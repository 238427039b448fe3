"""Kernel A: windowed weighted sum (gear hash / Rabin fingerprints) with
fused FastCDC candidate bits — the CUDA launcher and its plain version.

    h_i = sum_{k<W} w_k * g_{i-k}      (uint32 wraparound)

Gear: taps ``1 << k`` (W = 32) over ``GEAR_TABLE[byte]``; Rabin: taps
``p^k`` over the raw bytes. The scan also emits the two candidate maps
``(h & mask_s) == 0`` and ``(h & mask_l) == 0`` as 32-bit words: bit i of
word w is position 32w + i (on the card, the word of one thread's run
of 32 positions). That is not ``np.packbits``' order; ``unpack_bits``
reads this format.

The kernel rolls the window, ``h_i = r * h_{i-1} + g_i - r^W * g_{i-W}``,
which needs geometric taps ``w_k = r^k``; gear's (r = 2) and Rabin's
(r = ``POLY_P``) are, and the launcher raises on any others.

Hashes are returned as int32 tensors holding the uint32 bits.
Source: ``csrc/gear_hash.cu``; replaces ``repro/kernels/gear_hash.py:43``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/gear_hash.cu"
REPLACES = "src/repro/kernels/gear_hash.py:43"


def num_words(n: int) -> int:
    return -(-n // 32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[n] bool -> [ceil(n/32)] int32 words, bit i of word w = position 32w+i."""
    n = bits.shape[0]
    padded = torch.zeros(num_words(n) * 32, dtype=torch.int64, device=bits.device)
    padded[:n] = bits.to(torch.int64)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (padded.view(-1, 32) << shifts).sum(dim=1)
    return hashing.to_i32_bits(words)


def unpack_bits(words: np.ndarray, n: int) -> np.ndarray:
    """Host inverse of the word layout: [ceil(n/32)] words -> [n] bool."""
    raw = np.ascontiguousarray(words).astype("<u4", copy=False).view(np.uint8)
    return np.unpackbits(raw, bitorder="little")[:n].view(np.bool_)


# --- plain versions (run on whatever device their inputs are on) ---------------

def gear_hashes_plain(data: torch.Tensor) -> torch.Tensor:
    return hashing.to_i32_bits(hashing.gear_hashes(data))


def rabin_fps_plain(data: torch.Tensor, window: int) -> torch.Tensor:
    return hashing.to_i32_bits(hashing.rabin_fps(data, window))


def scan_plain(data: torch.Tensor, mask_s: int, mask_l: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[n] uint8 -> (gear hash bits [n] int32, cand_s words, cand_l words)."""
    h = hashing.gear_hashes(data)
    return (hashing.to_i32_bits(h), pack_bits((h & mask_s) == 0),
            pack_bits((h & mask_l) == 0))


# --- the kernel --------------------------------------------------------------

def geometric_ratio(taps: np.ndarray) -> int:
    """r with ``taps[k] == r**k mod 2**32`` for every k; raises otherwise.

    The kernel takes (r, W) and rolls the window; a tap set that is not a
    geometric series has no such recurrence, so it never reaches it."""
    taps = np.asarray(taps, dtype=np.uint32)
    if taps.ndim != 1 or taps.shape[0] == 0 or int(taps[0]) != 1:
        raise ValueError("kernel A takes geometric taps r^k, starting at 1")
    r = int(taps[1]) if taps.shape[0] > 1 else 0
    want = 1
    for k, w in enumerate(taps):
        if int(w) != want:
            raise ValueError(f"tap {k} is {int(w)}, not r^{k} = {want} (r = {r}): "
                             "kernel A takes geometric taps only")
        want = (want * r) & hashing.U32
    return r


# the gear table, uploaded once per device
_ON_DEVICE: dict[torch.device, torch.Tensor] = {}


def _gear_table(device: torch.device) -> torch.Tensor:
    if device not in _ON_DEVICE:
        _ON_DEVICE[device] = torch.from_numpy(hashing.GEAR_TABLE.view(np.int32).copy()).to(device)
    return _ON_DEVICE[device]


def windowed_sum_cuda(data: torch.Tensor, taps: np.ndarray, gear: bool,
                      masks: tuple[int, int] | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """Launch kernel A on ``data`` ([n] uint8, CUDA, contiguous, n > 0).

    ``taps`` must be geometric (``geometric_ratio``); ``gear`` selects
    ``GEAR_TABLE[byte]`` over the raw byte; ``masks`` (mask_s, mask_l)
    adds the two candidate-word maps."""
    r = geometric_ratio(taps)
    n = data.shape[0]
    table = _gear_table(data.device) if gear else None
    out = torch.empty(n, dtype=torch.int32, device=data.device)
    ws = wl = None
    mask_s = mask_l = 0
    if masks is not None:
        mask_s, mask_l = masks
        ws = torch.empty(num_words(n), dtype=torch.int32, device=data.device)
        wl = torch.empty_like(ws)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = _build.lib().repro_windowed_sum(
        data.data_ptr(), n, None if table is None else table.data_ptr(), r,
        len(taps), mask_s & 0xFFFFFFFF, mask_l & 0xFFFFFFFF,
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        None if wl is None else wl.data_ptr(), stream)
    _build.check(err, "repro_windowed_sum")
    return out, ws, wl
