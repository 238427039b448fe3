"""Fused per-stream ingest pipeline (port of ``repro.kernels.ingest``).

Two device passes per stream, and a third for the super-feature
baselines:

    scan_stream      bytes [Spad] u8, Spad = n rounded up to SCAN_ALIGN
                       -> kernel A: windowed gear hashes [Spad] (kept on
                          the device: StreamScan) + the two FastCDC
                          candidate maps as 32-bit words (to the host,
                          n/16 bytes in all, for boundary selection)
    extract_stream   StreamScan + chunk offsets/lengths [Bpad]
                       -> sub-chunk maxgear LSH [B, K] (two-tier segment
                          max, plain torch)
                       -> shingle ids + per-row uniquification
                          (``shingle_inputs``, the real rows only)
                       -> kernel B: multiply-shift embed, mean and
                          (``normalize``) normalise in one launch [B, M]
    chunk_rabin_fps  StreamScan's bytes + chunk offsets/lengths
                       -> the chunks packed with zero gaps, one launch of
                          kernel A's Rabin route: each chunk's window
                          fingerprints, as a per-chunk scan gives them

The chunk count B and the longest-chunk extent Lmax are padded up to a
power-of-two bucket, exactly as the reference does, and padded rows are
masked, so every integer stage is bit-identical to the reference per row.
The stream is not: the reference buckets it so that XLA compiles once per
bucket, but a CUDA scan takes any length, so it is padded only to
SCAN_ALIGN, the widest tile ``range_max`` reshapes it into. Hashes
past n are never read: every gather is masked by its chunk's end, and
whole tiles end at or before it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import features as _feat
from repro_torch.core import hashing
from repro_torch.core.features import bucket_pow2
from repro_torch.kernels import gear_hash, ops

_FLOOR_B = 16
# the stream is scanned at a multiple of this: the largest `tile` of
# range_max, which reshapes the hashes into rows of `tile`
SCAN_ALIGN = 128

# Positions are int64 here, but the reference indexes with int32 and
# routes longer streams to its per-chunk path; so does the port
# (core/features.FeatureExtractor), and extract_stream raises above it,
# as the reference's does.
FUSED_STREAM_LIMIT = 2**31 - 2**20


class StreamScan:
    """Device-resident gear scan of one stream (padded to SCAN_ALIGN, int32
    hash bits), with lazy host materialisation: indexes like the [n] uint32
    numpy array of the reference. ``data`` keeps the stream's bytes as the
    scan read them on the device, so later passes over the chunks
    (``chunk_rabin_fps``) gather them there instead of copying them up
    again."""

    def __init__(self, device: torch.Tensor, n: int, data: torch.Tensor) -> None:
        self.device = device            # [scan_length(n)] int32 hash bits
        self.n = n
        self.data = data                # [scan_length(n)] uint8, zeros past n
        self._np: np.ndarray | None = None

    def asnumpy(self) -> np.ndarray:
        if self._np is None:
            self._np = self.device[:self.n].cpu().numpy().view(np.uint32)
        return self._np

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, key):
        return self.asnumpy()[key]

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a if dtype is None else a.astype(dtype)


def scan_length(n: int) -> int:
    """Positions scanned for an n-byte stream: n rounded up to SCAN_ALIGN
    (one tile at least)."""
    return max(1, -(-n // SCAN_ALIGN)) * SCAN_ALIGN


def scan_stream(data: np.ndarray, mask_s: int, mask_l: int,
                device: torch.device | str
                ) -> tuple[StreamScan, np.ndarray, np.ndarray]:
    """The chunker scan on ``device``: returns the device-resident
    StreamScan plus the two [n] bool candidate maps the host boundary
    walk reads. Bytes go up and candidate words come down; the
    4-bytes-per-position hash array never leaves the device."""
    n = len(data)
    spad = scan_length(n)
    host = torch.zeros(spad, dtype=torch.uint8)
    host.numpy()[:n] = data
    on_dev = host.to(device)
    h, ws, wl = ops.scan_candidates(on_dev, int(mask_s), int(mask_l))
    cand_s = gear_hash.unpack_bits(ws.cpu().numpy(), n)
    cand_l = gear_hash.unpack_bits(wl.cpu().numpy(), n)
    return StreamScan(h, n, on_dev), cand_s, cand_l


def range_max(sh: torch.Tensor, s_abs: torch.Tensor, e_abs: torch.Tensor,
              tmax: int) -> torch.Tensor:
    """Max of ``sh`` ([Spad] u32-in-int64, Spad a multiple of SCAN_ALIGN)
    over each range [s, e) of ``s_abs`` / ``e_abs`` ([B, K] int64, ranges
    inside [0, Spad), none wider than ``tmax``): [B, K], 0 where empty."""
    spad = sh.shape[0]
    dev = sh.device

    def gather(pos: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        vals = sh[torch.clamp(pos, 0, spad - 1)]
        return torch.where(valid, vals, 0)

    if tmax <= 32:
        # tiny chunks: one dense masked gather [B, K, Tmax]
        t = torch.arange(tmax, device=dev)
        pos = s_abs[:, :, None] + t[None, None, :]
        return gather(pos, pos < e_abs[:, :, None]).amax(dim=-1)
    # two-tier max: whole tiles cover each segment's interior, two
    # <= tile-wide gathers its ragged edges (max is idempotent, so
    # overlaps are harmless)
    tile = min(SCAN_ALIGN, max(8, bucket_pow2(int(tmax ** 0.5))))
    ntiles = tmax // tile + 2
    tiles = sh.reshape(-1, tile).amax(dim=-1)
    ti0 = (s_abs + tile - 1) // tile                               # first whole
    ti1 = e_abs // tile                                            # one past last
    ji = torch.arange(ntiles, device=dev)
    tidx = ti0[:, :, None] + ji[None, None, :]
    tmask = ji[None, None, :] < (ti1 - ti0)[:, :, None]
    interior = torch.where(
        tmask, tiles[torch.clamp(tidx, 0, tiles.shape[0] - 1)], 0)
    tj = torch.arange(tile, device=dev)
    hpos = s_abs[:, :, None] + tj[None, None, :]                   # head edge
    head = gather(hpos, hpos < torch.minimum(e_abs, ti0 * tile)[:, :, None])
    ts = torch.maximum(s_abs, ti1 * tile)                          # tail edge
    tpos = ts[:, :, None] + tj[None, None, :]
    tail = gather(tpos, tpos < e_abs[:, :, None])
    return torch.maximum(interior.amax(dim=-1),
                         torch.maximum(head.amax(dim=-1), tail.amax(dim=-1)))


def subchunk_maxgear(sh: torch.Tensor, offsets: torch.Tensor,
                     lengths: torch.Tensor, k: int, lmax: int) -> torch.Tensor:
    """Stream hashes [Spad] u32-in-int64 + chunk offsets/lengths [B] ->
    [B, K] sub-chunk maxes (u32-in-int64).

    Segment j of a length-L chunk spans [floor(j*L/k), floor((j+1)*L/k)),
    clipped below by the 31-position gear warm-up; empty segments are 0.
    """
    j = torch.arange(k + 1, device=sh.device)
    lens = torch.clamp(lengths, min=0)
    bounds = (j[None, :] * lens[:, None]) // k                     # [B, K+1]
    s_abs = offsets[:, None] + torch.clamp(bounds[:, :k], min=_feat._WARMUP)
    e_abs = offsets[:, None] + bounds[:, 1:]                       # [B, K]
    return range_max(sh, s_abs, e_abs, lmax // k + 1)


def shingle_inputs(scan, offsets: np.ndarray, lengths: np.ndarray,
                   device: torch.device, *, k: int, n: int, lmax_floor: int = 0
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 1 up to kernel B on ``device``: bucket-pad, sub-chunk
    LSH, shingle ids and their first-occurrence mask. ``scan`` is a
    StreamScan or, as the reference also takes, the host [n] uint32 hash
    array. Returns kernel B's input for the real rows only: [B, S] int32
    id bits, [B, S] bool mask. The padded rows exist for the reference's
    bucketing; rows are independent, so dropping them changes no real
    row."""
    bsz = int(offsets.shape[0])
    ends = np.asarray(offsets, np.int64) + np.asarray(lengths, np.int64)
    if int(ends.max()) > FUSED_STREAM_LIMIT:
        raise ValueError("the fused extract serves streams up to FUSED_STREAM_LIMIT; "
                         "longer ones take the per-chunk path (FeatureExtractor "
                         "routes them)")
    if isinstance(scan, StreamScan):
        sh = hashing.from_i32_bits(scan.device.to(device))
    else:
        host = np.zeros(scan_length(len(scan)), np.int64)
        host[:len(scan)] = np.asarray(scan, np.uint32)
        sh = torch.from_numpy(host).to(device)
    bpad = bucket_pow2(bsz, _FLOOR_B)
    lmax = bucket_pow2(max(int(np.max(lengths)), 1), max(1, int(lmax_floor)))
    off_p = torch.zeros(bpad, dtype=torch.int64)
    off_p[:bsz] = torch.from_numpy(np.asarray(offsets, np.int64))
    len_p = torch.zeros(bpad, dtype=torch.int64)
    len_p[:bsz] = torch.from_numpy(np.asarray(lengths, np.int64))

    sub = subchunk_maxgear(sh, off_p.to(device), len_p.to(device), k, lmax)
    ids, mask = _feat.unique_mask(_feat.shingle_ids(sub, n))
    return hashing.to_i32_bits(ids[:bsz]), mask[:bsz]


def extract_stream(scan, offsets: np.ndarray, lengths: np.ndarray,
                   a: torch.Tensor, b: torch.Tensor, *, k: int, n: int,
                   normalize: bool = True, lmax_floor: int = 0) -> torch.Tensor:
    """Algorithm 1 on the device of ``a``: ``shingle_inputs``, then kernel B.

    ``scan`` is the stream's StreamScan from ``scan_stream`` (hash bits
    padded to SCAN_ALIGN) or its host hash array. ``a``/``b`` are the
    multiply-shift params as int32 bits [M]. Returns [B, M] float32 mean
    rows, L2-normalised unless ``normalize`` is False."""
    if offsets.shape[0] == 0:
        return torch.zeros(0, int(a.shape[-1]), dtype=torch.float32, device=a.device)
    ids, mask = shingle_inputs(scan, offsets, lengths, a.device, k=k, n=n,
                               lmax_floor=lmax_floor)
    return ops.shingle_embed(ids, mask, a, b, normalize)


def pack_chunks(data: torch.Tensor, offsets: np.ndarray, lengths: np.ndarray,
                gap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Lay the chunks of ``data`` (the stream's bytes, on the device) end
    to end with ``gap`` zero bytes between neighbours: chunk 0, gap,
    chunk 1, ... Returns the packed buffer ([sum L + gap * (B - 1)] bytes,
    zero-padded to a multiple of SCAN_ALIGN for ``range_max``) and each
    chunk's start in it ([B] int64)."""
    dev = data.device
    lens = torch.from_numpy(np.asarray(lengths, np.int64)).to(dev)
    offs = torch.from_numpy(np.asarray(offsets, np.int64)).to(dev)
    total = int(np.sum(lengths))
    chunk = torch.repeat_interleave(torch.arange(lens.shape[0], device=dev), lens,
                                    output_size=total)               # [sum L]
    before = torch.cumsum(lens, 0) - lens          # chunk bytes before each chunk
    starts = before + gap * torch.arange(lens.shape[0], device=dev)
    k = torch.arange(total, device=dev)
    packed = torch.zeros(scan_length(total + gap * (lens.shape[0] - 1)),
                         dtype=torch.uint8, device=dev)
    packed[k + gap * chunk] = data[k + (offs - before)[chunk]]
    return packed, starts


def chunk_rabin_fps(scan: StreamScan, offsets: np.ndarray, lengths: np.ndarray,
                    window: int = hashing.RABIN_WINDOW
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each chunk's Rabin fingerprints, as the reference takes them one
    chunk at a time (the window starts from 0 at the chunk's first byte),
    from one launch of kernel A over the whole stream.

    The chunks are packed with ``window - 1`` zero bytes between them
    (``pack_chunks``). A zero byte adds nothing to a window sum, so a
    window that starts inside a gap sees exactly the warm-up value of a
    per-chunk scan. Returns the fingerprints of the packed buffer ([Npad]
    u32-in-int64) and each chunk's start in it ([B] int64): chunk c's
    fingerprints are ``fps[starts[c]:starts[c] + L_c]``."""
    packed, starts = pack_chunks(scan.data, offsets, lengths, window - 1)
    return hashing.from_i32_bits(ops.rabin_fps(packed, window)), starts
