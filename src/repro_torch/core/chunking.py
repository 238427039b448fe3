"""FastCDC content-defined chunking: config, chunk records and the greedy
boundary walk (port of ``repro.core.chunking``).

The gear hash is linear, so the scan kernel evaluates it at every
position in parallel and emits two boundary-candidate maps
(``kernels/ingest.scan_stream``). Only the greedy min/normal/max-size
selection below walks the stream on the host, and it touches just the
sparse candidate positions. Boundaries are bit-identical to serial
FastCDC-with-reset whenever min_size >= 32 (the uint32 gear window).
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.kernels import ingest, ops


@dataclasses.dataclass(frozen=True)
class ChunkerConfig:
    avg_size: int = 16 * 1024
    min_factor: float = 0.25           # min_size = avg * min_factor
    max_factor: float = 4.0            # max_size = avg * max_factor
    norm_level: int = 2                # FastCDC normalization (mask +- bits)

    @property
    def min_size(self) -> int:
        return max(64, int(self.avg_size * self.min_factor))

    @property
    def max_size(self) -> int:
        return int(self.avg_size * self.max_factor)

    @property
    def mask_bits(self) -> int:
        return int(np.log2(self.avg_size))

    @property
    def mask_s(self) -> int:  # harder mask: used before avg_size
        return (1 << (self.mask_bits + self.norm_level)) - 1

    @property
    def mask_l(self) -> int:  # easier mask: used after avg_size
        return (1 << (self.mask_bits - self.norm_level)) - 1


@dataclasses.dataclass(frozen=True)
class Chunk:
    offset: int
    length: int
    data: bytes

    @property
    def digest(self) -> bytes:
        return hashlib.blake2b(self.data, digest_size=20).digest()


def select_boundaries(
    n: int, cand_s: np.ndarray, cand_l: np.ndarray, cfg: ChunkerConfig
) -> np.ndarray:
    """Greedy FastCDC boundary selection from candidate bitmaps.

    Returns boundary offsets including 0 and n. A cut at position i means the
    chunk ends *after* byte i (chunk = data[start : i + 1]).
    """
    bounds = [0]
    start = 0
    min_s, avg_s, max_s = cfg.min_size, cfg.avg_size, cfg.max_size
    while start < n:
        if n - start <= min_s:
            bounds.append(n)
            break
        # Region 1: [start+min, start+avg) against the hard mask.
        lo = start + min_s
        hi = min(start + avg_s, n)
        cut = -1
        if lo < hi:
            w = cand_s[lo:hi]
            idx = np.flatnonzero(w)
            if idx.size:
                cut = lo + int(idx[0])
        if cut < 0:
            # Region 2: [start+avg, start+max) against the easy mask.
            lo2 = max(lo, min(start + avg_s, n))
            hi2 = min(start + max_s, n)
            if lo2 < hi2:
                w = cand_l[lo2:hi2]
                idx = np.flatnonzero(w)
                if idx.size:
                    cut = lo2 + int(idx[0])
        if cut < 0:
            cut = min(start + max_s, n) - 1
        bounds.append(cut + 1)
        start = cut + 1
    if bounds[-1] != n:
        bounds.append(n)
    return np.asarray(bounds, dtype=np.int64)


def chunks_from_bounds(raw: bytes, bounds: np.ndarray) -> list[Chunk]:
    """Materialize Chunk objects from boundary offsets."""
    return [
        Chunk(offset=int(a), length=int(b - a), data=raw[a:b])
        for a, b in zip(bounds[:-1], bounds[1:])
    ]


def chunk_scan(data: bytes | np.ndarray, cfg: ChunkerConfig,
               device: torch.device | str) -> tuple[list[Chunk], ingest.StreamScan | None]:
    """FastCDC through the device scan: bytes go up, candidate words come
    back, the host walks the boundaries. Returns the chunks and the
    device-resident ``StreamScan`` the detector reads without a round-trip
    (None for an empty stream)."""
    buf = (np.frombuffer(data, dtype=np.uint8)
           if isinstance(data, (bytes, bytearray))
           else np.asarray(data, dtype=np.uint8))
    n = len(buf)
    if n == 0:
        return [], None
    scan, cand_s, cand_l = ingest.scan_stream(buf, cfg.mask_s, cfg.mask_l, device)
    raw = data if isinstance(data, bytes) else buf.tobytes()
    return chunks_from_bounds(raw, select_boundaries(n, cand_s, cand_l, cfg)), scan


def chunk_stream(data: bytes | np.ndarray, cfg: ChunkerConfig | None = None,
                 device: str | torch.device | None = None) -> list[Chunk]:
    """Chunk a byte stream: kernel A's scan on ``device`` (the CUDA device
    unless ``"cpu"``), then the host boundary walk."""
    return chunk_scan(data, cfg or ChunkerConfig(), ops.resolve_device(device))[0]
