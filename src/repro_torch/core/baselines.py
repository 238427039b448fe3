"""The paper's comparison targets: N-transform and Finesse resemblance
detection (super-feature schemes; port of ``repro.core.baselines``).

Both map a chunk to ``sf_count`` super-features over the chunk's Rabin
window fingerprints; two chunks are similar if ANY super-feature matches,
and the first match wins ("FirstFit", as in Finesse/FAST'19 and paper §3).

Each scheme has two forms that give the same super-features bit for bit:

  super_features(data)        one chunk's bytes, on the host: the plain
                              version, step for step the reference's;
  batch_super_features(...)   every chunk of a stream at once, from the
                              fingerprints kernel A took over the packed
                              chunks (``kernels/ingest.chunk_rabin_fps``):
                              range maxes as torch ops on the device
                              (``kernels/ingest.range_max``), then the
                              grouping and FNV-64 on the host.

Fingerprints are u32-in-int64 (``core/hashing``); FNV-64 runs on numpy
uint64, whose multiply wraps mod 2^64 as the reference's Python ints are
masked to.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.kernels import ingest  # a module: ingest imports core, which imports this

_FNV64_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV64_PRIME = np.uint64(0x100000001B3)


def fnv64(values: np.ndarray) -> np.ndarray:
    """FNV-1a over the last axis: [..., g] uint64 -> [...] uint64 (one
    hash per row, the values hashed whole in order, as the reference's
    ``_fnv64``)."""
    values = np.asarray(values, dtype=np.uint64)
    h = np.full(values.shape[:-1], _FNV64_OFFSET, dtype=np.uint64)
    for k in range(values.shape[-1]):
        h = (h ^ values[..., k]) * _FNV64_PRIME
    return h


def finesse_bounds(lengths: np.ndarray, t: int) -> np.ndarray:
    """Sub-chunk bounds [..., t + 1] int64 of chunks of ``lengths`` (>= 1):
    the reference's ``np.linspace(0, n, t + 1).astype(np.int64)``, taken
    for all lengths in one call. For n >= 1 numpy evaluates each row as
    the scalar call does (``arange * (n / t)``, the last entry set to n),
    so the truncation is the reference's bit for bit
    (``tests/test_torch_baselines.py`` checks every length up to the
    chunker's max). A length of 0 anywhere would send every row down
    numpy's other evaluation (divide, then scale), so it is refused."""
    n = np.asarray(lengths, np.int64)
    if n.size and int(n.min()) < 1:
        raise ValueError("chunk lengths must be >= 1")
    return np.linspace(0, n, t + 1, axis=-1).astype(np.int64)


def _host_u64(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().astype(np.uint64)


def _rows(sfs: np.ndarray) -> list[tuple[int, ...]]:
    return [tuple(r) for r in sfs.tolist()]


@dataclasses.dataclass(frozen=True)
class SuperFeatureConfig:
    features_per_sf: int = 4
    sf_count: int = 3
    window: int = hashing.RABIN_WINDOW

    @property
    def total_features(self) -> int:
        return self.features_per_sf * self.sf_count


def _chunk_fps(data: bytes, window: int) -> np.ndarray:
    """One chunk's Rabin fingerprints (warm-up from 0 at its first byte) as
    [L] uint64: the plain version of kernel A's Rabin route."""
    buf = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    return _host_u64(hashing.rabin_fps(buf, window))


class NTransform:
    """Shilane et al.: N linear transforms of all window fingerprints.

    feature_i = max_pos ((m_i * fp_pos + a_i) mod 2^32); super-feature j =
    FNV-64 of its group of ``features_per_sf`` consecutive features.
    """

    def __init__(self, cfg: SuperFeatureConfig | None = None, seed: int = 7):
        self.cfg = cfg or SuperFeatureConfig()
        rng = np.random.Generator(np.random.PCG64(seed))
        n = self.cfg.total_features
        self._m = (rng.integers(1, 2**32, n, dtype=np.uint64) | np.uint64(1))
        self._a = rng.integers(0, 2**32, n, dtype=np.uint64)

    def _super(self, feats: np.ndarray) -> np.ndarray:
        """[..., N] features -> [..., sf_count] super-features."""
        g, sf = self.cfg.features_per_sf, self.cfg.sf_count
        return fnv64(feats[..., :g * sf].reshape(*feats.shape[:-1], sf, g))

    def super_features(self, data: bytes) -> tuple[int, ...]:
        fps = _chunk_fps(data, self.cfg.window)                     # [L]
        t = (fps[None, :] * self._m[:, None] + self._a[:, None]) & np.uint64(0xFFFFFFFF)
        return tuple(self._super(t.max(axis=1)).tolist())

    def batch_super_features(self, fps: torch.Tensor, starts: torch.Tensor,
                             lengths: np.ndarray) -> list[tuple[int, ...]]:
        """Super-features of every chunk from the packed fingerprints
        ``fps`` and each chunk's ``starts`` in them (``chunk_rabin_fps``)."""
        lens = torch.from_numpy(np.asarray(lengths, np.int64)).to(fps.device)
        s, e, tmax = starts[:, None], (starts + lens)[:, None], int(np.max(lengths))
        feats = torch.cat([
            ingest.range_max((hashing.mul_u32(fps, int(m)) + int(a)) & hashing.U32, s, e, tmax)
            for m, a in zip(self._m, self._a)], dim=1)              # [B, N]
        return _rows(self._super(_host_u64(feats)))


class Finesse:
    """Zhang et al. FAST'19: fine-grained feature locality.

    Split the chunk into ``total_features`` sub-chunks; feature of each =
    max window fingerprint inside it (0 if it is empty). Group consecutive
    sub-chunk features into ``features_per_sf``-sized groups, sort within
    each group, and build SF_j from the j-th ranked value of every group
    (rank-based grouping, paper Fig. 2).
    """

    def __init__(self, cfg: SuperFeatureConfig | None = None):
        self.cfg = cfg or SuperFeatureConfig()

    def _super(self, feats: np.ndarray) -> np.ndarray:
        """[..., N] sub-chunk features -> [..., sf_count] super-features."""
        g, sf = self.cfg.features_per_sf, self.cfg.sf_count
        ranked = np.sort(feats[..., :g * sf].reshape(*feats.shape[:-1], sf, g), axis=-1)
        # SF_j hashes column j of the ranked groups: g hashes, cut to sf_count
        return fnv64(np.swapaxes(ranked, -1, -2))[..., :sf]

    def super_features(self, data: bytes) -> tuple[int, ...]:
        fps = _chunk_fps(data, self.cfg.window)
        n = len(fps)
        t = self.cfg.total_features
        bounds = np.linspace(0, n, t + 1).astype(np.int64)
        feats = np.zeros(t, dtype=np.uint64)
        for i in range(t):
            lo, hi = bounds[i], bounds[i + 1]
            feats[i] = fps[lo:hi].max() if hi > lo else 0
        return tuple(self._super(feats).tolist())

    def batch_super_features(self, fps: torch.Tensor, starts: torch.Tensor,
                             lengths: np.ndarray) -> list[tuple[int, ...]]:
        """As ``NTransform.batch_super_features``; the ranges are the
        sub-chunks, ``finesse_bounds`` apart inside each chunk."""
        bounds = finesse_bounds(lengths, self.cfg.total_features)   # [B, t + 1]
        tmax = max(1, int(np.diff(bounds, axis=-1).max()))
        pos = starts[:, None] + torch.from_numpy(bounds).to(fps.device)
        feats = ingest.range_max(fps, pos[:, :-1], pos[:, 1:], tmax)       # [B, t]
        return _rows(self._super(_host_u64(feats)))


class SuperFeatureIndex:
    """FirstFit store: any-SF-match -> similar; first match is the base.

    ``query``/``stage`` accept an *overlay* (same table-list shape, holding
    staged-but-not-admitted entries) so a batch can be scored as if its
    earlier chunks were already inserted, without mutating the index.
    Persistent tables win over the overlay, matching insert's
    first-writer-wins ``setdefault``.
    """

    def __init__(self):
        self._tables: list[dict[int, int]] = []

    def query(self, sfs: tuple[int, ...],
              overlay: list[dict[int, int]] | None = None) -> int | None:
        for j, sf in enumerate(sfs):
            hit = self._tables[j].get(sf) if j < len(self._tables) else None
            if hit is None and overlay is not None and j < len(overlay):
                hit = overlay[j].get(sf)
            if hit is not None:
                return hit
        return None

    def stage(self, sfs: tuple[int, ...], chunk_id: int,
              overlay: list[dict[int, int]]) -> None:
        """Record an insert in ``overlay`` only (the index is untouched),
        preserving first-writer-wins across persistent + staged entries."""
        while len(overlay) < len(sfs):
            overlay.append({})
        for j, sf in enumerate(sfs):
            if j >= len(self._tables) or sf not in self._tables[j]:
                overlay[j].setdefault(sf, chunk_id)

    def insert(self, sfs: tuple[int, ...], chunk_id: int) -> None:
        while len(self._tables) < len(sfs):
            self._tables.append({})
        for j, sf in enumerate(sfs):
            self._tables[j].setdefault(sf, chunk_id)
