"""N-sub-chunk shingles initial feature extraction (paper Algorithm 1;
port of ``repro.core.features``).

Per chunk, batched over chunks:

  1. split the chunk into K equal sub-chunks, b_j = floor(j*L/K);
  2. LSH each sub-chunk: the max windowed gear hash inside it (the
     chunker's scan already holds every position's hash), with the first
     31 positions of the chunk masked (their windows reach into the
     previous chunk) and empty sub-chunks giving 0;
  3. shingles: for r = 1..N, the polynomial combination (``SHINGLE_Q``)
     of every window of r+1 consecutive sub-chunk hashes;
  4. keep the unique shingles of each row (sort + neighbour mask);
  5. embed each unique shingle through M multiply-shift hash functions,
     L2-normalise the sub-vectors, average, normalise: kernel B, through
     ``kernels.ops.shingle_embed``, whose CPU route is the one plain
     version of the embed.

Only the fused stream path exists in the port (``kernels/ingest``); the
per-chunk host path and the ``lsh="poly"`` ablation are not ported yet.
Hashes are u32-in-int64 tensors (see ``core/hashing``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.kernels import ops

SHINGLE_Q = 0x9E3779B1  # odd golden-ratio multiplier


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    k: int = 32         # number of sub-chunks per chunk (paper: K)
    m: int = 64         # initial feature dimension (paper: M)
    n: int = 2          # max shingle radius (paper: N)

    @property
    def num_shingles(self) -> int:
        return sum(self.k - r for r in range(1, self.n + 1))


def _bounds(n: int, k: int) -> np.ndarray:
    """Equal-split segment bounds b_j = floor(j*n/k), exact integer math."""
    return (np.arange(k + 1, dtype=np.int64) * n) // k


_WARMUP = hashing.GEAR_WINDOW - 1  # positions whose 32B window crosses the
# chunk start; masked so stream-scan reuse and per-chunk hashing agree exactly


def shingle_ids(sub_hashes: torch.Tensor, n: int) -> torch.Tensor:
    """[B, K] u32-in-int64 -> [B, S] shingle hashes (S = sum_r (K-r)).

    shingle(j, r) = sum_t sub_hashes[j + t] * Q^t  for t in 0..r (mod 2^32).
    """
    k = sub_hashes.shape[-1]
    out = []
    for r in range(1, n + 1):
        acc = sub_hashes[..., : k - r]
        mult = SHINGLE_Q
        for t in range(1, r + 1):
            acc = (acc + hashing.mul_u32(sub_hashes[..., t : k - r + t], mult)) & hashing.U32
            mult = (mult * SHINGLE_Q) & hashing.U32
        out.append(acc)
    return torch.cat(out, dim=-1)


def unique_mask(ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort each row; mask[i]=True for the first occurrence of each value."""
    s = torch.sort(ids, dim=-1).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[..., 1:] = s[..., 1:] != s[..., :-1]
    return s, first


def bucket_pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor): the bucketing rule for the
    stream length, the chunk count and the longest-chunk extent."""
    return max(floor, 1 << max(0, int(n) - 1).bit_length())


class FeatureExtractor:
    """End-to-end Algorithm 1 over the chunker's stream scan (fused path).

    ``device`` follows the entry-point rule of ``kernels.ops.resolve_device``.
    """

    def __init__(self, cfg: FeatureConfig | None = None,
                 device: str | torch.device | None = None):
        self.cfg = cfg or FeatureConfig()
        self.device = ops.resolve_device(device)
        a, b = hashing.multiply_shift_params(self.cfg.m)
        self._a = hashing.to_i32_bits(hashing.u32_tensor(a, self.device))
        self._b = hashing.to_i32_bits(hashing.u32_tensor(b, self.device))

    def __call__(self, scan, offsets: np.ndarray, lengths: np.ndarray,
                 lmax_floor: int = 0) -> torch.Tensor:
        """[B, M] float32 initial features (on the extractor's device) for
        the chunks at ``offsets``/``lengths`` of the stream whose
        ``kernels.ingest.StreamScan`` is ``scan``."""
        from repro_torch.kernels import ingest
        return ingest.extract_stream(
            scan, np.asarray(offsets, np.int64),
            np.asarray(lengths, np.int64), self._a, self._b,
            k=self.cfg.k, n=self.cfg.n, lmax_floor=lmax_floor)
