"""N-sub-chunk shingles initial feature extraction (paper Algorithm 1;
port of ``repro.core.features``).

Per chunk, batched over chunks:

  1. split the chunk into K equal sub-chunks, b_j = floor(j*L/K);
  2. LSH each sub-chunk. ``lsh="maxgear"`` (the default): the max windowed
     gear hash inside it, with the first 31 positions of the chunk masked
     (their windows reach into the previous chunk, or are a per-chunk
     scan's warm-up) and empty sub-chunks giving 0. ``lsh="poly"`` (the
     ablation): the exact polynomial hash of the sub-chunk's bytes;
  3. shingles: for r = 1..N, the polynomial combination (``SHINGLE_Q``)
     of every window of r+1 consecutive sub-chunk hashes;
  4. keep the unique shingles of each row (sort + neighbour mask);
  5. embed each unique shingle through M multiply-shift hash functions,
     L2-normalise the sub-vectors, average and (``normalize``) normalise:
     kernel B, through ``kernels.ops.shingle_embed``, whose CPU route is
     the one plain version of the embed (``embed_shingles``).

Two routes, picked as the reference picks them (``FeatureExtractor``):
the fused stream path (``kernels/ingest``: maxgear over the chunker's
device-resident scan) and the per-chunk path (``batch_subchunk_lsh``,
then ``features_from_subhashes``), which serves ``fused=False``,
``lsh="poly"``, chunks given without a scan and streams past
``ingest.FUSED_STREAM_LIMIT``. On the per-chunk path, chunks given
without a scan are packed end to end on the device: one launch of kernel
A gives their gear hashes, and one prefix sum their poly hashes.
Hashes are u32-in-int64 tensors (see ``core/hashing``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.kernels import ops, shingle_embed

SHINGLE_Q = 0x9E3779B1  # odd golden-ratio multiplier


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    k: int = 32         # number of sub-chunks per chunk (paper: K)
    m: int = 64         # initial feature dimension (paper: M)
    n: int = 2          # max shingle radius (paper: N)
    lsh: str = "maxgear"  # sub-chunk LSH: "maxgear" | "poly" (ablation)
    normalize: bool = True

    @property
    def num_shingles(self) -> int:
        return sum(self.k - r for r in range(1, self.n + 1))


def _bounds(n: int, k: int) -> np.ndarray:
    """Equal-split segment bounds b_j = floor(j*n/k), exact integer math."""
    return (np.arange(k + 1, dtype=np.int64) * n) // k


_WARMUP = hashing.GEAR_WINDOW - 1  # positions whose 32B window crosses the
# chunk start; masked so stream-scan reuse and per-chunk hashing agree exactly


def subchunk_maxgear(gear_hashes: np.ndarray, k: int) -> np.ndarray:
    """[L] uint32 gear hashes of one chunk (host) -> [K] uint32 max per
    equal sub-chunk, the first GEAR_WINDOW-1 positions excluded and empty
    sub-chunks 0 (the reference's ``subchunk_maxgear_np``)."""
    gear_hashes = np.asarray(gear_hashes, np.uint32)
    n = len(gear_hashes)
    b = _bounds(n, k)
    starts = np.minimum(b[:-1], max(n - 1, 0))   # reduceat wants valid starts
    out = np.maximum.reduceat(gear_hashes, starts) if n else np.zeros(k, np.uint32)
    out[b[1:] <= b[:-1]] = 0
    # segments that overlap the warm-up: their max without it
    for i in np.flatnonzero(b[:-1] < min(_WARMUP, n)):
        lo, hi = max(int(b[i]), _WARMUP), int(b[i + 1])
        out[i] = gear_hashes[lo:hi].max() if hi > lo else 0
    return out.astype(np.uint32)


def subchunk_poly(data: torch.Tensor, k: int) -> torch.Tensor:
    """[L] uint8 chunk bytes -> [K] u32-in-int64 exact polynomial hashes
    of the K sub-chunks (the ablation's LSH)."""
    bounds = torch.from_numpy(_bounds(data.shape[0], k)).to(data.device)
    return hashing.segment_poly_hashes(data, bounds)


def batch_subchunk_maxgear(gear: torch.Tensor, lengths: torch.Tensor, k: int) -> torch.Tensor:
    """Gear hashes [B, Lmax] (u32-in-int64, zero-padded rows) + lengths [B]
    -> [B, K] segment maxes (the reference's ``batch_subchunk_maxgear_j``).

    Position p of a length-L row lies in segment floor((p*k + k-1) / L),
    the exact inverse of the floor(j*L/k) bounds; warm-up positions and
    padding go to a dropped segment K."""
    lmax = gear.shape[1]
    pos = torch.arange(lmax, device=gear.device)[None, :]
    lengths = lengths.to(torch.int64)[:, None]
    valid = (pos < lengths) & (pos >= _WARMUP)
    seg = torch.where(valid, (pos * k + (k - 1)) // torch.clamp(lengths, min=1), k)
    seg = torch.clamp(seg, 0, k)
    out = torch.zeros(gear.shape[0], k + 1, dtype=torch.int64, device=gear.device)
    return out.scatter_reduce_(1, seg, gear, "amax")[:, :k]


def batch_subchunk_poly(data: torch.Tensor, lengths: torch.Tensor, k: int) -> torch.Tensor:
    """Padded bytes [B, Lmax] uint8 + lengths [B] -> [B, K] u32-in-int64
    sub-chunk poly hashes (the reference's ``batch_subchunk_poly_j``): the
    rows are one buffer to ``hashing.segment_poly_hashes``, each segment
    bounded inside its row."""
    b, lmax = data.shape
    i = torch.arange(k + 1, device=data.device)[None, :]
    rows = torch.arange(b, device=data.device)[:, None] * lmax
    bounds = rows + (i * lengths.to(torch.int64)[:, None]) // k
    return hashing.segment_poly_hashes(data.reshape(-1), bounds)


def pack_chunk_bytes(chunks: list[bytes], device: torch.device
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunks laid end to end on ``device``: the buffer (zero-padded to
    ``ingest.scan_length``), each chunk's start and length ([B] int64).
    ``ingest.pack_chunks`` gathers chunks out of a stream already on the
    device; these are host bytes, which joined are already packed."""
    from repro_torch.kernels import ingest   # ingest imports this module
    lens = np.fromiter((len(c) for c in chunks), np.int64, len(chunks))
    total = int(lens.sum())
    host = torch.zeros(ingest.scan_length(total), dtype=torch.uint8)
    host.numpy()[:total] = np.frombuffer(b"".join(chunks), np.uint8)
    lengths = torch.from_numpy(lens)
    starts = torch.cumsum(lengths, 0) - lengths
    return host.to(device), starts.to(device), lengths.to(device)


def batch_subchunk_lsh(chunks: list[bytes], cfg: FeatureConfig,
                       stream_hashes=None, offsets: np.ndarray | None = None,
                       device: torch.device | str | None = None) -> torch.Tensor:
    """[B, K] u32-in-int64 sub-chunk LSH values on ``device`` (the
    reference's ``batch_subchunk_lsh_np``; the device rule of
    ``kernels.ops.resolve_device``).

    ``poly`` hashes the chunks packed on the device in one prefix sum.
    ``maxgear`` with ``stream_hashes`` + ``offsets`` reads the scan's host
    copy chunk by chunk, as the reference does; without them, kernel A
    hashes the packed chunks in one launch and each chunk's first 31
    positions are masked, so every position used sees only its own
    chunk's bytes."""
    from repro_torch.kernels import ingest
    device = ops.resolve_device(device)
    if cfg.lsh == "poly":
        packed, starts, lens = pack_chunk_bytes(chunks, device)
        j = torch.arange(cfg.k + 1, device=device)
        return hashing.segment_poly_hashes(packed, starts[:, None] + (j * lens[:, None]) // cfg.k)
    if stream_hashes is not None and offsets is not None:
        h = np.asarray(stream_hashes)
        out = np.stack([subchunk_maxgear(h[off:off + len(c)], cfg.k)
                        for c, off in zip(chunks, np.asarray(offsets, np.int64))])
        return hashing.u32_tensor(out, device)
    packed, starts, lens = pack_chunk_bytes(chunks, device)
    gear = hashing.from_i32_bits(ops.gear_hashes(packed))
    return ingest.subchunk_maxgear(gear, starts, lens, cfg.k, max(len(c) for c in chunks))


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


def embed_shingles(ids: torch.Tensor, mask: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """[B, S] int32 id bits + [B, S] mask, a/b [M] int32 bits -> [B, M]
    features: the plain version of kernel B (the reference's
    ``embed_shingles_j``)."""
    total = shingle_embed.shingle_embed_sum_plain(ids, mask, a, b)
    return shingle_embed.mean_normalize(total, mask, normalize)


def bucket_pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor): the bucketing rule for the
    stream length, the chunk count and the longest-chunk extent."""
    return max(floor, 1 << max(0, int(n) - 1).bit_length())


class FeatureExtractor:
    """End-to-end Algorithm 1: host API over chunk payloads, tensors on
    ``device`` underneath (the entry-point rule of
    ``kernels.ops.resolve_device``).

    With ``fused=True`` (the default), ``lsh="maxgear"`` and the chunker's
    stream scan, the whole LSH -> shingle -> embed pipeline runs on the
    scan (``kernels/ingest``); otherwise the per-chunk path runs, which the
    fused path equals within the embed's rounding."""

    def __init__(self, cfg: FeatureConfig | None = None,
                 device: str | torch.device | None = None, fused: bool = True):
        self.cfg = cfg or FeatureConfig()
        self.device = ops.resolve_device(device)
        self.fused = fused
        a, b = hashing.multiply_shift_params(self.cfg.m)
        self._a = hashing.to_i32_bits(hashing.u32_tensor(a, self.device))
        self._b = hashing.to_i32_bits(hashing.u32_tensor(b, self.device))

    def features_from_subhashes(self, sub_hashes) -> torch.Tensor:
        """[B, K] sub-chunk hashes (u32-in-int64 tensor or uint32 array) ->
        [B, M] features. Rows are padded to the reference's pow2 bucket
        (floor 16) before the shingle and embed stages."""
        sub = (sub_hashes.to(self.device) if isinstance(sub_hashes, torch.Tensor)
               else hashing.u32_tensor(sub_hashes, self.device))
        bsz = sub.shape[0]
        pad = bucket_pow2(bsz, 16) - bsz
        if pad:
            sub = torch.cat([sub, sub.new_zeros(pad, sub.shape[1])])
        ids, mask = unique_mask(shingle_ids(sub, self.cfg.n))
        return ops.shingle_embed(hashing.to_i32_bits(ids), mask, self._a, self._b,
                                 normalize=self.cfg.normalize)[:bsz]

    def features_from_stream(self, scan, offsets: np.ndarray, lengths: np.ndarray,
                             lmax_floor: int = 0) -> torch.Tensor:
        """Fused path over the stream's scan (a ``kernels.ingest.StreamScan``
        or a host [n] uint32 array). ``lmax_floor`` (the chunker's max
        chunk size) pins the Lmax bucket, as in the reference."""
        from repro_torch.kernels import ingest
        return ingest.extract_stream(
            scan, np.asarray(offsets, np.int64), np.asarray(lengths, np.int64),
            self._a, self._b, k=self.cfg.k, n=self.cfg.n,
            normalize=self.cfg.normalize, lmax_floor=lmax_floor)

    def __call__(self, chunks: list[bytes], stream_hashes=None,
                 offsets: np.ndarray | None = None, lmax_floor: int = 0) -> torch.Tensor:
        """[B, M] float32 initial features (on the extractor's device) for
        a list of chunk payloads; ``stream_hashes`` / ``offsets`` are the
        chunker's scan and each chunk's start in that stream."""
        from repro_torch.kernels import ingest
        if not chunks:
            return torch.zeros(0, self.cfg.m, dtype=torch.float32, device=self.device)
        if (self.fused and self.cfg.lsh == "maxgear"
                and stream_hashes is not None and offsets is not None
                # positions past the limit take the per-chunk path
                and len(stream_hashes) <= ingest.FUSED_STREAM_LIMIT):
            lengths = np.fromiter((len(c) for c in chunks), np.int64, len(chunks))
            return self.features_from_stream(stream_hashes, offsets, lengths,
                                             lmax_floor=lmax_floor)
        return self.features_from_subhashes(batch_subchunk_lsh(
            chunks, self.cfg, stream_hashes, offsets, self.device))
