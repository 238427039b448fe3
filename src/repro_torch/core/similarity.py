"""Resemblance indexes over context-aware features (port of
``repro.core.similarity``).

  * exact (``CosineIndex``): tiled cosine top-1 against the stored
    feature matrix, kernel C on the card;
  * banded (``BandedLSHIndex``): SimHash banding for sub-linear candidate
    lookup (sign random projections -> ``bands`` bucket tables), exact
    rerank of the candidates.

For the exact index, the stored features live on the index's device in an amortised-doubling
row buffer, so inserts are O(D) and a query sees one contiguous matrix.
Large queries go through kernel C (``ops.sim_topk``, a tiled top-1 with a
running max); small ones take the plain ``q @ index^T`` path, under the
reference's gate (index >= 512 rows and batch >= 8 rows). That product,
and the detector's intra-stream ``feats @ feats^T``, go through
``exact_matmul``: a verdict compares a score with 0.3, so it must not
depend on whether the caller enabled TF32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.registry import register_index
from repro_torch.kernels import ops

KERNEL_MIN_ROWS = 512
KERNEL_MIN_BATCH = 8


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full fp32 whatever the global TF32 settings.

    TF32 is turned off for this product, through the API the caller set
    it with (torch refuses to read through one API a state set through
    the other): the legacy ``allow_tf32`` / ``set_float32_matmul_precision``,
    or ``fp32_precision`` where this torch has it. Afterwards the legacy
    precision and every ``fp32_precision`` it touches come back as they were."""
    cublas = torch.backends.cuda.matmul
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:                   # set through fp32_precision only
        legacy = None
    knobs = []                             # (module, fp32_precision) where this torch has it
    for mod in (cublas, getattr(torch.backends.mkldnn, "matmul", None)):
        try:
            knobs.append((mod, mod.fp32_precision))
        except AttributeError:
            pass
    if legacy is not None:
        cublas.allow_tf32 = False          # sets both APIs' cuBLAS state
    else:
        cublas.fp32_precision = "ieee"
    try:
        return torch.matmul(a, b)
    finally:
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy)
        for mod, value in knobs:
            mod.fp32_precision = value


@register_index("exact")
class CosineIndex:
    """Append-only exact cosine top-1 index (features assumed L2-normalised)."""

    def __init__(self, dim: int, threshold: float = 0.3, use_kernel: bool = True,
                 device: str | torch.device | None = None):
        """``use_kernel=False`` names the reference's path that skips its
        kernel: on the CPU the port runs the plain version anyway; on the
        card it has no such path, and raises."""
        self.dim = dim
        self.threshold = threshold
        self.device = ops.resolve_device(device)
        if not use_kernel and self.device.type == "cuda":
            raise ValueError("use_kernel=False: on the card the port runs its "
                             "kernels and has no path that skips them")
        self._buf = torch.zeros(1024, dim, dtype=torch.float32, device=self.device)
        self._ids = np.zeros(1024, np.int64)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def _grow(self, need: int) -> None:
        cap = self._buf.shape[0]
        if self._n + need <= cap:
            return
        new_cap = max(cap * 2, self._n + need)
        buf = torch.zeros(new_cap, self.dim, dtype=torch.float32, device=self.device)
        buf[:self._n] = self._buf[:self._n]
        self._buf = buf
        self._ids = np.concatenate([self._ids, np.zeros(new_cap - cap, np.int64)])

    def insert(self, feature, chunk_id: int) -> None:
        self.insert_batch(torch.as_tensor(feature, dtype=torch.float32)[None],
                          np.asarray([chunk_id], np.int64))

    def insert_batch(self, features: torch.Tensor, chunk_ids: np.ndarray) -> None:
        k = features.shape[0]
        self._grow(k)
        self._buf[self._n:self._n + k] = features.to(self.device, torch.float32)
        self._ids[self._n:self._n + k] = chunk_ids
        self._n += k

    def query(self, features: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
        """[B, D] -> (best chunk_id [B] or -1, best score [B]) on the host."""
        q = torch.atleast_2d(torch.as_tensor(features, dtype=torch.float32)).to(self.device)
        if self._n == 0:
            return np.full(q.shape[0], -1, np.int64), np.zeros(q.shape[0], np.float32)
        index = self._buf[:self._n]
        if self._n >= KERNEL_MIN_ROWS and q.shape[0] >= KERNEL_MIN_BATCH:
            score, arg = ops.sim_topk(q.contiguous(), index)
        else:
            sims = exact_matmul(q, index.T)
            arg = sims.argmax(dim=1)
            score = sims.gather(1, arg[:, None])[:, 0]
        score = score.cpu().numpy()
        ids = self._ids[arg.cpu().numpy().astype(np.int64)]
        ids = np.where(score >= self.threshold, ids, -1)
        return ids, score


@register_index("banded-lsh")
class BandedLSHIndex:
    """SimHash banding: ``bands`` tables keyed by ``band_bits``-bit sign
    patterns, the reference's planes (``PCG64(seed)``) and keys.

    The tables are host dicts and the keys are computed on the host in
    float32 numpy with the reference's ``einsum``, so a projection within
    ulps of 0 takes the reference's sign and bucket. Features come up from
    the device once per ``query`` / ``insert_batch``; the rerank of a
    query's candidates is a host product, as in the reference."""

    def __init__(self, dim: int, bands: int = 16, band_bits: int = 6,
                 threshold: float = 0.3, seed: int = 11,
                 device: str | torch.device | None = None):
        # recall at cos=0.6: 1-(1-(1-acos(.6)/pi)^6)^16 ~ 0.9; at cos=0.9 ~ 1.0
        self.device = ops.resolve_device(device)
        rng = np.random.Generator(np.random.PCG64(seed))
        self.threshold = threshold
        self.bands = bands
        self.band_bits = band_bits
        self._planes = rng.standard_normal((bands, band_bits, dim)).astype(np.float32)
        self._tables: list[dict[int, list[int]]] = [dict() for _ in range(bands)]
        self._feats: dict[int, np.ndarray] = {}

    @staticmethod
    def _host(features) -> np.ndarray:
        if isinstance(features, torch.Tensor):
            features = features.detach().cpu().numpy()
        return np.atleast_2d(np.asarray(features, np.float32))

    def _keys_batch(self, features: np.ndarray) -> np.ndarray:
        """[n, D] -> [n, bands] bucket keys in one projection einsum."""
        signs = np.einsum("bkd,nd->nbk", self._planes, features) > 0
        weights = 1 << np.arange(self.band_bits, dtype=np.uint64)
        return (signs.astype(np.uint64) * weights).sum(axis=2)

    def insert(self, feature, chunk_id: int) -> None:
        self.insert_batch(self._host(feature), np.asarray([chunk_id], np.int64))

    def insert_batch(self, features, chunk_ids: np.ndarray) -> None:
        features = self._host(features)
        keys = self._keys_batch(features)
        for i, cid in enumerate(chunk_ids):
            cid = int(cid)
            self._feats[cid] = features[i]
            row = keys[i]
            for b in range(self.bands):
                self._tables[b].setdefault(int(row[b]), []).append(cid)

    def _rerank(self, feature: np.ndarray, keys: np.ndarray) -> tuple[int, float]:
        cands: list[int] = []
        for b in range(self.bands):
            cands.extend(self._tables[b].get(int(keys[b]), ()))
        if not cands:
            return -1, 0.0
        cand_ids = np.unique(np.asarray(cands, np.int64))
        sims = np.stack([self._feats[int(c)] for c in cand_ids]) @ feature
        best = int(sims.argmax())
        score = float(sims[best])
        if score < self.threshold:
            return -1, score
        return int(cand_ids[best]), score

    def query_one(self, feature) -> tuple[int, float]:
        feature = self._host(feature)
        return self._rerank(feature[0], self._keys_batch(feature)[0])

    def query(self, features) -> tuple[np.ndarray, np.ndarray]:
        """[B, D] -> (best chunk_id [B] or -1, best score [B]) on the host."""
        q = self._host(features)
        keys = self._keys_batch(q)
        out_id = np.empty(q.shape[0], np.int64)
        out_sc = np.empty(q.shape[0], np.float32)
        for i, f in enumerate(q):
            out_id[i], out_sc[i] = self._rerank(f, keys[i])
        return out_id, out_sc
