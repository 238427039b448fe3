"""Exact cosine resemblance index (port of ``repro.core.similarity.CosineIndex``).

The stored features live on the index's device in an amortised-doubling
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

    def __init__(self, dim: int, threshold: float = 0.3,
                 device: str | torch.device | None = None):
        self.dim = dim
        self.threshold = threshold
        self.device = ops.resolve_device(device)
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
