"""BP-neural-network chunk-context aware model (paper §4.3; port of
``repro.core.context_model``).

Word2vec-CBOW-shaped two-matrix linear network:

    Formula 1:  h_i       = (1/2K) * (sum of 2K context features) @ W     [D]
    Formula 2:  out_i     = (1/2K) * h_i @ U                              [M]
    Formula 3:  vector'_j = 2K * vector_j @ pinv(U)                       [D]

trained as cosine + MSE regression of ``out_i`` on the target chunk's
initial feature, with Adam (b1 0.9, b2 0.95, eps 1e-8, no weight decay —
the update of the reference's ``optim.adamw``). The fit's products, row
sums and norms accumulate in float64 and round once to float32, so it
ends at the same weights on the card and on the CPU.

The reference draws its init from ``jax.random``, which torch cannot
replay. At the (m, d, seed) that the port ships a fixture for
(``fixtures/``, written by ``scripts/make_context_init.py``), the default
init is the reference's own ``init_params``, bit for bit; elsewhere the
port draws its own from a ``torch.Generator`` seeded with ``cfg.seed``.
``ContextModel.init_source`` says which, and ``fit`` also accepts initial
params. The batch-index stream is numpy ``PCG64(cfg.seed)``, as in the
reference, so it replays exactly.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class ContextModelConfig:
    m: int = 64           # initial feature dim (paper M)
    d: int = 50           # context-aware feature dim (paper D; 40..80 in Tab.1)
    k: int = 2            # context half width -> 2K surrounding chunks
    lr: float = 3e-3
    steps: int = 300
    batch_size: int = 256
    mse_weight: float = 1.0
    cos_weight: float = 1.0
    seed: int = 0


FIXTURES = Path(__file__).resolve().parent / "fixtures"


def reference_init(cfg: ContextModelConfig) -> tuple[np.ndarray, np.ndarray] | None:
    """The reference's initial (w [m, d], u [d, m]) for ``cfg``'s widths and
    seed, where the port ships them; else None."""
    stem = f"context_init_m{cfg.m}_d{cfg.d}_seed{cfg.seed}"
    paths = [FIXTURES / f"{stem}.{name}.npy" for name in ("w", "u")]
    if not all(p.exists() for p in paths):
        return None
    w, u = (np.load(p) for p in paths)
    if w.shape != (cfg.m, cfg.d) or u.shape != (cfg.d, cfg.m):
        raise ValueError(f"{stem}: shapes {w.shape}, {u.shape}")
    return w, u


def make_training_pairs(features: torch.Tensor, k: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ctx_mean [T, M], target [T, M]) from the stream-ordered feature seq.

    Context of chunk i = the k chunks before and k after, edge-truncated
    (mean over however many neighbours exist)."""
    t, m = features.shape
    features = features.to(torch.float32)
    ctx_sum = torch.zeros(t, m, dtype=torch.float32, device=features.device)
    ctx_cnt = torch.zeros(t, 1, dtype=torch.float32, device=features.device)
    for off in range(1, k + 1):
        ctx_sum[off:] += features[:-off]
        ctx_cnt[off:] += 1
        ctx_sum[:-off] += features[off:]
        ctx_cnt[:-off] += 1
    return ctx_sum / torch.clamp(ctx_cnt, min=1.0), features


class ContextModel(nn.Module):
    """Train-then-predict context model: ``w [M, D]``, ``u [D, M]``.

    ``init_source`` names where the current params came from:
    ``"reference"`` (the shipped fixture of the reference's init),
    ``"torch"`` (the seeded torch draw) or ``"given"`` (``set_params``,
    ``load`` or ``fit(init=...)``)."""

    def __init__(self, cfg: ContextModelConfig | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        self.cfg = cfg or ContextModelConfig()
        self.device = ops.resolve_device(device)
        self.w = nn.Parameter(torch.empty(self.cfg.m, self.cfg.d, device=self.device))
        self.u = nn.Parameter(torch.empty(self.cfg.d, self.cfg.m, device=self.device))
        self.reset_parameters()
        self.u_pinv: torch.Tensor | None = None
        self.losses: list[float] = []

    def reset_parameters(self) -> None:
        cfg = self.cfg
        ref = reference_init(cfg)
        if ref is not None:
            self.set_params(*ref)
            self.init_source = "reference"
            return
        g = torch.Generator().manual_seed(cfg.seed)
        with torch.no_grad():
            self.w.copy_(torch.randn(cfg.m, cfg.d, generator=g) / np.sqrt(cfg.m))
            self.u.copy_(torch.randn(cfg.d, cfg.m, generator=g) / np.sqrt(cfg.d))
        self.init_source = "torch"

    def set_params(self, w: np.ndarray, u: np.ndarray) -> None:
        with torch.no_grad():
            self.w.copy_(torch.from_numpy(np.array(w, np.float32)))
            self.u.copy_(torch.from_numpy(np.array(u, np.float32)))
        self.init_source = "given"

    def forward(self, ctx_mean: torch.Tensor) -> torch.Tensor:
        """ctx_mean [B, M] (already the 1/2K-scaled context sum) -> out [B, M].

        Each product accumulates in float64 from the float32 operands and
        rounds once to float32 (through autograd, so do the gradient
        products), so no sum depends on the order a device's library
        takes it in."""
        h = (ctx_mean.double() @ self.w.double()).float()            # Formula 1
        return (h.double() @ self.u.double()).float()                 # Formula 2 (1/2K folded in)

    def loss_fn(self, ctx_mean: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Cosine + MSE regression loss of ``forward(ctx_mean)`` on
        ``target``, its row sums and norms in float64. With ``forward``'s
        products this makes a fit on the card end where one on the CPU
        does (ROADMAP Queue 3 item 1). Weights, Adam moments and updates
        stay float32: the algorithm is the reference's float32 one."""
        cfg = self.cfg
        out = self(ctx_mean).double()
        tgt = target.double()
        mse = torch.mean(torch.sum(torch.square(out - tgt), dim=-1))
        tn = tgt / (torch.linalg.norm(tgt, dim=-1, keepdim=True) + 1e-9)
        on = out / (torch.linalg.norm(out, dim=-1, keepdim=True) + 1e-9)
        cos = torch.mean(1.0 - torch.sum(tn * on, dim=-1))
        return cfg.mse_weight * mse + cfg.cos_weight * cos

    def fit(self, stream_features, init: tuple[np.ndarray, np.ndarray] | None = None
            ) -> "ContextModel":
        """Train on a stream-ordered [T, M] feature sequence, from ``init``
        (w, u) when given, else from this model's seeded init."""
        cfg = self.cfg
        feats = torch.as_tensor(stream_features, dtype=torch.float32).to(self.device)
        ctx, tgt = make_training_pairs(feats, cfg.k)
        if init is None:
            self.reset_parameters()
        else:
            self.set_params(*init)
        # one implementation on every device: torch picks `foreach` for CUDA
        # tensors and the single-tensor loop for CPU ones unless told
        opt = torch.optim.Adam(self.parameters(), lr=cfg.lr, betas=(0.9, 0.95),
                               eps=1e-8, weight_decay=0.0, foreach=False, fused=False)
        rng = np.random.Generator(np.random.PCG64(cfg.seed))
        n = ctx.shape[0]
        bs = min(cfg.batch_size, n)
        losses = []
        for _ in range(cfg.steps):
            idx = torch.from_numpy(rng.integers(0, n, size=bs)).to(self.device)
            opt.zero_grad(set_to_none=True)
            loss = self.loss_fn(ctx[idx], tgt[idx])
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        self.losses = [float(x) for x in torch.stack(losses).cpu()] if losses else []
        self._refresh_pinv()
        return self

    def _refresh_pinv(self) -> None:
        # Formula 3's U^{-1}: Moore-Penrose with small singular values
        # truncated (rtol 0.1, the reference's choice)
        with torch.no_grad():
            self.u_pinv = torch.linalg.pinv(self.u.detach(), rtol=0.1)   # [M, D]

    def load(self, w: np.ndarray, u: np.ndarray) -> "ContextModel":
        """Adopt trained params (w [M, D], u [D, M]) without training."""
        self.set_params(w, u)
        self._refresh_pinv()
        return self

    @torch.no_grad()
    def transform(self, features: torch.Tensor) -> torch.Tensor:
        """Formula 3: initial feature [*, M] -> context-aware feature [*, D],
        L2-normalised (search runs on cosine similarity)."""
        if self.u_pinv is None:
            raise RuntimeError("fit() or load() first")
        f = torch.as_tensor(features, dtype=torch.float32).to(self.device)
        v = (2 * self.cfg.k) * (f @ self.u_pinv)
        return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-12)
