"""Dense transformer layers (port of the dense part of
``repro.models.layers``): RMSNorm, RoPE (partial rotary included), GQA
attention and the SwiGLU MLP, as ``nn.Module``s.

Every parameter keeps the reference's layout (``wq`` [d, H, hd], ``wk`` /
``wv`` [d, KV, hd], ``wo`` [H, hd, d], ``w_gate`` / ``w_up`` [d, f],
``w_down`` [f, d], norm ``scale`` [d] in f32), so carrying weights across
is a copy. Projections keep ``pe``'s contract: the operands are the
activation and the weight in their own dtypes (bf16 in the full model),
and the product comes out in the activation dtype.

Attention routes by what it is given:
- with a KV cache (decode), the dense cached attention in torch ops,
  scores in f32 (``_dense_attention``); the reference also computes that
  outside any Pallas kernel;
- every other causal self-attention goes through kernel D
  (``ops.flash_attention``), at every length. The reference splits dense
  from chunked at 8192 tokens (``layers.py:212``) to bound XLA's memory;
  both branches compute the same function, and the kernel never
  materialises the scores, so the port needs no split;
- cross-attention memory is not in this slice and raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ops

NEG_INF = -1e30


def dtype_of(cfg) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def dense_init(shape, gen: torch.Generator, in_axes=(0,), dtype=torch.float32,
               device=None) -> torch.Tensor:
    """N(0, 1) / sqrt(fan_in) in f32, cast to ``dtype`` (``dense_init``'s
    std rule; the draws are torch's own)."""
    fan_in = int(np.prod([shape[a] for a in in_axes]))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * (1.0 / np.sqrt(fan_in))).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32, device=device),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps)


def rope_freqs(head_dim: int, fraction: float, theta: float) -> np.ndarray:
    rot = int(head_dim * fraction) // 2 * 2
    return 1.0 / theta ** (np.arange(0, rot, 2, dtype=np.float32) / rot)


@functools.lru_cache(maxsize=None)
def _freqs_on(head_dim: int, fraction: float, theta: float,
              device: torch.device) -> torch.Tensor:
    """``rope_freqs`` uploaded once per device: a copy from pageable host
    memory blocks the host until the stream drains, and RoPE runs twice in
    every attention sublayer."""
    return torch.from_numpy(rope_freqs(head_dim, fraction, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, fraction: float,
               theta: float) -> torch.Tensor:
    """x [B, T, H, hd]; positions [T] or [B, T] (interleaved pairs)."""
    hd = x.shape[-1]
    rot = int(hd * fraction) // 2 * 2
    if rot == 0:
        return x
    freqs = _freqs_on(hd, fraction, theta, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs                  # [B, T, rot/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    rotated = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    rotated = rotated.reshape(x[..., :rot].shape).to(x.dtype)
    if rot == hd:
        return rotated
    return torch.cat([rotated, x[..., rot:]], dim=-1)


def project(x: torch.Tensor, w: torch.Tensor, n_in: int) -> torch.Tensor:
    """``pe``: contract the last ``n_in`` axes of x with the first ``n_in``
    of w; the product comes out in x's dtype."""
    lead, tail = x.shape[:x.dim() - n_in], w.shape[n_in:]
    k = int(np.prod(w.shape[:n_in]))
    y = x.reshape(-1, k) @ w.reshape(k, -1)
    return y.view(*lead, *tail)


def _dense_attention(q, k, v, *, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """q [B, Tq, H, hd], k/v [B, Tk, KV, hd], scores materialised (the
    decode path). As the reference: q scaled in its own dtype, f32 scores
    and softmax, probabilities in q's dtype, f32 accumulation."""
    b, tq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, tq, kvh, g, hd) * torch.tensor(hd ** -0.5, dtype=q.dtype)
    s = torch.einsum("bqkgd,bjkd->bkgqj", qg.float(), k.float())
    if causal:
        qpos = q_offset + torch.arange(tq, device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqj,bjkd->bqkgd", p.float(), v.float())
    return out.reshape(b, tq, h, hd).to(q.dtype)


class Attention(nn.Module):
    """GQA self-attention sublayer (projections, RoPE, mixing, out-proj)."""

    def __init__(self, cfg, gen: torch.Generator, device=None):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.head_dim, dtype_of(cfg)
        self.cfg = cfg
        init = lambda shape, in_axes=(0,): nn.Parameter(
            dense_init(shape, gen, in_axes, dt, device), requires_grad=False)
        self.wq = init((d, cfg.num_heads, hd))
        self.wk = init((d, cfg.num_kv_heads, hd))
        self.wv = init((d, cfg.num_kv_heads, hd))
        self.wo = init((cfg.num_heads, hd, d), in_axes=(0, 1))

    def forward(self, x: torch.Tensor, *, kv_cache: dict | None = None,
                pos: int | None = None, memory: torch.Tensor | None = None
                ) -> torch.Tensor:
        """x [B, T, d]. With ``kv_cache`` ({"k", "v": [B, T_max, KV, hd]})
        and ``pos``, writes this step's K/V into the cache in place (the
        reference returns a new cache) and attends over it."""
        if memory is not None:
            raise NotImplementedError("cross-attention is not yet ported")
        cfg = self.cfg
        q = project(x, self.wq, 1)
        k = project(x, self.wk, 1)
        v = project(x, self.wv, 1)
        if pos is None:
            positions = torch.arange(x.shape[1], device=x.device)
        else:
            positions = torch.full((x.shape[0], x.shape[1]), pos, device=x.device)
        q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
        if kv_cache is not None:
            if pos is None:
                raise ValueError("a KV cache needs pos")
            t = x.shape[1]
            kv_cache["k"][:, pos:pos + t] = k.to(kv_cache["k"].dtype)
            kv_cache["v"][:, pos:pos + t] = v.to(kv_cache["v"].dtype)
            out = _dense_attention(q, kv_cache["k"], kv_cache["v"], causal=True,
                                   q_offset=pos)
        else:
            out = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                      causal=True)
        return project(out, self.wo, 2)


class MLP(nn.Module):
    """SwiGLU MLP (the only activation of the ported dense configs)."""

    def __init__(self, cfg, gen: torch.Generator, device=None):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, dtype_of(cfg)
        init = lambda shape: nn.Parameter(dense_init(shape, gen, (0,), dt, device),
                                          requires_grad=False)
        self.w_gate = init((d, f))
        self.w_up = init((d, f))
        self.w_down = init((f, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = project(x, self.w_gate, 1)
        u = project(x, self.w_up, 1)
        h = nn.functional.silu(g.float()).to(x.dtype) * u
        return project(h, self.w_down, 1)
