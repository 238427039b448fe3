"""Transformer layers (port of ``repro.models.layers`` outside a mesh):
RMSNorm, RoPE (partial rotary included), GQA attention, the SwiGLU and
GeLU MLPs and top-k routed experts with capacity (MoE), as
``nn.Module``s.

Every parameter keeps the reference's layout (``wq`` [d, H, hd], ``wk`` /
``wv`` [d, KV, hd], ``wo`` [H, hd, d], ``w_gate`` / ``w_up`` / ``w_in``
[d, f], ``w_down`` [f, d], the MoE ``router`` [d, E] in f32 and
``e_gate`` / ``e_up`` / ``e_in`` [E*s, d, f/s], ``e_down`` [E*s, f/s, d],
norm ``scale`` [d] in f32), so carrying weights across is a copy.
Projections keep ``pe``'s contract: the operands are the activation and
the weight in their own dtypes (bf16 in the full model), and the product
comes out in the activation dtype.

Attention routes by what it is given:
- with a KV cache (decode), the dense cached attention in torch ops,
  scores in f32 (``_dense_attention``); the reference also computes that
  outside any Pallas kernel;
- every other attention goes through kernel D (``ops.flash_attention``),
  at every length: causal self-attention (``causal=True``), the audio
  encoder's non-causal self-attention (``causal=False``, rotated at
  positions ``arange(T)``) and cross-attention over ``memory`` (q from x,
  k and v from memory, neither rotated, never causal; in a decode step
  too, at Tq 1). The reference computes the cross and encoder cases in
  ``_dense_attention(causal=False)`` and splits causal dense from chunked
  at 8192 tokens (``layers.py:210-215``); every branch is the function
  its Pallas kernel computes (keys past Tk masked, ``flash_attn.py:46-49``),
  and the kernel never materialises the scores, so the port needs no
  split.

MoE routing, dispatch and combine are torch ops, as the reference
computes them outside any Pallas kernel; the experts' products are
batched matmuls, the reference's ``pe`` einsums. Only the reference's
no-mesh branch is ported (``moe`` raises if given a mesh).
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


def _param(shape, gen, in_axes, dtype, device) -> nn.Parameter:
    return nn.Parameter(dense_init(shape, gen, in_axes, dtype, device), requires_grad=False)


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
    """GQA self- or cross-attention sublayer (projections, RoPE, mixing,
    out-proj)."""

    def __init__(self, cfg, gen: torch.Generator, device=None):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.head_dim, dtype_of(cfg)
        self.cfg = cfg
        init = lambda shape, in_axes=(0,): _param(shape, gen, in_axes, dt, device)
        self.wq = init((d, cfg.num_heads, hd))
        self.wk = init((d, cfg.num_kv_heads, hd))
        self.wv = init((d, cfg.num_kv_heads, hd))
        self.wo = init((cfg.num_heads, hd, d), in_axes=(0, 1))

    def forward(self, x: torch.Tensor, *, causal: bool = True,
                kv_cache: dict | None = None, pos: int | None = None,
                memory: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, T, d]. With ``memory`` [B, T_mem, d], cross-attention: k
        and v come from memory, nothing is rotated and no key is masked.
        With ``kv_cache`` ({"k", "v": [B, T_max, KV, hd]}) and ``pos``,
        writes this step's K/V into the cache in place (the reference
        returns a new cache) and attends over it."""
        cfg = self.cfg
        src = x if memory is None else memory
        q = project(x, self.wq, 1)
        k = project(src, self.wk, 1)
        v = project(src, self.wv, 1)
        if memory is None:
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
                                      causal=causal and memory is None)
        return project(out, self.wo, 2)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return nn.functional.gelu(x, approximate="tanh")


class MLP(nn.Module):
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``) or GeLU (``w_in``,
    ``w_down``) MLP, by ``cfg.act``."""

    def __init__(self, cfg, gen: torch.Generator, device=None):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, dtype_of(cfg)
        init = lambda shape: _param(shape, gen, (0,), dt, device)
        if cfg.act == "swiglu":
            self.w_gate = init((d, f))
            self.w_up = init((d, f))
        else:
            self.w_in = init((d, f))
        self.w_down = init((f, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "w_gate"):
            g = project(x, self.w_gate, 1)
            u = project(x, self.w_up, 1)
            h = nn.functional.silu(g.float()).to(x.dtype) * u
        else:
            h = gelu(project(x, self.w_in, 1).float()).to(x.dtype)
        return project(h, self.w_down, 1)


# --- MoE: top-k routing with capacity, local dispatch (the no-mesh branch) ------

# tokens a combine step gathers at once: bounds the [tokens * k, d] f32
# contributions (2.1 GB at 32,768 tokens of qwen3-moe, top-8) to an eighth
COMBINE_TOKENS = 4096


class MoE(nn.Module):
    """Routed experts (``init_moe``): a router [d, E] kept in f32 and
    ``moe_ffn_shards`` virtual experts a logical one, [E*s, d, f/s] each,
    SwiGLU (``e_gate``, ``e_up``) or GeLU (``e_in``) by ``cfg.act``.
    ``forward`` returns (output, load-balance loss)."""

    def __init__(self, cfg, gen: torch.Generator, device=None):
        super().__init__()
        d, f, e, s = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.moe_ffn_shards
        ev, fv, dt = e * s, f // s, dtype_of(cfg)
        self.cfg = cfg
        self.router = _param((d, e), gen, (0,), torch.float32, device)
        if cfg.act == "swiglu":
            self.e_gate = _param((ev, d, fv), gen, (1,), dt, device)
            self.e_up = _param((ev, d, fv), gen, (1,), dt, device)
        else:
            self.e_in = _param((ev, d, fv), gen, (1,), dt, device)
        self.e_down = _param((ev, fv, d), gen, (1,), dt, device)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return moe(dict(self.named_parameters()), x, self.cfg)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, a tie going
    to the lower index (a stable descending sort; ``torch.topk`` promises
    no order among equals)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_and_dispatch(xt: torch.Tensor, router: torch.Tensor, e: int, k: int, cap: int,
                        shards: int = 1):
    """Top-k routing -> slot positions -> the [E_v, C, d] dispatch buffer.

    The position of an assignment within its expert is the number of
    earlier assignments, in token-major [T*kv] order, that chose the same
    expert: the count the reference's cumsum over the one-hot takes, so
    the same assignments are kept; those at or past ``cap`` are dropped.
    With ``shards`` > 1 each choice fans out to ``shards`` virtual experts
    carrying the same gate. Returns (buf, slot, st, gate_flat, keep,
    probs, expert), the reference's values."""
    t, d = xt.shape
    probs = torch.softmax(xt.float() @ router, dim=-1)
    gate, expert = _top_k(probs, k)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    ev, kv = e * shards, k * shards
    if shards > 1:
        arange = torch.arange(shards, device=xt.device)
        expert_v = (expert[..., None] * shards + arange).reshape(t, kv)
        gate_v = gate.repeat_interleave(shards, dim=-1)
    else:
        expert_v, gate_v = expert, gate
    flat_e = expert_v.reshape(-1)                                   # [T*kv] token-major
    # a stable sort groups the assignments by expert in token-major order,
    # so an assignment's rank within its group is its position; the
    # one-hot cumsum down T*kv rows took 73 % of a 32,768-token qwen3-moe
    # prefill on an H100
    order = torch.sort(flat_e, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(flat_e.numel(), device=xt.device)
    counts = torch.bincount(flat_e, minlength=ev)
    pos = rank - (torch.cumsum(counts, 0) - counts)[flat_e]
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, ev * cap)          # dropped -> the pad row
    st = torch.arange(t * kv, device=xt.device) // kv
    # the buffer as a gather: each kept slot names its token, the rest the
    # zero row past the end (the reference scatters xt[st], the same rows)
    src = torch.full((ev * cap + 1,), t, dtype=torch.int64, device=xt.device)
    src[slot] = torch.where(keep, st, t)
    buf = torch.cat([xt, xt.new_zeros(1, d)])[src[:-1]]
    return buf.reshape(ev, cap, d), slot, st, gate_v.reshape(-1), keep, probs, expert


def _combine(y_flat: torch.Tensor, slot: torch.Tensor, gate_flat: torch.Tensor,
             keep: torch.Tensor, t: int, kv: int) -> torch.Tensor:
    """Inverse of dispatch: gather each assignment's output, weight it by
    its gate (0 where dropped) and sum over the k axis in f32. The
    reference's ``.at[st].add`` with ``st = arange(T*kv) // kv`` is this
    sum over a [T, kv, d] view; done as a sum it needs no atomics, so the
    card gives the same result on every run."""
    d = y_flat.shape[1]
    pad = torch.cat([y_flat, y_flat.new_zeros(1, d)])
    w = (gate_flat * keep).float()[:, None]
    out = torch.empty(t, d, dtype=torch.float32, device=y_flat.device)
    for t0 in range(0, t, COMBINE_TOKENS):
        a, b = t0 * kv, min(t, t0 + COMBINE_TOKENS) * kv
        out[t0:t0 + (b - a) // kv] = (pad[slot[a:b]].float() * w[a:b]).view(-1, kv, d).sum(1)
    return out


def _expert_ffn(params: dict, h: torch.Tensor) -> torch.Tensor:
    """[E_v, C, d] -> [E_v, C, d]: each expert's FFN as batched matmuls in
    the activation dtype."""
    if "e_gate" in params:
        g = torch.bmm(h, params["e_gate"])
        u = torch.bmm(h, params["e_up"])
        a = nn.functional.silu(g.float()).to(h.dtype) * u
    else:
        a = gelu(torch.bmm(h, params["e_in"]).float()).to(h.dtype)
    return torch.bmm(a, params["e_down"])


def _load_balance_loss(probs: torch.Tensor, expert: torch.Tensor, e: int, k: int
                       ) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * p_e."""
    onehot = nn.functional.one_hot(expert, e).float().sum(1)       # [T, E]
    f = onehot.mean(0) / k
    p = probs.mean(0)
    return e * torch.sum(f * p)


def moe(params: dict, x: torch.Tensor, cfg, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed experts with capacity over x [B, S, d] -> (out [B, S,
    d] in x's dtype, aux loss): the reference's branch outside a mesh,
    with its capacity ``min(ceil(t*kv*capacity_factor/E_v), t)`` at every
    t, decode included. The expert-parallel branch is not ported: a mesh
    raises."""
    if mesh is not None:
        raise NotImplementedError("MoE over a device mesh is not yet ported")
    b, s, d = x.shape
    e, k, vs = cfg.num_experts, cfg.experts_per_token, cfg.moe_ffn_shards
    ev, kv = e * vs, k * vs
    t = b * s
    cap = min(int(np.ceil(t * kv * cfg.capacity_factor / ev)), t)
    buf, slot, _, gate_flat, keep, probs, expert = _route_and_dispatch(
        x.reshape(t, d), params["router"], e, k, cap, vs)
    y = _expert_ffn(params, buf).reshape(ev * cap, d)
    del buf
    out = _combine(y, slot, gate_flat, keep, t, kv)
    aux = _load_balance_loss(probs, expert, e, k)
    return out.to(x.dtype).reshape(b, s, d), aux
