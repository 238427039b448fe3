"""Transformer layers (port of ``repro.models.layers``): RMSNorm, RoPE
(partial rotary included), GQA attention, the SwiGLU and GeLU MLPs and
top-k routed experts with capacity (MoE), as ``nn.Module``s.

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
batched matmuls, the reference's ``pe`` einsums.

On a device mesh (``distributed.sharding.use_rules(rules, mesh)``, the
params and activations DTensors) the sublayers annotate their
activations with the reference's ``constrain`` calls. Attention runs
kernel D inside ``shard_map`` on each rank's batch rows and q heads, with
the kv heads those q heads use; ``moe`` takes the reference's ``"ep"``
(experts over "model", one ``all_to_all`` pair) or ``"tp"`` (expert FFNs
split over "model", a ``psum``) branch. A decode step attends over a KV
cache laid out on the mesh (its sequence split over "cache_seq" where the
rules say so), its softmax combined across the ranks
(``_decode_attention_on_mesh``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.distributed import sharding as shd
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


def _dense_attention(q, k, v, *, causal: bool, q_offset: int = 0, k_offset: int = 0,
                     seq_axes=None) -> torch.Tensor:
    """q [B, Tq, H, hd], k/v [B, Tk, KV, hd], scores materialised (the
    decode path). As the reference: q scaled in its own dtype, f32 scores
    and softmax, probabilities in q's dtype, f32 accumulation.

    Inside ``shard_map`` with ``seq_axes`` (a mesh axis or a tuple of
    them), k and v are this rank's block of a key sequence split over
    those axes, its first key at global position ``k_offset``: the
    softmax's max and sum and the mixed values are combined over the axes
    (``pmax``, then ``psum``). The global max is taken before the exp, so
    a rank whose keys all lie past the query (masked) adds zeros; the
    probabilities are divided by the global sum and rounded to q's dtype
    before the mix, as the single-device softmax rounds them."""
    b, tq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, tq, kvh, g, hd) * torch.tensor(hd ** -0.5, dtype=q.dtype)
    s = torch.einsum("bqkgd,bjkd->bkgqj", qg.float(), k.float())
    if causal:
        qpos = q_offset + torch.arange(tq, device=q.device)[:, None]
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, NEG_INF)
    if seq_axes:
        e = torch.exp(s - shd.pmax(s.amax(dim=-1, keepdim=True), seq_axes))
        p = (e / shd.psum(e.sum(dim=-1, keepdim=True), seq_axes)).to(q.dtype)
    else:
        p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqj,bjkd->bqkgd", p.float(), v.float())
    if seq_axes:
        out = shd.psum(out, seq_axes)
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
        q = shd.constrain(q, "batch", "seq", "heads", None)
        k = shd.constrain(k, "batch", "seq", "kv_heads", None)
        if isinstance(q, DTensor):
            if kv_cache is not None:
                if pos is None:
                    raise ValueError("a KV cache needs pos")
                out = _decode_attention_on_mesh(q, k, v, kv_cache, pos, cfg)
            else:
                out = _attention_on_mesh(q, k, v, cfg, causal=causal and memory is None,
                                         rotate=memory is None)
            out = shd.constrain(out, "batch", "seq", "heads", None)
            return shd.constrain(project(out, self.wo, 2), "batch", "seq", "d_model")
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


def _local_kv_heads(h: int, kvh: int, m: int, i: int) -> list[int] | slice:
    """The kv heads that shard i of m (q heads ``[i*h/m, (i+1)*h/m)``)
    uses, as kernel D wants them: a slice where the shard's q heads map
    onto it in GQA order (q head j -> kv head j // group), else one kv
    head a q head (group 1)."""
    g, hl = h // kvh, h // m
    want = [(i * hl + j) // g for j in range(hl)]
    lo, hi = want[0], want[-1] + 1
    n = hi - lo
    if hl % n == 0 and all(w - lo == j // (hl // n) for j, w in enumerate(want)):
        return slice(lo, hi)
    return want


def _attention_on_mesh(q, k, v, cfg, *, causal: bool, rotate: bool):
    """Kernel D inside ``shard_map``: q split by ("batch", "seq",
    "heads"), k and v by ("batch", "seq", "kv_heads"); each rank rotates
    its rows (positions ``arange(T)``) and attends with the kv heads its q
    heads use. Heads that do not divide their axes are replicated (GSPMD
    pads them; DTensor's uneven shards are not split here)."""
    mesh = shd.current_mesh()
    h, kvh = q.shape[2], k.shape[2]
    q_spec = shd.even_spec(shd.activation_spec("batch", "seq", "heads", None), q.shape, mesh)
    kv_spec = shd.even_spec(shd.activation_spec("batch", "seq", "kv_heads", None), k.shape,
                            mesh)
    if q_spec[1] is not None or kv_spec[1] is not None:
        raise NotImplementedError("sequence-parallel attention is not ported")
    heads, kv_heads = q_spec[2], kv_spec[2]
    if kv_heads is not None and kv_heads != heads:
        raise NotImplementedError(f"kv heads over {kv_heads} with q heads over {heads}")
    m = shd.axes_size(heads, mesh)

    def local(ql, kl, vl):
        if m > 1 and kv_heads is None:
            i = 0
            for ax in (heads,) if isinstance(heads, str) else heads:
                i = i * mesh.shape[ax] + shd.axis_index(ax)
            sel = _local_kv_heads(h, kvh, m, i)
            kl, vl = kl[:, :, sel], vl[:, :, sel]
        if rotate:
            positions = torch.arange(ql.shape[1], device=ql.device)
            ql = apply_rope(ql, positions, cfg.rope_fraction, cfg.rope_theta)
            kl = apply_rope(kl, positions, cfg.rope_fraction, cfg.rope_theta)
        return ops.flash_attention(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                                   causal=causal)

    return shd.shard_map(local, mesh=mesh, in_specs=(q_spec, kv_spec, kv_spec),
                         out_specs=q_spec)(q, k, v)


def _decode_attention_on_mesh(q, k, v, kv_cache: dict, pos: int, cfg):
    """A decode step's attention over a KV cache laid out on the mesh, in
    ``shard_map``: what the reference's GSPMD computes from ``constrain(k,
    "batch", "cache_seq", "kv_heads", None)`` and ``_dense_attention(...,
    causal=True, q_offset=pos)`` (``layers.py:199-209``).

    The cache keeps the layout it has (``init_cache``'s: ``cache_pspecs``
    through ``sanitize_pspecs``, the cache's ("batch", "cache_seq",
    "kv_heads") entries where they divide). q and the step's new K / V
    rows follow its batch and kv-head entries and are whole along the rest
    (at Tq 1 a few KB). Each rank rotates them at ``pos``, writes the rows
    into its own cache block in place where that block holds ``pos``, and
    attends over its keys at their global positions; over a sequence split
    the softmax is combined across the ranks (``_dense_attention``'s
    ``seq_axes``). DTensor's own indexed write would gather a sharded
    sequence dim or raise."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = shd.current_mesh()
    ck, cv = kv_cache["k"], kv_cache["v"]
    c_spec = shd.spec_of(ck, mesh)
    if c_spec[3] is not None or shd.spec_of(cv, mesh) != c_spec:
        raise NotImplementedError(f"a KV cache laid out as {c_spec} / {shd.spec_of(cv, mesh)}")
    # q heads split as the kv heads: a block of kv heads serves the block of
    # q heads of the same index (q head j -> kv head j // group)
    q_spec = shd.P(c_spec[0], None, c_spec[2], None)
    if isinstance(ck, DTensor):
        _, (_, k_off, _, _) = compute_local_shape_and_global_offset(
            ck.shape, mesh.device_mesh, ck.placements)
    else:
        k_off = 0

    def local(ql, kl, vl, ckl, cvl):
        positions = torch.full((ql.shape[0], ql.shape[1]), pos, device=ql.device)
        ql = apply_rope(ql, positions, cfg.rope_fraction, cfg.rope_theta)
        kl = apply_rope(kl, positions, cfg.rope_fraction, cfg.rope_theta)
        t, n = ql.shape[1], ckl.shape[1]
        lo, hi = max(pos, k_off), min(pos + t, k_off + n)
        if lo < hi:
            ckl[:, lo - k_off:hi - k_off] = kl[:, lo - pos:hi - pos].to(ckl.dtype)
            cvl[:, lo - k_off:hi - k_off] = vl[:, lo - pos:hi - pos].to(cvl.dtype)
        return _dense_attention(ql, ckl, cvl, causal=True, q_offset=pos, k_offset=k_off,
                                seq_axes=c_spec[1])

    return shd.shard_map(local, mesh=mesh, in_specs=(q_spec, q_spec, q_spec, c_spec, c_spec),
                         out_specs=q_spec)(q, k, v, ck, cv)


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
        h = shd.constrain(h, "batch", "seq", "d_ff")
        return shd.constrain(project(h, self.w_down, 1), "batch", "seq", "d_model")


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


def moe(params: dict, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed experts with capacity over x [B, S, d] -> (out [B, S,
    d] in x's dtype, aux loss). Outside a mesh (or on one without a
    "model" axis): the local dispatch at the capacity
    ``min(ceil(t*kv*capacity_factor/E_v), t)`` at every t, decode
    included. On a mesh (``use_rules(rules, mesh)``), the reference's
    ``"ep"`` or ``"tp"`` mode in ``shard_map``, its token split, local
    capacity and collectives."""
    b, s, d = x.shape
    e, k, vs = cfg.num_experts, cfg.experts_per_token, cfg.moe_ffn_shards
    ev, kv = e * vs, k * vs
    mesh, rules = shd.current_mesh(), shd.current_rules()
    if mesh is not None and "model" in mesh.shape:
        return _moe_on_mesh(params, x, cfg, mesh, rules)
    t = b * s
    cap = min(int(np.ceil(t * kv * cfg.capacity_factor / ev)), t)
    buf, slot, _, gate_flat, keep, probs, expert = _route_and_dispatch(
        x.reshape(t, d), params["router"], e, k, cap, vs)
    y = _expert_ffn(params, buf).reshape(ev * cap, d)
    del buf
    out = _combine(y, slot, gate_flat, keep, t, kv)
    aux = _load_balance_loss(probs, expert, e, k)
    return out.to(x.dtype).reshape(b, s, d), aux


def _moe_on_mesh(params: dict, x: torch.Tensor, cfg, mesh, rules):
    """The reference's two distributed modes (``layers.py:360-418``):
    "ep" splits the tokens over every mesh axis (the sequence over "model"
    where it divides), routes each shard at its own capacity, sends each
    expert's slots to its owner with one ``all_to_all`` pair over "model"
    and runs the experts locally; "tp" splits the tokens over the batch
    axes only, runs every expert with its FFN dim split over "model" and
    ``psum``s the row-parallel ``e_down``. The aux loss is the ``pmean``
    of the shards'."""
    b, s, d = x.shape
    e, k, vs = cfg.num_experts, cfg.experts_per_token, cfg.moe_ffn_shards
    ev, kv = e * vs, k * vs
    m_ax = mesh.shape["model"]
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    dp = int(np.prod([mesh.shape[a] for a in batch_axes]))
    mode = rules.moe_mode if rules else ("ep" if ev % m_ax == 0 else "tp")

    seq_split = m_ax if (mode == "ep" and s % m_ax == 0) else 1
    x_spec = shd.P(batch_axes if b % dp == 0 else None,
                   "model" if seq_split > 1 else None, None)
    b_loc = b // dp if b % dp == 0 else b
    t_loc = b_loc * (s // seq_split)
    cap = max(1, int(np.ceil(t_loc * kv * cfg.capacity_factor / ev)))

    def _wspec(n):
        if mode == "ep":
            return shd.P("model", None, None)
        return shd.P(None, "model", None) if n == "e_down" else shd.P(None, None, "model")

    enames = sorted(n for n in params if n.startswith("e_"))
    in_specs = (x_spec, shd.P(None, None), tuple(_wspec(n) for n in enames))
    aux_axes = batch_axes + (("model",) if seq_split > 1 or mode == "tp" else ())

    def local_fn(x_loc, router, ws):
        wp = dict(zip(enames, ws))
        bl, sl, _ = x_loc.shape
        t = bl * sl
        buf, slot, _, gate_flat, keep, probs, expert = _route_and_dispatch(
            x_loc.reshape(t, d), router, e, k, cap, vs)
        if mode == "ep":
            recv = shd.all_to_all(buf, "model", split_axis=0, concat_axis=1)  # [Ev/m, m*C, d]
            y = _expert_ffn(wp, recv)
            back = shd.all_to_all(y, "model", split_axis=1, concat_axis=0)    # [Ev, C, d]
        else:
            back = shd.psum(_expert_ffn(wp, buf), "model")    # row-parallel e_down
        out = _combine(back.reshape(ev * cap, d), slot, gate_flat, keep, t, kv)
        aux = _load_balance_loss(probs, expert, e, k)
        if aux_axes:
            aux = shd.pmean(aux, aux_axes)
        return out.to(x_loc.dtype).reshape(bl, sl, d), aux

    fn = shd.shard_map(local_fn, mesh=mesh, in_specs=in_specs,
                       out_specs=(x_spec, shd.P()), check_vma=False)
    out, aux = fn(x, params["router"], tuple(params[n] for n in enames))
    return shd.constrain(out, "batch", "seq", "d_model"), aux
