"""Mamba2 SSD (state-space duality) block [arXiv:2405.21060] (port of
``repro.models.ssm``).

Recurrence per head (P = head dim, N = state dim, scalar decay a_t):

    h_t = a_t * h_{t-1} + B_t (dt_t x_t)^T        h: [N, P]
    y_t = C_t^T h_t + D * x_t

``ssm_train`` is the chunked dual form: quadratic, attention-like products
within a chunk and one state hand-off between chunks. ``ssm_step`` is the
O(1) recurrent update of decode. Layout as Mamba2: in_proj -> [z | xBC |
dt]; a depthwise causal conv of width W over xBC; ngroups 1 (B and C
shared across heads).

The reference scans the chunks one at a time (``lax.scan``). Here every
term that stays within a chunk (the decay matrix, ``y_intra``, each
chunk's own state ``s_new``) is computed for a group of chunks in one
batched op, and only the hand-off ``h_c = h_{c-1} * exp(la_last) + s_c``
runs chunk by chunk, over a [B, H, N, P] state; ``y_inter`` is then added
for the whole group. A group holds as many chunks as fit
``SSD_GROUP_BYTES`` of f32 decay matrix ([G, B, H, Q, Q]): all 2,048
chunks of a 524,288-token mamba2-130m prefill at once would take 12.9 GB.
Each three-operand einsum of the reference is two explicit two-operand
steps, so no [Q, K, H, P] product is ever formed (2.1 GB a chunk at
jamba's width) and every device sums in the same order.

On a device mesh (DTensors inside ``sharding.use_rules``) the scan and
the decode's state update run in ``sharding.shard_map`` on each rank's
batch rows and heads, on local tensors; the rest stays DTensor ops.

Dtypes follow the reference: the conv sums its W products in the
activation dtype, adds ``conv_b``, then goes to f32 for SiLU; the gates,
the scan and ``h`` are f32; ``y`` returns to the activation dtype before
``out_proj``. The conv cache is in the model dtype.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L

F32 = torch.float32

# f32 bytes of decay matrix [G, B, H, Q, Q] one group of chunks may take;
# the per-head state weights [G, B, H, N, Q] take at most as much again
SSD_GROUP_BYTES = 1 << 30


def ssm_dims(cfg) -> tuple[int, int, int]:
    """(d_inner, heads, conv channels)."""
    d_inner = 2 * cfg.d_model
    heads = d_inner // cfg.ssm_head_dim
    conv_ch = d_inner + 2 * cfg.ssm_state
    return d_inner, heads, conv_ch


class SSM(nn.Module):
    """``init_ssm``'s leaves under the reference's names: ``in_proj`` [d,
    d_inner + conv_ch + H], ``conv_w`` [W, conv_ch], ``conv_b`` [conv_ch]
    (zeros), ``out_proj`` [d_inner, d] in the model dtype; ``a_log``
    (zeros, A = -exp(a_log)), ``dt_bias`` (zeros) and ``d_skip`` (ones),
    [H] each, in f32 at every model dtype."""

    def __init__(self, cfg, gen: torch.Generator, device=None):
        super().__init__()
        d, dt = cfg.d_model, L.dtype_of(cfg)
        d_inner, heads, conv_ch = ssm_dims(cfg)
        self.cfg = cfg
        init = lambda shape: L._param(shape, gen, (0,), dt, device)
        const = lambda size, fill, dtype: nn.Parameter(
            torch.full((size,), fill, dtype=dtype, device=device), requires_grad=False)
        self.in_proj = init((d, d_inner + conv_ch + heads))
        self.conv_w = init((cfg.ssm_conv_width, conv_ch))
        self.conv_b = const(conv_ch, 0.0, dt)
        self.a_log = const(heads, 0.0, F32)
        self.dt_bias = const(heads, 0.0, F32)
        self.d_skip = const(heads, 1.0, F32)
        self.out_proj = init((d_inner, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ssm_train(dict(self.named_parameters()), x, self.cfg)

    def step(self, x: torch.Tensor, cache: dict) -> tuple[torch.Tensor, dict]:
        return ssm_step(dict(self.named_parameters()), x, self.cfg, cache)


def _split_proj(params: dict, x: torch.Tensor, cfg):
    """-> (z, xbc, dt_raw). On a mesh ``in_proj``'s output, split over
    "model" by ``p_ssm_inner``, is gathered whole before the slices (the
    [z | xBC | dt] bounds do not fall on shard bounds), as GSPMD gathers
    it for the reference; xbc's channels are then split as ``conv_w`` /
    ``conv_b`` are, for the depthwise conv."""
    d_inner, heads, conv_ch = ssm_dims(cfg)
    proj = shd.unshard(L.project(x, params["in_proj"], 1), -1)
    xbc = shd.constrain(proj[..., d_inner:d_inner + conv_ch], "batch", None, "p_ssm_inner")
    return proj[..., :d_inner], xbc, proj[..., d_inner + conv_ch:]


def _conv_scan(params: dict, xbc: torch.Tensor, conv_state: torch.Tensor | None = None):
    """Depthwise causal conv of width W over xbc [B, T, C]; ``conv_state``
    [B, W-1, C] is the history. -> (SiLU output in f32, the new history in
    xbc's dtype)."""
    w = params["conv_w"].shape[0]
    if conv_state is None:
        pad = xbc.new_zeros(xbc.shape[0], w - 1, xbc.shape[2])
    else:
        pad = conv_state.to(xbc.dtype)
    ext = torch.cat([pad, xbc], dim=1)
    t = xbc.shape[1]
    out = ext[:, :t] * params["conv_w"][0]
    for i in range(1, w):
        out = out + ext[:, i:i + t] * params["conv_w"][i]
    out = nn.functional.silu((out + params["conv_b"]).float())
    return out, ext[:, -(w - 1):]


def _gates(params: dict, dt_raw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (dt, the decay a in (0, 1)), f32 [B, T, H]."""
    dt = nn.functional.softplus(dt_raw.float() + params["dt_bias"])
    return dt, torch.exp(-dt * torch.exp(params["a_log"]))


def ssm_train(params: dict, x: torch.Tensor, cfg, chunk: int = 256) -> torch.Tensor:
    """x [B, T, D] -> y [B, T, D] (chunked SSD; T % chunk need not be 0).

    On a mesh (x a DTensor inside ``use_rules``) the scan runs in
    ``shard_map`` with the layout of the reference's ``constrain`` calls:
    each rank scans its own batch rows and heads (``xdt`` by ("batch",
    None, "heads", None), ``a`` by ("batch", None, "heads")) with the whole
    B and C (shared across heads), so each head sums in the order it does
    off the mesh."""
    b, t, _ = x.shape
    d_inner, heads, _ = ssm_dims(cfg)
    n, p = cfg.ssm_state, cfg.ssm_head_dim

    z, xbc, dt_raw = _split_proj(params, x, cfg)
    xbc, _ = _conv_scan(params, xbc)
    xbc = shd.unshard(xbc, -1)
    xs = xbc[..., :d_inner].reshape(b, t, heads, p)
    bmat = xbc[..., d_inner:d_inner + n]                            # [B, T, N]
    cmat = xbc[..., d_inner + n:]                                   # [B, T, N]
    dt, a = _gates(params, dt_raw)
    xdt = xs * dt[..., None]                                        # [B, T, H, P]
    if isinstance(x, DTensor):
        y = _scan_on_mesh(xdt, bmat, cmat, a, chunk)
    else:
        y = _ssd_scan(xdt, bmat, cmat, a, chunk)
    y = y + xs * params["d_skip"][:, None]
    y = (y.reshape(b, t, d_inner) * nn.functional.silu(z.float())).to(x.dtype)
    y = shd.constrain(y, "batch", "seq", None)
    return L.project(y, params["out_proj"], 1)


def _scan_on_mesh(xdt, bmat, cmat, a, chunk: int) -> torch.Tensor:
    """``_ssd_scan`` in ``shard_map`` on each rank's batch rows and heads
    (dims the axes do not divide stay whole, as in ``_attention_on_mesh``).
    The state never leaves its rank."""
    mesh = shd.current_mesh()
    x_spec = shd.even_spec(shd.activation_spec("batch", None, "heads", None), xdt.shape, mesh)
    bc_spec = shd.P(x_spec[0], None, None)
    a_spec = shd.P(x_spec[0], None, x_spec[2])
    return shd.shard_map(lambda *args: _ssd_scan(*args, chunk), mesh=mesh,
                         in_specs=(x_spec, bc_spec, bc_spec, a_spec),
                         out_specs=x_spec)(xdt, bmat, cmat, a)


def _ssd_scan(xdt, bmat, cmat, a, chunk: int) -> torch.Tensor:
    """The chunked scan: xdt [B, T, H, P], B and C [B, T, N], the decay a
    [B, T, H], all f32 -> y [B, T, H, P] f32, without the D skip."""
    b, t, heads, p = xdt.shape
    n = bmat.shape[-1]
    # padded positions have a = 1: they neither decay nor feed the state
    # (they follow every real one, so only the final state, which is not
    # returned, could see them)
    pad = (-t) % chunk
    if pad:
        xdt = nn.functional.pad(xdt, (0, 0, 0, 0, 0, pad))
        bmat = nn.functional.pad(bmat, (0, 0, 0, pad))
        cmat = nn.functional.pad(cmat, (0, 0, 0, pad))
        a = nn.functional.pad(a, (0, 0, 0, pad), value=1.0)
    nc = (t + pad) // chunk
    dev = xdt.device
    # chunk-major layouts: [nc, B, H, Q, P], [nc, B, Q, N], [nc, B, H, Q]
    xc = xdt.reshape(b, nc, chunk, heads, p).permute(1, 0, 3, 2, 4)
    bc = bmat.reshape(b, nc, chunk, n).transpose(0, 1)
    cc = cmat.reshape(b, nc, chunk, n).transpose(0, 1)
    la = torch.log(a.clamp_min(1e-20)).reshape(b, nc, chunk, heads).permute(1, 0, 3, 2)
    la = torch.cumsum(la, dim=-1)
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=dev).tril_()

    # under no_grad (serving) the decay matrix and the states are updated
    # in place, which keeps jamba's prefill in memory; with autograd every
    # step is out of place
    inplace = not torch.is_grad_enabled()
    y = torch.empty(b, nc, chunk, heads, p, dtype=F32, device=dev)
    h = torch.zeros(b, heads, n, p, dtype=F32, device=dev)
    group = max(1, SSD_GROUP_BYTES // (4 * b * heads * chunk * chunk))
    for g0 in range(0, nc, group):
        g1 = min(nc, g0 + group)
        xb, bb, cb, lg = xc[g0:g1].contiguous(), bc[g0:g1], cc[g0:g1], la[g0:g1]
        # intra-chunk (the dual quadratic form): (scores * decay) @ xb; the
        # mask goes in before exp, so no exp of a later position's (positive)
        # log-decay overflows into the product or its gradient
        decay = (lg[..., :, None] - lg[..., None, :])
        scores = cb @ bb.transpose(-1, -2)                          # [G, B, Q, K]
        if inplace:
            decay = decay.masked_fill_(~causal, -torch.inf).exp_().mul_(scores[:, :, None])
        else:
            decay = decay.masked_fill(~causal, -torch.inf).exp() * scores[:, :, None]
        y_g = decay @ xb                                            # [G, B, H, Q, P]
        del decay
        # each chunk's own state: (B * tail) @ xb
        tail = torch.exp(lg[..., -1:] - lg)                         # [G, B, H, K]
        s_new = (bb.transpose(-1, -2)[:, :, None] * tail[..., None, :]) @ xb
        # the hand-off, chunk by chunk: states[c] is the state entering chunk c
        last = torch.exp(lg[..., -1])[..., None, None]              # [G, B, H, 1, 1]
        if inplace:
            states = torch.empty((g1 - g0 + 1,) + h.shape, dtype=F32, device=dev)
            states[0] = h
            for c in range(g1 - g0):
                torch.addcmul(s_new[c], states[c], last[c], out=states[c + 1])
        else:
            hs = [h]
            for c in range(g1 - g0):
                hs.append(torch.addcmul(s_new[c], hs[c], last[c]))
            states = torch.stack(hs)
        h = states[-1]
        # inter-chunk: C @ states, decayed to each position
        y_g += (cb[:, :, None] @ states[:-1]) * torch.exp(lg)[..., None]
        y[:, g0:g1] = y_g.permute(1, 0, 3, 2, 4)
    return y.view(b, nc * chunk, heads, p)[:, :t]


def init_ssm_cache(cfg, batch: int, dtype=torch.float32, device=None) -> dict:
    """{"conv": [B, W-1, conv_ch] in ``dtype`` (the model's), "h": [B, H,
    N, P] f32}, zeros."""
    _, heads, conv_ch = ssm_dims(cfg)
    return {"conv": torch.zeros(batch, cfg.ssm_conv_width - 1, conv_ch, dtype=dtype,
                                device=device),
            "h": torch.zeros(batch, heads, cfg.ssm_state, cfg.ssm_head_dim, dtype=F32,
                             device=device)}


def _state_step(h, a, bvec, cvec, xdt):
    """The recurrence at one token: the state h [B, H, N, P] decayed by a
    [B, H] and fed B (dt x), then read by C -> (y [B, H, P], the new h)."""
    h = h * a[:, :, None, None] + bvec[:, None, :, None] * xdt[:, :, None, :]
    return (cvec[:, None, None, :] @ h)[:, :, 0], h


def _state_step_on_mesh(h, a, bvec, cvec, xdt):
    """``_state_step`` in ``shard_map`` over the state's own layout, on
    whichever dims ``sanitize_pspecs`` put the cache's axes (heads that
    the "model" axis does not divide move it to N): ``a`` takes h's batch
    and head entries, B and C its batch and N entries, ``xdt`` its batch,
    head and P entries. ``C @ h`` sums over N, so y is summed over N's
    axes; the new state comes out in the cache's placements."""
    mesh = shd.current_mesh()
    h_spec = shd.spec_of(h, mesh)
    batch, heads, n, p = h_spec

    def local(h, a, bvec, cvec, xdt):
        y, h = _state_step(h, a, bvec, cvec, xdt)
        return (y if n is None else shd.psum(y, n)), h

    return shd.shard_map(local, mesh=mesh,
                         in_specs=(h_spec, shd.P(batch, heads), shd.P(batch, n),
                                   shd.P(batch, n), shd.P(batch, heads, p)),
                         out_specs=(shd.P(batch, heads, p), h_spec))(h, a, bvec, cvec, xdt)


def ssm_step(params: dict, x: torch.Tensor, cfg, cache: dict) -> tuple[torch.Tensor, dict]:
    """Single-token decode: x [B, 1, D] -> (y [B, 1, D], the new cache).
    On a mesh the new ``conv`` and ``h`` keep the placements of the cache's
    (``init_cache``'s layout)."""
    b = x.shape[0]
    d_inner, heads, _ = ssm_dims(cfg)
    n, p = cfg.ssm_state, cfg.ssm_head_dim

    z, xbc, dt_raw = _split_proj(params, x, cfg)
    xbc, conv_state = _conv_scan(params, xbc, cache["conv"])
    xbc = shd.unshard(xbc, -1)
    xs = xbc[:, 0, :d_inner].reshape(b, heads, p)
    bvec = xbc[:, 0, d_inner:d_inner + n]
    cvec = xbc[:, 0, d_inner + n:]
    dt, a = _gates(params, dt_raw)                                  # [B, 1, H]
    xdt = xs * dt[:, 0, :, None]                                    # [B, H, P]

    step = _state_step_on_mesh if isinstance(cache["h"], DTensor) else _state_step
    y, h = step(cache["h"], a[:, 0], bvec, cvec, xdt)
    y = y + xs * params["d_skip"][:, None]
    y = (y.reshape(b, 1, d_inner) * nn.functional.silu(z.float())).to(x.dtype)
    if isinstance(cache["conv"], DTensor) \
            and tuple(conv_state.placements) != tuple(cache["conv"].placements):
        conv_state = conv_state.redistribute(cache["conv"].device_mesh,
                                             cache["conv"].placements)
    return L.project(y, params["out_proj"], 1), {"conv": conv_state, "h": h}
