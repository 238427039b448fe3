"""Kernel D: blockwise online-softmax attention — the CUDA launchers and
their plain version.

The launchers take the model layout ([B, T, H, hd], contiguous), which is
what ``models.layers`` produces, so no transpose surrounds a launch. The
plain version takes the reference kernel's layout, q [B, H, Tq, hd] and
k/v [B, KV, Tk, hd]. All compute what ``_flash_kernel`` computes: scale
1/sqrt(hd), GQA by index (query head h reads KV head h // (H/KV)), the
start-aligned causal mask ``kpos <= qpos``, f32 statistics, and
``acc / max(l, 1e-20)`` cast to the input dtype. Replaces
``repro/kernels/flash_attn.py:69``.

Two routes, chosen by dtype and hd alone (``route``), never as a fallback:

- ``"sm90"``: ``csrc/flash_attn_sm90.cu``, bf16 with hd 64 or 128 (every
  LM prefill). Products on the tensor cores (wgmma, f32 accumulation),
  tiles brought in by TMA. The scale multiplies q·k after the product, and
  P·V runs as ``bf16(P)·V + bf16(P - bf16(P))·V``, so the output stays
  within one bf16 rounding step of the f32 plain version; bf16-only P
  would not.
- ``"simt"``: ``csrc/flash_attn.cu``, f32 at any hd up to 128 and bf16 at
  the other hd: every product in f32 on the FMA units, the scale on q
  before the product, as the TPU kernel does.

The gradient (``flash_attention_plain_grad``) has no kernel: it
recomputes the scores in torch ops through the plain version's block
loop (``_score_blocks``), whichever route made the forward. The
reference never differentiates its Pallas kernel; its train path is
autodiff of the dense attention, which this computes.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/flash_attn_sm90.cu"
SOURCE_SIMT = "src/repro_torch/kernels/csrc/flash_attn.cu"
REPLACES = "src/repro/kernels/flash_attn.py:69"
MAX_HD = 128
SM90_HD = (64, 128)
NEG = -1e30
# f32 score elements one block of query rows of the plain version may
# hold (2 GiB), so a 32k-token prefill's scores never exist at once
PLAIN_SCORE_ELEMS = 1 << 29


def scale_of(hd: int) -> float:
    """The q scale, computed as the reference does (float64, then f32)."""
    return float(1.0 / np.sqrt(hd))


def _score_blocks(q: torch.Tensor, k: torch.Tensor, causal: bool):
    """The plain version's block loop, shared by its forward and its
    gradient: yields (r0, r1, qf, s) for each block of query rows, where
    qf [B, KV, G, Tq, hd] is q * ``scale_of(hd)`` in f32 and s the block's
    f32 scores [B, KV, G, r1 - r0, Tk], masked keys at ``NEG``. A block
    holds at most ``PLAIN_SCORE_ELEMS`` scores and is fresh, so a caller
    may overwrite it."""
    b, h, tq, hd = q.shape
    kvh, tk = k.shape[1], k.shape[2]
    g = h // kvh
    qf = (q.float() * scale_of(hd)).reshape(b, kvh, g, tq, hd)
    kt = k.float().transpose(-1, -2)                      # [B, KV, hd, Tk]
    kpos = torch.arange(tk, device=q.device)
    rows = max(1, PLAIN_SCORE_ELEMS // (b * h * tk))
    for r0 in range(0, tq, rows):
        r1 = min(tq, r0 + rows)
        s = qf[:, :, :, r0:r1].reshape(b, kvh, g * (r1 - r0), hd) @ kt
        s = s.view(b, kvh, g, r1 - r0, tk)
        if causal:
            qpos = torch.arange(r0, r1, device=q.device)
            s.masked_fill_(kpos[None, :] > qpos[:, None], NEG)
        yield r0, r1, qf, s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """q [B, H, Tq, hd], k/v [B, KV, Tk, hd] -> [B, H, Tq, hd] in q's dtype.

    Scores are materialised in f32, one block of query rows at a time
    (at most ``PLAIN_SCORE_ELEMS`` of them); the softmax is the exact one,
    exp(s - max) over its sum, so it is the same function as the online
    schedule of the kernel. It works in place on each block, so autograd
    must not see it: ``ops.flash_attention`` runs it inside its
    ``autograd.Function``."""
    b, h, tq, hd = q.shape
    kvh = k.shape[1]
    g = h // kvh
    vf = v.float()
    out = torch.empty(b, kvh, g, tq, hd, dtype=q.dtype, device=q.device)
    for r0, r1, _, s in _score_blocks(q, k, causal):
        p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()    # in place: s is a fresh block
        den = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
        o = (p.view(b, kvh, g * (r1 - r0), -1) @ vf).view(b, kvh, g, r1 - r0, hd)
        out[:, :, :, r0:r1] = (o / den).to(q.dtype)
        del s, p, o
    return out.view(b, h, tq, hd)


def flash_attention_plain_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               do: torch.Tensor, causal: bool = True
                               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention_plain`` (and so of kernel D) at
    q, k, v for the output gradient ``do`` [B, H, Tq, hd], in the same
    layout -> (dq, dk, dv), each in its input's dtype.

    The scores are recomputed from q and k, block by block as the forward
    makes them, in f32 at the same scale. Per block, with P = softmax(S):
    dV += Pᵀ·dO, dP = dO·Vᵀ, dS = P ∘ (dP − rowsum(P ∘ dP)), dQ = dS·K·scale
    and dK += dSᵀ·(Q·scale); dK and dV sum over each GQA group. rowsum(P
    ∘ dP) is rowsum(dO ∘ O) with O = P·V kept in f32, the softmax
    gradient as autodiff of the reference's ``_dense_attention`` forms it,
    so no output is saved and none is rounded to bf16 first."""
    b, h, tq, hd = q.shape
    kvh, tk = k.shape[1], k.shape[2]
    g = h // kvh
    kf, vt = k.float(), v.float().transpose(-1, -2)          # [B, KV, Tk, hd], [.., hd, Tk]
    dof = do.float().reshape(b, kvh, g, tq, hd)
    dq = torch.empty(b, kvh, g, tq, hd, dtype=q.dtype, device=q.device)
    dk = torch.zeros(b, kvh, tk, hd, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    scale = scale_of(hd)
    for r0, r1, qf, s in _score_blocks(q, k, causal):
        n = g * (r1 - r0)
        p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
        p = p.div_(p.sum(dim=-1, keepdim=True).clamp_min(1e-20)).view(b, kvh, n, tk)
        dob = dof[:, :, :, r0:r1].reshape(b, kvh, n, hd)
        dv += p.transpose(-1, -2) @ dob
        dp = dob @ vt                                        # [B, KV, n, Tk]
        ds = dp.sub_((p * dp).sum(dim=-1, keepdim=True)).mul_(p)
        del p, dp
        dq[:, :, :, r0:r1] = ((ds @ kf) * scale).view(b, kvh, g, r1 - r0, hd).to(q.dtype)
        dk += ds.transpose(-1, -2) @ qf[:, :, :, r0:r1].reshape(b, kvh, n, hd)
        del s, ds
    return dq.view(b, h, tq, hd), dk.to(k.dtype), dv.to(v.dtype)


def route(dtype: torch.dtype, hd: int) -> str:
    """The kernel that takes inputs of this dtype and head dim: "sm90" (the
    tensor cores) for bf16 at hd 64 or 128, else "simt"."""
    return "sm90" if dtype == torch.bfloat16 and hd in SM90_HD else "simt"


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool) -> torch.Tensor:
    """Launch the SIMT kernel on model-layout tensors (checked by the caller)."""
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.lib().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, kvh, tq, tk,
        hd, int(causal), int(q.dtype == torch.bfloat16), ctypes.c_float(scale_of(hd)),
        stream)
    _build.check(err, "repro_flash_attention")
    return o


def flash_attention_sm90_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool) -> torch.Tensor:
    """Launch the tensor-core kernel on model-layout tensors (checked by the
    caller, route "sm90")."""
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.lib().repro_flash_attention_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, kvh, tq, tk,
        hd, int(causal), ctypes.c_float(scale_of(hd)), stream)
    _build.check(err, "repro_flash_attention_sm90")
    return o
