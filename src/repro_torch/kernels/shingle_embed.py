"""Kernel B: shingle -> M-dim initial features (paper Algorithm 1, step
5) — the CUDA launcher and its plain version.

    total[b] = sum_s mask[b,s] * msu(ids[b,s]) / ||msu(ids[b,s])||
    out[b]   = mean over the unmasked shingles, L2-normalised unless
               normalize=False

The kernel computes both lines in one launch. The plain version is
``shingle_embed_sum_plain`` (the first line, as the reference's Pallas
kernel) followed by ``mean_normalize`` (the second, as the reference's
caller). Source: ``csrc/shingle_embed.cu``; replaces
``repro/kernels/shingle_embed.py:42``.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashing
from repro_torch.kernels import _build

SOURCE = "src/repro_torch/kernels/csrc/shingle_embed.cu"
REPLACES = "src/repro/kernels/shingle_embed.py:42"
MAX_M = 256


def shingle_embed_sum_plain(ids: torch.Tensor, mask: torch.Tensor,
                            a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """ids [B, S] int32 bits, mask [B, S] bool, a/b [M] int32 bits -> [B, M] f32."""
    v = hashing.multiply_shift_unit(hashing.from_i32_bits(ids),
                                    hashing.from_i32_bits(a),
                                    hashing.from_i32_bits(b))      # [B, S, M]
    norm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)) + 1e-12
    v = v / norm * mask[..., None].to(torch.float32)
    return v.sum(dim=1)


def mean_normalize(total: torch.Tensor, mask: torch.Tensor,
                   normalize: bool = True) -> torch.Tensor:
    """[B, M] sums -> mean over each row's unmasked shingles, L2-normalised
    unless ``normalize`` is False (an all-masked row stays 0)."""
    cnt = torch.clamp(mask.sum(dim=-1, keepdim=True), min=1).to(torch.float32)
    feat = total / cnt
    if not normalize:
        return feat
    return feat / (torch.linalg.norm(feat, dim=-1, keepdim=True) + 1e-12)


def shingle_embed_cuda(ids: torch.Tensor, mask: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Launch kernel B (inputs checked by the caller): [B, M] float32 mean
    features, L2-normalised unless ``normalize`` is False."""
    rows, s_len = ids.shape
    m = a.shape[0]
    out = torch.empty(rows, m, dtype=torch.float32, device=ids.device)
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    err = _build.lib().repro_shingle_embed(
        ids.data_ptr(), mask.data_ptr(), a.data_ptr(), b.data_ptr(),
        rows, s_len, m, int(normalize), out.data_ptr(), stream)
    _build.check(err, "repro_shingle_embed")
    return out


def residual_quotient_cuda(h: torch.Tensor, norm: torch.Tensor) -> torch.Tensor:
    """The kernel's division-free quotient, on its own: h [n] int32 hash
    bits and norm [n] float32 > 0 on the card -> [n] float32, which must
    equal (h * 2^-31) / norm bit for bit. A check, not on the main path."""
    if (h.dtype != torch.int32 or norm.dtype != torch.float32 or h.shape != norm.shape
            or h.dim() != 1 or not (h.is_contiguous() and norm.is_contiguous())):
        raise ValueError("want contiguous [n] int32 hashes and [n] float32 norms")
    out = torch.empty_like(norm)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = _build.lib().repro_shingle_quotient(
        h.data_ptr(), norm.data_ptr(), h.shape[0], out.data_ptr(), stream)
    _build.check(err, "repro_shingle_quotient")
    return out
