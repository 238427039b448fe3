"""Kernel B: shingle -> M-dim feature embedding sum (paper Algorithm 1,
step 5) — the CUDA launcher and its plain version.

    out[b, :] = sum_s mask[b,s] * msu(ids[b,s]) / ||msu(ids[b,s])||

The divide-by-count and the final normalisation (``mean_normalize``) run
in torch after either version, in the wrapper (``ops.shingle_embed``).
Source: ``csrc/shingle_embed.cu``; replaces
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


def mean_normalize(total: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, M] sums -> mean over each row's unmasked shingles, L2-normalised
    (an all-masked row stays 0)."""
    cnt = torch.clamp(mask.sum(dim=-1, keepdim=True), min=1).to(torch.float32)
    feat = total / cnt
    return feat / (torch.linalg.norm(feat, dim=-1, keepdim=True) + 1e-12)


def shingle_embed_sum_cuda(ids: torch.Tensor, mask: torch.Tensor,
                           a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch kernel B (inputs checked by the caller)."""
    rows, s_len = ids.shape
    m = a.shape[0]
    out = torch.empty(rows, m, dtype=torch.float32, device=ids.device)
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    err = _build.lib().repro_shingle_embed_sum(
        ids.data_ptr(), mask.data_ptr(), a.data_ptr(), b.data_ptr(),
        rows, s_len, m, out.data_ptr(), stream)
    _build.check(err, "repro_shingle_embed_sum")
    return out
