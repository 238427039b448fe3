"""int8 gradient compression with error feedback (port of
``repro.distributed.compress``).

Each gradient leaf is scaled per block of 256 values to int8 before the
(cross-host) reduction; the quantization residual is kept locally and
added to the next step's gradient, so the accumulated update is unbiased
(EF-SGD / 1-bit Adam lineage). The reduced bytes drop 4x against f32.

The math is the reference's, in f32 and in its order: the scale is
``max|x| / 127 + 1e-12`` per block, the codes ``clip(round(x / scale),
-127, 127)`` as int8 (round half to even in both packages), the
dequantized value ``code * scale``. On the same values the codes, the
scales, the effective gradients and the residuals equal the reference's
bit for bit, on the CPU and on the card. Torch ops on either device: the
reference has no kernel here.

Usage (train step integration):

    compressor = GradCompressor(convert.lm_leaf_groups(model))
    step = make_train_step(model, tx, compress_grads=compressor)

A gradient tree here is the port's grad dict ``{name: tensor}``, one
leaf a layer. The reference quantizes its own tree, whose leaves stack
the layers of one period position, and its blocks of 256 run across
them where a layer's leaf is not a multiple of 256 long (a norm scale, a
bias): ``GradCompressor(groups=convert.lm_leaf_groups(model))`` forms
the reference's leaves, and so its blocks and its results.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

BLOCK = 256
F32 = torch.float32

Grads = dict[str, torch.Tensor]


def _quantize_leaf(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """g -> (int8 codes [n_blocks, BLOCK], per-block f32 scales
    [n_blocks, 1]). Pads with zeros to a multiple of BLOCK."""
    flat = g.reshape(-1).to(F32)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    # the divisor is a tensor on the device: CUDA divides by a host scalar
    # as a multiply by its reciprocal, which rounds differently
    divisor = torch.tensor(127.0, dtype=F32, device=blocks.device)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / divisor + 1e-12
    codes = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return codes, scale


def _dequantize_leaf(codes: torch.Tensor, scale: torch.Tensor, shape,
                     dtype: torch.dtype) -> torch.Tensor:
    flat = (codes.to(F32) * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape).to(dtype)


def compress_decompress(grads: Grads, residual: Optional[Grads] = None,
                        groups: Optional[Sequence[Sequence[str]]] = None
                        ) -> tuple[Grads, Grads]:
    """Quantize and dequantize each leaf (what the network would carry is
    int8); returns the effective gradients, each in its leaf's dtype, and
    the new f32 error-feedback residuals.

    ``groups`` lists names whose gradients are quantized as one leaf, end
    to end in the order given (a name in no group is a leaf of its own).
    The blocks of 256 run across a leaf, so where the reference stacks
    layers into one leaf, ``convert.lm_leaf_groups(model)`` gives its
    blocks and so its results."""
    if residual is None:
        residual = {k: torch.zeros_like(g, dtype=F32) for k, g in grads.items()}
    grouped = {k for names in groups or () for k in names}
    eff, new_res = {}, {}
    for names in [*(groups or ()), *([k] for k in grads if k not in grouped)]:
        g_ef = torch.cat([grads[k].reshape(-1).to(F32) + residual[k].reshape(-1)
                          for k in names])
        codes, scale = _quantize_leaf(g_ef)
        deq = _dequantize_leaf(codes, scale, g_ef.shape, F32)
        parts = zip(names, deq.split([grads[k].numel() for k in names]),
                    g_ef.split([grads[k].numel() for k in names]))
        for k, part, ef in parts:
            g = grads[k]
            eff[k] = part.reshape(g.shape).to(g.dtype)
            new_res[k] = (ef - part).reshape(g.shape)
    return {k: eff[k] for k in grads}, {k: new_res[k] for k in grads}


class GradCompressor:
    """The stateful hook ``make_train_step(compress_grads=)`` takes: it
    holds the residuals between calls, so use one with one train step at a
    time. ``groups`` as in ``compress_decompress``: pass
    ``convert.lm_leaf_groups(model)`` for the reference's blocks."""

    def __init__(self, groups: Optional[Sequence[Sequence[str]]] = None):
        self.residual: Optional[Grads] = None
        self.groups = groups

    def __call__(self, grads: Grads) -> Grads:
        eff, self.residual = compress_decompress(grads, self.residual, self.groups)
        return eff
