"""GPipe-style pipeline parallelism over a mesh axis (port of
``repro.distributed.pipeline``).

Layer blocks are assigned to pipeline stages along a mesh axis (typically
"pod"); microbatches stream through the stages with ``ppermute``
hand-offs. Schedule: with S stages and M microbatches the loop runs
M + S - 1 ticks; stage s works on microbatch t - s at tick t (bubble
fraction (S-1)/(M+S-1), the standard GPipe trade).

The implementation is a ``sharding.shard_map`` over the pipeline axis:
every rank holds ONE stage's parameters (the leading stage axis sharded
over the axis), applies its stage, and ``ppermute``s activations to the
next stage. ``ppermute`` is differentiable, so autograd pipelines the
backward pass (reverse hand-offs).

    y = pipeline_apply(stage_fn, stage_params, x, mesh=mesh,
                       axis="pod", num_microbatches=8)

``stage_fn(params_s, x_mb) -> y_mb`` must be shape-preserving (equal-width
stages), which matches the repeating-block structure of
``models/transformer.py``. ``stage_params`` is a dict of tensors, nested
to any depth (a block's ``{"attn": {"wq": ...}, "ln1": {...}}``), each
leaf with a leading [S] axis: the reference's pytree.

The reference's ``jnp.where(stage == 0, ...)`` picks a value on the
device; here the stage is known on the host, so the branch is a Python
one. It still keeps the value it drops in the graph with a zero gradient
(``_pick``), as ``where`` does: every rank's backward then runs every
hand-off's inverse ``ppermute``, in the same order, which the ranks' point
to point calls need to pair up.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import sharding as shd


class _Pick(torch.autograd.Function):
    """``keep``, with ``drop`` in the graph at a zero gradient (a ``where``
    whose condition the host knows)."""

    @staticmethod
    def forward(ctx, keep, drop):
        return keep.view_as(keep)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros_like(g)


def _pick(keep: torch.Tensor, drop: torch.Tensor) -> torch.Tensor:
    return _Pick.apply(keep, drop)


def _stage(stage_params: dict, i: int) -> dict:
    """Stage ``i``'s params: every leaf of the nested dict indexed at ``i``
    on its leading axis (the reference's ``tree_map(lambda p: p[i])``)."""
    return shd._unflatten_like(stage_params, (v[i] for v in shd._flat_values(stage_params)))


def pipeline_apply(stage_fn: Callable, stage_params: dict, x: torch.Tensor,
                   *, mesh, axis: str = "pod",
                   num_microbatches: int | None = None) -> torch.Tensor:
    """x [B, ...] -> the stages applied in order, pipelined over ``axis``.

    stage_params: a nested dict of tensors, each leaf with a leading [S]
    axis (S = ``mesh.shape[axis]``). B must be a multiple of the
    microbatch count (default S). The result is the last stage's output
    [B, ...]."""
    s = mesh.shape[axis]
    b = x.shape[0]
    m = num_microbatches or s
    if b % m:
        raise ValueError(f"batch {b} does not split into {m} microbatches")
    mb = b // m

    xs = x.reshape(m, mb, *x.shape[1:])
    perm = [(i, (i + 1) % s) for i in range(s)]

    def local(params_local, xs_local):
        # this stage's params (leading axis of 1 stripped)
        params_local = _stage(params_local, 0)
        stage = shd.axis_index(axis)
        buf = torch.zeros_like(xs_local[0])           # activation entering this stage
        emits = []
        for t in range(m + s - 1):
            inject = xs_local[min(t, m - 1)]
            cur = _pick(inject, buf) if stage == 0 else _pick(buf, inject)
            out = stage_fn(params_local, cur)
            buf = shd.ppermute(out, axis, perm)
            # the last stage emits its result at ticks >= s-1
            if t >= s - 1:
                emits.append(out if stage == s - 1 else _pick(torch.zeros_like(out), out))
        return torch.stack(emits)                     # [M, mb, ...]

    fn = shd.shard_map(
        local, mesh=mesh,
        in_specs=(shd.P(axis), shd.P()),              # params staged; microbatches replicated
        out_specs=shd.P(axis),                        # [S*M, mb, ...]; only the last stage's valid
        check_vma=False)
    stacked = fn(dict(stage_params), xs)
    stacked = stacked.full_tensor() if isinstance(stacked, shd.DTensor) else stacked
    ys = stacked.reshape(s, m, mb, *x.shape[1:])[s - 1]
    return ys.reshape(b, *x.shape[1:])


def reference_apply(stage_fn: Callable, stage_params: dict, x: torch.Tensor) -> torch.Tensor:
    """Sequential oracle: apply every stage in order (tests)."""
    s = shd._flat_values(stage_params)[0].shape[0]
    for i in range(s):
        x = stage_fn(_stage(stage_params, i), x)
    return x
