"""Train and eval step builders (port of ``repro.train.step``), on one
device.

The step is functional, as the reference's is: ``TrainState.params`` is a
dict ``{name: tensor}`` keyed by ``Model.named_parameters()``, and the
model is called with it through ``torch.func.functional_call``. The
step makes those tensors leaves that require grad for the length of one
loss and its gradient; the module's own parameters keep
``requires_grad=False``, so serving the same model builds no graph. The
backward runs inside the call, so a block that ``remat`` recomputes sees
the same leaves.

Microbatches follow the reference: at 1 the grads stay in the param dtype;
at n > 1 the batch splits along its first axis, each microbatch's grads
come from ``torch.autograd.grad`` in the param dtype, are cast to f32,
summed and divided by n, and the loss and metrics are means. The
optimizer is any ``repro_torch.optim.GradientTransform``.
``compress_grads`` takes the grads before the update and returns the
grads the update uses: ``distributed.compress.GradCompressor`` (int8 with
error feedback), as in the reference.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch import nn

from repro_torch import optim

F32 = torch.float32


class TrainState(NamedTuple):
    params: Any                 # {name: tensor}, Model.named_parameters() order
    opt_state: optim.OptState
    step: torch.Tensor          # int32, 0-d


def init_state(params: dict, tx: optim.GradientTransform) -> TrainState:
    step = torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)
    return TrainState(params=params, opt_state=tx.init(params), step=step)


def model_params(model: nn.Module) -> dict[str, torch.Tensor]:
    """The model's parameters as the tree a ``TrainState`` holds (the
    same storage, detached)."""
    return {k: p.detach() for k, p in model.named_parameters()}


class _Bound(nn.Module):
    """``fn(model, *args)`` as a module call, so that ``functional_call``
    can run it with the model's params swapped (under ``model.``)."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def _call(model: nn.Module, params: dict, fn: Callable, *args):
    return torch.func.functional_call(_Bound(model, fn),
                                      {f"model.{k}": v for k, v in params.items()}, args)


def loss_and_grads(model: nn.Module, params: dict, batch: dict, remat: bool = True
                   ) -> tuple[torch.Tensor, dict, dict[str, torch.Tensor]]:
    """(loss, metrics, grads in each param's dtype) of ``model.loss`` at
    ``params``, one batch. The backward runs inside the call, where a
    block that remat recomputes still sees the leaves."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}

    def run(m, b):
        loss, metrics = m.loss(b, remat=remat)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    with torch.enable_grad():
        loss, metrics, grads = _call(model, leaves, run, batch)
    return loss, metrics, dict(zip(leaves, grads))


def _split(x, n: int, i: int):
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch {b} is not a multiple of {n} microbatches")
    return x[i * (b // n):(i + 1) * (b // n)]


def make_train_step(model: nn.Module, tx: optim.GradientTransform, *,
                    num_microbatches: int = 1,
                    compress_grads: Optional[Callable] = None,
                    remat: bool = True):
    """Returns train_step(state, batch) -> (state, metrics); metrics hold
    ``nll``, ``aux``, ``loss`` and ``grad_norm`` (f32 0-d tensors).
    ``compress_grads``: a hook on the grad dict before the update, e.g.
    ``distributed.compress.GradCompressor(convert.lm_leaf_groups(model))``
    for the reference's int8 compression; ``grad_norm`` is then the norm
    of what it returns, as in the reference."""

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        params = state.params
        if num_microbatches == 1:
            loss, metrics, grads = loss_and_grads(model, params, batch, remat)
        else:
            grads = {k: torch.zeros(p.shape, dtype=F32, device=p.device)
                     for k, p in params.items()}
            losses, ms = [], []
            for i in range(num_microbatches):
                mb = {k: _split(v, num_microbatches, i) for k, v in batch.items()}
                l, m, g = loss_and_grads(model, params, mb, remat)
                for k, gi in g.items():
                    grads[k] += gi.to(F32)
                del g
                losses.append(l)
                ms.append(m)
            grads = {k: g / num_microbatches for k, g in grads.items()}
            loss = torch.mean(torch.stack(losses))
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms])) for k in ms[0]}
        if compress_grads is not None:
            grads = compress_grads(grads)
        deltas, opt_state = tx.update(grads, state.opt_state, params)
        params = optim.apply_updates(params, deltas)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = optim.global_norm(grads)
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step


def make_eval_step(model: nn.Module):
    """Returns eval_step(params, batch) -> metrics (``nll``, ``aux``,
    ``loss``), with no graph and no remat."""

    def eval_step(params: dict, batch: dict) -> dict:
        with torch.no_grad():
            loss, metrics = _call(model, params, lambda m, b: m.loss(b, remat=False), batch)
        return dict(metrics, loss=loss)

    return eval_step
