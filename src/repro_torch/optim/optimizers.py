"""Functional optimizers, optax-style (port of ``repro.optim.optimizers``).

A param tree here is a dict ``{name: tensor}`` (``Model.named_parameters``
order); the optimizer state mirrors it. The rule is the reference's, not
``torch.optim.AdamW``'s: the first moment is kept in the param dtype
unless ``m_dtype`` is given and the second in f32 unless ``v_dtype`` is
given; the update is computed in f32, weight decay added inside it, then
cast to the param dtype. ``torch.optim.AdamW`` keeps both moments in the
param dtype and applies weight decay as a multiply of its own, so its
bf16 steps differ.

Every function is pure: it returns new tensors and changes none it is
given, so a step can be compared with, or retried from, the state before
it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

F32 = torch.float32

Schedule = Callable[[torch.Tensor], torch.Tensor]
Tree = dict[str, torch.Tensor]


def constant_schedule(value: float) -> Schedule:
    return lambda step: torch.tensor(value, dtype=F32, device=step.device)


def cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                    floor: float = 0.0) -> Schedule:
    """Linear warm-up to ``peak``, then a cosine down to ``floor`` at
    ``total_steps``; f32 of the step tensor, as the reference computes it."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(F32)
        warm = peak * step / max(1.0, warmup_steps)
        t = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        t = t.clamp(0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos)
    return sched


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, each squared in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32))) for g in tree.values()))


def clip_by_global_norm(tree: Tree, max_norm: float) -> tuple[Tree, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in tree.items()}, norm


class OptState(NamedTuple):
    step: torch.Tensor      # int32, 0-d
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class GradientTransform:
    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any], tuple[Any, OptState]]


def adamw(
    learning_rate: Schedule | float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    m_dtype: torch.dtype | None = None,
    v_dtype: torch.dtype | None = None,
    max_grad_norm: float | None = None,
) -> GradientTransform:
    sched = learning_rate if callable(learning_rate) else constant_schedule(learning_rate)

    def init(params: Tree) -> OptState:
        mu = {k: torch.zeros_like(p, dtype=m_dtype or p.dtype) for k, p in params.items()}
        nu = {k: torch.zeros_like(p, dtype=v_dtype or F32) for k, p in params.items()}
        step = torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)
        return OptState(step=step, mu=mu, nu=nu)

    def update(grads: Tree, state: OptState, params: Tree) -> tuple[Tree, OptState]:
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state.step + 1
        lr = sched(step)
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=F32, device=step.device), step.to(F32))
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=F32, device=step.device), step.to(F32))
        deltas, mu, nu = {}, {}, {}
        for k, p in params.items():
            g32 = grads[k].to(F32)
            m, v = state.mu[k], state.nu[k]
            m32 = m.to(F32) * b1 + g32 * (1 - b1)
            v32 = v.to(F32) * b2 + torch.square(g32) * (1 - b2)
            u = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
            if weight_decay:
                u = u + weight_decay * p.to(F32)
            deltas[k] = (-lr * u).to(p.dtype)
            mu[k], nu[k] = m32.to(m.dtype), v32.to(v.dtype)
        return deltas, OptState(step=step, mu=mu, nu=nu)

    return GradientTransform(init=init, update=update)


def apply_updates(params: Tree, deltas: Tree) -> Tree:
    return {k: p + deltas[k].to(p.dtype) for k, p in params.items()}
