"""Functional optimizers (port of ``repro.optim``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    GradientTransform,
    OptState,
    adamw,
    apply_updates,
    clip_by_global_norm,
    cosine_schedule,
    constant_schedule,
    global_norm,
)
