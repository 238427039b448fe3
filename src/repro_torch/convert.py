"""Carry state over from the JAX package, given as numpy arrays.

``context_model_from_params`` builds the port's context model from the
reference's trained ``w [M, D]`` and ``u [D, M]`` (``pinv(U)`` is
recomputed here). ``check_constants`` asserts that the port's own copies
of the hashing constants equal arrays taken from the reference, which
catches drift between the two packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import context_model, hashing


def context_model_from_params(w: np.ndarray, u: np.ndarray,
                              cfg: context_model.ContextModelConfig | None = None,
                              device: str | torch.device | None = None
                              ) -> context_model.ContextModel:
    w = np.asarray(w, np.float32)
    u = np.asarray(u, np.float32)
    cfg = cfg or context_model.ContextModelConfig(m=w.shape[0], d=w.shape[1])
    if w.shape != (cfg.m, cfg.d) or u.shape != (cfg.d, cfg.m):
        raise ValueError(f"params {w.shape}/{u.shape} do not fit m={cfg.m}, d={cfg.d}")
    return context_model.ContextModel(cfg, device=device).load(w, u)


def check_constants(gear_table: np.ndarray, ms_a: np.ndarray, ms_b: np.ndarray) -> None:
    """Raise if the port's GEAR_TABLE or multiply-shift (a, b) for
    ``len(ms_a)`` functions differ from the arrays given."""
    if not np.array_equal(np.asarray(gear_table, np.uint32), hashing.GEAR_TABLE):
        raise AssertionError("GEAR_TABLE differs from the reference's")
    a, b = hashing.multiply_shift_params(len(ms_a))
    if not (np.array_equal(np.asarray(ms_a, np.uint32), a)
            and np.array_equal(np.asarray(ms_b, np.uint32), b)):
        raise AssertionError("multiply-shift params differ from the reference's")
