"""Carry state over from the JAX package, given as numpy arrays.

``context_model_from_params`` builds the port's context model from the
reference's trained ``w [M, D]`` and ``u [D, M]`` (``pinv(U)`` is
recomputed here). ``lm_params_from_jax`` builds the port's LM (any
family) from the reference's param tree. ``check_constants``
asserts that the port's own copies of the hashing constants equal arrays
taken from the reference, which catches drift between the two packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import context_model, hashing
from repro_torch.models.transformer import Model, block_period


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


def _unstack(leaves: dict, tree: dict, stack: str, n: int, period: int = 1, pos: int = 0
             ) -> None:
    """Put each leaf of ``tree`` (``{group: {name: [n, ...]}}``, position
    ``pos`` of ``stack``) into ``leaves`` as layer ``r * period + pos``'s:
    ``f"{stack}.{layer}.{group}.{name}"`` for r < n."""
    for group, sub in tree.items():
        for name, arr in sub.items():
            arr = np.asarray(arr)
            if arr.shape[:1] != (n,):
                raise ValueError(f"{stack}[{pos}].{group}.{name}: leading axis "
                                 f"{arr.shape[:1]} is not {n}")
            for r in range(n):
                leaves[f"{stack}.{r * period + pos}.{group}.{name}"] = arr[r]


def lm_params_from_jax(params: dict, cfg: ModelConfig,
                       device: str | torch.device | None = None) -> Model:
    """The port's ``Model`` holding the reference's LM params.

    ``params`` is the reference's tree with numpy leaves (any float dtype;
    bf16 goes through f32 exactly): ``embed`` [V, d], ``lm_head`` [d, V]
    (absent when the head is tied), ``final_norm.scale`` [d], and
    ``blocks``, one entry per period-position, each leaf stacked over the
    ``L / period`` repetitions: layer ``i`` is ``blocks[i % period]`` at
    index ``i // period``. A position holds ``ln1``, ``attn.wq/wk/wv/wo``
    or ``ssm.in_proj/conv_w/conv_b/a_log/dt_bias/d_skip/out_proj``, where
    the layer has a cross sublayer ``ln_cross`` and ``cross.*``, and where
    it has an FFN ``ln2`` with ``mlp.*`` or ``moe.router`` / ``moe.e_*``.
    An encoder-decoder also has ``encoder`` (``ln1``, ``attn``, ``ln2``,
    ``mlp``, each leaf stacked over ``encoder_layers``), ``enc_norm.scale``
    and ``dec_cross``, one entry per period-position stacked like
    ``blocks`` (``ln_cross``, ``cross``). Raises on a missing or unexpected
    leaf (an ``lm_head`` beside a tied head included) or a shape that does
    not fit ``cfg``."""
    model = Model(cfg, device=device)
    period = block_period(cfg)
    n_rep = cfg.num_layers // period
    leaves = {"embed": params["embed"], "final_norm.scale": params["final_norm"]["scale"]}
    if "lm_head" in params:
        leaves["lm_head"] = params["lm_head"]
    for stacked in ("blocks", "dec_cross"):
        if stacked not in params:
            continue
        if len(params[stacked]) != period:
            raise ValueError(f"{stacked}: want {period} stacked period-positions (the block "
                             f"period of {cfg.name}), got {len(params[stacked])}")
        for pos, tree in enumerate(params[stacked]):
            _unstack(leaves, tree, stacked, n_rep, period, pos)
    if "encoder" in params:
        _unstack(leaves, params["encoder"], "encoder", cfg.encoder_layers)
    if "enc_norm" in params:
        leaves["enc_norm.scale"] = params["enc_norm"]["scale"]
    own = dict(model.named_parameters())
    if set(leaves) != set(own):
        raise ValueError(f"param trees differ: missing {sorted(set(own) - set(leaves))}, "
                         f"unexpected {sorted(set(leaves) - set(own))}")
    for name, arr in leaves.items():
        arr = np.array(arr, np.float32)
        if arr.shape != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {arr.shape}, want {tuple(own[name].shape)}")
        own[name].copy_(torch.from_numpy(arr))
    return model
