"""Carry state over from the JAX package, given as numpy arrays.

``context_model_from_params`` builds the port's context model from the
reference's trained ``w [M, D]`` and ``u [D, M]`` (``pinv(U)`` is
recomputed here). ``lm_params_from_jax`` builds the port's LM (any
family) from the reference's param tree, and ``lm_params_to_jax`` gives
that tree back from the port's params. ``check_constants``
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
            if not isinstance(arr, torch.Tensor):
                arr = np.asarray(arr)
            if tuple(arr.shape[:1]) != (n,):
                raise ValueError(f"{stack}[{pos}].{group}.{name}: leading axis "
                                 f"{tuple(arr.shape[:1])} is not {n}")
            for r in range(n):
                leaves[f"{stack}.{r * period + pos}.{group}.{name}"] = arr[r]


def lm_params_from_jax(params: dict, cfg: ModelConfig,
                       device: str | torch.device | None = None) -> Model:
    """The port's ``Model`` holding the reference's LM params.

    ``params`` is the reference's tree with numpy leaves, or tensors as
    ``lm_params_to_jax`` gives them (any float dtype; bf16 goes through
    f32 exactly): ``embed`` [V, d], ``lm_head`` [d, V]
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
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().float().cpu().numpy()
        arr = np.array(arr, np.float32)
        if arr.shape != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {arr.shape}, want {tuple(own[name].shape)}")
        own[name].copy_(torch.from_numpy(arr))
    return model


def _stacked_names(names, stack: str, n: int, period: int, pos: int
                   ) -> dict[tuple[str, str], list[str]]:
    """``{(group, name): [the names of layers r * period + pos, r < n]}``:
    the port's params that one stacked leaf of the reference holds."""
    prefix = f"{stack}.{pos}."
    out = {}
    for key in names:
        if key.startswith(prefix):
            group, name = key[len(prefix):].split(".")
            out[(group, name)] = [f"{stack}.{r * period + pos}.{group}.{name}"
                                  for r in range(n)]
    return out


def _stacks(cfg: ModelConfig) -> list[tuple[str, int, int, int]]:
    """(stack, repetitions, period, position) of each stacked subtree."""
    period = block_period(cfg)
    n_rep = cfg.num_layers // period
    out = [("blocks", n_rep, period, pos) for pos in range(period)]
    if cfg.encoder_layers:
        out += [("encoder", cfg.encoder_layers, 1, 0)]
        out += [("dec_cross", n_rep, period, pos) for pos in range(period)]
    return out


def lm_leaf_groups(model: Model) -> list[list[str]]:
    """The port's param names that make up each leaf of the reference's
    tree, in stacking order (one name for an unstacked leaf). A consumer
    that works on whole leaves, such as the int8 gradient compressor's
    blocks of 256 values, gives the reference's results over these
    groups."""
    names = [k for k, _ in model.named_parameters()]
    stacked = [group for spec in _stacks(model.cfg)
               for group in _stacked_names(names, *spec).values()]
    inside = {k for group in stacked for k in group}
    return [[k] for k in names if k not in inside] + stacked


def lm_params_to_jax(model: Model, params: dict | None = None) -> dict:
    """The reference's param tree of ``model``'s params, or of ``params``
    (a ``TrainState.params``: ``{name: tensor}`` by ``named_parameters()``)
    at ``model``'s config: ``lm_params_from_jax``'s layout (layer ``i``
    at ``blocks[i % period]`` index ``i // period``, likewise
    ``dec_cross``; ``encoder`` stacked over ``encoder_layers``; no
    ``lm_head`` for a tied head). The leaves are detached tensors in each
    param's dtype and on its device: numpy holds no bf16, and
    ``checkpoint.serialize`` writes a bf16 tensor as the reference writes
    its bf16 array. So the tree serialises to the reference's byte
    stream for the same values."""
    params = {k: v.detach() for k, v in (params if params is not None
                                         else dict(model.named_parameters())).items()}

    def stack(stack_name, n, period, pos):
        tree: dict = {}
        for (group, name), keys in _stacked_names(params, stack_name, n, period, pos).items():
            tree.setdefault(group, {})[name] = torch.stack([params[k] for k in keys])
        return tree

    stacks = _stacks(model.cfg)
    tree = {"embed": params["embed"], "final_norm": {"scale": params["final_norm.scale"]},
            "blocks": [stack(*s) for s in stacks if s[0] == "blocks"]}
    if "lm_head" in params:
        tree["lm_head"] = params["lm_head"]
    if model.cfg.encoder_layers:
        tree["encoder"] = stack(*next(s for s in stacks if s[0] == "encoder"))
        tree["enc_norm"] = {"scale": params["enc_norm.scale"]}
        tree["dec_cross"] = [stack(*s) for s in stacks if s[0] == "dec_cross"]
    return tree
