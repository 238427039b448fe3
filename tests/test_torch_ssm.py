"""The port's Mamba2 SSD block (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm`` on the CPU, on the same params
(``init_ssm``'s, carried across as numpy) and inputs, at the ``reduced()``
mamba2-130m widths (d 128, H 8, N 16, P 32, conv width 4).

``a_log``, ``dt_bias``, ``d_skip`` and ``conv_b`` start at 0, 0, 1 and 0,
values that hide a swap of heads or a misplaced bias, so every case but
one draws them from a seeded normal; one case raises ``a_log`` until the
decay reaches the ``1e-20`` clamp of the scan.

Tolerances, each from a measured max error on these inputs:
- the scan in f32, the recurrent step against the chunked scan and the
  caches, ``SSM_TOL`` = 2e-5 of the output's largest magnitude: measured
  at most 5.1e-6 of it over these cases, a 4x margin. Both packages are
  as far from a float64 run of the reference (3.0e-5 and 2.8e-5 at
  outputs up to 15.4, T 600), so the difference is summation order (the
  reference's ``lax.scan`` one chunk at a time, the port's batched
  chunks), nothing more;
- the conv in bf16 against the reference run op by op, 2e-6: measured
  4.8e-7 (the SiLU). Jitted, XLA fuses the W products and skips the bf16
  rounding between them, which the reference's code asks for.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import ssm as ref_ssm
from repro_torch.configs import base as configs
from repro_torch.models import ssm

torch.set_num_threads(1)

SSM_TOL = 2e-5
REF_CFG = dataclasses.replace(ref_get_config("mamba2-130m").reduced(), dtype="float32")
CFG = configs.ModelConfig(**dataclasses.asdict(REF_CFG))

_ref_train = jax.jit(ref_ssm.ssm_train, static_argnums=(2, 3))
_ref_step = jax.jit(ref_ssm.ssm_step, static_argnums=2)


def _params(leaves="random", seed=0) -> dict:
    """``init_ssm``'s params as numpy f32; ``random``: the four constant
    leaves drawn from a seeded normal; ``clamp``: ``a_log`` so large that
    the decay underflows past the scan's 1e-20 clamp in some heads."""
    p = {k: np.array(v, np.float32)
         for k, v in ref_ssm.init_ssm(jax.random.PRNGKey(seed), REF_CFG).items()}
    rng = np.random.default_rng(seed + 10)
    if leaves in ("random", "clamp"):
        for k in ("a_log", "dt_bias", "conv_b"):
            p[k] = (0.5 * rng.standard_normal(p[k].shape)).astype(np.float32)
        p["d_skip"] = rng.standard_normal(p["d_skip"].shape).astype(np.float32)
    if leaves == "clamp":
        p["a_log"][::2] = np.linspace(4.0, 12.0, len(p["a_log"][::2]), dtype=np.float32)
    return p


def _both(p: dict) -> tuple[dict, dict]:
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v.copy()) for k, v in p.items()})


def _x(t: int, b=2, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, t, CFG.d_model)).astype(np.float32)


def _close(got: np.ndarray, want: np.ndarray) -> None:
    np.testing.assert_allclose(got, want, rtol=0, atol=SSM_TOL * np.abs(want).max())


def test_module_holds_init_ssm_leaves():
    port = ssm.SSM(CFG, torch.Generator().manual_seed(0))
    want = ref_ssm.init_ssm(jax.random.PRNGKey(0), REF_CFG)
    got = dict(port.named_parameters())
    assert list(got) == list(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
    for name, fill in (("conv_b", 0.0), ("a_log", 0.0), ("dt_bias", 0.0), ("d_skip", 1.0)):
        assert bool((got[name] == fill).all()), name
    bf16 = ssm.SSM(dataclasses.replace(CFG, dtype="bfloat16"), torch.Generator())
    assert {n: p.dtype for n, p in bf16.named_parameters()} == {
        "in_proj": torch.bfloat16, "conv_w": torch.bfloat16, "conv_b": torch.bfloat16,
        "a_log": torch.float32, "dt_bias": torch.float32, "d_skip": torch.float32,
        "out_proj": torch.bfloat16}


@pytest.mark.parametrize("t", [1, 255, 256, 257, 600])
def test_ssm_train_matches_reference(t):
    """T below, at and one past a 256-token chunk, and over two padded chunks."""
    ref_p, p = _both(_params())
    x = _x(t)
    want = np.asarray(_ref_train(ref_p, jnp.asarray(x), REF_CFG, 256))
    got = ssm.ssm_train(p, torch.from_numpy(x), CFG)
    assert got.shape == (2, t, CFG.d_model) and got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("leaves", ["init", "clamp"])
def test_ssm_train_matches_reference_at_init_and_at_the_clamp(leaves):
    ref_p, tp = _both(_params(leaves))
    x = _x(300)
    if leaves == "clamp":
        _, a = ref_ssm._gates(ref_p, ref_ssm._split_proj(ref_p, jnp.asarray(x), REF_CFG)[2])
        assert (np.asarray(a) < 1e-20).mean() > 0.1 and (np.asarray(a) > 0.1).mean() > 0.1
    want = np.asarray(_ref_train(ref_p, jnp.asarray(x), REF_CFG, 256))
    _close(ssm.ssm_train(tp, torch.from_numpy(x), CFG).numpy(), want)


# the default, and three chunks a group: f32 [3, B 2, H 8, 8, 8]
@pytest.mark.parametrize("group_bytes", [ssm.SSD_GROUP_BYTES, 4 * 3 * 2 * 8 * 8 * 8])
def test_small_chunks_over_many_groups_match_reference(group_bytes, monkeypatch):
    """chunk 8 over 100 tokens (13 chunks): in one group, and three chunks
    a group, so the state crosses group boundaries."""
    monkeypatch.setattr(ssm, "SSD_GROUP_BYTES", group_bytes)
    ref_p, p = _both(_params())
    x = _x(100)
    want = np.asarray(_ref_train(ref_p, jnp.asarray(x), REF_CFG, 8))
    _close(ssm.ssm_train(p, torch.from_numpy(x), CFG, chunk=8).numpy(), want)


@pytest.mark.parametrize("leaves", ["random", "clamp"])
def test_steps_match_train_and_the_reference_caches(leaves):
    """``ssm_step`` token by token against the port's chunked scan over
    the same tokens (T 300: past one chunk), and its output and caches
    after each of the first k steps against the reference's ``ssm_step``."""
    ref_p, p = _both(_params(leaves))
    x = _x(300)
    full = ssm.ssm_train(p, torch.from_numpy(x), CFG).numpy()
    cache = ssm.init_ssm_cache(CFG, 2)
    ref_cache = ref_ssm.init_ssm_cache(REF_CFG, 2)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in ref_cache.items()}
    outs = []
    for i in range(300):
        y, cache = ssm.ssm_step(p, torch.from_numpy(x[:, i:i + 1]), CFG, cache)
        outs.append(y.numpy())
        if i < 6:
            want, ref_cache = _ref_step(ref_p, jnp.asarray(x[:, i:i + 1]), REF_CFG, ref_cache)
            _close(y.numpy(), np.asarray(want))
            for k in ("conv", "h"):
                _close(cache[k].numpy(), np.asarray(ref_cache[k]))
    _close(np.concatenate(outs, axis=1), full)


def test_bf16_conv_and_cache_dtypes_follow_the_reference():
    """The conv's W products summed in bf16, conv_b added, SiLU in f32; the
    step's conv cache in bf16, its state and gates in f32, y in bf16."""
    p = _params()
    bf = {"in_proj", "conv_w", "conv_b", "out_proj"}
    ref_p = {k: jnp.asarray(v, jnp.bfloat16 if k in bf else jnp.float32) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()).to(torch.bfloat16 if k in bf else torch.float32)
          for k, v in p.items()}
    xbc = np.random.default_rng(2).standard_normal((2, 50, p["conv_w"].shape[1]))
    want, want_state = ref_ssm._conv_scan(ref_p, jnp.asarray(xbc, jnp.bfloat16))
    got, state = ssm._conv_scan(tp, torch.from_numpy(xbc).bfloat16())
    assert got.dtype == torch.float32 and state.dtype == torch.bfloat16
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(state.float().numpy(), np.asarray(want_state, np.float32))
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    cache = ssm.init_ssm_cache(cfg, 2, torch.bfloat16)
    y, cache = ssm.ssm_step(tp, torch.from_numpy(_x(1)).bfloat16(), cfg, cache)
    assert (y.dtype, cache["conv"].dtype, cache["h"].dtype) == \
        (torch.bfloat16, torch.bfloat16, torch.float32)
    assert ssm.ssm_train(tp, torch.from_numpy(_x(9)).bfloat16(), cfg).dtype == torch.bfloat16
