"""The port's train step against the reference's for the SSM and hybrid
archs (mamba2-130m, jamba-v0.1-52b; ``reduced()``, f32), as
``tests/test_torch_train.py`` holds the attention archs, with its helpers
and optimizer; then the SSD scan's gradient (``models/ssm.ssm_train``)
alone.

Tolerances are those of ``tests/test_torch_train.py``: measured at most
5.3e-6 (mu) and 7.1e-6 (nu) of a leaf's largest value and 3.8e-4·lr
(params) for mamba2 (a 2.8x margin). jamba is held to ``JAMBA_TOL`` = 2e-4 in their place:
measured 4.2e-5 / 6.2e-5 / 5.3e-3·lr (a 3.2x margin), its ``a_log``
gradients the farthest. Its hidden states reach 17, and its forward is
already 4e-5 from the reference's (``tests/test_torch_lm.py``, where a
float64 run puts both packages about as far from the exact function).

The SSD scan alone: the port at chunk 8 against the reference at chunk 8
to ``SSD_TOL`` = 1e-5 of each leaf's largest value (measured at most
1.0e-6); the port at its chunk 256 against the reference at chunk 8 to
``CHUNKING_TOL`` = 1e-4 (measured 3.3e-5, ``a_log`` and ``dt_bias``,
whose gradients sum the exponents' sensitivities over every position:
another chunking sums them in another order, and the reference itself
moves 4.3e-6 between chunk 256 and 8 at T 40, where both are finite).

The reference's SSD gradient overflows (ROADMAP Queue 3, reference fault
2): ``ssm_train`` takes exp of every pair's log-decay difference and
masks the non-causal half after the exp (``src/repro/models/ssm.py:125-126``).
Past about 88 the exp is inf in f32; the forward masks it to 0, but the
backward multiplies the masked 0 by inf, and the gradient is NaN.
mamba2 reduced with its init constants meets it at T 256 (measured:
``grad_norm`` nan), and train_4k's length runs far past it.
The port masks before the exp, so it gets the same forward and a finite
gradient. Here it is held at such inputs to the reference run at chunk
8, a chunking that does not overflow and computes the same function.
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
from repro_torch.train import step
from test_torch_train import TOL, assert_step_matches_reference, port_train_step, setup

torch.set_num_threads(1)

JAMBA_TOL = 2e-4
SSD_TOL = 1e-5
CHUNKING_TOL = 1e-4
SSM_ARCHS = ("mamba2-130m", "jamba-v0.1-52b")


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_train_step_matches_reference(arch):
    assert_step_matches_reference(arch, 1, JAMBA_TOL if arch.startswith("jamba") else TOL)


def test_train_step_two_microbatches_matches_reference():
    assert_step_matches_reference("mamba2-130m", 2)


def test_mamba2_train_forward_equals_serving_forward():
    """The SSD with autograd (out of place) gives the logits the serving
    path (in place, under no_grad) gives, bit for bit, and the serving
    path still equals its own decode (``test_archs_smoke.py:90``'s check,
    here at the reference's 2e-2 and at 5e-5)."""
    _, _, model, batch = setup("mamba2-130m")
    tokens = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        served = model(tokens)
        cache = model.init_cache(tokens.shape[0], tokens.shape[1])
        steps = []
        for i in range(tokens.shape[1]):
            logits, cache = model.decode_step(tokens[:, i:i + 1], cache)
            steps.append(logits)
    leaves = {k: v.requires_grad_(True) for k, v in step.model_params(model).items()}
    trained = torch.func.functional_call(model, leaves, (tokens,))
    assert not trained.requires_grad  # forward() stays a no_grad serving entry
    loss_path = _grad_logits(model, leaves, tokens)
    assert loss_path.requires_grad
    assert torch.equal(loss_path.detach(), served)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), served.numpy(), rtol=0, atol=5e-5)


def _grad_logits(model, leaves, tokens):
    """Logits through ``_hidden`` and ``_logits`` with autograd on, as
    ``Model.loss`` computes them."""
    with torch.enable_grad():
        return step._call(model, leaves,
                          lambda m, t: m._logits(m._hidden(t, None, remat=True)[0]), tokens)


def _ssd_inputs(seed, t):
    """mamba2 reduced's SSD params with random constants (the draws of
    ``test_torch_lm._pair``), an input [2, t, d] and an output gradient."""
    ref_cfg = dataclasses.replace(ref_get_config("mamba2-130m").reduced(), dtype="float32")
    params = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                    ref_ssm.init_ssm(jax.random.PRNGKey(seed), ref_cfg))
    rng = np.random.default_rng(seed + 20)
    for name in ("a_log", "dt_bias", "d_skip", "conv_b"):
        params[name] = (0.5 * rng.standard_normal(params[name].shape)).astype(np.float32)
    x = rng.standard_normal((2, t, ref_cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, t, ref_cfg.d_model)).astype(np.float32)
    return ref_cfg, configs.ModelConfig(**dataclasses.asdict(ref_cfg)), params, x, dy


def _ref_grads(ref_cfg, params, x, dy, chunk):
    @jax.jit
    def value_and_vjp(p, u, g):
        y, vjp = jax.vjp(lambda p_, u_: ref_ssm.ssm_train(p_, u_, ref_cfg, chunk=chunk), p, u)
        return (y,) + vjp(g)

    y, gp, gx = value_and_vjp({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
                              jnp.asarray(dy))
    return np.asarray(y), {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx)


def _port_grads(cfg, params, x, dy, chunk=256):
    leaves = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    u = torch.from_numpy(x).requires_grad_(True)
    y = ssm.ssm_train(leaves, u, cfg, chunk=chunk)
    grads = torch.autograd.grad(y, [*leaves.values(), u], torch.from_numpy(dy))
    return (y.detach().numpy(), {k: g.numpy() for k, g in zip(leaves, grads)},
            grads[-1].numpy())


def _assert_close(got, want, tol):
    (y, gp, gx), (wy, wgp, wgx) = got, want
    np.testing.assert_allclose(y, wy, rtol=0, atol=tol * np.abs(wy).max())
    np.testing.assert_allclose(gx, wgx, rtol=0, atol=tol * np.abs(wgx).max())
    for k in wgp:
        np.testing.assert_allclose(gp[k], wgp[k], rtol=0, atol=tol * np.abs(wgp[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("t", [1, 40, 300])
def test_ssd_gradient_matches_reference(t):
    """``ssm_train``'s gradient (every SSM leaf and the input) against
    ``jax.vjp`` of the reference's at chunk 8, at T inside one chunk and
    past it (300: two chunks and a ragged tail), with random constants;
    the port at its own chunk 256 and at chunk 8."""
    ref_cfg, cfg, params, x, dy = _ssd_inputs(0, t)
    want = _ref_grads(ref_cfg, params, x, dy, chunk=8)
    assert all(np.isfinite(g).all() for g in want[1].values())
    _assert_close(_port_grads(cfg, params, x, dy), want, CHUNKING_TOL)
    _assert_close(_port_grads(cfg, params, x, dy, chunk=8), want, SSD_TOL)


def test_ssd_gradient_finite_where_reference_overflows():
    """At 255 positions in one chunk with these constants the reference's
    own gradient (chunk 256) is NaN while its forward is finite; the
    port's forward equals it, and its gradient is finite and equals the
    reference's at chunk 8."""
    ref_cfg, cfg, params, x, dy = _ssd_inputs(0, 255)
    ry, rgp, rgx = _ref_grads(ref_cfg, params, x, dy, chunk=256)
    assert np.isfinite(ry).all() and np.isnan(rgx).any()
    got = _port_grads(cfg, params, x, dy)
    np.testing.assert_allclose(got[0], ry, rtol=0, atol=SSD_TOL * np.abs(ry).max())
    _assert_close(got, _ref_grads(ref_cfg, params, x, dy, chunk=8), CHUNKING_TOL)


def test_ssd_serving_path_equals_grad_path():
    """Under no_grad the scan works in place (the decay matrix, the state
    hand-off); with autograd out of place. Same numbers, bit for bit."""
    _, cfg, params, x, _ = _ssd_inputs(1, 300)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    with torch.no_grad():
        served = ssm.ssm_train(tp, torch.from_numpy(x), cfg, chunk=64)
    u = torch.from_numpy(x).requires_grad_(True)
    trained = ssm.ssm_train(tp, u, cfg, chunk=64)
    assert trained.requires_grad
    assert torch.equal(trained.detach(), served)
