"""The port's train step (``repro_torch.train.step``, ``Model.loss``,
``repro_torch.optim``) against the reference's ``repro.train.step`` on
the CPU, in f32: the attention archs here (dense, MoE, the VLM and the
audio encoder-decoder), ``tests/test_torch_train_ssm.py`` the SSM and
hybrid archs. Each arch's ``reduced()`` config gets the reference's params
carried across (``test_torch_lm._pair``: norm scales of cross and encoder
sublayers and the SSM constants drawn at random), one batch of seeded
tokens (B 2, T 24; extras drawn at random) and one step of the same
``adamw``; loss, nll, aux and ``grad_norm``, and the updated params and
both moments (the reference's trees carried through
``convert.lm_params_from_jax``) must agree. Also: 2 microbatches, remat
on against off, every parameter's gradient nonzero, ``make_eval_step``,
and the ``TrainState`` round trip through ``checkpoint``.

The step's optimizer is ``adamw(1e-3, eps=1e-3, weight_decay=0.1)``. At
the default eps of 1e-8 the first Adam step is sign(g) for every element
whose |g| is above 1e-8, so an element whose gradient is within float
rounding of 0 may move by +lr in one package and -lr in the other:
measured, 14 of granite-8b reduced's 689,280 elements did (their
gradients agree to 2.9e-6 of the leaf's largest, as the moments show).
At eps 1e-3 the update is a smooth function of the gradient, so the
params test the gradients and the rule; ``tests/test_torch_optim.py``
holds the rule at the default eps on equal gradients.

Tolerances: the metrics relative, ``METRIC_RTOL`` = 1e-5 (measured at
most 1.2e-6); each moment leaf to ``TOL`` = 2e-5 times its largest
reference value (measured at most 2.9e-6 for mu, 4.4e-6 for nu, a 4.5x
margin); each param leaf to ``TOL`` times its largest value plus
``100 * TOL`` times lr, since a param moves by lr·u with u of order 1,
and where |g| is near eps u is 1/eps times as sensitive to g as g
itself (a leaf that starts at 0, such as ``conv_b``, holds nothing but
that update): measured at most 3.9e-4·lr, a 5x margin. The packages
sum in other orders (XLA's dots and its autodiff's against torch's),
nothing more.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.configs import get_config as ref_get_config
from repro.models import make_model as ref_make_model
from repro.train import step as ref_step
from repro_torch import checkpoint, convert, optim
from repro_torch.configs import base as configs
from repro_torch.models import Model, layers
from repro_torch.train import step
from test_torch_lm import _extras, _pair

torch.set_num_threads(1)

TOL = 2e-5
METRIC_RTOL = 1e-5
B, T = 2, 24
ADAMW = dict(learning_rate=1e-3, eps=1e-3, weight_decay=0.1)
ATTN_ARCHS = ("granite-8b", "granite-3-8b", "phi3-medium-14b", "chatglm3-6b",
              "qwen3-moe-30b-a3b", "grok-1-314b", "llama-3.2-vision-11b", "whisper-base")


@functools.lru_cache(maxsize=None)
def setup(arch: str, seed: int = 0):
    """(ref model, ref params, port model, numpy batch) for an arch's
    ``reduced()`` config in f32. mamba2 keeps the reference's init
    constants for its SSM (``a_log`` 0, ``dt_bias`` 0, ``d_skip`` 1,
    ``conv_b`` 0): at ``_pair``'s random ones the reference's own
    gradient is NaN (ROADMAP Queue 3, reference fault 2; held in
    ``test_torch_train_ssm.py``)."""
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(), dtype="float32")
    if arch == "mamba2-130m":
        ref = ref_make_model(ref_cfg)
        params = ref.init(jax.random.PRNGKey(seed))
        leaves = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
        cfg = configs.ModelConfig(**dataclasses.asdict(ref_cfg))
        model = convert.lm_params_from_jax(leaves, cfg, device="cpu")
    else:
        _, ref, params, model = _pair("float32", seed, ref_cfg)
    toks = np.random.default_rng(seed + 1).integers(0, ref_cfg.vocab_size, (B, T + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    batch.update(_extras(ref_cfg, B) or {})
    return ref, params, model, batch


@functools.lru_cache(maxsize=None)
def ref_train_step(arch: str, micro: int):
    """The reference's jitted step and its result from the initial state
    (each compiled once per arch and microbatch count)."""
    ref, params, _, batch = setup(arch)
    tx = ref_optim.adamw(**ADAMW)
    fn = jax.jit(ref_step.make_train_step(ref, tx, num_microbatches=micro))
    state, metrics = fn(ref_step.init_state(params, tx),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    return state, {k: float(v) for k, v in metrics.items()}


def port_train_step(arch: str, micro: int = 1, remat: bool = True):
    _, _, model, batch = setup(arch)
    tx = optim.adamw(**ADAMW)
    state = step.init_state(step.model_params(model), tx)
    return step.make_train_step(model, tx, num_microbatches=micro, remat=remat)(state, batch)


def ref_tree(tree, model) -> dict[str, np.ndarray]:
    """A reference param-shaped tree (params, mu or nu) by the port's names."""
    leaves = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)
    port = convert.lm_params_from_jax(leaves, model.cfg, device="cpu")
    return {k: v.numpy() for k, v in port.named_parameters()}


def assert_step_matches_reference(arch: str, micro: int, tol: float = TOL) -> step.TrainState:
    _, _, model, _ = setup(arch)
    ref_state, ref_metrics = ref_train_step(arch, micro)
    state, metrics = port_train_step(arch, micro)
    assert set(metrics) == {"loss", "nll", "aux", "grad_norm"}
    for k, v in metrics.items():
        assert v.dtype == torch.float32 and v.shape == ()
        assert np.isfinite(ref_metrics[k]), (k, ref_metrics[k])
        np.testing.assert_allclose(float(v), ref_metrics[k], rtol=METRIC_RTOL, atol=1e-7,
                                   err_msg=k)
    assert int(state.step) == int(ref_state.step) == 1
    assert int(state.opt_state.step) == int(ref_state.opt_state.step) == 1
    for what, mine, ref in (("params", state.params, ref_state.params),
                            ("mu", state.opt_state.mu, ref_state.opt_state.mu),
                            ("nu", state.opt_state.nu, ref_state.opt_state.nu)):
        want = ref_tree(ref, model)
        assert set(mine) == set(want)
        for k, w in want.items():
            atol = tol * np.abs(w).max() + (100 * tol * ADAMW["learning_rate"]
                                            if what == "params" else 0.0)
            np.testing.assert_allclose(mine[k].numpy(), w, rtol=0, atol=atol,
                                       err_msg=f"{what} {k}")
    # every leaf got a gradient: at step 1, mu = 0.1 * g
    dead = [k for k, m in state.opt_state.mu.items() if not bool((m != 0).any())]
    assert not dead, f"no gradient reached {dead}"
    # the module itself is untouched: serving builds no graph
    assert not any(p.requires_grad for p in model.parameters())
    return state


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_train_step_matches_reference(arch):
    assert_step_matches_reference(arch, 1)


@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-moe-30b-a3b"])
def test_train_step_two_microbatches_matches_reference(arch):
    """f32 accumulation over 2 microbatches (the MoE arch routes each
    microbatch at its own capacity, as the reference does)."""
    state = assert_step_matches_reference(arch, 2)
    assert all(m.dtype == torch.float32 for m in state.opt_state.mu.values())


@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-moe-30b-a3b", "whisper-base",
                                  "mamba2-130m"])
def test_remat_changes_no_number(arch):
    a_state, a_metrics = port_train_step(arch, remat=True)
    b_state, b_metrics = port_train_step(arch, remat=False)
    for k in a_metrics:
        assert torch.equal(a_metrics[k], b_metrics[k]), k
    for k in a_state.params:
        assert torch.equal(a_state.params[k], b_state.params[k]), k
        assert torch.equal(a_state.opt_state.nu[k], b_state.opt_state.nu[k]), k


def test_whisper_encoder_gets_gradients():
    """The loss trains the encoder (``_memory_for`` -> the encoder over the
    frames): each of its leaves, ``enc_norm`` and every ``dec_cross``
    leaf moves in one step."""
    _, _, model, _ = setup("whisper-base")
    state, _ = port_train_step("whisper-base")
    names = [k for k in state.params if k.split(".")[0] in ("encoder", "enc_norm", "dec_cross")]
    assert len([k for k in names if k.startswith("encoder.")]) == 2 * 8  # 2 layers x 8 leaves
    params = dict(model.named_parameters())
    moved = [k for k in names if not torch.equal(state.params[k], params[k])]
    assert moved == names


def test_loss_and_eval_step_match_reference():
    """``make_eval_step`` (``Model.loss`` without a graph or remat) against
    the reference's, and the loss's terms: the z-loss and 0.01 x aux."""
    arch = "qwen3-moe-30b-a3b"
    ref, params, model, batch = setup(arch)
    want = jax.jit(ref_step.make_eval_step(ref))(params, {k: jnp.asarray(v)
                                                          for k, v in batch.items()})
    got = step.make_eval_step(model)(step.model_params(model), batch)
    assert set(got) == set(want) == {"loss", "nll", "aux"}
    for k in got:
        assert not got[k].requires_grad
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=METRIC_RTOL, err_msg=k)
    assert float(got["aux"]) > 0
    with torch.no_grad():
        logits = model(torch.from_numpy(batch["tokens"])).float()
    lse = torch.logsumexp(logits, -1)
    nll = (lse - logits.gather(-1, torch.from_numpy(batch["labels"]).long()[..., None])[..., 0])
    total = nll.mean() + 1e-4 * lse.square().mean() + 0.01 * got["aux"]
    np.testing.assert_allclose(float(got["loss"]), float(total), rtol=1e-6)


def test_grads_in_param_dtype_and_no_module_graph():
    """At one microbatch the grads keep the param dtype (bf16 here), and
    the step leaves the model's own parameters as they were."""
    _, _, model, batch = setup("granite-8b")
    bf16 = Model(dataclasses.replace(model.cfg, dtype="bfloat16"), device="cpu")
    params = step.model_params(bf16)
    before = {k: v.clone() for k, v in bf16.named_parameters()}
    loss, metrics, grads = step.loss_and_grads(bf16, params, batch)
    for k, p in params.items():
        assert grads[k].dtype == p.dtype and grads[k].shape == p.shape, k
    assert loss.dtype == torch.float32 and not loss.requires_grad
    assert all(torch.equal(before[k], v) for k, v in bf16.named_parameters())
    assert layers.dtype_of(bf16.cfg) == torch.bfloat16


def test_train_state_round_trip_through_checkpoint(tmp_path):
    """``TrainState`` and its ``OptState`` (NamedTuples, dicts of tensors,
    0-d int32 steps) through ``checkpoint.save`` / ``restore``."""
    state, _ = port_train_step("granite-8b")
    checkpoint.save(tmp_path, state, 1)
    zeros = lambda tree: {k: torch.zeros_like(v) for k, v in tree.items()}
    step0 = torch.zeros((), dtype=torch.int32)
    like = step.TrainState(zeros(state.params), optim.OptState(
        step0, zeros(state.opt_state.mu), zeros(state.opt_state.nu)), step0)
    back = checkpoint.restore(tmp_path, like)
    assert isinstance(back, step.TrainState) and isinstance(back.opt_state, optim.OptState)
    assert checkpoint.latest_step(tmp_path) == 1
    assert back.step.dtype == torch.int32 and int(back.step) == 1
    assert int(back.opt_state.step) == 1
    for a, b in ((back.params, state.params), (back.opt_state.mu, state.opt_state.mu),
                 (back.opt_state.nu, state.opt_state.nu)):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
