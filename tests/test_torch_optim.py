"""The port's optimizer (``repro_torch.optim``) against the reference's
``repro.optim`` on the same numpy inputs: the schedules, ``global_norm``,
``clip_by_global_norm``, and several ``adamw`` steps with f32 and bf16
params, ``m_dtype``, weight decay, a schedule and ``max_grad_norm``.

Both sides get the same gradients, so each step is the same elementwise
f32 arithmetic. Tolerances, of each leaf's largest value: f32 results to
``F32_RTOL`` = 1e-6 (measured at most 4.1e-7: a few f32 ulps where the
two libraries round ``sqrt``, ``pow`` and a division differently); a
bf16 result is rounded once from that f32 value, so it may land one bf16
ulp away where the f32 values straddle a rounding boundary
(``BF16_RTOL`` = 2**-7; measured at most 1.2e-7, no bf16 result off).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro_torch import optim
from repro_torch.optim import optimizers

torch.set_num_threads(1)

F32_RTOL = 1e-6
BF16_RTOL = 2.0 ** -7
SHAPES = {"w": (17, 33), "b": (33,), "emb": (64, 8), "scale": (8,)}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


def _torch(tree, dtype):
    return {k: torch.from_numpy(v).to(dtype) for k, v in tree.items()}


def _jax(tree, dtype):
    return {k: jnp.asarray(v, dtype) for k, v in tree.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rtol, what):
    assert set(got) == set(want), what
    for k in got:
        g, w = _np(got[k]), _np(want[k])
        np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * np.abs(w).max(),
                                   err_msg=f"{what}[{k}]")


@pytest.mark.parametrize("sched", ["constant", "cosine", "cosine_no_warmup"])
def test_schedules_match_reference(sched):
    args = {"constant": (3e-4,), "cosine": (1e-3, 10, 100, 1e-5),
            "cosine_no_warmup": (2e-3, 0, 50)}[sched]
    make = "constant_schedule" if sched == "constant" else "cosine_schedule"
    mine, ref = getattr(optim, make)(*args), getattr(ref_optim, make)(*args)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        got = mine(torch.tensor(step, dtype=torch.int32))
        want = ref(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=F32_RTOL, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_global_norm_and_clip_match_reference(dtype):
    tdt, jdt = DTYPES[dtype]
    tree = _tree(1)
    norm = optim.global_norm(_torch(tree, tdt))
    want = ref_optim.global_norm(_jax(tree, jdt))
    assert norm.dtype == torch.float32
    np.testing.assert_allclose(float(norm), float(want), rtol=F32_RTOL)
    for max_norm in (0.5 * float(want), 10 * float(want)):     # clips, then does not
        got, gn = optim.clip_by_global_norm(_torch(tree, tdt), max_norm)
        ref, rn = ref_optim.clip_by_global_norm(_jax(tree, jdt), max_norm)
        np.testing.assert_allclose(float(gn), float(rn), rtol=F32_RTOL)
        assert all(got[k].dtype == tdt for k in got)
        _close(got, ref, F32_RTOL if dtype == "float32" else BF16_RTOL, "clipped")


ADAMW_CASES = {
    "f32": dict(dtype="float32", kw=dict(learning_rate=1e-3)),
    "f32_decay_clip_cosine": dict(dtype="float32", kw=dict(
        weight_decay=0.1, max_grad_norm=1.0, b1=0.8, b2=0.99, eps=1e-6)),
    "bf16": dict(dtype="bfloat16", kw=dict(learning_rate=1e-2, weight_decay=0.01)),
    "bf16_m_bf16_decay_clip": dict(dtype="bfloat16", kw=dict(
        learning_rate=3e-3, weight_decay=0.05, max_grad_norm=2.0, m_dtype="bfloat16")),
    "f32_m_bf16_v_bf16": dict(dtype="float32", kw=dict(
        learning_rate=1e-3, m_dtype="bfloat16", v_dtype="bfloat16")),
}


def _adamw_pair(kw):
    mine, ref = dict(kw), dict(kw)
    if "learning_rate" not in kw:
        mine["learning_rate"] = optim.cosine_schedule(1e-2, 2, 6)
        ref["learning_rate"] = ref_optim.cosine_schedule(1e-2, 2, 6)
    for key in ("m_dtype", "v_dtype"):
        if key in kw:
            mine[key], ref[key] = DTYPES[kw[key]]
    return optim.adamw(**mine), ref_optim.adamw(**ref)


@pytest.mark.parametrize("case", ADAMW_CASES)
def test_adamw_steps_match_reference(case):
    """Five steps with fresh gradients each, every delta, moment and
    updated param against the reference's, and the moments' dtypes."""
    dtype = ADAMW_CASES[case]["dtype"]
    kw = ADAMW_CASES[case]["kw"]
    tdt, jdt = DTYPES[dtype]
    rtol = F32_RTOL if dtype == "float32" and "m_dtype" not in kw else BF16_RTOL
    tx, ref_tx = _adamw_pair(kw)
    params, ref_params = _torch(_tree(2, 0.5), tdt), _jax(_tree(2, 0.5), jdt)
    state, ref_state = tx.init(params), ref_tx.init(ref_params)
    assert isinstance(state, optim.OptState) and state.step.dtype == torch.int32
    m_dt = DTYPES[kw["m_dtype"]][0] if "m_dtype" in kw else tdt
    v_dt = DTYPES[kw["v_dtype"]][0] if "v_dtype" in kw else torch.float32
    assert all(m.dtype == m_dt for m in state.mu.values())
    assert all(v.dtype == v_dt for v in state.nu.values())
    for step in range(5):
        grads = _tree(10 + step, 0.1 * (step + 1))
        before = {k: p.clone() for k, p in params.items()}
        deltas, state = tx.update(_torch(grads, tdt), state, params)
        ref_deltas, ref_state = ref_tx.update(_jax(grads, jdt), ref_state, ref_params)
        assert all(torch.equal(params[k], before[k]) for k in params)   # pure
        assert int(state.step) == int(ref_state.step) == step + 1
        _close(deltas, ref_deltas, rtol, f"deltas {step}")
        _close(state.mu, ref_state.mu, rtol, f"mu {step}")
        _close(state.nu, ref_state.nu, rtol, f"nu {step}")
        params = optim.apply_updates(params, deltas)
        ref_params = ref_optim.apply_updates(ref_params, ref_deltas)
        assert all(p.dtype == tdt for p in params.values())
        _close(params, ref_params, rtol, f"params {step}")
    assert all(m.dtype == m_dt for m in state.mu.values())
    assert all(v.dtype == v_dt for v in state.nu.values())


def test_adamw_is_not_torch_adamw_in_bf16():
    """Why the port keeps the reference's rule: ``torch.optim.AdamW`` keeps
    both moments in bf16 for bf16 params and decays as its own multiply,
    so after a few steps its params differ from the reference's, while
    the port's equal them."""
    tree = _tree(3, 0.5)
    tx, ref_tx = _adamw_pair(dict(learning_rate=1e-2, weight_decay=0.1))
    params, ref_params = _torch(tree, torch.bfloat16), _jax(tree, jnp.bfloat16)
    state, ref_state = tx.init(params), ref_tx.init(ref_params)
    leaves = [torch.nn.Parameter(p.clone()) for p in params.values()]
    torch_opt = torch.optim.AdamW(leaves, lr=1e-2, betas=(0.9, 0.95), eps=1e-8,
                                  weight_decay=0.1)
    for step in range(4):
        grads = _tree(20 + step, 0.1)
        deltas, state = tx.update(_torch(grads, torch.bfloat16), state, params)
        params = optim.apply_updates(params, deltas)
        ref_deltas, ref_state = ref_tx.update(_jax(grads, jnp.bfloat16), ref_state, ref_params)
        ref_params = ref_optim.apply_updates(ref_params, ref_deltas)
        for leaf, g in zip(leaves, _torch(grads, torch.bfloat16).values()):
            leaf.grad = g
        torch_opt.step()
    _close(params, ref_params, BF16_RTOL, "port")
    diff = max(float(np.abs(_np(leaf.detach()) - _np(ref_params[k])).max())
               for leaf, k in zip(leaves, params))
    assert diff > 0


def test_optstate_and_transform_types():
    assert optimizers.OptState._fields == ref_optim.OptState._fields
    assert [f.name for f in optimizers.dataclasses.fields(optim.GradientTransform)] == \
        ["init", "update"]
    tx = optim.adamw(1e-3)
    assert isinstance(tx, optim.GradientTransform)
    with pytest.raises(optimizers.dataclasses.FrozenInstanceError):
        tx.init = None
