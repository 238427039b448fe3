"""The port's MoE (``repro_torch.models.layers.moe`` and its steps) against
the JAX package's ``repro.models.layers.moe`` outside a mesh, in f32, on
the same params (``init_moe``'s, carried across as numpy) and inputs.

Held: the routing (experts, slots, the kept mask) bit for bit, the
dispatch buffer exactly (it is a copy of token rows), gates and router
probabilities within 1e-6, the output within 1e-5 absolute and the
load-balance loss within 1e-6 relative. Measured max errors over these
inputs: output 4.8e-7 (values up to 3.3), aux 2.3e-7 relative, gates
6.0e-8, probabilities 1.8e-7; the two packages sum the matmuls in other
orders, nothing more.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro_torch.configs import base as configs
from repro_torch.models import layers

torch.set_num_threads(1)

OUT_TOL = 1e-5

_ref_route = jax.jit(ref_layers._route_and_dispatch, static_argnums=(2, 3, 4, 5))
_ref_moe = jax.jit(ref_layers.moe, static_argnums=2)


def _cfg(act="swiglu", shards=1, capacity_factor=1.25, d=32, f=64, e=4, k=2):
    ref = dataclasses.replace(
        ref_get_config("qwen3-moe-30b-a3b").reduced(), d_model=d, d_ff=f, num_experts=e,
        experts_per_token=k, act=act, moe_ffn_shards=shards,
        capacity_factor=capacity_factor, dtype="float32")
    return ref, configs.ModelConfig(**dataclasses.asdict(ref))


def _params(ref_cfg, seed=0, tie_columns=()):
    """The reference's init_moe, as (jax tree, the port's torch dict);
    each pair in ``tie_columns`` gives two experts the same router column,
    so every token's probabilities for them are equal."""
    p = {k: np.array(v) for k, v in ref_layers.init_moe(jax.random.PRNGKey(seed),
                                                           ref_cfg).items()}
    for a, b in tie_columns:
        p["router"][:, b] = p["router"][:, a]
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v.copy()) for k, v in p.items()})


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _route_both(ref_cfg, ref_p, p, x):
    """Both packages' ``_route_and_dispatch`` at ``moe``'s capacity."""
    e, k, vs = ref_cfg.num_experts, ref_cfg.experts_per_token, ref_cfg.moe_ffn_shards
    t = x.shape[0] * x.shape[1]
    cap = min(int(np.ceil(t * k * vs * ref_cfg.capacity_factor / (e * vs))), t)
    xt = x.reshape(t, -1)
    want = _ref_route(jnp.asarray(xt), ref_p["router"], e, k, cap, vs)
    got = layers._route_and_dispatch(torch.from_numpy(xt), p["router"], e, k, cap, vs)
    return cap, [np.asarray(w) for w in want], [g.numpy() for g in got]


def _check(ref_cfg, cfg, ref_p, p, x):
    """Routing bit-equal, then moe's output and aux loss within tolerance;
    returns the share of assignments dropped."""
    _, want, got = _route_both(ref_cfg, ref_p, p, x)
    buf, slot, st, gate, keep, probs, expert = range(7)
    for i in (slot, st, keep, expert):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_array_equal(got[buf], want[buf])
    for i in (gate, probs):
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=1e-6)
    y, aux = layers.moe(p, torch.from_numpy(x), cfg)
    ref_y, ref_aux = _ref_moe(ref_p, jnp.asarray(x), ref_cfg)
    assert y.dtype == torch.float32 and y.shape == x.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=0, atol=OUT_TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-6)
    return 1.0 - want[keep].mean()


@pytest.mark.parametrize("capacity", ["drops", "ample"])
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_matches_reference(act, shards, capacity):
    ref_cfg, cfg = _cfg(act, shards, 0.5 if capacity == "drops" else 8.0)
    ref_p, p = _params(ref_cfg)
    dropped = _check(ref_cfg, cfg, ref_p, p, _x(2, 16, 32))
    assert (dropped > 0) == (capacity == "drops")


@pytest.mark.parametrize("shards", [1, 2])
def test_gate_ties_go_to_the_lower_expert(shards):
    """Experts 0 / 1 and 2 / 3 share router columns, so every token ties
    twice: top-k must take the lower index first, as ``jax.lax.top_k``."""
    ref_cfg, cfg = _cfg(shards=shards, e=6, k=3, capacity_factor=0.75)
    ref_p, p = _params(ref_cfg, seed=3, tie_columns=((0, 1), (2, 3)))
    _, want, got = _route_both(ref_cfg, ref_p, p, _x(2, 12, 32, seed=4))
    probs, expert = got[5], got[6]
    assert (probs[:, 0] == probs[:, 1]).all() and (probs[:, 2] == probs[:, 3]).all()
    chosen = [set(row) for row in expert]
    assert any({0, 1} <= row for row in chosen) and any({2, 3} <= row for row in chosen)
    assert any(0 in row and 1 not in row for row in chosen)        # a tie, cut by k
    _check(ref_cfg, cfg, ref_p, p, _x(2, 12, 32, seed=4))


def test_top_k_orders_ties_as_jax():
    """Many exact ties (values from a small set) along rows of two widths."""
    rng = np.random.default_rng(5)
    for width, k in ((8, 3), (128, 8)):
        probs = rng.integers(0, 4, (64, width)).astype(np.float32) / 4
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = layers._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("e,k,batch", [(64, 8, 4), (16, 8, 4), (4, 2, 1), (8, 2, 3)])
def test_decode_sized_tokens_keep_the_reference_capacity(e, k, batch):
    """One token a sequence: qwen3-moe's ratio (E 128, top-8) at batch 4
    gives capacity 1 and drops, as the reference does at decode."""
    ref_cfg, cfg = _cfg(e=e, k=k, f=16)
    ref_p, p = _params(ref_cfg, seed=e + k)
    cap, _, _ = _route_both(ref_cfg, ref_p, p, _x(batch, 1, 32))
    assert cap == min(int(np.ceil(batch * k * 1.25 / e)), batch)
    dropped = _check(ref_cfg, cfg, ref_p, p, _x(batch, 1, 32, seed=e))
    if (e, k, batch) == (64, 8, 4):
        assert cap == 1 and dropped > 0


def test_combine_is_chunked_over_tokens(monkeypatch):
    """A combine in several token chunks gives the one-chunk result bit for
    bit (each token's sum over k is its own)."""
    ref_cfg, cfg = _cfg(capacity_factor=0.75)
    _, p = _params(ref_cfg, seed=6)
    x = torch.from_numpy(_x(2, 40, 32, seed=7))
    whole, _ = layers.moe(p, x, cfg)
    monkeypatch.setattr(layers, "COMBINE_TOKENS", 7)
    chunked, _ = layers.moe(p, x, cfg)
    assert torch.equal(whole, chunked)


def test_moe_module_holds_the_reference_layout():
    for act, names in (("swiglu", {"router", "e_gate", "e_up", "e_down"}),
                       ("gelu", {"router", "e_in", "e_down"})):
        ref_cfg, cfg = _cfg(act, shards=2)
        module = layers.MoE(cfg, torch.Generator().manual_seed(0), "cpu")
        ref = ref_layers.init_moe(jax.random.PRNGKey(0), ref_cfg)
        got = dict(module.named_parameters())
        assert set(got) == set(ref) == names
        for n in names:
            assert tuple(got[n].shape) == ref[n].shape and got[n].dtype == torch.float32
        np.testing.assert_allclose(float(got["e_down"].std()), float(jnp.std(ref["e_down"])),
                                   rtol=0.1)
        y, aux = module(torch.from_numpy(_x(1, 8, 32)))
        assert y.shape == (1, 8, 32) and aux.shape == ()


def test_a_mesh_raises():
    ref_cfg, cfg = _cfg()
    _, p = _params(ref_cfg)
    with pytest.raises(NotImplementedError, match="mesh"):
        layers.moe(p, torch.zeros(1, 2, 32), cfg, mesh=object())
