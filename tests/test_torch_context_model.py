"""Port context model vs the JAX reference: transform with carried-over
params (1e-5), training from the reference's init with the same batch
indices (per-step loss to 1e-4 relative: the sums run in another
order), one Adam step vs ``optim.adamw``, the training pairs, and the
shipped fixtures of the reference's init (bit for bit)."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim
from repro.core import context_model as ref_cm
from repro_torch import convert
from repro_torch.core import context_model

torch.set_num_threads(1)


def _stream_features(t=400, m=64, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    motifs = rng.standard_normal((10, 5, m)).astype(np.float32)
    motifs /= np.linalg.norm(motifs, axis=-1, keepdims=True)
    rows = []
    while len(rows) < t:
        noise = rng.standard_normal((5, m)).astype(np.float32) * 0.05
        rows.extend(motifs[rng.integers(0, 10)] + noise)
    return np.stack(rows[:t])


def test_transform_with_converted_params():
    feats = _stream_features(t=200, seed=1)
    cfg = ref_cm.ContextModelConfig(m=64, d=50, steps=60)
    ref = ref_cm.ContextModel(cfg).fit(feats)
    port = convert.context_model_from_params(
        np.asarray(ref.params.w), np.asarray(ref.params.u),
        context_model.ContextModelConfig(m=64, d=50, steps=60), device="cpu")
    got = port.transform(torch.from_numpy(feats[:37])).numpy()
    np.testing.assert_allclose(got, ref.transform(feats[:37]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def test_fit_from_reference_init_tracks_reference_losses():
    feats = _stream_features(t=400)
    cfg = ref_cm.ContextModelConfig(m=64, d=50, steps=50)
    ref = ref_cm.ContextModel(cfg).fit(feats)
    init = ref_cm.init_params(cfg)
    port = context_model.ContextModel(
        context_model.ContextModelConfig(m=64, d=50, steps=50), device="cpu")
    port.fit(torch.from_numpy(feats), init=(np.asarray(init.w), np.asarray(init.u)))
    assert len(port.losses) == len(ref.losses) == 50
    np.testing.assert_allclose(port.losses, ref.losses, rtol=1e-4)
    assert np.mean(port.losses[-10:]) < np.mean(port.losses[:10])


def test_fit_without_init_is_seeded():
    feats = torch.from_numpy(_stream_features(t=120, seed=2))
    cfg = context_model.ContextModelConfig(m=64, d=30, steps=20)
    a = context_model.ContextModel(cfg, device="cpu").fit(feats)
    b = context_model.ContextModel(cfg, device="cpu").fit(feats)
    assert a.losses == b.losses
    assert torch.equal(a.u_pinv, b.u_pinv)


FIXTURE_STEM = re.compile(r"context_init_m(\d+)_d(\d+)_seed(\d+)\.w\.npy")


def test_fixtures_equal_reference_init_bit_for_bit():
    stems = [FIXTURE_STEM.fullmatch(p.name) for p in context_model.FIXTURES.glob("*.w.npy")]
    assert stems and all(stems)
    assert (64, 50, 0) in [tuple(int(x) for x in m.groups()) for m in stems]
    for m in stems:
        cfg = ref_cm.ContextModelConfig(*(int(x) for x in m.groups()))
        want = ref_cm.init_params(cfg)
        got = context_model.reference_init(context_model.ContextModelConfig(
            m=cfg.m, d=cfg.d, seed=cfg.seed))
        for g, w in zip(got, (want.w, want.u)):
            w = np.asarray(w)
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            assert np.array_equal(g.view(np.uint32), w.view(np.uint32))


def test_default_init_is_the_reference_s_where_shipped():
    cfg = context_model.ContextModelConfig(m=64, d=50)
    model = context_model.ContextModel(cfg, device="cpu")
    want = ref_cm.init_params(ref_cm.ContextModelConfig(m=64, d=50))
    assert model.init_source == "reference"
    assert np.array_equal(model.w.detach().numpy(), np.asarray(want.w))
    assert np.array_equal(model.u.detach().numpy(), np.asarray(want.u))
    other = context_model.ContextModel(context_model.ContextModelConfig(m=64, d=30),
                                       device="cpu")
    assert other.init_source == "torch"
    other.set_params(np.zeros((64, 30), np.float32), np.zeros((30, 64), np.float32))
    assert other.init_source == "given"


def test_fit_from_default_init_tracks_reference_losses():
    feats = _stream_features(t=400, seed=5)
    ref = ref_cm.ContextModel(ref_cm.ContextModelConfig(m=64, d=50, steps=40)).fit(feats)
    port = context_model.ContextModel(
        context_model.ContextModelConfig(m=64, d=50, steps=40), device="cpu")
    port.fit(torch.from_numpy(feats))
    assert port.init_source == "reference"
    np.testing.assert_allclose(port.losses, ref.losses, rtol=1e-4)


def test_one_adam_step_matches_reference_adamw():
    rng = np.random.Generator(np.random.PCG64(4))
    p = rng.standard_normal((8, 5)).astype(np.float32)
    g = rng.standard_normal((8, 5)).astype(np.float32)
    tx = optim.adamw(3e-3, weight_decay=0.0)
    params = {"p": jnp.asarray(p)}
    deltas, _ = tx.update({"p": jnp.asarray(g)}, tx.init(params), params)
    want = np.asarray(optim.apply_updates(params, deltas)["p"])
    tp = torch.nn.Parameter(torch.from_numpy(p.copy()))
    opt = torch.optim.Adam([tp], lr=3e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.0)
    tp.grad = torch.from_numpy(g)
    opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), want, rtol=1e-6, atol=1e-7)


def test_make_training_pairs_and_loss_match_reference():
    feats = _stream_features(t=50, seed=3)
    for k in (1, 2, 3):
        ctx, tgt = context_model.make_training_pairs(torch.from_numpy(feats), k)
        rctx, rtgt = ref_cm.make_training_pairs(feats, k)
        np.testing.assert_array_equal(ctx.numpy(), rctx)
        np.testing.assert_array_equal(tgt.numpy(), rtgt)
    cfg = ref_cm.ContextModelConfig(m=64, d=50)
    init = ref_cm.init_params(cfg)
    ctx, tgt = ref_cm.make_training_pairs(feats, 2)
    want = float(ref_cm.loss_fn(init, jnp.asarray(ctx), jnp.asarray(tgt), cfg))
    port = context_model.ContextModel(context_model.ContextModelConfig(m=64, d=50),
                                      device="cpu")
    port.set_params(np.asarray(init.w), np.asarray(init.u))
    got = port.loss_fn(torch.from_numpy(ctx), torch.from_numpy(tgt)).detach().item()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_ingest_before_fit_raises_runtime_error():
    """The port differs from the reference here on purpose. A CARD store
    built by ``build_store`` that ingests before ``fit`` raises
    ``RuntimeError: fit() or load() first`` in the port; the reference
    fails on an ``assert`` (``repro/core/context_model.py:139``), which is
    gone under ``python -O``, so a plain exception is the sounder check.
    Nothing is stored and the store keeps working after a fit."""
    from repro import api as ref_api
    from repro_torch.api import config

    stream = bytes(np.random.default_rng(3).integers(0, 256, 200_000, np.uint8))
    d = {"detector": "card", "chunker_args": {"avg_size": 8192},
         "detector_args": {"model": {"m": 64, "d": 50, "steps": 20}, "use_kernel": False}}
    store = config.build_store(config.DedupConfig.from_dict(d), device="cpu")
    with pytest.raises(RuntimeError, match=re.escape("fit() or load() first")):
        store.ingest(stream)
    assert store.reports == [] and store.backend.chunk_ids() == []
    ref = ref_api.build_store(ref_api.DedupConfig.from_dict(d))
    with pytest.raises(AssertionError, match=re.escape("fit() first")):
        ref.ingest(stream)
    store.fit([stream])
    handle = store.open_stream()
    handle.write(stream)
    assert store.restore(handle.commit().handle) == stream
