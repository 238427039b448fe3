"""The port's KV-cache decode on a device mesh against the reference's.

The reference's ``jax.jit(model.decode_step)`` runs in a subprocess on 8
XLA CPU devices, a (2, 4) ("data", "model") mesh, with the in / out
shardings that ``cells.input_specs`` / ``lower_cell`` give it (param,
token and cache specs through ``sanitize_pspecs``). The port's
``decode_step`` runs on 8 gloo ranks (``torch.multiprocessing`` with a
``file://`` store) on the same mesh, its params laid out in place by
``sharding.distribute_model`` and its cache by ``init_cache`` inside
``use_rules``. Both start from the reference's ``init`` (carried across by
``convert.lm_params_from_jax``), in f32, feed 8 prompt tokens and take
``GEN`` greedy steps. The layouts:

(a) reduced granite-8b under ``default_rules(cfg, decode=True)``, batch 4:
    the batch over "data", the cache's sequence over "model";
(b) the same under long_500k's rules (``batch=None``, ``cache_seq=("data",
    "model")``), batch 1: the sequence over all 8 ranks;
(c) reduced qwen3-moe-30b-a3b under its default decode rules, which give
    "tp" (4 experts do not divide 16);
(d) the same with ``moe_mode="ep"``, ``p_expert="model"`` and
    ``p_moe_ff=None`` (an expert axis and an FFN axis on "model" at once
    is no layout: the reference's ``PartitionSpec`` refuses it too);
(e) (a) with a ``max_len`` of 15, which "model" does not divide: the cache
    is not split over its sequence;
(f) reduced qwen3-moe-30b-a3b under long_500k's rules ("tp"), batch 1: the
    MoE branch on a replicated batch.

At every step the logits match the reference's within ``LOGIT_TOL`` of
that step's largest logit (``test_torch_train.py``'s ``METRIC_RTOL``), the
greedy tokens are the same and the final cache, gathered, matches the
reference's final cache within the same bound. The same serve runs off
the mesh in the port and in the reference: those match each other, and
for the dense layouts the mesh changes nothing (the MoE layouts route
each shard at its own capacity, the reference's rule, so their tokens
may differ off the mesh). ``Model.prefill`` on the mesh under (a)'s rules
matches the reference's prefill there. The groups are joined with a
deadline and killed past it.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from test_torch_mesh_train import MESH, MeshShape, _join, _quiet
from test_torch_train import METRIC_RTOL

pytestmark = pytest.mark.subprocess_mesh

torch.set_num_threads(1)

LOGIT_TOL = METRIC_RTOL
PROMPT, GEN = 8, 8
PREFILL_B, PREFILL_T = 4, 16
# name -> (arch, batch, generated tokens)
LAYOUTS = {"a": ("granite-8b", 4, GEN), "b": ("granite-8b", 1, GEN),
           "c": ("qwen3-moe-30b-a3b", 4, GEN), "d": ("qwen3-moe-30b-a3b", 4, GEN),
           "e": ("granite-8b", 4, GEN - 1), "f": ("qwen3-moe-30b-a3b", 1, GEN)}
ARCHS = ("granite-8b", "qwen3-moe-30b-a3b")
DEADLINE = 240.0


def _rules(shd, cfg, layout: str):
    rules = shd.default_rules(cfg, decode=True)
    if layout in ("b", "f"):
        return dataclasses.replace(rules, batch=None, cache_seq=("data", "model"))
    if layout == "d":
        return dataclasses.replace(rules, moe_mode="ep", p_expert="model", p_moe_ff=None)
    return rules


def _prompts(vocab: int, batch: int) -> np.ndarray:
    return np.random.default_rng(1).integers(0, vocab, (batch, PROMPT)).astype(np.int32)


def _prefill_tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(2).integers(0, vocab, (PREFILL_B, PREFILL_T)).astype(np.int32)


REF_SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_mesh
    from repro.models import make_model
    sys.path.insert(0, sys.argv[3])
    from test_torch_mesh_serve import (ARCHS, LAYOUTS, MESH, PROMPT, _prefill_tokens,
                                       _prompts, _rules)

    inits = pickle.load(open(sys.argv[1], "rb"))
    mesh = make_mesh(*MESH)

    def serve(dec, params, prompts, cache, gen):
        logits, toks = [], []
        for i in range(PROMPT):
            lg, cache = dec(params, jnp.asarray(prompts[:, i:i + 1]), cache)
            logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, axis=-1)[:, None].astype(jnp.int32)
        for _ in range(gen):
            toks.append(np.asarray(tok)[:, 0])
            lg, cache = dec(params, tok, cache)
            logits.append(np.asarray(lg))
            tok = jnp.argmax(lg, axis=-1)[:, None].astype(jnp.int32)
        kv = [np.asarray(c["kv"][w][r], np.float32) for c in cache["layers"]
              for r in range(cache["layers"][0]["kv"]["k"].shape[0]) for w in ("k", "v")]
        return {"logits": np.stack(logits), "tokens": np.stack(toks, 1), "cache": kv}

    out = {}
    for name, (arch, batch, gen) in LAYOUTS.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        model = make_model(cfg)
        params = jax.tree_util.tree_map(jnp.asarray, inits[arch])
        prompts = _prompts(cfg.vocab_size, batch)
        rules = _rules(shd, cfg, name)
        cache = model.init_cache(batch, PROMPT + gen)
        rec = {"plain": serve(jax.jit(model.decode_step), params, prompts, cache, gen)}
        with mesh, shd.use_rules(rules, mesh):
            def to_sh(shapes, specs):
                specs = shd.sanitize_pspecs(shapes, specs, mesh)
                return jax.tree_util.tree_map(lambda sp: NamedSharding(mesh, sp), specs,
                                              is_leaf=lambda x: isinstance(x, P))
            p_sh = to_sh(params, shd.param_pspecs(params, rules))
            c_sh = to_sh(cache, shd.cache_pspecs(cache, rules))
            tok = jax.ShapeDtypeStruct((batch, 1), jnp.int32)
            t_sh = to_sh(tok, shd.activation_spec("batch", None, rules=rules))
            dec = jax.jit(model.decode_step, in_shardings=(p_sh, t_sh, c_sh),
                          out_shardings=(None, c_sh))
            rec["mesh"] = serve(dec, jax.device_put(params, p_sh), prompts,
                                jax.device_put(cache, c_sh), gen)
            if name == "a":
                toks = jnp.asarray(_prefill_tokens(cfg.vocab_size))
                x_sh = to_sh(toks, shd.activation_spec("batch", None, rules=rules))
                pre = jax.jit(model.prefill, in_shardings=(p_sh, x_sh))
                rec["prefill"] = np.asarray(pre(jax.device_put(params, p_sh), toks))
        out[name] = rec
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _serve(model, prompts: np.ndarray, gen: int) -> dict:
    """8 prompt steps and ``gen`` greedy steps through ``decode_step`` (on
    the mesh when called inside ``use_rules`` with one): every step's
    logits, the tokens and the final cache, gathered, as numpy."""
    from repro_torch.launch.serve import _whole

    prompts = torch.from_numpy(prompts)
    cache = model.init_cache(prompts.shape[0], PROMPT + gen)
    logits, toks = [], []
    for i in range(PROMPT):
        lg, cache = model.decode_step(prompts[:, i:i + 1], cache)
        logits.append(_whole(lg))
    tok = torch.argmax(logits[-1], dim=-1)[:, None]
    for _ in range(gen):
        toks.append(tok[:, 0])
        lg, cache = model.decode_step(tok, cache)
        logits.append(_whole(lg))
        tok = torch.argmax(logits[-1], dim=-1)[:, None]
    kv = [_whole(layer["kv"][w]).numpy() for layer in cache["layers"] for w in ("k", "v")]
    placements = tuple(getattr(cache["layers"][0]["kv"]["k"], "placements", ()))
    return {"logits": torch.stack(logits).numpy(), "tokens": torch.stack(toks, 1).numpy(),
            "cache": kv, "placements": placements, "pos": cache["pos"]}


def _rank(rank: int, world: int, store: str, workdir: str) -> None:
    """One gloo rank: every layout's serve on the (2, 4) mesh, and (a)'s
    prefill; rank 0 writes the results to ``port.pkl``."""
    torch.set_num_threads(1)
    _quiet()
    from repro_torch import convert
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import TIMEOUT, make_mesh

    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    try:
        inits = pickle.load(open(os.path.join(workdir, "init.pkl"), "rb"))
        mesh = make_mesh(*MESH, device="cpu")
        out = {}
        for name, (arch, batch, gen) in LAYOUTS.items():
            cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
            rules = _rules(shd, cfg, name)
            model = convert.lm_params_from_jax(inits[arch], cfg, device="cpu")
            with shd.use_rules(rules, mesh):
                shd.distribute_model(model, mesh, rules)
                out[name] = _serve(model, _prompts(cfg.vocab_size, batch), gen)
                if name == "a":
                    toks = torch.from_numpy(_prefill_tokens(cfg.vocab_size))
                    out[name]["prefill"] = model.prefill(toks).full_tensor().numpy()
        if rank == 0:
            with open(os.path.join(workdir, "port.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _plain_serves(inits) -> dict:
    """The port's serve of every layout off the mesh (run while the ranks
    run)."""
    from repro_torch import convert
    from repro_torch.configs.base import get_config

    out = {}
    for name, (arch, batch, gen) in LAYOUTS.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        model = convert.lm_params_from_jax(inits[arch], cfg, device="cpu")
        out[name] = _serve(model, _prompts(cfg.vocab_size, batch), gen)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, port results on the mesh, port results off it)."""
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.models import make_model as ref_make_model

    work = tmp_path_factory.mktemp("mesh_serve")
    inits = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(ref_get_config(arch).reduced(), dtype="float32")
        params = ref_make_model(cfg).init(jax.random.PRNGKey(0))
        inits[arch] = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
    with open(work / "init.pkl", "wb") as f:
        pickle.dump(inits, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    with open(work / "ref.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(work / "init.pkl"),
                                 str(work / "ref.pkl"), tests_dir],
                                stdout=log, stderr=subprocess.STDOUT, env=env)
        ctx = mp.spawn(_rank, args=(8, f"file://{work}/store", str(work)), nprocs=8,
                       join=False)
        try:
            plain = _plain_serves(inits)
        finally:
            _join(ctx, proc, time.time() + DEADLINE)
    assert proc.returncode == 0, (work / "ref.log").read_text()[-3000:]
    with open(work / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(work / "port.pkl", "rb") as f:
        port = pickle.load(f)
    return ref, port, plain


def _assert_logits(got: np.ndarray, want: np.ndarray, what: str):
    assert got.shape == want.shape, (got.shape, want.shape)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.isfinite(g).all(), (what, i)
        np.testing.assert_allclose(g, w, rtol=0, atol=LOGIT_TOL * np.abs(w).max(),
                                   err_msg=f"{what}: step {i}")


def _assert_cache(got: list, want: list, what: str):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=LOGIT_TOL * np.abs(w).max(),
                                   err_msg=f"{what}: leaf {i}")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mesh_decode_matches_reference(runs, layout):
    ref, port, _ = runs
    got, want = port[layout], ref[layout]["mesh"]
    _assert_logits(got["logits"], want["logits"], f"{layout} on the mesh")
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["pos"] == PROMPT + LAYOUTS[layout][2]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mesh_cache_matches_reference(runs, layout):
    """The final cache, every layer's K and V gathered, is the
    reference's, and every position of it was written."""
    ref, port, _ = runs
    got = port[layout]["cache"]
    _assert_cache(got, ref[layout]["mesh"]["cache"], f"{layout} cache")
    assert all((np.abs(c).max(axis=(0, 2, 3)) > 0).all() for c in got)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_decode_matches_reference(runs, layout):
    """The same serve off the mesh, the port's against the reference's; for
    the dense layouts it is also the mesh's."""
    ref, port, plain = runs
    got, want = plain[layout], ref[layout]["plain"]
    _assert_logits(got["logits"], want["logits"], f"{layout} off the mesh")
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    _assert_cache(got["cache"], want["cache"], f"{layout} cache off the mesh")
    if LAYOUTS[layout][0] == "granite-8b":
        _assert_logits(port[layout]["logits"], got["logits"], f"{layout} mesh against plain")
        np.testing.assert_array_equal(port[layout]["tokens"], got["tokens"])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cache_keeps_the_reference_layout(runs, layout):
    """``init_cache`` inside ``use_rules`` lays each leaf out by
    ``sanitize_pspecs(cache_pspecs(...))``, and the decode keeps it: the
    sequence over "model" in (a) / (c) / (d), over both axes in (b) / (f), and
    not split at all where "model" does not divide ``max_len`` (e)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as shd

    _, port, _ = runs
    arch, batch, gen = LAYOUTS[layout]
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    leaf = torch.empty(batch, PROMPT + gen, cfg.num_kv_heads, cfg.head_dim, device="meta")
    spec = shd.sanitize_pspecs({"k": leaf}, shd.cache_pspecs({"k": leaf}, _rules(shd, cfg, layout)),
                               MeshShape)["k"]
    assert port[layout]["placements"] == shd.placements(spec, MeshShape)
    want = {"a": (Shard(0), Shard(1)), "b": (Shard(1), Shard(1)), "c": (Shard(0), Shard(1)),
            "d": (Shard(0), Shard(1)), "e": (Shard(0), Replicate()),
            "f": (Shard(1), Shard(1))}[layout]
    assert port[layout]["placements"] == want


def test_undivided_cache_gives_the_same_result(runs):
    """(e) is (a) with a cache whose sequence is whole on every rank: its
    steps give (a)'s logits and tokens."""
    _, port, _ = runs
    n = PROMPT + LAYOUTS["e"][2]
    _assert_logits(port["e"]["logits"], port["a"]["logits"][:n], "e against a")
    np.testing.assert_array_equal(port["e"]["tokens"], port["a"]["tokens"][:, :LAYOUTS["e"][2]])


def test_prefill_on_mesh_matches_reference(runs):
    ref, port, _ = runs
    got, want = port["a"]["prefill"], ref["a"]["prefill"]
    assert got.shape == want.shape == (PREFILL_B, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())


def test_sequence_parallel_prefill_raises(tmp_path):
    """Sequence-parallel prefill attention (``rules.seq`` set; no
    reference path sets it) is not ported: it raises on a mesh, and the
    same prefill runs without ``seq`` (a world of one gloo rank)."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import TIMEOUT, make_mesh
    from repro_torch.models import make_model

    _quiet()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, timeout=TIMEOUT)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        cfg = dataclasses.replace(get_config("granite-8b").reduced(), dtype="float32")
        model = make_model(cfg, device="cpu")
        toks = torch.from_numpy(_prefill_tokens(cfg.vocab_size))
        rules = shd.default_rules(cfg)
        with shd.use_rules(rules, mesh):
            shd.distribute_model(model, mesh, rules)
            logits = model.prefill(toks).full_tensor()
        seq_rules = dataclasses.replace(rules, batch=None, seq="data")
        with shd.use_rules(seq_rules, mesh):
            with pytest.raises(NotImplementedError, match="sequence-parallel"):
                model.prefill(toks)
        assert logits.shape == (PREFILL_B, cfg.vocab_size) and torch.isfinite(logits).all()
    finally:
        dist.destroy_process_group()
