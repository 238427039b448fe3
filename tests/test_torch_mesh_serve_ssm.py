"""The SSM and hybrid families' serving on a device mesh against the
reference's.

As ``tests/test_torch_mesh_serve.py``: the reference's ``jax.jit(model.
decode_step)`` runs in a subprocess on 8 XLA CPU devices, a (2, 4)
("data", "model") mesh, with the param, token and cache shardings that
``cells.input_specs`` / ``lower_cell`` give it (through
``sanitize_pspecs``); the port's ``decode_step`` on 8 gloo ranks on the
same mesh, its params laid out in place by ``sharding.distribute_model``
and its cache by ``init_cache`` inside ``use_rules``. Both start from the
reference's ``init`` (``convert.lm_params_from_jax``), in f32, feed 8
prompt tokens and take 8 greedy steps. The layouts:

(a) reduced mamba2-130m under ``default_rules(cfg, decode=True)``, batch
    4: the batch over "data", the SSM state's heads and the conv
    history's channels over "model" (``p_ssm_inner``);
(b) the same under long_500k's rules (``batch=None``, ``cache_seq=("data",
    "model")``), batch 1;
(c) reduced jamba-v0.1-52b (7 SSM layers, 1 attention layer, MoE every
    other layer, "tp") under its decode rules, batch 4: the attention
    layer's KV cache over its sequence;
(d) jamba under long_500k's rules, batch 1;
(e) jamba under its decode rules with ``moe_mode="ep"``,
    ``p_expert="model"`` and ``p_moe_ff=None`` (what full-size jamba's 16
    experts get), batch 4: the MoE's all_to_all at one token beside the
    SSM state and the sequence-sharded KV cache;
(f) reduced mamba2-130m at d_model 96, 6 heads, under its decode rules,
    batch 4: the 4-way "model" axis does not divide the heads, so
    ``sanitize_pspecs`` moves it to the state's N (as a 16-way axis does
    to full-size mamba2's 24 heads).

At every step the logits match the reference's mesh decode within
``LOGIT_TOL`` of that step's largest logit and the greedy tokens are the
same; the final cache (``conv`` and ``h`` of every SSM layer, ``k`` and
``v`` of jamba's attention layer), gathered, matches the reference's final
cache; every leaf keeps the placements of ``sanitize_pspecs(cache_pspecs(
...))``. The same serve runs off the mesh in both packages and matches;
for mamba2 the mesh changes nothing. jamba's MoE layers route each shard
at its own capacity (the reference's rule), so its mesh decode differs
from its decode off the mesh in both packages: it is held to the
reference's mesh decode only. ``Model.prefill`` of mamba2 at B 4, T 300
(past one 256-token SSD chunk) on the mesh under (a)'s rules matches the
reference's jitted prefill there. The groups are joined with a deadline
and killed past it.
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
from test_torch_mesh_serve import LOGIT_TOL, PROMPT, _assert_cache, _assert_logits, _prompts
from test_torch_mesh_train import MESH, MeshShape, _join, _quiet

pytestmark = pytest.mark.subprocess_mesh

torch.set_num_threads(1)

GEN = 8
PREFILL_B, PREFILL_T = 4, 300
# model -> (arch, changes to its reduced config)
MODELS = {"mamba2": ("mamba2-130m", {}), "mamba2_6h": ("mamba2-130m", {"d_model": 96}),
          "jamba": ("jamba-v0.1-52b", {})}
# layout -> (model, batch, rules)
LAYOUTS = {"a": ("mamba2", 4, "decode"), "b": ("mamba2", 1, "long"),
           "c": ("jamba", 4, "decode"), "d": ("jamba", 1, "long"), "e": ("jamba", 4, "ep"),
           "f": ("mamba2_6h", 4, "decode")}
DEADLINE = 300.0


def _cfg(get_config, model: str):
    arch, changes = MODELS[model]
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32", **changes)


def _rules(shd, cfg, layout: str):
    rules = shd.default_rules(cfg, decode=True)
    mode = LAYOUTS[layout][2]
    if mode == "long":
        return dataclasses.replace(rules, batch=None, cache_seq=("data", "model"))
    if mode == "ep":
        return dataclasses.replace(rules, moe_mode="ep", p_expert="model", p_moe_ff=None)
    return rules


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
    from repro.models.transformer import block_period
    sys.path.insert(0, sys.argv[3])
    from test_torch_mesh_serve_ssm import (GEN, LAYOUTS, MESH, PROMPT, _cfg, _prefill_tokens,
                                           _prompts, _rules)

    inits = pickle.load(open(sys.argv[1], "rb"))
    mesh = make_mesh(*MESH)

    def serve(dec, params, prompts, cache, period):
        logits, toks = [], []
        for i in range(PROMPT):
            lg, cache = dec(params, jnp.asarray(prompts[:, i:i + 1]), cache)
            logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, axis=-1)[:, None].astype(jnp.int32)
        for _ in range(GEN):
            toks.append(np.asarray(tok)[:, 0])
            lg, cache = dec(params, tok, cache)
            logits.append(np.asarray(lg))
            tok = jnp.argmax(lg, axis=-1)[:, None].astype(jnp.int32)
        # layer i is period-position i % period at repetition i // period
        layers = cache["layers"]
        n = period * jax.tree_util.tree_leaves(layers[0])[0].shape[0]
        leaves = {}
        for i in range(n):
            for kind, entry in layers[i % period].items():
                for leaf, v in entry.items():
                    leaves[f"{i}.{kind}.{leaf}"] = np.asarray(v[i // period], np.float32)
        return {"logits": np.stack(logits), "tokens": np.stack(toks, 1), "cache": leaves}

    out = {}
    for name, (model_name, batch, _) in LAYOUTS.items():
        cfg = _cfg(get_config, model_name)
        model = make_model(cfg)
        period = block_period(cfg)
        params = jax.tree_util.tree_map(jnp.asarray, inits[model_name])
        prompts = _prompts(cfg.vocab_size, batch)
        rules = _rules(shd, cfg, name)
        cache = model.init_cache(batch, PROMPT + GEN)
        rec = {"plain": serve(jax.jit(model.decode_step), params, prompts, cache, period)}
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
                                jax.device_put(cache, c_sh), period)
            if name == "a":
                toks = jnp.asarray(_prefill_tokens(cfg.vocab_size))
                x_sh = to_sh(toks, shd.activation_spec("batch", None, rules=rules))
                pre = jax.jit(model.prefill, in_shardings=(p_sh, x_sh))
                rec["prefill"] = np.asarray(pre(jax.device_put(params, p_sh), toks))
        out[name] = rec
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _serve(model, prompts: np.ndarray) -> dict:
    """8 prompt steps and ``GEN`` greedy steps through ``decode_step`` (on
    the mesh when called inside ``use_rules`` with one): every step's
    logits, the tokens, the final cache leaves gathered and their
    placements, as numpy."""
    from repro_torch.launch.serve import _whole

    prompts = torch.from_numpy(prompts)
    cache = model.init_cache(prompts.shape[0], PROMPT + GEN)
    logits, toks = [], []
    for i in range(PROMPT):
        lg, cache = model.decode_step(prompts[:, i:i + 1], cache)
        logits.append(_whole(lg))
    tok = torch.argmax(logits[-1], dim=-1)[:, None]
    for _ in range(GEN):
        toks.append(tok[:, 0])
        lg, cache = model.decode_step(tok, cache)
        logits.append(_whole(lg))
        tok = torch.argmax(logits[-1], dim=-1)[:, None]
    leaves = {f"{i}.{kind}.{leaf}": v for i, layer in enumerate(cache["layers"])
              for kind, entry in layer.items() for leaf, v in entry.items()}
    return {"logits": torch.stack(logits).numpy(), "tokens": torch.stack(toks, 1).numpy(),
            "cache": {k: _whole(v).float().numpy() for k, v in leaves.items()},
            "placements": {k: tuple(getattr(v, "placements", ())) for k, v in leaves.items()},
            "pos": cache["pos"]}


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
        for name, (model_name, batch, _) in LAYOUTS.items():
            cfg = _cfg(get_config, model_name)
            rules = _rules(shd, cfg, name)
            model = convert.lm_params_from_jax(inits[model_name], cfg, device="cpu")
            with shd.use_rules(rules, mesh):
                shd.distribute_model(model, mesh, rules)
                out[name] = _serve(model, _prompts(cfg.vocab_size, batch))
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
    for name, (model_name, batch, _) in LAYOUTS.items():
        cfg = _cfg(get_config, model_name)
        model = convert.lm_params_from_jax(inits[model_name], cfg, device="cpu")
        out[name] = _serve(model, _prompts(cfg.vocab_size, batch))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, port results on the mesh, port results off it)."""
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.models import make_model as ref_make_model

    work = tmp_path_factory.mktemp("mesh_serve_ssm")
    inits = {}
    for model_name in MODELS:
        params = ref_make_model(_cfg(ref_get_config, model_name)).init(jax.random.PRNGKey(0))
        inits[model_name] = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
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


def _cache_list(cache: dict) -> list:
    return [cache[k] for k in sorted(cache)]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mesh_decode_matches_reference(runs, layout):
    ref, port, _ = runs
    got, want = port[layout], ref[layout]["mesh"]
    _assert_logits(got["logits"], want["logits"], f"{layout} on the mesh")
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["pos"] == PROMPT + GEN


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mesh_cache_matches_reference(runs, layout):
    """The final cache, every SSM layer's conv history and state and
    jamba's K and V, gathered, is the reference's; every leaf was
    written."""
    ref, port, _ = runs
    got, want = port[layout]["cache"], ref[layout]["mesh"]["cache"]
    assert set(got) == set(want)
    kinds = {k.split(".", 2)[2] for k in got}
    assert kinds == ({"conv", "h", "k", "v"} if LAYOUTS[layout][0] == "jamba"
                     else {"conv", "h"})
    _assert_cache(_cache_list(got), _cache_list(want), f"{layout} cache")
    assert all(np.abs(v).max() > 0 for v in got.values())


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_decode_matches_reference(runs, layout):
    """The same serve off the mesh, the port's against the reference's; for
    mamba2 it is also the mesh's."""
    ref, port, plain = runs
    got, want = plain[layout], ref[layout]["plain"]
    _assert_logits(got["logits"], want["logits"], f"{layout} off the mesh")
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    _assert_cache(_cache_list(got["cache"]), _cache_list(want["cache"]),
                  f"{layout} cache off the mesh")
    if LAYOUTS[layout][0].startswith("mamba2"):
        _assert_logits(port[layout]["logits"], got["logits"], f"{layout} mesh against plain")
        np.testing.assert_array_equal(port[layout]["tokens"], got["tokens"])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cache_keeps_the_reference_layout(runs, layout):
    """``init_cache`` inside ``use_rules`` lays each leaf out by
    ``sanitize_pspecs(cache_pspecs(...))``, and every step keeps it: the
    conv history's channels and the state's heads over "model", the batch
    over "data" at batch 4; in (f) the state's N over "model" (its 6 heads
    do not divide); jamba's K / V sequence over "model", or over both axes
    at batch 1."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import make_model

    _, port, _ = runs
    model_name, batch, _ = LAYOUTS[layout]
    cfg = _cfg(get_config, model_name)
    cache = make_model(cfg, device="meta").init_cache(batch, PROMPT + GEN)["layers"]
    specs = shd.sanitize_pspecs(cache, shd.cache_pspecs(cache, _rules(shd, cfg, layout)),
                                MeshShape)
    want = {f"{i}.{kind}.{leaf}": shd.placements(spec, MeshShape)
            for i, layer in enumerate(specs) for kind, entry in layer.items()
            for leaf, spec in entry.items()}
    assert port[layout]["placements"] == want
    batched = batch > 1
    assert want["0.ssm.conv"] == ((Shard(0) if batched else Replicate()), Shard(2))
    assert want["0.ssm.h"] == ((Shard(0) if batched else Replicate()),
                               Shard(2) if layout == "f" else Shard(1))
    if model_name == "jamba":
        assert want["7.kv.k"] == ((Shard(0), Shard(1)) if batched else (Shard(1), Shard(1)))


def test_prefill_on_mesh_matches_reference(runs):
    ref, port, _ = runs
    got, want = port["a"]["prefill"], ref["a"]["prefill"]
    assert got.shape == want.shape == (PREFILL_B, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())
