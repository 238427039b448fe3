"""Attention where the "model" axis does not divide the heads, on a device
mesh, against the reference's GSPMD (ROADMAP Queue 3, faults F1 and F2).

GSPMD pads an interior shard that does not divide its dim
(``repro/distributed/sharding.py:280-281``); DTensor keeps such shards
uneven and cannot flatten or unflatten them. So the port raised where the
reference ran:

- F1: q heads that "model" does not divide. ``project(out, wo, 2)``
  flattened heads left uneven by ``constrain(out, "batch", "seq",
  "heads", None)`` ("Cannot flatten unevenly sharded tensor").
- F2: kv heads that "model" does not divide, under FSDP. The product of
  ``project(src, wk, 1)`` came out split over "model" on its [KV * hd]
  columns, and its view (or its gradient's, back to ``wk``'s [d, KV, hd])
  raised ("Cannot unflatten unevenly sharded tensor").

``sharding.reshape`` now keeps such a dim whole before the reshape, in the
forward and in the backward. The layouts, each reduced and in f32 on 8
gloo ranks, a (2, 4) ("data", "model") mesh, against the reference's run
on 8 XLA devices (its jit with the shardings ``cells.lower_cell`` gives):

- ``f1_granite_prefill`` / ``_step`` / ``_serve``: granite-8b with 2 q and
  2 kv heads under ``default_rules(cfg)`` (prefill and a train step) and
  ``default_rules(cfg, decode=True)`` (a serve);
- ``f1_whisper_prefill``: whisper-base with 2 / 2 heads (its encoder, its
  decoder's self and cross sublayers), frames drawn at random;
- ``f2_granite_step``: granite-8b with 8 q and 2 kv heads under
  ``default_rules(cfg, fsdp=True)``;
- ``granite_8_2_step``: the same under ``default_rules(cfg)`` (no FSDP);
- ``f3_mamba2_step``: mamba2-130m at d_model 96, 6 SSM heads, under
  ``default_rules(cfg)`` (fault F3, found by the dry run of full-size
  mamba2's train_4k, 24 heads on a 16-way axis: the gradient of the
  mixer's [B, T, H * P] -> [B, T, H, P] reshape came back split over
  "model" on H * P and could not be unflattened);
- ``moe_ep_laid_step``: reduced qwen3-moe-30b-a3b's train step under
  train_4k's rules with its experts over "model" ("ep"), the batch handed
  over as DTensors, as ``cells.lower_cell`` hands it.

``test_reshape_gathers_only_what_it_must`` holds the rule by which
``sharding.reshape`` gathers a dim (``_dims_to_gather``) on shapes alone.

This module also holds the harness that ``test_torch_mesh_cross.py`` and
``test_torch_mesh_serve_cross.py`` run their own jobs through: ``JOBS``
maps a name to (arch, changes to its reduced config, rules, kind, batch);
the kinds are one train step (``MICRO`` microbatches, ``ADAMW``; a
``laid_step`` hands its batch over laid out on the mesh),
``prefill`` (the last logits) and ``serve`` (``PROMPT`` prompt steps and
``GEN`` greedy steps through ``decode_step``, every step's logits, the
final cache and its placements). Each job starts from the reference's
``init`` carried across by ``convert.lm_params_from_jax``; extras are
drawn at random (``memory`` for a whisper serve, as
``cells._extras_shapes`` gives a decode cell). The ranks and the
reference's subprocess run at once and are killed past ``DEADLINE``.
"""
import dataclasses
import importlib
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
from test_torch_mesh_serve import LOGIT_TOL, _assert_cache, _assert_logits
from test_torch_mesh_train import (ADAMW, MESH, METRIC_RTOL, TOL, MeshShape, _assert_leaves,
                                   _join, _quiet)

pytestmark = pytest.mark.subprocess_mesh

torch.set_num_threads(1)

B, T, MICRO = 4, 32, 2
PROMPT, GEN = 8, 8
DEADLINE = 300.0
# name -> (arch, changes to its reduced config, rules, kind, batch)
JOBS = {
    "f1_granite_prefill": ("granite-8b", {"num_heads": 2, "num_kv_heads": 2}, "plain",
                           "prefill", B),
    "f1_granite_step": ("granite-8b", {"num_heads": 2, "num_kv_heads": 2}, "plain", "step", B),
    "f1_granite_serve": ("granite-8b", {"num_heads": 2, "num_kv_heads": 2}, "decode", "serve",
                         B),
    "f1_whisper_prefill": ("whisper-base", {"num_heads": 2, "num_kv_heads": 2}, "plain",
                           "prefill", B),
    "f2_granite_step": ("granite-8b", {"num_heads": 8, "num_kv_heads": 2}, "fsdp", "step", B),
    "granite_8_2_step": ("granite-8b", {"num_heads": 8, "num_kv_heads": 2}, "plain", "step",
                         B),
    "f3_mamba2_step": ("mamba2-130m", {"d_model": 96}, "plain", "step", B),
    "moe_ep_laid_step": ("qwen3-moe-30b-a3b", {}, "ep", "laid_step", B),
}


def job_cfg(get_config, job):
    arch, changes = job[0], job[1]
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32", **changes)


def job_rules(shd, cfg, mode: str):
    """The rules of the cell kind a job stands for: ``plain`` prefill_32k's
    (no FSDP below grok-1's size), ``fsdp`` train_4k's, ``ep`` train_4k's
    with the experts split over "model" (full-size qwen3-moe's layout),
    ``decode`` decode_32k's, ``long`` long_500k's."""
    if mode == "fsdp":
        return shd.default_rules(cfg, fsdp=True)
    if mode == "ep":
        return dataclasses.replace(shd.default_rules(cfg, fsdp=True), moe_mode="ep",
                                   p_expert="model", p_moe_ff=None)
    if mode == "plain":
        return shd.default_rules(cfg)
    rules = shd.default_rules(cfg, decode=True)
    if mode == "long":
        return dataclasses.replace(rules, batch=None, cache_seq=("data", "model"))
    return rules


def job_inputs(cfg, job) -> dict:
    """The job's seeded numpy inputs: ``tokens`` (and ``labels`` for a
    step), or ``prompts`` for a serve, and the family's extras drawn at
    random."""
    kind, batch = job[3], job[4]
    rng = np.random.default_rng(7)
    if kind == "serve":
        out = {"prompts": rng.integers(0, cfg.vocab_size, (batch, PROMPT)).astype(np.int32)}
    else:
        toks = rng.integers(0, cfg.vocab_size, (batch, T + 1)).astype(np.int32)
        out = {"tokens": toks[:, :-1]}
        if kind in ("step", "laid_step"):
            out["labels"] = toks[:, 1:]
    if cfg.family == "vlm":
        out["images"] = rng.normal(size=(batch, cfg.num_image_tokens, cfg.d_model))
    if cfg.family == "audio":
        name = "memory" if kind == "serve" else "frames"
        out[name] = rng.normal(size=(batch, cfg.num_audio_frames, cfg.d_model))
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in out.items()}


def _extras(inputs: dict) -> dict:
    return {k: v for k, v in inputs.items() if k in ("images", "frames", "memory")}


REF_SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import importlib
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import optim
    from repro.configs import get_config
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_mesh
    from repro.models import make_model
    from repro.models.transformer import block_period
    from repro.train import make_train_step
    from repro.train.step import init_state
    sys.path.insert(0, sys.argv[3])
    from test_torch_mesh_uneven import (ADAMW, GEN, MESH, MICRO, PROMPT, _extras, job_cfg,
                                        job_inputs, job_rules)
    JOBS = importlib.import_module(sys.argv[4]).JOBS

    inits = pickle.load(open(sys.argv[1], "rb"))
    mesh = make_mesh(*MESH)
    leaves = lambda t: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), t)

    def serve(dec, params, prompts, cache, extras, period):
        logits, toks = [], []
        for i in range(PROMPT):
            lg, cache = dec(params, jnp.asarray(prompts[:, i:i + 1]), cache, extras)
            logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, axis=-1)[:, None].astype(jnp.int32)
        for _ in range(GEN):
            toks.append(np.asarray(tok)[:, 0])
            lg, cache = dec(params, tok, cache, extras)
            logits.append(np.asarray(lg))
            tok = jnp.argmax(lg, axis=-1)[:, None].astype(jnp.int32)
        layers = cache["layers"]
        n = period * jax.tree_util.tree_leaves(layers[0])[0].shape[0]
        kv = {}
        for i in range(n):
            for kind, entry in layers[i % period].items():
                for leaf, v in entry.items():
                    kv[f"{i}.{kind}.{leaf}"] = np.asarray(v[i // period], np.float32)
        return {"logits": np.stack(logits), "tokens": np.stack(toks, 1), "cache": kv}

    out = {}
    for name, job in JOBS.items():
        cfg = job_cfg(get_config, job)
        model = make_model(cfg)
        params = jax.tree_util.tree_map(jnp.asarray, inits[name])
        inputs = {k: jnp.asarray(v) for k, v in job_inputs(cfg, job).items()}
        extras = _extras(inputs)
        rules = job_rules(shd, cfg, job[2])
        kind, batch = job[3], job[4]
        rec = {}
        with mesh, shd.use_rules(rules, mesh):
            def to_sh(shapes, specs):
                specs = shd.sanitize_pspecs(shapes, specs, mesh)
                return jax.tree_util.tree_map(lambda sp: NamedSharding(mesh, sp), specs,
                                              is_leaf=lambda x: isinstance(x, P))
            e_sh = to_sh(extras, {k: shd.activation_spec("batch", None, None, rules=rules)
                                  for k in extras})
            if kind in ("step", "laid_step"):
                tx = optim.adamw(**ADAMW)
                step = jax.jit(make_train_step(model, tx, num_microbatches=MICRO))
                state, m = step(init_state(params, tx), inputs)
                rec = {"metrics": {k: float(v) for k, v in m.items()},
                       "params": leaves(state.params), "mu": leaves(state.opt_state.mu)}
            else:
                p_sh = to_sh(params, shd.param_pspecs(params, rules))
                dparams = jax.device_put(params, p_sh)
                dextras = jax.device_put(extras, e_sh)
                if kind == "prefill":
                    toks = inputs["tokens"]
                    x_sh = to_sh(toks, shd.activation_spec("batch", None, rules=rules))
                    pre = jax.jit(lambda p, t, e: model.prefill(p, t, e or None),
                                  in_shardings=(p_sh, x_sh, e_sh))
                    rec["prefill"] = np.asarray(pre(dparams, toks, dextras))
                else:
                    cache = model.init_cache(batch, PROMPT + GEN)
                    c_sh = to_sh(cache, shd.cache_pspecs(cache, rules))
                    tok = jax.ShapeDtypeStruct((batch, 1), jnp.int32)
                    t_sh = to_sh(tok, shd.activation_spec("batch", None, rules=rules))
                    dec = jax.jit(lambda p, t, c, e: model.decode_step(p, t, c, e or None),
                                  in_shardings=(p_sh, t_sh, c_sh, e_sh),
                                  out_shardings=(None, c_sh))
                    rec["mesh"] = serve(dec, dparams, np.asarray(inputs["prompts"]),
                                        jax.device_put(cache, c_sh), dextras,
                                        block_period(cfg))
        if kind == "serve":
            plain = jax.jit(lambda p, t, c, e: model.decode_step(p, t, c, e or None))
            rec["plain"] = serve(plain, params, np.asarray(inputs["prompts"]),
                                 model.init_cache(batch, PROMPT + GEN), extras,
                                 block_period(cfg))
        out[name] = rec
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _serve(model, inputs: dict) -> dict:
    """``PROMPT`` prompt steps and ``GEN`` greedy steps through
    ``decode_step`` with the job's extras (on the mesh when called inside
    ``use_rules`` with one): every step's logits, the tokens, the final
    cache leaves gathered and their placements, as numpy."""
    from repro_torch.launch.serve import _whole

    prompts, extras = torch.from_numpy(inputs["prompts"]), _extras(inputs)
    cache = model.init_cache(prompts.shape[0], PROMPT + GEN)
    logits, toks = [], []
    for i in range(PROMPT):
        lg, cache = model.decode_step(prompts[:, i:i + 1], cache, extras)
        logits.append(_whole(lg))
    tok = torch.argmax(logits[-1], dim=-1)[:, None]
    for _ in range(GEN):
        toks.append(tok[:, 0])
        lg, cache = model.decode_step(tok, cache, extras)
        logits.append(_whole(lg))
        tok = torch.argmax(logits[-1], dim=-1)[:, None]
    leaves = {f"{i}.{kind}.{leaf}": v for i, layer in enumerate(cache["layers"])
              for kind, entry in layer.items() for leaf, v in entry.items()}
    return {"logits": torch.stack(logits).numpy(), "tokens": torch.stack(toks, 1).numpy(),
            "cache": {k: _whole(v).float().numpy() for k, v in leaves.items()},
            "placements": {k: tuple(getattr(v, "placements", ())) for k, v in leaves.items()},
            "pos": cache["pos"]}


def run_job(job, init, mesh=None) -> dict:
    """One job in the port: on ``mesh`` (inside ``use_rules``, params laid
    out by ``distribute_params`` / ``distribute_model``) or, without a
    mesh, off it."""
    import contextlib

    from repro_torch import convert, optim
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.train import step

    cfg = job_cfg(get_config, job)
    rules = job_rules(shd, cfg, job[2])
    model = convert.lm_params_from_jax(init, cfg, device="cpu")
    inputs = job_inputs(cfg, job)
    scope = shd.use_rules(rules, mesh) if mesh is not None else contextlib.nullcontext()
    whole = lambda t: t.full_tensor() if isinstance(t, shd.DTensor) else t
    with scope:
        if job[3] in ("step", "laid_step"):
            tx = optim.adamw(**ADAMW)
            params = step.model_params(model)
            if mesh is not None:
                params = shd.distribute_params(params, mesh, rules)
                if job[3] == "laid_step":
                    inputs = {k: shd.as_global(torch.from_numpy(v), "batch",
                                               *([None] * (v.ndim - 1)))
                              for k, v in inputs.items()}
            state, m = step.make_train_step(model, tx, num_microbatches=MICRO)(
                step.init_state(params, tx), inputs)
            return {"metrics": {k: float(v) for k, v in m.items()},
                    "params": {k: whole(v).numpy() for k, v in state.params.items()},
                    "mu": {k: whole(v).numpy() for k, v in state.opt_state.mu.items()}}
        if mesh is not None:
            shd.distribute_model(model, mesh, rules)
        if job[3] == "prefill":
            logits = model.prefill(torch.from_numpy(inputs["tokens"]), _extras(inputs))
            return {"prefill": whole(logits).numpy()}
        return _serve(model, inputs)


def _rank(rank: int, world: int, store: str, workdir: str, module: str) -> None:
    """One gloo rank: every job of ``module`` on the (2, 4) mesh; rank 0
    writes the results to ``port.pkl``."""
    torch.set_num_threads(1)
    _quiet()
    from repro_torch.launch.mesh import TIMEOUT, make_mesh

    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    try:
        jobs = importlib.import_module(module).JOBS
        inits = pickle.load(open(os.path.join(workdir, "init.pkl"), "rb"))
        mesh = make_mesh(*MESH, device="cpu")
        out = {name: run_job(job, inits[name], mesh) for name, job in jobs.items()}
        if rank == 0:
            with open(os.path.join(workdir, "port.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_jobs(jobs: dict, module: str, work, plain=()) -> tuple[dict, dict, dict]:
    """Every job in the reference's subprocess and on 8 gloo ranks at once,
    and the jobs named in ``plain`` off the mesh in this process while
    they run -> (reference results, port results on the mesh, port
    results off it)."""
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.models import make_model as ref_make_model

    inits = {}
    for name, job in jobs.items():
        params = ref_make_model(job_cfg(ref_get_config, job)).init(jax.random.PRNGKey(0))
        inits[name] = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
    with open(work / "init.pkl", "wb") as f:
        pickle.dump(inits, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    with open(work / "ref.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(work / "init.pkl"),
                                 str(work / "ref.pkl"), tests_dir, module],
                                stdout=log, stderr=subprocess.STDOUT, env=env)
        ctx = mp.spawn(_rank, args=(8, f"file://{work}/store", str(work), module), nprocs=8,
                       join=False)
        try:
            off = {name: run_job(jobs[name], inits[name]) for name in plain}
        finally:
            _join(ctx, proc, time.time() + DEADLINE)
    assert proc.returncode == 0, (work / "ref.log").read_text()[-3000:]
    with open(work / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(work / "port.pkl", "rb") as f:
        port = pickle.load(f)
    return ref, port, off


def ref_by_port_names(tree, job) -> dict:
    """A reference param-shaped tree by the port's names."""
    from repro_torch import convert
    from repro_torch.configs.base import get_config

    model = convert.lm_params_from_jax(tree, job_cfg(get_config, job), device="cpu")
    return {k: v.numpy() for k, v in model.named_parameters()}


def assert_step(got: dict, want: dict, job) -> None:
    """One step's metrics within ``METRIC_RTOL``, its params and first
    moments within ``test_torch_train.py``'s ``TOL``, and every gradient
    nonzero (at step 1, mu = 0.1 g)."""
    assert set(got["metrics"]) == set(want["metrics"]) == {"loss", "nll", "aux", "grad_norm"}
    for k, w in want["metrics"].items():
        assert np.isfinite(w), (k, w)
        np.testing.assert_allclose(got["metrics"][k], w, rtol=METRIC_RTOL, atol=1e-7,
                                   err_msg=k)
    for what in ("params", "mu"):
        _assert_leaves(got[what], ref_by_port_names(want[what], job), what)
    dead = [k for k, mu in got["mu"].items() if not np.any(mu != 0)]
    assert not dead, f"no gradient reached {dead}"


def assert_serve(got: dict, want: dict, what: str) -> None:
    """Every step's logits within ``LOGIT_TOL`` of its largest, the same
    tokens, and the final cache leaves within the same bound."""
    _assert_logits(got["logits"], want["logits"], what)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert set(got["cache"]) == set(want["cache"])
    keys = sorted(want["cache"])
    _assert_cache([got["cache"][k] for k in keys], [want["cache"][k] for k in keys],
                  f"{what} cache")


def cache_placements(job, batch: int) -> dict:
    """The placements ``sanitize_pspecs(cache_pspecs(...))`` gives each
    leaf of the job's cache on the (2, 4) mesh."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import make_model

    cfg = job_cfg(get_config, job)
    cache = make_model(cfg, device="meta").init_cache(batch, PROMPT + GEN)["layers"]
    specs = shd.sanitize_pspecs(cache, shd.cache_pspecs(cache, job_rules(shd, cfg, job[2])),
                                MeshShape)
    return {f"{i}.{kind}.{leaf}": shd.placements(spec, MeshShape)
            for i, layer in enumerate(specs) for kind, entry in layer.items()
            for leaf, spec in entry.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_jobs(JOBS, __name__, tmp_path_factory.mktemp("mesh_uneven"),
                    plain=("f1_granite_serve",))


@pytest.mark.parametrize("name", [n for n, j in JOBS.items() if j[3] == "prefill"])
def test_prefill_matches_reference(runs, name):
    """F1's prefill: the last logits within ``LOGIT_TOL`` of the largest."""
    ref, port, _ = runs
    got, want = port[name]["prefill"], ref[name]["prefill"]
    assert got.shape == want.shape == (B, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())


@pytest.mark.parametrize("name", [n for n, j in JOBS.items() if j[3].endswith("step")])
def test_step_matches_reference(runs, name):
    """F1's and F2's sharded train step (and 8 / 2 heads without FSDP); and
    reduced qwen3-moe's step in the "ep" layout with its batch handed over
    as DTensors laid out by ("batch", ...), as ``cells.lower_cell`` hands
    it: ``train.step._split`` gathers the rows, takes the reference's
    microbatch rows and lays them out again."""
    ref, port, _ = runs
    assert_step(port[name], ref[name], JOBS[name])


def test_serve_matches_reference(runs):
    """F1's layout through a decode: logits, tokens and cache against the
    reference's mesh decode, and the port's own decode off the mesh."""
    ref, port, off = runs
    name = "f1_granite_serve"
    assert_serve(port[name], ref[name]["mesh"], "on the mesh")
    assert_serve(off[name], ref[name]["plain"], "off the mesh")
    assert port[name]["pos"] == PROMPT + GEN
    assert port[name]["placements"] == cache_placements(JOBS[name], B)


@pytest.mark.parametrize("src,dst,shards,want", [
    # F1: [B, T, H, hd] -> [B * T, H * hd], H = 2 over 4: the heads gathered;
    # B over 2 divides, T is merged into B
    ((4, 32, 2, 8), (128, 16), {0: 2, 2: 4}, {2}),
    # a batch of 3 over 2 that the reshape keeps as it is stays split
    ((3, 32, 2, 8), (3, 32, 16), {0: 2}, set()),
    ((3, 32, 2, 8), (3, 32, 16), {0: 2, 2: 4}, {2}),
    # F2: [B * T, KV * hd] -> [B, T, KV, hd], KV = 2 over 4: the columns
    # split into heads that 4 does not divide; rows over 2 split into B = 4
    ((128, 16), (4, 32, 2, 8), {0: 2, 1: 4}, {1}),
    ((128, 32), (4, 32, 4, 8), {0: 2, 1: 4}, set()),
    # a split whose first dim the shards do not divide: B = 3 over 2
    ((96, 16), (3, 32, 16), {0: 2}, {0}),
    # a sharded dim of one element, and a sharded dim merged into the one before
    ((1, 32, 16), (32, 16), {0: 1}, {0}),
    ((4, 32, 16), (128, 16), {1: 2}, {1}),
])
def test_reshape_gathers_only_what_it_must(src, dst, shards, want):
    """``sharding._dims_to_gather``: a dim whose shards do not divide it is
    gathered before a reshape only where the reshape merges or splits it
    (where DTensor cannot flatten or unflatten it); a dim the reshape keeps
    as it is stays split."""
    from repro_torch.distributed import sharding as shd

    assert shd._dims_to_gather(src, dst, shards, set()) == want
    assert shd._dims_to_gather(src, dst, shards, {0}) == want | {0}
