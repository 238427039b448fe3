"""The SSM and hybrid families' training on a device mesh against the
reference's.

As ``tests/test_torch_mesh_train.py``: the reference runs in a subprocess
on 8 XLA CPU devices, a (2, 4) ("data", "model") mesh, and the port on 8
gloo ranks (``torch.multiprocessing`` with a ``file://`` store) on the same
mesh, both at once (the ranks take a layout's steps once the reference
has written its states), from the same params (the reference's
``init``, carried across by ``convert.lm_params_from_jax``), in f32.

(a) ``ssm.ssm_train`` alone at ``chunk=8``, B 4, T 64 (8 chunks, so the
    state is handed from chunk to chunk), under ``default_rules(cfg)``:
    reduced mamba2-130m's SSM params from the reference's ``init_ssm``,
    with ``a_log``, ``dt_bias``, ``conv_b`` and ``d_skip`` drawn at random
    (their init values are constants: a head wired to another head's
    gate would not show). The value and the gradient of ``sum(y * w)``
    (every param and the input) against ``jax.value_and_grad`` of the
    reference's ``ssm_train`` under ``use_rules`` on the 8 devices; the
    port's mesh gradient at one 256-token chunk (where a chunk's
    log-decay may pass 88 and the reference's gradient turns NaN,
    ROADMAP reference fault 2) against its own gradient off the mesh.
(b) The sharded train step at 2 microbatches, B 4, T 64 (the
    reference's SSD gradient is finite at this length), with
    ``tests/test_torch_train.py``'s AdamW, at each of the first 4 states
    of the reference's own 8-device run: the port takes one step from
    the reference's state i (params, mu, nu and step carried across) and
    is held to the reference's step i + 1. Over a chain of steps the two
    packages drift apart on their own, off the mesh as much as on it
    (AdamW turns a last-digit difference of a small gradient into a
    full-size step; a jamba router may then flip a choice), so only
    jamba's first ``CHAIN`` = 2 steps are also held chained, each from
    the port's own last state. The layouts:
    - ``mamba2``: reduced mamba2-130m under ``default_rules(cfg,
      fsdp=True)``; its 4 chained steps on the mesh also against the
      port's own 4 chained steps off it;
    - ``jamba_tp``: reduced jamba-v0.1-52b (7 SSM layers and 1 attention
      layer, MoE every other layer) under ``default_rules(cfg)``, which
      gives "tp" at 4 experts;
    - ``jamba_ep``: the same with ``moe_mode="ep"``, ``p_expert="model"``
      and ``p_moe_ff=None``, what full-size jamba's 16 experts get.
    The MoE layers route each shard at its own capacity (the reference's
    rule), so jamba is held to the reference's mesh run, never to a run
    off the mesh. mamba2 is held to ``test_torch_mesh_train.py``'s
    ``TOL`` and ``METRIC_RTOL``; jamba's leaves to
    ``test_torch_train_ssm.py``'s ``JAMBA_TOL`` (its forward is already
    4e-5 from the reference's off the mesh).
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
from test_torch_mesh_train import (ADAMW, MESH, MICRO, STEPS, TOL, MeshShape, _assert_leaves,
                                   _assert_metrics, _batch, _join, _quiet, _ref_by_port_names)

pytestmark = pytest.mark.subprocess_mesh

torch.set_num_threads(1)

LAYOUTS = {"mamba2": ("mamba2-130m", "fsdp"), "jamba_tp": ("jamba-v0.1-52b", "tp"),
           "jamba_ep": ("jamba-v0.1-52b", "ep")}
SCAN_ARCH, SCAN_B, SCAN_T, SCAN_CHUNK = "mamba2-130m", 4, 64, 8
LONG_T = 256
CHAIN = 2
DEADLINE = 480.0


def _rules(shd, cfg, mode):
    if mode == "fsdp":
        return shd.default_rules(cfg, fsdp=True)
    rules = shd.default_rules(cfg)
    if mode == "ep":
        return dataclasses.replace(rules, moe_mode="ep", p_expert="model", p_moe_ff=None)
    return rules


def _scan_inputs(ssm_params: dict, t: int) -> dict:
    """The SSM params with their constant leaves drawn at random, x [B, t,
    d] and the cotangent weights w."""
    rng = np.random.default_rng(5)
    p = {k: np.asarray(v, np.float32) for k, v in ssm_params.items()}
    for k, base, scale in (("a_log", 0.0, 0.5), ("dt_bias", 0.0, 0.5), ("conv_b", 0.0, 0.1),
                           ("d_skip", 1.0, 0.2)):
        p[k] = (base + scale * rng.normal(size=p[k].shape)).astype(np.float32)
    d = p["in_proj"].shape[0]
    return {"params": p, "x": rng.normal(size=(SCAN_B, t, d)).astype(np.float32),
            "w": rng.normal(size=(SCAN_B, t, d)).astype(np.float32)}


def _dump(obj, path: str) -> None:
    """Write a pickle whole before it appears under ``path`` (the ranks
    wait for it)."""
    with open(path + ".tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".tmp", path)


REF_SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro import optim
    from repro.configs import get_config
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_mesh
    from repro.models import make_model, ssm
    from repro.train import make_train_step
    from repro.train.step import init_state
    sys.path.insert(0, sys.argv[3])
    from test_torch_mesh_ssm import (ADAMW, LAYOUTS, MESH, MICRO, SCAN_ARCH, SCAN_CHUNK,
                                     STEPS, _batch, _dump, _rules)

    work = sys.argv[2]
    try:
        inits = pickle.load(open(sys.argv[1], "rb"))
        mesh = make_mesh(*MESH)
        cfg = dataclasses.replace(get_config(SCAN_ARCH).reduced(), dtype="float32")
        scan = inits["scan"]
        with mesh, shd.use_rules(shd.default_rules(cfg), mesh):
            def f(p, x, w):
                return jnp.sum(ssm.ssm_train(p, x, cfg, chunk=SCAN_CHUNK) * w)
            y = jax.jit(lambda p, x: ssm.ssm_train(p, x, cfg, chunk=SCAN_CHUNK))(
                scan["params"], scan["x"])
            val, (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
                scan["params"], scan["x"], scan["w"])
        _dump({"y": np.asarray(y), "value": float(val), "x": np.asarray(gx),
               **{k: np.asarray(v) for k, v in gp.items()}}, os.path.join(work, "ref_scan.pkl"))
        as_numpy = lambda t: jax.tree_util.tree_map(np.asarray, t)
        for name, (arch, mode) in LAYOUTS.items():
            cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
            model = make_model(cfg)
            tx = optim.adamw(**ADAMW)
            batch = _batch(cfg.vocab_size)
            with mesh, shd.use_rules(_rules(shd, cfg, mode), mesh):
                # each step from a numpy state: every call has the first
                # call's input types, so the step compiles once
                state = as_numpy(init_state(inits[name], tx))
                step = jax.jit(make_train_step(model, tx, num_microbatches=MICRO))
                states, metrics = [], []
                for _ in range(STEPS):
                    states.append({"params": state.params, "mu": state.opt_state.mu,
                                   "nu": state.opt_state.nu, "step": int(state.step)})
                    state, m = step(state, batch)
                    state = as_numpy(state)
                    metrics.append({k: float(v) for k, v in m.items()})
                states.append({"params": state.params, "mu": state.opt_state.mu,
                               "nu": state.opt_state.nu, "step": int(state.step)})
            _dump({"states": states, "metrics": metrics}, os.path.join(work, f"ref_{name}.pkl"))
    except BaseException:
        open(os.path.join(work, "ref.failed"), "w").close()
        raise
""")


def _wait_for(workdir: str, name: str) -> dict:
    """The reference's pickle ``ref_{name}.pkl``, once written; raises if
    the reference failed (the spawning test's deadline ends a wait that
    never does)."""
    path = os.path.join(workdir, f"ref_{name}.pkl")
    while not os.path.exists(path):
        if os.path.exists(os.path.join(workdir, "ref.failed")):
            raise RuntimeError("the reference subprocess failed")
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def _scan_grads(ssm_train, cfg, inp: dict, chunk: int, mesh=None, rules=None) -> dict:
    """``ssm_train`` and the gradient of ``sum(y * w)`` (params and x) ->
    numpy, on ``mesh`` (params laid out by ``distribute_params``, x split
    by ("batch", "seq", "d_model")) when it is given."""
    from repro_torch.distributed import sharding as shd

    params = {k: torch.from_numpy(v) for k, v in inp["params"].items()}
    x = torch.from_numpy(inp["x"])
    if mesh is not None:
        params = shd.distribute_params(params, mesh, rules)
        x = shd.as_global(x, "batch", "seq", "d_model").detach()
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    leaves["x"] = x.requires_grad_(True)
    whole = lambda t: t.full_tensor() if isinstance(t, shd.DTensor) else t
    with torch.enable_grad():
        y = whole(ssm_train({k: v for k, v in leaves.items() if k != "x"}, leaves["x"], cfg,
                            chunk=chunk))
        value = (y * torch.from_numpy(inp["w"])).sum()
        grads = torch.autograd.grad(value, list(leaves.values()))
    return {"y": y.detach().numpy(), "value": float(value.detach()),
            **{k: whole(g).numpy() for k, g in zip(leaves, grads)}}


def _leaf_errors(got: dict, want: dict) -> dict:
    """{leaf: (max |got - want|, max |want|)}."""
    assert set(got) == set(want)
    return {k: (float(np.abs(got[k] - w).max()), float(np.abs(w).max())) for k, w in want.items()}


def _steps_from_reference(model, arch: str, tx, ref: dict, mesh, rules,
                          chain: bool = False) -> dict:
    """One sharded step from each of the reference's states i < STEPS:
    the metrics, and (rank 0) each updated tree's error against the
    reference's state i + 1. With ``chain``, also ``CHAIN`` steps chained
    from the reference's state 0, each from the port's own last state:
    their metrics and the last one's errors against the reference's state
    ``CHAIN``."""
    from repro_torch import optim
    from repro_torch.distributed import sharding as shd
    from repro_torch.train import step

    trees = ("params", "mu", "nu")
    states = {}

    def port_state(i: int) -> dict:
        """The reference's state i under the port's names, converted once."""
        if i not in states:
            states[i] = {what: _ref_by_port_names(ref["states"][i][what], arch)
                         for what in trees}
        return states[i]

    def errors(state, i: int):
        got = {"params": state.params, "mu": state.opt_state.mu, "nu": state.opt_state.nu}
        got = {what: {k: v.full_tensor().numpy() for k, v in tree.items()}
               for what, tree in got.items()}
        if dist.get_rank() == 0:
            return {what: _leaf_errors(got[what], port_state(i)[what]) for what in trees}
        return None

    train_step = step.make_train_step(model, tx, num_microbatches=MICRO)
    batch = _batch(model.cfg.vocab_size)
    rec = {"metrics": [], "errors": []}
    for i in range(STEPS):
        laid = {what: shd.distribute_params({k: torch.from_numpy(v) for k, v in tree.items()},
                                            mesh, rules)
                for what, tree in port_state(i).items()}
        count = torch.tensor(ref["states"][i]["step"], dtype=torch.int32)
        state = step.TrainState(laid["params"], optim.OptState(count, laid["mu"], laid["nu"]),
                                count)
        state, m = train_step(state, batch)
        rec["metrics"].append({k: float(v) for k, v in m.items()})
        rec["errors"].append(errors(state, i + 1))
        rec["steps"] = (int(state.step), ref["states"][i + 1]["step"])
        if i == 0:
            own, chained = state, [rec["metrics"][0]]
    rec["placements"] = {k: tuple(v.placements) for k, v in state.params.items()}
    if chain:
        for _ in range(1, CHAIN):
            own, m = train_step(own, batch)
            chained.append({k: float(v) for k, v in m.items()})
        rec["chained"] = {"metrics": chained, "errors": errors(own, CHAIN),
                          "step": int(own.step)}
    return rec


def _rank(rank: int, world: int, store: str, workdir: str) -> None:
    """One gloo rank: the scan cases, mamba2's chained steps, then one step
    from each of the reference's states of every layout, on the (2, 4)
    mesh; rank 0 writes what the ranks computed to ``port.pkl``."""
    torch.set_num_threads(1)
    _quiet()
    from repro_torch import convert, optim
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import TIMEOUT, make_mesh
    from repro_torch.models import ssm
    from repro_torch.train import step

    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    try:
        inits = pickle.load(open(os.path.join(workdir, "init.pkl"), "rb"))
        mesh = make_mesh(*MESH, device="cpu")
        out = {}
        cfg = dataclasses.replace(get_config(SCAN_ARCH).reduced(), dtype="float32")
        rules = shd.default_rules(cfg)
        with shd.use_rules(rules, mesh):
            out["scan"] = _scan_grads(ssm.ssm_train, cfg, inits["scan"], SCAN_CHUNK, mesh, rules)
            out["scan_long"] = _scan_grads(ssm.ssm_train, cfg, inits["scan_long"], LONG_T,
                                           mesh, rules)
        for name, (arch, mode) in LAYOUTS.items():
            cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
            model = convert.lm_params_from_jax(inits[name], cfg, device="cpu")
            tx = optim.adamw(**ADAMW)
            rules = _rules(shd, cfg, mode)
            with shd.use_rules(rules, mesh):
                if name == "mamba2":
                    train_step = step.make_train_step(model, tx, num_microbatches=MICRO)
                    state = step.init_state(
                        shd.distribute_params(step.model_params(model), mesh, rules), tx)
                    chained = []
                    for _ in range(STEPS):
                        state, m = train_step(state, _batch(cfg.vocab_size))
                        chained.append({k: float(v) for k, v in m.items()})
                    out["chained"] = {"metrics": chained, "params": {
                        k: v.full_tensor().numpy() for k, v in state.params.items()}}
                out[name] = _steps_from_reference(model, arch, tx, _wait_for(workdir, name),
                                                  mesh, rules, chain=name.startswith("jamba"))
        if rank == 0:
            with open(os.path.join(workdir, "port.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _plain_runs(inits) -> dict:
    """The port off the mesh, run while the ranks run: the long scan's
    gradient, and mamba2's 4 chained steps."""
    from repro_torch import convert, optim
    from repro_torch.configs.base import get_config
    from repro_torch.models import ssm
    from repro_torch.train import step

    cfg = dataclasses.replace(get_config(SCAN_ARCH).reduced(), dtype="float32")
    out = {"scan_long": _scan_grads(ssm.ssm_train, cfg, inits["scan_long"], LONG_T)}
    cfg = dataclasses.replace(get_config(LAYOUTS["mamba2"][0]).reduced(), dtype="float32")
    model = convert.lm_params_from_jax(inits["mamba2"], cfg, device="cpu")
    tx = optim.adamw(**ADAMW)
    train_step = step.make_train_step(model, tx, num_microbatches=MICRO)
    state = step.init_state(step.model_params(model), tx)
    metrics = []
    for _ in range(STEPS):
        state, m = train_step(state, _batch(cfg.vocab_size))
        metrics.append({k: float(v) for k, v in m.items()})
    out["chained"] = {"metrics": metrics,
                      "params": {k: v.numpy() for k, v in state.params.items()}}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, port results on the mesh, port results off it)."""
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.models import make_model as ref_make_model
    from repro.models.ssm import init_ssm

    work = tmp_path_factory.mktemp("mesh_ssm")
    numpy_tree = lambda t: jax.tree_util.tree_map(lambda x: np.array(x, np.float32), t)
    inits = {}
    for name, (arch, _) in LAYOUTS.items():
        cfg = dataclasses.replace(ref_get_config(arch).reduced(), dtype="float32")
        inits[name] = numpy_tree(ref_make_model(cfg).init(jax.random.PRNGKey(0)))
    cfg = dataclasses.replace(ref_get_config(SCAN_ARCH).reduced(), dtype="float32")
    ssm_params = numpy_tree(init_ssm(jax.random.PRNGKey(3), cfg))
    inits["scan"] = _scan_inputs(ssm_params, SCAN_T)
    inits["scan_long"] = _scan_inputs(ssm_params, LONG_T)
    with open(work / "init.pkl", "wb") as f:
        pickle.dump(inits, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    with open(work / "ref.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(work / "init.pkl"),
                                 str(work), tests_dir],
                                stdout=log, stderr=subprocess.STDOUT, env=env)
        ctx = mp.spawn(_rank, args=(8, f"file://{work}/store", str(work)), nprocs=8,
                       join=False)
        try:
            plain = _plain_runs(inits)
        finally:
            _join(ctx, proc, time.time() + DEADLINE)
    assert proc.returncode == 0, (work / "ref.log").read_text()[-3000:]
    ref = {}
    for name in ("scan", *LAYOUTS):
        with open(work / f"ref_{name}.pkl", "rb") as f:
            ref[name] = pickle.load(f)
    with open(work / "port.pkl", "rb") as f:
        port = pickle.load(f)
    return ref, port, plain


def _assert_close(got: np.ndarray, want: np.ndarray, what: str):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("what", ["y", "value"])
def test_mesh_scan_matches_reference(runs, what):
    """``ssm_train`` at chunk 8 on the mesh: its output and ``sum(y * w)``."""
    ref, port, _ = runs
    _assert_close(np.asarray(port["scan"][what]), np.asarray(ref["scan"][what]), what)


@pytest.mark.parametrize("leaf", ["in_proj", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip",
                                  "out_proj", "x"])
def test_mesh_scan_gradient_matches_reference(runs, leaf):
    """Every param's gradient and the input's, each finite and nonzero."""
    ref, port, _ = runs
    got, want = port["scan"][leaf], ref["scan"][leaf]
    _assert_close(got, want, f"d/d{leaf}")
    assert np.abs(got).max() > 0


def test_mesh_scan_gradient_is_finite_at_a_long_chunk(runs):
    """At one 256-token chunk the mask before the exp keeps the mesh
    gradient finite, and it equals the port's own gradient off the mesh."""
    _, port, plain = runs
    got, want = port["scan_long"], plain["scan_long"]
    for k, w in want.items():
        _assert_close(np.asarray(got[k]), np.asarray(w), f"long chunk {k}")


def _tol(layout: str) -> float:
    from test_torch_train_ssm import JAMBA_TOL

    return JAMBA_TOL if layout.startswith("jamba") else TOL


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sharded_step_matches_reference(runs, layout):
    """Each of the 4 steps from the reference's state: loss, nll, aux and
    grad_norm, then the updated params, mu and nu (each leaf within the
    tolerance of its largest value; params plus 100 tolerances of lr)."""
    ref, port, _ = runs
    got = port[layout]
    _assert_metrics(got["metrics"], ref[layout]["metrics"])
    assert got["steps"] == (STEPS, STEPS)
    for i, errors in enumerate(got["errors"]):
        _assert_errors(errors, _tol(layout), i)


@pytest.mark.parametrize("layout", ["jamba_ep", "jamba_tp"])
def test_chained_steps_match_reference(runs, layout):
    """jamba's ``CHAIN`` steps chained on the mesh, each from the port's own
    last state, against the reference's first ``CHAIN`` steps: the last
    state at ``JAMBA_TOL``, as one step is held, and the metrics of each
    step at ``JAMBA_TOL`` relative too (a chained step's metrics are
    functions of a state held at that tolerance: step 2's grad_norm was
    measured 1.2e-5 apart, past ``METRIC_RTOL``; step 1 is
    ``test_sharded_step_matches_reference``'s first step)."""
    ref, port, _ = runs
    got, tol = port[layout]["chained"], _tol(layout)
    for i, (g, w) in enumerate(zip(got["metrics"], ref[layout]["metrics"][:CHAIN],
                                   strict=True)):
        assert set(g) == set(w) == {"loss", "nll", "aux", "grad_norm"}
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=tol, atol=1e-7,
                                       err_msg=f"chained step {i} {k}")
    assert got["step"] == CHAIN
    _assert_errors(got["errors"], tol, "chained")


def _assert_errors(errors: dict, tol: float, where) -> None:
    """Each leaf's (error, largest value) within ``tol`` of that value;
    params plus 100 tolerances of lr."""
    for what, leaves in errors.items():
        for k, (err, scale) in leaves.items():
            extra = 100 * tol * ADAMW["learning_rate"] if what == "params" else 0.0
            assert err <= tol * scale + extra, (where, what, k, err, scale)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_state_keeps_the_reference_layout(runs, layout):
    """After a step every param is still laid out by
    ``sanitize_pspecs(param_pspecs(...))``: the SSM's inner dim over
    "model", FSDP's d_model over "data", the experts or their FFN over
    "model" by the MoE mode."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import make_model

    _, port, _ = runs
    arch, mode = LAYOUTS[layout]
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = dict(make_model(cfg, device="meta").named_parameters())
    rules = _rules(shd, cfg, mode)
    want = shd.named_shardings(shd.sanitize_pspecs(params, shd.param_pspecs(params, rules),
                                                   MeshShape), MeshShape)
    assert port[layout]["placements"] == want
    if mode == "fsdp":
        assert want["blocks.0.ssm.in_proj"] == (Shard(0), Shard(1))
    else:
        assert want["blocks.0.ssm.in_proj"] == (Replicate(), Shard(1))
        assert want["blocks.1.moe.e_gate"] == ((Replicate(), Shard(0)) if mode == "ep"
                                               else (Replicate(), Shard(2)))


def test_fsdp_steps_match_unsharded_steps(runs):
    """mamba2 has no MoE: its 4 chained steps on the mesh are its 4 chained
    steps off it."""
    _, port, plain = runs
    _assert_metrics(port["chained"]["metrics"], plain["chained"]["metrics"])
    _assert_leaves(port["chained"]["params"], plain["chained"]["params"], "params")
