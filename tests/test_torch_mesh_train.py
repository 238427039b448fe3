"""The port's sharded train step against the reference's 8-device step.

The reference's ``make_train_step`` runs in a subprocess on 8 XLA CPU
devices, a (2, 4) ("data", "model") mesh, as
``tests/test_distributed.py::test_sharded_train_step_8dev`` runs it. The
port's runs on 8 gloo ranks (``torch.multiprocessing`` with a ``file://``
store) on the same mesh (``launch.mesh.make_mesh(device="cpu")``), its
params laid out by ``sharding.distribute_params``. Both start from the
same params (the reference's ``init``, carried across by
``convert.lm_params_from_jax``) and take 4 steps at 2 microbatches on the
same seeded numpy tokens, in f32, with ``tests/test_torch_train.py``'s
``adamw``. The layouts:

(a) reduced qwen3-moe-30b-a3b under ``ShardingRules(batch=("data",),
    p_d_model=None, moe_mode="ep")``, the reference's own test: the
    experts over "model", the tokens split over both axes, one
    ``all_to_all`` pair;
(b) the same with ``moe_mode="tp"``: the expert FFNs split over "model"
    and a ``psum``;
(c) reduced granite-8b under ``default_rules(cfg, fsdp=True)``: d_model
    params over "data" (FSDP), heads / FFN / vocab over "model".

At every step the loss, nll, aux and ``grad_norm`` match the reference's
within ``test_torch_train.py``'s ``METRIC_RTOL``, and the final params,
mu and nu within its ``TOL`` (each leaf to TOL times its largest value,
params plus 100 TOL lr); (c) also matches the port's own unsharded step.
The reference subprocess and the 8 ranks run at once, each group joined
with a deadline and killed past it; every process group times out after
``launch.mesh.TIMEOUT``.
"""
import dataclasses
import logging
import os
import pickle
import subprocess
import sys
import textwrap
import time
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

pytestmark = pytest.mark.subprocess_mesh

torch.set_num_threads(1)

TOL = 2e-5
METRIC_RTOL = 1e-5
ADAMW = dict(learning_rate=1e-3, eps=1e-3, weight_decay=0.1)      # test_torch_train.py's
STEPS, MICRO, B, T = 4, 2, 4, 64
MESH = ((2, 4), ("data", "model"))
LAYOUTS = {"a": ("qwen3-moe-30b-a3b", "ep"), "b": ("qwen3-moe-30b-a3b", "tp"),
           "c": ("granite-8b", "fsdp")}
DEADLINE = 240.0


class MeshShape:
    """MESH's shape alone, as the spec functions read a mesh."""
    shape = dict(zip(MESH[1], MESH[0]))
    axis_names = MESH[1]


def _batch(vocab: int) -> dict:
    toks = np.random.default_rng(1).integers(0, vocab, (B, T + 1))
    return {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}


def _rules(pkg, cfg, mode):
    if mode == "fsdp":
        return pkg.default_rules(cfg, fsdp=True)
    return pkg.ShardingRules(batch=("data",), p_d_model=None, moe_mode=mode)


REF_SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro import optim
    from repro.configs import get_config
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_mesh
    from repro.models import make_model
    from repro.train import make_train_step
    from repro.train.step import init_state
    sys.path.insert(0, sys.argv[3])
    from test_torch_mesh_train import ADAMW, LAYOUTS, MESH, MICRO, STEPS, _batch, _rules

    inits = pickle.load(open(sys.argv[1], "rb"))
    mesh = make_mesh(*MESH)
    out = {}
    for name, (arch, mode) in LAYOUTS.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        model = make_model(cfg)
        tx = optim.adamw(**ADAMW)
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg.vocab_size).items()}
        with mesh, shd.use_rules(_rules(shd, cfg, mode), mesh):
            state = init_state(jax.tree_util.tree_map(jnp.asarray, inits[name]), tx)
            step = jax.jit(make_train_step(model, tx, num_microbatches=MICRO))
            metrics = []
            for _ in range(STEPS):
                state, m = step(state, batch)
                metrics.append({k: float(v) for k, v in m.items()})
        leaves = lambda t: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), t)
        out[name] = {"metrics": metrics, "params": leaves(state.params),
                     "mu": leaves(state.opt_state.mu), "nu": leaves(state.opt_state.nu)}
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _quiet() -> None:
    warnings.filterwarnings("ignore")
    logging.disable(logging.WARNING)


def _rank(rank: int, world: int, store: str, workdir: str) -> None:
    """One gloo rank: every layout on the (2, 4) mesh; rank 0 writes what
    the ranks computed to ``port.pkl``."""
    torch.set_num_threads(1)
    _quiet()
    from repro_torch import convert, optim
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import TIMEOUT, make_mesh
    from repro_torch.train import step

    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    try:
        inits = pickle.load(open(os.path.join(workdir, "init.pkl"), "rb"))
        mesh = make_mesh(*MESH, device="cpu")
        out = {}
        for name, (arch, mode) in LAYOUTS.items():
            cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
            model = convert.lm_params_from_jax(inits[name], cfg, device="cpu")
            tx = optim.adamw(**ADAMW)
            batch = _batch(cfg.vocab_size)
            train_step = step.make_train_step(model, tx, num_microbatches=MICRO)
            rec = {}
            rules = _rules(shd, cfg, mode)
            with shd.use_rules(rules, mesh):
                state = step.init_state(
                    shd.distribute_params(step.model_params(model), mesh, rules), tx)
                rec["metrics"] = []
                for _ in range(STEPS):
                    state, m = train_step(state, batch)
                    rec["metrics"].append({k: float(v) for k, v in m.items()})
            rec["placements"] = {k: tuple(v.placements) for k, v in state.params.items()}
            for what, tree in (("params", state.params), ("mu", state.opt_state.mu),
                               ("nu", state.opt_state.nu)):
                rec[what] = {k: v.full_tensor().numpy() for k, v in tree.items()}
            rec["norms"] = (float(optim.global_norm(state.opt_state.mu).full_tensor()),
                            float(optim.global_norm({k: torch.from_numpy(v)
                                                     for k, v in rec["mu"].items()})))
            out[name] = rec
        if rank == 0:
            with open(os.path.join(workdir, "port.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _join(ctx, proc: subprocess.Popen, deadline: float) -> None:
    """Wait for the ranks and the reference subprocess until ``deadline``;
    past it (or when either fails) kill whatever still runs."""
    try:
        while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.time()))):
            if time.time() > deadline:
                raise TimeoutError("the gloo ranks passed their deadline")
        proc.wait(timeout=max(0.1, deadline - time.time()))
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, port results) of every layout."""
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.models import make_model as ref_make_model

    work = tmp_path_factory.mktemp("mesh_train")
    inits = {}
    for name, (arch, _) in LAYOUTS.items():
        cfg = dataclasses.replace(ref_get_config(arch).reduced(), dtype="float32")
        params = ref_make_model(cfg).init(jax.random.PRNGKey(0))
        inits[name] = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
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
            unsharded = _unsharded_steps(inits["c"], LAYOUTS["c"][0])
        finally:
            _join(ctx, proc, time.time() + DEADLINE)
    assert proc.returncode == 0, (work / "ref.log").read_text()[-3000:]
    with open(work / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(work / "port.pkl", "rb") as f:
        port = pickle.load(f)
    port["c"].update(unsharded)
    return ref, port


def _unsharded_steps(init, arch) -> dict:
    """The port's own step without a mesh, from the same params and batch
    (run while the ranks run)."""
    from repro_torch import convert, optim
    from repro_torch.configs.base import get_config
    from repro_torch.train import step

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = convert.lm_params_from_jax(init, cfg, device="cpu")
    tx = optim.adamw(**ADAMW)
    train_step = step.make_train_step(model, tx, num_microbatches=MICRO)
    state = step.init_state(step.model_params(model), tx)
    metrics = []
    for _ in range(STEPS):
        state, m = train_step(state, _batch(cfg.vocab_size))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"unsharded": metrics,
            "unsharded_params": {k: v.numpy() for k, v in state.params.items()}}


def _ref_by_port_names(tree, arch) -> dict:
    from repro_torch import convert
    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = convert.lm_params_from_jax(tree, cfg, device="cpu")
    return {k: v.numpy() for k, v in model.named_parameters()}


def _assert_metrics(got: list, want: list):
    assert len(got) == len(want) == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w) == {"loss", "nll", "aux", "grad_norm"}
        for k in w:
            assert np.isfinite(w[k]), (i, k, w[k])
            np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL, atol=1e-7,
                                       err_msg=f"step {i} {k}")
    assert want[-1]["loss"] < want[0]["loss"]


def _assert_leaves(got: dict, want: dict, what: str):
    assert set(got) == set(want)
    for k, w in want.items():
        atol = TOL * np.abs(w).max() + (100 * TOL * ADAMW["learning_rate"]
                                        if what == "params" else 0.0)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=atol, err_msg=f"{what} {k}")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sharded_step_matches_reference(runs, layout):
    ref, port = runs
    arch = LAYOUTS[layout][0]
    _assert_metrics(port[layout]["metrics"], ref[layout]["metrics"])
    for what in ("params", "mu", "nu"):
        _assert_leaves(port[layout][what], _ref_by_port_names(ref[layout][what], arch), what)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_state_keeps_the_reference_layout(runs, layout):
    """After 4 steps every param is still laid out by
    ``sanitize_pspecs(param_pspecs(...))``, and ``global_norm`` of a
    sharded tree equals that of the same tree unsharded."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import make_model

    _, port = runs
    arch, mode = LAYOUTS[layout]
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = dict(make_model(cfg, device="meta").named_parameters())

    rules = _rules(shd, cfg, mode)
    want = shd.named_shardings(shd.sanitize_pspecs(params, shd.param_pspecs(params, rules),
                                                   MeshShape), MeshShape)
    assert port[layout]["placements"] == want
    sharded = [k for k, pl in want.items() if any(isinstance(p, Shard) for p in pl)]
    assert sharded and len(sharded) < len(want)
    if mode == "fsdp":
        assert want["blocks.0.attn.wq"] == (Shard(0), Shard(1))
    else:
        assert want["blocks.0.moe.e_gate"] == (Replicate(), Shard(0))
    np.testing.assert_allclose(*port[layout]["norms"], rtol=1e-6)


def test_fsdp_step_matches_unsharded_step(runs):
    _, port = runs
    rec = port["c"]
    _assert_metrics(rec["metrics"], rec["unsharded"])
    _assert_leaves(rec["params"], rec["unsharded_params"], "params")


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-base"])
def test_unported_families_raise_on_a_mesh(arch):
    """The VLM and audio families do not run on a mesh yet: their loss
    raises inside ``use_rules`` with a mesh, and runs without (the images
    or frames drawn at random)."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import make_model

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = make_model(cfg, device="cpu")
    batch = _batch(cfg.vocab_size)
    rng = np.random.default_rng(2)
    if cfg.family == "vlm":
        batch["images"] = rng.normal(size=(B, cfg.num_image_tokens, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(B, cfg.num_audio_frames, cfg.d_model)).astype(
            np.float32)

    with shd.use_rules(shd.default_rules(cfg), MeshShape()):
        with pytest.raises(NotImplementedError, match="mesh"):
            model.loss(batch)
    with torch.no_grad():
        loss, _ = model.loss(batch, remat=False)
    assert torch.isfinite(loss)


def test_remat_recompute_keeps_the_mesh(tmp_path):
    """The backward of a CUDA tensor runs on the autograd engine's own
    thread, where the forward's ``use_rules`` context is not set: the
    blocks that remat recomputes there must still run on the mesh. Here
    the gradient is taken on a fresh thread (a world of one gloo rank,
    reduced qwen3-moe in "ep" mode), and equals the one taken in the
    forward's thread."""
    import threading

    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import TIMEOUT, make_mesh
    from repro_torch.models import make_model
    from repro_torch.train import step

    _quiet()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, timeout=TIMEOUT)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(), dtype="float32")
        model = make_model(cfg, device="cpu")
        rules = _rules(shd, cfg, "ep")
        batch = _batch(cfg.vocab_size)
        grads = []
        with shd.use_rules(rules, mesh):
            params = shd.distribute_params(step.model_params(model), mesh, rules)
            for threaded in (False, True):
                leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}

                def run(m, b):
                    # the backward inside the call, as the step takes it
                    loss, _ = m.loss(b, remat=True)
                    out = {}

                    def backward():
                        try:
                            out["g"] = torch.autograd.grad(loss, list(leaves.values()))
                        except Exception as e:        # noqa: BLE001 - re-raised below
                            out["e"] = e

                    if threaded:
                        t = threading.Thread(target=backward)
                        t.start()
                        t.join(60)
                    else:
                        backward()
                    if "e" in out:
                        raise out["e"]
                    return out["g"]

                with torch.enable_grad():
                    got = step._call(model, leaves, run, batch)
                grads.append([g.full_tensor() for g in got])
        for a, b in zip(*grads):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def test_mesh_constructors():
    """``make_host_mesh`` starts a one-rank gloo group where none exists
    and reads as the reference's mesh; ``make_production_mesh`` raises
    unless the world holds its 256 ranks; a CUDA mesh raises where there
    is no card (never a gloo mesh in its place)."""
    from repro_torch.launch import mesh as launch_mesh

    assert not dist.is_initialized()
    try:
        mesh = launch_mesh.make_host_mesh(device="cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert mesh.shape == {"data": 1, "model": 1} and list(mesh.shape) == ["data", "model"]
        assert mesh.axis_names == ("data", "model") and mesh.device_type == "cpu"
        assert mesh.local_rank("model") == 0 and mesh.get_group("data") is not None
        with pytest.raises(ValueError, match="256 ranks"):
            launch_mesh.make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="differ in length"):
            launch_mesh.make_mesh((1,), ("data", "model"), device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                launch_mesh.make_host_mesh()
    finally:
        dist.destroy_process_group()
