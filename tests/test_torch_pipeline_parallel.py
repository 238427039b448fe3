"""The port's GPipe pipeline against the reference's, on 4 ranks.

The reference's ``tests/test_pipeline_parallel.py`` on both sides: S 4
stages of ``tanh(x @ w + b)`` at D 16, B 8, over a 4-rank "pod" axis. The
reference's ``pipeline_apply`` runs in a subprocess on 4 XLA CPU devices;
the port's on 4 gloo ranks (``torch.multiprocessing`` with a ``file://``
store), from the same seeded numpy params and input, at 1, 2, 4 and 8
microbatches. The output matches the port's ``reference_apply`` and the
reference's pipeline, and the gradient of ``sum(y ** 2)`` (params and
input) matches ``jax.grad``'s, each within ``TOL``; every stage's gradient
is nonzero. The same stages with their params nested one level
(``{"lin": {"w", "b"}}``, as a block's ``attn.wq`` is) go through
``pipeline_apply`` at 2 microbatches and through ``reference_apply``,
each against the reference's pipeline in value and gradient.
``ppermute`` (a partial permutation, whose unsent ranks get zeros) and
``pmax`` match JAX's, and ``ppermute``'s gradient taken on a fresh
thread (where CUDA's autograd engine runs a backward, with no shard_map
context set) equals the one taken on the calling thread. Both groups are
joined with a deadline and killed past it.
"""
import os
import pickle
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from test_torch_mesh_train import _join, _quiet

pytestmark = pytest.mark.subprocess_mesh

torch.set_num_threads(1)

TOL = 1e-5
S, D, B = 4, 16, 8
MICROBATCHES = (1, 2, 4, 8)
NESTED_MICROBATCHES = 2
# a partial permutation: rank 2 receives nothing, rank 3 sends nothing
PERM = ((0, 1), (1, 3), (2, 0))
DEADLINE = 180.0


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    return {"w": (rng.normal(size=(S, D, D)) * 0.3).astype(np.float32),
            "b": (rng.normal(size=(S, D)) * 0.1).astype(np.float32),
            "x": rng.normal(size=(B, D)).astype(np.float32),
            "c": rng.normal(size=(S, 3, D)).astype(np.float32)}


REF_SCRIPT = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.distributed.pipeline import pipeline_apply
    from repro.distributed.sharding import shard_map
    from repro.launch.mesh import make_mesh
    sys.path.insert(0, sys.argv[2])
    from test_torch_pipeline_parallel import MICROBATCHES, NESTED_MICROBATCHES, PERM, _inputs

    mesh = make_mesh((4,), ("pod",))
    inp = _inputs()
    params = {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])}
    x = jnp.asarray(inp["x"])

    def stage(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    out = {}
    for m in MICROBATCHES:
        def loss(p, x):
            with mesh:
                return jnp.sum(pipeline_apply(stage, p, x, mesh=mesh, axis="pod",
                                              num_microbatches=m) ** 2)
        with mesh:
            y = pipeline_apply(stage, params, x, mesh=mesh, axis="pod", num_microbatches=m)
        gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
        out[m] = {"y": np.asarray(y), "w": np.asarray(gp["w"]), "b": np.asarray(gp["b"]),
                  "x": np.asarray(gx)}

    def nested_stage(p, x):
        return jnp.tanh(x @ p["lin"]["w"] + p["lin"]["b"])

    def nested_loss(p, x):
        with mesh:
            y = pipeline_apply(nested_stage, p, x, mesh=mesh, axis="pod",
                               num_microbatches=NESTED_MICROBATCHES)
        return jnp.sum(y ** 2), y
    (_, y), (gp, gx) = jax.value_and_grad(nested_loss, argnums=(0, 1), has_aux=True)(
        {"lin": params}, x)
    out["nested"] = {"y": np.asarray(y), "w": np.asarray(gp["lin"]["w"]),
                     "b": np.asarray(gp["lin"]["b"]), "x": np.asarray(gx)}

    def local(c):
        return (jax.lax.ppermute(c, "pod", PERM), jax.lax.pmax(c, "pod"))
    with mesh:
        pp, pm = shard_map(local, mesh=mesh, in_specs=P("pod"),
                           out_specs=(P("pod"), P("pod")), check_vma=False)(jnp.asarray(inp["c"]))
    out["ppermute"], out["pmax"] = np.asarray(pp), np.asarray(pm)
    pickle.dump(out, open(sys.argv[1], "wb"))
""")


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _nested_stage(p, x):
    return torch.tanh(x @ p["lin"]["w"] + p["lin"]["b"])


def _rank(rank: int, world: int, store: str, workdir: str) -> None:
    """One gloo rank of the 4-rank "pod" mesh; each writes ``rank{r}.pkl``."""
    torch.set_num_threads(1)
    _quiet()
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.pipeline import pipeline_apply, reference_apply
    from repro_torch.launch.mesh import TIMEOUT, make_mesh

    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    try:
        mesh = make_mesh((S,), ("pod",), device="cpu")
        inp = {k: torch.from_numpy(v) for k, v in _inputs().items()}
        out = {"sequential": reference_apply(_stage, inp, inp["x"]).numpy()}
        for m in MICROBATCHES:
            leaves = {k: inp[k].clone().requires_grad_(True) for k in ("w", "b", "x")}
            y = pipeline_apply(_stage, {"w": leaves["w"], "b": leaves["b"]}, leaves["x"],
                               mesh=mesh, axis="pod", num_microbatches=m)
            (y ** 2).sum().backward()
            out[m] = {"y": y.detach().numpy(),
                      **{k: v.grad.numpy() for k, v in leaves.items()}}
        for name, apply in (("nested", lambda p, x: pipeline_apply(
                _nested_stage, p, x, mesh=mesh, axis="pod",
                num_microbatches=NESTED_MICROBATCHES)),
                            ("nested_sequential", lambda p, x: reference_apply(
                                _nested_stage, p, x))):
            leaves = {k: inp[k].clone().requires_grad_(True) for k in ("w", "b", "x")}
            y = apply({"lin": {"w": leaves["w"], "b": leaves["b"]}}, leaves["x"])
            (y ** 2).sum().backward()
            out[name] = {"y": y.detach().numpy(),
                         **{k: v.grad.numpy() for k, v in leaves.items()}}

        def local(c):
            return shd.ppermute(c, "pod", PERM), shd.pmax(c, "pod")
        pp, pm = shd.shard_map(local, mesh=mesh, in_specs=(shd.P("pod"),),
                               out_specs=(shd.P("pod"), shd.P("pod")))(inp["c"])
        out["ppermute"], out["pmax"] = pp.full_tensor().numpy(), pm.full_tensor().numpy()

        grads = []
        for threaded in (False, True):
            c = inp["c"].clone().requires_grad_(True)
            cube = lambda t: shd.ppermute(t ** 3, "pod", PERM)
            y = shd.shard_map(cube, mesh=mesh, in_specs=(shd.P("pod"),),
                              out_specs=shd.P("pod"))(c)
            loss = (y.full_tensor() * torch.arange(1.0, 4.0)[:, None]).sum()
            got = {}

            def backward():
                try:
                    got["g"] = torch.autograd.grad(loss, [c])[0]
                except Exception as e:        # noqa: BLE001 - re-raised below
                    got["e"] = e

            if threaded:
                t = threading.Thread(target=backward)
                t.start()
                t.join(60)
            else:
                backward()
            if "e" in got:
                raise got["e"]
            grads.append(got["g"].numpy())
        out["thread_grads"] = grads
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, each port rank's results)."""
    work = tmp_path_factory.mktemp("pipeline")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    with open(work / "ref.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(work / "ref.pkl"),
                                 tests_dir], stdout=log, stderr=subprocess.STDOUT, env=env)
        ctx = mp.spawn(_rank, args=(S, f"file://{work}/store", str(work)), nprocs=S,
                       join=False)
        _join(ctx, proc, time.time() + DEADLINE)
    assert proc.returncode == 0, (work / "ref.log").read_text()[-3000:]
    with open(work / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    port = []
    for r in range(S):
        with open(work / f"rank{r}.pkl", "rb") as f:
            port.append(pickle.load(f))
    return ref, port


@pytest.mark.parametrize("m", MICROBATCHES)
def test_pipeline_matches_sequential_and_reference(runs, m):
    ref, port = runs
    for got in port:
        np.testing.assert_allclose(got[m]["y"], got["sequential"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got[m]["y"], ref[m]["y"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("m", MICROBATCHES)
def test_pipeline_gradient_matches_reference(runs, m):
    """The gradient of ``sum(y ** 2)`` flows back through the reverse
    hand-offs to every stage's params (and to the input) on every rank."""
    ref, port = runs
    for got in port:
        for k in ("w", "b", "x"):
            np.testing.assert_allclose(got[m][k], ref[m][k], rtol=TOL, atol=TOL,
                                       err_msg=f"{m} microbatches, d/d{k}")
        assert np.isfinite(got[m]["w"]).all()
        assert (np.abs(got[m]["w"]).sum(axis=(1, 2)) > 0).all()
        assert (np.abs(got[m]["b"]).sum(axis=1) > 0).all()


@pytest.mark.parametrize("route", ["nested", "nested_sequential"])
def test_nested_stage_params_match_reference(runs, route):
    """Stage params nested one level (``{"lin": {"w": [S, D, D], "b": [S,
    D]}}``): ``pipeline_apply`` and ``reference_apply`` give the
    reference pipeline's output and gradient (params and input)."""
    ref, port = runs
    for got in port:
        for k in ("y", "w", "b", "x"):
            np.testing.assert_allclose(got[route][k], ref["nested"][k], rtol=TOL, atol=TOL,
                                       err_msg=f"{route} {k}")
        assert (np.abs(got[route]["w"]).sum(axis=(1, 2)) > 0).all()


def test_ppermute_and_pmax_match_jax(runs):
    """A partial permutation sends each listed rank's block and leaves the
    others zero; ``pmax`` is the elementwise max over the axis."""
    ref, port = runs
    for got in port:
        np.testing.assert_array_equal(got["ppermute"], ref["ppermute"])
        np.testing.assert_array_equal(got["pmax"], ref["pmax"])
    assert not ref["ppermute"][2].any() and ref["ppermute"][[0, 1, 3]].all()


def test_ppermute_gradient_on_a_fresh_thread(runs):
    """The gradient is the inverse permutation (3 c**2 times each row's
    weight where the block was sent; zero for the rank that sends
    nothing), the same on a fresh thread as on the calling thread."""
    _, port = runs
    c = _inputs()["c"].astype(np.float64)
    want = np.zeros_like(c)
    for src, dst in PERM:
        want[src] = 3 * c[src] ** 2 * np.arange(1.0, 4.0)[:, None]
    for got in port:
        on_caller, on_thread = got["thread_grads"]
        np.testing.assert_array_equal(on_caller, on_thread)
        np.testing.assert_allclose(on_caller, want, rtol=1e-6)


def test_batch_must_split_into_microbatches():
    """``B % M != 0`` raises before any rank communicates, as the
    reference's ``assert`` does."""
    from repro_torch.distributed.pipeline import pipeline_apply

    class PodMesh:
        shape = {"pod": S}
        axis_names = ("pod",)

    x = torch.from_numpy(_inputs()["x"])
    params = {"w": torch.zeros(S, D, D), "b": torch.zeros(S, D)}
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(_stage, params, x, mesh=PodMesh(), axis="pod", num_microbatches=3)


def test_ppermute_to_self_on_one_rank(tmp_path):
    """On a one-rank axis the pair (0, 0) hands the block to itself (gloo
    has no pair to its own rank, so there it is a local copy) and the
    gradient comes back the same way; the pipeline then applies its one
    stage."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import TIMEOUT, make_mesh

    _quiet()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, timeout=TIMEOUT)
    try:
        mesh = make_mesh((1,), ("pod",), device="cpu")
        inp = {k: torch.from_numpy(v) for k, v in _inputs().items()}
        c = inp["c"][:1].clone().requires_grad_(True)
        y = shd.shard_map(lambda t: shd.ppermute(2 * t, "pod", [(0, 0)]), mesh=mesh,
                          in_specs=(shd.P("pod"),), out_specs=shd.P("pod"))(c)
        y = y.full_tensor()
        (g,) = torch.autograd.grad(y.sum(), [c])
        assert torch.equal(y, 2 * inp["c"][:1]) and torch.equal(g, torch.full_like(g, 2.0))
        params = {"w": inp["w"][:1], "b": inp["b"][:1]}
        got = pipeline_apply(_stage, params, inp["x"], mesh=mesh, axis="pod",
                             num_microbatches=4)
        want = _stage({"w": inp["w"][0], "b": inp["b"][0]}, inp["x"])
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    finally:
        dist.destroy_process_group()
