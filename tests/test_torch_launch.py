"""The port's training launcher and supervisor (``repro_torch.launch.train``,
``repro_torch.launch.supervisor``) and the inverse converter
(``convert.lm_params_to_jax``) against the reference's
``repro.launch.train``, ``repro.launch.supervisor`` and param trees, on
the CPU.

- ``build``: the learning-rate schedule at steps 0-25 and the token
  batches equal the reference's; three steps of each package's
  ``step_fn`` from the reference's ``model.init(PRNGKey(0))`` give its
  loss and ``grad_norm`` within ``tests/test_torch_train.py``'s
  ``METRIC_RTOL``, in f32 (both launchers' ``get_config`` patched to f32:
  in bf16 the two packages round differently), for reduced mamba2-130m
  and granite-8b at seq 32 (measured at most 7.7e-8 for the loss and
  1.2e-6 for ``grad_norm``: the launcher's eps 1e-8 makes the first Adam
  step nearly sign(g), see ``test_torch_train.py``).
- The inverse converter: every ``reduced()`` arch round-trips bit for
  bit, and gives the reference's own tree back (paths, shapes, dtypes,
  values).
- The ``--dedup-ckpt`` mirror: two drifted param sets of reduced
  mamba2-130m through the reference's ``DedupCheckpointStore`` and the
  port's, fed ``lm_params_to_jax``: the same streams, DCR and counts.
- Resume is exact: a run that crashes at step 12 and resumes from step 10
  ends with the checkpoint of an uninterrupted run, byte for byte; the
  restart through the supervisor as a subprocess
  (``tests/test_checkpoint.py::test_restart_after_injected_failure``).
- The supervisor: the same return codes and lines as the reference's over
  the same workers (a crash then success, a worker that always fails, a
  silent one killed by the heartbeat).

Every test has a SIGALRM time limit, every subprocess a ``timeout`` and
one thread, and every path lives under ``tmp_path``.
"""
import argparse
import dataclasses
import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.checkpoint import DedupCheckpointStore as RefDedupCheckpointStore
from repro.configs import get_config as ref_get_config
from repro.launch import supervisor as ref_supervisor
from repro.launch import train as ref_launch
from repro.models import make_model as ref_make_model
from repro_torch import convert
from repro_torch.checkpoint import DedupCheckpointStore
from repro_torch.checkpoint.store import flatten_with_path
from repro_torch.configs import ARCH_IDS, base, get_config
from repro_torch.launch import supervisor, train as launch
from repro_torch.models import make_model
from repro_torch.train.step import init_state, model_params
from test_torch_lifecycle import time_limit
from test_torch_train import METRIC_RTOL

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_limit = time_limit(120, test_restart_after_injected_failure=300)

RUN = ["--arch", "mamba2-130m", "--steps", "20", "--batch", "2", "--seq", "32",
       "--checkpoint-every", "5"]
DEDUP_LINE = re.compile(r"^\[dedup-ckpt\] DCR=\d+\.\d\d stored=\d+MiB raw=\d+MiB$")


def _env() -> dict:
    return dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")


def _args(arch: str, **kw) -> argparse.Namespace:
    base_args = dict(arch=arch, reduced=True, steps=30, batch=2, seq=32, lr=3e-3,
                     microbatches=1, device="cpu")
    return argparse.Namespace(**{**base_args, **kw})


# --- build ------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [10, 30])
def test_schedule_matches_reference(steps):
    """The launcher's schedule (warm-up 20, cosine to max(steps, 21)) at
    steps 0-25 against the reference's ``build`` arguments."""
    args = _args("granite-8b", steps=steps)
    mine = launch.lr_schedule(args)
    ref = ref_optim.cosine_schedule(args.lr, 20, max(args.steps, 21))
    for step in range(26):
        got = mine(torch.tensor(step, dtype=torch.int32))
        want = ref(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0, err_msg=step)


def test_build_batches_equal_reference():
    args = _args("granite-8b", batch=4, seq=48)
    cfg, _, _, _, pipe = launch.build(args)
    rcfg, _, _, _, ref_pipe = ref_launch.build(args)
    assert cfg.vocab_size == rcfg.vocab_size
    for step in range(4):
        got, want = pipe.batch(step), ref_pipe.batch(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


def _f32(get):
    return lambda arch: dataclasses.replace(get(arch), dtype="float32")


@pytest.mark.parametrize("arch", ["mamba2-130m", "granite-8b"])
def test_build_steps_match_reference(arch, monkeypatch):
    """Three steps of each package's ``build`` (the launcher's AdamW: warm-up,
    decay 0.1, clip 1.0), both from the reference's ``model.init(PRNGKey(0))``:
    loss and ``grad_norm`` at each step within ``METRIC_RTOL``."""
    monkeypatch.setattr(launch, "get_config", _f32(get_config))
    monkeypatch.setattr(ref_launch, "get_config", _f32(ref_get_config))
    args = _args(arch)
    cfg, model, tx, step_fn, pipe = launch.build(args)
    ref_cfg, ref_model, ref_tx, ref_step_fn, ref_pipe = ref_launch.build(args)
    assert cfg.dtype == ref_cfg.dtype == "float32"
    params = ref_model.init(jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
    carried = convert.lm_params_from_jax(leaves, cfg, device="cpu")
    state = init_state(model_params(carried), tx)
    ref_state = ref_launch.init_state(params, ref_tx)
    for step in range(3):
        batch = {k: torch.from_numpy(v) for k, v in pipe.batch(step).items()}
        state, metrics = step_fn(state, batch)
        ref_state, ref_metrics = ref_step_fn(
            ref_state, {k: jnp.asarray(v) for k, v in ref_pipe.batch(step).items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]),
                                       rtol=METRIC_RTOL, atol=1e-7, err_msg=f"{k} {step}")
    assert int(state.opt_state.step) == 3


def test_launcher_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--steps", "1"])


# --- the inverse converter --------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_inverse_converter_round_trips(arch):
    model = make_model(get_config(arch).reduced(), device="cpu", seed=2)
    back = convert.lm_params_from_jax(convert.lm_params_to_jax(model), model.cfg, device="cpu")
    mine, theirs = dict(model.named_parameters()), dict(back.named_parameters())
    assert list(mine) == list(theirs)
    for k, p in mine.items():
        assert p.dtype == theirs[k].dtype and torch.equal(p, theirs[k]), k


@functools.lru_cache(maxsize=None)
def _reference_tree(arch: str):
    ref_cfg = ref_get_config(arch).reduced()
    return ref_cfg, ref_make_model(ref_cfg).init(jax.random.PRNGKey(1))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_inverse_converter_gives_the_reference_tree(arch):
    ref_cfg, params = _reference_tree(arch)
    cfg = base.ModelConfig(**dataclasses.asdict(ref_cfg))
    leaves = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), params)
    model = convert.lm_params_from_jax(leaves, cfg, device="cpu")
    tree = convert.lm_params_to_jax(model)
    want = [(jax.tree_util.keystr(p), v)
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]]
    got = flatten_with_path(tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
        assert np.array_equal(g.float().numpy(), np.asarray(w, np.float32)), path


# --- the --dedup-ckpt mirror ------------------------------------------------------

def test_mirror_matches_reference():
    """Reduced mamba2-130m's bf16 params, then a drifted copy (each value
    times 1 + 1e-3 N(0, 1), rounded to bf16 in JAX), saved as the
    reference's launcher mirrors them (``jax.device_get(state.params)``)
    and as the port's does (``lm_params_to_jax`` of the carried model):
    equal streams and handles, DCR, bytes in and stored, chunk counts."""
    ref_cfg, params = _reference_tree("mamba2-130m")
    cfg = base.ModelConfig(**dataclasses.asdict(ref_cfg))
    rng = np.random.default_rng(9)
    drifted = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x, np.float32)
                              * (1 + 1e-3 * rng.standard_normal(x.shape)).astype(np.float32),
                              x.dtype), params)
    mine, ref = DedupCheckpointStore(device="cpu"), RefDedupCheckpointStore()
    for step, tree in ((5, params), (10, drifted)):
        leaves = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)
        model = convert.lm_params_from_jax(leaves, cfg, device="cpu")
        got = mine.save(convert.lm_params_to_jax(model), step)
        want = ref.save(jax.device_get(tree), step)
        assert (got.bytes_in, got.bytes_stored, got.dcr) == (
            want.bytes_in, want.bytes_stored, want.dcr)
    assert [mine._steps[s][0] for s in mine.steps] == [ref._steps[s][0] for s in ref.steps]
    for s in mine.steps:
        assert mine._store.restore(mine._steps[s][0]) == ref._store.restore(ref._steps[s][0])
    counts = lambda st: (st.chunks, st.dup_chunks, st.delta_chunks, st.raw_chunks)
    assert [counts(r) for r in mine._store.reports] == [counts(r) for r in ref._store.reports]
    assert mine.stats.dcr > 1.0


# --- resume ---------------------------------------------------------------------

def _files(d: Path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_resume_is_exact(tmp_path, capsys):
    """Crash at step 12 (exit 17), resume from the step-10 checkpoint with
    the mirror on: the step-20 checkpoint equals an uninterrupted run's,
    file for file."""
    crash, whole = tmp_path / "crash", tmp_path / "whole"
    with pytest.raises(SystemExit) as exc:
        launch.main(RUN + ["--ckpt-dir", str(crash), "--fail-at", "12", "--device", "cpu"])
    assert exc.value.code == 17
    assert "[failure-injection] crashing at step 12" in capsys.readouterr().out
    assert launch.main(RUN + ["--ckpt-dir", str(crash), "--fail-at", "12", "--device", "cpu",
                              "--dedup-ckpt"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert f"[resume] restored step 10 from {crash}" in out
    assert out[-1].startswith("[done] 20 steps in ")
    mirror = [ln for ln in out if ln.startswith("[dedup-ckpt]")]
    assert len(mirror) == 2 and all(DEDUP_LINE.match(ln) for ln in mirror), mirror
    assert launch.main(RUN + ["--ckpt-dir", str(whole), "--device", "cpu"]) == 0
    name = "step_00000020"
    assert _files(crash / name) == _files(whole / name)
    assert sorted(p.name for p in crash.iterdir()) == sorted(p.name for p in whole.iterdir())


@pytest.mark.subprocess_mesh
def test_restart_after_injected_failure(tmp_path):
    """Worker crashes at step 12; the supervisor restarts it; the run
    completes from the last committed checkpoint (the port of
    ``tests/test_checkpoint.py::test_restart_after_injected_failure``)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.supervisor", "--retries", "2", "--",
           sys.executable, "-m", "repro_torch.launch.train", *RUN,
           "--ckpt-dir", str(tmp_path / "run"), "--fail-at", "12", "--device", "cpu"]
    p = subprocess.run(cmd, capture_output=True, text=True, env=_env(), cwd=ROOT,
                       timeout=240)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-2000:]
    assert "failure-injection" in p.stdout
    assert "[resume] restored step 10" in p.stdout
    assert "[done] 20 steps" in p.stdout
    assert "[supervisor] worker exited 17; restarting" in p.stdout
    assert "[supervisor] worker finished (attempt 1)" in p.stdout


# --- the supervisor against the reference's ---------------------------------------

def _workers(tmp: Path) -> dict[str, tuple[list[str], list[str]]]:
    """name -> (supervisor flags, worker command)."""
    once = ("import pathlib, sys; m = pathlib.Path(sys.argv[1]); print('work', flush=True); "
            "sys.exit(0 if m.exists() else (m.touch() or 17))")
    return {
        "crash_once": (["--retries", "2"], [sys.executable, "-c", once, str(tmp / "marker")]),
        "always_fails": (["--retries", "1"],
                         [sys.executable, "-c", "print('no', flush=True); raise SystemExit(3)"]),
        "straggler": (["--retries", "0", "--heartbeat-timeout", "1"],
                      [sys.executable, "-c", "import time; time.sleep(30)"]),
    }


@pytest.mark.parametrize("worker", ["crash_once", "always_fails", "straggler"])
def test_supervisor_matches_reference(worker, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    runs = {}
    for name, module in (("ref", ref_supervisor), ("mine", supervisor)):
        d = tmp_path / name
        d.mkdir()
        flags, cmd = _workers(d)[worker]
        rc = module.main(flags + ["--"] + cmd)
        runs[name] = (rc, capsys.readouterr().out)
    assert runs["mine"] == runs["ref"]
    rc, out = runs["mine"]
    want = {"crash_once": (0, "[supervisor] worker finished (attempt 1)"),
            "always_fails": (1, "[supervisor] worker exited 3; giving up"),
            "straggler": (1, "killing straggler")}[worker]
    assert rc == want[0] and want[1] in out
