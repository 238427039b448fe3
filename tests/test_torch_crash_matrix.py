"""The crash-script harness of the port (``repro_torch.api.faults``:
``run_crash_script``, ``snapshot_dir``, ``check_crash_invariants``,
``abandon``) against the JAX package's: the port places the same
``file.*`` and ``objstore.*`` crashpoints, and for every one of them the
script of ``tests/test_crash_matrix.py`` stops at the same op in both
packages with the same ``CrashRun`` and leaves the same directory; the
port's store reopened on that copy honours the post-crash contract
(``check_crash_invariants == []``)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.api import faults as ref_faults
import repro.api.objectstore  # noqa: F401 - registers the reference's objstore.* points
from repro_torch.api import config, faults
from repro_torch.api import objectstore  # noqa: F401 - registers the port's objstore.* points
from test_torch_lifecycle import disk_bytes, time_limit

torch.set_num_threads(1)
_limit = time_limit(30)

PKGS = {"ref": (ref_api, ref_faults), "port": (config, faults)}


def _data(size, seed):
    return bytes(np.random.default_rng(seed).integers(0, 256, size, np.uint8))


def script():
    """The 7-op script of tests/test_crash_matrix.py (about 120 KB a stream)."""
    d1 = _data(120_000, 1)
    d2 = d1[:60_000] + _data(20_000, 2) + d1[60_000:]
    d3 = _data(90_000, 3)
    return d1, [("ingest", "a", d1), ("ingest", "b", d2), ("delete", "a"),
                ("collect",), ("compact",), ("ingest", "c", d3), ("flush",)]


def build(which, backend, root, injector=None, device="cpu"):
    pkg = PKGS[which][0]
    args = {"path": str(root)}
    if injector is not None:
        args["faults"] = injector
    cfg = pkg.DedupConfig.from_dict({"detector": "finesse", "backend": backend,
                                     "backend_args": args})
    return pkg.build_store(cfg, device=device) if which == "port" else pkg.build_store(cfg)


def crash_once(which, backend, point, tmp_path, device="cpu"):
    """Arm ``point``, run the script to the crash, snapshot, reopen the
    snapshot: (run, snapshot bytes, invariant violations)."""
    F = PKGS[which][1]
    root, snap = tmp_path / which / "store", tmp_path / which / "snap"
    inj = F.FaultInjector()
    store = build(which, backend, root, inj, device)
    train, ops = script()
    store.fit([train])
    inj.arm(point, 1)
    run = F.run_crash_script(store, ops)
    F.snapshot_dir(root, snap)
    F.abandon(store)
    on_disk = disk_bytes(snap)
    reopened = build(which, backend, snap, device=device)
    errors = F.check_crash_invariants(reopened, run)
    reopened.close()
    return run, on_disk, errors


FILE_POINTS = sorted(p for p in faults.registered_crashpoints() if p.startswith("file."))
OBJ_POINTS = sorted(p for p in faults.registered_crashpoints() if p.startswith("objstore."))


def test_same_crashpoints_as_the_reference():
    assert faults.registered_crashpoints() == ref_faults.registered_crashpoints()
    assert len(FILE_POINTS) == 7 and len(OBJ_POINTS) == 8


@pytest.mark.parametrize("point", FILE_POINTS + OBJ_POINTS)
def test_crash_run_matches_reference(point, tmp_path):
    backend = "file" if point.startswith("file.") else "objectstore"
    ref_run, ref_disk, ref_errors = crash_once("ref", backend, point, tmp_path)
    run, disk, errors = crash_once("port", backend, point, tmp_path)
    assert run.crashed_at == ref_run.crashed_at == point
    assert dataclasses.asdict(run) == dataclasses.asdict(ref_run)
    assert disk == ref_disk
    assert errors == ref_errors == []


def test_unarmed_script_runs_to_its_end(tmp_path):
    inj = faults.FaultInjector()
    store = build("port", "file", tmp_path / "s", inj)
    train, ops = script()
    store.fit([train])
    run = faults.run_crash_script(store, ops)
    assert run.crashed_at is None and run.pending is None
    assert inj.fired == [] and inj.hits
    assert sorted(run.committed) == ["a", "b", "c"] and run.deleted == {"a"}
    assert store.scrub().clean
    store.close()


def test_check_crash_invariants_sees_a_resurrection(tmp_path):
    """A stream the run says was deleted but that still restores is a
    violation, as in the reference."""
    store = build("port", "file", tmp_path / "s")
    train, ops = script()
    store.fit([train])
    run = faults.run_crash_script(store, ops[:2])
    run.deleted.add("a")
    (msg,) = faults.check_crash_invariants(store, run)
    assert "resurrected" in msg
    store.close()
