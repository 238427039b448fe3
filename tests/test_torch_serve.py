"""The port's multi-tenant server (``repro_torch.api.serve``,
``config.build_server``) against the JAX package's ``repro.api.serve``:
each server case of ``tests/test_serve.py`` runs through both packages on
stores built from one dict, and what comes out (results, typed errors,
tenant stats, breaker transitions, the server's metric families) must be
equal. Added: a deadline that expires between extract and the backend
writes of a CARD commit leaves the detector index, the stats and the
backend as they were; metric shards of the worker threads are counted
after ``close()``; and the hypothesis property of
``tests/test_serve_property.py``, where one op sequence must give equal
charges in both packages, neither drifting from ``StoreStats``.

Data is made from a seed and crosses between the packages as bytes."""
import dataclasses
import json
import random
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from pathlib import Path

from repro import api as ref_api
from repro.api import concurrency as ref_concurrency
from repro.api import faults as ref_faults
from repro.api import objectstore as ref_objectstore
from repro.api import observe as ref_observe
from repro.api import serve as ref_serve
from repro.data import workloads as ref_workloads
from repro_torch import api
from repro_torch.api import concurrency, config, faults, objectstore, observe, serve
from repro_torch.data import workloads
from test_torch_lifecycle import time_limit

torch.set_num_threads(1)

_limit = time_limit(30, test_tenant_byte_charges_equal_the_reference_and_never_drift=120,
                    test_chip_smoke_serve_steps_equal_the_reference=240)

JOIN_S = 10.0
PKGS = {
    "port": types.SimpleNamespace(api=api, serve=serve, conc=concurrency, faults=faults,
                                  build=lambda d: config.build_store(
                                      config.DedupConfig.from_dict(d), device="cpu"),
                                  build_server=lambda d: config.build_server(
                                      config.DedupConfig.from_dict(d), device="cpu")),
    "ref": types.SimpleNamespace(api=ref_api, serve=ref_serve, conc=ref_concurrency,
                                 faults=ref_faults,
                                 build=lambda d: ref_api.build_store(
                                     ref_api.DedupConfig.from_dict(d)),
                                 build_server=lambda d: ref_api.build_server(
                                     ref_api.DedupConfig.from_dict(d))),
}


def _obj_server(pkg, tmp_path, side, *, latency=0.0, fault_hook=None, max_retries=2,
                tenant=None, workers=4, max_object_bytes=None, breaker=None,
                avg_chunk=None):
    backend_args = {"path": str(tmp_path / f"{side}-obj"), "latency": latency,
                    "fault_hook": fault_hook, "max_retries": max_retries,
                    "cache_bytes": 1}
    if max_object_bytes is not None:
        backend_args["max_object_bytes"] = max_object_bytes
    d = {"detector": "dedup-only", "backend": "objectstore", "backend_args": backend_args}
    if avg_chunk is not None:
        d["chunker_args"] = {"avg_size": avg_chunk}
    return pkg.serve.DedupServer(pkg.build(d), workers=workers, breaker=breaker,
                                 default_tenant=tenant or pkg.serve.TenantConfig())


def _payload(n, seed=0):
    return random.Random(seed).randbytes(n)


def _outcome(fn, *args, **kwargs):
    """A call's result, or its error's type name (compared across packages)."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:     # noqa: BLE001 - the type is the outcome
        return type(e).__name__


def _server_families(srv) -> dict:
    om = __import__(type(srv).__module__.rsplit(".", 1)[0] + ".observe",
                    fromlist=["parse_prometheus_text"])
    parsed = om.parse_prometheus_text(srv.store.metrics().to_prometheus())
    return {(n, tuple(sorted(lb.items()))): v for n, lb, v in parsed["samples"]
            if n.startswith(("repro_server_", "repro_tenant_"))}


def both(case, tmp_path):
    """Run ``case(pkg, side, tmp_path)`` for each package; the records must
    be equal. Returns the port's."""
    got = {side: case(pkg, side, tmp_path) for side, pkg in PKGS.items()}
    assert got["port"] == got["ref"]
    return got["port"]


# --- directed server behaviour ------------------------------------------------------

def test_namespace_isolation_and_roundtrip(tmp_path):
    def case(pkg, side, tmp_path):
        srv = _obj_server(pkg, tmp_path, side)
        try:
            data_a, data_b = b"alpha" * 4000, b"bravo" * 4000
            ra, rb = srv.ingest("a", data_a), srv.ingest("b", data_b)
            rec = [srv.restore("a", ra.handle) == data_a,
                   srv.restore_range("b", rb.handle, 10, 25) == data_b[10:35],
                   _outcome(srv.restore, "a", rb.handle),
                   _outcome(srv.delete, "b", ra.handle),
                   _outcome(srv.delete, "a", ra.handle) >= 0,
                   _outcome(srv.restore, "a", ra.handle),
                   srv.tenant_stats("a"), srv.tenant_stats("b"), srv.tenants()]
            assert rec[2] == rec[3] == rec[5] == "KeyError" and all(rec[:2])
            return rec + [_server_families(srv)]
        finally:
            srv.close(close_store=True)
    both(case, tmp_path)


def test_quota_admission_and_settlement(tmp_path):
    def case(pkg, side, tmp_path):
        srv = _obj_server(pkg, tmp_path, side,
                          tenant=pkg.serve.TenantConfig(quota_bytes=64 << 10))
        try:
            rep = srv.ingest("t", b"q" * 4000)
            s1 = srv.tenant_stats("t")
            assert s1["bytes_stored"] == rep.bytes_stored <= 4000 and s1["reserved"] == 0
            rep2 = srv.ingest("t", b"q" * 4000)
            assert rep2.bytes_stored < 4000
            err = _outcome(srv.ingest, "t", _payload(80 << 10))
            s2 = srv.tenant_stats("t")
            assert err == "QuotaExceededError" and s2["shed"] == {"quota": 1}
            srv.delete("t", rep.handle)
            srv.delete("t", rep2.handle)
            s3 = srv.tenant_stats("t")
            assert s3["bytes_stored"] == 0
            return [rep.bytes_stored, rep2.bytes_stored, s1, s2, s3, err,
                    _server_families(srv)]
        finally:
            srv.close(close_store=True)
    both(case, tmp_path)


def test_admission_sheds_overload_when_queue_full(tmp_path):
    def case(pkg, side, tmp_path):
        gate, armed = threading.Event(), threading.Event()

        def hook(op, key, n):
            if armed.is_set() and op == "get":
                gate.wait(JOIN_S)
            return None

        srv = _obj_server(pkg, tmp_path, side, fault_hook=hook,
                          tenant=pkg.serve.TenantConfig(max_inflight=1, max_queue=1))
        try:
            data = _payload(30000, seed=3)
            rep = srv.ingest("t", data)
            armed.set()
            f1 = srv.submit("t", "restore", rep.handle)
            f2 = srv.submit("t", "restore", rep.handle)
            with pytest.raises(pkg.serve.OverloadError) as ei:
                srv.submit("t", "restore", rep.handle)
            shed = srv.tenant_stats("t")["shed"]
            armed.clear()
            gate.set()
            ok = [f1.result(JOIN_S) == data, f2.result(JOIN_S) == data]
            text = srv.store.metrics().to_prometheus()
            assert 'repro_tenant_shed_total{reason="overload",tenant="t"} 1' in text
            return [ei.value.pending, ei.value.limit, shed, ok, _server_families(srv)]
        finally:
            gate.set()
            srv.close(close_store=True)
    assert both(case, tmp_path)[:3] == [2, 2, {"overload": 1}]


def test_deadline_expiry_mid_restore_is_typed_and_prompt(tmp_path):
    def case(pkg, side, tmp_path):
        srv = _obj_server(pkg, tmp_path, side, latency=0.03, max_object_bytes=8192,
                          avg_chunk=2048)
        try:
            data = _payload(256 << 10, seed=5)
            rep = srv.ingest("t", data)
            t0 = time.perf_counter()
            err = _outcome(srv.restore, "t", rep.handle, timeout=0.06)
            assert time.perf_counter() - t0 < 2.0
            return [err, srv.tenant_stats("t")["shed"], srv.restore("t", rep.handle) == data]
        finally:
            srv.close(close_store=True)
    assert both(case, tmp_path) == ["DeadlineExceededError", {"deadline": 1}, True]


def test_deadline_expiry_sheds_commit_before_writes(tmp_path):
    def case(pkg, side, tmp_path):
        srv = _obj_server(pkg, tmp_path, side, latency=0.02)
        try:
            before = srv.store.stats.bytes_stored
            err = _outcome(srv.ingest, "t", _payload(256 << 10, seed=7), timeout=1e-4)
            s = srv.tenant_stats("t")
            return [err, srv.store.stats.bytes_stored == before, s["bytes_stored"],
                    s["reserved"]]
        finally:
            srv.close(close_store=True)
    assert both(case, tmp_path) == ["DeadlineExceededError", True, 0, 0]


def test_store_restore_respects_ambient_deadline_scope(tmp_path):
    def case(pkg, side, tmp_path):
        srv = _obj_server(pkg, tmp_path, side, latency=0.02, max_object_bytes=8192)
        try:
            rep = srv.ingest("t", _payload(96 << 10, seed=9))
            with pkg.conc.deadline_scope(0.01):
                return _outcome(srv.store.restore, rep.handle)
        finally:
            srv.close(close_store=True)
    assert both(case, tmp_path) == "DeadlineExceededError"


def test_tenant_cache_serves_repeat_restores_without_backend_io(tmp_path):
    def case(pkg, side, tmp_path):
        srv = _obj_server(pkg, tmp_path, side,
                          tenant=pkg.serve.TenantConfig(cache_bytes=4 << 20))
        try:
            data = _payload(40000, seed=11)
            rep = srv.ingest("t", data)
            assert srv.restore("t", rep.handle) == data
            gets = srv.store.backend.client.op_counts.get("get", 0)
            assert srv.restore("t", rep.handle) == data
            same = srv.store.backend.client.op_counts.get("get", 0) == gets
            stats = srv.tenant_stats("t")
            srv.delete("t", rep.handle)
            return [same, stats, srv.tenant_stats("t")["cache_hits"],
                    _outcome(srv.restore, "t", rep.handle), _server_families(srv)]
        finally:
            srv.close(close_store=True)
    rec = both(case, tmp_path)
    assert rec[0] and rec[1]["cache_hits"] == 1 == rec[2] and rec[3] == "KeyError"


def breaker_drill(pkg, srv, handle: int, data: bytes, storm: threading.Event) -> list:
    """Open the breaker with two failed restores, see writes shed while it
    is open, wait out the cooldown, let a restore probe close it, write
    again. Returns the outcomes and the transitions."""
    out = []
    storm.set()
    for _ in range(2):
        out.append(_outcome(srv.restore, "t", handle))
    out.append(srv.breaker.state())
    out.append(_outcome(srv.ingest, "t", b"rejected"))
    out.append(_outcome(srv.delete, "t", handle))
    time.sleep(srv.breaker.cooldown_seconds + 0.01)
    storm.clear()
    out.append(srv.restore("t", handle) == data)
    out.append(srv.breaker.state())
    out.append(dict(srv.breaker.transitions))
    out.append(type(_outcome(srv.ingest, "t", b"writable again")).__name__)
    out.append(srv.tenant_stats("t")["shed"])
    return out


def test_breaker_opens_gates_writes_and_recovers(tmp_path):
    def case(pkg, side, tmp_path):
        storm = threading.Event()

        def hook(op, key, n):
            if storm.is_set() and op == "get":
                return pkg.faults.TransientError(503, f"storm {op} #{n}")
            return None

        breaker = pkg.serve.CircuitBreaker(fail_threshold=2, window_seconds=5.0,
                                           cooldown_seconds=0.05, probe_successes=1)
        srv = _obj_server(pkg, tmp_path, side, fault_hook=hook, max_retries=0,
                          breaker=breaker)
        try:
            data = b"stormy" * 3000
            rep = srv.ingest("t", data)
            out = breaker_drill(pkg, srv, rep.handle, data, storm)
            text = srv.store.metrics().to_prometheus()
            for to in ("open", "half_open", "closed"):
                assert f'repro_server_breaker_transitions_total{{to="{to}"}} 1' in text
            assert "repro_server_breaker_state 0" in text
            return out + [_server_families(srv)]
        finally:
            srv.close(close_store=True)
    rec = both(case, tmp_path)
    assert rec[:9] == ["TransientError", "TransientError", "open", "CircuitOpenError",
                       "CircuitOpenError", True, "closed",
                       {"closed": 1, "half_open": 1, "open": 1}, "IngestReport"]
    assert rec[9]["circuit"] == 2


def test_breaker_halfopen_failure_reopens():
    def case(pkg, side, tmp_path):
        t = [0.0]
        br = pkg.serve.CircuitBreaker(fail_threshold=1, cooldown_seconds=10.0,
                                      probe_successes=2, clock=lambda: t[0])
        seen = []
        br.record_failure()
        seen.append(br.state())
        for now, event in ((11.0, None), (11.0, "failure"), (22.0, None),
                           (22.0, "success"), (22.0, "success")):
            t[0] = now
            if event == "failure":
                br.record_failure()
            elif event == "success":
                br.record_success()
            seen.append(br.state())
        return seen + [br.transitions]
    rec = both(case, None)
    assert rec[:6] == ["open", "half_open", "open", "half_open", "half_open", "closed"]


def test_submit_rejects_unknown_op_and_closed_server(tmp_path):
    def case(pkg, side, tmp_path):
        srv = _obj_server(pkg, tmp_path, side)
        out = [_outcome(srv.submit, "t", "scrub")]
        srv.close(close_store=True)
        out.append(_outcome(srv.submit, "t", "restore", 0))
        srv.close()
        return out
    assert both(case, tmp_path) == ["ValueError", "RuntimeError"]


def test_build_server_from_config(tmp_path):
    def case(pkg, side, tmp_path):
        srv = pkg.build_server({
            "detector": "dedup-only", "backend": "objectstore",
            "backend_args": {"path": str(tmp_path / f"{side}-o")}, "server_workers": 2,
            "tenant_args": {"quota_bytes": 1 << 20, "max_inflight": 3}})
        try:
            assert type(srv).__name__ == "DedupServer"
            assert type(srv).__module__ == f"{pkg.serve.__name__}"
            rep = srv.ingest("t", b"configured" * 100)
            return [srv.restore("t", rep.handle) == b"configured" * 100,
                    srv.tenant_stats("t"), srv._pool._max_workers,
                    dataclasses.asdict(srv._default_cfg)]
        finally:
            srv.close(close_store=True)
    rec = both(case, tmp_path)
    assert rec[0] and rec[1]["quota_bytes"] == 1 << 20 and rec[2] == 2


def test_worker_metric_shards_count_after_close(tmp_path):
    """Requests served by the pool's threads: a snapshot taken after
    ``close()`` counts every worker's shard, as the reference's does."""
    def case(pkg, side, tmp_path):
        srv = _obj_server(pkg, tmp_path, side, workers=4)
        datas = [_payload(20000 + 1000 * i, seed=20 + i) for i in range(6)]
        futs = [srv.submit(f"t{i % 2}", "ingest", d) for i, d in enumerate(datas)]
        reps = [f.result(JOIN_S) for f in futs]
        futs = [srv.submit(f"t{i % 2}", "restore", r.handle) for i, r in enumerate(reps)]
        assert [f.result(JOIN_S) for f in futs] == datas
        srv.close()
        fams = _server_families(srv)
        snap = srv.store.metrics().snapshot()
        commits = snap["repro_ingest_commits_total"]["samples"][0]["value"]
        restores = {s["labels"]["surface"]: s["value"]
                    for s in snap["repro_restore_ops_total"]["samples"]}
        srv.store.close()
        return [commits, restores, fams]
    rec = both(case, tmp_path)
    assert rec[0] == 6 and rec[1]["full"] == 6
    assert rec[2][("repro_server_requests_total", (("op", "ingest"), ("outcome", "ok")))] == 6


# --- a deadline between extract and the backend writes --------------------------------

CARD_DICT = {"detector": "card", "chunker_args": {"avg_size": 4096},
             "detector_args": {"feat": {"k": 16, "m": 64, "n": 2},
                               "model": {"m": 64, "d": 50, "steps": 20},
                               "use_kernel": False}}


def test_deadline_mid_commit_leaves_the_detector_index_unchanged():
    """A CARD commit whose deadline runs out after score (the pass-3a probe
    fires before any backend write) raises ``DeadlineExceededError`` in
    both packages; the detector index, the digest table, the stats and the
    backend's records stay as they were, and the next ingest of the same
    stream is the reference's."""
    base = _payload(96 << 10, seed=30)
    nxt = base[:50_000] + _payload(4000, seed=31) + base[50_000:]
    got = {}
    for side, pkg in PKGS.items():
        store = pkg.build(CARD_DICT)
        store.fit([base])
        store.ingest(base)
        det = store.detector
        rows = len(det.index)
        feats = np.array(det.index._buf[:rows])
        chunk_ids = sorted(store.backend.chunk_ids())
        stats = dataclasses.asdict(store.stats)
        score = det.score

        def slow_score(f, batch, score=score):
            out = score(f, batch)
            time.sleep(0.05)            # the deadline expires here
            return out

        det.score = slow_score
        with pkg.conc.deadline_scope(0.02):
            err = _outcome(store.ingest, nxt)
        det.score = score
        assert err == "DeadlineExceededError"
        assert len(det.index) == rows
        assert np.array_equal(np.array(det.index._buf[:rows]), feats)
        assert sorted(store.backend.chunk_ids()) == chunk_ids
        assert dataclasses.asdict(store.stats) == stats
        assert len(store.reports) == 1 and len(store.digest_seeds()) == len(chunk_ids)
        rep = store.open_stream()
        rep.write(nxt)
        rep = rep.commit()
        got[side] = [rows, len(chunk_ids), rep.chunks, rep.dup_chunks, rep.delta_chunks,
                     rep.raw_chunks, rep.bytes_stored, len(det.index),
                     store.restore(rep.handle) == nxt]
        store.close()
    assert got["port"] == got["ref"]


# --- the quota property -------------------------------------------------------------

_PAYLOADS = [bytes([65 + i]) * (1500 + 977 * i) for i in range(6)]
_OPS = st.lists(st.tuples(st.integers(0, 2), st.sampled_from(["ingest", "delete", "compact"]),
                          st.integers(0, 5)), min_size=1, max_size=24)


def _charges(pkg, ops) -> list:
    store = pkg.build({"detector": "dedup-only", "backend": "memory"})
    srv = pkg.serve.DedupServer(store, workers=2)
    live = {0: [], 1: [], 2: []}
    trail = []
    try:
        for tidx, kind, pidx in ops:
            tenant = f"t{tidx}"
            if kind == "ingest":
                rep = srv.ingest(tenant, _PAYLOADS[pidx])
                live[tidx].append((rep.handle, _PAYLOADS[pidx], rep.bytes_stored))
            elif kind == "delete":
                if not live[tidx]:
                    continue
                handle, _, _ = live[tidx].pop(pidx % len(live[tidx]))
                srv.delete(tenant, handle)
            else:
                store.collect()
                store.compact()
            stats = [srv.tenant_stats(f"t{i}") for i in range(3)]
            assert sum(s["bytes_ingested"] for s in stats) == store.stats.bytes_stored
            for i in range(3):
                assert stats[i]["bytes_stored"] == sum(c for _, _, c in live[i])
            trail.append([(s["bytes_stored"], s["bytes_ingested"], s["streams"])
                          for s in stats])
        for i in range(3):
            for handle, data, _ in live[i]:
                assert srv.restore(f"t{i}", handle) == data
    finally:
        srv.close(close_store=True)
    return trail


@settings(max_examples=20, deadline=None)
@given(ops=_OPS)
def test_tenant_byte_charges_equal_the_reference_and_never_drift(ops):
    """After every op of any ingest / delete / compact interleaving, each
    package's tenant charges match its own ``StoreStats`` and live handles,
    and the two packages' charges are equal."""
    assert _charges(PKGS["port"], ops) == _charges(PKGS["ref"], ops)


# --- the slice as a whole: chip_smoke.py's phase serve on the CPU ---------------------

def _port_cli(argv):
    extra = ["--device", "cpu"] if argv[0] in ("cp", "verify", "scrub") else []
    return objectstore.main([*argv, *extra])


ENVS = {
    "port": types.SimpleNamespace(
        build_server=PKGS["port"].build_server, build_store=PKGS["port"].build,
        serve=serve, faults=faults, parse=observe.parse_prometheus_text,
        dump=observe.main, cli=_port_cli),
    "ref": types.SimpleNamespace(
        build_server=PKGS["ref"].build_server, build_store=PKGS["ref"].build,
        serve=ref_serve, faults=ref_faults, parse=ref_observe.parse_prometheus_text,
        dump=ref_observe.main, cli=ref_objectstore.main),
}


def test_chip_smoke_serve_steps_equal_the_reference(tmp_path, capsys):
    """chip_smoke.py's phase serve (``serve_steps``: the interleaved
    tenants, concurrent restores, typed sheds, deletes, metrics and spans
    after close, the breaker drill, the CLI roots), run by both packages on
    the CPU at 512 KiB x 4 versions: every number the card is held to
    (scripts/serve_dcr.py prints the reference's at 32 MiB) is equal."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    cfg = workloads.WorkloadConfig(base_size=512 << 10, versions=4)
    versions = {n: workloads.make_workload(n, cfg) for n in ("sql_dump", "vmdk")}
    ref_cfg = ref_workloads.WorkloadConfig(base_size=512 << 10, versions=4)
    assert versions == {n: ref_workloads.make_workload(n, ref_cfg) for n in versions}
    got = {}
    for side, env in ENVS.items():
        root = tmp_path / side
        root.mkdir()
        pinned, measured = chip_smoke.serve_steps(env, versions, str(root))
        got[side] = json.loads(json.dumps(pinned))
        assert measured["dump_lines"] > measured["trace_lines"] > 0
    capsys.readouterr()
    assert got["port"] == got["ref"]
    assert got["port"]["quota"] == "QuotaExceededError"
    assert got["port"]["overload"] == "OverloadError"
    assert got["port"]["spans"] == {"ingest": 10, "restore": 10, "gc.delete": 2}
