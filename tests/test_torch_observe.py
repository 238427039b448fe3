"""Observability of the port (``repro_torch.api.observe``, the store's
``metrics()`` / ``cache_stats()`` and spans, the backends'
``bind_observability``, the reclamation and scrub recorders) against the
JAX package's ``repro.api.observe``: each case of ``tests/test_observe.py``
runs through both packages (``side`` ``port`` and ``ref``), and the
comparisons hold the two to each other. A deterministic registry exports
byte-identical Prometheus text and JSON; the strict parsers accept and
reject the same inputs; stores built from one dict on the memory, file
and objectstore backends export the same families, label sets, counters,
gauges and histogram counts after ingest, restore, gc and scrub (seconds
left out); ``dump`` prints the same lines with the timings masked.

Left out: ``test_bench_helpers_zero_division_guards``, which tests
``benchmarks/common.py``; the benchmarks are not ported."""
import gc
import json
import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.api import concurrency as ref_concurrency
from repro.api import observe as ref_observe
from repro_torch import api
from repro_torch.api import concurrency, config, observe
from test_torch_lifecycle import time_limit

torch.set_num_threads(1)

_limit = time_limit(20)

SIDES = {"port": (observe, concurrency), "ref": (ref_observe, ref_concurrency)}
side_param = pytest.mark.parametrize("side", sorted(SIDES))


def _bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8).tobytes()


# --- registry basics ------------------------------------------------------------

def _fill(om):
    """The registry of tests/test_observe.py's round-trip case, built in a
    fixed order: its exports depend on nothing but the calls."""
    reg = om.MetricsRegistry()
    reg.counter("repro_t_ops_total", "ops", labels={"op": "get"}).inc()
    reg.counter("repro_t_ops_total", "ops", labels={"op": "get"}).inc(4)
    reg.counter("repro_t_ops_total", "ops", labels={"op": "put"}).inc(2)
    reg.gauge("repro_t_depth", "queue depth").set(7)
    h = reg.histogram("repro_t_lat_seconds", "latency", bounds=om.SECONDS_BUCKETS)
    for v in (1e-6, 0.001, 0.5, 100.0):
        h.observe(v)
    reg.counter("repro_t_esc_total", 'help with "quotes"\nand newline',
                labels={"path": 'a\\b"c\nd'}).inc(3)
    reg.histogram("repro_t_w", "", bounds=om.log2_bounds(0, 3)).observe(3.0)
    return reg


@side_param
def test_counter_gauge_histogram_roundtrip(side):
    om, _ = SIDES[side]
    snap = _fill(om).snapshot()
    by_label = {tuple(sorted(s["labels"].items())): s["value"]
                for s in snap["repro_t_ops_total"]["samples"]}
    assert by_label == {(("op", "get"),): 5, (("op", "put"),): 2}
    assert snap["repro_t_depth"]["samples"][0]["value"] == 7
    hist = snap["repro_t_lat_seconds"]["samples"][0]
    assert hist["count"] == 4 and hist["sum"] == pytest.approx(100.501001)
    assert sum(n for _, n in hist["buckets"]) == hist["count"]


def test_exports_are_byte_identical():
    """The same calls give the same Prometheus text and the same JSON."""
    mine, ref = _fill(observe), _fill(ref_observe)
    assert mine.to_prometheus() == ref.to_prometheus()
    assert mine.to_json() == ref.to_json()
    assert mine.snapshot() == ref.snapshot()
    assert observe.SECONDS_BUCKETS == ref_observe.SECONDS_BUCKETS
    assert observe.BYTES_BUCKETS == ref_observe.BYTES_BUCKETS
    assert observe.COUNT_BUCKETS == ref_observe.COUNT_BUCKETS
    assert observe.DEFAULT_RING_EVENTS == ref_observe.DEFAULT_RING_EVENTS


@side_param
def test_histogram_bucket_placement_and_overflow(side):
    om, _ = SIDES[side]
    reg = om.MetricsRegistry()
    h = reg.histogram("repro_t_w", "", bounds=om.log2_bounds(0, 3))
    for v in (1.0, 3.0, 999.0):
        h.observe(v)
    sample = reg.snapshot()["repro_t_w"]["samples"][0]
    got = dict(sample["buckets"])
    assert got[1.0] == 1 and got[4.0] == 1 and sample["count"] == 3


@side_param
def test_kind_and_bounds_conflicts_raise(side):
    om, _ = SIDES[side]
    reg = om.MetricsRegistry()
    reg.counter("repro_t_x_total", "")
    with pytest.raises(ValueError):
        reg.gauge("repro_t_x_total", "")
    reg.histogram("repro_t_h", "", bounds=om.COUNT_BUCKETS)
    with pytest.raises(ValueError):
        reg.histogram("repro_t_h", "", bounds=om.BYTES_BUCKETS)


@side_param
def test_derived_view_and_callback(side):
    om, _ = SIDES[side]
    reg = om.MetricsRegistry()
    state = {"n": 41}
    reg.register_callback(
        lambda: reg.counter("repro_t_view_total", "view").set_total(state["n"]))
    reg.counter("repro_t_view_total", "view").inc()
    assert reg.snapshot()["repro_t_view_total"]["samples"][0]["value"] == 42
    state["n"] = 100
    assert reg.snapshot()["repro_t_view_total"]["samples"][0]["value"] == 101


# --- concurrency: exact totals, no torn reads -------------------------------------

@side_param
def test_concurrent_counters_exact(side):
    om, _ = SIDES[side]
    reg = om.MetricsRegistry()

    def worker():
        c = reg.counter("repro_t_hammer_total", "")
        for _ in range(5_000):
            c.inc()
        reg.fold_current()

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert reg.snapshot()["repro_t_hammer_total"]["samples"][0]["value"] == 40_000


@side_param
def test_snapshot_while_hammering_is_consistent(side):
    om, _ = SIDES[side]
    reg = om.MetricsRegistry()
    stop = threading.Event()

    def hammer():
        c = reg.counter("repro_t_mono_total", "")
        h = reg.histogram("repro_t_mono_seconds", "", bounds=om.SECONDS_BUCKETS)
        while not stop.is_set():
            for _ in range(100):
                c.inc()
                h.observe(0.001)

    ts = [threading.Thread(target=hammer, daemon=True) for _ in range(4)]
    for t in ts:
        t.start()
    last_c = last_n = -1.0
    try:
        for _ in range(30):
            snap = reg.snapshot()
            if "repro_t_mono_seconds" in snap:
                [s] = snap["repro_t_mono_seconds"]["samples"]
                assert sum(n for _, n in s["buckets"]) == s["count"] >= last_n
                last_n = s["count"]
            if "repro_t_mono_total" in snap:
                [s] = snap["repro_t_mono_total"]["samples"]
                assert s["value"] >= last_c
                last_c = s["value"]
    finally:
        stop.set()
        for t in ts:
            t.join(10)
    assert last_c > 0 and last_n > 0


@side_param
def test_lock_wait_histogram_under_writer_contention(side):
    om, conc = SIDES[side]
    reg = om.MetricsRegistry()

    def obs(s, seconds):
        reg.histogram("repro_lock_wait_seconds", "", labels={"side": s},
                      bounds=om.SECONDS_BUCKETS).observe(seconds)

    lock = conc.RWLock(observer=obs)
    with lock.read():
        pass
    lock.acquire_write()
    waited = []

    def reader():
        t0 = time.perf_counter()
        with lock.read():
            waited.append(time.perf_counter() - t0)

    t = threading.Thread(target=reader)
    t.start()
    time.sleep(0.05)
    lock.release_write()
    t.join(10)
    reg.fold_current()
    samples = {s["labels"]["side"]: s
               for s in reg.snapshot()["repro_lock_wait_seconds"]["samples"]}
    assert samples["read"]["count"] == 2 and samples["write"]["count"] == 1
    assert samples["read"]["sum"] >= 0.9 * waited[0] >= 0.02


@side_param
def test_iotelemetry_fold_current_exact_and_idempotent(side):
    _, conc = SIDES[side]
    tel = conc.IoTelemetry()

    def task():
        c = tel.local()
        c.bytes_read += 100
        c.requests += 1
        tel.fold_current()
        tel.fold_current()
        c2 = tel.local()
        assert c2 is not c
        c2.bytes_read += 11
        tel.fold_current()

    t = threading.Thread(target=task)
    t.start()
    t.join(10)
    gc.collect()
    assert tel.total("bytes_read") == 111 and tel.total("requests") == 1


@side_param
def test_iotelemetry_scoped_folds_on_exit(side):
    _, conc = SIDES[side]
    tel = conc.IoTelemetry()
    seen = []

    def task():
        with tel.scoped() as c:
            c.bytes_read += 7
        seen.append(tel.total("bytes_read"))

    t = threading.Thread(target=task)
    t.start()
    t.join(10)
    assert seen == [7] and tel.total("bytes_read") == 7


@side_param
def test_registry_fold_current_from_pool_thread(side):
    om, _ = SIDES[side]
    reg = om.MetricsRegistry()
    with ThreadPoolExecutor(max_workers=1) as ex:
        def task():
            reg.counter("repro_t_pool_total", "").inc(5)
            reg.fold_current()
        ex.submit(task).result(10)
        assert reg.snapshot()["repro_t_pool_total"]["samples"][0]["value"] == 5


# --- exporters and the strict parser ------------------------------------------------

@side_param
def test_prometheus_label_escaping_roundtrip(side):
    om, _ = SIDES[side]
    text = _fill(om).to_prometheus()
    assert '\\\\b\\"c\\nd' in text
    [(_, labels, value)] = [s for s in om.parse_prometheus_text(text)["samples"]
                            if s[0] == "repro_t_esc_total"]
    assert labels == {"path": 'a\\b"c\nd'} and value == 3.0


@side_param
def test_prometheus_histogram_exposition_shape(side):
    om, _ = SIDES[side]
    reg = om.MetricsRegistry()
    h = reg.histogram("repro_t_sh_seconds", "x", bounds=om.log2_bounds(0, 2))
    h.observe(1.5)
    h.observe(10.0)
    text = reg.to_prometheus()
    assert "# TYPE repro_t_sh_seconds histogram" in text
    parsed = om.parse_prometheus_text(text)
    buckets = {lb["le"]: v for n, lb, v in parsed["samples"]
               if n == "repro_t_sh_seconds_bucket"}
    assert (buckets["2"], buckets["4"], buckets["+Inf"]) == (1.0, 1.0, 2.0)


PARSER_INPUTS = [
    "repro_x_total{le=} 1",
    "repro_x_total 1",
    "# TYPE repro_x_total counter\n9bad_name 1",
    '# TYPE repro_x_total counter\nrepro_x_total{a="b} 1',
    "# TYPE repro_x_total counter\nrepro_x_total 1",
    '# HELP repro_x h\n# TYPE repro_x gauge\nrepro_x{a="1",b="x\\"y"} -2.5',
    "# TYPE repro_h histogram\nrepro_h_bucket{le=\"1\"} 2\nrepro_h_bucket{le=\"+Inf\"} 1",
    "# TYPE repro_h histogram\nrepro_h_bucket{le=\"+Inf\"} 1\nrepro_h_count 1\nrepro_h_sum 0.5",
    "# TYPE repro_x_total counter\nrepro_x_total NaN",
    "# TYPE repro_x widget\nrepro_x 1",
]


@pytest.mark.parametrize("text", PARSER_INPUTS)
def test_parsers_accept_and_reject_alike(text):
    """The same input is accepted with the same result, or rejected with
    ``ValueError``, by both parsers."""
    outcome = []
    for om in (observe, ref_observe):
        try:
            outcome.append(om.parse_prometheus_text(text))
        except ValueError:
            outcome.append("ValueError")
    assert repr(outcome[0]) == repr(outcome[1])     # repr: NaN == NaN


@side_param
def test_json_snapshot_loads_clean(side):
    om, _ = SIDES[side]
    reg = om.MetricsRegistry()
    reg.counter("repro_t_j_total", "").inc()
    reg.histogram("repro_t_j_seconds", "", bounds=om.SECONDS_BUCKETS).observe(0.5)
    snap = json.loads(reg.to_json())
    assert snap["repro_t_j_total"]["type"] == "counter"
    [s] = snap["repro_t_j_seconds"]["samples"]
    assert s["count"] == 1 == sum(n for _, n in s["buckets"])


# --- the tracer ---------------------------------------------------------------------

@side_param
def test_tracer_ring_bound_and_sink_roundtrip(side, tmp_path):
    om, _ = SIDES[side]
    path = str(tmp_path / "t.jsonl")
    tr = om.Tracer(ring_events=4, path=path)
    for i in range(10):
        tr.record("op", 0.001, i=i)
    assert [e["i"] for e in tr.events()] == [6, 7, 8, 9]
    tr.close()
    with open(path) as f:
        sink = [json.loads(line) for line in f if line.strip()]
    assert len(sink) == 10
    assert all(e["op"] == "op" and "tid" in e and "s" in e for e in sink)


@side_param
def test_tracer_span_parent_links(side):
    om, _ = SIDES[side]
    tr = om.Tracer(ring_events=16)
    with tr.span("parent", phase="x") as labels:
        labels["extra"] = 1
    parent_id = tr.events()[-1]["id"]
    child = tr.record("parent.child", 0.5, parent=parent_id)
    events = {e["op"]: e for e in tr.events()}
    assert events["parent"]["extra"] == 1
    assert events["parent.child"]["parent"] == parent_id != child
    assert tr.ops() == {"parent": 1, "parent.child": 1}


def test_config_trace_knobs_roundtrip(tmp_path):
    d = {"detector": "dedup-only", "trace_path": str(tmp_path / "t.jsonl"),
         "trace_ring_events": 64}
    assert config.DedupConfig.from_dict(d).to_dict() == \
        ref_api.DedupConfig.from_dict(d).to_dict()
    for bad, err in (({"trace_path": 7}, TypeError), ({"trace_ring_events": -1}, ValueError)):
        for cfg_cls in (config.DedupConfig, ref_api.DedupConfig):
            with pytest.raises(err):
                cfg_cls.from_dict({"detector": "dedup-only", **bad})


# --- instrumented store paths, both packages from one dict -------------------------

def _dict(tmp_path, backend: str, side: str, **extra) -> dict:
    d = {"detector": "dedup-only", "chunker_args": {"avg_size": 4096},
         "backend": backend, "trace_ring_events": 1024, **extra}
    if backend != "memory":
        d["backend_args"] = {"path": str(tmp_path / f"{side}-{backend}"),
                             **extra.get("backend_args", {})}
    return d


def _build(side: str, d: dict):
    if side == "port":
        return config.build_store(config.DedupConfig.from_dict(d), device="cpu")
    return ref_api.build_store(ref_api.DedupConfig.from_dict(d))


def _parsed(store):
    om = observe if type(store).__module__.startswith("repro_torch") else ref_observe
    return om.parse_prometheus_text(store.metrics().to_prometheus())


def _timing(name: str) -> bool:
    return "seconds" in name


def nontiming(parsed: dict) -> dict:
    """Every sample but what a clock measured: seconds counters go, and a
    seconds histogram keeps only its ``_count``."""
    out = {}
    for name, labels, value in parsed["samples"]:
        if _timing(name) and not name.endswith("_count"):
            continue
        out[(name, tuple(sorted(labels.items())))] = value
    return out


def _families(parsed: dict) -> set:
    return {(name, tuple(sorted(k for k in labels if k != "le")))
            for name, labels, _ in parsed["samples"]}


def _drive(store, side: str) -> list:
    """ingest two streams, every restore surface (twice in full: cold,
    then warm), delete, collect, compact, scrub; returns what came out."""
    a, b = _bytes(96 << 10, 1), _bytes(64 << 10, 2)
    handles = []
    for data in (a, a[:40_000] + b, b):
        with store.open_stream() as s:
            s.write(data)
        handles.append(s.report.handle)
    out = [store.restore(handles[0]) == a, store.restore(handles[0]) == a,
           b"".join(store.restore_iter(handles[1], batch_chunks=4)) == a[:40_000] + b,
           store.restore_range(handles[2], 1000, 2000) == b[1000:3000]]
    out.append(store.delete(handles[1]))
    store.collect()
    store.compact()
    rep = store.scrub()
    out += [rep.clean, rep.verified, store.restore(handles[2]) == b]
    return out


@pytest.mark.parametrize("backend", ["memory", "file", "objectstore"])
def test_store_metrics_equal_the_reference(tmp_path, backend):
    """Families, label sets, every non-timing value and every histogram
    count are the reference's after ingest, restore, gc and scrub."""
    stores = {side: _build(side, _dict(tmp_path, backend, side)) for side in SIDES}
    try:
        outs = {side: _drive(store, side) for side, store in stores.items()}
        assert outs["port"] == outs["ref"]
        parsed = {side: _parsed(store) for side, store in stores.items()}
        assert parsed["port"]["types"] == parsed["ref"]["types"]
        assert _families(parsed["port"]) == _families(parsed["ref"])
        assert nontiming(parsed["port"]) == nontiming(parsed["ref"])
        assert stores["port"].cache_stats() == stores["ref"].cache_stats()
        assert stores["port"].observe.tracer.ops() == stores["ref"].observe.tracer.ops()
        ops = stores["port"].observe.tracer.ops()
        for op in ("ingest", "restore", "gc.delete", "gc.collect", "gc.compact", "scrub"):
            assert ops.get(op, 0) >= 1, op
    finally:
        for store in stores.values():
            store.close()


@side_param
def test_ingest_metrics_and_spans(side, tmp_path):
    store = _build(side, _dict(tmp_path, "file", side))
    with store.open_stream() as s:
        s.write(_bytes(64 << 10, 3))
    parsed = _parsed(store)
    assert parsed["types"]["repro_ingest_stage_seconds"] == "histogram"
    assert parsed["types"]["repro_ingest_commits_total"] == "counter"
    assert parsed["types"]["repro_store_dcr"] == "gauge"
    stages = {lb["stage"] for n, lb, v in parsed["samples"]
              if n == "repro_ingest_stage_seconds_count" and v >= 1}
    assert stages == {"chunk", "extract", "score", "observe", "delta", "store"}
    ops = store.observe.tracer.ops()
    assert ops["ingest"] == 1 and all(ops[f"ingest.{s}"] == 1 for s in stages)
    store.close()


@side_param
def test_restore_metrics_cache_hits_and_spans(side, tmp_path):
    store = _build(side, _dict(tmp_path, "file", side))
    data = _bytes(64 << 10, 4)
    with store.open_stream() as s:
        s.write(data)
    h = s.report.handle
    assert store.restore(h) == data and store.restore(h) == data
    parsed = _parsed(store)
    by = {(n, tuple(sorted(lb.items()))): v for n, lb, v in parsed["samples"]}
    assert by[("repro_restore_ops_total", (("surface", "full"),))] == 2
    assert by[("repro_reader_cache_lookups_total", (("outcome", "hit"),))] > 0
    ops = store.observe.tracer.ops()
    for op in ("restore", "restore.plan", "restore.read", "restore.decode",
               "restore.prefetch"):
        assert ops[op] == 2, op
    restores = [e for e in store.observe.tracer.events() if e["op"] == "restore"]
    assert restores[-1]["hit_ratio"] > 0 and restores[-1]["surface"] == "full"
    store.close()


@side_param
def test_gc_metrics_and_spans(side, tmp_path):
    store = _build(side, _dict(tmp_path, "file", side))
    for seed in (5, 6):
        with store.open_stream() as s:
            s.write(_bytes(48 << 10, seed))
    store.delete(s.report.handle)
    store.collect()
    store.compact()
    parsed = _parsed(store)
    phases = {lb["phase"] for n, lb, v in parsed["samples"]
              if n == "repro_gc_phase_seconds_count" and v >= 1}
    assert {"delete", "collect", "compact", "compact.sizing", "compact.rewrite"} <= phases
    assert {n: v for n, lb, v in parsed["samples"] if not lb}["repro_gc_freed_bytes_total"] > 0
    store.close()


@side_param
def test_tracing_disabled_by_default(side, tmp_path):
    store = _build(side, {"detector": "dedup-only", "chunker_args": {"avg_size": 4096}})
    assert store.observe.tracer is None
    with store.open_stream() as s:
        s.write(_bytes(16 << 10, 7))
    assert store.restore(s.report.handle)
    assert "repro_ingest_commits_total" in store.metrics().snapshot()
    store.close()


def test_objectstore_retry_metrics_equal_the_reference(tmp_path):
    """A GET fault schedule through a reopened objectstore store: retries,
    backoff, per-op request counts and retry spans, alike in both."""
    got = {}
    for side in SIDES:
        pkg = api if side == "port" else ref_api
        d = _dict(tmp_path, "objectstore", side)
        store = _build(side, d)
        data = _bytes(64 << 10, 8)
        with store.open_stream() as s:
            s.write(data)
        h = s.report.handle
        store.close()
        d["backend_args"].update(fault_hook=pkg.FaultSchedule({"get": list(range(1, 64, 2))}),
                                 retry_backoff=0.001)
        store = _build(side, d)
        assert store.restore(h) == data and store.backend.retries >= 1
        parsed = _parsed(store)
        by = nontiming(parsed)
        assert by[("repro_objstore_retries_total", ())] == store.backend.retries
        assert {n: v for n, lb, v in parsed["samples"]}[
            "repro_objstore_backoff_seconds_total"] > 0
        spans = [e for e in store.observe.tracer.events() if e["op"] == "objstore.retry"]
        assert spans and spans[0]["client_op"] == "get"
        got[side] = (by, len(spans), [e["attempt"] for e in spans])
        store.close()
    assert got["port"] == got["ref"]


@side_param
def test_reader_run_shape_histograms(side, tmp_path):
    d = _dict(tmp_path, "file", side)
    store = _build(side, d)
    with store.open_stream() as s:
        s.write(_bytes(96 << 10, 9))
    h = s.report.handle
    store.close()
    store = _build(side, d)
    assert store.restore(h)
    by = {n: v for n, lb, v in _parsed(store)["samples"] if n.endswith("_count")}
    assert by["repro_reader_run_bytes_count"] >= 1
    assert by["repro_reader_run_extents_count"] >= 1
    store.close()


def test_verified_read_counts_a_corrupt_chunk_alike(tmp_path):
    """A flipped payload bit on the file backend: both packages raise
    ``CorruptChunkError`` and count it in ``repro_corrupt_chunks_total``."""
    got = []
    for side in SIDES:
        pkg = api if side == "port" else ref_api
        d = _dict(tmp_path, "file", side, verify_reads=True)
        store = _build(side, d)
        with store.open_stream() as s:
            s.write(_bytes(32 << 10, 10))
        h = s.report.handle
        store.close()
        _, _, off, _ = store.backend._index[0]
        pkg.faults.flip_bit(f"{d['backend_args']['path']}/chunks.log", off + 3)
        store = _build(side, d)
        with pytest.raises(pkg.CorruptChunkError):
            store.restore(h)
        got.append(nontiming(_parsed(store))[("repro_corrupt_chunks_total", ())])
        store.close()
    assert got == [1, 1]


def _masked_dump(om, path, capsys) -> list[str]:
    assert om.main(["dump", path]) == 0
    out = capsys.readouterr().out
    out = re.sub(r"\d\d:\d\d:\d\d tid=\S+ *", "T tid=? ", out)
    out = re.sub(r" *-?[\d.]+(e-?\d+)? ?ms", " ? ms", out)     # width varies too
    out = re.sub(r"total=[\d.]+s", "total=?s", out)
    return out.splitlines()


def test_trace_sink_and_dump_equal_the_reference(tmp_path, capsys):
    """A store's JSONL sink holds what its ring holds; ``dump`` of the two
    packages' sinks prints the same lines once timings are masked, and each
    package's ``dump`` reads the other's sink."""
    paths = {}
    for side in SIDES:
        paths[side] = str(tmp_path / f"{side}-trace.jsonl")
        store = _build(side, _dict(tmp_path, "file", side, trace_path=paths[side]))
        _drive(store, side)
        n_ring = len(store.observe.tracer.events())
        store.close()
        with open(paths[side]) as f:
            sink = [json.loads(line) for line in f if line.strip()]
        assert len(sink) == n_ring >= 2
    mine = _masked_dump(observe, paths["port"], capsys)
    assert mine == _masked_dump(ref_observe, paths["ref"], capsys)
    assert _masked_dump(observe, paths["ref"], capsys) == mine
    assert _masked_dump(ref_observe, paths["port"], capsys) == mine


@side_param
def test_observe_cli_dump(side, tmp_path, capsys):
    om, _ = SIDES[side]
    trace = str(tmp_path / "trace.jsonl")
    tr = om.Tracer(ring_events=8, path=trace)
    tr.record("alpha", 0.25, k=1)
    tr.record("alpha", 0.75)
    tr.record("beta", 0.1)
    tr.close()
    assert om.main(["dump", trace]) == 0
    out = capsys.readouterr().out
    assert "# 3 spans" in out and "alpha" in out and "beta" in out
    assert om.main(["tail", trace, "--from-start"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 3
