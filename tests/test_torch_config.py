"""The port's configuration path and registries (``repro_torch.api.config``,
``api.registry``) against the JAX package's ``repro.api``: the same
config dict gives the same validation, the same round trip and, through
``build_store``, the same verdicts, container records, per-stream counts
and DCR for every ported detector, and for CARD with each feature path
and index knob (``fused: False``, ``lsh: "poly"``, ``normalize: False``,
``index: "banded-lsh"``). The trace and server knobs build what the
reference's build (a tracer, a ``DedupServer``); nothing is silently
ignored.

Test-only registrations go through ``monkeypatch`` on the port's own
tables (undone at teardown); nothing here registers into the reference's
registry."""
import dataclasses
import functools
import hashlib
import inspect

import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.api import registry as ref_registry
from repro_torch.api import config, registry
from repro_torch.api.store import DedupStore
from repro_torch.core import chunking, context_model, features, pipeline
from repro_torch.data import workloads
from repro_torch.kernels import ops

torch.set_num_threads(1)

AVG = 8192
CARD_ARGS = {"feat": {"k": 32, "m": 64, "n": 2},
             "model": {"m": 64, "d": 50, "steps": 60},
             "use_kernel": False}
DICTS = {
    "dedup-only": {"detector": "dedup-only", "chunker_args": {"avg_size": AVG}},
    "finesse": {"detector": "finesse", "chunker_args": {"avg_size": AVG}},
    "n-transform": {"detector": "n-transform", "chunker_args": {"avg_size": AVG}},
    "card": {"detector": "card", "detector_args": CARD_ARGS, "chunker_args": {"avg_size": AVG}},
    # the per-chunk feature path, the poly ablation, unnormalised features
    # and the banded index, each from a dict
    "card-unfused": {"detector": "card", "detector_args": {**CARD_ARGS, "fused": False},
                     "chunker_args": {"avg_size": AVG}},
    "card-poly": {"detector": "card",
                  "detector_args": {**CARD_ARGS, "feat": {**CARD_ARGS["feat"], "lsh": "poly"}},
                  "chunker_args": {"avg_size": AVG}},
    "card-unnormalized": {
        "detector": "card",
        "detector_args": {**CARD_ARGS, "feat": {**CARD_ARGS["feat"], "normalize": False}},
        "chunker_args": {"avg_size": AVG}},
    "card-banded": {"detector": "card", "detector_args": {**CARD_ARGS, "index": "banded-lsh"},
                    "chunker_args": {"avg_size": AVG}},
}


@functools.lru_cache(maxsize=None)
def _versions():
    versions = workloads.make_workload(
        "sql_dump", workloads.WorkloadConfig(base_size=1 << 20, versions=3))
    from repro.data import workloads as ref_workloads
    assert versions == ref_workloads.make_workload(
        "sql_dump", ref_workloads.WorkloadConfig(base_size=1 << 20, versions=3))
    return versions


def _record_verdicts(det) -> list:
    seen = []
    score = det.score

    def recording(feats, batch):
        res = score(feats, batch)
        seen.append(res.base_ids.copy())
        return res

    det.score = recording
    return seen


def _drive(store, versions) -> list:
    seen = _record_verdicts(store.detector)
    store.fit(versions[:1])
    for v in versions:
        store.ingest(v)
    return seen


def _report_key(r):
    return (r.bytes_in, r.bytes_stored, r.chunks, r.dup_chunks, r.delta_chunks, r.raw_chunks)


# --- DedupConfig: fields, round trip, validation -------------------------------

def test_fields_and_defaults_are_the_reference_s():
    assert config.DedupConfig().to_dict() == ref_api.DedupConfig().to_dict()
    assert config._KNOWN_KEYS == set(ref_api.DedupConfig().to_dict())


@pytest.mark.parametrize("name", sorted(DICTS) + ["knobs"])
def test_round_trip(name):
    d = DICTS.get(name) or {"detector": "finesse", "restore_cache_bytes": 1 << 20,
                            "restore_readahead": 0, "verify_reads": True,
                            "retry_deadline": 2.5, "trace_ring_events": 8,
                            "server_workers": 2, "tenant_args": {"quota_bytes": 5}}
    cfg = config.DedupConfig.from_dict(d)
    assert config.DedupConfig.from_dict(cfg.to_dict()) == cfg
    assert cfg.to_dict() == ref_api.DedupConfig.from_dict(d).to_dict()


BAD = [
    {"detectr": "card"},
    {"detector": 3},
    {"chunker": None},
    {"backend": ["memory"]},
    {"policy": 1},
    {"restore_cache_bytes": 0},
    {"restore_cache_bytes": True},
    {"restore_cache_shards": 1.5},
    {"restore_reader_fds": 0},
    {"restore_readahead": -1},
    {"restore_coalesce_gap": -1},
    {"restore_tier_bytes": 0},
    {"restore_cache_policy": 3},
    {"restore_tier_path": 1},
    {"verify_reads": 1},
    {"retry_deadline": -1},
    {"retry_deadline": True},
    {"retry_deadline": "1"},
    {"trace_path": 2},
    {"trace_ring_events": -1},
    {"server_workers": 0},
    {"server_workers": True},
]


@pytest.mark.parametrize("bad", BAD, ids=lambda d: "-".join(f"{k}={v!r}" for k, v in d.items()))
def test_invalid_config_raises_as_the_reference(bad):
    with pytest.raises(Exception) as ref_err:
        ref_api.DedupConfig.from_dict(bad)
    with pytest.raises(type(ref_err.value)) as err:
        config.DedupConfig.from_dict(bad)
    assert str(err.value) == str(ref_err.value)


# --- registries ----------------------------------------------------------------

def test_registry_listings():
    assert registry.available_detectors() == ["card", "dedup-only", "finesse", "n-transform"]
    assert registry.available_indexes() == ["banded-lsh", "exact"]
    assert registry.available_chunkers() == ["fastcdc"]
    assert registry.available_backends() == ["file", "memory", "objectstore", "s3"] == \
        ref_registry.available_backends()
    assert registry.available_policies() == ["eager", "never", "threshold"]
    assert registry.available_cache_policies() == ["arc", "lru"]
    assert registry.get_chunker("fastcdc") is chunking.ChunkerConfig
    # the reference's own tables hold no port factory
    ref_registry._ensure_builtins()
    for table in (ref_registry._DETECTORS, ref_registry._INDEXES, ref_registry._CHUNKERS,
                  ref_registry._BACKENDS, ref_registry._POLICIES,
                  ref_registry._CACHE_POLICIES):
        assert not any(f.__module__.startswith("repro_torch") for f in table.values())


@pytest.mark.parametrize("kind,plural", [
    ("detector", "detectors"), ("index", "indexes"), ("chunker", "chunkers"),
    ("backend", "backends"), ("policy", "policies"), ("cache_policy", "cache_policies")])
def test_unknown_name_lists_available(kind, plural):
    get = getattr(registry, f"get_{kind}")
    available = getattr(registry, f"available_{plural}")()
    with pytest.raises(KeyError, match=r"unknown .*'nope'; available: ") as err:
        get("nope")
    assert str(available) in str(err.value)
    with pytest.raises(KeyError) as ref_err:
        getattr(ref_registry, f"get_{kind}")("nope")
    assert str(err.value).split(";")[0] == str(ref_err.value).split(";")[0]


def test_register_twice_and_test_only_names(monkeypatch):
    factory = registry.get_detector("dedup-only")
    assert registry.register_detector("dedup-only")(factory) is factory   # same: no-op
    with pytest.raises(ValueError, match="detector 'dedup-only' already registered"):
        registry.register_detector("dedup-only")(lambda **kw: None)

    made = []

    def custom(device=None, tag=0):
        made.append(tag)
        return pipeline.NullDetector(device)

    monkeypatch.setitem(registry._DETECTORS, "test-only", custom)
    store = config.build_store(config.DedupConfig.from_dict(
        {"detector": "test-only", "detector_args": {"tag": 5}}), device="cpu")
    assert made == [5] and store.detector.name == "dedup-only"
    assert "test-only" in registry.available_detectors()


def test_no_test_only_name_left_behind():
    assert "test-only" not in registry.available_detectors()


def test_failed_builtin_import_is_retried(monkeypatch):
    """``_ensure_builtins`` marks the registries loaded only after every
    import succeeded, so a failure surfaces again on the next lookup."""
    import builtins
    real_import = builtins.__import__

    def failing(name, *args, **kwargs):
        if name == "repro_torch.api":
            raise ImportError("boom")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(registry, "_builtins_loaded", False)
    monkeypatch.setattr(builtins, "__import__", failing)
    for _ in range(2):
        with pytest.raises(ImportError, match="boom"):
            registry.available_detectors()
    assert registry._builtins_loaded is False
    monkeypatch.setattr(builtins, "__import__", real_import)
    assert "card" in registry.available_detectors()
    assert registry._builtins_loaded is True


def test_api_exports_are_reference_names():
    """``repro_torch.api`` re-exports what is ported under the reference's
    names, and only names the reference's ``repro.api`` exports too."""
    from repro_torch import api
    mine = ({n for n in vars(api) if not n.startswith("_")} | set(api._LAZY_EXPORTS)) - {
        "types", "restore", "concurrency", "detect", "integrity", "faults", "containers",
        "objectstore", "store", "registry", "config", "lifecycle", "refcount", "observe",
        "serve"}  # submodules
    missing = [n for n in sorted(mine) if not hasattr(ref_api, n)]
    assert not missing, f"exported by the port but not by the reference: {missing}"
    for name in ("build_store", "DedupConfig", "DedupStore", "chunk_with", "FileBackend",
                 "ObjectStoreBackend", "LocalObjectStore", "InMemoryBackend", "crc32c",
                 "CorruptChunkError", "CorruptJournalError", "FaultSchedule",
                 "TransientError", "DeadlineExceededError", "RestoreReport", "RWLock",
                 "LockTimeout", "RefcountTable", "CollectReport", "CompactionRun",
                 "ReclamationPolicy", "EagerPolicy", "ThresholdPolicy", "NeverPolicy",
                 "build_policy", "ScrubReport", "MetricsRegistry", "Observability", "Tracer",
                 "parse_prometheus_text", "CircuitBreaker", "CircuitOpenError",
                 "DedupServer", "OverloadError", "QuotaExceededError", "RequestRejected",
                 "TenantConfig", "build_server"):
        assert name in mine and getattr(api, name).__module__.startswith("repro_torch.api")


# names a reference package exports whose module is not ported yet (none
# since the cells of the dry run were ported)
UNPORTED_EXPORTS: dict[str, set[str]] = {}


@pytest.mark.parametrize("pkg", ["api", "checkpoint", "configs", "core", "data", "distributed",
                                 "kernels", "models", "optim", "train"])
def test_reference_exports_exist_in_the_port(pkg):
    """The converse of ``test_api_exports_are_reference_names``: every
    public name a reference package's ``__init__`` exports (its lazy
    exports included) is importable from the port's package of the same
    name, and is the port's own object."""
    import importlib
    import types
    ref = importlib.import_module(f"repro.{pkg}")
    mine = importlib.import_module(f"repro_torch.{pkg}")
    names = {n for n, v in vars(ref).items()
             if not n.startswith("_") and not isinstance(v, types.ModuleType)}
    names |= set(getattr(ref, "_LAZY_EXPORTS", ()))
    names -= UNPORTED_EXPORTS.get(pkg, set()) | {"annotations"}
    missing = sorted(n for n in names if not hasattr(mine, n))
    assert not missing, f"repro.{pkg} exports {missing}, repro_torch.{pkg} does not"
    for n in names:
        module = getattr(getattr(mine, n), "__module__", None) or "repro_torch"
        assert module.startswith("repro_torch"), (n, module)


# the trace and server knobs, each as the reference builds it: (knob dict,
# what to compare)
OBSERVE_SERVE_KNOBS = [
    ({"trace_path": "t.jsonl"}, "tracer"),
    ({"trace_ring_events": 16}, "tracer"),
    ({"server_workers": 2}, "server"),
    ({"server_args": {"workers": 2}}, "server"),
    ({"tenant_args": {"quota_bytes": 1}}, "server"),
]


def _knob_dict(extra: dict, tmp_path, side: str) -> dict:
    d = {**DICTS["dedup-only"], **extra}
    if "trace_path" in d:
        d["trace_path"] = str(tmp_path / f"{side}-{d['trace_path']}")
    return d


@pytest.mark.parametrize("extra,what", OBSERVE_SERVE_KNOBS,
                         ids=lambda x: "-".join(x) if isinstance(x, dict) else None)
def test_observe_and_serve_knobs_build_as_the_reference(tmp_path, extra, what):
    """Each trace / server knob builds what the reference's builds: a tracer
    whose ring and sink record the same spans for one ingest, or a server
    with the same workers and default tenant limits, which sheds alike."""
    data = _versions()[0]
    mine_d, ref_d = _knob_dict(extra, tmp_path, "port"), _knob_dict(extra, tmp_path, "ref")
    if what == "tracer":
        store = config.build_store(config.DedupConfig.from_dict(mine_d), device="cpu")
        ref = ref_api.build_store(ref_api.DedupConfig.from_dict(ref_d))
        mine_tr, ref_tr = store.observe.tracer, ref.observe.tracer
        assert mine_tr is not None and ref_tr is not None
        assert mine_tr.ring_events == ref_tr.ring_events
        store.ingest(data)
        ref.ingest(data)
        assert mine_tr.ops() == ref_tr.ops() and mine_tr.ops()["ingest"] == 1
        store.close()
        ref.close()
        if "trace_path" in extra:
            lines = [(tmp_path / f"{side}-t.jsonl").read_text().splitlines()
                     for side in ("port", "ref")]
            assert len(lines[0]) == len(lines[1]) == len(mine_tr.events()) > 0
        return
    srv = config.build_server(config.DedupConfig.from_dict(mine_d), device="cpu")
    ref_srv = ref_api.build_server(ref_api.DedupConfig.from_dict(ref_d))
    try:
        assert srv._pool._max_workers == ref_srv._pool._max_workers
        assert dataclasses.asdict(srv._default_cfg) == dataclasses.asdict(ref_srv._default_cfg)
        outcomes = []
        for server in (srv, ref_srv):
            try:
                outcomes.append(server.ingest("t", data).bytes_stored)
            except Exception as e:         # noqa: BLE001 - compared across packages
                outcomes.append(type(e).__name__)
        assert outcomes[0] == outcomes[1]
        assert (outcomes[0] == "QuotaExceededError") == ("tenant_args" in extra)
        assert srv.tenant_stats("t") == ref_srv.tenant_stats("t")
    finally:
        srv.close(close_store=True)
        ref_srv.close(close_store=True)


# StoreStats the policies are asked about: (live_bytes, dead_bytes)
POLICY_STATS = [(0, 0), (100, 0), (0, 1), (100, 1), (100, 50), (100, 100), (3, 1), (1, 3)]


def _stats_pair(live, dead):
    from repro_torch.api.types import StoreStats
    return (StoreStats(live_bytes=live, dead_bytes=dead),
            ref_api.StoreStats(live_bytes=live, dead_bytes=dead))


@pytest.mark.parametrize("d", [{"policy": "eager"},
                               {"policy": "threshold", "policy_args": {"ratio": 0.5}},
                               {"policy": "never"}],
                         ids=["eager", "threshold", "never"])
def test_policy_from_a_dict_decides_as_the_reference(d):
    """Each policy is built from a dict on the CPU, through ``build_store``,
    and decides ``should_compact`` as the reference's on the same stats."""
    full = {"detector": "dedup-only", **d}
    store = config.build_store(config.DedupConfig.from_dict(full), device="cpu")
    ref_policy = ref_api.build_policy(ref_api.DedupConfig.from_dict(full))
    assert store.policy.name == ref_policy.name == d["policy"]
    assert type(store.policy).__module__ == "repro_torch.api.lifecycle"
    for live, dead in POLICY_STATS:
        stats, ref_stats = _stats_pair(live, dead)
        assert store.policy.should_compact(stats) == ref_policy.should_compact(ref_stats)
    store.close()


def test_policy_args_a_policy_does_not_take_raise_as_the_reference():
    d = {"detector": "dedup-only", "policy_args": {"ratio": 0.5}}
    with pytest.raises(TypeError) as ref_err:
        ref_api.build_store(ref_api.DedupConfig.from_dict(d))
    with pytest.raises(TypeError) as err:
        config.build_store(config.DedupConfig.from_dict(d), device="cpu")
    assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("d,err,match", [
    ({"backend": "s3"}, TypeError,
     "_s3_backend\\(\\) missing 1 required positional argument: 'bucket'"),
    ({"backend": "nope"}, KeyError,
     "unknown backend 'nope'; available: \\['file', 'memory', 'objectstore', 's3'\\]"),
    ({"detector_args": {"index": "nope"}}, KeyError,
     "unknown index 'nope'; available: \\['banded-lsh', 'exact'\\]"),
    ({"chunker": "rabin"}, KeyError, "unknown chunker"),
], ids=["s3", "nope", "banded-lsh", "chunker"])
def test_unregistered_component_raises(d, err, match):
    """Each raises what the reference raises, with the same text."""
    full = {"detector": "card", **d}
    with pytest.raises(err, match=match):
        ref_api.build_store(ref_api.DedupConfig.from_dict(full))
    with pytest.raises(err, match=match):
        config.build_store(config.DedupConfig.from_dict(full), device="cpu")


@pytest.mark.parametrize("backend,cls", [("file", "FileBackend"),
                                         ("objectstore", "ObjectStoreBackend")])
def test_persistent_backends_build(tmp_path, backend, cls):
    """Both names build through the port's registry (they raised before
    the backends were ported)."""
    store = config.build_store(config.DedupConfig.from_dict(
        {"detector": "dedup-only", "backend": backend,
         "backend_args": {"path": str(tmp_path / backend)}}), device="cpu")
    assert type(store.backend).__name__ == cls
    assert type(store.backend).__module__.startswith("repro_torch.api.")
    store.close()


# one value for each knob _BACKEND_KNOBS forwards
KNOB_VALUES = {"restore_cache_bytes": 1 << 20, "restore_cache_shards": 2,
               "restore_cache_policy": "arc", "restore_reader_fds": 2,
               "restore_readahead": 0, "restore_coalesce_gap": 0,
               "restore_tier_path": "TIER", "restore_tier_bytes": 4096,
               "verify_reads": True, "retry_deadline": 1.0}


def _spy_init(monkeypatch, cls) -> list:
    """Record the kwargs ``cls`` is built with; ``functools.wraps`` keeps
    the signature the config path inspects."""
    seen = []
    real = cls.__init__

    @functools.wraps(real)
    def init(self, *args, **kwargs):
        seen.append(kwargs)
        real(self, *args, **kwargs)

    monkeypatch.setattr(cls, "__init__", init)
    return seen


@pytest.mark.parametrize("backend", ["file", "objectstore"])
@pytest.mark.parametrize("knob", sorted(KNOB_VALUES))
def test_serving_knob_reaches_the_factory_as_in_the_reference(tmp_path, monkeypatch,
                                                              backend, knob):
    from repro.api import containers as ref_containers
    from repro.api import objectstore as ref_objectstore
    from repro_torch.api import containers, objectstore
    classes = {"file": (containers.FileBackend, ref_containers.FileBackend),
               "objectstore": (objectstore.ObjectStoreBackend,
                               ref_objectstore.ObjectStoreBackend)}[backend]
    value = KNOB_VALUES[knob]
    kwargs = []
    for pkg, cls, name in ((config, classes[0], "port"), (ref_api, classes[1], "ref")):
        if value == "TIER":
            value = str(tmp_path / name / "tier")
        seen = _spy_init(monkeypatch, cls)
        built = pkg.build_backend(pkg.DedupConfig.from_dict(
            {"backend": backend, "backend_args": {"path": str(tmp_path / name / "b")},
             knob: value}))
        built.close()
        (got,) = seen
        got.pop("path")
        kwargs.append({k: (v.replace(f"/{name}/", "/") if isinstance(v, str) else v)
                       for k, v in got.items()})
        value = KNOB_VALUES[knob]
    assert kwargs[0] == kwargs[1]
    kwarg = config._BACKEND_KNOBS[knob]
    declared = kwarg in inspect.signature(classes[0]).parameters
    assert kwargs[0] == ({kwarg: kwargs[0][kwarg]} if declared else {})
    if declared and knob != "restore_tier_path":
        assert kwargs[0][kwarg] == value


def test_use_kernel_false():
    """On the CPU it changes nothing (the plain versions run anyway); on
    the card it is refused: the port has no path that skips its kernels."""
    with_flag = config.build_detector(config.DedupConfig.from_dict(DICTS["card"]), "cpu")
    assert with_flag.device.type == "cpu" and with_flag.model_cfg.steps == 60
    assert with_flag.index.device.type == "cpu"


def test_use_kernel_false_refused_on_the_card(monkeypatch):
    monkeypatch.setattr(ops, "resolve_device", lambda device: torch.device("cuda", 0))
    with pytest.raises(ValueError, match="use_kernel=False"):
        config.build_detector(config.DedupConfig.from_dict(DICTS["card"]))


def test_card_index_through_the_registry(monkeypatch):
    made = {}

    def fake_index(dim, threshold, device, **kw):
        made.update(dim=dim, threshold=threshold, device=device, **kw)
        return "an index"

    monkeypatch.setitem(registry._INDEXES, "test-only", fake_index)
    det = config.build_detector(config.DedupConfig.from_dict({
        "detector": "card",
        "detector_args": {**CARD_ARGS, "threshold": 0.4, "index": "test-only",
                          "index_args": {"extra": 1}}}), "cpu")
    assert det.index == "an index"
    assert made == dict(dim=50, threshold=0.4, device=torch.device("cpu"), extra=1)


# --- the config path equals direct construction, and the reference -------------

def test_config_path_equals_direct_construction():
    versions = _versions()
    for name, direct in (("finesse", pipeline.finesse_detector(device="cpu")),
                         ("n-transform", pipeline.ntransform_detector(device="cpu")),
                         ("dedup-only", pipeline.NullDetector("cpu"))):
        a = config.build_store(config.DedupConfig.from_dict(DICTS[name]), device="cpu")
        b = DedupStore(direct, chunking.ChunkerConfig(avg_size=AVG), device="cpu")
        assert a.cfg == b.cfg and a.detector.name == b.detector.name == name
        va, vb = _drive(a, versions), _drive(b, versions)
        assert all(np.array_equal(x, y) for x, y in zip(va, vb))
        assert [_report_key(r) for r in a.reports] == [_report_key(r) for r in b.reports]
    card = config.build_detector(config.DedupConfig.from_dict(DICTS["card"]), "cpu")
    direct = pipeline.CARDDetector(features.FeatureConfig(k=32, m=64, n=2),
                                   context_model.ContextModelConfig(m=64, d=50, steps=60),
                                   device="cpu")
    assert (card.feat_cfg, card.model_cfg, card.threshold) == (
        direct.feat_cfg, direct.model_cfg, direct.threshold)
    assert type(card.index) is type(direct.index)


@pytest.mark.parametrize("name", sorted(DICTS))
def test_build_store_matches_reference(name):
    """One dict, both packages, sql_dump 1 MiB x 3 (CARD from the shipped
    init, which is the reference's): identical verdicts, records,
    per-stream counts, DCR and restores."""
    versions = _versions()
    d = DICTS[name]
    ref = ref_api.build_store(ref_api.DedupConfig.from_dict(d))
    port = config.build_store(config.DedupConfig.from_dict(d), device="cpu")
    ref_seen, seen = _drive(ref, versions), _drive(port, versions)
    assert len(seen) == len(ref_seen) == len(versions)
    for s, (r, p) in enumerate(zip(ref_seen, seen)):
        assert np.array_equal(r, p), f"stream {s}: verdicts differ"
    assert [_report_key(r) for r in port.reports] == [_report_key(r) for r in ref.reports]
    assert sorted(port.backend.chunk_ids()) == sorted(ref.backend.chunk_ids())
    for cid in ref.backend.chunk_ids():
        assert port.backend.record(cid) == ref.backend.record(cid), cid
    assert port.stats.dcr == ref.stats.dcr
    if name != "dedup-only":
        assert port.stats.delta_chunks > 0
    for h, v in enumerate(versions):
        assert port.restore(h) == v


def _stats_key(stats) -> dict:
    """Every field of the port's StoreStats but the timing ones: seconds,
    and the read bytes that readahead happened to hide behind decode."""
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)
            if not f.name.endswith("seconds") and f.name != "restore_prefetch_bytes"}


def _sha(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


@pytest.mark.parametrize("backend", ["memory", "file", "objectstore"])
def test_build_store_on_each_backend_matches_reference(tmp_path, backend):
    """One CARD dict per backend through both packages (sql_dump 1 MiB x 3,
    serving knobs set): equal reports (the file backend's record header
    counted), stats, DCR, restores, ranges and stream lengths; then both
    closed and rebuilt from the same dict on the same directory, where
    every stream restores SHA-identical, and a fresh fit and ingest give
    new chunk ids above the reopened ``max_chunk_id()`` in both."""
    versions = _versions()
    persistent = backend != "memory"

    def d(name):
        out = {**DICTS["card"], "backend": backend}
        if persistent:
            out.update(backend_args={"path": str(tmp_path / name)},
                       restore_cache_bytes=1 << 20, restore_reader_fds=2,
                       restore_readahead=2, verify_reads=backend == "file")
        return out

    ref = ref_api.build_store(ref_api.DedupConfig.from_dict(d("ref")))
    port = config.build_store(config.DedupConfig.from_dict(d("port")), device="cpu")
    for store in (ref, port):
        store.fit(versions[:1])
        for v in versions:
            store.ingest(v)
    assert [_report_key(r) for r in port.reports] == [_report_key(r) for r in ref.reports]
    overhead = {"memory": 0, "file": 29, "objectstore": 0}[backend]
    assert port.backend.record_overhead == ref.backend.record_overhead == overhead
    st = port.stats
    assert st.bytes_stored == sum(len(port.backend.record(c)[2])
                                  for c in port.backend.chunk_ids()) + overhead * (
        st.delta_chunks + st.raw_chunks)
    rng = np.random.default_rng(7)
    for h, v in enumerate(versions):
        assert _sha(port.restore(h)) == _sha(ref.restore(h)) == _sha(v)
        assert (b"".join(port.restore_iter(h, batch_chunks=16))
                == b"".join(ref.restore_iter(h, batch_chunks=16)) == v)
        assert port.stream_length(h) == ref.stream_length(h) == len(v)
        for _ in range(4):
            off, ln = int(rng.integers(0, len(v))), int(rng.integers(0, 200_000))
            assert port.restore_range(h, off, ln) == ref.restore_range(h, off, ln) == v[off:off + ln]
    assert port.stats.dcr == ref.stats.dcr
    assert _stats_key(port.stats) == {k: v for k, v in _stats_key(ref.stats).items()
                                      if k in _stats_key(port.stats)}
    if not persistent:
        return
    ref.close()
    port.close()
    with pytest.raises(RuntimeError, match="store is closed"):
        port.restore(0)
    ref = ref_api.build_store(ref_api.DedupConfig.from_dict(d("ref")))
    port = config.build_store(config.DedupConfig.from_dict(d("port")), device="cpu")
    stored = port.backend.max_chunk_id()
    assert stored == ref.backend.max_chunk_id() == max(max(r) for r in
                                                        (port.backend.recipe(h) for h in range(3)))
    for h, v in enumerate(versions):
        assert _sha(port.restore(h)) == _sha(ref.restore(h)) == _sha(v)
        assert port.last_restore.bytes_read == ref.last_restore.bytes_read > 0
        assert port.restore_range(h, 1000, 5000) == ref.restore_range(h, 1000, 5000) == (
            v[1000:6000])
    before = set(port.backend.chunk_ids())
    for store in (ref, port):
        store.fit(versions[:1])
        store.ingest(versions[2])
    last = port.reports[-1]
    assert _report_key(last) == _report_key(ref.reports[-1])
    # the digest table starts empty on a reopen: every chunk is stored anew,
    # under ids past the persisted ones (none overwritten)
    added = set(port.backend.chunk_ids()) - before
    assert len(added) == last.delta_chunks + last.raw_chunks > 0
    assert min(added) == stored + 1 and set(port.backend.recipe(3)) == added
    assert sorted(port.backend.chunk_ids()) == sorted(ref.backend.chunk_ids())
    for h, v in enumerate(list(versions) + [versions[2]]):
        assert _sha(port.restore(h)) == _sha(v)
    ref.close()
    port.close()
