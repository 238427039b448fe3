"""The port's configuration path and registries (``repro_torch.api.config``,
``api.registry``) against the JAX package's ``repro.api``: the same
config dict gives the same validation, the same round trip and, through
``build_store``, the same verdicts, container records, per-stream counts
and DCR for every ported detector. Knobs whose component is not ported
raise ``NotImplementedError``; nothing is silently ignored.

Test-only registrations go through ``monkeypatch`` on the port's own
tables (undone at teardown); nothing here registers into the reference's
registry."""
import functools

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
    assert registry.available_indexes() == ["exact"]
    assert registry.available_chunkers() == ["fastcdc"]
    assert registry.available_backends() == ["memory"]
    assert registry.available_policies() == []
    assert registry.available_cache_policies() == []
    assert registry.get_chunker("fastcdc") is chunking.ChunkerConfig
    # the reference's own tables hold no port factory
    ref_registry._ensure_builtins()
    for table in (ref_registry._DETECTORS, ref_registry._INDEXES, ref_registry._CHUNKERS,
                  ref_registry._BACKENDS):
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


# --- what is not ported raises ---------------------------------------------------

UNPORTED = [
    ({"restore_cache_bytes": 1 << 20}, "Queue 1 item 4"),
    ({"restore_cache_shards": 2}, "Queue 1 item 4"),
    ({"restore_cache_policy": "arc"}, "Queue 1 item 4"),
    ({"restore_reader_fds": 2}, "Queue 1 item 3"),
    ({"restore_readahead": 0}, "Queue 1 item 4"),
    ({"restore_coalesce_gap": 0}, "Queue 1 item 3"),
    ({"restore_tier_path": "x"}, "Queue 1 item 3"),
    ({"restore_tier_bytes": 1}, "Queue 1 item 3"),
    ({"verify_reads": False}, "Queue 1 item 3"),
    ({"retry_deadline": 1.0}, "Queue 1 item 3"),
    ({"trace_path": "t.jsonl"}, "Queue 1 item 4"),
    ({"trace_ring_events": 0}, "Queue 1 item 4"),
    ({"server_workers": 2}, "Queue 1 item 4"),
    ({"server_args": {"workers": 2}}, "Queue 1 item 4"),
    ({"tenant_args": {"quota_bytes": 1}}, "Queue 1 item 4"),
    ({"policy": "eager"}, "Queue 1 item 4"),
    ({"policy": "threshold", "policy_args": {"ratio": 0.5}}, "Queue 1 item 4"),
    ({"policy_args": {"ratio": 0.5}}, "Queue 1 item 4"),
    ({"detector_args": {**CARD_ARGS, "fused": False}}, "Queue 1 item 5"),
]


@pytest.mark.parametrize("extra,item", UNPORTED,
                         ids=lambda x: "-".join(x) if isinstance(x, dict) else None)
def test_unported_knob_raises(extra, item):
    cfg = config.DedupConfig.from_dict({"detector": "card", **extra})
    with pytest.raises(NotImplementedError, match=item):
        config.build_store(cfg, device="cpu")


@pytest.mark.parametrize("d,err,match", [
    ({"backend": "file"}, KeyError, "unknown backend 'file'; available: \\['memory'\\]"),
    ({"backend": "objectstore"}, KeyError, "unknown backend"),
    ({"backend": "s3"}, KeyError, "unknown backend"),
    ({"detector_args": {"index": "banded-lsh"}}, KeyError,
     "unknown index 'banded-lsh'; available: \\['exact'\\]"),
    ({"chunker": "rabin"}, KeyError, "unknown chunker"),
], ids=["file", "objectstore", "s3", "banded-lsh", "chunker"])
def test_unregistered_component_raises(d, err, match):
    with pytest.raises(err, match=match):
        config.build_store(config.DedupConfig.from_dict({"detector": "card", **d}),
                           device="cpu")


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
