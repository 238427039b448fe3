"""End to end: the port's DedupStore (CARD over FastCDC, on the CPU) vs
the JAX reference store with ``use_kernel=True`` (Pallas in interpret
mode): once with the reference's trained context-model params carried
over, once with the port fitting its own from its default init, which
at these widths is the reference's ``init_params``.

Per stream the chunk/dup/delta/raw counts and bytes stored, every
container record, the DCR and every restored version must be equal. A
verdict may differ only where the reference's own margin — to the 0.3
threshold or to the runner-up candidate — is below 1e-5 (float sums run
in another order); such flips are counted and printed, at most one per
workload, and the exact checks then apply to the streams before it."""
import functools

import numpy as np
import pytest
import torch

from repro.core import chunking as ref_chunking
from repro.core import context_model as ref_cm
from repro.core import features as ref_features
from repro.core import pipeline as ref_pipeline
from repro.data import workloads as ref_workloads
from repro_torch import convert
from repro_torch.api.store import DedupStore
from repro_torch.core import chunking, context_model, features, pipeline
from repro_torch.data import workloads

torch.set_num_threads(1)

AVG = 512
# vmdk is half zero blocks, which dedup away: it needs more bytes for
# its index to reach the kernel gate (512 rows) before the last query
BASE = {"sql_dump": 512 << 10, "vmdk": 768 << 10, "kernel": 512 << 10}
THRESHOLD = 0.3


def _capture(det, snapshot_index: bool) -> list:
    """Wrap ``det.score`` to record each stream's verdicts (and, for the
    reference, what a margin needs: features, index rows and ids)."""
    seen = []
    score = det.score

    def recording(feats, batch):
        entry = {"ids": batch.ids.copy()}
        if snapshot_index:
            idx = det.index
            entry.update(feats=np.asarray(feats, np.float64),
                         rows=np.asarray(idx._buf[:idx._n], np.float64),
                         row_ids=idx._ids[:idx._n].copy())
        res = score(feats, batch)
        entry["base_ids"] = res.base_ids.copy()
        seen.append(entry)
        return res

    det.score = recording
    return seen


def _margin(entry: dict, i: int) -> float:
    """The reference's margin for chunk i: distance of the best candidate
    score to the threshold, or to the best candidate of another id."""
    f = entry["feats"]
    cand_s = np.concatenate([entry["rows"] @ f[i], f[:i] @ f[i]])
    cand_id = np.concatenate([entry["row_ids"], entry["ids"][:i]])
    keep = cand_id != entry["ids"][i]
    cand_s, cand_id = cand_s[keep], cand_id[keep]
    if cand_s.size == 0:
        return np.inf
    top = int(np.argmax(cand_s))
    others = cand_s[cand_id != cand_id[top]]
    runner = others.max() if others.size else -np.inf
    return float(min(abs(cand_s[top] - THRESHOLD), cand_s[top] - runner))


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The workload's versions and the JAX store that ingested them, with
    the verdicts it gave (shared by the tests of one workload)."""
    versions = ref_workloads.make_workload(
        name, ref_workloads.WorkloadConfig(base_size=BASE[name], versions=3))
    assert versions == workloads.make_workload(
        name, workloads.WorkloadConfig(base_size=BASE[name], versions=3))
    ref_det = ref_pipeline.CARDDetector(
        feat_cfg=ref_features.FeatureConfig(k=32, m=64, n=2),
        model_cfg=ref_cm.ContextModelConfig(m=64, d=50, steps=150),
        threshold=THRESHOLD, use_kernel=True)
    ref_store = ref_pipeline.DedupStore(ref_det, ref_chunking.ChunkerConfig(avg_size=AVG))
    ref_store.fit(versions[:1])
    ref_seen = _capture(ref_det, snapshot_index=True)
    for v in versions:
        ref_store.ingest(v)
    return versions, ref_det, ref_store, ref_seen


def _port_detector():
    return pipeline.CARDDetector(
        feat_cfg=features.FeatureConfig(k=32, m=64, n=2),
        model_cfg=context_model.ContextModelConfig(m=64, d=50, steps=150),
        threshold=THRESHOLD, device="cpu")


def _assert_store_matches(name, versions, ref_det, ref_store, ref_seen, det, store, seen):
    # some query must have crossed the kernel gate (index >= 512 rows)
    assert max(len(r["rows"]) for r in ref_seen) >= 512
    assert len(det.index) == len(ref_det.index)

    flips = []
    for s, (r, p) in enumerate(zip(ref_seen, seen)):
        assert np.array_equal(r["ids"], p["ids"]), f"stream {s}: chunk ids differ"
        for i in np.flatnonzero(r["base_ids"] != p["base_ids"]):
            flips.append((s, int(i), int(r["base_ids"][i]), int(p["base_ids"][i]),
                          _margin(r, int(i))))
    print(f"{name}: index rows at each query {[len(r['rows']) for r in ref_seen]}")
    print(f"{name}: verdict flips (stream, chunk, ref, port, ref margin): {flips}")
    assert len(flips) <= 1, flips
    assert all(m < 1e-5 for *_, m in flips), flips

    exact_streams = flips[0][0] if flips else len(versions)
    key = lambda r: (r.chunks, r.dup_chunks, r.delta_chunks, r.raw_chunks, r.bytes_stored)
    for s in range(exact_streams):
        assert key(store.reports[s]) == key(ref_store.reports[s]), f"stream {s}"
    if not flips:
        assert sorted(store.backend.chunk_ids()) == sorted(ref_store.backend.chunk_ids())
        for cid in ref_store.backend.chunk_ids():
            assert store.backend.record(cid) == ref_store.backend.record(cid), cid
        assert store.stats.dcr == ref_store.stats.dcr
        assert store.stats.delta_chunks > 0
    for h, v in enumerate(versions):
        assert store.restore(h) == v
    return flips


@pytest.mark.parametrize("name", ["sql_dump", "vmdk", "kernel"])
def test_port_store_matches_reference(name):
    versions, ref_det, ref_store, ref_seen = _reference(name)
    cfg = chunking.ChunkerConfig(avg_size=AVG)
    det = _port_detector()
    det.model = convert.context_model_from_params(
        np.asarray(ref_det.model.params.w), np.asarray(ref_det.model.params.u),
        det.model_cfg, device="cpu")
    det.lmax_floor = cfg.max_size
    store = DedupStore(det, cfg, device="cpu")
    seen = _capture(det, snapshot_index=False)
    for v in versions:
        store.ingest(v)
    _assert_store_matches(name, versions, ref_det, ref_store, ref_seen, det, store, seen)


@pytest.mark.parametrize("name", ["sql_dump", "vmdk", "kernel"])
def test_port_fit_matches_reference(name):
    """The port fits its own context model, from its default init (the
    reference's ``init_params``, shipped as a fixture) and the same batch
    stream: the same DCR, per-stream counts and records as the JAX store,
    under the flip rule above."""
    versions, ref_det, ref_store, ref_seen = _reference(name)
    det = _port_detector()
    assert det.model.init_source == "reference"
    store = DedupStore(det, chunking.ChunkerConfig(avg_size=AVG), device="cpu")
    store.fit(versions[:1])
    np.testing.assert_allclose(det.model.losses, ref_det.model.losses, rtol=1e-4)
    seen = _capture(det, snapshot_index=False)
    for v in versions:
        store.ingest(v)
    _assert_store_matches(name, versions, ref_det, ref_store, ref_seen, det, store, seen)


def test_sessions_and_restore():
    versions = workloads.make_workload(
        "sql_dump", workloads.WorkloadConfig(base_size=128 << 10, versions=2))
    det = pipeline.CARDDetector(
        feat_cfg=features.FeatureConfig(k=8, m=16, n=2),
        model_cfg=context_model.ContextModelConfig(m=16, d=8, steps=10), device="cpu")
    cfg = chunking.ChunkerConfig(avg_size=1024)
    store = DedupStore(det, cfg, device="cpu")
    store.fit(versions[:1])
    stats = store.ingest(versions[0])
    assert stats.chunks > 0 and stats.bytes_in == len(versions[0])
    with store.open_stream() as s:
        s.write(versions[1][:1000])
        s.write(versions[1][1000:])
    assert store.restore(s.report.handle) == versions[1]
    assert store.restore(0) == versions[0]
    assert store.stats.bytes_in == sum(len(v) for v in versions)
    assert store.ingest(b"").chunks == store.stats.chunks
    assert store.restore(2) == b""
    with pytest.raises(RuntimeError):
        s.write(b"x")
    with pytest.raises(ValueError, match="detector runs on"):
        DedupStore(det, cfg, device="meta")
