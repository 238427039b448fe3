"""The port's staged detector protocol (``repro_torch.api.detect``):
``run_detect`` equals extract -> score -> observe and falls back to a
legacy ``detect``; ``LegacyDetectMixin.detect`` equals the staged methods
for every ported detector; ``score`` never mutates an index; and the
store drives a legacy-only detector to the same result as the staged one
(as ``tests/test_api.py`` holds the reference)."""
import functools

import numpy as np
import pytest
import torch

from repro.api import store as ref_store
from repro.api import types as ref_types
from repro.core import chunking as ref_chunking
from repro.core import pipeline as ref_pipeline
from repro_torch.api import detect
from repro_torch.api.store import DedupStore, chunk_with
from repro_torch.api.types import DetectBatch
from repro_torch.core import chunking, context_model, features, pipeline
from repro_torch.data import workloads

torch.set_num_threads(1)

CCFG = chunking.ChunkerConfig(avg_size=2048)

MAKERS = {
    "dedup-only": lambda: pipeline.NullDetector("cpu"),
    "finesse": lambda: pipeline.finesse_detector(device="cpu"),
    "n-transform": lambda: pipeline.ntransform_detector(device="cpu"),
    "card": lambda: pipeline.CARDDetector(
        features.FeatureConfig(k=8, m=16, n=2),
        context_model.ContextModelConfig(m=16, d=8, steps=10), device="cpu"),
}


@functools.lru_cache(maxsize=None)
def _versions():
    return workloads.make_workload(
        "sql_dump", workloads.WorkloadConfig(base_size=128 << 10, versions=3))


def _batches(versions):
    """One DetectBatch per version, ids and is_new as a store assigns them."""
    seen: dict[bytes, int] = {}
    out = []
    for v in versions:
        chunks, scan = chunk_with(CCFG, v, "cpu")
        ids = np.empty(len(chunks), np.int64)
        is_new = np.zeros(len(chunks), bool)
        for i, ck in enumerate(chunks):
            if ck.digest not in seen:
                seen[ck.digest] = len(seen)
                is_new[i] = True
            ids[i] = seen[ck.digest]
        out.append(DetectBatch(chunks=chunks, ids=ids, is_new=is_new, stream_hashes=scan))
    return out


def _index_state(det):
    if isinstance(det, pipeline.SuperFeatureDetector):
        return [dict(t) for t in det._index._tables]
    if isinstance(det, pipeline.CARDDetector):
        return (det.index._buf[:len(det.index)].clone(), det.index._ids[:len(det.index)].copy())
    return None


def _same_state(a, b) -> bool:
    if isinstance(a, tuple):
        return torch.equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    return a == b


def _fitted(name):
    """A fitted detector; two CARD fits of one config give one model (the
    fit is seeded), so two detectors of a comparison agree."""
    det = MAKERS[name]()
    det.fit(_versions()[:1], CCFG)
    return det


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_legacy_detect_equals_staged(name):
    staged, legacy = _fitted(name), _fitted(name)
    assert detect.is_staged(staged) and isinstance(staged, detect.StagedDetector)
    for batch in _batches(_versions()):
        feats = staged.extract(batch)
        want = staged.score(feats, batch).base_ids
        staged.observe(feats, batch)
        got = legacy.detect(batch.chunks, batch.ids, batch.is_new, batch.stream_hashes)
        assert got.dtype == np.int64 and np.array_equal(got, want)
        assert _same_state(_index_state(legacy), _index_state(staged))
    if name != "dedup-only":
        assert (want >= 0).any()


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_run_detect_is_extract_score_observe(name):
    a, b = _fitted(name), _fitted(name)
    for batch in _batches(_versions()):
        got = detect.run_detect(a, batch)
        feats = b.extract(batch)
        want = b.score(feats, batch)
        b.observe(feats, batch)
        assert np.array_equal(got.base_ids, want.base_ids)
        assert _same_state(_index_state(a), _index_state(b))


class _LegacyOnly:
    """A third-party detector with only the v0 single-call surface."""

    def __init__(self, inner):
        self._inner = inner
        self.name = inner.name
        self.device = inner.device

    def fit(self, streams, cfg):
        self._inner.fit(streams, cfg)

    def detect(self, chunks, ids, is_new, stream_hashes):
        return self._inner.detect(chunks, ids, is_new, stream_hashes)


def test_run_detect_falls_back_to_legacy_detect():
    wrapped = _LegacyOnly(_fitted("finesse"))
    staged = _fitted("finesse")
    assert not detect.is_staged(wrapped)
    assert not isinstance(wrapped, detect.StagedDetector)
    for batch in _batches(_versions()):
        got = detect.run_detect(wrapped, batch)
        assert np.array_equal(got.base_ids, detect.run_detect(staged, batch).base_ids)


@pytest.mark.parametrize("name", ["finesse", "card"])
def test_store_drives_a_legacy_only_detector(name):
    key = lambda s: (s.bytes_in, s.bytes_stored, s.chunks, s.dup_chunks,
                     s.delta_chunks, s.raw_chunks)
    staged = pipeline.run_workload(MAKERS[name](), _versions(), CCFG)
    legacy_det = _LegacyOnly(MAKERS[name]())
    store = DedupStore(legacy_det, CCFG, device="cpu")
    store.fit(_versions()[:1])
    for v in _versions():
        store.ingest(v)
    assert key(store.stats) == key(staged)
    assert store.stats.extract_seconds == store.stats.observe_seconds == 0.0
    for h, v in enumerate(_versions()):
        assert store.restore(h) == v


@pytest.mark.parametrize("name", ["finesse", "n-transform", "card"])
def test_score_does_not_mutate_index(name):
    det = _fitted(name)
    batch = _batches(_versions()[:1])[0]
    before = _index_state(det)
    feats = det.extract(batch)
    r1 = det.score(feats, batch)
    assert _same_state(_index_state(det), before)          # pure: nothing admitted
    r2 = det.score(feats, batch)
    assert np.array_equal(r1.base_ids, r2.base_ids)
    det.observe(feats, batch)
    assert not _same_state(_index_state(det), before)


def test_null_detector_verdicts():
    det = pipeline.NullDetector("cpu")
    batch = _batches(_versions()[:1])[0]
    assert det.extract(batch) is None
    res = det.score(None, batch)
    assert res.base_ids.dtype == np.int64 and (res.base_ids == -1).all()
    assert len(res) == len(batch)


def test_detect_batch_offsets_match_reference():
    """``DetectBatch.offsets``: each chunk's stream offset, as the
    reference's own CARD extract reads it."""
    versions = _versions()
    ref_cfg = ref_chunking.ChunkerConfig(avg_size=CCFG.avg_size)
    for batch, v in zip(_batches(versions), versions):
        ref_chunks, hashes = ref_store.chunk_with(ref_cfg, v)
        ref_batch = ref_types.DetectBatch(chunks=ref_chunks, ids=batch.ids,
                                          is_new=batch.is_new, stream_hashes=hashes)
        assert batch.offsets.dtype == ref_batch.offsets.dtype == np.int64
        np.testing.assert_array_equal(batch.offsets, ref_batch.offsets)
        assert batch.offsets[0] == 0 and (np.diff(batch.offsets) > 0).all()


def _v0_detector(protocol):
    """A detector with only the v0 protocol's ``fit`` / ``detect``: a new
    chunk deltas against the chunk at its place in the previous stream."""
    class SamePlace(protocol):
        name = "same-place"

        def fit(self, training_streams, cfg):
            self.prev = None

        def detect(self, chunks, ids, is_new, stream_hashes):
            base = np.full(len(ids), -1, np.int64)
            if self.prev is not None:
                at = np.minimum(np.arange(len(ids)), len(self.prev) - 1)
                base[is_new] = self.prev[at[is_new]]
            self.prev = ids.copy()
            return base
    return SamePlace()


def test_v0_detector_protocol_matches_reference():
    """The v0 ``Detector`` protocol has the reference's members and
    signatures, and a detector written against it drives both packages'
    stores to the same records and DCR."""
    import inspect
    for member in ("fit", "detect"):
        got = inspect.signature(getattr(pipeline.Detector, member)).parameters
        want = inspect.signature(getattr(ref_pipeline.Detector, member)).parameters
        assert list(got) == list(want)
    assert pipeline.Detector.__annotations__ == {"name": "str"} == \
        ref_pipeline.Detector.__annotations__
    versions = _versions()
    mine = DedupStore(_v0_detector(pipeline.Detector), CCFG, device="cpu")
    ref = ref_store.DedupStore(_v0_detector(ref_pipeline.Detector),
                               ref_chunking.ChunkerConfig(avg_size=CCFG.avg_size))
    for store in (mine, ref):
        store.fit(versions[:1])
        for v in versions:
            store.ingest(v)
    assert mine.stats.delta_chunks > 0
    assert (mine.stats.dcr, mine.stats.delta_chunks, mine.stats.raw_chunks) == (
        ref.stats.dcr, ref.stats.delta_chunks, ref.stats.raw_chunks)
    assert [mine.restore(h) for h in range(3)] == list(versions)
