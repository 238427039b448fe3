"""The port's scrub (``repro_torch.api.integrity.scrub``, ``ScrubReport``,
``DedupStore.scrub``) against the JAX package's, after the scrub cases
of ``tests/test_integrity.py``: both packages ingest the same streams
into byte-identical directories, the same bits are flipped in each, and
the port's ``ScrubReport`` (without ``seconds``) equals the reference's,
before and after ``repair=True``; the follow-up scrub is clean, also
after a reopen."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro_torch import api
from repro_torch.api import config
from repro_torch.api.faults import flip_bit
from test_torch_lifecycle import disk_bytes, time_limit

torch.set_num_threads(1)
_limit = time_limit(30)

BACKENDS = ["file", "objectstore"]


def _data(size=150_000, seed=0):
    return bytes(np.random.default_rng(seed).integers(0, 256, size, np.uint8))


def _store(which, root, backend, **knobs):
    d = {"detector": "finesse", "backend": backend, "backend_args": {"path": str(root)},
         **knobs}
    if which == "port":
        return config.build_store(config.DedupConfig.from_dict(d), device="cpu")
    return ref_api.build_store(ref_api.DedupConfig.from_dict(d))


def _ingest(store, data):
    with store.open_stream() as s:
        s.write(data)
    return s.report.handle


def _cold(store):
    store.backend._cache.retain(lambda cid: False)


def _payload_files(root, backend):
    return [root / "chunks.log"] if backend == "file" else sorted(root.glob("e*/chunks/*"))


def _fields(report) -> dict:
    d = dataclasses.asdict(report)
    d.pop("seconds")
    return d


def _key(report):
    return _fields(report), report.clean


class Pair:
    """The same store in both packages, each in its own directory."""

    def __init__(self, tmp_path, backend, **knobs):
        self.backend, self.knobs = backend, knobs
        self.roots = {w: tmp_path / w for w in ("ref", "port")}
        self.stores = {w: _store(w, r, backend, **knobs) for w, r in self.roots.items()}

    def each(self, fn):
        return {w: fn(s) for w, s in self.stores.items()}

    def same(self, fn):
        out = self.each(fn)
        assert out["port"] == out["ref"]
        return out["port"]

    def flush_and_compare_dirs(self):
        self.each(lambda s: s.backend.flush())
        assert disk_bytes(self.roots["port"]) == disk_bytes(self.roots["ref"])

    def flip(self, pick):
        """Flip the bit ``pick(store, root)`` names, in both directories."""
        for w, s in self.stores.items():
            path, offset, bit = pick(s, self.roots[w])
            flip_bit(path, offset, bit)
        self.each(_cold)

    def scrub(self, repair=False):
        return self.same(lambda s: _key(s.scrub(repair=repair)))

    def reopen(self):
        self.each(lambda s: s.close())
        self.stores = {w: _store(w, r, self.backend) for w, r in self.roots.items()}

    def close(self):
        self.each(lambda s: s.close())


@pytest.mark.parametrize("backend", BACKENDS)
def test_scrub_clean_and_fully_verified(tmp_path, backend):
    p = Pair(tmp_path, backend)
    data = _data()
    p.each(lambda s: s.fit([data]))
    h = p.same(lambda s: _ingest(s, data))
    rep, clean = p.scrub()
    assert clean and rep["chunks"] > 0 and rep["verified"] == rep["chunks"]
    assert rep["unverifiable"] == 0 and rep["streams"] == 1 and not rep["repaired"]
    assert p.stores["port"].restore(h) == data
    p.close()


def test_scrub_memory_backend():
    data = _data(60_000)
    reports = []
    for which in ("ref", "port"):
        d = {"detector": "finesse", "backend": "memory"}
        store = (config.build_store(config.DedupConfig.from_dict(d), device="cpu")
                 if which == "port" else ref_api.build_store(ref_api.DedupConfig.from_dict(d)))
        store.fit([data])
        _ingest(store, data)
        reports.append(_key(store.scrub()))
        store.close()
    assert reports[0] == reports[1]
    assert reports[1][1] and reports[1][0]["verified"] == reports[1][0]["chunks"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_bitflip_detected_and_repaired(tmp_path, backend):
    p = Pair(tmp_path, backend, verify_reads=True)
    data = _data()
    p.each(lambda s: s.fit([data]))
    h = p.same(lambda s: _ingest(s, data))
    p.flush_and_compare_dirs()

    def middle(store, root):
        target = _payload_files(root, backend)[0]
        return target, os.path.getsize(target) // 2, 3

    p.flip(middle)
    errs = p.each(lambda s: pytest.raises(Exception, s.restore, h).value)
    assert type(errs["port"]).__name__ == type(errs["ref"]).__name__ == "CorruptChunkError"
    assert isinstance(errs["port"], api.CorruptChunkError)
    assert (errs["port"].cid, errs["port"].expected, errs["port"].actual) == (
        errs["ref"].cid, errs["ref"].expected, errs["ref"].actual)

    rep, clean = p.scrub()
    assert not clean and rep["corrupt"] and rep["streams_lost"] == (h,)
    assert all(rep["blast_radius"][c] == 1 for c in rep["corrupt"])
    fix, _ = p.scrub(repair=True)
    assert fix["repaired"] and fix["retired_streams"] == (h,)
    assert set(fix["quarantined"]) >= set(rep["lost"])
    assert p.scrub()[1]
    p.same(lambda s: type(pytest.raises((KeyError, IndexError), s.restore, h).value).__name__)
    p.flush_and_compare_dirs()
    p.reopen()                          # quarantine and retire are durable
    assert p.scrub()[1]
    assert h not in p.stores["port"].backend.live_handles()
    p.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_scrub_detects_without_verify_reads(tmp_path, backend):
    p = Pair(tmp_path, backend)
    data = _data(seed=3)
    p.each(lambda s: s.fit([data]))
    p.same(lambda s: _ingest(s, data))
    p.flush_and_compare_dirs()

    def middle(store, root):
        target = _payload_files(root, backend)[0]
        return target, os.path.getsize(target) // 2, 0

    p.flip(middle)
    rep, clean = p.scrub()
    assert not clean and len(rep["corrupt"]) >= 1
    p.close()


def _chunk_of(which_cids):
    def pick(store, root):
        cid = which_cids(store)
        _, _, off, ln = store.backend._index[cid]
        return root / "chunks.log", off + ln // 2, 0
    return pick


def test_repair_spares_untouched_streams(tmp_path):
    p = Pair(tmp_path, "file", verify_reads=True)
    a, b = _data(seed=1), _data(seed=2)
    p.each(lambda s: s.fit([a]))
    ha = p.same(lambda s: _ingest(s, a))
    hb = p.same(lambda s: _ingest(s, b))
    p.flush_and_compare_dirs()

    def only_b(store):
        ra = set(store.backend.recipe(ha))
        return [c for c in store.backend.recipe(hb) if c not in ra][0]

    p.flip(_chunk_of(only_b))
    fix, _ = p.scrub(repair=True)
    assert hb in fix["retired_streams"] and ha not in fix["retired_streams"]
    assert p.scrub()[1]
    assert p.stores["port"].restore(ha) == a
    p.close()


def test_blast_radius_counts_sharing_streams(tmp_path):
    p = Pair(tmp_path, "file")
    data = _data(seed=5)
    p.each(lambda s: s.fit([data]))
    h1 = p.same(lambda s: _ingest(s, data))
    h2 = p.same(lambda s: _ingest(s, data))
    p.flush_and_compare_dirs()

    def shared(store):
        return [c for c in store.backend.recipe(h1) if c in set(store.backend.recipe(h2))][0]

    p.flip(_chunk_of(shared))
    rep, _ = p.scrub()
    cid = shared(p.stores["port"])
    assert cid in rep["corrupt"] and rep["blast_radius"][cid] == 2
    assert set(rep["streams_lost"]) == {h1, h2}
    p.close()


def test_refcount_drift_is_structural(tmp_path):
    p = Pair(tmp_path, "file")
    data = _data(60_000, seed=9)
    p.each(lambda s: s.fit([data]))
    p.same(lambda s: _ingest(s, data))
    assert p.scrub()[1]

    def drift(store):
        store._refs.live_bytes += 12345
    p.each(drift)
    rep, _ = p.scrub()
    assert any("refcount drift" in e for e in rep["structural_errors"])
    p.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_scrub_after_compaction_matches_reference(tmp_path, backend):
    """Scrub of a compacted store, and after a flip in the rewritten log."""
    p = Pair(tmp_path, backend)
    a, b = _data(seed=11), _data(seed=12)
    p.each(lambda s: s.fit([a]))
    ha = p.same(lambda s: _ingest(s, a))
    p.same(lambda s: _ingest(s, b))
    p.each(lambda s: s.delete(ha))
    p.same(lambda s: _fields(s.compact()))
    p.flush_and_compare_dirs()
    rep, clean = p.scrub()
    assert clean and rep["verified"] == rep["chunks"]

    def last(store, root):
        target = _payload_files(root, backend)[-1]
        return target, os.path.getsize(target) - 7, 5

    p.flip(last)
    assert not p.scrub()[1]
    p.scrub(repair=True)
    assert p.scrub()[1]
    p.close()
