"""The port's object-store backend (``repro_torch.api.objectstore``) against
the JAX package's ``repro.api.objectstore``: over ``LocalObjectStore`` the
same records give the same object names and bytes (container objects,
journals, manifest) through commits, retirements, quarantines and
compaction; a reopened root replays to the same index and recipes, and
recovers lost or orphaned objects as the reference does; retries under a
fault schedule leave restores byte-exact; the disk tier serves, fills and
drops as the reference's."""
import json

import numpy as np
import pytest
import torch

from repro.api import objectstore as ref_os
from repro_torch.api import faults, objectstore
from repro_torch.core import delta

torch.set_num_threads(1)


def _blobs(n: int, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(0, 256, int(rng.integers(100, 6000)), np.uint8))
            for _ in range(n)]


def _objects(root) -> dict[str, bytes]:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _state(b):
    return (dict(b._index), dict(b._crcs), list(b._recipes), dict(b._recipe_lens),
            b.epoch, b._cur_seq, b._next_journal, b.max_chunk_id())


def _drive(mod, root, blobs, **kw):
    b = mod.ObjectStoreBackend(root, max_object_bytes=20_000, **kw)
    n = len(blobs)
    b.put_many([(i, -1, blobs[i], None) for i in range(n // 2)])
    b.add_recipe(list(range(n // 2)), [len(blobs[i]) for i in range(n // 2)])
    b.flush()
    # patches (opaque payloads to the backend) against the first half
    b.put_many([(i, i - n // 2, blobs[i][:50], None) for i in range(n // 2, n - 2)])
    b.put_raw(n - 2, blobs[n - 2])
    b.put_delta(n - 1, 0, blobs[n - 1][:40], data=None)
    b.add_recipe(list(range(n // 2, n)))                 # no lengths
    b.add_recipe([0, 3, 3, n - 2])
    b.flush()
    b.retire_recipe(2)
    b.drop_chunks([n - 1])
    return b


def test_objects_are_the_reference_s(tmp_path):
    blobs = _blobs(24, seed=3)
    mine = _drive(objectstore, tmp_path / "port", blobs)
    ref = _drive(ref_os, tmp_path / "ref", blobs)
    assert _objects(tmp_path / "port") == _objects(tmp_path / "ref")
    assert _state(mine) == _state(ref)
    assert mine.storage_bytes() == ref.storage_bytes()
    assert mine.get_many(list(range(12))) == ref.get_many(list(range(12))) == blobs[:12]
    for cid in range(23):
        assert mine.record(cid) == ref.record(cid)
        assert (mine.base_of(cid), mine.payload_size(cid), mine.checksum_of(cid)) == (
            ref.base_of(cid), ref.payload_size(cid), ref.checksum_of(cid))
    counts = lambda b: (b.client.requests, dict(b.client.op_counts), b.client.bytes_put,
                        b.client.bytes_got, b.read_requests)
    assert counts(mine) == counts(ref)
    keep = list(range(12)) + [22]
    for b in (mine, ref):
        b.rewrite_live((cid, 0, -1, blobs[cid]) for cid in keep)
    assert _objects(tmp_path / "port") == _objects(tmp_path / "ref")
    assert _state(mine) == _state(ref) and mine.epoch == 1
    mine.close()
    ref.close()
    again = objectstore.ObjectStoreBackend(tmp_path / "port")
    ref_again = ref_os.ObjectStoreBackend(tmp_path / "ref")
    assert _state(again) == _state(ref_again)
    assert again.get_many(keep) == [blobs[c] for c in keep]
    # recipe 1 named chunks the rewrite left out: recovery-retired on open
    assert again.live_handles() == ref_again.live_handles() == [0]
    assert again.recipe_lengths(0) == [len(blobs[i]) for i in range(12)]
    again.close()
    ref_again.close()


@pytest.mark.parametrize("damage", ["lost_journal", "lost_container", "orphans", "no_manifest"])
def test_recovery_matches_reference(tmp_path, damage):
    blobs = _blobs(20, seed=13)
    for mod, name in ((objectstore, "port"), (ref_os, "ref")):
        b = mod.ObjectStoreBackend(tmp_path / name, max_object_bytes=1 << 20)
        b.put_many([(i, -1, blobs[i], None) for i in range(10)])
        b.add_recipe(list(range(10)), [len(blobs[i]) for i in range(10)])
        b.flush()
        b.put_many([(i, i - 10, delta.encode(blobs[i], blobs[i - 10]), None)
                    for i in range(10, 20)])
        b.add_recipe(list(range(10, 20)))
        b.flush()
        b.close()
        cl = mod.LocalObjectStore(tmp_path / name)
        if damage == "lost_journal":
            cl.delete_object("e00000000/journal/00000001.json")
        elif damage == "lost_container":
            cl.delete_object("e00000000/chunks/00000000")
        elif damage == "orphans":
            cl.put("e00000000/chunks/00000042", b"orphaned bytes")
            cl.put("e00000001/chunks/00000000", b"stale epoch bytes")
        else:
            cl.delete_object("manifest.json")
    mine = objectstore.ObjectStoreBackend(tmp_path / "port")
    ref = ref_os.ObjectStoreBackend(tmp_path / "ref")
    assert _state(mine) == _state(ref)
    assert _objects(tmp_path / "port") == _objects(tmp_path / "ref")
    assert mine.live_handles() == ref.live_handles()
    for h in ref.live_handles():
        assert mine.get_many(mine.recipe(h)) == ref.get_many(ref.recipe(h))
    mine.close()
    ref.close()


def test_fault_schedule_retries_keep_reads_exact(tmp_path):
    blobs = _blobs(30, seed=5)
    b = objectstore.ObjectStoreBackend(tmp_path / "o", max_object_bytes=30_000,
                                       coalesce_gap=0, retry_backoff=0.001)
    b.put_many([(i, -1, blobs[i], None) for i in range(30)])
    b.flush()
    b.close()
    b = objectstore.ObjectStoreBackend(tmp_path / "o", retry_backoff=0.001,
                                       cache_bytes=1, readahead=0)
    b.client.fault_hook = faults.FaultSchedule({"get": [2, 3]})
    assert b.get_many(list(range(30))) == blobs
    assert b.retries == 2
    b.client.fault_hook = faults.FaultSchedule({"get": list(range(1, 20))})
    with pytest.raises(faults.TransientError, match="injected fault"):
        b.get(7)
    b.client.fault_hook = faults.FaultSchedule({"get": list(range(1, 20))})
    b._retry_deadline = 0.0
    with pytest.raises(faults.RetryBudgetExceeded):
        b.get(8)
    b.close()


def test_local_object_store_matches_reference(tmp_path):
    seen = []
    for mod, name in ((objectstore, "port"), (ref_os, "ref")):
        cl = mod.LocalObjectStore(tmp_path / name)
        cl.put("a/b/1", b"hello world")
        cl.put("a/2", b"xy")
        assert cl.get_range("a/b/1", 6, 100) == b"world"
        assert cl.head("a/2") == 2 and cl.head("nope") is None
        with pytest.raises(KeyError):
            cl.get("nope")
        with pytest.raises(ValueError, match="bad object key"):
            cl.put("../x", b"")
        cl.delete_object("a/2")
        cl.delete_object("a/2")
        seen.append((cl.list(""), cl.requests, cl.op_counts, cl.bytes_put, cl.bytes_got))
    assert seen[0] == seen[1]
    assert seen[0][0] == [("a/b/1", 11)]


def test_disk_tier_matches_reference(tmp_path):
    blobs = _blobs(40, seed=21)
    for mod, name in ((objectstore, "port"), (ref_os, "ref")):
        b = mod.ObjectStoreBackend(tmp_path / name / "o", coalesce_gap=0)
        b.put_many([(i, -1, blobs[i], None) for i in range(40)])
        b.flush()
        b.close()
    runs = {}
    for mod, name in ((objectstore, "port"), (ref_os, "ref")):
        b = mod.ObjectStoreBackend(tmp_path / name / "o", tier_path=tmp_path / name / "t",
                                   tier_bytes=60_000, cache_bytes=1, verify_reads=True)
        first = b.get_many(list(range(40)))
        second = b.get_many(list(range(0, 40, 3)))
        t = b._tier
        runs[name] = (first, second, t.hits, t.misses, t.bytes, len(t), t.bytes_served,
                      t.bytes_filled, t.dropped, b.client.op_counts.get("get"),
                      sorted(p.name for p in (tmp_path / name / "t").rglob("*") if p.is_file()))
        b.close()
    assert runs["port"] == runs["ref"]
    assert runs["port"][0] == blobs and runs["port"][2] > 0


def test_manifest_and_close(tmp_path):
    b = objectstore.ObjectStoreBackend(tmp_path / "o")
    assert json.loads((tmp_path / "o" / "manifest.json").read_text()) == {"epoch": 0}
    b.put_many([(0, -1, b"x" * 5000, None), (1, -1, b"y" * 7000, None)])
    b.add_recipe([0, 1, 0], [5000, 7000, 5000])
    b._cache.retain(lambda cid: False)
    assert b.get_many([1, 0]) == [b"y" * 7000, b"x" * 5000]   # reads flush first
    assert b._executor is None       # one coalesced run: no readahead pool
    b.close()
    with pytest.raises(ValueError, match="needs a path"):
        objectstore.ObjectStoreBackend()
