"""The port's container backends (``repro_torch.api.containers``) against
the JAX package's ``repro.api.containers``: the same records through
``put_many`` / ``add_recipe`` / ``retire_recipe`` / ``drop_chunks`` /
``rewrite_live`` give byte-identical ``chunks.log`` and ``recipes.jsonl``
and the same index; a reopened directory serves the same reads; torn
tails recover as the reference recovers them. One case differs on
purpose: a ``chunks.log`` cut inside its 12-byte header (reference fault
1, see ``test_log_torn_inside_header_restarts_as_rcl2``)."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from repro.api import containers as ref_containers
from repro.api import faults as ref_faults
from repro_torch.api import config, containers, faults
from repro_torch.api.integrity import CorruptChunkError, CorruptJournalError
from repro_torch.core import delta

torch.set_num_threads(1)


def _records(seed: int, n: int = 40, start: int = 0):
    """Seeded (cid, base, payload, data) records: raw chunks and real
    patches against earlier chunks of the same batch."""
    rng = np.random.default_rng(seed)
    out, data = [], {}
    for cid in range(start, start + n):
        raw = bytes(rng.integers(0, 256, int(rng.integers(50, 3000)), np.uint8))
        if data and rng.random() < 0.5:
            base = int(rng.choice(list(data)))
            mixed = np.frombuffer(data[base], np.uint8).copy()
            idx = rng.integers(0, len(mixed), max(1, len(mixed) // 40))
            mixed[idx] = rng.integers(0, 256, len(idx), np.uint8)
            mixed = mixed.tobytes()
            payload = delta.encode(mixed, data[base])
            out.append((cid, base, payload, mixed))
            data[cid] = mixed
        else:
            out.append((cid, -1, raw, None))
            data[cid] = raw
    return out, data


def _files(path):
    return {f: (path / f).read_bytes() for f in ("chunks.log", "recipes.jsonl")}


def _state(b):
    return (dict(b._index), dict(b._crcs), list(b._recipes), dict(b._recipe_lens),
            b.epoch, b.record_overhead, b._log_v2, b.max_chunk_id())


def _both(tmp_path, **kw):
    return (containers.FileBackend(tmp_path / "port", **kw),
            ref_containers.FileBackend(tmp_path / "ref", **kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_file_backend_writes_the_reference_s_bytes(tmp_path, seed):
    mine, ref = _both(tmp_path)
    recs, data = _records(seed)
    for b in (mine, ref):
        b.put_many(recs[:25])
        b.add_recipe([r[0] for r in recs[:25]], [len(data[r[0]]) for r in recs[:25]])
        b.flush()
        for cid, base, payload, d in recs[25:]:
            if base < 0:
                b.put_raw(cid, payload)
            else:
                b.put_delta(cid, base, payload, data=d)
        b.add_recipe([r[0] for r in recs[20:]])             # no lengths
        b.add_recipe([r[0] for r in recs[::3]], [len(data[r[0]]) for r in recs[::3]])
        b.flush()
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    assert _state(mine) == _state(ref)
    cids = [r[0] for r in recs]
    assert mine.get_many(cids[::-1] + cids[:5]) == ref.get_many(cids[::-1] + cids[:5])
    assert mine.get_many(cids) == [data[c] for c in cids]
    for cid in cids:
        assert mine.record(cid) == ref.record(cid)
        assert (mine.base_of(cid), mine.payload_size(cid), mine.checksum_of(cid)) == (
            ref.base_of(cid), ref.payload_size(cid), ref.checksum_of(cid))
    live = set(mine.recipe(0)) | set(mine.recipe(2))
    victim = next(c for c in reversed(cids) if c not in live)
    for b in (mine, ref):
        b.retire_recipe(1)
        b.drop_chunks([victim])
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    assert (mine.live_handles(), mine.num_streams(), mine.recipe_lengths(0),
            mine.recipe_lengths(2)) == (ref.live_handles(), ref.num_streams(),
                                        ref.recipe_lengths(0), ref.recipe_lengths(2))
    # compaction: rebase the survivors of recipes 0 and 2 as raw / patches
    keep = sorted(live)
    rewrite = [(cid, *mine.record(cid)) for cid in keep]
    rewrite = [(cid, kind, base, payload) if base in keep or kind == 0
               else (cid, 0, -1, data[cid]) for cid, kind, base, payload in rewrite]
    for b in (mine, ref):
        b.rewrite_live(iter(rewrite))
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    assert _state(mine) == _state(ref)
    assert mine.storage_bytes() == ref.storage_bytes()
    assert mine.get_many(keep) == [data[c] for c in keep]
    mine.close()
    ref.close()
    again, ref_again = _both(tmp_path)
    assert _state(again) == _state(ref_again)
    assert again.get_many(keep) == [data[c] for c in keep]
    for h in (0, 2):
        assert again.recipe(h) == ref_again.recipe(h)
    with pytest.raises(KeyError, match="stream 1 retired"):
        again.recipe(1)
    with pytest.raises(IndexError, match="unknown stream handle -1"):
        again.recipe(-1)
    again.close()
    ref_again.close()


def test_in_memory_backend_has_the_whole_protocol():
    mine, ref = containers.InMemoryBackend(), ref_containers.InMemoryBackend()
    recs, data = _records(5)
    for b in (mine, ref):
        assert isinstance(b, ref_containers.ContainerBackend)
        assert isinstance(b, containers.ContainerBackend)
        assert b.max_chunk_id() == -1 and b.record_overhead == 0
        b.put_many(recs[:30])
        for cid, base, payload, d in recs[30:]:
            if base < 0:
                b.put_raw(cid, payload)
            else:
                b.put_delta(cid, base, payload, data=d)
        b.add_recipe([r[0] for r in recs], [len(data[r[0]]) for r in recs])
        b.add_recipe([r[0] for r in recs[:3]])
        b.retire_recipe(1)
    cids = [r[0] for r in recs]
    for cid in cids:
        assert mine.record(cid) == ref.record(cid)
        assert (mine.base_of(cid), mine.payload_size(cid), mine.checksum_of(cid),
                mine.get(cid)) == (ref.base_of(cid), ref.payload_size(cid),
                                   ref.checksum_of(cid), ref.get(cid))
    assert mine.get_many(cids) == ref.get_many(cids) == [data[c] for c in cids]
    assert (mine.max_chunk_id(), sorted(mine.chunk_ids()), mine.storage_bytes(),
            mine.live_handles(), mine.num_streams(), mine.recipe_lengths(0)) == (
        ref.max_chunk_id(), sorted(ref.chunk_ids()), ref.storage_bytes(),
        ref.live_handles(), ref.num_streams(), ref.recipe_lengths(0))
    with pytest.raises(KeyError, match="stream 1 retired"):
        mine.recipe_lengths(1)
    keep = [c for c in cids if mine.base_of(c) < 0]
    for b in (mine, ref):
        b.rewrite_live((c, *b.record(c)[:2], b.record(c)[2]) for c in keep)
        b.drop_chunks(keep[-1:])
    assert mine.epoch == ref.epoch == 1
    assert sorted(mine.chunk_ids()) == sorted(ref.chunk_ids()) == keep[:-1]
    assert mine.storage_bytes() == ref.storage_bytes()
    with pytest.raises(KeyError, match="is not stored"):
        mine.put_delta(999, 12345, b"x")
    mine.flush()
    mine.close()


def _small_dir(tmp_path, name="d", **kw):
    """A small RCL2 directory: 3 records (one a patch) in 2 recipes."""
    b = containers.FileBackend(tmp_path / name, **kw)
    raw0, raw1 = b"A" * 40 + b"B" * 40, bytes(range(60))
    b.put_many([(0, -1, raw0, None), (1, -1, raw1, None),
                (2, 0, delta.encode(raw0[:70] + b"CC", raw0), raw0[:70] + b"CC")])
    b.add_recipe([0, 1], [len(raw0), len(raw1)])
    b.add_recipe([2, 1, 0], [72, len(raw1), len(raw0)])
    b.close()
    return tmp_path / name


@pytest.mark.parametrize("cut", range(1, 12))
def test_log_torn_inside_header_restarts_as_rcl2(tmp_path, cut):
    """The port differs from the reference here on purpose (reference
    fault 1). A ``chunks.log`` cut to 1-11 bytes, inside its 12-byte
    ``RCL2`` + epoch header, holds no record (a v1 record header alone is
    25 bytes). The reference reads it as a header-less v1 log, truncates
    it to 0, writes a fresh RCL2 header and then appends v1 records after
    it, so the next open parses those records as v2 and the stream
    ingested in between is lost. The port treats such a log as empty: it
    is truncated to 0, reopened as RCL2 with v2 records, and a stream
    ingested after the reopen restores after a second reopen."""
    path = _small_dir(tmp_path)
    os.truncate(path / "chunks.log", cut)
    cfg = config.DedupConfig.from_dict({"detector": "dedup-only", "backend": "file",
                                        "backend_args": {"path": str(path)},
                                        "chunker_args": {"avg_size": 1024}})
    store = config.build_store(cfg, device="cpu")
    b = store.backend
    b.flush()
    assert (path / "chunks.log").read_bytes() == containers._LOG_HEADER.pack(
        containers._LOG_MAGIC2, 0)
    assert b._log_v2 and b.record_overhead == containers._REC_HEADER2.size == 29
    assert b.live_handles() == [] and b.num_streams() == 2     # both recovery-retired
    assert store._next_id == 3          # ids named by the retired recipes stay burned
    stream = bytes(np.random.default_rng(cut).integers(0, 256, 20_000, np.uint8))
    handle = store.open_stream()
    handle.write(stream)
    report = handle.commit()
    assert report.bytes_stored == report.bytes_in + 29 * report.raw_chunks
    store.close()
    again = config.build_store(cfg, device="cpu")
    assert again.backend._log_v2
    assert again.restore(report.handle) == stream
    assert again.stream_length(report.handle) == len(stream)
    again.close()


def _reopen_pair(tmp_path, cut_log, cut_recipes):
    """The small directory in two copies, cut the same, opened by each
    package's FileBackend."""
    src = _small_dir(tmp_path, "src")
    out = []
    for name in ("port", "ref"):
        dst = tmp_path / name
        dst.mkdir()
        for f in ("chunks.log", "recipes.jsonl"):
            blob = (src / f).read_bytes()
            cut = cut_log if f == "chunks.log" else cut_recipes
            (dst / f).write_bytes(blob if cut is None else blob[:cut])
    return (containers.FileBackend(tmp_path / "port"),
            ref_containers.FileBackend(tmp_path / "ref"))


def _compare_reopened(tmp_path, mine, ref):
    assert _state(mine) == _state(ref)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    for h in ref.live_handles():
        assert mine.get_many(mine.recipe(h)) == ref.get_many(ref.recipe(h))
        assert mine.recipe_lengths(h) == ref.recipe_lengths(h)
    mine.close()
    ref.close()


def test_log_cuts_past_the_header_recover_as_the_reference(tmp_path):
    """Every cut of a small log from its full header on (and none), with
    the recipe journal whole: the same index, recipes, recovery
    retirements, truncated files and restores as the reference."""
    size = (_small_dir(tmp_path, "probe") / "chunks.log").stat().st_size
    for cut in [None, 0] + list(range(12, size)):
        sub = tmp_path / f"log{cut}"
        sub.mkdir()
        mine, ref = _reopen_pair(sub, cut, None)
        _compare_reopened(sub, mine, ref)


@pytest.mark.parametrize("cut_log", [None, 12, 130])
def test_recipe_cuts_recover_as_the_reference(tmp_path, cut_log):
    size = (_small_dir(tmp_path, "probe") / "recipes.jsonl").stat().st_size
    for cut in range(0, size, 5):
        sub = tmp_path / f"rec{cut}"
        sub.mkdir()
        mine, ref = _reopen_pair(sub, cut_log, cut)
        _compare_reopened(sub, mine, ref)


def test_mid_journal_damage_raises_as_the_reference(tmp_path):
    path = _small_dir(tmp_path)
    lines = (path / "recipes.jsonl").read_bytes().split(b"\n")
    lines[1] = b"{not json"
    (path / "recipes.jsonl").write_bytes(b"\n".join(lines))
    with pytest.raises(CorruptJournalError, match="line 2"):
        containers.FileBackend(path)
    with pytest.raises(ValueError, match="line 2"):
        ref_containers.FileBackend(path)


def test_verify_reads_raises_on_a_flipped_payload_bit(tmp_path):
    path = _small_dir(tmp_path)
    b = containers.FileBackend(path)
    _, _, offset, _ = b._index[1]
    b.close()
    faults.flip_bit(path / "chunks.log", offset + 5)
    checked = containers.FileBackend(path, verify_reads=True)
    with pytest.raises(CorruptChunkError) as err:
        checked.get_many([1])
    assert err.value.cid == 1
    checked.close()
    unchecked = containers.FileBackend(path)
    assert unchecked.get(1) != bytes(range(60))     # served as it is, unverified
    unchecked.close()


def test_crashpoint_in_put_many(tmp_path):
    inj = faults.FaultInjector()
    b = containers.FileBackend(tmp_path / "d", faults=inj)
    inj.arm("file.put_many.written")
    with pytest.raises(faults.SimulatedCrash):
        b.put_many([(0, -1, b"x" * 100, None)])
    assert inj.hits == {"file.put_many.written": 1}
    assert set(faults.registered_crashpoints()) >= {
        p for p in ref_faults.registered_crashpoints() if p.startswith("file.")}
    b.close()


def _open_fds() -> int:
    return len(os.listdir("/proc/self/fd"))


def test_close_releases_every_fd_and_pool(tmp_path):
    before = _open_fds()
    b = containers.FileBackend(tmp_path / "d", reader_fds=6, readahead=3,
                               coalesce_gap=0, cache_bytes=1)
    recs, data = _records(9, n=60)
    b.put_many(recs)
    b.flush()
    cids = [r[0] for r in recs]
    assert b.get_many(cids) == [data[c] for c in cids]    # several runs: readahead
    assert b._executor is not None and b.read_requests > 1
    assert _open_fds() == before + 6 + 2
    b.close()
    assert b._executor is None and _open_fds() == before


def test_planned_reads_count_bytes_requests_and_cache(tmp_path):
    recs, data = _records(11, n=50)
    mine, ref = _both(tmp_path, cache_bytes=1 << 20, readahead=2)
    for b in (mine, ref):
        b.put_many(recs)
        b.flush()
        b._cache.retain(lambda cid: False)
    cids = [r[0] for r in recs][::-1]
    assert mine.get_many(cids) == ref.get_many(cids)
    counters = lambda b: (b.bytes_read, b.read_requests, b.cache_hits, b.cache_misses,
                          b.decoded_chunks)
    assert counters(mine) == counters(ref)
    assert mine.get_many(cids) == ref.get_many(cids)        # warm
    assert counters(mine) == counters(ref)
    assert hashlib.sha256(b"".join(mine.get_many(cids))).digest() == hashlib.sha256(
        b"".join(data[c] for c in cids)).digest()
    mine.close()
    ref.close()
    assert json.loads((tmp_path / "port" / "recipes.jsonl").read_text()) == {"epoch": 0}


def test_concurrent_planned_reads_stay_exact(tmp_path):
    """Eight threads read overlapping chains through one backend whose
    cache is smaller than the data (evictions, pins and cold-decode
    singleflight all race), with a short switch interval: every read is
    exact and no pin is left behind."""
    import sys
    import threading
    recs, data = _records(13, n=120)
    b = containers.FileBackend(tmp_path / "d", cache_bytes=40_000, readahead=2,
                               coalesce_gap=0, reader_fds=3)
    b.put_many(recs)
    b.flush()
    cids = [r[0] for r in recs]
    errors = []

    def reader(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(15):
                pick = [int(c) for c in rng.choice(cids, 25)]
                if b.get_many(pick) != [data[c] for c in pick]:
                    errors.append(seed)
        except Exception as e:          # reported below, with the seed
            errors.append((seed, repr(e)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader, args=(s,)) for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert b._cache._pins == {} and b._flights == {}
    b.close()
