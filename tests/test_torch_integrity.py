"""The port's checksum, fault-injection and deadline / telemetry modules
(``repro_torch.api.integrity``, ``faults``, ``concurrency``) against the
JAX package's: ``crc32c`` equals the reference's on both routes (the
native wheel and the pure-Python table), the RFC 3720 vector included;
the error types carry the same messages; the fault schedule, the retry
loop, the crashpoint injector and the on-disk injectors behave the same;
deadlines and per-thread telemetry count as the reference's do."""
import random
import threading
import time

import numpy as np
import pytest
import torch

from repro.api import concurrency as ref_concurrency
from repro.api import faults as ref_faults
from repro.api import integrity as ref_integrity
from repro_torch.api import concurrency, faults, integrity

torch.set_num_threads(1)


def _blobs():
    rng = np.random.default_rng(7)
    return [b"", b"a", b"123456789"] + [bytes(rng.integers(0, 256, n, np.uint8))
                                        for n in (1, 31, 63, 4096, 65537)]


@pytest.mark.parametrize("route", ["native", "python"])
def test_crc32c_matches_reference_on_both_routes(monkeypatch, route):
    if route == "python":
        monkeypatch.setattr(integrity, "_crc32c_native", None)
    elif integrity._crc32c_native is None:
        pytest.skip("google_crc32c is not installed here")
    assert integrity.crc32c_route() == route
    # RFC 3720 B.4 test vector for CRC-32C (Castagnoli)
    assert integrity.crc32c(b"123456789") == 0xE3069283
    for blob in _blobs():
        want = ref_integrity.crc32c(blob)
        assert integrity.crc32c(blob) == want == ref_integrity._crc32c_py(blob)
        assert (integrity.crc32c(memoryview(blob)) == integrity.crc32c(bytearray(blob))
                == want)


def test_crc32c_stats_count_calls_bytes_and_seconds():
    integrity.reset_crc32c_stats()
    blobs = _blobs()
    for blob in blobs:
        integrity.crc32c(blob)
    stats = dict(integrity.CRC32C_STATS)
    assert stats["calls"] == len(blobs)
    assert stats["bytes"] == sum(len(b) for b in blobs)
    assert stats["seconds"] > 0
    integrity.reset_crc32c_stats()
    assert integrity.CRC32C_STATS == {"calls": 0, "bytes": 0, "seconds": 0.0}


@pytest.mark.parametrize("make", [
    lambda m: m.CorruptChunkError(7, "chunks.log", 0xDEADBEEF, 0x12345678),
    lambda m: m.CorruptJournalError("recipes.jsonl", 3, "unparseable journal line"),
], ids=["chunk", "journal"])
def test_corruption_errors_match_reference(make):
    mine, ref = make(integrity), make(ref_integrity)
    assert str(mine) == str(ref)
    assert isinstance(mine, type(ref).__mro__[1])     # IOError / ValueError
    assert {k: v for k, v in vars(mine).items()} == {k: v for k, v in vars(ref).items()}


def test_fault_schedule_matches_reference():
    mine = faults.FaultSchedule({"get": [2, 3], "put": [1]}, status=429)
    ref = ref_faults.FaultSchedule({"get": [2, 3], "put": [1]}, status=429)
    calls = [("get", "k", 1), ("put", "p", 2), ("get", "k", 3), ("get", "k", 4),
             ("get", "k", 5), ("list", "", 6), ("put", "p", 7)]
    for call in calls:
        a, b = mine(*call), ref(*call)
        assert (a is None) == (b is None)
        if a is not None:
            assert isinstance(a, faults.TransientError) and str(a) == str(b)
            assert a.status == b.status == 429


@pytest.mark.parametrize("fails,deadline", [(0, None), (2, None), (5, None), (3, 0.05),
                                            (3, 10.0)])
def test_with_retries_matches_reference(fails, deadline):
    def run(mod):
        n = {"calls": 0}
        slept, attempts, backoffs = [], [], []

        def fn(x):
            n["calls"] += 1
            if n["calls"] <= fails:
                raise mod.TransientError(503, f"try {n['calls']}")
            return x * 2

        try:
            out = mod.with_retries(fn, (21,), max_retries=4, backoff=0.01,
                                   deadline=deadline, rng=random.Random(5),
                                   on_attempt=lambda s, ok: attempts.append(ok),
                                   on_backoff=lambda d, a: backoffs.append((d, a)),
                                   sleep=slept.append)
        except mod.TransientError as e:
            out = (type(e).__name__, str(e), getattr(e, "attempts", None))
        return out, n["calls"], slept, attempts, backoffs

    assert run(faults) == run(ref_faults)


def test_retry_budget_error_matches_reference():
    last = faults.TransientError(429, "slow down")
    mine = faults.RetryBudgetExceeded(3, 0.25, 0.2, last=last)
    ref = ref_faults.RetryBudgetExceeded(3, 0.25, 0.2,
                                         last=ref_faults.TransientError(429, "slow down"))
    assert str(mine) == str(ref)
    assert (mine.attempts, mine.slept, mine.deadline, mine.status) == (3, 0.25, 0.2, 429)
    assert isinstance(mine, faults.TransientError)


def test_crashpoints_and_injector():
    from repro.api import objectstore as _ref_objectstore  # noqa: F401 (registers)
    from repro_torch.api import objectstore as _objectstore  # noqa: F401 (registers)
    assert faults.registered_crashpoints() == ref_faults.registered_crashpoints()
    point = "file.put_many.written"
    assert faults.register_crashpoint(point, faults.registered_crashpoints()[point]) == point
    with pytest.raises(ValueError, match="already registered"):
        faults.register_crashpoint(point, "something else")
    inj = faults.FaultInjector()
    inj.crashpoint(point)
    inj.arm(point, 2)           # counts from now: the 2nd hit after arming
    inj.crashpoint(point)
    with pytest.raises(faults.SimulatedCrash, match=point) as err:
        inj.crashpoint(point)
    assert not isinstance(err.value, Exception)     # a BaseException only
    assert inj.hits[point] == 3 and inj.fired == [point]
    with pytest.raises(ValueError, match="unknown crashpoint"):
        inj.arm("nope")
    with pytest.raises(ValueError, match="ordinal must be >= 1"):
        inj.arm(point, 0)
    inj.arm(point)
    inj.disarm()
    inj.crashpoint(point)


def test_disk_injectors_match_reference(tmp_path):
    data = bytes(range(256)) * 4
    for mod, name in ((faults, "a"), (ref_faults, "b")):
        p = tmp_path / name
        p.write_bytes(data)
        assert mod.flip_bit(p, 10, 3) == data[10] ^ 8
        assert mod.flip_byte(p, 20) == data[20] ^ 0xFF
        assert mod.truncate_tail(p, 100) == len(data) - 100
        assert mod.truncate_tail(p, 10**6) == 0
        with pytest.raises(ValueError, match="outside"):
            mod.flip_bit(p, 0)
        with pytest.raises(ValueError, match="bit must be in"):
            mod.flip_bit(p, 0, 8)
    (tmp_path / "a").write_bytes(data)
    (tmp_path / "b").write_bytes(data)
    for mod, name in ((faults, "a"), (ref_faults, "b")):
        mod.flip_bit(tmp_path / name, 5, 7)
        mod.truncate_tail(tmp_path / name, 3)
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()


def test_deadline_scope():
    assert concurrency.current_deadline() is None and concurrency.remaining_time() is None
    concurrency.check_deadline("free")          # no scope: never raises
    with concurrency.deadline_scope(10.0):
        outer = concurrency.current_deadline()
        with concurrency.deadline_scope(100.0):     # wider: the outer holds
            assert concurrency.current_deadline() == outer
        with concurrency.deadline_scope(0.0):
            time.sleep(0.001)
            with pytest.raises(concurrency.DeadlineExceededError) as err:
                concurrency.check_deadline("restore")
            ref = ref_concurrency.DeadlineExceededError("restore", 0.0)
            assert str(err.value) == str(ref) and err.value.op == "restore"
        assert concurrency.current_deadline() == outer
        assert 0 < concurrency.remaining_time() <= 10.0
    assert concurrency.current_deadline() is None
    with concurrency.deadline_scope(None):
        assert concurrency.current_deadline() is None


def test_io_telemetry_per_thread_and_totals():
    assert concurrency.COUNTER_FIELDS == ref_concurrency.COUNTER_FIELDS
    tel = concurrency.IoTelemetry()
    tel.local().bytes_read += 10
    tel.local().requests += 1

    def worker():
        c = tel.local()
        c.bytes_read += 5
        c.cache_hits += 2
        tel.fold_current()
        tel.local().bytes_read += 1       # a fresh record after the fold

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert tel.local().snapshot()[2] == 10      # this thread's own only
    assert tel.total("bytes_read") == 10 + 4 * 6
    assert tel.total("cache_hits") == 8 and tel.total("requests") == 1
    with tel.scoped() as c:
        c.decode_seconds += 0.5
    assert tel.total("decode_seconds") == 0.5
    acc = concurrency.zero_deltas()
    concurrency.accumulate(acc, (1, 2, 3, 4, 5, 6, 7))
    concurrency.accumulate(acc, (1, 1, 1, 1, 1, 1, 1))
    assert acc == [2, 3, 4, 5, 6, 7, 8]
