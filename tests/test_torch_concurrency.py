"""The port's lifecycle lock (``repro_torch.api.concurrency.RWLock`` /
``LockTimeout``) and how the store uses it, against the reference's
semantics: writer preference, timeouts that leave the lock untouched, a
``delete`` that waits for an in-flight restore batch, deadline-bounded
lock waits, and a ``close()`` that drains a live prefetch pool before it
takes the exclusive side (the reverse order deadlocks). Every wait on
another thread has its own timeout, and every test a time limit, so a
deadlock fails here instead of hanging the suite."""
import threading
import time

import numpy as np
import pytest
import torch

from repro.api import concurrency as ref_concurrency
from repro_torch.api import concurrency, config
from test_torch_lifecycle import time_limit

torch.set_num_threads(1)
_limit = time_limit(20)

LOCKS = {"ref": ref_concurrency, "port": concurrency}
JOIN = 10.0                     # seconds any helper thread may take


def _start(fn, *args):
    out = {}

    def run():
        try:
            out["value"] = fn(*args)
        except BaseException as e:      # noqa: BLE001 - handed to the test
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def _finish(t, out):
    t.join(JOIN)
    assert not t.is_alive(), "helper thread deadlocked"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _wait_for(cond, what):
    end = time.monotonic() + JOIN
    while not cond():
        assert time.monotonic() < end, f"never saw {what}"
        time.sleep(0.005)


@pytest.mark.parametrize("which", sorted(LOCKS))
def test_writer_preference_and_timeouts(which):
    mod = LOCKS[which]
    seen = []
    lock = mod.RWLock(observer=lambda side, s: seen.append(side))
    lock.acquire_read()
    writer = _start(lock.acquire_write)
    _wait_for(lambda: lock._writers_waiting == 1, "the writer wait")
    # a new reader queues behind the waiting writer (writer preference)
    with pytest.raises(mod.LockTimeout) as err:
        lock.acquire_read(timeout=0.05)
    assert (err.value.side, err.value.timeout) == ("read", 0.05)
    assert str(err.value) == "RWLock read acquisition timed out after 0.050s"
    lock.release_read()
    _finish(*writer)
    assert lock._writer_active and lock._readers == 0
    with pytest.raises(mod.LockTimeout):
        lock.acquire_read(timeout=0.02)
    lock.release_write()
    assert seen == ["read", "read", "write", "read"]   # failed waits too


@pytest.mark.parametrize("which", sorted(LOCKS))
def test_timed_out_writer_releases_waiting_readers(which):
    """A writer that gives up must not keep holding readers back."""
    mod = LOCKS[which]
    lock = mod.RWLock()
    lock.acquire_read()
    writer = _start(lock.acquire_write, 0.2)
    _wait_for(lambda: lock._writers_waiting == 1, "the writer wait")
    reader = _start(lock.acquire_read)
    with pytest.raises(mod.LockTimeout):
        _finish(*writer)
    _finish(*reader)                    # woken when the writer gave up
    assert lock._readers == 2 and lock._writers_waiting == 0


def test_write_context_manager_is_exclusive():
    lock = concurrency.RWLock()
    with lock.write():
        with pytest.raises(concurrency.LockTimeout):
            lock.acquire_write(timeout=0.01)
        with pytest.raises(concurrency.LockTimeout):
            lock.acquire_read(timeout=0.01)
    with lock.read(), lock.read(timeout=0.01):
        assert lock._readers == 2


# --- the store ------------------------------------------------------------------

def _data(size, seed):
    return bytes(np.random.default_rng(seed).integers(0, 256, size, np.uint8))


def _store(tmp_path, backend="file"):
    d = {"detector": "dedup-only", "chunker_args": {"avg_size": 4096}, "backend": backend}
    if backend != "memory":
        d["backend_args"] = {"path": str(tmp_path / "s")}
    return config.build_store(config.DedupConfig.from_dict(d), device="cpu")


class Gate:
    """Wraps ``backend.get_many``: each call announces itself and then
    waits until the test opens the gate."""

    def __init__(self, backend):
        self.entered = threading.Event()
        self.open = threading.Event()
        real = backend.get_many

        def gated(cids):
            self.entered.set()
            assert self.open.wait(JOIN), "gate never opened"
            return real(cids)

        backend.get_many = gated


def test_delete_waits_for_an_in_flight_restore_iter_batch(tmp_path):
    store = _store(tmp_path)
    a, b = _data(100_000, 1), _data(100_000, 2)
    store.ingest(a)
    store.ingest(b)
    ha, hb = 0, 1
    gate = Gate(store.backend)
    pieces = store.restore_iter(ha, batch_chunks=4)
    first = _start(next, pieces)        # its first batch blocks in get_many
    assert gate.entered.wait(JOIN)
    deleting = _start(store.delete, ha)
    _wait_for(lambda: store._lifecycle_lock._writers_waiting == 1, "delete waiting")
    time.sleep(0.05)
    assert deleting[0].is_alive()       # held off by the batch in flight
    gate.open.set()
    piece = _finish(*first)
    assert _finish(*deleting) > 0
    assert a.startswith(piece)
    # the rest of the iterator runs against the post-delete state; the
    # payloads stay on disk until a compaction, so it still completes
    assert piece + b"".join(pieces) == a
    with pytest.raises(KeyError):
        store.restore(ha)
    assert store.restore(hb) == b
    store.close()


def test_lifecycle_ops_wait_for_a_restore_and_commits_run_beside_it(tmp_path):
    store = _store(tmp_path)
    a = _data(60_000, 3)
    store.ingest(a)
    gate = Gate(store.backend)
    restoring = _start(store.restore, 0)
    assert gate.entered.wait(JOIN)
    committing = _start(store.ingest, _data(30_000, 4))     # shared side too
    compacting = _start(store.compact)
    _wait_for(lambda: "value" in committing[1] or "error" in committing[1], "the commit")
    assert compacting[0].is_alive()
    gate.open.set()
    assert _finish(*restoring) == a
    _finish(*committing)
    assert not _finish(*compacting).skipped
    store.close()


def test_deadline_bounds_the_lifecycle_lock_wait(tmp_path):
    store = _store(tmp_path, "memory")
    store.ingest(_data(20_000, 5))
    store._lifecycle_lock.acquire_read()
    try:
        with concurrency.deadline_scope(0.05):
            with pytest.raises(concurrency.DeadlineExceededError, match="delete"):
                store.delete(0)
    finally:
        store._lifecycle_lock.release_read()
    # the deadline is the calling thread's: hold the exclusive side here
    # and restore here, where the bounded wait gives up instead of blocking
    with store._lifecycle_lock.write(), concurrency.deadline_scope(0.05):
        with pytest.raises(concurrency.DeadlineExceededError, match="restore"):
            store.restore(0)
    assert store.delete(0) > 0
    store.close()


def test_close_with_a_live_prefetch_pool_finishes(tmp_path):
    """A partly consumed ``restore_iter`` has its next batch in flight on
    the prefetch pool when ``close()`` runs: close drains the pool, then
    takes the exclusive side and closes the backend; the abandoned
    iterator then fails cleanly."""
    store = _store(tmp_path)
    a = _data(200_000, 6)
    store.ingest(a)
    pieces = store.restore_iter(0, batch_chunks=2)
    got = next(pieces)                  # batch 2 is now on the pool
    assert store._prefetch is not None
    _finish(*_start(store.close))
    assert store._prefetch is None and store._backend_closed
    with pytest.raises(RuntimeError, match="store is closed"):
        got += b"".join(pieces)
    assert a.startswith(got)
    for op in (lambda: store.restore(0), lambda: store.delete(0), store.collect,
               store.compact, store.scrub, lambda: store.ingest(b"x" * 10),
               lambda: store.seed_digests({})):
        with pytest.raises(RuntimeError, match="store is closed"):
            op()
    store.close()                       # idempotent


def test_close_waits_for_an_in_flight_restore(tmp_path):
    store = _store(tmp_path)
    a = _data(60_000, 7)
    store.ingest(a)
    gate = Gate(store.backend)
    restoring = _start(store.restore, 0)
    assert gate.entered.wait(JOIN)
    closing = _start(store.close)
    _wait_for(lambda: store._closed, "close started")
    time.sleep(0.05)
    assert closing[0].is_alive() and not store._backend_closed
    gate.open.set()
    assert _finish(*restoring) == a
    _finish(*closing)
    assert store._backend_closed


def test_close_drains_the_pool_before_taking_the_exclusive_side(tmp_path):
    """A prefetch task that has not reached the shared side yet when
    ``close()`` starts: close must wait for it before it takes the
    exclusive side, or the task waits for the lock while close waits
    for the task."""
    store = _store(tmp_path)
    a = _data(200_000, 8)
    store.ingest(a)
    counters = store._io_counters

    def slow_in_the_pool():
        if threading.current_thread().name.startswith("repro-prefetch"):
            time.sleep(0.3)             # close() starts meanwhile
        return counters()

    store._io_counters = slow_in_the_pool
    pieces = store.restore_iter(0, batch_chunks=2)
    next(pieces)                        # batch 2 is submitted to the pool
    closing, _ = _start(store.close)
    closing.join(5)
    if closing.is_alive():
        # deadlocked: free the pool thread (the interpreter joins pool
        # threads at exit, so a stuck one would hang the whole run), then fail
        lock = store._lifecycle_lock
        with lock._cond:
            lock._writer_active = False
            lock._cond.notify_all()
        closing.join(5)
        pytest.fail("close() deadlocked against its own prefetch pool")
    assert store._prefetch is None and store._backend_closed
