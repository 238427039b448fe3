"""Concurrency primitives for the store and its read path (port of
``repro.api.concurrency``).

    RWLock          writer-preferring shared/exclusive lock. Restores and
                    commits take the shared side, lifecycle mutations
                    (delete / collect / compact / scrub / close: they swap
                    the chunk index and reopen file handles) the exclusive
                    side. Both acquire sides take an optional ``timeout``
                    and raise ``LockTimeout`` when it elapses.
    deadline_scope  thread-local end-to-end request deadline. Lock waits
                    and the restore / commit hot loops consult it via
                    ``remaining_time()`` / ``check_deadline()`` and fail
                    with ``DeadlineExceededError`` instead of running past
                    the budget.
    IoTelemetry     per-thread I/O counters that also aggregate to
                    lifetime totals, so a restore's report counts its own
                    reads exactly while other threads restore too.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class LockTimeout(TimeoutError):
    """An RWLock acquire gave up after its ``timeout`` elapsed. The lock
    state is untouched (nothing to release); the wait is still reported
    through the lock's observer so a wedged writer shows up in the
    ``repro_lock_wait_seconds`` histogram instead of starving readers
    silently."""

    def __init__(self, side: str, timeout: float) -> None:
        super().__init__(
            f"RWLock {side} acquisition timed out after {timeout:.3f}s")
        self.side = side
        self.timeout = timeout


class DeadlineExceededError(TimeoutError):
    """A request ran past its end-to-end deadline (DESIGN.md §15.3).
    Raised by the cooperative ``check_deadline`` probes and by
    deadline-aware lock acquisition — always *between* atomic units of
    work (never mid-write), so the store is left consistent and the
    request slot is freed instead of hanging."""

    def __init__(self, op: str = "request",
                 budget: float | None = None) -> None:
        detail = "" if budget is None else f" (budget {budget:.3f}s)"
        super().__init__(f"{op} exceeded its deadline{detail}")
        self.op = op
        self.budget = budget


_DEADLINE_TL = threading.local()


@contextmanager
def deadline_scope(timeout: float | None):
    """Bound everything inside to ``timeout`` seconds from now. Nested
    scopes keep the *tighter* absolute deadline (an outer 100 ms budget is
    not widened by an inner default of 1 s). ``None`` is a no-op scope, so
    callers can pass an optional per-request timeout straight through.

    The deadline is thread-local: it rides the request's own thread
    through store/backend code with zero plumbing, and deliberately does
    NOT leak into backend worker pools (prefetch/fetcher threads) — the
    request thread is the one doing the cooperative checks, and an
    expired deadline must never poison another tenant's request that
    happens to reuse a pool thread."""
    if timeout is None:
        yield
        return
    prev = getattr(_DEADLINE_TL, "at", None)
    prev_budget = getattr(_DEADLINE_TL, "budget", None)
    at = time.monotonic() + timeout
    budget = float(timeout)
    if prev is not None and prev < at:
        at, budget = prev, prev_budget
    _DEADLINE_TL.at = at
    _DEADLINE_TL.budget = budget
    try:
        yield
    finally:
        _DEADLINE_TL.at = prev
        _DEADLINE_TL.budget = prev_budget


def current_deadline() -> float | None:
    """Absolute ``time.monotonic()`` deadline of the innermost active
    scope on this thread, or None when unbounded."""
    return getattr(_DEADLINE_TL, "at", None)


def remaining_time() -> float | None:
    """Seconds left in the active deadline scope (may be negative once
    expired); None when unbounded."""
    at = getattr(_DEADLINE_TL, "at", None)
    return None if at is None else at - time.monotonic()


def check_deadline(op: str = "request") -> None:
    """Cooperative probe: raise ``DeadlineExceededError`` if this
    thread's deadline scope has expired; free (one getattr) when no
    scope is active, so unbounded callers pay ~nothing."""
    at = getattr(_DEADLINE_TL, "at", None)
    if at is not None and time.monotonic() >= at:
        raise DeadlineExceededError(op, getattr(_DEADLINE_TL, "budget",
                                                None))


class RWLock:
    """Shared/exclusive lock, writer-preferring, not reentrant.

    ``read()`` / ``write()`` are context managers. A thread must not
    nest acquisitions (a reader re-entering while a writer waits would
    deadlock under writer preference); callers keep critical sections
    leaf-shaped instead.

    ``observer`` (optional) is called as ``observer(side, seconds)``
    after every successful acquire with ``side`` in ``("read",
    "write")`` and the time the acquire took — the lock-contention
    signal (DESIGN.md §12.2 feeds it into the
    ``repro_lock_wait_seconds`` histogram). It runs outside the
    internal condition and must not acquire this lock. Without an
    observer the acquire paths don't even read the clock.
    """

    def __init__(self, observer=None) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer_active = False
        self._writers_waiting = 0
        self._observer = observer

    # explicit acquire/release pairs for hot paths (a generator-based
    # contextmanager costs ~4µs per cycle, which ranged reads notice);
    # the read()/write() context managers below wrap these for callers
    # off the hot path

    def acquire_read(self, timeout: float | None = None) -> None:
        obs = self._observer
        t0 = (time.perf_counter()
              if obs is not None or timeout is not None else 0.0)
        try:
            with self._cond:
                while self._writer_active or self._writers_waiting:
                    remaining = None
                    if timeout is not None:
                        remaining = timeout - (time.perf_counter() - t0)
                        if remaining <= 0:
                            raise LockTimeout("read", timeout)
                    self._cond.wait(remaining)
                self._readers += 1
        except LockTimeout:
            # failed waits still feed the contention histogram — a wedged
            # writer must be visible, not just survivable
            if obs is not None:
                obs("read", time.perf_counter() - t0)
            raise
        if obs is not None:
            obs("read", time.perf_counter() - t0)

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if not self._readers and self._writers_waiting:
                self._cond.notify_all()

    def acquire_write(self, timeout: float | None = None) -> None:
        obs = self._observer
        t0 = (time.perf_counter()
              if obs is not None or timeout is not None else 0.0)
        try:
            with self._cond:
                acquired = False
                self._writers_waiting += 1
                try:
                    while self._writer_active or self._readers:
                        remaining = None
                        if timeout is not None:
                            remaining = timeout - (time.perf_counter() - t0)
                            if remaining <= 0:
                                raise LockTimeout("write", timeout)
                        self._cond.wait(remaining)
                    acquired = True
                finally:
                    self._writers_waiting -= 1
                    # a timed-out writer may be the only thing holding
                    # readers back (writer preference): wake them
                    if not acquired and not self._writers_waiting:
                        self._cond.notify_all()
                self._writer_active = True
        except LockTimeout:
            if obs is not None:
                obs("write", time.perf_counter() - t0)
            raise
        if obs is not None:
            obs("write", time.perf_counter() - t0)

    def release_write(self) -> None:
        with self._cond:
            self._writer_active = False
            self._cond.notify_all()

    @contextmanager
    def read(self, timeout: float | None = None):
        self.acquire_read(timeout)
        try:
            yield
        finally:
            self.release_read()

    @contextmanager
    def write(self, timeout: float | None = None):
        self.acquire_write(timeout)
        try:
            yield
        finally:
            self.release_write()


#: Field order of an I/O counter snapshot — shared by the backends that
#: produce them and the store that turns deltas into RestoreReports.
#: ``requests`` counts physical payload reads (preads for the file
#: backend, ranged GETs for object stores) — the metric a latency-bound
#: remote backend is optimized on (DESIGN.md §11.3).
COUNTER_FIELDS = ("read_seconds", "decode_seconds", "bytes_read",
                  "cache_hits", "cache_misses", "prefetch_bytes",
                  "requests")


class _Counters:
    """One thread's I/O counters (a plain mutable record)."""

    __slots__ = COUNTER_FIELDS

    def __init__(self) -> None:
        self.read_seconds = 0.0
        self.decode_seconds = 0.0
        self.bytes_read = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.prefetch_bytes = 0
        self.requests = 0

    def snapshot(self) -> tuple:
        return (self.read_seconds, self.decode_seconds, self.bytes_read,
                self.cache_hits, self.cache_misses, self.prefetch_bytes,
                self.requests)


def zero_deltas() -> list:
    """A fresh all-zero counter accumulator (COUNTER_FIELDS order)."""
    return [0] * len(COUNTER_FIELDS)


def accumulate(acc: list, deltas) -> None:
    """``acc[i] += deltas[i]`` over COUNTER_FIELDS positions."""
    for i, d in enumerate(deltas):
        acc[i] += d


class _Fold:
    """Thread-local anchor: folds its thread's counter record into the
    telemetry's dead-thread aggregate when the thread exits (CPython
    tears down thread-local storage then, dropping the last reference).
    Without this a thread-per-request server would pin one record per
    thread it ever ran, growing memory and ``totals()`` cost forever."""

    __slots__ = ("_tel", "_c")

    def __init__(self, tel: "IoTelemetry", c: "_Counters") -> None:
        self._tel = tel
        self._c = c

    def __del__(self) -> None:
        try:
            self._tel._fold(self._c)
        except Exception:       # interpreter teardown: nothing to save
            pass


class IoTelemetry:
    """Per-thread counters + lock-free hot path + aggregated totals.

    ``local()`` returns this thread's counter record (created on first
    use; creation is the only locked operation). ``totals()`` sums the
    dead-thread aggregate plus every live thread's record — totals drift
    only by in-flight increments, which is the same guarantee global
    ``+=`` counters had. Exited threads' records are folded into the
    aggregate (see ``_Fold``), so lifetime cost is O(live threads).

    Pooled executors whose threads never exit must not rely on the
    ``_Fold``/GC path: call ``fold_current()`` (or wrap the task in
    ``scoped()``) when a task finishes, so lifetime totals are exact
    under thread reuse instead of trailing by whatever the pool's
    threads still hold.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._live: list[_Counters] = []
        self._dead = _Counters()
        self._tl = threading.local()

    def local(self) -> _Counters:
        c = getattr(self._tl, "c", None)
        if c is None:
            c = _Counters()
            with self._lock:
                self._live.append(c)
            self._tl.c = c
            self._tl.fold = _Fold(self, c)
        return c

    def _fold(self, c: _Counters) -> None:
        with self._lock:
            try:
                self._live.remove(c)
            except ValueError:
                return              # already folded
            accumulate_to = self._dead
            snap = c.snapshot()
            for field, value in zip(COUNTER_FIELDS, snap):
                setattr(accumulate_to, field,
                        getattr(accumulate_to, field) + value)

    def fold_current(self) -> None:
        """Fold the calling thread's counter record into the dead
        aggregate now and detach it, without waiting for thread exit.
        Idempotent with the ``_Fold`` destructor (``_fold`` ignores an
        already-folded record); the next ``local()`` call on this
        thread starts a fresh record."""
        c = getattr(self._tl, "c", None)
        if c is None:
            return
        self._tl.c = None
        self._tl.fold = None        # disarm the GC-timed fold first
        self._fold(c)

    @contextmanager
    def scoped(self):
        """Context manager form of the explicit-fold contract: yields
        this thread's counter record, folds it on exit. For executor
        tasks: ``with telemetry.scoped() as c: ...``."""
        try:
            yield self.local()
        finally:
            self.fold_current()

    def totals(self) -> tuple:
        # snapshot under the lock: a thread exiting between a locked row
        # copy and an unlocked read would _fold its counters into _dead
        # while the copied live record is still summed too, over-reporting
        # by that thread's whole lifetime
        acc = zero_deltas()
        with self._lock:
            accumulate(acc, self._dead.snapshot())
            for c in self._live:
                accumulate(acc, c.snapshot())
        return tuple(acc)

    def total(self, field: str) -> float | int:
        return self.totals()[COUNTER_FIELDS.index(field)]
