"""Fault injection for durability testing (port of ``repro.api.faults``).

    TransientError      retryable object-store failure (HTTP 429/5xx in
                        spirit); raised by fault hooks, absorbed by
                        ``ObjectStoreBackend``'s retry policy
    RetryBudgetExceeded a ``TransientError`` raised when the retry
                        policy's total-deadline budget runs out
    with_retries        the decorrelated-jitter retry loop
    FaultSchedule       a deterministic ``fault_hook`` failing chosen
                        per-op request ordinals
    SimulatedCrash      raised by an armed crashpoint; a ``BaseException``
                        so no ``except Exception`` path absorbs it
    FaultInjector       arms named crashpoints; backends thread one
                        through their write paths via ``faults=``
    flip_bit / flip_byte / truncate_tail
                        on-disk corruption injectors (bit rot, torn
                        writes, power-loss truncation)
    run_crash_script / snapshot_dir / check_crash_invariants / abandon
                        the crash-matrix harness: drive an op script
                        until an armed crashpoint fires, copy the
                        directory as a ``kill -9`` left it, reopen and
                        check the post-crash contract

Crashpoints are registered at import time by the modules that place them
(``containers.py``, ``objectstore.py``); ``registered_crashpoints()`` is
the matrix. This module imports nothing of the port, so every layer can
depend on it without cycles.
"""
from __future__ import annotations

import dataclasses
import os
import random
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Sequence


class TransientError(Exception):
    """A retryable object-store failure — the moral equivalent of HTTP
    429/500/503 or a socket timeout. ``ObjectStoreBackend`` retries
    these with exponential backoff; anything else propagates."""

    def __init__(self, status: int = 503,
                 msg: str = "transient object-store error") -> None:
        super().__init__(f"{status}: {msg}")
        self.status = status


class RetryBudgetExceeded(TransientError):
    """The retry policy's total-deadline budget ran out (§11.2).

    Subclasses ``TransientError`` so callers that treat "the store is
    flaky right now" generically keep working; carries the forensic
    detail a bounded-hang policy owes its caller: how many attempts
    were issued and how long the policy slept before giving up."""

    def __init__(self, attempts: int, slept: float, deadline: float,
                 last: Exception | None = None) -> None:
        self.attempts = int(attempts)
        self.slept = float(slept)
        self.deadline = float(deadline)
        self.last = last
        status = getattr(last, "status", 503)
        Exception.__init__(
            self,
            f"retry deadline of {deadline:.3f}s exceeded after "
            f"{attempts} attempts ({slept:.3f}s slept); last error: "
            f"{last}")
        self.status = status


def with_retries(fn: Callable, args: Sequence = (), *,
                 max_retries: int = 4, backoff: float = 0.05,
                 cap: float | None = None, deadline: float | None = None,
                 rng: random.Random | None = None,
                 on_attempt: Callable[[float, bool], None] | None = None,
                 on_backoff: Callable[[float, int], None] | None = None,
                 sleep: Callable[[float], None] = time.sleep):
    """The audited decorrelated-jitter retry loop (§11.2/§13.5) as a
    reusable helper — one implementation shared by
    ``ObjectStoreBackend._call`` and the §15 serving layer instead of
    each caller hand-rolling its own backoff math.

    Calls ``fn(*args)``. On ``TransientError``: sleep a decorrelated
    jittered delay (``uniform(backoff, 3 * previous_delay)``, capped at
    ``cap``, default ``backoff * 2^max_retries``) and reissue, up to
    ``max_retries`` reissues AND at most ``deadline`` total seconds
    asleep — whichever budget runs out first. Exhausting the attempt
    budget re-raises the last ``TransientError``; exhausting the
    deadline raises ``RetryBudgetExceeded`` with the attempt count and
    slept seconds. Any non-transient exception propagates immediately.

    Observation hooks (all optional, all called outside the sleep):
    ``on_attempt(seconds, ok)`` after every issue of ``fn`` — including
    failed ones — with its wall time; ``on_backoff(delay, attempt)``
    once per absorbed fault, right before sleeping. ``rng``/``sleep``
    are injectable for deterministic tests."""
    if rng is None:
        rng = random.Random()
    if cap is None:
        cap = backoff * (1 << max_retries)
    attempt = 0
    slept = 0.0
    prev_delay = backoff
    while True:
        t0 = time.perf_counter() if on_attempt is not None else 0.0
        try:
            result = fn(*args)
        except TransientError as e:
            if on_attempt is not None:
                on_attempt(time.perf_counter() - t0, False)
            if attempt >= max_retries:
                raise
            delay = rng.uniform(backoff, min(cap, prev_delay * 3))
            if deadline is not None and slept + delay > deadline:
                raise RetryBudgetExceeded(attempt + 1, slept, deadline,
                                          last=e) from e
            prev_delay = delay
            if on_backoff is not None:
                on_backoff(delay, attempt + 1)
            sleep(delay)
            slept += delay
            attempt += 1
            continue
        if on_attempt is not None:
            on_attempt(time.perf_counter() - t0, True)
        return result


class FaultSchedule:
    """A ``fault_hook`` that fails chosen per-op request ordinals.

    ``FaultSchedule({"get": [2, 3]})`` raises a ``TransientError`` on
    the 2nd and 3rd GET-class requests (counting per op, 1-based) and
    lets everything else through — deterministic, so tests can assert
    exactly how many retries a restore needed."""

    def __init__(self, fail: dict[str, Sequence[int]],
                 status: int = 503) -> None:
        self._fail = {op: set(int(n) for n in ns) for op, ns in fail.items()}
        self._status = status
        self._seen: dict[str, int] = {}
        self._lock = threading.Lock()

    def __call__(self, op: str, key: str, n: int) -> Exception | None:
        with self._lock:
            k = self._seen.get(op, 0) + 1
            self._seen[op] = k
        if k in self._fail.get(op, ()):
            return TransientError(self._status,
                                  f"injected fault: {op} #{k} ({key})")
        return None


# --- crashpoints --------------------------------------------------------------

class SimulatedCrash(BaseException):
    """Raised when an armed crashpoint is hit. A ``BaseException`` on
    purpose: the point is to model the process dying *here*, and a
    well-meaning ``except Exception`` recovery path absorbing it would
    test the handler instead of the crash."""

    def __init__(self, point: str) -> None:
        super().__init__(f"simulated crash at {point!r}")
        self.point = point


# name -> description; populated at import time by the modules that
# place the crashpoint calls (containers.py, objectstore.py)
_CRASHPOINTS: dict[str, str] = {}


def register_crashpoint(name: str, description: str) -> str:
    """Declare a crashpoint once, at module import. Re-registering the
    same name with the same description is a no-op (modules reload under
    ``python -m``); a conflicting description is a hard error — two
    different boundaries must never share a matrix row."""
    existing = _CRASHPOINTS.get(name)
    if existing is not None and existing != description:
        raise ValueError(f"crashpoint {name!r} already registered with a "
                         f"different description")
    _CRASHPOINTS[name] = description
    return name


def registered_crashpoints() -> dict[str, str]:
    """The crash matrix: every registered ``name -> description``."""
    return dict(_CRASHPOINTS)


class FaultInjector:
    """Arms crashpoints; backends call ``crashpoint(name)`` at every
    fsync/rename/PUT boundary they registered.

    ``arm(name, ordinal)`` makes the *ordinal*-th hit of ``name``
    *after arming* raise ``SimulatedCrash`` (1-based; default the next
    one). Counting from the arm call — not from injector construction —
    means a harness can build a store (whose setup may already cross
    the boundary, e.g. the manifest PUT) and still catch the first hit
    its own op script causes. Hit counts are kept for every registered
    point whether armed or not, so a harness can assert its op script
    actually reached the boundary it meant to test (``hits``).
    Thread-safe — write paths may run on pool threads."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._armed: dict[str, int] = {}
        self.hits: dict[str, int] = {}
        self.fired: list[str] = []

    def arm(self, point: str, ordinal: int = 1) -> None:
        if point not in _CRASHPOINTS:
            raise ValueError(f"unknown crashpoint {point!r}; registered: "
                             f"{sorted(_CRASHPOINTS)}")
        if ordinal < 1:
            raise ValueError(f"ordinal must be >= 1, got {ordinal}")
        with self._lock:
            # absolute target hit count: ordinal is relative to *now*
            self._armed[point] = self.hits.get(point, 0) + int(ordinal)

    def disarm(self, point: str | None = None) -> None:
        with self._lock:
            if point is None:
                self._armed.clear()
            else:
                self._armed.pop(point, None)

    def crashpoint(self, point: str) -> None:
        """Called by instrumented code. Counts the hit; raises
        ``SimulatedCrash`` when this hit is the armed ordinal."""
        with self._lock:
            n = self.hits.get(point, 0) + 1
            self.hits[point] = n
            fire = self._armed.get(point) == n
            if fire:
                self.fired.append(point)
        if fire:
            raise SimulatedCrash(point)


# --- on-disk corruption injectors ---------------------------------------------

def flip_bit(path: str | Path, byte_offset: int, bit: int = 0) -> int:
    """Flip one bit of the file at ``path`` in place (bit rot). Returns
    the new byte value. Offsets are validated so a drifted test corrupts
    loudly instead of silently extending the file."""
    if not 0 <= bit < 8:
        raise ValueError(f"bit must be in [0, 8), got {bit}")
    path = os.fspath(path)
    size = os.path.getsize(path)
    if not 0 <= byte_offset < size:
        raise ValueError(f"offset {byte_offset} outside {path} "
                         f"({size} bytes)")
    with open(path, "r+b") as f:
        f.seek(byte_offset)
        old = f.read(1)[0]
        new = old ^ (1 << bit)
        f.seek(byte_offset)
        f.write(bytes([new]))
    return new


def flip_byte(path: str | Path, byte_offset: int) -> int:
    """Invert one whole byte in place; returns the new value."""
    for bit in range(1, 8):     # flip the remaining 7 bits
        flip_bit(path, byte_offset, bit)
    return flip_bit(path, byte_offset, 0)


def truncate_tail(path: str | Path, nbytes: int) -> int:
    """Drop the last ``nbytes`` of the file (power-loss truncation /
    torn write). Returns the new size; truncating more than the file
    holds leaves it empty."""
    path = os.fspath(path)
    size = os.path.getsize(path)
    new = max(0, size - max(0, int(nbytes)))
    os.truncate(path, new)
    return new


# --- crash-matrix harness -----------------------------------------------------

@dataclasses.dataclass
class CrashRun:
    """What one scripted run did before (maybe) crashing.

    ``committed`` maps stream name -> (handle, bytes) for every ingest
    whose commit *returned*; ``deleted`` holds names whose delete
    returned; ``pending`` is the op that was in flight when the crash
    fired (its effects are allowed to be absent — or, for a delete,
    either applied or not); ``crashed_at`` is the crashpoint name, or
    None when the script ran to completion."""

    committed: dict[str, tuple[int, bytes]]
    deleted: set[str]
    pending: tuple | None
    crashed_at: str | None


def run_crash_script(store: Any, ops: Sequence[tuple]) -> CrashRun:
    """Drive a portable op script against ``store`` until an armed
    crashpoint fires (or the script completes). Ops:

        ("ingest", name, data)   open_stream/write/commit
        ("delete", name)         delete a previously committed stream
        ("compact",)             store.compact()
        ("collect",)             store.collect()
        ("flush",)               backend flush

    The shadow state records only *completed* ops, so the returned
    ``CrashRun`` is exactly what a client that saw its calls return
    would be entitled to find after the crash."""
    committed: dict[str, tuple[int, bytes]] = {}
    deleted: set[str] = set()
    pending: tuple | None = None
    crashed_at: str | None = None
    try:
        for op in ops:
            pending = op
            kind = op[0]
            if kind == "ingest":
                _, name, data = op
                with store.open_stream() as s:
                    s.write(data)
                committed[name] = (s.report.handle, bytes(data))
            elif kind == "delete":
                store.delete(committed[op[1]][0])
                deleted.add(op[1])
            elif kind == "compact":
                store.compact()
            elif kind == "collect":
                store.collect()
            elif kind == "flush":
                store.backend.flush()
            else:
                raise ValueError(f"unknown crash-script op {op!r}")
            pending = None
    except SimulatedCrash as crash:
        crashed_at = crash.point
    return CrashRun(committed=committed, deleted=deleted,
                    pending=pending, crashed_at=crashed_at)


def snapshot_dir(src: str | Path, dst: str | Path) -> Path:
    """Copy the store directory as the on-disk state a ``kill -9`` left:
    bytes the process wrote through to the OS are present, bytes still
    sitting in user-space buffers of the abandoned (never closed) store
    object are not — which is exactly the distinction the crash model
    needs. Call it *before* dropping the crashed store, so no interpreter
    finalizer can flush more state into the copy."""
    dst = Path(dst)
    shutil.copytree(src, dst)
    return dst


def check_crash_invariants(store: Any, run: CrashRun) -> list[str]:
    """The §13 post-crash contract, checked on a *reopened* store:

      1. ``scrub()`` reports the store clean (recovery already retired
         anything the crash tore);
      2. every stream whose commit returned — and that was not deleted —
         restores byte-identically;
      3. every stream whose delete returned stays deleted;
      4. the op in flight at the crash may have happened or not, but a
         half-state is never visible: an in-flight ingest's stream simply
         doesn't exist (its commit never returned a handle), an in-flight
         delete's stream is either intact or gone.

    Returns a list of violation descriptions — empty means the store
    honoured the contract."""
    errors: list[str] = []
    report = store.scrub()
    if not report.clean:
        errors.append(f"scrub not clean after reopen: "
                      f"corrupt={list(report.corrupt)} "
                      f"missing={list(report.missing)} "
                      f"streams_lost={list(report.streams_lost)} "
                      f"structural={list(report.structural_errors)}")
    pending_delete = (run.pending[1]
                      if run.pending and run.pending[0] == "delete"
                      else None)
    for name, (handle, data) in run.committed.items():
        if name in run.deleted:
            try:
                store.restore(handle)
            except (KeyError, IndexError):
                continue
            errors.append(f"deleted stream {name!r} (handle {handle}) "
                          f"resurrected")
        elif name == pending_delete:
            try:
                got = store.restore(handle)
            except (KeyError, IndexError):
                continue        # the in-flight delete landed: fine
            if got != data:
                errors.append(f"stream {name!r} (handle {handle}) "
                              f"survived its in-flight delete but "
                              f"restored wrong bytes")
        else:
            try:
                got = store.restore(handle)
            except Exception as e:      # noqa: BLE001 - report, don't mask
                errors.append(f"committed stream {name!r} (handle "
                              f"{handle}) unrestorable: {e!r}")
                continue
            if got != data:
                errors.append(f"committed stream {name!r} (handle "
                              f"{handle}) restored wrong bytes "
                              f"({len(got)} vs {len(data)})")
    return errors


def abandon(store: Any) -> None:
    """Best-effort resource release of a crashed store *after* the
    directory snapshot was taken. Close may legitimately fail (the crash
    fired mid-mutation); anything it still manages to flush goes to the
    original directory, never the snapshot."""
    try:
        store.close()
    except BaseException:       # noqa: BLE001 - crashed object, anything goes
        pass
