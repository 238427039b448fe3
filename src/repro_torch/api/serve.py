"""Multi-tenant serving front end over one long-lived DedupStore (port of
``repro.api.serve``, whole; DESIGN.md §15).

The paper's setting is a cloud provider deduplicating across many users.
``DedupServer`` is the service layer over one store:

    per-tenant namespaces   a stream handle belongs to the tenant that
                            committed it; a restore or delete of a foreign
                            handle fails with KeyError, as a handle that
                            never existed does
    quotas                  stored bytes (admission-checked against the
                            upper bound, settled to the deduplicated
                            actual after commit), concurrent in-flight
                            requests, and an optional per-tenant
                            ``DecodeCache`` of whole streams in front of
                            the shared store
    admission control       a bounded per-tenant queue; a request that
                            cannot be queued is shed synchronously with
                            ``OverloadError``
    request deadlines       every request runs inside a ``deadline_scope``;
                            lock waits, restores and commit passes shed
                            with ``DeadlineExceededError``
    graceful degradation    a ``CircuitBreaker`` over backend transient
                            faults turns writes away while restores go on,
                            and closes again through half-open probes

Every shed is typed and leaves the store untouched: ``OverloadError``
(queue full, raised by ``submit``), ``QuotaExceededError``,
``CircuitOpenError`` (write while the breaker is not closed) and
``DeadlineExceededError``. The ``repro_server_*`` / ``repro_tenant_*``
families go into the store's registry.

On the card, a CARD ingest launches kernels A, B and C from the server's
worker threads (see ``DedupServer._ingest``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable

from repro_torch.api.concurrency import (DeadlineExceededError, LockTimeout,
                                   check_deadline, deadline_scope,
                                   remaining_time)
from repro_torch.api.faults import TransientError
from repro_torch.api.restore import DecodeCache


class RequestRejected(Exception):
    """Base of the shed taxonomy (§15.2): raised instead of queueing
    when admitting (or continuing) the request could not meet its SLO.
    The request did no store work; the client may back off and retry."""


class OverloadError(RequestRejected):
    """The tenant's admission queue is full. Raised synchronously by
    ``submit`` — overload is the caller's backpressure signal, so it
    must never itself queue."""

    def __init__(self, tenant: str, pending: int, limit: int) -> None:
        super().__init__(
            f"tenant {tenant!r} overloaded: {pending} requests pending "
            f"(limit {limit})")
        self.tenant = tenant
        self.pending = pending
        self.limit = limit


class QuotaExceededError(RequestRejected):
    """Admitting this ingest could exceed the tenant's stored-bytes
    quota. Checked against the *upper bound* (raw length plus bytes
    already reserved by in-flight ingests) — dedup may store far less,
    but a quota must hold under concurrency, not just after the fact."""

    def __init__(self, tenant: str, used: int, wanted: int,
                 quota: int) -> None:
        super().__init__(
            f"tenant {tenant!r} quota exceeded: {used} bytes charged + "
            f"{wanted} requested > quota {quota}")
        self.tenant = tenant
        self.used = used
        self.wanted = wanted
        self.quota = quota


class CircuitOpenError(RequestRejected):
    """The backend circuit breaker is not closed: mutations are
    rejected so a struggling backend sees only read traffic (which the
    cache/tier can often serve) plus the half-open probes."""

    def __init__(self, state: str) -> None:
        super().__init__(
            f"backend circuit breaker is {state}: store is read-only "
            f"until half-open probes succeed")
        self.state = state


DEFAULT_MAX_INFLIGHT = 8
DEFAULT_MAX_QUEUE = 32


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """Per-tenant limits. ``quota_bytes`` bounds *charged* stored bytes
    (None = unlimited); ``max_inflight`` requests run concurrently and
    up to ``max_queue`` more wait; past that ``submit`` sheds.
    ``cache_bytes`` > 0 gives the tenant a private whole-stream
    ``DecodeCache`` (§14.1 policy machinery — ``cache_policy`` names a
    registered eviction policy) in front of the shared store, so one
    tenant's scan traffic cannot churn another's working set.
    ``default_timeout`` applies to requests submitted without one."""

    quota_bytes: int | None = None
    max_inflight: int = DEFAULT_MAX_INFLIGHT
    max_queue: int = DEFAULT_MAX_QUEUE
    cache_bytes: int = 0
    cache_policy: str = "arc"
    default_timeout: float | None = None


class CircuitBreaker:
    """Three-state breaker (§15.4) over backend transient-fault rates.

    closed — normal service; ``fail_threshold`` failures within a
    sliding ``window_seconds`` trip it open. open — writes shed
    instantly; after ``cooldown_seconds`` the next state probe moves it
    to half_open (lazily: no timer thread). half_open — reads flow as
    probes; ``probe_successes`` consecutive successes re-close it, any
    failure re-opens (and restarts the cooldown).

    ``record_failure``/``record_success`` are fed by the server with
    backend outcomes only (a quota rejection is not a backend fault).
    ``on_transition(to_state)`` is the metrics hook. ``clock`` is
    injectable for deterministic tests."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"
    STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def __init__(self, fail_threshold: int = 5, window_seconds: float = 10.0,
                 cooldown_seconds: float = 5.0, probe_successes: int = 2,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Callable[[str], None] | None = None) -> None:
        self.fail_threshold = max(1, int(fail_threshold))
        self.window_seconds = float(window_seconds)
        self.cooldown_seconds = float(cooldown_seconds)
        self.probe_successes = max(1, int(probe_successes))
        self.on_transition = on_transition
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures: list[float] = []    # timestamps inside the window
        self._opened_at = 0.0
        self._probes_ok = 0
        #: lifetime transition tally by target state — the §15.4
        #: "demonstrably opens and recovers" evidence
        self.transitions: dict[str, int] = {self.CLOSED: 0,
                                            self.HALF_OPEN: 0, self.OPEN: 0}

    def _set(self, state: str) -> None:
        # lock held. on_transition must be leaf-shaped (metrics inc).
        if state == self._state:
            return
        self._state = state
        self.transitions[state] += 1
        if self.on_transition is not None:
            self.on_transition(state)

    def _state_locked(self) -> str:
        if (self._state == self.OPEN
                and self._clock() - self._opened_at >= self.cooldown_seconds):
            self._probes_ok = 0
            self._set(self.HALF_OPEN)
        return self._state

    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def allow_write(self) -> bool:
        """Mutations only in the closed state: half-open probes are
        reads — a write probe against a flaky backend could half-commit."""
        return self.state() == self.CLOSED

    def record_failure(self) -> None:
        with self._lock:
            now = self._clock()
            st = self._state_locked()
            if st == self.HALF_OPEN:
                self._opened_at = now       # failed probe: back to open,
                self._failures.clear()      # cooldown restarts
                self._set(self.OPEN)
                return
            if st == self.OPEN:
                return
            self._failures.append(now)
            cutoff = now - self.window_seconds
            self._failures = [t for t in self._failures if t >= cutoff]
            if len(self._failures) >= self.fail_threshold:
                self._opened_at = now
                self._set(self.OPEN)

    def record_success(self) -> None:
        with self._lock:
            if self._state_locked() == self.HALF_OPEN:
                self._probes_ok += 1
                if self._probes_ok >= self.probe_successes:
                    self._failures.clear()
                    self._set(self.CLOSED)


class _Tenant:
    """One tenant's namespace + accounting. ``bytes_stored`` is the live
    charge (sum of each live handle's commit-time ``bytes_stored``);
    ``bytes_ingested`` the lifetime charge (never decremented — the
    per-tenant share of ``StoreStats.bytes_stored``, which is also
    lifetime). ``reserved`` holds the raw upper bound of in-flight
    ingests so the quota check is exact under concurrency."""

    def __init__(self, name: str, cfg: TenantConfig) -> None:
        self.name = name
        self.cfg = cfg
        self.lock = threading.Lock()
        self.slots = threading.BoundedSemaphore(cfg.max_inflight)
        self.handle_cost: dict[int, int] = {}
        self.bytes_stored = 0
        self.bytes_ingested = 0
        self.reserved = 0
        self.pending = 0        # admitted, not yet finished
        self.inflight = 0       # holding an execution slot right now
        self.requests = 0
        self.shed: dict[str, int] = {}
        self.cache = (DecodeCache(cfg.cache_bytes, policy=cfg.cache_policy)
                      if cfg.cache_bytes > 0 else None)

    def shed_one(self, reason: str) -> None:
        with self.lock:
            self.shed[reason] = self.shed.get(reason, 0) + 1


class DedupServer:
    """Thread-pool request router over one ``DedupStore`` (§15.1).

    ``submit(tenant, op, *args, timeout=...)`` admission-checks and
    returns a Future; ``ingest``/``restore``/``restore_range``/
    ``delete`` are the blocking wrappers. The executor is shared across
    tenants (work-conserving); fairness comes from the per-tenant
    inflight semaphore — a tenant can queue work but never hold more
    than ``max_inflight`` executor threads, so no tenant starves the
    pool. Tenants are auto-created on first use with ``default_tenant``
    limits; ``add_tenant`` registers explicit ones."""

    _OPS = frozenset({"ingest", "restore", "restore_range", "delete"})

    def __init__(self, store, *, workers: int = 8,
                 breaker: CircuitBreaker | None = None,
                 default_tenant: TenantConfig | None = None) -> None:
        self.store = store
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self._default_cfg = (default_tenant if default_tenant is not None
                             else TenantConfig())
        self._tenants: dict[str, _Tenant] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._pool = ThreadPoolExecutor(max_workers=max(1, int(workers)),
                                        thread_name_prefix="repro-serve")
        self._init_observability()

    # --- tenants -------------------------------------------------------------

    def add_tenant(self, name: str,
                   cfg: TenantConfig | None = None, **limits) -> TenantConfig:
        """Register a tenant with explicit limits (either a
        ``TenantConfig`` or its fields as keywords). Must happen before
        the tenant's first request; re-registering raises."""
        if cfg is None:
            cfg = TenantConfig(**limits)
        elif limits:
            raise TypeError("pass a TenantConfig or keyword limits, not both")
        with self._lock:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already exists")
            self._tenants[name] = _Tenant(name, cfg)
        return cfg

    def _tenant(self, name: str) -> _Tenant:
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                t = _Tenant(name, self._default_cfg)
                self._tenants[name] = t
            return t

    def tenants(self) -> list[str]:
        with self._lock:
            return sorted(self._tenants)

    def tenant_stats(self, name: str) -> dict:
        """Point-in-time accounting snapshot for one tenant."""
        t = self._tenant(name)
        with t.lock:
            out = {
                "tenant": t.name,
                "bytes_stored": t.bytes_stored,
                "bytes_ingested": t.bytes_ingested,
                "reserved": t.reserved,
                "quota_bytes": t.cfg.quota_bytes,
                "streams": len(t.handle_cost),
                "pending": t.pending,
                "inflight": t.inflight,
                "requests": t.requests,
                "shed": dict(t.shed),
            }
        cache = t.cache
        if cache is not None:
            out["cache_hits"] = cache.hits
            out["cache_misses"] = cache.misses
        return out

    # --- metrics -------------------------------------------------------------

    def _init_observability(self) -> None:
        m = self.store.observe.metrics
        self._m = m
        self._c_transitions = {
            s: m.counter("repro_server_breaker_transitions_total",
                         "Breaker transitions by target state (§15.4)",
                         labels={"to": s})
            for s in (CircuitBreaker.CLOSED, CircuitBreaker.HALF_OPEN,
                      CircuitBreaker.OPEN)}
        self._g_state = m.gauge(
            "repro_server_breaker_state",
            "Breaker state: 0 closed / 1 half-open / 2 open")
        self._g_inflight = m.gauge(
            "repro_server_inflight",
            "Requests holding an execution slot, all tenants")
        # chain, don't clobber: a caller may have installed its own hook
        prev = self.breaker.on_transition

        def note(state: str) -> None:
            self._c_transitions[state].inc()
            if prev is not None:
                prev(state)

        self.breaker.on_transition = note
        m.register_callback(self._export_views)

    def _count(self, op: str, outcome: str) -> None:
        self._m.counter("repro_server_requests_total",
                        "Requests by op and outcome (§15.2 taxonomy)",
                        labels={"op": op, "outcome": outcome}).inc()

    def _export_views(self) -> None:
        # derived views (§12): tenant accounting is authoritative in
        # _Tenant; copied into gauges/set_total counters at snapshot time
        self._g_state.set(CircuitBreaker.STATE_CODE[self.breaker.state()])
        with self._lock:
            tenants = list(self._tenants.values())
        m = self._m
        inflight_total = 0
        for t in tenants:
            lb = {"tenant": t.name}
            with t.lock:
                stored, inflight = t.bytes_stored, t.inflight
                queued = max(0, t.pending - t.inflight)
                requests = t.requests
                shed = dict(t.shed)
            inflight_total += inflight
            m.gauge("repro_tenant_bytes_stored",
                    "Live stored-bytes charge per tenant (§15.1)",
                    labels=lb).set(stored)
            m.gauge("repro_tenant_inflight",
                    "Requests holding an execution slot", labels=lb
                    ).set(inflight)
            m.gauge("repro_tenant_queue_depth",
                    "Admitted requests waiting for a slot", labels=lb
                    ).set(queued)
            m.counter("repro_tenant_requests_total",
                      "Lifetime requests submitted", labels=lb
                      ).set_total(requests)
            for reason, n in shed.items():
                m.counter("repro_tenant_shed_total",
                          "Requests shed by typed reason (§15.2)",
                          labels={"tenant": t.name, "reason": reason}
                          ).set_total(n)
            cache = t.cache
            if cache is not None:
                for outcome, n in (("hit", cache.hits),
                                   ("miss", cache.misses)):
                    m.counter("repro_tenant_cache_lookups_total",
                              "Per-tenant stream-cache lookups (§15.1)",
                              labels={"tenant": t.name, "outcome": outcome}
                              ).set_total(n)
        self._g_inflight.set(inflight_total)

    # --- request routing -----------------------------------------------------

    def submit(self, tenant: str, op: str, *args,
               timeout: float | None = None) -> Future:
        """Admission-check and enqueue one request; returns its Future.
        Sheds synchronously with ``OverloadError`` when the tenant's
        queue (``max_inflight + max_queue``) is full — backpressure must
        reach the caller now, not after a queue delay."""
        if op not in self._OPS:
            raise ValueError(f"unknown op {op!r} (have {sorted(self._OPS)})")
        if self._closed:
            raise RuntimeError("server is closed")
        t = self._tenant(tenant)
        if timeout is None:
            timeout = t.cfg.default_timeout
        limit = t.cfg.max_inflight + t.cfg.max_queue
        with t.lock:
            t.requests += 1
            if t.pending >= limit:
                t.shed["overload"] = t.shed.get("overload", 0) + 1
                self._count(op, "overload")
                raise OverloadError(tenant, t.pending, limit)
            t.pending += 1
        try:
            return self._pool.submit(self._run, t, op, args, timeout,
                                     time.monotonic())
        except BaseException:
            with t.lock:        # executor refused (shutdown race)
                t.pending -= 1
            raise

    # blocking wrappers — the client surface most callers want

    def ingest(self, tenant: str, data: bytes,
               timeout: float | None = None):
        """Commit one stream under the tenant's namespace; returns its
        ``IngestReport``."""
        return self.submit(tenant, "ingest", data, timeout=timeout).result()

    def restore(self, tenant: str, handle: int,
                timeout: float | None = None) -> bytes:
        return self.submit(tenant, "restore", handle,
                           timeout=timeout).result()

    def restore_range(self, tenant: str, handle: int, offset: int,
                      length: int, timeout: float | None = None) -> bytes:
        return self.submit(tenant, "restore_range", handle, offset, length,
                           timeout=timeout).result()

    def delete(self, tenant: str, handle: int,
               timeout: float | None = None) -> int:
        return self.submit(tenant, "delete", handle,
                           timeout=timeout).result()

    # --- worker body ---------------------------------------------------------

    def _run(self, t: _Tenant, op: str, args: tuple,
             timeout: float | None, t_submit: float) -> Any:
        # the deadline is end-to-end from submit(): time spent queued in
        # the executor before a worker picked this up already counts
        budget = timeout
        if timeout is not None:
            budget = max(0.0, timeout - (time.monotonic() - t_submit))
        try:
            with deadline_scope(budget):
                # the inflight slot wait counts against the deadline: a
                # request that spent its whole budget queued must shed,
                # not start a restore it can no longer finish in time
                wait = remaining_time()
                ok = (t.slots.acquire() if wait is None
                      else t.slots.acquire(timeout=max(0.0, wait)))
                if not ok:
                    raise DeadlineExceededError(f"{op} (tenant slot wait)",
                                                timeout)
                with t.lock:
                    t.inflight += 1
                try:
                    result = self._dispatch(t, op, args)
                finally:
                    with t.lock:
                        t.inflight -= 1
                    t.slots.release()
                    # pooled worker: fold per-thread I/O + metric shards
                    # so lifetime totals stay exact under thread reuse
                    self.store.observe.metrics.fold_current()
            self._count(op, "ok")
            return result
        except BaseException as e:
            self._note_failure(t, op, e)
            raise
        finally:
            with t.lock:
                t.pending -= 1

    def _note_failure(self, t: _Tenant, op: str, e: BaseException) -> None:
        if isinstance(e, QuotaExceededError):
            reason = "quota"
        elif isinstance(e, CircuitOpenError):
            reason = "circuit"
        elif isinstance(e, (DeadlineExceededError, LockTimeout)):
            reason = "deadline"
        elif isinstance(e, TransientError):
            # RetryBudgetExceeded included: the backend's own retry
            # policy already gave up, which is exactly the breaker signal
            self.breaker.record_failure()
            self._count(op, "backend_error")
            return
        else:
            self._count(op, "error")
            return
        t.shed_one(reason)
        self._count(op, reason)

    def _dispatch(self, t: _Tenant, op: str, args: tuple) -> Any:
        check_deadline(op)
        if op == "ingest":
            (data,) = args
            return self._ingest(t, data)
        if op == "restore":
            (handle,) = args
            return self._restore(t, int(handle))
        if op == "restore_range":
            handle, offset, length = args
            return self._restore_range(t, int(handle), int(offset),
                                       int(length))
        (handle,) = args
        return self._delete(t, int(handle))

    def _check_owned(self, t: _Tenant, handle: int) -> None:
        # namespace isolation: a foreign (or never-issued) handle is
        # indistinguishable from a missing one
        with t.lock:
            if handle not in t.handle_cost:
                raise KeyError(
                    f"tenant {t.name!r} has no stream {handle}")

    def _ingest(self, t: _Tenant, data: bytes):
        if not self.breaker.allow_write():
            raise CircuitOpenError(self.breaker.state())
        upper = len(data)
        quota = t.cfg.quota_bytes
        with t.lock:
            if (quota is not None
                    and t.bytes_stored + t.reserved + upper > quota):
                raise QuotaExceededError(t.name, t.bytes_stored + t.reserved,
                                         upper, quota)
            t.reserved += upper
        try:
            # the commit runs on this worker thread, so on the card kernels
            # A, B and C launch from it, on its current stream. The store's
            # commit lock serialises every commit with its device work, and
            # that keeps the launch counters and exact_matmul's process-wide
            # TF32 save / restore safe: no device work runs outside it
            session = self.store.open_stream()
            session.write(data)
            report = session.commit()
        except BaseException:
            with t.lock:
                t.reserved -= upper
            raise
        with t.lock:
            t.reserved -= upper
            t.handle_cost[report.handle] = report.bytes_stored
            t.bytes_stored += report.bytes_stored
            t.bytes_ingested += report.bytes_stored
        self.breaker.record_success()
        return report

    def _probing(self) -> bool:
        """Half-open breaker: reads must bypass the tenant cache so they
        reach the backend and act as live probes — a cache hit proves
        nothing about backend health and would leave the breaker stuck
        half-open forever (§15.4)."""
        return self.breaker.state() == CircuitBreaker.HALF_OPEN

    def _restore(self, t: _Tenant, handle: int) -> bytes:
        self._check_owned(t, handle)
        cache = t.cache
        if cache is not None and not self._probing():
            data = cache.get(handle)
            if data is not None:
                return data     # tenant-cache hit: no store, no breaker
        data = self.store.restore(handle)
        self.breaker.record_success()
        if cache is not None and len(data) <= cache.budget_bytes:
            cache.put(handle, data)
        return data

    def _restore_range(self, t: _Tenant, handle: int, offset: int,
                       length: int) -> bytes:
        if offset < 0 or length < 0:
            raise ValueError("offset/length must be non-negative")
        self._check_owned(t, handle)
        cache = t.cache
        if cache is not None and not self._probing():
            data = cache.get(handle)
            if data is not None:
                return data[offset:offset + length]
        out = self.store.restore_range(handle, offset, length)
        self.breaker.record_success()
        return out

    def _delete(self, t: _Tenant, handle: int) -> int:
        if not self.breaker.allow_write():
            raise CircuitOpenError(self.breaker.state())
        self._check_owned(t, handle)
        freed = self.store.delete(handle)
        with t.lock:
            cost = t.handle_cost.pop(handle, 0)
            t.bytes_stored -= cost
        if t.cache is not None:
            t.cache.retain(lambda h: h != handle)
        self.breaker.record_success()
        return freed

    # --- lifecycle -----------------------------------------------------------

    def close(self, close_store: bool = False) -> None:
        """Stop admitting, drain in-flight requests, optionally close
        the underlying store. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._pool.shutdown(wait=True)
        if close_store:
            self.store.close()

    def __enter__(self) -> "DedupServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
