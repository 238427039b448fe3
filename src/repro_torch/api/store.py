"""Session-oriented dedup + delta-compression store (port of
``repro.api.store``, whole: ingest, the restore read path, the lifecycle
lock, reclamation, scrub, the digest-table seam and observability).

    session = store.open_stream()
    session.write(part1); session.write(part2)   # stage bytes
    report = session.commit()                    # chunk/detect/store
    store.restore(report.handle)                 # byte-identical

Commit runs the reference's passes: 0 chunk (kernel A scan + host
boundary walk); 1 exact dedup by blake2b and id assignment; 2 extract,
score (kernels B and C); 3a delta-vs-raw decisions over a worklist;
3b one group write plus the recipe (with its chunk lengths, when the
backend takes them); then the detector observes the stream. Ids start
past the backend's ``max_chunk_id()``, so a store reopened on a
persistent backend never reissues a stored id, and every stored record
counts the backend's ``record_overhead``.

``restore``, ``restore_iter`` and ``restore_range`` go through the
backend's planned ``get_many`` and record a ``RestoreReport``
(``store.last_restore``). ``DedupStore`` runs on the CUDA device unless
given ``device="cpu"``; its backend is host code and takes no device.

Space reclamation is delegated to ``api/lifecycle.py``: ``delete(handle)``
retires a stream and decrefs its chunks (chunks another stream's patch
depends on stay pinned), ``collect()`` is the mark-sweep accounting pass,
``compact()`` rewrites the container without dead records, rebasing
surviving patches whose base was evicted; ``scrub()`` is the fsck walk of
``api/integrity.py``. The ``RefcountTable`` is rebuilt from the backend
on open, so a reopened store can delete and compact streams it did not
ingest. Restores and commits take the shared side of the lifecycle lock
(commits are also serialised among themselves), the lifecycle operations
and ``close`` the exclusive side.

Every store owns an ``Observability`` (``store.observe``, registry at
``store.metrics()``; a tracer when ``trace_path`` / ``trace_ring_events``
is set): commits, restores by surface, lock waits, reclamation and scrub
record into it under the reference's metric names, and the backend binds
its read-engine views to it. Stage seconds are the ones the commit
measures, after synchronising the card.
"""
from __future__ import annotations

import inspect
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.api import containers, lifecycle
from repro_torch.api.concurrency import (DeadlineExceededError, LockTimeout, RWLock,
                                         accumulate, check_deadline, remaining_time,
                                         zero_deltas)
from repro_torch.api.detect import is_staged
from repro_torch.api.refcount import RefcountTable
from repro_torch.api.restore import RecipeLayout
from repro_torch.api.types import DetectBatch, IngestReport, RestoreReport, StoreStats
from repro_torch.core import chunking, delta
from repro_torch.kernels import ops


def _accepts_lengths(add_recipe: Any) -> bool:
    """Whether a backend's ``add_recipe`` takes the ``lengths`` argument;
    False when the signature is uninspectable (ranged reads then
    materialise the recipe once)."""
    try:
        params = inspect.signature(add_recipe).parameters
    except (TypeError, ValueError):
        return False
    return "lengths" in params or any(
        p.kind is inspect.Parameter.VAR_POSITIONAL for p in params.values())


def chunk_with(chunker: Any, stream: bytes, device: torch.device | str):
    """Dispatch chunking through a registered chunker. A chunker with a
    ``chunk(stream) -> (chunks, stream_hashes)`` method is called as it
    is; anything else is a FastCDC ``ChunkerConfig`` and goes through
    kernel A's scan on ``device`` (``chunking.chunk_scan``), whose stream
    hashes stay on the device for the detector."""
    if hasattr(chunker, "chunk"):
        return chunker.chunk(stream)
    return chunking.chunk_scan(stream, chunker, device)


class StreamSession:
    """Write-then-commit handle for ingesting one stream."""

    def __init__(self, store: "DedupStore") -> None:
        self._store = store
        self._parts: list[bytes] = []
        self._closed = False
        self.report: IngestReport | None = None

    def write(self, data: bytes) -> None:
        if self._closed:
            raise RuntimeError("stream session already committed/aborted")
        self._parts.append(bytes(data))

    def commit(self) -> IngestReport:
        if self._closed:
            raise RuntimeError("stream session already committed/aborted")
        self._closed = True
        self.report = self._store._commit_stream(b"".join(self._parts))
        return self.report

    def abort(self) -> None:
        self._closed = True
        self._parts.clear()

    def __enter__(self) -> "StreamSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if not self._closed:
            if exc_type is None:
                self.commit()
            else:
                self.abort()


class DedupStore:
    """Container store with exact dedup + detector-driven delta compression."""

    def __init__(self, detector: Any,
                 chunker_cfg: chunking.ChunkerConfig | None = None,
                 backend: containers.ContainerBackend | None = None,
                 policy: Any | None = None,
                 trace_path: str | None = None,
                 trace_ring_events: int | None = None,
                 device: str | torch.device | None = None):
        self.device = ops.resolve_device(device)
        det_device = getattr(detector, "device", None)
        if det_device is not None and torch.device(det_device) != self.device:
            raise ValueError(f"detector runs on {det_device}, store on {self.device}")
        self.detector = detector
        self.cfg = chunker_cfg or chunking.ChunkerConfig()
        self.backend = backend if backend is not None else containers.InMemoryBackend()
        self.policy = policy if policy is not None else lifecycle.NeverPolicy()
        self.stats = StoreStats()
        self.reports: list[IngestReport] = []
        self._by_digest: dict[bytes, int] = {}
        # a reopened (persistent) backend already holds chunk ids; start
        # past them so new chunks never shadow stored records
        self._next_id = self.backend.max_chunk_id() + 1
        # probed once: a TypeError raised inside a two-argument add_recipe
        # must propagate, not trigger a second (duplicating) append
        self._recipe_lengths_ok = _accepts_lengths(self.backend.add_recipe)
        self._refs = RefcountTable.rebuild(self.backend)
        # ranged-restore prefix sums per handle, built lazily; dropped on
        # delete, kept across compaction (lengths are invariant under
        # rebasing)
        self._layouts: dict[int, RecipeLayout] = {}
        self.last_restore: RestoreReport | None = None
        # restores and commits take the shared side of the lifecycle lock,
        # delete / collect / compact / scrub / close the exclusive side;
        # commits are also serialised against each other. restore_iter's
        # next-batch fetches run on the prefetch pool, created on first use.
        # The registry comes first: the lock's wait observer and the
        # backend binding below record into it.
        self._init_observability(trace_path, trace_ring_events)
        self._lifecycle_lock = RWLock(observer=self._observe_lock_wait)
        self._commit_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._prefetch: ThreadPoolExecutor | None = None
        # two close flags: _closed flips first (under the stats lock) and
        # stops prefetch-pool creation; _backend_closed flips under the
        # exclusive lock right before the backend closes, so fetches in
        # flight when close() started (the drained prefetch tasks too)
        # still finish, and any fetch arriving after gets RuntimeError
        self._closed = False
        self._backend_closed = False
        # per-thread backend telemetry (None -> lifetime-attribute fallback)
        self._io_counters = getattr(self.backend, "io_counters", None)
        self._fold_io = getattr(self.backend, "fold_io_counters", None)
        # the backend's own counters become derived views of the registry
        bind = getattr(self.backend, "bind_observability", None)
        if bind is not None:
            bind(self.observe)
        self._refresh_lifecycle_stats()

    def _init_observability(self, trace_path: str | None,
                            trace_ring_events: int | None) -> None:
        # imported here, as the reference does, so that ``python -m
        # repro_torch.api.observe`` finds its module not yet imported
        from repro_torch.api import observe as om
        self.observe = om.Observability(
            trace_path=trace_path, trace_ring_events=trace_ring_events)
        m = self.observe.metrics
        # native instruments, created up front so every family is in the
        # exposition from the first snapshot, zeros included
        self._c_ingest_commits = m.counter(
            "repro_ingest_commits_total", "Committed stream sessions")
        self._c_ingest_bytes = {
            d: m.counter("repro_ingest_bytes_total",
                         "Stream bytes in vs. container bytes stored",
                         labels={"dir": d}) for d in ("in", "stored")}
        self._c_ingest_chunks = {
            k: m.counter("repro_ingest_chunks_total",
                         "Chunk dispositions at commit (DESIGN.md §2.2)",
                         labels={"kind": k})
            for k in ("dup", "delta", "raw")}
        self._h_ingest_stage = {
            s: m.histogram("repro_ingest_stage_seconds",
                           "Per-commit ingest phase timings (§8)",
                           labels={"stage": s}, bounds=om.SECONDS_BUCKETS)
            for s in ("chunk", "extract", "score", "observe", "delta", "store")}
        self._c_restore_ops = {
            s: m.counter("repro_restore_ops_total",
                         "Restore calls by serving surface (§9)",
                         labels={"surface": s})
            for s in ("full", "iter", "range")}
        self._c_restore_bytes = {
            d: m.counter("repro_restore_bytes_total",
                         "Bytes served vs. physical payload bytes read",
                         labels={"dir": d}) for d in ("out", "read")}
        self._h_restore_stage = {
            s: m.histogram("repro_restore_stage_seconds",
                           "Per-restore wall/read/decode timings (§9)",
                           labels={"stage": s}, bounds=om.SECONDS_BUCKETS)
            for s in ("total", "read", "decode")}
        self._h_restore_requests = m.histogram(
            "repro_restore_requests",
            "Physical payload reads (preads / ranged GETs) per restore",
            bounds=om.COUNT_BUCKETS)
        self._h_lock_wait = {
            s: m.histogram("repro_lock_wait_seconds",
                           "RWLock acquire wait time — the §10 "
                           "lock-contention signal",
                           labels={"lock": "lifecycle", "side": s},
                           bounds=om.SECONDS_BUCKETS)
            for s in ("read", "write")}
        # lifecycle gauges: derived views over StoreStats, copied in at
        # snapshot time
        g_bytes = {k: m.gauge("repro_store_bytes",
                              "Store accounting (live/dead per §7.2)",
                              labels={"kind": k})
                   for k in ("in", "stored", "live", "dead", "reclaimed")}
        g_dcr = m.gauge("repro_store_dcr",
                        "Lifetime data compression ratio (bytes_in / "
                        "bytes_stored)")
        g_streams = m.gauge("repro_store_streams", "Committed streams")

        def _export_store_views() -> None:
            with self._stats_lock:
                s = self.stats
                vals = {"in": s.bytes_in, "stored": s.bytes_stored,
                        "live": s.live_bytes, "dead": s.dead_bytes,
                        "reclaimed": s.reclaimed_bytes}
                dcr = s.dcr
                streams = len(self.reports)
            for k, v in vals.items():
                g_bytes[k].set(v)
            g_dcr.set(dcr)
            g_streams.set(streams)

        m.register_callback(_export_store_views)

    def _observe_lock_wait(self, side: str, seconds: float) -> None:
        self._h_lock_wait[side].observe(seconds)

    def metrics(self):
        """The store's ``MetricsRegistry`` (``.to_prometheus()``,
        ``.to_json()``, ``.snapshot()``); also ``store.observe.metrics``."""
        return self.observe.metrics

    def cache_stats(self) -> dict:
        """Lifetime cache-hierarchy signals as one flat dict, read off the
        backend: the decode cache's policy name, ghost hits and evictions,
        the cold-decode singleflight waits and collapses, the decode
        count, and the disk tier's tallies where one is configured.
        Backends without the read engine (memory) report zeros."""
        b = self.backend
        cache = getattr(b, "_cache", None)
        out = {
            "policy": getattr(cache, "policy_name", None),
            "ghost_hits": getattr(cache, "ghost_hits", 0),
            "evictions": getattr(cache, "evictions", 0),
            "singleflight_waits": getattr(b, "_sf_waits", 0),
            "singleflight_collapsed": getattr(b, "_sf_collapsed", 0),
            "decoded_chunks": getattr(b, "decoded_chunks", 0),
        }
        tier = getattr(b, "_tier", None)
        out["tier"] = None if tier is None else {
            "bytes": tier.bytes, "entries": len(tier),
            "hits": tier.hits, "misses": tier.misses,
            "bytes_served": tier.bytes_served,
            "bytes_filled": tier.bytes_filled, "dropped": tier.dropped,
        }
        return out

    def _clock(self) -> float:
        # stage timings end on the device: wait for queued kernels first
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def fit(self, training_streams: Sequence[bytes]) -> None:
        t0 = self._clock()
        self.detector.fit(training_streams, self.cfg)
        self.stats.fit_seconds += self._clock() - t0

    def open_stream(self) -> StreamSession:
        return StreamSession(self)

    def ingest(self, stream: bytes) -> StoreStats:
        """One-shot session commit; returns the aggregate."""
        session = self.open_stream()
        session.write(stream)
        session.commit()
        return self.stats

    def _commit_stream(self, stream: bytes) -> IngestReport:
        # one commit at a time (id assignment, digest table, one group
        # commit in flight); commits run beside restores but are excluded
        # from lifecycle mutations. Under a deadline scope both lock
        # waits are bounded: shedding before any chunking is the cheap place.
        check_deadline("commit")
        t = remaining_time()
        if t is None:
            self._commit_lock.acquire()
        elif not self._commit_lock.acquire(timeout=max(0.0, t)):
            raise DeadlineExceededError("commit (commit-lock wait)")
        try:
            self._acquire_read_deadline("commit")
            try:
                # fail before the chunk / detect passes run, not on the
                # closed backend after the work is done
                self._check_open()
                return self._commit_stream_locked(stream)
            finally:
                self._lifecycle_lock.release_read()
        finally:
            self._commit_lock.release()

    def _commit_stream_locked(self, stream: bytes) -> IngestReport:
        # pass 0: chunk
        t0 = self._clock()
        chunks, stream_hashes = chunk_with(self.cfg, stream, self.device)
        chunk_seconds = self._clock() - t0

        # pass 1: exact dedup; assign ids
        n = len(chunks)
        ids = np.empty(n, np.int64)
        is_new = np.zeros(n, bool)
        digests = [ck.digest for ck in chunks]
        seen_in_stream: dict[bytes, int] = {}
        for i, dig in enumerate(digests):
            ref = self._by_digest.get(dig)
            if ref is None:
                ref = seen_in_stream.get(dig)
            if ref is not None:
                ids[i] = ref
            else:
                ids[i] = self._next_id
                self._next_id += 1
                is_new[i] = True
                seen_in_stream[dig] = int(ids[i])

        # deadline probes run only in passes 0-3a: after the first
        # backend write the commit must finish
        check_deadline("commit")

        # pass 2: resemblance detection; a staged detector's index
        # admission (observe) waits until the backend writes succeed, a
        # legacy single-call detector mutates inside detect()
        extract_seconds = score_seconds = observe_seconds = 0.0
        batch = DetectBatch(chunks=chunks, ids=ids, is_new=is_new,
                            stream_hashes=stream_hashes)
        staged = n > 0 and is_staged(self.detector)
        feats = None
        if n == 0:
            base_ids = np.empty(0, np.int64)
        elif staged:
            t0 = self._clock()
            feats = self.detector.extract(batch)
            extract_seconds = self._clock() - t0
            t0 = self._clock()
            base_ids = self.detector.score(feats, batch).base_ids
            score_seconds = self._clock() - t0
        else:
            t0 = self._clock()
            base_ids = np.asarray(
                self.detector.detect(chunks, ids, is_new, stream_hashes), np.int64)
            score_seconds = self._clock() - t0

        # pass 3a: delta-vs-raw decisions over a worklist; a same-stream
        # base that is not stored yet resolves from the staged records.
        # Every stored record also costs the backend's per-record
        # overhead (headers), so the DCR is the container's footprint.
        backend = self.backend
        bytes_in = sum(ck.length for ck in chunks)
        bytes_stored = 0
        overhead = int(getattr(backend, "record_overhead", 0))
        dup_chunks = int(n - is_new.sum())
        delta_chunks = raw_chunks = 0
        delta_seconds = 0.0
        staged_data: dict[int, bytes] = {}
        records: list[tuple[int, int, bytes, bytes | None]] = []
        for i in np.flatnonzero(is_new):
            check_deadline("commit")    # last shed point: nothing written yet
            ck = chunks[i]
            cid = int(ids[i])
            entry = None
            base = int(base_ids[i])
            if base >= 0:
                base_data = staged_data.get(base)
                if base_data is None and backend.contains(base):
                    base_data = backend.get(base)
                if base_data is not None:
                    t0 = time.perf_counter()
                    d = delta.encode(ck.data, base_data)
                    delta_seconds += time.perf_counter() - t0
                    if len(d) < ck.length:
                        entry = (cid, base, d, ck.data)
                        bytes_stored += len(d) + overhead
                        delta_chunks += 1
            if entry is None:
                entry = (cid, -1, ck.data, None)
                bytes_stored += ck.length + overhead
                raw_chunks += 1
            records.append(entry)
            staged_data[cid] = ck.data

        # pass 3b: one batched backend write + recipe + flush; refcounts
        # and digests are registered only after the writes succeed
        t0 = time.perf_counter()
        put_many = getattr(backend, "put_many", None)
        if put_many is not None:
            put_many(records)
        else:                       # third-party backends: per-chunk puts
            for cid, base, payload, data in records:
                if base < 0:
                    backend.put_raw(cid, payload)
                else:
                    backend.put_delta(cid, base, payload, data=data)
        for i, (cid, base, payload, _data) in zip(np.flatnonzero(is_new), records):
            self._refs.track(cid, base, len(payload))
            self._by_digest[digests[i]] = cid
        recipe = [int(c) for c in ids]
        if self._recipe_lengths_ok:     # persist lengths for ranged restores
            handle = backend.add_recipe(recipe, [int(ck.length) for ck in chunks])
        else:
            handle = backend.add_recipe(recipe)
        for cid in recipe:              # only now do the chunks become live
            self._refs.incref_recipe(cid)
        backend.flush()
        store_seconds = time.perf_counter() - t0

        if staged:
            t0 = self._clock()
            self.detector.observe(feats, batch)
            observe_seconds = self._clock() - t0

        report = IngestReport(
            handle=handle, bytes_in=bytes_in, bytes_stored=bytes_stored,
            chunks=n, dup_chunks=dup_chunks, delta_chunks=delta_chunks,
            raw_chunks=raw_chunks,
            detect_seconds=extract_seconds + score_seconds + observe_seconds,
            chunk_seconds=chunk_seconds, delta_seconds=delta_seconds,
            extract_seconds=extract_seconds, score_seconds=score_seconds,
            observe_seconds=observe_seconds, store_seconds=store_seconds)
        with self._stats_lock:
            self.reports.append(report)
            self.stats.absorb(report)
            self._refresh_lifecycle_stats()
        self._observe_ingest(report)
        return report

    def _observe_ingest(self, r: IngestReport) -> None:
        """Record one commit into the registry (and the ring, when
        tracing): the stage seconds the report already measured, no new
        timers on the ingest path."""
        self._c_ingest_commits.inc()
        self._c_ingest_bytes["in"].inc(r.bytes_in)
        self._c_ingest_bytes["stored"].inc(r.bytes_stored)
        self._c_ingest_chunks["dup"].inc(r.dup_chunks)
        self._c_ingest_chunks["delta"].inc(r.delta_chunks)
        self._c_ingest_chunks["raw"].inc(r.raw_chunks)
        stages = (("chunk", r.chunk_seconds), ("extract", r.extract_seconds),
                  ("score", r.score_seconds), ("observe", r.observe_seconds),
                  ("delta", r.delta_seconds), ("store", r.store_seconds))
        for stage, seconds in stages:
            self._h_ingest_stage[stage].observe(seconds)
        tr = self.observe.tracer
        if tr is not None:
            total = sum(s for _, s in stages)
            pid = tr.record("ingest", total, handle=r.handle,
                            bytes_in=r.bytes_in, bytes_stored=r.bytes_stored,
                            chunks=r.chunks, dup_chunks=r.dup_chunks,
                            delta_chunks=r.delta_chunks,
                            dcr=round(r.dcr, 4))
            t0 = time.time() - total
            for stage, seconds in stages:
                tr.record("ingest." + stage, seconds, t0=t0, parent=pid)
                t0 += seconds

    # --- serving path (api/restore.py) ---------------------------------------

    def restore(self, handle: int) -> bytes:
        """Reconstruct a committed stream byte for byte by its handle;
        each distinct chunk is materialised once, through the backend's
        planned ``get_many``. Raises KeyError for a retired stream and
        IndexError for a handle the store never issued."""
        recipe = self.backend.recipe(handle)
        t0 = time.perf_counter()
        data, d = self._fetch_counted(recipe)
        out = b"".join(data[cid] for cid in recipe)
        self._note_restore(handle, len(out), len(recipe), time.perf_counter() - t0, d,
                           surface="full")
        return out

    def restore_iter(self, handle: int, batch_chunks: int = 256):
        """Stream a committed object as chunk-aligned ``bytes`` pieces,
        ``batch_chunks`` recipe slots at a time (one planned ``get_many``
        a batch). While the caller consumes batch k, batch k+1 is fetched
        on the prefetch pool. Same errors as ``restore``, raised at call
        time; the ``RestoreReport`` is recorded when the iterator is
        exhausted."""
        recipe = self.backend.recipe(handle)    # raise before iterating

        def gen():
            t0 = time.perf_counter()
            acc = zero_deltas()
            total = 0
            fut = None
            try:
                for i in range(0, len(recipe), batch_chunks):
                    part = recipe[i:i + batch_chunks]
                    if fut is not None:
                        data, d = fut.result()
                        fut = None
                    else:
                        data, d = self._fetch_counted(part)
                    accumulate(acc, d)
                    nxt = recipe[i + batch_chunks:i + 2 * batch_chunks]
                    if nxt:     # overlap the next fetch with consumption
                        fut = self._prefetch_pool().submit(self._prefetch_fetch, nxt)
                    for cid in part:
                        piece = data[cid]
                        total += len(piece)
                        yield piece
            finally:
                if fut is not None:     # abandoned mid-stream
                    fut.cancel()
            self._note_restore(handle, total, len(recipe), time.perf_counter() - t0, acc,
                               surface="iter")

        return gen()

    def restore_range(self, handle: int, offset: int, length: int) -> bytes:
        """Serve ``stream[offset:offset + length]``: the recipe's prefix
        sums map the range onto the minimal chunk window, so only the
        chunks it overlaps are read and decoded. Ranges are clamped to the
        stream's end; a negative offset or length raises ValueError."""
        recipe = self.backend.recipe(handle)
        t0 = time.perf_counter()
        acc = zero_deltas()
        first, last, skip = self._layout(handle, recipe, acc).chunk_window(offset, length)
        if last < first:
            self._note_restore(handle, 0, 0, time.perf_counter() - t0, acc,
                               surface="range")
            return b""
        part = recipe[first:last + 1]
        data, d = self._fetch_counted(part)
        accumulate(acc, d)
        blob = b"".join(data[cid] for cid in part)
        out = blob[skip:skip + min(length, len(blob) - skip)]
        self._note_restore(handle, len(out), len(part), time.perf_counter() - t0, acc,
                           surface="range")
        return out

    def stream_length(self, handle: int) -> int:
        """Total materialised bytes of a committed stream (no decoding
        when the backend kept the recipe's lengths)."""
        return self._layout(handle, self.backend.recipe(handle)).total_bytes

    # --- digest-table persistence seam ---------------------------------------

    def digest_seeds(self) -> dict[bytes, int]:
        """Snapshot of the exact-dedup digest table (content digest ->
        stored chunk id). The table lives in memory only: a store reopened
        on an existing backend starts with it empty. Callers that reopen
        stores persist this snapshot and hand it back via ``seed_digests``."""
        with self._stats_lock:
            return dict(self._by_digest)

    def seed_digests(self, mapping: dict[bytes, int]) -> int:
        """Preload the digest table from a ``digest_seeds`` snapshot.
        Entries whose chunk id is no longer stored (deleted and compacted
        away meanwhile) are skipped, so a stale snapshot never aliases
        fresh content onto missing records. Returns how many were admitted."""
        admitted = 0
        with self._commit_lock, self._lifecycle_lock.read():
            self._check_open()
            for dig, cid in mapping.items():
                cid = int(cid)
                if self.backend.contains(cid):
                    self._by_digest[bytes(dig)] = cid
                    admitted += 1
        return admitted

    def _fetch_unique(self, cids: Sequence[int]) -> dict[int, bytes]:
        """Materialise each distinct chunk id once: planned ``get_many``
        when the backend has it, per-chunk ``get`` otherwise."""
        uniq = list(dict.fromkeys(int(c) for c in cids))
        get_many = getattr(self.backend, "get_many", None)
        if get_many is not None:
            return dict(zip(uniq, get_many(uniq)))
        return {cid: self.backend.get(cid) for cid in uniq}

    def _acquire_read_deadline(self, op: str) -> None:
        """Shared lifecycle lock, bounded by the caller's deadline scope:
        an unbounded caller blocks, a request with a budget waits at most
        what is left of it and fails with ``DeadlineExceededError``."""
        t = remaining_time()
        if t is None:
            self._lifecycle_lock.acquire_read()
            return
        try:
            self._lifecycle_lock.acquire_read(timeout=max(0.0, t))
        except LockTimeout as e:
            raise DeadlineExceededError(f"{op} (lifecycle-lock wait)") from e

    def _fetch_counted(self, cids: Sequence[int]) -> tuple[dict, list]:
        """``_fetch_unique`` under the shared lifecycle lock plus this
        thread's I/O counter deltas; the snapshot pair runs on the
        fetching thread, so the deltas are exact per call even when it
        runs on the prefetch pool."""
        lock = self._lifecycle_lock
        check_deadline("restore")
        snap = self._backend_counters()
        self._acquire_read_deadline("restore")
        try:
            # a resumed restore_iter can arrive here after close(); the
            # flag flips under the write lock, so a reader that sees it
            # False is ordered before the close and fetches safely
            self._check_open()
            data = self._fetch_unique(cids)
        finally:
            lock.release_read()
        now = self._backend_counters()
        return data, [now[i] - snap[i] for i in range(len(snap))]

    def _prefetch_fetch(self, cids: Sequence[int]) -> tuple[dict, list]:
        """``_fetch_counted`` as a prefetch-pool task: folds the pool
        thread's telemetry record and metric shard when done (pool threads
        outlive the task, so lifetime totals must not wait for thread
        exit). The fold comes after the counter snapshot pair, so the
        per-call deltas are unaffected."""
        try:
            return self._fetch_counted(cids)
        finally:
            if self._fold_io is not None:
                self._fold_io()
            self.observe.metrics.fold_current()

    def _prefetch_pool(self) -> ThreadPoolExecutor:
        pool = self._prefetch
        if pool is None:
            with self._stats_lock:
                # never recreate the pool after close() drained it
                if self._closed:
                    raise RuntimeError("store is closed")
                if self._prefetch is None:
                    self._prefetch = ThreadPoolExecutor(
                        max_workers=4, thread_name_prefix="repro-prefetch")
                pool = self._prefetch
        return pool

    def _layout(self, handle: int, recipe: Sequence[int],
                acc: list | None = None) -> RecipeLayout:
        layout = self._layouts.get(handle)
        if layout is None:
            lengths = None
            recipe_lengths = getattr(self.backend, "recipe_lengths", None)
            if recipe_lengths is not None:
                lengths = recipe_lengths(handle)
            if lengths is None:     # recipe without lengths: materialise once
                data, d = self._fetch_counted(recipe)
                if acc is not None:
                    accumulate(acc, d)
                lengths = [len(data[cid]) for cid in recipe]
            layout = RecipeLayout(lengths)
            # cache only while the handle is still live, checked under the
            # shared lock: a delete retires the recipe and pops the layout
            # as one step under the exclusive lock, so an unguarded insert
            # could land after the pop and pin the layout for good
            lock = self._lifecycle_lock
            self._acquire_read_deadline("restore")
            try:
                try:
                    self.backend.recipe(handle)
                except (KeyError, IndexError):
                    pass        # deleted meanwhile: serve, don't cache
                else:
                    self._layouts[handle] = layout
            finally:
                lock.release_read()
        return layout

    def _backend_counters(self) -> tuple:
        """This thread's backend I/O counters (concurrency.COUNTER_FIELDS
        order); backends without per-thread telemetry give their lifetime
        totals, or zeros."""
        if self._io_counters is not None:
            return self._io_counters()
        b = self.backend
        return (getattr(b, "read_seconds", 0.0), getattr(b, "decode_seconds", 0.0),
                getattr(b, "bytes_read", 0), getattr(b, "cache_hits", 0),
                getattr(b, "cache_misses", 0), getattr(b, "prefetch_bytes", 0),
                getattr(b, "read_requests", 0))

    def _note_restore(self, handle: int, bytes_out: int, chunks: int,
                      seconds: float, d: Sequence, surface: str = "full") -> None:
        report = RestoreReport(
            handle=handle, bytes_out=bytes_out, chunks=chunks, seconds=seconds,
            read_seconds=d[0], decode_seconds=d[1], bytes_read=int(d[2]),
            cache_hits=int(d[3]), cache_misses=int(d[4]),
            prefetch_bytes=int(d[5]), requests=int(d[6]))
        with self._stats_lock:
            self.last_restore = report
            self.stats.absorb_restore(report)
        self._c_restore_ops[surface].inc()
        self._c_restore_bytes["out"].inc(report.bytes_out)
        self._c_restore_bytes["read"].inc(report.bytes_read)
        self._h_restore_stage["total"].observe(seconds)
        self._h_restore_stage["read"].observe(report.read_seconds)
        self._h_restore_stage["decode"].observe(report.decode_seconds)
        self._h_restore_requests.observe(report.requests)
        tr = self.observe.tracer
        if tr is not None:
            hits, misses = report.cache_hits, report.cache_misses
            pid = tr.record(
                "restore", seconds, surface=surface, handle=handle,
                bytes_out=report.bytes_out, bytes_read=report.bytes_read,
                requests=report.requests, cache_hits=hits,
                cache_misses=misses,
                hit_ratio=round(hits / max(1, hits + misses), 4))
            t0 = time.time() - seconds
            tr.record("restore.plan", max(
                0.0, seconds - report.read_seconds - report.decode_seconds),
                t0=t0, parent=pid, chunks=chunks)
            tr.record("restore.read", report.read_seconds, t0=t0,
                      parent=pid, bytes_read=report.bytes_read,
                      requests=report.requests)
            tr.record("restore.decode", report.decode_seconds, t0=t0,
                      parent=pid)
            tr.record("restore.prefetch", 0.0, t0=t0, parent=pid,
                      prefetch_bytes=report.prefetch_bytes)

    # --- space reclamation (api/lifecycle.py) --------------------------------

    def _check_open(self) -> None:
        # every surface fails with the same clean error before mutating
        # anything (a delete reaching the closed backend would retire the
        # recipe in memory, then die on the closed journal handle)
        if self._backend_closed:
            raise RuntimeError("store is closed")

    def _acquire_write_deadline(self, op: str) -> None:
        """Exclusive lifecycle lock, bounded by the caller's deadline
        scope: the write-side twin of ``_acquire_read_deadline``."""
        t = remaining_time()
        if t is None:
            self._lifecycle_lock.acquire_write()
            return
        try:
            self._lifecycle_lock.acquire_write(timeout=max(0.0, t))
        except LockTimeout as e:
            raise DeadlineExceededError(f"{op} (lifecycle-lock wait)") from e

    def delete(self, handle: int) -> int:
        """Retire a committed stream; returns the logical bytes the delete
        made reclaimable. May trigger compaction per the store policy.
        Exclusive: in-flight restores finish first, later ones see the
        post-delete state (the deleted handle then raises KeyError)."""
        check_deadline("delete")
        self._acquire_write_deadline("delete")
        try:
            self._check_open()
            return lifecycle.delete_stream(self, handle)
        finally:
            self._lifecycle_lock.release_write()

    def collect(self) -> lifecycle.CollectReport:
        """Mark-sweep accounting pass (mutates no data)."""
        self._acquire_write_deadline("collect")
        try:
            self._check_open()
            return lifecycle.collect(self)
        finally:
            self._lifecycle_lock.release_write()

    def compact(self) -> lifecycle.CompactionRun:
        """Rewrite the container without dead records, rebasing survivors.
        Exclusive: the backend swaps its chunk index and reopens its
        reader fds, so no restore may be mid-plan while it runs."""
        self._acquire_write_deadline("compact")
        try:
            self._check_open()
            return lifecycle.compact(self)
        finally:
            self._lifecycle_lock.release_write()

    def scrub(self, repair: bool = False):
        """Fsck walk: verify every stored record against its checksum,
        check recipe reachability and refcount consistency, and return a
        ``ScrubReport``; ``repair=True`` quarantines corrupt chunks and
        their dependents and retires every affected stream. Exclusive,
        like delete and compact."""
        from repro_torch.api import integrity
        self._acquire_write_deadline("scrub")
        try:
            self._check_open()
            return integrity.scrub(self, repair=repair)
        finally:
            self._lifecycle_lock.release_write()

    def _refresh_lifecycle_stats(self) -> None:
        # dead_bytes = all compaction can drop: unreferenced records plus
        # records pinned only as delta bases (rebasing frees them)
        self.stats.live_bytes = self._refs.live_bytes
        self.stats.dead_bytes = self._refs.dead_bytes + self._refs.pinned_bytes

    def close(self) -> None:
        """Idempotent. Restores arriving after close (a partly consumed
        ``restore_iter`` resumed, too) raise RuntimeError instead of
        touching the closed backend."""
        # the flag flips under the lock that guards prefetch-pool
        # creation, so no pool is created after it; then drain the pool
        # BEFORE taking the exclusive lock (its tasks take the shared
        # side, so the reverse order deadlocks); then close the backend
        # under exclusion, after in-flight restores finish
        with self._stats_lock:
            if self._closed:
                return
            self._closed = True
        if self._prefetch is not None:
            self._prefetch.shutdown(wait=True)
            self._prefetch = None
        with self._lifecycle_lock.write():
            self._backend_closed = True
            self.backend.close()
        self.observe.close()    # flush and close the JSONL trace sink
