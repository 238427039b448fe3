"""Pluggable container backends (port of ``repro.api.containers``, whole
except ``bind_observability``, which comes with ``observe.py``;
DESIGN.md §2.3, lifecycle in §7).

A ``ContainerBackend`` owns the three persistent artifacts of the store:
chunk payloads (raw bytes or a delta patch + base reference), and stream
recipes (the ordered chunk-id list that reconstructs a stream). All store
*policy* — exact dedup, resemblance detection, delta-vs-raw decision,
accounting, and when to reclaim — stays above the backend in
``repro_torch.api.store`` and ``api/lifecycle.py``; backends only
move bytes.

    InMemoryBackend   dict-based records; reads walk each delta chain
                      down to its raw record and decode back up;
    FileBackend       append-only chunk log + recipe journal on disk.
                      Stores what is *logically* stored (patch bytes for
                      delta chunks), materializes on read by resolving the
                      base chain, and can be reopened on an existing
                      directory for restore (byte-identical; tested).

Reclamation hooks (DESIGN.md §7): recipes are *retired* (tombstoned, the
handle slot survives so later handles stay stable) rather than removed;
``rewrite_live`` atomically replaces the stored record set with the
compacted one. ``FileBackend`` stamps a monotonically increasing
**compaction epoch** in the chunk-log header and the recipe journal
header so a reopen can tell a compacted directory from an append-only
one; the two files are replaced by separate renames, so after a crash
mid-compaction the epochs may disagree by one — both intermediate states
are consistent (the new recipe set only drops retired streams, and the
old log is a record superset of the new one), and the reopen adopts the
larger epoch.
"""
from __future__ import annotations

import itertools
import json
import os
import struct
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, Protocol, Sequence, runtime_checkable

from repro_torch.api.concurrency import IoTelemetry, check_deadline
from repro_torch.api.faults import register_crashpoint
from repro_torch.api.integrity import (CorruptChunkError, CorruptJournalError,
                                       crc32c)
from repro_torch.api.registry import register_backend
from repro_torch.api.restore import (DEFAULT_CACHE_BYTES, DEFAULT_CACHE_POLICY,
                                     DEFAULT_CACHE_SHARDS, ShardedDecodeCache,
                                     coalesce_reads, plan_chains)
from repro_torch.core import delta

_REC_HEADER = struct.Struct("<BqqQ")    # v1: kind, cid, base, payload length
_REC_HEADER2 = struct.Struct("<BqqQI")  # v2 (§13.1): ... + payload crc32c
_KIND_RAW = 0
_KIND_DELTA = 1

# get_many read coalescing (DESIGN.md §9): payload extents whose gap is at
# most _READ_MERGE_GAP bytes (record headers, the odd dead record) are
# fetched as ONE sequential read; runs are capped so a single slab never
# dwarfs the decode-cache budget.
_READ_MERGE_GAP = 1 << 12
_READ_MAX_RUN = 8 << 20

# chunk-log file header: magic + compaction epoch. Logs written before the
# header existed start directly with a record whose first byte is a kind
# (0 or 1), never the magic's 'R', so both parse unambiguously. RCL2
# (§13.1) appends a crc32c to every record header; RCL1 logs still open
# (their records scrub as ``unverifiable``) and keep appending v1 records
# so one file never mixes record formats — the first compaction rewrites
# the whole log as RCL2.
_LOG_MAGIC = b"RCL1"
_LOG_MAGIC2 = b"RCL2"
_LOG_HEADER = struct.Struct("<4sQ")

# serving-engine knobs (DESIGN.md §10): fds in the pread reader pool (=
# max payload reads in flight) and how many coalesced read runs the
# fetcher keeps in flight ahead of the decode loop (0 disables readahead)
DEFAULT_READER_FDS = 4
DEFAULT_READAHEAD = 2

# FileBackend crashpoints (DESIGN.md §13.4): every write/fsync/rename
# boundary a kill can land on. Backends call them only when a
# FaultInjector was threaded in via ``faults=``; the harness in
# repro_torch.api.faults enumerates this registry as its crash matrix.
_CP_PUT_WRITTEN = register_crashpoint(
    "file.put_many.written",
    "after a group commit's buffered log append, before flush")
_CP_RECIPE_APPENDED = register_crashpoint(
    "file.recipe.appended",
    "after a recipe journal line is written, before the commit flush")
_CP_RETIRE_BEFORE_FSYNC = register_crashpoint(
    "file.retire.before_fsync",
    "after a retire tombstone is written, before its fsync")
_CP_FLUSH_BEFORE_FSYNC = register_crashpoint(
    "file.flush.before_fsync",
    "after both file flushes, before the optional commit fsync")
_CP_COMPACT_TMPS = register_crashpoint(
    "file.compact.tmps_written",
    "both compaction tmp files written+fsynced, before any rename")
_CP_COMPACT_RECIPES_RENAMED = register_crashpoint(
    "file.compact.recipes_renamed",
    "recipes renamed into place, chunk log still the old one")
_CP_COMPACT_DONE = register_crashpoint(
    "file.compact.done",
    "both renames durable, before in-memory state swaps")


class _Flight:
    """One in-flight cold decode (DESIGN.md §14.2).

    The owning plan sets ``data`` (or flags ``error``) and fires the
    event exactly once, right after the decoded bytes land in the cache;
    waiting plans block on the event instead of re-reading and
    re-decoding the same chain. Waiters hold a direct reference, so the
    owner may drop the flight from the shared table the moment it
    resolves."""

    __slots__ = ("event", "data", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.data: bytes | None = None
        self.error = False


class _ReaderPool:
    """A fixed set of O_RDONLY fds over one file, consumed via ``os.pread``.

    ``pread`` is positionless — it never touches the fd offset — so every
    fd is usable from any thread with no locking; the pool exists so the
    kernel can keep several reads genuinely in flight (each ``os.pread``
    releases the GIL for the duration of the syscall). Dispatch is
    round-robin; fds are interchangeable.
    """

    def __init__(self, path: str | Path, size: int) -> None:
        self._path = os.fspath(path)
        self.size = max(1, int(size))
        self._fds = [os.open(self._path, os.O_RDONLY)
                     for _ in range(self.size)]
        self._rr = itertools.count()

    def pread(self, offset: int, length: int) -> bytes:
        """Read up to ``length`` bytes at ``offset``; shorter only at EOF
        (callers treat a short result as a truncated record)."""
        if length <= 0:
            return b""
        fd = self._fds[next(self._rr) % len(self._fds)]
        data = os.pread(fd, length, offset)
        if len(data) == length or not data:
            return data
        parts = [data]
        got = len(data)
        while got < length:       # regular files only short-read at EOF,
            more = os.pread(fd, length - got, offset + got)   # but be safe
            if not more:
                break
            parts.append(more)
            got += len(more)
        return b"".join(parts)

    def reopen(self) -> None:
        """Swap every fd for a fresh open of the (possibly replaced-by-
        rename) path — the compaction hook. Callers guarantee no reads
        are in flight (the store's exclusive lifecycle lock)."""
        old, self._fds = self._fds, [os.open(self._path, os.O_RDONLY)
                                     for _ in range(self.size)]
        for fd in old:
            os.close(fd)

    def close(self) -> None:
        old, self._fds = self._fds, []
        for fd in old:
            os.close(fd)


@runtime_checkable
class ContainerBackend(Protocol):
    """Byte storage behind the dedup store; see module docstring."""

    # compaction epoch: starts at 0, bumped by every rewrite_live; the
    # lifecycle layer reports it and reopen logic persists it
    epoch: int

    # fixed per-record storage overhead in bytes (headers etc.); the store
    # adds it to bytes_stored so per-stream DCR matches the real container
    # footprint. 0 for backends that store payloads bare.
    record_overhead: int

    def put_raw(self, cid: int, data: bytes) -> None: ...

    def put_delta(self, cid: int, base: int, patch: bytes,
                  data: bytes | None = None) -> None:
        """Store chunk `cid` as a patch against `base`. `data` is the
        already-materialized raw bytes — backends MAY cache it but must
        not count on it (restore-after-reopen has only the patch)."""
        ...

    def put_many(self, records: Sequence[tuple[int, int, bytes,
                                               bytes | None]]) -> None:
        """Group-commit a stream's new chunks in one batched write
        (DESIGN.md §8). Each record is ``(cid, base, payload, data)``:
        ``base < 0`` stores ``payload`` as raw bytes, ``base >= 0``
        stores it as a patch with optional materialized ``data``.
        Records arrive in stream order, so any same-stream base precedes
        its dependents. Durable backends should turn the whole batch into
        one buffered append; the store issues a single ``flush()`` after
        the recipe."""
        ...

    def get(self, cid: int) -> bytes:
        """Materialized raw bytes of a chunk (delta chains resolved)."""
        ...

    def get_many(self, cids: Sequence[int]) -> list[bytes]:
        """Materialized bytes for each requested chunk, in request order
        (duplicates allowed). The batched read primitive of the restore
        planner (DESIGN.md §9): backends may plan the whole batch —
        shared base chains decoded once, payload reads sorted/coalesced
        by container offset — instead of resolving each chunk
        independently. The store falls back to per-chunk ``get`` for
        third-party backends that never implement this."""
        ...

    def contains(self, cid: int) -> bool: ...

    def max_chunk_id(self) -> int:
        """Largest chunk id ever stored, -1 when empty — a store opened on
        an existing backend seeds its id counter past this so new chunks
        never collide with (and silently shadow) persisted ones."""
        ...

    def chunk_ids(self) -> Iterable[int]: ...

    def base_of(self, cid: int) -> int:
        """Base chunk id a stored patch decodes against; -1 for raw."""
        ...

    def payload_size(self, cid: int) -> int:
        """Logically stored bytes (patch size for delta chunks)."""
        ...

    def record(self, cid: int) -> tuple[int, int, bytes]:
        """The stored record as (kind, base, payload) — the payload is the
        patch for delta chunks, not the materialized bytes."""
        ...

    def add_recipe(self, chunk_ids: Sequence[int],
                   lengths: Sequence[int] | None = None) -> int:
        """Persist a stream recipe; returns the stream handle.
        ``lengths`` are the materialized chunk lengths per recipe slot —
        persisted so ranged restores can prefix-sum a reopened stream
        without decoding it (DESIGN.md §9.3)."""
        ...

    def recipe(self, handle: int) -> list[int]: ...

    def recipe_lengths(self, handle: int) -> list[int] | None:
        """Materialized chunk lengths per recipe slot, or None when the
        recipe predates length recording (the store then derives them by
        materializing the chunks once). Same errors as ``recipe``."""
        ...

    def retire_recipe(self, handle: int) -> None:
        """Tombstone a stream recipe. The handle slot survives (later
        handles stay stable); `recipe(handle)` raises KeyError after."""
        ...

    def num_streams(self) -> int:
        """Total handles ever issued, retired slots included."""
        ...

    def live_handles(self) -> list[int]: ...

    def storage_bytes(self) -> int:
        """Current on-disk/in-core container footprint (what compaction
        shrinks); durable backends must flush before measuring."""
        ...

    def rewrite_live(self, records: Iterable[tuple[int, int, int, bytes]]) -> None:
        """Atomically replace the record set with `records` (cid, kind,
        base, payload — consumed once, so callers may stream a generator
        and backends must not hold all payloads at once) and drop
        retired-recipe tombstones, bumping the compaction epoch. Callers
        guarantee every base referenced by a delta record is itself in
        `records`."""
        ...

    def flush(self) -> None: ...

    def close(self) -> None: ...


class PlannedChainReader:
    """Shared read-side engine for record-log backends (DESIGN.md §9–§10).

    Durable backends — ``FileBackend`` here and ``ObjectStoreBackend``
    in ``repro_torch.api.objectstore`` — keep an in-memory index
    ``cid -> (kind, base, offset, length)`` over an append-only payload
    address space and serve reads through identical machinery: the §9
    chain planner, a byte-budgeted sharded decode cache, span reads
    coalesced with a backend-tunable gap, and §10.3 double-buffered
    readahead. This base class holds all of it; subclasses provide the
    storage primitives

        _read_span(offset, length)   raw payload-space read (``pread``
                                     on the file log; a ranged GET for
                                     object stores, whose offsets are
                                     virtual — see objectstore.py). A
                                     short result means truncation.
        _flush_if_dirty()            make buffered appends readable
        _fetch_width()               span reads usefully in flight
        _read_desc()                 human name for error messages

    plus the attributes ``_index``, ``_cache``, ``_telemetry``,
    ``_recipes``, ``_recipe_lens``, ``_max_recipe_cid``, ``_readahead``,
    ``_merge_gap``, ``_max_run``, ``_executor`` and ``_ex_lock``. The
    write surface (puts, recipes, compaction, durability) stays with
    each backend — only byte *reading* is shared.
    """

    # integrity defaults (§13): subclasses overwrite per instance —
    # ``_crcs`` maps cid -> persisted payload crc32c (absent for records
    # that predate checksums), ``_verify_reads`` turns on read-path
    # verification, ``_faults`` threads a FaultInjector through the
    # write-path crashpoints
    _crcs: dict[int, int] = {}
    _verify_reads = False
    _faults = None

    # cold-decode singleflight + heat defaults (§14.2, §14.4): real
    # per-instance state comes from _init_read_engine_state(); the
    # class-level Nones keep a subclass that never calls it working
    # (singleflight off, no heat signal)
    _flights = None                 # cid -> _Flight, shared across plans
    _sf_lock = None
    _singleflight = False
    _sf_waits = 0                   # plans that parked on a foreign flight
    _sf_collapsed = 0               # chunks served from a foreign flight
    _heat = None                    # cid -> lifetime request count
    # local-disk chunk tier (§14.3): remote backends install one; the
    # get_many read path consults/fills it generically
    _tier = None
    #: chunks materialized from stored payloads over the backend's
    #: lifetime (raw reads + delta decodes) — the singleflight race test
    #: pins "each base decoded exactly once" against this
    decoded_chunks = 0

    def _init_read_engine_state(self, singleflight: bool = True) -> None:
        """Per-instance singleflight/heat state; durable subclasses call
        this from ``__init__`` (the class attributes above must never be
        mutated — they would be shared across every backend)."""
        self._flights = {}
        self._sf_lock = threading.Lock()
        self._singleflight = bool(singleflight)
        self._sf_waits = 0
        self._sf_collapsed = 0
        self._heat = {}
        self.decoded_chunks = 0

    def chunk_heat(self) -> dict[int, int]:
        """Lifetime request count per chunk id (targets of ``get`` /
        ``get_many``; §14.4). Compaction placement consumes this to lay
        hot chains contiguously. Snapshot copy — safe to iterate while
        restores proceed."""
        heat = self._heat
        if heat is None:
            return {}
        with self._sf_lock:
            return dict(heat)

    def _bump_heat(self, cids) -> None:
        heat = self._heat
        if heat is not None:
            with self._sf_lock:
                for cid in cids:
                    heat[cid] = heat.get(cid, 0) + 1

    def _count_decodes(self, n: int) -> None:
        if n:
            lock = self._sf_lock
            if lock is not None:
                with lock:
                    self.decoded_chunks += n
            else:
                self.decoded_chunks += n

    def _cp(self, point: str) -> None:
        faults = self._faults
        if faults is not None:
            faults.crashpoint(point)

    def checksum_of(self, cid: int) -> int | None:
        """Persisted crc32c of the stored payload, or None when the
        record predates checksums (scrub reports it unverifiable)."""
        if cid not in self._index:
            raise KeyError(cid)
        return self._crcs.get(cid)

    def _check_payload(self, cid: int, payload: bytes) -> None:
        """Raise ``CorruptChunkError`` when a payload read off the
        container does not match its persisted checksum; records without
        one pass (there is nothing to verify them against)."""
        expected = self._crcs.get(cid)
        if expected is None:
            return
        actual = crc32c(payload)
        if actual != expected:
            raise CorruptChunkError(cid, self._read_desc(), expected, actual)

    def fold_io_counters(self) -> None:
        """Fold the calling thread's telemetry record into the lifetime
        aggregate (the pooled-executor contract —
        ``IoTelemetry.fold_current``)."""
        self._telemetry.fold_current()

    # --- lifetime I/O totals (telemetry properties, DESIGN.md §9.4) ----------

    @property
    def read_seconds(self) -> float:
        return self._telemetry.total("read_seconds")

    @property
    def decode_seconds(self) -> float:
        return self._telemetry.total("decode_seconds")

    @property
    def bytes_read(self) -> int:
        return self._telemetry.total("bytes_read")

    @property
    def prefetch_bytes(self) -> int:
        return self._telemetry.total("prefetch_bytes")

    @property
    def read_requests(self) -> int:
        """Physical payload reads issued over the backend's lifetime
        (preads / ranged GETs, one per coalesced span; §11.3)."""
        return self._telemetry.total("requests")

    def io_counters(self) -> tuple:
        """This thread's I/O counter snapshot, in
        ``repro_torch.api.concurrency.COUNTER_FIELDS`` order. The store diffs
        two snapshots around a restore for an exact per-call
        RestoreReport even while other threads restore concurrently."""
        return self._telemetry.local().snapshot()

    @property
    def cache_hits(self) -> int:
        return self._cache.hits

    @property
    def cache_misses(self) -> int:
        return self._cache.misses

    @property
    def cache_bytes(self) -> int:
        return self._cache.bytes

    @property
    def cache_peak_bytes(self) -> int:
        return self._cache.peak_bytes

    # --- reading ------------------------------------------------------------

    def _read_payload(self, offset: int, length: int) -> bytes:
        self._flush_if_dirty()
        tel = self._telemetry.local()
        tel.requests += 1
        data = self._read_span(offset, length)
        # count what actually came back, not what was asked for — and a
        # short read here is a truncated record (external truncation or
        # torn tail past the scan), which must fail loudly instead of
        # handing a short payload to delta.decode
        tel.bytes_read += len(data)
        if len(data) != length:
            raise IOError(
                f"truncated record: wanted {length} bytes at offset "
                f"{offset} of {self._read_desc()}, got {len(data)}")
        return data

    def get(self, cid: int) -> bytes:
        tel = self._telemetry.local()
        self._bump_heat((cid,))
        data = self._cache.get(cid)
        if data is not None:
            tel.cache_hits += 1
            return data
        tel.cache_misses += 1
        # walk the base chain down to a raw/cached ancestor, then apply
        # patches back up (iterative: delta chains can outgrow recursion).
        # Correctness never depends on cache retention: `data` is a local
        # strong reference, so a budget-pressed cache may evict behind us.
        # The walk seeds from the miss above — only *bases* are probed
        # inside the loop, so each chain node costs exactly one counted
        # cache lookup (re-probing `cid` would double-count the miss in
        # the §9.4 telemetry).
        chain: list[tuple[int, bytes]] = []
        verify = self._verify_reads
        tier = self._tier
        decoded = 0
        cur = cid
        while True:
            check_deadline("restore")   # per chain node: nothing held yet
            kind, base, offset, length = self._index[cur]  # KeyError
            payload = (tier.get(cur, self._crcs.get(cur))
                       if tier is not None else None)
            if payload is None:
                payload = self._read_payload(offset, length)   # before I/O
                if tier is not None:
                    tier.put(cur, payload, self._crcs.get(cur))
            if verify:
                self._check_payload(cur, payload)
            if kind == _KIND_RAW:
                data = payload
                decoded += 1
                self._cache.put(cur, data)
                break
            chain.append((cur, payload))
            cur = base
            data = self._cache.get(cur)
            if data is not None:
                tel.cache_hits += 1
                break
            tel.cache_misses += 1
        for c, patch in reversed(chain):
            data = delta.decode(patch, data)
            decoded += 1
            self._cache.put(c, data)
        self._count_decodes(decoded)
        return data

    def _reader_executor(self) -> ThreadPoolExecutor:
        ex = self._executor
        if ex is None:
            with self._ex_lock:
                if self._executor is None:
                    self._executor = ThreadPoolExecutor(
                        max_workers=self._fetch_width(),
                        thread_name_prefix="repro-readahead")
                ex = self._executor
        return ex

    def get_many(self, cids: Sequence[int]) -> list[bytes]:
        """Planned batch materialization (DESIGN.md §9, concurrent +
        double-buffered per §10): every requested chunk's base chain is
        decoded exactly once, payload reads are issued in ascending
        address order with adjacent records coalesced into sequential
        runs, and — when more than one run is scheduled — a background
        fetcher keeps up to ``readahead`` runs in flight while the
        decode loop chews the runs already fetched. Bases stay pinned in
        the decode cache only while a dependent patch of this plan still
        needs them. Safe to call from any number of threads: plans pin
        atomically (``try_pin``), so a concurrent plan's eviction
        pressure cannot invalidate this plan between planning and
        decoding."""
        if not cids:
            return []
        check_deadline("restore")
        cache = self._cache
        tel = self._telemetry.local()
        targets = list(dict.fromkeys(int(c) for c in cids))
        self._bump_heat(targets)
        # batched cache probe: one lock round-trip per shard, not per
        # chunk — this IS the warm restore (every target a hit)
        out = cache.get_present(targets)
        missing = [cid for cid in targets if cid not in out]
        tel.cache_hits += len(out)
        tel.cache_misses += len(missing)
        if missing:
            index = self._index
            for cid in missing:     # unknown cids: KeyError before any I/O
                index[cid]

            def entry(cid: int) -> tuple[int, int, int]:
                kind, base, offset, length = index[cid]
                return (base if kind == _KIND_DELTA else -1, offset, length)

            pinned: set[int] = set()
            pinned_data: dict[int, bytes] = {}
            use_sf = self._singleflight and self._flights is not None
            sf_lock = self._sf_lock
            flights = self._flights
            flights_won: dict[int, _Flight] = {}   # cids this plan decodes
            flights_wait: dict[int, _Flight] = {}  # foreign decodes parked on
            owned_unresolved: set[int] = set()

            def probe(cid: int) -> bool:
                # the planner's is_cached callback, made concurrency-safe:
                # pin-if-present is one atomic step, so another thread's
                # eviction cannot undo the answer between planning and
                # decoding (§10.2). At most one pin per cid per plan.
                if cid in pinned_data or cid in flights_wait:
                    return True
                data = cache.try_pin(cid)
                if data is not None:
                    pinned.add(cid)
                    pinned_data[cid] = data
                    return True
                if not use_sf:
                    return False
                # cold-decode singleflight (§14.2): claim the cid when
                # nobody is decoding it — this plan becomes the owner
                # and schedules the read — else park on the owner's
                # flight: the planner treats a foreign flight like a
                # cached chunk, so the chain walk stops here and this
                # plan never re-reads or re-decodes the shared suffix.
                with sf_lock:
                    fl = flights.get(cid)
                    if fl is None:
                        fl = _Flight()
                        flights[cid] = fl
                        flights_won[cid] = fl
                        owned_unresolved.add(cid)
                        return False
                    self._sf_waits += 1
                flights_wait[cid] = fl
                return True

            def resolve_flight(cid: int, data: bytes) -> None:
                # the decoded bytes are already in the cache; publish to
                # waiters and drop the table entry so later plans probe
                # the cache instead of a dead flight
                fl = flights_won.get(cid)
                if fl is None:
                    return
                fl.data = data
                fl.event.set()
                owned_unresolved.discard(cid)
                with sf_lock:
                    flights.pop(cid, None)

            def await_flight(fl) -> bytes | None:
                # §14.2 deadlock rule: a plan may block on a foreign
                # flight only while it owns no unresolved flight of its
                # own — two plans interleaved along one physical chain
                # could otherwise wait on each other forever. Owners
                # fall back to self.get instead (a rare duplicate
                # decode beats a deadlock).
                if not fl.event.is_set():
                    if owned_unresolved:
                        return None
                    fl.event.wait()
                return None if fl.error else fl.data

            try:
                plan = plan_chains(missing, entry, probe)
                wanted = set(plan.targets)

                payloads: dict[int, bytes] = {}
                verify = self._verify_reads
                tier = self._tier
                crcs = self._crcs
                reads = plan.reads
                if tier is not None and reads:
                    # disk-tier filter (§14.3): serve whatever the local
                    # tier holds (crc-verified inside), fetch the rest
                    # remotely. Tier bytes are local and free of the
                    # remote hop, so they stay out of bytes_read.
                    reads = []
                    for off, ln, cid in plan.reads:
                        payload = tier.get(cid, crcs.get(cid))
                        if payload is None:
                            reads.append((off, ln, cid))
                        else:
                            if verify:  # §13.2 contract holds tier or not
                                self._check_payload(cid, payload)
                            payloads[cid] = payload

                # coalesce the offset-sorted reads into sequential runs
                # (gap/cap are backend knobs — MB-scale for object
                # stores, KB-scale for the local log; §9.1, §11.3)
                runs = coalesce_reads(reads, self._merge_gap,
                                      self._max_run)

                remaining = dict(plan.dependents)
                order = plan.decode_order
                decode_pos = 0

                def ingest_run(run: tuple, blob: bytes) -> None:
                    start, end, extents = run
                    tel.bytes_read += len(blob)
                    if len(blob) != end - start:    # truncated record(s)
                        raise IOError(
                            f"truncated record run: wanted {end - start} "
                            f"bytes at offset {start} of "
                            f"{self._read_desc()}, got {len(blob)}")
                    view = memoryview(blob)
                    for off, ln, cid in extents:
                        payload = bytes(view[off - start:off - start + ln])
                        if verify:      # per-chunk, coalesced span or not
                            self._check_payload(cid, payload)
                        payloads[cid] = payload
                        if tier is not None:
                            # crc-verified-on-fill (§14.3): put() drops
                            # fills that do not match the journaled crc
                            tier.put(cid, payload, crcs.get(cid))

                def decode_ready() -> None:
                    # decode the available prefix of the topological
                    # order; stops at the first chunk whose payload is
                    # still in flight (a later run)
                    nonlocal decode_pos
                    t0 = time.perf_counter()
                    decoded = 0
                    while decode_pos < len(order):
                        cid = order[decode_pos]
                        payload = payloads.pop(cid, None)
                        if payload is None:
                            break
                        decode_pos += 1
                        kind, base, _, _ = index[cid]
                        if kind == _KIND_RAW:
                            data = payload
                        else:
                            # plan-local refs first, then an uncounted
                            # peek: the base is pinned by this very plan,
                            # and counting it as a cache hit would
                            # inflate the telemetry on every cold chain
                            base_data = pinned_data.get(base)
                            if base_data is None:
                                base_data = cache.peek(base)
                            if base_data is None and flights_wait:
                                fl = flights_wait.get(base)
                                if fl is not None:
                                    base_data = await_flight(fl)
                                    if base_data is not None:
                                        with sf_lock:
                                            self._sf_collapsed += 1
                            if base_data is None:  # flight failed/deferred
                                base_data = self.get(base)
                            data = delta.decode(payload, base_data)
                            left = remaining.get(base)
                            if left is not None:
                                if left > 1:
                                    remaining[base] = left - 1
                                else:
                                    del remaining[base]
                                    # flight-waited bases were never
                                    # pinned by this plan — unpinning
                                    # them would steal the owner's pin
                                    if base in pinned:
                                        cache.unpin(base)
                                        pinned.discard(base)
                        decoded += 1
                        pin = cid in remaining
                        cache.put(cid, data, pin=pin)
                        if pin:
                            pinned.add(cid)
                        if flights_won:
                            resolve_flight(cid, data)
                        if cid in wanted:
                            out[cid] = data
                    tel.decode_seconds += time.perf_counter() - t0
                    self._count_decodes(decoded)

                self._flush_if_dirty()
                read_span = self._read_span

                def read_run(run: tuple) -> tuple[bytes, float]:
                    t0 = time.perf_counter()
                    blob = read_span(run[0], run[1] - run[0])
                    return blob, time.perf_counter() - t0

                if self._readahead > 0 and len(runs) > 1:
                    # double-buffered fetch (§10.3): the read of runs
                    # k+1..k+readahead overlaps the decode of run k
                    ex = self._reader_executor()
                    pending: deque = deque()
                    ri = 0
                    try:
                        while ri < len(runs) or pending:
                            # cooperative deadline probe (§15.3): raised
                            # here — at a run boundary — the error flows
                            # through the finally blocks below, which
                            # cancel in-flight reads, error-resolve owned
                            # flights, and unpin plan bases, so an
                            # over-deadline restore sheds cleanly
                            check_deadline("restore")
                            while (ri < len(runs)
                                   and len(pending) <= self._readahead):
                                pending.append((runs[ri],
                                                ex.submit(read_run,
                                                          runs[ri])))
                                ri += 1
                            run, fut = pending.popleft()
                            overlapped = fut.done() and run is not runs[0]
                            blob, secs = fut.result()
                            tel.read_seconds += secs
                            tel.requests += 1
                            if overlapped:  # fully hidden behind decode
                                tel.prefetch_bytes += len(blob)
                            ingest_run(run, blob)
                            decode_ready()
                    finally:
                        # an aborted plan (truncated record, corrupt
                        # patch) must not leave span reads in flight: a
                        # later compaction swaps the read substrate
                        # (_pool.reopen() / index flip) under the
                        # documented no-reads-in-flight precondition.
                        # Cancel what hasn't started and drain what has;
                        # no-op on the success path.
                        while pending:
                            _, fut = pending.popleft()
                            if not fut.cancel():
                                try:
                                    fut.result()
                                except Exception:
                                    pass
                else:                       # serial: one run, or disabled
                    for run in runs:
                        check_deadline("restore")   # same shed boundary
                        blob, secs = read_run(run)
                        tel.read_seconds += secs
                        tel.requests += 1
                        ingest_run(run, blob)
                    decode_ready()
                if decode_pos != len(order):    # every payload arrived,
                    decode_ready()              # so this always finishes
                if decode_pos != len(order):
                    raise RuntimeError(
                        f"restore plan incomplete: decoded {decode_pos} "
                        f"of {len(order)} chunks")

                # a target can become cached (by a concurrent restore)
                # between the fast-path miss and the planner probe; the
                # probe pinned it — or parked on the plan actually
                # decoding it — so serve it from the plan's own refs.
                # get_present already counted every one of these as a
                # miss, so the tally is corrected once the real outcome
                # is known (§14.2 hit-ratio fix): a flight-served target
                # was a concurrent decode (a hit for the report), and a
                # self.get fallback re-counts the lookup itself.
                for tgt in plan.targets:
                    if tgt in out:
                        continue
                    data = pinned_data.get(tgt)
                    if data is None and flights_wait:
                        fl = flights_wait.get(tgt)
                        if fl is not None:
                            data = await_flight(fl)
                            if data is not None:
                                with sf_lock:
                                    self._sf_collapsed += 1
                                tel.cache_misses -= 1
                                tel.cache_hits += 1
                    if data is None:
                        tel.cache_misses -= 1   # self.get counts its own
                        data = self.get(tgt)
                    out[tgt] = data
            finally:
                # a failed plan must not leave its claimed flights
                # unresolved — waiters would park forever. On success
                # every owned flight resolved during decode; anything
                # still pending here is flagged as an error and waiters
                # fall back to their own self.get.
                if flights_won:
                    with sf_lock:
                        for cid, fl in flights_won.items():
                            if not fl.event.is_set():
                                fl.error = True
                                fl.event.set()
                                flights.pop(cid, None)
                # a failed plan (corrupt patch, truncated read) must not
                # leak pins — leaked entries would be unevictable forever
                for cid in pinned:
                    cache.unpin(cid)
                pinned.clear()
        return [out[int(c)] for c in cids]

    # --- index / recipe read surface ----------------------------------------

    def contains(self, cid: int) -> bool:
        return cid in self._index

    def max_chunk_id(self) -> int:
        # covers cids named by recipe lines too (retired included): a
        # torn-tail recovery drops chunks from the index but their recipe
        # line survives in the journal, and reissuing those ids would
        # alias new content under an old recipe's cids (§10.6)
        return max(max(self._index, default=-1), self._max_recipe_cid)

    def chunk_ids(self) -> list[int]:
        return list(self._index)

    def base_of(self, cid: int) -> int:
        kind, base, _, _ = self._index[cid]
        return base if kind == _KIND_DELTA else -1

    def payload_size(self, cid: int) -> int:
        return self._index[cid][3]

    def record(self, cid: int) -> tuple[int, int, bytes]:
        kind, base, offset, length = self._index[cid]
        payload = self._read_payload(offset, length)
        if self._verify_reads:
            self._check_payload(cid, payload)
        return (kind, base if kind == _KIND_DELTA else -1, payload)

    def recipe(self, handle: int) -> list[int]:
        if not 0 <= handle < len(self._recipes):    # no negative aliasing
            raise IndexError(f"unknown stream handle {handle}")
        recipe = self._recipes[handle]
        if recipe is None:
            raise KeyError(f"stream {handle} retired")
        return recipe

    def recipe_lengths(self, handle: int) -> list[int] | None:
        self.recipe(handle)                 # raises on unknown/retired
        return self._recipe_lens.get(handle)

    def num_streams(self) -> int:
        return len(self._recipes)

    def live_handles(self) -> list[int]:
        return [h for h, r in enumerate(self._recipes) if r is not None]


@register_backend("memory")
class InMemoryBackend:
    """Chunk records and stream recipes in dicts.

    Records are ``(kind, base, payload)``: a raw chunk keeps its bytes, a
    delta chunk its base id and COPY/ADD patch. Unlike the reference's
    in-memory backend, which also keeps every chunk's materialised bytes,
    ``get`` rebuilds a chunk by walking its delta chain down to a raw
    record and decoding back up, so a restore exercises every stored
    patch. Checksums are computed when asked for: payloads in memory never
    change, so ``checksum_of`` gives what the reference stored at put time.
    """

    name = "memory"
    record_overhead = 0     # payloads stored bare in dicts

    def __init__(self) -> None:
        self._records: dict[int, tuple[int, int, bytes]] = {}
        self._recipes: list[list[int] | None] = []
        self._recipe_lens: dict[int, list[int]] = {}
        self.epoch = 0

    def put_raw(self, cid: int, data: bytes) -> None:
        self._records[cid] = (_KIND_RAW, -1, data)

    def put_delta(self, cid: int, base: int, patch: bytes,
                  data: bytes | None = None) -> None:
        if base not in self._records:
            raise KeyError(f"delta base {base} of chunk {cid} is not stored")
        self._records[cid] = (_KIND_DELTA, base, patch)

    def put_many(self, records: Sequence[tuple[int, int, bytes,
                                               bytes | None]]) -> None:
        """Store ``(cid, base, payload, data)`` records; ``base < 0`` is raw."""
        for cid, base, payload, data in records:
            if base < 0:
                self.put_raw(cid, payload)
            else:
                self.put_delta(cid, base, payload, data=data)

    def get(self, cid: int) -> bytes:
        """Materialise a chunk: walk its chain to a raw record, decode up."""
        chain = []
        kind, base, payload = self._records[cid]
        while kind == _KIND_DELTA:
            chain.append(payload)
            kind, base, payload = self._records[base]
        data = payload
        for patch in reversed(chain):
            data = delta.decode(patch, data)
        return data

    def get_many(self, cids: Sequence[int]) -> list[bytes]:
        return [self.get(c) for c in cids]

    def contains(self, cid: int) -> bool:
        return cid in self._records

    def max_chunk_id(self) -> int:
        return max(self._records, default=-1)

    def chunk_ids(self) -> list[int]:
        return list(self._records)

    def base_of(self, cid: int) -> int:
        return self._records[cid][1]

    def payload_size(self, cid: int) -> int:
        return len(self._records[cid][2])

    def record(self, cid: int) -> tuple[int, int, bytes]:
        return self._records[cid]

    def checksum_of(self, cid: int) -> int | None:
        return crc32c(self._records[cid][2])

    def drop_chunks(self, cids: Sequence[int]) -> None:
        """Quarantine: forget ``cids`` entirely. Callers guarantee no live
        recipe references them."""
        for cid in cids:
            self._records.pop(int(cid), None)

    def add_recipe(self, chunk_ids: Sequence[int],
                   lengths: Sequence[int] | None = None) -> int:
        self._recipes.append([int(c) for c in chunk_ids])
        handle = len(self._recipes) - 1
        if lengths is not None:
            self._recipe_lens[handle] = [int(n) for n in lengths]
        return handle

    def recipe(self, handle: int) -> list[int]:
        # no negative aliasing: delete(-1) must never retire the newest
        if not 0 <= handle < len(self._recipes):
            raise IndexError(f"unknown stream handle {handle}")
        recipe = self._recipes[handle]
        if recipe is None:
            raise KeyError(f"stream {handle} retired")
        return recipe

    def recipe_lengths(self, handle: int) -> list[int] | None:
        self.recipe(handle)                 # raises on unknown/retired
        return self._recipe_lens.get(handle)

    def retire_recipe(self, handle: int) -> None:
        self.recipe(handle)                 # raises on unknown/retired
        self._recipes[handle] = None
        self._recipe_lens.pop(handle, None)

    def num_streams(self) -> int:
        return len(self._recipes)

    def live_handles(self) -> list[int]:
        return [h for h, r in enumerate(self._recipes) if r is not None]

    def storage_bytes(self) -> int:
        return sum(len(payload) for _, _, payload in self._records.values())

    def rewrite_live(self, records: Iterable[tuple[int, int, int, bytes]]) -> None:
        self._records = {cid: (kind, base if kind == _KIND_DELTA else -1,
                               payload)
                         for cid, kind, base, payload in records}
        self.epoch += 1

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


@register_backend("file")
class FileBackend(PlannedChainReader):
    """Append-only on-disk containers.

    Layout under `path`:
        chunks.log     [RCL2 epoch] then [kind cid base len crc32c]
                       [payload] records, appended (RCL1 / pre-magic
                       logs have no crc field and still open; §13.1)
        recipes.jsonl  {"epoch": N} header line, then one line per handle
                       slot: {"recipe": ids, "lens": lengths} (live
                       recipe with materialized chunk lengths for ranged
                       restores), a bare JSON array (live recipe written
                       before lengths existed), ``null`` (slot retired
                       before the last compaction), {"retire": h}
                       (tombstone appended by a delete), or
                       {"quarantine": [cids]} (scrub --repair drop,
                       §13.3)

    An index {cid -> (kind, base, offset, length)} is rebuilt by scanning
    the log on open, so a fresh FileBackend on an existing directory can
    serve restores immediately. Materialized chunks live in a
    byte-budgeted ``ShardedDecodeCache`` (DESIGN.md §9.2, sharded per
    §10.2) — restore working sets rotate LRU under ``cache_bytes``
    instead of accumulating the whole dataset in RAM. ``rewrite_live``
    (compaction, DESIGN.md §7.3) rewrites both files through temp-file +
    atomic rename with the epoch bumped; pre-header directories still
    open (epoch 0, records at offset 0).

    Concurrency contract (DESIGN.md §10.4): ``get``/``get_many``/
    ``record`` and the recipe read surface are safe from any number of
    threads at once (payload reads are positionless ``os.pread`` on a
    pooled fd set, the decode cache is sharded and internally locked,
    telemetry is per-thread). Writes (``put_*``, ``add_recipe``,
    ``retire_recipe``) may run concurrently with reads but not with each
    other, and ``rewrite_live``/``close`` require full exclusion (the
    reference's store enforces both with its commit mutex and lifecycle
    RW lock; the port's commits one stream at a time and closes after its
    restores).
    """

    name = "file"
    record_overhead = _REC_HEADER.size

    def __init__(self, path: str | Path, fsync_on_flush: bool = False,
                 cache_bytes: int | None = None,
                 cache_shards: int | None = None,
                 cache_policy: str | None = None,
                 reader_fds: int | None = None,
                 readahead: int | None = None,
                 coalesce_gap: int | None = None,
                 verify_reads: bool = False,
                 singleflight: bool = True,
                 faults=None) -> None:
        """``fsync_on_flush=True`` makes every ``flush()`` (one per
        committed stream — group commit, DESIGN.md §8) durable with a
        single fsync per file; the default keeps the historical
        buffered-only commits (deletes always fsync their tombstone).
        ``cache_bytes`` budgets the decode cache (DESIGN.md §9.2;
        default ``repro_torch.api.restore.DEFAULT_CACHE_BYTES``) and
        ``cache_shards`` how many ways it stripes (§10.2).
        ``reader_fds`` sizes the pread pool (= payload reads in flight),
        ``readahead`` how many coalesced read runs the fetcher keeps in
        flight ahead of the decode loop (0 = strictly serial reads).
        ``coalesce_gap`` is the largest hole (bytes of unwanted data)
        two records may straddle and still be fetched in one pread
        (default 4 KiB — one page of waste; object stores use MB-scale
        gaps, §11.3). ``cache_policy`` names the decode-cache eviction
        policy ("lru"/"arc", §14.1); ``singleflight=False`` disables the
        §14.2 cold-decode collapse (benchmark A/B only).
        ``verify_reads`` checks every payload read off the
        log against its persisted crc32c (§13.2); ``faults`` threads a
        ``repro_torch.api.faults.FaultInjector`` through the write-path
        crashpoints (tests only)."""
        self.path = Path(path)
        self._fsync_on_flush = fsync_on_flush
        self._verify_reads = bool(verify_reads)
        self._faults = faults
        self.path.mkdir(parents=True, exist_ok=True)
        self._log_path = self.path / "chunks.log"
        self._recipes_path = self.path / "recipes.jsonl"
        for stale in (self._log_path, self._recipes_path):
            tmp = stale.with_suffix(stale.suffix + ".tmp")
            if tmp.exists():        # abandoned mid-compaction; originals win
                tmp.unlink()
        self._index: dict[int, tuple[int, int, int, int]] = {}
        self._crcs: dict[int, int] = {}
        # one file never mixes record formats: fresh/empty logs start as
        # RCL2 (checksummed records), existing RCL1/pre-magic logs keep
        # appending v1 records until the first compaction rewrites them
        self._log_v2 = True
        self._cache = ShardedDecodeCache(
            cache_bytes if cache_bytes is not None else DEFAULT_CACHE_BYTES,
            shards=cache_shards if cache_shards is not None
            else DEFAULT_CACHE_SHARDS,
            policy=cache_policy if cache_policy is not None
            else DEFAULT_CACHE_POLICY)
        self._init_read_engine_state(singleflight)
        self._recipes: list[list[int] | None] = []
        self._recipe_lens: dict[int, list[int]] = {}
        # largest cid referenced by ANY recipe line ever seen — retired
        # and recovery-retired included. max_chunk_id() covers it so the
        # ids of a torn-away chunk (still named by its recipe line in the
        # journal) are never reissued to new content (§10.6).
        self._max_recipe_cid = -1
        # restore telemetry (DESIGN.md §9.4): per-thread counters so
        # concurrent restores attribute I/O exactly (§10.5); the
        # read_seconds/bytes_read/... properties expose lifetime totals
        self._telemetry = IoTelemetry()
        self._readahead = (DEFAULT_READAHEAD if readahead is None
                           else max(0, int(readahead)))
        self._merge_gap = (_READ_MERGE_GAP if coalesce_gap is None
                           else max(0, int(coalesce_gap)))
        self._max_run = _READ_MAX_RUN
        self.epoch = 0
        self._scan()
        self.record_overhead = (_REC_HEADER2.size if self._log_v2
                                else _REC_HEADER.size)
        self._log = open(self._log_path, "ab")
        if self._log.tell() == 0:
            self._log.write(_LOG_HEADER.pack(_LOG_MAGIC2, self.epoch))
        self._recipes_f = open(self._recipes_path, "a")
        if self._recipes_f.tell() == 0:
            self._recipes_f.write(json.dumps({"epoch": self.epoch}) + "\n")
        self._pool = _ReaderPool(self._log_path,
                                 reader_fds if reader_fds is not None
                                 else DEFAULT_READER_FDS)
        self._executor: ThreadPoolExecutor | None = None
        self._io_lock = threading.Lock()    # append handle + dirty flag
        self._ex_lock = self._io_lock       # guards lazy executor creation
        self._log_dirty = False

    # --- PlannedChainReader storage primitives (DESIGN.md §9/§10) ------------

    def _fetch_width(self) -> int:
        return self._pool.size

    def _read_span(self, offset: int, length: int) -> bytes:
        return self._pool.pread(offset, length)

    def _read_desc(self) -> str:
        return str(self._log_path)

    def _scan(self) -> None:
        # A kill -9 mid-ingest can tear the tail of either file; the torn
        # record belongs to a commit that never produced an IngestReport,
        # so dropping it loses nothing — but indexing it would serve short
        # reads (silent corruption) and a torn recipe line would make the
        # directory unopenable.
        log_epoch = recipes_epoch = 0
        if self._log_path.exists():
            size = self._log_path.stat().st_size
            good_end = 0
            with open(self._log_path, "rb") as f:
                head = f.read(_LOG_HEADER.size)
                if len(head) == _LOG_HEADER.size and head[:4] in (
                        _LOG_MAGIC, _LOG_MAGIC2):
                    log_epoch = _LOG_HEADER.unpack(head)[1]
                    good_end = _LOG_HEADER.size
                    self._log_v2 = head[:4] == _LOG_MAGIC2
                elif size < _LOG_HEADER.size:
                    # torn inside its own header: empty. The reference
                    # reads this as a pre-magic v1 log, then writes an
                    # RCL2 header and appends v1 records after it, which
                    # the next open misparses. Nothing is lost here: a v1
                    # record header alone is 25 bytes, so no log this
                    # short holds a record. It is truncated to 0 below
                    # and reopens as RCL2 with v2 records.
                    self._log_v2 = True
                else:
                    f.seek(0)       # pre-epoch log: records start at 0
                    self._log_v2 = False    # never mix record formats
                rec_header = _REC_HEADER2 if self._log_v2 else _REC_HEADER
                while True:
                    header = f.read(rec_header.size)
                    if len(header) < rec_header.size:
                        break
                    if self._log_v2:
                        kind, cid, base, length, crc = rec_header.unpack(
                            header)
                    else:
                        kind, cid, base, length = rec_header.unpack(header)
                        crc = None
                    if f.tell() + length > size:      # torn payload tail
                        break
                    self._index[cid] = (kind, base, f.tell(), length)
                    if crc is not None:
                        self._crcs[cid] = crc
                    f.seek(length, 1)
                    good_end = f.tell()
            if good_end < size:   # drop the torn bytes so later appends
                os.truncate(self._log_path, good_end)   # start on a boundary
        if self._recipes_path.exists():
            good_end = 0
            torn = False
            with open(self._recipes_path, "rb") as f:
                lines = f.readlines()
            for i, line in enumerate(lines):
                last = i == len(lines) - 1
                # an unterminated final line is torn even when it
                # parses — the next append would merge onto it
                if not line.endswith(b"\n"):
                    torn = True
                    break
                if line.strip():
                    try:
                        entry = json.loads(line)
                    except json.JSONDecodeError:
                        if last:            # torn recipe tail
                            torn = True
                            break
                        # a malformed line with durable lines AFTER it is
                        # not a torn tail — truncating here would silently
                        # drop committed streams (§13.3): fail loudly
                        raise CorruptJournalError(
                            self._recipes_path, i + 1,
                            "unparseable journal line before end of file")
                    if isinstance(entry, dict):
                        if i == 0 and "epoch" in entry:
                            recipes_epoch = int(entry["epoch"])
                        elif "retire" in entry:
                            h = int(entry["retire"])
                            if 0 <= h < len(self._recipes):
                                self._recipes[h] = None
                                self._recipe_lens.pop(h, None)
                        elif "quarantine" in entry:
                            # scrub --repair dropped these cids (§13.3):
                            # un-index them, but burn their ids so they
                            # are never reissued to new content
                            for cid in entry["quarantine"]:
                                cid = int(cid)
                                self._index.pop(cid, None)
                                self._crcs.pop(cid, None)
                                self._max_recipe_cid = max(
                                    self._max_recipe_cid, cid)
                        elif "recipe" in entry:
                            rec = entry["recipe"]
                            self._recipes.append(rec)
                            if rec:
                                self._max_recipe_cid = max(
                                    self._max_recipe_cid, max(rec))
                            lens = entry.get("lens")
                            if lens is not None:
                                self._recipe_lens[
                                    len(self._recipes) - 1] = lens
                    else:   # list = live recipe, null = retired slot
                        self._recipes.append(entry)
                        if entry:
                            self._max_recipe_cid = max(
                                self._max_recipe_cid, max(entry))
                good_end += len(line)
            if torn:
                os.truncate(self._recipes_path, good_end)
        # Joint-truncation hardening (DESIGN.md §10.6): the two files'
        # tails tear independently (commits are buffered, not fsync'd, so
        # the OS may persist a recipe line whose chunks never reached the
        # log). A live recipe referencing a chunk missing from the index
        # belongs to a commit that never produced an IngestReport —
        # retire it at scan time rather than crash the refcount rebuild
        # or serve KeyErrors later. The retirement must be DURABLE: the
        # recipe line itself survives in the journal, so without a
        # tombstone a later ingest that reused the torn cids would make
        # every referenced cid exist again on the next reopen and the
        # recipe would resurrect as live — serving another stream's
        # bytes. Committed streams are untouched (their chunks precede
        # their recipe line, and truncation is always a prefix of each
        # file).
        recovered: list[int] = []
        for h, recipe in enumerate(self._recipes):
            if recipe is not None and any(cid not in self._index
                                          for cid in recipe):
                self._recipes[h] = None
                self._recipe_lens.pop(h, None)
                recovered.append(h)
        if recovered:
            # fsync'd before __init__ returns, so no ingest can slip in
            # ahead of the tombstone; a crash right here just re-derives
            # the same retirement on the next open (no ids reused yet)
            with open(self._recipes_path, "a") as f:
                for h in recovered:
                    f.write(json.dumps({"retire": h}) + "\n")
                f.flush()
                os.fsync(f.fileno())
        # a crash between the two compaction renames leaves the epochs one
        # apart; both file states are consistent (see module docstring)
        self.epoch = max(log_epoch, recipes_epoch)

    def _pack_header(self, kind: int, cid: int, base: int,
                     payload: bytes) -> tuple[bytes, int | None]:
        if self._log_v2:
            crc = crc32c(payload)
            return (_REC_HEADER2.pack(kind, cid, base, len(payload), crc),
                    crc)
        return _REC_HEADER.pack(kind, cid, base, len(payload)), None

    def _append(self, kind: int, cid: int, base: int, payload: bytes) -> None:
        header, crc = self._pack_header(kind, cid, base, payload)
        with self._io_lock:
            self._log.write(header)
            offset = self._log.tell()
            self._log.write(payload)
            self._log_dirty = True
        self._index[cid] = (kind, base, offset, len(payload))
        if crc is not None:
            self._crcs[cid] = crc
        self._cp(_CP_PUT_WRITTEN)

    def put_raw(self, cid: int, data: bytes) -> None:
        self._append(_KIND_RAW, cid, -1, data)
        self._cache.put(cid, data)

    def put_delta(self, cid: int, base: int, patch: bytes,
                  data: bytes | None = None) -> None:
        self._append(_KIND_DELTA, cid, base, patch)
        if data is not None:
            self._cache.put(cid, data)

    def put_many(self, records: Sequence[tuple[int, int, bytes,
                                               bytes | None]]) -> None:
        """One buffered append for a whole stream's worth of records:
        headers and payloads are packed into a single buffer and written
        with one ``write()`` call, so a commit costs one syscall batch
        instead of two writes per chunk (DESIGN.md §8). Index/cache
        bookkeeping is identical to the per-chunk puts."""
        with self._io_lock:
            buf = bytearray()
            start = self._log.tell()
            entries = []
            for cid, base, payload, data in records:
                kind = _KIND_RAW if base < 0 else _KIND_DELTA
                if kind == _KIND_RAW:
                    data = payload
                header, crc = self._pack_header(kind, cid,
                                                base if kind else -1,
                                                payload)
                buf += header
                entries.append((cid, kind, base if kind else -1,
                                start + len(buf), len(payload), crc, data))
                buf += payload
            if not buf:
                return
            # index/cache only after the write is accepted — a failed write
            # must not leave phantom index entries at never-written offsets
            self._log.write(bytes(buf))
            self._log_dirty = True
        for cid, kind, base, offset, length, crc, data in entries:
            self._index[cid] = (kind, base, offset, length)
            if crc is not None:
                self._crcs[cid] = crc
            if data is not None:
                self._cache.put(cid, data)
        self._cp(_CP_PUT_WRITTEN)

    def _flush_if_dirty(self) -> None:
        # double-checked: readers skip the lock entirely once clean
        if self._log_dirty:
            with self._io_lock:
                if self._log_dirty:
                    self._log.flush()
                    self._log_dirty = False

    def add_recipe(self, chunk_ids: Sequence[int],
                   lengths: Sequence[int] | None = None) -> int:
        recipe = [int(c) for c in chunk_ids]
        self._recipes.append(recipe)
        if recipe:
            self._max_recipe_cid = max(self._max_recipe_cid, max(recipe))
        handle = len(self._recipes) - 1
        if lengths is None:
            self._recipes_f.write(json.dumps(recipe) + "\n")
        else:
            lens = [int(n) for n in lengths]
            self._recipe_lens[handle] = lens
            self._recipes_f.write(
                json.dumps({"recipe": recipe, "lens": lens}) + "\n")
        self._cp(_CP_RECIPE_APPENDED)
        return handle

    def retire_recipe(self, handle: int) -> None:
        self.recipe(handle)                 # raises on unknown/retired
        self._recipes[handle] = None
        self._recipe_lens.pop(handle, None)
        self._recipes_f.write(json.dumps({"retire": handle}) + "\n")
        # deletes are rare and irreversible-by-intent: fsync the tombstone
        # so a power loss cannot resurrect the stream (commits stay
        # flush-only; resurrecting a never-reported commit is harmless)
        self._cp(_CP_RETIRE_BEFORE_FSYNC)
        self._recipes_f.flush()
        os.fsync(self._recipes_f.fileno())

    def drop_chunks(self, cids: Sequence[int]) -> None:
        """Quarantine: durably un-index ``cids`` (scrub --repair, §13.3).
        A fsync'd ``{"quarantine": [...]}`` journal line records the drop
        — the records stay physically in the log (append-only) but are
        dead to the index on every future open, and their ids are burned
        so they can never be reissued. Callers guarantee no live recipe
        still references them and nothing deltas against them."""
        cids = sorted(int(c) for c in cids)
        if not cids:
            return
        self._recipes_f.write(json.dumps({"quarantine": cids}) + "\n")
        self._recipes_f.flush()
        os.fsync(self._recipes_f.fileno())
        dropped = set()
        for cid in cids:
            if self._index.pop(cid, None) is not None:
                dropped.add(cid)
            self._crcs.pop(cid, None)
            self._max_recipe_cid = max(self._max_recipe_cid, cid)
        self._cache.retain(lambda cid: cid not in dropped)

    def storage_bytes(self) -> int:
        self.flush()
        return (self._log_path.stat().st_size
                + self._recipes_path.stat().st_size)

    def _fsync_dir(self) -> None:
        fd = os.open(self.path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def rewrite_live(self, records: Iterable[tuple[int, int, int, bytes]]) -> None:
        """Compaction commit: stream `records` into fresh fsync'd files
        (epoch+1) next to the originals, then atomically rename each into
        place — recipes first, log second, with a directory fsync between
        so the ordering survives power loss (the new recipe set with the
        old log is restorable; a compacted log with pre-compaction recipes
        would reference swept chunks, so that state must never become
        durable). The old handles stay open until both renames succeed —
        a failed rename leaves the backend fully usable on the original
        files (the stale tmps are cleaned on the next open)."""
        new_epoch = self.epoch + 1
        new_index: dict[int, tuple[int, int, int, int]] = {}
        new_crcs: dict[int, int] = {}
        # compaction always writes the current format: an RCL1 log is
        # upgraded to RCL2 here, gaining checksums for every record
        log_tmp = self._log_path.with_suffix(".log.tmp")
        with open(log_tmp, "wb") as f:
            f.write(_LOG_HEADER.pack(_LOG_MAGIC2, new_epoch))
            for cid, kind, base, payload in records:
                crc = crc32c(payload)
                f.write(_REC_HEADER2.pack(kind, cid, base, len(payload),
                                          crc))
                new_index[cid] = (kind, base, f.tell(), len(payload))
                new_crcs[cid] = crc
                f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        recipes_tmp = self._recipes_path.with_suffix(".jsonl.tmp")
        with open(recipes_tmp, "w") as f:
            f.write(json.dumps({"epoch": new_epoch}) + "\n")
            for h, recipe in enumerate(self._recipes):
                lens = self._recipe_lens.get(h)
                if recipe is not None and lens is not None:
                    f.write(json.dumps({"recipe": recipe, "lens": lens})
                            + "\n")
                else:           # null keeps handle slots stable
                    f.write(json.dumps(recipe) + "\n")
            f.flush()
            os.fsync(f.fileno())

        self.flush()                        # don't lose buffered appends
        self._cp(_CP_COMPACT_TMPS)
        os.replace(recipes_tmp, self._recipes_path)
        try:
            self._fsync_dir()               # recipes durably renamed first
            self._cp(_CP_COMPACT_RECIPES_RENAMED)
            os.replace(log_tmp, self._log_path)
            self._fsync_dir()
        finally:
            # the recipes path changed identity above either way: rebind
            # the append handle so later commits/tombstones reach the file
            # on disk even if the log rename failed (new recipes + old log
            # is a consistent state; see module docstring)
            self._recipes_f.close()
            self._recipes_f = open(self._recipes_path, "a")

        self._cp(_CP_COMPACT_DONE)
        self._log.close()
        self.epoch = new_epoch
        self._index = new_index
        self._crcs = new_crcs
        self._log_v2 = True
        self.record_overhead = _REC_HEADER2.size
        self._cache.retain(new_index.__contains__)
        self._log = open(self._log_path, "ab")
        self._pool.reopen()     # fresh fds on the renamed-into-place log
        self._log_dirty = False

    def flush(self) -> None:
        with self._io_lock:
            self._log.flush()
            self._log_dirty = False
            self._recipes_f.flush()
            self._cp(_CP_FLUSH_BEFORE_FSYNC)
            if self._fsync_on_flush:
                os.fsync(self._log.fileno())
                os.fsync(self._recipes_f.fileno())

    def close(self) -> None:
        self.flush()
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        self._log.close()
        self._pool.close()
        self._recipes_f.close()
