"""Object-store container backend and its fault-injecting local fake
(port of ``repro.api.objectstore``; ``S3ObjectClient``, the ``"s3"``
backend and the ``cp``/``ls``/``stat``/``verify`` CLI are not ported:
boto3 is not installed, and the CLI comes in a later slice).

  ObjectStoreBackend  a full ``ContainerBackend`` that keeps the chunk
                      log as immutable *container objects* and serves
                      restores through the shared read engine
                      (``containers.PlannedChainReader``): planned
                      chains, MB-scale range coalescing, a concurrent
                      fetch pool with double-buffered readahead, and
                      retry-with-backoff around every request. Commits
                      group into one container PUT + one journal PUT.
  LocalObjectStore    a directory-backed object API (``get_range`` /
                      ``put`` / ``list`` / ``head`` / ``delete_object``)
                      with injectable per-request latency, bandwidth
                      caps, and transient-error schedules.
  DiskTierCache       a byte-budgeted local-disk chunk tier in front of
                      the remote store.

Object layout under one backend root (all writes are whole-object PUTs,
which object stores apply atomically — there are no torn tails here,
only *missing* objects), the reference's names and bytes:

    manifest.json               {"epoch": N} — which epoch prefix is live;
                                rewriting it is the atomic compaction flip
    e{epoch:08d}/chunks/{seq:08d}
                                container objects: chunk payloads packed
                                back-to-back, no per-record headers
                                (``record_overhead = 0`` — the index
                                lives in the journal)
    e{epoch:08d}/journal/{seq:08d}.json
                                journal objects, each a JSON list of
                                entries replayed in order on open:
                                {"chunks": [[cid,kind,base,seq,off,len,
                                crc32c]..]}, {"recipe": ids, "lens": lens},
                                {"retire": handle}, {"quarantine":
                                [cids]}, and the consolidated
                                {"recipes": [...]} written by compaction

Addressing: the index maps ``cid -> (kind, base, voff, length)`` where
``voff = seq << 40 | offset`` is a *virtual* offset. Chain plans sort
and coalesce on voff; because every coalesce gap is far below 2^40, a
coalesced run never straddles two container objects, so the shared read
engine needs no object-awareness — ``_read_span`` splits voff back into
(object, range) and issues one ranged GET.

Recovery: a crash can lose the journal PUT of a commit whose container
PUT landed (the order is container-then-journal), leaving an orphan
container object; it can never produce a journal that references bytes
that were not uploaded first. ``_scan`` replays the journals, drops index
entries whose container object is missing or too short (plus their delta
dependents), durably retires recipes referencing lost chunks, deletes
orphan containers and any stale-epoch leftovers of an interrupted
compaction.
"""
from __future__ import annotations

import json
import os
import random
import threading
import time
from pathlib import Path
from typing import Callable, Iterable, Sequence

from repro_torch.api.concurrency import IoTelemetry
from repro_torch.api.containers import (_KIND_DELTA, _KIND_RAW,
                                        DEFAULT_READAHEAD, PlannedChainReader)
# canonical home of the fault machinery is api/faults.py; the re-exports
# keep the reference's import path working
from repro_torch.api.faults import (FaultSchedule, RetryBudgetExceeded,  # noqa: F401
                                    TransientError, register_crashpoint,
                                    with_retries)
from repro_torch.api.integrity import crc32c
from repro_torch.api.registry import get_cache_policy, register_backend
from repro_torch.api.restore import (DEFAULT_CACHE_BYTES, DEFAULT_CACHE_POLICY,
                                     DEFAULT_CACHE_SHARDS, ShardedDecodeCache)

# voff = seq << _OBJ_SHIFT | offset-in-object. 2^40 per object is far
# beyond any real object size, and far beyond any coalesce gap — the
# invariant that keeps runs from straddling objects (module docstring).
_OBJ_SHIFT = 40
_OBJ_MASK = (1 << _OBJ_SHIFT) - 1

#: Default coalesce gap for object backends: with ~10 ms per request,
#: re-reading a 1 MiB hole costs less than a second round-trip on any
#: link faster than ~100 MB/s — the opposite trade from the file
#: backend's one-page gap (DESIGN.md §11.3).
DEFAULT_OBJSTORE_GAP = 1 << 20
DEFAULT_OBJSTORE_MAX_RUN = 32 << 20
#: Target container-object size; put_many rolls to a new object past it
#: (multipart-style part uploads for one group commit).
DEFAULT_OBJECT_BYTES = 8 << 20
DEFAULT_FETCHERS = 4            # concurrent ranged GETs in flight
DEFAULT_MAX_RETRIES = 4
DEFAULT_RETRY_BACKOFF = 0.05    # doubles per attempt: 50/100/200/400 ms
#: Default byte budget for the local-disk chunk tier (§14.3) when a
#: ``tier_path`` is given without an explicit ``tier_bytes``.
DEFAULT_TIER_BYTES = 256 << 20

_MANIFEST_KEY = "manifest.json"

# ObjectStoreBackend crashpoints (DESIGN.md §13.4): every PUT boundary a
# kill can land on. Fired only when a FaultInjector was threaded in via
# ``faults=``.
_CP_LOCALPUT_BEFORE_RENAME = register_crashpoint(
    "objstore.localput.before_rename",
    "LocalObjectStore PUT: tmp written+fsynced, before the rename")
_CP_FLUSH_BEFORE_CONTAINER = register_crashpoint(
    "objstore.flush.before_container_put",
    "commit flush entered, before the container object PUT")
_CP_FLUSH_BETWEEN_PUTS = register_crashpoint(
    "objstore.flush.between_puts",
    "container object PUT landed, journal PUT not yet issued")
_CP_FLUSH_AFTER_JOURNAL = register_crashpoint(
    "objstore.flush.after_journal_put",
    "journal PUT landed, before in-memory staging resets")
_CP_RETIRE_BEFORE_FLUSH = register_crashpoint(
    "objstore.retire.before_flush",
    "retire entry journaled in memory, before its durable flush PUT")
_CP_COMPACT_CONTAINERS_PUT = register_crashpoint(
    "objstore.compact.containers_put",
    "all new-epoch container objects PUT, journal not yet")
_CP_COMPACT_JOURNAL_PUT = register_crashpoint(
    "objstore.compact.journal_put",
    "new-epoch consolidated journal PUT, manifest not yet flipped")
_CP_COMPACT_MANIFEST_FLIPPED = register_crashpoint(
    "objstore.compact.manifest_flipped",
    "manifest flipped to the new epoch, old epoch not yet deleted")


class LocalObjectStore:
    """Directory-backed object API with injectable faults (§11.2).

    Keys are ``/``-separated paths under ``root``; objects are plain
    files, PUT atomically (tmp + rename) so a crashed writer can never
    leave a half-object — matching the whole-object atomicity real
    stores give. Every request first pays ``latency`` seconds, then an
    optional ``fault_hook(op, key, request_ordinal)`` may return an
    exception to raise (see ``FaultSchedule``); transfers additionally
    pay ``len / bandwidth_bps``. Request/byte counters are kept per op —
    benchmarks read them as ground truth for "how many GETs did that
    restore cost".

    Thread-safe: counters are locked, the filesystem does the rest.
    """

    def __init__(self, root: str | Path, latency: float = 0.0,
                 bandwidth_bps: float | None = None,
                 fault_hook: Callable[[str, str, int],
                                      Exception | None] | None = None,
                 faults=None) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.latency = float(latency)
        self.bandwidth_bps = bandwidth_bps
        self.fault_hook = fault_hook
        self.faults = faults    # FaultInjector for the PUT crashpoint
        self._lock = threading.Lock()
        self.requests = 0
        self.op_counts: dict[str, int] = {}
        self.bytes_put = 0
        self.bytes_got = 0

    def _path(self, key: str) -> Path:
        if ".." in key.split("/"):
            raise ValueError(f"bad object key {key!r}")
        return self.root / key

    def _begin(self, op: str, key: str) -> None:
        with self._lock:
            self.requests += 1
            n = self.requests
            self.op_counts[op] = self.op_counts.get(op, 0) + 1
        if self.latency > 0:
            time.sleep(self.latency)
        hook = self.fault_hook
        if hook is not None:
            exc = hook(op, key, n)
            if exc is not None:
                raise exc

    def _bill(self, op: str, nbytes: int) -> None:
        with self._lock:
            if op == "put":
                self.bytes_put += nbytes
            else:
                self.bytes_got += nbytes
        if self.bandwidth_bps and nbytes:
            time.sleep(nbytes / self.bandwidth_bps)

    def put(self, key: str, data: bytes) -> None:
        self._begin("put", key)
        path = self._path(key)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        if self.faults is not None:
            self.faults.crashpoint(_CP_LOCALPUT_BEFORE_RENAME)
        os.replace(tmp, path)
        self._bill("put", len(data))

    def get(self, key: str) -> bytes:
        self._begin("get", key)
        try:
            data = self._path(key).read_bytes()
        except FileNotFoundError:
            raise KeyError(key) from None
        self._bill("get", len(data))
        return data

    def get_range(self, key: str, start: int, length: int) -> bytes:
        """Ranged GET: bytes [start, start+length), short at object end
        (callers treat short as truncation, like ``_ReaderPool.pread``)."""
        self._begin("get", key)
        try:
            with open(self._path(key), "rb") as f:
                f.seek(start)
                data = f.read(length)
        except FileNotFoundError:
            raise KeyError(key) from None
        self._bill("get", len(data))
        return data

    def head(self, key: str) -> int | None:
        """Object size in bytes, or None when the key is absent."""
        self._begin("head", key)
        try:
            return self._path(key).stat().st_size
        except FileNotFoundError:
            return None

    def list(self, prefix: str = "") -> list[tuple[str, int]]:
        """Sorted ``(key, size)`` pairs under ``prefix`` — one LIST
        request regardless of result count (real stores paginate; the
        request-count model here stays deliberately simple)."""
        self._begin("list", prefix)
        out = []
        for dirpath, _, files in os.walk(self.root):
            for fn in files:
                if fn.endswith(".tmp"):     # a torn PUT, never visible
                    continue
                p = Path(dirpath) / fn
                key = p.relative_to(self.root).as_posix()
                if key.startswith(prefix):
                    out.append((key, p.stat().st_size))
        out.sort()
        return out

    def delete_object(self, key: str) -> None:
        """Idempotent delete (matching S3: deleting a missing key is OK)."""
        self._begin("delete", key)
        try:
            self._path(key).unlink()
        except FileNotFoundError:
            pass


class DiskTierCache:
    """Byte-budgeted local-disk chunk tier in front of a remote object
    store (DESIGN.md §14.3).

    One plain file per cached chunk payload (``{cid & 0xff:02x}/{cid}``
    under the tier root, tmp+rename writes), no on-disk metadata —
    reopen rebuilds the in-memory book by scanning the directory, so
    the tier survives process restarts and tolerates losing any file at
    any time (a lost entry is just a miss).

    Coherence rules (§14.3):

      * **crc-verified on fill** — ``put`` computes crc32c over the
        payload and drops the fill unless it matches the journaled crc
        the backend passed in (chunks without a journaled crc are never
        tiered: there would be nothing to verify reads against);
      * **lazily re-verified on read** — the first ``get`` of an entry
        this process hasn't verified yet (every entry, after a reopen)
        recomputes the crc; a mismatch — bit rot, or a patch rebased by
        compaction — unlinks the file and reports a miss, so corruption
        is *refetched*, never served;
      * eviction ordering comes from the same pluggable
        :class:`repro_torch.api.restore.CachePolicy` family as the decode
        cache ("arc" by default, so whole-store scans stream through
        without flushing hot chains).

    All operations serialize on one lock — tier file I/O is local and
    micro-seconds-scale against the remote hop it replaces, and the
    simplicity keeps the directory book exact.
    """

    def __init__(self, root: str | Path, budget_bytes: int,
                 policy: str = "arc") -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.budget_bytes = max(1, int(budget_bytes))
        self.policy_name = str(policy)
        self._policy = get_cache_policy(self.policy_name)(self.budget_bytes)
        self._lock = threading.Lock()
        self._sizes: dict[int, int] = {}
        self._verified: set[int] = set()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.bytes_served = 0
        self.bytes_filled = 0
        self.dropped = 0        # crc-failed entries unlinked (bit rot or
        #                         post-compaction staleness) — §14.3
        with self._lock:
            self._scan_dir()

    def _path(self, cid: int) -> Path:
        return self.root / f"{cid & 0xff:02x}" / str(cid)

    def _scan_dir(self) -> None:
        # lock held. Torn fills (tmp files) are dropped; everything else
        # is adopted unverified — the first read re-checks its crc
        for sub in sorted(self.root.iterdir()):
            if not sub.is_dir():
                continue
            for f in sorted(sub.iterdir()):
                if f.name.endswith(".tmp"):
                    f.unlink(missing_ok=True)
                    continue
                try:
                    cid = int(f.name)
                except ValueError:
                    continue
                size = f.stat().st_size
                self._sizes[cid] = size
                self.bytes += size
                self._policy.on_insert(cid, size)
        self._evict_over_budget()

    def _evict_over_budget(self) -> None:
        # lock held; the tier has no pin concept, every entry is fair game
        while self.bytes > self.budget_bytes:
            victim = self._policy.victim(lambda c: False)
            if victim is None:
                break
            self._forget(victim)

    def _forget(self, cid: int) -> None:
        # lock held; policy bookkeeping is the caller's (victim() already
        # moved evictees to its ghost side; on_remove covers the rest)
        size = self._sizes.pop(cid, None)
        if size is not None:
            self.bytes -= size
        self._verified.discard(cid)
        self._path(cid).unlink(missing_ok=True)

    def get(self, cid: int, expected_crc: int | None) -> bytes | None:
        """Tiered payload bytes, or None (miss / dropped-as-bad)."""
        with self._lock:
            size = self._sizes.get(cid)
            if size is None:
                self.misses += 1
                return None
            try:
                data = self._path(cid).read_bytes()
            except OSError:
                data = None
            ok = (data is not None and len(data) == size
                  and (cid in self._verified or expected_crc is None
                       or crc32c(data) == expected_crc))
            if not ok:
                self._policy.on_remove(cid)
                self._forget(cid)
                self.misses += 1
                self.dropped += 1
                return None
            self._verified.add(cid)
            self.hits += 1
            self.bytes_served += len(data)
            self._policy.on_hit(cid)
            return data

    def put(self, cid: int, payload: bytes, expected_crc: int | None) -> None:
        """Fill from a coalesced-GET span; drops silently unless the
        payload matches the journaled crc (crc-verified-on-fill)."""
        if expected_crc is None or crc32c(payload) != expected_crc:
            return
        with self._lock:
            if cid in self._sizes:
                return
            path = self._path(cid)
            path.parent.mkdir(exist_ok=True)
            tmp = path.with_name(path.name + ".tmp")
            tmp.write_bytes(payload)
            os.replace(tmp, path)
            self._sizes[cid] = len(payload)
            self._verified.add(cid)
            self.bytes += len(payload)
            self.bytes_filled += len(payload)
            self._policy.on_insert(cid, len(payload))
            self._evict_over_budget()

    def retain(self, keep: Callable[[int], bool]) -> None:
        """Drop entries whose cid fails ``keep`` (compaction sweep /
        quarantine). Entries whose *payload* compaction rewrote (rebased
        patches) are caught lazily by the read-path crc check — which is
        why every surviving entry is demoted to unverified here: their
        expected crcs may have just changed under them."""
        with self._lock:
            for cid in [c for c in self._sizes if not keep(c)]:
                self._policy.on_remove(cid)
                self._forget(cid)
            self._verified.clear()

    def __len__(self) -> int:
        return len(self._sizes)


@register_backend("objectstore")
class ObjectStoreBackend(PlannedChainReader):
    """``ContainerBackend`` over an object API (module docstring, §11).

    The write path stages into RAM: ``put_many`` appends payloads to an
    open container buffer (rolled past ``max_object_bytes`` —
    multipart-style parts of one logical commit) and queues journal
    rows; ``flush()`` uploads the open buffer as one container object
    and everything journaled since the last flush as one journal
    object — so a committed stream costs O(stream/max_object_bytes)
    PUTs, not O(chunks). The container PUT always precedes its journal
    PUT: a crash between the two leaves an orphan container (cleaned on
    the next open), never a journal naming bytes that don't exist.

    Reads go through the inherited §9/§10 engine; every request is
    wrapped in retry-with-exponential-backoff on ``TransientError``
    (``max_retries``/``retry_backoff``), so an injected 429/timeout
    schedule below the retry budget is invisible to callers except in
    the client's request counters.

    Concurrency contract: identical to ``FileBackend`` (reads from any
    number of threads; writes serialized; ``rewrite_live``/``close``
    under full exclusion).
    """

    name = "objectstore"
    record_overhead = 0         # payloads packed bare; index in journal

    def __init__(self, path: str | Path | None = None, *,
                 client=None,
                 latency: float = 0.0,
                 bandwidth_bps: float | None = None,
                 fault_hook=None,
                 cache_bytes: int | None = None,
                 cache_shards: int | None = None,
                 cache_policy: str | None = None,
                 readahead: int | None = None,
                 coalesce_gap: int | None = None,
                 fetchers: int | None = None,
                 max_object_bytes: int | None = None,
                 max_retries: int | None = None,
                 retry_backoff: float | None = None,
                 retry_deadline: float | None = None,
                 verify_reads: bool = False,
                 singleflight: bool = True,
                 tier_path: str | Path | None = None,
                 tier_bytes: int | None = None,
                 faults=None) -> None:
        """Either ``path`` (a ``LocalObjectStore`` is built over it,
        forwarding ``latency``/``bandwidth_bps``/``fault_hook``) or an
        explicit ``client`` with the same surface. The serving knobs
        (``cache_bytes``/``cache_shards``/``readahead``/
        ``coalesce_gap``) mean what they do on ``FileBackend`` —
        ``coalesce_gap`` just defaults six orders of magnitude larger
        (§11.3). ``fetchers`` sizes the concurrent GET pool,
        ``max_retries``/``retry_backoff``/``retry_deadline`` the
        transient-failure budget (§13.5: backoff is decorrelated-jittered
        and total sleep per logical request is capped by the deadline).
        ``verify_reads`` checks every payload against its journaled
        crc32c (§13.2); ``faults`` threads a FaultInjector through the
        PUT-boundary crashpoints (tests only). ``cache_policy`` names
        the decode-cache eviction policy ("lru"/"arc", §14.1) and
        ``singleflight=False`` disables the §14.2 cold-decode collapse
        (benchmark A/B only). ``tier_path`` roots a local-disk chunk
        tier in front of the remote store (§14.3) budgeted by
        ``tier_bytes`` (default ``DEFAULT_TIER_BYTES``); the tier reuses
        the scan-resistant policy family and survives reopen."""
        if client is None:
            if path is None:
                raise ValueError("ObjectStoreBackend needs a path (local "
                                 "object root) or an explicit client")
            client = LocalObjectStore(path, latency=latency,
                                      bandwidth_bps=bandwidth_bps,
                                      fault_hook=fault_hook, faults=faults)
        self.client = client
        self._verify_reads = bool(verify_reads)
        self._faults = faults
        self._crcs: dict[int, int] = {}
        self._desc = f"objects at {getattr(client, 'root', None) or getattr(client, 'bucket', '?')}"
        self._max_object_bytes = (DEFAULT_OBJECT_BYTES
                                  if max_object_bytes is None
                                  else max(1, int(max_object_bytes)))
        self._max_retries = (DEFAULT_MAX_RETRIES if max_retries is None
                             else max(0, int(max_retries)))
        self._backoff = (DEFAULT_RETRY_BACKOFF if retry_backoff is None
                         else float(retry_backoff))
        # total seconds one logical request may spend ASLEEP across its
        # retries before RetryBudgetExceeded; None = attempts-only budget
        self._retry_deadline = (None if retry_deadline is None
                                else max(0.0, float(retry_deadline)))
        # decorrelated jitter needs a private RNG (never the global one —
        # tests seed that); the cap keeps one sleep bounded at what the
        # old deterministic schedule's final doubling would have been
        self._retry_rng = random.Random()
        self._backoff_cap = self._backoff * (1 << self._max_retries)
        self.retries = 0        # transient failures absorbed (lifetime)
        self._fetchers = (DEFAULT_FETCHERS if fetchers is None
                          else max(1, int(fetchers)))
        # --- PlannedChainReader state (base-class contract) ---
        self._index: dict[int, tuple[int, int, int, int]] = {}
        self._cache = ShardedDecodeCache(
            cache_bytes if cache_bytes is not None else DEFAULT_CACHE_BYTES,
            shards=cache_shards if cache_shards is not None
            else DEFAULT_CACHE_SHARDS,
            policy=cache_policy if cache_policy is not None
            else DEFAULT_CACHE_POLICY)
        self._init_read_engine_state(singleflight)
        if tier_path is not None:
            # the tier defaults to the scan-resistant policy even when
            # the in-RAM cache stays lru — scans must stream through the
            # disk tier too, and there is no compatibility reason to
            # rotate it (§14.3)
            self._tier = DiskTierCache(
                tier_path,
                tier_bytes if tier_bytes is not None else DEFAULT_TIER_BYTES,
                policy=cache_policy if cache_policy is not None else "arc")
        self._recipes: list[list[int] | None] = []
        self._recipe_lens: dict[int, list[int]] = {}
        self._max_recipe_cid = -1
        self._telemetry = IoTelemetry()
        self._readahead = (DEFAULT_READAHEAD if readahead is None
                           else max(0, int(readahead)))
        self._merge_gap = (DEFAULT_OBJSTORE_GAP if coalesce_gap is None
                           else max(0, int(coalesce_gap)))
        self._max_run = DEFAULT_OBJSTORE_MAX_RUN
        self._executor = None
        self._ex_lock = threading.Lock()
        # --- staging (guarded by _io_lock) ---
        self._io_lock = threading.Lock()
        self._pending = bytearray()     # open container object's payloads
        self._cur_seq = 0               # its sequence number
        self._chunk_rows: list[list[int]] = []   # journal rows not yet PUT
        self._journal_entries: list[dict] = []   # recipe/retire, in order
        self._next_journal = 0
        self._dirty = False
        self.epoch = 0
        self._scan()
        if self._manifest_missing:
            self._call(self.client.put, _MANIFEST_KEY,
                       json.dumps({"epoch": self.epoch}).encode())

    # --- request plumbing ----------------------------------------------------

    def _call(self, fn, *args):
        """Issue one client request with the retry policy (§11.2/§13.5):
        on ``TransientError`` sleep a decorrelated-jittered backoff
        (``uniform(base, 3 * previous_sleep)``, capped at
        ``backoff * 2^max_retries``) and reissue, up to ``max_retries``
        reissues AND at most ``retry_deadline`` total seconds asleep —
        whichever budget runs out first. Exhausting the attempt budget
        re-raises the last ``TransientError``; exhausting the deadline
        raises ``RetryBudgetExceeded`` carrying the attempt count and
        slept seconds. Every attempt — including failed ones — shows up
        in the client's own request counters; ``self.retries`` totals
        the absorbed faults. The loop itself is ``faults.with_retries``."""

        def on_backoff(delay: float, attempt: int) -> None:
            self.retries += 1

        return with_retries(fn, args, max_retries=self._max_retries,
                            backoff=self._backoff, cap=self._backoff_cap,
                            deadline=self._retry_deadline,
                            rng=self._retry_rng, on_backoff=on_backoff)

    @staticmethod
    def _chunk_key(epoch: int, seq: int) -> str:
        return f"e{epoch:08d}/chunks/{seq:08d}"

    @staticmethod
    def _journal_key(epoch: int, seq: int) -> str:
        return f"e{epoch:08d}/journal/{seq:08d}.json"

    # --- PlannedChainReader storage primitives -------------------------------

    def _fetch_width(self) -> int:
        return self._fetchers

    def _read_span(self, offset: int, length: int) -> bytes:
        seq, off = offset >> _OBJ_SHIFT, offset & _OBJ_MASK
        key = self._chunk_key(self.epoch, seq)
        try:
            data = self._call(self.client.get_range, key, off, length)
        except KeyError:
            # surface as the truncation error class the engine documents
            raise IOError(f"container object {key} missing "
                          f"({self._desc})") from None
        return data

    def _read_desc(self) -> str:
        return self._desc

    def _flush_if_dirty(self) -> None:
        # double-checked like FileBackend: readers skip the lock once clean
        if self._dirty:
            with self._io_lock:
                if self._dirty:
                    self._flush_locked()

    # --- write path ----------------------------------------------------------

    def _upload_pending_locked(self) -> None:
        if self._pending:
            self._call(self.client.put,
                       self._chunk_key(self.epoch, self._cur_seq),
                       bytes(self._pending))
            self._pending = bytearray()
            self._cur_seq += 1

    def _flush_locked(self) -> None:
        # container object first, journal second (module docstring: a
        # journal must never name bytes that were not uploaded before it)
        had_work = bool(self._pending or self._chunk_rows
                        or self._journal_entries)
        if had_work:
            self._cp(_CP_FLUSH_BEFORE_CONTAINER)
        self._upload_pending_locked()
        entries: list[dict] = []
        if self._chunk_rows:
            entries.append({"chunks": self._chunk_rows})
        entries.extend(self._journal_entries)
        if entries:
            self._cp(_CP_FLUSH_BETWEEN_PUTS)
            self._call(self.client.put,
                       self._journal_key(self.epoch, self._next_journal),
                       json.dumps(entries).encode())
            self._cp(_CP_FLUSH_AFTER_JOURNAL)
            self._next_journal += 1
            self._chunk_rows = []
            self._journal_entries = []
        self._dirty = False

    def _stage(self, cid: int, base: int, payload: bytes) -> tuple:
        crc = crc32c(payload)
        with self._io_lock:
            kind = _KIND_RAW if base < 0 else _KIND_DELTA
            if (self._pending and len(self._pending) + len(payload)
                    > self._max_object_bytes):
                self._upload_pending_locked()   # roll to the next part
            seq, off = self._cur_seq, len(self._pending)
            self._pending += payload
            self._chunk_rows.append([cid, kind, base if kind else -1,
                                     seq, off, len(payload), crc])
            self._dirty = True
        entry = (kind, base if kind else -1,
                 (seq << _OBJ_SHIFT) | off, len(payload))
        self._index[cid] = entry
        self._crcs[cid] = crc
        return entry

    def put_raw(self, cid: int, data: bytes) -> None:
        self._stage(cid, -1, data)
        self._cache.put(cid, data)

    def put_delta(self, cid: int, base: int, patch: bytes,
                  data: bytes | None = None) -> None:
        self._stage(cid, base, patch)
        if data is not None:
            self._cache.put(cid, data)

    def put_many(self, records: Sequence[tuple[int, int, bytes,
                                               bytes | None]]) -> None:
        for cid, base, payload, data in records:
            self._stage(cid, base, payload)
            if base < 0:
                data = payload
            if data is not None:
                self._cache.put(cid, data)

    def add_recipe(self, chunk_ids: Sequence[int],
                   lengths: Sequence[int] | None = None) -> int:
        recipe = [int(c) for c in chunk_ids]
        self._recipes.append(recipe)
        if recipe:
            self._max_recipe_cid = max(self._max_recipe_cid, max(recipe))
        handle = len(self._recipes) - 1
        entry: dict = {"recipe": recipe}
        if lengths is not None:
            lens = [int(n) for n in lengths]
            self._recipe_lens[handle] = lens
            entry["lens"] = lens
        with self._io_lock:
            self._journal_entries.append(entry)
            self._dirty = True
        return handle

    def retire_recipe(self, handle: int) -> None:
        self.recipe(handle)                 # raises on unknown/retired
        self._recipes[handle] = None
        self._recipe_lens.pop(handle, None)
        with self._io_lock:
            self._journal_entries.append({"retire": handle})
            self._dirty = True
            self._cp(_CP_RETIRE_BEFORE_FLUSH)
            # durable-tombstone parity with FileBackend's fsync: the PUT
            # completes before delete() returns, so a crash cannot
            # resurrect the stream
            self._flush_locked()

    def drop_chunks(self, cids: Sequence[int]) -> None:
        """Quarantine: durably un-index ``cids`` (scrub --repair, §13.3).
        The ``{"quarantine": [...]}`` journal entry is flushed (PUT)
        before this returns, so every later open agrees; the payload
        bytes stay in their container objects until the next compaction
        sweeps them. Callers guarantee no live recipe still references
        the cids and nothing deltas against them."""
        cids = sorted(int(c) for c in cids)
        if not cids:
            return
        with self._io_lock:
            self._journal_entries.append({"quarantine": cids})
            self._dirty = True
            self._flush_locked()
        dropped = set()
        for cid in cids:
            if self._index.pop(cid, None) is not None:
                dropped.add(cid)
            self._crcs.pop(cid, None)
            self._max_recipe_cid = max(self._max_recipe_cid, cid)
        self._cache.retain(lambda cid: cid not in dropped)
        if self._tier is not None:
            self._tier.retain(lambda cid: cid not in dropped)

    def storage_bytes(self) -> int:
        self.flush()
        return sum(size for _, size
                   in self._call(self.client.list, f"e{self.epoch:08d}/"))

    def rewrite_live(self, records: Iterable[tuple[int, int, int,
                                                   bytes]]) -> None:
        """Compaction commit (§11.4): stream the live set into fresh
        ``e{epoch+1}/`` container objects plus one consolidated journal,
        then flip ``manifest.json`` — the single atomic PUT that makes
        the new epoch the one ``_scan`` will replay — then delete the
        old epoch's objects. A crash before the flip leaves stale
        new-epoch objects (cleaned on next open); after it, stale
        old-epoch objects (ditto). Runs under the store's exclusive
        lifecycle lock, so no reads are in flight across the index swap."""
        with self._io_lock:
            self._flush_locked()    # nothing buffered crosses the flip
        old_epoch, new_epoch = self.epoch, self.epoch + 1
        new_index: dict[int, tuple[int, int, int, int]] = {}
        new_crcs: dict[int, int] = {}
        rows: list[list[int]] = []
        buf = bytearray()
        seq = 0
        for cid, kind, base, payload in records:
            if buf and len(buf) + len(payload) > self._max_object_bytes:
                self._call(self.client.put,
                           self._chunk_key(new_epoch, seq), bytes(buf))
                buf = bytearray()
                seq += 1
            off = len(buf)
            buf += payload
            crc = crc32c(payload)
            rows.append([cid, kind, base, seq, off, len(payload), crc])
            new_index[cid] = (kind, base, (seq << _OBJ_SHIFT) | off,
                              len(payload))
            new_crcs[cid] = crc
        if buf:
            self._call(self.client.put, self._chunk_key(new_epoch, seq),
                       bytes(buf))
            seq += 1
        self._cp(_CP_COMPACT_CONTAINERS_PUT)
        # consolidated recipe table: retired slots collapse to null
        # (tombstones dropped, handles stay stable — protocol contract)
        recipes_entry = {"recipes": [
            None if r is None else [r, self._recipe_lens.get(h)]
            for h, r in enumerate(self._recipes)]}
        self._call(self.client.put, self._journal_key(new_epoch, 0),
                   json.dumps([{"chunks": rows}, recipes_entry]).encode())
        self._cp(_CP_COMPACT_JOURNAL_PUT)
        self._call(self.client.put, _MANIFEST_KEY,
                   json.dumps({"epoch": new_epoch}).encode())     # the flip
        self._cp(_CP_COMPACT_MANIFEST_FLIPPED)
        for key, _ in self._call(self.client.list, f"e{old_epoch:08d}/"):
            self._call(self.client.delete_object, key)
        self.epoch = new_epoch
        self._index = new_index
        self._crcs = new_crcs
        self._cache.retain(new_index.__contains__)
        if self._tier is not None:
            # swept cids leave the tier now; entries whose payload the
            # rebase rewrote fail their next crc re-check and drop then
            self._tier.retain(new_index.__contains__)
        self._cur_seq = seq
        self._next_journal = 1
        self._dirty = False

    def scrub_stream(self):
        """Streaming scrub source (§14.5): ``(payload_requests, iter)``
        where the iterator yields ``(cid, payload | None)`` for every
        indexed chunk and ``payload_requests`` counts the client GETs it
        will cost — **one full GET per container object** instead of one
        ranged GET per chunk (the §13 scrub's per-record path). ``None``
        means the chunk's bytes are unreadable (container object missing
        or too short); scrub classifies those. Bypasses the decode cache
        and the disk tier by design — scrub verifies what the *store*
        holds, not what a cache holds."""
        self.flush()
        by_seq: dict[int, list[tuple[int, int, int]]] = {}
        for cid, (kind, base, voff, length) in self._index.items():
            by_seq.setdefault(voff >> _OBJ_SHIFT, []).append(
                (voff & _OBJ_MASK, length, cid))

        def stream():
            for seq in sorted(by_seq):
                key = self._chunk_key(self.epoch, seq)
                try:
                    blob = self._call(self.client.get, key)
                except (KeyError, OSError):
                    blob = None
                extents = sorted(by_seq[seq])
                if blob is None:
                    for _, _, cid in extents:
                        yield cid, None
                    continue
                view = memoryview(blob)
                for off, length, cid in extents:
                    if off + length > len(blob):
                        yield cid, None     # short object: torn record
                    else:
                        yield cid, bytes(view[off:off + length])

        return len(by_seq), stream()

    def flush(self) -> None:
        with self._io_lock:
            self._flush_locked()

    def close(self) -> None:
        self.flush()
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        close = getattr(self.client, "close", None)
        if close is not None:
            close()

    # --- open-time recovery --------------------------------------------------

    def _scan(self) -> None:
        cl = self.client
        try:
            manifest = json.loads(self._call(cl.get, _MANIFEST_KEY))
        except KeyError:
            manifest = None
        self._manifest_missing = manifest is None
        all_objects = self._call(cl.list, "")
        if manifest is None:
            # a crash before the very first manifest PUT: whatever
            # landed was never addressable — start clean
            self.epoch = 0
            for key, _ in all_objects:
                if key != _MANIFEST_KEY:
                    self._call(cl.delete_object, key)
            return
        self.epoch = int(manifest["epoch"])
        prefix = f"e{self.epoch:08d}/"
        chunk_prefix = prefix + "chunks/"
        journal_prefix = prefix + "journal/"
        sizes: dict[int, int] = {}
        journals: list[tuple[int, str]] = []
        stale: list[str] = []
        for key, size in all_objects:
            if key == _MANIFEST_KEY:
                continue
            if key.startswith(chunk_prefix):
                sizes[int(key[len(chunk_prefix):])] = size
            elif key.startswith(journal_prefix):
                journals.append((int(key[len(journal_prefix):-len(".json")]),
                                 key))
            else:       # another epoch: an interrupted compaction's debris
                stale.append(key)
        journals.sort()
        self._next_journal = journals[-1][0] + 1 if journals else 0
        for _, key in journals:
            for entry in json.loads(self._call(cl.get, key)):
                self._replay(entry)
        # drop index entries whose container object vanished or is too
        # short to hold them, then their delta dependents (a patch with
        # a lost base can never decode)
        lost = set()
        for cid, (kind, base, voff, length) in self._index.items():
            size = sizes.get(voff >> _OBJ_SHIFT)
            if size is None or (voff & _OBJ_MASK) + length > size:
                lost.add(cid)
        changed = bool(lost)
        while changed:
            changed = False
            for cid, (kind, base, _, _) in self._index.items():
                if kind == _KIND_DELTA and base in lost and cid not in lost:
                    lost.add(cid)
                    changed = True
        for cid in lost:
            del self._index[cid]
            self._crcs.pop(cid, None)
        # recovery-retire recipes naming chunks we no longer hold; the
        # retires are journaled durably so every later open agrees
        # (exactly the file backend's torn-tail policy, §10.6 — the ids
        # stay burned via _max_recipe_cid, never reissued)
        retired = []
        for h, recipe in enumerate(self._recipes):
            if recipe is not None and any(c not in self._index
                                          for c in recipe):
                self._recipes[h] = None
                self._recipe_lens.pop(h, None)
                retired.append(h)
        if retired:
            self._call(cl.put, self._journal_key(self.epoch,
                                                 self._next_journal),
                       json.dumps([{"retire": h} for h in retired]).encode())
            self._next_journal += 1
        # orphan containers (uploaded, journal PUT never landed) and
        # stale-epoch debris are unreachable: delete both
        referenced = {voff >> _OBJ_SHIFT
                      for _, _, voff, _ in self._index.values()}
        for seq in sorted(set(sizes) - referenced):
            self._call(cl.delete_object, self._chunk_key(self.epoch, seq))
        for key in stale:
            self._call(cl.delete_object, key)
        self._cur_seq = max(sizes, default=-1) + 1

    def _replay(self, entry: dict) -> None:
        if "chunks" in entry:
            for row in entry["chunks"]:
                # pre-§13 journals have 6-element rows (no crc); those
                # records replay fine and scrub as ``unverifiable``
                cid, kind, base, seq, off, length = (int(v)
                                                     for v in row[:6])
                self._index[cid] = (kind, base,
                                    (seq << _OBJ_SHIFT) | off, length)
                if len(row) > 6:
                    self._crcs[cid] = int(row[6])
        elif "quarantine" in entry:
            # scrub --repair dropped these cids (§13.3): un-index them
            # and burn their ids so they are never reissued
            for cid in entry["quarantine"]:
                cid = int(cid)
                self._index.pop(cid, None)
                self._crcs.pop(cid, None)
                self._max_recipe_cid = max(self._max_recipe_cid, cid)
        elif "recipe" in entry:
            recipe = [int(c) for c in entry["recipe"]]
            self._recipes.append(recipe)
            if recipe:
                self._max_recipe_cid = max(self._max_recipe_cid,
                                           max(recipe))
            if entry.get("lens") is not None:
                self._recipe_lens[len(self._recipes) - 1] = [
                    int(n) for n in entry["lens"]]
        elif "retire" in entry:
            h = int(entry["retire"])
            if 0 <= h < len(self._recipes):
                self._recipes[h] = None
                self._recipe_lens.pop(h, None)
        elif "recipes" in entry:            # consolidated (compaction)
            self._recipes = []
            self._recipe_lens = {}
            for slot in entry["recipes"]:
                if slot is None:
                    self._recipes.append(None)
                    continue
                recipe, lens = slot
                h = len(self._recipes)
                self._recipes.append([int(c) for c in recipe])
                if recipe:
                    self._max_recipe_cid = max(self._max_recipe_cid,
                                               max(recipe))
                if lens is not None:
                    self._recipe_lens[h] = [int(n) for n in lens]
