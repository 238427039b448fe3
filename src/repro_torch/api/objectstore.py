"""Object-store container backend, its fault-injecting local fake and the
``cp``/``ls``/``stat``/``verify``/``scrub`` CLI (port of
``repro.api.objectstore``).

  CLI                 ``python -m repro_torch.api.objectstore cp/ls/stat/
                      verify/scrub``: copy local files into a deduplicated
                      object store, list logical vs physical bytes,
                      verify restores by SHA-256, fsck. A store root holds
                      ``catalog.json`` (names -> stream handles, SHAs and
                      sizes, the pinned DedupConfig, the digest seeds) and
                      ``objects/`` (the object tree), byte for byte the
                      reference's layout, so either package's CLI reads a
                      root the other wrote. The one difference: ``cp``,
                      ``verify`` and ``scrub`` take ``--device`` (default
                      ``cuda``; ``cpu`` runs the store's plain path).

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
  S3ObjectClient      the same object API over a boto3 S3 client
                      (``backend="s3"``); boto3 is imported only when no
                      ``client=`` is given, so an in-process fake of the
                      boto3 surface drives it without boto3 or a network.
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

import argparse
import hashlib
import json
import os
import random
import sys
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


class S3ObjectClient:
    """boto3 adapter with the ``LocalObjectStore`` surface.

    Import of boto3 is deferred to construction — the dependency is
    optional and the rest of this module (backend, fake, CLI) must work
    without it. Select via ``DedupConfig(backend="s3", backend_args=
    {"bucket": ..., "prefix": ...})``. The tests drive it through
    ``client=`` with an in-process fake of the boto3 surface; a real
    bucket needs boto3 and a network.
    """

    def __init__(self, bucket: str, prefix: str = "",
                 client=None) -> None:
        if client is None:
            try:
                import boto3
            except ImportError as e:         # pragma: no cover
                raise RuntimeError(
                    "backend 's3' needs boto3, which is not installed; "
                    "use backend 'objectstore' (the local fake) instead"
                ) from e
            client = boto3.client("s3")      # pragma: no cover
        self._s3 = client
        self.bucket = bucket
        self.prefix = prefix.strip("/")

    def _key(self, key: str) -> str:
        return f"{self.prefix}/{key}" if self.prefix else key

    def _wrap(self, err) -> Exception:
        # 429/5xx and throttling codes are retryable; 404 maps to the
        # KeyError contract; anything else propagates untouched
        code = (getattr(err, "response", None) or {}).get(
            "ResponseMetadata", {}).get("HTTPStatusCode")
        if code in (429, 500, 502, 503, 504):
            return TransientError(code, str(err))
        return err

    def put(self, key: str, data: bytes) -> None:
        try:
            self._s3.put_object(Bucket=self.bucket, Key=self._key(key),
                                Body=data)
        except Exception as e:               # pragma: no cover
            raise self._wrap(e) from e

    def get(self, key: str) -> bytes:
        try:
            resp = self._s3.get_object(Bucket=self.bucket,
                                       Key=self._key(key))
            return resp["Body"].read()
        except Exception as e:
            if type(e).__name__ in ("NoSuchKey", "404"):
                raise KeyError(key) from None
            raise self._wrap(e) from e

    def get_range(self, key: str, start: int, length: int) -> bytes:
        try:
            resp = self._s3.get_object(
                Bucket=self.bucket, Key=self._key(key),
                Range=f"bytes={start}-{start + length - 1}")
            return resp["Body"].read()
        except Exception as e:
            if type(e).__name__ in ("NoSuchKey", "404"):
                raise KeyError(key) from None
            raise self._wrap(e) from e

    def head(self, key: str) -> int | None:
        try:
            resp = self._s3.head_object(Bucket=self.bucket,
                                        Key=self._key(key))
            return int(resp["ContentLength"])
        except Exception as e:
            code = (getattr(e, "response", None) or {}).get(
                "ResponseMetadata", {}).get("HTTPStatusCode")
            if code == 404:
                return None
            raise self._wrap(e) from e

    def list(self, prefix: str = "") -> list[tuple[str, int]]:
        out = []
        paginator = self._s3.get_paginator("list_objects_v2")
        full = self._key(prefix)
        strip = len(self.prefix) + 1 if self.prefix else 0
        for page in paginator.paginate(Bucket=self.bucket, Prefix=full):
            for obj in page.get("Contents", ()):
                out.append((obj["Key"][strip:], int(obj["Size"])))
        out.sort()
        return out

    def delete_object(self, key: str) -> None:
        try:
            self._s3.delete_object(Bucket=self.bucket, Key=self._key(key))
        except Exception as e:               # pragma: no cover
            raise self._wrap(e) from e


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

    # --- observability (§12) -------------------------------------------------

    _h_req_seconds = None
    _h_get_bytes = None
    _c_backoff = None

    def bind_observability(self, obs) -> None:
        """Base binding (run shapes + reader views) plus the remote-store
        instruments: per-request latency histograms by op, ranged-GET
        response sizes, retry/backoff accounting. The client's own
        request/byte counters — every attempt, fault-injected ones
        included — are re-exported as derived views."""
        super().bind_observability(obs)
        from repro_torch.api import observe as om
        m = obs.metrics
        self._h_req_seconds = {
            op: m.histogram("repro_objstore_request_seconds",
                            "Client request latency per attempt (§11.2)",
                            labels={"op": op}, bounds=om.SECONDS_BUCKETS)
            for op in ("put", "get", "head", "list", "delete")}
        self._h_get_bytes = m.histogram(
            "repro_objstore_get_bytes", "Ranged-GET response sizes (§11.3)",
            bounds=om.BYTES_BUCKETS)
        self._c_backoff = m.counter(
            "repro_objstore_backoff_seconds_total",
            "Time slept in the retry policy's exponential backoff")
        c_retries = m.counter("repro_objstore_retries_total",
                              "Transient failures absorbed by the retry "
                              "policy")
        client = self.client
        tier = self._tier
        c_tier = g_tier = None
        if tier is not None:
            c_tier = {
                "hit": m.counter("repro_tier_lookups_total",
                                 "Disk-tier probe outcomes (§14.3)",
                                 labels={"outcome": "hit"}),
                "miss": m.counter("repro_tier_lookups_total",
                                  "Disk-tier probe outcomes (§14.3)",
                                  labels={"outcome": "miss"}),
                "served": m.counter("repro_tier_bytes_total",
                                    "Bytes served from / filled into the "
                                    "disk tier", labels={"dir": "served"}),
                "filled": m.counter("repro_tier_bytes_total",
                                    "Bytes served from / filled into the "
                                    "disk tier", labels={"dir": "filled"}),
                "dropped": m.counter("repro_tier_dropped_total",
                                     "Tier entries unlinked on crc "
                                     "mismatch (bit rot or "
                                     "post-compaction staleness; §14.3)"),
            }
            g_tier = m.gauge("repro_tier_bytes", "Disk-tier residency")

        def _export_objstore_views() -> None:
            if c_tier is not None:
                c_tier["hit"].set_total(tier.hits)
                c_tier["miss"].set_total(tier.misses)
                c_tier["served"].set_total(tier.bytes_served)
                c_tier["filled"].set_total(tier.bytes_filled)
                c_tier["dropped"].set_total(tier.dropped)
                g_tier.set(tier.bytes)
            c_retries.set_total(self.retries)
            op_counts = getattr(client, "op_counts", None)
            if op_counts is not None:
                for op, n in list(op_counts.items()):
                    m.counter("repro_objstore_client_requests_total",
                              "Client requests by op, every attempt "
                              "counted", labels={"op": op}).set_total(n)
            for attr, d in (("bytes_put", "put"), ("bytes_got", "got")):
                v = getattr(client, attr, None)
                if v is not None:
                    m.counter("repro_objstore_client_bytes_total",
                              "Object bytes shipped to / from the store",
                              labels={"dir": d}).set_total(v)

        m.register_callback(_export_objstore_views)

    # client method name -> exported op label (§12.2 naming)
    _OP_LABELS = {"get_range": "get", "delete_object": "delete"}

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
        the absorbed faults. When an Observability is bound, every attempt
        also lands in the per-op latency histogram and each absorbed fault
        books its backoff into the counter (plus an ``objstore.retry``
        span when tracing is on). The loop itself is ``faults.with_retries``."""
        hists = self._h_req_seconds
        op = self._OP_LABELS.get(fn.__name__, fn.__name__)
        h = hists[op] if hists is not None else None
        on_attempt = ((lambda seconds, ok: h.observe(seconds))
                      if h is not None else None)

        def on_backoff(delay: float, attempt: int) -> None:
            self.retries += 1
            if self._c_backoff is not None:
                self._c_backoff.inc(delay)
                tr = self._obs.tracer
                if tr is not None:
                    tr.record("objstore.retry", delay, client_op=op,
                              attempt=attempt)

        return with_retries(fn, args, max_retries=self._max_retries,
                            backoff=self._backoff, cap=self._backoff_cap,
                            deadline=self._retry_deadline,
                            rng=self._retry_rng, on_attempt=on_attempt,
                            on_backoff=on_backoff)

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
        if self._h_get_bytes is not None:
            self._h_get_bytes.observe(len(data))
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


def _s3_backend(bucket: str, prefix: str = "", **kwargs):
    """Registry factory for ``DedupConfig(backend="s3")``: a real boto3
    client behind the same ObjectStoreBackend (boto3 gated at call time)."""
    return ObjectStoreBackend(client=S3ObjectClient(bucket, prefix),
                              **kwargs)


# registered only under the module's canonical name: run as ``python -m``
# the module executes once more as __main__, and its __main__ block hands
# over to the canonical module, which registers the backends exactly once
if __name__ != "__main__":
    register_backend("objectstore")(ObjectStoreBackend)
    register_backend("s3")(_s3_backend)


_CATALOG = "catalog.json"
_URL_SCHEME = "obj://"


def _human(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} TiB"       # pragma: no cover


def _split_obj_url(url: str) -> tuple[Path, str | None]:
    """``obj://ROOT`` or ``obj://ROOT/NAME`` -> (root, name|None).

    Resolution: a trailing slash, an existing directory, or a path with
    no surrounding catalog is the store *root*; a path whose parent
    holds ``catalog.json`` is ROOT/NAME. So ``cp f.bin obj://backups``
    names the object ``f.bin`` inside ``backups`` whether or not the
    store exists yet, and ``obj://backups/f.bin`` picks one object of
    an existing store."""
    rest = url[len(_URL_SCHEME):]
    if not rest:
        raise SystemExit(f"bad object URL {url!r}: empty path")
    if rest.endswith("/"):
        return Path(rest.rstrip("/")), None
    p = Path(rest)
    if (p / _CATALOG).is_file() or p.is_dir():
        return p, None
    if (p.parent / _CATALOG).is_file():
        return p.parent, p.name
    return p, None              # a store root that does not exist yet


class _CliStore:
    """One CLI invocation's session over a store root: the catalog plus
    a DedupStore built from the catalog's pinned config.

    The catalog persists what the in-memory store cannot recover from
    the backend alone: object names -> (stream handle, SHA-256, sizes)
    and the exact-dedup digest table (``DedupStore.digest_seeds``), so
    a later ``cp`` into the same root still dedups byte-identical
    chunks across invocations. Detector *resemblance* state is not
    persisted — a reopened store delta-compresses only against chunks
    it sees in its own invocation (documented limitation, §11.6).
    The store runs on ``device``: the card unless the caller asks for
    ``"cpu"``; the catalog and the object tree do not depend on it."""

    def __init__(self, root: Path, detector: str = "finesse",
                 chunk_size: int | None = None,
                 create: bool = False, latency: float = 0.0,
                 verify_reads: bool = False, device: str = "cuda") -> None:
        # local import: config imports the store; keeping it out of
        # module scope keeps backend-only users import-light
        from repro_torch.api.config import DedupConfig, build_store
        self.root = Path(root)
        self._cat_path = self.root / _CATALOG
        if self._cat_path.is_file():
            self.cat = json.loads(self._cat_path.read_text())
        elif create:
            self.root.mkdir(parents=True, exist_ok=True)
            chunker_args = ({"avg_size": int(chunk_size)}
                            if chunk_size else {})
            self.cat = {"config": {"detector": detector,
                                   "chunker": "fastcdc",
                                   "chunker_args": chunker_args,
                                   "backend": "objectstore",
                                   "backend_args": {"path": "objects"}},
                        "files": {}, "digests": {}}
        else:
            raise SystemExit(f"no object store at {self.root} "
                             f"(missing {_CATALOG})")
        cfg_dict = json.loads(json.dumps(self.cat["config"]))  # deep copy
        args = cfg_dict.setdefault("backend_args", {})
        # the catalog stores the object root relative to itself so the
        # whole store directory stays relocatable
        args["path"] = str(self.root / args.get("path", "objects"))
        if latency:
            args["latency"] = latency
        if verify_reads:
            cfg_dict["verify_reads"] = True
        self.cfg = DedupConfig.from_dict(cfg_dict)
        self.store = build_store(self.cfg, device=device)
        self._fitted = False
        seeds = {bytes.fromhex(k): int(v)
                 for k, v in self.cat.get("digests", {}).items()}
        if seeds:
            self.store.seed_digests(seeds)

    @property
    def files(self) -> dict:
        return self.cat["files"]

    def ingest(self, src: Path, name: str | None) -> tuple[str, dict]:
        data = src.read_bytes()
        name = name or src.name
        if self.cat["config"]["detector"] == "card" and not self._fitted:
            # CARD's context model needs an offline fit; train it on the
            # first incoming file of this invocation (§5)
            self.store.fit([data])
            self._fitted = True
        old = self.files.get(name)
        if old is not None:     # cp over an existing name replaces it
            self.store.delete(old["handle"])
        with self.store.open_stream() as s:
            s.write(data)
        rep = s.report
        entry = {"handle": rep.handle,
                 "sha256": hashlib.sha256(data).hexdigest(),
                 "bytes": rep.bytes_in, "stored": rep.bytes_stored,
                 "chunks": rep.chunks, "dup_chunks": rep.dup_chunks,
                 "delta_chunks": rep.delta_chunks}
        self.files[name] = entry
        return name, entry

    def save(self) -> None:
        self.store.backend.flush()
        self.cat["digests"] = {dig.hex(): cid for dig, cid
                               in self.store.digest_seeds().items()}
        tmp = self._cat_path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(self.cat, indent=1))
        os.replace(tmp, self._cat_path)

    def close(self) -> None:
        self.store.close()


def _cmd_cp(args) -> int:
    srcs, dst = list(args.src), args.dst
    to_store = dst.startswith(_URL_SCHEME)
    from_store = any(s.startswith(_URL_SCHEME) for s in srcs)
    if to_store == from_store:
        raise SystemExit("cp needs exactly one obj:// side "
                         "(local -> store or store -> local)")
    if to_store:
        root, name = _split_obj_url(dst)
        if name is not None and len(srcs) > 1:
            raise SystemExit(f"cannot copy {len(srcs)} files onto the "
                             f"single object name {name!r}")
        st = _CliStore(root, detector=args.detector,
                       chunk_size=args.chunk_size, create=True,
                       device=args.device)
        try:
            for s in srcs:
                src = Path(s)
                n, e = st.ingest(src, name)
                print(f"{src} -> {_URL_SCHEME}{root}/{n}  "
                      f"{_human(e['bytes'])} logical, "
                      f"{_human(e['stored'])} stored  "
                      f"(dcr {e['bytes'] / max(1, e['stored']):.2f})")
            st.save()
        finally:
            st.close()
        return 0
    if len(srcs) != 1:
        raise SystemExit("store -> local cp takes exactly one source")
    root, name = _split_obj_url(srcs[0])
    if name is None:
        raise SystemExit(f"source {srcs[0]!r} must name one object "
                         f"({_URL_SCHEME}ROOT/NAME)")
    st = _CliStore(root, device=args.device)
    try:
        entry = st.files.get(name)
        if entry is None:
            raise SystemExit(f"no object {name!r} in {root} "
                             f"(see: ls {_URL_SCHEME}{root})")
        data = st.store.restore(entry["handle"])
        if hashlib.sha256(data).hexdigest() != entry["sha256"]:
            raise SystemExit(f"restore of {name!r} failed its SHA-256 "
                             "check; not writing corrupt output")
        out = Path(args.dst)
        if out.is_dir():
            out = out / name
        out.write_bytes(data)
        print(f"{srcs[0]} -> {out}  {_human(len(data))} (sha256 ok)")
    finally:
        st.close()
    return 0


def _cmd_ls(args) -> int:
    root, _ = _split_obj_url(args.url)
    cat_path = root / _CATALOG
    if not cat_path.is_file():
        raise SystemExit(f"no object store at {root} (missing {_CATALOG})")
    files = json.loads(cat_path.read_text())["files"]
    print(f"{'LOGICAL':>12}  {'STORED':>12}  {'DCR':>6}  NAME")
    tot_in = tot_st = 0
    for name in sorted(files):
        e = files[name]
        tot_in += e["bytes"]
        tot_st += e["stored"]
        print(f"{_human(e['bytes']):>12}  {_human(e['stored']):>12}  "
              f"{e['bytes'] / max(1, e['stored']):>6.2f}  {name}")
    print(f"{_human(tot_in):>12}  {_human(tot_st):>12}  "
          f"{tot_in / max(1, tot_st):>6.2f}  ({len(files)} objects)")
    return 0


def _cmd_stat(args) -> int:
    root, _ = _split_obj_url(args.url)
    cat_path = root / _CATALOG
    if not cat_path.is_file():
        raise SystemExit(f"no object store at {root} (missing {_CATALOG})")
    cat = json.loads(cat_path.read_text())
    files = cat["files"]
    logical = sum(e["bytes"] for e in files.values())
    # physical truth from the object tree itself, not the catalog: this
    # is what a bucket bill would charge
    objects = LocalObjectStore(root / cat["config"]["backend_args"]
                               .get("path", "objects"))
    listing = objects.list("")
    physical = sum(size for _, size in listing)
    chunks = sum(1 for key, _ in listing if "/chunks/" in key)
    journals = sum(1 for key, _ in listing if "/journal/" in key)
    print(f"store root      {root}")
    print(f"objects (files) {len(files)}")
    print(f"logical bytes   {logical} ({_human(logical)})")
    print(f"physical bytes  {physical} ({_human(physical)})")
    print(f"space saved     {100.0 * (1 - physical / max(1, logical)):.1f}%"
          f"  (dcr {logical / max(1, physical):.2f})")
    print(f"container objs  {chunks}")
    print(f"journal objs    {journals}")
    print(f"detector        {cat['config']['detector']}")
    return 0


def _cmd_verify(args) -> int:
    from repro_torch.api.integrity import CorruptChunkError
    root, name = _split_obj_url(args.url)
    st = _CliStore(root, verify_reads=True, device=args.device)
    failed = 0
    try:
        names = args.names or ([name] if name else sorted(st.files))
        for n in names:
            entry = st.files.get(n)
            if entry is None:
                print(f"FAIL  {n}  (not in catalog)")
                failed += 1
                continue
            try:
                data = st.store.restore(entry["handle"])
            except CorruptChunkError as e:
                # the per-record crc32c caught it before SHA could (§13.2)
                print(f"FAIL  {n}  ({e})")
                failed += 1
                continue
            ok = (len(data) == entry["bytes"] and
                  hashlib.sha256(data).hexdigest() == entry["sha256"])
            rep = st.store.last_restore
            detail = (f"{_human(len(data))}, {rep.requests} reads, "
                      f"{_human(rep.bytes_read)} fetched")
            if ok:
                print(f"ok    {n}  ({detail})")
            else:
                print(f"FAIL  {n}  (restored bytes do not match the "
                      f"recorded SHA-256; {detail})")
                failed += 1
    finally:
        st.close()
    print(f"{len(names) - failed}/{len(names)} objects verified")
    return 1 if failed else 0


def _cmd_scrub(args) -> int:
    root, _ = _split_obj_url(args.url)
    st = _CliStore(root, device=args.device)
    try:
        report = st.store.scrub(repair=args.repair)
        print(f"chunks          {report.chunks} "
              f"({report.verified} verified, "
              f"{report.unverifiable} unverifiable)")
        print(f"bytes checked   {_human(report.bytes_checked)}")
        naive = report.payload_requests_naive
        if naive and report.payload_requests < naive:
            saved = naive - report.payload_requests
            print(f"GET requests    {report.payload_requests} streamed "
                  f"(vs {naive} per-chunk: {saved} saved, "
                  f"{100.0 * saved / naive:.0f}%)")
        print(f"streams         {report.streams}")
        if report.corrupt:
            print(f"CORRUPT chunks  {list(report.corrupt)}")
            for cid, n in sorted(report.blast_radius.items()):
                print(f"  cid {cid}: blast radius {n} stream(s)")
        if report.missing:
            print(f"MISSING chunks  {list(report.missing)}")
        if report.streams_lost:
            print(f"streams lost    {list(report.streams_lost)}")
        for err in report.structural_errors:
            print(f"structural      {err}")
        if report.repaired:
            print(f"repaired: quarantined {len(report.quarantined)} "
                  f"chunk(s), retired {len(report.retired_streams)} "
                  f"stream(s)")
            post = st.store.scrub()
            print(f"post-repair     {'clean' if post.clean else 'DIRTY'}")
            return 0 if post.clean else 1
        print("clean" if report.clean else "DIRTY (rerun with --repair "
              "to quarantine)")
        return 0 if report.clean else 1
    finally:
        st.close()


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api.objectstore",
        description="Deduplicated object-store front door (DESIGN.md "
                    "§11.6): copy files into a chunk-deduplicated, "
                    "delta-compressed object tree and restore them "
                    "SHA-verified. Store URLs look like obj://DIR or "
                    "obj://DIR/NAME. The commands that build a store "
                    "(cp, verify, scrub) run it on the CUDA device "
                    "unless given --device cpu.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    cp = sub.add_parser("cp", help="copy local files into a store, or "
                                   "one object back out")
    cp.add_argument("src", nargs="+",
                    help="local file(s), or one obj://ROOT/NAME source")
    cp.add_argument("dst", help="obj://ROOT[/NAME], or a local path")
    cp.add_argument("--detector", default="finesse",
                    help="resemblance detector for a NEW store "
                         "(finesse/card/dedup-only; default finesse — "
                         "card additionally trains its context model on "
                         "the first file)")
    cp.add_argument("--chunk-size", type=int, default=None,
                    help="average CDC chunk size for a NEW store (bytes)")
    ls = sub.add_parser("ls", help="list objects: logical vs stored "
                                   "bytes and per-file DCR")
    ls.add_argument("url", help="obj://ROOT")
    st = sub.add_parser("stat", help="whole-store accounting (logical "
                                     "vs physical bytes, object counts)")
    st.add_argument("url", help="obj://ROOT")
    vf = sub.add_parser("verify", help="restore object(s) with verified "
                                       "reads (per-chunk crc32c) and "
                                       "check SHA-256 against the catalog")
    vf.add_argument("url", help="obj://ROOT or obj://ROOT/NAME")
    vf.add_argument("names", nargs="*",
                    help="object names (default: every object)")
    sc = sub.add_parser("scrub", help="fsck the store: verify every "
                                      "record checksum, recipe "
                                      "reachability, refcounts; exit 1 "
                                      "when dirty")
    sc.add_argument("url", help="obj://ROOT")
    sc.add_argument("--repair", action="store_true",
                    help="quarantine corrupt chunks and retire dependent "
                         "streams (exit reflects the post-repair scrub)")
    for p in (cp, vf, sc):
        p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                       help="where the store runs (default: the CUDA "
                            "device; a missing one raises)")
    args = ap.parse_args(argv)
    return {"cp": _cmd_cp, "ls": _cmd_ls, "stat": _cmd_stat,
            "verify": _cmd_verify, "scrub": _cmd_scrub}[args.cmd](args)


if __name__ == "__main__":      # pragma: no cover - thin; logic is main()
    # defer to the canonical module so backends register exactly once
    from repro_torch.api import objectstore as _canonical
    sys.exit(_canonical.main(sys.argv[1:]))
