"""Restore/serving fast path: planner + bounded decode cache (port of
``repro.api.restore``, whole; DESIGN.md §9).

CARD's whole point is detecting *more* resemblance, which means a larger
delta-chunk fraction and deeper base chains — so serving a stream back is
dominated by chain decodes and container reads, not hash lookups. This
module holds the two pieces of the read path that are pure policy (no
backend I/O), so every backend and the store share them:

    plan_chains    group the requested chunk ids by shared base chains,
                   topologically order the decodes so every base is
                   decoded exactly once per restore, and schedule the
                   physical payload reads in ascending log-offset order
                   (the backend coalesces adjacent records into batched
                   sequential reads);
    DecodeCache    byte-budgeted cache over materialized chunk bytes with
                   chain-aware pinning: an entry a still-pending patch in
                   the current plan decodes against is pinned and cannot
                   be evicted, everything else rotates under the budget
                   according to a pluggable :class:`CachePolicy`
                   ("lru" or the scan-resistant "arc", DESIGN.md §14.1).
                   Replaces FileBackend's unbounded dict cache —
                   restoring a store larger than RAM no longer
                   materializes the whole dataset.
    RecipeLayout   prefix sums over a recipe's materialized chunk
                   lengths; maps a byte range onto the minimal chunk-id
                   window so ``restore_range`` decodes only what the
                   range overlaps.

The planner consumes two callbacks instead of a backend so it stays
dependency-free (and unit-testable on synthetic topologies):
``entry(cid) -> (base, offset, length)`` describes the stored record
(``base < 0`` = raw) and ``is_cached(cid)`` asks the decode cache.
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
import threading
from collections import OrderedDict
from typing import Callable, Protocol, Sequence

from repro_torch.api.registry import get_cache_policy, register_cache_policy

#: Default decode-cache budget for file-backed stores. Large enough that
#: version-chain restores stay warm, small enough that restoring a
#: multi-GB store does not silently become an in-RAM copy of it.
DEFAULT_CACHE_BYTES = 128 << 20

#: Default shard count for :class:`ShardedDecodeCache` (DESIGN.md §10.2).
#: Sequential chunk ids stripe round-robin across shards, so adjacent
#: chunks of one restore — and concurrent restores of different streams —
#: rarely contend on the same shard lock.
DEFAULT_CACHE_SHARDS = 8

#: Default eviction policy (DESIGN.md §14.1). "lru" preserves the
#: pre-§14 behaviour bit-for-bit; "arc" adds scan resistance.
DEFAULT_CACHE_POLICY = "lru"


class CachePolicy(Protocol):
    """Eviction-ordering strategy behind :class:`DecodeCache`
    (DESIGN.md §14.1).

    The cache owns storage (``cid -> bytes``), pin refcounts, the byte
    ledger, and the lock; the policy owns only *ordering* metadata —
    which live cid to evict next, plus any ghost bookkeeping for
    entries already evicted. Every method is called with the cache's
    shard lock held, so policies need no locking of their own. The
    policy's live-entry book must mirror the cache's entries exactly:
    every ``on_insert``ed cid stays known until ``victim`` returns it
    or ``on_remove`` drops it.

    Factories are registered via ``register_cache_policy(name)`` and
    take the shard's ``budget_bytes`` (ghost lists size themselves off
    it).
    """

    ghost_hits: int   # evicted-then-rereferenced events (scan signal)
    evictions: int    # victims handed back from victim()

    def on_hit(self, cid: int) -> None:
        """A cached cid was referenced (get/get_present/try_pin)."""

    def on_insert(self, cid: int, nbytes: int) -> None:
        """``put`` stored ``nbytes`` for cid (may replace a live entry;
        policies must treat a live re-insert as a size update + touch)."""

    def on_remove(self, cid: int) -> None:
        """cid was invalidated (compaction ``retain``): forget it
        entirely — no ghost entry, the chunk no longer exists."""

    def victim(self, is_pinned: Callable[[int], object]) -> int | None:
        """Pick, book-keep (live -> ghost), and return the next evictee,
        skipping cids where ``is_pinned(cid)`` is truthy; None when every
        live entry is pinned."""


@register_cache_policy("lru")
class LruCachePolicy:
    """Classic least-recently-used — the pre-§14 inlined policy, byte
    identical: one recency queue, oldest unpinned entry evicts first,
    no ghost memory (``ghost_hits`` stays 0)."""

    def __init__(self, budget_bytes: int) -> None:
        self._order: "OrderedDict[int, int]" = OrderedDict()
        self.ghost_hits = 0
        self.evictions = 0

    def on_hit(self, cid: int) -> None:
        self._order.move_to_end(cid)

    def on_insert(self, cid: int, nbytes: int) -> None:
        self._order[cid] = nbytes
        self._order.move_to_end(cid)

    def on_remove(self, cid: int) -> None:
        self._order.pop(cid, None)

    def victim(self, is_pinned: Callable[[int], object]) -> int | None:
        cid = next((c for c in self._order if not is_pinned(c)), None)
        if cid is not None:
            del self._order[cid]
            self.evictions += 1
        return cid


@register_cache_policy("arc")
class ArcCachePolicy:
    """Scan-resistant adaptive policy (ARC-style ghost lists, §14.1).

    Live entries split into a recency queue T1 (seen once) and a
    frequency queue T2 (seen again while live); evicted cids leave a
    byte-sized *ghost* in B1/B2 mirroring the queue they died in. A
    miss that lands on a ghost is a reuse the cache failed to hold —
    the adaptation target ``p`` (how many budget bytes T1 deserves)
    grows on B1 ghost hits and shrinks on B2 ghost hits, and the
    reinserted cid goes straight to T2. A whole-store scan touches
    every chunk exactly once, so its pages live and die in T1 without
    ever displacing T2 — the hot chain bases pointed restores need.

    Sizes are bytes, not entry counts — chunk sizes vary ~100× and an
    entry-counted ARC would let one jumbo raw chunk evict a thousand
    hot bases. Ghost lists are trimmed to one budget's worth of bytes
    per side, so policy overhead stays O(metadata), never O(payload).
    """

    def __init__(self, budget_bytes: int) -> None:
        self.budget_bytes = int(budget_bytes)
        self._t1: "OrderedDict[int, int]" = OrderedDict()  # recency
        self._t2: "OrderedDict[int, int]" = OrderedDict()  # frequency
        self._b1: "OrderedDict[int, int]" = OrderedDict()  # ghosts of T1
        self._b2: "OrderedDict[int, int]" = OrderedDict()  # ghosts of T2
        self._t1_bytes = 0
        self._b1_bytes = 0
        self._b2_bytes = 0
        self._p = 0               # byte target for T1
        self.ghost_hits = 0
        self.evictions = 0

    def on_hit(self, cid: int) -> None:
        nbytes = self._t1.pop(cid, None)
        if nbytes is not None:    # second reference: promote to T2
            self._t1_bytes -= nbytes
            self._t2[cid] = nbytes
        elif cid in self._t2:
            self._t2.move_to_end(cid)

    def on_insert(self, cid: int, nbytes: int) -> None:
        nbytes = int(nbytes)
        if cid in self._t1:       # live replacement: size update + touch
            self._t1_bytes += nbytes - self._t1[cid]
            self._t1[cid] = nbytes
            self._t1.move_to_end(cid)
            return
        if cid in self._t2:
            self._t2[cid] = nbytes
            self._t2.move_to_end(cid)
            return
        ghost = self._b1.pop(cid, None)
        if ghost is not None:     # recency ghost: T1 was too small
            self._b1_bytes -= ghost
            self.ghost_hits += 1
            self._p = min(self.budget_bytes, self._p + ghost)
            self._t2[cid] = nbytes
            return
        ghost = self._b2.pop(cid, None)
        if ghost is not None:     # frequency ghost: T1 was too greedy
            self._b2_bytes -= ghost
            self.ghost_hits += 1
            self._p = max(0, self._p - ghost)
            self._t2[cid] = nbytes
            return
        self._t1[cid] = nbytes    # brand new: recency side
        self._t1_bytes += nbytes

    def on_remove(self, cid: int) -> None:
        nbytes = self._t1.pop(cid, None)
        if nbytes is not None:
            self._t1_bytes -= nbytes
        else:
            self._t2.pop(cid, None)
        # invalidations leave no ghost: the chunk is gone from the
        # store, remembering it would skew adaptation toward dead ids

    def victim(self, is_pinned: Callable[[int], object]) -> int | None:
        # evict from T1 while it overshoots its target (or T2 is empty),
        # else from T2; fall back to the other queue when the preferred
        # one holds only pinned entries
        prefer_t1 = self._t1_bytes > self._p or not self._t2
        queues = (self._t1, self._t2) if prefer_t1 else (self._t2, self._t1)
        for queue in queues:
            cid = next((c for c in queue if not is_pinned(c)), None)
            if cid is None:
                continue
            nbytes = queue.pop(cid)
            if queue is self._t1:
                self._t1_bytes -= nbytes
                self._b1[cid] = nbytes
                self._b1_bytes += nbytes
            else:
                self._b2[cid] = nbytes
                self._b2_bytes += nbytes
            self.evictions += 1
            self._trim_ghosts()
            return cid
        return None

    def _trim_ghosts(self) -> None:
        # each ghost side remembers at most one budget's worth of
        # evicted bytes — enough to recognize any reuse the live cache
        # could possibly have held, bounded so metadata cannot grow
        # with the store
        while self._b1_bytes > self.budget_bytes and self._b1:
            _, nbytes = self._b1.popitem(last=False)
            self._b1_bytes -= nbytes
        while self._b2_bytes > self.budget_bytes and self._b2:
            _, nbytes = self._b2.popitem(last=False)
            self._b2_bytes -= nbytes


def _resolve_policy(policy: str, budget_bytes: int):
    factory = get_cache_policy(policy)
    return factory(budget_bytes)


class DecodeCache:
    """Byte-budgeted cache of materialized chunk bytes with pinning and
    a pluggable eviction policy (DESIGN.md §9, §14.1).

    ``pin``/``unpin`` are refcounted; pinned entries are skipped by
    eviction (the restore planner pins a base until the last dependent
    patch of the current plan has decoded against it, so a plan never
    re-decodes a chain it already walked). ``peak_bytes`` is sampled at
    stable points (after each eviction pass), which is what the budget
    acceptance test pins.

    Eviction *ordering* is delegated to a :class:`CachePolicy` resolved
    by registry name ("lru" default, "arc" scan-resistant); storage,
    pins, byte accounting, and hit/miss counters live here so the
    pin/try_pin/get_present contracts are identical under every policy.

    Every mutating operation is atomic under an internal lock, so a
    single instance is safe to share between restore threads — and it is
    the shard building block of :class:`ShardedDecodeCache`, which
    spreads that lock N ways (DESIGN.md §10.2).
    """

    def __init__(self, budget_bytes: int = DEFAULT_CACHE_BYTES,
                 policy: str = DEFAULT_CACHE_POLICY) -> None:
        if budget_bytes <= 0:
            raise ValueError(f"cache budget must be positive, got {budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self.policy_name = str(policy)
        self._policy = _resolve_policy(self.policy_name, self.budget_bytes)
        self._lock = threading.Lock()
        self._entries: dict[int, bytes] = {}
        self._pins: dict[int, int] = {}
        self.bytes = 0
        self.peak_bytes = 0
        self.hits = 0
        self.misses = 0

    def __contains__(self, cid: int) -> bool:
        return cid in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, cid: int) -> bytes | None:
        """Cached bytes (touching the policy's ordering) or None; counts
        hit/miss."""
        with self._lock:
            data = self._entries.get(cid)
            if data is None:
                self.misses += 1
                return None
            self.hits += 1
            self._policy.on_hit(cid)
            return data

    def peek(self, cid: int) -> bytes | None:
        """``get`` without touching the hit/miss counters or eviction
        order — for plan-internal base lookups (the plan itself pinned
        the entry moments ago; counting those as hits would inflate the
        §9.4 telemetry every cold restore of a delta chain). Still takes
        the lock — other threads mutate the dict under it, and the
        thread-safety contract is every-operation-atomic, not
        GIL-happens-to-save-us."""
        with self._lock:
            return self._entries.get(cid)

    def get_present(self, cids: Sequence[int]) -> dict[int, bytes]:
        """Batched ``get``: one lock acquisition for the whole batch —
        the warm-restore hot path (§10.2) would otherwise pay a lock
        round-trip per recipe slot. Counter/ordering semantics are
        identical to per-cid ``get``; absent cids are simply missing
        from the result (and counted as misses — a caller that then
        materializes them itself must reclassify, see
        ``PlannedChainReader.get_many``)."""
        with self._lock:
            entries = self._entries
            on_hit = self._policy.on_hit
            found: dict[int, bytes] = {}
            for cid in cids:
                data = entries.get(cid)
                if data is None:
                    self.misses += 1
                else:
                    self.hits += 1
                    on_hit(cid)
                    found[cid] = data
            return found

    def put(self, cid: int, data: bytes, pin: bool = False) -> None:
        with self._lock:
            old = self._entries.get(cid)
            if old is not None:
                self.bytes -= len(old)
            self._entries[cid] = data
            self.bytes += len(data)
            self._policy.on_insert(cid, len(data))
            if pin:
                self._pins[cid] = self._pins.get(cid, 0) + 1
            self._evict()

    def pin(self, cid: int) -> None:
        """Protect an already-cached entry from eviction (refcounted)."""
        with self._lock:
            if cid not in self._entries:
                raise KeyError(f"cannot pin uncached chunk {cid}")
            self._pins[cid] = self._pins.get(cid, 0) + 1

    def try_pin(self, cid: int) -> bytes | None:
        """Atomically pin-and-return a cached entry, or None when absent.

        The concurrent planner probe (DESIGN.md §10.2): between "is this
        cached?" and "pin it" another thread's eviction could drop the
        entry, so the two must be one operation. Deliberately does NOT
        count hits/misses — the serial planner's ``is_cached`` probe was
        uncounted too, and probing every chain node would otherwise
        inflate the §9.4 telemetry on every cold restore. It IS a real
        reuse though, so the policy ordering is touched."""
        with self._lock:
            data = self._entries.get(cid)
            if data is None:
                return None
            self._policy.on_hit(cid)
            self._pins[cid] = self._pins.get(cid, 0) + 1
            return data

    def unpin(self, cid: int) -> None:
        with self._lock:
            left = self._pins.get(cid, 0) - 1
            if left < 0:
                raise ValueError(f"unpin underflow on chunk {cid}")
            if left:
                self._pins[cid] = left
            else:
                self._pins.pop(cid, None)
                self._evict()

    def retain(self, keep: Callable[[int], bool]) -> None:
        """Drop every unpinned entry whose cid fails ``keep`` (compaction)."""
        with self._lock:
            for cid in [c for c in self._entries
                        if not keep(c) and not self._pins.get(c)]:
                data = self._entries.pop(cid)
                self._policy.on_remove(cid)
                self.bytes -= len(data)

    @property
    def ghost_hits(self) -> int:
        return self._policy.ghost_hits

    @property
    def evictions(self) -> int:
        return self._policy.evictions

    def _evict(self) -> None:
        # called with self._lock held. The policy picks victims (and
        # does its ghost bookkeeping); pinned bytes may transiently
        # exceed the budget (the plan working set), and then nothing
        # can be dropped until an unpin
        while self.bytes > self.budget_bytes:
            victim = self._policy.victim(self._pins.get)
            if victim is None:
                break
            self.bytes -= len(self._entries.pop(victim))
        if self.bytes > self.peak_bytes:
            self.peak_bytes = self.bytes


class ShardedDecodeCache:
    """N independent :class:`DecodeCache` shards behind one facade
    (DESIGN.md §10.2).

    Chunk ids stripe across shards (``cid % shards``); the global byte
    budget is apportioned across shards (remainder spread one byte per
    leading shard), so the sum of shard budgets is exactly the global
    budget and the aggregate ``peak_bytes`` (sum of shard peaks) can
    only exceed it when pinned working sets do — same contract a single
    cache has. Each operation takes exactly one shard lock, so restore
    threads working different parts of the id space never contend.

    Counters (``hits``/``misses``/``bytes``/``peak_bytes``) aggregate
    across shards; on a serial workload they equal a single-shard cache's
    counters as long as no eviction fires (eviction order is per-shard,
    not global — the one observable policy difference).

    Every shard runs its own instance of the same :class:`CachePolicy`
    (§14.1), each adapting to the id-striped slice of traffic it sees.
    """

    def __init__(self, budget_bytes: int = DEFAULT_CACHE_BYTES,
                 shards: int = DEFAULT_CACHE_SHARDS,
                 policy: str = DEFAULT_CACHE_POLICY) -> None:
        if budget_bytes <= 0:
            raise ValueError(f"cache budget must be positive, got {budget_bytes}")
        if shards <= 0:
            raise ValueError(f"shard count must be positive, got {shards}")
        # never hand a shard a zero budget (DecodeCache rejects it)
        shards = min(int(shards), int(budget_bytes))
        base, rem = divmod(int(budget_bytes), shards)
        self.shards = [DecodeCache(base + (1 if i < rem else 0), policy=policy)
                       for i in range(shards)]
        self.budget_bytes = int(budget_bytes)
        self.policy_name = str(policy)

    def _shard(self, cid: int) -> DecodeCache:
        return self.shards[cid % len(self.shards)]

    def __contains__(self, cid: int) -> bool:
        return cid in self._shard(cid)

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    def get(self, cid: int) -> bytes | None:
        return self._shard(cid).get(cid)

    def peek(self, cid: int) -> bytes | None:
        return self._shard(cid).peek(cid)

    def get_present(self, cids: Sequence[int]) -> dict[int, bytes]:
        """Batched ``get`` across shards: cids group by shard and each
        shard is locked once, so a warm restore costs O(shards) lock
        round-trips instead of O(chunks)."""
        shards = self.shards
        n = len(shards)
        if n == 1:
            return shards[0].get_present(cids)
        groups: list[list[int] | None] = [None] * n
        for cid in cids:
            g = groups[cid % n]
            if g is None:
                groups[cid % n] = [cid]
            else:
                g.append(cid)
        found: dict[int, bytes] = {}
        for idx, group in enumerate(groups):
            if group is not None:
                found.update(shards[idx].get_present(group))
        return found

    def put(self, cid: int, data: bytes, pin: bool = False) -> None:
        self._shard(cid).put(cid, data, pin=pin)

    def pin(self, cid: int) -> None:
        self._shard(cid).pin(cid)

    def try_pin(self, cid: int) -> bytes | None:
        return self._shard(cid).try_pin(cid)

    def unpin(self, cid: int) -> None:
        self._shard(cid).unpin(cid)

    def retain(self, keep: Callable[[int], bool]) -> None:
        for s in self.shards:
            s.retain(keep)

    @property
    def hits(self) -> int:
        return sum(s.hits for s in self.shards)

    @property
    def misses(self) -> int:
        return sum(s.misses for s in self.shards)

    @property
    def bytes(self) -> int:
        return sum(s.bytes for s in self.shards)

    @property
    def peak_bytes(self) -> int:
        return sum(s.peak_bytes for s in self.shards)

    @property
    def ghost_hits(self) -> int:
        return sum(s.ghost_hits for s in self.shards)

    @property
    def evictions(self) -> int:
        return sum(s.evictions for s in self.shards)

    @property
    def _pins(self) -> dict[int, int]:
        # merged read-only view (shards never share a cid)
        merged: dict[int, int] = {}
        for s in self.shards:
            merged.update(s._pins)
        return merged


@dataclasses.dataclass
class RestorePlan:
    """One restore's worth of work, planned before any I/O happens.

    targets       requested chunk ids, deduplicated, request order
    decode_order  every chunk the plan decodes, bases strictly before
                  their dependents, each exactly once
    reads         (offset, length, cid) payload reads in ascending
                  container-offset order — the backend merges adjacent
                  entries into batched sequential reads
    dependents    cid -> how many patches in this plan decode against it
                  (the decode loop pins a base until this drains to 0)
    cached_bases  chain walks that stopped at an already-cached chunk;
                  the executor pins these up front so eviction cannot
                  race the plan
    """

    targets: list[int]
    decode_order: list[int]
    reads: list[tuple[int, int, int]]
    dependents: dict[int, int]
    cached_bases: list[int]

    def __len__(self) -> int:
        return len(self.decode_order)


def plan_chains(targets: Sequence[int],
                entry: Callable[[int], tuple[int, int, int]],
                is_cached: Callable[[int], bool]) -> RestorePlan:
    """Plan the decode of ``targets`` (see module docstring).

    ``entry(cid)`` -> ``(base, offset, length)`` for the stored record
    (``base < 0`` raw); ``is_cached`` consults the decode cache. Chains
    share suffixes freely: a base reached from several targets is read
    and decoded once, and a walk that hits an already-planned or cached
    chunk stops there.
    """
    decode_order: list[int] = []
    planned: set[int] = set()
    dependents: dict[int, int] = {}
    cached_seen: set[int] = set()
    cached_bases: list[int] = []
    reads: list[tuple[int, int, int]] = []
    uniq = list(dict.fromkeys(int(t) for t in targets))
    for tgt in uniq:
        path: list[int] = []
        cur = tgt
        while cur not in planned:
            if is_cached(cur):
                # record it as a pinnable base only when a patch in this
                # plan decodes against it — a cached *target* is served
                # straight from the cache and needs no pin
                if cur != tgt and cur not in cached_seen:
                    cached_seen.add(cur)
                    cached_bases.append(cur)
                break
            base, offset, length = entry(cur)
            path.append(cur)
            planned.add(cur)
            reads.append((offset, length, cur))
            if base < 0:
                break
            dependents[base] = dependents.get(base, 0) + 1
            cur = base
        decode_order.extend(reversed(path))
    reads.sort()
    return RestorePlan(targets=uniq, decode_order=decode_order, reads=reads,
                       dependents=dependents, cached_bases=cached_bases)


def coalesce_reads(reads: Sequence[tuple[int, int, int]], gap: int,
                   max_run: int) -> list[tuple[int, int, list]]:
    """Merge a plan's offset-sorted ``(offset, length, cid)`` reads into
    sequential runs ``(start, end, extents)`` (DESIGN.md §9.1).

    Adjacent extents whose gap is at most ``gap`` bytes are fetched as
    one read; runs are capped near ``max_run`` so a single slab never
    dwarfs the decode-cache budget. The gap is a *backend* knob
    (``coalesce_gap`` / ``DedupConfig.restore_coalesce_gap``): a local
    file wants KB-scale gaps (skipping dead records is nearly free), an
    object store wants MB-scale gaps so one ranged GET amortizes its
    request latency over many extents (§11.3). ``reads`` must already be
    sorted by offset — ``plan_chains`` emits them that way."""
    runs: list[tuple[int, int, list]] = []
    i, n_reads = 0, len(reads)
    while i < n_reads:
        start = reads[i][0]
        end = start + reads[i][1]
        j = i + 1
        while (j < n_reads
               and reads[j][0] - end <= gap
               and end - start < max_run):
            end = max(end, reads[j][0] + reads[j][1])
            j += 1
        runs.append((start, end, list(reads[i:j])))
        i = j
    return runs


class RecipeLayout:
    """Prefix sums over a recipe's materialized chunk lengths.

    Maps byte ranges onto chunk windows for ``restore_range``. Lengths
    are invariant under compaction (rebasing rewrites *patches*, never
    materialized bytes — DESIGN.md §7.2), so a layout stays valid for a
    handle's whole lifetime; the store drops it on ``delete``.
    """

    def __init__(self, lengths: Sequence[int]) -> None:
        # plain list + bisect: scalar np.searchsorted costs ~4µs a call,
        # which dominates small ranged reads (§10.7 profile)
        self._ends = list(itertools.accumulate(int(n) for n in lengths))

    @property
    def total_bytes(self) -> int:
        return self._ends[-1] if self._ends else 0

    def chunk_window(self, offset: int, length: int) -> tuple[int, int, int]:
        """``(first, last, skip)``: recipe slots ``first..last`` (inclusive)
        cover ``[offset, offset+length)``, whose first requested byte sits
        ``skip`` bytes into chunk ``first``. Empty ranges return
        ``(0, -1, 0)``."""
        if offset < 0 or length < 0:
            raise ValueError(f"negative range ({offset}, {length})")
        total = self.total_bytes
        start = min(offset, total)
        end = min(offset + length, total)
        if end <= start:
            return (0, -1, 0)
        ends = self._ends
        first = bisect.bisect_right(ends, start)
        last = bisect.bisect_left(ends, end)
        chunk_start = ends[first - 1] if first else 0
        return (first, last, start - chunk_start)
