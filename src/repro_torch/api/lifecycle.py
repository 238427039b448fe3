"""Space reclamation: deletion, mark-sweep collection, compaction (port of
``repro.api.lifecycle``; DESIGN.md §7).

The store is append-only until something here runs. Three operations,
each delegated to by ``DedupStore``:

    delete_stream(store, handle)   retire a recipe; decref its chunks in
                                   the refcount table (api/refcount.py)
                                   — a chunk another stream's patch still
                                   decodes against stays *pinned*, never
                                   collected out from under the patch;
    collect(store)                 mark-sweep accounting pass: classify
                                   every tracked chunk live/pinned/dead,
                                   refresh StoreStats and the delta
                                   chain-depth histogram; mutates no data;
    compact(store)                 rewrite the container with only
                                   recipe-live records. Live delta chunks
                                   whose base is *not* kept (it died, or
                                   is pinned-only and being evicted) are
                                   **rebased**: re-encoded against their
                                   nearest surviving ancestor, or
                                   materialized to raw — whichever is
                                   smaller. Safe because a patch decodes
                                   against the base's *materialized*
                                   bytes, which compaction never changes.

Whether a delete triggers compaction automatically is a pluggable
``ReclamationPolicy`` chosen via ``DedupConfig`` (registry key
``policy``): "eager" compacts whenever reclaimable bytes exist,
"threshold" when the reclaimable fraction of the container crosses a
ratio, "never" (the default) leaves it to explicit ``compact()`` calls.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Protocol, runtime_checkable

from repro_torch.api import containers
from repro_torch.api.refcount import RefcountTable
from repro_torch.api.registry import register_policy
from repro_torch.api.types import StoreStats
from repro_torch.core import delta


@dataclasses.dataclass(frozen=True)
class CollectReport:
    """One mark-sweep pass over the refcount table (no data mutated)."""

    live_chunks: int
    pinned_chunks: int
    dead_chunks: int
    live_bytes: int
    pinned_bytes: int
    dead_bytes: int
    chain_depth_hist: dict[int, int]

    @property
    def reclaimable_bytes(self) -> int:
        """Logical payload bytes a compaction pass would drop (before any
        growth from rebasing pinned bases into their dependents)."""
        return self.pinned_bytes + self.dead_bytes


@dataclasses.dataclass(frozen=True)
class CompactionRun:
    """What one container rewrite did; ``reclaimed_bytes`` is the measured
    backend footprint shrink (``storage_bytes`` before minus after).

    ``skipped=True`` means the sizing pass found the rewrite would grow
    the container (rebase materialization outweighing the sweepable
    bytes) and nothing was mutated — ``reclaimed_bytes`` is 0, never
    negative (regression-pinned in tests/test_lifecycle.py)."""

    epoch: int
    live_chunks: int
    swept_chunks: int
    swept_bytes: int            # logical payload bytes of dropped records
    rebased_delta: int          # live patches re-encoded onto a live ancestor
    rebased_raw: int            # live patches materialized to raw instead
    bytes_before: int
    bytes_after: int
    reclaimed_bytes: int
    seconds: float
    skipped: bool = False


@runtime_checkable
class ReclamationPolicy(Protocol):
    name: str

    def should_compact(self, stats: StoreStats) -> bool:
        """Consulted by the store after every delete; ``stats.dead_bytes``
        already includes pinned-only bytes (what compaction can free)."""
        ...


@register_policy("eager")
class EagerPolicy:
    """Compact after every delete that left anything reclaimable."""

    name = "eager"

    def should_compact(self, stats: StoreStats) -> bool:
        return stats.dead_bytes > 0


@register_policy("threshold")
class ThresholdPolicy:
    """Compact once reclaimable bytes exceed `ratio` of the container."""

    name = "threshold"

    def __init__(self, ratio: float = 0.25) -> None:
        if not 0.0 < ratio <= 1.0:
            raise ValueError(f"ratio must be in (0, 1], got {ratio}")
        self.ratio = ratio

    def should_compact(self, stats: StoreStats) -> bool:
        total = stats.live_bytes + stats.dead_bytes
        return total > 0 and stats.dead_bytes / total >= self.ratio


@register_policy("never")
class NeverPolicy:
    """Reclaim only on explicit ``compact()`` calls (the default)."""

    name = "never"

    def should_compact(self, stats: StoreStats) -> bool:
        return False


def _observe_gc(store: Any, phase: str, seconds: float,
                counters: dict[str, int] | None = None,
                **labels) -> None:
    """Record one reclamation phase into the store's registry / tracer.
    Tolerates stores without an Observability, as the reference does for
    its test doubles; the port's store has none until observability is
    ported, so nothing is recorded yet."""
    obs = getattr(store, "observe", None)
    if obs is None:
        return
    raise NotImplementedError(
        f"gc.{phase}: observability is not ported yet "
        "(ROADMAP Queue 1 item 4)")


def rebind_store_views(store: Any) -> None:
    """Rederive the store's in-memory views from durable backend state
    after the record set changed shape underneath them (compaction here,
    scrub repair in ``api/integrity.py``): rebuild the refcount table,
    drop digests of records no longer held (future ingests must not dedup
    against vanished payloads), and refresh the lifecycle stats. Ranged-
    restore prefix sums (``store._layouts``) survive — chunk lengths are
    invariant under rebasing, and repair pops the layouts of the streams
    it retires itself."""
    backend = store.backend
    store._refs = RefcountTable.rebuild(backend)
    store._by_digest = {d: c for d, c in store._by_digest.items()
                        if backend.contains(c)}
    store._refresh_lifecycle_stats()
    store._compact_skipped_at = None    # state changed; sizing is fresh


def delete_stream(store: Any, handle: int) -> int:
    """Retire stream `handle` and release its chunk references. Returns
    the logical bytes the delete made reclaimable (dead + newly pinned).
    The payloads stay on disk until a compaction; until then a new ingest
    may dedup against them, which revives them (refcount goes back up).
    Raises KeyError for an already-retired handle (IndexError for one the
    store never issued)."""
    t0 = time.perf_counter()
    refs: RefcountTable = store._refs
    recipe = store.backend.recipe(handle)
    store.backend.retire_recipe(handle)     # durable backends fsync the
    store.backend.flush()                   # tombstone themselves
    getattr(store, "_layouts", {}).pop(handle, None)   # ranged-read sums
    before = refs.dead_bytes + refs.pinned_bytes
    for cid in recipe:
        refs.decref_recipe(cid)
    freed = (refs.dead_bytes + refs.pinned_bytes) - before
    store._refresh_lifecycle_stats()
    if store.policy is not None and store.policy.should_compact(store.stats):
        # a previous compact() skipped at this reclaimable level: the
        # sizing pass (get + delta.encode over every rebase candidate)
        # would reach the same verdict, so don't re-pay it until more
        # bytes have actually become reclaimable
        skip_at = getattr(store, "_compact_skipped_at", None)
        if skip_at is None or refs.dead_bytes + refs.pinned_bytes > skip_at:
            compact(store)
    _observe_gc(store, "delete", time.perf_counter() - t0,
                counters={"freed_bytes": freed},
                handle=handle, freed_bytes=freed)
    return freed


def collect(store: Any) -> CollectReport:
    """Mark-sweep accounting: classify chunks, refresh lifecycle stats."""
    t0 = time.perf_counter()
    refs: RefcountTable = store._refs
    live = refs.live_cids()
    pinned = refs.pinned_cids()
    dead = refs.dead_cids()
    hist = refs.chain_depth_hist()
    report = CollectReport(
        live_chunks=len(live), pinned_chunks=len(pinned),
        dead_chunks=len(dead), live_bytes=refs.live_bytes,
        pinned_bytes=refs.pinned_bytes, dead_bytes=refs.dead_bytes,
        chain_depth_hist=hist)
    store._refresh_lifecycle_stats()
    store.stats.chain_depth_hist = dict(hist)
    _observe_gc(store, "collect", time.perf_counter() - t0,
                live_chunks=report.live_chunks,
                dead_chunks=report.dead_chunks,
                reclaimable_bytes=report.reclaimable_bytes)
    return report


def _placement_order(keep: set[int], rebases: dict[int, tuple],
                     base_of: Any, heat: dict[int, int]) -> list[int]:
    """Heat-aware placement for the compaction rewrite (DESIGN.md §14.4).

    Group the live set by post-rebase delta-chain root (a rebase changes
    a patch's base, so placement must follow where the chain will point
    *after* the rewrite, not where it points now), write whole chains
    contiguously, and order chains by aggregate read heat (hottest
    first, root cid breaking ties for determinism). Within a chain,
    members go base-before-dependent in cid order — the order a pointed
    restore walks them. Cold stores (no heat) keep the plain sorted
    order so the rewrite stays byte-stable across otherwise-identical
    compactions."""
    if not heat:
        return sorted(keep)
    chain_root: dict[int, int] = {}

    def root_of(cid: int) -> int:
        seen: list[int] = []
        cur = cid
        while cur in keep and cur not in chain_root:
            seen.append(cur)
            hit = rebases.get(cur)
            base = hit[1] if hit is not None else base_of(cur)
            if base < 0 or base not in keep:
                break
            cur = base
        root = chain_root.get(cur, cur if cur in keep else seen[-1])
        for c in seen:
            chain_root[c] = root
        return root

    chains: dict[int, list[int]] = {}
    for cid in sorted(keep):        # sorted -> base precedes dependents
        chains.setdefault(root_of(cid), []).append(cid)
    ranked = sorted(chains, key=lambda r: (-sum(heat.get(c, 0)
                                                for c in chains[r]), r))
    return [cid for r in ranked for cid in chains[r]]


def compact(store: Any) -> CompactionRun:
    """Rewrite the container without dead/pinned records, rebasing live
    patches whose base is evicted; see module docstring. Backends that
    track read heat (``chunk_heat``) get hot delta chains placed
    contiguously at the front of the rewritten container (§14.4), so the
    coalescer turns a hot pointed restore into few long reads."""
    t0 = time.perf_counter()
    refs: RefcountTable = store._refs
    backend = store.backend
    keep = set(refs.live_cids())
    swept = [cid for cid in refs.chunk_ids() if cid not in keep]
    swept_bytes = sum(refs.size_of(cid) for cid in swept)

    # sizing pass: decide every rebase up front so a rewrite that would
    # *grow* the container (patch materialization outweighing the
    # sweepable bytes — BENCH_GC once measured reclaimed_mb < 0) can be
    # skipped before anything is mutated. Only re-encoded patches are
    # held (re-encoding is the expensive part); raw materializations are
    # re-read from the backend when streamed, so the extra working set is
    # the patch bytes, not the decoded container.
    rebased = {"delta": 0, "raw": 0}
    rebases: dict[int, tuple[int, int, bytes | None]] = {}
    growth = 0
    for cid in sorted(keep):
        base = backend.base_of(cid)
        if base < 0 or base in keep:
            continue
        # nearest surviving ancestor: materialized content is invariant
        # under compaction, so old patch semantics carry
        anc = refs.base_of(base)
        while anc >= 0 and anc not in keep:
            anc = refs.base_of(anc)
        raw = backend.get(cid)
        patch = delta.encode(raw, backend.get(anc)) if anc >= 0 else None
        if patch is not None and len(patch) < len(raw):
            rebases[cid] = (containers._KIND_DELTA, anc, patch)
            rebased["delta"] += 1
            growth += len(patch) - backend.payload_size(cid)
        else:
            rebases[cid] = (containers._KIND_RAW, -1, None)  # fetch later
            rebased["raw"] += 1
            growth += len(raw) - backend.payload_size(cid)

    sizing_seconds = time.perf_counter() - t0

    if growth > 0 and growth >= swept_bytes:
        # rewriting would enlarge the container: leave it append-only
        # until enough dead bytes accumulate to pay for the rebases
        # (delete_stream consults the marker before re-running sizing)
        store._compact_skipped_at = refs.dead_bytes + refs.pinned_bytes
        size = backend.storage_bytes()
        seconds = time.perf_counter() - t0
        _observe_gc(store, "compact", seconds, skipped=True, growth=growth)
        _observe_gc(store, "compact.sizing", sizing_seconds)
        return CompactionRun(
            epoch=backend.epoch, live_chunks=len(keep), swept_chunks=0,
            swept_bytes=0, rebased_delta=0, rebased_raw=0,
            bytes_before=size, bytes_after=size, reclaimed_bytes=0,
            seconds=seconds, skipped=True)

    heat_fn = getattr(backend, "chunk_heat", None)
    order = _placement_order(keep, rebases, backend.base_of,
                             heat_fn() if heat_fn is not None else {})

    def live_records():
        # streamed, not a list: the backend consumes one record at a time,
        # so compaction RAM is one payload (plus the re-encoded patches),
        # not the whole live container
        for cid in order:
            hit = rebases.get(cid)
            if hit is None:
                kind, base, payload = backend.record(cid)
            else:
                kind, base, payload = hit
                if payload is None:     # raw materialization, re-read
                    payload = backend.get(cid)
            yield cid, kind, base, payload

    bytes_before = backend.storage_bytes()
    backend.rewrite_live(live_records())
    bytes_after = backend.storage_bytes()
    rebased_delta, rebased_raw = rebased["delta"], rebased["raw"]

    # the durable state changed shape: rederive the refcount view from it
    # and forget digests of swept payloads so future ingests cannot dedup
    # against chunks that no longer exist. Ranged-restore prefix sums
    # (store._layouts) deliberately survive: rebasing rewrites *patches*,
    # never materialized bytes, so every live recipe's chunk lengths —
    # and the lengths persisted next to the recipes — are invariant
    # under compaction (pinned by tests/test_restore.py).
    rebind_store_views(store)
    store.stats.reclaimed_bytes += bytes_before - bytes_after

    seconds = time.perf_counter() - t0
    reclaimed = bytes_before - bytes_after
    _observe_gc(store, "compact", seconds,
                counters={"reclaimed_bytes": reclaimed,
                          "swept_chunks": len(swept)},
                reclaimed_bytes=reclaimed, swept_chunks=len(swept),
                rebased_delta=rebased_delta, rebased_raw=rebased_raw)
    _observe_gc(store, "compact.sizing", sizing_seconds)
    _observe_gc(store, "compact.rewrite", seconds - sizing_seconds)

    return CompactionRun(
        epoch=backend.epoch, live_chunks=len(keep), swept_chunks=len(swept),
        swept_bytes=swept_bytes, rebased_delta=rebased_delta,
        rebased_raw=rebased_raw, bytes_before=bytes_before,
        bytes_after=bytes_after, reclaimed_bytes=bytes_before - bytes_after,
        seconds=time.perf_counter() - t0)
