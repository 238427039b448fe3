"""Chunk refcounting for space reclamation (port of
``repro.api.refcount``; DESIGN.md §7.1).

A deleted stream cannot simply drop its chunks: delta base-chains
(DESIGN.md §2.3) mean a chunk with no recipe reference may still be the
base some live patch decodes against. The table therefore tracks *two*
reference kinds per chunk and classifies every chunk into one of three
categories:

    recipe refs   occurrences of the chunk in live (non-retired) stream
                  recipes — one ref per recipe slot, so a chunk repeated
                  inside a stream is decref'd symmetrically on delete;
    base deps     number of *retained* chunks whose stored patch decodes
                  against this chunk.

    live     recipe refs > 0            (some live stream needs it)
    pinned   recipe refs == 0, deps > 0 (held only as a delta base)
    dead     both zero                  (reclaimable garbage)

"Retained" = live or pinned. Retained-ness cascades along the base
chain: when the last dependent of a chunk goes away the chunk may become
dead, which releases *its* base in turn (and symmetrically on revival —
a new stream deduping against a dead-but-unswept chunk brings its whole
chain back). `live_bytes` / `pinned_bytes` / `dead_bytes` are maintained
incrementally, so the policy check after every delete is O(chain), not
O(chunks).

The table is an in-memory view; the durable truth is the container
backend (records + recipes), from which `RefcountTable.rebuild` derives
an identical table on store reopen and after compaction.
"""
from __future__ import annotations

from typing import Any


class RefcountTable:
    """Per-chunk recipe/base refcounts with incremental byte accounting."""

    def __init__(self) -> None:
        self._recipe: dict[int, int] = {}    # cid -> live recipe slots
        self._deps: dict[int, int] = {}      # cid -> retained dependents
        self._base_of: dict[int, int] = {}   # cid -> base cid (-1 = raw)
        self._size: dict[int, int] = {}      # cid -> stored payload bytes
        self.live_bytes = 0
        self.pinned_bytes = 0
        self.dead_bytes = 0

    # --- registration --------------------------------------------------------

    def track(self, cid: int, base: int, size: int) -> None:
        """Register a stored chunk (starts dead until a recipe refs it)."""
        if cid in self._size:
            raise ValueError(f"chunk {cid} already tracked")
        self._recipe[cid] = 0
        self._deps[cid] = 0
        self._base_of[cid] = int(base)
        self._size[cid] = int(size)
        self.dead_bytes += size

    @classmethod
    def rebuild(cls, backend: Any) -> "RefcountTable":
        """Derive the table from a backend's records + live recipes (store
        reopen, and the post-compaction reset)."""
        table = cls()
        for cid in backend.chunk_ids():
            table.track(cid, backend.base_of(cid), backend.payload_size(cid))
        for handle in backend.live_handles():
            for cid in backend.recipe(handle):
                table.incref_recipe(cid)
        return table

    # --- refcount transitions ------------------------------------------------

    def incref_recipe(self, cid: int) -> None:
        self._shift(cid, +1)

    def decref_recipe(self, cid: int) -> None:
        self._shift(cid, -1)

    def _shift(self, cid: int, d_recipe: int) -> None:
        """Apply a recipe-ref delta, cascading retained-ness flips down the
        base chain (iterative — chains can be arbitrarily deep)."""
        d_deps = 0
        while True:
            r0, d0 = self._recipe[cid], self._deps[cid]
            r1, d1 = r0 + d_recipe, d0 + d_deps
            if r1 < 0 or d1 < 0:
                raise ValueError(f"refcount underflow on chunk {cid}")
            self._recipe[cid], self._deps[cid] = r1, d1
            size = self._size[cid]
            self._account(r0, d0, -size)
            self._account(r1, d1, +size)
            base = self._base_of[cid]
            flipped = (r0 + d0 > 0) != (r1 + d1 > 0)
            if not flipped or base < 0:
                return
            cid, d_recipe, d_deps = base, 0, (1 if r1 + d1 > 0 else -1)

    def _account(self, recipe: int, deps: int, delta: int) -> None:
        if recipe > 0:
            self.live_bytes += delta
        elif deps > 0:
            self.pinned_bytes += delta
        else:
            self.dead_bytes += delta

    # --- queries -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._size)

    def __contains__(self, cid: int) -> bool:
        return cid in self._size

    def base_of(self, cid: int) -> int:
        return self._base_of[cid]

    def size_of(self, cid: int) -> int:
        return self._size[cid]

    def recipe_refs(self, cid: int) -> int:
        return self._recipe.get(cid, 0)

    def base_deps(self, cid: int) -> int:
        return self._deps.get(cid, 0)

    def is_live(self, cid: int) -> bool:
        return self._recipe.get(cid, 0) > 0

    def is_pinned(self, cid: int) -> bool:
        return self._recipe.get(cid, 0) == 0 and self._deps.get(cid, 0) > 0

    def is_retained(self, cid: int) -> bool:
        return self._recipe.get(cid, 0) + self._deps.get(cid, 0) > 0

    def chunk_ids(self) -> list[int]:
        return list(self._size)

    def live_cids(self) -> list[int]:
        return [c for c in self._size if self.is_live(c)]

    def pinned_cids(self) -> list[int]:
        return [c for c in self._size if self.is_pinned(c)]

    def dead_cids(self) -> list[int]:
        return [c for c in self._size if not self.is_retained(c)]

    def chain_depth_hist(self) -> dict[int, int]:
        """Histogram {depth: count} over *live* chunks; raw chunks are depth
        0, each patch hop adds 1. The compaction rebase exists to keep this
        from growing unboundedly as old generations are deleted."""
        memo: dict[int, int] = {}
        hist: dict[int, int] = {}
        for cid in self._size:
            if not self.is_live(cid):
                continue
            path: list[int] = []
            cur = cid
            while cur >= 0 and cur not in memo:
                path.append(cur)
                cur = self._base_of[cur]
            depth = -1 if cur < 0 else memo[cur]
            for c in reversed(path):
                depth += 1
                memo[c] = depth
            hist[memo[cid]] = hist.get(memo[cid], 0) + 1
        return hist
