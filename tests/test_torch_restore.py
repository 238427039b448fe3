"""The port's restore read engine (``repro_torch.api.restore``) against the
JAX package's ``repro.api.restore``: the ``"lru"`` and ``"arc"`` cache
policies give the same hits, misses, evictions and ghost hits on the same
seeded trace, ``plan_chains`` and ``coalesce_reads`` give the same plans
and runs on seeded chain topologies, and ``RecipeLayout`` maps the same
ranges onto the same windows."""
import numpy as np
import pytest
import torch

from repro.api import restore as ref_restore
from repro_torch.api import registry
from repro_torch.api import restore

torch.set_num_threads(1)


def _trace(seed: int, n: int = 3000, ids: int = 200):
    """A seeded mix of gets, puts (sizes 1-4 KiB), pins and unpins, with
    a hot set and a one-pass scan in the middle."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        if 1000 <= i < 1400:                      # scan: every id once
            cid = int(ids + i - 1000)
        elif rng.random() < 0.6:
            cid = int(rng.integers(0, 20))        # hot set
        else:
            cid = int(rng.integers(0, ids))
        r = rng.random()
        if r < 0.45:
            ops.append(("get", cid))
        elif r < 0.85:
            ops.append(("put", cid, int(rng.integers(1, 5)) * 1024))
        elif r < 0.9:
            ops.append(("get_present", [cid, cid + 1, cid + 7]))
        elif r < 0.95:
            ops.append(("try_pin", cid))
        else:
            ops.append(("peek", cid))
    return ops


def _run(cache, ops) -> list:
    seen, pinned = [], []
    for op in ops:
        if op[0] == "get":
            seen.append(cache.get(op[1]) is not None)
        elif op[0] == "put":
            cache.put(op[1], bytes([op[1] % 251]) * op[2])
        elif op[0] == "get_present":
            seen.append(sorted(cache.get_present(op[1])))
        elif op[0] == "try_pin":
            if cache.try_pin(op[1]) is not None:
                pinned.append(op[1])
            if len(pinned) > 3:                   # keep at most 3 pins
                cache.unpin(pinned.pop(0))
        else:
            seen.append(cache.peek(op[1]) is not None)
    seen.append((cache.hits, cache.misses, cache.bytes, cache.peak_bytes,
                 cache.ghost_hits, cache.evictions, len(cache)))
    return seen


@pytest.mark.parametrize("policy", ["lru", "arc"])
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_cache_policies_match_reference(policy, shards, seed):
    ops = _trace(seed)
    budget = 48 * 1024
    mine = restore.ShardedDecodeCache(budget, shards=shards, policy=policy)
    ref = ref_restore.ShardedDecodeCache(budget, shards=shards, policy=policy)
    got, want = _run(mine, ops), _run(ref, ops)
    assert got == want
    assert got[-1][5] > 0, "the trace must evict"
    if policy == "arc":
        assert got[-1][4] > 0, "the trace must reach the ghost lists"


def test_cache_policies_are_the_port_s_registrations():
    assert registry.get_cache_policy("lru") is restore.LruCachePolicy
    assert registry.get_cache_policy("arc") is restore.ArcCachePolicy
    assert restore.DecodeCache(10).policy_name == restore.DEFAULT_CACHE_POLICY == "lru"


@pytest.mark.parametrize("cls", ["DecodeCache", "ShardedDecodeCache"])
def test_cache_errors_match_reference(cls):
    for args in ((0,), (-5,)):
        with pytest.raises(ValueError) as ref_err:
            getattr(ref_restore, cls)(*args)
        with pytest.raises(ValueError, match=str(ref_err.value)):
            getattr(restore, cls)(*args)
    c = restore.DecodeCache(100)
    with pytest.raises(KeyError, match="cannot pin uncached chunk 3"):
        c.pin(3)
    c.put(3, b"x")
    with pytest.raises(ValueError, match="unpin underflow on chunk 3"):
        c.unpin(3)


def _topology(seed: int, n: int = 300):
    """Seeded chains: each cid is raw or a delta on an earlier cid; offsets
    in a shuffled log with gaps."""
    rng = np.random.default_rng(seed)
    base = [-1 if (i == 0 or rng.random() < 0.2) else int(rng.integers(max(0, i - 12), i))
            for i in range(n)]
    lengths = rng.integers(10, 5000, n)
    order = rng.permutation(n)
    offsets = np.zeros(n, np.int64)
    pos = 12
    for cid in order:
        offsets[cid] = pos
        pos += int(lengths[cid]) + int(rng.choice([29, 29, 29, 3000, 9000]))
    cached = set(int(c) for c in rng.choice(n, 25, replace=False))
    targets = [int(t) for t in rng.integers(0, n, 120)]
    return base, offsets, lengths, cached, targets


@pytest.mark.parametrize("seed", range(6))
def test_plan_chains_and_coalesce_reads_match_reference(seed):
    base, offsets, lengths, cached, targets = _topology(seed)

    def entry(cid):
        return (base[cid], int(offsets[cid]), int(lengths[cid]))

    mine = restore.plan_chains(targets, entry, cached.__contains__)
    ref = ref_restore.plan_chains(targets, entry, cached.__contains__)
    assert (mine.targets, mine.decode_order, mine.reads, mine.dependents,
            mine.cached_bases) == (ref.targets, ref.decode_order, ref.reads,
                                   ref.dependents, ref.cached_bases)
    assert len(mine) == len(ref) > 0
    for gap, max_run in ((0, 1 << 20), (4096, 1 << 20), (1 << 20, 32 << 20), (4096, 8000)):
        assert (restore.coalesce_reads(mine.reads, gap, max_run)
                == ref_restore.coalesce_reads(ref.reads, gap, max_run))


@pytest.mark.parametrize("seed", range(3))
def test_recipe_layout_matches_reference(seed):
    rng = np.random.default_rng(seed)
    lengths = [int(x) for x in rng.integers(0, 9000, 50)]
    mine, ref = restore.RecipeLayout(lengths), ref_restore.RecipeLayout(lengths)
    assert mine.total_bytes == ref.total_bytes == sum(lengths)
    for _ in range(200):
        off = int(rng.integers(0, mine.total_bytes + 100))
        ln = int(rng.integers(0, 30000))
        assert mine.chunk_window(off, ln) == ref.chunk_window(off, ln)
    assert restore.RecipeLayout([]).chunk_window(0, 10) == (0, -1, 0)
    with pytest.raises(ValueError, match="negative range"):
        mine.chunk_window(-1, 4)
