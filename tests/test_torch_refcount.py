"""The port's ``RefcountTable`` (``repro_torch.api.refcount``) against the
JAX package's: seeded op sequences (track, incref, decref, with base
chains up to a few hops deep) through both tables give the same live /
pinned / dead ids and bytes, the same depth histogram and the same
``ValueError`` at the same op, and ``rebuild`` from a backend gives the
table the store keeps."""
import numpy as np
import pytest
import torch

from repro.api.refcount import RefcountTable as RefTable
from repro_torch.api.refcount import RefcountTable
from test_torch_lifecycle import time_limit

torch.set_num_threads(1)
_limit = time_limit(10)


def _state(t) -> tuple:
    return (sorted(t.live_cids()), sorted(t.pinned_cids()), sorted(t.dead_cids()),
            t.live_bytes, t.pinned_bytes, t.dead_bytes, t.chain_depth_hist(), len(t))


def _apply(t, op):
    """One op; a ValueError is part of the result, not a failure."""
    try:
        getattr(t, op[0])(*op[1:])
    except ValueError as e:
        return str(e)
    return None


def _ops(seed: int, n: int = 400) -> list:
    """Track chunks whose base is an earlier chunk (or raw), then mixed
    increfs and decrefs, with some deliberate underflows and re-tracks."""
    rng = np.random.default_rng(seed)
    ops, tracked = [], []
    for _ in range(n):
        r = rng.random()
        if r < 0.3 or not tracked:
            cid = len(tracked) if rng.random() > 0.05 or not tracked else int(
                rng.choice(tracked))                       # a double track
            base = int(rng.choice(tracked)) if tracked and rng.random() < 0.6 else -1
            ops.append(("track", cid, base, int(rng.integers(1, 5000))))
            if cid == len(tracked):
                tracked.append(cid)
        elif r < 0.7:
            ops.append(("incref_recipe", int(rng.choice(tracked))))
        else:
            ops.append(("decref_recipe", int(rng.choice(tracked))))
    return ops


@pytest.mark.parametrize("seed", range(8))
def test_seeded_ops_match_reference(seed):
    ref, port = RefTable(), RefcountTable()
    raised = 0
    for i, op in enumerate(_ops(seed)):
        a, b = _apply(ref, op), _apply(port, op)
        assert a == b, f"op {i} {op}"
        raised += a is not None
        assert _state(port) == _state(ref), f"after op {i} {op}"
    assert raised > 0                   # the error paths really ran
    for cid in ref.chunk_ids():
        assert (port.base_of(cid), port.size_of(cid), port.recipe_refs(cid),
                port.base_deps(cid), port.is_live(cid), port.is_pinned(cid),
                port.is_retained(cid)) == (
            ref.base_of(cid), ref.size_of(cid), ref.recipe_refs(cid), ref.base_deps(cid),
            ref.is_live(cid), ref.is_pinned(cid), ref.is_retained(cid))


@pytest.mark.parametrize("table", [RefTable, RefcountTable], ids=["ref", "port"])
def test_underflow_and_double_track_raise(table):
    t = table()
    t.track(1, -1, 100)
    with pytest.raises(ValueError, match="chunk 1 already tracked"):
        t.track(1, -1, 100)
    t.incref_recipe(1)
    t.decref_recipe(1)
    with pytest.raises(ValueError, match="refcount underflow on chunk 1"):
        t.decref_recipe(1)


def test_cascade_along_a_chain():
    """0 <- 1 <- 2: the last recipe ref of 2 going away kills the whole
    chain; a new ref on 2 revives it, pinning 0 and 1."""
    for t in (RefTable(), RefcountTable()):
        t.track(0, -1, 10)
        t.track(1, 0, 20)
        t.track(2, 1, 30)
        t.incref_recipe(2)
        assert (t.live_cids(), t.pinned_cids(), t.dead_cids()) == ([2], [0, 1], [])
        assert t.chain_depth_hist() == {2: 1}
        t.decref_recipe(2)
        assert (t.live_bytes, t.pinned_bytes, t.dead_bytes) == (0, 0, 60)
        t.incref_recipe(2)
        assert (t.live_bytes, t.pinned_bytes, t.dead_bytes) == (30, 30, 0)


@pytest.mark.parametrize("seed", range(2))
def test_rebuild_from_backend_matches_reference(seed):
    """A backend holding seeded records and recipes (some retired): both
    packages' ``rebuild`` give the same table."""
    from repro.api.containers import InMemoryBackend as RefBackend
    from repro_torch.api.containers import InMemoryBackend
    tables = []
    for backend in (RefBackend(), InMemoryBackend()):
        r = np.random.default_rng(seed)
        for cid in range(40):
            data = bytes(r.integers(0, 256, int(r.integers(1, 300)), np.uint8))
            if cid and r.random() < 0.5:
                backend.put_delta(cid, int(r.integers(0, cid)), data[:len(data) // 2 + 1],
                                  data=data)
            else:
                backend.put_raw(cid, data)
        for _ in range(6):
            backend.add_recipe([int(c) for c in r.integers(0, 40, 12)])
        backend.retire_recipe(int(r.integers(0, 6)))
        tables.append(_state((RefTable if len(tables) == 0 else RefcountTable).rebuild(backend)))
    assert tables[0] == tables[1]
