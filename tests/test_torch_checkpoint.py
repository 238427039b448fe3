"""The port's checkpoint stores (``repro_torch.checkpoint``) against the JAX
package's ``repro.checkpoint``: the same tree (made from seeded numpy
arrays, bf16 carried as its uint16 bit pattern) gives the same blobs, ids,
manifest (but ``treedef``) and files on disk; restores are value-exact;
and ``DedupCheckpointStore`` gives the reference's stream, handles, DCR
and counts at ``tests/test_checkpoint.py``'s drift."""
import collections
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import DedupCheckpointStore as RefDedupCheckpointStore
from repro.checkpoint import dedup_store as ref_dedup_store
from repro.checkpoint import store as ref_store
from repro_torch.checkpoint import DedupCheckpointStore, latest_step, list_steps, restore, save
from repro_torch.checkpoint import dedup_store, store

torch.set_num_threads(1)

BF16 = "bf16"


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 (round to nearest even) as uint16 bits."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).view(
        torch.int16).numpy().view(np.uint16)


def _np_tree(seed=0, scale=1.0):
    """test_checkpoint._tree's shapes and dtypes, drawn with numpy: a dict
    of (kind, array) leaves, bf16 as bits."""
    rng = np.random.default_rng(seed)
    return {"w": ("f32", (rng.standard_normal((64, 128)) * scale).astype(np.float32)),
            "b": (BF16, _bf16_bits(np.arange(128))),
            "nested": {"step": ("i32", np.asarray(7, np.int32)),
                       "m": (BF16, _bf16_bits(np.ones((3, 5, 7)) * scale))}}


def _ckpt_np_tree(seed=0):
    """test_checkpoint._ckpt_tree's shapes and dtypes."""
    rng = np.random.default_rng(seed)
    return {"params": {"w": (BF16, _bf16_bits(rng.standard_normal((512, 1024)))),
                       "e": (BF16, _bf16_bits(rng.standard_normal((1024, 256))))},
            "mu": ("f32", (rng.standard_normal((256, 512)) * 0.01).astype(np.float32)),
            "step": ("i32", np.asarray(7, np.int32))}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(*tree)


def to_torch(tree, device="cpu"):
    def leaf(kind, a):
        t = torch.from_numpy(np.array(a))
        return (t.view(torch.int16).view(torch.bfloat16) if kind == BF16 else t).to(device)
    return _map(tree, leaf)


def to_jax(tree):
    return _map(tree, lambda kind, a: jnp.asarray(a.view(ml_dtypes.bfloat16) if kind == BF16
                                                  else a))


def drift(tree, rng, sigma):
    """x + N(0, sigma) in x's dtype for the float leaves (bf16 through
    float32, rounded once), the same arrays for both packages."""
    def leaf(kind, a):
        if kind == "i32":
            return kind, a
        noise = (rng.standard_normal(a.shape) * sigma).astype(np.float32)
        if kind == BF16:
            x = (a.astype(np.uint32) << 16).view(np.float32)
            return kind, _bf16_bits(x + noise)
        return kind, a + noise
    return _map(tree, leaf)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _leaves_equal(got, want_np):
    """Every leaf of the port's restored tree equals the numpy tree's,
    bit for bit (bf16 by bit pattern) and in the same dtype."""
    flat = [leaf for _, leaf in store.flatten_with_path(got)]
    want = [leaf for _, leaf in store.flatten_with_path(to_torch(want_np))]
    assert len(flat) == len(want)
    for g, w in zip(flat, want):
        assert g.dtype == w.dtype and torch.equal(_bits(g), _bits(w))


# --- serialize / save / restore ----------------------------------------------------

def test_blobs_and_manifest_equal_reference():
    tree = _np_tree()
    blobs, manifest = store.serialize(to_torch(tree))
    ref_blobs, ref_manifest = ref_store.serialize(to_jax(tree))
    assert blobs == ref_blobs
    assert manifest["leaves"] == ref_manifest["leaves"]
    assert [m["path"] for m in manifest["leaves"]] == [
        "['b']", "['nested']['m']", "['nested']['step']", "['w']"]
    assert manifest["treedef"].startswith("repro_torch ")


def test_files_on_disk_equal_reference(tmp_path):
    tree = _np_tree(seed=3)
    mine = save(tmp_path / "port", to_torch(tree), step=4)
    ref = ref_store.save(tmp_path / "ref", to_jax(tree), step=4)
    assert mine.name == ref.name == "step_00000004"
    assert sorted(p.name for p in mine.iterdir()) == sorted(p.name for p in ref.iterdir())
    for p in mine.glob("leaf_*.bin"):
        assert p.read_bytes() == (ref / p.name).read_bytes()
    got, want = (json.loads((d / "manifest.json").read_text()) for d in (mine, ref))
    got.pop("treedef")
    want.pop("treedef")
    assert got == want
    # each package reads the other's checkpoint
    _leaves_equal(restore(tmp_path / "ref", to_torch(tree)), tree)
    back = ref_store.restore(tmp_path / "port", to_jax(tree))
    assert np.array_equal(np.asarray(back["w"]), tree["w"][1])
    assert np.array_equal(np.asarray(back["b"]).view(np.uint16), tree["b"][1])


def test_roundtrip_dtypes_and_containers(tmp_path):
    """bf16, int32, scalar, float16, bool and int64 leaves in dicts, lists,
    tuples and an OrderedDict (a state_dict's order) round-trip exactly,
    each leaf taking ``like``'s dtype."""
    rng = np.random.default_rng(1)
    tree = {
        "sd": collections.OrderedDict([("z", torch.randn(4, 3)), ("a", torch.arange(3))]),
        "seq": [torch.tensor(2.5, dtype=torch.float16), (torch.tensor([True, False]),)],
        "bf": torch.from_numpy(rng.standard_normal((7, 9)).astype(np.float32)).to(torch.bfloat16),
        "step": torch.tensor(11, dtype=torch.int32),
        "skip": None,
    }
    save(tmp_path, tree, step=1)
    got = restore(tmp_path, tree)
    assert list(got["sd"]) == ["z", "a"] and isinstance(got["seq"][1], tuple)
    assert got["skip"] is None
    for (pg, g), (pw, w) in zip(store.flatten_with_path(got), store.flatten_with_path(tree)):
        assert pg == pw and g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))
    paths = [m["path"] for m in json.loads(
        (tmp_path / "step_00000001" / "manifest.json").read_text())["leaves"]]
    assert paths == ["['bf']", "['sd']['z']", "['sd']['a']", "['seq'][0]", "['seq'][1][0]",
                     "['step']"]
    as_f32 = restore(tmp_path, {**tree, "bf": torch.zeros(7, 9)})
    assert as_f32["bf"].dtype == torch.float32
    assert torch.equal(as_f32["bf"], tree["bf"].float())


def test_multiple_steps_and_latest(tmp_path):
    for s in (1, 5, 10):
        save(tmp_path, to_torch(_np_tree(seed=s)), step=s)
    assert list_steps(tmp_path) == [1, 5, 10] and latest_step(tmp_path) == 10
    _leaves_equal(restore(tmp_path, to_torch(_np_tree()), step=5), _np_tree(seed=5))
    _leaves_equal(restore(tmp_path, to_torch(_np_tree())), _np_tree(seed=10))
    with pytest.raises(FileNotFoundError):
        restore(tmp_path / "none", to_torch(_np_tree()))


def test_corrupt_blob_raises(tmp_path):
    tree = to_torch(_np_tree())
    d = save(tmp_path, tree, step=1)
    victim = sorted(d.glob("leaf_*.bin"))[0]
    raw = bytearray(victim.read_bytes())
    raw[0] ^= 0xFF
    victim.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="digest"):
        restore(tmp_path, tree, step=1)


def test_tmp_dir_never_listed(tmp_path):
    """A .tmp directory (a crash mid-write) is not a checkpoint, even with
    a manifest in it."""
    tree = to_torch(_np_tree())
    save(tmp_path, tree, step=2)
    (tmp_path / "step_00000009.tmp").mkdir()
    (tmp_path / "step_00000009.tmp" / "manifest.json").write_text("{}")
    assert latest_step(tmp_path) == 2 == ref_store.latest_step(tmp_path)
    assert list_steps(tmp_path) == ref_store.list_steps(tmp_path) == [2]


def test_leaf_count_mismatch_raises(tmp_path):
    save(tmp_path, to_torch(_np_tree()), step=1)
    with pytest.raises(ValueError, match="4 leaves, target tree has 1"):
        restore(tmp_path, {"w": torch.zeros(1)})


# --- the deduplicated store ----------------------------------------------------------

@pytest.mark.parametrize("itemsize", [1, 2, 4])
def test_byte_planes_equal_reference(itemsize):
    raw = np.random.default_rng(itemsize).integers(0, 256, 4096, np.uint8).tobytes()
    planes = dedup_store._byte_planes(raw, itemsize)
    assert planes == ref_dedup_store._byte_planes(raw, itemsize)
    assert dedup_store._unbyte_planes(planes, itemsize) == raw


def _run_drift(make, convert, sigma, steps=4, **kw):
    store_ = make(**kw)
    rng = np.random.default_rng(0)
    tree = _ckpt_np_tree(1)
    history = []
    for i in range(steps):
        tree = drift(tree, rng, sigma)
        store_.save(convert(tree), step=i)
        history.append(tree)
    return store_, history


def _stats_key(st):
    return (st.bytes_in, st.bytes_stored, st.chunks, st.dup_chunks, st.delta_chunks,
            st.raw_chunks)


@pytest.mark.parametrize("byte_plane", [True, False])
def test_dedup_store_matches_reference(byte_plane):
    """test_checkpoint's drift (sigma 1e-3, 4 steps) through both packages'
    default stores: the same streams and manifests (but treedef), the same
    handles, counts and DCR; every step restores value-exact."""
    mine, history = _run_drift(lambda **kw: DedupCheckpointStore(device="cpu", **kw),
                               to_torch, 1e-3, byte_plane=byte_plane)
    ref, _ = _run_drift(RefDedupCheckpointStore, to_jax, 1e-3, byte_plane=byte_plane)
    assert mine.steps == ref.steps == [0, 1, 2, 3]
    for step in mine.steps:
        (h, man), (rh, rman) = mine._steps[step], ref._steps[step]
        man, rman = dict(man), dict(rman)
        man.pop("treedef")
        rman.pop("treedef")
        assert h == rh and man == rman
        assert mine._store.restore(h) == ref._store.restore(rh)
    assert [r.handle for r in mine._store.reports] == [r.handle for r in ref._store.reports]
    assert [_stats_key(r) for r in mine._store.reports] == [
        _stats_key(r) for r in ref._store.reports]
    assert mine.stats.dcr == ref.stats.dcr
    assert mine.stats.delta_chunks > 0
    for step, tree in enumerate(history):
        _leaves_equal(mine.restore(to_torch(_ckpt_np_tree(0)), step=step), tree)
    back = ref.restore(to_jax(_ckpt_np_tree(0)), step=2)
    assert np.array_equal(np.asarray(back["params"]["w"]).view(np.uint16),
                          history[2]["params"]["w"][1])


# --- NamedTuple trees (a train state's shape) ---------------------------------------

NT = collections.namedtuple("NT", "x y")
Inner = collections.namedtuple("Inner", "mu nu count")


def _nt_trees(kind):
    """(port tree, reference tree) of the same float32 / int32 leaves."""
    rng = np.random.default_rng(5)
    if kind == "flat":
        leaves = [np.ones(1, np.float32), np.zeros(2, np.float32)]
        build = lambda a: NT(*a)
    else:
        leaves = [rng.standard_normal((3, 4)).astype(np.float32),
                  rng.standard_normal(5).astype(np.float32),
                  np.asarray(9, np.int32), rng.standard_normal(2).astype(np.float32)]
        build = lambda a: {"opt": Inner(a[0], {"b": a[1]}, a[2]), "params": NT(a[3], None)}
    return (build([torch.from_numpy(a.copy()) for a in leaves]),
            build([jnp.asarray(a) for a in leaves]))


@pytest.mark.parametrize("kind", ["flat", "nested"])
def test_namedtuple_trees_save_and_restore_as_the_reference(tmp_path, kind):
    """A NamedTuple's fields get JAX's ``.field`` paths; both packages write
    the same blobs and manifest (but treedef), each restores the other's
    checkpoint, and the port rebuilds the NamedTuple type."""
    mine, ref = _nt_trees(kind)
    blobs, manifest = store.serialize(mine)
    ref_blobs, ref_manifest = ref_store.serialize(ref)
    assert blobs == ref_blobs and manifest["leaves"] == ref_manifest["leaves"]
    paths = [m["path"] for m in manifest["leaves"]]
    assert paths == ([".x", ".y"] if kind == "flat" else
                     ["['opt'].mu", "['opt'].nu['b']", "['opt'].count", "['params'].x"])
    assert "NT(" in manifest["treedef"]
    save(tmp_path / "port", mine, step=1)
    ref_store.save(tmp_path / "ref", ref, step=1)
    for src in ("port", "ref"):
        got = restore(tmp_path / src, mine, step=1)
        want = mine if kind == "flat" else mine["opt"]
        have = got if kind == "flat" else got["opt"]
        assert type(have) is type(want) and have._fields == want._fields
        for (p, g), (_, w) in zip(store.flatten_with_path(got), store.flatten_with_path(mine)):
            assert torch.equal(g, w), p
        back = ref_store.restore(tmp_path / src, ref, step=1)
        for g, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(ref)):
            assert np.array_equal(np.asarray(g), np.asarray(w))


def test_namedtuple_tree_through_the_dedup_store():
    """``DedupCheckpointStore.restore`` of a NamedTuple-in-dict tree, as
    the reference's: the same handles and manifests, the type rebuilt."""
    mine_tree, ref_tree = _nt_trees("nested")
    mine, ref = DedupCheckpointStore(device="cpu"), RefDedupCheckpointStore()
    for step in range(2):
        mine.save(mine_tree, step)
        ref.save(ref_tree, step)
    for step in range(2):
        (h, man), (rh, rman) = mine._steps[step], ref._steps[step]
        assert h == rh and man["leaves"] == rman["leaves"]
    got = mine.restore(mine_tree, step=1)
    assert isinstance(got["opt"], Inner) and isinstance(got["params"], NT)
    assert got["params"].y is None
    for (_, g), (_, w) in zip(store.flatten_with_path(got), store.flatten_with_path(mine_tree)):
        assert torch.equal(g, w)
