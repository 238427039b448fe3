"""Atomic pytree checkpointing of torch state (port of
``repro.checkpoint.store``).

Layout:  <dir>/step_<N>/
            manifest.json   (per-leaf shape/dtype/digest, in flatten order)
            <leaf_id>.bin   (raw little-endian bytes; bf16 stored as u16)

A tree is nested dicts, lists, tuples and NamedTuples (``None`` holds no
leaf) of tensors, numpy arrays or Python scalars; a flat ``state_dict``
is one dict. Leaves are flattened in JAX's order: a dict's keys sorted
(an ``OrderedDict`` in its own order), sequences and a NamedTuple's
fields in order; each leaf's ``path`` is in ``jax.tree_util.keystr``
form (``['params']['w']``, a NamedTuple field ``.mu``). So
the blobs, their ids and the manifest are the reference's for the same
tree, except ``treedef``: the reference writes JAX's ``PyTreeDef``
string there, the port its own description of the structure. Neither
reads it back; ``restore`` takes the structure from ``like``.

Commit protocol: write to ``step_<N>.tmp/``, fsync files, atomic rename
to ``step_<N>/``: a crashed writer never leaves a readable-but-corrupt
checkpoint, and a restart takes ``latest_step()``.

``restore`` puts each leaf on the device and in the dtype of ``like``'s
leaf at the same place, and gives each dict ``like``'s key order.

Sharded trees (the elastic restore of the reference's ``deserialize``):
a ``DTensor`` leaf is saved as its full tensor, so the files are those
of an unsharded save of the same values. Such a save is collective:
every rank of the default process group calls it, every rank takes part
in each gather, and rank 0 alone writes. ``restore`` lays a leaf out as
``like``'s DTensor leaf is, on its mesh and placements, whatever mesh
saved it.
"""
from __future__ import annotations

import collections
import hashlib
import json
import os
import re
import shutil
from pathlib import Path
from typing import Any, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


def _children(node: Any) -> list[tuple[str, Any]] | None:
    """(key string, child) pairs of a container node in flatten order, or
    None for a leaf."""
    if _is_namedtuple(node):
        return [(f".{f}", v) for f, v in zip(node._fields, node)]
    if isinstance(node, collections.OrderedDict):
        return [(f"[{k!r}]", v) for k, v in node.items()]
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    if node is None:
        return []
    return None


def flatten_with_path(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """[(keystr path, leaf)] in JAX's flatten order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [item for key, child in kids for item in flatten_with_path(child, prefix + key)]


def structure(tree: Any) -> str:
    """The tree's shape with each leaf as ``*``: the port's ``treedef``."""
    if isinstance(tree, dict):
        kids = _children(tree)
        return "{" + ", ".join(f"{k[1:-1]}: {structure(v)}" for k, v in kids) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(structure(v) for v in tree) + "]"
    if _is_namedtuple(tree):
        inner = ", ".join(f"{f}={structure(v)}" for f, v in zip(tree._fields, tree))
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, tuple):
        inner = ", ".join(structure(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "None" if tree is None else "*"


def _unflatten(like: Any, leaves: Iterator[Any]) -> Any:
    kids = _children(like)
    if kids is None:
        return next(leaves)
    if isinstance(like, dict):
        # leaves come in flatten order (sorted keys); the dict keeps like's
        # order, which a consumer may depend on (a train state's global
        # norm sums its leaves in dict order)
        keys = list(like) if isinstance(like, collections.OrderedDict) else sorted(like)
        values = {key: _unflatten(like[key], leaves) for key in keys}
        out = type(like)() if isinstance(like, collections.OrderedDict) else {}
        for key in like:
            out[key] = values[key]
        return out
    if isinstance(like, (list, tuple)):
        items = [_unflatten(v, leaves) for v in like]
        if isinstance(like, list):
            return items
        return type(like)(*items) if _is_namedtuple(like) else type(like)(items)
    return None


def _leaf_to_bytes(x: Any) -> tuple[bytes, dict]:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            arr, logical = t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        else:
            arr = t.numpy()
            logical = str(arr.dtype)
    else:
        arr = np.asarray(x)
        logical = str(arr.dtype)
    meta = {"shape": list(arr.shape), "store_dtype": str(arr.dtype), "dtype": logical}
    raw = np.ascontiguousarray(arr).tobytes()
    meta["digest"] = hashlib.blake2b(raw, digest_size=16).hexdigest()
    return raw, meta


def _bytes_to_leaf(raw: bytes, meta: dict) -> torch.Tensor:
    arr = np.frombuffer(bytearray(raw), dtype=np.dtype(meta["store_dtype"]))
    arr = arr.reshape(meta["shape"])
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def serialize(tree: Any) -> tuple[list[tuple[str, bytes]], dict]:
    """-> ([(leaf_id, raw_bytes)], manifest). Shared with the dedup store."""
    blobs, leaves = [], []
    for i, (path, leaf) in enumerate(flatten_with_path(tree)):
        raw, meta = _leaf_to_bytes(leaf)
        meta["id"] = f"leaf_{i:05d}"
        meta["path"] = path
        blobs.append((meta["id"], raw))
        leaves.append(meta)
    return blobs, {"leaves": leaves, "treedef": f"repro_torch {structure(tree)}"}


def deserialize(blobs: dict[str, bytes], manifest: dict, like: Any) -> Any:
    """Rebuild in ``like``'s structure, each leaf digest-checked and put on
    the device and in the dtype of ``like``'s leaf (a tensor on the CPU
    where that leaf is not a tensor)."""
    flat = [leaf for _, leaf in flatten_with_path(like)]
    leaves = manifest["leaves"]
    if len(flat) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, target tree has {len(flat)}")
    out = []
    for meta, target in zip(leaves, flat):
        raw = blobs[meta["id"]]
        if hashlib.blake2b(raw, digest_size=16).hexdigest() != meta["digest"]:
            raise IOError(f"digest mismatch for {meta['path']}")
        t = _bytes_to_leaf(raw, meta)
        if isinstance(target, torch.Tensor):
            t = t.to(device=target.device, dtype=target.dtype)
        if isinstance(target, DTensor):
            # each rank holds the whole leaf and keeps its own shards
            t = distribute_tensor(t, target.device_mesh, target.placements, src_data_rank=None)
        out.append(t)
    return _unflatten(like, iter(out))


def _gathered(tree: Any) -> tuple[Any, bool]:
    """(the tree with each DTensor leaf as its full tensor, whether it had
    any): every rank of the leaf's mesh takes part in each gather."""
    flat = flatten_with_path(tree)
    if not any(isinstance(leaf, DTensor) for _, leaf in flat):
        return tree, False
    full = [leaf.full_tensor() if isinstance(leaf, DTensor) else leaf for _, leaf in flat]
    return _unflatten(tree, iter(full)), True


def save(ckpt_dir: str | Path, tree: Any, step: int) -> Path:
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tree, sharded = _gathered(tree)
    if sharded:
        if dist.get_rank() == 0:
            _write(ckpt_dir, final, tree, step)
        dist.barrier()
        return final
    return _write(ckpt_dir, final, tree, step)


def _write(ckpt_dir: Path, final: Path, tree: Any, step: int) -> Path:
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    blobs, manifest = serialize(tree)
    for leaf_id, raw in blobs:
        with open(tmp / f"{leaf_id}.bin", "wb") as f:
            f.write(raw)
            f.flush()
            os.fsync(f.fileno())
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    return final


def restore(ckpt_dir: str | Path, like: Any, step: Optional[int] = None) -> Any:
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    blobs = {m["id"]: (d / f"{m['id']}.bin").read_bytes() for m in manifest["leaves"]}
    return deserialize(blobs, manifest, like)


def list_steps(ckpt_dir: str | Path) -> list[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for p in ckpt_dir.iterdir():
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and (p / "manifest.json").exists():
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None
