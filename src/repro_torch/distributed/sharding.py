"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP) (port of
``repro.distributed.sharding``).

Tensors are annotated with *logical* axis names; a ``ShardingRules``
table maps each name to mesh axes (or None = replicated). The table and
the spec functions are the reference's. The reference's GSPMD becomes
torch's DTensor here:

- a spec ``P`` is a tuple with one entry a tensor dim: None, a mesh axis,
  or a tuple of mesh axes in mesh order; ``placements(spec, mesh)`` gives
  each mesh dim ``Shard(i)`` where the entry of tensor dim i names it and
  ``Replicate()`` elsewhere;
- ``constrain`` is a ``redistribute`` of a DTensor inside ``use_rules``
  with a mesh (GSPMD's ``with_sharding_constraint``), and a no-op
  otherwise;
- ``shard_map`` runs a function on the local shards
  (``torch.distributed.tensor.experimental.local_map``); inside it,
  ``all_to_all``, ``psum``, ``pmean``, ``pmax``, ``ppermute`` and
  ``axis_index`` act on a named mesh axis. Its gradients are the
  transpose ``jax.grad`` takes through the reference's
  ``shard_map(check_vma=False)``: an output's cotangent is divided by the
  size of the mesh axes its spec leaves out, an input's gradient is
  summed over the axes its spec leaves out, ``psum`` transposes to
  ``psum``, ``all_to_all`` to the inverse ``all_to_all`` and ``ppermute``
  to the inverse permutation (``pmax`` takes no gradient).

DTensor accepts uneven shards where ``pjit`` needs exact division;
``distribute_params`` (a param dict), ``distribute_model`` (a model's own
params, in place) and ``distribute_cache`` (a KV cache) still lay tensors
out by ``sanitize_pspecs``, so the port's layouts are the reference's.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

Axes = Any  # None | str | tuple[str, ...]


class P(tuple):
    """A partition spec: one entry a tensor dim (None, a mesh axis name or
    a tuple of them). ``tuple(P(...))`` equals ``tuple`` of the
    reference's ``PartitionSpec`` with the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis -> mesh axes (None = replicate)."""
    # activation axes
    batch: Axes = ("pod", "data")
    seq: Axes = None            # sequence parallelism when set
    d_model: Axes = None
    heads: Axes = "model"
    kv_heads: Axes = None
    head_dim: Axes = None
    d_ff: Axes = "model"
    vocab: Axes = "model"
    expert: Axes = "model"
    capacity: Axes = None
    cache_seq: Axes = None      # KV-cache / SSM-state seq axis (long-context SP)
    frames: Axes = None         # audio/vision memory tokens
    state: Axes = None          # SSM state dim
    # parameter axes
    p_vocab: Axes = "model"
    p_d_model: Axes = None      # FSDP shards this over "data"
    p_heads: Axes = "model"
    p_kv_heads: Axes = None
    p_d_ff: Axes = "model"
    p_expert: Axes = "model"
    p_moe_ff: Axes = None
    p_ssm_inner: Axes = "model"
    # MoE execution mode: "ep" (experts sharded over model, all_to_all
    # dispatch) when num_experts % model_axis == 0, else "tp" (expert FFNs
    # tensor-parallel over model, local dispatch) — see models/layers.moe.
    moe_mode: str = "ep"

    def get(self, name: str) -> Axes:
        return getattr(self, name)


def default_rules(cfg=None, *, multi_pod: bool = False, fsdp: bool = False,
                  decode: bool = False, seq_shard: bool = False) -> ShardingRules:
    """Per-arch / per-shape defaults, the reference's (its 16-way model
    axis included):

    * TP shards Q heads / FFN / vocab over "model"; KV heads shard only when
      they divide the axis.
    * FSDP additionally shards the d_model param axis over "data" (and
      "pod" on a multi-pod mesh).
    * decode: the KV-cache sequence axis is sharded over "model" where the
      KV heads are not.
    """
    batch = ("pod", "data") if multi_pod else ("data",)
    kv_ok = bool(cfg and cfg.num_kv_heads and cfg.num_kv_heads % 16 == 0)
    ep_ok = bool(cfg is None or not cfg.num_experts
                 or (cfg.num_experts * getattr(cfg, "moe_ffn_shards", 1)) % 16 == 0)
    return ShardingRules(
        batch=batch,
        kv_heads="model" if kv_ok else None,
        p_kv_heads="model" if kv_ok else None,
        p_d_model=(("pod", "data") if multi_pod else ("data",)) if fsdp else None,
        cache_seq=("model" if not kv_ok else None) if decode else None,
        heads="model", p_heads="model",
        moe_mode="ep" if ep_ok else "tp",
        p_expert="model" if ep_ok else None,
        p_moe_ff=None if ep_ok else "model",
    )


_ACTIVE: contextvars.ContextVar[Optional[ShardingRules]] = \
    contextvars.ContextVar("sharding_rules", default=None)
_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar("sharding_mesh", default=None)
# the mesh of the shard_map whose local function is running: its
# collectives name that mesh's axes
_LOCAL_MESH: contextvars.ContextVar = contextvars.ContextVar("shard_map_mesh", default=None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules], mesh=None):
    tok = _ACTIVE.set(rules)
    tok_m = _ACTIVE_MESH.set(mesh)
    try:
        yield
    finally:
        _ACTIVE.reset(tok)
        _ACTIVE_MESH.reset(tok_m)


def current_rules() -> Optional[ShardingRules]:
    return _ACTIVE.get()


def current_mesh():
    return _ACTIVE_MESH.get()


def _flatten(axes_list: tuple[Axes, ...]) -> P:
    out = []
    for a in axes_list:
        if isinstance(a, (list, tuple)):
            a = tuple(x for x in a if x is not None) or None
            if a is not None and len(a) == 1:
                a = a[0]
        out.append(a)
    return P(*out)


def activation_spec(*logical: Optional[str], rules: ShardingRules | None = None) -> P:
    rules = rules or _ACTIVE.get()
    if rules is None:
        raise ValueError("activation_spec needs rules: pass them or call inside use_rules")
    return _flatten(tuple(None if n is None else rules.get(n) for n in logical))


def _as_tuple(ax: Axes) -> tuple:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: mesh dim j is
    ``Shard(i)`` where entry i names axis j, else ``Replicate()``. A tensor
    dim over several axes must list them in mesh order (DTensor shards a
    dim over its mesh dims in that order); an axis the mesh lacks, or one
    named twice, raises."""
    names = list(mesh.axis_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        axes = _as_tuple(entry)
        for ax in axes:
            if ax not in names:
                raise ValueError(f"spec {spec} names axis {ax!r}; the mesh has {names}")
            j = names.index(ax)
            if not isinstance(out[j], Replicate):
                raise ValueError(f"spec {spec} names axis {ax!r} twice")
            out[j] = Shard(i)
        order = [names.index(ax) for ax in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: axes {axes} are not in mesh order {names}")
    return tuple(out)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """``with_sharding_constraint`` by logical names: a DTensor is
    redistributed to the spec's placements inside ``use_rules(rules,
    mesh)`` (a dim of size 1 kept whole); anything else, or outside, comes
    back as it is."""
    rules, mesh = _ACTIVE.get(), _ACTIVE_MESH.get()
    if rules is None or mesh is None or not isinstance(x, DTensor):
        return x
    # a dim of one element stays whole (its value is the same either way):
    # DTensor refuses to view a tensor whose one-element dim is sharded,
    # even over a one-rank axis (torch 2.13)
    spec = activation_spec(*logical, rules=rules)
    want = placements(P(*(None if n == 1 else e for e, n in zip(spec, x.shape))), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh.device_mesh, want)


def as_global(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """A plain tensor that holds the same global value on every rank (a
    batch, a constant) as a DTensor constrained to ``logical``, inside
    ``use_rules`` with a mesh; anything else comes back as it is."""
    mesh = _ACTIVE_MESH.get()
    if mesh is None or _ACTIVE.get() is None or isinstance(x, DTensor):
        return x
    dm = mesh.device_mesh
    x = DTensor.from_local(x, dm, [Replicate()] * dm.ndim, run_check=False)
    return constrain(x, *logical) if logical else x


def unshard(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor with ``dim`` gathered whole on every rank (its other
    placements kept); anything else comes back as it is."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                 for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


# ---------------------------------------------------------------------------
# Parameter specs: leaf-name -> logical axes (leading stacked-layer axes, of
# the reference's stacked params, replicate).
# ---------------------------------------------------------------------------

_PARAM_AXES: dict[str, tuple[Optional[str], ...]] = {
    "embed": ("p_vocab", "p_d_model"),
    "lm_head": ("p_d_model", "p_vocab"),
    "pos_embed": (None, "p_d_model"),
    # attention
    "wq": ("p_d_model", "p_heads", None),
    "wk": ("p_d_model", "p_kv_heads", None),
    "wv": ("p_d_model", "p_kv_heads", None),
    "wo": ("p_heads", None, "p_d_model"),
    # dense mlp
    "w_gate": ("p_d_model", "p_d_ff"),
    "w_up": ("p_d_model", "p_d_ff"),
    "w_in": ("p_d_model", "p_d_ff"),
    "w_down": ("p_d_ff", "p_d_model"),
    # moe
    "router": ("p_d_model", None),
    "e_gate": ("p_expert", "p_d_model", "p_moe_ff"),
    "e_up": ("p_expert", "p_d_model", "p_moe_ff"),
    "e_in": ("p_expert", "p_d_model", "p_moe_ff"),
    "e_down": ("p_expert", "p_moe_ff", "p_d_model"),
    # ssm (mamba2)
    "in_proj": ("p_d_model", "p_ssm_inner"),
    "conv_w": (None, "p_ssm_inner"),
    "conv_b": ("p_ssm_inner",),
    "a_log": (None,),
    "dt_bias": (None,),
    "out_proj": ("p_ssm_inner", "p_d_model"),
    # norms / scalars
    "scale": (None,),
    "norm": (None,),
}


def _spec_for_leaf(name: str, ndim: int, rules: ShardingRules) -> P:
    axes = _PARAM_AXES.get(name)
    if axes is None:
        return P()  # replicate unknown leaves
    pad = ndim - len(axes)
    full = (None,) * pad + tuple(axes)
    return _flatten(tuple(None if a is None else rules.get(a) for a in full))


_CACHE_AXES: dict[str, tuple[Optional[str], ...]] = {
    "k": ("batch", "cache_seq", "kv_heads", None),
    "v": ("batch", "cache_seq", "kv_heads", None),
    "conv": ("batch", None, "p_ssm_inner"),
    "h": ("batch", "p_ssm_inner", None, None),
    "pos": (),
}


def _leaf_name(key) -> str:
    """A dict key's leaf name: its last dotted component (a port param dict
    is keyed by ``named_parameters()``: ``blocks.0.attn.wq`` -> ``wq``)."""
    return str(key).rsplit(".", 1)[-1]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


def _map_named(fn: Callable, tree: Any, *rest: Any, name: str = "") -> Any:
    """fn(name, leaf, *other leaves) over nested dicts, lists and tuples
    (a ``P`` is a leaf); ``name`` is the leaf name of the nearest dict key
    above, as the reference takes the last ``DictKey`` of a path."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, *(r[k] for r in rest), name=_leaf_name(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        items = [_map_named(fn, v, *(r[i] for r in rest), name=name)
                 for i, v in enumerate(tree)]
        if _is_namedtuple(tree):
            return type(tree)(*items)
        return type(tree)(items)
    return fn(name, tree, *rest)


def _ndim(leaf) -> int:
    return len(getattr(leaf, "shape", ()) or ())


def param_pspecs(params_tree: Any, rules: ShardingRules) -> Any:
    """A ``P`` tree mirroring ``params_tree`` (tensors, ``meta`` ones
    included, or anything with a ``.shape``)."""
    return _map_named(lambda name, leaf: _spec_for_leaf(name, _ndim(leaf), rules), params_tree)


def cache_pspecs(cache_tree: Any, rules: ShardingRules) -> Any:
    def spec(name, leaf):
        axes = _CACHE_AXES.get(name)
        if axes is None:
            return P()
        full = (None,) * (_ndim(leaf) - len(axes)) + tuple(axes)
        return _flatten(tuple(None if a is None else rules.get(a) for a in full))
    return _map_named(spec, cache_tree)


def named_shardings(tree_specs: Any, mesh) -> Any:
    """Each spec of the tree as its DTensor placements on ``mesh``."""
    return _map_named(lambda _, s: placements(s, mesh), tree_specs)


def axes_size(ax: Axes, mesh) -> int:
    """How many ranks the mesh axes of one spec entry span."""
    return math.prod(mesh.shape[a] for a in _as_tuple(ax))


def even_spec(spec: P, shape, mesh) -> P:
    """``spec`` with each entry whose axes do not divide its dim dropped
    (GSPMD pads such a dim; here it stays whole)."""
    return P(*(e if n % axes_size(e, mesh) == 0 else None for e, n in zip(spec, shape)))


def sanitize_pspecs(shapes_tree: Any, specs_tree: Any, mesh) -> Any:
    """Make specs legal as pjit INPUT shardings (exact divisibility).

    For each leaf dim whose size the assigned axes do not divide, the axes
    are shifted to the next dim if that works (e.g. 40 heads on a 16-way
    axis -> shard head_dim), else dropped (e.g. vocab 51865 -> replicate).
    ``mesh`` is anything with a ``.shape`` mapping."""

    def fix(_, shape_leaf, spec):
        if not isinstance(spec, P):
            return spec
        dims = tuple(getattr(shape_leaf, "shape", ()) or ())
        entries = list(spec) + [None] * (len(dims) - len(spec))
        out = [list(_as_tuple(e)) for e in entries]
        for i in range(len(dims)):
            keep = []
            for ax in list(out[i]):
                cur = math.prod(mesh.shape[a] for a in keep)
                if dims[i] % (cur * mesh.shape[ax]) == 0:
                    keep.append(ax)
                else:
                    # shift to the next dim only if it is currently
                    # unsharded; never pile axes onto a sharded dim
                    if i + 1 < len(dims) and not out[i + 1]:
                        if dims[i + 1] % mesh.shape[ax] == 0:
                            out[i + 1].append(ax)
            out[i] = keep
        return P(*(None if not e else (e[0] if len(e) == 1 else tuple(e)) for e in out))

    return _map_named(fix, shapes_tree, specs_tree)


def distribute_params(params: dict, mesh, rules: ShardingRules) -> dict:
    """``{name: tensor}`` -> ``{name: DTensor}`` laid out by
    ``sanitize_pspecs(param_pspecs(...))`` on ``mesh`` (the reference's
    ``device_put`` with ``NamedSharding``, ``cells.py:146-148``). Every
    rank passes the same values; each keeps its own shards."""
    specs = sanitize_pspecs(params, param_pspecs(params, rules), mesh)
    return {k: distribute_tensor(v.detach(), mesh.device_mesh, placements(specs[k], mesh),
                                 src_data_rank=None)
            for k, v in params.items()}


def distribute_model(model: torch.nn.Module, mesh, rules: ShardingRules) -> torch.nn.Module:
    """Lay ``model``'s own parameters out in place on ``mesh``, each a
    DTensor by ``sanitize_pspecs(param_pspecs(...))`` as
    ``distribute_params`` lays out a param dict (the reference's
    ``in_shardings`` of ``lower_cell``, ``cells.py:141-149``), so that
    ``prefill`` / ``decode_step`` run on the mesh. Returns ``model``."""
    laid = distribute_params(dict(model.named_parameters()), mesh, rules)
    for name, value in laid.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        setattr(mod, leaf, torch.nn.Parameter(value, requires_grad=False))
    return model


def distribute_cache(cache: Any, mesh, rules: ShardingRules) -> Any:
    """A KV / SSM cache tree of (``meta``) tensors -> DTensors of zeros with
    the same shapes and dtypes, laid out by ``sanitize_pspecs(cache_pspecs(
    ...))`` on ``mesh`` (``cells.input_specs`` / ``lower_cell``'s cache
    shardings); each rank allocates its own shards alone. Leaves that are
    not tensors come back as they are."""
    from torch.distributed.tensor import zeros

    specs = sanitize_pspecs(cache, cache_pspecs(cache, rules), mesh)

    def make(_, leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return zeros(tuple(leaf.shape), dtype=leaf.dtype, device_mesh=mesh.device_mesh,
                     placements=placements(spec, mesh))
    return _map_named(make, cache, specs)


def spec_of(x: torch.Tensor, mesh) -> P:
    """The spec a DTensor is laid out by on ``mesh`` (each mesh axis on
    the tensor dim it shards; a partial or a plain tensor reads as
    replicated)."""
    entries = [[] for _ in range(x.dim())]
    if isinstance(x, DTensor):
        for ax, p in zip(mesh.axis_names, x.placements):
            if isinstance(p, Shard):
                entries[p.dim % x.dim()].append(ax)
    return P(*(None if not e else (e[0] if len(e) == 1 else tuple(e)) for e in entries))


# ---------------------------------------------------------------------------
# shard_map and the named-axis collectives of its local functions
# ---------------------------------------------------------------------------

def _local_mesh():
    mesh = _LOCAL_MESH.get()
    if mesh is None:
        raise RuntimeError("a named-axis collective runs only inside shard_map")
    return mesh


def _axes_of(axis) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _all_reduce(x: torch.Tensor, mesh, axes: tuple[str, ...]) -> torch.Tensor:
    out = x.contiguous().clone()
    for ax in axes:
        dist.all_reduce(out, group=mesh.get_group(ax))
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, *ctx.args), None, None


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum over the named mesh axis (or axes) of the running shard_map;
    its gradient is the reference's transpose, a psum."""
    return _PSum.apply(x, _local_mesh(), _axes_of(axis))


def pmean(x: torch.Tensor, axis) -> torch.Tensor:
    axes = _axes_of(axis)
    n = math.prod(_local_mesh().shape[a] for a in axes)
    return psum(x, axes) / n


def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    """``jax.lax.pmax``: the elementwise max over the named mesh axis (or
    axes) of the running shard_map. No gradient (the softmax combine of
    the mesh decode uses it under ``no_grad``)."""
    mesh = _local_mesh()
    out = x.detach().contiguous().clone()
    for ax in _axes_of(axis):
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.get_group(ax))
    return out


def axis_index(axis: str) -> int:
    """This rank's index along ``axis`` of the running shard_map's mesh."""
    return _local_mesh().local_rank(axis)


def _all_to_all(x: torch.Tensor, mesh, axis: str, split_axis: int, concat_axis: int
                ) -> torch.Tensor:
    n = mesh.shape[axis]
    shape = list(x.shape)
    if shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(shape)} does not split {n} ways")
    shape[split_axis:split_axis + 1] = [n, shape[split_axis] // n]
    send = x.reshape(shape).movedim(split_axis, 0).contiguous()
    recv = torch.empty_like(send)
    # always a collective call, a one-rank axis included
    dist.all_to_all_single(recv, send, group=mesh.get_group(axis))
    out = recv.movedim(0, concat_axis)
    merged = list(out.shape)
    merged[concat_axis:concat_axis + 2] = [merged[concat_axis] * merged[concat_axis + 1]]
    return out.reshape(merged)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, split_axis, concat_axis)
        return _all_to_all(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_axis, concat_axis = ctx.args
        return _all_to_all(g, mesh, axis, concat_axis, split_axis), None, None, None, None


def all_to_all(x: torch.Tensor, axis: str, split_axis: int, concat_axis: int,
               tiled: bool = True) -> torch.Tensor:
    """``jax.lax.all_to_all(tiled=True)`` over a named mesh axis: dim
    ``split_axis`` splits into one block a rank, block j goes to rank j,
    and the blocks received are concatenated along ``concat_axis`` in rank
    order. Its gradient is the inverse all_to_all."""
    if not tiled:
        raise NotImplementedError("all_to_all: only tiled=True is ported")
    split_axis %= x.dim()
    concat_axis %= x.dim()
    return _AllToAll.apply(x, _local_mesh(), axis, split_axis, concat_axis)


def _ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """Each rank's ``x`` to its ``perm`` partner along ``axis`` (group
    ranks), as one ``batch_isend_irecv`` over the axis' group; a rank that
    no pair sends to gets zeros, as in JAX."""
    group = mesh.get_group(axis)
    me = mesh.local_rank(axis)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == dst == me and dist.get_backend(group) == "gloo":
            # gloo has no pair to its own rank (the send raises); NCCL takes
            # the send to self inside the batch, so on the card a one-rank
            # axis still goes through the group
            out.copy_(x)
            continue
        if src == me:
            ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst), group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):
    """The mesh and the pairs ride on ``ctx``: the backward of a CUDA
    tensor runs on the autograd engine's own thread, where the shard_map
    context (``_LOCAL_MESH``) is unset."""

    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.args = (mesh, axis, tuple((d, s) for s, d in perm))
        return _ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, *ctx.args), None, None, None


def ppermute(x: torch.Tensor, axis: str, perm) -> torch.Tensor:
    """``jax.lax.ppermute`` over a named mesh axis of the running
    shard_map: ``perm`` is a list of (source, destination) indices along
    ``axis``; a rank no pair sends to receives zeros. Its gradient is the
    inverse permutation."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    return _PPermute.apply(x, _local_mesh(), axis, perm)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _unmentioned(spec: P, mesh) -> list[str]:
    named = {a for e in spec for a in _as_tuple(e)}
    return [a for a in mesh.axis_names if a not in named]


def _grad_placements(spec: P, mesh) -> tuple:
    """An input's gradient placements: its own shards, and a partial sum
    over the axes its spec leaves out."""
    pl = placements(spec, mesh)
    missing = set(_unmentioned(spec, mesh))
    return tuple(Partial() if a in missing else p for a, p in zip(mesh.axis_names, pl))


def _flat_specs(specs: Any, values: Any) -> list:
    """One spec a leaf of ``values`` (a ``P`` covers its whole subtree)."""
    if isinstance(specs, P):
        return [specs] * len(_flat_values(values))
    if isinstance(specs, dict):
        return [s for k in values for s in _flat_specs(specs[k], values[k])]
    return [s for sp, v in zip(specs, values, strict=True) for s in _flat_specs(sp, v)]


def _spec_leaves(specs: Any) -> list[P]:
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in _spec_leaves(v)]
    return [s for v in specs for s in _spec_leaves(v)]


def _flat_values(values: Any) -> list:
    if isinstance(values, dict):
        return [x for k in values for x in _flat_values(values[k])]
    if isinstance(values, (list, tuple)):
        return [x for v in values for x in _flat_values(v)]
    return [values]


def _unflatten_like(like: Any, leaves, spec_tree: bool = False) -> Any:
    """Rebuild ``like``'s structure from ``leaves`` (with ``spec_tree``,
    ``like`` is a spec tree and each ``P`` takes one leaf)."""
    if spec_tree and isinstance(like, P):
        return next(leaves)
    if isinstance(like, dict):
        return {k: _unflatten_like(v, leaves, spec_tree) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        items = [_unflatten_like(v, leaves, spec_tree) for v in like]
        return type(like)(*items) if _is_namedtuple(like) else type(like)(items)
    return next(leaves)


def shard_map(f: Callable, *, mesh, in_specs, out_specs, check_vma: bool = True) -> Callable:
    """``jax.shard_map`` over DTensors: each tensor argument is
    redistributed to its ``in_specs`` placements on ``mesh`` and ``f``
    runs on the local shards; each output (one a ``P`` of ``out_specs``)
    becomes a DTensor of its spec. A plain tensor argument is taken as the
    same value on every rank. Inside ``f``, ``all_to_all`` / ``psum`` /
    ``pmean`` / ``axis_index`` name ``mesh``'s axes. The gradients are
    ``jax.grad``'s through the reference's unchecked shard_map (module
    docstring); both of JAX's transposes give the same gradients, so
    ``check_vma`` selects nothing here."""
    from torch.distributed.tensor.experimental import local_map

    dm = mesh.device_mesh
    out_list = _spec_leaves(out_specs)
    out_pl = tuple(placements(s, mesh) for s in out_list)
    # an output's cotangent is divided by the size of the axes it leaves out
    out_scale = [1.0 / math.prod(mesh.shape[a] for a in _unmentioned(s, mesh))
                 for s in out_list]

    def run(*args):
        flat = _flat_values(args)
        specs = _flat_specs(tuple(in_specs), args)
        in_pl, grad_pl = [], []
        for i, (x, s) in enumerate(zip(flat, specs)):
            if not isinstance(x, torch.Tensor):
                in_pl.append(None)
                grad_pl.append(None)
                continue
            if not isinstance(x, DTensor):
                flat[i] = DTensor.from_local(x, dm, [Replicate()] * dm.ndim, run_check=False)
            in_pl.append(placements(s, mesh))
            grad_pl.append(_grad_placements(s, mesh))

        def local(*xs):
            tok = _LOCAL_MESH.set(mesh)
            try:
                out = f(*_unflatten_like(args, iter(xs)))
            finally:
                _LOCAL_MESH.reset(tok)
            ys = _flat_values(out)
            if len(ys) != len(out_pl):
                raise ValueError(f"shard_map: {len(ys)} outputs for {len(out_pl)} out_specs")
            return tuple(_ScaleGrad.apply(y, c) if c != 1.0 and y.requires_grad else y
                         for y, c in zip(ys, out_scale))

        fn = local_map(local, out_placements=out_pl, in_placements=tuple(in_pl),
                       in_grad_placements=tuple(grad_pl), device_mesh=dm,
                       redistribute_inputs=True)
        res = fn(*flat)
        return _unflatten_like(out_specs, iter(res), spec_tree=True)

    return run
