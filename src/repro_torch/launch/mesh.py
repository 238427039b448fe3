"""Device meshes (port of ``repro.launch.mesh``).

A FUNCTION, not a module-level constant, so importing this module never
touches a process group or a device.

Mesh layout (the reference's production meshes, 256 ranks a pod):
  single-pod:  (16, 16)      axes ("data", "model")
  multi-pod:   (2, 16, 16)   axes ("pod", "data", "model")

The port's ``Mesh`` holds a ``torch.distributed.device_mesh.DeviceMesh``
and reads as the reference's does: ``mesh.shape`` is an ordered mapping
axis name -> size (``mesh.shape["model"]``) and ``mesh.axis_names`` the
names in mesh order. A mesh on CUDA runs NCCL, one on the CPU gloo, and
one on ``meta`` (the dry run's shapes, nothing allocated) lays DTensors
out over an existing world of torch's ``fake`` backend, which the caller
starts (``launch.dryrun.fake_world``); the backend follows the device
the caller asks for and never changes on its own. Where no process group
exists, ``make_mesh`` starts one of a single rank (never a fake one); a
multi-rank group is the caller's (``torch.distributed.
init_process_group`` with its address, world size and rank). Every group
made here times out after ``TIMEOUT``, so a rank that fails leaves the
others an error, not a hang.
"""
from __future__ import annotations

import datetime
import itertools
import math

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

TIMEOUT = datetime.timedelta(seconds=60)


class Mesh:
    """A named device mesh: ``device_mesh`` (torch's), ``axis_names`` and
    ``shape`` (``{name: size}`` in mesh order)."""

    def __init__(self, device_mesh: DeviceMesh, axis_names: tuple[str, ...],
                 device_type: str | None = None):
        self.device_mesh = device_mesh
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, device_mesh.shape))
        # a meta mesh's DeviceMesh is a "cpu" one: DTensor's dispatch asks
        # the mesh's device module, which "meta" has not
        self.device_type = device_type or device_mesh.device_type

    def get_group(self, axis: str) -> dist.ProcessGroup:
        return self.device_mesh.get_group(axis)

    def local_rank(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type})"


def _backend(device_type: str) -> str:
    return {"cuda": "nccl", "meta": "fake"}.get(device_type, "gloo")


def _device_type(device) -> str:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for a gloo mesh")
    return dev.type


def _ensure_group(device_type: str) -> None:
    """The default process group: a world of one on this backend where none
    exists; an existing group must be of this backend."""
    backend = _backend(device_type)
    if not dist.is_initialized():
        if device_type == "meta":
            raise RuntimeError("a meta mesh needs a fake world: start one first "
                               "(launch.dryrun.fake_world)")
        if device_type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=TIMEOUT)
        return
    have = dist.get_backend()
    if have != backend:
        raise RuntimeError(f"the process group runs {have}; a {device_type} mesh needs {backend}")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def make_mesh(shape, axes, *, device=None) -> Mesh:
    """A mesh of ``shape`` over the ranks of the default group, in rank
    order (rank r at the row-major position r), on CUDA unless
    ``device="cpu"`` (or ``"meta"`` over a fake world). Each axis gets a
    group of its own, made here with ``TIMEOUT``: every rank makes every
    group, in the same order."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    device_type = _device_type(device)
    _ensure_group(device_type)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the world has {world}")
    ranks = np.arange(world).reshape(shape)
    me = dist.get_rank()
    groups = []
    for dim in range(len(shape)):
        mine = None
        others = [d for d in range(len(shape)) if d != dim]
        for idx in itertools.product(*(range(shape[d]) for d in others)):
            sl = [slice(None)] * len(shape)
            for d, i in zip(others, idx):
                sl[d] = i
            members = ranks[tuple(sl)].tolist()
            g = (dist.group.WORLD if len(members) == world else
                 dist.new_group(members, timeout=TIMEOUT, backend=_backend(device_type)))
            if me in members:
                mine = g
        groups.append(mine)
    dm = DeviceMesh.from_group(groups, "cpu" if device_type == "meta" else device_type,
                               mesh=torch.as_tensor(ranks), mesh_dim_names=axes)
    return Mesh(dm, axes, device_type)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production mesh; raises unless the world holds its
    256 (512 multi-pod) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(model_axis: int = 1, *, device=None) -> Mesh:
    """A ("data", "model") mesh over every rank of the default group (one
    rank where there is none): world / model_axis x model_axis."""
    device_type = _device_type(device)
    _ensure_group(device_type)
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"{n} ranks do not split into a model axis of {model_axis}")
    return make_mesh((n // model_axis, model_axis), ("data", "model"), device=device_type)
