"""The elastic restore of the port's checkpoint store (port of
``tests/test_checkpoint.py::test_elastic_reshard_subprocess``): a tree
saved from an 8-rank ("data",) gloo mesh, its leaf sharded
``P("data", None)``, restores onto a 4-rank mesh with the placements and
mesh of ``like``; the saved files are byte-equal to an unsharded save of
the same tree. Each world is a ``torch.multiprocessing`` spawn with a
``file://`` store, joined with a deadline and killed past it.
"""
import os
import pickle
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import checkpoint

pytestmark = pytest.mark.subprocess_mesh

torch.set_num_threads(1)

DEADLINE = 120.0


def _x() -> torch.Tensor:
    return torch.arange(64.0).reshape(8, 8)


def _rank(rank: int, world: int, store: str, ckpt: str, mode: str) -> None:
    torch.set_num_threads(1)
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import TIMEOUT, make_mesh

    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    try:
        mesh = make_mesh((world,), ("data",), device="cpu")
        xs = shd.distribute_params({"x": _x()}, mesh, shd.ShardingRules())["x"]
        xs = xs.redistribute(mesh.device_mesh, shd.placements(shd.P("data", None), mesh))
        if mode == "save":
            checkpoint.save(ckpt, {"x": xs}, step=1)
            return
        like = {"x": torch.zeros_like(xs)}
        got = checkpoint.restore(ckpt, like, step=1)["x"]
        full = got.full_tensor()
        if rank == 0:
            with open(os.path.join(ckpt, "restored.pkl"), "wb") as f:
                pickle.dump({"x": full, "placements": tuple(got.placements),
                             "like": tuple(like["x"].placements),
                             "mesh": got.device_mesh.size(), "local": tuple(got.to_local().shape)},
                            f)
    finally:
        dist.destroy_process_group()


def _spawn(world: int, work, ckpt, mode: str) -> None:
    ctx = mp.spawn(_rank, args=(world, f"file://{work}/store_{mode}", str(ckpt), mode),
                   nprocs=world, join=False)
    deadline = time.time() + DEADLINE
    try:
        while not ctx.join(timeout=5.0):
            if time.time() > deadline:
                raise TimeoutError(f"the {world} ranks passed their deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def test_elastic_reshard_8_to_4(tmp_path):
    sharded, plain = tmp_path / "sharded", tmp_path / "plain"
    _spawn(8, tmp_path, sharded, "save")
    _spawn(4, tmp_path, sharded, "restore")
    with open(sharded / "restored.pkl", "rb") as f:
        got = pickle.load(f)
    assert torch.equal(got["x"], _x())
    assert got["placements"] == got["like"] and got["mesh"] == 4
    assert got["local"] == (2, 8)
    # the sharded save wrote what an unsharded save of the same values writes
    checkpoint.save(plain, {"x": _x()}, step=1)
    files = sorted(p.name for p in (plain / "step_00000001").iterdir())
    assert files == sorted(p.name for p in (sharded / "step_00000001").iterdir())
    for name in files:
        assert ((sharded / "step_00000001" / name).read_bytes()
                == (plain / "step_00000001" / name).read_bytes()), name
