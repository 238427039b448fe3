"""The dry run: every (arch x shape) cell laid out on the production mesh
and its step run once on ``meta`` tensors (port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch whisper-base --shape all

The reference compiles each cell for 256 (512) placeholder XLA devices.
Here the process starts a world of torch's ``fake`` backend of 256 ranks
(512 with ``--mesh multi``) and is its rank 0: every collective returns
at once and moves nothing. Each cell is built by ``cells.lower_cell`` on
the ``meta`` device over ``launch.mesh.make_production_mesh(device=
"meta")``, so rank 0 holds its shards as ``meta`` tensors of their local
shapes and the step allocates nothing; a cell that is incoherent under
its rules raises here as the reference's ``.compile()`` does. No card is
needed.

Each record (``artifacts/dryrun/{arch}.{shape}.{single|multi}.json``)
keeps the reference's fields where the port has a counterpart:

- ``ok``, ``lower_s`` (building and laying the cell out) and ``trace_s``
  (one run of its step on ``meta``), ``kind``, ``chips``;
- ``memory``: ``argument_bytes`` (a rank's local shards of the params, the
  train state, the inputs and the cache, exact) and ``output_bytes`` (the
  local shards of what the step returns, exact); ``temp_bytes`` and
  ``alias_bytes`` are null (nothing has a compiled buffer assignment), so
  ``peak_per_chip_gb`` (arguments + outputs) is a lower bound
  (``peak_is_lower_bound``);
- ``roofline`` (``distributed.roofline``): rank 0's FLOPs and collective
  bytes counted while the step ran (``roofline.RankCounter``), the
  argument bytes as its HBM bytes, H100 peaks, and the reference's
  ``model_flops`` / ``model_bytes``.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import base as configs
from repro_torch.distributed import roofline as rl
from repro_torch.launch.cells import lower_cell
from repro_torch.launch.mesh import make_production_mesh


def fake_world(world: int) -> None:
    """Make this process rank 0 of a ``fake``-backend world of ``world``
    ranks (re-made at another size); any other process group raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a dry run needs a fake world; this process runs "
                               f"{dist.get_backend()}")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def local_bytes(tree) -> int:
    """The bytes rank 0 holds of every tensor in ``tree`` (a DTensor's local
    shard, any other tensor whole)."""
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if isinstance(tree, DTensor) else tree
        return t.numel() * t.element_size()
    return 0


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, out_dir: Path,
             verbose: bool = True, **overrides) -> dict:
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    chips = dist.get_world_size()
    tag = f"{arch}.{shape_name}.{'multi' if multi_pod else 'single'}"
    t0 = time.time()
    record: dict = {"arch": arch, "shape": shape_name,
                    "mesh": "2x16x16" if multi_pod else "16x16",
                    "chips": chips, "ok": False, "overrides": {
                        k: str(v) for k, v in overrides.items()}}
    try:
        lowered, meta = lower_cell(arch, shape_name, mesh, multi_pod=multi_pod, **overrides)
        t_lower = time.time() - t0
        with rl.RankCounter() as counter:
            out = lowered.step()
        t_trace = time.time() - t0 - t_lower
        arg_bytes, out_bytes = local_bytes(lowered.args), local_bytes(out)
        roof = rl.build(counter, arg_bytes, configs.get_config(arch),
                        configs.get_shape(shape_name), chips)
        record.update({
            "ok": True,
            "lower_s": round(t_lower, 2),
            "trace_s": round(t_trace, 2),
            "kind": meta.kind,
            "num_microbatches": meta.num_microbatches,
            "fsdp": meta.fsdp,
            "memory": {
                "argument_bytes": arg_bytes,
                "output_bytes": out_bytes,
                "temp_bytes": None,
                "alias_bytes": None,
                "peak_per_chip_gb": round((arg_bytes + out_bytes) / 2**30, 3),
                "peak_is_lower_bound": True,
            },
            "roofline": roof.to_dict(),
        })
        if verbose:
            print(f"[ok] {tag}: trace={t_trace:.1f}s "
                  f"mem/chip>={record['memory']['peak_per_chip_gb']}GB "
                  f"dominant={roof.dominant} "
                  f"t=({roof.t_compute:.4f},{roof.t_memory:.4f},"
                  f"{roof.t_collective:.4f})s "
                  f"roofline={roof.roofline_fraction:.2%}", flush=True)
    except Exception as e:  # noqa: BLE001 — record and continue
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[FAIL] {tag}: {record['error']}", flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"{tag}.json", "w") as f:
        json.dump(record, f, indent=2)
    return record


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry run")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = list(configs.ARCH_IDS) if args.arch == "all" else [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    out_dir = Path(args.out)

    results = []
    for arch in archs:
        shapes = [s.name for s in configs.cells(arch)]
        if args.shape != "all":
            if args.shape not in shapes:
                print(f"[skip] {arch}.{args.shape}: N/A for this arch")
                continue
            shapes = [args.shape]
        for shape_name in shapes:
            for mp in meshes:
                tag = f"{arch}.{shape_name}.{'multi' if mp else 'single'}"
                if args.skip_existing and (out_dir / f"{tag}.json").exists():
                    existing = json.loads((out_dir / f"{tag}.json").read_text())
                    if existing.get("ok"):
                        print(f"[cached] {tag}")
                        results.append(existing)
                        continue
                results.append(run_cell(arch, shape_name, multi_pod=mp, out_dir=out_dir))
    ok = sum(r.get("ok", False) for r in results)
    print(f"\n{ok}/{len(results)} cells traced")
    if ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
