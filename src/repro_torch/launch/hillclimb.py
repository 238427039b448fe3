"""Perf iteration: re-run one dry-run cell with explicit overrides and
log its roofline terms (port of ``repro.launch.hillclimb``).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch grok-1-314b \\
        --shape train_4k --tag mb4 --microbatches 4

The record goes to ``artifacts/hillclimb/{arch}.{shape}.{tag}/``
(``dryrun.run_cell``'s, on ``meta`` over a fake world; no card needed).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import run_cell


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--fsdp", choices=["on", "off"], default=None)
    ap.add_argument("--m-dtype", default=None)
    ap.add_argument("--out", default="artifacts/hillclimb")
    args = ap.parse_args(argv)

    overrides = {}
    if args.microbatches is not None:
        overrides["num_microbatches"] = args.microbatches
    if args.fsdp is not None:
        overrides["fsdp"] = args.fsdp == "on"
    if args.m_dtype is not None:
        overrides["m_dtype"] = args.m_dtype

    out = Path(args.out) / f"{args.arch}.{args.shape}.{args.tag}"
    rec = run_cell(args.arch, args.shape, multi_pod=args.multi_pod, out_dir=out, **overrides)
    if rec.get("ok"):
        r = rec["roofline"]
        print(json.dumps({
            "tag": args.tag, "t_compute": r["t_compute_s"],
            "t_memory": r["t_memory_s"], "t_collective": r["t_collective_s"],
            "dominant": r["dominant"], "frac": r["roofline_fraction"],
            "mem_gb": rec["memory"]["peak_per_chip_gb"],
        }, indent=1))
    return rec


if __name__ == "__main__":
    main()
