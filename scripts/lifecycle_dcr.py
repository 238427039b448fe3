#!/usr/bin/env python3
"""Print the JAX reference's numbers for ``chip_smoke.py``'s phase
``lifecycle`` (space reclamation), which pins them as
``LIFECYCLE_REFERENCE``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/lifecycle_dcr.py [--base-mib 32]

The stores and steps are ``chip_smoke.py``'s own (``LIFECYCLE_STORES``,
``lifecycle_dict``, ``lifecycle_steps``), run here through
``repro.api.build_store`` on a CPU, each in a fresh temporary directory:
CARD (k 32, m 64, n 2, d 50, 150 steps, threshold 0.3; FastCDC avg 8192)
on ``file`` with ``verify_reads`` and policy ``never`` for ``sql_dump``
and ``vmdk``, and on ``objectstore`` with policy ``threshold`` (ratio
0.25) for ``sql_dump``, at 32 MiB x 4 versions (seed 1234). Each line is
one store's pinned numbers: ingest counts, DCR before the deletes, each
delete's freed bytes (and whether it auto-compacted), the
``CollectReport``, the ``CompactionRun`` without ``seconds``, storage
bytes before and after, the survivors' DCR, the re-ingest, the scrubs,
the digest count and the admitted seeds, and the seeded ingest. The port
never imports JAX; this script does. It runs for a few minutes on a CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from repro import api  # noqa: E402
from repro.data import workloads  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base-mib", type=float, default=chip_smoke.BASE / 2**20,
                    help="version size in MiB (the phase's is 32)")
    base = int(ap.parse_args().base_mib * 2**20)
    cache: dict[str, list[bytes]] = {}
    for name, backend, policy, policy_args in chip_smoke.LIFECYCLE_STORES:
        if name not in cache:
            cache[name] = workloads.make_workload(
                name, workloads.WorkloadConfig(base_size=base, versions=chip_smoke.VERSIONS))
        root = tempfile.mkdtemp(prefix="lifecycle_dcr_")
        t0 = time.perf_counter()
        try:
            pinned, _ = chip_smoke.lifecycle_steps(
                lambda d: api.build_store(api.DedupConfig.from_dict(d)),
                chip_smoke.lifecycle_dict(backend, policy, policy_args, root), cache[name])
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(json.dumps({"store": f"{name}/{backend}", "pinned": pinned,
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
