#!/usr/bin/env python3
"""Print the JAX reference's numbers for ``chip_smoke.py``'s phase
``serve`` (the multi-tenant server, its metrics and spans, the breaker
drill and the object-store CLI), which pins them as ``SERVE_REFERENCE``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/serve_dcr.py [--base-mib 32]

The steps are ``chip_smoke.py``'s own (``serve_steps``, ``serve_dict``),
run here through ``repro.api.build_server``, ``repro.api.serve``,
``repro.api.observe`` and ``repro.api.objectstore.main`` on a CPU, in a
fresh temporary directory: CARD (k 32, m 64, n 2, d 50, 150 steps,
threshold 0.3; FastCDC avg 8192) on ``objectstore`` over
``LocalObjectStore``, 4 workers, fit on sql_dump version 0; tenants
``sql`` and ``vm`` ingest sql_dump's and vmdk's 4 versions of 32 MiB
(seed 1234) interleaved, then concurrent restores, a quota and an
overload shed, the deletes of each tenant's version 0, the metrics after
``close()``, the breaker drill and the CLI roots. The last line is the
pinned dict. The port never imports JAX; this script does. It runs for
a few minutes on a CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from repro import api  # noqa: E402
from repro.api import faults, objectstore, observe, serve  # noqa: E402
from repro.data import workloads  # noqa: E402


def reference_env():
    return types.SimpleNamespace(
        build_server=lambda d: api.build_server(api.DedupConfig.from_dict(d)),
        build_store=lambda d: api.build_store(api.DedupConfig.from_dict(d)),
        serve=serve, faults=faults, parse=observe.parse_prometheus_text,
        dump=observe.main, cli=objectstore.main)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base-mib", type=float, default=chip_smoke.BASE / 2**20,
                    help="version size in MiB (the phase's is 32)")
    base = int(ap.parse_args().base_mib * 2**20)
    versions = {name: workloads.make_workload(
        name, workloads.WorkloadConfig(base_size=base, versions=chip_smoke.VERSIONS))
        for name in ("sql_dump", "vmdk")}
    tmp = tempfile.mkdtemp(prefix="serve_dcr_")
    t0 = time.perf_counter()
    try:
        pinned, measured = chip_smoke.serve_steps(reference_env(), versions, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"seconds": round(time.perf_counter() - t0, 1),
                      "cli_s": measured["cli_s"]}), flush=True)
    print(json.dumps(pinned), flush=True)


if __name__ == "__main__":
    main()
