#!/usr/bin/env python3
"""Print the JAX reference's DCR and chunk counts for the paper's two
baselines (and exact dedup alone) at the configuration of
``chip_smoke.py``'s phase ``baselines``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/baseline_dcr.py

Each store is built from a config dict through ``repro.api.build_store``
(FastCDC avg 8192, default super-feature settings) and ingests the
``sql_dump`` and ``vmdk`` generators at 32 MiB x 4 versions (seed 1234),
after ``fit`` on the first version. ``chip_smoke.py`` pins the printed
numbers (``BASELINE_REFERENCE``): the port on the card must give the
same. The port never imports JAX; this script does. It runs for a few
minutes on a CPU.
"""
from __future__ import annotations

import json
import time

from repro import api
from repro.data import workloads

BASE, VERSIONS, AVG = 32 << 20, 4, 8192
DETECTORS = ("dedup-only", "finesse", "n-transform")


def main() -> None:
    for name in ("sql_dump", "vmdk"):
        versions = workloads.make_workload(
            name, workloads.WorkloadConfig(base_size=BASE, versions=VERSIONS))
        for det in DETECTORS:
            t0 = time.perf_counter()
            store = api.build_store(api.DedupConfig.from_dict(
                {"detector": det, "chunker_args": {"avg_size": AVG}}))
            store.fit(versions[:1])
            for v in versions:
                store.ingest(v)
            st = store.stats
            print(json.dumps({
                "workload": name, "detector": det, "dcr": round(st.dcr, 6),
                "bytes_in": st.bytes_in, "bytes_stored": st.bytes_stored,
                "chunks": st.chunks, "dup": st.dup_chunks,
                "delta": st.delta_chunks, "raw": st.raw_chunks,
                "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
