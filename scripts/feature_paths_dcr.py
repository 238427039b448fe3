#!/usr/bin/env python3
"""Print the JAX reference's DCR and chunk counts for ``chip_smoke.py``'s
phase ``features``: CARD with the per-chunk feature path (``fused:
False``), the poly sub-chunk LSH (``feat.lsh: "poly"``) and the banded
index (``index: "banded-lsh"``, 16 bands of 6 bits).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/feature_paths_dcr.py

Each store is built from ``chip_smoke.feature_dict`` (phase ``main``'s
widths: FastCDC avg 8192; CARD k 32, m 64, n 2, d 50, 150 steps,
threshold 0.3) through ``repro.api.build_store`` and ingests the
``sql_dump`` and ``vmdk`` generators at 32 MiB x 4 versions (seed 1234),
after ``fit`` on the first version. ``chip_smoke.py`` pins the printed
(DCR, chunks, dup, delta, raw) as ``FEATURE_REFERENCE``: the port on the
card must give the same. The port never imports JAX; this script does.
It runs for several minutes on a CPU (the reference's poly hash walks
every byte in Python).
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from repro import api  # noqa: E402
from repro.data import workloads  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> None:
    for name in ("sql_dump", "vmdk"):
        versions = workloads.make_workload(
            name, workloads.WorkloadConfig(base_size=chip_smoke.BASE,
                                           versions=chip_smoke.VERSIONS))
        for variant in chip_smoke.FEATURE_STORES:
            t0 = time.perf_counter()
            store = api.build_store(api.DedupConfig.from_dict(chip_smoke.feature_dict(variant)))
            store.fit(versions[:1])
            for v in versions:
                store.ingest(v)
            st = store.stats
            print(json.dumps({
                "workload": name, "store": variant, "dcr": round(st.dcr, 6),
                "chunks": st.chunks, "dup": st.dup_chunks, "delta": st.delta_chunks,
                "raw": st.raw_chunks, "bytes_stored": st.bytes_stored,
                "pinned": [round(st.dcr, 6), st.chunks, st.dup_chunks, st.delta_chunks,
                           st.raw_chunks],
                "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
