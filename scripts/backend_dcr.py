#!/usr/bin/env python3
"""Print the JAX reference's DCR, byte counts and chunk counts for CARD on
the persistent backends (``"file"`` and ``"objectstore"``) at the
configuration of ``chip_smoke.py``'s phases ``main`` and ``backends``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/backend_dcr.py

Each store is built from a config dict through ``repro.api.build_store``
(FastCDC avg 8192; CARD k 32, m 64, n 2, d 50, 150 steps, threshold 0.3;
the backend rooted in a fresh temporary directory) and ingests the
``sql_dump`` and ``vmdk`` generators at 32 MiB x 4 versions (seed 1234),
after ``fit`` on the first version. The DCR depends on the backend: a
``FileBackend`` adds its record header (29 bytes a record for an RCL2 log)
to every stored chunk, an ``ObjectStoreBackend`` adds nothing. Each line
also gives the DCR without that overhead, which is the in-memory
backend's (``chip_smoke.py``'s ``REFERENCE_DCR``). ``chip_smoke.py`` pins
the printed numbers (``BACKEND_REFERENCE``): the port on the card must
give the same. The port never imports JAX; this script does. It runs for
several minutes on a CPU.
"""
from __future__ import annotations

import json
import tempfile
import time

from repro import api
from repro.data import workloads

BASE, VERSIONS, AVG = 32 << 20, 4, 8192
CARD_ARGS = {"feat": {"k": 32, "m": 64, "n": 2},
             "model": {"m": 64, "d": 50, "steps": 150}, "threshold": 0.3}
BACKENDS = ("file", "objectstore")


def main() -> None:
    for name in ("sql_dump", "vmdk"):
        versions = workloads.make_workload(
            name, workloads.WorkloadConfig(base_size=BASE, versions=VERSIONS))
        for backend in BACKENDS:
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as root:
                store = api.build_store(api.DedupConfig.from_dict({
                    "detector": "card", "detector_args": CARD_ARGS,
                    "chunker_args": {"avg_size": AVG}, "backend": backend,
                    "backend_args": {"path": root}}))
                store.fit(versions[:1])
                for v in versions:
                    store.ingest(v)
                st = store.stats
                overhead = int(store.backend.record_overhead)
                store.close()
            records = st.delta_chunks + st.raw_chunks
            print(json.dumps({
                "workload": name, "backend": backend, "dcr": round(st.dcr, 6),
                "bytes_in": st.bytes_in, "bytes_stored": st.bytes_stored,
                "record_overhead": overhead,
                "dcr_without_overhead": round(
                    st.bytes_in / (st.bytes_stored - overhead * records), 6),
                "chunks": st.chunks, "dup": st.dup_chunks,
                "delta": st.delta_chunks, "raw": st.raw_chunks,
                "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
