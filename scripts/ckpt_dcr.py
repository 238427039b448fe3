#!/usr/bin/env python3
"""Print the JAX reference's DCR and chunk counts for ``chip_smoke.py``'s
phase ``checkpoint``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/ckpt_dcr.py

Each store of ``chip_smoke.CKPT_STORES`` is the reference's
``DedupCheckpointStore`` with its default detector (CARD k 32, m 64, n 2,
d 50, 120 steps; FastCDC avg 16 KiB) and saves ``CKPT_STEPS`` drifted
steps of ``chip_smoke.ckpt_tree``: the same numpy arrays the port gets
(bf16 leaves handed over as their bit patterns), drifted by
``chip_smoke.ckpt_drift``. ``chip_smoke.py`` pins the printed (DCR,
chunks, dup, delta, raw) as ``CKPT_REFERENCE``: the port on the card must
give the same. The port never imports JAX; this script does. It runs for
a few minutes on a CPU.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint import DedupCheckpointStore  # noqa: E402

import chip_smoke  # noqa: E402


def to_jax(tree: dict) -> dict:
    return chip_smoke.ckpt_map(tree, lambda kind, a: jnp.asarray(
        a.view(ml_dtypes.bfloat16) if kind == "bfloat16" else a))


def main() -> None:
    for scale, sigma, planes in chip_smoke.CKPT_STORES:
        t0 = time.perf_counter()
        store = DedupCheckpointStore(byte_plane=planes)
        chip_smoke.ckpt_saves(store, to_jax, scale, sigma)
        st = store.stats
        print(json.dumps({
            "store": chip_smoke.ckpt_key(scale, sigma, planes), "dcr": round(st.dcr, 6),
            "bytes_in": st.bytes_in, "bytes_stored": st.bytes_stored, "chunks": st.chunks,
            "dup": st.dup_chunks, "delta": st.delta_chunks, "raw": st.raw_chunks,
            "pinned": [round(st.dcr, 6), st.chunks, st.dup_chunks, st.delta_chunks,
                       st.raw_chunks],
            "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
