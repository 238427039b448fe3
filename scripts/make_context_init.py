#!/usr/bin/env python3
"""Write the JAX reference's initial context-model params as ``.npy``
fixtures for the PyTorch port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_context_init.py

``repro.core.context_model.init_params`` draws ``w [m, d]`` and
``u [d, m]`` from ``jax.random``, which torch cannot replay. The port
loads these files as its default init at the same (m, d, seed), so a
fit from scratch starts where the reference's does
(``repro_torch.core.context_model.reference_init``). The port never
imports JAX; this script and ``tests/test_torch_context_model.py`` do.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from repro.core import context_model as ref_cm

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "src" / "repro_torch" / "core" / "fixtures"
# (m, d, seed): the widths of chip_smoke.py and of the port's tests
WIDTHS = [(64, 50, 0)]


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    for m, d, seed in WIDTHS:
        params = ref_cm.init_params(ref_cm.ContextModelConfig(m=m, d=d, seed=seed))
        stem = f"context_init_m{m}_d{d}_seed{seed}"
        for name in ("w", "u"):
            arr = np.asarray(getattr(params, name), np.float32)
            np.save(OUT / f"{stem}.{name}.npy", arr)
            print(f"{stem}.{name}.npy {arr.shape}")


if __name__ == "__main__":
    main()
