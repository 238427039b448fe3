"""PyTorch/CUDA port of the CARD dedup + delta-compression system.

A second package beside the JAX reference ``repro``: the same modules,
one for one (``core``, ``kernels``, ``api``, ``data``), in PyTorch, with
the reference's Pallas kernels rewritten by hand in CUDA C++ for Hopper
(``kernels/csrc``). Nothing here imports JAX or ``repro``.

Entry points (``api.store.DedupStore``, ``core.pipeline.CARDDetector``)
run on the CUDA device unless the caller passes ``device="cpu"``; they
raise when CUDA is asked for and absent. Each kernel wrapper in
``kernels.ops`` dispatches on the device of the tensor it is given: a CPU
tensor takes the plain PyTorch version, a CUDA tensor the kernel.
"""
