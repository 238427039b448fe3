"""Sweep kernel C's micro tile, ring depth and unrolling on the card.

    PYTHONPATH=src python -m repro_torch.kernels.topk_sweep [--rounds 2]

Builds ``csrc/sim_topk.cu`` once for each (threads along the rows, stages,
unroll of the paired-column loop) in ``VARIANTS`` (all nvcc runs started
together), with the build's own nvcc flags, into its own library under
``build/repro_torch_kernels/sweep/``, and prints ptxas' register and
spill lines. kTx 8 is the 8 x 16 micro tile on 128 threads, kTx 16 the
8 x 8 tile on 256. Then it holds every variant to the plain version
(every argmax row equal, scores bit-identical to the port's own build) at
B 4096, D 50, N 16,384 and 2^20 (unit rows from a seeded generator), and
times each by CUDA events, the variants in turn within each round. The
card's SM clock and power draw are sampled while the port's own build
runs at N 2^20. One JSON line per variant and round. A measuring tool:
nothing in the port reads it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time

import torch

from repro_torch.kernels import _build, ops, sim_topk

# (kTx, kStages, unroll of the paired-column loop); the first is the source's own
VARIANTS = [(8, 2, 1), (8, 2, 5), (8, 3, 1), (16, 2, 1), (16, 2, 5)]
ROWS_Q, D, SIZES = 4096, 50, (16_384, 1 << 20)
_UNROLL = re.compile(r"#pragma unroll \d+(\n\s+for \(int c = 0; c < kD; c \+= 2\))")


def build_all() -> dict[tuple[int, int, int], tuple[str, list[str]]]:
    """Compile every variant (one nvcc each, all started together); returns
    {variant: (library path, ptxas lines)}."""
    src = (_build.CSRC / "sim_topk.cu").read_text()
    out = _build.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tx, stages, unroll in VARIANTS:
        var, n_tx = re.subn(r"constexpr int kTx = \d+;", f"constexpr int kTx = {tx};", src)
        var, n_st = re.subn(r"constexpr int kStages = \d+;", f"constexpr int kStages = {stages};",
                            var)
        var, n_un = _UNROLL.subn(rf"#pragma unroll {unroll}\1", var)
        if (n_tx, n_st, n_un) != (1, 1, 1):
            raise RuntimeError("sim_topk.cu no longer declares kTx, kStages and the "
                               "paired-column loop once each")
        name = f"sim_topk_tx{tx}_s{stages}_u{unroll}"
        cu, lib = out / f"{name}.cu", out / f"{name}.so"
        cu.write_text(var)
        procs[(tx, stages, unroll)] = (str(lib), subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for (kTx, kStages, unroll) {key}:\n{log}")
        built[key] = (lib, [ln.strip() for ln in log.splitlines()
                            if re.search(r"registers|spill", ln)])
    return built


def launcher(lib_path: str):
    """sim_topk through one variant's C entry, with the port's split plan."""
    fn = getattr(ctypes.CDLL(lib_path), "repro_sim_topk")
    fn.argtypes = _build._SIGNATURES["repro_sim_topk"]
    fn.restype = ctypes.c_int

    def run(q: torch.Tensor, index: torch.Tensor):
        dev = q.device
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits, per = sim_topk.split_plan(q.shape[0], index.shape[0], sms)
        part_s = torch.empty(splits, q.shape[0], device=dev)
        part_r = torch.empty(splits, q.shape[0], dtype=torch.int32, device=dev)
        out_s = torch.empty(q.shape[0], device=dev)
        out_r = torch.empty(q.shape[0], dtype=torch.int32, device=dev)
        _build.check(fn(q.data_ptr(), index.data_ptr(), q.shape[0], index.shape[0], q.shape[1],
                        splits, per, part_s.data_ptr(), part_r.data_ptr(), out_s.data_ptr(),
                        out_r.data_ptr(), torch.cuda.current_stream(dev).cuda_stream), lib_path)
        return out_s, out_r
    return run


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def unit_rows(rows: int, gen: torch.Generator) -> torch.Tensor:
    x = torch.randn(rows, D, device="cuda", generator=gen)
    return x / torch.linalg.norm(x, dim=1, keepdim=True)


def clocks_under(fn, seconds: float = 2.0) -> list[str]:
    """nvidia-smi's SM clock and power draw, sampled while ``fn`` runs."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader", "-lms", "200"],
                           stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
        torch.cuda.synchronize()
    smi.terminate()
    return smi.communicate()[0].strip().splitlines()[2:]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("topk_sweep: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    built = build_all()
    for key, (_lib, ptxas) in built.items():
        print(json.dumps({"variant": dict(zip(("kTx", "kStages", "unroll"), key)),
                          "ptxas": ptxas}), flush=True)
    runs = {key: launcher(lib) for key, (lib, _ptxas) in built.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = unit_rows(ROWS_Q, gen)
    failed = False
    for n in SIZES:
        index = unit_rows(n, gen)
        want_s, want_r = ops.sim_topk(q, index)
        _plain_s, plain_r = sim_topk.sim_topk_plain(q, index)
        failed |= not torch.equal(want_r, plain_r)
        for rnd in range(args.rounds):
            for key, run in runs.items():
                s, r = run(q, index)
                same = bool(torch.equal(s, want_s) and torch.equal(r, want_r))
                failed |= not same
                print(json.dumps({"round": rnd, "n": n, "kTx": key[0], "kStages": key[1],
                                  "unroll": key[2], "identical": same,
                                  "kernel_ms": time_ms(lambda: run(q, index))}), flush=True)
        if n == SIZES[-1]:
            print(json.dumps({"clocks_sm_power": clocks_under(lambda: ops.sim_topk(q, index))}),
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
