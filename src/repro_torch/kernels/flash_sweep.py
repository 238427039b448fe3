"""Sweep the tensor-core flash kernel's key tile and ring depth on the card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_sweep [--t 32768] [--rounds 2]

Builds ``csrc/flash_attn_sm90.cu`` once for each (keys per tile, stages) in
``VARIANTS`` (all nvcc runs started together), with the build's own nvcc
flags, into its own library under ``build/repro_torch_kernels/sweep/``,
and prints ptxas' register, spill and wgmma-serialisation lines. Then, in
a fresh process per variant and round (so a faulting variant cannot spoil
the next), it holds the variant to the
plain version within one bf16 rounding step (rtol 2^-7, atol 2e-5) at two
shapes and at the timed one, and times it at B 1, T, granite-8b's heads
(32 query, 8 KV, hd 128), bf16, causal, by CUDA events, beside one
``scaled_dot_product_attention`` call as a yardstick. One JSON line per
variant and round. A measuring tool: nothing in the port reads it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys

import torch

from repro_torch.kernels import _build, flash_attn

VARIANTS = [(128, 2), (64, 2), (64, 4), (64, 6)]      # (kBk, kStages)
CHECKS = [(4097, 4097, True), (1000, 3000, False)]
HEADS, KV_HEADS, HD = 32, 8, 128


def build_all() -> dict[tuple[int, int], tuple[str, list[str]]]:
    """Compile every variant (one nvcc each, all started together); returns
    {(kBk, kStages): (library path, ptxas lines)}."""
    src = (_build.CSRC / "flash_attn_sm90.cu").read_text()
    out = _build.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for bk, stages in VARIANTS:
        var, n_bk = re.subn(r"constexpr int kBk = \d+;", f"constexpr int kBk = {bk};", src)
        var, n_st = re.subn(r"constexpr int kStages = \d+;", f"constexpr int kStages = {stages};",
                            var)
        if (n_bk, n_st) != (1, 1):
            raise RuntimeError("flash_attn_sm90.cu no longer declares kBk and kStages once each")
        cu, lib = out / f"flash_sm90_bk{bk}_s{stages}.cu", out / f"flash_sm90_bk{bk}_s{stages}.so"
        cu.write_text(var)
        procs[(bk, stages)] = (str(lib), subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for (kBk, kStages) {key}:\n{log}")
        built[key] = (lib, [ln.strip() for ln in log.splitlines()
                            if re.search(r"registers|spill|C7512", ln)])
    return built


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


def measure(lib_path: str, t_main: int) -> dict:
    """Check and time one built variant (in this process)."""
    fn = getattr(ctypes.CDLL(lib_path), "repro_flash_attention_sm90")
    fn.argtypes = _build._SIGNATURES["repro_flash_attention_sm90"]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tr = lambda x: x.transpose(1, 2)

    def run(q, k, v, causal):
        o = torch.empty_like(q)
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), q.shape[0],
                        q.shape[2], k.shape[2], q.shape[1], k.shape[1], HD, int(causal),
                        ctypes.c_float(flash_attn.scale_of(HD)),
                        torch.cuda.current_stream().cuda_stream), lib_path)
        return o

    def used(tq, tk, causal, time_it=False):
        mk = lambda t, h: torch.randn(1, t, h, HD, device=dev, generator=gen).bfloat16()
        q, k, v = mk(tq, HEADS), mk(tk, KV_HEADS), mk(tk, KV_HEADS)
        ms = time_ms(lambda: run(q, k, v, causal)) if time_it else None
        got = run(q, k, v, causal).float()
        want = tr(flash_attn.flash_attention_plain(tr(q), tr(k), tr(v), causal)).float()
        share = float(((got - want).abs() / (2e-5 + 2.0 ** -7 * want.abs())).max())
        return share, ms, (q, k, v)

    shares = [used(*c)[0] for c in CHECKS]
    share, ms, (q, k, v) = used(t_main, t_main, True, time_it=True)
    sdpa_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        tr(q), tr(k), tr(v), is_causal=True, enable_gqa=True))
    flops = 2.0 * 2.0 * HEADS * t_main * t_main * HD / 2
    return dict(kernel_ms=ms, sdpa_ms=sdpa_ms, tflop_per_s=flops / ms / 1e9,
                bound_used=shares + [share], within_one_step=max(shares + [share]) <= 1.0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--t", type=int, default=32_768)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--run", help=argparse.SUPPRESS)        # one variant, in a child
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_sweep: no CUDA device", file=sys.stderr)
        return 1
    if args.run:
        print(json.dumps(measure(args.run, args.t)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    built = build_all()
    for (bk, stages), (_lib, ptxas) in built.items():
        print(json.dumps({"variant": {"kBk": bk, "kStages": stages}, "ptxas": ptxas}), flush=True)
    failed = False
    for rnd in range(args.rounds):
        for (bk, stages), (lib, _ptxas) in built.items():
            child = subprocess.run(
                [sys.executable, "-m", "repro_torch.kernels.flash_sweep", "--run", lib,
                 "--t", str(args.t)], stdout=subprocess.PIPE, text=True)
            lines = child.stdout.strip().splitlines()
            row = json.loads(lines[-1]) if child.returncode == 0 and lines else {"failed": True}
            failed |= child.returncode != 0 or not row.get("within_one_step", False)
            print(json.dumps({"round": rnd, "kBk": bk, "kStages": stages, **row}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
