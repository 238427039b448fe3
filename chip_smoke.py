#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of CARD on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each (phases 3b and 7 are the LM slice):
  1. device   the card's name and power limit (nvidia-smi), the torch and
              CUDA versions; TF32 must be off;
  2. build    nvcc builds every kernel in src/repro_torch/kernels/csrc
              (seconds, ptxas registers and spills of each kernel, the
              HGMMA, HMMA and FFMA counts of each flash kernel's SASS: the
              tensor-core kernel must hold HGMMA; and the FFMA and
              shared-memory load counts of each top-1 kernel's SASS);
  3. kernel   each kernel against its plain PyTorch version on the card,
              at the main path's shapes, with kernel, plain and
              library-call times and the bound: kernel A bit-exact at
              sizes across a thread's run, a block and the halo, timed at
              the main path's scan length and at the 64 MiB bucket, with
              Rabin; kernel B (features with the mean-normalise epilogue
              fused) at [4096, 61], M 64 and on a real sql_dump extract,
              its quotients bit for bit against x / norm, timed beside
              the old torch epilogue and the launch floor; kernel C's
              argmax exact at B 4097, D 16 / 50 / 64 / 256, its ties and
              padding, timed at N 16,384 and 2^20; kernel A's Rabin
              route on the packed chunks of a real sql_dump version (the
              baselines' extract): bit-exact for every chunk against the
              plain version run on that chunk alone, timed beside the
              plain version and the bound;
  3b. attn_kernel  kernel D (flash attention) against its plain version,
              each check on the route dtype and hd give it (bf16 at hd 64
              or 128 on the tensor cores, f32 and hd 100 on the SIMT
              kernel): granite-8b's heads, causal, ragged, causal and
              non-causal Tq != Tk, hd 64, batch 2; then the tensor-core
              kernel timed at the prefill shape beside the SIMT kernel,
              the plain version, SDPA and the bound;
  4. main     CARD ingest end to end (DedupStore on the card) over
              sql_dump and vmdk, 32 MiB x 4 versions: fit, ingest,
              SHA-256-identical restore, stage times, DCR (which must be
              the JAX package's) and the launch count of each kernel,
              which must all be > 0; then a profiled ingest ("profile")
              for the device busy share;
  4b. baselines  four stores built from config dicts on the card
              (``api.config.build_store``): dedup-only, Finesse,
              N-transform and CARD, each over the same workloads: DCR and
              chunk counts equal to the JAX package's (pinned from
              scripts/baseline_dcr.py; CARD's as in phase 4), every restore
              SHA-256-identical, kernel A's Rabin route launched on both
              super-feature paths; DCR, ingest MB/s and detect seconds side
              by side;
  4c. backends  CARD stores on the persistent backends ("file" with
              verify_reads, "objectstore" over LocalObjectStore), each built
              from a config dict on the card in a fresh temporary directory,
              over the same workloads: fit, ingest the 4 versions (DCR, bytes
              stored and counts pinned to the JAX package's from
              scripts/backend_dcr.py, counts equal to phase 4's, kernels A, B
              and C launched), close; a fresh store from the same dict on the
              same directory restores every version SHA-256-identically cold
              and warm, by iterator and by 16 seeded ranges; a fresh fit and
              ingest of version 3 stores new chunks under ids above the
              reopened max_chunk_id, with A and B launched again (C's gate
              wants 512 indexed rows; the reopened index is empty), and all
              5 streams restore; on "objectstore" a FaultSchedule fails a GET
              and the restore stays exact with retries > 0. One JSON line a
              workload and backend: DCR, counts, ingest MB/s, store seconds,
              cold / warm restore MB/s, bytes read, requests and read
              amplification, bytes on disk, the crc32c route and its seconds;
  4d. lifecycle  space reclamation on three CARD stores built from dicts
              on the card ("file" with verify_reads and policy "never" for
              both workloads, "objectstore" with policy "threshold", ratio
              0.25, for sql_dump): ingest the 4 versions, delete versions 0
              and 1 (each deleted handle raises KeyError), collect,
              compact, re-ingest version 0 against an index that still
              holds the swept rows (kernels A, B and C must launch there),
              restore every live stream SHA-256-identically, scrub clean,
              close, reopen, scrub and restore again, seed the digest
              table from the closed store's snapshot and ingest version 3
              again (no new chunk). Every count, report and byte total is
              pinned to the JAX package's (scripts/lifecycle_dcr.py runs
              the same steps). One JSON line a store (DCR before and the
              survivors' after, reclaimable and reclaimed bytes, the
              rebase mix, delete / collect / compact / scrub seconds,
              restore MB/s, the crc32c route, launches); then the crash
              drill ("lifecycle_crash"): the crash-matrix script crashed at
              one compaction crashpoint a backend, copied, reopened, and
              the post-crash contract checked;
  5. fit      the card's context-model fit against a CPU fit from the
              same init and batch stream (per-step loss, transform);
  6. parity   the port on the card and on the CPU over kernel-workload
              streams, under one model: identical verdicts, records,
              per-stream counts and DCR; then ("tf32") the same ingest on
              the card with TF32 turned on: identical verdicts;
  7. lm       granite-8b at full width and depth in bf16 (seeded random
              weights): a 32,768-token Model.prefill through kernel D
              (36 launches, all on the tensor cores; kernel time, peak
              memory); serve_loop at batch 4, prompt 64, 64 new tokens,
              and a profiled short serve_loop for decode's device busy
              share; and, at depth 4 in f32, prefill's last logits against
              token-by-token decode_step.
Then the nvidia-smi line, the kernels summary line, and the result line.
Exits non-zero on any mismatch and when there is no CUDA device.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.api import config, faults, integrity  # noqa: E402
from repro_torch.api.store import DedupStore, chunk_with  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import chunking, context_model, features, hashing, pipeline  # noqa: E402
from repro_torch.data import workloads  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build, flash_attn, gear_hash, ingest, ops, shingle_embed, sim_topk)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import make_model  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): device memory
# rate, fp32 outside the tensor cores (kernels A-C do fp32 and 32-bit
# integer work on the scalar ALUs) and bf16 on the tensor cores (kernel
# D's bound: the least time for attention's FLOPs on this card, whatever
# units the kernel uses).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

FEAT = features.FeatureConfig(k=32, m=64, n=2)
MODEL = context_model.ContextModelConfig(m=64, d=50, steps=150)
CHUNKER = chunking.ChunkerConfig(avg_size=8192)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls.

    A sleep kernel holds the stream while the host enqueues the calls, so
    they run back to back and host overhead between launches (ctypes,
    allocation) stays out of the device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(reps * 400_000)     # ~0.2 ms of cycles per call
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, flops: float, flop_rate: float = FP32_FLOP_PER_S
          ) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- phase 3: kernels against their plain versions -----------------------------

def time_gear(data, n: int) -> dict:
    """Kernel A (the fused scan) and its plain version at one length, with
    the bound: bytes, each input byte read and each hash and candidate
    word written; operations, the serial gear recurrence h = (h << 1) + g
    (2 a position) and two mask tests (2 each), at the scalar-ALU rate."""
    mask_s, mask_l = CHUNKER.mask_s, CHUNKER.mask_l
    ms = time_ms(lambda: ops.scan_candidates(data, mask_s, mask_l))
    plain_ms = time_ms(lambda: gear_hash.scan_plain(data, mask_s, mask_l), reps=3, warmup=1)
    b_ms, b_by = bound(n + 4 * n + 2 * 4 * gear_hash.num_words(n), 6.0 * n)
    return dict(n=n, kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def check_gear(dev, sizes, gen, main_n: int, bucket_n: int) -> dict:
    """Kernel A bit-exact against its plain version at every size (hashes,
    both candidate maps, gear alone, Rabin at W 48 and 16), then timed at
    the main path's scan length and at the 64 MiB pow2 bucket the main
    path scanned before, with Rabin at W 48 beside it."""
    mask_s, mask_l = CHUNKER.mask_s, CHUNKER.mask_l
    for n in sizes:
        data = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev, generator=gen)
        h, ws, wl = ops.scan_candidates(data, mask_s, mask_l)
        ph, pws, pwl = gear_hash.scan_plain(data, mask_s, mask_l)
        torch.cuda.synchronize()
        if not (torch.equal(h, ph) and torch.equal(ws, pws) and torch.equal(wl, pwl)):
            fail(f"scan_candidates != plain at n={n}")
        if not torch.equal(ops.gear_hashes(data), gear_hash.gear_hashes_plain(data)):
            fail(f"gear_hashes != plain at n={n}")
        for window in (hashing.RABIN_WINDOW, 16):
            if not torch.equal(ops.rabin_fps(data, window), gear_hash.rabin_fps_plain(data, window)):
                fail(f"rabin_fps (W {window}) != plain at n={n}")
        del data, h, ws, wl, ph, pws, pwl
    data = torch.randint(0, 256, (bucket_n,), dtype=torch.uint8, device=dev, generator=gen)
    at_bucket = time_gear(data, bucket_n)
    at_bucket["rabin_ms"] = time_ms(lambda: ops.rabin_fps(data))
    cands = int(torch.sum(ops.scan_candidates(data, mask_s, mask_l)[1] != 0).item())
    main = time_gear(data[:main_n], main_n)
    emit("kernel", name="gear_scan", sizes=sizes, exact=True, rabin_windows=[48, 16],
         **main, library_ms=None, bucket_64mib=at_bucket, nonzero_cand_words=cands)
    return dict(name="gear_scan", max_abs_err=0.0, ms=main["kernel_ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None, shape=[main_n],
                bucket_64mib=at_bucket)


def check_rabin(dev, version: bytes) -> dict:
    """Kernel A's Rabin route as the super-feature baselines launch it: on
    one real sql_dump version's chunks, packed with W - 1 zero bytes
    between them (``ingest.pack_chunks``). Bit-exact against the plain
    version on the whole packed buffer, and, for every chunk, against the
    plain version run on that chunk alone (one row a chunk, its window
    starting from 0 at the chunk's first byte: the reference's per-chunk
    fingerprints). Timed beside the plain version, with the bound: bytes,
    each packed byte read and each fingerprint written; operations, the
    rolling recurrence h = p*h + b - p^W*b' (4 a position)."""
    window = hashing.RABIN_WINDOW
    chunks, scan = chunk_with(CHUNKER, version, dev)
    offs = np.asarray([c.offset for c in chunks], np.int64)
    lens = np.asarray([c.length for c in chunks], np.int64)
    packed, starts = ingest.pack_chunks(scan.data, offs, lens, window - 1)
    got = ops.rabin_fps(packed, window)
    if not torch.equal(got, gear_hash.rabin_fps_plain(packed, window)):
        fail("rabin_fps != plain on the packed sql_dump chunks")
    t = torch.arange(int(lens.max()), device=dev)
    valid = t[None, :] < torch.from_numpy(lens).to(dev)[:, None]     # [B, Lmax]
    pos = (starts[:, None] + t[None, :])[valid]     # every chunk byte, chunk by chunk
    rows = torch.zeros(valid.shape, dtype=torch.uint8, device=dev)
    rows[valid] = packed[pos]
    alone = hashing.to_i32_bits(hashing.rabin_fps(rows, window))[valid]
    wrong = int((got[pos] != alone).sum())
    if wrong:
        fail(f"rabin_fps on the packed chunks differs from per-chunk fingerprints "
             f"at {wrong} positions")
    del rows, valid, pos, alone
    n = packed.shape[0]
    ms = time_ms(lambda: ops.rabin_fps(packed, window))
    plain_ms = time_ms(lambda: gear_hash.rabin_fps_plain(packed, window), reps=3, warmup=1)
    b_ms, b_by = bound(n + 4 * n, 4.0 * n)
    out = dict(n=n, chunks=len(chunks), window=window, kernel_ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=None, per_chunk_exact=True)
    emit("kernel", name="rabin_packed", **out)
    return out


def real_extract(dev, version: bytes) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B's input on one real stream, as the main path makes it:
    the version's chunks, their sub-chunk LSH, shingle ids and
    first-occurrence mask (``ingest.shingle_inputs``), real rows only."""
    chunks, scan = chunk_with(CHUNKER, version, dev)
    offs = np.asarray([c.offset for c in chunks], np.int64)
    lens = np.asarray([c.length for c in chunks], np.int64)
    return ingest.shingle_inputs(scan, offs, lens, dev, k=FEAT.k, n=FEAT.n,
                                 lmax_floor=CHUNKER.max_size)


def check_quotient(dev, gen, ids, a, b) -> int:
    """Kernel B's division-free quotient bit for bit against IEEE x / norm
    on the card: the norms of this run's hash vectors, every 8th float32
    significand in [4, 8) (M 64 gives norms near 4.6) and 2^20 uniform in
    [0.004, 12]; returns the number of pairs."""
    v = hashing.multiply_shift_unit(hashing.from_i32_bits(ids[:2048]),
                                    hashing.from_i32_bits(a), hashing.from_i32_bits(b))
    sig = torch.arange(0, 1 << 23, 8, dtype=torch.int32, device=dev) | 0x40800000
    norm = torch.cat([torch.sqrt(torch.sum(v * v, dim=-1)).reshape(-1) + 1e-12,
                      sig.view(torch.float32) + 1e-12,
                      torch.rand(1 << 20, device=dev, generator=gen) * 12 + 4e-3])
    h = torch.randint(-2**31, 2**31 - 1, norm.shape, dtype=torch.int32, device=dev,
                      generator=gen)
    got = shingle_embed.residual_quotient_cuda(h, norm)
    want = h.float() * 2.0**-31 / norm
    wrong = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    if wrong:
        fail(f"shingle_embed: {wrong} of {norm.numel()} quotients differ from x / norm")
    return norm.numel()


def check_embed(dev, gen, real: tuple[torch.Tensor, torch.Tensor]) -> dict:
    """Kernel B (sums, mean and normalisation in one launch) against its
    plain version (the sums, then ``mean_normalize``) within 1e-5: at
    [4096, 61], M 64 with random ids and four all-masked rows (exactly 0),
    and on ``real``, one sql_dump version's extract. Its quotient bit for
    bit (``check_quotient``). Timed beside the plain version, the torch
    epilogue that followed the kernel before (``mean_normalize`` alone)
    and the launch floor (a one-element ``zero_``). The bound: each id (4
    bytes) and mask byte read once, a and b, each feature written once;
    5 operations per unmasked (shingle, component) pair (scale,
    square-accumulate, divide, accumulate) and 4 per output (mean,
    square-accumulate, normalise)."""
    rows, s_len = 4096, FEAT.num_shingles
    a_np, b_np = hashing.multiply_shift_params(FEAT.m)
    a = hashing.to_i32_bits(hashing.u32_tensor(a_np, dev))
    b = hashing.to_i32_bits(hashing.u32_tensor(b_np, dev))
    ids = torch.randint(-2**31, 2**31 - 1, (rows, s_len), dtype=torch.int32,
                        device=dev, generator=gen)
    mask = torch.rand(rows, s_len, device=dev, generator=gen) < 0.8
    mask[:4] = False                               # all-masked rows give 0
    plain = lambda i, mk: shingle_embed.mean_normalize(
        shingle_embed.shingle_embed_sum_plain(i, mk, a, b), mk)
    errs = []
    for name, (i, mk) in (("random", (ids, mask)), ("sql_dump extract", real)):
        got, want = ops.shingle_embed(i, mk, a, b), plain(i, mk)
        errs.append(float((got - want).abs().max()))
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            fail(f"shingle_embed != plain on {name} input (max abs err {errs[-1]})")
        if name == "random" and float(got[:4].abs().max()) != 0.0:
            fail("shingle_embed: an all-masked row is not 0")
    pairs = check_quotient(dev, gen, ids, a, b)
    ms = time_ms(lambda: shingle_embed.shingle_embed_cuda(ids, mask, a, b), reps=50)
    real_ms = time_ms(lambda: shingle_embed.shingle_embed_cuda(*real, a, b), reps=50)
    plain_ms = time_ms(lambda: plain(ids, mask))
    total = shingle_embed.shingle_embed_sum_plain(ids, mask, a, b)
    epilogue_ms = time_ms(lambda: shingle_embed.mean_normalize(total, mask), reps=50)
    one = torch.zeros(1, device=dev)
    floor_ms = time_ms(lambda: one.zero_(), reps=50)
    valid = int(mask.sum())
    b_ms, b_by = bound(5 * rows * s_len + 8 * FEAT.m + 4 * rows * FEAT.m,
                       5.0 * valid * FEAT.m + 4.0 * rows * FEAT.m)
    real_shape = [real[0].shape[0], real[0].shape[1], FEAT.m]
    emit("kernel", name="shingle_embed", shape=[rows, s_len, FEAT.m],
         max_abs_err=errs[0], tol=1e-5, kernel_ms=ms, plain_ms=plain_ms,
         old_epilogue_ms=epilogue_ms, launch_floor_ms=floor_ms, bound_ms=b_ms,
         bound_by=b_by, library_ms=None, real_shape=real_shape,
         real_unmasked=int(real[1].sum()), real_max_abs_err=errs[1], real_kernel_ms=real_ms,
         quotient_pairs=pairs, quotient_bit_exact=True)
    return dict(name="shingle_embed", max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shape=[rows, s_len, FEAT.m], old_epilogue_ms=epilogue_ms,
                launch_floor_ms=floor_ms, real_shape=real_shape, real_kernel_ms=real_ms)


def library_topk(q, index, block=1 << 18):
    """One torch.matmul + max per block of index rows: the yardstick."""
    best = None
    for n0 in range(0, index.shape[0], block):
        s, _ = torch.max(q @ index[n0:n0 + block].T, dim=1)
        best = s if best is None else torch.maximum(best, s)
    return best


def compare_topk(q, index, s, r) -> float:
    """Scores within 1e-4 of the plain version and every row equal;
    returns the max score error."""
    ps, pr = sim_topk.sim_topk_plain(q, index)
    err = float((s - ps).abs().max())
    if not torch.allclose(s, ps, rtol=1e-4, atol=1e-4):
        fail(f"sim_topk scores != plain (max abs err {err})")
    wrong = int((r != pr).sum())
    if wrong:
        fail(f"sim_topk argmax != plain on {wrong} of {r.numel()} rows")
    return err


def unit_rows(rows: int, d: int, dev, gen) -> torch.Tensor:
    """Random L2-normalised rows: what CosineIndex stores and is asked."""
    x = torch.randn(rows, d, device=dev, generator=gen)
    return x / torch.linalg.norm(x, dim=1, keepdim=True)


def check_topk(dev, gen, big_n: int) -> dict:
    d = MODEL.d
    # padding never wins; ties go to the lowest row (across splits too)
    q = -torch.eye(4, 16, device=dev)
    _, r = ops.sim_topk(q, torch.eye(3, 16, device=dev))
    if int(r.max()) >= 3:
        fail("sim_topk: a padded row won")
    same = torch.full((200_000, 16), 0.25, device=dev)
    _, r = ops.sim_topk(torch.ones(9, 16, device=dev), same)
    if int(r.abs().max()) != 0:
        fail("sim_topk: a tie across splits did not go to row 0")
    idx = torch.randn(200_000, 16, device=dev, generator=gen) * 0.01
    idx[150_000] = 1.0
    idx[160_000] = 1.0
    _, r = ops.sim_topk(torch.ones(9, 16, device=dev), idx)
    if not bool((r == 150_000).all()):
        fail("sim_topk: a tie did not go to the lowest row")

    # B past a multiple of 128, and D 16, 64 and 256 (chunked) at small N
    for b, n, dd in ((4097, 16_384, d), (4097, 5000, 16), (4097, 5000, 64), (4097, 5000, 256)):
        q, index = unit_rows(b, dd, dev, gen), unit_rows(n, dd, dev, gen)
        compare_topk(q, index, *ops.sim_topk(q, index))
    q = unit_rows(4096, d, dev, gen)
    out = None
    for n in (16_384, big_n):
        index = unit_rows(n, d, dev, gen)
        s, r = ops.sim_topk(q, index)
        err = compare_topk(q, index, s, r)
        ms = time_ms(lambda: ops.sim_topk(q, index), reps=10)
        plain_ms = time_ms(lambda: sim_topk.sim_topk_plain(q, index), reps=5, warmup=1)
        lib_ms = time_ms(lambda: library_topk(q, index), reps=5, warmup=1)
        b_ms, b_by = bound(4 * (q.numel() + index.numel()) + 8 * q.shape[0],
                           2.0 * q.shape[0] * n * d)
        emit("kernel", name="sim_topk", shape=[q.shape[0], n, d], max_abs_err=err,
             argmax="exact", kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
             bound_ms=b_ms, bound_by=b_by)
        row = dict(name="sim_topk", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   shape=[q.shape[0], n, d])
        if out is None:
            out = row
        else:
            out["large_index"] = row
        del index
    return out


# --- phase 3b: kernel D against its plain version ------------------------------

# the LM slice's configuration; kernel D is checked at its heads over the
# shapes below and the tolerances of tests/test_kernels.py::TestFlashAttention
LM = get_config("granite-8b")
# (name, B, Tq, Tk, H, KV, hd, causal): Tq 2048 / 4096 / 4097 causal and
# 1000 x 3000 non-causal at granite's heads, the start-aligned causal
# Tq != Tk case, granite's heads at hd 64, and a batch of 2. Each runs in
# bf16 (the tensor-core route) and in f32 (the SIMT route)
ATTN_CHECKS = [
    ("2048x2048_causal", 1, 2048, 2048, 32, 8, 128, True),
    ("4096x4096_causal", 1, 4096, 4096, 32, 8, 128, True),
    ("4097x4097_causal", 1, 4097, 4097, 32, 8, 128, True),
    ("1000x3000_full", 1, 1000, 3000, 32, 8, 128, False),
    ("100x260_causal", 1, 100, 260, 32, 8, 128, True),
    ("hd64_1000x1000_causal", 1, 1000, 1000, 32, 8, 64, True),
    ("b2_2048x2048_causal", 2, 2048, 2048, 32, 8, 128, True),
]
# hd 100 (a head dim TMA's 128-byte boxes do not take): the SIMT route in both dtypes
SIMT_ONLY_CHECKS = [("hd100_70x70_causal", 1, 70, 70, 32, 8, 100, True)]
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 is also held to one bf16 ulp (at most 2**-7 of the value) plus the
# f32 tolerance: kernel and plain version both compute in f32 and round the
# output once, so they differ by at most one rounding step
BF16_ULP = 2.0 ** -7


def attn_inputs(b: int, tq: int, tk: int, h: int, kv: int, hd: int, dtype, dev, gen):
    """Model layout [B, Tq, H, hd] q and [B, Tk, KV, hd] k, v."""
    mk = lambda t, n: torch.randn(b, t, n, hd, device=dev, generator=gen).to(dtype)
    return mk(tq, h), mk(tk, kv), mk(tk, kv)


def attn_plain(q, k, v, causal):
    t = lambda x: x.transpose(1, 2)
    return t(flash_attn.flash_attention_plain(t(q), t(k), t(v), causal))


def attn_err(got, want, dtype, what: str) -> tuple[float, float]:
    """(max abs error, the largest share of the tightest bound used); fails
    the run on a mismatch."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    tol = ATTN_TOL[dtype]
    rtol, atol = (BF16_ULP, ATTN_TOL[torch.float32]) if dtype == torch.bfloat16 else (tol, tol)
    err, used = float(diff.max()), float((diff / (atol + rtol * want.abs())).max())
    if not torch.allclose(got, want, rtol=tol, atol=tol) or used > 1:
        fail(f"flash_attention != plain at {what} (max abs err {err}, "
             f"{used} of the bound rtol {rtol} atol {atol})")
    return err, used


SASS_OPS = {"flash_attn": ("HGMMA", "HMMA", "FFMA"),
            "sim_topk_partial": ("FFMA", "LDS", "LDS.64", "LDS.128")}


def sass_counts(lib_path: str) -> dict[str, dict[str, int]]:
    """Instruction counts in the SASS of the built library (cuobjdump
    -sass): HGMMA (wgmma), HMMA (mma.sync) and FFMA in each flash-attention
    kernel; FFMA and shared-memory loads by width (LDS is 32-bit) in each
    top-1 kernel, whose ratio is the inner loop's FFMA per load."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, check=True).stdout
    counts, name, wanted = {}, None, ()
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            wanted = next((v for k, v in SASS_OPS.items() if k in m.group(1)), ())
            name = m.group(1) if wanted else None
            if name:
                counts[name] = {op: 0 for op in wanted}
        elif name and "@!PT" not in line:    # never issued: a predicate that is always false
            for op in wanted:
                # a load at its exact width ("LDS" is not "LDS.128"); any
                # other op with its modifiers ("HGMMA.64x64x16...")
                tail = r"(?![.\w])" if op.startswith("LDS") else r"\b"
                if re.search(rf"\b{re.escape(op)}{tail}", line):
                    counts[name][op] += 1
    for c in counts.values():
        if "LDS" in c:
            loads = c["LDS"] + c["LDS.64"] + c["LDS.128"]
            c["ffma_per_lds"] = c["FFMA"] / loads if loads else None
    return counts


def ptxas_summary(log: str) -> dict[str, list[int]]:
    """[registers, spill-store bytes, spill-load bytes] of each kernel, by
    mangled name, from the ptxas -v log of the build."""
    out, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
            out[name] = [0, 0, 0]
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name][0] = int(m.group(1))
    return out


def check_attn(dev, gen, t_main: int) -> dict:
    """Each route of kernel D against the plain version at every check it
    takes, then both routes, the plain version and SDPA timed at the
    prefill's shape (B 1, T = the prefill length, granite's heads, bf16)."""
    checks = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, b, tq, tk, h, kv, hd, causal in ATTN_CHECKS + SIMT_ONLY_CHECKS:
            q, k, v = attn_inputs(b, tq, tk, h, kv, hd, dtype, dev, gen)
            before = dict(ops.LAUNCHES)
            got = ops.flash_attention(q, k, v, causal)
            torch.cuda.synchronize()
            sm90 = ops.LAUNCHES["flash_attention_sm90"] - before["flash_attention_sm90"]
            route = "sm90" if sm90 else "simt"
            if (ops.LAUNCHES["flash_attention"] != before["flash_attention"] + 1
                    or route != flash_attn.route(dtype, hd)):
                fail(f"flash_attention took route {route} for {dtype} at {name}")
            err, used = attn_err(got, attn_plain(q, k, v, causal), dtype, name)
            checks.append(dict(name=name, dtype=str(dtype)[6:], route=route,
                               shape=[b, tq, tk, h, kv, hd], causal=causal,
                               max_abs_err=err, bound_used=used))
            del q, k, v, got

    q, k, v = attn_inputs(1, t_main, t_main, LM.num_heads, LM.num_kv_heads, LM.head_dim,
                          torch.bfloat16, dev, gen)
    outs = {}
    before = ops.LAUNCHES["flash_attention_sm90"]
    ms = time_ms(lambda: outs.update(sm90=ops.flash_attention(q, k, v, True)),
                 reps=10, warmup=2)
    if ops.LAUNCHES["flash_attention_sm90"] - before != 12:
        fail("the prefill-shape timing did not run the tensor-core route")
    # the SIMT kernel on the same inputs: kernel D's earlier time
    simt_ms = time_ms(lambda: outs.update(simt=flash_attn.flash_attention_cuda(q, k, v, True)),
                      reps=1, warmup=1)
    plain_ms = time_ms(lambda: outs.update(plain=attn_plain(q, k, v, True)),
                       reps=1, warmup=1)
    main_name = f"{t_main}x{t_main}_causal"
    err, used = attn_err(outs["sm90"], outs["plain"], torch.bfloat16, main_name)
    simt_err, simt_used = attn_err(outs["simt"], outs["plain"], torch.bfloat16, "simt " + main_name)
    del outs
    t = lambda x: x.transpose(1, 2)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        t(q), t(k), t(v), is_causal=True, enable_gqa=True), reps=5, warmup=2)
    moved = 2 * (2 * q.numel() + k.numel() + v.numel())          # q, k, v, o in bf16
    flops = 2.0 * 2.0 * LM.num_heads * t_main * t_main * LM.head_dim / 2    # causal half
    b_ms, b_by = bound(moved, flops, BF16_FLOP_PER_S)
    shape = [1, t_main, LM.num_heads, LM.num_kv_heads, LM.head_dim]
    emit("attn_kernel", name="flash_attention", checks=checks,
         tol={str(k)[6:]: v for k, v in ATTN_TOL.items()}, bf16_ulp_rtol=BF16_ULP,
         shape=shape, dtype="bfloat16", route="sm90", max_abs_err=err, bound_used=used,
         kernel_ms=ms, simt_ms=simt_ms, simt_max_abs_err=simt_err, simt_bound_used=simt_used,
         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
         bound_rate="989e12 bf16 FLOP/s", kernel_tflop_per_s=flops / ms / 1e9,
         # Q.K^T once and P.V twice (P hi and lo): the FLOPs the tensor cores do
         tensor_core_tflop_per_s=1.5 * flops / ms / 1e9, simt_tflop_per_s=flops / simt_ms / 1e9)
    del q, k, v
    err_f32 = max(c["max_abs_err"] for c in checks if c["dtype"] == "float32")
    return dict(name="flash_attention", max_abs_err=err, max_abs_err_f32=err_f32,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, shape=shape, simt_ms=simt_ms,
                simt_source=flash_attn.SOURCE_SIMT)


# --- phase 4: the main path ----------------------------------------------------

# The JAX package's DCR at this configuration (32 MiB x 4 versions, seed
# 1234, FEAT, MODEL, CHUNKER, threshold 0.3), from its CPU run, to six
# decimals. The port's context model starts from the reference's own
# init at these widths (core/fixtures), so the card must give the same.
REFERENCE_DCR = {"sql_dump": 4.129564, "vmdk": 5.681883}
# (chunks, dup, delta, raw) of each workload's phase-4 store, for phase 4c
MAIN_COUNTS: dict[str, tuple[int, int, int, int]] = {}


def card_detector(device) -> pipeline.CARDDetector:
    return pipeline.CARDDetector(feat_cfg=FEAT, model_cfg=MODEL, threshold=0.3,
                                 device=device)


def main_path(name: str, versions: list[bytes]) -> dict[str, int]:
    store = DedupStore(card_detector(None), CHUNKER)
    store._clock()
    ops.reset_launches()
    t0 = time.perf_counter()
    store.fit(versions[:1])
    t1 = time.perf_counter()
    for v in versions:
        store.ingest(v)
    t2 = store._clock()
    for h, v in enumerate(versions):
        if hashlib.sha256(store.restore(h)).digest() != hashlib.sha256(v).digest():
            fail(f"{name}: version {h} did not restore byte-identically")
    t3 = time.perf_counter()
    launches = dict(ops.LAUNCHES)
    st = store.stats
    total = sum(len(v) for v in versions)
    per_kernel = {"gear_scan": launches["scan_candidates"] + launches["gear_hashes"]
                  + launches["rabin_fps"],
                  "shingle_embed": launches["shingle_embed"],
                  "sim_topk": launches["sim_topk"]}
    emit("main", workload=name, base_mib=BASE / 2**20, versions=len(versions),
         bytes_in=total, ingest_mb_per_s=total / 1e6 / (t2 - t1),
         fit_s=t1 - t0, ingest_s=t2 - t1, restore_s=t3 - t2,
         stages_s={"chunk": st.chunk_seconds, "extract": st.extract_seconds,
                   "score": st.score_seconds, "observe": st.observe_seconds,
                   "delta": st.delta_seconds, "store": st.store_seconds},
         chunks=st.chunks, dup=st.dup_chunks, delta=st.delta_chunks,
         raw=st.raw_chunks, dcr=st.dcr, dcr_reference=REFERENCE_DCR[name],
         init_source=store.detector.model.init_source, restored="sha256-identical",
         launches=per_kernel, wrapper_launches=launches)
    MAIN_COUNTS[name] = (st.chunks, st.dup_chunks, st.delta_chunks, st.raw_chunks)
    if round(st.dcr, 6) != REFERENCE_DCR[name]:
        fail(f"{name}: DCR {st.dcr} is not the reference's {REFERENCE_DCR[name]}")
    if min(per_kernel.values()) <= 0:
        fail(f"{name}: a kernel was never launched on the main path: {per_kernel}")
    if not (st.dcr > 1.0 and st.delta_chunks > 0):
        fail(f"{name}: no delta compression (dcr {st.dcr})")
    return per_kernel


def profile_device(fn) -> tuple[float, float, dict]:
    """(host wall seconds of ``fn``, device seconds, the top device rows in
    ms): kernel and copy time summed by torch.profiler (one stream, so
    device rows never overlap). ``fn`` synchronizes before it returns."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    # device-side rows only (kernels, copies): an operator's row repeats
    # the device time of the kernels it launched
    dev_rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in dev_rows) / 1e6
    if device_s <= 0:
        fail("the profiler recorded no device time")
    top = sorted(dev_rows, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return wall, device_s, {e.key: e.self_device_time_total / 1e3 for e in top}


def device_share(name: str, versions: list[bytes]) -> None:
    """Device busy share of one ingest (the second version of ``name``)."""
    store = DedupStore(card_detector(None), CHUNKER)
    store.fit(versions[:1])
    store.ingest(versions[0])
    store._clock()
    wall, device_s, top = profile_device(lambda: (store.ingest(versions[1]), store._clock()))
    emit("profile", workload=name, base_mib=BASE / 2**20, wall_s=wall,
         device_s=device_s, device_busy_share=device_s / wall, top_device_ms=top)


# --- phase 4b: the paper's baselines beside CARD, through the config path -----

# The JAX package's DCR and (chunks, dup, delta, raw) at this configuration
# (32 MiB x 4 versions, seed 1234, FastCDC avg 8192, default super-feature
# settings), printed on a CPU by scripts/baseline_dcr.py; CARD's is phase
# 4's. The port takes the same chunks and super-features, so the card must
# give the same.
BASELINE_REFERENCE = {
    "sql_dump": {"dedup-only": (2.068891, 14533, 7728, 0, 6805),
                 "finesse": (3.446245, 14533, 7728, 2645, 4160),
                 "n-transform": (3.698334, 14533, 7728, 2938, 3867)},
    "vmdk": {"dedup-only": (3.378073, 9547, 6753, 0, 2794),
             "finesse": (4.590089, 9547, 6753, 711, 2083),
             "n-transform": (3.510103, 9547, 6753, 108, 2686)},
}
BASELINE_DETECTORS = ("dedup-only", "finesse", "n-transform", "card")


def baseline_config(detector: str) -> config.DedupConfig:
    args = {"feat": dataclasses.asdict(FEAT), "model": dataclasses.asdict(MODEL),
            "threshold": 0.3} if detector == "card" else {}
    return config.DedupConfig.from_dict({"detector": detector, "detector_args": args,
                                         "chunker_args": {"avg_size": CHUNKER.avg_size}})


def baselines_phase(dev, name: str, versions: list[bytes]) -> dict[str, int]:
    """Each detector's store, built from its config dict on the card,
    ingests ``versions``; the launch counts are reset before each store and
    read after it. Returns the kernels' launches summed over the stores,
    with kernel A's Rabin route also on its own ("rabin")."""
    total = sum(len(v) for v in versions)
    rows, launches = {}, {"gear_scan": 0, "shingle_embed": 0, "sim_topk": 0, "rabin": 0}
    for det in BASELINE_DETECTORS:
        store = config.build_store(baseline_config(det), device=dev)
        store._clock()
        ops.reset_launches()
        t0 = time.perf_counter()
        store.fit(versions[:1])
        t1 = time.perf_counter()
        for v in versions:
            store.ingest(v)
        t2 = store._clock()
        lc = dict(ops.LAUNCHES)
        for h, v in enumerate(versions):
            if hashlib.sha256(store.restore(h)).digest() != hashlib.sha256(v).digest():
                fail(f"baselines {name} {det}: version {h} did not restore byte-identically")
        st = store.stats
        counts = (st.chunks, st.dup_chunks, st.delta_chunks, st.raw_chunks)
        rows[det] = dict(dcr=st.dcr, ingest_mb_per_s=total / 1e6 / (t2 - t1),
                         detect_s=st.detect_seconds, extract_s=st.extract_seconds,
                         score_s=st.score_seconds, observe_s=st.observe_seconds,
                         delta_s=st.delta_seconds, chunk_s=st.chunk_seconds,
                         extract_s_by_version=[r.extract_seconds for r in store.reports],
                         fit_s=t1 - t0, ingest_s=t2 - t1, counts=list(counts),
                         launches={k: v for k, v in lc.items() if v})
        if det == "card":
            want_dcr = REFERENCE_DCR[name]
            used = [lc["scan_candidates"], lc["shingle_embed"], lc["sim_topk"]]
        else:
            want_dcr, *want_counts = BASELINE_REFERENCE[name][det]
            used = [lc["scan_candidates"]] + ([lc["rabin_fps"]] if det != "dedup-only" else [])
            if list(counts) != want_counts:
                fail(f"baselines {name} {det}: counts {counts} are not the reference's "
                     f"{want_counts}")
        if round(st.dcr, 6) != want_dcr:
            fail(f"baselines {name} {det}: DCR {st.dcr} is not the reference's {want_dcr}")
        if min(used) <= 0:
            fail(f"baselines {name} {det}: a kernel of the path was never launched: {lc}")
        launches["gear_scan"] += lc["scan_candidates"] + lc["gear_hashes"] + lc["rabin_fps"]
        launches["shingle_embed"] += lc["shingle_embed"]
        launches["sim_topk"] += lc["sim_topk"]
        launches["rabin"] += lc["rabin_fps"]
        del store
    card = rows["card"]
    emit("baselines", workload=name, base_mib=BASE / 2**20, versions=len(versions),
         bytes_in=total, detectors=rows, restored="sha256-identical",
         dcr_reference={**{d: r[0] for d, r in BASELINE_REFERENCE[name].items()},
                        "card": REFERENCE_DCR[name]},
         card_dcr_gain={d: card["dcr"] / rows[d]["dcr"] - 1 for d in ("finesse", "n-transform")},
         card_detect_speedup={d: rows[d]["detect_s"] / card["detect_s"]
                              for d in ("finesse", "n-transform")})
    return launches


# --- phase 4c: CARD on the persistent backends, closed and reopened ----------

# The JAX package's DCR, bytes stored and (chunks, dup, delta, raw) for CARD
# on each persistent backend at phase 4's configuration, printed on a CPU by
# scripts/backend_dcr.py. A FileBackend adds its 29-byte RCL2 record header
# to each stored chunk, an ObjectStoreBackend nothing (its DCR is
# REFERENCE_DCR's).
BACKEND_REFERENCE = {
    "sql_dump": {"file": (4.105373, 33687118, 14533, 7728, 6796, 9),
                 "objectstore": (4.129564, 33489773, 14533, 7728, 6796, 9)},
    "vmdk": {"file": (5.66246, 23703078, 9547, 6753, 1704, 1090),
             "objectstore": (5.681883, 23622052, 9547, 6753, 1704, 1090)},
}
BACKEND_KNOBS = {"restore_cache_bytes": 256 << 20, "restore_reader_fds": 4,
                 "restore_readahead": 2}
RANGE_SLICES = 16


def backend_config(backend: str, root: str) -> config.DedupConfig:
    args = {"feat": dataclasses.asdict(FEAT), "model": dataclasses.asdict(MODEL),
            "threshold": 0.3}
    return config.DedupConfig.from_dict({
        "detector": "card", "detector_args": args,
        "chunker_args": {"avg_size": CHUNKER.avg_size}, "backend": backend,
        "backend_args": {"path": root}, **BACKEND_KNOBS,
        **({"verify_reads": True} if backend == "file" else {})})


def card_launches(what: str, need=("gear_scan", "shingle_embed", "sim_topk"),
                  counts: dict[str, int] | None = None) -> dict[str, int]:
    """Kernels A, B and C's launches since the last reset (or in
    ``counts``, wrapper counts of one stretch); fails unless each kernel
    in ``need`` launched."""
    c = ops.LAUNCHES if counts is None else counts
    lc = {"gear_scan": c["scan_candidates"] + c["gear_hashes"],
          "shingle_embed": c["shingle_embed"], "sim_topk": c["sim_topk"]}
    if min(lc[k] for k in need) <= 0:
        fail(f"{what}: a kernel of the path was never launched: {lc}")
    return lc


def restore_all(store, versions: list[bytes], what: str) -> dict:
    """Restore every version, SHA-256 against the input; wall time, MB/s
    and the summed RestoreReport counters."""
    want = [hashlib.sha256(v).digest() for v in versions]
    t0 = time.perf_counter()
    reports = []
    for h, v in enumerate(versions):
        if hashlib.sha256(store.restore(h)).digest() != want[h]:
            fail(f"{what}: version {h} did not restore byte-identically")
        reports.append(store.last_restore)
    seconds = time.perf_counter() - t0
    out = sum(r.bytes_out for r in reports)
    read = sum(r.bytes_read for r in reports)
    last = reports[-1]
    return dict(seconds=seconds, mb_per_s=out / 1e6 / seconds, bytes_out=out, bytes_read=read,
                requests=sum(r.requests for r in reports), read_amplification=read / out,
                cache_hits=sum(r.cache_hits for r in reports),
                cache_misses=sum(r.cache_misses for r in reports),
                last_restore=dict(bytes_read=last.bytes_read, requests=last.requests,
                                  read_amplification=last.read_amplification))


def disk_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)


def backends_phase(dev, name: str, versions: list[bytes]) -> dict[str, int]:
    """Each persistent backend's CARD store, built from its config dict on
    the card: ingest, close, reopen, restore, re-ingest (see the module
    docstring). Launch counts are reset before each ingest and read after
    it; returns them summed."""
    total = sum(len(v) for v in versions)
    launches = {"gear_scan": 0, "shingle_embed": 0, "sim_topk": 0}
    rng = np.random.default_rng(1234)
    for backend in ("file", "objectstore"):
        what = f"backends {name} {backend}"
        root = tempfile.mkdtemp(prefix=f"chip_smoke_{backend}_")
        try:
            t_phase = time.perf_counter()
            cfg = backend_config(backend, root)
            store = config.build_store(cfg, device=dev)
            store._clock()
            ops.reset_launches()
            integrity.reset_crc32c_stats()
            t0 = time.perf_counter()
            store.fit(versions[:1])
            t1 = time.perf_counter()
            for v in versions:
                store.ingest(v)
            t2 = store._clock()
            ingest_lc = card_launches(what)
            crc_ingest = dict(integrity.CRC32C_STATS)
            st = store.stats
            counts = (st.chunks, st.dup_chunks, st.delta_chunks, st.raw_chunks)
            want_dcr, want_stored, *want_counts = BACKEND_REFERENCE[name][backend]
            if round(st.dcr, 6) != want_dcr or st.bytes_stored != want_stored:
                fail(f"{what}: DCR {st.dcr} / {st.bytes_stored} bytes stored are not the "
                     f"reference's {want_dcr} / {want_stored}")
            if list(counts) != want_counts or counts != MAIN_COUNTS[name]:
                fail(f"{what}: counts {counts} are not the reference's {want_counts} "
                     f"and phase 4's {MAIN_COUNTS[name]}")
            ingest = dict(seconds=t2 - t1, mb_per_s=total / 1e6 / (t2 - t1), fit_s=t1 - t0,
                          store_s=st.store_seconds, delta_s=st.delta_seconds,
                          chunk_s=st.chunk_seconds, detect_s=st.detect_seconds)
            store.close()
            on_disk = disk_bytes(root)

            # a fresh store from the same dict on the same directory
            integrity.reset_crc32c_stats()
            t0 = time.perf_counter()
            store = config.build_store(cfg, device=dev)
            open_s = time.perf_counter() - t0
            cold = restore_all(store, versions, f"{what} cold")
            warm = restore_all(store, versions, f"{what} warm")
            crc_restore = dict(integrity.CRC32C_STATS)
            for h, v in enumerate(versions):
                if hashlib.sha256(b"".join(store.restore_iter(h))).digest() != \
                        hashlib.sha256(v).digest():
                    fail(f"{what}: restore_iter of version {h} differs")
                if store.stream_length(h) != len(v):
                    fail(f"{what}: stream_length of version {h} is {store.stream_length(h)}")
            for _ in range(RANGE_SLICES):
                h = int(rng.integers(len(versions)))
                off = int(rng.integers(len(versions[h])))
                ln = int(rng.integers(1, 1 << 21))
                if store.restore_range(h, off, ln) != versions[h][off:off + ln]:
                    fail(f"{what}: restore_range({h}, {off}, {ln}) differs")

            # fit again (the detector index lives in memory) and re-ingest
            reopened_max = store.backend.max_chunk_id()
            before = set(store.backend.chunk_ids())
            store._clock()
            ops.reset_launches()
            store.fit(versions[:1])
            report = store.open_stream()
            report.write(versions[3])
            report = report.commit()
            store._clock()
            # the reopened detector's index is empty while version 3 is
            # scored, under kernel C's gate (512 rows, as the reference's):
            # C serves the 4-version ingests above, not this one
            reingest_lc = card_launches(f"{what} re-ingest", need=("gear_scan", "shingle_embed"))
            added = set(store.backend.chunk_ids()) - before
            if not added or min(added) <= reopened_max or \
                    len(added) != report.delta_chunks + report.raw_chunks:
                fail(f"{what}: the re-ingest stored {len(added)} chunks from id "
                     f"{min(added, default=None)}; the reopened max_chunk_id is {reopened_max}")
            restore_all(store, list(versions) + [versions[3]], f"{what} after re-ingest")

            retries = None
            if backend == "objectstore":
                store.backend._cache.retain(lambda cid: False)     # cold: GETs happen
                store.backend.client.fault_hook = faults.FaultSchedule({"get": [2]})
                if store.restore(1) != versions[1]:
                    fail(f"{what}: version 1 did not restore under a fault schedule")
                retries = store.backend.retries
                if retries <= 0:
                    fail(f"{what}: the fault schedule was never retried")
            store.close()
            for k in launches:
                launches[k] += ingest_lc[k] + reingest_lc[k]
            emit("backends", workload=name, backend=backend, base_mib=BASE / 2**20,
                 versions=len(versions), bytes_in=total, dcr=st.dcr, dcr_reference=want_dcr,
                 bytes_stored=st.bytes_stored, record_overhead=store.backend.record_overhead,
                 counts=list(counts), ingest=ingest, disk_bytes=on_disk, open_s=open_s,
                 cold=cold, warm=warm, restored="sha256-identical",
                 ranges=RANGE_SLICES, reopened_max_chunk_id=reopened_max,
                 reingest=dict(handle=report.handle, new_chunks=len(added),
                               first_new_id=min(added), dcr=report.dcr,
                               seconds=report.chunk_seconds + report.detect_seconds
                               + report.delta_seconds + report.store_seconds),
                 crc32c=dict(route=integrity.crc32c_route(), ingest=crc_ingest,
                             restore=crc_restore),
                 retries=retries, launches={"ingest": ingest_lc, "reingest": reingest_lc},
                 phase_s=time.perf_counter() - t_phase)
            del store
        finally:
            shutil.rmtree(root, ignore_errors=True)
    return launches


# --- phase 4d: space reclamation on the card ----------------------------------

# BENCH_GC's layout: 4 versions, retain the last 2. Each store: (workload,
# backend, policy, policy_args); the threshold store auto-compacts on a
# delete through the policy that build_policy makes from its dict.
LIFECYCLE_STORES = (("sql_dump", "file", "never", {}),
                    ("vmdk", "file", "never", {}),
                    ("sql_dump", "objectstore", "threshold", {"ratio": 0.25}))
LIFECYCLE_DELETED = (0, 1)
LIFECYCLE_CARD = {"feat": {"k": 32, "m": 64, "n": 2},
                  "model": {"m": 64, "d": 50, "steps": 150}, "threshold": 0.3}
# What scripts/lifecycle_dcr.py printed for each store (the JAX package on
# a CPU, the same dicts and steps): the card must give exactly these.
LIFECYCLE_REFERENCE: dict[str, dict] = {
    "sql_dump/file": {
        "ingest": [[3526, 0, 3517, 9, 29084034], [3598, 2537, 1061, 0, 1501879], [3668, 2563,
            1105, 0, 1481104], [3741, 2628, 1113, 0, 1620101]],
        "dcr_before": 4.105373,
        "storage_before": 33863918,
        "deletes": [{"handle": 0, "freed": 8623577, "auto_compacted": False}, {"handle": 1,
            "freed": 6638705, "auto_compacted": False}],
        "collect": {"live_chunks": 4781, "pinned_chunks": 1840, "dead_chunks": 184,
            "live_bytes": 18227491, "pinned_bytes": 14587303, "dead_bytes": 674979,
            "chain_depth_hist": {"0": 5, "1": 24, "2": 85, "3": 216, "4": 405, "5": 667, "6":
            768, "7": 727, "8": 680, "9": 551, "10": 354, "11": 170, "12": 83, "13": 29, "14":
            14, "15": 3}, "reclaimable_bytes": 15262282},
        "compact": {"epoch": 1, "live_chunks": 4781, "swept_chunks": 2024, "swept_bytes":
            15262282, "rebased_delta": 2685, "rebased_raw": 58, "bytes_before": 33863946,
            "bytes_after": 33505924, "reclaimed_bytes": 358022, "skipped": False},
        "storage_after": 33505924,
        "reclaimed_bytes": 358022,
        "dcr_survivors": 2.104645,
        "stats": {"live_bytes": 33276660, "dead_bytes": 0, "chain_depth_hist": {"0": 5, "1": 24,
            "2": 85, "3": 216, "4": 405, "5": 667, "6": 768, "7": 727, "8": 680, "9": 551, "10":
            354, "11": 170, "12": 83, "13": 29, "14": 14, "15": 3}},
        "reingest": [3526, 1829, 0, 1697, 17153424],
        "scrub": [6478, 6478, 50380871, 3],
        "digests": 6478,
        "scrub_reopened": [6478, 6478, 50380871, 3],
        "seeds_admitted": 6478,
        "seeded_ingest": [3741, 3741, 0, 0, 0],
    },
    "vmdk/file": {
        "ingest": [[2370, 0, 1437, 933, 20231553], [2383, 2233, 95, 55, 1233957], [2392, 2251,
            85, 56, 1200529], [2402, 2269, 87, 46, 1037039]],
        "dcr_before": 5.66246,
        "storage_before": 23819992,
        "deletes": [{"handle": 0, "freed": 1216639, "auto_compacted": False}, {"handle": 1,
            "freed": 1094746, "auto_compacted": False}],
        "collect": {"live_chunks": 2526, "pinned_chunks": 115, "dead_chunks": 153, "live_bytes":
            21310667, "pinned_bytes": 929036, "dead_bytes": 1382349, "chain_depth_hist": {"0":
            1004, "1": 310, "2": 306, "3": 258, "4": 229, "5": 170, "6": 115, "7": 49, "8": 29,
            "9": 18, "10": 13, "11": 8, "12": 8, "13": 3, "14": 3, "15": 1, "16": 2},
            "reclaimable_bytes": 2311385},
        "compact": {"epoch": 1, "live_chunks": 2526, "swept_chunks": 268, "swept_bytes":
            2311385, "rebased_delta": 165, "rebased_raw": 33, "bytes_before": 23820020,
            "bytes_after": 21927068, "reclaimed_bytes": 1892952, "skipped": False},
        "storage_after": 21927068,
        "reclaimed_bytes": 1892952,
        "dcr_survivors": 3.060549,
        "stats": {"live_bytes": 21794959, "dead_bytes": 0, "chain_depth_hist": {"0": 1004, "1":
            310, "2": 306, "3": 258, "4": 229, "5": 170, "6": 115, "7": 49, "8": 29, "9": 18,
            "10": 13, "11": 8, "12": 8, "13": 3, "14": 3, "15": 1, "16": 2}},
        "reingest": [2370, 2109, 0, 261, 4184670],
        "scrub": [2787, 2787, 25972060, 3],
        "digests": 2787,
        "scrub_reopened": [2787, 2787, 25972060, 3],
        "seeds_admitted": 2787,
        "seeded_ingest": [2402, 2402, 0, 0, 0],
    },
    "sql_dump/objectstore": {
        "ingest": [[3526, 0, 3517, 9, 28981780], [3598, 2537, 1061, 0, 1471110], [3668, 2563,
            1105, 0, 1449059], [3741, 2628, 1113, 0, 1587824]],
        "dcr_before": 4.129564,
        "storage_before": 33973838,
        "deletes": [{"handle": 0, "freed": 8623577, "auto_compacted": False}, {"handle": 1,
            "freed": 6638705, "auto_compacted": True}],
        "collect": {"live_chunks": 4781, "pinned_chunks": 0, "dead_chunks": 0, "live_bytes":
            33276660, "pinned_bytes": 0, "dead_bytes": 0, "chain_depth_hist": {"0": 63, "1":
            318, "2": 757, "3": 1073, "4": 1063, "5": 805, "6": 448, "7": 192, "8": 51, "9":
            11}, "reclaimable_bytes": 0},
        "compact": {"epoch": 2, "live_chunks": 4781, "swept_chunks": 0, "swept_bytes": 0,
            "rebased_delta": 0, "rebased_raw": 0, "bytes_before": 33585120, "bytes_after":
            33585120, "reclaimed_bytes": 0, "skipped": False},
        "storage_after": 33585120,
        "reclaimed_bytes": 388748,
        "dcr_survivors": 2.099682,
        "stats": {"live_bytes": 33276660, "dead_bytes": 0, "chain_depth_hist": {"0": 63, "1":
            318, "2": 757, "3": 1073, "4": 1063, "5": 805, "6": 448, "7": 192, "8": 51, "9":
            11}},
        "reingest": [3526, 1829, 0, 1697, 17104211],
        "scrub": [6478, 6478, 50380871, 3],
        "digests": 6478,
        "scrub_reopened": [6478, 6478, 50380871, 3],
        "seeds_admitted": 6478,
        "seeded_ingest": [3741, 3741, 0, 0, 0],
    },
}
# The compaction crashpoint the crash drill fires on each backend.
CRASH_POINTS = {"file": "file.compact.recipes_renamed",
                "objectstore": "objstore.compact.manifest_flipped"}


def lifecycle_dict(backend: str, policy: str, policy_args: dict, root: str) -> dict:
    return {"detector": "card", "detector_args": LIFECYCLE_CARD,
            "chunker_args": {"avg_size": 8192}, "backend": backend,
            "backend_args": {"path": root}, "policy": policy, "policy_args": policy_args,
            **({"verify_reads": True} if backend == "file" else {})}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"lifecycle: {msg}")


class _Timed:
    """Wraps one method of an object and sums the seconds spent in it."""

    def __init__(self, obj, name: str) -> None:
        self.seconds = 0.0
        real = getattr(obj, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0

        setattr(obj, name, timed)


def lifecycle_steps(build, d: dict, versions: list[bytes], mark=lambda label: None
                    ) -> tuple[dict, dict]:
    """Phase 4d's steps on one store. ``build(d)`` makes a store from a
    config dict: the port's on the card here, the JAX package's in
    scripts/lifecycle_dcr.py, which calls this very function. Fit on
    version 0 and ingest every version; delete versions 0 and 1 (each
    deleted handle must raise KeyError); collect, compact; re-ingest
    version 0 (its chunks swept, its digests dropped, the detector index
    still holding their rows); restore every live stream SHA-identically;
    scrub clean with every record verified; take the digest seeds and
    close; reopen, scrub clean again, restore again; seed the digests,
    fit, and ingest version 3 again, which must store no new chunk.
    ``mark(label)`` is called around the re-ingest (the card run counts
    its launches there). Returns (pinned, measured): the numbers the JAX
    package must share, and the timings plus a plain recount of the live
    chunks' chain depths, walked on the backend's records."""
    sha = hashlib.sha256
    pinned: dict = {}
    measured: dict = {}

    def counts(r):
        return [r.chunks, r.dup_chunks, r.delta_chunks, r.raw_chunks, r.bytes_stored]

    def restore_live(store, handles, what):
        t0 = time.perf_counter()
        out = 0
        for h in handles:
            want = versions[0] if h == len(versions) else versions[h]
            got = store.restore(h)
            _require(sha(got).digest() == sha(want).digest(),
                     f"{what}: stream {h} did not restore byte-identically")
            out += len(got)
        return out / 1e6 / (time.perf_counter() - t0)

    def scrub(store, what):
        t0 = time.perf_counter()
        rep = store.scrub()
        seconds = time.perf_counter() - t0
        records = len(store.backend.chunk_ids())
        _require(rep.clean and rep.verified == records == rep.chunks,
                 f"{what}: scrub not clean or not fully verified: {rep}")
        return [rep.chunks, rep.verified, rep.bytes_checked, rep.streams], seconds

    store = build(d)
    rewrite = _Timed(store.backend, "rewrite_live")
    store.fit(versions[:1])
    t0 = time.perf_counter()
    for v in versions:
        store.ingest(v)
    measured["ingest_s"] = time.perf_counter() - t0
    pinned["ingest"] = [counts(r) for r in store.reports]
    pinned["dcr_before"] = round(store.stats.dcr, 6)
    pinned["storage_before"] = store.backend.storage_bytes()

    deletes, measured["delete_s"] = [], []
    for h in LIFECYCLE_DELETED:
        epoch = store.backend.epoch
        t0 = time.perf_counter()
        freed = store.delete(h)
        measured["delete_s"].append(time.perf_counter() - t0)
        deletes.append({"handle": h, "freed": freed,
                        "auto_compacted": store.backend.epoch != epoch})
        try:
            store.restore(h)
        except KeyError:
            pass
        else:
            _require(False, f"deleted handle {h} still restores")
    pinned["deletes"] = deletes
    t0 = time.perf_counter()
    report = store.collect()
    measured["collect_s"] = time.perf_counter() - t0
    pinned["collect"] = {**dataclasses.asdict(report),
                         "reclaimable_bytes": report.reclaimable_bytes}
    measured["depth_hist_recount"] = depth_recount(store.backend)
    auto_rewrite_s = rewrite.seconds
    t0 = time.perf_counter()
    run = store.compact()
    compact_s = time.perf_counter() - t0
    measured["compact_s"] = {"total": compact_s,
                             "rewrite": rewrite.seconds - auto_rewrite_s,
                             "sizing_and_rebind": compact_s - rewrite.seconds + auto_rewrite_s,
                             "in_deletes": auto_rewrite_s}
    pinned["compact"] = {k: v for k, v in dataclasses.asdict(run).items() if k != "seconds"}
    storage_after = store.backend.storage_bytes()
    live = [h for h in range(len(versions)) if h not in LIFECYCLE_DELETED]
    pinned["storage_after"] = storage_after
    pinned["reclaimed_bytes"] = store.stats.reclaimed_bytes
    pinned["dcr_survivors"] = round(sum(len(versions[h]) for h in live) / storage_after, 6)
    pinned["stats"] = {"live_bytes": store.stats.live_bytes,
                       "dead_bytes": store.stats.dead_bytes,
                       "chain_depth_hist": store.stats.chain_depth_hist}

    mark("reingest")
    again = store.open_stream()
    again.write(versions[0])
    again = again.commit()
    mark("reingest done")
    pinned["reingest"] = counts(again)
    live.append(again.handle)
    measured["restore_mb_per_s"] = restore_live(store, live, "after compaction")
    pinned["scrub"], measured["scrub_s"] = scrub(store, "after compaction")
    seeds = store.digest_seeds()
    pinned["digests"] = len(seeds)
    store.close()

    store = build(d)
    pinned["scrub_reopened"], measured["scrub_reopened_s"] = scrub(store, "reopened")
    measured["restore_reopened_mb_per_s"] = restore_live(store, live, "reopened")
    pinned["seeds_admitted"] = store.seed_digests(seeds)
    store.fit(versions[:1])
    before = set(store.backend.chunk_ids())
    seeded = store.open_stream()
    seeded.write(versions[3])
    seeded = seeded.commit()
    _require(set(store.backend.chunk_ids()) == before and seeded.dup_chunks == seeded.chunks,
             f"the seeded ingest stored new chunks: {counts(seeded)}")
    pinned["seeded_ingest"] = counts(seeded)
    store.close()
    return pinned, measured


def depth_recount(backend) -> dict[int, int]:
    """{delta-chain depth: live chunks}, by walking ``base_of`` from every
    chunk a live recipe names (independent of the refcount table)."""
    live = {c for h in backend.live_handles() for c in backend.recipe(h)}
    hist: dict[int, int] = {}
    for cid in live:
        depth, cur = 0, backend.base_of(cid)
        while cur >= 0:
            depth, cur = depth + 1, backend.base_of(cur)
        hist[depth] = hist.get(depth, 0) + 1
    return hist


def check_lifecycle(what: str, pinned: dict, recount: dict, want: dict) -> dict:
    """Every pinned number must equal the JAX package's. The live chain-depth
    histogram (CollectReport and StoreStats) must equal a plain recount on
    the card's own records and hold the reference's number of live
    chunks; its split by depth follows the ingest's verdicts, which on
    the card may take the other side of a near-tie (ROADMAP Queue 3), so
    it is reported against the reference's, by depth. Returns that
    difference (empty where it is the reference's)."""
    got = json.loads(json.dumps(pinned))
    want = json.loads(json.dumps(want))
    hists = {k: (got[k].pop("chain_depth_hist"), want[k].pop("chain_depth_hist"))
             for k in ("collect", "stats")}
    if got != want:
        diff = {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                if got.get(k) != want.get(k)}
        fail(f"{what}: not the reference's numbers: {diff}")
    recount = json.loads(json.dumps(recount))
    if hists["collect"][0] != recount:
        fail(f"{what}: the depth histogram {hists['collect'][0]} is not the recount {recount}")
    for k, (g, w) in hists.items():
        if sum(g.values()) != sum(w.values()):
            fail(f"{what}: {k} depth histogram counts {sum(g.values())} live chunks, "
                 f"the reference's {sum(w.values())}")
    g, w = hists["collect"]
    return {d: g.get(d, 0) - w.get(d, 0) for d in sorted(set(g) | set(w), key=int)
            if g.get(d, 0) != w.get(d, 0)}


def lifecycle_phase(dev, main_versions: dict[str, list[bytes]]) -> dict[str, int]:
    """Phase 4d on each store of LIFECYCLE_STORES, then the crash drill;
    launch counts are reset before each store and read after it."""
    launches = {"gear_scan": 0, "shingle_embed": 0, "sim_topk": 0}
    for name, backend, policy, policy_args in LIFECYCLE_STORES:
        what = f"lifecycle {name} {backend}"
        versions = main_versions[name]
        root = tempfile.mkdtemp(prefix=f"chip_smoke_gc_{backend}_")
        marks: dict[str, dict] = {}

        def mark(label: str) -> None:
            torch.cuda.synchronize(dev)
            marks[label] = dict(ops.LAUNCHES)

        try:
            t_phase = time.perf_counter()
            integrity.reset_crc32c_stats()
            ops.reset_launches()
            pinned, measured = lifecycle_steps(
                lambda d: config.build_store(config.DedupConfig.from_dict(d), device=dev),
                lifecycle_dict(backend, policy, policy_args, root), versions, mark)
            torch.cuda.synchronize(dev)
            total_lc = card_launches(what)
            reingest_lc = card_launches(
                f"{what} post-compaction re-ingest",
                counts={k: marks["reingest done"][k] - marks["reingest"][k]
                        for k in marks["reingest"]})
            hist_diff = check_lifecycle(what, pinned, measured.pop("depth_hist_recount"),
                                        LIFECYCLE_REFERENCE[f"{name}/{backend}"])
            for k in launches:
                launches[k] += total_lc[k]
            c, run = pinned["collect"], pinned["compact"]
            emit("lifecycle", workload=name, backend=backend, policy=policy,
                 policy_args=policy_args, base_mib=BASE / 2**20, versions=len(versions),
                 deleted=list(LIFECYCLE_DELETED), dcr_before=pinned["dcr_before"],
                 dcr_survivors_after=pinned["dcr_survivors"],
                 reclaimable_bytes=c["reclaimable_bytes"],
                 reclaimed_bytes=pinned["reclaimed_bytes"],
                 rebase={"delta": run["rebased_delta"], "raw": run["rebased_raw"]},
                 deletes=pinned["deletes"], collect=c, compact=run,
                 storage_bytes={"before": pinned["storage_before"],
                                "after": pinned["storage_after"]},
                 reingest=pinned["reingest"], seeded_ingest=pinned["seeded_ingest"],
                 seeds_admitted=pinned["seeds_admitted"], scrub=pinned["scrub"],
                 pinned="the JAX package's", depth_hist_vs_reference=hist_diff,
                 restored="sha256-identical",
                 seconds=measured, crc32c=dict(route=integrity.crc32c_route(),
                                               **integrity.CRC32C_STATS),
                 launches={"store": total_lc, "reingest": reingest_lc},
                 phase_s=time.perf_counter() - t_phase)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    crash_drill(dev)
    return launches


def crash_drill(dev) -> None:
    """The crash-matrix script (two ingests of about 120 KB, a delete,
    collect, compact, a third ingest, flush) on the card, crashed at one
    compaction crashpoint a backend; the directory is copied as a kill -9
    left it and reopened, and the post-crash contract must hold."""
    registered = faults.registered_crashpoints()
    rng = np.random.default_rng(1)
    d1 = rng.integers(0, 256, 120_000, np.uint8).tobytes()
    d2 = d1[:60_000] + np.random.default_rng(2).integers(0, 256, 20_000, np.uint8).tobytes() \
        + d1[60_000:]
    d3 = np.random.default_rng(3).integers(0, 256, 90_000, np.uint8).tobytes()
    script = [("ingest", "a", d1), ("ingest", "b", d2), ("delete", "a"), ("collect",),
              ("compact",), ("ingest", "c", d3), ("flush",)]
    for backend, point in CRASH_POINTS.items():
        if point not in registered:
            fail(f"crash drill: {point} is not a registered crashpoint")
        tmp = tempfile.mkdtemp(prefix="chip_smoke_crash_")
        try:
            t0 = time.perf_counter()
            root, snap = os.path.join(tmp, "store"), os.path.join(tmp, "snap")
            inj = faults.FaultInjector()
            d = lifecycle_dict(backend, "never", {}, root)
            d["backend_args"]["faults"] = inj
            store = config.build_store(config.DedupConfig.from_dict(d), device=dev)
            store.fit([d1])
            inj.arm(point, 1)
            run = faults.run_crash_script(store, script)
            faults.snapshot_dir(root, snap)
            faults.abandon(store)
            if run.crashed_at != point:
                fail(f"crash drill: the script crashed at {run.crashed_at}, not {point}")
            reopened = config.build_store(config.DedupConfig.from_dict(
                lifecycle_dict(backend, "never", {}, snap)), device=dev)
            errors = faults.check_crash_invariants(reopened, run)
            reopened.close()
            if errors:
                fail(f"crash drill at {point}: {errors}")
            emit("lifecycle_crash", backend=backend, point=point, crashed_at=run.crashed_at,
                 committed={k: h for k, (h, _) in run.committed.items()},
                 deleted=sorted(run.deleted), pending=run.pending and run.pending[:2],
                 violations=errors, seconds=time.perf_counter() - t0)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


# --- phases 5 and 6: the card's fit, then card / CPU parity ------------------

def record_verdicts(det) -> list:
    seen = []
    score = det.score

    def recording(feats, batch):
        res = score(feats, batch)
        seen.append(res.base_ids.copy())
        return res

    det.score = recording
    return seen


def fit_phase(versions: list[bytes]) -> tuple[DedupStore, DedupStore]:
    """The card's fit (cuBLAS steps, cuSOLVER pinv) against the CPU's from
    the same seeded init and the same batch indices: per-step loss within
    1e-4 relative (as the CPU port is held against JAX), and the two
    transforms of one feature batch within 1e-4. Returns the fitted CPU
    and card stores."""
    cpu = DedupStore(card_detector("cpu"), CHUNKER, device="cpu")
    gpu = DedupStore(card_detector(None), CHUNKER)
    if not torch.equal(gpu.detector.model.w.detach().cpu(), cpu.detector.model.w.detach()):
        fail("card and CPU context models start from different params")
    cpu.fit(versions[:1])
    gpu.fit(versions[:1])
    lc = np.asarray(cpu.detector.model.losses)
    lg = np.asarray(gpu.detector.model.losses)
    if len(lg) != len(lc):
        fail(f"card fit ran {len(lg)} steps, CPU fit {len(lc)}")
    loss_err = float(np.max(np.abs(lg - lc) / np.abs(lc)))
    chunks, h = chunk_with(CHUNKER, versions[1], "cpu")
    feats = cpu.detector._initial_features(chunks, h)
    want = cpu.detector.model.transform(feats)
    got = gpu.detector.model.transform(feats.to(gpu.device)).cpu()
    tf_err = float((got - want).abs().max())
    emit("fit", workload="kernel", steps=len(lc), loss_first=float(lc[0]),
         loss_last=float(lc[-1]), loss_max_rel_err=loss_err, rows=feats.shape[0],
         transform_max_abs_err=tf_err, tol=1e-4)
    if loss_err > 1e-4:
        fail(f"card fit losses != CPU fit (max rel err {loss_err})")
    if tf_err > 1e-4:
        fail(f"card fit transform != CPU fit (max abs err {tf_err})")
    return cpu, gpu


def parity_phase(cpu: DedupStore, gpu: DedupStore, versions: list[bytes]) -> None:
    """The port on the card and on the CPU, under one context model (the
    CPU's, carried to the card): identical verdicts, records, per-stream
    counts and DCR, and byte-identical restores."""
    gpu.detector.model = convert.context_model_from_params(
        cpu.detector.model.w.detach().numpy(), cpu.detector.model.u.detach().numpy(),
        MODEL, device=gpu.device)
    v_cpu, v_gpu = record_verdicts(cpu.detector), record_verdicts(gpu.detector)
    for v in versions:
        cpu.ingest(v)
        gpu.ingest(v)
    same_verdicts = (len(v_cpu) == len(v_gpu)
                     and all(np.array_equal(a, b) for a, b in zip(v_cpu, v_gpu)))
    same_records = (sorted(cpu.backend.chunk_ids()) == sorted(gpu.backend.chunk_ids())
                    and all(cpu.backend.record(c) == gpu.backend.record(c)
                            for c in cpu.backend.chunk_ids()))
    key = lambda r: (r.chunks, r.dup_chunks, r.delta_chunks, r.raw_chunks, r.bytes_stored)
    same_reports = [key(r) for r in cpu.reports] == [key(r) for r in gpu.reports]
    restored = all(gpu.restore(h) == v for h, v in enumerate(versions))
    emit("parity", workload="kernel", base_mib=1, versions=len(versions),
         verdicts_identical=same_verdicts, records_identical=same_records,
         reports_identical=same_reports, dcr_cpu=cpu.stats.dcr,
         dcr_gpu=gpu.stats.dcr, restored=restored)
    if not (same_verdicts and same_records and same_reports and restored
            and cpu.stats.dcr == gpu.stats.dcr):
        fail("card and CPU runs of the port differ")
    tf32_phase(gpu, versions, v_gpu)


def tf32_phase(gpu: DedupStore, versions: list[bytes], want: list) -> None:
    """The same ingest on the card, under the same model, with TF32 turned
    on globally: the verdicts must not move (the verdict products pin full
    fp32, core/similarity.exact_matmul). TF32 is off again afterwards."""
    store = DedupStore(card_detector(None), CHUNKER)
    store.detector.model = gpu.detector.model
    store.detector.lmax_floor = gpu.detector.lmax_floor
    got = record_verdicts(store.detector)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for v in versions:
            store.ingest(v)
        still_on = torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    same = len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
    emit("tf32", workload="kernel", versions=len(versions), verdicts_identical=same,
         tf32_still_on_after=still_on, dcr=store.stats.dcr)
    if not (same and still_on):
        fail("verdicts with TF32 on differ from those with it off, or the flag was not restored")


# --- phase 7: the LM slice ------------------------------------------------------

# prefill_32k's length (configs/base.py LM_SHAPES), cut from global batch
# 32 to one prompt on one card; the serving batch; the parity run
PREFILL_LEN = 32_768
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 64, 64
PROFILE_PROMPT, PROFILE_GEN = 8, 16
PARITY_LAYERS, PARITY_LEN, PARITY_TOL = 4, 256, 1e-3


def timed_prefill(model, tokens) -> tuple[torch.Tensor, float, dict[str, float]]:
    """(last logits, wall seconds, ms inside kernel D by route: CUDA events
    around each launch of whichever kernel the prefill takes)."""
    events = {"sm90": [], "simt": []}
    real = {"sm90": flash_attn.flash_attention_sm90_cuda, "simt": flash_attn.flash_attention_cuda}

    def timed(route):
        def launch(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real[route](*args)
            end.record()
            events[route].append((start, end))
            return out
        return launch

    flash_attn.flash_attention_sm90_cuda = timed("sm90")
    flash_attn.flash_attention_cuda = timed("simt")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model.prefill(tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        flash_attn.flash_attention_sm90_cuda = real["sm90"]
        flash_attn.flash_attention_cuda = real["simt"]
    return logits, wall, {r: sum(s.elapsed_time(e) for s, e in ev) for r, ev in events.items()}


def lm_phase(dev) -> int:
    """granite-8b at full width and depth; returns kernel D's launches in
    the 32k prefill (the slice's main path), all on the tensor cores."""
    cfg = LM
    gen = torch.Generator(device=dev).manual_seed(3)
    t0 = time.perf_counter()
    model = make_model(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    model.prefill(torch.randint(0, cfg.vocab_size, (1, 512), device=dev, generator=gen))

    tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_LEN), device=dev, generator=gen)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    logits, wall, attn_ms = timed_prefill(model, tokens)
    launches = ops.LAUNCHES["flash_attention"]
    sm90_launches = ops.LAUNCHES["flash_attention_sm90"]
    peak = torch.cuda.max_memory_allocated(dev)
    if tuple(logits.shape) != (1, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        fail(f"prefill logits are not finite [1, {cfg.vocab_size}]")
    total_ms = sum(attn_ms.values())
    emit("lm", part="prefill", arch=cfg.name, params=n_params, dtype=cfg.dtype,
         tokens=PREFILL_LEN, init_s=init_s, seconds=wall, tokens_per_s=PREFILL_LEN / wall,
         flash_attention_launches=launches, flash_attention_sm90_launches=sm90_launches,
         flash_attention_ms=total_ms, flash_attention_ms_by_route=attn_ms,
         flash_attention_share=total_ms / 1e3 / wall, peak_bytes=peak,
         logits_abs_max=float(logits.float().abs().max()))
    if launches != cfg.num_layers or sm90_launches != cfg.num_layers:
        fail(f"prefill launched kernel D {launches} times, {sm90_launches} on the tensor "
             f"cores; want all {cfg.num_layers} on the tensor cores")

    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), device=dev,
                            generator=gen)
    out, prefill_s, decode_s = serve.serve_loop(model, prompts, SERVE_GEN)
    emit("lm", part="serve", batch=SERVE_BATCH, prompt=SERVE_PROMPT, gen=SERVE_GEN,
         prefill_s=prefill_s, decode_s=decode_s,
         prefill_tokens_per_s=SERVE_BATCH * SERVE_PROMPT / prefill_s,
         decode_tokens_per_s=SERVE_BATCH * SERVE_GEN / decode_s,
         first_tokens=out[:, :8].tolist())
    if out.shape != (SERVE_BATCH, SERVE_GEN) or not ((out >= 0) & (out < cfg.vocab_size)).all():
        fail(f"serve_loop gave tokens of shape {out.shape} or outside the vocabulary")
    # where a decode step's time goes: a short profiled serve_loop (the
    # profiler adds host time; the device time per step is its own)
    steps = PROFILE_PROMPT + PROFILE_GEN
    wall, device_s, top = profile_device(
        lambda: serve.serve_loop(model, prompts[:, :PROFILE_PROMPT], PROFILE_GEN))
    emit("lm", part="decode_profile", batch=SERVE_BATCH, steps=steps, wall_s=wall,
         device_s=device_s, device_busy_share=device_s / wall,
         device_ms_per_step=device_s / steps * 1e3,
         unprofiled_ms_per_step=decode_s / SERVE_GEN * 1e3, top_device_ms=top)
    del model, logits
    torch.cuda.empty_cache()

    # the card's version of tests/test_archs_smoke.py:108: kernel D's path
    # against the dense cached path, full width, depth cut, f32, TF32 off
    small = dataclasses.replace(cfg, num_layers=PARITY_LAYERS, dtype="float32")
    model = make_model(small, seed=1)
    tokens = torch.randint(0, cfg.vocab_size, (1, PARITY_LEN), device=dev, generator=gen)
    pre = model.prefill(tokens)
    cache = model.init_cache(1, PARITY_LEN)
    for i in range(PARITY_LEN):
        step, cache = model.decode_step(tokens[:, i:i + 1], cache)
    err = float((pre - step).abs().max())
    emit("lm", part="parity", layers=PARITY_LAYERS, tokens=PARITY_LEN, dtype="float32",
         max_abs_err=err, logits_abs_max=float(step.abs().max()), tol=PARITY_TOL)
    if not torch.allclose(pre, step, rtol=PARITY_TOL, atol=PARITY_TOL):
        fail(f"prefill (kernel D) != token-by-token decode (max abs err {err})")
    del model
    torch.cuda.empty_cache()
    return launches


# stream bytes per version, versions, and the largest index kernel C scans
BASE, VERSIONS, BIG_N = 32 << 20, 4, 1 << 20


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())

    smi = nvidia_smi()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmul is enabled")
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(dev),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    log = _build.build_info.get("ptxas", "")
    sass = sass_counts(_build.build_info["path"])
    emit("build", seconds=build_s, cached=_build.build_info["cached"],
         path=_build.build_info["path"], ptxas=ptxas_summary(log),
         ptxas_warnings=[ln.strip() for ln in log.splitlines() if "C7512" in ln],
         flash_sass={k: v for k, v in sass.items() if "flash_attn" in k},
         topk_sass={k: v for k, v in sass.items() if "sim_topk" in k})
    hgmma = [c["HGMMA"] for name, c in sass.items() if "sm90" in name]
    if not hgmma or min(hgmma) == 0:
        fail(f"the tensor-core flash kernel holds no HGMMA: {sass}")

    main_versions = {name: workloads.make_workload(
        name, workloads.WorkloadConfig(base_size=BASE, versions=VERSIONS))
        for name in ("sql_dump", "vmdk")}
    # the main path scans each stream at its length rounded up to 128
    # (kernels/ingest.scan_length); before, at its pow2 bucket (64 MiB)
    scan_n = max(ingest.scan_length(len(v)) for versions in main_versions.values()
                 for v in versions)
    bucket_n = max(features.bucket_pow2(len(v)) for versions in main_versions.values()
                   for v in versions)

    gen = torch.Generator(device=dev).manual_seed(0)
    rabin = check_rabin(dev, main_versions["sql_dump"][1])
    rows = [check_gear(dev, sorted({1, 31, 33, 100, 8193, BASE, scan_n, bucket_n}), gen,
                       scan_n, bucket_n),
            check_embed(dev, gen, real_extract(dev, main_versions["sql_dump"][1])),
            check_topk(dev, gen, BIG_N),
            check_attn(dev, gen, PREFILL_LEN)]

    rows[0]["rabin_packed"] = rabin

    launches = {"gear_scan": 0, "shingle_embed": 0, "sim_topk": 0, "rabin": 0}
    for name, versions in main_versions.items():
        for k, v in main_path(name, versions).items():
            launches[k] += v
        device_share(name, versions[:2])
    for name, versions in main_versions.items():
        for k, v in baselines_phase(dev, name, versions).items():
            launches[k] += v
    for name, versions in main_versions.items():
        for k, v in backends_phase(dev, name, versions).items():
            launches[k] += v
    for k, v in lifecycle_phase(dev, main_versions).items():
        launches[k] += v
    small = workloads.make_workload(
        "kernel", workloads.WorkloadConfig(base_size=1 << 20, versions=3))
    parity_phase(*fit_phase(small), small)
    del main_versions, small
    gc.collect()
    torch.cuda.empty_cache()
    launches["flash_attention"] = lm_phase(dev)

    sources = {"gear_scan": gear_hash, "shingle_embed": shingle_embed, "sim_topk": sim_topk,
               "flash_attention": flash_attn}
    for row in rows:
        mod = sources[row["name"]]
        row.update(route="cuda", source=mod.SOURCE, replaces=mod.REPLACES,
                   launches=launches[row["name"]])
    rows[0]["rabin_launches"] = launches["rabin"]
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
