#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of CARD on one NVIDIA card.

    python3 chip_smoke.py [--phases mesh,mesh_serve]

With no argument every phase runs (the kernels line needs them all);
``--phases`` picks some of PHASES (device and build always run; the
kernels line is left out and the last line names the phases run).

Phases 4-6 (the CARD phases after the kernel checks, and the context
model's parity) run in a second process (``--card-child``, its lines
relayed here) beside phases 7-12 in this one: they are host-bound with
a light card, the LM phases card-bound. The two processes share the card
and the host's cores, and how far they overlap differs from run to run,
so the times of phases 4-12 are not comparable with a run that takes the
phases one after another (``--phases`` with the phases of one process
alone); the kernel checks' times are taken alone.

Phases, one JSON line each (phases 3b, 7 and 7b are the LM slice):
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
              fused, and with normalize=False, which stops after the
              mean) at [4096, 61], M 64 and on a real sql_dump extract,
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
              the plain version, SDPA and the bound; then one line an
              arch whose heads differ from granite's (phi3-medium 40 / 10,
              chatglm3 32 / 2, qwen3-moe 32 / 4 at hd 64), at the same
              length, held to the bf16 tolerance and timed the same way;
              then one line a shape of the cross-attention and encoder
              paths (llama-3.2-vision-11b's cross, 32,768 x 1601 at 32 / 8,
              hd 128; whisper-base's causal 32,768 x 32,768, its cross
              32,768 x 1500 and its encoder's 1500 x 1500 at 8 / 8, hd 64;
              the cross of a decode step at batch 4, Tq 1, for each),
              checked on both routes and timed the same way, non-causal
              where the path is;
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
              amplification, bytes on disk, the crc32c route and its seconds.
              Then "s3": CARD over S3ObjectClient on an in-process fake of
              the boto3 surface (StubS3): fit, ingest (DCR, bytes stored and
              counts the "objectstore" run's, A, B and C launched), close, a
              second store on the same bucket restores every version
              SHA-256-identically;
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
  4e. serve  the multi-tenant server on the card: one DedupServer built
              from a config dict (``config.build_server``: CARD on
              "objectstore", 4 workers, tenant limits, a JSONL trace and a
              4096-span ring), fit on sql_dump version 0; tenants "sql" and
              "vm" ingest their workload's 4 versions interleaved, one
              request at a time (kernels A, B and C launch from the
              server's worker threads); every restore at once plus a range
              a tenant (SHA-256-identical), a foreign handle (KeyError), a
              quota shed and an overload shed (typed, the store
              untouched), the deletes of each tenant's version 0; then the
              registry after close() (the Prometheus text through the
              port's strict parser: family and label set, the non-timing
              values, the histogram counts), the trace's spans and its
              ``observe dump``; a breaker drill on a small dedup-only store
              (open, writes shed, half-open, closed); and the object-store
              CLI in process (``cp`` into a CARD root and a Finesse root, a
              second ``cp`` into the CARD root, ``ls``, ``stat``,
              ``verify``, ``scrub``, a copy back out). Every count, charge,
              DCR, metric value, span count, transition and catalog entry
              is pinned to the JAX package's (scripts/serve_dcr.py runs the
              same steps). One JSON line: per-tenant ingest MB/s, stage
              sums from the registry, concurrent restore MB/s, sheds, CLI
              seconds by subcommand, launches, the phase's seconds;
  4f. features  CARD with each other feature path and index, from dicts
              on the card over phase 4's data: the per-chunk path
              ("fused": False), the poly sub-chunk LSH (feat "lsh":
              "poly") and the banded index ("index": "banded-lsh", 16
              bands of 6 bits): DCR and counts pinned to the JAX
              package's (scripts/feature_paths_dcr.py; the unfused store's
              also to phase 4's), every restore SHA-256-identical, A, B
              and C launched (C never beside the banded index); one JSON
              line a workload with ingest MB/s and extract seconds, fused
              (phase 4) against unfused. Then ("kernel" line
              "gear_packed") the per-chunk path's gear route on sql_dump
              version 1 given as chunks without a scan: kernel A over the
              chunks packed end to end, bit-exact against the plain
              version on every chunk past its 31-byte warm-up, its
              features within 3e-7 of the fused path's, timed;
  4g. checkpoint  DedupCheckpointStore on the card: bench_ckpt_store's
              tree (4 MiB a step, from numpy) over 4 drifted steps at
              sigma 1e-3, 1e-4 and 1e-5, byte planes on and off, and one
              store at 16x the leaf sizes (64 MiB a step, sigma 1e-4):
              DCR and counts pinned to scripts/ckpt_dcr.py, every step
              restored onto the card value-exact, A and B launched in
              each store and C in the 64 MiB one; then a CUDA state dict
              through the plain checkpoint store (save, a .tmp directory
              latest_step must not report, restore onto the card);
  5. fit      the card's context-model fit against a CPU fit from the
              same init and batch stream (per-step loss, transform);
  6. parity   the port on the card and on the CPU over kernel-workload
              streams, under one model: identical verdicts, records,
              per-stream counts and DCR; then ("tf32") the same ingest on
              the card with TF32 turned on: identical verdicts;
  7. lm       granite-8b at full width and depth in bf16 (seeded random
              weights): a 32,768-token Model.prefill through kernel D
              (36 launches, all on the tensor cores; kernel time, peak
              memory); serve_loop at batch 4, prompt 16, 16 new tokens,
              and a profiled short serve_loop for decode's device busy
              share; and, at depth 4 in f32, prefill's last logits against
              token-by-token decode_step;
  7b. lm_families  granite-3-8b, phi3-medium-14b, chatglm3-6b,
              qwen3-moe-30b-a3b and mamba2-130m at full width and depth,
              and jamba-v0.1-52b at full width and one block period (8 of
              its 32 layers: 103 GB in bf16 do not fit one card), in bf16
              (seeded random weights), one at a time, each freed before
              the next: a 32,768-token prefill, every attention sublayer
              through kernel D (one launch each, all on the tensor cores:
              none for mamba2, one for jamba) and every SSM sublayer
              through the chunked SSD (seconds, tokens/s, D's time, peak
              memory with the weights, for MoE the share of routing
              assignments capacity dropped); mamba2 also at long_500k's
              524,288 tokens; qwen3-moe, mamba2 and jamba also a profiled
              prefill and serve_loop at batch 4, prompt 16, 16 new tokens
              (tokens/s, drops in the prompt steps and in generation);
              then, for those six and grok-1, f32 parity at the arch's
              full head and SSM layout with depth 4 (jamba: one period of
              8), d_ff 512, vocabulary 4096 and at most 16 experts, over
              256 tokens (mamba2 and jamba 300: past one SSD chunk): the
              card's prefill against the CPU's on the same weights within
              1e-3, differing routing decisions counted, each a near tie
              (margin < 1e-6); all but qwen3-moe and grok-1 also against
              the card's token-by-token decode (jamba at a capacity that
              drops nothing); llama-3.2-vision-11b and whisper-base at full
              size with seeded random extras (images [1, 1601, 4096],
              frames [1, 1500, 512]): a 32,768-token prefill (48 and 18
              launches of D, all on the tensor cores: self, cross and
              encoder sublayers), serve_loop at batch 4, prompt 16, 16 new
              tokens with images or the encoder's output as memory (8 and
              6 launches a step), a step with the extras as f32 host
              tensors equal to the step with them on the card, and
              serve_loop without extras raising KeyError as the
              reference's does; their f32 parity (the VLM at one block
              period of 5 with 1601 image tokens, whisper at full size),
              prefill against own decode with the same extras within
              1e-4;
  8. train   single-device training (``Model.loss``, the reference's
              AdamW, ``train.step``, the token pipeline): kernel D's
              gradient (its forward on each route, the backward in torch
              ops) against autograd through ``layers._dense_attention`` at
              granite-8b's and whisper-base's train shapes, f32 within
              1e-4 of the largest value and bf16 within one rounding step
              more; one f32 train step of granite-8b, whisper-base and
              mamba2-130m (their head and SSM layouts at 2 layers) on the
              card against the CPU at 1 and 2 microbatches: loss, nll,
              aux, grad_norm, updated params and moments, every parameter's
              gradient nonzero, kernel D launched twice an attention
              sublayer (remat); then bf16 at full width with remat on, 3
              steps of train_4k's 4096 tokens from the token pipeline:
              granite-8b at 8 of its 36 layers, whisper-base and
              mamba2-130m at full size (step seconds, tokens/s, peak,
              kernel D's launches a step, each loss; gates: finite loss,
              params moved, every gradient nonzero, peak under 72 GB);
              and kernel D at granite's train shape timed beside SDPA,
              with the gradient's torch ops beside SDPA's backward. Also
              int8 gradient compression (``distributed.compress``): 5
              error-feedback steps over grads of several shapes (lengths
              off the 256-value block, a bf16 leaf) on the card and the
              CPU, codes, scales, effective grads and residuals bit-equal;
              and the three f32 steps again with ``GradCompressor`` over the
              reference's leaves, card against CPU, the same bounds at
              every element whose int8 code agrees (at most 1e-3 of the
              codes may move by one, where the two grads straddle a
              half-way point);
  9. launch  the training launcher under the supervisor, as a user runs
              them: ``supervisor --retries 2 -- launch.train --arch
              whisper-base --full --steps 10 --batch 2 --seq 256
              --checkpoint-every 3 --dedup-ckpt --fail-at 7`` as a
              subprocess (rc 0, the crash at 7, the resume from 6, 10
              steps, three ``[dedup-ckpt]`` lines with DCR >= 1; each
              attempt's wall seconds); beside it ``launch.train.main``
              with the same arguments in this process, uninterrupted (step and save
              seconds, peak memory, the launches of A, B, C and D); both
              step-9 TrainStates restored onto the card must be equal bit
              for bit;
  10. mesh   the sharded train step on a device mesh: ``launch.mesh.
              make_host_mesh()`` (one NCCL rank, 1 x 1 ("data", "model")),
              qwen3-moe-30b-a3b at full width and 2 of its 48 layers
              (1.85 B parameters) under ``default_rules(cfg)`` (MoE's "ep"
              branch, its all_to_all pair a real NCCL call on the one
              rank), params laid out by ``distribute_params``: 3 bf16
              steps at batch 2 x 2,048 tokens on the mesh, then the same 3
              without it (losses, grad norms, the largest param
              difference, step seconds, peak memory, kernel D's launches
              inside the steps, equal on both; losses and grad norms
              within 1e-3 relative); one f32 step at 1 x 1,024 on the
              mesh and without it, loss and grad norm within 1e-6
              relative; mamba2-130m the same (SSM mixer in shard_map);
              and whisper-base at full size, bf16, 3 steps at 2 x 2,048
              tokens with seeded random frames [2, 1500, 512] laid out by
              ("batch", None, None), on the mesh and off it: losses, grad
              norms and params equal (within 1e-3 of their largest),
              every gradient nonzero, kernel D's launches inside the
              steps (30 a step: the encoder's 6 once, the decoder's 6
              causal and 6 cross twice under remat) equal on both, all on
              the tensor cores. The process group is destroyed at the end
              of phase 12.
  11. mesh_serve  serving on the same one-rank NCCL mesh (phases 10 and 11
              share main's ``make_host_mesh()``), params laid out in place
              by ``sharding.distribute_model``, the KV cache by
              ``init_cache`` inside ``use_rules`` (its sequence over
              "cache_seq"): granite-8b at full width and 8 of its 36
              layers, bf16,
              ``serve_loop`` at batch 4, a 16-token prompt and 16 new
              tokens on the mesh and off it, under decode_32k's rules
              (``default_rules(cfg, decode=True)``) and long_500k's
              (``batch=None, cache_seq=("data", "model")``, batch 1): the
              greedy tokens equal, a difference allowed only where the
              off-mesh top-2 margin is within one bf16 rounding step (a
              near tie, reported); the same at 2 layers in f32, every
              step's logits within 1e-5 relative; a 4,096-token
              ``Model.prefill`` on and off the mesh (8 kernel D launches
              each, all on the tensor cores); qwen3-moe-30b-a3b at full
              width and 2 of 48 layers served the same way under its
              decode rules (MoE's "ep" branch); mamba2-130m at full
              size and jamba-v0.1-52b at full width and one period (8 of
              32 layers, MoE "ep"), bf16, served the same way under
              decode_32k's rules (every mesh step's logits a DTensor,
              jamba's all_to_all), and mamba2's 4,096-token prefill on
              and off the mesh (no kernel D); then
              ``distributed.pipeline.pipeline_apply`` over a one-rank "pod"
              axis, each stage 2 granite-8b blocks at full width in bf16,
              x [4, 2048, 4096] in 4 microbatches, against
              ``reference_apply`` (8 kernel D launches in the forward, 7
              NCCL hand-offs), then one backward with every stage
              parameter's gradient nonzero; and the cross families served
              the same way under decode_32k's rules at batch 4:
              llama-3.2-vision-11b at full width and one period (5 of 40
              layers: 4 self, 1 cross), seeded random images, and
              whisper-base at full size, decoding from the memory its
              encoder gives over seeded random frames (on the mesh, the
              encoder's run on the mesh): tokens equal but at a near tie,
              kernel D's cross launches at Tq 1 (1 and 6 a step) equal on
              and off the mesh, all on the tensor cores. Decode tokens/s,
              step and first-step seconds, peak memory, the port's
              collectives a step and D's launches, on and off the mesh.
  12. cells  the dry run and one cell at full shape: ``launch.dryrun.
              run_cell`` over every cell of whisper-base, phi3-medium-14b
              and jamba-v0.1-52b (10 cells) at one block period (the
              depth cut of tests/test_torch_dryrun.py: num_layers one
              period, at most one encoder layer), rank 0 of a fake world
              of 256 ranks on ``meta`` tensors, in a subprocess started
              before phase 8 (it runs beside the card-bound phases;
              killed past 300 s), every cell ``ok``, one line a cell with its
              argument bytes and roofline terms; then the reference's
              whisper-base ``prefill_32k`` cell at its full shape (B 32,
              T 32,768, seeded random frames [32, 1500, 512]) through
              ``launch.cells.lower_cell`` on the one-rank NCCL mesh and
              the same prefill off it (the same weights, seed 0): the
              last logits within one bf16 rounding step of the largest,
              18 kernel D launches in each (6 encoder, 6 causal, 6
              cross), all on the tensor cores, seconds and peak memory
              (under 72 GB).
Then the nvidia-smi line, the kernels summary line, and the result line.
Exits non-zero on any mismatch and when there is no CUDA device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import checkpoint, convert, optim  # noqa: E402
from repro_torch.api import config, faults, integrity  # noqa: E402
from repro_torch.api.store import DedupStore, chunk_with  # noqa: E402
from repro_torch.configs import cells as cell_list, get_config, get_shape  # noqa: E402
from repro_torch.core import chunking, context_model, features, hashing, pipeline  # noqa: E402
from repro_torch.data import TokenPipeline, TokenPipelineConfig, workloads  # noqa: E402
from repro_torch.distributed import compress  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build, flash_attn, gear_hash, ingest, ops, shingle_embed, sim_topk)
from repro_torch.launch import serve, train as launch_train  # noqa: E402
from repro_torch.models import layers, make_model  # noqa: E402
from repro_torch.models.transformer import block_period, layer_kinds  # noqa: E402
from repro_torch.train import step as train  # noqa: E402

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


# the CARD phases' process (CARD_CHILD) prints through this process's
# stdout: one line at a time
PRINT_LOCK = threading.Lock()


def emit(phase: str, **fields) -> None:
    line = json.dumps({"phase": phase, **fields})
    with PRINT_LOCK:
        print(line, flush=True)


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
    plain = lambda i, mk, normalize=True: shingle_embed.mean_normalize(
        shingle_embed.shingle_embed_sum_plain(i, mk, a, b), mk, normalize)
    errs, unnormalized_errs = [], []
    for name, (i, mk) in (("random", (ids, mask)), ("sql_dump extract", real)):
        for normalize, out in ((True, errs), (False, unnormalized_errs)):
            got = ops.shingle_embed(i, mk, a, b, normalize=normalize)
            want = plain(i, mk, normalize)
            out.append(float((got - want).abs().max()))
            if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
                fail(f"shingle_embed (normalize={normalize}) != plain on {name} input "
                     f"(max abs err {out[-1]})")
            if name == "random" and float(got[:4].abs().max()) != 0.0:
                fail("shingle_embed: an all-masked row is not 0")
    pairs = check_quotient(dev, gen, ids, a, b)
    ms = time_ms(lambda: shingle_embed.shingle_embed_cuda(ids, mask, a, b), reps=50)
    unnormalized_ms = time_ms(
        lambda: shingle_embed.shingle_embed_cuda(ids, mask, a, b, normalize=False), reps=50)
    unnormalized_plain_ms = time_ms(lambda: plain(ids, mask, False))
    real_ms = time_ms(lambda: shingle_embed.shingle_embed_cuda(*real, a, b), reps=50)
    plain_ms = time_ms(lambda: plain(ids, mask))
    total = shingle_embed.shingle_embed_sum_plain(ids, mask, a, b)
    epilogue_ms = time_ms(lambda: shingle_embed.mean_normalize(total, mask), reps=50)
    one = torch.zeros(1, device=dev)
    floor_ms = time_ms(lambda: one.zero_(), reps=50)
    valid = int(mask.sum())
    b_ms, b_by = bound(5 * rows * s_len + 8 * FEAT.m + 4 * rows * FEAT.m,
                       5.0 * valid * FEAT.m + 4.0 * rows * FEAT.m)
    # normalize=False: the same sums and mean, no norm (3 fewer operations
    # an output)
    un_ms, un_by = bound(5 * rows * s_len + 8 * FEAT.m + 4 * rows * FEAT.m,
                         5.0 * valid * FEAT.m + 1.0 * rows * FEAT.m)
    unnormalized = dict(max_abs_err=max(unnormalized_errs), kernel_ms=unnormalized_ms,
                        plain_ms=unnormalized_plain_ms, bound_ms=un_ms, bound_by=un_by)
    real_shape = [real[0].shape[0], real[0].shape[1], FEAT.m]
    emit("kernel", name="shingle_embed", shape=[rows, s_len, FEAT.m],
         max_abs_err=errs[0], tol=1e-5, kernel_ms=ms, plain_ms=plain_ms,
         old_epilogue_ms=epilogue_ms, launch_floor_ms=floor_ms, bound_ms=b_ms,
         bound_by=b_by, library_ms=None, real_shape=real_shape,
         real_unmasked=int(real[1].sum()), real_max_abs_err=errs[1], real_kernel_ms=real_ms,
         quotient_pairs=pairs, quotient_bit_exact=True, unnormalized=unnormalized)
    return dict(name="shingle_embed", max_abs_err=max(errs + unnormalized_errs), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shape=[rows, s_len, FEAT.m], old_epilogue_ms=epilogue_ms,
                launch_floor_ms=floor_ms, real_shape=real_shape, real_kernel_ms=real_ms,
                unnormalized=unnormalized)


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
        for name, b, tq, tk, h, kv, hd, causal in (ATTN_CHECKS + SIMT_ONLY_CHECKS
                                                   + ATTN_PATH_SHAPES):
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
    main_name = f"{t_main}x{t_main}_causal"
    row, plain = time_attn(q, k, v, main_name)
    # the SIMT kernel on the same inputs: kernel D's earlier time
    outs = {}
    simt_ms = time_ms(lambda: outs.update(simt=flash_attn.flash_attention_cuda(q, k, v, True)),
                      reps=1, warmup=1)
    simt_err, simt_used = attn_err(outs["simt"], plain, torch.bfloat16, "simt " + main_name)
    del outs, plain, q, k, v
    flops = row.pop("flops")
    emit("attn_kernel", name="flash_attention", checks=checks,
         tol={str(k)[6:]: v for k, v in ATTN_TOL.items()}, bf16_ulp_rtol=BF16_ULP,
         dtype="bfloat16", route="sm90", **row, kernel_ms=row["ms"],
         simt_ms=simt_ms, simt_max_abs_err=simt_err, simt_bound_used=simt_used,
         bound_rate="989e12 bf16 FLOP/s", kernel_tflop_per_s=flops / row["ms"] / 1e9,
         # Q.K^T once and P.V twice (P hi and lo): the FLOPs the tensor cores do
         tensor_core_tflop_per_s=1.5 * flops / row["ms"] / 1e9,
         simt_tflop_per_s=flops / simt_ms / 1e9)
    # the other archs' head layouts at the same length (phase lm_families
    # runs each at these shapes)
    arch_rows = []
    for arch, h, kv, hd in ATTN_ARCH_SHAPES:
        q, k, v = attn_inputs(1, t_main, t_main, h, kv, hd, torch.bfloat16, dev, gen)
        arch_row, plain = time_attn(q, k, v, f"{arch} {main_name}")
        del plain, q, k, v
        arch_row.pop("flops")
        arch_rows.append(dict(arch=arch, **arch_row))
        emit("attn_kernel", name="flash_attention", arch=arch, dtype="bfloat16",
             route="sm90", **arch_row)
    # the cross-attention and encoder paths' shapes
    path_rows = []
    for name, b, tq, tk, h, kv, hd, causal in ATTN_PATH_SHAPES:
        q, k, v = attn_inputs(b, tq, tk, h, kv, hd, torch.bfloat16, dev, gen)
        path_row, plain = time_attn(q, k, v, name, causal)
        del plain, q, k, v
        path_row.pop("flops")
        path_rows.append(dict(path=name, **path_row))
        emit("attn_kernel", name="flash_attention", path=name, dtype="bfloat16",
             route="sm90", **path_row)
    err_f32 = max(c["max_abs_err"] for c in checks if c["dtype"] == "float32")
    return dict(name="flash_attention", max_abs_err=row["max_abs_err"], max_abs_err_f32=err_f32,
                ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"], shape=row["shape"],
                simt_ms=simt_ms, simt_source=flash_attn.SOURCE_SIMT, arch_rows=arch_rows,
                path_rows=path_rows)


# (arch, H, KV, hd) of phase lm_families' archs whose heads differ from
# granite-8b's (granite-3-8b has its 32 / 8 at hd 128): group 4 at 40
# heads, group 16, and hd 64 on the tensor cores
ATTN_ARCH_SHAPES = [("phi3-medium-14b", 40, 10, 128), ("chatglm3-6b", 32, 2, 128),
                    ("qwen3-moe-30b-a3b", 32, 4, 64)]
# (name, B, Tq, Tk, H, KV, hd, causal) of the cross-attention and encoder
# paths of phase lm_families, as its prefills and decode steps give them:
# llama-3.2-vision-11b's cross sublayer over its 1601 image tokens,
# whisper-base's causal self-attention (GQA group 1 at hd 64), its cross
# over 1500 frames and its encoder's non-causal 1500 x 1500, and the cross
# sublayer of a decode step at batch 4 (Tq 1) for each. Each is checked on
# both routes (bf16: tensor cores, f32: SIMT) and timed on the tensor cores
ATTN_PATH_SHAPES = [
    ("llama-3.2-vision-11b cross", 1, 32_768, 1601, 32, 8, 128, False),
    ("whisper-base self", 1, 32_768, 32_768, 8, 8, 64, True),
    ("whisper-base cross", 1, 32_768, 1500, 8, 8, 64, False),
    ("whisper-base encoder", 1, 1500, 1500, 8, 8, 64, False),
    ("llama-3.2-vision-11b decode cross", 4, 1, 1601, 32, 8, 128, False),
    ("whisper-base decode cross", 4, 1, 1500, 8, 8, 64, False),
]


def time_attn(q, k, v, what: str, causal: bool = True) -> tuple[dict, torch.Tensor]:
    """Kernel D's tensor-core route at one bf16 shape ([B, Tq, H, hd] q,
    [B, Tk, KV, hd] k, v; causal ones square), held to the plain version
    and timed beside it, SDPA and the bound: bytes, q, k, v and o once
    each; operations, 4 B H Tq Tk hd (Q.K^T and P.V), halved when causal,
    at the bf16 tensor-core rate. Returns (the row, the plain output)."""
    b, tq, h, hd = q.shape
    tk = k.shape[1]
    outs = {}
    before = ops.LAUNCHES["flash_attention_sm90"]
    ms = time_ms(lambda: outs.update(sm90=ops.flash_attention(q, k, v, causal)),
                 reps=10, warmup=2)
    if ops.LAUNCHES["flash_attention_sm90"] - before != 12:
        fail(f"the {what} timing did not run the tensor-core route")
    plain_ms = time_ms(lambda: outs.update(plain=attn_plain(q, k, v, causal)),
                       reps=1, warmup=1)
    err, used = attn_err(outs["sm90"], outs["plain"], torch.bfloat16, what)
    t = lambda x: x.transpose(1, 2)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        t(q), t(k), t(v), is_causal=causal, enable_gqa=True), reps=5, warmup=2)
    moved = 2 * (2 * q.numel() + k.numel() + v.numel())          # q, k, v, o in bf16
    flops = 4.0 * b * h * tq * tk * hd / (2 if causal else 1)     # causal: the lower half
    b_ms, b_by = bound(moved, flops, BF16_FLOP_PER_S)
    row = dict(shape=[b, tq, tk, h, k.shape[2], hd], causal=causal, max_abs_err=err,
               bound_used=used, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, flops=flops)
    return row, outs["plain"]


# --- phase 4: the main path ----------------------------------------------------

# The JAX package's DCR at this configuration (32 MiB x 4 versions, seed
# 1234, FEAT, MODEL, CHUNKER, threshold 0.3), from its CPU run, to six
# decimals. The port's context model starts from the reference's own
# init at these widths (core/fixtures), so the card must give the same.
REFERENCE_DCR = {"sql_dump": 4.129564, "vmdk": 5.681883}
# (chunks, dup, delta, raw) of each workload's phase-4 store, for phases
# 4c and 4f, and its extract seconds (the fused path), for phase 4f
MAIN_COUNTS: dict[str, tuple[int, int, int, int]] = {}
MAIN_EXTRACT_S: dict[str, float] = {}


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
    MAIN_EXTRACT_S[name] = st.extract_seconds
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
    for k, v in s3_backend(dev, name, versions).items():
        launches[k] += v
    return launches


# --- phase 4c, "s3": CARD over S3ObjectClient and an in-process S3 fake -------

class _NoSuchKey(Exception):
    """boto3 raises a generated class named ``NoSuchKey``; the client
    matches on the class name."""


_NoSuchKey.__name__ = "NoSuchKey"


class _Missing(Exception):
    """botocore-shaped 404, the status where the client reads it."""

    def __init__(self, key: str) -> None:
        super().__init__(f"head_object: 404 for {key!r}")
        self.response = {"ResponseMetadata": {"HTTPStatusCode": 404}}


class _Body:
    def __init__(self, data: bytes) -> None:
        self._data = data

    def read(self) -> bytes:
        return self._data


class _Pages:
    def __init__(self, buckets: dict) -> None:
        self._buckets = buckets

    def paginate(self, Bucket: str, Prefix: str = ""):
        keys = sorted(k for k in self._buckets.get(Bucket, {}) if k.startswith(Prefix))
        for i in range(0, len(keys), 2):
            yield {"Contents": [{"Key": k, "Size": len(self._buckets[Bucket][k])}
                                for k in keys[i:i + 2]]}
        if not keys:
            yield {}


class StubS3:
    """In-process fake of the boto3 S3 surface ``S3ObjectClient`` uses
    (a copy of the conformance suite's ``_StubS3``: inclusive-end ranges
    clamped at the object's end, small list pages, idempotent deletes),
    so the "s3" path runs with neither boto3 nor a network."""

    def __init__(self) -> None:
        self._buckets: dict[str, dict[str, bytes]] = {}

    def put_object(self, Bucket: str, Key: str, Body: bytes) -> dict:
        self._buckets.setdefault(Bucket, {})[Key] = bytes(Body)
        return {"ResponseMetadata": {"HTTPStatusCode": 200}}

    def get_object(self, Bucket: str, Key: str, Range: str | None = None) -> dict:
        data = self._buckets.get(Bucket, {}).get(Key)
        if data is None:
            raise _NoSuchKey(f"NoSuchKey: {Key!r}")
        if Range is not None:
            start, _, end = Range.removeprefix("bytes=").partition("-")
            data = data[int(start):int(end) + 1]
        return {"Body": _Body(data), "ResponseMetadata": {"HTTPStatusCode": 200}}

    def head_object(self, Bucket: str, Key: str) -> dict:
        data = self._buckets.get(Bucket, {}).get(Key)
        if data is None:
            raise _Missing(Key)
        return {"ContentLength": len(data), "ResponseMetadata": {"HTTPStatusCode": 200}}

    def get_paginator(self, op: str) -> _Pages:
        if op != "list_objects_v2":
            raise ValueError(op)
        return _Pages(self._buckets)

    def delete_object(self, Bucket: str, Key: str) -> dict:
        self._buckets.get(Bucket, {}).pop(Key, None)
        return {"ResponseMetadata": {"HTTPStatusCode": 204}}


def s3_backend(dev, name: str, versions: list[bytes]) -> dict[str, int]:
    """CARD from phase 4c's dict over ``ObjectStoreBackend(client=
    S3ObjectClient(..., client=StubS3()))``: fit, ingest the 4 versions
    (DCR, bytes stored and counts must be the "objectstore" run's: the
    same objects, through another client), close; a second store on the
    same bucket restores every version SHA-256-identically. Returns the
    ingest's kernel launches."""
    from repro_torch.api.objectstore import S3ObjectClient
    what = f"backends {name} s3"
    stub = StubS3()
    d = backend_config("objectstore", "").to_dict()
    d["backend_args"] = {"client": S3ObjectClient("chip-smoke", f"card/{name}", client=stub)}
    cfg = config.DedupConfig.from_dict(d)
    store = config.build_store(cfg, device=dev)
    store._clock()
    ops.reset_launches()
    t0 = time.perf_counter()
    store.fit(versions[:1])
    t1 = time.perf_counter()
    for v in versions:
        store.ingest(v)
    t2 = store._clock()
    lc = card_launches(what)
    st = store.stats
    counts = (st.chunks, st.dup_chunks, st.delta_chunks, st.raw_chunks)
    want_dcr, want_stored, *want_counts = BACKEND_REFERENCE[name]["objectstore"]
    if round(st.dcr, 6) != want_dcr or st.bytes_stored != want_stored \
            or list(counts) != want_counts:
        fail(f"{what}: DCR {st.dcr}, {st.bytes_stored} bytes stored and counts {counts} are "
             f"not the objectstore run's {want_dcr}, {want_stored}, {want_counts}")
    store.close()
    objects = stub._buckets["chip-smoke"]
    store = config.build_store(cfg, device=dev)
    cold = restore_all(store, versions, f"{what} reopened")
    store.close()
    total = sum(len(v) for v in versions)
    emit("backends", workload=name, backend="s3", client="S3ObjectClient over StubS3",
         base_mib=BASE / 2**20, versions=len(versions), bytes_in=total, dcr=st.dcr,
         dcr_reference=want_dcr, bytes_stored=st.bytes_stored, counts=list(counts),
         ingest=dict(seconds=t2 - t1, mb_per_s=total / 1e6 / (t2 - t1), fit_s=t1 - t0),
         objects=len(objects), object_bytes=sum(map(len, objects.values())),
         cold=cold, restored="sha256-identical", launches={"ingest": lc})
    return lc


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


def _require(cond: bool, msg: str, phase: str = "lifecycle") -> None:
    if not cond:
        raise RuntimeError(f"{phase}: {msg}")


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


def check_lifecycle(what: str, pinned: dict, recount: dict, want: dict) -> None:
    """Every pinned number must equal the JAX package's, the live
    chain-depth histograms (CollectReport and StoreStats) included, and
    that histogram must equal a plain recount on the card's own records."""
    got = json.loads(json.dumps(pinned))
    want = json.loads(json.dumps(want))
    if got != want:
        diff = {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                if got.get(k) != want.get(k)}
        fail(f"{what}: not the reference's numbers: {diff}")
    recount = json.loads(json.dumps(recount))
    if got["collect"]["chain_depth_hist"] != recount:
        fail(f"{what}: the depth histogram {got['collect']['chain_depth_hist']} is not "
             f"the recount {recount}")


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
            check_lifecycle(what, pinned, measured.pop("depth_hist_recount"),
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
                 pinned="the JAX package's",
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


# --- phase 4e: the multi-tenant server, observability and the CLI -----------

# One server from a config dict: CARD at phase 4's widths on "objectstore"
# over LocalObjectStore (no latency), 4 workers, default tenant limits, a
# JSONL trace with a 4096-span ring. Two tenants ingest in this fixed order.
SERVE_ORDER = (("sql", "sql_dump", 0), ("vm", "vmdk", 0), ("sql", "sql_dump", 1),
               ("vm", "vmdk", 1), ("sql", "sql_dump", 2), ("vm", "vmdk", 2),
               ("sql", "sql_dump", 3), ("vm", "vmdk", 3))
SERVE_TENANT = {"max_inflight": 4, "max_queue": 4}
# families whose every sample is pinned: what the requests decide, not what
# the thread timing of the concurrent restores decides (which restore finds
# a chunk in the decode cache, so GETs, bytes read and read runs are
# reported, not pinned)
SERVE_PINNED_FAMILIES = (
    "repro_ingest_commits_total", "repro_ingest_bytes_total", "repro_ingest_chunks_total",
    "repro_restore_ops_total", "repro_server_requests_total",
    "repro_server_breaker_state", "repro_server_breaker_transitions_total",
    "repro_server_inflight", "repro_tenant_bytes_stored", "repro_tenant_inflight",
    "repro_tenant_queue_depth", "repro_tenant_requests_total", "repro_tenant_shed_total",
    "repro_store_bytes", "repro_store_dcr", "repro_store_streams",
    "repro_gc_freed_bytes_total")
# histograms whose count (one observation a request, commit or lock
# acquire) is pinned; their buckets and sums are timings
SERVE_PINNED_COUNTS = ("repro_ingest_stage_seconds", "repro_restore_stage_seconds",
                       "repro_restore_requests", "repro_gc_phase_seconds",
                       "repro_lock_wait_seconds")
# single samples pinned in a family that is otherwise reported: the bytes
# the restores return are fixed by the requests, the bytes they read are not
SERVE_PINNED_SAMPLES = ("repro_restore_bytes_total{dir=out}",)
SERVE_CLI_ROOTS = (("card_root", ["--detector", "card"]), ("finesse_root", []))
# What scripts/serve_dcr.py printed (the JAX package on a CPU, the same
# dict and steps): the card must give exactly these.
SERVE_REFERENCE: dict = {
    "ingest": [["sql", 0, 0, 3526, 0, 3517, 9, 28981780], ["vm", 0, 1, 2370, 0, 515, 1855,
        28550760], ["sql", 1, 2, 3598, 2537, 1011, 50, 1576051], ["vm", 1, 3, 2383,
        2233, 51, 99, 1673789], ["sql", 2, 4, 3668, 2563, 1051, 54, 1546302], ["vm", 2,
        5, 2392, 2251, 52, 89, 1466695], ["sql", 3, 6, 3741, 2628, 1061, 52, 1671280],
        ["vm", 3, 7, 2402, 2269, 52, 81, 1372236]],
    "tenants": {"sql": {"tenant": "sql", "bytes_stored": 33775413, "bytes_ingested": 33775413,
        "reserved": 0, "quota_bytes": None, "streams": 4, "pending": 0, "inflight": 0,
        "requests": 4, "shed": {}}, "vm": {"tenant": "vm", "bytes_stored": 33063480,
        "bytes_ingested": 33063480, "reserved": 0, "quota_bytes": None, "streams": 4,
        "pending": 0, "inflight": 0, "requests": 4, "shed": {}}},
    "dcr": 4.077205,
    "foreign": "KeyError",
    "quota": "QuotaExceededError",
    "overload": "OverloadError",
    "tight": [[3741, 3741, 0], [3741, 3741, 0]],
    "shed": {"small": {"quota": 1}, "tight": {"overload": 1}},
    "deletes": [8623577, 1869357],
    "tenants_after": {"sql": {"tenant": "sql", "bytes_stored": 4793633, "bytes_ingested":
        33775413, "reserved": 0, "quota_bytes": None, "streams": 3, "pending": 0,
        "inflight": 0, "requests": 11, "shed": {}}, "vm": {"tenant": "vm",
        "bytes_stored": 4512720, "bytes_ingested": 33063480, "reserved": 0,
        "quota_bytes": None, "streams": 3, "pending": 0, "inflight": 0, "requests": 10,
        "shed": {}}, "tight": {"tenant": "tight", "bytes_stored": 0, "bytes_ingested":
        0, "reserved": 0, "quota_bytes": None, "streams": 2, "pending": 0, "inflight":
        0, "requests": 3, "shed": {"overload": 1}}},
    "stats": [343732127, 66838893, 56345959, 10492934],
    "families": [["repro_cache_evictions_total", ""], ["repro_cache_ghost_hits_total", ""],
        ["repro_corrupt_chunks_total", ""], ["repro_gc_freed_bytes_total", ""],
        ["repro_gc_phase_seconds", "phase"], ["repro_ingest_bytes_total", "dir"],
        ["repro_ingest_chunks_total", "kind"], ["repro_ingest_commits_total", ""],
        ["repro_ingest_stage_seconds", "stage"], ["repro_lock_wait_seconds",
        "lock,side"], ["repro_objstore_backoff_seconds_total", ""],
        ["repro_objstore_client_bytes_total", "dir"],
        ["repro_objstore_client_requests_total", "op"], ["repro_objstore_get_bytes",
        ""], ["repro_objstore_request_seconds", "op"], ["repro_objstore_retries_total",
        ""], ["repro_reader_bytes_total", "dir"], ["repro_reader_cache_bytes", "kind"],
        ["repro_reader_cache_lookups_total", "outcome"],
        ["repro_reader_io_seconds_total", "phase"], ["repro_reader_requests_total", ""],
        ["repro_reader_run_bytes", ""], ["repro_reader_run_extents", ""],
        ["repro_restore_bytes_total", "dir"], ["repro_restore_ops_total", "surface"],
        ["repro_restore_requests", ""], ["repro_restore_stage_seconds", "stage"],
        ["repro_server_breaker_state", ""], ["repro_server_breaker_transitions_total",
        "to"], ["repro_server_inflight", ""], ["repro_server_requests_total",
        "op,outcome"], ["repro_singleflight_total", "event"], ["repro_store_bytes",
        "kind"], ["repro_store_dcr", ""], ["repro_store_streams", ""],
        ["repro_tenant_bytes_stored", "tenant"], ["repro_tenant_inflight", "tenant"],
        ["repro_tenant_queue_depth", "tenant"], ["repro_tenant_requests_total",
        "tenant"], ["repro_tenant_shed_total", "reason,tenant"]],
    "metrics": {"repro_gc_freed_bytes_total{}": 10492934.0, "repro_ingest_bytes_total{dir=in}":
        343732127.0, "repro_ingest_bytes_total{dir=stored}": 66838893.0,
        "repro_ingest_chunks_total{kind=delta}": 7310.0,
        "repro_ingest_chunks_total{kind=dup}": 21963.0,
        "repro_ingest_chunks_total{kind=raw}": 2289.0, "repro_ingest_commits_total{}":
        10.0, "repro_restore_bytes_total{dir=out}": 278807357.0,
        "repro_restore_ops_total{surface=full}": 8.0,
        "repro_restore_ops_total{surface=iter}": 0.0,
        "repro_restore_ops_total{surface=range}": 2.0, "repro_server_breaker_state{}":
        0.0, "repro_server_breaker_transitions_total{to=closed}": 0.0,
        "repro_server_breaker_transitions_total{to=half_open}": 0.0,
        "repro_server_breaker_transitions_total{to=open}": 0.0,
        "repro_server_inflight{}": 0.0,
        "repro_server_requests_total{op=delete,outcome=ok}": 2.0,
        "repro_server_requests_total{op=ingest,outcome=ok}": 10.0,
        "repro_server_requests_total{op=ingest,outcome=overload}": 1.0,
        "repro_server_requests_total{op=ingest,outcome=quota}": 1.0,
        "repro_server_requests_total{op=restore,outcome=error}": 1.0,
        "repro_server_requests_total{op=restore,outcome=ok}": 8.0,
        "repro_server_requests_total{op=restore_range,outcome=ok}": 2.0,
        "repro_store_bytes{kind=dead}": 10492934.0, "repro_store_bytes{kind=in}":
        343732127.0, "repro_store_bytes{kind=live}": 56345959.0,
        "repro_store_bytes{kind=reclaimed}": 0.0, "repro_store_bytes{kind=stored}":
        66838893.0, "repro_store_dcr{}": 5.142696289120169, "repro_store_streams{}":
        10.0, "repro_tenant_bytes_stored{tenant=small}": 0.0,
        "repro_tenant_bytes_stored{tenant=sql}": 4793633.0,
        "repro_tenant_bytes_stored{tenant=tight}": 0.0,
        "repro_tenant_bytes_stored{tenant=vm}": 4512720.0,
        "repro_tenant_inflight{tenant=small}": 0.0, "repro_tenant_inflight{tenant=sql}":
        0.0, "repro_tenant_inflight{tenant=tight}": 0.0,
        "repro_tenant_inflight{tenant=vm}": 0.0,
        "repro_tenant_queue_depth{tenant=small}": 0.0,
        "repro_tenant_queue_depth{tenant=sql}": 0.0,
        "repro_tenant_queue_depth{tenant=tight}": 0.0,
        "repro_tenant_queue_depth{tenant=vm}": 0.0,
        "repro_tenant_requests_total{tenant=small}": 1.0,
        "repro_tenant_requests_total{tenant=sql}": 11.0,
        "repro_tenant_requests_total{tenant=tight}": 3.0,
        "repro_tenant_requests_total{tenant=vm}": 10.0,
        "repro_tenant_shed_total{reason=overload,tenant=tight}": 1.0,
        "repro_tenant_shed_total{reason=quota,tenant=small}": 1.0},
    "counts": {"repro_gc_phase_seconds_count{phase=delete}": 2.0,
        "repro_ingest_stage_seconds_count{stage=chunk}": 10.0,
        "repro_ingest_stage_seconds_count{stage=delta}": 10.0,
        "repro_ingest_stage_seconds_count{stage=extract}": 10.0,
        "repro_ingest_stage_seconds_count{stage=observe}": 10.0,
        "repro_ingest_stage_seconds_count{stage=score}": 10.0,
        "repro_ingest_stage_seconds_count{stage=store}": 10.0,
        "repro_lock_wait_seconds_count{lock=lifecycle,side=read}": 22.0,
        "repro_lock_wait_seconds_count{lock=lifecycle,side=write}": 2.0,
        "repro_restore_requests_count{}": 10.0,
        "repro_restore_stage_seconds_count{stage=decode}": 10.0,
        "repro_restore_stage_seconds_count{stage=read}": 10.0,
        "repro_restore_stage_seconds_count{stage=total}": 10.0},
    "spans": {"ingest": 10, "restore": 10, "gc.delete": 2},
    "breaker": ["TransientError", "TransientError", "open", "CircuitOpenError",
        "CircuitOpenError", "open", True, "closed", {"closed": 1, "half_open": 1,
        "open": 1}, "IngestReport", {"circuit": 2}],
    "cli": {"card_root": {"v0.bin": [28985425, 1818, 0, 1808], "v1.bin": [1621713, 1855, 975,
        880], "v2.bin": [15150998, 1894, 996, 895]}, "finesse_root": {"v0.bin":
        [33554551, 1818, 0, 0], "v1.bin": [2241025, 1855, 975, 765]}},
}


def serve_dict(root: str) -> dict:
    return {"detector": "card", "detector_args": LIFECYCLE_CARD,
            "chunker_args": {"avg_size": 8192}, "backend": "objectstore",
            "backend_args": {"path": os.path.join(root, "objects")},
            "server_workers": 4, "tenant_args": SERVE_TENANT,
            "trace_path": os.path.join(root, "trace.jsonl"), "trace_ring_events": 4096}


def _outcome(fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except Exception as e:     # noqa: BLE001 - the type is the outcome
        return type(e).__name__


def metric_samples(parse, text: str) -> tuple[list, dict, dict]:
    """(sorted [family, label keys], the pinned families' samples, the
    pinned histograms' counts) of one exposition, through ``parse``."""
    parsed = parse(text)
    families, values, counts = set(), {}, {}
    for name, labels, value in parsed["samples"]:
        fam = re.sub(r"_(bucket|count|sum)$", "", name) if name not in parsed["types"] else name
        families.add((fam, ",".join(sorted(k for k in labels if k != "le"))))
        key = name + "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"
        if fam in SERVE_PINNED_FAMILIES or key in SERVE_PINNED_SAMPLES:
            values[key] = value
        elif fam in SERVE_PINNED_COUNTS and name.endswith("_count"):
            counts[key] = value
    return sorted(list(f) for f in families), values, counts


def breaker_drill(env, data: bytes, root: str) -> list:
    """A dedup-only store on objectstore behind a breaker (2 failures
    open it, 0.05 s cooldown, 1 probe closes it): two failed restores open
    it, writes shed while reads go on, a restore probe closes it."""
    storm = threading.Event()

    def hook(op, key, n):
        if storm.is_set() and op == "get":
            return env.faults.TransientError(503, f"storm {op} #{n}")
        return None

    store = env.build_store({"detector": "dedup-only", "chunker_args": {"avg_size": 8192},
                             "backend": "objectstore",
                             "backend_args": {"path": root, "fault_hook": hook,
                                              "max_retries": 0, "cache_bytes": 1}})
    breaker = env.serve.CircuitBreaker(fail_threshold=2, window_seconds=5.0,
                                       cooldown_seconds=0.05, probe_successes=1)
    srv = env.serve.DedupServer(store, workers=2, breaker=breaker)
    try:
        handle = srv.ingest("t", data).handle
        storm.set()
        out = [_outcome(srv.restore, "t", handle) for _ in range(2)] + [breaker.state()]
        out += [_outcome(srv.ingest, "t", b"rejected"), _outcome(srv.delete, "t", handle),
                breaker.state()]
        time.sleep(0.06)
        storm.clear()
        out += [srv.restore("t", handle) == data, breaker.state(),
                dict(breaker.transitions), type(srv.ingest("t", data[:4096])).__name__,
                srv.tenant_stats("t")["shed"]]
        return out
    finally:
        srv.close(close_store=True)


def cli_steps(env, versions: list[bytes], tmp: str) -> tuple[dict, dict]:
    """The object-store CLI in process: versions 0 and 1 into a CARD root
    and a default (Finesse) root, version 2 into the CARD root in a second
    invocation (digest seeds from the catalog), then ls, stat, verify and
    scrub of each root, and one object copied back out."""
    files = []
    for i, v in enumerate(versions[:3]):
        files.append(os.path.join(tmp, f"v{i}.bin"))
        with open(files[-1], "wb") as f:
            f.write(v)
    seconds: dict = {}
    pinned: dict = {}

    def run(label, argv):
        t0 = time.perf_counter()
        rc = env.cli(argv)
        seconds[label] = seconds.get(label, 0.0) + time.perf_counter() - t0
        _require(rc == 0, f"cli {argv[0]} {argv[1:]} exited {rc}", "serve")

    for name, extra in SERVE_CLI_ROOTS:
        url = "obj://" + os.path.join(tmp, name)
        run(f"cp {name}", ["cp", *files[:2], url, *extra])
        if name == "card_root":
            run("cp second invocation", ["cp", files[2], url])
        for cmd in ("ls", "stat", "verify", "scrub"):
            run(cmd, [cmd, url])
        with open(os.path.join(tmp, name, "catalog.json")) as f:
            cat = json.load(f)
        pinned[name] = {n: [e["stored"], e["chunks"], e["dup_chunks"], e["delta_chunks"]]
                        for n, e in sorted(cat["files"].items())}
    out = os.path.join(tmp, "restored.bin")
    run("cp out", ["cp", "obj://" + os.path.join(tmp, "card_root", "v0.bin"), out])
    with open(out, "rb") as f:
        _require(f.read() == versions[0], "the CLI's copy out is not version 0", "serve")
    return pinned, seconds


def serve_steps(env, versions: dict[str, list[bytes]], tmp: str, mark=lambda label: None
                ) -> tuple[dict, dict]:
    """Phase 4e's steps. ``env`` carries one package's ``build_server``,
    ``build_store``, ``serve``, ``faults``, ``parse`` (its Prometheus
    parser), ``dump`` (its observe CLI) and ``cli`` (its object-store CLI):
    the port's on the card here, the JAX package's in scripts/serve_dcr.py,
    which calls this very function. Returns (pinned, measured)."""
    sha = hashlib.sha256
    pinned: dict = {}
    measured: dict = {}
    srv = env.build_server(serve_dict(tmp))
    store = srv.store
    try:
        t0 = time.perf_counter()
        store.fit(versions["sql_dump"][:1])
        measured["fit_s"] = time.perf_counter() - t0

        mark("start")
        handles: dict[str, list[int]] = {"sql": [], "vm": []}
        want: dict[tuple[str, int], bytes] = {}
        reports, measured["ingest_s"] = [], {"sql": 0.0, "vm": 0.0}
        for tenant, name, v in SERVE_ORDER:
            t0 = time.perf_counter()
            r = srv.submit(tenant, "ingest", versions[name][v]).result()
            measured["ingest_s"][tenant] += time.perf_counter() - t0
            handles[tenant].append(r.handle)
            want[(tenant, r.handle)] = versions[name][v]
            reports.append([tenant, v, r.handle, r.chunks, r.dup_chunks, r.delta_chunks,
                            r.raw_chunks, r.bytes_stored])
        pinned["ingest"] = reports
        pinned["tenants"] = {t: srv.tenant_stats(t) for t in ("sql", "vm")}
        pinned["dcr"] = round(store.stats.dcr, 6)

        # every restore at once, both tenants, plus one range each
        t0 = time.perf_counter()
        futs = {key: srv.submit(key[0], "restore", key[1]) for key in want}
        ranges = {t: srv.submit(t, "restore_range", handles[t][1], 1 << 20, 3 << 20)
                  for t in ("sql", "vm")}
        for key, fut in futs.items():
            _require(sha(fut.result()).digest() == sha(want[key]).digest(),
                     f"restore {key} is not its input", "serve")
        for t, fut in ranges.items():
            _require(fut.result() == want[(t, handles[t][1])][1 << 20:4 << 20],
                     f"range of {t} is not its input", "serve")
        measured["restore_s"] = time.perf_counter() - t0
        measured["restore_mb_per_s"] = (sum(map(len, want.values())) + (6 << 20)) / 1e6 \
            / measured["restore_s"]
        pinned["foreign"] = _outcome(srv.restore, "sql", handles["vm"][0])
        _require(pinned["foreign"] == "KeyError", "a foreign handle did not raise KeyError",
                 "serve")

        # typed sheds: a quota below one version, then a full queue
        before = dataclasses.asdict(store.stats)
        srv.add_tenant("small", quota_bytes=len(versions["sql_dump"][0]) // 2)
        pinned["quota"] = _outcome(srv.ingest, "small", versions["sql_dump"][0])
        after = dataclasses.asdict(store.stats)
        _require(after == before, f"the quota shed changed the store: {before} -> {after}",
                 "serve")
        srv.add_tenant("tight", max_inflight=1, max_queue=1)
        dup = versions["sql_dump"][3]
        admitted = [srv.submit("tight", "ingest", dup) for _ in range(2)]
        pinned["overload"] = _outcome(srv.submit, "tight", "ingest", dup)
        tight = [f.result() for f in admitted]
        pinned["tight"] = sorted([r.chunks, r.dup_chunks, r.bytes_stored] for r in tight)
        pinned["shed"] = {t: srv.tenant_stats(t)["shed"] for t in ("small", "tight")}
        _require((pinned["quota"], pinned["overload"]) == ("QuotaExceededError",
                                                           "OverloadError"),
                 f"sheds are not typed: {pinned['quota']}, {pinned['overload']}", "serve")

        t0 = time.perf_counter()
        pinned["deletes"] = [srv.delete(t, handles[t][0]) for t in ("sql", "vm")]
        measured["delete_s"] = time.perf_counter() - t0
        pinned["tenants_after"] = {t: srv.tenant_stats(t) for t in ("sql", "vm", "tight")}
        pinned["stats"] = [store.stats.bytes_in, store.stats.bytes_stored,
                           store.stats.live_bytes, store.stats.dead_bytes]
        mark("end")
    finally:
        srv.close()
    # after close(): every worker's metric shard is folded in
    text = store.metrics().to_prometheus()
    pinned["families"], pinned["metrics"], pinned["counts"] = metric_samples(env.parse, text)
    snap = store.metrics().snapshot()
    measured["stage_sums_s"] = {
        s["labels"]["stage"]: s["sum"]
        for s in snap["repro_ingest_stage_seconds"]["samples"]}
    measured["restore_sums_s"] = {
        s["labels"]["stage"]: s["sum"]
        for s in snap["repro_restore_stage_seconds"]["samples"]}
    ops_ = store.observe.tracer.ops()
    pinned["spans"] = {op: ops_.get(op, 0) for op in ("ingest", "restore", "gc.delete")}
    store.close()
    trace = os.path.join(tmp, "trace.jsonl")
    with open(trace) as f:
        measured["trace_lines"] = sum(1 for line in f if line.strip())
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        _require(env.dump(["dump", trace]) == 0, "dump of the trace failed", "serve")
    measured["dump_lines"] = len(printed.getvalue().splitlines())
    t0 = time.perf_counter()
    pinned["breaker"] = breaker_drill(env, versions["sql_dump"][0][:1 << 20],
                                      os.path.join(tmp, "breaker"))
    measured["breaker_s"] = time.perf_counter() - t0
    pinned["cli"], measured["cli_s"] = cli_steps(env, versions["sql_dump"], tmp)
    return pinned, measured


def concurrent_ingests(env, dev, versions: dict[str, list[bytes]], tmp: str) -> dict:
    """Card only, not pinned: tenants ``sql`` and ``vm`` submit an ingest
    (the first 8 MiB of version 1 of each workload: about 1,000 chunks, so
    the second commit's index passes kernel C's 512 rows) at the same
    moment into a fresh fitted server. The commit lock serialises the two
    commits with their device work, so the reports and kernels A-C's
    launches must be those of the same two ingests run one after the
    other, in one order or the other, on fresh servers; each restore must
    be its input, and the TF32 state must be what it was before."""
    sha = hashlib.sha256
    pair = (("sql", versions["sql_dump"][1][:8 << 20]), ("vm", versions["vmdk"][1][:8 << 20]))
    tf32 = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)

    def run(order, label: str) -> tuple[dict, dict, float]:
        root = os.path.join(tmp, "concurrent_" + label)
        os.makedirs(root)
        srv = env.build_server(serve_dict(root))
        try:
            srv.store.fit(versions["sql_dump"][:1])
            torch.cuda.synchronize(dev)
            ops.reset_launches()
            t0 = time.perf_counter()
            if label == "together":
                futs = [(t, srv.submit(t, "ingest", data)) for t, data in order]
                reports = {t: f.result() for t, f in futs}
            else:
                reports = {t: srv.submit(t, "ingest", data).result() for t, data in order}
            torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - t0
            lc = card_launches(f"serve: ingests {label}")
            for t, data in order:
                _require(sha(srv.restore(t, reports[t].handle)).digest() == sha(data).digest(),
                         f"concurrent ingests ({label}): {t}'s restore is not its input",
                         "serve")
        finally:
            srv.close(close_store=True)
        got = {t: [r.chunks, r.dup_chunks, r.delta_chunks, r.raw_chunks, r.bytes_stored]
               for t, r in reports.items()}
        return got, lc, seconds

    serial = {"sql,vm": run(pair, "sql_vm"), "vm,sql": run(pair[::-1], "vm_sql")}
    got, lc, seconds = run(pair, "together")
    orders = [o for o, (r, l, _) in serial.items() if (r, l) == (got, lc)]
    _require(bool(orders), f"concurrent ingests: reports {got} and launches {lc} are those "
             f"of neither serial order: {({o: v[:2] for o, v in serial.items()})}", "serve")
    after = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    _require(after == tf32 and not after[1],
             f"concurrent ingests: TF32 state {tf32} -> {after}", "serve")
    return {"as_serial_order": orders, "reports": got, "launches": lc,
            "serial_launches": {o: v[1] for o, v in serial.items()},
            "seconds": seconds, "serial_seconds": {o: v[2] for o, v in serial.items()},
            "tf32_after": after}


def serve_phase(dev, main_versions: dict[str, list[bytes]]) -> dict[str, int]:
    """Phase 4e on the card: every pinned number must be SERVE_REFERENCE's,
    and kernels A, B and C must launch inside the server's ingests."""
    from repro_torch.api import objectstore, observe, serve as serve_mod
    env = types.SimpleNamespace(
        build_server=lambda d: config.build_server(config.DedupConfig.from_dict(d),
                                                   device=dev),
        build_store=lambda d: config.build_store(config.DedupConfig.from_dict(d),
                                                 device=dev),
        serve=serve_mod, faults=faults, parse=observe.parse_prometheus_text,
        dump=observe.main, cli=objectstore.main)
    marks: dict[str, dict] = {}

    def mark(label: str) -> None:
        torch.cuda.synchronize(dev)
        if label == "start":
            ops.reset_launches()
        marks[label] = dict(ops.LAUNCHES)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    t_phase = time.perf_counter()
    try:
        integrity.reset_crc32c_stats()
        pinned, measured = serve_steps(env, main_versions, tmp, mark)
        concurrent = concurrent_ingests(env, dev, main_versions, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lc = card_launches("serve: the server's ingests", counts=marks["end"])
    got = json.loads(json.dumps(pinned))
    want = json.loads(json.dumps(SERVE_REFERENCE))
    if got != want:
        diff = {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
                if got.get(k) != want.get(k)}
        fail(f"serve: not the reference's numbers: {diff}")
    ingest_mb_s = {t: sum(len(main_versions[n][v]) for tt, n, v in SERVE_ORDER if tt == t)
                   / 1e6 / measured["ingest_s"][t] for t in ("sql", "vm")}
    emit("serve", base_mib=BASE / 2**20, versions=VERSIONS, workers=4, tenant=SERVE_TENANT,
         dcr=pinned["dcr"], ingest_mb_per_s=ingest_mb_s,
         restore_mb_per_s=measured["restore_mb_per_s"], sheds=pinned["shed"],
         quota=pinned["quota"], overload=pinned["overload"], breaker=pinned["breaker"],
         spans=pinned["spans"], cli=pinned["cli"], pinned="the JAX package's",
         restored="sha256-identical", seconds=measured, concurrent=concurrent,
         crc32c=dict(route=integrity.crc32c_route(), **integrity.CRC32C_STATS),
         launches=lc, phase_s=time.perf_counter() - t_phase)
    return lc


# --- phase 4f: every CARD feature path and index on the card ------------------

# Each store: phase 4's CARD widths with one knob (config dict keys of
# "detector_args"; "feat" keys merge into FEAT's).
FEATURE_STORES = {"unfused": {"fused": False},
                  "poly": {"feat": {"lsh": "poly"}},
                  "banded": {"index": "banded-lsh"}}
# What scripts/feature_paths_dcr.py printed for each store (the JAX package
# on a CPU, the same dicts and data): (DCR, chunks, dup, delta, raw).
FEATURE_REFERENCE = {
    "sql_dump": {"unfused": (4.129564, 14533, 7728, 6796, 9),
                 "poly": (3.58046, 14533, 7728, 6795, 10),
                 "banded": (4.127169, 14533, 7728, 6796, 9)},
    "vmdk": {"unfused": (5.681883, 9547, 6753, 1704, 1090),
             "poly": (5.609139, 9547, 6753, 1698, 1096),
             "banded": (5.68022, 9547, 6753, 1704, 1090)},
}


def feature_dict(variant: str) -> dict:
    knobs = dict(FEATURE_STORES[variant])
    feat = {**dataclasses.asdict(FEAT), **knobs.pop("feat", {})}
    return {"detector": "card",
            "detector_args": {"feat": feat, "model": dataclasses.asdict(MODEL),
                              "threshold": 0.3, **knobs},
            "chunker_args": {"avg_size": CHUNKER.avg_size}}


def packed_gear_route(dev, version: bytes) -> dict:
    """The per-chunk path's gear route on one version given as chunks
    without a scan: kernel A over the chunks packed end to end
    (``features.pack_chunk_bytes``), bit-exact against the plain version
    on the whole buffer and, for every chunk, past its 31-byte warm-up,
    against the plain version run on that chunk alone; its sub-chunk
    maxes equal those read from the stream scan's host copy, and the
    extractor's features on it equal the fused path's within 3e-7
    (tests/test_ingest_fast.py's tolerance). Launches are counted over the
    extractor's call alone. Timed beside the plain version and the bound
    (as kernel A's: each byte read, each hash written; 2 operations a
    position)."""
    chunks, scan = chunk_with(CHUNKER, version, dev)
    data = [c.data for c in chunks]
    offs = np.asarray([c.offset for c in chunks], np.int64)
    packed, starts, lens = features.pack_chunk_bytes(data, dev)
    got = ops.gear_hashes(packed)
    if not torch.equal(got, gear_hash.gear_hashes_plain(packed)):
        fail("gear_hashes != plain on the packed sql_dump chunks")
    t = torch.arange(int(lens.max()), device=dev)
    valid = t[None, :] < lens[:, None]                                 # [B, Lmax]
    pos = (starts[:, None] + t[None, :])[valid]
    rows = torch.zeros(valid.shape, dtype=torch.uint8, device=dev)
    rows[valid] = packed[pos]
    alone = hashing.to_i32_bits(hashing.gear_hashes(rows))
    past_warmup = valid & (t[None, :] >= features._WARMUP)
    wrong = int((got[(starts[:, None] + t[None, :])[past_warmup]] != alone[past_warmup]).sum())
    if wrong:
        fail(f"gear_hashes on the packed chunks differs from per-chunk hashes at {wrong} "
             f"positions")
    del rows, valid, pos, alone, past_warmup
    sub_packed = features.batch_subchunk_lsh(data, FEAT, device=dev)
    sub_scan = features.batch_subchunk_lsh(data, FEAT, scan, offs, device=dev)
    if not torch.equal(sub_packed, sub_scan):
        fail("packed per-chunk sub-chunk maxes differ from the scan's")
    ext = features.FeatureExtractor(FEAT, device=dev)
    torch.cuda.synchronize(dev)
    ops.reset_launches()
    per_chunk = ext(data)
    torch.cuda.synchronize(dev)
    launches = dict(ops.LAUNCHES)
    fused = ext(data, scan, offs, lmax_floor=CHUNKER.max_size)
    err = float((per_chunk - fused).abs().max())
    if err > 3e-7:
        fail(f"per-chunk features differ from the fused path's by {err}")
    if launches["gear_hashes"] != 1 or launches["shingle_embed"] != 1:
        fail(f"the packed per-chunk route launched {launches}, not one A and one B")
    n = packed.shape[0]
    ms = time_ms(lambda: ops.gear_hashes(packed))
    plain_ms = time_ms(lambda: gear_hash.gear_hashes_plain(packed), reps=3, warmup=1)
    b_ms, b_by = bound(n + 4 * n, 2.0 * n)
    out = dict(n=n, chunks=len(chunks), kernel_ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=None, per_chunk_exact=True,
               features_max_abs_err=err, launches={k: v for k, v in launches.items() if v})
    emit("kernel", name="gear_packed", **out)
    return out


def features_phase(dev, main_versions: dict[str, list[bytes]]) -> tuple[dict, dict[str, int]]:
    """Phase 4f: each FEATURE_STORES store, built from its dict on the
    card, over phase 4's data: fit, ingest, SHA-256 restore, DCR and
    counts pinned to FEATURE_REFERENCE (the unfused store's also to phase
    4's); A, B and C launched, C never with the banded index. Launch
    counts are reset before each store and read after it. Then the
    packed per-chunk gear route on sql_dump version 1. Returns that
    route's kernel line and the launches summed over the stores."""
    launches = {"gear_scan": 0, "shingle_embed": 0, "sim_topk": 0}
    for name, versions in main_versions.items():
        total = sum(len(v) for v in versions)
        rows = {}
        t_phase = time.perf_counter()
        for variant in FEATURE_STORES:
            what = f"features {name} {variant}"
            store = config.build_store(config.DedupConfig.from_dict(feature_dict(variant)),
                                       device=dev)
            store._clock()
            ops.reset_launches()
            t0 = time.perf_counter()
            store.fit(versions[:1])
            t1 = time.perf_counter()
            for v in versions:
                store.ingest(v)
            t2 = store._clock()
            banded = variant == "banded"
            lc = card_launches(what, need=("gear_scan", "shingle_embed") if banded
                               else ("gear_scan", "shingle_embed", "sim_topk"))
            if banded and lc["sim_topk"]:
                fail(f"{what}: kernel C launched {lc['sim_topk']} times beside the banded index")
            for h, v in enumerate(versions):
                if hashlib.sha256(store.restore(h)).digest() != hashlib.sha256(v).digest():
                    fail(f"{what}: version {h} did not restore byte-identically")
            st = store.stats
            counts = (st.chunks, st.dup_chunks, st.delta_chunks, st.raw_chunks)
            want_dcr, *want_counts = FEATURE_REFERENCE[name][variant]
            if round(st.dcr, 6) != want_dcr or list(counts) != want_counts:
                fail(f"{what}: DCR {st.dcr} and counts {counts} are not the reference's "
                     f"{want_dcr} and {want_counts}")
            if variant == "unfused" and (round(st.dcr, 6) != REFERENCE_DCR[name]
                                         or counts != MAIN_COUNTS[name]):
                fail(f"{what}: DCR {st.dcr} / counts {counts} are not phase 4's "
                     f"{REFERENCE_DCR[name]} / {MAIN_COUNTS[name]}")
            rows[variant] = dict(dcr=st.dcr, counts=list(counts),
                                 ingest_mb_per_s=total / 1e6 / (t2 - t1), fit_s=t1 - t0,
                                 extract_s=st.extract_seconds, score_s=st.score_seconds,
                                 observe_s=st.observe_seconds, detect_s=st.detect_seconds,
                                 launches=lc)
            for k in launches:
                launches[k] += lc[k]
            del store
        emit("features", workload=name, base_mib=BASE / 2**20, versions=len(versions),
             bytes_in=total, stores=rows, pinned="the JAX package's",
             restored="sha256-identical",
             extract_s={"fused": MAIN_EXTRACT_S[name], "unfused": rows["unfused"]["extract_s"]},
             phase_s=time.perf_counter() - t_phase)
    return packed_gear_route(dev, main_versions["sql_dump"][1]), launches


# --- phase 4g: the CARD checkpoint store on the card ----------------------------

# bench_ckpt_store's tree (w [512, 2048] bf16, e [2048, 256] bf16, mu
# [512, 512] f32: 4 MiB a step) with each side times `scale`, drawn from
# numpy (bf16 leaves as their uint16 bits) so that scripts/ckpt_dcr.py
# hands the JAX package the same arrays. Each store: (scale, drift sigma,
# byte planes); scale 4 is 64 MiB a step.
CKPT_STORES = tuple((1, sigma, planes) for planes in (True, False)
                    for sigma in (1e-3, 1e-4, 1e-5)) + ((4, 1e-4, True),)
CKPT_STEPS = 4
# What scripts/ckpt_dcr.py printed for each store: (DCR, chunks, dup,
# delta, raw).
CKPT_REFERENCE: dict[str, tuple] = {
    "x1 sigma 0.001 planes on": (1.101695, 859, 0, 92, 767),
    "x1 sigma 0.0001 planes on": (1.378694, 871, 4, 240, 627),
    "x1 sigma 1e-05 planes on": (1.937386, 871, 134, 299, 438),
    "x1 sigma 0.001 planes off": (1.000109, 866, 0, 2, 864),
    "x1 sigma 0.0001 planes off": (1.008564, 865, 0, 9, 856),
    "x1 sigma 1e-05 planes off": (2.01897, 880, 0, 449, 431),
    "x16 sigma 0.0001 planes on": (1.375585, 13809, 42, 3834, 9933),
}


def ckpt_key(scale: int, sigma: float, planes: bool) -> str:
    return f"x{scale * scale} sigma {sigma:g} planes {'on' if planes else 'off'}"


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 (round to nearest even) as uint16 bits."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).view(
        torch.int16).numpy().view(np.uint16)


def ckpt_tree(scale: int, seed: int = 1) -> dict:
    """{"params": {"w", "e"}, "mu"}: (dtype name, numpy array) leaves."""
    rng = np.random.default_rng(seed)
    s = scale
    return {"params": {"w": ("bfloat16", bf16_bits(rng.standard_normal((512 * s, 2048 * s)))),
                       "e": ("bfloat16", bf16_bits(rng.standard_normal((2048 * s, 256 * s))))},
            "mu": ("float32", (rng.standard_normal((512 * s, 512 * s)) * 0.01).astype(np.float32))}


def ckpt_map(tree: dict, fn) -> dict:
    return {k: ckpt_map(v, fn) if isinstance(v, dict) else fn(*v) for k, v in tree.items()}


def ckpt_drift(tree: dict, rng, sigma: float) -> dict:
    """Each leaf plus N(0, sigma) noise, added in float32 and rounded once
    to the leaf's dtype."""
    def leaf(kind, a):
        noise = (rng.standard_normal(a.shape) * sigma).astype(np.float32)
        if kind == "bfloat16":
            return kind, bf16_bits((a.astype(np.uint32) << 16).view(np.float32) + noise)
        return kind, a + noise
    return ckpt_map(tree, leaf)


def ckpt_to_torch(tree: dict, device) -> dict:
    def leaf(kind, a):
        t = torch.from_numpy(np.array(a))
        return (t.view(torch.int16).view(torch.bfloat16) if kind == "bfloat16" else t).to(device)
    return ckpt_map(tree, leaf)


def ckpt_saves(store, convert, scale: int, sigma: float) -> tuple[list[dict], float]:
    """Save CKPT_STEPS drifted steps (numpy seed 0, tree seed 1, as
    bench_ckpt_store); returns the numpy trees and the save seconds."""
    rng = np.random.default_rng(0)
    tree, history, seconds = ckpt_tree(scale), [], 0.0
    for i in range(CKPT_STEPS):
        tree = ckpt_drift(tree, rng, sigma)
        converted = convert(tree)
        t0 = time.perf_counter()
        store.save(converted, step=i)
        seconds += time.perf_counter() - t0
        history.append(tree)
    return history, seconds


def ckpt_equal(got: dict, want: dict) -> bool:
    """Value-exact, leaf by leaf (bf16 by bit pattern), on ``want``'s device."""
    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    flat_got = [got["mu"], got["params"]["e"], got["params"]["w"]]
    flat_want = [want["mu"], want["params"]["e"], want["params"]["w"]]
    return all(g.device == w.device and g.dtype == w.dtype and torch.equal(bits(g), bits(w))
               for g, w in zip(flat_got, flat_want))


def plain_checkpoint_drill(dev) -> dict:
    """checkpoint.store on a CUDA state dict: save, a .tmp directory left
    as a crashed writer would, latest_step, restore onto the card."""
    model = torch.nn.Sequential(torch.nn.Linear(64, 32), torch.nn.LayerNorm(32)).to(dev)
    state = {"model": model.state_dict(),
             "emb": torch.randn(100, 16, device=dev).to(torch.bfloat16),
             "step": torch.tensor(12, dtype=torch.int32, device=dev)}
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        checkpoint.save(root, state, step=12)
        os.mkdir(os.path.join(root, "step_00000013.tmp"))
        if checkpoint.latest_step(root) != 12 or checkpoint.list_steps(root) != [12]:
            fail(f"checkpoint: the .tmp directory was listed: {checkpoint.list_steps(root)}")
        got = checkpoint.restore(root, state)
        ok = all(g.device == w.device and g.dtype == w.dtype
                 and torch.equal(g.view(torch.int16) if g.dtype == torch.bfloat16 else g,
                                 w.view(torch.int16) if w.dtype == torch.bfloat16 else w)
                 for g, w in zip(list(got["model"].values()) + [got["emb"], got["step"]],
                                 list(state["model"].values()) + [state["emb"], state["step"]]))
        if not ok:
            fail("checkpoint: the CUDA state dict did not restore value-exact on the card")
        return dict(leaves=len(state["model"]) + 2, latest_step=12, tmp_listed=False,
                    restored="value-exact, on the card")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def checkpoint_phase(dev) -> dict[str, int]:
    """Phase 4g: each CKPT_STORES store (``DedupCheckpointStore`` on the
    card, its default CARD detector) saves CKPT_STEPS drifted steps; DCR
    and counts pinned to CKPT_REFERENCE; every step restores onto the card
    value-exact. Launch counts are reset before each store and read after
    its saves; A and B must launch in each, C in the 64 MiB store (the
    smaller stores may never pass C's 512-row gate). Then the plain store's
    drill."""
    from repro_torch.checkpoint import DedupCheckpointStore
    launches = {"gear_scan": 0, "shingle_embed": 0, "sim_topk": 0}
    rows = {}
    t_phase = time.perf_counter()
    for scale, sigma, planes in CKPT_STORES:
        key = ckpt_key(scale, sigma, planes)
        what = f"checkpoint {key}"
        store = DedupCheckpointStore(byte_plane=planes, device=dev)
        torch.cuda.synchronize(dev)
        ops.reset_launches()
        history, save_s = ckpt_saves(store, lambda t: ckpt_to_torch(t, dev), scale, sigma)
        torch.cuda.synchronize(dev)
        lc = card_launches(what, need=("gear_scan", "shingle_embed", "sim_topk") if scale > 1
                           else ("gear_scan", "shingle_embed"))
        like = ckpt_to_torch(ckpt_tree(scale, seed=2), dev)
        t0 = time.perf_counter()
        for step, tree in enumerate(history):
            if not ckpt_equal(store.restore(like, step=step), ckpt_to_torch(tree, dev)):
                fail(f"{what}: step {step} did not restore value-exact on the card")
        restore_s = time.perf_counter() - t0
        st = store.stats
        counts = (st.chunks, st.dup_chunks, st.delta_chunks, st.raw_chunks)
        want_dcr, *want_counts = CKPT_REFERENCE[key]
        if round(st.dcr, 6) != want_dcr or list(counts) != want_counts:
            fail(f"{what}: DCR {st.dcr} and counts {counts} are not the reference's "
                 f"{want_dcr} and {want_counts}")
        rows[key] = dict(step_bytes=st.bytes_in // CKPT_STEPS, dcr=st.dcr, counts=list(counts),
                         save_s=save_s, save_mb_per_s=st.bytes_in / 1e6 / save_s,
                         restore_s=restore_s, launches=lc)
        for k in launches:
            launches[k] += lc[k]
        del store, history
    if launches["sim_topk"] <= 0:
        fail("checkpoint: kernel C never launched")
    emit("checkpoint", steps=CKPT_STEPS, stores=rows, pinned="the JAX package's",
         restored="value-exact, on the card", plain_store=plain_checkpoint_drill(dev),
         phase_s=time.perf_counter() - t_phase)
    return launches


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
# (prompt and new tokens cut from 64 to 16 to make room for the SSM and
# hybrid serves of phase mesh_serve)
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 16, 16
# (the profiler's post-processing grows with the steps profiled: cut
# from 8 + 16 steps to 4 + 8 to make room for phase launch)
PROFILE_PROMPT, PROFILE_GEN = 4, 8
PARITY_LAYERS, PARITY_LEN, PARITY_TOL = 4, 256, 1e-3


def timed_prefill(model, tokens, extras: dict | None = None
                  ) -> tuple[torch.Tensor, float, dict[str, float]]:
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
        logits = model.prefill(tokens, extras)
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


# --- phase 7b: the other LM archs -----------------------------------------------

# each at full width in bf16 (seeded random weights), at full depth where it
# fits one card: a prefill of PREFILL_LEN tokens, every attention sublayer
# through kernel D, every SSM sublayer through the chunked SSD
FAMILY_ARCHS = ("granite-3-8b", "phi3-medium-14b", "chatglm3-6b", "qwen3-moe-30b-a3b",
                "mamba2-130m", "jamba-v0.1-52b")
# jamba-v0.1-52b is 51.46 B parameters, 103 GB in bf16: one block period of
# its 32 layers (8: every sublayer kind, 13.27 B, 26.5 GB) on one 80 GB card
FAMILY_DEPTH = {"jamba-v0.1-52b": 8}
# long_500k's length, for an arch with a sub-quadratic mixer and nothing else
# (mamba2-130m: attention-free)
LONG_LEN = get_shape("long_500k").seq_len
# the families' serve_loop: batch 4, a 16-token prompt (token by token, as
# the reference's serve_loop fills the cache; cut from 64 to make room for
# phase mesh) and 16 new tokens
FAMILY_SERVE_PROMPT, FAMILY_SERVE_GEN = 16, 16
# the cross-attention families, at full size (llama-3.2-vision-11b is
# 10.11 B parameters, 20.2 GB in bf16): a prefill with seeded random
# extras (images [1, 1601, 4096]; frames [1, 1500, 512] through the
# encoder) and decode at batch 4 with images / the encoder's output as memory
CROSS_ARCHS = ("llama-3.2-vision-11b", "whisper-base")
# the cross archs' prefill against their own decode, f32
CROSS_DECODE_TOL = 1e-4
# card-against-CPU parity in f32 at each arch's full head layout (d_model,
# H / KV, hd, rotary fraction, activation, virtual experts, the SSM's N and
# P, the image tokens), with depth (one block period where the period is
# longer), FFN width, vocabulary and expert count cut so that the CPU side
# runs in seconds; top-k stays the arch's where it fits the cut expert
# count. whisper-base (97.2 M parameters) runs at full size
FAMILY_PARITY_ARCHS = FAMILY_ARCHS + ("grok-1-314b",) + CROSS_ARCHS
FAMILY_PARITY_FULL = ("whisper-base",)
FAMILY_PARITY_CUT = dict(num_layers=PARITY_LAYERS, d_ff=512, vocab_size=4096,
                         dtype="float32")
FAMILY_PARITY_EXPERTS = 16
# past one 256-token SSD chunk; mamba2's not a multiple of it
FAMILY_PARITY_LEN = {"mamba2-130m": 300, "jamba-v0.1-52b": 300}
NEAR_TIE = 1e-6


@contextlib.contextmanager
def moe_routes(keep_routes: bool = False):
    """Record what each MoE sublayer's routing did while the block runs:
    ``kept`` (a device count a call, read once at the end), ``assigned``,
    ``busiest`` (the share of the call's choices that went to its k
    busiest logical experts: k / E when the load is even, 1 when every
    token picks the same k) and, with ``keep_routes``, each call's router
    probabilities and experts on the host. Wraps
    ``layers._route_and_dispatch``, which ``layers.moe`` looks up at each
    call."""
    from repro_torch.models import layers
    real = layers._route_and_dispatch
    rec = {"kept": [], "assigned": [], "busiest": [], "routes": []}

    def recorded(xt, router, e, k, *args, **kwargs):
        out = real(xt, router, e, k, *args, **kwargs)
        keep, probs, expert = out[4], out[5], out[6]
        rec["kept"].append(keep.sum())
        rec["assigned"].append(keep.numel())
        load = torch.bincount(expert.reshape(-1), minlength=e)
        rec["busiest"].append(load.topk(k).values.sum() / expert.numel())
        if keep_routes:
            rec["routes"].append((probs.cpu(), expert.cpu()))
        return out

    layers._route_and_dispatch = recorded
    try:
        yield rec
    finally:
        layers._route_and_dispatch = real


def dropped_share(rec: dict, calls: slice = slice(None)) -> float | None:
    assigned = sum(rec["assigned"][calls])
    if not assigned:
        return None
    return 1.0 - float(sum(int(k) for k in rec["kept"][calls])) / assigned


def busiest_share(rec: dict) -> float | None:
    """The mean over calls of ``busiest`` (see ``moe_routes``)."""
    shares = [float(b) for b in rec["busiest"]]
    return sum(shares) / len(shares) if shares else None


def route_differences(cpu_routes: list, card_routes: list, k: int) -> dict:
    """Routing decisions (token, choice) where the card and the CPU chose
    another expert, and each such token's margin on the CPU: the smallest
    gap between neighbours among its k + 1 largest router probabilities."""
    differ, margins = 0, []
    for (probs, want), (_, got) in zip(cpu_routes, card_routes):
        rows = (want != got).any(dim=1)
        differ += int((want != got).sum())
        if rows.any():
            top = probs[rows].sort(dim=-1, descending=True).values[:, :k + 1]
            margins += (top[:, :-1] - top[:, 1:]).min(dim=1).values.tolist()
    return dict(decisions=sum(int(e.numel()) for _, e in cpu_routes), differ=differ,
                tokens_differ=len(margins), min_margin=min(margins, default=None),
                max_margin=max(margins, default=None))


def family_prefill(dev, arch: str, gen) -> int:
    """One arch at full width (depth cut by FAMILY_DEPTH): init, a 32,768-token
    prefill (kernel D's launches and time by route, peak memory with the
    weights, for MoE the share of assignments capacity dropped), and for
    an attention-free arch one at long_500k's 524,288 tokens; for every
    arch but the dense ones a profiled prefill and serve_loop at batch 4.
    Returns kernel D's launches in the prefills: one an attention
    sublayer, all on the tensor cores."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=FAMILY_DEPTH.get(arch, full.num_layers))
    kinds = layer_kinds(cfg)
    n_attn, n_moe = sum(k.mixer == "attn" for k in kinds), sum(k.moe for k in kinds)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = make_model(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated(dev)
    model.prefill(torch.randint(0, cfg.vocab_size, (1, 512), device=dev, generator=gen))
    total = 0
    for n in (PREFILL_LEN, LONG_LEN) if cfg.is_attention_free else (PREFILL_LEN,):
        tokens = torch.randint(0, cfg.vocab_size, (1, n), device=dev, generator=gen)
        if n != PREFILL_LEN:
            torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        with moe_routes() as rec:
            logits, wall, attn_ms = timed_prefill(model, tokens)
        launches = ops.LAUNCHES["flash_attention"]
        sm90_launches = ops.LAUNCHES["flash_attention_sm90"]
        peak = torch.cuda.max_memory_allocated(dev)
        if tuple(logits.shape) != (1, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
            fail(f"{arch}: prefill logits are not finite [1, {cfg.vocab_size}]")
        total_ms = sum(attn_ms.values())
        emit("lm_families", part="prefill", arch=arch, family=cfg.family,
             params=sum(p.numel() for p in model.parameters()),
             active_params=cfg.active_param_count(), dtype=cfg.dtype, layers=cfg.num_layers,
             full_layers=full.num_layers,
             heads=[cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
             attention_layers=n_attn, moe_layers=n_moe, tokens=n,
             init_s=init_s, seconds=wall, tokens_per_s=n / wall,
             flash_attention_launches=launches, flash_attention_sm90_launches=sm90_launches,
             flash_attention_ms=total_ms, flash_attention_share=total_ms / 1e3 / wall,
             weight_bytes=weights, peak_bytes=peak, dropped_share=dropped_share(rec),
             busiest_experts_share=busiest_share(rec),
             logits_abs_max=float(logits.float().abs().max()))
        if launches != n_attn or sm90_launches != n_attn:
            fail(f"{arch}: prefill launched kernel D {launches} times, {sm90_launches} on the "
                 f"tensor cores; want all {n_attn} on the tensor cores")
        total += launches
        del logits
    if cfg.family != "dense":
        # where the prefill's device time goes, by kernel (the profiler
        # adds host time; the device rows are the prefill's own)
        tokens = tokens[:, :PREFILL_LEN]
        wall_p, device_s, top = profile_device(
            lambda: (model.prefill(tokens), torch.cuda.synchronize()))
        emit("lm_families", part="prefill_profile", arch=arch, tokens=PREFILL_LEN,
             wall_s=wall_p, device_s=device_s, device_busy_share=device_s / wall_p,
             top_device_ms=top)
        prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, FAMILY_SERVE_PROMPT),
                                device=dev, generator=gen)
        ops.reset_launches()
        with moe_routes() as rec:
            out, prefill_s, decode_s = serve.serve_loop(model, prompts, FAMILY_SERVE_GEN)
        prompt_calls = slice(0, FAMILY_SERVE_PROMPT * n_moe)
        emit("lm_families", part="serve", arch=arch, batch=SERVE_BATCH,
             prompt=FAMILY_SERVE_PROMPT, gen=FAMILY_SERVE_GEN, prefill_s=prefill_s,
             decode_s=decode_s,
             prefill_tokens_per_s=SERVE_BATCH * FAMILY_SERVE_PROMPT / prefill_s,
             decode_tokens_per_s=SERVE_BATCH * FAMILY_SERVE_GEN / decode_s,
             flash_attention_launches=ops.LAUNCHES["flash_attention"],
             dropped_share_prompt=dropped_share(rec, prompt_calls),
             dropped_share_decode=dropped_share(rec, slice(prompt_calls.stop, None)),
             busiest_experts_share=busiest_share(rec),
             first_tokens=out[:, :8].tolist())
        if out.shape != (SERVE_BATCH, FAMILY_SERVE_GEN) or \
                not ((out >= 0) & (out < cfg.vocab_size)).all():
            fail(f"{arch}: serve_loop gave tokens of shape {out.shape} or outside the vocabulary")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return total


def family_parity(dev, arch: str, gen) -> None:
    """The arch's head and SSM layout with depth and widths cut
    (FAMILY_PARITY_CUT; depth one block period where that is longer;
    nothing cut for FAMILY_PARITY_FULL), in f32, with seeded random extras
    where the family takes them: the card's prefill (kernel D, the chunked
    SSD) against the CPU's plain path on the same weights and extras, last
    logits within PARITY_TOL; its routing decisions that differ between
    the card and the CPU must each be a near tie. Then the card's prefill
    against its own token-by-token decode with the same extras (the dense
    cached attention, the cross sublayers at Tq 1, the recurrent SSM step;
    within CROSS_DECODE_TOL for the cross archs), at a capacity that drops
    nothing where the stack has MoE: a prefill routes all tokens under one
    capacity, decode a token a sequence, so at the arch's capacity the
    reference's two differ too. qwen3-moe and grok-1, MoE in every layer
    and top-8 of 16 after the cut, where near ties between the two paths
    are common, are exempt from the decode check."""
    t0 = time.perf_counter()
    full = get_config(arch)
    period = block_period(full)
    cut = dict(FAMILY_PARITY_CUT, num_layers=period * max(1, PARITY_LAYERS // period))
    if full.num_experts:
        cut.update(num_experts=min(full.num_experts, FAMILY_PARITY_EXPERTS),
                   experts_per_token=min(full.experts_per_token, FAMILY_PARITY_EXPERTS // 2))
    cfg = dataclasses.replace(full, **(dict(dtype="float32") if arch in FAMILY_PARITY_FULL
                                       else cut))
    length = FAMILY_PARITY_LEN.get(arch, PARITY_LEN)
    extras = cross_extras(cfg, 1, dev, gen, torch.float32) if arch in CROSS_ARCHS else None
    cpu = make_model(cfg, device="cpu", seed=5)
    card = make_model(cfg, seed=5)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (1, length), device=dev, generator=gen)
    with moe_routes(keep_routes=True) as cpu_rec:
        want = cpu.prefill(tokens.cpu(), extras and {k: v.cpu() for k, v in extras.items()})
    with moe_routes(keep_routes=True) as card_rec:
        got = card.prefill(tokens, extras)
    del cpu
    err = float((got.cpu() - want).abs().max())
    line = dict(arch=arch, layers=cfg.num_layers, heads=[cfg.num_heads, cfg.num_kv_heads,
                cfg.head_dim], d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
                experts=[cfg.num_experts, cfg.experts_per_token, cfg.moe_ffn_shards],
                ssm=[cfg.ssm_state, cfg.ssm_head_dim] if cfg.ssm_state else None,
                extras={k: list(v.shape) for k, v in (extras or {}).items()},
                tokens=length, dtype="float32", card_vs_cpu_max_abs_err=err,
                logits_abs_max=float(want.abs().max()), tol=PARITY_TOL)
    if not torch.allclose(got.cpu(), want, rtol=PARITY_TOL, atol=PARITY_TOL):
        fail(f"{arch}: the card's prefill != the CPU's (max abs err {err})")
    if cfg.num_experts:
        diff = route_differences(cpu_rec["routes"], card_rec["routes"], cfg.experts_per_token)
        line.update(routing=diff)
        if diff["tokens_differ"] and diff["max_margin"] >= NEAR_TIE:
            fail(f"{arch}: the card routed a token otherwise than the CPU at margin "
                 f"{diff['max_margin']} (not a near tie)")
    if cfg.family == "moe":
        line.update(decode_check="exempt: MoE capacity differs between a prefill and a "
                    "token-by-token decode, in the reference too")
    else:
        if cfg.num_experts:
            nodrop = dataclasses.replace(
                cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
            model = make_model(nodrop, seed=5)
            model.load_state_dict(card.state_dict())
            got = model.prefill(tokens, extras)
            line.update(decode_capacity_factor=nodrop.capacity_factor)
        else:
            model = card
        cache = model.init_cache(1, length)
        for i in range(length):
            step, cache = model.decode_step(tokens[:, i:i + 1], cache, extras)
        derr = float((got - step).abs().max())
        tol = CROSS_DECODE_TOL if extras else PARITY_TOL
        line.update(prefill_vs_decode_max_abs_err=derr, decode_tol=tol, decode_tokens=length)
        if not torch.allclose(got, step, rtol=tol, atol=tol):
            fail(f"{arch}: prefill != token-by-token decode (max abs err {derr})")
        del model
    emit("lm_families", part="parity", seconds=time.perf_counter() - t0, **line)
    del card
    torch.cuda.empty_cache()


def cross_extras(cfg, batch: int, dev, gen, dtype) -> dict:
    """Seeded normal ``images`` (vlm) or ``frames`` (audio), [batch, T, d]."""
    n = cfg.num_image_tokens if cfg.family == "vlm" else cfg.num_audio_frames
    x = torch.randn(batch, n, cfg.d_model, device=dev, generator=gen).to(dtype)
    return {"images" if cfg.family == "vlm" else "frames": x}


def kernel_d_calls(cfg) -> tuple[int, int]:
    """Kernel D's launches in a prefill with extras (every self-attention,
    cross and encoder sublayer) and in a decode step given the memory (the
    cross sublayers)."""
    kinds = layer_kinds(cfg)
    cross = sum(k.cross for k in kinds) + (cfg.num_layers if cfg.encoder_layers else 0)
    return sum(k.mixer == "attn" for k in kinds) + cross + cfg.encoder_layers, cross


def cross_family(dev, arch: str, gen) -> int:
    """A cross-attention arch at full size in bf16: a 32,768-token prefill
    with seeded random extras (kernel D's launches, all on the tensor
    cores, and time; peak memory with the weights); serve_loop at batch 4
    with images, or with the encoder's output as memory, kernel D's
    launches a step checked; one step with the extras as f32 host tensors
    equal to the same step with them on the card; serve_loop without
    extras raising KeyError, as the reference's does. Returns kernel D's
    launches in the prefill and the serve_loop."""
    cfg = get_config(arch)
    n_prefill, n_step = kernel_d_calls(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = make_model(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated(dev)
    extras = cross_extras(cfg, 1, dev, gen, torch.bfloat16)
    model.prefill(torch.randint(0, cfg.vocab_size, (1, 512), device=dev, generator=gen), extras)
    tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_LEN), device=dev, generator=gen)
    ops.reset_launches()
    logits, wall, attn_ms = timed_prefill(model, tokens, extras)
    launches, sm90 = ops.LAUNCHES["flash_attention"], ops.LAUNCHES["flash_attention_sm90"]
    peak = torch.cuda.max_memory_allocated(dev)
    if tuple(logits.shape) != (1, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        fail(f"{arch}: prefill logits are not finite [1, {cfg.vocab_size}]")
    total_ms = sum(attn_ms.values())
    emit("lm_families", part="prefill", arch=arch, family=cfg.family,
         params=sum(p.numel() for p in model.parameters()), dtype=cfg.dtype,
         layers=cfg.num_layers, encoder_layers=cfg.encoder_layers,
         heads=[cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
         extras={k: list(v.shape) for k, v in extras.items()}, tokens=PREFILL_LEN,
         init_s=init_s, seconds=wall, tokens_per_s=PREFILL_LEN / wall,
         flash_attention_launches=launches, flash_attention_sm90_launches=sm90,
         flash_attention_ms=total_ms, flash_attention_share=total_ms / 1e3 / wall,
         weight_bytes=weights, peak_bytes=peak,
         logits_abs_max=float(logits.float().abs().max()))
    if launches != n_prefill or sm90 != n_prefill:
        fail(f"{arch}: prefill launched kernel D {launches} times, {sm90} on the tensor "
             f"cores; want all {n_prefill} on the tensor cores")
    del logits

    served = cross_extras(cfg, SERVE_BATCH, dev, gen, torch.bfloat16)
    if cfg.family == "audio":
        with torch.no_grad():
            served = {"memory": model.encode_audio(served["frames"])}
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, FAMILY_SERVE_PROMPT),
                            device=dev, generator=gen)
    ops.reset_launches()
    out, prefill_s, decode_s = serve.serve_loop(model, prompts, FAMILY_SERVE_GEN,
                                                extras=served)
    steps = FAMILY_SERVE_PROMPT + FAMILY_SERVE_GEN
    serve_launches = ops.LAUNCHES["flash_attention"]
    serve_sm90 = ops.LAUNCHES["flash_attention_sm90"]
    # the extras as f32 tensors on the host: cast and moved to the card
    host = {k: v.float().cpu() for k, v in served.items()}
    got, _ = model.decode_step(prompts[:, :1], model.init_cache(SERVE_BATCH, 1), host)
    host_launches = ops.LAUNCHES["flash_attention_sm90"] - serve_sm90
    want, _ = model.decode_step(prompts[:, :1], model.init_cache(SERVE_BATCH, 1), served)
    try:
        serve.serve_loop(model, prompts[:, :2], 1)
        no_extras = None
    except KeyError as e:
        no_extras = f"KeyError: {e}"
    emit("lm_families", part="serve", arch=arch, batch=SERVE_BATCH,
         prompt=FAMILY_SERVE_PROMPT, gen=FAMILY_SERVE_GEN,
         extras={k: list(v.shape) for k, v in served.items()},
         prefill_s=prefill_s, decode_s=decode_s,
         prefill_tokens_per_s=SERVE_BATCH * FAMILY_SERVE_PROMPT / prefill_s,
         decode_tokens_per_s=SERVE_BATCH * FAMILY_SERVE_GEN / decode_s,
         flash_attention_launches=serve_launches, flash_attention_per_step=serve_launches / steps,
         host_extras_step_equal=bool(torch.equal(got, want)), without_extras=no_extras,
         first_tokens=out[:, :8].tolist())
    if serve_launches != n_step * steps or serve_sm90 != serve_launches:
        fail(f"{arch}: serve_loop launched kernel D {serve_launches} times ({serve_sm90} on "
             f"the tensor cores) in {steps} steps; want {n_step} a step, on the tensor cores")
    if out.shape != (SERVE_BATCH, FAMILY_SERVE_GEN) or \
            not ((out >= 0) & (out < cfg.vocab_size)).all():
        fail(f"{arch}: serve_loop gave tokens of shape {out.shape} or outside the vocabulary")
    if host_launches != n_step or not torch.equal(got, want):
        fail(f"{arch}: a step with host f32 extras launched kernel D {host_launches} times "
             f"or differs from the step with the extras on the card")
    if no_extras is None:
        fail(f"{arch}: serve_loop without extras ran; the reference's raises KeyError")
    del model, served, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return launches + serve_launches


def lm_families_phase(dev) -> int:
    """Phase 7b; returns kernel D's launches in its prefills and in the
    cross archs' serve_loops."""
    gen = torch.Generator(device=dev).manual_seed(4)
    t0 = time.perf_counter()
    launches = sum(family_prefill(dev, arch, gen) for arch in FAMILY_ARCHS)
    launches += sum(cross_family(dev, arch, gen) for arch in CROSS_ARCHS)
    for arch in FAMILY_PARITY_ARCHS:
        family_parity(dev, arch, gen)
    emit("lm_families", part="summary", archs=list(FAMILY_ARCHS + CROSS_ARCHS),
         flash_attention_launches=launches, phase_s=time.perf_counter() - t0)
    return launches


# --- phase 8: training ---------------------------------------------------------

# train_4k's length (configs/base.py LM_SHAPES); its global batch of 256
# cut to what one card holds at each arch's width; granite-8b's depth cut
# from 36 layers to 8 (2.15 B parameters: bf16 params, grads and mu and
# f32 nu, each held twice while the functional update runs, with the
# model's own copy, reckon to about 48 GB; 16 layers would not fit 72 GB)
TRAIN_LEN = get_shape("train_4k").seq_len
TRAIN_STEPS = 3
TRAIN_FULL = {"granite-8b": dict(layers=8, batch=4, micro=1),
              "whisper-base": dict(layers=None, batch=8, micro=2),
              "mamba2-130m": dict(layers=None, batch=8, micro=1)}
TRAIN_PEAK_LIMIT = 72e9
# the f32 step, card against CPU: each arch's head and SSM layout at 2
# layers (whisper: 2 + 2), d_ff 512, vocabulary 4096; mamba2 over 300
# tokens, past one SSD chunk; the step's optimizer is the CPU tests'
# (tests/test_torch_train.py: eps 1e-3, so the first Adam step is a smooth
# function of the gradient, not sign(g))
TRAIN_PARITY_ARCHS = ("granite-8b", "whisper-base", "mamba2-130m")
TRAIN_PARITY_CUT = dict(num_layers=2, d_ff=512, vocab_size=4096)
TRAIN_PARITY_LEN = {"mamba2-130m": 300}
TRAIN_PARITY_BATCH = 2
TRAIN_PARITY_ADAMW = dict(learning_rate=1e-3, eps=1e-3, weight_decay=0.1)
TRAIN_TOL = 1e-4
# kernel D's gradient: (name, B, Tq, Tk, H, KV, hd, causal) at the train
# shapes: granite-8b's self-attention at train_4k, whisper-base's causal
# self-attention (GQA group 1), its cross over 1500 frames and its encoder
GRAD_SHAPES = [
    ("granite-8b train self", 1, 4096, 4096, 32, 8, 128, True),
    ("whisper-base train self", 1, 4096, 4096, 8, 8, 64, True),
    ("whisper-base train cross", 1, 4096, 1500, 8, 8, 64, False),
    ("whisper-base encoder", 1, 1500, 1500, 8, 8, 64, False),
]


def grad_err(got, want, bf16: bool) -> tuple[float, float]:
    """(max abs error, share of the bound used): the f32 bound TRAIN_TOL of
    the tensor's largest value, plus, in bf16, one rounding step of each
    value (BF16_ULP)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    bound_t = TRAIN_TOL * float(want.abs().max()) + (BF16_ULP * want.abs() if bf16 else 0.0)
    return float(diff.max()), float((diff / bound_t).max())


def check_grads(dev, gen) -> list[dict]:
    """Kernel D's forward (each route) with its gradient (torch ops) against
    autograd through ``layers._dense_attention`` in f32 on the same
    values: f32 inputs on the SIMT route, bf16 inputs (the f32 reference
    on their rounded values) on the tensor cores."""
    lines = []
    for name, b, tq, tk, h, kv, hd, causal in GRAD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attn_inputs(b, tq, tk, h, kv, hd, dtype, dev, gen)
            do = torch.randn(b, tq, h, hd, device=dev, generator=gen).to(dtype)
            ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
            before = dict(ops.LAUNCHES)
            out = ops.flash_attention(*ins, causal=causal)
            got = torch.autograd.grad(out, ins, do)
            torch.cuda.synchronize()
            route = flash_attn.route(dtype, hd)
            if (ops.LAUNCHES["flash_attention"] - before["flash_attention"] != 1
                    or ops.LAUNCHES["flash_attention_sm90"] - before["flash_attention_sm90"]
                    != int(route == "sm90")):
                fail(f"{name}: the gradient's forward did not launch kernel D once on {route}")
            ref = [t.float().requires_grad_(True) for t in (q, k, v)]
            want_out = layers._dense_attention(*ref, causal=causal)
            want = torch.autograd.grad(want_out, ref, do.float())
            errs = {}
            for what, g, w in (("out", out, want_out), *zip(("dq", "dk", "dv"), got, want)):
                if g.dtype != dtype:
                    fail(f"{name}: {what} came back in {g.dtype}, not {dtype}")
                errs[what] = grad_err(g.detach(), w.detach(), dtype == torch.bfloat16)
            line = dict(name=name, dtype=str(dtype)[6:], route=route,
                        shape=[b, tq, tk, h, kv, hd], causal=causal,
                        max_abs_err={w: e for w, (e, _) in errs.items()},
                        bound_used=max(u for _, u in errs.values()))
            lines.append(line)
            if line["bound_used"] > 1:
                fail(f"kernel D's gradient != autograd of _dense_attention at {name} "
                     f"{dtype}: {errs}")
            del q, k, v, do, ins, out, got, ref, want_out, want
    torch.cuda.empty_cache()
    return lines


def time_grad(dev, gen) -> dict:
    """Kernel D at granite-8b's train shape (B 1, T 4096, 32 / 8, hd 128,
    causal, bf16): the forward as phase attn_kernel times it, and the
    gradient's torch ops beside SDPA's backward."""
    _, b, t, _, h, kv, hd, _ = GRAD_SHAPES[0]
    q, k, v = attn_inputs(b, t, t, h, kv, hd, torch.bfloat16, dev, gen)
    row, plain = time_attn(q, k, v, "train shape")
    del plain
    do = torch.randn_like(q)
    tr = lambda x: x.transpose(1, 2)
    bwd_ms = time_ms(lambda: flash_attn.flash_attention_plain_grad(
        tr(q), tr(k), tr(v), tr(do), True), reps=3, warmup=1)
    ins = [tr(x).detach().requires_grad_(True) for x in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(*ins, is_causal=True,
                                                           enable_gqa=True)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(out, ins, tr(do), retain_graph=True),
                         reps=5, warmup=2)
    # the backward's least work in bf16: q, k, v and do read, dq, dk and dv
    # written; the products S = QK^T, dP = dO V^T, dV = P^T dO, dQ = dS K
    # and dK = dS^T Q over the causal half
    moved = 2 * (3 * q.numel() + 2 * k.numel() + 2 * v.numel())
    flops = 10.0 * b * h * t * t * hd / 2
    bwd_bound, bwd_by = bound(moved, flops, BF16_FLOP_PER_S)
    row.pop("flops")
    del q, k, v, do, ins, out
    torch.cuda.empty_cache()
    return dict(row, backward_ms=bwd_ms, library_backward_ms=lib_bwd_ms,
                backward_bound_ms=bwd_bound, backward_bound_by=bwd_by)


def dead_leaves(state) -> list[str]:
    """Leaves whose gradient was 0 everywhere: at step 1, mu = (1 - b1) g."""
    return [k for k, m in state.opt_state.mu.items() if not bool((m != 0).any())]


# int8 gradient compression (distributed/compress.py): grads of several
# shapes, lengths off the 256-value block and a bf16 leaf, through 5
# error-feedback steps on the card and on the CPU; the card's and the
# CPU's raw grads in the compressed f32 step differ by rounding, which
# moves a code by one where a value sits at a half-way point
COMPRESS_SHAPES = {"wq": ((4096, 4096), torch.float32), "scale": ((4096,), torch.float32),
                   "b257": ((257,), torch.float32), "conv": ((3, 300), torch.float32),
                   "one": ((1,), torch.float32), "emb_bf16": ((51865, 64), torch.bfloat16)}
COMPRESS_STEPS = 5
COMPRESS_FLIP_SHARE = 1e-3


class RawGradCompressor(compress.GradCompressor):
    """``GradCompressor`` that keeps the raw grads it was given, on the CPU."""

    def __call__(self, grads):
        self.raw = {k: g.detach().cpu() for k, g in grads.items()}
        return super().__call__(grads)


def code_flips(grads: dict, other: dict, groups) -> dict[str, torch.Tensor]:
    """Per param, where the int8 codes of two grad dicts (CPU tensors, the
    same names) differ, quantized over ``groups``; fails where a code moved
    by more than one."""
    out = {}
    grouped = {k for names in groups for k in names}
    for names in [*groups, *([k] for k in grads if k not in grouped)]:
        codes = [compress._quantize_leaf(torch.cat([g[k].reshape(-1).float() for k in names]))[0]
                 for g in (grads, other)]
        diff = (codes[0].int() - codes[1].int()).reshape(-1)
        if int(diff.abs().max()) > 1:
            fail(f"an int8 code of {names[0]} moved by {int(diff.abs().max())}")
        at = 0
        for k in names:
            n = grads[k].numel()
            out[k] = (diff[at:at + n] != 0).reshape(grads[k].shape)
            at += n
    return out


def compress_parity(dev) -> None:
    """``compress_decompress`` over COMPRESS_STEPS error-feedback steps on
    the card and on the CPU from the same grads: codes, scales, effective
    grads and residuals bit-equal; the card's wall ms a step."""
    cpu_gen = torch.Generator().manual_seed(12)
    res = {"cpu": None, "card": None}
    unequal = []
    card_ms = []
    for i in range(COMPRESS_STEPS):
        grads = {k: (torch.randn(shape, generator=cpu_gen) * 10.0 ** (-i)).to(dtype)
                 for k, (shape, dtype) in COMPRESS_SHAPES.items()}
        on = {"cpu": grads, "card": {k: g.to(dev) for k, g in grads.items()}}
        out = {}
        for side, g in on.items():
            r = res[side] or {k: torch.zeros_like(v, dtype=torch.float32) for k, v in g.items()}
            qs = {k: compress._quantize_leaf(v.float() + r[k]) for k, v in g.items()}
            if side == "card":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            eff, res[side] = compress.compress_decompress(g, res[side])
            if side == "card":
                torch.cuda.synchronize()
                card_ms.append((time.perf_counter() - t0) * 1e3)
            out[side] = (qs, eff, res[side])
        for k in COMPRESS_SHAPES:
            (qa, ea, ra), (qb, eb, rb) = out["cpu"], out["card"]
            pairs = [qa[k][0], qb[k][0].cpu()], [qa[k][1], qb[k][1].cpu()], \
                [ea[k], eb[k].cpu()], [ra[k], rb[k].cpu()]
            for what, (a, b) in zip(("codes", "scales", "effective", "residual"), pairs):
                if a.dtype != b.dtype or not torch.equal(raw_bytes(a), raw_bytes(b)):
                    unequal.append([i, k, what])
    n = sum(torch.Size(shape).numel() for shape, _ in COMPRESS_SHAPES.values())
    emit("train", part="compress",
         shapes={k: [list(s), str(d)[6:]] for k, (s, d) in COMPRESS_SHAPES.items()},
         elements=n, steps=COMPRESS_STEPS, bit_equal=not unequal, unequal=unequal[:10],
         card_ms_per_step=card_ms)
    if unequal:
        fail(f"int8 compression differs between card and CPU: {unequal[:5]}")


def train_parity(dev, arch: str, gen) -> None:
    """One f32 train step, card against CPU, at 1 and at 2 microbatches:
    loss, nll, aux, grad_norm relative and each moment leaf within
    TRAIN_TOL of its largest value, each param leaf within TRAIN_TOL of its
    largest plus 100 TRAIN_TOL lr (tests/test_torch_train.py's rule);
    every parameter's gradient nonzero on the card (kernel D's output has
    a backward, or wq, wk, wv and all before attention would get none);
    kernel D launched twice a microbatch and attention sublayer (remat
    recomputes the forward)."""
    full = get_config(arch)
    cut = dict(TRAIN_PARITY_CUT, dtype="float32")
    if full.encoder_layers:
        cut["encoder_layers"] = TRAIN_PARITY_CUT["num_layers"]
    cfg = dataclasses.replace(full, **cut)
    length = TRAIN_PARITY_LEN.get(arch, PARITY_LEN)
    cpu = make_model(cfg, device="cpu", seed=5)
    card = make_model(cfg, seed=5)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(11)
    batch = TokenPipeline(TokenPipelineConfig(cfg.vocab_size, TRAIN_PARITY_BATCH, length)
                          ).batch(0)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (TRAIN_PARITY_BATCH, cfg.num_audio_frames, cfg.d_model)).astype(np.float32)
    calls = kernel_d_calls(cfg)[0] - cfg.encoder_layers       # the remat'd decoder's
    groups = convert.lm_leaf_groups(cpu)
    for micro, compressed in ((1, False), (2, False), (1, True)):
        tx = optim.adamw(**TRAIN_PARITY_ADAMW)
        hooks = [RawGradCompressor(groups) if compressed else None for _ in range(2)]
        t0 = time.perf_counter()
        want_state, want = train.make_train_step(
            cpu, tx, num_microbatches=micro, compress_grads=hooks[0])(
            train.init_state(train.model_params(cpu), tx), batch)
        cpu_s = time.perf_counter() - t0
        ops.reset_launches()
        t0 = time.perf_counter()
        state, got = train.make_train_step(
            card, tx, num_microbatches=micro, compress_grads=hooks[1])(
            train.init_state(train.model_params(card), tx), batch)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = ops.LAUNCHES["flash_attention"]
        flipped = code_flips(hooks[1].raw, hooks[0].raw, groups) if compressed else {}
        n_flipped = sum(int(m.sum()) for m in flipped.values())
        n_elems = sum(p.numel() for p in state.params.values())
        metric_err = {k: abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-30)
                      for k in want}
        errs = {}
        for what, mine, ref in (("params", state.params, want_state.params),
                                ("mu", state.opt_state.mu, want_state.opt_state.mu),
                                ("nu", state.opt_state.nu, want_state.opt_state.nu)):
            used = 0.0
            for name, w in ref.items():
                extra = 100 * TRAIN_TOL * TRAIN_PARITY_ADAMW["learning_rate"] \
                    if what == "params" else 0.0
                lim = TRAIN_TOL * float(w.abs().max()) + extra
                diff = (mine[name].cpu() - w).abs()
                if name in flipped:
                    diff = diff[~flipped[name]]
                worst = float(diff.max()) if diff.numel() else 0.0
                used = max(used, worst / max(lim, 1e-30))
            errs[what] = used
        dead = dead_leaves(state)
        emit("train", part="parity", arch=arch, micro=micro, compress_grads=compressed,
             code_flips=[n_flipped, n_elems] if compressed else None, layers=cfg.num_layers,
             encoder_layers=cfg.encoder_layers,
             heads=[cfg.num_heads, cfg.num_kv_heads, cfg.head_dim], d_model=cfg.d_model,
             ssm=[cfg.ssm_state, cfg.ssm_head_dim] if cfg.ssm_state else None,
             batch=TRAIN_PARITY_BATCH, tokens=length, dtype="float32",
             metrics={k: float(v) for k, v in got.items()}, metric_rel_err=metric_err,
             bound_used=errs, tol=TRAIN_TOL, cpu_s=cpu_s, card_s=card_s,
             flash_attention_launches=launches, zero_grad_leaves=dead)
        if dead:
            fail(f"{arch}: no gradient reached {dead} on the card")
        if max(metric_err.values()) > TRAIN_TOL or max(errs.values()) > 1:
            fail(f"{arch}: the card's f32 train step != the CPU's ({metric_err}, {errs})")
        if launches != 2 * calls * micro + cfg.encoder_layers * micro:
            fail(f"{arch}: the train step launched kernel D {launches} times")
        if n_flipped > COMPRESS_FLIP_SHARE * n_elems:
            fail(f"{arch}: {n_flipped} of {n_elems} int8 codes differ between card and CPU")
        del state, want_state, hooks
    del cpu, card
    gc.collect()
    torch.cuda.empty_cache()


def train_full(dev, arch: str, gen) -> int:
    """bf16 at full width (granite-8b's depth cut, TRAIN_FULL), remat on,
    TRAIN_STEPS steps of train_4k's length from the token pipeline (whisper
    with seeded random frames): step seconds, tokens/s, peak memory,
    kernel D's launches a step, each step's loss. Gates: a finite loss,
    params that changed, every gradient nonzero, the peak under
    TRAIN_PEAK_LIMIT. Returns kernel D's launches."""
    spec = TRAIN_FULL[arch]
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=spec["layers"] or full.num_layers)
    torch.cuda.reset_peak_memory_stats(dev)
    model = make_model(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    weights = torch.cuda.memory_allocated(dev)
    tx = optim.adamw(optim.cosine_schedule(3e-4, 1, 100), weight_decay=0.1,
                     max_grad_norm=1.0)
    train_step = train.make_train_step(model, tx, num_microbatches=spec["micro"])
    state = train.init_state(train.model_params(model), tx)
    pipe = TokenPipeline(TokenPipelineConfig(cfg.vocab_size, spec["batch"], TRAIN_LEN))
    frames = (cross_extras(cfg, spec["batch"], dev, gen, torch.bfloat16)
              if cfg.family == "audio" else {})
    first = {k: v[:64].clone() for k, v in state.params.items()}
    losses, seconds, launches, norms = [], [], [], []
    for i in range(TRAIN_STEPS):
        batch = dict(pipe.batch(i), **frames)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches.append(ops.LAUNCHES["flash_attention"])
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if i == 0:
            dead = dead_leaves(state)
    peak = torch.cuda.max_memory_allocated(dev)
    moved = [k for k, v in first.items() if not torch.equal(state.params[k][:64], v)]
    tokens = spec["batch"] * TRAIN_LEN
    steady = sorted(seconds[1:])[len(seconds[1:]) // 2]
    emit("train", part="full", arch=arch, family=cfg.family, params=n_params,
         layers=cfg.num_layers, full_layers=full.num_layers, dtype=cfg.dtype,
         batch=spec["batch"], microbatches=spec["micro"], tokens=TRAIN_LEN, remat=True,
         step_s=seconds, tokens_per_s=tokens / steady, losses=losses, grad_norms=norms,
         flash_attention_launches_per_step=launches,
         weight_bytes=weights, peak_bytes=peak, peak_limit=TRAIN_PEAK_LIMIT,
         zero_grad_leaves=dead, leaves_unchanged=len(first) - len(moved))
    if not all(np.isfinite(losses)):
        fail(f"{arch}: a train step's loss is not finite: {losses}")
    if dead or len(moved) != len(first):
        fail(f"{arch}: {len(dead)} leaves got no gradient, {len(first) - len(moved)} "
             "did not move")
    if peak >= TRAIN_PEAK_LIMIT:
        fail(f"{arch}: the train step's peak {peak / 1e9:.2f} GB passed the limit")
    del model, state, train_step, first
    gc.collect()
    torch.cuda.empty_cache()
    return sum(launches)


def train_phase(dev) -> tuple[int, dict]:
    """Phase 8; returns kernel D's launches in the full-width train steps
    and the kernel line's train row."""
    gen = torch.Generator(device=dev).manual_seed(8)
    t0 = time.perf_counter()
    grads = check_grads(dev, gen)
    emit("train", part="kernel_grad", checks=grads, tol=TRAIN_TOL, bf16_ulp_rtol=BF16_ULP)
    compress_parity(dev)
    for arch in TRAIN_PARITY_ARCHS:
        train_parity(dev, arch, gen)
    launches = {arch: train_full(dev, arch, gen) for arch in TRAIN_FULL}
    row = time_grad(dev, gen)
    row["launches"] = launches["granite-8b"]
    emit("train", part="summary", flash_attention_launches=launches, train_row=row,
         phase_s=time.perf_counter() - t0)
    return sum(launches.values()), row


# --- phase 9: the training launcher, the supervisor and the --dedup-ckpt mirror -

# whisper-base at full size (97.2 M params; it trains on one card, phase
# train): its path launches kernel D forward with D's gradient, and the
# mirror kernels A, B and C over the params of each checkpoint (about
# 194 MB of bf16 a save). Saves at steps 3, 6 and 9; the first process
# crashes at 7 and the second resumes from 6.
LAUNCH_ARCH = "whisper-base"
LAUNCH_ARGS = ["--arch", LAUNCH_ARCH, "--full", "--steps", "10", "--batch", "2",
               "--seq", "256", "--checkpoint-every", "3", "--dedup-ckpt"]
LAUNCH_FAIL_AT, LAUNCH_RESUME, LAUNCH_LAST = 7, 6, 9
LAUNCH_TIMEOUT_S = 400
DCR_LINE = re.compile(r"^\[dedup-ckpt\] DCR=(\d+\.\d+) stored=(\d+)MiB raw=(\d+)MiB$")


def supervised_run(ckpt_dir: str, out: dict) -> None:
    """``supervisor --retries 2 -- launch.train LAUNCH_ARGS --fail-at 7`` as
    a subprocess in its own session (killed with its worker past
    LAUNCH_TIMEOUT_S): fills ``out`` with the process, its lines, each
    attempt's wall seconds and the rc."""
    cmd = [sys.executable, "-m", "repro_torch.launch.supervisor", "--retries", "2", "--",
           sys.executable, "-m", "repro_torch.launch.train", *LAUNCH_ARGS,
           "--fail-at", str(LAUNCH_FAIL_AT), "--ckpt-dir", ckpt_dir]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = out["proc"] = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=env,
        start_new_session=True)
    timer = threading.Timer(LAUNCH_TIMEOUT_S, stop_supervised, (out,))
    timer.start()
    lines, attempts, mark = [], [], t0
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if line.startswith("[supervisor] worker"):
                now = time.perf_counter()
                attempts.append(now - mark)
                mark = now
        out["rc"] = proc.wait()
    finally:
        timer.cancel()
        out.update(wall_s=time.perf_counter() - t0, attempt_s=attempts, log=lines)


def stop_supervised(out: dict) -> None:
    """Kill the supervised run's session (the supervisor and its worker)."""
    proc = out.get("proc")
    if proc is not None and proc.poll() is None:
        os.killpg(proc.pid, 9)
        proc.wait()


def inprocess_run(ckpt_dir: str) -> dict:
    """``launch.train.main(LAUNCH_ARGS)`` in this process, uninterrupted:
    its lines, step seconds (synchronised), the seconds of each
    checkpoint save and each mirror save, the peak memory, and the
    launches of each kernel (counts set to 0 just before)."""
    step_s, save_s, mirror_s = [], [], []
    real_build, real_save, real_store = launch_train.build, launch_train.save, \
        launch_train.DedupCheckpointStore

    def timed(fn, into):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            into.append(time.perf_counter() - t0)
            return out
        return call

    def build(args):
        cfg, model, tx, step_fn, pipe = real_build(args)
        return cfg, model, tx, timed(step_fn, step_s), pipe

    def store(*args, **kwargs):
        st = real_store(*args, **kwargs)
        st.save = timed(st.save, mirror_s)
        return st

    launch_train.build, launch_train.save = build, timed(real_save, save_s)
    launch_train.DedupCheckpointStore = store
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = launch_train.main([*LAUNCH_ARGS, "--ckpt-dir", ckpt_dir])
    finally:
        launch_train.build, launch_train.save = real_build, real_save
        launch_train.DedupCheckpointStore = real_store
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    return dict(rc=rc, wall_s=wall, step_s=step_s, save_s=save_s, mirror_s=mirror_s,
                peak_bytes=torch.cuda.max_memory_allocated(), launches=launches,
                log=out.getvalue().splitlines())


def raw_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def start_supervised() -> dict:
    """``supervised_run`` on a thread in a fresh temporary root -> its
    record (``root``, ``worker``; the run's fields as it fills them).
    Killed and removed at exit."""
    import atexit

    root = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    sup = {"rc": None, "root": root, "started": time.perf_counter()}
    sup["worker"] = threading.Thread(target=supervised_run,
                                     args=(os.path.join(root, "supervised"), sup))
    sup["worker"].start()
    atexit.register(shutil.rmtree, root, True)
    atexit.register(stop_supervised, sup)
    return sup


def launch_phase(dev) -> dict[str, int]:
    """Phase 9: the supervised run (crash at 7, resume at 6, 10 steps,
    three mirror lines, each DCR >= 1) beside the same arguments run in
    this process without a crash; then both step-9 TrainStates restored
    onto the card: params, mu, nu and the steps equal bit for bit. Returns
    the in-process run's kernel launches."""
    t_phase = time.perf_counter()
    sup = start_supervised()
    root = sup["root"]
    try:
        try:
            inproc = inprocess_run(os.path.join(root, "inprocess"))
            sup["worker"].join(max(1.0, LAUNCH_TIMEOUT_S - (time.perf_counter()
                                                            - sup["started"])))
        finally:
            stop_supervised(sup)
            sup["worker"].join()
        sup_dcr = [float(m.group(1)) for m in map(DCR_LINE.match, sup["log"]) if m]
        dcr = [float(m.group(1)) for m in map(DCR_LINE.match, inproc["log"]) if m]
        steps = {name: checkpoint.list_steps(os.path.join(root, name))
                 for name in ("supervised", "inprocess")}
        model = make_model(get_config(LAUNCH_ARCH), seed=0)
        like = train.init_state(train.model_params(model), optim.adamw(3e-3))
        got = {name: checkpoint.restore(os.path.join(root, name), like, LAUNCH_LAST)
               for name in ("supervised", "inprocess")}
        a = checkpoint.store.flatten_with_path(got["supervised"])
        b = checkpoint.store.flatten_with_path(got["inprocess"])
        on_card = all(t.device.type == "cuda" for _, t in a + b)
        differ = [pa for (pa, ta), (_, tb) in zip(a, b)
                  if ta.dtype != tb.dtype or not torch.equal(raw_bytes(ta), raw_bytes(tb))]
        del model, like, got, a, b
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("launch", part="supervised", args=LAUNCH_ARGS, fail_at=LAUNCH_FAIL_AT,
         rc=sup["rc"], wall_s=sup["wall_s"], attempt_s=sup["attempt_s"],
         dcr_lines=[ln for ln in sup["log"] if DCR_LINE.match(ln)],
         first_process_dcr_rose=len(sup_dcr) >= 2 and sup_dcr[1] > sup_dcr[0],
         log=sup["log"])
    emit("launch", part="inprocess", rc=inproc["rc"], wall_s=inproc["wall_s"],
         step_s=inproc["step_s"], checkpoint_save_s=inproc["save_s"],
         mirror_save_s=inproc["mirror_s"], peak_bytes=inproc["peak_bytes"],
         launches=inproc["launches"], dcr_lines=[ln for ln in inproc["log"]
                                                 if DCR_LINE.match(ln)], log=inproc["log"])
    emit("launch", part="resume", steps=steps, restored_on_card=on_card,
         bit_equal=not differ, differing_leaves=differ[:10],
         phase_s=time.perf_counter() - t_phase)
    log = "\n".join(sup["log"])
    want = (f"[failure-injection] crashing at step {LAUNCH_FAIL_AT}",
            f"[resume] restored step {LAUNCH_RESUME} from", "[done] 10 steps in ",
            "[supervisor] worker finished (attempt 1)")
    if sup["rc"] != 0 or not all(w in log for w in want):
        fail(f"the supervised launcher run failed (rc {sup['rc']}): {sup['log'][-12:]}")
    if len(sup_dcr) != 3 or min(sup_dcr) < 1.0:
        fail(f"the supervised run's mirror printed {sup_dcr}, want three DCRs >= 1")
    if inproc["rc"] != 0 or len(dcr) != 3 or min(dcr) < 1.0:
        fail(f"the in-process launcher run failed: {inproc['log'][-6:]}")
    if steps["supervised"] != [3, 6, LAUNCH_LAST] or steps["inprocess"] != [3, 6, LAUNCH_LAST]:
        fail(f"checkpoints at {steps}, want [3, 6, {LAUNCH_LAST}] in each run")
    if not on_card or differ:
        fail(f"the resumed run's step-{LAUNCH_LAST} state != the uninterrupted run's "
             f"(on the card: {on_card}): {differ[:10]}")
    lc = card_launches("the launcher's main path", counts=inproc["launches"])
    lc["flash_attention"] = inproc["launches"]["flash_attention"]
    if lc["flash_attention"] == 0:
        fail("the launcher's main path launched no flash_attention")
    return lc


# stream bytes per version, versions, and the largest index kernel C scans
BASE, VERSIONS, BIG_N = 32 << 20, 4, 1 << 20


# --- phase 10: the sharded train step on a device mesh --------------------------

# qwen3-moe-30b-a3b at full width (d 2048, 32 / 4 heads at hd 64, 128 experts
# top-8, vocabulary 151,936) and 2 of its 48 layers: 1.85 B parameters,
# about 18.5 GB of bf16 train state at 10 bytes a parameter
MESH_ARCH, MESH_LAYERS = "qwen3-moe-30b-a3b", 2
MESH_BATCH, MESH_LEN, MESH_STEPS = 2, 2048, 3
MESH_F32_BATCH, MESH_F32_LEN = 1, 1024
MESH_RTOL = 1e-6
# the bf16 steps on and off the mesh: one rank runs the same local ops, so
# their losses and grad norms agree far inside this (equal on an H100); a
# lookup or a gradient routed through another op shows here (a bf16
# embedding gradient summed in f32 moved the grad norm by 18 %)
MESH_BF16_RTOL = 1e-3
# mamba2-130m at full size (24 layers, d 768, 128.9 M parameters): the SSM
# mixer's chunked scan in shard_map, the same steps and batches; its f32
# step at 2 layers
MESH_SSM_ARCH, MESH_SSM_F32_LAYERS = "mamba2-130m", 2


def mesh_run(model, init: dict, batches: list, tx, mesh, rules) -> dict:
    """The train step over ``batches`` from ``init``: on ``mesh`` under
    ``use_rules(rules, mesh)`` with the params laid out by
    ``distribute_params``, or without a mesh (``mesh`` None). Returns the
    metrics, step seconds, peak memory, kernel D's launches inside the
    steps, the NCCL all_to_all calls, the final params (plain), the leaves
    whose first gradient was 0 everywhere and those that did not move."""
    import torch.distributed as tdist
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding

    calls = [0]
    a2a = tdist.all_to_all_single
    whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t

    def counted(*args, **kwargs):
        calls[0] += 1
        return a2a(*args, **kwargs)

    torch.cuda.reset_peak_memory_stats()
    step = train.make_train_step(model, tx)
    scope = sharding.use_rules(rules, mesh) if mesh is not None else contextlib.nullcontext()
    losses, norms, seconds = [], [], []
    tdist.all_to_all_single = counted
    try:
        with scope:
            params = (sharding.distribute_params(init, mesh, rules) if mesh is not None
                      else dict(init))
            state = train.init_state(params, tx)
            del params
            ops.reset_launches()
            for i, batch in enumerate(batches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                if i == 0:
                    # at step 1, mu = (1 - b1) g
                    dead = [k for k, mu in state.opt_state.mu.items()
                            if not bool((whole(mu) != 0).any())]
            launches = dict(ops.LAUNCHES)
    finally:
        tdist.all_to_all_single = a2a
    final = {k: whole(v) for k, v in state.params.items()}
    still = [k for k, v in final.items() if torch.equal(v, init[k])]
    placements = {tuple(map(str, v.placements)) for v in state.params.values()
                  if isinstance(v, DTensor)}
    del state
    return dict(losses=losses, grad_norms=norms, step_s=seconds, final=final,
                peak_bytes=torch.cuda.max_memory_allocated(),
                flash_attention=launches["flash_attention"],
                flash_attention_sm90=launches["flash_attention_sm90"],
                nccl_all_to_all=calls[0], placements=sorted(placements), dead=dead,
                unmoved=still)


def mesh_pair(cfg, rules, b: int, n: int, steps: int, mesh, extras: dict | None = None
              ) -> tuple[dict, dict, dict, float]:
    """``steps`` AdamW steps of a fresh ``cfg`` model (seed 0) on ``mesh``
    and off it, from the same params and token batches [b, n] (each with
    ``extras``) -> (on, off, the relative loss and grad norm differences,
    the largest param difference)."""
    model = make_model(cfg, seed=0)
    init = train.model_params(model)     # the step is pure: both runs start here
    pipe = TokenPipeline(TokenPipelineConfig(cfg.vocab_size, b, n))
    batches = [dict(pipe.batch(i), **(extras or {})) for i in range(steps)]
    tx = optim.adamw(3e-4, weight_decay=0.1)
    on = mesh_run(model, init, batches, tx, mesh, rules)
    off = mesh_run(model, init, batches, tx, None, None)
    on["params"] = sum(v.numel() for v in init.values())
    diff = max(float((on["final"][k].float() - off["final"][k].float()).abs().max())
               for k in init)
    rel = {k: [abs(x - y) / max(abs(y), 1e-30) for x, y in zip(on[k], off[k])]
           for k in ("losses", "grad_norms")}
    return on, off, rel, diff


def mesh_ssm(mesh, backend: str) -> None:
    """mamba2-130m on the mesh and off it: 3 bf16 steps at full size, then
    one f32 step at 2 layers. Gates: finite losses, every gradient nonzero,
    every param moved, the bf16 steps within MESH_BF16_RTOL of those off the
    mesh, and the f32 step's loss, grad norm and params within MESH_RTOL."""
    from repro_torch.distributed import sharding

    full = get_config(MESH_SSM_ARCH)
    for dtype, layers, b, n, steps in (
            ("bfloat16", full.num_layers, MESH_BATCH, MESH_LEN, MESH_STEPS),
            ("float32", MESH_SSM_F32_LAYERS, MESH_F32_BATCH, MESH_F32_LEN, 1)):
        cfg = dataclasses.replace(full, num_layers=layers, dtype=dtype)
        on, off, rel, diff = mesh_pair(cfg, sharding.default_rules(cfg), b, n, steps, mesh)
        scale = max(float(v.float().abs().max()) for v in on["final"].values())
        emit("mesh", part=f"ssm_{dtype}", arch=MESH_SSM_ARCH, dtype=dtype, layers=layers,
             full_layers=full.num_layers, params=on["params"],
             batch=b, tokens=n, steps=steps, mesh=mesh.shape, backend=backend,
             placements=on["placements"],
             **{f"{k}_mesh": on[k] for k in ("losses", "grad_norms", "step_s", "peak_bytes",
                                             "flash_attention", "dead", "unmoved")},
             **{f"{k}_no_mesh": off[k] for k in ("losses", "grad_norms", "step_s",
                                                 "peak_bytes")},
             rel_diff=rel, max_param_diff=diff, param_abs_max=scale,
             bit_equal=diff == 0 and max(max(v) for v in rel.values()) == 0)
        if not all(np.isfinite(on["losses"] + on["grad_norms"])):
            fail(f"mesh {MESH_SSM_ARCH} {dtype}: a loss or grad norm is not finite")
        if on["dead"] or on["unmoved"]:
            fail(f"mesh {MESH_SSM_ARCH} {dtype}: no gradient for {on['dead']}, not moved: "
                 f"{on['unmoved']}")
        if on["flash_attention"] or off["flash_attention"]:
            fail(f"mesh {MESH_SSM_ARCH}: kernel D launched in an attention-free arch")
        tol = MESH_RTOL if dtype == "float32" else MESH_BF16_RTOL
        if max(max(v) for v in rel.values()) > tol \
                or (dtype == "float32" and diff > MESH_RTOL * scale):
            fail(f"mesh {MESH_SSM_ARCH}: the {dtype} steps on the mesh != without it: {rel}, "
                 f"params {diff}")
        del on, off
        gc.collect()
        torch.cuda.empty_cache()


# whisper-base at full size (97.2 M parameters): its encoder's non-causal
# self-attention and every decoder layer's cross sublayer through kernel D
# in shard_map, the frames laid out by ("batch", None, None); 3 bf16 steps
# at 2 x 2,048 tokens with seeded random frames [2, 1500, 512]
MESH_CROSS_ARCH = "whisper-base"


def mesh_cross(mesh, backend: str) -> int:
    """whisper-base on the mesh and off it: 3 bf16 steps at full size with
    the same frames. Gates: finite losses, every gradient nonzero, every
    param moved, losses and grad norms within MESH_BF16_RTOL and params
    within MESH_BF16_RTOL of their largest value of those off the mesh,
    kernel D's launches equal on both (18 a forward, remat doubles them),
    all on the tensor cores. Returns D's launches on the mesh."""
    from repro_torch.distributed import sharding

    cfg = get_config(MESH_CROSS_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(10)
    frames = torch.randn(MESH_BATCH, cfg.num_audio_frames, cfg.d_model, device="cuda",
                         generator=gen).to(torch.bfloat16)
    rules = sharding.default_rules(cfg)
    on, off, rel, diff = mesh_pair(cfg, rules, MESH_BATCH, MESH_LEN, MESH_STEPS, mesh,
                                   {"frames": frames})
    scale = max(float(v.float().abs().max()) for v in on["final"].values())
    # remat runs each decoder block's forward twice, the encoder once
    per_step = 2 * (kernel_d_calls(cfg)[0] - cfg.encoder_layers) + cfg.encoder_layers
    emit("mesh", part="cross", arch=MESH_CROSS_ARCH, dtype=cfg.dtype, layers=cfg.num_layers,
         encoder_layers=cfg.encoder_layers, params=on["params"], batch=MESH_BATCH,
         tokens=MESH_LEN, frames=cfg.num_audio_frames, steps=MESH_STEPS, mesh=mesh.shape,
         backend=backend, placements=on["placements"],
         **{f"{k}_mesh": on[k] for k in ("losses", "grad_norms", "step_s", "peak_bytes",
                                         "flash_attention", "flash_attention_sm90", "dead",
                                         "unmoved")},
         **{f"{k}_no_mesh": off[k] for k in ("losses", "grad_norms", "step_s", "peak_bytes",
                                             "flash_attention")},
         rel_diff=rel, max_param_diff=diff, param_abs_max=scale,
         bit_equal=diff == 0 and max(max(v) for v in rel.values()) == 0)
    if not all(np.isfinite(on["losses"] + on["grad_norms"])):
        fail(f"mesh {MESH_CROSS_ARCH}: a loss or grad norm is not finite")
    if on["dead"] or on["unmoved"]:
        fail(f"mesh {MESH_CROSS_ARCH}: no gradient for {on['dead']}, not moved: {on['unmoved']}")
    want = per_step * MESH_STEPS
    if not (on["flash_attention"] == off["flash_attention"] == on["flash_attention_sm90"]
            == want):
        fail(f"mesh {MESH_CROSS_ARCH}: kernel D {on['flash_attention']} on the mesh "
             f"({on['flash_attention_sm90']} tensor-core), {off['flash_attention']} off; "
             f"want {want}")
    if max(max(v) for v in rel.values()) > MESH_BF16_RTOL or diff > MESH_BF16_RTOL * scale:
        fail(f"mesh {MESH_CROSS_ARCH}: the steps on the mesh != without it: {rel}, "
             f"params {diff}")
    launches = on["flash_attention"]
    del on, off
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def mesh_phase(dev, mesh) -> int:
    """Phase 10 (see the module docstring) on ``mesh``, main's one-rank
    NCCL ``make_host_mesh()``; returns kernel D's launches in the mesh
    steps."""
    import torch.distributed as tdist

    from repro_torch.distributed import sharding

    t0 = time.perf_counter()
    backend = tdist.get_backend()
    if backend != "nccl" or mesh.device_type != "cuda" or mesh.shape != {"data": 1,
                                                                       "model": 1}:
        fail(f"mesh: want a 1 x 1 NCCL mesh on the card, got {mesh} over {backend}")
    full = get_config(MESH_ARCH)
    rows, total = {}, 0
    for dtype, b, n, steps in (("bfloat16", MESH_BATCH, MESH_LEN, MESH_STEPS),
                               ("float32", MESH_F32_BATCH, MESH_F32_LEN, 1)):
        cfg = dataclasses.replace(full, num_layers=MESH_LAYERS, dtype=dtype)
        rules = sharding.default_rules(cfg)
        if rules.moe_mode != "ep":
            fail(f"mesh: {MESH_ARCH}'s default rules take moe_mode {rules.moe_mode}")
        on, off, rel, diff = mesh_pair(cfg, rules, b, n, steps, mesh)
        per_step = 2 * sum(k.mixer == "attn" for k in layer_kinds(cfg))   # remat
        row = dict(arch=MESH_ARCH, dtype=dtype, layers=cfg.num_layers,
                   full_layers=full.num_layers, params=on["params"], batch=b, tokens=n,
                   steps=steps, mesh=mesh.shape, backend=backend,
                   moe_mode=rules.moe_mode, placements=on["placements"],
                   **{f"{k}_mesh": on[k] for k in ("losses", "grad_norms", "step_s",
                                                   "peak_bytes", "flash_attention",
                                                   "flash_attention_sm90",
                                                   "nccl_all_to_all")},
                   **{f"{k}_no_mesh": off[k] for k in ("losses", "grad_norms", "step_s",
                                                       "peak_bytes", "flash_attention")},
                   rel_diff=rel, max_param_diff=diff)
        emit("mesh", part=dtype, **row)
        rows[dtype] = row
        if not all(np.isfinite(on["losses"] + on["grad_norms"])):
            fail(f"mesh {dtype}: a loss or grad norm is not finite: {row}")
        if on["flash_attention"] <= 0 or on["flash_attention"] != off["flash_attention"] \
                or on["flash_attention"] != per_step * steps:
            fail(f"mesh {dtype}: kernel D launched {on['flash_attention']} times on the "
                 f"mesh, {off['flash_attention']} without; want {per_step * steps}")
        if dtype == "bfloat16" and on["flash_attention_sm90"] != on["flash_attention"]:
            fail(f"mesh: {on['flash_attention_sm90']} of kernel D's bf16 launches ran "
                 "on the tensor cores")
        if on["nccl_all_to_all"] <= 0 or off["nccl_all_to_all"] != 0:
            fail(f"mesh {dtype}: {on['nccl_all_to_all']} NCCL all_to_all calls on the "
                 f"mesh, {off['nccl_all_to_all']} without")
        if max(max(v) for v in rel.values()) > (MESH_RTOL if dtype == "float32"
                                                 else MESH_BF16_RTOL):
            fail(f"mesh: the {dtype} steps on the mesh != without it: {rel}")
        total += on["flash_attention"]
        del on, off
        gc.collect()
        torch.cuda.empty_cache()
    mesh_ssm(mesh, backend)
    total += mesh_cross(mesh, backend)
    emit("mesh", part="summary", flash_attention_launches=total,
         phase_s=time.perf_counter() - t0)
    return total


# --- phase 11: serving on the device mesh, and the pipeline ---------------------

# granite-8b at full width and 8 of its 36 layers (as phase train runs it;
# cut from full depth to make room for the SSM and hybrid serves) served
# as decode_32k and long_500k lower their decode: batch 4 (long: 1), a
# 16-token prompt, 16 new tokens; the f32 check at 2 layers
MS_LAYERS = 8
MS_BATCH, MS_LONG_BATCH, MS_PROMPT, MS_GEN = 4, 1, 16, 16
MS_F32_LAYERS, MS_F32_RTOL = 2, 1e-5
MS_PREFILL_LEN = 4096
# the prefill on the mesh runs the same local ops on one rank (kernel D
# included): a wrong layer or layout moves the logits by O(1), rounding a
# few bf16 steps at most
MS_PREFILL_RTOL = 2e-2
MS_MOE_ARCH, MS_MOE_LAYERS = "qwen3-moe-30b-a3b", 2
# mamba2-130m at full size and jamba-v0.1-52b at full width and one block
# period (8 of its 32 layers, as phase lm_families runs it: 52 B parameters
# do not fit one card), bf16, served as granite is under decode_32k's
# rules; mamba2's prefill at MS_PREFILL_LEN
MS_SSM_ARCHS = ("mamba2-130m", "jamba-v0.1-52b")
# the pipeline's stage: 2 granite-8b blocks at full width, bf16, x [4,
# 2048, 4096] in 4 microbatches over a one-rank "pod" axis
PIPE_BLOCKS, PIPE_BATCH, PIPE_LEN, PIPE_MICRO = 2, 4, 2048, 4
# the pipeline runs each block on one microbatch at a time, reference_apply
# on the whole batch (other GEMM shapes): the two agree to a few bf16
# rounding steps of the output's largest value
PIPE_TOL = 2.0 ** -6


def serve_layouts(cfg) -> dict:
    """decode_32k's and long_500k's rules (``cells.input_specs``) -> (rules,
    batch)."""
    from repro_torch.distributed import sharding

    rules = sharding.default_rules(cfg, decode=True)
    return {"decode_32k": (rules, MS_BATCH),
            "long_500k": (dataclasses.replace(rules, batch=None, cache_seq=("data", "model")),
                          MS_LONG_BATCH)}


def port_collectives():
    """Counts the port's own collective calls (``sharding``'s psum, pmax,
    all_to_all and ppermute go through these three); DTensor's
    redistributes are not counted. Returns (counts, restore)."""
    import torch.distributed as tdist

    counts = {"all_reduce": 0, "all_to_all_single": 0, "batch_isend_irecv": 0}
    real = {name: getattr(tdist, name) for name in counts}

    def counted(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return real[name](*args, **kwargs)
        return call

    for name in counts:
        setattr(tdist, name, counted(name))
    return counts, lambda: [setattr(tdist, n, f) for n, f in real.items()]


def recorded_serve(model, prompts, keep_logits: bool, mesh=None, rules=None,
                   extras: dict | None = None) -> dict:
    """``serve.serve_loop`` (inside ``use_rules(rules, mesh)`` when ``mesh``
    is given; ``extras`` to every step), with every step's logits
    recorded: whole in f32 where ``keep_logits``, else the top two of each
    row. Returns the tokens, the loop's seconds, the first step's seconds,
    peak memory, the port's collectives a step, kernel D's launches, and
    whether every step's logits came back a DTensor (a step that ran on
    the mesh)."""
    from repro_torch.distributed import sharding

    rec, first, laid = [], [], []
    real = model.decode_step

    def step(token, cache, extras=None):
        t0 = time.perf_counter()
        logits, cache = real(token, cache, extras)
        laid.append(isinstance(logits, sharding.DTensor))
        if not first:
            torch.cuda.synchronize()
            first.append(time.perf_counter() - t0)
        whole = (logits.full_tensor() if isinstance(logits, sharding.DTensor)
                 else logits).float()
        rec.append(whole if keep_logits else torch.topk(whole, 2, dim=-1).values)
        return logits, cache

    scope = sharding.use_rules(rules, mesh) if mesh is not None else contextlib.nullcontext()
    torch.cuda.reset_peak_memory_stats()
    model.decode_step = step
    counts, restore = port_collectives()
    ops.reset_launches()
    try:
        with scope:
            out, prefill_s, decode_s = serve.serve_loop(model, prompts, MS_GEN, extras=extras)
    finally:
        restore()
        del model.decode_step
    launches = {k: ops.LAUNCHES[k] for k in ("flash_attention", "flash_attention_sm90")}
    steps = MS_PROMPT + MS_GEN
    return dict(tokens=out, logits=torch.stack(rec), prefill_s=prefill_s, decode_s=decode_s,
                first_step_s=first[0], step_s=decode_s / MS_GEN,
                decode_tokens_per_s=out.shape[0] * MS_GEN / decode_s,
                peak_bytes=torch.cuda.max_memory_allocated(),
                collectives_per_step={k: v / steps for k, v in counts.items()},
                on_mesh=all(laid), launches=launches)


def bf16_step(x: torch.Tensor) -> torch.Tensor:
    """One bf16 rounding step (the spacing of bf16 values) at |x|."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def near_tie_check(what: str, on: dict, off: dict) -> list:
    """The greedy tokens on and off the mesh, row by row, up to the first
    that differs. A difference where the off-mesh top-2 margin is within
    one bf16 rounding step is a near tie: reported, and the rest of that
    row (fed another token) is not compared; any other fails."""
    ties = []
    top2 = off["logits"][MS_PROMPT - 1:-1]                  # the logits each token came from
    for b in range(on["tokens"].shape[0]):
        for j in range(MS_GEN):
            if on["tokens"][b, j] == off["tokens"][b, j]:
                continue
            hi, lo = float(top2[j, b, 0]), float(top2[j, b, 1])
            margin, stepsize = hi - lo, float(bf16_step(torch.tensor(hi)))
            if margin > stepsize:
                fail(f"mesh_serve {what}: row {b} token {j} is {on['tokens'][b, j]} on the "
                     f"mesh, {off['tokens'][b, j]} off it, at a top-2 margin of {margin} "
                     f"(one bf16 step {stepsize})")
            ties.append(dict(row=b, token=j, margin=margin, bf16_step=stepsize))
            break
    return ties


def prefill_launches(model, tokens, mesh=None, rules=None) -> tuple[torch.Tensor, dict]:
    """``Model.prefill`` (on the mesh when ``mesh`` is given) -> (last
    logits, gathered, f32; kernel D's launches by route and the seconds)."""
    from repro_torch.distributed import sharding

    scope = sharding.use_rules(rules, mesh) if mesh is not None else contextlib.nullcontext()
    ops.reset_launches()
    with scope:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model.prefill(tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    logits = logits.full_tensor() if isinstance(logits, sharding.DTensor) else logits
    return logits.float(), dict(seconds=wall, flash_attention=ops.LAUNCHES["flash_attention"],
                                flash_attention_sm90=ops.LAUNCHES["flash_attention_sm90"])


def mesh_serve_granite(dev, mesh, gen) -> int:
    """(a): granite-8b served on and off the mesh under both layouts,
    bf16 at MS_LAYERS and f32 at 2 layers, and the 4,096-token prefill;
    returns kernel D's launches."""
    from repro_torch.distributed import sharding

    launches = 0
    for dtype, layers in (("bfloat16", MS_LAYERS), ("float32", MS_F32_LAYERS)):
        cfg = dataclasses.replace(LM, num_layers=layers, dtype=dtype)
        layouts = serve_layouts(cfg)
        model = make_model(cfg, seed=0)
        prompts = torch.randint(0, cfg.vocab_size, (MS_BATCH, MS_PROMPT), device=dev,
                                generator=gen)
        f32 = dtype == "float32"
        off = {name: recorded_serve(model, prompts[:b], f32) for name, (_, b) in layouts.items()}
        if not f32:
            tokens = torch.randint(0, cfg.vocab_size, (1, MS_PREFILL_LEN), device=dev,
                                   generator=gen)
            pre_off, pre_off_row = prefill_launches(model, tokens)
        sharding.distribute_model(model, mesh, layouts["decode_32k"][0])
        for name, (rules, b) in layouts.items():
            on = recorded_serve(model, prompts[:b], f32, mesh, rules)
            row = dict(arch=cfg.name, dtype=dtype, layers=layers, layout=name, batch=b,
                       prompt=MS_PROMPT, gen=MS_GEN, cache_seq=rules.cache_seq,
                       rules_batch=rules.batch,
                       **{f"{k}_mesh": on[k] for k in ("prefill_s", "decode_s", "step_s",
                                                       "first_step_s", "decode_tokens_per_s",
                                                       "peak_bytes", "collectives_per_step")},
                       **{f"{k}_no_mesh": off[name][k] for k in (
                           "prefill_s", "decode_s", "step_s", "first_step_s",
                           "decode_tokens_per_s", "peak_bytes", "collectives_per_step")})
            if f32:
                want, got = off[name]["logits"], on["logits"]
                rel = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
                row.update(max_rel_logit_diff=max(rel), tol=MS_F32_RTOL,
                           tokens_equal=bool(np.array_equal(on["tokens"], off[name]["tokens"])))
                emit("mesh_serve", part="granite", **row)
                if not all(torch.isfinite(got).all() for got in on["logits"]) \
                        or max(rel) > MS_F32_RTOL:
                    fail(f"mesh_serve {name} f32: the logits on the mesh differ from "
                         f"those off it by {max(rel)} relative (tol {MS_F32_RTOL})")
            else:
                ties = near_tie_check(f"granite {name}", on, off[name])
                row.update(near_ties=ties, tokens_equal=bool(np.array_equal(
                    on["tokens"], off[name]["tokens"])), first_tokens=on["tokens"][:, :8].tolist())
                emit("mesh_serve", part="granite", **row)
            if on["collectives_per_step"]["all_reduce"] <= 0 \
                    or sum(off[name]["collectives_per_step"].values()) != 0:
                fail(f"mesh_serve {name}: port collectives a step {on['collectives_per_step']} "
                     f"on the mesh, {off[name]['collectives_per_step']} off it")
        if not f32:
            pre_on, pre_on_row = prefill_launches(model, tokens, mesh, layouts["decode_32k"][0])
            err = float((pre_on - pre_off).abs().max())
            emit("mesh_serve", part="granite_prefill", tokens=MS_PREFILL_LEN,
                 mesh=pre_on_row, no_mesh=pre_off_row, max_abs_diff=err,
                 logits_abs_max=float(pre_off.abs().max()))
            want = dict(flash_attention=cfg.num_layers, flash_attention_sm90=cfg.num_layers)
            if {k: pre_on_row[k] for k in want} != want \
                    or {k: pre_off_row[k] for k in want} != want:
                fail(f"mesh_serve prefill: kernel D {pre_on_row} on the mesh, {pre_off_row} "
                     f"off it; want {cfg.num_layers} each, all on the tensor cores")
            if not bool(torch.isfinite(pre_on).all()) \
                    or err > MS_PREFILL_RTOL * float(pre_off.abs().max()):
                fail(f"mesh_serve prefill: the last logits differ by {err} on the mesh")
            launches += pre_on_row["flash_attention"] + pre_off_row["flash_attention"]
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def mesh_serve_moe(dev, mesh, gen) -> None:
    """(b): qwen3-moe-30b-a3b at full width, 2 layers, served on and off the
    mesh under its default decode rules (MoE's "ep" branch)."""
    from repro_torch.distributed import sharding

    cfg = dataclasses.replace(get_config(MS_MOE_ARCH), num_layers=MS_MOE_LAYERS)
    rules = sharding.default_rules(cfg, decode=True)
    if rules.moe_mode != "ep":
        fail(f"mesh_serve: {MS_MOE_ARCH}'s decode rules take moe_mode {rules.moe_mode}")
    model = make_model(cfg, seed=0)
    prompts = torch.randint(0, cfg.vocab_size, (MS_BATCH, MS_PROMPT), device=dev, generator=gen)
    off = recorded_serve(model, prompts, False)
    sharding.distribute_model(model, mesh, rules)
    on = recorded_serve(model, prompts, False, mesh, rules)
    ties = near_tie_check("qwen3-moe", on, off)
    emit("mesh_serve", part="moe", arch=cfg.name, layers=cfg.num_layers, moe_mode=rules.moe_mode,
         batch=MS_BATCH, prompt=MS_PROMPT, gen=MS_GEN, near_ties=ties,
         tokens_equal=bool(np.array_equal(on["tokens"], off["tokens"])),
         **{f"{k}_mesh": on[k] for k in ("decode_s", "step_s", "first_step_s",
                                         "decode_tokens_per_s", "peak_bytes",
                                         "collectives_per_step")},
         **{f"{k}_no_mesh": off[k] for k in ("decode_s", "step_s", "decode_tokens_per_s",
                                             "peak_bytes")})
    if on["collectives_per_step"]["all_to_all_single"] <= 0:
        fail(f"mesh_serve moe: no all_to_all on the mesh ({on['collectives_per_step']})")
    del model
    gc.collect()
    torch.cuda.empty_cache()


def mesh_serve_ssm(dev, mesh, gen) -> None:
    """(c): mamba2-130m and jamba-v0.1-52b (one period) served on and off
    the mesh under decode_32k's rules, and mamba2's prefill on and off it.
    Gates: every mesh step ran on the mesh, tokens equal but at a near tie,
    jamba's MoE in "ep" with its all_to_all, the prefill equal."""
    from repro_torch.distributed import sharding

    for arch in MS_SSM_ARCHS:
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=FAMILY_DEPTH.get(arch, full.num_layers))
        rules, b = serve_layouts(cfg)["decode_32k"]
        model = make_model(cfg, seed=0)
        prompts = torch.randint(0, cfg.vocab_size, (b, MS_PROMPT), device=dev, generator=gen)
        off = recorded_serve(model, prompts, False)
        ssm_only = cfg.is_attention_free
        if ssm_only:
            tokens = torch.randint(0, cfg.vocab_size, (1, MS_PREFILL_LEN), device=dev,
                                   generator=gen)
            pre_off, pre_off_row = prefill_launches(model, tokens)
        sharding.distribute_model(model, mesh, rules)
        on = recorded_serve(model, prompts, False, mesh, rules)
        ties = near_tie_check(arch, on, off)
        emit("mesh_serve", part="ssm", arch=arch, family=cfg.family, layers=cfg.num_layers,
             full_layers=full.num_layers, dtype=cfg.dtype, moe_mode=rules.moe_mode,
             batch=b, prompt=MS_PROMPT, gen=MS_GEN, near_ties=ties,
             tokens_equal=bool(np.array_equal(on["tokens"], off["tokens"])),
             first_tokens=on["tokens"][:, :8].tolist(),
             **{f"{k}_mesh": on[k] for k in ("prefill_s", "decode_s", "step_s", "first_step_s",
                                             "decode_tokens_per_s", "peak_bytes",
                                             "collectives_per_step", "on_mesh")},
             **{f"{k}_no_mesh": off[k] for k in ("prefill_s", "decode_s", "step_s",
                                                 "decode_tokens_per_s", "peak_bytes",
                                                 "collectives_per_step", "on_mesh")})
        if not on["on_mesh"] or off["on_mesh"] \
                or sum(off["collectives_per_step"].values()) != 0:
            fail(f"mesh_serve {arch}: the mesh serve ran off the mesh, or the plain one on it")
        if cfg.num_experts and (rules.moe_mode != "ep"
                                or on["collectives_per_step"]["all_to_all_single"] <= 0):
            fail(f"mesh_serve {arch}: MoE in {rules.moe_mode} with "
                 f"{on['collectives_per_step']} a step")
        if ssm_only:
            pre_on, pre_on_row = prefill_launches(model, tokens, mesh, rules)
            err = float((pre_on - pre_off).abs().max())
            emit("mesh_serve", part="ssm_prefill", arch=arch, tokens=MS_PREFILL_LEN,
                 mesh=pre_on_row, no_mesh=pre_off_row, max_abs_diff=err,
                 logits_abs_max=float(pre_off.abs().max()),
                 bit_equal=bool(torch.equal(pre_on, pre_off)))
            if pre_on_row["flash_attention"] or pre_off_row["flash_attention"]:
                fail(f"mesh_serve {arch} prefill: kernel D launched in an attention-free arch")
            if not bool(torch.isfinite(pre_on).all()) \
                    or err > MS_PREFILL_RTOL * float(pre_off.abs().max()):
                fail(f"mesh_serve {arch} prefill: the last logits differ by {err} on the mesh")
        del model
        gc.collect()
        torch.cuda.empty_cache()


# llama-3.2-vision-11b at full width and one period (5 of its 40 layers: 4
# self-attention, 1 cross over the images) and whisper-base at full size,
# bf16, served as granite is under decode_32k's rules with seeded random
# images, or with the memory the encoder gives from seeded random frames
MS_CROSS = {"llama-3.2-vision-11b": 5, "whisper-base": 6}


def mesh_serve_cross(dev, mesh, gen) -> int:
    """(d): the VLM (one period) and whisper-base served on and off the
    mesh under decode_32k's rules; whisper's memory from its encoder run on
    the mesh (and off it for the serve off it). Gates: every mesh step ran
    on the mesh, tokens equal but at a near tie, kernel D's cross
    launches at Tq 1 (one a cross sublayer a step) equal on both, all on
    the tensor cores. Returns D's launches (the encoder runs included)."""
    from repro_torch.distributed import sharding

    total = 0
    for arch, layers in MS_CROSS.items():
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=layers)
        rules, b = serve_layouts(cfg)["decode_32k"]
        model = make_model(cfg, seed=0)
        prompts = torch.randint(0, cfg.vocab_size, (b, MS_PROMPT), device=dev, generator=gen)
        ex = cross_extras(cfg, b, dev, gen, torch.bfloat16)
        ops.reset_launches()
        with torch.no_grad():
            off_extras = {"memory": model.encode_audio(ex["frames"])} if "frames" in ex else ex
        enc_off = ops.LAUNCHES["flash_attention"]
        off = recorded_serve(model, prompts, False, extras=off_extras)
        sharding.distribute_model(model, mesh, rules)
        ops.reset_launches()
        with sharding.use_rules(rules, mesh), torch.no_grad():
            on_extras = {"memory": model.encode_audio(ex["frames"])} if "frames" in ex else ex
        enc_on = ops.LAUNCHES["flash_attention"]
        on = recorded_serve(model, prompts, False, mesh, rules, extras=on_extras)
        ties = near_tie_check(arch, on, off)
        cross_per_step = kernel_d_calls(cfg)[1]
        want = cross_per_step * (MS_PROMPT + MS_GEN)
        emit("mesh_serve", part="cross", arch=arch, family=cfg.family, layers=cfg.num_layers,
             full_layers=full.num_layers, dtype=cfg.dtype, batch=b, prompt=MS_PROMPT,
             gen=MS_GEN, extras={k: list(v.shape) for k, v in ex.items()},
             memory_from_encoder_on_mesh=isinstance(on_extras.get("memory"),
                                                    sharding.DTensor),
             encoder_launches_mesh=enc_on, encoder_launches_no_mesh=enc_off,
             near_ties=ties, tokens_equal=bool(np.array_equal(on["tokens"], off["tokens"])),
             first_tokens=on["tokens"][:, :8].tolist(), cross_launches_per_step=cross_per_step,
             **{f"{k}_mesh": on[k] for k in ("prefill_s", "decode_s", "step_s", "first_step_s",
                                             "decode_tokens_per_s", "peak_bytes",
                                             "collectives_per_step", "on_mesh", "launches")},
             **{f"{k}_no_mesh": off[k] for k in ("prefill_s", "decode_s", "step_s",
                                                 "decode_tokens_per_s", "peak_bytes",
                                                 "on_mesh", "launches")})
        if not on["on_mesh"] or off["on_mesh"]:
            fail(f"mesh_serve {arch}: the mesh serve ran off the mesh, or the plain one on it")
        for name, got in (("on", on["launches"]), ("off", off["launches"])):
            if got != dict(flash_attention=want, flash_attention_sm90=want):
                fail(f"mesh_serve {arch}: kernel D {got} in the serve {name} the mesh; want "
                     f"{want} at Tq 1, all on the tensor cores")
        if enc_on != enc_off or enc_on != cfg.encoder_layers:
            fail(f"mesh_serve {arch}: the encoder launched D {enc_on} times on the mesh, "
                 f"{enc_off} off it; want {cfg.encoder_layers}")
        total += on["launches"]["flash_attention"] + enc_on
        del model, on, off, on_extras, off_extras
        gc.collect()
        torch.cuda.empty_cache()
    return total


def mesh_serve_pipeline(dev, gen) -> int:
    """(c): ``pipeline_apply`` over a one-rank "pod" axis, each stage 2
    granite-8b blocks, against ``reference_apply``, then one backward;
    returns kernel D's launches."""
    from torch.func import functional_call

    from repro_torch.distributed import pipeline
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models.transformer import Block, SublayerKind

    pod = launch_mesh.make_mesh((1,), ("pod",))
    kind = SublayerKind("attn", False, False, True)
    blocks = torch.nn.ModuleList(Block(LM, kind, gen, dev) for _ in range(PIPE_BLOCKS))
    params = {k: v.detach()[None].clone().requires_grad_(True)
              for k, v in blocks.named_parameters()}
    del blocks
    stage_blocks = torch.nn.ModuleList(Block(LM, kind, None, "meta") for _ in range(PIPE_BLOCKS))

    def stage(p, x):
        for i, blk in enumerate(stage_blocks):
            x, _ = functional_call(blk, {k.split(".", 1)[1]: v for k, v in p.items()
                                         if k.split(".", 1)[0] == str(i)}, (x,))
        return x

    x = torch.randn(PIPE_BATCH, PIPE_LEN, LM.d_model, device=dev, generator=gen,
                    dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        want = pipeline.reference_apply(stage, params, x)
    ops.reset_launches()
    counts, restore = port_collectives()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = pipeline.pipeline_apply(stage, params, x, mesh=pod, axis="pod",
                                    num_microbatches=PIPE_MICRO)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        launches = dict(flash_attention=ops.LAUNCHES["flash_attention"],
                        flash_attention_sm90=ops.LAUNCHES["flash_attention_sm90"])
        t0 = time.perf_counter()
        y.float().square().sum().backward()
        torch.cuda.synchronize()
        bwd_s = time.perf_counter() - t0
    finally:
        restore()
    diff = float((y.detach().float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    zero = [k for k, v in params.items() if v.grad is None or not bool(v.grad.abs().max() > 0)]
    emit("mesh_serve", part="pipeline", stages=1, blocks=PIPE_BLOCKS, batch=PIPE_BATCH,
         tokens=PIPE_LEN, microbatches=PIPE_MICRO, dtype="bfloat16",
         bit_equal=bool(torch.equal(y.detach(), want)), max_abs_diff=diff, out_abs_max=scale,
         tol=PIPE_TOL * scale, forward_s=fwd_s, backward_s=bwd_s, launches=launches,
         collectives=counts, params=len(params), zero_grads=zero,
         peak_bytes=torch.cuda.max_memory_allocated())
    want_d = PIPE_BLOCKS * PIPE_MICRO
    if launches != dict(flash_attention=want_d, flash_attention_sm90=want_d):
        fail(f"mesh_serve pipeline: kernel D {launches}; want {want_d}, all on the tensor cores")
    # M + S - 1 ticks (S 1) hand off forward, and all but the last backward
    ticks = PIPE_MICRO
    if counts["batch_isend_irecv"] != 2 * ticks - 1:
        fail(f"mesh_serve pipeline: {counts['batch_isend_irecv']} hand-offs through NCCL, "
             f"want {2 * ticks - 1}")
    if not bool(torch.isfinite(y).all()) or diff > PIPE_TOL * scale:
        fail(f"mesh_serve pipeline: {diff} from reference_apply (tol {PIPE_TOL * scale})")
    if zero:
        fail(f"mesh_serve pipeline: zero or missing gradients for {zero}")
    del params, y, want, x
    gc.collect()
    torch.cuda.empty_cache()
    return launches["flash_attention"]


def mesh_serve_phase(dev, mesh) -> int:
    """Phase 11 (see the module docstring) on ``mesh``, main's one-rank
    NCCL ``make_host_mesh()``; returns kernel D's launches."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(11)
    launches = mesh_serve_granite(dev, mesh, gen)
    mesh_serve_moe(dev, mesh, gen)
    mesh_serve_ssm(dev, mesh, gen)
    launches += mesh_serve_cross(dev, mesh, gen)
    launches += mesh_serve_pipeline(dev, gen)
    emit("mesh_serve", part="summary", flash_attention_launches=launches,
         phase_s=time.perf_counter() - t0)
    return launches


# --- phase 12: the dry-run cells, and one cell at its full shape ---------------

# the dry run of every cell of these archs (10 cells) at one block period
# (num_layers one period, at most one encoder layer: the depth cut of
# tests/test_torch_dryrun.py), each rank-0 step on ``meta`` over a fake
# world of 256 ranks, in a subprocess with a deadline
CELL_ARCHS = ("whisper-base", "phi3-medium-14b", "jamba-v0.1-52b")
DRYRUN_TIMEOUT_S = 300
DRYRUN_SCRIPT = """
import dataclasses, json, logging, sys, tempfile, warnings
from pathlib import Path
warnings.filterwarnings("ignore")
logging.disable(logging.WARNING)
import torch
torch.set_num_threads(1)
from repro_torch.configs import base
from repro_torch.launch import dryrun
from repro_torch.models.transformer import block_period

real = base.get_config
base.get_config = lambda arch: dataclasses.replace(
    real(arch), num_layers=block_period(real(arch)),
    encoder_layers=min(real(arch).encoder_layers, 1))
out = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
for arch in sys.argv[1].split(","):
    for shape in base.cells(arch):
        r = dryrun.run_cell(arch, shape.name, multi_pod=False, out_dir=out, verbose=False)
        r.pop("traceback", None)
        print(json.dumps(r), flush=True)
"""
# the reference's prefill_32k cell of whisper-base at its full shape: B 32,
# T 32,768, frames [32, 1500, 512], through ``cells.lower_cell`` on the
# one-rank NCCL mesh and the same prefill off it
CELL_ARCH, CELL_SHAPE = "whisper-base", "prefill_32k"


def start_dryrun() -> subprocess.Popen:
    """``dryrun.run_cell`` over CELL_ARCHS' cells in a subprocess, started
    before phase train so that its host work runs beside the card's;
    killed past DRYRUN_TIMEOUT_S or at exit."""
    import atexit

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c", DRYRUN_SCRIPT, ",".join(CELL_ARCHS)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=ROOT, env=env)
    proc.started = time.perf_counter()
    atexit.register(lambda: proc.poll() is None and (proc.kill(), proc.wait()))
    return proc


def finish_dryrun(proc: subprocess.Popen) -> list[dict]:
    """The dry run's records, one a cell (its deadline counted from its
    start)."""
    left = DRYRUN_TIMEOUT_S - (time.perf_counter() - proc.started)
    try:
        out, err = proc.communicate(timeout=max(1.0, left))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"cells: the dry run passed its {DRYRUN_TIMEOUT_S} s deadline")
    if proc.returncode != 0:
        fail(f"cells: the dry run exited {proc.returncode}: {err[-2000:]}")
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def cells_phase(dev, mesh, dry: subprocess.Popen) -> int:
    """Phase 12 (see the module docstring), with the dry run ``dry`` that
    main started; returns kernel D's launches in the full-shape cell on
    and off the mesh."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import cells

    t0 = time.perf_counter()
    recs = finish_dryrun(dry)
    dry_s = time.perf_counter() - dry.started
    for r in recs:
        roof = r.get("roofline", {})
        emit("cells", part="dryrun", arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
             chips=r["chips"], ok=r["ok"], error=r.get("error"), lower_s=r.get("lower_s"),
             trace_s=r.get("trace_s"), memory=r.get("memory"),
             **{k: roof.get(k) for k in ("flops_per_chip", "coll_bytes_per_chip",
                                         "model_flops_global", "t_compute_s", "t_memory_s",
                                         "t_collective_s", "dominant", "roofline_fraction")})
    want = sum(len(cell_list(a)) for a in CELL_ARCHS)
    bad = [f"{r['arch']}.{r['shape']}: {r.get('error')}" for r in recs if not r["ok"]]
    if len(recs) != want or bad:
        fail(f"cells: {len(recs)} of {want} cells dry-ran, failures {bad}")

    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    lowered, meta = cells.lower_cell(CELL_ARCH, CELL_SHAPE, mesh)
    build_s = time.perf_counter() - t1
    ops.reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    on = lowered.step()
    torch.cuda.synchronize()
    on_s = time.perf_counter() - t1
    on_launches = {k: ops.LAUNCHES[k] for k in ("flash_attention", "flash_attention_sm90")}
    on = (on.full_tensor() if isinstance(on, sharding.DTensor) else on).float()
    on_peak = torch.cuda.max_memory_allocated()
    inputs = lowered.inputs
    del lowered
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = make_model(get_config(CELL_ARCH), seed=0)
    ops.reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    off = model.prefill(inputs["tokens"], {"frames": inputs["frames"]}).float()
    torch.cuda.synchronize()
    off_s = time.perf_counter() - t1
    off_launches = {k: ops.LAUNCHES[k] for k in ("flash_attention", "flash_attention_sm90")}
    off_peak = torch.cuda.max_memory_allocated()
    err = float((on - off).abs().max())
    step = float(bf16_step(off.abs().max()))
    shape = get_shape(CELL_SHAPE)
    emit("cells", part="full_cell", arch=CELL_ARCH, shape=CELL_SHAPE, kind=meta.kind,
         batch=shape.global_batch, tokens=shape.seq_len,
         inputs={k: list(v.shape) for k, v in inputs.items()}, mesh=mesh.shape,
         rules_batch=meta.rules.batch, build_s=build_s, prefill_s_mesh=on_s,
         prefill_s_no_mesh=off_s, tokens_per_s_mesh=shape.global_batch * shape.seq_len / on_s,
         tokens_per_s_no_mesh=shape.global_batch * shape.seq_len / off_s,
         peak_bytes_mesh=on_peak, peak_bytes_no_mesh=off_peak, launches_mesh=on_launches,
         launches_no_mesh=off_launches, max_abs_diff=err, logits_abs_max=float(off.abs().max()),
         bf16_step=step, bit_equal=bool(torch.equal(on, off)), dryrun_wall_s=dry_s,
         phase_s=time.perf_counter() - t0)
    want_d = dict(flash_attention=18, flash_attention_sm90=18)
    if on_launches != want_d or off_launches != want_d:
        fail(f"cells {CELL_ARCH} {CELL_SHAPE}: kernel D {on_launches} on the mesh, "
             f"{off_launches} off it; want 18 each (6 encoder, 6 causal, 6 cross), all on "
             "the tensor cores")
    if not bool(torch.isfinite(on).all()) or err > step:
        fail(f"cells {CELL_ARCH} {CELL_SHAPE}: the last logits differ by {err} on the mesh "
             f"(one bf16 step of the largest: {step})")
    if max(on_peak, off_peak) >= 72e9:
        fail(f"cells {CELL_ARCH} {CELL_SHAPE}: peak {on_peak} / {off_peak} bytes")
    del model, on, off, inputs
    gc.collect()
    torch.cuda.empty_cache()
    return on_launches["flash_attention"] + off_launches["flash_attention"]


# the phases a run may pick (``--phases``); every one runs by default
PHASES = ("kernel", "main", "baselines", "backends", "lifecycle", "serve", "features",
          "checkpoint", "parity", "lm", "lm_families", "train", "launch", "mesh", "mesh_serve",
          "cells")


# the phases that run in a process of their own: the CARD phases
# after the kernel checks, and phase parity. They are host-bound with a
# light card; the LM phases, card-bound, run beside them in this process,
# after the kernel checks (whose timings nothing shares)
CHILD_PHASES = PHASES[1:9]
CHILD_FLAG = "--card-child"
CHILD_RESULT = "chip_smoke card phases: "


def card_workloads() -> dict[str, list[bytes]]:
    return {name: workloads.make_workload(
        name, workloads.WorkloadConfig(base_size=BASE, versions=VERSIONS))
        for name in ("sql_dump", "vmdk")}


def card_child(dev, phases: tuple[str, ...]) -> int:
    """The CARD phases of ``phases`` in this process (the child that
    ``start_card_child`` starts): their JSON lines, then one CHILD_RESULT
    line with their kernel launches and the packed gear route's row."""
    _build.lib()
    launches = {"gear_scan": 0, "shingle_embed": 0, "sim_topk": 0, "rabin": 0,
                "gear_packed": 0}

    def add(counts: dict) -> None:
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    main_versions = card_workloads() if set(phases) & set(CHILD_PHASES[:-1]) else None
    if "main" in phases:
        for name, versions in main_versions.items():
            add(main_path(name, versions))
            device_share(name, versions[:2])
    for phase, fn in (("baselines", baselines_phase), ("backends", backends_phase)):
        if phase in phases:
            for name, versions in main_versions.items():
                add(fn(dev, name, versions))
    if "lifecycle" in phases:
        add(lifecycle_phase(dev, main_versions))
    if "serve" in phases:
        add(serve_phase(dev, main_versions))
    gear_packed = None
    if "features" in phases:
        gear_packed, feature_launches = features_phase(dev, main_versions)
        add(feature_launches)
        launches["gear_packed"] = gear_packed["launches"]["gear_hashes"]
        launches["gear_scan"] += launches["gear_packed"]
        launches["shingle_embed"] += gear_packed["launches"]["shingle_embed"]
    if "checkpoint" in phases:
        add(checkpoint_phase(dev))
    if "parity" in phases:
        small = workloads.make_workload(
            "kernel", workloads.WorkloadConfig(base_size=1 << 20, versions=3))
        parity_phase(*fit_phase(small), small)
    print(CHILD_RESULT + json.dumps({"launches": launches, "gear_packed": gear_packed}),
          flush=True)
    return 0


def start_card_child(phases: list[str]) -> dict:
    """``chip_smoke.py --card-child --phases ...`` as a subprocess beside
    this process's LM phases (both on the card; the host's cores shared),
    its lines relayed to this stdout as they come; killed at exit."""
    import atexit

    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), CHILD_FLAG,
                             "--phases", ",".join(phases)], stdout=subprocess.PIPE,
                            text=True, cwd=ROOT)
    child = {"proc": proc, "result": None}

    def relay():
        for line in proc.stdout:
            if line.startswith(CHILD_RESULT):
                child["result"] = json.loads(line[len(CHILD_RESULT):])
                continue
            with PRINT_LOCK:
                print(line, end="", flush=True)

    child["relay"] = threading.Thread(target=relay, daemon=True)
    child["relay"].start()
    atexit.register(lambda: proc.poll() is None and (proc.kill(), proc.wait()))
    return child


def finish_card_child(child: dict) -> tuple[dict, dict | None]:
    """Wait for the CARD phases' process -> (their kernel launches, the
    packed gear route's row); its failure fails the run."""
    rc = child["proc"].wait()
    child["relay"].join()
    if rc != 0 or child["result"] is None:
        fail(f"the CARD phases' process exited {rc}")
    return child["result"]["launches"], child["result"]["gear_packed"]


def parse_phases(argv: list[str]) -> tuple[tuple[str, ...], bool]:
    """``--phases name,name`` -> (the phases to run, in PHASES order (device
    and build always run; no argument: all of them), whether this is the
    CARD phases' process)."""
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port on one NVIDIA card.")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    ap.add_argument(CHILD_FLAG, action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    names = [n for n in args.phases.split(",") if n]
    unknown = sorted(set(names) - set(PHASES))
    if unknown or not names:
        ap.error(f"unknown phases {unknown}; pick from {', '.join(PHASES)}")
    return tuple(n for n in PHASES if n in names), args.card_child


def main(argv: list[str] | None = None) -> int:
    phases, child = parse_phases(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    if child:
        return card_child(dev, phases)

    smi = nvidia_smi()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmul is enabled")
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(dev),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         phases=list(phases))

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

    launches = {"gear_scan": 0, "shingle_embed": 0, "sim_topk": 0, "rabin": 0,
                "flash_attention": 0, "gear_packed": 0}
    rows = []
    if "kernel" in phases:
        main_versions = card_workloads()
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
        del main_versions
        gc.collect()

    def add(counts: dict) -> None:
        for k, v in counts.items():
            launches[k] += v

    child_phases = [p for p in phases if p in CHILD_PHASES]
    child = start_card_child(child_phases) if child_phases else None
    if "lm" in phases:
        launches["flash_attention"] += lm_phase(dev)
    if "lm_families" in phases:
        launches["flash_attention"] += lm_families_phase(dev)
    if "cells" in phases:
        # the dry run's host work goes beside the card-bound train steps,
        # not beside the host-bound CARD phases
        dry = start_dryrun()
    train_row = None
    if "train" in phases:
        train_launches, train_row = train_phase(dev)
        launches["flash_attention"] += train_launches
    if "launch" in phases:
        add(launch_phase(dev))
    mesh_launches = mesh_serve_launches = cells_launches = 0
    if {"mesh", "mesh_serve", "cells"} & set(phases):
        import torch.distributed as tdist

        from repro_torch.launch import mesh as launch_mesh
        mesh = launch_mesh.make_host_mesh()
        try:
            if "mesh" in phases:
                mesh_launches = mesh_phase(dev, mesh)
            if "mesh_serve" in phases:
                mesh_serve_launches = mesh_serve_phase(dev, mesh)
            if "cells" in phases:
                cells_launches = cells_phase(dev, mesh, dry)
        finally:
            tdist.destroy_process_group()
    launches["flash_attention"] += mesh_launches + mesh_serve_launches + cells_launches
    gear_packed = None
    if child is not None:
        counts, gear_packed = finish_card_child(child)
        add(counts)

    print(smi, flush=True)
    if phases == PHASES:
        # the kernels line holds every path's launches: a full run only
        sources = {"gear_scan": gear_hash, "shingle_embed": shingle_embed,
                   "sim_topk": sim_topk, "flash_attention": flash_attn}
        for row in rows:
            mod = sources[row["name"]]
            row.update(route="cuda", source=mod.SOURCE, replaces=mod.REPLACES,
                       launches=launches[row["name"]])
        rows[0]["rabin_launches"] = launches["rabin"]
        rows[0]["gear_packed"] = gear_packed
        rows[0]["gear_packed_launches"] = launches["gear_packed"]
        rows[3]["train_row"] = train_row
        rows[3]["mesh_launches"] = mesh_launches
        rows[3]["mesh_serve_launches"] = mesh_serve_launches
        rows[3]["cells_launches"] = cells_launches
        print(json.dumps({"kernels": rows}), flush=True)
    last = {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}
    if phases != PHASES:
        # a partial run's last line names its phases: only a full run
        # ends in the bare line
        last["phases"] = list(phases)
    print(json.dumps(last), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
