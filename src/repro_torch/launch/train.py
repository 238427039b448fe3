"""Training launcher with checkpoint/restart fault tolerance (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b --reduced \\
        --steps 50 --checkpoint-every 10 --ckpt-dir /tmp/run1 [--device cpu]

Restart semantics: on start, if the checkpoint dir has a committed step,
training resumes from it (the data pipeline is (step, shard)-deterministic,
so the restarted worker replays exactly its shard, with no coordination).
``--fail-at N`` exits with code 17 at step N of a fresh run to exercise
the restart path; ``launch/supervisor.py`` wraps this process and
restarts it, the single-host simulation of a job manager rescheduling a
worker. ``--dedup-ckpt`` also mirrors each checkpoint's params into a
CARD ``DedupCheckpointStore`` (on the card: kernels A, B and C over the
training state), fed the reference's param tree
(``convert.lm_params_to_jax``), so its stream and DCR are the
reference's for the same values.

The flags, defaults and printed lines are the reference's, plus
``--device``: the CUDA device unless ``--device cpu``; asked for CUDA
where there is none, the launcher raises. The whole ``TrainState`` (params,
the optimizer's step, mu and nu, the step) goes through
``checkpoint.save`` / ``restore``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import optim
from repro_torch.checkpoint import DedupCheckpointStore, latest_step, restore, save
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_to_jax
from repro_torch.data import TokenPipeline, TokenPipelineConfig
from repro_torch.models import make_model
from repro_torch.train import make_train_step
from repro_torch.train.step import init_state, model_params


def lr_schedule(args):
    """Warm-up over 20 steps to ``--lr``, then a cosine to 0 at ``--steps``
    (at least 21)."""
    return optim.cosine_schedule(args.lr, 20, max(args.steps, 21))


def build(args):
    """-> (cfg, model, tx, step_fn, pipe) on ``args.device`` (None: CUDA)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = make_model(cfg, device=getattr(args, "device", None), seed=0)
    tx = optim.adamw(lr_schedule(args), weight_decay=0.1, max_grad_norm=1.0)
    step_fn = make_train_step(model, tx, num_microbatches=args.microbatches)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, global_batch=args.batch,
        seq_len=args.seq, shards=1))
    return cfg, model, tx, step_fn, pipe


def extras_for(cfg, batch):
    """The reference's stand-ins for the vision tower's and the audio front
    end's outputs: zeros."""
    ex = {}
    if cfg.family == "vlm":
        ex["images"] = np.zeros((batch, cfg.num_image_tokens, cfg.d_model), np.float32)
    if cfg.family == "audio":
        ex["frames"] = np.zeros((batch, cfg.num_audio_frames, cfg.d_model), np.float32)
    return ex


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--dedup-ckpt", action="store_true",
                    help="also mirror checkpoints into the CARD dedup store")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="simulate a worker crash at this step")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)

    cfg, model, tx, step_fn, pipe = build(args)
    dev = model.device
    state = init_state(model_params(model), tx)

    start = 0
    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            state = restore(args.ckpt_dir, state, last)
            start = int(last)
            print(f"[resume] restored step {start} from {args.ckpt_dir}", flush=True)

    dstore = DedupCheckpointStore(device=dev) if args.dedup_ckpt else None
    extras = {k: torch.from_numpy(v).to(dev) for k, v in extras_for(cfg, args.batch).items()}
    t0 = time.time()
    for step in range(start, args.steps):
        if step == args.fail_at and start == 0:
            # fire only on a fresh (non-resumed) run so the restarted worker
            # can make progress: a one-off node failure
            print(f"[failure-injection] crashing at step {step}", flush=True)
            sys.exit(17)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(step).items()}
        state, metrics = step_fn(state, dict(batch, **extras))
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0):.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.checkpoint_every == 0:
            save(args.ckpt_dir, state, step + 1)
            if dstore is not None:
                stats = dstore.save(lm_params_to_jax(model, state.params), step + 1)
                print(f"[dedup-ckpt] DCR={stats.dcr:.2f} "
                      f"stored={stats.bytes_stored >> 20}MiB "
                      f"raw={stats.bytes_in >> 20}MiB", flush=True)
    print(f"[done] {args.steps} steps in {time.time()-t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
