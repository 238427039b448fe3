"""Serving driver: batched autoregressive decode with KV caches (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \\
        --batch 8 --prompt-len 32 --gen 32 [--full] [--device cpu]

``--arch`` takes every arch of ``configs.ARCH_IDS``: grok-1-314b,
qwen3-moe-30b-a3b, llama-3.2-vision-11b, granite-8b, chatglm3-6b,
phi3-medium-14b, granite-3-8b, mamba2-130m, jamba-v0.1-52b and
whisper-base. The prompt goes through ``decode_step`` token by token (an
SSM layer's state and an attention layer's KV cache alike), as in the
reference (which has no one-pass cache fill); then ``gen`` tokens are
generated greedily, or sampled at ``--temperature`` from a seeded
``torch.Generator`` (torch's draws, not JAX's). ``serve_loop`` passes
``extras`` to every step; without them a vlm or audio model raises
``KeyError``, as the reference's ``serve_loop`` does, so ``main`` gives
llama-3.2-vision-11b seeded random ``images`` and whisper-base the
encoder's output over seeded random ``frames`` as ``memory`` (the
reference's stubs of the vision tower and the conv front end). Runs on the
CUDA device unless ``--device cpu``; reports prefill and decode tokens/s
and checks that every token is in the vocabulary.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config
from repro_torch.models import make_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _whole(logits: torch.Tensor) -> torch.Tensor:
    """The step's logits as a plain tensor, gathered whole on every rank:
    on a mesh they come out a DTensor split over the vocabulary
    (``constrain(..., "vocab")``) and the batch, and each rank needs every
    row's next token."""
    return logits.full_tensor() if isinstance(logits, DTensor) else logits


def serve_loop(model, prompts: torch.Tensor, gen_len: int, temperature: float = 0.0,
               generator: torch.Generator | None = None, extras: dict | None = None
               ) -> tuple[np.ndarray, float, float]:
    """prompts [B, P] -> (generated tokens [B, gen_len] int64, prefill
    seconds, decode seconds). ``extras`` goes to every ``decode_step``.
    Inside ``sharding.use_rules(rules, mesh)``, with the model's params laid
    out by ``sharding.distribute_model``, it serves on the mesh: the cache
    is laid out by the rules and every rank gets the same tokens."""
    b, plen = prompts.shape
    dev = model.device
    prompts = prompts.to(dev)
    cache = model.init_cache(b, plen + gen_len)
    logits = None
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(plen):
        logits, cache = model.decode_step(prompts[:, i:i + 1], cache, extras)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    toks = []
    tok = torch.argmax(_whole(logits), dim=-1)[:, None]
    t0 = time.perf_counter()
    for _ in range(gen_len):
        toks.append(tok[:, 0].cpu().numpy())
        logits, cache = model.decode_step(tok, cache, extras)
        logits = _whole(logits)
        if temperature > 0 and generator is not None:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = torch.argmax(logits, dim=-1)[:, None]
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return np.stack(toks, axis=1), prefill_s, decode_s


def stub_extras(model, batch: int) -> dict | None:
    """Seeded random extras for the families that need them: ``images``
    [B, T_img, d] for vlm, ``memory`` = the encoder over random ``frames``
    [B, T_frames, d] for audio (computed once, not at every step)."""
    cfg = model.cfg
    if cfg.family not in ("vlm", "audio"):
        return None
    n = cfg.num_image_tokens if cfg.family == "vlm" else cfg.num_audio_frames
    gen = torch.Generator(device=model.device).manual_seed(3)
    x = torch.randn(batch, n, cfg.d_model, generator=gen, device=model.device)
    if cfg.family == "vlm":
        return {"images": x}
    with torch.no_grad():
        return {"memory": model.encode_audio(x)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = make_model(cfg, device=args.device, seed=0)
    cpu = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=cpu)
    sampler = torch.Generator(device=model.device).manual_seed(2)
    out, prefill_s, decode_s = serve_loop(model, prompts, args.gen,
                                          args.temperature, sampler, stub_extras(model, args.batch))
    print(f"arch={cfg.name} batch={args.batch} device={model.device}")
    print(f"prefill {args.prompt_len} steps: {prefill_s:.2f}s "
          f"({args.batch * args.prompt_len / max(prefill_s, 1e-9):.1f} tok/s)")
    print(f"decode  {args.gen} steps: {decode_s:.2f}s "
          f"({args.batch * args.gen / max(decode_s, 1e-9):.1f} tok/s)")
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise SystemExit("a generated token is outside the vocabulary")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
