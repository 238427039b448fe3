"""Dry-run cells: (arch x input shape x mesh) -> a step laid out on the mesh
(port of ``repro.launch.cells``).

The reference lowers each cell from ``ShapeDtypeStruct`` stand-ins and
compiles it for 256 (512) placeholder devices. Here the cell is built on
the mesh's device type: on a ``meta`` mesh over a fake world
(``launch.dryrun.fake_world``) every parameter, optimizer moment, input
and cache block is a ``meta`` tensor of its rank's local shape, and the
step runs once allocating nothing; on a CUDA mesh the same cell runs for
real (random weights from seed 0, seeded random inputs).

The rules and specs are the reference's, function for function
(``input_specs``, ``init_state_specs``, ``_serve_fsdp``,
``_default_microbatches``, ``_extras_shapes``, ``_extras_specs``).
``cell_specs`` gives the sanitized specs that ``lower_cell`` lays the
params, the train state, the inputs and the cache out by (the
reference's ``in_shardings``); it reads only the mesh's shape.

Per-cell policy knobs (all overridable by the perf hillclimb):
  * fsdp: shard the d_model param axis over "data" (ZeRO-3). Default: on
    for train; on for serving when bf16 params exceed ~10 GB/chip under
    TP alone (grok-1).
  * num_microbatches: gradient-accumulation splits for train cells.
  * m_dtype: bf16 first moment for >=100B params.
  * long_500k: batch (=1) replicated, KV-cache sequence axis sharded over
    ("data","model") — sequence parallelism for single-stream decode.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch import optim
from repro_torch.configs import base as configs
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models import make_model
from repro_torch.train import step as train


@dataclasses.dataclass
class CellMeta:
    arch: str
    shape_name: str
    kind: str
    chips: int
    fsdp: bool
    num_microbatches: int
    rules: shd.ShardingRules


def _serve_fsdp(cfg) -> bool:
    """Serving gathers FSDP-sharded weights every step, so serve cells use
    plain TP unless bf16 params exceed ~10 GB/chip under the 16-way model
    axis alone (only grok-1)."""
    return cfg.param_count() * 2 / 16 > 10e9


def _default_microbatches(cfg) -> int:
    return 8


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _extras_shapes(cfg, batch: int, dtype, kind: str) -> dict:
    ex = {}
    if cfg.family == "vlm":
        ex["images"] = _meta((batch, cfg.num_image_tokens, cfg.d_model), dtype)
    if cfg.family == "audio":
        # decode serves from the cached encoder output ("memory"); train /
        # prefill run the encoder over stub frame embeddings
        name = "memory" if kind == "decode" else "frames"
        ex[name] = _meta((batch, cfg.num_audio_frames, cfg.d_model), dtype)
    return ex


def _extras_specs(cfg, rules, kind: str) -> dict:
    out = {}
    name = {"vlm": "images",
            "audio": "memory" if kind == "decode" else "frames"}.get(cfg.family)
    if name:
        out[name] = shd.activation_spec("batch", None, None, rules=rules)
    return out


def input_specs(arch: str, shape_name: str, *, multi_pod: bool = False,
                fsdp: Optional[bool] = None,
                rules: Optional[shd.ShardingRules] = None) -> dict:
    """``meta`` stand-ins + specs for every model input, and the cell's
    rules, config, shape and (``meta``) model."""
    cfg = configs.get_config(arch)
    shape = configs.get_shape(shape_name)
    model = make_model(cfg, device="meta")
    dtype = L.dtype_of(cfg)

    if rules is None:
        if shape.kind == "decode" and shape.global_batch == 1:
            # long-context single stream: replicate batch, shard the cache
            # sequence axis over every mesh axis (SP decode)
            rules = dataclasses.replace(
                shd.default_rules(cfg, multi_pod=multi_pod, decode=True,
                                  fsdp=_serve_fsdp(cfg) if fsdp is None else fsdp),
                batch=None, cache_seq=("data", "model"))
        elif shape.kind == "train":
            rules = shd.default_rules(cfg, multi_pod=multi_pod,
                                      fsdp=True if fsdp is None else fsdp)
        else:
            rules = shd.default_rules(cfg, multi_pod=multi_pod,
                                      decode=shape.kind == "decode",
                                      fsdp=_serve_fsdp(cfg) if fsdp is None else fsdp)

    b, s = shape.global_batch, shape.seq_len
    tok_spec = shd.activation_spec("batch", None, rules=rules)
    if shape.kind == "train":
        batch = {"tokens": _meta((b, s), torch.int32), "labels": _meta((b, s), torch.int32),
                 **_extras_shapes(cfg, b, dtype, shape.kind)}
        specs = {"tokens": tok_spec, "labels": tok_spec,
                 **_extras_specs(cfg, rules, shape.kind)}
    elif shape.kind == "prefill":
        batch = {"tokens": _meta((b, s), torch.int32),
                 **_extras_shapes(cfg, b, dtype, shape.kind)}
        specs = {"tokens": tok_spec, **_extras_specs(cfg, rules, shape.kind)}
    else:  # decode
        batch = {"token": _meta((b, 1), torch.int32),
                 **_extras_shapes(cfg, b, dtype, shape.kind)}
        specs = {"token": tok_spec, **_extras_specs(cfg, rules, shape.kind)}
        cache = model.init_cache(b, s)
        batch["__cache__"] = cache
        specs["__cache__"] = shd.cache_pspecs(cache, rules)
    return {"batch": batch, "specs": specs, "rules": rules, "cfg": cfg,
            "shape": shape, "model": model}


def init_state_specs(state_shapes, pspecs):
    """TrainState specs: params/mu/nu follow param specs; scalars replicate."""
    return train.TrainState(params=pspecs,
                            opt_state=optim.OptState(step=shd.P(), mu=pspecs, nu=pspecs),
                            step=shd.P())


def _moments(cfg, m_dtype: Optional[str]) -> Optional[torch.dtype]:
    bf16 = m_dtype == "bfloat16" or (m_dtype is None and cfg.param_count() > 1e11)
    return torch.bfloat16 if bf16 else None


def cell_specs(spec: dict, mesh) -> dict:
    """The sanitized specs of a cell (``input_specs``' result) on ``mesh``
    (anything with a ``.shape`` mapping): ``params``, ``state`` (train),
    ``batch`` and ``cache`` (decode) — what ``lower_cell`` lays each
    argument out by."""
    params = dict(spec["model"].named_parameters())
    pspecs = shd.param_pspecs(params, spec["rules"])
    batch = {k: v for k, v in spec["batch"].items() if k != "__cache__"}
    bspecs = {k: v for k, v in spec["specs"].items() if k != "__cache__"}
    out = {"params": shd.sanitize_pspecs(params, pspecs, mesh),
           "batch": shd.sanitize_pspecs(batch, bspecs, mesh)}
    if spec["shape"].kind == "train":
        out["state"] = init_state_specs(None, out["params"])
    if "__cache__" in spec["batch"]:
        out["cache"] = shd.sanitize_pspecs(spec["batch"]["__cache__"],
                                           spec["specs"]["__cache__"], mesh)
    return out


@dataclasses.dataclass
class Lowered:
    """A cell laid out on its mesh. ``step()`` runs its train step,
    prefill or decode step once (inside the cell's rules) and returns the
    outputs; ``args`` are the laid-out arguments (``state`` for train,
    ``params`` (the model's own) for serving, ``batch``, and ``cache`` for
    decode) and ``inputs`` the same inputs before layout; ``specs`` is
    ``cell_specs``."""
    model: Any
    args: dict
    inputs: dict
    specs: dict
    step: Callable[[], Any]


def _inputs(batch: dict, device, seed: int, vocab: int) -> dict:
    """The batch's stand-ins on a real device: tokens uniform over the
    vocabulary, extras N(0, 1), from ``seed``; on ``meta``, the stand-ins."""
    if torch.device(device).type == "meta":
        return dict(batch)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, v in batch.items():
        if v.dtype == torch.int32:
            out[k] = torch.randint(0, vocab, tuple(v.shape), generator=gen, device=device,
                                   dtype=torch.int32)
        else:
            out[k] = torch.randn(tuple(v.shape), generator=gen, device=device).to(v.dtype)
    return out


def lower_cell(arch: str, shape_name: str, mesh, *, multi_pod: bool = False,
               fsdp: Optional[bool] = None,
               num_microbatches: Optional[int] = None,
               m_dtype: Optional[str] = None,
               rules: Optional[shd.ShardingRules] = None,
               seed: int = 0) -> tuple[Lowered, CellMeta]:
    """Lay one cell out on ``mesh`` (a ``launch.mesh.Mesh``) -> (lowered,
    meta). The model is built on the mesh's device type (``meta`` over a
    fake world, else CUDA or the CPU with seed ``seed``); the params, the
    train state, the batch and the cache are laid out by ``cell_specs``."""
    spec = input_specs(arch, shape_name, multi_pod=multi_pod, fsdp=fsdp, rules=rules)
    cfg, shape, rules = spec["cfg"], spec["shape"], spec["rules"]
    chips = math.prod(mesh.shape.values())
    nm = num_microbatches or _default_microbatches(cfg)
    meta = CellMeta(arch, shape_name, shape.kind, chips,
                    fsdp if fsdp is not None else shape.kind == "train",
                    nm if shape.kind == "train" else 0, rules)
    specs = cell_specs(spec, mesh)
    device = mesh.device_type
    model = spec["model"] if device == "meta" else make_model(cfg, device=device, seed=seed)
    batch = {k: v for k, v in spec["batch"].items() if k != "__cache__"}
    inputs = _inputs(batch, model.device, seed + 1, cfg.vocab_size)
    dm = mesh.device_mesh

    def lay(x, sp):
        return distribute_tensor(x, dm, shd.placements(sp, mesh), src_data_rank=None)

    with shd.use_rules(rules, mesh):
        laid = {k: lay(v, specs["batch"][k]) for k, v in inputs.items()}
        extras = {k: v for k, v in laid.items() if k not in ("tokens", "labels", "token")}
        if shape.kind == "train":
            tx = optim.adamw(optim.cosine_schedule(3e-4, 2000, 100_000), weight_decay=0.1,
                             m_dtype=_moments(cfg, m_dtype), max_grad_norm=1.0)
            state = train.init_state(
                shd.distribute_params(train.model_params(model), mesh, rules), tx)
            fn = train.make_train_step(model, tx, num_microbatches=nm)
            args = {"state": state, "batch": laid}
            call = lambda: fn(state, laid)
        else:
            shd.distribute_model(model, mesh, rules)
            args = {"params": dict(model.named_parameters()), "batch": laid}
            if shape.kind == "prefill":
                call = lambda: model.prefill(laid["tokens"], extras or None)
            else:
                cache = model.init_cache(shape.global_batch, shape.seq_len)
                args["cache"] = cache
                call = lambda: model.decode_step(laid["token"], cache, extras or None)

    def step():
        with shd.use_rules(rules, mesh):
            return call()

    return Lowered(model, args, inputs, specs, step), meta
