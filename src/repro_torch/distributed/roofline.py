"""Roofline terms of one cell (port of the analytic parts of
``repro.distributed.roofline``), with an NVIDIA H100's peaks.

    compute term    = a rank's FLOPs / peak FLOP/s
    memory term     = a rank's argument bytes / HBM bytes/s
    collective term = sum over a rank's collectives of tensor bytes x
                      ring factor / link bytes/s

The reference reads its FLOPs, bytes and collectives from XLA's compiled
HLO (``hlo_cost.py``); nothing here parses HLO. ``RankCounter`` counts
them while the cell's step runs once on ``meta`` tensors (the dry run):

- FLOPs are counted inside DTensor's local dispatch: the mode declines
  every op on DTensors (as ``torch.distributed.tensor.debug.
  CommDebugMode`` does), so it sees the local ops DTensor runs on each
  rank's shards, and the ops inside ``shard_map`` on local tensors; each
  is priced by ``torch.utils.flop_counter``'s formulas at its local
  shapes. The ops on ``FakeTensor``s that DTensor's sharding propagation
  runs at global shapes, to learn an output's shape (once for each new
  op and input layout, so their number depends on its cache), run
  uncounted. Kernel D's ``meta`` route adds its attention FLOPs
  (``kernels.ops.META_FLOPS``). So the count is one rank's, a replicated
  computation counted in full.
- Collective bytes are each collective's tensor bytes as the rank holds
  them (an all-gather's or all-to-all's output, an all-reduce's tensor, a
  reduce-scatter's output, a send's tensor), DTensor's redistributes and
  the port's own ``psum`` / ``all_to_all`` / ``ppermute`` alike, weighted
  by the reference's ring factors (all-reduce 2, the others 1).

Hardware model (NVIDIA H100 SXM5, data sheet): 989 TFLOP/s dense bf16,
3.35 TB/s HBM3, NVLink 900 GB/s a GPU (450 GB/s a direction).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
           "all-to-all": 1.0, "collective-permute": 1.0}
# a collective op (torch's functional collectives, which DTensor's
# redistributes run, and c10d's, which ``torch.distributed`` runs) -> its
# kind and the argument that holds the bytes it moves (None: its output)
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", None),
    "all_reduce": ("all-reduce", None),
    "reduce_scatter_tensor": ("reduce-scatter", None),
    "all_to_all_single": ("all-to-all", None),
    "_allgather_base_": ("all-gather", 0),
    "allreduce_": ("all-reduce", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "alltoall_base_": ("all-to-all", 0),
    "send": ("collective-permute", 0),
}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


class RankCounter(TorchDispatchMode):
    """Counts one rank's FLOPs and collective bytes while it is entered
    (see the module docstring): ``flops`` (``attention_flops`` of them
    from kernel D's ``meta`` route), ``coll_bytes`` by kind (ring-factor
    weighted) and ``coll_counts`` by kind."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        from repro_torch.kernels import ops

        self._registry, self._ops = flop_registry, ops
        self.op_flops = 0.0
        self.coll_bytes = {k: 0.0 for k in _FACTOR}
        self.coll_counts = {k: 0 for k in _FACTOR}

    def __enter__(self):
        self._meta0 = self._ops.META_FLOPS["flash_attention"]
        return super().__enter__()

    def __exit__(self, *exc):
        self.attention_flops = self._ops.META_FLOPS["flash_attention"] - self._meta0
        return super().__exit__(*exc)

    @property
    def flops(self) -> float:
        return self.op_flops + self.attention_flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs it; its local ops come back here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out                  # DTensor's sharding propagation, at global shapes
        packet = getattr(func, "_overloadpacket", None)
        formula = self._registry.get(packet)
        if formula is not None:
            self.op_flops += float(formula(*args, **kwargs, out_val=out))
        coll = _COLLECTIVES.get(getattr(packet, "__name__", ""))
        if coll is not None:
            kind, arg = coll
            self.coll_bytes[kind] += _nbytes(out if arg is None else args[arg]) * _FACTOR[kind]
            self.coll_counts[kind] += 1
        return out


@dataclasses.dataclass
class Roofline:
    flops: float                  # per-chip
    hbm_bytes: float              # per-chip
    coll_bytes: float             # per-chip, factor-weighted
    coll_by_kind: dict[str, Any]
    model_flops_global: float     # 6*N*D etc.
    model_bytes_global: float     # minimum bytes that must move through HBM
    chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / total counted FLOPs (catches remat/redundancy)."""
        total = self.flops * self.chips
        return self.model_flops_global / total if total else 0.0

    @property
    def t_ideal(self) -> float:
        """Analytic lower bound: max(useful FLOPs at peak, minimum bytes at
        full HBM bandwidth)."""
        return max(self.model_flops_global / self.chips / PEAK_FLOPS,
                   self.model_bytes_global / self.chips / HBM_BW)

    @property
    def roofline_fraction(self) -> float:
        return self.t_ideal / self.t_bound if self.t_bound else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "coll_bytes_per_chip": self.coll_bytes,
            "coll_by_kind": self.coll_by_kind,
            "model_flops_global": self.model_flops_global,
            "model_bytes_global": self.model_bytes_global,
            "chips": self.chips,
            "t_ideal_s": self.t_ideal,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*tokens (train), 2*N_active*tokens
    (prefill/decode), plus the attention term."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        base = 6.0 * n_active * tokens
        attn = _attn_flops(cfg, shape.seq_len, causal=True) * shape.global_batch * 3
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        base = 2.0 * n_active * tokens
        attn = _attn_flops(cfg, shape.seq_len, causal=True) * shape.global_batch
    else:  # decode: one token per sequence, attention reads the full cache
        tokens = shape.global_batch
        base = 2.0 * n_active * tokens
        attn = (4.0 * _attn_layers(cfg) * cfg.num_heads * cfg.head_dim
                * shape.seq_len) * shape.global_batch
    return base + attn


def model_bytes(cfg, shape) -> float:
    """Minimum HBM traffic (global): weights streamed once per step, plus —
    for decode — the KV cache / SSM state read once."""
    n_active = cfg.active_param_count()
    wbytes = 2.0 * n_active  # bf16
    if shape.kind != "decode":
        return wbytes
    l_attn = _attn_layers(cfg)
    kv = (2.0 * l_attn * shape.seq_len * cfg.num_kv_heads * cfg.head_dim
          * 2.0 * shape.global_batch)
    ssm = 0.0
    if cfg.family in ("ssm", "hybrid"):
        d_inner = 2 * cfg.d_model
        heads = d_inner // cfg.ssm_head_dim
        l_ssm = cfg.num_layers - l_attn
        ssm = 4.0 * l_ssm * heads * cfg.ssm_state * cfg.ssm_head_dim * shape.global_batch
    return wbytes + kv + ssm


def _attn_layers(cfg) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid" and cfg.attn_layer_period:
        return cfg.num_layers // cfg.attn_layer_period
    return cfg.num_layers


def _attn_flops(cfg, seq: int, causal: bool) -> float:
    l = _attn_layers(cfg)  # noqa: E741 - the reference's name
    if not l:
        return 0.0
    # 2 matmuls (QK^T, PV), 2*d_head*H per position pair; causal halves it
    per_layer = 4.0 * cfg.num_heads * cfg.head_dim * seq * seq
    return l * per_layer * (0.5 if causal else 1.0)


def build(counter: RankCounter, argument_bytes: int, cfg, shape, chips: int) -> Roofline:
    """A rank's roofline from what ``counter`` counted over one run of the
    cell's step and the rank's argument bytes."""
    return Roofline(
        flops=counter.flops,
        hbm_bytes=float(argument_bytes),
        coll_bytes=sum(counter.coll_bytes.values()),
        coll_by_kind={"bytes": dict(counter.coll_bytes), "counts": dict(counter.coll_counts),
                      "attention_flops": counter.attention_flops},
        model_flops_global=model_flops(cfg, shape),
        model_bytes_global=model_bytes(cfg, shape),
        chips=chips,
    )
