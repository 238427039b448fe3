"""Model assembler, dense and MoE families (port of
``repro.models.transformer``).

A config induces a repeating period of sublayers (``layer_kinds``,
``block_period``); the ported archs have period 1: [attn + mlp] x L for
the dense LMs, [attn + moe] x L for grok-1 and qwen3-moe. The reference
stacks each period-position's params and scans them; here the layers are
an ``nn.ModuleList`` walked in order, each built from its kind, and the
run is eager under ``torch.no_grad`` (no remat: the port serves, it does
not train yet). The MoE load-balance loss is summed over the sublayers as
the reference's scan sums it (``logits_and_aux``).

``Model.prefill`` runs every attention sublayer through kernel D;
``Model.decode_step`` runs the dense cached attention. SSM and hybrid
stacks, cross-attention, an encoder and a tied head raise
``NotImplementedError`` until their slice is ported.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class SublayerKind:
    mixer: str          # "attn" | "ssm"
    moe: bool
    cross: bool
    ffn: bool


def layer_kinds(cfg: ModelConfig) -> list[SublayerKind]:
    """Each layer's sublayer kind (the reference's rule, every family)."""
    kinds = []
    for i in range(cfg.num_layers):
        if cfg.family == "ssm":
            kinds.append(SublayerKind("ssm", False, False, False))
            continue
        if cfg.family == "hybrid" and cfg.attn_layer_period:
            mixer = "attn" if i % cfg.attn_layer_period == cfg.attn_layer_period - 1 else "ssm"
        else:
            mixer = "attn"
        moe = bool(cfg.num_experts) and i % cfg.moe_layer_period == cfg.moe_layer_period - 1
        cross = bool(cfg.cross_attn_period) and i % cfg.cross_attn_period == cfg.cross_attn_period - 1
        kinds.append(SublayerKind(mixer, moe, cross, ffn=True))
    return kinds


def block_period(cfg: ModelConfig) -> int:
    p = 1
    for per in (cfg.moe_layer_period if cfg.num_experts else 1,
                cfg.attn_layer_period or 1,
                cfg.cross_attn_period or 1):
        p = math.lcm(p, per)
    if cfg.num_layers % p:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers is not a multiple of "
                         f"the block period {p}")
    return p


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless every sublayer is attention + an MLP or MoE FFN
    (SwiGLU or GeLU), with no encoder and an untied head."""
    if (cfg.family not in ("dense", "moe") or cfg.cross_attn_period
            or cfg.encoder_layers or cfg.tie_embeddings or cfg.act not in ("swiglu", "gelu")):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): only attention + MLP / MoE stacks are ported")


class Block(nn.Module):
    """One attention sublayer with its MLP or MoE FFN (``_apply_sublayer``
    of an attention kind)."""

    def __init__(self, cfg: ModelConfig, kind: SublayerKind, gen: torch.Generator,
                 device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = L.Attention(cfg, gen, device)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        if kind.moe:
            self.moe = L.MoE(cfg, gen, device)
        else:
            self.mlp = L.MLP(cfg, gen, device)

    def forward(self, x: torch.Tensor, kv_cache: dict | None = None,
                pos: int | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
        """-> (x, the MoE aux loss, or None for an MLP)."""
        x = x + self.attn(self.ln1(x), kv_cache=kv_cache, pos=pos)
        h = self.ln2(x)
        if hasattr(self, "moe"):
            y, aux = self.moe(h)
            return x + y, aux
        return x + self.mlp(h), None


class Model(nn.Module):
    """A dense or MoE LM on one device. ``device=None`` means CUDA (and raises
    where there is none); pass ``device="cpu"`` for the plain path. The
    init is drawn on the device from ``torch.Generator(device).manual_seed(
    seed)`` with ``dense_init``'s std rule."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.device = ops.resolve_device(device)
        dev, dt = self.device, L.dtype_of(cfg)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.blocks = nn.ModuleList(Block(cfg, kind, gen, dev) for kind in layer_kinds(cfg))
        self.embed = nn.Parameter(
            L.dense_init((cfg.vocab_size, cfg.d_model), gen, dtype=dt, device=dev),
            requires_grad=False)
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, dev)
        self.lm_head = nn.Parameter(
            L.dense_init((cfg.d_model, cfg.vocab_size), gen, dtype=dt, device=dev),
            requires_grad=False)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens].to(L.dtype_of(self.cfg))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return L.project(self.final_norm(x), self.lm_head, 1)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, V] in the model dtype."""
        return self.logits_and_aux(tokens)[0]

    @torch.no_grad()
    def logits_and_aux(self, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``forward``: (logits [B, T, V], the MoE
        load-balance loss summed over the sublayers, f32, 0 without MoE)."""
        x, aux = self._hidden(tokens)
        return self._logits(x), aux

    def _hidden(self, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self._embed(tokens.to(self.device))
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for block in self.blocks:
            x, a = block(x)
            if a is not None:
                aux = aux + a
        return x, aux

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced pass over tokens [B, T] -> last-position logits
        [B, V], the value of the reference's ``logits[:, -1]``. Only the
        last position goes through the final norm and the head (both are
        per position): at 32,768 tokens the full [1, T, 49152] bf16 logits
        would take 3.2 GB. Every attention sublayer runs kernel D."""
        return self._logits(self._hidden(tokens)[0][:, -1:])[:, 0]

    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        mk = lambda: torch.zeros(shape, dtype=L.dtype_of(cfg), device=self.device)
        return {"layers": [{"kv": {"k": mk(), "v": mk()}} for _ in self.blocks],
                "pos": 0}

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: dict
                    ) -> tuple[torch.Tensor, dict]:
        """token [B, 1] -> (logits [B, V], cache). Writes the step's K/V into
        the cache tensors in place and returns the cache with ``pos`` + 1."""
        pos = cache["pos"]
        x = self._embed(token.to(self.device))
        for block, c in zip(self.blocks, cache["layers"]):
            x, _ = block(x, kv_cache=c["kv"], pos=pos)
        return self._logits(x)[:, 0], {"layers": cache["layers"], "pos": pos + 1}


def make_model(cfg: ModelConfig, device: str | torch.device | None = None,
               seed: int = 0) -> Model:
    return Model(cfg, device, seed)
