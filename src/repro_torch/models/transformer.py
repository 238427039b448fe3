"""Model assembler, dense, MoE, SSM and hybrid families (port of
``repro.models.transformer``).

A config induces a repeating period of sublayers (``layer_kinds``,
``block_period``): [attn + mlp] x L for the dense LMs, [attn + moe] x L
for grok-1 and qwen3-moe, [ssm] x 24 for mamba2 (no FFN, tied head), and
jamba's period of 8, [ssm + mlp, ssm + moe, ...,  attn + moe]. The
reference stacks each period-position's params and scans them; here the
layers are an ``nn.ModuleList`` walked in order, each built from its
kind, and the run is eager under ``torch.no_grad`` (no remat: the port
serves, it does not train yet). The MoE load-balance loss is summed over
the sublayers as the reference's scan sums it (``logits_and_aux``).

``Model.prefill`` runs every attention sublayer through kernel D and
every SSM sublayer through ``ssm.ssm_train``; ``Model.decode_step`` runs
the dense cached attention and ``ssm.ssm_step``. Cross-attention and an
encoder (the vlm and audio families) raise ``NotImplementedError`` until
their slice is ported.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import ssm as S


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
    """Raise unless every sublayer is attention or SSM with an MLP or MoE
    FFN (SwiGLU or GeLU) or none, with no cross-attention and no encoder."""
    if (cfg.family not in ("dense", "moe", "ssm", "hybrid") or cfg.cross_attn_period
            or cfg.encoder_layers or cfg.act not in ("swiglu", "gelu")):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): only attention / SSM + MLP / MoE stacks are ported")


class Block(nn.Module):
    """One sublayer (``_apply_sublayer``): its mixer by ``kind.mixer``
    (``attn``: GQA attention, ``ssm``: the Mamba2 SSD block), then, where
    ``kind.ffn``, its MLP or MoE FFN."""

    def __init__(self, cfg: ModelConfig, kind: SublayerKind, gen: torch.Generator,
                 device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        if kind.mixer == "attn":
            self.attn = L.Attention(cfg, gen, device)
        else:
            self.ssm = S.SSM(cfg, gen, device)
        if kind.ffn:
            self.ln2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
            if kind.moe:
                self.moe = L.MoE(cfg, gen, device)
            else:
                self.mlp = L.MLP(cfg, gen, device)

    def forward(self, x: torch.Tensor, cache: dict | None = None,
                pos: int | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
        """-> (x, the MoE aux loss, or None without MoE). With the layer's
        ``cache`` entry (decode), an attention sublayer writes its K/V into
        ``cache["kv"]`` in place and an SSM sublayer puts its new state
        under ``cache["ssm"]``."""
        h = self.ln1(x)
        if hasattr(self, "attn"):
            x = x + self.attn(h, kv_cache=cache["kv"] if cache else None, pos=pos)
        elif cache is not None:
            y, cache["ssm"] = self.ssm.step(h, cache["ssm"])
            x = x + y
        else:
            x = x + self.ssm(h)
        if hasattr(self, "moe"):
            y, aux = self.moe(self.ln2(x))
            return x + y, aux
        if hasattr(self, "mlp"):
            return x + self.mlp(self.ln2(x)), None
        return x, None


class Model(nn.Module):
    """A dense, MoE, SSM or hybrid LM on one device. ``device=None`` means
    CUDA (and raises where there is none); pass ``device="cpu"`` for the
    plain path. The init is drawn on the device from ``torch.Generator(
    device).manual_seed(seed)`` with ``dense_init``'s std rule. A tied
    head (``tie_embeddings``) has no ``lm_head``: the logits use
    ``embed.T``."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.device = ops.resolve_device(device)
        dev, dt = self.device, L.dtype_of(cfg)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.kinds = layer_kinds(cfg)
        self.blocks = nn.ModuleList(Block(cfg, kind, gen, dev) for kind in self.kinds)
        self.embed = nn.Parameter(
            L.dense_init((cfg.vocab_size, cfg.d_model), gen, dtype=dt, device=dev),
            requires_grad=False)
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, dev)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                L.dense_init((cfg.d_model, cfg.vocab_size), gen, dtype=dt, device=dev),
                requires_grad=False)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens].to(L.dtype_of(self.cfg))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return L.project(self.final_norm(x), head, 1)

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
        would take 3.2 GB. Every attention sublayer runs kernel D, every
        SSM sublayer the chunked SSD."""
        return self._logits(self._hidden(tokens)[0][:, -1:])[:, 0]

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Each layer's entry by its kind: ``{"kv": {"k", "v": [B, max_len,
        KV, hd]}}`` in the model dtype for attention, ``{"ssm": {"conv":
        [B, W-1, conv_ch] in the model dtype, "h": [B, H, N, P] f32}}`` for
        SSM; ``pos`` 0."""
        cfg, dt = self.cfg, L.dtype_of(self.cfg)
        shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        mk = lambda: torch.zeros(shape, dtype=dt, device=self.device)
        layers = [{"kv": {"k": mk(), "v": mk()}} if kind.mixer == "attn" else
                  {"ssm": S.init_ssm_cache(cfg, batch, dt, self.device)}
                  for kind in self.kinds]
        return {"layers": layers, "pos": 0}

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: dict
                    ) -> tuple[torch.Tensor, dict]:
        """token [B, 1] -> (logits [B, V], cache). Writes the step's K/V into
        the cache tensors in place, puts each SSM layer's new state in its
        entry, and returns the cache with ``pos`` + 1."""
        pos = cache["pos"]
        x = self._embed(token.to(self.device))
        for block, c in zip(self.blocks, cache["layers"]):
            x, _ = block(x, cache=c, pos=pos)
        return self._logits(x)[:, 0], {"layers": cache["layers"], "pos": pos + 1}


def make_model(cfg: ModelConfig, device: str | torch.device | None = None,
               seed: int = 0) -> Model:
    return Model(cfg, device, seed)
