"""Model assembler, dense family (port of ``repro.models.transformer``).

A config induces a repeating period of sublayers; the dense LMs of this
slice have period 1, [attn + mlp] x L. The reference stacks each
period-position's params and scans them (so it needs ``block_period``);
here the layers are an ``nn.ModuleList`` walked in order, and the run is
eager under ``torch.no_grad`` (no remat: the port serves, it does not
train yet).

``Model.prefill`` runs every attention sublayer through kernel D;
``Model.decode_step`` runs the dense cached attention. Configs with
experts, SSM layers, cross-attention, an encoder, a tied head or another
activation than SwiGLU raise ``NotImplementedError`` until their slice is
ported.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless the config is a dense stack of attention + SwiGLU MLP
    sublayers, with no encoder and an untied head. The reference's
    ``layer_kinds`` comes with the first slice that mixes sublayer kinds."""
    if (cfg.family != "dense" or cfg.num_experts or cfg.cross_attn_period
            or cfg.encoder_layers or cfg.tie_embeddings or cfg.act != "swiglu"):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): only dense attention + SwiGLU stacks are ported")


class Block(nn.Module):
    """One [attn + mlp] sublayer (``_apply_sublayer`` of a dense kind)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = L.Attention(cfg, gen, device)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.mlp = L.MLP(cfg, gen, device)

    def forward(self, x: torch.Tensor, kv_cache: dict | None = None,
                pos: int | None = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), kv_cache=kv_cache, pos=pos)
        return x + self.mlp(self.ln2(x))


class Model(nn.Module):
    """A dense LM on one device. ``device=None`` means CUDA (and raises
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
        self.blocks = nn.ModuleList(Block(cfg, gen, dev) for _ in range(cfg.num_layers))
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
        return self._logits(self._hidden(tokens))

    def _hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self._embed(tokens.to(self.device))
        for block in self.blocks:
            x = block(x)
        return x

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced pass over tokens [B, T] -> last-position logits
        [B, V], the value of the reference's ``logits[:, -1]``. Only the
        last position goes through the final norm and the head (both are
        per position): at 32,768 tokens the full [1, T, 49152] bf16 logits
        would take 3.2 GB. Every attention sublayer runs kernel D."""
        return self._logits(self._hidden(tokens)[:, -1:])[:, 0]

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
            x = block(x, kv_cache=c["kv"], pos=pos)
        return self._logits(x)[:, 0], {"layers": cache["layers"], "pos": pos + 1}


def make_model(cfg: ModelConfig, device: str | torch.device | None = None,
               seed: int = 0) -> Model:
    return Model(cfg, device, seed)
