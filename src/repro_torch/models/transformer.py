"""Model assembler, every family (port of ``repro.models.transformer``).

A config induces a repeating period of sublayers (``layer_kinds``,
``block_period``): [attn + mlp] x L for the dense LMs, [attn + moe] x L
for grok-1 and qwen3-moe, [ssm] x 24 for mamba2 (no FFN, tied head),
jamba's period of 8, [ssm + mlp, ssm + moe, ...,  attn + moe], and
llama-vision's period of 5, [attn + mlp] x 4 then attn + cross + mlp;
whisper is an encoder stack and a decoder stack with a cross sublayer at
every layer (``dec_cross``). The reference stacks each period-position's
params and scans them; here the layers are an ``nn.ModuleList`` walked in
order, each built from its kind. The MoE load-balance loss is summed over
the sublayers as the reference's scan sums it (``logits_and_aux``).

Serving (``forward``, ``logits_and_aux``, ``prefill``, ``decode_step``)
runs under ``torch.no_grad``, and every parameter is made with
``requires_grad=False``, so serving builds no graph. Training is
functional, as the reference's is: ``train.step`` calls ``Model.loss``
through ``torch.func.functional_call`` with leaves that require grad, and
``loss`` runs with autograd on. With ``remat`` each block is wrapped in
``torch.utils.checkpoint`` (non-reentrant): its activations are dropped
and recomputed in the backward, the reference's ``jax.checkpoint`` with
``nothing_saveable`` around each scanned body.

``extras`` is the reference's: ``images`` [B, T_img, d] (vlm), ``frames``
[B, T_frames, d] (audio; the encoder runs over them at every call) or
``memory`` [B, T_mem, d] (a precomputed encoder output; it wins over the
others). Each is cast to the model dtype on the model's device; a vlm or
audio model without its extra raises ``KeyError``, as the reference does.

``Model.prefill`` runs every attention sublayer through kernel D (the
cross sublayers and the encoder's non-causal self-attention too) and
every SSM sublayer through ``ssm.ssm_train``; ``Model.decode_step`` runs
the dense cached self-attention, the cross sublayers through kernel D at
Tq 1, and ``ssm.ssm_step``. The memory's K / V are recomputed at every
step, as the reference does (it keeps no cross-attention cache).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
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
    """Raise unless the family and the FFN activation are the reference's."""
    if (cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
            or cfg.act not in ("swiglu", "gelu")):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} with act {cfg.act!r} is not "
                         "the reference's")


class CrossAttention(nn.Module):
    """A cross sublayer's params (``ln_cross``, ``cross``): whisper's
    ``dec_cross`` entry of one decoder layer."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        self.ln_cross = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.cross = L.Attention(cfg, gen, device)


class Block(nn.Module):
    """One sublayer (``_apply_sublayer``): its mixer by ``kind.mixer``
    (``attn``: GQA attention, ``ssm``: the Mamba2 SSD block), then, where
    ``kind.cross``, its cross sublayer over the memory, then, where
    ``kind.ffn``, its MLP or MoE FFN."""

    def __init__(self, cfg: ModelConfig, kind: SublayerKind, gen: torch.Generator,
                 device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        if kind.mixer == "attn":
            self.attn = L.Attention(cfg, gen, device)
        else:
            self.ssm = S.SSM(cfg, gen, device)
        if kind.cross:
            self.ln_cross = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
            self.cross = L.Attention(cfg, gen, device)
        if kind.ffn:
            self.ln2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
            if kind.moe:
                self.moe = L.MoE(cfg, gen, device)
            else:
                self.mlp = L.MLP(cfg, gen, device)

    def forward(self, x: torch.Tensor, cache: dict | None = None, pos: int | None = None,
                memory: torch.Tensor | None = None, cross_extra: CrossAttention | None = None,
                causal: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
        """-> (x, the MoE aux loss, or None without MoE). With the layer's
        ``cache`` entry (decode), an attention sublayer writes its K/V into
        ``cache["kv"]`` in place and an SSM sublayer puts its new state
        under ``cache["ssm"]``. The cross sublayer (this block's own, or
        ``cross_extra``'s params) runs only where ``memory`` is given, as
        the reference's does; ``causal=False`` is the audio encoder's
        self-attention."""
        h = self.ln1(x)
        if hasattr(self, "attn"):
            x = x + self.attn(h, causal=causal, kv_cache=cache["kv"] if cache else None,
                              pos=pos)
        elif cache is not None:
            y, cache["ssm"] = self.ssm.step(h, cache["ssm"])
            x = x + y
        else:
            x = x + self.ssm(h)
        cp = cross_extra if cross_extra is not None else self
        if hasattr(cp, "cross") and memory is not None:
            x = x + cp.cross(cp.ln_cross(x), memory=memory)
        if hasattr(self, "moe"):
            y, aux = self.moe(self.ln2(x))
            return x + y, aux
        if hasattr(self, "mlp"):
            return x + self.mlp(self.ln2(x)), None
        return x, None


# the families whose every sublayer runs on a device mesh (the cross
# sublayers and the audio encoder do not yet)
MESH_FAMILIES = ("dense", "moe", "ssm", "hybrid")

# the audio encoder's sublayer: self-attention (run non-causal) and an MLP
ENCODER_KIND = SublayerKind("attn", False, False, True)


def _lookup_on_mesh(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` on the mesh: each rank looks its ("batch", "seq")
    rows up in the table gathered whole, with the op the plain path uses
    (so its gradient is the same scatter-add); the table's gradient is
    summed over the ranks. DTensor's own lookup in a vocab-sharded table
    cannot redistribute its gradient, and its indexing fails to shard in
    torch 2.11."""
    mesh = shd.current_mesh()
    spec = shd.even_spec(shd.activation_spec("batch", "seq"), tokens.shape, mesh)
    return shd.shard_map(lambda t, ids: t[ids], mesh=mesh, in_specs=(shd.P(None, None), spec),
                         out_specs=shd.P(*spec, None))(table, tokens)


class Model(nn.Module):
    """An LM of any family on one device. ``device=None`` means CUDA (and
    raises where there is none); pass ``device="cpu"`` for the plain path.
    The init is drawn on the device from ``torch.Generator(device)
    .manual_seed(seed)`` with ``dense_init``'s std rule (``device="meta"``
    gives the shapes alone). A tied head
    (``tie_embeddings``) has no ``lm_head``: the logits use ``embed.T``.
    An encoder-decoder (``encoder_layers``) also holds ``encoder`` (its
    layers), ``enc_norm`` and ``dec_cross`` (each decoder layer's cross
    sublayer), under the reference's names."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.device = ops.resolve_device(device)
        dev, dt = self.device, L.dtype_of(cfg)
        # a meta model (shapes only, for layouts) draws nothing
        gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
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
        if cfg.encoder_layers:
            self.encoder = nn.ModuleList(Block(cfg, ENCODER_KIND, gen, dev)
                                         for _ in range(cfg.encoder_layers))
            self.enc_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, dev)
            self.dec_cross = nn.ModuleList(CrossAttention(cfg, gen, dev)
                                           for _ in range(cfg.num_layers))

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = _lookup_on_mesh(self.embed, tokens) if isinstance(tokens, shd.DTensor) \
            else self.embed[tokens]
        return shd.constrain(x.to(L.dtype_of(self.cfg)), "batch", "seq", "d_model")

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return shd.constrain(L.project(self.final_norm(x), head, 1), "batch", "seq", "vocab")

    def encode_audio(self, frames) -> torch.Tensor:
        """The encoder stack (``_encode_audio``) over frame embeddings [B,
        T_frames, d] (a tensor or an array, on any device): each layer's
        non-causal self-attention (rotated at ``arange(T_frames)``) and
        GeLU MLP, then ``enc_norm`` -> the memory [B, T_frames, d] in the
        model dtype. It runs with autograd as the caller has it (``loss``
        trains the encoder); a serving caller runs it under no_grad."""
        x = self._extra(frames)
        for block in self.encoder:
            x, _ = block(x, causal=False)
        return self.enc_norm(x)

    def _extra(self, value) -> torch.Tensor:
        return torch.as_tensor(value).to(device=self.device, dtype=L.dtype_of(self.cfg))

    def _memory_for(self, extras: dict) -> torch.Tensor | None:
        """``_memory_for``: ``memory`` wins, then the family's own extra."""
        if "memory" in extras:
            return self._extra(extras["memory"])
        if self.cfg.family == "audio":
            return self.encode_audio(extras["frames"])
        if self.cfg.family == "vlm":
            return self._extra(extras["images"])
        return None

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, extras: dict | None = None) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, V] in the model dtype."""
        return self.logits_and_aux(tokens, extras)[0]

    @torch.no_grad()
    def logits_and_aux(self, tokens: torch.Tensor, extras: dict | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``forward``: (logits [B, T, V], the MoE
        load-balance loss summed over the sublayers, f32, 0 without MoE)."""
        x, aux = self._hidden(tokens, extras)
        return self._logits(x), aux

    def _hidden(self, tokens: torch.Tensor, extras: dict | None,
                cache: dict | None = None, remat: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
        if shd.current_mesh() is not None and self.cfg.family not in MESH_FAMILIES:
            raise NotImplementedError(f"{self.cfg.name}: the {self.cfg.family} family does "
                                      "not run on a mesh yet")
        memory = self._memory_for(extras or {})
        x = self._embed(shd.as_global(tokens.to(self.device), "batch", "seq"))
        aux = shd.as_global(torch.zeros((), dtype=torch.float32, device=self.device))
        pos = cache["pos"] if cache else None
        remat = remat and cache is None and torch.is_grad_enabled()
        # the recompute runs in the backward, on the autograd engine's own
        # thread for CUDA tensors: it takes the sharding rules and mesh of
        # the forward with it
        rules, mesh = shd.current_rules(), shd.current_mesh()
        rules_ctx = lambda: (contextlib.nullcontext(), shd.use_rules(rules, mesh))
        for i, block in enumerate(self.blocks):
            kwargs = dict(cache=cache["layers"][i] if cache else None, pos=pos, memory=memory,
                          cross_extra=self.dec_cross[i] if self.cfg.encoder_layers else None)
            if remat:
                x, a = checkpoint(block, x, use_reentrant=False, context_fn=rules_ctx,
                                  **kwargs)
            else:
                x, a = block(x, **kwargs)
            if a is not None:
                aux = aux + a
        return x, aux

    def loss(self, batch: dict, remat: bool = True
             ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """The reference's ``Model.loss``: ``batch`` holds ``tokens`` and
        ``labels`` [B, T] (tensors or arrays) and any extras under their
        own keys. -> (nll + 1e-4 * mean(lse**2) + 0.01 * aux, {"nll",
        "aux"}), all f32: the logits are cast to f32, lse is their
        logsumexp and the gold logit is taken at each label. With autograd
        on and ``remat``, each block is recomputed in the backward."""
        extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
        x, aux = self._hidden(torch.as_tensor(batch["tokens"]), extras, remat=remat)
        logits = self._logits(x).float()
        labels = shd.as_global(torch.as_tensor(batch["labels"]).to(
            device=self.device, dtype=torch.int64), "batch", "seq")
        lse = torch.logsumexp(logits, dim=-1)
        # DTensor's gather from a vocab-sharded tensor fails in its masked
        # reduction: the gold logit is taken from the vocab gathered whole
        gold = torch.gather(shd.unshard(logits, -1), -1, labels[..., None])[..., 0]
        nll = torch.mean(lse - gold)
        z_loss = 1e-4 * torch.mean(torch.square(lse))
        return nll + z_loss + 0.01 * aux, {"nll": nll, "aux": aux}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, extras: dict | None = None) -> torch.Tensor:
        """Teacher-forced pass over tokens [B, T] -> last-position logits
        [B, V], the value of the reference's ``logits[:, -1]``. Only the
        last position goes through the final norm and the head (both are
        per position): at 32,768 tokens the full [1, T, 49152] bf16 logits
        would take 3.2 GB. Every attention sublayer runs kernel D, every
        SSM sublayer the chunked SSD."""
        return self._logits(self._hidden(tokens, extras)[0][:, -1:])[:, 0]

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Each layer's entry by its kind: ``{"kv": {"k", "v": [B, max_len,
        KV, hd]}}`` in the model dtype for attention, ``{"ssm": {"conv":
        [B, W-1, conv_ch] in the model dtype, "h": [B, H, N, P] f32}}`` for
        SSM; ``pos`` 0. Nothing for the cross sublayers: their K / V are
        the memory's, recomputed at every step. Inside ``use_rules(rules,
        mesh)`` each leaf is a DTensor of zeros laid out by
        ``cache_pspecs`` and then ``sanitize_pspecs`` (the reference's
        ``cells.input_specs`` / ``lower_cell``, ``cells.py:123-125``,
        ``:145-149``): each rank allocates its own block alone. A
        ``max_len`` the axes do not divide leaves the sequence whole."""
        cfg, dt = self.cfg, L.dtype_of(self.cfg)
        shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        mesh, rules = shd.current_mesh(), shd.current_rules()
        on_mesh = mesh is not None and rules is not None
        dev = "meta" if on_mesh else self.device
        mk = lambda: torch.zeros(shape, dtype=dt, device=dev)
        layers = [{"kv": {"k": mk(), "v": mk()}} if kind.mixer == "attn" else
                  {"ssm": S.init_ssm_cache(cfg, batch, dt, dev)}
                  for kind in self.kinds]
        if on_mesh:
            layers = shd.distribute_cache(layers, mesh, rules)
        return {"layers": layers, "pos": 0}

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: dict, extras: dict | None = None
                    ) -> tuple[torch.Tensor, dict]:
        """token [B, 1] -> (logits [B, V], cache). Writes the step's K/V into
        the cache tensors in place, puts each SSM layer's new state in its
        entry, and returns the cache with ``pos`` + 1. With ``frames`` the
        encoder runs again, as in the reference; pass ``memory`` to spare it.
        Inside ``use_rules(rules, mesh)`` (params laid out by
        ``sharding.distribute_model``, the cache by ``init_cache`` there)
        each rank writes into its own cache block and the logits come out
        a DTensor split over the vocabulary (dense and MoE families)."""
        x, _ = self._hidden(token, extras, cache)
        return self._logits(x)[:, 0], {"layers": cache["layers"], "pos": cache["pos"] + 1}


def make_model(cfg: ModelConfig, device: str | torch.device | None = None,
               seed: int = 0) -> Model:
    return Model(cfg, device, seed)
