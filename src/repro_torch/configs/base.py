"""Model / input-shape configuration schema and registry (port of
``repro.configs.base``).

``ModelConfig`` is a copy of the reference's dataclass, field for field,
so a config carries across as ``ModelConfig(**dataclasses.asdict(c))``.
The registry holds every architecture of ``ARCH_IDS``.
"""
from __future__ import annotations

import dataclasses
import importlib
import math


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_layer_period: int = 1   # layer % period == period-1 is MoE
    capacity_factor: float = 1.25
    moe_ffn_shards: int = 1
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    attn_layer_period: int = 0  # hybrid: one attention layer per period
    # --- position encoding ---
    rope_theta: float = 1e4
    rope_fraction: float = 1.0  # chatglm applies rotary to half the head dim
    # --- VLM ---
    cross_attn_period: int = 0  # one cross-attn-augmented layer per period
    num_image_tokens: int = 0
    # --- enc-dec (audio) ---
    encoder_layers: int = 0
    num_audio_frames: int = 0
    # --- misc ---
    norm_eps: float = 1e-5
    act: str = "swiglu"         # swiglu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_model // max(self.num_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """long_500k runs only for sub-quadratic sequence mixers."""
        return self.family in ("ssm", "hybrid")

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU tests (the reference's rule)."""
        period = 1
        for per in (self.moe_layer_period if self.num_experts else 1,
                    self.attn_layer_period or 1,
                    self.cross_attn_period or 1):
            period = period * per // math.gcd(period, per)
        layers = period * max(1, 4 // period)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, layers),
            d_model=128,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=(min(4, max(1, self.num_kv_heads * 4 // self.num_heads))
                          if self.num_heads else 0),
            d_ff=256,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            num_image_tokens=min(self.num_image_tokens, 16),
            encoder_layers=min(self.encoder_layers, 2),
            num_audio_frames=min(self.num_audio_frames, 32),
        )

    def param_count(self) -> int:
        """Analytic parameter count (the reference's, for every family)."""
        d, f, v, hd = self.d_model, self.d_ff, self.vocab_size, self.head_dim
        h, kv = self.num_heads, self.num_kv_heads
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d      # q, k+v, o
        mlp = 3 * d * f if self.act == "swiglu" else 2 * d * f
        total = 0
        for layer in range(self.num_layers):
            if self.family == "ssm":
                total += self._ssm_layer_params()
                continue
            if self.family == "hybrid":
                is_attn = (self.attn_layer_period and
                           layer % self.attn_layer_period == self.attn_layer_period - 1)
                total += attn if is_attn else self._ssm_layer_params()
            else:
                total += attn
            if self.cross_attn_period and layer % self.cross_attn_period == self.cross_attn_period - 1:
                total += attn
            is_moe = (self.num_experts and
                      layer % self.moe_layer_period == self.moe_layer_period - 1)
            total += (self.num_experts * mlp + d * self.num_experts) if is_moe else mlp
            total += 2 * d  # norms
        total += v * d                       # embed
        if not self.tie_embeddings:
            total += v * d                   # lm_head
        if self.encoder_layers:
            total += self.encoder_layers * (attn + mlp + 2 * d)
            total += self.num_layers * attn  # decoder cross-attn
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE counts only routed experts)."""
        if not self.num_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp = 3 * d * f if self.act == "swiglu" else 2 * d * f
        moe_layers = sum(
            1 for layer in range(self.num_layers)
            if layer % self.moe_layer_period == self.moe_layer_period - 1)
        dense_total = self.param_count() - moe_layers * self.num_experts * mlp
        return dense_total + moe_layers * self.experts_per_token * mlp

    def _ssm_layer_params(self) -> int:
        d, n = self.d_model, self.ssm_state
        d_inner = 2 * d
        heads = d_inner // self.ssm_head_dim
        in_proj = d * (2 * d_inner + 2 * n + heads)
        return in_proj + self.ssm_conv_width * (d_inner + 2 * n) + d_inner * d + heads


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


LM_SHAPES = (
    InputShape("train_4k", "train", 4_096, 256),
    InputShape("prefill_32k", "prefill", 32_768, 32),
    InputShape("decode_32k", "decode", 32_768, 128),
    InputShape("long_500k", "decode", 524_288, 1),
)

ARCH_IDS = (
    "grok-1-314b",
    "qwen3-moe-30b-a3b",
    "llama-3.2-vision-11b",
    "granite-8b",
    "chatglm3-6b",
    "phi3-medium-14b",
    "granite-3-8b",
    "mamba2-130m",
    "jamba-v0.1-52b",
    "whisper-base",
)

# each architecture's config module
_PORTED = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; options: {list(ARCH_IDS)}")
    return importlib.import_module(_PORTED[arch]).CONFIG


def get_shape(name: str) -> InputShape:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}")
