"""Jamba-v0.1 52B [arXiv:2403.19887; hf] — Mamba+attention 1:7 interleave,
MoE 16e top-2 on every other layer."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    num_experts=16, experts_per_token=2, moe_layer_period=2,
    ssm_state=16, ssm_head_dim=64, ssm_conv_width=4,
    attn_layer_period=8,  # 1 attention layer per 8 (1:7 mamba:attn)
)
