"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B; hf] — MoE 128e top-8, GQA kv=4.

d_ff=768 is the per-expert intermediate size (the config as assigned).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab_size=151936,
    num_experts=128, experts_per_token=8, moe_layer_period=1,
    rope_theta=1e6,
)
