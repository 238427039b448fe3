"""grok-1 314B [hf:xai-org/grok-1; unverified] — MoE 8e top-2, GQA kv=8."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab_size=131072,
    num_experts=8, experts_per_token=2, moe_layer_period=1,
    moe_ffn_shards=2,  # 16 virtual half-width experts -> EP on a 16-way axis
    act="gelu",  # grok uses gelu experts
)
