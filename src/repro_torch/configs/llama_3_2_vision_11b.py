"""Llama-3.2-11B-Vision [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

Text backbone with cross-attention image layers every 5th layer; the vision
tower is a stub — the caller passes precomputed patch embeddings as
``extras["images"]`` [B, 1601, 4096].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    cross_attn_period=5, num_image_tokens=1601,
    rope_theta=5e5,
)
