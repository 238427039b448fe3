"""ChatGLM3-6B [arXiv:2406.12793; hf] — 2D/partial RoPE, GQA kv=2."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=65024,
    rope_fraction=0.5,  # rotary applied to half of each head (RoPE-2d)
)
