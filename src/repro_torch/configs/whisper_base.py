"""Whisper-base [arXiv:2212.04356; unverified] — enc-dec; conv audio
frontend is a stub: the caller passes precomputed frame embeddings as
``extras["frames"]`` [B, 1500, 512], or the encoder's output as
``extras["memory"]``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865,
    encoder_layers=6, num_audio_frames=1500,
    act="gelu",
)
