"""Qwen1.5-0.5B — dense decoder with QKV bias.

[hf:Qwen/Qwen1.5-0.5B]
24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936, QKV bias.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    max_position_embeddings=32768,
    tie_embeddings=True,
))
