"""Phi-4-mini (3.8B) — dense decoder, RoPE (partial) + SwiGLU + GQA.

[arXiv:2412.08905]
32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    source="arXiv:2412.08905 (Phi-4 family), mini dims",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    partial_rotary_factor=0.75,
    max_position_embeddings=131072,
    tie_embeddings=True,
))
