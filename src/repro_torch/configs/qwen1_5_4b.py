"""Qwen1.5-4B — dense decoder with QKV bias.

[hf:Qwen/Qwen1.5-0.5B model-card family; 4B scale as assigned]
40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936, QKV bias.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B (arch family), assigned 4B dims",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=5_000_000.0,
    max_position_embeddings=32768,
))
