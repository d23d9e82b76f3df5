"""CodeQwen1.5-7B — dense decoder, Qwen1.5 architecture.

[hf:Qwen/CodeQwen1.5-7B]
32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416, QKV bias.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    source="hf:Qwen/CodeQwen1.5-7B",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    max_position_embeddings=65536,
))
