"""Jamba-v0.1-52B — hybrid Mamba+attention (1:7 interleave) with MoE.

[arXiv:2403.19887]
32L d_model=4096; attention layer every 8th layer (offset 4 in the paper's
block layout; we use offset 4 of period 8 => 4 attn layers), 32H GQA kv=8,
d_ff=14336, MoE 16 experts top-2 on every other layer, vocab=65536.
Mamba layers use d_state=16 (Mamba-1 scale; executed with our SSD block,
n_groups=1 — noted in DESIGN.md §8).
"""
from repro_torch.configs.base import (
    ModelConfig, MoEConfig, SSMConfig, register)

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="arXiv:2403.19887 (Jamba)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    activation="swiglu",
    norm="rmsnorm",
    max_position_embeddings=262144,
    attn_layer_period=8,
    attn_layer_offset=4,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256),
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336,
                  moe_layer_period=2, router_aux_weight=0.01),
))
