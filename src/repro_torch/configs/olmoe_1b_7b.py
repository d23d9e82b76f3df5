"""OLMoE-1B-7B — sparse MoE, 64 experts top-8, QK-norm.

[arXiv:2409.02060]
16L d_model=2048 16H (GQA kv=16) d_ff(expert)=1024 vocab=50304.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    source="arXiv:2409.02060 (OLMoE)",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,                     # every FFN is MoE
    vocab_size=50304,
    qk_norm=True,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    max_position_embeddings=4096,
    moe=MoEConfig(num_experts=64, top_k=8, d_expert=1024,
                  router_aux_weight=0.01),
))
