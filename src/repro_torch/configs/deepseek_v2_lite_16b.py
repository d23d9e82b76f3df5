"""DeepSeek-V2-Lite (16B) — MLA attention + fine-grained MoE.

[arXiv:2405.04434]
27L d_model=2048 16H, MLA kv_lora_rank=512 (qk_nope=128, qk_rope=64,
v_head=128), MoE: 2 shared + 64 routed experts top-6, d_expert=1408,
first layer dense (d_ff=10944), vocab=102400.

NOTE: the assignment line says "MoE 64e top-6" while its bracket note says
"160 routed" (which is full DeepSeek-V2, not Lite). We follow the explicit
"64e top-6" figure, which matches the published V2-Lite card.
"""
from repro_torch.configs.base import (
    MLAConfig, ModelConfig, MoEConfig, register)

CONFIG = register(ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="arXiv:2405.04434 (DeepSeek-V2), Lite dims",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=0,                 # MLA defines its own head dims
    d_ff=10944,                 # dense FFN for the first layer
    vocab_size=102400,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    max_position_embeddings=163840,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408,
                  num_shared_experts=2, d_shared=1408,
                  router_aux_weight=0.001, first_dense=1),
))
