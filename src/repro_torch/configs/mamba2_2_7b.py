"""Mamba2-2.7B — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060]
64L d_model=2560 (attn-free), d_inner=5120, head_dim=64 => 80 heads,
ssm_state=128, vocab=50280.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060 (Mamba-2 / SSD)",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    norm="rmsnorm",
    max_position_embeddings=1 << 20,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256)
))
