"""InternVL2-1B — VLM: InternViT (STUB) + Qwen2-0.5B language backbone.

[arXiv:2404.16821]
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
Vision encoder + projector are a STUB: ``input_specs`` supplies projected
patch embeddings (B, 256, 896) prepended to the token stream.
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821 (InternVL2), Qwen2-0.5B LM backbone",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    max_position_embeddings=32768,
    tie_embeddings=True,
    encoder=EncoderConfig(num_layers=0, n_ctx=256),  # pure stub: embeddings in
))
