"""Whisper-medium — encoder-decoder audio backbone.

[arXiv:2212.04356]
24L (decoder) d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.
Enc-dec with conv frontend STUB: ``input_specs`` supplies precomputed
mel-frame embeddings (B, 1500, 1024); we implement the transformer
encoder stack + decoder with self/cross attention.
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-medium",
    family="audio",
    source="arXiv:2212.04356 (Whisper), medium dims",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    qkv_bias=True,
    activation="gelu",
    norm="layernorm",
    learned_positions=True,
    tie_embeddings=True,
    max_position_embeddings=524288,  # backbone positions for long shapes
    encoder=EncoderConfig(num_layers=24, n_ctx=1500, d_model=1024,
                          num_heads=16, d_ff=4096),
))
