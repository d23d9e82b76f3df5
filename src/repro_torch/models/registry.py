"""Model registry: config -> callable bundle, plus abstract input specs.

Port of the reference package's ``repro.models.registry``.  ``init``
takes a ``torch.Generator`` where the reference takes a PRNG key, and
makes the weights on the generator's device.  ``input_specs(cfg,
shape)`` returns ``meta`` tensors of the reference's shapes and dtypes
for every input of the step function the shape's kind selects (the dry
run runs against them without allocating anything); its decode cache is
the port's per-layer list (``transformer.init_cache`` on ``meta``), not
the reference's stacked tree.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import _dtype

__all__ = ["ModelBundle", "build", "token_len", "input_specs",
           "decode_window"]

Params = Any


@dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init: Callable[..., Params]
    forward: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_cache: Callable[..., Any]


def build(cfg: ModelConfig) -> ModelBundle:
    tfm.require_supported(cfg)
    return ModelBundle(
        cfg=cfg,
        init=lambda gen: tfm.init_params(cfg, gen),
        forward=lambda params, batch, **kw: tfm.forward(cfg, params, batch,
                                                        **kw),
        prefill=lambda params, batch, cache_len, **kw: tfm.prefill(
            cfg, params, batch, cache_len, **kw),
        decode_step=lambda params, tokens, cache, lengths, **kw:
            tfm.decode_step(cfg, params, tokens, cache, lengths, **kw),
        init_cache=lambda batch, cache_len, device="cuda": tfm.init_cache(
            cfg, batch, cache_len, device),
    )


def token_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Text-token length for full-sequence steps (VLM reserves patch slots,
    enc-dec models keep the full length on the decoder side)."""
    if cfg.family == "vlm" and cfg.encoder is not None:
        return shape.seq_len - cfg.encoder.n_ctx
    return shape.seq_len


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Abstract inputs for the (arch, shape) step function: ``meta``
    tensors, int32 tokens / labels / lengths as in the reference."""
    dt = _dtype(cfg.dtype)
    b = shape.global_batch

    def meta(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        s = token_len(cfg, shape)
        specs: Dict[str, Any] = {"tokens": meta((b, s))}
        if shape.kind == "train":
            specs["labels"] = meta((b, s))
        if cfg.family == "vlm" and cfg.encoder is not None:
            specs["patch_embeds"] = meta((b, cfg.encoder.n_ctx,
                                          cfg.d_model), dt)
        if cfg.family == "audio" and cfg.encoder is not None:
            specs["frames"] = meta(
                (b, cfg.encoder.n_ctx, cfg.encoder.d_model or cfg.d_model),
                dt)
        return specs
    # decode: one token against a cache of length seq_len
    return {
        "tokens": meta((b, 1)),
        "cache": tfm.init_cache(cfg, b, shape.seq_len, device="meta"),
        "lengths": meta((b,)),
    }


def decode_window(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Sliding window used for the long-context decode shape on attention
    architectures (0 = full attention)."""
    if shape.name == "long_500k" and cfg.has_attention():
        return cfg.sliding_window
    return 0
