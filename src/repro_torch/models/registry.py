"""Model registry: config -> callable bundle.

Port of the reference package's ``repro.models.registry`` (``ModelBundle``
and ``build``; the abstract ``input_specs`` of the dry run belong to the
launch slice).  ``init`` takes a ``torch.Generator`` where the reference
takes a PRNG key, and makes the weights on the generator's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm

__all__ = ["ModelBundle", "build"]

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
