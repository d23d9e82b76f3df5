"""GQA attention of the port's dense transformer.

Port of the GQA part of the reference package's
``repro.models.attention``:

- Full-sequence path (forward / prefill): ``gqa_forward`` returns
  ``(out, (k, v))`` so the caller can fill a KV cache.  Its attention
  core is ``kernels.flash_attention``: the CUDA kernel on CUDA tensors
  (any S; the reference's query-chunked ``chunked_sdpa`` above
  ``CHUNK_THRESHOLD`` has no counterpart, the kernel never forms the
  (S, S) scores), its plain version on CPU tensors.
- Decode path: ``gqa_decode`` writes the new token's K/V into the cache
  at index ``lengths`` (in place, an index write: the reference's
  mask-select ``_scatter_time`` rebuilds the whole cache) and then
  attends over the valid prefix and itself through
  ``kernels.decode_attention``.

Both are causal, with RoPE positions (the port's dense family has no
encoder and no learned positions).  The attention cores follow the
Pallas kernels' arithmetic: on bf16
inputs the reference model rounds the probabilities to bf16 before P·V
and the port does not, so the two differ in the last bits there; in
float32 they agree to rounding.  The reference's ``REPRO_SHARD_*``
sharding hints have no numerical effect and are not read.  MLA,
cross-attention, q/k norms and the int8 KV cache are not ported (see
``transformer.require_supported``).
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import _init_w, param
from repro_torch.models.rope import apply_rope

__all__ = ["init_gqa", "gqa_forward", "gqa_decode", "kv_quantized"]


def init_gqa(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> nn.ParameterDict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": _init_w(gen, (d, h, hd), dtype),
        "wk": _init_w(gen, (d, kv, hd), dtype),
        "wv": _init_w(gen, (d, kv, hd), dtype),
        "wo": _init_w(gen, (h, hd, d), dtype, scale=(h * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = param(torch.zeros(h, hd, dtype=dtype, device=dev))
        p["bk"] = param(torch.zeros(kv, hd, dtype=dtype, device=dev))
        p["bv"] = param(torch.zeros(kv, hd, dtype=dtype, device=dev))
    return nn.ParameterDict(p)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _project_qkv(p, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary_factor)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary_factor)
    return q.contiguous(), k.contiguous(), v.contiguous()


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", out, wo) as one matrix product."""
    h, k, d = wo.shape
    return out.reshape(*out.shape[:-2], h * k) @ wo.reshape(h * k, d)


def gqa_forward(p, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, window: int = 0
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention. positions: (S,). Returns (out, (k, v))."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = flash_attention(q, k, v, causal=True, window=window)
    return _out_proj(out, p["wo"]), (k, v)


def gqa_decode(p, cfg: ModelConfig, x: torch.Tensor,
               cache: Dict[str, torch.Tensor], lengths: torch.Tensor, *,
               window: int = 0
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode. x: (B,1,d); cache k/v: (B,S_max,KV,hd),
    updated in place at ``lengths`` (int32 (B,), each in [0, S_max));
    returns (out, cache)."""
    q, k_new, v_new = _project_qkv(p, cfg, x, lengths[:, None])
    _scatter_time(cache["k"], k_new, lengths)
    _scatter_time(cache["v"], v_new, lengths)
    out = decode_attention(q[:, 0], cache["k"], cache["v"], lengths,
                           window=window)
    return _out_proj(out[:, None], p["wo"]), cache


def kv_quantized() -> bool:
    """The reference's int8 KV cache switch (``REPRO_KV_INT8=1``); the
    port raises where it is set."""
    return os.environ.get("REPRO_KV_INT8") == "1"


def _scatter_time(cache: torch.Tensor, new: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Write new (B,1,...) into cache (B,S,...) at per-row index
    ``lengths``, in place; returns cache.  An index out of [0, S)
    raises (the reference's mask-select writes nothing there)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, lengths.long()] = new[:, 0].to(cache.dtype)
    return cache
