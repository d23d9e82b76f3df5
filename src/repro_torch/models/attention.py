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
  at index ``lengths`` (in place, where the reference's mask-select
  ``_scatter_time`` rebuilds the whole cache; as there, a row whose
  length lies outside ``[0, S)`` writes nothing) and then attends over
  the valid prefix and itself through ``kernels.decode_attention``.
- The int8 KV cache (``REPRO_KV_INT8=1``, read by ``kv_quantized``):
  ``quantize_kv`` turns K/V into int8 codes and float32 scales, one per
  (position, kv head); the cache holds ``k``, ``k_scale``, ``v``,
  ``v_scale`` and its decode attends through
  ``kernels.decode_attention_int8``, which reads the codes as they are.
- q/k norms (``cfg.qk_norm``, OLMoE): an rmsnorm over the head width
  after the bias and before RoPE.

Both are causal, with RoPE positions (the port has no encoder and no
learned positions).  The attention cores follow the Pallas kernels'
arithmetic: on bf16 inputs the reference model rounds the probabilities
(on the int8 cache: the probabilities times the value scales) to bf16
before P·V and the port does not, so the two differ in the last bits
there; in float32 they agree to rounding.  The reference's
``REPRO_SHARD_*`` sharding hints have no numerical effect and are not
read.  MLA and cross-attention are not ported (see
``transformer.require_supported``).
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_int8)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import _init_w, apply_norm, param
from repro_torch.models.rope import apply_rope

__all__ = ["init_gqa", "gqa_forward", "gqa_decode", "kv_quantized",
           "quantize_kv"]


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
    if cfg.qk_norm:
        p["q_norm"] = param(torch.ones(hd, dtype=dtype, device=dev))
        p["k_norm"] = param(torch.ones(hd, dtype=dtype, device=dev))
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
    if "q_norm" in p:
        q = apply_norm({"scale": p["q_norm"]}, q, "rmsnorm")
        k = apply_norm({"scale": p["k_norm"]}, k, "rmsnorm")
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
    """Single-token decode. x: (B,1,d); cache k/v: (B,S_max,KV,hd) in
    the model's dtype, or int8 codes beside float32 ``k_scale`` /
    ``v_scale`` (B,S_max,KV,1); updated in place at ``lengths`` (int32
    (B,); a row outside [0, S_max) writes nothing); returns (out,
    cache)."""
    q, k_new, v_new = _project_qkv(p, cfg, x, lengths[:, None])
    if "k_scale" in cache:
        for name, new in (("k", k_new), ("v", v_new)):
            codes, scale = quantize_kv(new)
            _scatter_time(cache[name], codes, lengths)
            _scatter_time(cache[f"{name}_scale"], scale, lengths)
        out = decode_attention_int8(q[:, 0], cache["k"], cache["k_scale"],
                                    cache["v"], cache["v_scale"], lengths,
                                    window=window)
    else:
        _scatter_time(cache["k"], k_new, lengths)
        _scatter_time(cache["v"], v_new, lengths)
        out = decode_attention(q[:, 0], cache["k"], cache["v"], lengths,
                               window=window)
    return _out_proj(out[:, None], p["wo"]), cache


def kv_quantized() -> bool:
    """The int8 KV cache switch, ``REPRO_KV_INT8=1`` (read at each
    call, as the reference reads it)."""
    return os.environ.get("REPRO_KV_INT8") == "1"


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., hd) -> (int8 codes, float32 scale (..., 1)): the scale is
    amax / 127 + 1e-12, the codes x / scale rounded half to even and
    clipped to ±127, as the reference's."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    codes = torch.clamp(torch.round(xf / scale), -127, 127)
    return codes.to(torch.int8), scale


def _scatter_time(cache: torch.Tensor, new: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Write new (B,1,...) into cache (B,S,...) at per-row index
    ``lengths``, in place; returns cache.  As the reference's
    mask-select, a row whose length lies outside [0, S) writes nothing:
    it is written at a clamped index with its old value, so the host
    never reads ``lengths``."""
    s = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx = lengths.long().clamp(0, s - 1)
    ok = ((lengths >= 0) & (lengths < s)).reshape(
        (-1,) + (1,) * (cache.dim() - 2))
    cache[rows, idx] = torch.where(ok, new[:, 0].to(cache.dtype),
                                   cache[rows, idx])
    return cache
