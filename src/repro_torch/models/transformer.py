"""The port's decoder stack: dense transformers and Mamba2 SSMs.

Port of the dense and SSM families of the reference package's
``repro.models.transformer``.  The parameters are ``nn.Module``s: a
``Transformer`` holds the embedding table, the final norm and one
``nn.ModuleDict`` block per layer, keyed as the reference's pytree is:
``norm1``, ``attn`` or ``ssm`` by the layer's kind
(``cfg.layer_kinds()``), and ``norm2``, ``ffn`` when the config has an
FFN.  The reference stacks the layers and runs them under
``lax.scan``; here the stack is a Python loop over the blocks.  The
cache is a list with one dict per layer: ``{"k", "v"}`` of ``(B,
cache_len, KV, hd)`` tensors for an attention layer, ``{"conv_x",
"conv_bc", "ssm"}`` for a Mamba2 layer (which ignores ``cache_len`` and
``lengths``); ``decode_step`` updates it in place.

Public API (used by registry / serving):
    init_params(cfg, generator)                -> Transformer
    forward(cfg, params, batch, window=0)      -> (logits, aux_loss)
    prefill(cfg, params, batch, cache_len, window=0) -> (logits, cache)
    decode_step(cfg, params, tokens, cache, lengths, window=0)
                                               -> (logits, cache)
    init_cache(cfg, batch, cache_len, device)  -> cache

The dense family with rotary positions and the attention-free SSM
family are ported.  MoE, hybrid, MLA, enc-dec and VLM configurations,
learned positions, q/k norms and the int8 KV cache raise
``NotImplementedError`` (from ``build``, ``init_params``,
``init_cache`` and the weight conversion) naming the ROADMAP item that
adds them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as ssm
from repro_torch.models.layers import (_dtype, _init_w, apply_mlp,
                                       apply_norm, embed, init_embedding,
                                       init_mlp, init_norm, unembed)

__all__ = ["Transformer", "init_params", "init_cache", "forward", "prefill",
           "decode_step", "layer_specs", "split_pattern",
           "require_supported"]

Cache = List[Dict[str, torch.Tensor]]


def require_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port,
    naming its ROADMAP item."""
    missing = []
    if cfg.family not in ("dense", "ssm"):
        missing.append(f"the {cfg.family} family")
    if cfg.moe is not None:
        missing.append("MoE layers (ROADMAP Queue A 8b)")
    if cfg.attn_layer_period:
        missing.append("the hybrid Mamba2 / attention interleave "
                       "(ROADMAP Queue A 8b, with Jamba's MoE)")
    if cfg.mla is not None:
        missing.append("MLA attention (ROADMAP Queue A 8c)")
    if cfg.encoder is not None:
        missing.append("enc-dec / VLM stacks and cross-attention "
                       "(ROADMAP Queue A 8e)")
    if cfg.learned_positions:
        missing.append("learned positions (ROADMAP Queue A 8e)")
    if cfg.qk_norm:
        missing.append("q/k norms (ROADMAP Queue A 8b, with OLMoE)")
    if attn.kv_quantized():
        missing.append("the int8 KV cache, REPRO_KV_INT8 (ROADMAP Queue "
                       "A 8f)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch yet: "
            + "; ".join(missing))


# ---------------------------------------------------------------------------
# Layer pattern
# ---------------------------------------------------------------------------

def layer_specs(cfg: ModelConfig) -> List[Tuple[str, bool]]:
    kinds = cfg.layer_kinds()
    moes = cfg.moe_layers()
    return list(zip(kinds, moes))


def split_pattern(cfg: ModelConfig) -> Tuple[int, int, int]:
    """Return (n_lead, period, repeats) for the layer stack."""
    specs = layer_specs(cfg)
    lead = cfg.moe.first_dense if cfg.moe else 0
    rest = specs[lead:]
    p = cfg.attn_layer_period or 1
    if cfg.moe and cfg.moe.moe_layer_period > 1:
        p = math.lcm(p, cfg.moe.moe_layer_period)
    if len(rest) % p:
        raise ValueError(f"{cfg.name}: {len(rest)} layers are not a "
                         f"multiple of the period {p}")
    for i, s in enumerate(rest):
        if s != rest[i % p]:
            raise ValueError(f"{cfg.name}: stack not periodic at {i}")
    return lead, p, len(rest) // p


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Transformer(nn.Module):
    """A decoder's weights: ``embed`` (V, d), ``norm_f``, an optional
    untied ``unembed`` (d, V) and ``layers``, one ``ModuleDict(norm1,
    attn | ssm[, norm2, ffn])`` per layer."""

    def __init__(self, embed_table: nn.Parameter, norm_f: nn.ParameterDict,
                 layers: List[nn.ModuleDict],
                 unembed_w: Optional[nn.Parameter] = None):
        super().__init__()
        self.embed = embed_table
        self.norm_f = norm_f
        self.layers = nn.ModuleList(layers)
        self.unembed = unembed_w


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               dtype: torch.dtype) -> nn.ModuleDict:
    blk = {"norm1": init_norm(gen, cfg.d_model, cfg.norm, dtype)}
    if kind == "attn":
        blk["attn"] = attn.init_gqa(gen, cfg, dtype)
    else:
        blk["ssm"] = ssm.init_mamba2(gen, cfg.d_model, cfg.ssm, dtype)
    if cfg.d_ff:
        blk["norm2"] = init_norm(gen, cfg.d_model, cfg.norm, dtype)
        blk["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                              dtype)
    return nn.ModuleDict(blk)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Transformer:
    """Random weights drawn from ``gen``, on ``gen``'s device, in the
    config's dtype."""
    require_supported(cfg)
    dtype = _dtype(cfg.dtype)
    table = init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype)
    norm_f = init_norm(gen, cfg.d_model, cfg.norm, dtype)
    unembed_w = (None if cfg.tie_embeddings else
                 _init_w(gen, (cfg.d_model, cfg.vocab_size), dtype))
    layers = [init_block(gen, cfg, kind, dtype)
              for kind in cfg.layer_kinds()]
    return Transformer(table, norm_f, layers, unembed_w)


def _block_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                 dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    if kind == "attn":
        shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    s = cfg.ssm
    return {"conv_x": torch.zeros(batch, s.d_conv - 1,
                                  s.d_inner(cfg.d_model), dtype=dtype,
                                  device=device),
            "conv_bc": torch.zeros(batch, s.d_conv - 1,
                                   2 * s.n_groups * s.d_state, dtype=dtype,
                                   device=device),
            "ssm": torch.zeros(batch, s.n_heads(cfg.d_model), s.head_dim,
                               s.d_state, dtype=torch.float32,
                               device=device)}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> Cache:
    require_supported(cfg)
    dtype = _dtype(cfg.dtype)
    return [_block_cache(cfg, kind, batch, cache_len, dtype, device)
            for kind in cfg.layer_kinds()]


# ---------------------------------------------------------------------------
# One block
# ---------------------------------------------------------------------------

def _pad_time(x: torch.Tensor, target: int) -> torch.Tensor:
    """Pad axis 1 (time) of a (B, S, KV, hd) tensor up to ``target``."""
    if x.shape[1] == target:
        return x
    return F.pad(x, (0, 0, 0, 0, 0, target - x.shape[1]))


def apply_block(cfg: ModelConfig, bp: nn.ModuleDict, kind: str,
                x: torch.Tensor, *,
                mode: str, positions: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_len: int = 0, window: int = 0
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Apply one block. mode: 'full' | 'prefill' | 'decode'."""
    new_cache = None
    h = apply_norm(bp["norm1"], x, cfg.norm)
    if kind == "ssm":
        if mode == "decode":
            a, new_cache = ssm.mamba2_decode(bp["ssm"], cfg.d_model,
                                             cfg.ssm, h, cache)
        else:
            a, sc = ssm.mamba2_forward(bp["ssm"], cfg.d_model, cfg.ssm, h)
            if mode == "prefill":
                new_cache = sc
    elif mode == "decode":
        a, new_cache = attn.gqa_decode(bp["attn"], cfg, h, cache, lengths,
                                       window=window)
    else:
        a, (k, v) = attn.gqa_forward(bp["attn"], cfg, h, positions,
                                     window=window)
        if mode == "prefill":
            new_cache = {"k": _pad_time(k, cache_len),
                         "v": _pad_time(v, cache_len)}
    x = x + a
    if "ffn" in bp:
        h2 = apply_norm(bp["norm2"], x, cfg.norm)
        x = x + apply_mlp(bp["ffn"], h2, cfg.activation)
    return x, new_cache


def _run_stack(cfg: ModelConfig, params: Transformer, x: torch.Tensor, *,
               mode: str, positions=None, lengths=None,
               cache: Optional[Cache] = None, cache_len: int = 0,
               window: int = 0) -> Tuple[torch.Tensor, Optional[Cache]]:
    new_cache: Cache = []
    for i, (kind, bp) in enumerate(zip(cfg.layer_kinds(), params.layers)):
        x, nc = apply_block(cfg, bp, kind, x, mode=mode, positions=positions,
                            lengths=lengths,
                            cache=cache[i] if cache is not None else None,
                            cache_len=cache_len, window=window)
        new_cache.append(nc)
    return x, (new_cache if mode != "full" else None)


def _logits(cfg: ModelConfig, params: Transformer,
            x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(params.norm_f, x, cfg.norm)
    if cfg.tie_embeddings:
        return unembed(params.embed, x, tied=True)
    return unembed(params.unembed, x, tied=False)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: Transformer,
            batch: Dict[str, torch.Tensor], *, window: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. batch: tokens (B,S). Returns (logits
    (B,S,V), aux_loss = 0)."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = embed(params.embed, tokens)
    x, _ = _run_stack(cfg, params, x, mode="full", positions=positions,
                      window=window)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return _logits(cfg, params, x), aux


def prefill(cfg: ModelConfig, params: Transformer,
            batch: Dict[str, torch.Tensor], cache_len: int, *,
            window: int = 0) -> Tuple[torch.Tensor, Cache]:
    """Prompt pass: logits of the last position (B,1,V) and the KV
    cache padded to ``cache_len``."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = embed(params.embed, tokens)
    x, cache = _run_stack(cfg, params, x, mode="prefill",
                          positions=positions, cache_len=cache_len,
                          window=window)
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
                cache: Cache, lengths: torch.Tensor, *, window: int = 0
                ) -> Tuple[torch.Tensor, Cache]:
    """tokens: (B,1); lengths: int32 (B,), the current fill of each
    cache row.  The cache is updated in place and returned."""
    x = embed(params.embed, tokens)
    x, new_cache = _run_stack(cfg, params, x, mode="decode",
                              lengths=lengths, cache=cache, window=window)
    return _logits(cfg, params, x), new_cache
