"""The port's decoder stack: dense and MoE transformers, Mamba2 SSMs and
their hybrid interleave.

Port of the dense, MoE, SSM and hybrid families of the reference
package's ``repro.models.transformer``.  The parameters are
``nn.Module``s: a ``Transformer`` holds the embedding table, the final
norm and one ``nn.ModuleDict`` block per layer, keyed as the
reference's pytree is: ``norm1``, ``attn`` or ``ssm`` by the layer's
kind (``cfg.layer_kinds()``), and ``norm2``, ``ffn`` when the layer has
an FFN: the MoE FFN of ``models.moe`` on the layers ``cfg.moe_layers()``
flags (after ``first_dense`` lead layers, every
``moe_layer_period``-th), a dense MLP on the others.  An attention
layer's ``attn`` is GQA, or DeepSeek-V2's MLA when ``cfg.mla`` is set;
a hybrid (Jamba) puts an attention layer every ``attn_layer_period``
layers and Mamba2 layers between them.  The reference stacks the layers
and runs them under ``lax.scan``; here the stack is a Python loop over
the blocks, which sums the MoE layers' aux losses.  The cache is a list
with one dict per layer: ``{"k", "v"}`` of ``(B, cache_len, KV, hd)``
tensors for an attention layer (with ``REPRO_KV_INT8=1``: int8 codes
beside float32 ``k_scale`` / ``v_scale`` of ``(B, cache_len, KV, 1)``),
``{"c_kv", "k_pe"}`` of ``(B, cache_len, rank | rope)`` in the model's
dtype for an MLA layer (int8 or not), ``{"conv_x", "conv_bc", "ssm"}``
for a Mamba2 layer (which ignores ``cache_len`` and ``lengths``);
``decode_step`` updates it in place.

Public API (used by registry / serving):
    init_params(cfg, generator)                -> Transformer
    forward(cfg, params, batch, window=0)      -> (logits, aux_loss)
    prefill(cfg, params, batch, cache_len, window=0) -> (logits, cache)
    decode_step(cfg, params, tokens, cache, lengths, window=0)
                                               -> (logits, cache)
    init_cache(cfg, batch, cache_len, device)  -> cache

The dense and MoE families with rotary positions (q/k norms and MLA
included), the attention-free SSM family and the hybrid interleave are
ported.  Enc-dec and VLM configurations and learned positions raise
``NotImplementedError`` (from ``build``, ``init_params``, ``init_cache``
and the weight conversion) naming the ROADMAP item that adds them.
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
from repro_torch.models.moe import apply_moe, init_moe

__all__ = ["Transformer", "init_params", "init_cache", "forward", "prefill",
           "decode_step", "layer_specs", "split_pattern",
           "require_supported"]

Cache = List[Dict[str, torch.Tensor]]


def require_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port,
    naming its ROADMAP item."""
    missing = []
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        missing.append(f"the {cfg.family} family (ROADMAP Queue A 8e)")
    if cfg.encoder is not None:
        missing.append("enc-dec / VLM stacks and cross-attention "
                       "(ROADMAP Queue A 8e)")
    if cfg.learned_positions:
        missing.append("learned positions (ROADMAP Queue A 8e)")
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
    attn | ssm[, norm2, ffn])`` per layer (a MoE layer's ``ffn`` nests
    its ``shared`` experts' dict)."""

    def __init__(self, embed_table: nn.Parameter, norm_f: nn.ParameterDict,
                 layers: List[nn.ModuleDict],
                 unembed_w: Optional[nn.Parameter] = None):
        super().__init__()
        self.embed = embed_table
        self.norm_f = norm_f
        self.layers = nn.ModuleList(layers)
        self.unembed = unembed_w


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               moe_flag: bool, dtype: torch.dtype) -> nn.ModuleDict:
    blk = {"norm1": init_norm(gen, cfg.d_model, cfg.norm, dtype)}
    if kind == "attn":
        blk["attn"] = (attn.init_mla(gen, cfg, dtype) if cfg.mla is not None
                       else attn.init_gqa(gen, cfg, dtype))
    else:
        blk["ssm"] = ssm.init_mamba2(gen, cfg.d_model, cfg.ssm, dtype)
    if moe_flag or cfg.d_ff:
        blk["norm2"] = init_norm(gen, cfg.d_model, cfg.norm, dtype)
        blk["ffn"] = (init_moe(gen, cfg.d_model, cfg.moe, cfg.activation,
                               dtype) if moe_flag else
                      init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                               dtype))
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
    layers = [init_block(gen, cfg, kind, moe_flag, dtype)
              for kind, moe_flag in layer_specs(cfg)]
    return Transformer(table, norm_f, layers, unembed_w)


def _block_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                 dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    if kind == "attn" and cfg.mla is not None:
        # before the int8 switch, as the reference: the latent cache stays
        # in the model's dtype
        m = cfg.mla
        return {"c_kv": torch.zeros(batch, cache_len, m.kv_lora_rank,
                                    dtype=dtype, device=device),
                "k_pe": torch.zeros(batch, cache_len, m.qk_rope_head_dim,
                                    dtype=dtype, device=device)}
    if kind == "attn":
        shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
        if attn.kv_quantized():
            scale = shape[:3] + (1,)
            return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "k_scale": torch.zeros(scale, device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v_scale": torch.zeros(scale, device=device)}
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
    """Pad axis 1 (time) of a (B, S, ...) tensor up to ``target``."""
    if x.shape[1] == target:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, target - x.shape[1]))


def apply_block(cfg: ModelConfig, bp: nn.ModuleDict, kind: str,
                moe_flag: bool, x: torch.Tensor, *,
                mode: str, positions: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_len: int = 0, window: int = 0
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]],
                           Optional[torch.Tensor]]:
    """Apply one block. mode: 'full' | 'prefill' | 'decode'.  Returns
    (x, new cache, the MoE aux loss or None)."""
    new_cache, aux = None, None
    h = apply_norm(bp["norm1"], x, cfg.norm)
    if kind == "ssm":
        if mode == "decode":
            a, new_cache = ssm.mamba2_decode(bp["ssm"], cfg.d_model,
                                             cfg.ssm, h, cache)
        else:
            a, sc = ssm.mamba2_forward(bp["ssm"], cfg.d_model, cfg.ssm, h)
            if mode == "prefill":
                new_cache = sc
    elif cfg.mla is not None and mode == "decode":
        a, new_cache = attn.mla_decode(bp["attn"], cfg, h, cache, lengths,
                                       window=window)
    elif cfg.mla is not None:
        a, (c_kv, k_pe) = attn.mla_forward(bp["attn"], cfg, h, positions,
                                           window=window)
        if mode == "prefill":
            new_cache = {"c_kv": _pad_time(c_kv, cache_len),
                         "k_pe": _pad_time(k_pe, cache_len)}
    elif mode == "decode":
        a, new_cache = attn.gqa_decode(bp["attn"], cfg, h, cache, lengths,
                                       window=window)
    else:
        a, (k, v) = attn.gqa_forward(bp["attn"], cfg, h, positions,
                                     window=window)
        if mode == "prefill" and attn.kv_quantized():
            new_cache = {}
            for name, t in (("k", k), ("v", v)):
                codes, scale = attn.quantize_kv(t)
                new_cache[name] = _pad_time(codes, cache_len)
                new_cache[f"{name}_scale"] = _pad_time(scale, cache_len)
        elif mode == "prefill":
            new_cache = {"k": _pad_time(k, cache_len),
                         "v": _pad_time(v, cache_len)}
    x = x + a
    if "ffn" in bp:
        h2 = apply_norm(bp["norm2"], x, cfg.norm)
        if moe_flag:
            f, aux = apply_moe(bp["ffn"], cfg.moe, h2, cfg.activation)
        else:
            f = apply_mlp(bp["ffn"], h2, cfg.activation)
        x = x + f
    return x, new_cache, aux


def _run_stack(cfg: ModelConfig, params: Transformer, x: torch.Tensor, *,
               mode: str, positions=None, lengths=None,
               cache: Optional[Cache] = None, cache_len: int = 0,
               window: int = 0
               ) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
    new_cache: Cache = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, ((kind, moe_flag), bp) in enumerate(zip(layer_specs(cfg),
                                                   params.layers)):
        x, nc, aux = apply_block(
            cfg, bp, kind, moe_flag, x, mode=mode, positions=positions,
            lengths=lengths, cache=cache[i] if cache is not None else None,
            cache_len=cache_len, window=window)
        new_cache.append(nc)
        if aux is not None:
            aux_total = aux_total + aux
    return x, (new_cache if mode != "full" else None), aux_total


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
    (B,S,V), aux_loss: the MoE layers' load-balance losses summed, 0
    without MoE)."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = embed(params.embed, tokens)
    x, _, aux = _run_stack(cfg, params, x, mode="full", positions=positions,
                           window=window)
    return _logits(cfg, params, x), aux


def prefill(cfg: ModelConfig, params: Transformer,
            batch: Dict[str, torch.Tensor], cache_len: int, *,
            window: int = 0) -> Tuple[torch.Tensor, Cache]:
    """Prompt pass: logits of the last position (B,1,V) and the KV
    cache padded to ``cache_len``."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = embed(params.embed, tokens)
    x, cache, _ = _run_stack(cfg, params, x, mode="prefill",
                             positions=positions, cache_len=cache_len,
                             window=window)
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
                cache: Cache, lengths: torch.Tensor, *, window: int = 0
                ) -> Tuple[torch.Tensor, Cache]:
    """tokens: (B,1); lengths: int32 (B,), the current fill of each
    cache row.  The cache is updated in place and returned."""
    x = embed(params.embed, tokens)
    x, new_cache, _ = _run_stack(cfg, params, x, mode="decode",
                                 lengths=lengths, cache=cache,
                                 window=window)
    return _logits(cfg, params, x), new_cache
