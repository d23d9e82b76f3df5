"""The port's model stacks: dense and MoE transformers, Mamba2 SSMs,
their hybrid interleave, the enc-dec (audio) and VLM stacks.

Port of the reference package's ``repro.models.transformer``. The
parameters are ``nn.Module``s: a ``Transformer`` holds the embedding
table, the final norm and one ``nn.ModuleDict`` block per layer, keyed
as the reference's pytree is: ``norm1``, ``attn`` or ``ssm`` by the
layer's kind (``cfg.layer_kinds()``), and ``norm2``, ``ffn`` when the
layer has an FFN: the MoE FFN of ``models.moe`` on the layers
``cfg.moe_layers()`` flags (after ``first_dense`` lead layers, every
``moe_layer_period``-th), a dense MLP on the others. An attention
layer's ``attn`` is GQA, or DeepSeek-V2's MLA when ``cfg.mla`` is set; a
hybrid (Jamba) puts an attention layer every ``attn_layer_period``
layers and Mamba2 layers between them. The reference stacks the layers
and runs them under ``lax.scan``; here the stack is a Python loop over
the blocks, which sums the MoE layers' aux losses. The cache is a list
with one dict per layer: ``{"k", "v"}`` of ``(B, cache_len, KV, hd)``
tensors for an attention layer (with ``REPRO_KV_INT8=1``: int8 codes
beside float32 ``k_scale`` / ``v_scale`` of ``(B, cache_len, KV, 1)``),
``{"c_kv", "k_pe"}`` of ``(B, cache_len, rank | rope)`` in the model's
dtype for an MLA layer (int8 or not), ``{"conv_x", "conv_bc", "ssm"}``
for a Mamba2 layer (which ignores ``cache_len`` and ``lengths``);
``decode_step`` updates it in place.

Enc-dec (whisper, ``cfg.encoder.num_layers > 0``): the ``Transformer``
also holds ``encoder`` (its learned ``pos (n_ctx, d)``, one block per
encoder layer, ``norm``), and each decoder block a cross-attention
``norm_x`` / ``xattn``.  ``encode`` runs the encoder's blocks
unmasked over ``frames + pos`` (the frames' dtype promotes against the
table's, as in the reference: the engine's float32 frames make the
encoder, the cross K/V and their cache float32), and a decoder layer's
cache adds ``cross_k`` / ``cross_v`` of ``(B, n_ctx, H, hd)``, which
stay float under ``REPRO_KV_INT8=1``.  Learned positions
(``cfg.learned_positions``) add ``pos_embed`` (at most 65,536 rows, the
reference's cap) at the token positions in place of RoPE; decode clips
the position to the table's last row.  The VLM (InternVL2) puts its
``patch_embeds (B, n_ctx, d)``, cast to the model's dtype, in front of
the prompt, at positions ``0 … n_ctx - 1``; without them it runs on the
text alone.

Training (``remat=True`` on ``forward``, ``forward_hidden`` and
``encode``): each repeated layer (index ``lead`` and past, one period of
``split_pattern`` at a time) and each encoder layer runs under
``torch.utils.checkpoint`` (non-reentrant), which keeps only its input
and recomputes it in the backward; ``REPRO_REMAT_GROUP`` (read at each
call, as the reference reads it) groups the periods two-level, as the
reference's ``_remat_group``.  The values are unchanged; B3's forward
runs twice a checkpointed layer.

Public API (used by registry / serving / training):
    init_params(cfg, generator)                -> Transformer
    abstract_params(cfg)                       -> Transformer on ``meta``
    forward(cfg, params, batch, window=0, remat=False)
                                               -> (logits, aux_loss)
    forward_hidden(cfg, params, batch, window=0, remat=False)
                                               -> (hidden, aux_loss)
    prefill(cfg, params, batch, cache_len, window=0) -> (logits, cache)
    decode_step(cfg, params, tokens, cache, lengths, window=0)
                                               -> (logits, cache)
    init_cache(cfg, batch, cache_len, device)  -> cache

Every family of the registry is ported; ``require_supported`` raises
``NotImplementedError`` for any other.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.distributed.tensor import Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels._mesh import is_dtensor
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as ssm
from repro_torch.models.layers import (_dtype, _init_w, apply_mlp,
                                       apply_norm, embed, init_embedding,
                                       init_mlp, init_norm, shard_hint,
                                       unembed, batch_rows)
from repro_torch.models.moe import apply_moe, init_moe

__all__ = ["Transformer", "Encoder", "init_params", "abstract_params",
           "init_cache", "forward",
           "forward_hidden", "prefill", "decode_step", "encode",
           "encoder_cfg", "layer_specs", "split_pattern",
           "require_supported"]

Cache = List[Dict[str, torch.Tensor]]

# the model families the port runs: every family of the registry
FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
# the reference's cap on the learned position table's rows
MAX_POSITION_ROWS = 65536


def require_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port does not
    run."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported to "
            f"repro_torch")


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


def _remat_group(r: int) -> int:
    """The group of layer periods a two-level remat checkpoints together:
    the largest divisor of ``r`` not above ``REPRO_REMAT_GROUP`` (read at
    each call); 1 (single level) when it is unset, 0 or 1, or ``r <=
    2``, as the reference's ``_remat_group``."""
    want = int(os.environ.get("REPRO_REMAT_GROUP", "0") or 0)
    if want <= 1 or r <= 2:
        return 1
    g = min(want, r)
    while r % g:
        g -= 1
    return g


def _like(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A block's output ``a`` laid out as the residual ``x`` it is added
    to (on DTensors: a sequence-sharded residual takes a reduce-scatter
    here, and its gradient an all-gather back, the sequence-parallel
    pair); a plain tensor as it is.  Where the residual is still a
    ``Partial`` sum that ``a`` is not (decode, whose one position takes
    no sequence hint, after a vocabulary-sharded embedding) ``a`` is
    replicated there and the add reduces the residual."""
    if not is_dtensor(a) or a.placements == x.placements:
        return a
    want = [Replicate() if p.is_partial() and not q.is_partial() else p
            for p, q in zip(x.placements, a.placements)]
    return a.redistribute(a.device_mesh, want)


def _shard_seq(x: torch.Tensor) -> torch.Tensor:
    """The reference's §Perf T3 hint (sequence parallelism): between the
    repeated blocks the residual stream's sequence axis over
    ``REPRO_SHARD_SEQ_AXIS`` (read at each call), on DTensors whose
    sequence is a multiple of 16; a plain tensor as it is."""
    if x.dim() != 3 or x.shape[1] % 16:
        return x
    return shard_hint(x, 1, os.environ.get("REPRO_SHARD_SEQ_AXIS"))


def _checkpoint(fn, *args):
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Encoder(nn.Module):
    """An enc-dec model's encoder: the learned ``pos`` (n_ctx, d), one
    ``ModuleDict(norm1, attn, norm2, ffn)`` per layer, ``norm``."""

    def __init__(self, pos: nn.Parameter, layers: List[nn.ModuleDict],
                 norm: nn.ParameterDict):
        super().__init__()
        self.pos = pos
        self.layers = nn.ModuleList(layers)
        self.norm = norm


class Transformer(nn.Module):
    """A model's weights: ``embed`` (V, d), ``norm_f``, an optional
    untied ``unembed`` (d, V), ``layers``, one ``ModuleDict(norm1,
    attn | ssm[, norm_x, xattn][, norm2, ffn])`` per layer (a MoE
    layer's ``ffn`` nests its ``shared`` experts' dict), and for the
    configs that have them the learned ``pos_embed`` (rows, d) and the
    ``encoder``."""

    def __init__(self, embed_table: nn.Parameter, norm_f: nn.ParameterDict,
                 layers: List[nn.ModuleDict],
                 unembed_w: Optional[nn.Parameter] = None,
                 pos_embed: Optional[nn.Parameter] = None,
                 encoder: Optional[Encoder] = None):
        super().__init__()
        self.embed = embed_table
        self.norm_f = norm_f
        self.layers = nn.ModuleList(layers)
        self.unembed = unembed_w
        self.pos_embed = pos_embed
        self.encoder = encoder


def _is_encdec(cfg: ModelConfig) -> bool:
    return cfg.encoder is not None and cfg.encoder.num_layers > 0


def encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder's own config: a dense stack at the encoder's widths,
    with learned positions (no RoPE)."""
    e = cfg.encoder
    d = e.d_model or cfg.d_model
    h = e.num_heads or cfg.num_heads
    return ModelConfig(
        name="enc", family="dense", source="", num_layers=e.num_layers,
        d_model=d, num_heads=h, num_kv_heads=h, head_dim=d // h,
        d_ff=e.d_ff or cfg.d_ff, vocab_size=0, qkv_bias=cfg.qkv_bias,
        activation=cfg.activation, norm=cfg.norm, learned_positions=True)


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               moe_flag: bool, dtype: torch.dtype, *,
               cross: bool = False) -> nn.ModuleDict:
    blk = {"norm1": init_norm(gen, cfg.d_model, cfg.norm, dtype)}
    if kind == "attn":
        blk["attn"] = (attn.init_mla(gen, cfg, dtype) if cfg.mla is not None
                       else attn.init_gqa(gen, cfg, dtype))
        if cross:
            blk["norm_x"] = init_norm(gen, cfg.d_model, cfg.norm, dtype)
            blk["xattn"] = attn.init_gqa(gen, cfg, dtype, cross=True)
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
    cross = _is_encdec(cfg)
    layers = [init_block(gen, cfg, kind, moe_flag, dtype, cross=cross)
              for kind, moe_flag in layer_specs(cfg)]
    pos_embed = (init_embedding(gen, min(cfg.max_position_embeddings,
                                         MAX_POSITION_ROWS),
                                cfg.d_model, dtype)
                 if cfg.learned_positions else None)
    encoder = None
    if cross:
        ecfg = encoder_cfg(cfg)
        blocks = [init_block(gen, ecfg, "attn", False, dtype)
                  for _ in range(ecfg.num_layers)]
        encoder = Encoder(
            init_embedding(gen, cfg.encoder.n_ctx, ecfg.d_model, dtype),
            blocks, init_norm(gen, ecfg.d_model, cfg.norm, dtype))
    return Transformer(table, norm_f, layers, unembed_w, pos_embed, encoder)


class _MetaDraw:
    """Stands in for a generator on the ``meta`` device, which torch does
    not have: ``layers._gen_kw`` draws nothing for it."""
    device = torch.device("meta")


def abstract_params(cfg: ModelConfig) -> Transformer:
    """The ``Transformer`` of ``init_params`` on the ``meta`` device: the
    same names, shapes and dtypes, no values, no memory.  The port's
    ``jax.eval_shape(init_params)``; the sharding rules and the dry run
    read it."""
    return init_params(cfg, _MetaDraw())


def _block_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                 dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    c = _self_cache(cfg, kind, batch, cache_len, dtype, device)
    if kind == "attn" and _is_encdec(cfg):
        # the cross K/V stay float whatever the int8 switch says
        shape = (batch, cfg.encoder.n_ctx, cfg.num_heads, cfg.head_dim)
        c["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        c["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def _self_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
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
    """Pad axis 1 (time) of a (B, S, ...) tensor up to ``target``; a
    ``target`` under S raises, as the reference's pad does."""
    if x.shape[1] == target:
        return x
    if target < x.shape[1]:
        raise ValueError(f"a cache of {target} positions cannot hold "
                         f"{x.shape[1]}")
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, target - x.shape[1]))


def apply_block(cfg: ModelConfig, bp: nn.ModuleDict, kind: str,
                moe_flag: bool, x: torch.Tensor, *,
                mode: str, positions: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_len: int = 0, window: int = 0, causal: bool = True,
                cross_enc: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]],
                           Optional[torch.Tensor]]:
    """Apply one block. mode: 'full' | 'prefill' | 'decode'.  Returns
    (x, new cache, the MoE aux loss or None).  ``cross_enc``: the
    encoder's output, which a block with ``xattn`` attends to outside
    decode (in decode it reads the cache's ``cross_k`` / ``cross_v``)."""
    new_cache, aux = None, None
    rope = not cfg.learned_positions
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
                                       window=window, rope=rope)
    else:
        a, (k, v) = attn.gqa_forward(bp["attn"], cfg, h, positions,
                                     causal=causal, window=window, rope=rope)
        if mode == "prefill" and attn.kv_quantized():
            new_cache = {}
            for name, t in (("k", k), ("v", v)):
                codes, scale = attn.quantize_kv(t)
                new_cache[name] = _pad_time(codes, cache_len)
                new_cache[f"{name}_scale"] = _pad_time(scale, cache_len)
        elif mode == "prefill":
            new_cache = {"k": _pad_time(k, cache_len),
                         "v": _pad_time(v, cache_len)}
    x = x + _like(a, x)
    if "xattn" in bp:
        hx = apply_norm(bp["norm_x"], x, cfg.norm)
        if mode == "decode":
            ck, cv = cache["cross_k"], cache["cross_v"]
        else:
            ck, cv = attn.cross_kv(bp["xattn"], cross_enc)
            if mode == "prefill":
                new_cache["cross_k"], new_cache["cross_v"] = ck, cv
        a = attn.cross_attend(bp["xattn"], hx, ck, cv,
                              decode=mode == "decode")
        x = x + _like(a, x)
    if "ffn" in bp:
        h2 = apply_norm(bp["norm2"], x, cfg.norm)
        if moe_flag:
            f, aux = apply_moe(bp["ffn"], cfg.moe, h2, cfg.activation)
        else:
            f = apply_mlp(bp["ffn"], h2, cfg.activation)
        x = x + _like(f, x)
    return x, new_cache, aux


def _run_layers(cfg: ModelConfig, params: Transformer, x: torch.Tensor,
                lo: int, hi: int, positions, window: int,
                cross_enc: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layers ``lo … hi - 1`` in full mode; returns (x, their aux sum)."""
    specs = layer_specs(cfg)
    lead = split_pattern(cfg)[0]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(lo, hi):
        kind, moe_flag = specs[i]
        if i >= lead:
            x = _shard_seq(x)
        x, _, aux = apply_block(cfg, params.layers[i], kind, moe_flag, x,
                                mode="full", positions=positions,
                                window=window, cross_enc=cross_enc)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def _run_stack_remat(cfg: ModelConfig, params: Transformer, x: torch.Tensor,
                     positions, window: int,
                     cross_enc: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full-mode stack with each period of the repeated layers
    checkpointed, and with ``REPRO_REMAT_GROUP`` groups of periods
    checkpointed around them."""
    lead, p, r = split_pattern(cfg)
    x, aux_total = _run_layers(cfg, params, x, 0, lead, positions, window,
                               cross_enc)

    def periods(x, j0: int, n: int):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j in range(j0, j0 + n):
            x, a = _checkpoint(_run_layers, cfg, params, x, lead + j * p,
                               lead + (j + 1) * p, positions, window,
                               cross_enc)
            aux = aux + a
        return x, aux

    group = _remat_group(r)
    for j0 in range(0, r, group):
        if group > 1:
            x, a = _checkpoint(periods, x, j0, group)
        else:
            x, a = periods(x, j0, 1)
        aux_total = aux_total + a
    return x, aux_total


def _run_stack(cfg: ModelConfig, params: Transformer, x: torch.Tensor, *,
               mode: str, positions=None, lengths=None,
               cache: Optional[Cache] = None, cache_len: int = 0,
               window: int = 0, cross_enc: Optional[torch.Tensor] = None,
               remat: bool = False
               ) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
    if remat and mode == "full":
        x, aux = _run_stack_remat(cfg, params, x, positions, window,
                                  cross_enc)
        return x, None, aux
    new_cache: Cache = []
    lead = split_pattern(cfg)[0]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, ((kind, moe_flag), bp) in enumerate(zip(layer_specs(cfg),
                                                   params.layers)):
        if i >= lead:
            x = _shard_seq(x)
        x, nc, aux = apply_block(
            cfg, bp, kind, moe_flag, x, mode=mode, positions=positions,
            lengths=lengths, cache=cache[i] if cache is not None else None,
            cache_len=cache_len, window=window, cross_enc=cross_enc)
        new_cache.append(nc)
        if aux is not None:
            aux_total = aux_total + aux
    return x, (new_cache if mode != "full" else None), aux_total


def _logits(cfg: ModelConfig, params: Transformer,
            x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(params.norm_f, batch_rows(x), cfg.norm)
    if cfg.tie_embeddings:
        return unembed(params.embed, x, tied=True)
    return unembed(params.unembed, x, tied=False)


# ---------------------------------------------------------------------------
# Encoder and inputs
# ---------------------------------------------------------------------------

def _encoder_layer(ecfg: ModelConfig, bp: nn.ModuleDict, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    return apply_block(ecfg, bp, "attn", False, x, mode="full",
                       positions=positions, causal=False)[0]


def encode(cfg: ModelConfig, params: Transformer, frames: torch.Tensor, *,
           remat: bool = False) -> torch.Tensor:
    """The encoder over ``frames (B, T, d)``: learned positions added
    (in the promoted dtype of the frames and the table), the encoder's
    blocks unmasked (each checkpointed with ``remat``), its final
    norm."""
    enc = params.encoder
    ecfg = encoder_cfg(cfg)
    x = frames + enc.pos[None, :frames.shape[1]]
    positions = torch.arange(frames.shape[1], device=frames.device)
    for bp in enc.layers:
        if remat:
            x = _checkpoint(_encoder_layer, ecfg, bp, x, positions)
        else:
            x = _encoder_layer(ecfg, bp, x, positions)
    return apply_norm(enc.norm, x, cfg.norm)


def _embed_in(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    x = embed(params.embed, tokens)
    if cfg.learned_positions:
        x = x + params.pos_embed[positions]
    return x


def _frames(cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> torch.Tensor:
    if "frames" not in batch:
        raise ValueError(f"{cfg.name} is an encoder-decoder model: its "
                         f"batch needs the encoder's input 'frames' "
                         f"(B, {cfg.encoder.n_ctx}, d) beside 'tokens'")
    return batch["frames"]


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def forward_hidden(cfg: ModelConfig, params: Transformer,
                   batch: Dict[str, torch.Tensor], *, window: int = 0,
                   remat: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``forward`` up to the unembedding: the final hidden states (B, S',
    d) before ``norm_f`` (a VLM's patch rows kept) and the aux loss.
    The chunked cross-entropy computes the logits a chunk at a time from
    these."""
    tokens = batch["tokens"]
    s = tokens.shape[1]
    cross_enc = None
    if _is_encdec(cfg):
        cross_enc = encode(cfg, params, _frames(cfg, batch), remat=remat)
        positions = torch.arange(s, device=tokens.device)
        x = _embed_in(cfg, params, tokens, positions)
    elif cfg.family == "vlm" and "patch_embeds" in batch:
        pe = batch["patch_embeds"]
        positions = torch.arange(pe.shape[1] + s, device=tokens.device)
        x = torch.cat([pe.to(_dtype(cfg.dtype)),
                       _embed_in(cfg, params, tokens,
                                 positions[pe.shape[1]:])], dim=1)
    else:
        positions = torch.arange(s, device=tokens.device)
        x = _embed_in(cfg, params, tokens, positions)
    x, _, aux = _run_stack(cfg, params, x, mode="full", positions=positions,
                           window=window, cross_enc=cross_enc, remat=remat)
    return x, aux


def forward(cfg: ModelConfig, params: Transformer,
            batch: Dict[str, torch.Tensor], *, window: int = 0,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. batch: tokens (B,S) [+ frames (enc-dec) /
    patch_embeds (VLM)]. Returns (logits (B,S',V), aux_loss: the MoE
    layers' load-balance losses summed, 0 without MoE); S' = n_ctx + S
    with patch embeddings in front.  ``remat``: checkpoint the repeated
    layers (training)."""
    x, aux = forward_hidden(cfg, params, batch, window=window, remat=remat)
    return _logits(cfg, params, x), aux


def prefill(cfg: ModelConfig, params: Transformer,
            batch: Dict[str, torch.Tensor], cache_len: int, *,
            window: int = 0) -> Tuple[torch.Tensor, Cache]:
    """Prompt pass: logits of the last position (B,1,V) and the KV
    cache padded to ``cache_len`` (which must hold the patch rows too on
    a VLM: n_ctx + S positions are written)."""
    tokens = batch["tokens"]
    s = tokens.shape[1]
    cross_enc = None
    if _is_encdec(cfg):
        cross_enc = encode(cfg, params, _frames(cfg, batch))
    positions = torch.arange(s, device=tokens.device)
    x = _embed_in(cfg, params, tokens, positions)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        pe = batch["patch_embeds"]
        positions = torch.arange(pe.shape[1] + s, device=tokens.device)
        x = torch.cat([pe.to(x.dtype), x], dim=1)
    x, cache, _ = _run_stack(cfg, params, x, mode="prefill",
                             positions=positions, cache_len=cache_len,
                             window=window, cross_enc=cross_enc)
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
                cache: Cache, lengths: torch.Tensor, *, window: int = 0
                ) -> Tuple[torch.Tensor, Cache]:
    """tokens: (B,1); lengths: int32 (B,), the current fill of each
    cache row.  The cache is updated in place and returned."""
    positions = lengths[:, None]
    if cfg.learned_positions:
        positions = positions.clamp(0, params.pos_embed.shape[0] - 1)
    x = _embed_in(cfg, params, tokens, positions)
    x, new_cache, _ = _run_stack(cfg, params, x, mode="decode",
                                 lengths=lengths, cache=cache,
                                 window=window)
    return _logits(cfg, params, x), new_cache
