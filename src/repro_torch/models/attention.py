"""GQA, MLA and cross-attention of the port's transformers.

Port of the reference package's ``repro.models.attention``:

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
- DeepSeek-V2's multi-head latent attention (``cfg.mla``): ``init_mla``
  with the reference's parameter names and layouts; ``mla_forward``
  expands the latent ``c_kv`` through ``w_uk`` / ``w_uv`` and attends
  q, k of width nope + rope against v of width ``v_head_dim`` through
  ``kernels.flash_attention`` (on the card its (192, 128) pair);
  ``mla_decode`` writes ``c_kv`` and ``k_pe`` into the latent cache at
  ``lengths`` (as ``gqa_decode`` writes K/V), absorbs ``w_uk`` into the
  query in float32 and attends in the latent space through
  ``kernels.mla_decode``, then lifts the float32 context through
  ``w_uv`` and ``wo``, as the reference does; its cache stays in the
  model's dtype under ``REPRO_KV_INT8=1``.

- Learned positions (whisper): ``rope=False`` skips RoPE in
  ``gqa_forward`` / ``gqa_decode``; ``causal=False`` (whisper's encoder)
  goes through to the kernel.
- Cross-attention (enc-dec): ``init_gqa(cross=True)`` (biases when
  ``cfg.qkv_bias``, never q/k norms), ``cross_kv`` projects the
  encoder's output to K/V once a prefill, and ``cross_attend`` attends
  the decoder's queries to all of them, unmasked: through
  ``kernels.flash_attention`` with a key length of its own (``S_k =
  n_ctx``, ``causal=False``) in forward and prefill, and through
  ``kernels.decode_attention`` at ``lengths = n_ctx - 1`` on every row
  (which admits every key) in decode.  Where K/V are float32 under a
  bf16 query (the engine's float32 frames make the encoder float32, as
  in the reference) the query is cast to K's dtype for the kernel and
  the output back to the query's, which is the reference's arithmetic:
  its score einsum promotes to float32 and ``sdpa`` casts back.

Self-attention is causal with RoPE positions unless the config has
learned positions.  The attention cores follow the Pallas kernels'
arithmetic: on bf16 inputs the reference model rounds the probabilities
(on the int8 cache: the probabilities times the value scales) to bf16
before P·V and the port does not, so the two differ in the last bits
there; in float32 they agree to rounding.

On a device mesh (DTensor weights and activations) the reference's
layout hints act, read at each call as the reference reads them; on
plain tensors they do nothing.  ``REPRO_SHARD_HEADS_AXIS`` (the
reference's §Perf T1, ``_shard_heads``) shards the head axis of q, k and
v over that mesh axis, and (§Perf T5) repeats k and v to the full head
count before the attention kernel when KV < H and KV does not divide the
axis, so every rank's query heads find their kv heads on the same rank;
the cache keeps the compact k and v.  The cache write and the decode
kernels follow the cache's own layout (``launch.sharding.cache_specs``):
MLA's latent cache over its sequence (each rank's partials merged),
whisper's cross cache over its heads, with the cross decode's lengths
a replicated DTensor.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_int8)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mla_decode import mla_decode_attention
from repro_torch.kernels._mesh import (is_dtensor, local_call, seq_dims,
                                       seq_offset)
from repro_torch.models.layers import (_init_w, apply_norm, batch_rows,
                                       matmul, param, shard_hint)
from repro_torch.models.rope import apply_rope

__all__ = ["init_gqa", "gqa_forward", "gqa_decode", "kv_quantized",
           "quantize_kv", "cross_kv", "cross_attend", "init_mla",
           "mla_forward", "mla_decode"]


def init_gqa(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             *, cross: bool = False) -> nn.ParameterDict:
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
    if cfg.qk_norm and not cross:
        p["q_norm"] = param(torch.ones(hd, dtype=dtype, device=dev))
        p["k_norm"] = param(torch.ones(hd, dtype=dtype, device=dev))
    return nn.ParameterDict(p)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one matrix product.  On a DTensor
    weight, each rank multiplies its own rows of ``x`` by its own heads
    (or head widths) of ``w`` (``local_map``): DTensor would have to
    flatten (H, hd) with hd sharded (qwen1.5-4b's fallback)."""
    if is_dtensor(w):
        return _proj_mesh(x, w)
    d, h, k = w.shape
    return matmul(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _proj_mesh(x, w):
    mesh = w.device_mesh
    if not is_dtensor(x):
        x = distribute_tensor(x, mesh, [Replicate()] * mesh.ndim)
    wl = [p if p in (Shard(1), Shard(2)) else Replicate()
          for p in w.placements]
    rows = [p if p == Shard(0) and wl[i] == Replicate() else Replicate()
            for i, p in enumerate(x.placements)]
    out = [Shard(wl[i].dim + 1) if wl[i] != Replicate() else rows[i]
           for i in range(mesh.ndim)]
    # w's gradient on a rank covers only its own rows of x, and x's only
    # its own heads of w: each a sum across the other's shards
    wg = [Partial() if rows[i] != Replicate() else wl[i]
          for i in range(mesh.ndim)]
    xg = [Partial() if wl[i] != Replicate() else rows[i]
          for i in range(mesh.ndim)]

    def local(a, b):
        d, h, k = b.shape
        return matmul(a, b.reshape(d, h * k)).reshape(*a.shape[:-1], h, k)

    return local_call(local, mesh, (rows, wl), out, x, w,
                      out_shapes=tuple(x.shape[:-1]) + tuple(w.shape[1:]),
                      in_grad_placements=(xg, wg))


def _heads_axis():
    return os.environ.get("REPRO_SHARD_HEADS_AXIS")


def _shard_heads(x: torch.Tensor) -> torch.Tensor:
    """The reference's §Perf T1 hint: the head axis of a (B, S, H, hd)
    activation over ``REPRO_SHARD_HEADS_AXIS``, on DTensors."""
    return shard_hint(x, x.dim() - 2, _heads_axis())


def _repeat_kv(q, k) -> bool:
    """The reference's §Perf T5 case: under the head hint, on DTensors,
    fewer kv heads than query heads and a kv head count that does not
    divide the hint's mesh axis."""
    axis = _heads_axis()
    if not (axis and is_dtensor(q) and k.shape[2] < q.shape[2]):
        return False
    names = q.device_mesh.mesh_dim_names or ()
    return (axis in names
            and k.shape[2] % q.device_mesh.size(names.index(axis)) != 0)


def _project_qkv(p, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, *, rope: bool = True):
    x = batch_rows(x)           # on a mesh: one gather for q, k and v
    q, k, v = (_proj(x, p[n]) for n in ("wq", "wk", "wv"))
    q = _shard_heads(q)
    if not _repeat_kv(q, k):
        # (kv heads that are repeated take the hint after the repeat)
        k, v = _shard_heads(k), _shard_heads(v)
    if "bq" in p:
        q, k, v = (_bias(t, p[n]) for t, n in ((q, "bq"), (k, "bk"),
                                                (v, "bv")))
    if "q_norm" in p:
        q = apply_norm({"scale": p["q_norm"]}, q, "rmsnorm")
        k = apply_norm({"scale": p["k_norm"]}, k, "rmsnorm")
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta,
                       cfg.partial_rotary_factor)
        k = apply_rope(k, positions, cfg.rope_theta,
                       cfg.partial_rotary_factor)
    return q.contiguous(), k.contiguous(), v.contiguous()


def _bias(t: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``t (B, S, H, hd) + b (H, hd)``, the bias given its two leading
    unit dimensions first: the broadcast's backward then sums ``t``'s
    gradient to ``(1, 1, H, hd)`` and squeezes it, where DTensor refuses
    the flattening view that a plain add's backward takes when one kv
    head is sharded over a mesh axis of one rank (internvl2-1b's)."""
    return t + b[None, None]


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", out, wo) as one matrix product.  On a
    DTensor ``out`` whose heads are sharded, or a DTensor ``wo`` that
    shards its head width (InternVL2's 14 heads over 16 ranks), each rank
    contracts its own heads (or head widths) against its rows of ``wo``
    and the ranks' products are summed (``Partial``): DTensor cannot
    flatten (H, hd) when H is chunked unevenly (qwen1.5-4b's 20 heads
    over 16 ranks) nor, on the card's torch, when hd is sharded."""
    if is_dtensor(out) and (_head_dims(out) or _width_dims(wo)):
        return _out_proj_mesh(out, wo)
    h, k, d = wo.shape
    return matmul(out.reshape(*out.shape[:-2], h * k), wo.reshape(h * k, d))


def _head_dims(t) -> list:
    return [i for i, p in enumerate(t.placements)
            if p == Shard(t.dim() - 2)]


def _width_dims(wo) -> list:
    """The mesh dimensions over which a DTensor ``wo (H, hd, d)`` shards
    hd."""
    if not is_dtensor(wo):
        return []
    return [i for i, p in enumerate(wo.placements) if p == Shard(1)]


def _out_proj_mesh(out, wo):
    mesh = out.device_mesh
    heads = _head_dims(out)
    width = [i for i in _width_dims(wo) if i not in heads]
    split = heads + width
    lead = out.dim() - 2
    rows = [p if isinstance(p, Shard) and p.dim < lead and i not in split
            else Replicate() for i, p in enumerate(out.placements)]
    lay = [Shard(lead) if i in heads else Shard(lead + 1) if i in width
           else p for i, p in enumerate(rows)]
    wlay = [Shard(0) if i in heads else Shard(1) if i in width
            else Replicate() for i in range(mesh.ndim)]
    # wo's gradient on a rank covers only its own rows of the batch
    wgrad = [wlay[i] if i in split else (Partial() if rows[i] != Replicate()
                                         else Replicate())
             for i in range(mesh.ndim)]
    res = [Partial() if i in split else p for i, p in enumerate(rows)]

    def local(o, w):
        h, k, d = w.shape
        return matmul(o.reshape(*o.shape[:-2], h * k), w.reshape(h * k, d))

    return local_call(local, mesh, (lay, wlay), res, out, wo,
                      out_shapes=tuple(out.shape[:-2]) + (wo.shape[2],),
                      in_grad_placements=(lay, wgrad))


def gqa_forward(p, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, causal: bool = True,
                window: int = 0, rope: bool = True
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention. positions: (S,). Returns (out, (k, v))."""
    q, k, v = _project_qkv(p, cfg, x, positions, rope=rope)
    kc, vc = k, v                    # the cache keeps the compact layout
    if _repeat_kv(q, k):
        # the reference's §Perf T5: kv heads that do not divide the axis
        # are repeated to the full head count
        g = q.shape[2] // k.shape[2]
        k = _shard_heads(k.repeat_interleave(g, dim=2))
        v = _shard_heads(v.repeat_interleave(g, dim=2))
    out = flash_attention(q, k, v, causal=causal, window=window)
    return _out_proj(out, p["wo"]), (kc, vc)


def gqa_decode(p, cfg: ModelConfig, x: torch.Tensor,
               cache: Dict[str, torch.Tensor], lengths: torch.Tensor, *,
               window: int = 0, rope: bool = True
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode. x: (B,1,d); cache k/v: (B,S_max,KV,hd) in
    the model's dtype, or int8 codes beside float32 ``k_scale`` /
    ``v_scale`` (B,S_max,KV,1); updated in place at ``lengths`` (int32
    (B,); a row outside [0, S_max) writes nothing); returns (out,
    cache)."""
    q, k_new, v_new = _project_qkv(p, cfg, x, lengths[:, None], rope=rope)
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
    never reads ``lengths``.  On a DTensor cache each rank writes its own
    rows and, where the sequence is sharded, its own slice of it, at
    ``lengths`` shifted by the slice's offset."""
    if is_dtensor(cache):
        return _scatter_time_mesh(cache, new, lengths)
    s = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    idx = lengths.long().clamp(0, s - 1)
    ok = ((lengths >= 0) & (lengths < s)).reshape(
        (-1,) + (1,) * (cache.dim() - 2))
    cache[rows, idx] = torch.where(ok, new[:, 0].to(cache.dtype),
                                   cache[rows, idx])
    return cache


def _scatter_time_mesh(cache, new, lengths):
    mesh = cache.device_mesh
    sd = seq_dims(cache)
    rows = [Shard(0) if p == Shard(0) else Replicate()
            for p in cache.placements]
    layout = [Shard(1) if i in sd else p for i, p in enumerate(rows)]
    s_all = cache.shape[1]

    def local(c, n, lens):
        return _scatter_time(c, n, lens - seq_offset(mesh, sd, s_all))

    return local_call(local, mesh, (layout, rows, rows), layout, cache, new,
                      lengths, out_shapes=cache.shape)


# ---------------------------------------------------------------------------
# Cross-attention (enc-dec)
# ---------------------------------------------------------------------------

def cross_kv(p, enc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder's output ``(B, n_ctx, d)`` as cross K/V ``(B, n_ctx,
    KV, hd)`` in the promoted dtype of ``enc`` and the weights."""
    k, v = _proj(enc, p["wk"]), _proj(enc, p["wv"])
    if "bk" in p:
        k, v = _bias(k, p["bk"]), _bias(v, p["bv"])
    return k.contiguous(), v.contiguous()


def cross_attend(p, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 decode: bool = False) -> torch.Tensor:
    """The decoder's ``x (B, S, d)`` attending to every row of the cross
    K/V ``(B, n_ctx, KV, hd)``, unmasked: B3 with ``S_k = n_ctx``, or
    with ``decode`` (S = 1) B4 at ``lengths = n_ctx - 1``.  The kernels
    take q in K's dtype; the output returns to x's before ``wo``."""
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = _bias(q, p["bq"])
    qk = q.to(k.dtype).contiguous()
    if decode:
        full = torch.full((x.shape[0],), k.shape[1] - 1, dtype=torch.int32,
                          device=x.device)
        if is_dtensor(qk):
            # every rank's whole copy: B4's mesh route takes its rows
            mesh = qk.device_mesh
            full = DTensor.from_local(full, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)
        out = decode_attention(qk[:, 0], k, v, full)[:, None]
    else:
        out = flash_attention(qk, k, v, causal=False)
    return _out_proj(out.to(q.dtype), p["wo"])


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 latent attention)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> nn.ParameterDict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return nn.ParameterDict({
        "wq": _init_w(gen, (d, h, qd), dtype),
        "w_dkv": _init_w(gen, (d, m.kv_lora_rank), dtype),
        "w_kpe": _init_w(gen, (d, m.qk_rope_head_dim), dtype),
        "norm_ckv": param(torch.ones(m.kv_lora_rank, dtype=dtype,
                                     device=gen.device)),
        "w_uk": _init_w(gen, (m.kv_lora_rank, h, m.qk_nope_head_dim), dtype),
        "w_uv": _init_w(gen, (m.kv_lora_rank, h, m.v_head_dim), dtype),
        "wo": _init_w(gen, (h, m.v_head_dim, d), dtype,
                      scale=(h * m.v_head_dim) ** -0.5),
    })


def _mla_q(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    nope = cfg.mla.qk_nope_head_dim
    q = _proj(x, p["wq"])
    return q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta)


def _mla_latent(p, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor):
    c_kv = apply_norm({"scale": p["norm_ckv"]}, x @ p["w_dkv"], "rmsnorm")
    k_pe = apply_rope((x @ p["w_kpe"])[:, :, None, :], positions,
                      cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_pe


def mla_forward(p, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, window: int = 0
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence MLA in the expanded form, causal.  positions: (S,).
    Returns (out, (c_kv, k_pe))."""
    x = batch_rows(x)           # on a mesh: one gather for q and the latent
    q_nope, q_pe = _mla_q(p, cfg, x, positions)
    c_kv, k_pe = _mla_latent(p, cfg, x, positions)
    k_nope = _proj(c_kv, p["w_uk"])
    v = _proj(c_kv, p["w_uv"])
    k_pe_h = k_pe[:, :, None, :].expand(*k_nope.shape[:3], k_pe.shape[-1])
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe_h], dim=-1)
    out = flash_attention(q, k, v, causal=True, window=window)
    return _out_proj(out, p["wo"]), (c_kv, k_pe)


def mla_decode(p, cfg: ModelConfig, x: torch.Tensor,
               cache: Dict[str, torch.Tensor], lengths: torch.Tensor, *,
               window: int = 0
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed-form MLA decode.  x: (B,1,d); cache ``c_kv`` (B,S,rank)
    and ``k_pe`` (B,S,rope), updated in place at ``lengths`` (int32
    (B,); a row outside [0, S) writes nothing); returns (out, cache).
    The query absorbs ``w_uk`` and the context is lifted through
    ``w_uv`` in float32, as the reference computes them."""
    m = cfg.mla
    q_nope, q_pe = _mla_q(p, cfg, x, lengths[:, None])
    c_new, kpe_new = _mla_latent(p, cfg, x, lengths[:, None])
    _scatter_time(cache["c_kv"], c_new, lengths)
    _scatter_time(cache["k_pe"], kpe_new, lengths)
    q_abs = torch.einsum("bhk,rhk->bhr", q_nope[:, 0].float(),
                         p["w_uk"].float())
    ctx = mla_decode_attention(
        q_abs.contiguous(), q_pe[:, 0].float().contiguous(), cache["c_kv"],
        cache["k_pe"], lengths,
        scale=(m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5,
        window=window)
    out = torch.einsum("bhr,rhk->bhk", ctx, p["w_uv"].float()).to(x.dtype)
    return _out_proj(out[:, None], p["wo"]), cache
