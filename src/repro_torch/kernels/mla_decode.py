"""Absorbed MLA decode attention of the port's DeepSeek-V2 layers: the
CUDA kernel ``csrc/mla_decode.cu`` and its plain torch version.

``mla_decode_attention(q_abs, q_pe, c_kv, k_pe, lengths, scale=,
window=)`` attends one query token per batch row in the latent space:
q_abs ``(B, H, R)`` (the query with ``W_uk`` absorbed) and q_pe ``(B,
H, P)`` in float32, the cache c_kv ``(B, S, R)`` and k_pe ``(B, S, P)``
in float32 or bfloat16, int32 ``lengths (B,)``.  Head h scores position
t as ``(q_abs[h]·c_kv[t] + q_pe[h]·k_pe[t])·scale`` at the positions
``t <= lengths[b]`` (the slot at ``lengths[b]`` already holds the new
token) and, when ``window`` is set, ``lengths[b] - t < window``; the
float32 softmax weighs the rows of c_kv, and the result is the context
``(B, H, R)`` in float32, which the model then lifts through ``W_uv``.
A row with no admitted position gives 0.

It replaces no Pallas kernel: the reference computes this chain in
float32 einsums inside ``repro.models.attention.mla_decode``, and
``mla_decode_attention_plain`` is that arithmetic in torch.  The
wrapper launches the kernel for CUDA tensors and takes the plain
version for CPU tensors; it raises on any other device, on shapes and
dtypes it does not take and, on the card, on widths other than
DeepSeek-V2-Lite's (``SHAPES``: 16 heads, rank 512, rope 64) and on
misaligned pointers.  On the card the cache axis is split across blocks
(``mla_splits``, from the shapes and the card's SM count, never from
``lengths``) and each row's last block to finish merges the splits'
partials in split order, through a workspace and an int32 arrival
counter a row kept per device (the counters return to zero at the end
of every launch).  A failed build or launch raises: there is no
fallback.  ``mla_decode_attention.launches`` counts the wrapper calls
that launch the kernel, one per call.  A ``meta`` tensor takes the shape function (the
output, empty; ``meta_calls``).  A DTensor (a device mesh) goes through
``local_map`` (``kernels._mesh``) as B4 does: on a cache sequence of one
shard the wrapper runs on each rank's tensors (on the card one launch a
rank, counted); where ``launch.sharding.cache_specs`` splits the
sequence, each rank's ``mla_decode_partials_plain`` over its own slice
are merged across the ranks on the CPU (the shape function on
``meta``), and the CUDA kernel, which has no partials entry, raises
``NotImplementedError`` (ROADMAP 3f).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.kernels._launch import (DTYPE_CODE, check_aligned,
                                         float_workspace, kernel_device,
                                         shape_only, sm_count)
from repro_torch.kernels._mesh import (is_dtensor, local_call,
                                       merge_partials, ranks, seq_dims,
                                       seq_offset)
from repro_torch.kernels.flash_attention import NEG_INF

__all__ = ["SHAPES", "TILE", "mla_decode_attention",
           "mla_decode_attention_plain", "mla_decode_partials_plain",
           "mla_splits"]

# (heads, kv_lora_rank, qk_rope_head_dim) the CUDA kernel is built for:
# DeepSeek-V2-Lite's
SHAPES = ((16, 512, 64),)
# cache positions per tile of the CUDA kernel (bf16; a float32 tile is
# half of one); a split is whole tiles
TILE = 64
# a split's partial, read back by its row's last block, costs about
# this share of a tile's work (mla_splits' cost)
MERGE_COST = 1 / 16
MAX_SPLITS = 64

# per device: the split workspace and the rows' arrival counters
_WORK: Dict[torch.device, torch.Tensor] = {}
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _check(q_abs, q_pe, c_kv, k_pe, lengths) -> None:
    if q_abs.dim() != 3 or q_pe.dim() != 3 or c_kv.dim() != 3 \
            or k_pe.dim() != 3:
        raise ValueError(f"mla_decode_attention takes q_abs (B,H,R), q_pe "
                         f"(B,H,P), c_kv (B,S,R) and k_pe (B,S,P); got "
                         f"{tuple(q_abs.shape)}, {tuple(q_pe.shape)}, "
                         f"{tuple(c_kv.shape)}, {tuple(k_pe.shape)}")
    b, h, r = q_abs.shape
    p = q_pe.shape[2]
    s = c_kv.shape[1]
    if (tuple(q_pe.shape[:2]) != (b, h) or tuple(c_kv.shape) != (b, s, r)
            or tuple(k_pe.shape) != (b, s, p)):
        raise ValueError(f"shapes do not match: q_abs {tuple(q_abs.shape)}, "
                         f"q_pe {tuple(q_pe.shape)}, c_kv "
                         f"{tuple(c_kv.shape)}, k_pe {tuple(k_pe.shape)}")
    if q_abs.dtype != torch.float32 or q_pe.dtype != torch.float32:
        raise ValueError(f"q_abs and q_pe must be float32, got "
                         f"{q_abs.dtype}, {q_pe.dtype}")
    if c_kv.dtype not in DTYPE_CODE or k_pe.dtype != c_kv.dtype:
        raise ValueError(f"the latent cache is float32 or bfloat16, one "
                         f"dtype; got {c_kv.dtype}, {k_pe.dtype}")
    if tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32 ({b},), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if not all(t.is_contiguous() for t in (q_abs, q_pe, c_kv, k_pe,
                                           lengths)):
        raise ValueError("mla_decode_attention takes contiguous tensors")
    if len({t.device for t in (q_abs, q_pe, c_kv, k_pe, lengths)}) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{[t.device for t in (q_abs, q_pe, c_kv, k_pe)]}")


def mla_decode_attention_plain(q_abs: torch.Tensor, q_pe: torch.Tensor,
                               c_kv: torch.Tensor, k_pe: torch.Tensor,
                               lengths: torch.Tensor, *, scale: float,
                               window: int = 0) -> torch.Tensor:
    """The plain torch version, on any device: the reference's einsum
    chain in float32 (scores, masked softmax normalised before the
    product with c_kv)."""
    m, e, c = _exp_scores(q_abs, q_pe, c_kv, k_pe, lengths, scale, window)
    p = e / (e.sum(dim=-1, keepdim=True) + 1e-30)
    return torch.einsum("bht,btr->bhr", p, c)


def _exp_scores(q_abs, q_pe, c_kv, k_pe, lengths, scale: float,
                window: int):
    """The float32 scores' row max ``m`` ``(B, H, 1)``, ``exp(score - m)``
    at the admitted positions and 0 elsewhere ``(B, H, S)``, and the
    float32 cache ``c``."""
    _check(q_abs, q_pe, c_kv, k_pe, lengths)
    c = c_kv.float()
    sc = torch.einsum("bhr,btr->bht", q_abs, c)
    sc = sc + torch.einsum("bhp,btp->bht", q_pe, k_pe.float())
    sc = sc * scale
    pos = torch.arange(c_kv.shape[1], device=c_kv.device)[None, :]
    length = lengths.long()[:, None]
    mask = pos <= length
    if window:
        mask &= length - pos < window
    mask = mask[:, None, :]
    sc = torch.where(mask, sc, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    return m, torch.where(mask, torch.exp(sc - m), 0.0), c


def mla_decode_partials_plain(q_abs: torch.Tensor, q_pe: torch.Tensor,
                              c_kv: torch.Tensor, k_pe: torch.Tensor,
                              lengths: torch.Tensor, *, scale: float,
                              window: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """``mla_decode_attention_plain`` before its normalisation: the
    float32 softmax statistics over the admitted positions of this cache,
    ``m`` and ``l`` ``(B, H, 1)`` and the unnormalised context ``acc``
    ``(B, H, R)`` (a row with no admitted position: ``m = NEG_INF``,
    ``l = 0``, ``acc = 0``).  ``acc / (l + 1e-30)`` is the context; the
    partials of the slices of a cache merge by rescaling each with
    ``exp(m - max m)`` and summing, as the mesh route does across
    ranks."""
    m, e, c = _exp_scores(q_abs, q_pe, c_kv, k_pe, lengths, scale, window)
    return m, e.sum(dim=-1, keepdim=True), torch.einsum("bht,btr->bhr", e, c)


def mla_splits(b: int, s: int, sms: int) -> Tuple[int, int]:
    """``(splits, chunk)`` for ``b`` rows of an ``s``-position cache on a
    card with ``sms`` SMs, which hold one block each: the split count
    (at most the cache's tiles and ``MAX_SPLITS``) whose waves of
    ``(splits, b)`` blocks times the tiles a block walks, plus
    ``MERGE_COST`` a split merged, is least (the fewest splits on a
    tie); ``chunk`` is a whole number of tiles and ``splits`` slices of
    it cover the cache, none of them wholly past its end."""
    tiles = max(1, -(-s // TILE))
    best = None
    for want in range(1, min(tiles, MAX_SPLITS) + 1):
        per = -(-tiles // want)
        n = -(-tiles // per)
        cost = -(-b * n // sms) * per + (n - 1) * MERGE_COST
        if best is None or cost < best[0]:
            best = (cost, per)
    chunk = best[1] * TILE
    return max(1, -(-s // chunk)), chunk


def _workspace(dev: torch.device, floats: int) -> torch.Tensor:
    """This kernel's split workspace on ``dev`` (``_WORK``)."""
    return float_workspace(_WORK, dev, floats)


def _counters(dev: torch.device, rows: int) -> torch.Tensor:
    """The rows' int32 arrival counters on ``dev`` (``_COUNTERS``): zero
    when made, and every launch leaves them zero."""
    have = _COUNTERS.get(dev)
    if have is None or have.numel() < rows:
        _COUNTERS[dev] = torch.zeros(rows, dtype=torch.int32, device=dev)
    return _COUNTERS[dev]


def _launch(q_abs, q_pe, c_kv, k_pe, lengths, out, scale: float,
            window: int) -> None:
    from repro_torch.kernels._build import library

    b, h, r = q_abs.shape
    s, p = c_kv.shape[1], k_pe.shape[2]
    if (h, r, p) not in SHAPES:
        raise ValueError(f"the CUDA mla_decode_attention is built for "
                         f"(heads, rank, rope) in {SHAPES}, got "
                         f"{(h, r, p)}")
    # the kernel reads q and stages the cache 16 bytes at a time
    check_aligned("mla_decode_attention", q_abs, q_pe, c_kv, k_pe)
    if b > 65535 or b * s >= 1 << 31 or abs(window) >= 1 << 31:
        raise ValueError(f"shape {tuple(c_kv.shape)} / window {window} too "
                         f"large for one launch")
    splits, chunk = mla_splits(b, s, sm_count(q_abs.device))
    ws = cnt = None
    if splits > 1:
        ws = _workspace(q_abs.device, splits * b * h * (r + 2)).data_ptr()
        cnt = _counters(q_abs.device, b).data_ptr()
    fn = library("mla_decode").mla_decode_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q_abs.device).cuda_stream
    with torch.cuda.device(q_abs.device):
        err = fn(q_abs.data_ptr(), q_pe.data_ptr(), c_kv.data_ptr(),
                 k_pe.data_ptr(), lengths.data_ptr(), out.data_ptr(), ws,
                 cnt, b,
                 s, h, r, p, DTYPE_CODE[c_kv.dtype], float(scale),
                 int(window), chunk, splits, stream)
    if err != 0:
        raise RuntimeError(f"mla_decode_attention kernel launch failed: "
                           f"CUDA error {err}")


def mla_decode_attention(q_abs: torch.Tensor, q_pe: torch.Tensor,
                         c_kv: torch.Tensor, k_pe: torch.Tensor,
                         lengths: torch.Tensor, *, scale: float,
                         window: int = 0) -> torch.Tensor:
    """The latent context ``(B, H, R)`` in float32.  The CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if is_dtensor(c_kv):
        return _on_mesh(q_abs, q_pe, c_kv, k_pe, lengths, scale, window)
    _check(q_abs, q_pe, c_kv, k_pe, lengths)
    if not kernel_device(q_abs, "mla_decode_attention"):
        return mla_decode_attention_plain(q_abs, q_pe, c_kv, k_pe, lengths,
                                          scale=scale, window=window)
    out = torch.empty_like(q_abs)
    if not shape_only(mla_decode_attention, q_abs, out,
                      ops=_ops(q_abs, q_pe, c_kv)):
        _launch(q_abs, q_pe, c_kv, k_pe, lengths, out, scale, window)
        mla_decode_attention.launches += 1
    return out


mla_decode_attention.launches = 0
mla_decode_attention.meta_calls = 0


def _ops(q_abs, q_pe, c_kv) -> float:
    """The kernel's operation count with every cache position admitted:
    the two score products and p·c_kv, two flops a multiply-add."""
    b, h, r = q_abs.shape
    return 2.0 * b * h * (2 * r + q_pe.shape[2]) * c_kv.shape[1]


def _on_mesh(q_abs, q_pe, c_kv, k_pe, lengths, scale: float, window: int):
    """MLA decode on DTensors, B4's route (``decode_attention._on_mesh``)
    over the latent cache: the queries and ``lengths`` follow the cache's
    batch shards, every rank holds all heads.  Where the cache's sequence
    is one shard the wrapper runs on each rank's tensors; where it is
    split each rank's float32 partials over its own slice (``lengths``
    shifted by the slice's offset; the window needs no shift) are merged
    with a max and two sum all-reduces, on the CPU and on ``meta``."""
    mesh = c_kv.device_mesh
    sd = seq_dims(c_kv)
    rows = [Shard(0) if p == Shard(0) else Replicate()
            for p in c_kv.placements]
    cache = [Shard(1) if i in sd else p for i, p in enumerate(rows)]
    split = ranks(mesh, sd)
    if split == 1:
        def local(qa, qp, c, kp, lens):
            return mla_decode_attention(qa, qp, c, kp, lens, scale=scale,
                                        window=window)
    elif c_kv.device.type == "cuda":
        raise NotImplementedError(
            f"MLA decode attention over a cache sequence split across "
            f"{split} GPUs: the CUDA kernel has no partials entry (ROADMAP "
            f"3f)")
    else:
        s_all = c_kv.shape[1]

        def local(qa, qp, c, kp, lens):
            if qa.device.type == "meta":
                fn = mla_decode_attention
                fn.meta_calls += 1
                fn.meta_ops = getattr(fn, "meta_ops", 0.0) + _ops(qa, qp, c)
                m = torch.empty(qa.shape[:2] + (1,), device="meta")
                l, acc = torch.empty_like(m), torch.empty_like(qa)
            else:
                off = seq_offset(mesh, sd, s_all)
                m, l, acc = mla_decode_partials_plain(
                    qa, qp, c, kp, lens - off, scale=scale, window=window)
            return merge_partials(m, l, acc, mesh, sd)

    return local_call(local, mesh, (rows, rows, cache, cache, rows), rows,
                      q_abs, q_pe, c_kv, k_pe, lengths,
                      out_shapes=q_abs.shape)
