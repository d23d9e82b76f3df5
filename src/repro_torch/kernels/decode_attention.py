"""Decode attention of the port's transformers: the CUDA kernel
``csrc/decode_attention.cuh`` and its plain torch versions.

``decode_attention(q, k, v, lengths, window=)`` attends one query token
per batch row, q ``(B, H, hd)``, to its cache k, v ``(B, S, KV, hd)``:
query head h reads kv head ``h // (H // KV)`` at the positions
``pos <= lengths[b]`` (the slot at ``lengths[b]`` already holds the new
token) and, when ``window`` is set, ``lengths[b] - pos < window``.  The
softmax is float32 as in ``flash_attention``; the output has q's dtype.
It replaces the reference's Pallas kernel
``repro.kernels.decode_attention`` (``_kernel``) and computes the
attention of the reference model's ``gqa_decode``, with the same bf16
caveat as ``flash_attention``.

The wrapper launches the kernel for CUDA tensors and takes
``decode_attention_plain`` for CPU tensors, and raises on anything else
(device, dtype, layout, ``H % KV``, more than 8 query heads per kv head
on the card).  On the card the cache axis is split across blocks
(flash-decoding): ``decode_splits`` picks the split from the shapes and
the card's SM count, never from ``lengths``, and the kernel merges the
splits' partials in the same launch, through a workspace and ticket
counters the wrapper keeps per device.  ``decode_partials_plain`` and
``merge_partials_plain`` are that split-and-merge algebra in plain
torch, for the tests.  ``decode_attention.launches`` counts the kernel
launches, one per call.

``decode_attention_int8(q, k, k_scale, v, v_scale, lengths, window=)``
is B4 over the int8 KV cache: int8 codes k, v ``(B, S, KV, hd)`` and
float32 scales ``(B, S, KV, 1)``, q in float32 or bfloat16.  It computes
what the reference model's int8 ``gqa_decode`` computes: the score
``(q·k_i8)·hd^-0.5·k_scale``, the masked online softmax, the
accumulator ``Σ p·v_scale·v_i8`` and ``acc / (l + 1e-30)``.  The kernel
is the int8 instantiation of the same template
(``csrc/decode_attention.cuh``, built from
``csrc/decode_attention_int8.cu``): it stages the codes (and the scales) and turns them into floats in
registers, so the cache is never dequantized into a copy; it takes the
same split rule and merge.
``decode_attention_int8_plain`` is its plain version, and
``decode_attention_int8.launches`` counts its launches.

``meta`` tensors (the dry run) take the kernels' shape function: the
output, empty, counted in ``meta_calls`` and not as a launch.  DTensors
(a device mesh) go through ``local_map`` (``kernels._mesh``): q and
``lengths`` follow the cache's batch shards, and q its kv-head shards
where the cache shards its heads (whisper's cross cache, ``P(batch,
None, "model", None)``), so that each rank reads its own heads.  Where
the cache's sequence is sharded (``launch.sharding.cache_specs``: over
"model", or over "data" and "model" at long_500k) each rank attends its
own slice of the keys, with ``lengths`` shifted by the slice's offset
(the window needs no shift), into float32 partials ``m``, ``l``,
``acc``, and the ranks merge them with a max and two sum all-reduces
(``kernels._mesh.merge_partials``): the arithmetic of
``decode_partials_plain`` and ``merge_partials_plain`` across ranks.
That route runs the plain partials on the CPU and the shape function on
``meta``; the CUDA kernel has no partials entry, so a sequence split
over more than one GPU raises ``NotImplementedError`` (ROADMAP 3f).  On a
split of one the kernel runs on each rank's shard as it does today.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.kernels._launch import (DTYPE_CODE, kernel_device,
                                         shape_only, sm_count)
from repro_torch.kernels._mesh import (head_placements, is_dtensor,
                                       local_call, merge_partials, ranks,
                                       remap, seq_dims, seq_offset)
from repro_torch.kernels.flash_attention import (NEG_INF,
                                                 check_attention_inputs,
                                                 launchable)

__all__ = ["decode_attention", "decode_attention_plain",
           "decode_attention_int8", "decode_attention_int8_plain",
           "MAX_GROUP", "decode_splits", "decode_partials_plain",
           "merge_partials_plain"]

# query heads per kv head the CUDA kernel serves in one block
MAX_GROUP = 8
# cache positions per tile of the CUDA kernel: TILE_ELEMS / head_dim
# (on the int8 cache: a tile of TILE_ELEMS bytes of codes)
TILE_ELEMS = 4096
# the grid aims at this many blocks per SM
BLOCKS_PER_SM = 2
# the CUDA merge holds at most this many splits' statistics
MAX_SPLITS = 64

# per device: the split workspace and ticket counters
_WORK: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _check_shapes(name: str, q, k, v, lengths) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name} takes q (B,H,hd) and k, v (B,S,KV,hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, hd = q.shape
    if (k.shape[0], k.shape[3]) != (b, hd):
        raise ValueError(f"cache {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32 ({b},), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")


def _check(q, k, v, lengths) -> None:
    _check_shapes("decode_attention", q, k, v, lengths)
    check_attention_inputs(q, k, v)
    if lengths.device != q.device:
        raise ValueError(f"lengths on {lengths.device}, q on {q.device}")


def _check_int8(q, k, k_scale, v, v_scale, lengths) -> None:
    _check_shapes("decode_attention_int8", q, k, v, lengths)
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise ValueError(f"the int8 cache holds int8 codes, got {k.dtype}, "
                         f"{v.dtype}")
    want = tuple(k.shape[:3]) + (1,)
    for t in (k_scale, v_scale):
        if t.dtype != torch.float32 or tuple(t.shape) != want:
            raise ValueError(f"scales must be float32 {want}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    check_attention_inputs(q, k, k_scale, v, v_scale, lengths,
                           cache_dtypes=False)


def _attend_plain(q, k, v, lengths, window, k_scale=None, v_scale=None):
    """B4's arithmetic in float32 with the whole cache as one tile; with
    the int8 cache's scales, the score takes ``k_scale`` and the p·v sum
    reads ``p·v_scale`` while ``l`` sums ``p``."""
    b, h, hd = q.shape
    _, l, acc = _partials_plain(q, k, v, lengths, window, k_scale, v_scale)
    return (acc / (l + 1e-30)).reshape(b, h, hd).to(q.dtype)


def _partials_plain(q, k, v, lengths, window, k_scale=None, v_scale=None):
    """``_attend_plain`` before its division: the float32 statistics ``m``
    and ``l`` ``(B, KV, G, 1)`` and ``acc`` ``(B, KV, G, hd)`` over the
    whole cache (a row with no admitted key: ``m = NEG_INF``, ``l = 0``,
    ``acc = 0``)."""
    b, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    sc = torch.einsum("bkgh,btkh->bkgt", q.float().reshape(b, kv, g, hd),
                      k.float()) * (hd ** -0.5)
    if k_scale is not None:
        sc = sc * k_scale[..., 0].transpose(1, 2)[:, :, None, :]
    pos = torch.arange(s, device=q.device)[None, :]
    length = lengths.long()[:, None]
    mask = pos <= length
    if window:
        mask &= length - pos < window
    mask = mask[:, None, None, :]
    sc = torch.where(mask, sc, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(sc - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale[..., 0].transpose(1, 2)[:, :, None, :]
    acc = torch.einsum("bkgt,btkh->bkgh", p, v.float())
    return m, l, acc


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """The plain torch version, on any device: the Pallas kernel's
    arithmetic in float32 with the whole cache as one tile."""
    _check(q, k, v, lengths)
    return _attend_plain(q, k, v, lengths, window)


def decode_attention_int8_plain(q: torch.Tensor, k: torch.Tensor,
                                k_scale: torch.Tensor, v: torch.Tensor,
                                v_scale: torch.Tensor, lengths: torch.Tensor,
                                *, window: int = 0) -> torch.Tensor:
    """The plain torch version of B4 over the int8 cache, on any device:
    float32 arithmetic with the whole cache as one tile."""
    _check_int8(q, k, k_scale, v, v_scale, lengths)
    return _attend_plain(q, k, v, lengths, window, k_scale, v_scale)


def decode_splits(b: int, kv: int, s: int, hd: int,
                  sms: int) -> Tuple[int, int]:
    """``(splits, chunk)`` for a ``(b, s, kv, hd)`` cache on a card with
    ``sms`` SMs: enough splits that the ``(splits, kv, b)`` grid gives
    every SM ``BLOCKS_PER_SM`` blocks, but no more than the cache has
    tiles nor ``MAX_SPLITS``; ``chunk`` is a whole number of tiles and
    ``splits`` slices of it cover the cache, none of them wholly past its
    end."""
    tile = TILE_ELEMS // hd
    tiles = max(1, -(-s // tile))
    want = -(-BLOCKS_PER_SM * sms // max(1, b * kv))
    splits = max(1, min(want, tiles, MAX_SPLITS))
    chunk = -(-tiles // splits) * tile
    return max(1, -(-s // chunk)), chunk


def decode_partials_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, splits: int, chunk: int, *,
                          window: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """What each split block of the CUDA kernel computes, in plain
    torch: for split s, the float32 softmax statistics over the
    admitted positions in ``[s * chunk, (s + 1) * chunk)`` — ``m`` and
    ``l`` of shape ``(B, KV, splits, G)`` and ``acc`` ``(B, KV, splits,
    G, hd)``; an empty split has ``m = NEG_INF``, ``l = 0``, ``acc =
    0``."""
    _check(q, k, v, lengths)
    b, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    sc = torch.einsum("bkgh,btkh->bkgt", q.float().reshape(b, kv, g, hd),
                      k.float()) * (hd ** -0.5)
    pos = torch.arange(s, device=q.device)
    length = lengths.long()[:, None]
    mask = pos[None, :] <= length
    if window:
        mask &= length - pos[None, :] < window
    part = (pos[None, :] // chunk
            == torch.arange(splits, device=q.device)[:, None])
    # (B, 1, splits, 1, S): admitted and in the split
    mask = (mask[:, None, :] & part[None])[:, None, :, None, :]
    sc = torch.where(mask, sc[:, :, None], NEG_INF)
    m = sc.amax(dim=-1)
    p = torch.where(mask, torch.exp(sc - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bksgt,btkh->bksgh", p, v.float())
    return m, l, acc


def merge_partials_plain(m: torch.Tensor, l: torch.Tensor,
                         acc: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """The kernel's merge of ``decode_partials_plain``'s statistics:
    rescale each split by ``exp(m_s - max m)`` and divide the summed
    accumulator by the summed ``l + 1e-30``; ``(B, H, hd)`` in
    ``dtype``."""
    b, kv, _, g, hd = acc.shape
    top = m.amax(dim=2, keepdim=True)
    w = torch.exp(m - top)
    lsum = (l * w).sum(dim=2)
    asum = (acc * w[..., None]).sum(dim=2)
    return (asum / (lsum[..., None] + 1e-30)).reshape(b, kv * g,
                                                       hd).to(dtype)


def _workspace(dev: torch.device, floats: int,
               counters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device's split workspace and ticket counters, grown (and
    zeroed) when a launch needs more; never allocated per call."""
    have = _WORK.get(dev)
    if (have is None or have[0].numel() < floats
            or have[1].numel() < counters):
        floats = max(floats, 0 if have is None else have[0].numel())
        counters = max(counters, 0 if have is None else have[1].numel())
        _WORK[dev] = (torch.zeros(floats, dtype=torch.float32, device=dev),
                      torch.zeros(counters, dtype=torch.int32, device=dev))
    return _WORK[dev]


def _ops(q, k, window: int) -> float:
    """B4's operation count on these shapes with every cache position
    (or the window) admitted: q·k and p·v, two flops a multiply-add, a
    head and position (the shape function does not see ``lengths``)."""
    b, h, hd = q.shape
    s = k.shape[1]
    return 4.0 * hd * h * b * (min(s, window) if window else s)


def _launch(q, k, v, lengths, out, window: int, scales=None) -> None:
    """One launch of the float kernel, or of the int8 one when
    ``scales`` holds the cache's (k_scale, v_scale)."""
    from repro_torch.kernels._build import library

    b, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    launchable("decode_attention", hd, q, k, v, out)
    if h // kv > MAX_GROUP:
        raise ValueError(f"the CUDA decode_attention serves at most "
                         f"{MAX_GROUP} query heads per kv head, got "
                         f"{h // kv}")
    if max(b, kv) > 65535 or s >= 1 << 30 or abs(window) >= 1 << 31:
        raise ValueError(f"shape {tuple(k.shape)} / window {window} too "
                         f"large for one launch")
    splits, chunk = decode_splits(b, kv, s, hd, sm_count(q.device))
    ws = tickets = 0
    if splits > 1:
        # m, l and acc[hd] for each (row, kv head, split, query head)
        work, count = _workspace(q.device, b * splits * h * (hd + 2),
                                 b * kv)
        ws, tickets = work.data_ptr(), count.data_ptr()
    if scales is None:
        fn = library("decode_attention").decode_attention_launch
        ptrs = (q, k, v)
    else:
        fn = library("decode_attention_int8").decode_attention_int8_launch
        ptrs = (q, k, scales[0], v, scales[1])
    fn.argtypes = [ctypes.c_void_p] * (len(ptrs) + 4) + [ctypes.c_int] * 6 + [
        ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(*(t.data_ptr() for t in ptrs), lengths.data_ptr(),
                 out.data_ptr(), ws, tickets, b, s, h, kv, hd,
                 DTYPE_CODE[q.dtype], hd ** -0.5, int(window), splits, chunk,
                 stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """Decode attention: q ``(B, H, hd)``, cache k/v ``(B, S, KV, hd)``,
    int32 ``lengths (B,)`` → ``(B, H, hd)`` in q's dtype.  The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if is_dtensor(k):
        return _on_mesh(decode_attention, q, k, v, lengths, window)
    _check(q, k, v, lengths)
    if not kernel_device(q, "decode_attention"):
        return decode_attention_plain(q, k, v, lengths, window=window)
    out = torch.empty_like(q)
    if not shape_only(decode_attention, q, out, ops=_ops(q, k, window)):
        _launch(q, k, v, lengths, out, window)
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
decode_attention.meta_calls = 0


def decode_attention_int8(q: torch.Tensor, k: torch.Tensor,
                          k_scale: torch.Tensor, v: torch.Tensor,
                          v_scale: torch.Tensor, lengths: torch.Tensor, *,
                          window: int = 0) -> torch.Tensor:
    """Decode attention over the int8 cache: q ``(B, H, hd)``, codes k/v
    int8 ``(B, S, KV, hd)``, scales float32 ``(B, S, KV, 1)``, int32
    ``lengths (B,)`` → ``(B, H, hd)`` in q's dtype.  The CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if is_dtensor(k):
        return _on_mesh(decode_attention_int8, q, k, v, lengths, window,
                        (k_scale, v_scale))
    _check_int8(q, k, k_scale, v, v_scale, lengths)
    if not kernel_device(q, "decode_attention_int8"):
        return decode_attention_int8_plain(q, k, k_scale, v, v_scale,
                                           lengths, window=window)
    out = torch.empty_like(q)
    if not shape_only(decode_attention_int8, q, out,
                      ops=_ops(q, k, window)):
        _launch(q, k, v, lengths, out, window, scales=(k_scale, v_scale))
        decode_attention_int8.launches += 1
    return out


decode_attention_int8.launches = 0
decode_attention_int8.meta_calls = 0


def _on_mesh(fn, q, k, v, lengths, window: int, scales=None):
    """B4 (``fn``: the float or the int8 wrapper) on DTensors; see the
    module's docstring."""
    mesh = k.device_mesh
    sd = seq_dims(k)
    h, kv = q.shape[1], k.shape[2]
    # a cache that shards its kv heads (whisper's cross cache) keeps them:
    # each rank's query heads read its own kv heads
    heads = head_placements(
        k, 2, lambda n: (h % n == 0 and kv % n == 0) or h == kv)
    rows = remap(heads, {0: 0, 2: 1})
    cache = [Shard(1) if i in sd else p for i, p in enumerate(heads)]
    lens = remap(heads, {0: 0})
    tail = () if scales is None else tuple(scales)
    split = ranks(mesh, sd)
    if split == 1:
        def local(q, k, v, lengths, *sc):
            if sc:
                return fn(q, k, sc[0], v, sc[1], lengths, window=window)
            return fn(q, k, v, lengths, window=window)
    elif k.device.type == "cuda":
        raise NotImplementedError(
            f"decode attention over a cache sequence split across "
            f"{split} GPUs: the CUDA kernel has no partials entry (ROADMAP "
            f"3f)")
    else:
        s_all = k.shape[1]

        def local(q, k, v, lengths, *sc):
            b, h, hd = q.shape
            kv = k.shape[2]
            if q.device.type == "meta":
                fn.meta_calls += 1
                fn.meta_ops = getattr(fn, "meta_ops", 0.0) + _ops(q, k,
                                                                  window)
                m = torch.empty(b, kv, h // kv, 1, device="meta")
                l, acc = torch.empty_like(m), torch.empty(
                    b, kv, h // kv, hd, device="meta")
            else:
                off = seq_offset(mesh, sd, s_all)
                m, l, acc = _partials_plain(q, k, v, lengths - off, window,
                                            *sc)
            return merge_partials(m, l, acc, mesh, sd).reshape(
                b, h, hd).to(q.dtype)

    return local_call(local, mesh, (rows, cache, cache, lens)
                      + (cache,) * len(tail), rows, q, k, v, lengths, *tail,
                      out_shapes=q.shape)
