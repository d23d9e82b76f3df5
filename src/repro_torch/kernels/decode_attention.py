"""Decode attention of the port's dense transformer: the CUDA kernel
``csrc/decode_attention.cu`` and its plain torch version.

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
on the card).  ``decode_attention.launches`` counts the kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention import (DTYPE_CODE, NEG_INF,
                                                 check_attention_inputs,
                                                 kernel_device, launchable)

__all__ = ["decode_attention", "decode_attention_plain", "MAX_GROUP"]

# query heads per kv head the CUDA kernel serves in one block
MAX_GROUP = 8


def _check(q, k, v, lengths) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention takes q (B,H,hd) and k, v "
                         f"(B,S,KV,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hd = q.shape
    if (k.shape[0], k.shape[3]) != (b, hd):
        raise ValueError(f"cache {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32 ({b},), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    check_attention_inputs(q, k, v)
    if lengths.device != q.device:
        raise ValueError(f"lengths on {lengths.device}, q on {q.device}")


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """The plain torch version, on any device: the Pallas kernel's
    arithmetic in float32 with the whole cache as one tile."""
    _check(q, k, v, lengths)
    b, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    sc = torch.einsum("bkgh,btkh->bkgt", q.float().reshape(b, kv, g, hd),
                      k.float()) * (hd ** -0.5)
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
    acc = torch.einsum("bkgt,btkh->bkgh", p, v.float())
    return (acc / (l + 1e-30)).reshape(b, h, hd).to(q.dtype)


def _launch(q, k, v, lengths, out, window: int) -> None:
    from repro_torch.kernels._build import library

    b, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    launchable("decode_attention", hd, q, k, v, out)
    if h // kv > MAX_GROUP:
        raise ValueError(f"the CUDA decode_attention serves at most "
                         f"{MAX_GROUP} query heads per kv head, got "
                         f"{h // kv}")
    if b > 65535 or s >= 1 << 31 or abs(window) >= 1 << 31:
        raise ValueError(f"shape {tuple(k.shape)} / window {window} too "
                         f"large for one launch")
    fn = library("decode_attention").decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), b, s, h, kv, hd,
                 DTYPE_CODE[q.dtype], hd ** -0.5, int(window), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """Decode attention: q ``(B, H, hd)``, cache k/v ``(B, S, KV, hd)``,
    int32 ``lengths (B,)`` → ``(B, H, hd)`` in q's dtype.  The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    _check(q, k, v, lengths)
    if not kernel_device(q, "decode_attention"):
        return decode_attention_plain(q, k, v, lengths, window=window)
    out = torch.empty_like(q)
    _launch(q, k, v, lengths, out, window)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
