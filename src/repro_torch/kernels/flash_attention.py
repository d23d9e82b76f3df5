"""Prefill attention of the port's dense transformer: the CUDA kernel
``csrc/flash_attention.cu`` and its plain torch version.

``flash_attention(q, k, v, causal=, window=)`` computes blocked causal /
sliding-window / unmasked GQA attention for q ``(B, S, H, hd)``, k
``(B, S_k, KV, hd)`` and v ``(B, S_k, KV, hdv)``: query head h reads kv
head ``h // (H // KV)``; the key length ``S_k`` is ``S`` for
self-attention and the encoder's ``n_ctx`` for cross-attention (no
mask; ``causal=True`` with ``S_k != S`` raises: no path needs it and
the reference defines no alignment for it); the scores are scaled by
``hd ** -0.5``; the softmax runs in float32 with
masked scores ``NEG_INF = -0.7 * f32max`` and ``out = acc / (l +
1e-30)``, so a row with no admitted key is 0; the output is ``(B, S, H,
hdv)`` in q's dtype.  The value width is q's for GQA; MLA's expanded
prefill attends q, k of width 192 against v of width 128.  It replaces
the reference's Pallas kernel ``repro.kernels.flash_attention``
(``_kernel``) and computes what the
reference model's ``sdpa`` computes, except that the reference rounds
the probabilities to one bf16 before P·V on bf16 inputs, where the
Pallas kernel and the plain version keep them in float32 and the bf16
CUDA kernel carries them as two bf16 terms (about 16 bits).

The wrapper launches a kernel for CUDA tensors and takes
``flash_attention_plain`` for CPU tensors; it raises on any other
device, on a dtype other than float32 / bfloat16, on non-contiguous or
misaligned inputs, on ``H % KV != 0`` and on ``causal`` with
``S_k != S``.  On the card the dtype picks
the kernel: bfloat16 runs ``flash_attention_kernel_bf16`` (tensor-core
tiles, P carried as two bf16 terms), float32 runs
``flash_attention_kernel`` (CUDA cores, no TF32 rounding), at every
width pair.  A failed build or launch raises: there is no fallback.

Gradients.  On CPU tensors autograd differentiates the plain version as
it is.  On CUDA tensors with grad enabled and an input that requires
grad, the call goes through ``_FlashAttentionFn``: its forward is the
same kernel asked also for each row's log-sum-exp ``lse (B, H, S)``
float32 (``m · scale + log l``, ``+inf`` on a row with no admitted key),
it saves ``q, k, v, out, lse``, and its backward runs the hand-written
kernels of ``csrc/flash_attention_backward.cu`` (a ``D = rowsum(dO ∘
out)`` pass, a dK/dV kernel over key tiles and a dQ kernel over query
tiles, no atomics: on the tensor cores for bfloat16, P and dS carried
as two bf16 terms, on the CUDA cores for float32), which return ``dq,
dk, dv`` in the inputs' dtype; a row with no admitted key gets zero gradients.  It
replaces XLA's autodiff of the reference's ``sdpa``
(``src/repro/models/attention.py:142``); the Pallas kernel has no
backward.  Under ``no_grad`` / ``inference_mode``, or with no input
that requires grad (serving), the call is one launch that writes no
``lse`` and saves nothing.  ``flash_attention_with_lse`` and
``flash_attention_backward`` are those two steps on their own, and
``flash_attention_lse_plain`` / ``flash_attention_backward_plain``
their plain versions (for the tests and the smoke script).

Counters.  ``flash_attention.launches`` counts the wrapper calls that
launch the forward kernel (one per call, whichever kernel it runs, with
or without ``lse``); ``flash_attention.backward_launches`` the calls
that launch the backward (one per call, for its three kernels).

``meta`` tensors (the dry run) take the kernels' shape functions: the
outputs, empty, in their shapes and dtypes, counted in
``flash_attention.meta_calls`` / ``meta_backward_calls`` and not as
launches; autograd goes through ``_FlashAttentionFn`` as on the card.
DTensors (a device mesh) go through ``local_map`` (``kernels._mesh``):
q, k and v keep a sharded batch, and their heads where every rank's
query heads read its own kv heads (H and KV both divide the head
shards, or H == KV, as qwen1.5-4b's 20 heads chunk unevenly over 16),
and are replicated otherwise; each rank runs this wrapper on its shard.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels._launch import (DTYPE_CODE, check_aligned,
                                         kernel_device, shape_only)
from repro_torch.kernels._mesh import (head_placements, is_dtensor,
                                       local_call, remap)

__all__ = ["NEG_INF", "Q_CHUNK", "HEAD_DIMS", "WIDTHS", "admitted_pairs",
           "flash_attention",
           "flash_attention_plain", "flash_attention_lse_plain",
           "flash_attention_with_lse", "flash_attention_backward",
           "flash_attention_backward_plain"]

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
# the plain version scores this many query rows at a time, so that its
# (B, KV, G, rows, S) score tensor stays bounded at long prompts
Q_CHUNK = 1024
# head widths the CUDA decode kernels are compiled for
HEAD_DIMS = (32, 64, 128)
# (query/key width, value width) pairs the CUDA prefill kernels are
# compiled for: GQA's, and DeepSeek-V2's MLA (nope 128 + rope 64, v 128)
WIDTHS = tuple((hd, hd) for hd in HEAD_DIMS) + ((192, 128),)


def check_attention_inputs(q: torch.Tensor, *kv: torch.Tensor,
                           cache_dtypes: bool = True) -> None:
    """Raise unless q and the kv tensors share a device and a dtype the
    kernels take, are contiguous, and group the heads evenly.  With
    ``cache_dtypes=False`` only q's dtype is checked (the int8 cache's
    codes and scales have their own)."""
    for t in (q, *kv) if cache_dtypes else (q,):
        if t.dtype not in DTYPE_CODE:
            raise ValueError(f"attention takes float32 or bfloat16, got "
                             f"{t.dtype}")
    if not all(t.is_contiguous() for t in (q, *kv)):
        raise ValueError("attention takes contiguous tensors")
    if cache_dtypes and len({t.dtype for t in (q, *kv)}) != 1:
        raise ValueError(f"q, k and v differ in dtype: "
                         f"{[t.dtype for t in (q, *kv)]}")
    if len({t.device for t in (q, *kv)}) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{[t.device for t in (q, *kv)]}")
    h, kvh = q.shape[-2], kv[0].shape[-2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads do not group evenly over "
                         f"{kvh} kv heads")


def launchable(name: str, hd: int, *tensors: torch.Tensor) -> None:
    """Raise unless the CUDA kernel is compiled for this head width and
    every pointer is 16-byte aligned (its vector loads need it)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"the CUDA {name} is built for head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    check_aligned(name, *tensors)


def _check(q, k, v, causal: bool) -> None:
    if (q.dim() != 4 or k.dim() != 4 or v.dim() != 4
            or k.shape[:3] != v.shape[:3]):
        raise ValueError(f"flash_attention takes q (B,S,H,hd), k "
                         f"(B,S_k,KV,hd) and v (B,S_k,KV,hdv), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, _, hd = q.shape
    if (k.shape[0], k.shape[3]) != (b, hd):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if causal and k.shape[1] != s:
        raise ValueError(f"causal flash_attention takes as many keys as "
                         f"queries, got S {s} and S_k {k.shape[1]}")
    check_attention_inputs(q, k, v)


def admitted_pairs(s: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs a head's mask admits, in closed form: query row
    q admits key t when ``t <= q`` (causal) and ``q - t < window`` (a
    window)."""
    if causal:
        if not window or window >= s:
            return s * (s + 1) // 2
        return window * (window + 1) // 2 + (s - window) * window
    if not window:
        return s * sk
    # row q admits the keys past q - window
    return sum(sk - min(sk, max(0, q - window + 1)) for q in range(s))


def _ops(q, k, v, causal: bool, window: int, per_pair: float) -> float:
    """B3's operation count on these shapes: ``per_pair`` flops a head
    and admitted pair."""
    b, s, h, _ = q.shape
    return per_pair * b * h * admitted_pairs(s, k.shape[1], causal, window)


def _mask(c0: int, n: int, sk: int, causal: bool, window: int,
          device) -> torch.Tensor:
    """The admitted (query row, key) pairs of query rows ``c0 … c0 + n -
    1`` over ``sk`` keys, ``(n, sk)``."""
    pq = torch.arange(c0, c0 + n, device=device)[:, None]
    pk = torch.arange(sk, device=device)[None, :]
    mask = torch.ones(n, sk, dtype=torch.bool, device=device)
    if causal:
        mask &= pk <= pq
    if window:
        mask &= pq - pk < window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The plain torch version, on any device: the Pallas kernel's
    arithmetic in float32 with the whole key axis as one tile."""
    _check(q, k, v, causal)
    b, s, h, hd = q.shape
    sk, kv, hdv = k.shape[1], k.shape[2], v.shape[3]
    g = h // kv
    kf, vf = k.float(), v.float()
    out = q.new_empty(b, s, h, hdv)
    for c0 in range(0, s, Q_CHUNK):
        qc = q[:, c0:c0 + Q_CHUNK].float()
        n = qc.shape[1]
        sc = torch.einsum("bskgh,btkh->bkgst", qc.reshape(b, n, kv, g, hd),
                          kf) * (hd ** -0.5)
        mask = _mask(c0, n, sk, causal, window, q.device)
        sc = torch.where(mask, sc, NEG_INF)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(sc - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.einsum("bkgst,btkh->bkgsh", p, vf)
        o = (acc / (l + 1e-30)).permute(0, 3, 1, 2, 4)
        out[:, c0:c0 + n] = o.reshape(b, n, h, hdv).to(q.dtype)
    return out


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, *,
                              causal: bool = True,
                              window: int = 0) -> torch.Tensor:
    """Each query row's log-sum-exp of its scaled admitted scores, ``(B,
    H, S)`` float32 (``+inf`` on a row with no admitted key): what the
    kernel writes when asked for ``lse``."""
    b, s, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    kf = k.float()
    out = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    for c0 in range(0, s, Q_CHUNK):
        qc = q[:, c0:c0 + Q_CHUNK].float()
        n = qc.shape[1]
        sc = torch.einsum("bskgh,btkh->bkgst", qc.reshape(b, n, kv, g, hd),
                          kf) * (hd ** -0.5)
        mask = _mask(c0, n, sk, causal, window, q.device)
        m = torch.where(mask, sc, NEG_INF).amax(dim=-1)
        l = torch.where(mask, torch.exp(sc - m[..., None]), 0.0).sum(dim=-1)
        lse = torch.where(l > 0, m + torch.log(l), torch.inf)
        out[:, :, c0:c0 + n] = lse.reshape(b, h, n)
    return out


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, out: torch.Tensor,
                                   lse: torch.Tensor, dout: torch.Tensor, *,
                                   causal: bool = True, window: int = 0
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """The plain backward, on any device: the explicit formula in
    float32 from the forward's ``out`` and ``lse`` (``P = exp(s · scale -
    lse)`` under the mask, ``D = rowsum(dO ∘ out)``, ``dS = P ∘ (dO·vᵀ -
    D)``), query rows ``Q_CHUNK`` at a time; returns ``(dq, dk, dv)`` in
    the inputs' dtype.  The tests and the smoke script hold the kernels
    against it."""
    _check(q, k, v, causal)
    b, s, h, hd = q.shape
    sk, kv, hdv = k.shape[1], k.shape[2], v.shape[3]
    g = h // kv
    scale = hd ** -0.5
    kf, vf = k.float(), v.float()
    dq = torch.empty(b, s, h, hd, dtype=torch.float32, device=q.device)
    dk = torch.zeros(b, sk, kv, hd, dtype=torch.float32, device=q.device)
    dv = torch.zeros(b, sk, kv, hdv, dtype=torch.float32, device=q.device)
    for c0 in range(0, s, Q_CHUNK):
        qc = q[:, c0:c0 + Q_CHUNK].float()
        n = qc.shape[1]
        qg = qc.reshape(b, n, kv, g, hd)
        og = out[:, c0:c0 + n].float().reshape(b, n, kv, g, hdv)
        dg = dout[:, c0:c0 + n].float().reshape(b, n, kv, g, hdv)
        lc = lse[:, :, c0:c0 + n].reshape(b, kv, g, n, 1)
        sc = torch.einsum("bskgh,btkh->bkgst", qg, kf) * scale
        mask = _mask(c0, n, sk, causal, window, q.device)
        p = torch.where(mask, torch.exp(sc - lc), 0.0)
        d = (dg * og).sum(dim=-1).permute(0, 2, 3, 1)[..., None]
        ds = p * (torch.einsum("bskgh,btkh->bkgst", dg, vf) - d)
        dv += torch.einsum("bkgst,bskgh->btkh", p, dg)
        dk += torch.einsum("bkgst,bskgh->btkh", ds, qg) * scale
        dq[:, c0:c0 + n] = (torch.einsum("bkgst,btkh->bskgh", ds, kf)
                            * scale).reshape(b, n, h, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _launch(q, k, v, out, causal: bool, window: int, lse=None) -> None:
    from repro_torch.kernels._build import library

    b, s, h, hd = q.shape
    sk, kv, hdv = k.shape[1], k.shape[2], v.shape[3]
    if (hd, hdv) not in WIDTHS:
        raise ValueError(f"the CUDA flash_attention is built for (head_dim, "
                         f"value width) in {WIDTHS}, got {(hd, hdv)}")
    check_aligned("flash_attention", q, k, v, out)
    # grid limits: (B*H, ceil(S/64)) in bf16, (ceil(S/32), H, B) in f32
    if (max(b, h) > 65535 or -(-s // 64) > 65535 or sk >= 1 << 31
            or abs(window) >= 1 << 31):
        raise ValueError(f"shape {tuple(q.shape)} / window {window} too "
                         f"large for one launch")
    fn = library("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 b, s, sk, h, kv, hd, hdv, DTYPE_CODE[q.dtype], hd ** -0.5,
                 int(bool(causal)), int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")


def _launch_backward(q, k, v, out, lse, dout, dq, dk, dv, causal: bool,
                     window: int) -> None:
    from repro_torch.kernels._build import library

    b, s, h, hd = q.shape
    sk, kv, hdv = k.shape[1], k.shape[2], v.shape[3]
    if (hd, hdv) not in WIDTHS:
        raise ValueError(f"the CUDA flash_attention backward is built for "
                         f"(head_dim, value width) in {WIDTHS}, got "
                         f"{(hd, hdv)}")
    check_aligned("flash_attention backward", q, k, v, out, dout, lse, dq,
                  dk, dv)
    if max(b, h) > 65535 or sk >= 1 << 31 or abs(window) >= 1 << 31:
        raise ValueError(f"shape {tuple(q.shape)} / window {window} too "
                         f"large for one launch")
    delta = torch.empty(b * h * s, dtype=torch.float32, device=q.device)
    fn = library("flash_attention_backward").flash_attention_backward_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 b, s, sk, h, kv, hd, hdv, DTYPE_CODE[q.dtype], hd ** -0.5,
                 int(bool(causal)), int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"CUDA error {err}")


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: the forward and its rows' log-sum-exp ``(B, H,
    S)`` float32, from one kernel launch on CUDA tensors, from the plain
    versions on CPU tensors.  No autograd: the saved state of the
    backward."""
    if is_dtensor(q):
        return _on_mesh(q, k, v, causal, window, with_lse=True)
    _check(q, k, v, causal)
    if not kernel_device(q, "flash_attention"):
        return (flash_attention_plain(q, k, v, causal=causal, window=window),
                flash_attention_lse_plain(q, k, causal=causal,
                                          window=window))
    out = q.new_empty(q.shape[:3] + v.shape[3:])
    lse = torch.empty(q.shape[0], q.shape[2], q.shape[1],
                      dtype=torch.float32, device=q.device)
    if not shape_only(flash_attention, q, out, lse,
                      ops=_ops(q, k, v, causal, window,
                               2 * (q.shape[3] + v.shape[3]))):
        _launch(q, k, v, out, causal, window, lse)
        flash_attention.launches += 1
    return out, lse


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, window: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``(dq, dk, dv)`` in the inputs' dtype, from ``out`` and ``lse`` of
    ``flash_attention_with_lse`` and the output's gradient ``dout``: the
    three backward kernels on CUDA tensors (one count of
    ``flash_attention.backward_launches``), the plain version on CPU
    tensors."""
    _check(q, k, v, causal)
    if not kernel_device(q, "flash_attention"):
        return flash_attention_backward_plain(q, k, v, out, lse, dout,
                                              causal=causal, window=window)
    dout = dout.to(q.dtype).contiguous()
    if (out.shape != dout.shape or out.dtype != q.dtype
            or lse.shape != (q.shape[0], q.shape[2], q.shape[1])
            or lse.dtype != torch.float32
            or not (out.is_contiguous() and lse.is_contiguous())):
        raise ValueError(f"flash_attention backward takes out and dout "
                         f"{tuple(q.shape[:3] + v.shape[3:])} in "
                         f"{q.dtype} and a contiguous float32 lse "
                         f"{(q.shape[0], q.shape[2], q.shape[1])}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if not shape_only(flash_attention, q, dq, dk, dv, backward=True,
                      ops=_ops(q, k, v, causal, window,
                               5 * (q.shape[3] + v.shape[3]))):
        _launch_backward(q, k, v, out, lse, dout, dq, dk, dv, causal,
                         window)
        flash_attention.backward_launches += 1
    return dq, dk, dv


class _FlashAttentionFn(torch.autograd.Function):
    """B3 under autograd: the forward kernel with ``lse``, the saved
    ``q, k, v, out, lse``, and the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = flash_attention_with_lse(q, k, v, causal=causal,
                                            window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Prefill attention: q ``(B, S, H, hd)``, k ``(B, S_k, KV, hd)``, v
    ``(B, S_k, KV, hdv)`` → ``(B, S, H, hdv)`` in q's dtype (``S_k ==
    S`` when ``causal``).  The plain version for CPU tensors, which
    autograd differentiates as it is.  On CUDA tensors the kernel: with
    grad enabled and an input that requires grad, through
    ``_FlashAttentionFn`` (the kernel also writes ``lse``, and the
    backward runs the backward kernels); otherwise one launch that saves
    nothing, as serving runs it."""
    if is_dtensor(q):
        return _on_mesh(q, k, v, causal, window, with_lse=False)
    _check(q, k, v, causal)
    if not kernel_device(q, "flash_attention"):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttentionFn.apply(q, k, v, causal, window)
    out = q.new_empty(q.shape[:3] + v.shape[3:])
    if not shape_only(flash_attention, q, out,
                      ops=_ops(q, k, v, causal, window,
                               2 * (q.shape[3] + v.shape[3]))):
        _launch(q, k, v, out, causal, window)
        flash_attention.launches += 1
    return out


def _on_mesh(q, k, v, causal: bool, window: int, with_lse: bool):
    """B3 on DTensors: ``local_map`` over q, k, v placed alike (batch, and
    heads where each rank's query heads read its own kv heads)."""
    h, kv = q.shape[2], k.shape[2]
    pl = head_placements(
        q, 2, lambda n: (h % n == 0 and kv % n == 0) or h == kv)
    if with_lse:
        def fn(a, b, c):
            return flash_attention_with_lse(a, b, c, causal=causal,
                                            window=window)
        outs = (pl, remap(pl, {0: 0, 2: 1}))
        shapes = (q.shape[:3] + v.shape[3:],
                  (q.shape[0], q.shape[2], q.shape[1]))
    else:
        def fn(a, b, c):
            return flash_attention(a, b, c, causal=causal, window=window)
        outs = pl
        shapes = q.shape[:3] + v.shape[3:]
    return local_call(fn, q.device_mesh, (pl, pl, pl), outs, q, k, v,
                      out_shapes=shapes)


flash_attention.launches = 0
flash_attention.backward_launches = 0
flash_attention.meta_calls = 0
flash_attention.meta_backward_calls = 0
