"""Prefill attention of the port's dense transformer: the CUDA kernel
``csrc/flash_attention.cu`` and its plain torch version.

``flash_attention(q, k, v, causal=, window=)`` computes blocked causal /
sliding-window GQA attention for q ``(B, S, H, hd)`` and k, v ``(B, S,
KV, hd)``: query head h reads kv head ``h // (H // KV)``; the softmax
runs in float32 with masked scores ``NEG_INF = -0.7 * f32max`` and
``out = acc / (l + 1e-30)``, so a row with no admitted key is 0; the
output has q's dtype.  It replaces the reference's Pallas kernel
``repro.kernels.flash_attention`` (``_kernel``) and computes what the
reference model's ``sdpa`` computes, except that the reference rounds
the probabilities to bf16 before P·V on bf16 inputs while the kernel,
like the Pallas kernel, keeps them in float32.

The wrapper launches the kernel for CUDA tensors and takes
``flash_attention_plain`` for CPU tensors; it raises on any other
device, on a dtype other than float32 / bfloat16, on non-contiguous or
misaligned inputs and on ``H % KV != 0``.  A failed build or launch
raises: there is no fallback.  ``flash_attention.launches`` counts the
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["NEG_INF", "Q_CHUNK", "HEAD_DIMS", "flash_attention",
           "flash_attention_plain"]

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
# the plain version scores this many query rows at a time, so that its
# (B, KV, G, rows, S) score tensor stays bounded at long prompts
Q_CHUNK = 1024
# head widths the CUDA kernels are compiled for
HEAD_DIMS = (32, 64, 128)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_attention_inputs(q: torch.Tensor, *kv: torch.Tensor) -> None:
    """Raise unless q and the kv tensors share a device and a dtype the
    kernels take, are contiguous, and group the heads evenly."""
    for t in (q, *kv):
        if t.dtype not in DTYPE_CODE:
            raise ValueError(f"attention takes float32 or bfloat16, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError("attention takes contiguous tensors")
    if len({t.dtype for t in (q, *kv)}) != 1:
        raise ValueError(f"q, k and v differ in dtype: "
                         f"{[t.dtype for t in (q, *kv)]}")
    if len({t.device for t in (q, *kv)}) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{[t.device for t in (q, *kv)]}")
    h, kvh = q.shape[-2], kv[0].shape[-2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads do not group evenly over "
                         f"{kvh} kv heads")


def kernel_device(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (take the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on CUDA (kernel) or CPU (plain "
                     f"version), got device {t.device}")


def launchable(name: str, hd: int, *tensors: torch.Tensor) -> None:
    """Raise unless the CUDA kernel is compiled for this head width and
    every pointer is 16-byte aligned (its vector loads need it)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"the CUDA {name} is built for head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"the CUDA {name} needs 16-byte aligned "
                             f"tensors")


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B,S,H,hd) and k, v "
                         f"(B,S,KV,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, _, hd = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, hd):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    check_attention_inputs(q, k, v)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The plain torch version, on any device: the Pallas kernel's
    arithmetic in float32 with the whole key axis as one tile."""
    _check(q, k, v)
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    kf, vf = k.float(), v.float()
    pos = torch.arange(s, device=q.device)
    out = torch.empty_like(q)
    for c0 in range(0, s, Q_CHUNK):
        qc = q[:, c0:c0 + Q_CHUNK].float()
        n = qc.shape[1]
        sc = torch.einsum("bskgh,btkh->bkgst", qc.reshape(b, n, kv, g, hd),
                          kf) * (hd ** -0.5)
        pq = pos[c0:c0 + n, None]
        pk = pos[None, :]
        mask = torch.ones(n, s, dtype=torch.bool, device=q.device)
        if causal:
            mask &= pk <= pq
        if window:
            mask &= pq - pk < window
        sc = torch.where(mask, sc, NEG_INF)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(sc - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.einsum("bkgst,btkh->bkgsh", p, vf)
        o = (acc / (l + 1e-30)).permute(0, 3, 1, 2, 4)
        out[:, c0:c0 + n] = o.reshape(b, n, h, hd).to(q.dtype)
    return out


def _launch(q, k, v, out, causal: bool, window: int) -> None:
    from repro_torch.kernels._build import library

    b, s, h, hd = q.shape
    kv = k.shape[2]
    launchable("flash_attention", hd, q, k, v, out)
    if max(b, h) > 65535 or s >= 1 << 31 or abs(window) >= 1 << 31:
        raise ValueError(f"shape {tuple(q.shape)} / window {window} too "
                         f"large for one launch")
    fn = library("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, h, kv, hd, DTYPE_CODE[q.dtype], hd ** -0.5,
                 int(bool(causal)), int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Prefill attention: q ``(B, S, H, hd)``, k/v ``(B, S, KV, hd)`` →
    ``(B, S, H, hd)`` in q's dtype.  The CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    _check(q, k, v)
    if not kernel_device(q, "flash_attention"):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    out = torch.empty_like(q)
    _launch(q, k, v, out, causal, window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
