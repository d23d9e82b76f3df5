"""Superstep histogram update of the port's sweep: a CUDA kernel and its
plain torch version.

The sweep bins the job latencies of each 32-step block once per block.
``hist_update`` takes the stacked block of every point at once —
``lats``/``inc`` of shape ``(P, R, W)`` — and adds it into the
``(P, n_bins)`` histogram rows (and, in sketch mode, the per-bin
latency sums), in place.  It replaces the reference's
``repro.kernels.superstep.hist_update`` (Pallas ``_hist_body``), which
runs per point under ``vmap``.

Backends:

- ``"cuda"``: the hand-written kernel ``csrc/hist_update.cu``, one
  launch over all points, on the current stream, no synchronisation.
  It takes CUDA tensors only.
- ``"torch"``: ``hist_update_plain`` — ``bit_bins`` plus
  ``scatter_add_`` — for CPU tensors only.

``"auto"`` (or ``None``) reads ``REPRO_TORCH_SUPERSTEP_BACKEND`` and
otherwise picks by the tensors' device.  A CUDA tensor never reaches the
plain version through the wrapper, and a failed build or launch raises.
``hist_update_plain`` is public so that a check on the card can hold the
kernel against it on the same inputs.

Counts are integer adds, so the two backends agree bit for bit; the
sketch sums agree to within a float32 rounding (see ``engine
.scatter_hist_sums``).
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import engine
from repro_torch.core import hist as hist_mod

__all__ = ["BACKENDS", "ENV_VAR", "resolve_backend", "hist_update",
           "hist_update_plain"]

BACKENDS = ("auto", "torch", "cuda")
ENV_VAR = "REPRO_TORCH_SUPERSTEP_BACKEND"

_SMEM_LIMIT = 48 * 1024    # shared memory a launch gets without opting in


def resolve_backend(backend: Optional[str], device) -> str:
    """``"torch"`` or ``"cuda"`` for tensors on ``device``.

    ``None``/``"auto"`` consults ``REPRO_TORCH_SUPERSTEP_BACKEND``,
    then the device: ``"cuda"`` for CUDA, ``"torch"`` for the CPU.  A
    backend that cannot take tensors on ``device`` raises."""
    b = "auto" if backend is None else str(backend)
    if b == "auto":
        b = os.environ.get(ENV_VAR, "auto")
    dev = torch.device(device).type
    if b == "auto":
        b = "cuda" if dev == "cuda" else "torch"
    if b not in ("torch", "cuda"):
        raise ValueError(f"unknown superstep backend {b!r}; pick from "
                         f"{BACKENDS} (or set {ENV_VAR})")
    if b == "cuda" and dev != "cuda":
        raise ValueError(f"superstep backend 'cuda' needs CUDA tensors, "
                         f"got device {dev!r}")
    if b == "torch" and dev != "cpu":
        raise ValueError(f"superstep backend 'torch' is the plain version "
                         f"for CPU tensors; tensors on {dev!r} take the "
                         f"'cuda' kernel")
    return b


def _check(hists: Sequence[torch.Tensor], lats: torch.Tensor,
           inc: torch.Tensor, n_bins: int, sketch: bool) -> None:
    if lats.dim() != 3 or lats.dtype != torch.float32:
        raise ValueError(f"lats must be float32 (P, R, W), got "
                         f"{lats.dtype} {tuple(lats.shape)}")
    if inc.shape != lats.shape or inc.dtype != torch.bool:
        raise ValueError(f"inc must be bool of lats' shape "
                         f"{tuple(lats.shape)}, got {inc.dtype} "
                         f"{tuple(inc.shape)}")
    if sketch and n_bins != hist_mod.SKETCH_BINS:
        raise ValueError(f"sketch mode has {hist_mod.SKETCH_BINS} bins, "
                         f"got n_bins={n_bins}")
    want = 2 if sketch else 1
    if len(hists) != want:
        raise ValueError(f"{'sketch' if sketch else 'full'} mode takes "
                         f"{want} accumulator(s), got {len(hists)}")
    shape = (lats.shape[0], n_bins)
    for h, dt in zip(hists, (torch.int32, torch.float32)):
        if tuple(h.shape) != shape or h.dtype != dt:
            raise ValueError(f"accumulator must be {dt} {shape}, got "
                             f"{h.dtype} {tuple(h.shape)}")
    devices = {t.device for t in (lats, inc, *hists)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")


def hist_update_plain(hists: Sequence[torch.Tensor], lats: torch.Tensor,
                      inc: torch.Tensor, *, n_bins: int,
                      sketch: bool = False) -> Tuple[torch.Tensor, ...]:
    """The plain torch version of the kernel, on any device: bin by bit
    pattern, scatter-add the counts (and sums) into the rows in place.
    Returns ``hists``."""
    _check(hists, lats, inc, n_bins, sketch)
    bins = hist_mod.bit_bins(lats, n_bins, sketch)
    engine.scatter_hist(hists[0], bins, inc)
    if sketch:
        engine.scatter_hist_sums(hists[1], bins, inc, lats)
    return tuple(hists)


def _launch_cuda(hists, lats, inc, n_bins: int, sketch: bool) -> None:
    from repro_torch.kernels._build import library

    for t in (lats, inc, *hists):
        if not t.is_contiguous():
            raise ValueError("the CUDA hist_update takes contiguous "
                             "tensors")
    p, r, w = lats.shape
    per_point = r * w
    if per_point % 16 or inc.data_ptr() % 16:
        raise ValueError(f"the CUDA hist_update reads the mask 16 bytes "
                         f"at a time: R*W must be a multiple of 16 (got "
                         f"{per_point}) and the mask 16-byte aligned")
    if p >= 1 << 31:
        raise ValueError(f"too many points for one launch: {p}")
    if n_bins * (4 + (8 if sketch else 0)) > _SMEM_LIMIT:
        raise ValueError(f"n_bins={n_bins} exceeds the kernel's shared "
                         f"memory")
    lib = library("hist_update")
    fn = lib.hist_update_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    shift, base, _ = hist_mod.bin_params(sketch)
    stream = torch.cuda.current_stream(lats.device).cuda_stream
    with torch.cuda.device(lats.device):
        err = fn(lats.data_ptr(), inc.data_ptr(), hists[0].data_ptr(),
                 hists[1].data_ptr() if sketch else None, p, per_point,
                 n_bins, shift, base, stream)
    if err != 0:
        raise RuntimeError(f"hist_update kernel launch failed: CUDA "
                           f"error {err}")


def hist_update(hists: Sequence[torch.Tensor], lats: torch.Tensor,
                inc: torch.Tensor, *, n_bins: int, backend: str,
                sketch: bool = False) -> Tuple[torch.Tensor, ...]:
    """Per-superstep histogram update of every point, in place.

    ``hists`` is ``(counts,)`` or, in sketch mode, ``(counts, sums)``,
    each ``(P, n_bins)`` (int32, float32); ``lats``/``inc`` are the
    ``(P, R, W)`` float32/bool block.  ``backend`` is resolved by
    ``resolve_backend`` against the tensors' device.  Returns
    ``hists``.  ``hist_update.launches`` counts the kernel launches."""
    if resolve_backend(backend, lats.device) == "torch":
        return hist_update_plain(hists, lats, inc, n_bins=n_bins,
                                 sketch=sketch)
    _check(hists, lats, inc, n_bins, sketch)
    _launch_cuda(hists, lats, inc, n_bins, sketch)
    hist_update.launches += 1
    return tuple(hists)


hist_update.launches = 0
