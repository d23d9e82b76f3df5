"""Superstep kernels of the port's Monte Carlo sweeps: two CUDA kernels
and their plain torch versions.

The sweeps amortise their whole-block work to one call per superstep:

- ``hist_update`` bins the job latencies of a superstep block once per
  block.  It takes the stacked block of every point at once —
  ``lats``/``inc`` of shape ``(P, R, W)``, any ``R*W`` — and adds it
  into the ``(P, n_bins)`` histogram rows (and, in sketch mode, the
  per-bin latency sums), in place.  It replaces the reference's
  ``repro.kernels.superstep.hist_update`` (Pallas ``_hist_body``),
  which runs per point under ``vmap``.
- ``fifo_compact`` re-compacts the generate sweep's tail-pointer FIFO
  buffers to ``head = 0`` with the clock rebase folded in:
  ``out[p, i] = buf[p, k[p] + i] - now[p]``, and ``0 - now[p]`` past
  the end.  It replaces the reference's ``fifo_compact`` (Pallas
  ``_compact_body``) and writes out of place, into a second buffer the
  caller allocates once and swaps with ``buf``.

Backends (the same for both):

- ``"cuda"``: the hand-written kernels ``csrc/hist_update.cu`` and
  ``csrc/fifo_compact.cu``, one launch over all points, on the current
  stream, no synchronisation.  They take CUDA tensors only.  How a
  launch is cut (warps per point, shared memory, vector or scalar
  loads) is ``hist_update_plan`` / ``fifo_compact_plan``, plain Python
  on shapes and pointers.
- ``"torch"``: ``hist_update_plain`` (``bit_bins`` plus
  ``scatter_add_``) and ``fifo_compact_plain`` (``engine.fifo_pop_shift``
  minus ``now``), for CPU tensors only.

``"auto"`` (or ``None``) reads ``REPRO_TORCH_SUPERSTEP_BACKEND`` and
otherwise picks by the tensors' device.  A CUDA tensor never reaches a
plain version through a wrapper, and a failed build or launch raises.
The plain versions are public so that a check on the card can hold each
kernel against its plain version on the same inputs.

Counts are integer adds and the compaction is one float32 subtraction
per element, so the two backends agree bit for bit; the sketch sums
agree to within a float32 rounding (see ``engine.scatter_hist_sums``).
Each wrapper counts its kernel launches in ``<wrapper>.launches``.

``hist_update_min_bytes`` counts the bytes any implementation of the
histogram update must move on a given block, at the card's 32-byte
sector granularity: the bound a kernel time is held against.
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import engine
from repro_torch.core import hist as hist_mod

__all__ = ["BACKENDS", "ENV_VAR", "resolve_backend", "hist_update",
           "hist_update_plain", "hist_update_plan", "hist_update_min_bytes",
           "HistPlan", "WARP_POINTS_COEF", "fifo_compact",
           "fifo_compact_plain", "fifo_compact_plan", "CompactPlan"]

BACKENDS = ("auto", "torch", "cuda")
ENV_VAR = "REPRO_TORCH_SUPERSTEP_BACKEND"

_SMEM_LIMIT = 48 * 1024    # shared memory a launch gets without opting in
_SECTOR = 32               # bytes the card's memory moves at a time
# hist_update: a launch over P points of E entries each gives each point
# one warp (a block holds 8) when P >= WARP_POINTS_COEF * sqrt(E), else
# a block of 8 warps, so that a small grid still spreads over the card.
# On the H100 the two cross near there on the paths' own blocks, from
# about 700 points at 768 entries a point to 3,900 at 24,576
# (tools/ablate_torch_superstep.py, PERF.md)
WARP_POINTS_COEF = 28


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


class HistPlan(NamedTuple):
    """How one ``hist_update`` launch is cut."""
    warps_per_point: int     # 1 (a warp a point) or 8 (a block a point)
    points_per_block: int    # points sharing a block
    threads: int             # threads a block
    blocks: int
    smem_bytes: int          # dynamic shared memory a block
    vec_loads: bool          # mask words + float4 latencies
    vec_rows: bool           # 16-byte flush of the histogram rows


def hist_update_plan(n_points: int, per_point: int, n_bins: int, *,
                     sketch: bool = False, lats_ptr: int = 0,
                     inc_ptr: int = 0,
                     row_ptrs: Sequence[int] = (0,)) -> HistPlan:
    """The launch of ``hist_update`` on ``n_points`` points of
    ``per_point`` entries each, from the shapes and the tensors' data
    pointers alone.  Raises when a point's slice does not fit the shared
    memory a launch gets without opting in."""
    many = n_points * n_points >= WARP_POINTS_COEF ** 2 * per_point
    warps_per_point = 1 if many else 8
    slice_bytes = n_bins * (4 + (8 if sketch else 0))
    ppb = min(8 // warps_per_point, _SMEM_LIMIT // slice_bytes)
    if ppb < 1:
        raise ValueError(f"n_bins={n_bins} exceeds the kernel's shared "
                         f"memory")
    # the vector loop pairs 4-aligned mask words with 16-aligned float4s
    # of latencies: both hold on every row when the bases agree mod 4
    # entries
    vec_loads = lats_ptr % 4 == 0 and (lats_ptr // 4 - inc_ptr) % 4 == 0
    vec_rows = n_bins % 4 == 0 and all(q % 16 == 0 for q in row_ptrs)
    return HistPlan(warps_per_point, ppb, 32 * warps_per_point * ppb,
                    -(-n_points // ppb), ppb * slice_bytes, vec_loads,
                    vec_rows)


def _sectors(t: torch.Tensor, flat_idx: torch.Tensor) -> int:
    """How many 32-byte sectors of ``t``'s memory hold the elements at
    ``flat_idx``."""
    first = t.data_ptr() % _SECTOR
    n = -(-(first + t.numel() * t.element_size()) // _SECTOR)
    hit = torch.zeros(n, dtype=torch.bool, device=t.device)
    hit[(first + flat_idx * t.element_size()) // _SECTOR] = True
    return int(hit.sum())


def hist_update_min_bytes(hists: Sequence[torch.Tensor], lats: torch.Tensor,
                          inc: torch.Tensor, *, n_bins: int,
                          sketch: bool = False) -> int:
    """The bytes any implementation of the update must move on this
    block, at 32-byte sector granularity: the whole mask, every sector of
    latencies holding an included entry, and every sector of the rows
    (counts, and sums in sketch mode) whose bins receive a count, read
    once and written once."""
    _check(hists, lats, inc, n_bins, sketch)
    p = lats.shape[0]
    per_point = lats[0].numel() if p else 0
    idx = inc.reshape(-1).nonzero().squeeze(1)
    bins = hist_mod.bit_bins(lats.reshape(-1)[idx], n_bins, sketch).long()
    cells = (idx // max(per_point, 1)) * n_bins + bins
    rows = sum(2 * _SECTOR * _sectors(h, cells) for h in hists)
    return inc.numel() + _SECTOR * _sectors(lats, idx) + rows


def _launch_cuda(hists, lats, inc, n_bins: int, sketch: bool) -> None:
    from repro_torch.kernels._build import library

    for t in (lats, inc, *hists):
        if not t.is_contiguous():
            raise ValueError("the CUDA hist_update takes contiguous "
                             "tensors")
    p, r, w = lats.shape
    if p >= 1 << 31:
        raise ValueError(f"too many points for one launch: {p}")
    plan = hist_update_plan(p, r * w, n_bins, sketch=sketch,
                            lats_ptr=lats.data_ptr(), inc_ptr=inc.data_ptr(),
                            row_ptrs=[h.data_ptr() for h in hists])
    lib = library("hist_update")
    fn = lib.hist_update_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    shift, base, _ = hist_mod.bin_params(sketch)
    stream = torch.cuda.current_stream(lats.device).cuda_stream
    with torch.cuda.device(lats.device):
        err = fn(lats.data_ptr(), inc.data_ptr(), hists[0].data_ptr(),
                 hists[1].data_ptr() if sketch else None, p, r * w,
                 n_bins, shift, base, plan.warps_per_point,
                 plan.points_per_block, plan.smem_bytes,
                 int(plan.vec_loads), int(plan.vec_rows), stream)
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


def _check_compact(buf: torch.Tensor, k: torch.Tensor, now: torch.Tensor,
                   out: torch.Tensor) -> None:
    if buf.dim() != 2 or buf.dtype != torch.float32:
        raise ValueError(f"buf must be float32 (P, n), got {buf.dtype} "
                         f"{tuple(buf.shape)}")
    p = buf.shape[0]
    if tuple(k.shape) != (p,) or k.dtype != torch.int32:
        raise ValueError(f"k must be int32 ({p},), got {k.dtype} "
                         f"{tuple(k.shape)}")
    if tuple(now.shape) != (p,) or now.dtype != torch.float32:
        raise ValueError(f"now must be float32 ({p},), got {now.dtype} "
                         f"{tuple(now.shape)}")
    if out.shape != buf.shape or out.dtype != buf.dtype:
        raise ValueError(f"out must be float32 {tuple(buf.shape)}, "
                         f"got {out.dtype} {tuple(out.shape)}")
    # in place is a race on the card: one thread reads buf[i + k] while
    # another writes buf[i + k] as its own output
    if out.data_ptr() == buf.data_ptr():
        raise ValueError("fifo_compact writes out of place: out must "
                         "not be buf")
    devices = {t.device for t in (buf, k, now, out)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")


def fifo_compact_plain(buf: torch.Tensor, k: torch.Tensor,
                       now: torch.Tensor, *,
                       out: torch.Tensor) -> torch.Tensor:
    """The plain torch version of the compaction kernel, on any device:
    ``engine.fifo_pop_shift(buf, k, n) - now[:, None]`` (``0 <= k <=
    n``), written into ``out``.  Returns ``out``."""
    _check_compact(buf, k, now, out)
    vals = engine.fifo_pop_shift(buf, k, buf.shape[1])
    return torch.sub(vals, now.unsqueeze(1), out=out)


class CompactPlan(NamedTuple):
    """How one ``fifo_compact`` launch is cut."""
    rows_per_block: int      # one warp a row
    threads: int
    blocks: int
    vec: bool                # float4 stores (buf and out 16-byte aligned)


def fifo_compact_plan(n_rows: int, n: int, *, buf_ptr: int = 0,
                      out_ptr: int = 0) -> CompactPlan:
    """The launch of ``fifo_compact`` on ``n_rows`` rows of ``n``
    floats, from the shape and the two buffers' data pointers."""
    return CompactPlan(8, 256, -(-n_rows // 8),
                       buf_ptr % 16 == 0 and out_ptr % 16 == 0)


def _launch_compact(buf, k, now, out) -> None:
    from repro_torch.kernels._build import library

    for t in (buf, k, now, out):
        if not t.is_contiguous():
            raise ValueError("the CUDA fifo_compact takes contiguous "
                             "tensors")
    p, n = buf.shape
    if p >= 1 << 31 or n >= 1 << 31:
        raise ValueError(f"buffer too large for one launch: {p} x {n}")
    plan = fifo_compact_plan(p, n, buf_ptr=buf.data_ptr(),
                             out_ptr=out.data_ptr())
    lib = library("fifo_compact")
    fn = lib.fifo_compact_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    with torch.cuda.device(buf.device):
        err = fn(buf.data_ptr(), k.data_ptr(), now.data_ptr(),
                 out.data_ptr(), p, n, int(plan.vec), stream)
    if err != 0:
        raise RuntimeError(f"fifo_compact kernel launch failed: CUDA "
                           f"error {err}")


def fifo_compact(buf: torch.Tensor, k: torch.Tensor, now: torch.Tensor, *,
                 backend: str, out: torch.Tensor) -> torch.Tensor:
    """Per-superstep FIFO re-compaction with the clock rebase folded in,
    for every point at once: ``out[p, i] = buf[p, k[p] + i] - now[p]``
    (``0 - now[p]`` where ``k[p] + i >= n``), for ``buf`` float32
    ``(P, n)``, ``k`` int32 ``(P,)`` in ``[0, n]`` and ``now`` float32
    ``(P,)``.  Out of place: into ``out``, never ``buf`` itself.
    ``backend`` is resolved by ``resolve_backend`` against the tensors'
    device.  Returns ``out``; ``fifo_compact.launches`` counts the
    kernel launches."""
    if resolve_backend(backend, buf.device) == "torch":
        return fifo_compact_plain(buf, k, now, out=out)
    _check_compact(buf, k, now, out)
    _launch_compact(buf, k, now, out)
    fifo_compact.launches += 1
    return out


fifo_compact.launches = 0
