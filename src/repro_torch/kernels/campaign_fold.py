"""The campaign's chunk fold: a CUDA kernel and its plain torch version.

A campaign (``repro_torch.core.campaign``) streams a grid through a
sweep in fixed-size chunks and folds each chunk's per-point outputs
into one campaign accumulator on the card.  The fold is a sequential
left fold of the chunk's ``m`` rows, in global point order, into:

- the merged histogram ``hist`` (int64) and, in sketch mode, its
  per-bin latency sums ``hist_sums`` (float64);
- the counters ``points``, ``jobs``, ``batches``, ``buffer_dropped``,
  the loss counters and ``quarantined_points`` (int64);
- the float64 sums ``sum_latency_jobs``, ``sum_latency``, ``sum_util``
  and ``sum_batch``;
- ``max_ci``, the largest per-point 95% batch-means half-width;
- the top-K worst mean latencies and best goodput rates with their
  global indices: a point replaces the *first* minimal slot, on a
  strict improvement only, so the earliest index wins ties.

A point whose float statistics hold a NaN or an infinity is masked out
of every sum and counted in ``quarantined_points``; padded tail lanes
(``i >= n_valid``) fold as identities.  The reference computes the same
fold as a jitted ``lax.scan`` (``repro.core.campaign._build_fold``);
no TPU kernel of the reference corresponds to it.

Why the order matters: a campaign's accumulator must be bitwise the
same whatever the chunk size, so the float64 additions and the top-K
replacements run in exactly the global point order.  Integer counts
and the max are exact in any order.

Backends:

- the CUDA kernels ``csrc/campaign_fold.cu`` (CUDA tensors): one call
  a chunk, in place on the accumulator, on the current stream, no
  synchronisation: a wide pass that prepares every row into a workspace
  kept per device, then the ordered tail (the float64 chains and the
  top-K walks) beside the histogram counts; any ``k_top >= 1``: lists
  of up to 1,908 slots are walked in shared memory, longer ones in the
  accumulator's own slots, in the same order;
- ``campaign_fold_plain`` (any device; the wrapper takes it for CPU
  tensors): the integer fields and the max vectorised, ``hist_sums`` in
  a loop over points vectorised over bins, and the scalar sums and the
  top-K lists in a loop over points in Python floats, which are IEEE
  binary64 with the kernel's rounding.

``campaign_fold.launches`` counts the wrapper calls that launch the
kernels, one a chunk.

The accumulator lives in two flat tensors, ``FoldAcc.ints`` (int64)
and ``FoldAcc.floats`` (float64), in the layout the kernel reads;
``FoldAcc.views()`` names its fields as the reference's dict does.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["FoldAcc", "ACC_INT", "ACC_F64", "SUMMARY_KEYS", "Z95",
           "campaign_fold", "campaign_fold_plain", "chain_floor",
           "fold_min_bytes",
           "summary_dict"]

# the accumulator's scalar fields, in the reference's order
ACC_INT = ("points", "jobs", "batches", "buffer_dropped",
           "overflow_dropped", "abandoned", "n_in_slo", "n_fresh",
           "n_retry", "quarantined_points")
ACC_F64 = ("sum_latency_jobs", "sum_latency", "sum_util", "sum_batch")
LOSS_KEYS = ("overflow_dropped", "abandoned", "n_in_slo", "n_fresh",
             "n_retry")
# the per-chunk summary the fold returns (int64), in the reference's
# order; the last two only on loss grids
SUMMARY_KEYS = ("points", "jobs", "buffer_dropped", "quarantined",
                "overflow_dropped", "abandoned")
# two-sided 95% normal quantile (repro_torch.core.variance.Z95)
Z95 = 1.959963984540054

# per device: the kernels' row workspace (bytes), and chain_floor's
# operands
_WORK: Dict[torch.device, torch.Tensor] = {}
_CHAIN: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


class FoldAcc:
    """The campaign accumulator on a device: ``ints`` holds ``hist``,
    the ``ACC_INT`` counters, ``top_lat_idx`` and ``top_good_idx``;
    ``floats`` holds ``hist_sums``, the ``ACC_F64`` sums, ``max_ci``,
    ``top_lat_val`` and ``top_good_val``, each in that order."""

    def __init__(self, ints: torch.Tensor, floats: torch.Tensor,
                 n_bins: int, k_top: int) -> None:
        self.ints, self.floats = ints, floats
        self.n_bins, self.k_top = int(n_bins), int(k_top)

    def _slices(self) -> List[Tuple[str, str, slice, bool]]:
        nb, k = self.n_bins, self.k_top
        out = [("hist", "i", slice(0, nb), False),
               ("hist_sums", "f", slice(0, nb), False)]
        for j, key in enumerate(ACC_INT):
            out.append((key, "i", slice(nb + j, nb + j + 1), True))
        for j, key in enumerate(ACC_F64 + ("max_ci",)):
            out.append((key, "f", slice(nb + j, nb + j + 1), True))
        i0, f0 = nb + len(ACC_INT), nb + len(ACC_F64) + 1
        out += [("top_lat_val", "f", slice(f0, f0 + k), False),
                ("top_lat_idx", "i", slice(i0, i0 + k), False),
                ("top_good_val", "f", slice(f0 + k, f0 + 2 * k), False),
                ("top_good_idx", "i", slice(i0 + k, i0 + 2 * k), False)]
        return out

    def views(self) -> Dict[str, torch.Tensor]:
        """The fields as views into the two flat tensors (scalars 0-d)."""
        out = {}
        for key, kind, sl, scalar in self._slices():
            t = (self.ints if kind == "i" else self.floats)[sl]
            out[key] = t.reshape(()) if scalar else t
        return out

    @classmethod
    def from_host(cls, acc: Dict[str, np.ndarray], device) -> "FoldAcc":
        """Pack a reference-layout numpy accumulator onto ``device``."""
        n_bins, k_top = acc["hist"].shape[0], acc["top_lat_val"].shape[0]
        shell = cls(torch.zeros(0), torch.zeros(0), n_bins, k_top)
        ints, floats = [], []
        for key, kind, _, _ in shell._slices():
            a = np.asarray(acc[key]).reshape(-1)
            (ints if kind == "i" else floats).append(a)
        return cls(torch.as_tensor(np.concatenate(ints).astype(np.int64),
                                   device=device),
                   torch.as_tensor(np.concatenate(floats)
                                   .astype(np.float64), device=device),
                   n_bins, k_top)

    def unpack(self, ints: np.ndarray, floats: np.ndarray
               ) -> Dict[str, np.ndarray]:
        """Host copies of ``ints`` / ``floats`` → the reference-layout
        numpy accumulator (0-d arrays for the scalars)."""
        out = {}
        for key, kind, sl, scalar in self._slices():
            a = np.array((ints if kind == "i" else floats)[sl])
            out[key] = a.reshape(()) if scalar else a
        return out

    def to_host(self) -> Dict[str, np.ndarray]:
        return self.unpack(self.ints.cpu().numpy(),
                           self.floats.cpu().numpy())


def _summary_keys(has_loss: bool) -> Tuple[str, ...]:
    return SUMMARY_KEYS if has_loss else SUMMARY_KEYS[:4]


_F32 = ("mean_latency", "utilization", "mean_batch", "lam", "lat_bm_m2")
_I32 = ("hist", "n_jobs", "batches", "dropped", "lat_bm_n")


def _check(acc: FoldAcc, chunk: Dict[str, torch.Tensor], gidx, n_valid,
           has_loss: bool, sketch: bool) -> int:
    m = chunk["hist"].shape[0]
    if chunk["hist"].shape != (m, acc.n_bins):
        raise ValueError(f"hist must be ({m}, {acc.n_bins}), got "
                         f"{tuple(chunk['hist'].shape)}")
    need = list(_F32 + _I32) + (["hist_sums"] if sketch else [])
    need += list(LOSS_KEYS) if has_loss else []
    for key in need:
        t = chunk.get(key)
        if t is None:
            raise ValueError(f"chunk lacks {key!r}")
        want = (torch.float32 if key in _F32 or key == "hist_sums"
                else torch.int32)
        shape = (m, acc.n_bins) if key in ("hist", "hist_sums") else (m,)
        if t.dtype != want or tuple(t.shape) != shape:
            raise ValueError(f"chunk[{key!r}] must be {want} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if gidx.dtype != torch.int64 or tuple(gidx.shape) != (m,):
        raise ValueError(f"gidx must be int64 ({m},), got {gidx.dtype} "
                         f"{tuple(gidx.shape)}")
    if not 0 <= int(n_valid) <= m:
        raise ValueError(f"n_valid {n_valid} outside [0, {m}]")
    if acc.k_top < 1:
        raise ValueError("the fold keeps at least one top-K slot")
    devices = {t.device for t in (gidx, acc.ints, acc.floats,
                                  *(chunk[k] for k in need))}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    return m


def campaign_fold_plain(acc: FoldAcc, chunk: Dict[str, torch.Tensor],
                        gidx: torch.Tensor, n_valid: int, *,
                        has_loss: bool, sketch: bool) -> torch.Tensor:
    """The plain version of the fold, on any device: updates ``acc`` in
    place and returns the chunk's int64 summary (``SUMMARY_KEYS``, the
    loss pair on loss grids only)."""
    m = _check(acc, chunk, gidx, n_valid, has_loss, sketch)
    f64, i64 = torch.float64, torch.int64
    dev = acc.ints.device
    a = acc.views()
    valid = torch.arange(m, device=dev) < int(n_valid)
    lat, util, batch, lam, m2 = (chunk[k].to(f64) for k in _F32)
    finite = (torch.isfinite(lat) & torch.isfinite(util)
              & torch.isfinite(batch) & torch.isfinite(lam)
              & torch.isfinite(m2))
    if sketch:
        finite &= torch.isfinite(chunk["hist_sums"]).all(1)
    ok = valid & finite
    w = ok.to(i64)

    # integer fields: exact in any order
    jobs = chunk["n_jobs"].to(i64)
    summary = [w.sum(), (jobs * w).sum(),
               (chunk["dropped"].to(i64) * w).sum(),
               (valid & ~finite).to(i64).sum()]
    a["quarantined_points"] += summary[3]
    a["hist"] += (chunk["hist"].to(i64) * w.unsqueeze(1)).sum(0)
    a["points"] += summary[0]
    a["jobs"] += summary[1]
    a["batches"] += (chunk["batches"].to(i64) * w).sum()
    a["buffer_dropped"] += summary[2]
    if has_loss:
        for key in LOSS_KEYS:
            a[key] += (chunk[key].to(i64) * w).sum()
        summary += [(chunk[k].to(i64) * w).sum()
                    for k in ("overflow_dropped", "abandoned")]
    else:
        # loss-free: every measured job completes in SLO
        a["n_in_slo"] += summary[1]
        a["n_fresh"] += summary[1]

    # max_ci: the max is exact in any order (NaN propagates)
    nb = chunk["lat_bm_n"].to(f64)
    ci = Z95 * torch.sqrt(m2 / torch.clamp(nb - 1.0, min=1.0)
                          / torch.clamp(nb, min=1.0))
    ci = torch.where(ok & (nb >= 2.0), ci, 0.0)
    if m:
        a["max_ci"].copy_(torch.maximum(a["max_ci"], ci.max()))

    # hist_sums: one point at a time, vectorised over bins
    if sketch:
        rows = torch.where(ok.unsqueeze(1), chunk["hist_sums"].to(f64), 0.0)
        for i in range(m):
            a["hist_sums"] += rows[i]

    # the scalar sums and the top-K lists: one point at a time
    okl = ok.tolist()
    latl = torch.where(ok, lat, 0.0).tolist()
    utill = torch.where(ok, util, 0.0).tolist()
    batchl = torch.where(ok, batch, 0.0).tolist()
    jobsl = jobs.to(f64).tolist()
    if has_loss:
        offered = (jobs + chunk["overflow_dropped"].to(i64)
                   + chunk["abandoned"].to(i64)).tolist()
        slo = chunk["n_in_slo"].to(f64).tolist()
        goodl = [lm * (s / float(max(o, 1)) if o > 0 else 1.0)
                 for lm, s, o in zip(lam.tolist(), slo, offered)]
    else:
        goodl = [lm * 1.0 for lm in lam.tolist()]
    gl = gidx.tolist()
    sums = [float(a[k]) for k in ACC_F64]
    tops = [(a["top_lat_val"].tolist(), a["top_lat_idx"].tolist(), latl),
            (a["top_good_val"].tolist(), a["top_good_idx"].tolist(), goodl)]
    for i in range(m):
        wf = 1.0 if okl[i] else 0.0
        sums[0] = sums[0] + latl[i] * jobsl[i] * wf
        sums[1] = sums[1] + latl[i] * wf
        sums[2] = sums[2] + utill[i] * wf
        sums[3] = sums[3] + batchl[i] * wf
        if okl[i]:
            for vals, idxs, v in tops:
                am = min(range(len(vals)), key=vals.__getitem__)
                if v[i] > vals[am]:
                    vals[am], idxs[am] = v[i], gl[i]
    for key, s in zip(ACC_F64, sums):
        a[key].fill_(s)
    for (vals, idxs, _), name in zip(tops, ("lat", "good")):
        a[f"top_{name}_val"].copy_(torch.tensor(vals, dtype=f64))
        a[f"top_{name}_idx"].copy_(torch.tensor(idxs, dtype=i64))
    return torch.stack(summary)


class _FoldArgs(ctypes.Structure):
    """``FoldArgs`` of csrc/campaign_fold.cu, field for field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "hist", "hist_sums", "n_jobs", "batches", "dropped", "lat", "util",
        "batch", "lam", "bm_m2", "bm_n", "overflow", "abandoned", "in_slo",
        "fresh", "retry", "gidx", "ints", "floats", "summary")] + [
        ("m", ctypes.c_int64), ("n_valid", ctypes.c_int64),
        ("n_bins", ctypes.c_int32), ("k_top", ctypes.c_int32),
        ("has_loss", ctypes.c_int32), ("sketch", ctypes.c_int32)]


def _launch_cuda(acc: FoldAcc, chunk, gidx, n_valid: int, m: int,
                 has_loss: bool, sketch: bool, summary) -> None:
    from repro_torch.kernels._build import library

    if m >= 1 << 31:
        raise ValueError(f"too many points for one launch: {m}")
    if sketch and (acc.n_bins % 4 or chunk["hist_sums"].data_ptr() % 16):
        raise ValueError(f"the CUDA fold stages hist_sums 16 bytes at a "
                         f"time: n_bins % 4 == 0 and 16-byte aligned rows, "
                         f"got n_bins={acc.n_bins}")
    keys = list(_F32 + _I32) + (["hist_sums"] if sketch else [])
    keys += list(LOSS_KEYS) if has_loss else []
    for t in [chunk[k] for k in keys] + [gidx, acc.ints, acc.floats]:
        if not t.is_contiguous():
            raise ValueError("the CUDA campaign_fold takes contiguous "
                             "tensors")

    def ptr(key):
        return chunk[key].data_ptr() if key in keys else None

    args = _FoldArgs(
        hist=ptr("hist"), hist_sums=ptr("hist_sums"), n_jobs=ptr("n_jobs"),
        batches=ptr("batches"), dropped=ptr("dropped"),
        lat=ptr("mean_latency"), util=ptr("utilization"),
        batch=ptr("mean_batch"), lam=ptr("lam"), bm_m2=ptr("lat_bm_m2"),
        bm_n=ptr("lat_bm_n"), overflow=ptr("overflow_dropped"),
        abandoned=ptr("abandoned"), in_slo=ptr("n_in_slo"),
        fresh=ptr("n_fresh"), retry=ptr("n_retry"), gidx=gidx.data_ptr(),
        ints=acc.ints.data_ptr(), floats=acc.floats.data_ptr(),
        summary=summary.data_ptr(), m=m, n_valid=int(n_valid),
        n_bins=acc.n_bins, k_top=acc.k_top, has_loss=int(has_loss),
        sketch=int(sketch))
    lib = library("campaign_fold")
    size = lib.campaign_fold_work_bytes
    size.argtypes, size.restype = [ctypes.c_int64], ctypes.c_int64
    need = size(m)
    work = _WORK.get(gidx.device)
    if work is None or work.numel() < need:
        work = _WORK[gidx.device] = torch.empty(need, dtype=torch.uint8,
                                                device=gidx.device)
    fn = lib.campaign_fold_launch
    fn.argtypes = [ctypes.POINTER(_FoldArgs), ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(gidx.device).cuda_stream
    with torch.cuda.device(gidx.device):
        err = fn(ctypes.byref(args), work.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"campaign_fold kernel launch failed: CUDA "
                           f"error {err}")


def campaign_fold(acc: FoldAcc, chunk: Dict[str, torch.Tensor],
                  gidx: torch.Tensor, n_valid: int, *, has_loss: bool,
                  sketch: bool) -> torch.Tensor:
    """Fold a chunk's per-point outputs into ``acc`` in place, in the
    order of the rows (``gidx`` holds their global indices, rows at or
    past ``n_valid`` are padding).  ``chunk`` holds the sweep outputs
    (int32 / float32 ``(m,)`` rows, ``hist`` and ``hist_sums`` ``(m,
    n_bins)``) and ``lam``.  CUDA tensors launch the kernel, CPU tensors
    take ``campaign_fold_plain``.  Returns the chunk's int64 summary, on
    the accumulator's device."""
    if acc.ints.device.type == "cpu":
        return campaign_fold_plain(acc, chunk, gidx, n_valid,
                                   has_loss=has_loss, sketch=sketch)
    if acc.ints.device.type != "cuda":
        raise ValueError(f"campaign_fold takes CPU or CUDA tensors, got "
                         f"{acc.ints.device}")
    m = _check(acc, chunk, gidx, n_valid, has_loss, sketch)
    summary = torch.zeros(len(_summary_keys(has_loss)), dtype=torch.int64,
                          device=acc.ints.device)
    _launch_cuda(acc, chunk, gidx, n_valid, m, has_loss, sketch, summary)
    campaign_fold.launches += 1
    return summary


campaign_fold.launches = 0


def chain_floor(dev: torch.device, m: int) -> torch.Tensor:
    """Launch one thread's chain of ``m`` dependent float64 additions on
    ``dev`` (``csrc/campaign_fold.cu``'s floor of the ordered tail, for
    timing: the fold's sums cannot run faster); returns its result, 0 +
    m in float64.  Its operands live on the device between calls, so a
    call copies nothing from the host."""
    from repro_torch.kernels._build import library

    if dev not in _CHAIN:
        _CHAIN[dev] = (torch.tensor([0.0, 1.0], dtype=torch.float64,
                                    device=dev),
                       torch.empty(1, dtype=torch.float64, device=dev))
    x, out = _CHAIN[dev]
    fn = library("campaign_fold").campaign_fold_chain_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), out.data_ptr(), m,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chain_floor launch failed: CUDA error {err}")
    return out


def fold_min_bytes(m: int, n_bins: int, *, has_loss: bool, sketch: bool,
                   k_top: int) -> int:
    """The bytes any implementation of the fold must move: each chunk
    input read once (the int32 histogram rows; the float32 per-bin sums
    in sketch mode; the nine (m,) rows of 4 bytes, five float32 and four
    int32 besides ``hist``; the five loss rows on loss grids; the int64
    indices), the accumulator fields the fold updates read and written
    once (``hist_sums`` in sketch mode only), and the summary written
    once."""
    rows = m * n_bins * 4 * (2 if sketch else 1)
    cols = m * 4 * (len(_F32) + len(_I32) - 1
                    + (len(LOSS_KEYS) if has_loss else 0)) + m * 8
    acc = 2 * 8 * (n_bins * (2 if sketch else 1) + len(ACC_INT)
                   + len(ACC_F64) + 1 + 4 * k_top)
    return rows + cols + acc + 8 * len(_summary_keys(has_loss))


def summary_dict(summary: np.ndarray, has_loss: bool) -> Dict[str, int]:
    """The summary's host values under their names."""
    return {k: int(v) for k, v in zip(_summary_keys(has_loss), summary)}

