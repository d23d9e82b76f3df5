"""Latency-histogram binning shared by the port's sweep and its kernel.

Own copy of the reference package's ``repro.core.hist``.  Latencies are
binned by their float32 bit pattern — the top ``_MANT`` mantissa bits
plus the exponent, i.e. ``2**_MANT`` log-spaced bins per octave — so a
bin index costs one shift and one subtract per sample on the device:
``bin = clamp((bits >> shift) - base, 0, n_bins - 1)``.  Positive
float32 bits are monotone in value, so this is an exact monotone
binning.  With ``_MANT = 3`` and 512 bins the histogram spans
2**-32 … 2**32 at ~9% per-bin resolution.

Two resolutions share the same bit-pattern binning: the full histogram
(512 bins by default) and the 64-bin streaming quantile sketch
(``SKETCH_MANT = 1`` over 2**-16 … 2**16) with its pinned worst-case
relative error ``SKETCH_REL_ERR``.

``bit_bins`` is the torch form of the device-side binning: the shift is
arithmetic on int32, exactly as ``lax.bitcast_convert_type`` followed by
``>>`` in the reference, so a negative value (or −0.0, whose bits are
0x80000000) lands in bin 0 and +inf / +NaN land in the top bin.  The
edge and percentile reconstruction is host-side numpy.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["hist_edges", "hist_percentiles", "bit_bins", "bin_params",
           "thinned_rows",
           "sketch_edges", "sketch_percentiles", "SKETCH_BINS",
           "SKETCH_MANT", "SKETCH_EXP_MIN", "SKETCH_REL_ERR"]

_MANT = 3
_EXP_MIN = -32

# bit-pattern binning constants: bin = (bits >> _BIN_SHIFT) - _BIN_BASE
_BIN_BASE = (127 + _EXP_MIN) << _MANT
_BIN_SHIFT = 23 - _MANT

# streaming-sketch constants: 2**SKETCH_MANT bins per octave over
# exponents [SKETCH_EXP_MIN, SKETCH_EXP_MAX) — 2**-16 ≈ 15 µs up to
# 2**16 ≈ 65 ks covers every latency the sweep models, in 64 bins
SKETCH_MANT = 1
SKETCH_EXP_MIN = -16
SKETCH_EXP_MAX = 16
SKETCH_BINS = (SKETCH_EXP_MAX - SKETCH_EXP_MIN) << SKETCH_MANT
_SK_BASE = (127 + SKETCH_EXP_MIN) << SKETCH_MANT
_SK_SHIFT = 23 - SKETCH_MANT

# worst-case relative error of a sketch percentile: the estimate lies
# inside the bin holding the true quantile; bit-pattern bins are linear
# within an octave, so the widest bin spans 2**-SKETCH_MANT of its
# lower edge
SKETCH_REL_ERR = float(2.0 ** -SKETCH_MANT)


def bin_params(sketch: bool = False) -> Tuple[int, int, int]:
    """``(shift, base, n_bins)`` of a binning mode (``n_bins`` is the
    sketch's fixed width; full-histogram callers pass their own)."""
    if sketch:
        return _SK_SHIFT, _SK_BASE, SKETCH_BINS
    return _BIN_SHIFT, _BIN_BASE, 0


def _edges(n_bins: int, mant: int, exp_min: int) -> np.ndarray:
    j = np.arange(n_bins + 1, dtype=np.int64)
    bits = (j + ((127 + exp_min) << mant)) << (23 - mant)
    return bits.astype(np.int32).view(np.float32).astype(np.float64)


def hist_edges(n_bins: int) -> np.ndarray:
    """The n_bins+1 latency values bounding the histogram bins."""
    return _edges(n_bins, _MANT, _EXP_MIN)


def sketch_edges() -> np.ndarray:
    """The SKETCH_BINS+1 latency values bounding the sketch bins."""
    return _edges(SKETCH_BINS, SKETCH_MANT, SKETCH_EXP_MIN)


def bit_bins(lats: torch.Tensor, n_bins: int,
             sketch: bool = False) -> torch.Tensor:
    """int32 bin indices of a float32 latency tensor, clamped to
    [0, n_bins): ``(lats.view(int32) >> shift) - base``."""
    if lats.dtype != torch.float32:
        raise TypeError(f"bit_bins takes float32 latencies, got "
                        f"{lats.dtype}")
    shift, base, _ = bin_params(sketch)
    bits = lats.contiguous().view(torch.int32)
    return ((bits >> shift) - base).clamp_(0, n_bins - 1)


def thinned_rows(rebase_every: int, hist_every: int) -> np.ndarray:
    """The fixed scrambled 1-in-N step subsample the superstep kernels
    feed to the percentile histogram when ``hist_every > 1`` (a fixed
    scrambled offset pattern per superstep — not a lattice, which could
    resonate with the event-parity structure of idle cycles).  Sorted,
    deterministic, and the reference's rows bit for bit: both draw the
    permutation from numpy's ``default_rng(0)``."""
    return np.sort(np.random.default_rng(0).permutation(
        rebase_every)[:max(1, rebase_every // hist_every)])


def hist_percentiles(hist: np.ndarray, qs: Iterable[float],
                     edges: Optional[np.ndarray] = None
                     ) -> List[np.ndarray]:
    """Percentiles from per-point bit-binned histograms, with linear
    in-bin interpolation.  Pass ``edges`` to reconstruct a non-default
    binning (e.g. the sketch's).  A 1-D input is treated as one
    point."""
    hist = np.atleast_2d(np.asarray(hist))
    if edges is None:
        edges = hist_edges(hist.shape[1])
    cum = np.cumsum(hist, axis=1)
    total = cum[:, -1]
    rows = np.arange(hist.shape[0])
    out = []
    for p in qs:
        target = p / 100.0 * np.maximum(total, 1)
        j = np.argmax(cum >= target[:, None], axis=1)
        below = np.where(j > 0, cum[rows, np.maximum(j - 1, 0)], 0)
        inbin = np.maximum(hist[rows, j], 1)
        frac = np.clip((target - below) / inbin, 0.0, 1.0)
        lat = edges[j] + frac * (edges[j + 1] - edges[j])
        out.append(np.where(total > 0, lat, np.nan))
    return out


def sketch_percentiles(counts: np.ndarray,
                       qs: Iterable[float]) -> List[np.ndarray]:
    """``hist_percentiles`` over sketch-binned counts: each estimate is
    within ``SKETCH_REL_ERR`` of the exact in-range sample
    percentile."""
    counts = np.atleast_2d(np.asarray(counts))
    if counts.shape[1] != SKETCH_BINS:
        raise ValueError(f"sketch counts must have {SKETCH_BINS} bins "
                         f"(got {counts.shape[1]})")
    return hist_percentiles(counts, qs, edges=sketch_edges())
