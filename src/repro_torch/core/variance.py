"""Batch-means error bars for the port's Monte Carlo sweep.

Own copy of ``batch_means_stats`` from the reference package's
``repro.core.variance``: the sweep keeps a Welford batch-means triple
(running block mean, centered second moment M2, block count — one update
per superstep, ``engine.welford_block``), and this turns (M2, n) into a
mean-latency standard error and a z·stderr CI half-width.  Plain numpy.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Z95", "batch_means_stats"]

# two-sided 95% normal quantile — the default CI level everywhere
Z95 = 1.959963984540054


def batch_means_stats(bm_m2, bm_n, z: float = Z95):
    """Standard error and CI half-width from the sweep's batch-means
    accumulators.

    ``bm_m2`` is the centered second moment Σ (x_j − x̄)² of the block
    means, ``bm_n`` the number of blocks that completed ≥1 measured
    job.  Returns ``(stderr, halfwidth)`` (f64), NaN where fewer than
    two blocks exist (no variance information — e.g. a zero-rate
    point, or a run too short for two supersteps of completions)."""
    m2 = np.asarray(bm_m2, dtype=np.float64)
    n = np.asarray(bm_n, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        var = m2 / np.maximum(n - 1.0, 1.0)
        stderr = np.sqrt(np.maximum(var, 0.0) / np.maximum(n, 1.0))
    stderr = np.where(n >= 2.0, stderr, np.nan)
    return stderr, z * stderr
