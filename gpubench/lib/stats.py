"""Statistics the benchmark reports, the union of time intervals, and the
host's gaps between batches."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile, linear between order statistics (numpy's
    default)."""
    return float(np.percentile(np.asarray(values, dtype=float), q))


def merged(intervals: Sequence[Sequence[float]]) -> list:
    """The intervals' union as disjoint sorted ``[start, end]`` pairs."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def host_gaps(batches: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """The host gaps between consecutive batches while requests waited
    (``backlog`` when the first ended): seconds from the first's end to
    the next one's call, and the part of each spent forming the next
    batch (from the loop's wake, ``t_form``, to the call)."""
    i = [k for k in range(len(batches) - 1) if batches[k].backlog]
    gap = np.array([batches[k + 1].t_call - batches[k].t_end for k in i])
    form = np.array([batches[k + 1].t_call - batches[k + 1].t_form
                     for k in i])
    return gap, form
