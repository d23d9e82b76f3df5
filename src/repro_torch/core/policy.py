"""Dynamic-batching policies for the serving engine (and simulator).

The paper analyses BatchAllWaiting (Eq. 2): when the server goes idle, grab
every waiting job. CappedBatch adds the finite b_max used in its Fig. 8 /
real-system experiments (max_batch_size in TF-Serving / Triton terms).
TimeoutBatch is the beyond-paper comparison: wait up to `max_wait` to
accumulate a batch (Triton's queue delay knob) — included to show the
paper's no-wait policy dominates it in mean latency under its model.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["BatchPolicy", "BatchAllWaiting", "CappedBatch", "TimeoutBatch"]


@dataclass(frozen=True)
class BatchPolicy:
    """Decision: given queue state, how many jobs to take and whether to
    delay service. Subclasses override ``take`` and ``release_time``."""

    def take(self, n_waiting: int) -> int:
        raise NotImplementedError

    def release_time(self, now: float, oldest_arrival: float,
                     n_waiting: int) -> float:
        """Earliest time the next batch may start (>= now)."""
        return now

    @property
    def b_max(self) -> float:
        return math.inf


@dataclass(frozen=True)
class BatchAllWaiting(BatchPolicy):
    """The paper's policy (Eq. 2): serve all waiting jobs immediately."""

    def take(self, n_waiting: int) -> int:
        return n_waiting


@dataclass(frozen=True)
class CappedBatch(BatchPolicy):
    """Serve min(waiting, cap) immediately — finite b_max variant."""

    cap: int = 64

    def take(self, n_waiting: int) -> int:
        return min(n_waiting, self.cap)

    @property
    def b_max(self) -> float:
        return float(self.cap)


@dataclass(frozen=True)
class TimeoutBatch(BatchPolicy):
    """Delay service until `max_wait` has elapsed since the oldest waiting
    arrival or `target` jobs have accumulated (Triton queue-delay style)."""

    max_wait: float = 0.005
    target: int = 32
    cap: int = 64

    def take(self, n_waiting: int) -> int:
        return min(n_waiting, self.cap)

    def release_time(self, now: float, oldest_arrival: float,
                     n_waiting: int) -> float:
        if n_waiting >= self.target:
            return now
        return max(now, oldest_arrival + self.max_wait)

    @property
    def b_max(self) -> float:
        return float(self.cap)
