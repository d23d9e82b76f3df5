"""Common result schema of the port's queue-evaluation backends.

Own copy of the reference package's ``SimResult`` (``repro.core.results``):
the port imports nothing of ``repro``, so the record is duplicated field
for field, which keeps results of the two packages interchangeable for
callers that read fields by name.  ``repro_torch.core.evaluate`` returns
one per grid point for its ``"analytic"`` and ``"sweep"`` backends.

Fields a backend cannot produce are NaN (floats) or None (arrays); the
analytic backend, for example, has no percentiles.

Energy is derived, not stored: ``eta``/``energy_per_job`` evaluate the
paper's Eq. (18)/(19) on the measured mean batch size via
``repro_torch.core.energy`` — identical to summing c^[b] = β·b + c0 over
the processed batches, because the energy law is linear.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = ["SimResult"]

_NAN = float("nan")


@dataclass
class SimResult:
    """Backend-independent summary of one (λ, service-model, policy) point."""

    lam: float                            # arrival rate
    n_jobs: int                           # jobs in the measured window
    mean_latency: float                   # E[W]: arrival → batch departure
    mean_batch: float                     # E[B] over processed batches
    batch_m2: float                       # E[B²] over processed batches
    utilization: float                    # busy-time fraction (1 − π0)
    mean_wait: float = _NAN               # E[W] − per-job service part
    mean_service: float = _NAN            # per-job service part
    latency_p50: float = _NAN
    latency_p95: float = _NAN
    latency_p99: float = _NAN
    n_batches: int = 0                    # batches in the measured window
    backend: str = ""                     # "sim" | "sweep" | "markov" | ...
    # -- regenerative batch-means error bars (MC backends only; NaN on
    #    exact backends, whose mean is not an estimate) -------------------
    stderr: float = _NAN                  # std error of mean_latency
    ci_halfwidth: float = _NAN            # 95% CI half-width (z·stderr)
    k: int = 1                            # replica count (1 = single server)
    routing: str = ""                     # fleet routing ("" outside fleets)
    discipline: str = ""                  # generate scheduling discipline
    #                                       ("static"/"continuous"; "" when
    #                                       the backend is request-level)
    # -- SLO / admission-control metrics (NaN when the point ran without
    #    loss regimes on a backend that predates them) ---------------------
    goodput_frac: float = _NAN            # P(job completes within deadline)
    reject_frac: float = _NAN             # P(job finally lost to q_max)
    abandon_frac: float = _NAN            # P(job finally reneges in queue)
    retry_inflation: float = _NAN         # (fresh+retry)/fresh arrivals
    batch_sizes: Optional[np.ndarray] = field(default=None, repr=False)
    latencies: Optional[np.ndarray] = field(default=None, repr=False)

    # -- derived energy metrics (paper §3.2, via core/energy.py) ----------

    def eta(self, beta: float, c0: float) -> float:
        """Energy efficiency η = jobs per unit energy (Eq. 18/19).

        Uses η = 1/(β + c0/E[B]), which equals the empirical
        Σb / Σ(β·b + c0) because c^[b] is linear in b.
        """
        from repro_torch.core.energy import eta_given_EB
        return float(eta_given_EB(self.mean_batch, beta, c0))

    def energy_per_job(self, beta: float, c0: float) -> float:
        """Mean energy (Joules) per completed job: 1/η."""
        return 1.0 / self.eta(beta, c0)

    @property
    def throughput(self) -> float:
        """Mean departure rate: λ in a lossless steady state, scaled by
        the completing fraction when admission-control losses are on."""
        if math.isnan(self.reject_frac) or math.isnan(self.abandon_frac):
            return self.lam
        return self.lam * (1.0 - self.reject_frac - self.abandon_frac)

    @property
    def goodput(self) -> float:
        """Rate of jobs completed within SLO, λ·goodput_frac (λ when the
        point ran without loss regimes)."""
        if math.isnan(self.goodput_frac):
            return self.lam
        return self.lam * self.goodput_frac

    def check(self) -> "SimResult":
        """Cheap internal-consistency assertions (used by tests).
        NaN fields mean "not produced by this backend" and are skipped."""
        assert self.mean_batch >= 1.0 - 1e-9
        if not math.isnan(self.batch_m2):
            assert self.batch_m2 >= self.mean_batch ** 2 * (1 - 1e-6)
        assert 0.0 <= self.utilization <= 1.0 + 1e-9
        if not math.isnan(self.latency_p50):
            assert (self.latency_p50 <= self.latency_p95 + 1e-12
                    <= self.latency_p99 + 2e-12)
        for frac in (self.goodput_frac, self.reject_frac,
                     self.abandon_frac):
            if not math.isnan(frac):
                assert -1e-9 <= frac <= 1.0 + 1e-9
        if not math.isnan(self.retry_inflation):
            assert self.retry_inflation >= 1.0 - 1e-9
        if not math.isnan(self.stderr):
            assert self.stderr >= 0.0
            assert self.ci_halfwidth >= self.stderr
        return self
