"""SLO-driven operating-point planner — the port's copy.

Own copy of the reference package's ``repro.core.planner``: the port
imports nothing of ``repro``, not even this module, which loads no JAX.
The code is the reference's, unchanged.

The reference module's description follows.

SLO-driven operating-point planner — the paper's results as a feature.

Given a calibrated service model (α, τ0) and optionally an energy model
(β, c0), the planner answers the operational questions the paper's analysis
enables:

- ``max_rate_for_slo``: the largest admissible λ such that the closed-form
  latency characterization φ(λ, α, τ0) stays within an SLO. Because
  Corollary 1 shows η is non-decreasing in λ, this point is also the most
  energy-efficient admissible operating point.
- ``operating_point``: full prediction (latency bound, utilization bounds,
  E[B] lower bound, η lower bound) at a given λ.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core import analytic as an
from repro_torch.core.analytic import LinearServiceModel
from repro_torch.core.energy import LinearEnergyModel, eta_lower

__all__ = ["OperatingPoint", "Planner"]


@dataclass(frozen=True)
class OperatingPoint:
    lam: float
    rho: float
    latency_bound: float            # φ(λ)
    latency_bound_phi0: float
    latency_bound_phi1: float
    utilization_upper: float
    mean_batch_lower: float
    eta_lower: Optional[float] = None


@dataclass(frozen=True)
class Planner:
    service: LinearServiceModel
    energy: Optional[LinearEnergyModel] = None

    def operating_point(self, lam: float) -> OperatingPoint:
        a, t0 = self.service.alpha, self.service.tau0
        if not an.is_stable(lam, a, t0):
            raise ValueError(
                f"λ={lam} unstable: limit {self.service.mu_inf:.6g}")
        return OperatingPoint(
            lam=lam,
            rho=an.rho(lam, a),
            latency_bound=float(an.phi(lam, a, t0)),
            latency_bound_phi0=float(an.phi0(lam, a, t0)),
            latency_bound_phi1=float(an.phi1(lam, a, t0)),
            utilization_upper=float(an.utilization_upper(lam, a, t0)),
            mean_batch_lower=float(an.mean_batch_lower(lam, a, t0)),
            eta_lower=(float(eta_lower(lam, a, t0, self.energy.beta,
                                       self.energy.c0))
                       if self.energy else None),
        )

    def max_rate_for_slo(self, w_slo: float, *, tol: float = 1e-9) -> float:
        """Largest λ with φ(λ) ≤ w_slo (φ is increasing in λ). Bisection on
        (0, 1/α); returns 0.0 if even λ→0 violates the SLO."""
        a, t0 = self.service.alpha, self.service.tau0
        lo, hi = 0.0, (1.0 - 1e-12) / a
        if float(an.phi(1e-12, a, t0)) > w_slo:
            return 0.0
        if float(an.phi(hi, a, t0)) <= w_slo:
            return hi
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if float(an.phi(mid, a, t0)) <= w_slo:
                lo = mid
            else:
                hi = mid
            if hi - lo < tol * max(1.0, hi):
                break
        return lo

    def min_latency(self) -> float:
        """φ as λ→0: the light-traffic latency floor (≈ α + τ0 · 3/2 … the
        bound's intercept; the true floor is the single-job time α+τ0)."""
        return float(an.phi(1e-12, self.service.alpha, self.service.tau0))
