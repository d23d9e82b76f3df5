"""Energy model and efficiency results (paper §3.2).

Linear batch energy c^[b] = β·b + c0 (Assumption 2), average energy
efficiency η (Eq. 18/19), and the Corollary-1 regime: η is non-decreasing
in the arrival rate λ — the "operate as hot as the SLO allows" result —
with the closed-form lower bound (Eq. 40).  Own copy of the reference
package's ``repro.core.energy``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.analytic import mean_batch_lower

__all__ = ["LinearEnergyModel", "eta_given_EB", "eta_lower",
           "eta_from_batches"]


@dataclass(frozen=True)
class LinearEnergyModel:
    """c^[b] = β·b + c0 — energy (Joules) to process a batch of size b."""

    beta: float
    c0: float

    def c(self, b):
        return self.beta * np.asarray(b, dtype=float) + self.c0

    def eta(self, eb):
        return eta_given_EB(eb, self.beta, self.c0)


def eta_given_EB(eb, beta: float, c0: float):
    """Eq. (19): η = 1/(β + c0/E[B])."""
    eb = np.asarray(eb, dtype=float)
    return 1.0 / (beta + c0 / eb)


def eta_lower(lam, alpha: float, tau0: float, beta: float, c0: float):
    """Eq. (40): closed-form lower bound of η using Remark 5's E[B] bound."""
    return eta_given_EB(mean_batch_lower(lam, alpha, tau0), beta, c0)


def eta_from_batches(batch_sizes: np.ndarray, beta: float, c0: float
                     ) -> float:
    """Empirical η (Eq. 18) from a sequence of processed batch sizes:
    jobs per unit energy = Σb / Σc^[b]."""
    b = np.asarray(batch_sizes, dtype=float)
    return float(b.sum() / (beta * b.sum() + c0 * b.size))
