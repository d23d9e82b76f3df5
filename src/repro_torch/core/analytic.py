"""Closed-form characterization of the dynamic-batching queue (the paper).

Implements, symbol-for-symbol, the analytical results of
Inoue, "Queueing Analysis of GPU-Based Inference Servers with Dynamic
Batching: A Closed-Form Characterization" (Perf. Eval. 2020):

- batch throughput μ^[b] = b/(αb+τ0)                         (Eq. 26)
- stability ρ = λα < 1                                        (Eq. 27)
- Lemma 3: E[B], E[B²] in terms of Pr(A=0)                    (Eq. 31, 32)
- Lemma 4: E[W] in terms of π0                                (Eq. 35)
- Lemma 5: π0 ≥ max(0, 1 − λ(α+τ0))                           (Eq. 39)
- Theorem 2: closed-form upper bounds φ0, φ1 and φ = min      (Eq. 41–43)
- utilization identity 1−π0 = λα + λτ0/E[B]                   (Eq. 38)
- E[B] lower bound max(1, λτ0/(1−λα))                         (Remark 5)

All functions are plain-float NumPy-friendly.  Own copy of the reference
package's ``repro.core.analytic`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = [
    "mu_b", "rho", "is_stable", "stability_limit", "phi0", "phi1", "phi",
    "mean_latency_given_pi0", "pi0_lower", "mean_batch_lower",
    "utilization_upper", "mean_wait_decomposition", "LinearServiceModel",
]


# ---------------------------------------------------------------------------
# service-time model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LinearServiceModel:
    """Deterministic linear batch processing times τ^[b] = α·b + τ0
    (Assumption 4), the GPU/TPU-inference service law."""

    alpha: float
    tau0: float

    def tau(self, b):
        return self.alpha * np.asarray(b, dtype=float) + self.tau0

    def mu(self, b):
        return mu_b(b, self.alpha, self.tau0)

    @property
    def mu_inf(self) -> float:
        return 1.0 / self.alpha

    def stability_limit(self, b_max: float = math.inf) -> float:
        return stability_limit(self.alpha, self.tau0, b_max)


def mu_b(b, alpha: float, tau0: float):
    """Mean throughput at batch size b (Eq. 1 / 26)."""
    b = np.asarray(b, dtype=float)
    return b / (alpha * b + tau0)


def rho(lam: float, alpha: float) -> float:
    """Normalized load ρ = λα (Eq. 27)."""
    return lam * alpha


def stability_limit(alpha: float, tau0: float,
                    b_max: float = math.inf) -> float:
    """Supremum of stable arrival rates: μ^[b_max] (→ 1/α for b_max=∞)."""
    if math.isinf(b_max):
        return 1.0 / alpha
    return b_max / (alpha * b_max + tau0)


def is_stable(lam: float, alpha: float, tau0: float,
              b_max: float = math.inf) -> bool:
    return lam < stability_limit(alpha, tau0, b_max)


# ---------------------------------------------------------------------------
# Theorem 2
# ---------------------------------------------------------------------------

def phi0(lam, alpha: float, tau0: float):
    """Upper bound from π0 ≥ 1 − λ(α+τ0) (Eq. 41). Valid for ρ < 1."""
    lam = np.asarray(lam, dtype=float)
    return ((alpha + tau0) / (2.0 * (1.0 - lam * alpha))
            * (1.0 + 2.0 * lam * tau0
               + (1.0 - lam * tau0) / (1.0 + lam * alpha)))


def phi1(lam, alpha: float, tau0: float):
    """Upper bound from π0 ≥ 0 (Eq. 42). Valid for ρ < 1."""
    lam = np.asarray(lam, dtype=float)
    la = lam * alpha
    return (1.5 * tau0 / (1.0 - la)
            + 0.5 * alpha * (la + 2.0) / (1.0 - la * la))


def phi(lam, alpha: float, tau0: float):
    """φ = min(φ0, φ1) (Eq. 43) — the paper's closed-form latency
    characterization. φ0 is the tighter bound iff λ ≤ 1/(α+τ0)."""
    return np.minimum(phi0(lam, alpha, tau0), phi1(lam, alpha, tau0))


# ---------------------------------------------------------------------------
# Lemmas 3–5 and supporting identities
# ---------------------------------------------------------------------------

def batch_moments_given_pA0(lam: float, alpha: float, tau0: float,
                            p_a0: float):
    """Lemma 3: (E[B], E[B²]) given Pr(A=0) (Eqs. 31, 32)."""
    eb = (lam * tau0 + p_a0) / (1.0 - lam * alpha)
    eb2 = ((1.0 + 2.0 * lam * lam * alpha * tau0) * eb
           + (lam * tau0) ** 2) / (1.0 - (lam * alpha) ** 2)
    return eb, eb2


def mean_latency_given_pi0(lam, alpha: float, tau0: float, pi0):
    """Lemma 4 (Eq. 35): E[W] as a function of the idle probability π0."""
    lam = np.asarray(lam, dtype=float)
    pi0 = np.asarray(pi0, dtype=float)
    la = lam * alpha
    num = lam * (1.0 + 2.0 * la) * (
        2.0 * alpha * tau0 + alpha * alpha
        + (1.0 - pi0 - la) * tau0 / lam)
    return alpha + tau0 + num / (2.0 * (1.0 - la * la))


def mean_latency_given_batch_moments(lam, alpha: float, tau0: float,
                                     eb, eb2):
    """Eq. (36): E[W] = α + τ0 + (1+2λα)(E[B²]−E[B]) / (2λE[B])."""
    lam = np.asarray(lam, dtype=float)
    return (alpha + tau0
            + (1.0 + 2.0 * lam * alpha) * (eb2 - eb) / (2.0 * lam * eb))


def pi0_lower(lam, alpha: float, tau0: float):
    """Lemma 5 (Eq. 39)."""
    lam = np.asarray(lam, dtype=float)
    return np.maximum(0.0, 1.0 - lam * (alpha + tau0))


def utilization_upper(lam, alpha: float, tau0: float):
    """Upper bound on server utilization 1−π0: min(1, λ(α+τ0))."""
    lam = np.asarray(lam, dtype=float)
    return np.minimum(1.0, lam * (alpha + tau0))


def utilization_given_EB(lam, alpha: float, tau0: float, eb):
    """Eq. (38): 1−π0 = λα + λτ0/E[B]."""
    lam = np.asarray(lam, dtype=float)
    return lam * alpha + lam * tau0 / np.asarray(eb, dtype=float)


def mean_batch_lower(lam, alpha: float, tau0: float):
    """Remark 5: E[B] ≥ max(1, λτ0/(1−λα))."""
    lam = np.asarray(lam, dtype=float)
    return np.maximum(1.0, lam * tau0 / (1.0 - lam * alpha))


def mean_wait_decomposition(lam: float, alpha: float, tau0: float,
                            eb: float, eb2: float):
    """Lemma 2 / Remark 1 split: (mean queueing wait, mean processing)."""
    wait = (eb2 - eb) / (2.0 * lam * eb)
    proc = alpha * eb2 / eb + tau0
    return wait, proc
