"""Least-squares calibration of the linear service / energy models.

Fits τ^[b] = α·b + τ0 (Assumption 4) and c^[b] = β·b + c0 (Assumption 2)
from measured (batch_size, latency[, power]) samples, exactly as the paper
does for Table 1 / Fig. 9, and reports R².
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.analytic import LinearServiceModel
from repro_torch.core.energy import LinearEnergyModel

__all__ = ["LinearFit", "fit_linear", "fit_service_model",
           "fit_energy_model", "TABLE1_V100", "TABLE1_P4"]


@dataclass(frozen=True)
class LinearFit:
    slope: float
    intercept: float
    r2: float


def fit_linear(x: Sequence[float], y: Sequence[float]) -> LinearFit:
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    A = np.stack([x, np.ones_like(x)], axis=1)
    (slope, intercept), *_ = np.linalg.lstsq(A, y, rcond=None)
    pred = slope * x + intercept
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    return LinearFit(float(slope), float(intercept), r2)


def fit_service_model(batch_sizes: Sequence[float],
                      latencies: Sequence[float]
                      ) -> Tuple[LinearServiceModel, float]:
    """Fit (α, τ0) from measured batch latencies. Returns (model, R²)."""
    f = fit_linear(batch_sizes, latencies)
    return LinearServiceModel(alpha=max(f.slope, 1e-12),
                              tau0=max(f.intercept, 0.0)), f.r2


def fit_energy_model(batch_sizes: Sequence[float],
                     energies: Sequence[float]
                     ) -> Tuple[LinearEnergyModel, float]:
    """Fit (β, c0) from per-batch energy (power × latency)."""
    f = fit_linear(batch_sizes, energies)
    return LinearEnergyModel(beta=max(f.slope, 1e-12),
                             c0=max(f.intercept, 0.0)), f.r2


# ---------------------------------------------------------------------------
# Paper Table 1 measurement data (NVIDIA, ResNet-50) — used by benchmarks
# to reproduce the paper's own fits: α=0.1438ms, τ0=1.8874ms (V100);
# α=0.5833ms, τ0=1.4284ms (P4).
# ---------------------------------------------------------------------------

# (batch_size, throughput images/s, board power W)
TABLE1_V100 = np.array([
    (1, 476, 120), (2, 880, 109), (4, 1631, 132), (8, 2685, 153),
    (64, 5877, 274), (128, 6275, 285)], dtype=float)

TABLE1_P4 = np.array([
    (1, 569, 44), (2, 736, 44), (4, 974, 49), (8, 1291, 57),
    (64, 1677, 63), (128, 1676, 62)], dtype=float)


def table1_service_samples(table: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """(b, τ^[b] in ms) derived as batch_size / throughput (Eq. 1)."""
    b = table[:, 0]
    tau_ms = b / table[:, 1] * 1e3
    return b, tau_ms


def table1_energy_samples(table: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(b, c^[b] in Joules) = power × batch processing time (paper Fig. 2)."""
    b = table[:, 0]
    tau_s = b / table[:, 1]
    return b, table[:, 2] * tau_s
