"""Beyond-paper: replica economics under dynamic batching — the port's
copy.

Own copy of the reference package's ``repro.core.replicas``: the code
is the reference's, except that ``fleet_latency`` and ``simulate_jsq``
take ``device`` and their fleet runs go through the port's
``repro_torch.core.sweep.fleet_sweep`` — on CUDA unless
``device="cpu"``.  ``simulate_jsq_numpy`` is the host oracle.

The reference module's description follows.

Beyond-paper: replica economics under dynamic batching.

Should a fleet run k independent dynamic-batching replicas (each taking a
1/k split of the traffic) or one consolidated server k× as fast? The
paper's model answers this cleanly:

- k replicas, random split: each is the paper's queue at (λ/k, α, τ0)
  ⇒ E[W] = φ(λ/k, α, τ0)-ish (exactly: the same queue at lower load).
- one consolidated server: (λ, α/k, τ0') — per-sample marginal divides
  by k, the fixed cost τ0' depends on how the speedup is obtained
  (τ0/k for perfect scale-up; τ0 for pure tensor-parallel weight
  streaming across k chips with unchanged launch overheads).

Because batching efficiency grows with load (Theorem 1), consolidation
wins twice: bigger batches AND lower marginal time. This module computes
both sides exactly (markov solver) and in closed form (φ), and measures
what routing can and cannot recover via the vectorized fleet kernel
(``repro_torch.core.sweep.fleet_sweep``): random split, round-robin, and
join-shortest-queue (JSQ, the strongest practical router) all run as
(λ, k, routing) grid points in one dispatch.

The original per-event NumPy JSQ loop is kept as
``simulate_jsq_numpy`` — the independent cross-check reference the fleet
kernel's statistical tests pin against (see tests/test_fleet.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from repro_torch.core.analytic import LinearServiceModel, phi
from repro_torch.core.markov import solve

__all__ = ["ReplicaComparison", "compare", "fleet_latency",
           "simulate_jsq", "simulate_jsq_numpy"]


@dataclass
class ReplicaComparison:
    lam: float
    k: int
    ew_split: float              # k replicas, random split (exact)
    ew_consolidated: float       # one k×-fast server (exact)
    ew_split_phi: float          # closed-form versions
    ew_consolidated_phi: float
    consolidation_gain: float    # split / consolidated
    ew_jsq: float = math.nan     # k replicas under JSQ (fleet-kernel MC)


def compare(lam: float, model: LinearServiceModel, k: int,
            *, tau0_scaling: str = "flat", jsq: bool = False,
            n_jobs: int = 100_000, seed: int = 0,
            device=None) -> ReplicaComparison:
    """tau0_scaling: 'flat' (consolidated keeps τ0 — tensor-parallel) or
    'scaled' (τ0/k — perfect scale-up).  ``jsq=True`` adds a Monte Carlo
    JSQ latency from the fleet kernel (one extra dispatch on
    ``device``)."""
    tau0_c = model.tau0 if tau0_scaling == "flat" else model.tau0 / k
    cons = LinearServiceModel(model.alpha / k, tau0_c)
    ew_split = solve(lam / k, model).mean_latency
    ew_cons = solve(lam, cons).mean_latency
    return ReplicaComparison(
        lam=lam, k=k,
        ew_split=ew_split,
        ew_consolidated=ew_cons,
        ew_split_phi=float(phi(lam / k, model.alpha, model.tau0)),
        ew_consolidated_phi=float(phi(lam, cons.alpha, cons.tau0)),
        consolidation_gain=ew_split / ew_cons,
        ew_jsq=(simulate_jsq(lam, model, k, n_jobs=n_jobs, seed=seed,
                             device=device)
                if jsq else math.nan),
    )


def _fleet_steps(lam: float, model: LinearServiceModel, k: int,
                 n_jobs: int) -> int:
    """Fleet events needed for ~n_jobs measured jobs: one batch per
    event in steady state, E[B] jobs per batch at the per-replica load
    (Remark 5 lower bound), plus warmup/idle/deferral slack."""
    rho = (lam / k) * model.alpha
    eb = max(1.0, (lam / k) * model.tau0 / max(1e-6, 1.0 - rho))
    return max(512, int(1.8 * n_jobs / eb))


def fleet_latency(lams: Sequence[float], model: LinearServiceModel,
                  ks: Sequence[int], routing="jsq", *,
                  n_steps: int = 6000, seed: int = 0, q_cap: int = 256,
                  a_cap: int = 32, hist_every: int = 1,
                  require_clean: bool = True, device=None) -> np.ndarray:
    """Mean latency for parallel (λ_total, k) points under ``routing``
    (a name, or a per-point sequence) in one fleet dispatch on
    ``device``."""
    from repro_torch.core.sweep import FleetGrid, fleet_sweep
    grid = FleetGrid.from_points(list(lams), model.alpha, model.tau0,
                                 k=list(ks), routing=routing)
    r = fleet_sweep(grid, n_steps=n_steps, seed=seed, q_cap=q_cap,
                    a_cap=a_cap, hist_every=hist_every, device=device)
    if require_clean and int(r.buffer_dropped.sum()):
        raise RuntimeError(
            f"fleet sweep dropped {int(r.buffer_dropped.sum())} arrivals; "
            "raise q_cap (or lower the load)")
    return r.mean_latency


def simulate_jsq(lam: float, model: LinearServiceModel, k: int, *,
                 n_jobs: int = 100_000, seed: int = 0,
                 backend: str = "fleet", device=None) -> float:
    """Join-shortest-queue over k dynamic-batching replicas: arrivals go
    to the replica with the fewest waiting+in-service jobs. Returns mean
    latency.

    backend='fleet' (default) runs the port's fleet sweep on ``device``
    (CUDA unless ``device="cpu"``); backend='numpy' runs the legacy
    per-event loop (the slow exact reference, kept for cross-checking)."""
    if backend == "numpy":
        return simulate_jsq_numpy(lam, model, k, n_jobs=n_jobs, seed=seed)
    if backend != "fleet":
        raise ValueError(f"unknown backend {backend!r}")
    (ew,) = fleet_latency(
        [lam], model, [k], "jsq", seed=seed,
        n_steps=_fleet_steps(lam, model, k, n_jobs), device=device)
    return float(ew)


def simulate_jsq_numpy(lam: float, model: LinearServiceModel, k: int, *,
                       n_jobs: int = 100_000, seed: int = 0) -> float:
    """The original event-driven NumPy JSQ loop (one (arrival, departure)
    event at a time) — the fleet kernel's independent cross-check."""
    rng = np.random.default_rng(seed)
    arr = np.cumsum(rng.exponential(1.0 / lam, size=n_jobs))
    # per-replica state
    waiting: List[List[float]] = [[] for _ in range(k)]
    busy_until = np.zeros(k)
    in_service = np.zeros(k, dtype=int)
    lat: List[float] = []
    i = 0
    now = 0.0

    def start_service(r: int, t: float) -> None:
        b = len(waiting[r])
        if b == 0:
            return
        svc = float(model.tau(b))
        depart = t + svc
        for a in waiting[r]:
            lat.append(depart - a)
        waiting[r].clear()
        in_service[r] = b
        busy_until[r] = depart

    while len(lat) < n_jobs:
        # next event: arrival or earliest busy replica finishing
        busy = busy_until > now
        t_dep = busy_until[busy].min() if busy.any() else np.inf
        t_arr = arr[i] if i < n_jobs else np.inf
        if t_arr <= t_dep:
            now = t_arr
            # JSQ routing (waiting + in flight)
            load = np.array([len(w) for w in waiting]) + in_service \
                * (busy_until > now)
            r = int(np.argmin(load))
            waiting[r].append(now)
            i += 1
            if busy_until[r] <= now:
                start_service(r, now)
        else:
            now = t_dep
            done = np.where((busy_until <= now + 1e-12)
                            & (in_service > 0))[0]
            for r in done:
                in_service[r] = 0
                if waiting[r]:
                    start_service(r, now)
        if i >= n_jobs and not (busy_until > now).any() \
                and not any(waiting):
            break

    return float(np.mean(lat[:n_jobs]))
