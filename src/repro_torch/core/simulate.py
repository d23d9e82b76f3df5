"""Exact discrete-event simulation of the batching queue — the port's copy.

Own copy of the reference package's ``repro.core.simulate``: the port
imports nothing of ``repro``, not even this module, which loads no JAX.
It is the ``"sim"`` backend of ``repro_torch.core.evaluate`` and a host
oracle of the port's ``sweep``.  The code is the reference's, unchanged.

The reference module's description follows.

Exact discrete-event simulation of the dynamic-batching queue.

Simulates the paper's model (§2): Poisson(λ) arrivals, single batch server,
batch-all-waiting policy (Eq. 2), batch-size-dependent service times H^[b]
(deterministic / exponential / gamma with fixed CV — Example 1 families),
optional finite maximum batch size b_max.

The event structure is regenerative per service: between service completions
the only events are arrivals, so the simulation advances batch-by-batch and
draws the Poisson arrivals inside each service period in bulk. Per-job
latencies are exact (arrival → batch departure).
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from repro_torch.core.analytic import LinearServiceModel
from repro_torch.core.results import SimResult

__all__ = ["SimResult", "simulate", "ServiceTimeSampler"]


class ServiceTimeSampler:
    """H^[b] sampler. dist: 'det' | 'exp' | 'gamma' (cv fixed)."""

    def __init__(self, model: LinearServiceModel, dist: str = "det",
                 cv: float = 0.5):
        self.model = model
        self.dist = dist
        self.cv = cv

    def sample(self, b: int, rng: np.random.Generator) -> float:
        mean = float(self.model.tau(b))
        if self.dist == "det":
            return mean
        if self.dist == "exp":
            return float(rng.exponential(mean))
        if self.dist == "gamma":
            k = 1.0 / (self.cv ** 2)
            return float(rng.gamma(k, mean / k))
        raise ValueError(f"unknown dist {self.dist!r}")


def simulate(lam: float, model: LinearServiceModel, *,
             n_jobs: int = 200_000, b_max: float = math.inf,
             dist: str = "det", cv: float = 0.5, seed: int = 0,
             warmup_frac: float = 0.1, keep_latencies: bool = False
             ) -> SimResult:
    """Run the batch-service queue until ~n_jobs jobs have departed."""
    rng = np.random.default_rng(seed)
    sampler = ServiceTimeSampler(model, dist, cv)

    # pre-draw arrivals in blocks
    block = max(4096, int(lam * 64) + 1)
    arr_times: List[np.ndarray] = []
    t_arr = 0.0

    def draw_block():
        nonlocal t_arr
        gaps = rng.exponential(1.0 / lam, size=block)
        times = t_arr + np.cumsum(gaps)
        t_arr = float(times[-1])
        arr_times.append(times)

    draw_block()
    buf = arr_times[-1]
    buf_pos = 0

    def next_arrivals_until(t: float) -> np.ndarray:
        """Pop all arrival times <= t (in order)."""
        nonlocal buf, buf_pos
        out = []
        while True:
            rest = buf[buf_pos:]
            idx = np.searchsorted(rest, t, side="right")
            out.append(rest[:idx])
            buf_pos += idx
            if buf_pos < len(buf):
                break
            draw_block()
            buf = arr_times[-1]
            buf_pos = 0
        return np.concatenate(out) if len(out) > 1 else out[0]

    def peek_next_arrival() -> float:
        nonlocal buf, buf_pos
        if buf_pos >= len(buf):
            draw_block()
            buf = arr_times[-1]
            buf_pos = 0
        return float(buf[buf_pos])

    now = 0.0
    busy_time = 0.0
    waiting: List[float] = []            # arrival times of queued jobs
    latencies: List[float] = []
    batches: List[int] = []
    departed = 0

    while departed < n_jobs:
        if not waiting:
            # idle until the next arrival
            t_next = peek_next_arrival()
            got = next_arrivals_until(t_next)
            now = t_next
            waiting.extend(got.tolist())
        # form a batch (FIFO, capped at b_max)
        b = int(min(len(waiting), b_max))
        batch_arrivals = waiting[:b]
        waiting = waiting[b:]
        s = sampler.sample(b, rng)
        depart = now + s
        # latency = departure - arrival (sojourn)
        latencies.extend(depart - a for a in batch_arrivals)
        batches.append(b)
        departed += b
        busy_time += s
        # arrivals during service join the queue
        got = next_arrivals_until(depart)
        waiting.extend(got.tolist())
        now = depart

    lat = np.asarray(latencies[: n_jobs])
    bs = np.asarray(batches)
    # warmup removal (job-indexed)
    w = int(len(lat) * warmup_frac)
    lat_w = lat[w:]
    # service time per job (latency - wait) accounted via batch bookkeeping:
    # recompute service means from batches
    svc = model.tau(bs) if dist == "det" else None
    mean_service_per_job = (float((bs * model.tau(bs)).sum() / bs.sum())
                            if dist == "det" else float("nan"))
    res = SimResult(
        lam=lam,
        n_jobs=len(lat_w),
        mean_latency=float(lat_w.mean()),
        mean_wait=float(lat_w.mean() - mean_service_per_job)
        if dist == "det" else float("nan"),
        mean_service=mean_service_per_job,
        mean_batch=float(bs.mean()),
        batch_m2=float((bs.astype(float) ** 2).mean()),
        utilization=float(busy_time / now),
        batch_sizes=bs,
        latency_p50=float(np.percentile(lat_w, 50)),
        latency_p95=float(np.percentile(lat_w, 95)),
        latency_p99=float(np.percentile(lat_w, 99)),
        latencies=lat_w if keep_latencies else None,
        n_batches=len(bs),
        backend="sim",
    )
    return res
