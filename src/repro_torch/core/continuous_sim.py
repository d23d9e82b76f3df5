"""Beyond-paper: continuous (iteration-level) batching — the port's copy.

Own copy of the reference package's ``repro.core.continuous_sim``: the
port imports nothing of ``repro``, not even this module, which loads no
JAX.  What differs from the reference: ``simulate_continuous`` /
``simulate_static_generate`` default to ``backend="gen"``, the port's
``gen_sweep`` on CUDA (``device="cpu"`` on request), since the port's
entry points run on the card unless the caller asks for the CPU;
``backend="numpy"`` is the exact host loop, and the port's own oracle.

The reference module's description follows.

The paper's model serves each batch to completion (static batching — the
TF-Serving/Triton request-level batcher it analyzes). Modern LLM serving
(Orca, vLLM) instead reschedules at every decode iteration: new requests
join the running batch between token steps, finished sequences leave
immediately.

This module holds the *scalar numpy reference loops* for both
disciplines under one token-granular service model:

- a request = prefill of `prompt_len` tokens + `gen_tokens` decode steps,
- decode-step time  = α_d·b + τ0_d  (b = active sequences — the paper's
  linear law applied at token granularity),
- prefill time      = α_p·tokens + τ0_p,
- static discipline: the paper's batch-all-waiting over whole requests
  (service time = prefill(batch) + gen_tokens·decode-steps(batch)),
- continuous discipline: slots up to `max_active`; waiting requests are
  prefilled and join between steps; each step serves all active sequences.

The fast path is the vectorized token-level kernel
(``repro_torch.core.gen_sweep.gen_sweep`` / ``evaluate(grid,
backend="gen")``), which runs dense (load, prompt, gen_tokens,
max_active, discipline) grids in one call; these loops are kept as its
independent cross-check (pinned statistically in
``tests/test_torch_gen.py``).  The
``simulate_continuous``/``simulate_static_generate`` wrappers accept
``backend="gen"`` (default, on ``device``) or ``backend="numpy"``
(exact, slow, on the host).

Clock accounting is exact: both loops advance ``now`` through every
idle, prefill, and decode interval with no early-exit path, accumulate
``busy``/``span`` interval-by-interval, and report utilization over the
post-warmup measurement window — matching the kernel's convention, so
the parity tests pin kernel-vs-numpy utilization tightly.

The reference's comparison (benchmarks/continuous.py) shows the
queueing insight: static batching inflates latency with head-of-line
blocking at high load while continuous batching keeps E[W] near the
per-token service floor — but the *energy/throughput* monotonicity of
the paper (Corollary 1) applies unchanged, because both disciplines
still batch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.core.results import SimResult

__all__ = ["GenServiceModel", "ContinuousResult", "simulate_continuous",
           "simulate_static_generate", "simulate_continuous_numpy",
           "simulate_static_generate_numpy", "estimate_gen_steps"]


@dataclass(frozen=True)
class GenServiceModel:
    """Linear service laws at token granularity."""

    alpha_decode: float          # per-sequence marginal per decode step
    tau0_decode: float           # fixed cost per decode step
    alpha_prefill: float         # per-prompt-token marginal
    tau0_prefill: float          # fixed cost per prefill

    def decode_step(self, b: int) -> float:
        return self.alpha_decode * b + self.tau0_decode

    def prefill(self, tokens: int) -> float:
        return self.alpha_prefill * tokens + self.tau0_prefill

    def request_capacity(self, prompt_len: int, gen_tokens: int) -> float:
        """Saturation request rate 1/(gen·α_d + prompt·α_p) — the b→∞
        per-request service rate; λ/capacity is the normalized load ρ."""
        return 1.0 / (gen_tokens * self.alpha_decode
                      + prompt_len * self.alpha_prefill)

    def capped_capacity(self, prompt_len: int, gen_tokens: int,
                        max_active: int) -> float:
        """Saturation request rate with at most ``max_active``
        concurrent sequences: max_active requests per
        prefill(max_active·prompt) + gen·decode(max_active).  Loads
        normalized by this rate are stable for every ``max_active``
        (the b→∞ ``request_capacity`` is not reachable under a small
        slot cap)."""
        return max_active / (self.prefill(prompt_len * max_active)
                             + gen_tokens * self.decode_step(max_active))


@dataclass
class ContinuousResult(SimResult):
    """Shared ``SimResult`` schema for the generate simulators.

    ``mean_batch`` holds the mean *active* batch size (over decode steps
    for the continuous discipline, over request batches for static);
    ``mean_active`` is a readable alias.  ``discipline`` is inherited
    from ``SimResult``."""

    @property
    def mean_active(self) -> float:
        return self.mean_batch


def _arrivals(lam: float, n: int, rng) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / lam, size=n))


def estimate_gen_steps(lam: float, model: GenServiceModel, *,
                       prompt_len: int, gen_tokens: int, max_active: int,
                       n_jobs: int) -> int:
    """Kernel scan steps needed for ~``n_jobs`` completions.  The
    kernel advances one *run* of identical decode steps per scan step
    (run-length event skipping), and every run ends at a retirement, an
    admittable arrival, or an idle wake-up — each bounded by the job
    count — so ~4 steps per job is a conservative ceiling at any load
    (the 10% warmup and rare coverage splits included)."""
    del lam, model, prompt_len, gen_tokens, max_active  # load-free bound
    return max(512, int(4 * n_jobs))


def _gen_kernel_point(lam: float, model: GenServiceModel, *,
                      prompt_len: int, gen_tokens: int, max_active: int,
                      n_jobs: int, seed: int, discipline: str,
                      device) -> ContinuousResult:
    """One-point dispatch through the vectorized token-level kernel."""
    from repro_torch.core.gen_sweep import GenGrid, gen_sweep
    grid = GenGrid.from_points(
        [lam], model.alpha_decode, model.tau0_decode,
        model.alpha_prefill, model.tau0_prefill, prompt_len=prompt_len,
        gen_tokens=gen_tokens, max_active=max_active,
        discipline=discipline)
    n_steps = estimate_gen_steps(lam, model, prompt_len=prompt_len,
                                 gen_tokens=gen_tokens,
                                 max_active=max_active, n_jobs=n_jobs)
    r = gen_sweep(grid, n_steps=n_steps, seed=seed, device=device)
    if int(r.buffer_dropped.sum()):
        # same contract as the fleet wrapper: a capacity-clamped run is
        # biased, never return it silently
        raise RuntimeError(
            f"gen kernel dropped {int(r.buffer_dropped.sum())} arrivals "
            "(waiting queue or per-step arrival chain overflowed); "
            "the point is likely overloaded — lower the load or call "
            "gen_sweep directly with larger q_cap/a_cap")
    res = r.point(0)
    return ContinuousResult(**{f: getattr(res, f) for f in (
        "lam", "n_jobs", "mean_latency", "mean_batch", "batch_m2",
        "utilization", "latency_p50", "latency_p95", "latency_p99",
        "n_batches", "backend", "discipline")})


def simulate_continuous(lam: float, model: GenServiceModel, *,
                        prompt_len: int = 128, gen_tokens: int = 32,
                        max_active: int = 64, n_jobs: int = 20_000,
                        seed: int = 0, backend: str = "gen",
                        device=None) -> ContinuousResult:
    """Iteration-level scheduling: between decode steps, admit waiting
    requests (prefill runs inline, batched with one another).

    ``backend="gen"`` (default) dispatches one point through the
    vectorized kernel on ``device`` — CUDA unless ``device="cpu"`` —
    (``n_jobs`` is mapped to an equivalent decode-step count);
    ``backend="numpy"`` runs the exact scalar loop below on the host."""
    if backend == "gen":
        return _gen_kernel_point(lam, model, prompt_len=prompt_len,
                                 gen_tokens=gen_tokens,
                                 max_active=max_active, n_jobs=n_jobs,
                                 seed=seed, discipline="continuous",
                                 device=device)
    if backend != "numpy":
        raise ValueError(f"unknown backend {backend!r}")
    return simulate_continuous_numpy(
        lam, model, prompt_len=prompt_len, gen_tokens=gen_tokens,
        max_active=max_active, n_jobs=n_jobs, seed=seed)


def simulate_static_generate(lam: float, model: GenServiceModel, *,
                             prompt_len: int = 128, gen_tokens: int = 32,
                             b_max: Optional[int] = 64,
                             n_jobs: int = 20_000, seed: int = 0,
                             backend: str = "gen",
                             device=None) -> ContinuousResult:
    """The paper's batch-all-waiting discipline applied to whole generate
    requests: a batch of b requests holds the server for
    prefill(b·prompt) + gen_tokens · decode_step(b).  Backends as in
    ``simulate_continuous`` (the kernel needs finite ``b_max``)."""
    if backend == "gen":
        if not b_max:
            raise ValueError("backend 'gen' needs a finite b_max "
                             "(it is the kernel's slot-pool size)")
        return _gen_kernel_point(lam, model, prompt_len=prompt_len,
                                 gen_tokens=gen_tokens,
                                 max_active=int(b_max), n_jobs=n_jobs,
                                 seed=seed, discipline="static",
                                 device=device)
    if backend != "numpy":
        raise ValueError(f"unknown backend {backend!r}")
    return simulate_static_generate_numpy(
        lam, model, prompt_len=prompt_len, gen_tokens=gen_tokens,
        b_max=b_max, n_jobs=n_jobs, seed=seed)


def _result(lam: float, done: List[float], sizes: List[int],
            busy_meas: float, span_meas: float, n_jobs: int,
            discipline: str) -> ContinuousResult:
    lat = np.asarray(done[:n_jobs])
    w = int(len(lat) * 0.1)
    lat = lat[w:]
    s = np.asarray(sizes, dtype=float)
    return ContinuousResult(
        lam=lam, n_jobs=len(lat), mean_latency=float(lat.mean()),
        latency_p50=float(np.percentile(lat, 50)),
        latency_p95=float(np.percentile(lat, 95)),
        latency_p99=float(np.percentile(lat, 99)),
        mean_batch=float(s.mean()) if s.size else 0.0,
        batch_m2=float((s ** 2).mean()) if s.size else 0.0,
        n_batches=int(s.size),
        utilization=float(busy_meas / span_meas) if span_meas else 0.0,
        backend="sim",
        discipline=discipline)


def simulate_continuous_numpy(lam: float, model: GenServiceModel, *,
                              prompt_len: int = 128, gen_tokens: int = 32,
                              max_active: int = 64, n_jobs: int = 20_000,
                              seed: int = 0) -> ContinuousResult:
    """The exact per-decode-step loop (the kernel's cross-check).

    Each iteration is one scheduler cycle: jump over any idle interval
    to the next arrival, admit waiting requests into free slots (batched
    inline prefill), then one decode step for every active sequence.
    ``busy``/``span`` are accumulated interval-by-interval over the
    post-warmup window (measurement starts once 10% of jobs have
    finished), so utilization matches the kernel's convention."""
    rng = np.random.default_rng(seed)
    arr = _arrivals(lam, n_jobs, rng)
    warmup_jobs = int(n_jobs * 0.1)
    i = 0                                  # next arrival to admit
    now = 0.0
    busy_meas = 0.0
    span_meas = 0.0
    waiting: List[int] = []                # request ids
    active: List[List] = []                # [remaining_tokens, arrival_t]
    done: List[float] = []
    active_sizes: List[int] = []

    while len(done) < n_jobs:
        t0 = now
        measuring = len(done) >= warmup_jobs
        # admit arrivals that have occurred; if the system is empty and
        # none have, advance the clock over the idle interval first
        while i < n_jobs and arr[i] <= now:
            waiting.append(i)
            i += 1
        if not waiting and not active:
            # i < n_jobs always holds here: an empty system with no
            # waiting work means some arrivals are still to come
            now = max(now, arr[i])
            waiting.append(i)
            i += 1
        free = max_active - len(active)
        if waiting and free:
            join = waiting[:free]
            waiting = waiting[free:]
            # batched prefill of the joiners
            t_pf = model.prefill(prompt_len * len(join))
            now += t_pf
            for j in join:
                active.append([gen_tokens, arr[j]])
        else:
            t_pf = 0.0
        # one decode step for every active sequence (non-empty by
        # construction: admission above is unconditional when idle)
        b = len(active)
        active_sizes.append(b)
        dt = model.decode_step(b)
        now += dt
        if measuring:
            busy_meas += t_pf + dt
            span_meas += now - t0          # includes the idle jump
        still = []
        for seq in active:
            seq[0] -= 1
            if seq[0] == 0:
                done.append(now - seq[1])
            else:
                still.append(seq)
        active = still

    return _result(lam, done, active_sizes, busy_meas, span_meas,
                   n_jobs, "continuous")


def simulate_static_generate_numpy(lam: float, model: GenServiceModel, *,
                                   prompt_len: int = 128,
                                   gen_tokens: int = 32,
                                   b_max: Optional[int] = 64,
                                   n_jobs: int = 20_000,
                                   seed: int = 0) -> ContinuousResult:
    """The exact batch-at-a-time loop for the static discipline (same
    clock/measurement conventions as ``simulate_continuous_numpy``)."""
    rng = np.random.default_rng(seed)
    arr = _arrivals(lam, n_jobs, rng)
    warmup_jobs = int(n_jobs * 0.1)
    i = 0
    now = 0.0
    busy_meas = 0.0
    span_meas = 0.0
    waiting: List[int] = []
    done: List[float] = []
    batches: List[int] = []
    cap = b_max or n_jobs

    while len(done) < n_jobs:
        t0 = now
        measuring = len(done) >= warmup_jobs
        while i < n_jobs and arr[i] <= now:
            waiting.append(i)
            i += 1
        if not waiting:
            # idle: jump to the next arrival (one must exist — see the
            # continuous loop) and admit it
            now = max(now, arr[i])
            waiting.append(i)
            i += 1
        batch = waiting[:cap]
        waiting = waiting[cap:]
        b = len(batch)
        svc = model.prefill(prompt_len * b) + gen_tokens * model.decode_step(b)
        now += svc
        if measuring:
            busy_meas += svc
            span_meas += now - t0
        batches.append(b)
        for j in batch:
            done.append(now - arr[j])

    return _result(lam, done, batches, busy_meas, span_meas,
                   n_jobs, "static")
