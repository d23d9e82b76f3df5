"""Parameter grid and result record of the port's single-server sweep.

Own copy of the part of the reference package's ``repro.core.grid`` that
the ported kernels need: the integer codes, ``SweepGrid`` (every axis,
the loss and failure axes included — the port stores them so a
reference grid carries across whole, and its sweep refuses grids that
set them), the ``_LossAccounting`` mixin, ``SweepResult`` (without the
failure accounting fields, which come with the failure slice), and the
token-level ``GenGrid`` / ``GenResult`` of the generate sweep.  The
fleet and Markov grids come with the slices that port those kernels.
Plain numpy, no torch.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.hist import hist_edges, sketch_edges
from repro_torch.core.results import SimResult

__all__ = ["DIST_CODE", "DIST_NAME", "OVERFLOW_CODE", "OVERFLOW_NAME",
           "DISC_CODE", "DISC_NAME", "FAIL_DISC_CODE", "FAIL_DISC_NAME",
           "SweepGrid", "SweepResult", "GenGrid", "GenResult"]

DIST_CODE = {"det": 0, "exp": 1, "gamma": 2}
DIST_NAME = {v: k for k, v in DIST_CODE.items()}

# Finite-waiting-room overflow modes: "reject" turns an arrival away at
# its arrival epoch when q_max jobs already wait (an immediate 429);
# "drop" always buffers the arrival but evicts the newest jobs beyond
# q_max at the next batch-formation epoch (a 503 after queueing).  Both
# count in ``overflow_dropped``; ``q_max = 0`` means an infinite room.
OVERFLOW_CODE = {"reject": 0, "drop": 1}
OVERFLOW_NAME = {v: k for k, v in OVERFLOW_CODE.items()}

# Scheduling disciplines for the token-level generate kernel: "static" is
# the paper's batch-held-to-completion policy applied to whole generate
# requests; "continuous" is iteration-level (Orca/vLLM-style) scheduling
# where waiting requests join the running batch between decode steps.
DISC_CODE = {"static": 0, "continuous": 1}
DISC_NAME = {v: k for k, v in DISC_CODE.items()}

# Server-failure interruption disciplines (what happens to the work in
# flight when a replica breaks down mid-batch): "resume" carries the
# remaining batch work across the repair (preempt-resume), "restart"
# re-executes the interrupted batch from scratch after the repair
# (preempt-restart — spot-preemption work loss), "drop" abandons the
# in-flight jobs at the failure epoch and routes them to the retry
# orbit / loss accounting (fail-drop).
FAIL_DISC_CODE = {"resume": 0, "restart": 1, "drop": 2}
FAIL_DISC_NAME = {v: k for k, v in FAIL_DISC_CODE.items()}


# ---------------------------------------------------------------------------
# parameter grids
# ---------------------------------------------------------------------------

def _as_f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).reshape(-1)


def _as_i32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int32).reshape(-1)


class _GridOps:
    """Shared struct-of-arrays grid mechanics (length, concat, shard)."""

    def _arrays(self) -> Tuple[np.ndarray, ...]:
        raise NotImplementedError

    def __len__(self) -> int:
        return int(self._arrays()[0].shape[0])

    def concat(self, other):
        if type(other) is not type(self):
            raise TypeError(f"cannot concat {type(other).__name__} onto "
                            f"{type(self).__name__}")
        return type(self)(*[np.concatenate([a, b]) for a, b in
                            zip(self._arrays(), other._arrays())])

    def take(self, idx):
        """Sub-grid at ``idx`` (a slice or an integer index array) —
        dispatching subsets is the natural way to shard a grid, and the
        determinism tests rely on it (a point's result must not depend
        on which vmap batch it was dispatched in)."""
        return type(self)(*[np.asarray(a[idx]).reshape(-1)
                            for a in self._arrays()])


def _as_overflow_codes(overflow) -> List[int]:
    vals = ([overflow] if isinstance(overflow, str)
            else list(np.atleast_1d(overflow)))
    return [OVERFLOW_CODE[o] if isinstance(o, str) else int(o)
            for o in vals]


def _as_fail_disc_codes(fail_disc) -> List[int]:
    vals = ([fail_disc] if isinstance(fail_disc, str)
            else list(np.atleast_1d(fail_disc)))
    return [FAIL_DISC_CODE[d] if isinstance(d, str) else int(d)
            for d in vals]


def _as_disc_codes(discipline) -> List[int]:
    vals = ([discipline] if isinstance(discipline, str)
            else list(np.atleast_1d(discipline)))
    return [DISC_CODE[d] if isinstance(d, str) else int(d) for d in vals]


@dataclass(frozen=True)
class SweepGrid(_GridOps):
    """Struct-of-arrays parameter grid; one entry per simulated point.

    ``b_max = 0`` encodes an infinite maximum batch size (batch-all-
    waiting).  ``dist`` holds ``DIST_CODE`` integers; ``cv`` is only read
    for the gamma family.  ``wait_max``/``wait_target`` encode the
    timeout policy (0 ⇒ no artificial delay).

    The admission-control axes (all off by default): ``q_max`` bounds the
    waiting room (0 ⇒ infinite), ``overflow`` picks the ``OVERFLOW_CODE``
    regime used when it binds, ``deadline`` is the per-request SLO —
    waiting jobs renege (abandon) once their age exceeds it, and
    completions beyond it count against goodput (0 ⇒ no deadline) — and
    ``retry_rate`` closes the loop: every finally-lost job re-arrives
    after an Exp(retry_rate) backoff (0 ⇒ lost jobs leave forever).

    The server-failure axes (all off by default): ``mtbf`` is the mean
    time between failures of an exponential breakdown clock that runs
    only while the server is busy (0 ⇒ the server never fails),
    ``mttr`` the mean of the Exp repair time, ``fail_disc`` a
    ``FAIL_DISC_CODE`` integer picking the interruption discipline
    (resume / restart / drop), and ``throttle`` ≥ 1 scales the first
    post-repair batch's service mean (a degraded/thermal-throttle
    phase; 1 ⇒ no degradation)."""

    lam: np.ndarray
    alpha: np.ndarray
    tau0: np.ndarray
    b_max: np.ndarray
    dist: np.ndarray
    cv: np.ndarray
    wait_max: np.ndarray
    wait_target: np.ndarray
    q_max: np.ndarray
    deadline: np.ndarray
    overflow: np.ndarray
    retry_rate: np.ndarray
    mtbf: np.ndarray
    mttr: np.ndarray
    fail_disc: np.ndarray
    throttle: np.ndarray

    @property
    def rho(self) -> np.ndarray:
        return self.lam * self.alpha

    @property
    def has_loss(self) -> bool:
        """True when any point enables an admission-control regime.

        A fail-drop failure point also needs the loss machinery: its
        aborted in-flight jobs are filed through the same retry-orbit /
        abandonment accounting."""
        return bool(np.any(self.q_max > 0) or np.any(self.deadline > 0)
                    or np.any(self.retry_rate > 0)
                    or np.any((self.mtbf > 0)
                              & (self.fail_disc
                                 == FAIL_DISC_CODE["drop"])))

    @property
    def has_fail(self) -> bool:
        """True when any point enables the breakdown/repair regime."""
        return bool(np.any(self.mtbf > 0))

    @property
    def overflow_names(self) -> List[str]:
        return [OVERFLOW_NAME[int(o)] for o in self.overflow]

    @property
    def fail_disc_names(self) -> List[str]:
        return [FAIL_DISC_NAME[int(d)] for d in self.fail_disc]

    @classmethod
    def from_points(cls, lam, alpha, tau0, *, b_max=0, dist="det", cv=0.5,
                    wait_max=0.0, wait_target=0, q_max=0, deadline=0.0,
                    overflow="reject", retry_rate=0.0, mtbf=0.0,
                    mttr=0.0, fail_disc="resume",
                    throttle=1.0) -> "SweepGrid":
        """Build a grid from parallel per-point sequences (broadcast
        scalars to the common length)."""
        dist_codes = ([DIST_CODE[d] if isinstance(d, str) else int(d)
                       for d in np.atleast_1d(dist)]
                      if not isinstance(dist, str) else [DIST_CODE[dist]])
        arrays = [_as_f32(lam), _as_f32(alpha), _as_f32(tau0),
                  _as_i32(b_max), _as_i32(dist_codes), _as_f32(cv),
                  _as_f32(wait_max), _as_i32(wait_target),
                  _as_i32(q_max), _as_f32(deadline),
                  _as_i32(_as_overflow_codes(overflow)),
                  _as_f32(retry_rate), _as_f32(mtbf), _as_f32(mttr),
                  _as_i32(_as_fail_disc_codes(fail_disc)),
                  _as_f32(throttle)]
        n = max(a.shape[0] for a in arrays)
        arrays = [np.broadcast_to(a, (n,)).copy() if a.shape[0] == 1 else a
                  for a in arrays]
        if any(a.shape[0] != n for a in arrays):
            raise ValueError("per-point sequences have mismatched lengths")
        if np.any((arrays[12] > 0) & (arrays[13] <= 0)):
            raise ValueError("failure points (mtbf > 0) need mttr > 0")
        return cls(*arrays)

    @classmethod
    def from_product(cls, lams: Sequence[float], alphas: Sequence[float],
                     tau0s: Sequence[float], *,
                     b_maxes: Sequence[int] = (0,),
                     dists: Sequence[str] = ("det",),
                     cvs: Sequence[float] = (0.5,),
                     wait_maxes: Sequence[float] = (0.0,),
                     wait_targets: Sequence[int] = (0,),
                     q_maxes: Sequence[int] = (0,),
                     deadlines: Sequence[float] = (0.0,),
                     overflows: Sequence[str] = ("reject",),
                     retry_rates: Sequence[float] = (0.0,),
                     mtbfs: Sequence[float] = (0.0,),
                     mttrs: Sequence[float] = (0.0,),
                     fail_discs: Sequence[str] = ("resume",),
                     throttles: Sequence[float] = (1.0,)
                     ) -> "SweepGrid":
        """Cartesian product of per-axis values, flattened to one grid."""
        dist_codes = [DIST_CODE[d] if isinstance(d, str) else int(d)
                      for d in dists]
        mesh = np.meshgrid(_as_f32(lams), _as_f32(alphas), _as_f32(tau0s),
                           _as_i32(b_maxes), _as_i32(dist_codes),
                           _as_f32(cvs), _as_f32(wait_maxes),
                           _as_i32(wait_targets), _as_i32(q_maxes),
                           _as_f32(deadlines),
                           _as_i32(_as_overflow_codes(list(overflows))),
                           _as_f32(retry_rates), _as_f32(mtbfs),
                           _as_f32(mttrs),
                           _as_i32(_as_fail_disc_codes(list(fail_discs))),
                           _as_f32(throttles), indexing="ij")
        flat = [m.reshape(-1) for m in mesh]
        return cls.from_points(
            flat[0], flat[1], flat[2], b_max=flat[3], dist=flat[4],
            cv=flat[5], wait_max=flat[6], wait_target=flat[7],
            q_max=flat[8], deadline=flat[9], overflow=flat[10],
            retry_rate=flat[11], mtbf=flat[12], mttr=flat[13],
            fail_disc=flat[14], throttle=flat[15])

    @classmethod
    def from_rhos(cls, rhos: Sequence[float], alpha: float, tau0: float,
                  **kw) -> "SweepGrid":
        """Grid over normalized loads ρ = λα for one service model."""
        lams = [r / alpha for r in rhos]
        return cls.from_product(lams, [alpha], [tau0], **kw)

    def _arrays(self) -> Tuple[np.ndarray, ...]:
        return (self.lam, self.alpha, self.tau0, self.b_max, self.dist,
                self.cv, self.wait_max, self.wait_target, self.q_max,
                self.deadline, self.overflow, self.retry_rate,
                self.mtbf, self.mttr, self.fail_disc, self.throttle)


@dataclass(frozen=True)
class GenGrid(_GridOps):
    """Parameter grid for the token-level generate kernel.

    A request is a prefill of ``prompt_len`` tokens followed by
    ``gen_tokens`` decode steps; service is linear at token granularity
    (one decode step over b active sequences costs α_d·b + τ0_d, a
    batched prefill of t tokens costs α_p·t + τ0_p).  ``max_active``
    bounds the concurrent sequences (the static discipline's b_max);
    ``discipline`` holds ``DISC_CODE`` integers.  The loss and failure
    axes are stored so a reference grid carries across whole; the
    port's ``gen_sweep`` refuses grids that set them."""

    lam: np.ndarray
    alpha_decode: np.ndarray
    tau0_decode: np.ndarray
    alpha_prefill: np.ndarray
    tau0_prefill: np.ndarray
    prompt_len: np.ndarray
    gen_tokens: np.ndarray
    max_active: np.ndarray
    discipline: np.ndarray
    q_max: np.ndarray
    deadline: np.ndarray
    overflow: np.ndarray
    retry_rate: np.ndarray
    mtbf: np.ndarray
    mttr: np.ndarray
    fail_disc: np.ndarray
    throttle: np.ndarray

    @property
    def has_loss(self) -> bool:
        """True when any point enables an admission-control regime
        (fail-drop failure points need the loss machinery too)."""
        return bool(np.any(self.q_max > 0) or np.any(self.deadline > 0)
                    or np.any(self.retry_rate > 0)
                    or np.any((self.mtbf > 0)
                              & (self.fail_disc
                                 == FAIL_DISC_CODE["drop"])))

    @property
    def has_fail(self) -> bool:
        """True when any point enables the breakdown/repair regime."""
        return bool(np.any(self.mtbf > 0))

    @property
    def rho(self) -> np.ndarray:
        """Decode-capacity-normalized load: λ per request over the b→∞
        per-request service rate 1/(gen·α_d + prompt·α_p)."""
        return self.lam * (self.gen_tokens * self.alpha_decode
                           + self.prompt_len * self.alpha_prefill)

    @property
    def discipline_names(self) -> List[str]:
        return [DISC_NAME[int(d)] for d in self.discipline]

    @property
    def equivalent_alpha(self) -> np.ndarray:
        """Per-request marginal of the *static* discipline's batch law:
        a batch of b requests costs prefill(b·prompt) + gen·decode(b) =
        equivalent_alpha·b + equivalent_tau0 — the paper's Assumption 4
        at request granularity (see docs/theory.md)."""
        return (self.prompt_len * self.alpha_prefill
                + self.gen_tokens * self.alpha_decode)

    @property
    def equivalent_tau0(self) -> np.ndarray:
        return self.tau0_prefill + self.gen_tokens * self.tau0_decode

    @classmethod
    def from_points(cls, lam, alpha_decode, tau0_decode, alpha_prefill,
                    tau0_prefill, *, prompt_len=128, gen_tokens=32,
                    max_active=64, discipline="continuous", q_max=0,
                    deadline=0.0, overflow="reject",
                    retry_rate=0.0, mtbf=0.0, mttr=0.0,
                    fail_disc="resume", throttle=1.0) -> "GenGrid":
        arrays = [_as_f32(lam), _as_f32(alpha_decode), _as_f32(tau0_decode),
                  _as_f32(alpha_prefill), _as_f32(tau0_prefill),
                  _as_i32(prompt_len), _as_i32(gen_tokens),
                  _as_i32(max_active),
                  _as_i32(_as_disc_codes(discipline)),
                  _as_i32(q_max), _as_f32(deadline),
                  _as_i32(_as_overflow_codes(overflow)),
                  _as_f32(retry_rate), _as_f32(mtbf), _as_f32(mttr),
                  _as_i32(_as_fail_disc_codes(fail_disc)),
                  _as_f32(throttle)]
        n = max(a.shape[0] for a in arrays)
        arrays = [np.broadcast_to(a, (n,)).copy() if a.shape[0] == 1 else a
                  for a in arrays]
        if any(a.shape[0] != n for a in arrays):
            raise ValueError("per-point sequences have mismatched lengths")
        if np.any(arrays[7] < 1):
            raise ValueError("max_active must be >= 1")
        if np.any(arrays[6] < 1):
            raise ValueError("gen_tokens must be >= 1")
        if np.any((arrays[13] > 0) & (arrays[14] <= 0)):
            raise ValueError("failure points (mtbf > 0) need mttr > 0")
        return cls(*arrays)

    @classmethod
    def from_product(cls, lams: Sequence[float], model, *,
                     prompt_lens: Sequence[int] = (128,),
                     gen_tokens: Sequence[int] = (32,),
                     max_actives: Sequence[int] = (64,),
                     disciplines: Sequence[str] = ("continuous",),
                     q_maxes: Sequence[int] = (0,),
                     deadlines: Sequence[float] = (0.0,),
                     overflows: Sequence[str] = ("reject",),
                     retry_rates: Sequence[float] = (0.0,),
                     mtbfs: Sequence[float] = (0.0,),
                     mttrs: Sequence[float] = (0.0,),
                     fail_discs: Sequence[str] = ("resume",),
                     throttles: Sequence[float] = (1.0,)
                     ) -> "GenGrid":
        """Cartesian product of the sweep axes for one token-level
        service model (a ``GenServiceModel`` or anything with its four
        constants)."""
        disc = _as_i32(_as_disc_codes(list(disciplines)))
        mesh = np.meshgrid(_as_f32(lams), _as_i32(prompt_lens),
                           _as_i32(gen_tokens), _as_i32(max_actives),
                           disc, _as_i32(q_maxes), _as_f32(deadlines),
                           _as_i32(_as_overflow_codes(list(overflows))),
                           _as_f32(retry_rates), _as_f32(mtbfs),
                           _as_f32(mttrs),
                           _as_i32(_as_fail_disc_codes(list(fail_discs))),
                           _as_f32(throttles), indexing="ij")
        flat = [m.reshape(-1) for m in mesh]
        return cls.from_points(
            flat[0].astype(np.float32), model.alpha_decode,
            model.tau0_decode, model.alpha_prefill, model.tau0_prefill,
            prompt_len=flat[1], gen_tokens=flat[2], max_active=flat[3],
            discipline=flat[4], q_max=flat[5], deadline=flat[6],
            overflow=flat[7], retry_rate=flat[8], mtbf=flat[9],
            mttr=flat[10], fail_disc=flat[11], throttle=flat[12])

    @classmethod
    def from_rhos(cls, rhos: Sequence[float], model, **axes) -> "GenGrid":
        """Product grid over decode-capacity-normalized loads ρ: each
        (ρ, prompt, gen, ...) point gets λ = ρ/(gen·α_d + prompt·α_p),
        so points at different token counts face the same relative
        load.  ``axes`` are ``from_product``'s keyword axes."""
        grid = cls.from_product([1.0] * len(rhos), model, **axes)
        reps = len(grid) // len(rhos)
        rho_pts = np.repeat(_as_f32(list(rhos)), reps)
        lam = rho_pts / (grid.gen_tokens * grid.alpha_decode
                         + grid.prompt_len * grid.alpha_prefill)
        return cls(lam.astype(np.float32), *grid._arrays()[1:])

    def _arrays(self) -> Tuple[np.ndarray, ...]:
        return (self.lam, self.alpha_decode, self.tau0_decode,
                self.alpha_prefill, self.tau0_prefill, self.prompt_len,
                self.gen_tokens, self.max_active, self.discipline,
                self.q_max, self.deadline, self.overflow,
                self.retry_rate, self.mtbf, self.mttr, self.fail_disc,
                self.throttle)



class _LossAccounting:
    """Derived goodput/loss metrics shared by the MC result classes.

    Every *measured* job is counted exactly once at its terminal outcome
    (a retried job is one offered job; its re-arrivals only inflate
    ``n_retry``): ``offered = n_jobs + overflow_dropped + abandoned``,
    and ``goodput_frac + late_frac + reject_frac + abandon_frac = 1``
    exactly.  Without loss regimes every fraction degenerates correctly
    (goodput_frac = 1, losses = 0, retry_inflation = 1).

    Degenerate denominators keep the same convention: a point with
    ``offered == 0`` (nothing measured — e.g. a warmup-dominated or
    zero-rate lane) reports goodput_frac = 1 and losses = 0, so the
    partition identity still holds; ``retry_inflation`` is pinned to 1
    when ``n_fresh == 0`` (a retry stream with no measured fresh
    arrivals carries no inflation evidence — the old ratio exploded to
    ``n_retry``)."""

    @property
    def offered(self) -> np.ndarray:
        """Measured jobs reaching a terminal outcome (done or lost)."""
        return (self.n_jobs + self.overflow_dropped
                + self.abandoned).astype(np.float64)

    @property
    def _offered_safe(self) -> np.ndarray:
        return np.maximum(self.offered, 1.0)

    @property
    def goodput_frac(self) -> np.ndarray:
        """Fraction of offered jobs completed within their deadline
        (1 where nothing was offered — see the class docstring)."""
        return np.where(self.offered > 0,
                        self.n_in_slo / self._offered_safe, 1.0)

    @property
    def reject_frac(self) -> np.ndarray:
        """Fraction of offered jobs finally lost to the waiting room."""
        return self.overflow_dropped / self._offered_safe

    @property
    def abandon_frac(self) -> np.ndarray:
        """Fraction of offered jobs that finally reneged in queue."""
        return self.abandoned / self._offered_safe

    @property
    def late_frac(self) -> np.ndarray:
        """Fraction completed but past deadline (0 with no deadline)."""
        return (self.n_jobs - self.n_in_slo) / self._offered_safe

    @property
    def goodput(self) -> np.ndarray:
        """Rate of jobs completed within SLO, λ·goodput_frac."""
        return self.grid.lam * self.goodput_frac

    @property
    def throughput(self) -> np.ndarray:
        """Rate of jobs completed at all, λ·(n_jobs/offered)."""
        return self.grid.lam * (self.n_jobs / self._offered_safe)

    @property
    def retry_inflation(self) -> np.ndarray:
        """Arrival-stream inflation (fresh+retry)/fresh ≥ 1 (pinned to
        1 where no fresh arrival was measured)."""
        return np.where(self.n_fresh > 0,
                        (self.n_fresh + self.n_retry)
                        / np.maximum(self.n_fresh, 1.0), 1.0)


@dataclass
class SweepResult(_LossAccounting):
    """Struct-of-arrays sweep output; ``point(i)``/``to_results()`` view it
    through the backend-independent ``SimResult`` schema.

    ``buffer_dropped`` is the capacity-sizing witness — arrivals lost to
    the *internal* buffer clamps (``q_cap``/``a_cap``), which must stay 0
    in a well-sized run.  ``overflow_dropped``/``abandoned`` are the
    *measured* admission-control losses (finite ``q_max`` overflow and
    deadline reneging) — legitimate outputs, not witnesses."""

    grid: SweepGrid
    mean_latency: np.ndarray
    latency_p50: np.ndarray
    latency_p95: np.ndarray
    latency_p99: np.ndarray
    mean_batch: np.ndarray
    batch_m2: np.ndarray
    mean_service: np.ndarray
    utilization: np.ndarray
    n_jobs: np.ndarray
    n_batches: np.ndarray
    max_queue: np.ndarray
    buffer_dropped: np.ndarray        # arrivals lost to capacity clamps
    overflow_dropped: np.ndarray      # finite-q_max losses (both modes)
    abandoned: np.ndarray             # deadline reneges in queue
    n_in_slo: np.ndarray              # completions within deadline
    n_fresh: np.ndarray               # measured first-time arrivals
    n_retry: np.ndarray               # measured orbit re-arrivals
    hist: np.ndarray = field(repr=False)           # (N, n_bins) counts
    # streaming-sketch runs (sketch=True) also carry the per-bin latency
    # sums their fused kernel accumulates; None on full-histogram runs
    hist_sums: np.ndarray = field(default=None, repr=False)
    # regenerative batch-means error bars (one sample per superstep
    # block, Welford-accumulated in the scan carry): the mean-latency
    # standard error, its 95% CI half-width, and the block count the
    # estimate rests on.  NaN where fewer than two blocks completed
    # jobs (zero-rate points, runs shorter than two supersteps).
    stderr: np.ndarray = field(default=None, repr=False)
    ci_halfwidth: np.ndarray = field(default=None, repr=False)
    n_blocks: np.ndarray = field(default=None, repr=False)

    @property
    def hist_bin_edges(self) -> np.ndarray:
        """Latency values bounding the (shared) histogram bins — the
        sketch's log-spaced edges on a sketch run (identified by the
        per-bin sums only that mode accumulates)."""
        if self.hist_sums is not None:
            return sketch_edges()
        return hist_edges(self.hist.shape[1])

    def __len__(self) -> int:
        return len(self.grid)

    @property
    def mean_wait(self) -> np.ndarray:
        return self.mean_latency - self.mean_service

    def eta(self, beta: float, c0: float) -> np.ndarray:
        from repro_torch.core.energy import eta_given_EB
        return eta_given_EB(self.mean_batch, beta, c0)

    def point(self, i: int) -> SimResult:
        return SimResult(
            lam=float(self.grid.lam[i]),
            n_jobs=int(self.n_jobs[i]),
            mean_latency=float(self.mean_latency[i]),
            mean_batch=float(self.mean_batch[i]),
            batch_m2=float(self.batch_m2[i]),
            utilization=float(self.utilization[i]),
            mean_wait=float(self.mean_wait[i]),
            mean_service=float(self.mean_service[i]),
            latency_p50=float(self.latency_p50[i]),
            latency_p95=float(self.latency_p95[i]),
            latency_p99=float(self.latency_p99[i]),
            n_batches=int(self.n_batches[i]),
            backend="sweep",
            stderr=(float(self.stderr[i]) if self.stderr is not None
                    else float("nan")),
            ci_halfwidth=(float(self.ci_halfwidth[i])
                          if self.ci_halfwidth is not None
                          else float("nan")),
            goodput_frac=float(self.goodput_frac[i]),
            reject_frac=float(self.reject_frac[i]),
            abandon_frac=float(self.abandon_frac[i]),
            retry_inflation=float(self.retry_inflation[i]),
        )

    def to_results(self) -> List[SimResult]:
        return [self.point(i) for i in range(len(self))]


@dataclass
class GenResult(_LossAccounting):
    """Token-level sweep output (one entry per ``GenGrid`` point).

    ``mean_batch``/``batch_m2`` are moments of the *active batch size
    per decode step* (for the static discipline, with per-point-constant
    ``gen_tokens``, these equal the per-request-batch moments, since
    every batch contributes ``gen_tokens`` equal steps).  ``n_steps``
    counts measured decode steps; ``n_jobs`` counts requests that
    *finished* inside the measured window (their latencies feed
    ``mean_latency`` and the histogram percentiles).  The loss counters
    follow the ``SweepResult`` split: ``buffer_dropped`` is the capacity
    witness (must stay 0), ``overflow_dropped``/``abandoned`` the
    measured admission-control losses (0 until the loss slice)."""

    grid: GenGrid
    mean_latency: np.ndarray
    latency_p50: np.ndarray
    latency_p95: np.ndarray
    latency_p99: np.ndarray
    mean_batch: np.ndarray
    batch_m2: np.ndarray
    utilization: np.ndarray
    n_jobs: np.ndarray
    n_steps: np.ndarray
    max_queue: np.ndarray
    buffer_dropped: np.ndarray        # arrivals lost to capacity clamps
    overflow_dropped: np.ndarray      # finite-q_max losses (both modes)
    abandoned: np.ndarray             # deadline reneges in queue
    n_in_slo: np.ndarray              # completions within deadline
    n_fresh: np.ndarray               # measured first-time arrivals
    n_retry: np.ndarray               # measured orbit re-arrivals
    hist: np.ndarray = field(repr=False)           # (N, n_bins) counts
    hist_sums: np.ndarray = field(default=None, repr=False)
    # regenerative batch-means error bars — see SweepResult
    stderr: np.ndarray = field(default=None, repr=False)
    ci_halfwidth: np.ndarray = field(default=None, repr=False)
    n_blocks: np.ndarray = field(default=None, repr=False)

    @property
    def hist_bin_edges(self) -> np.ndarray:
        if self.hist_sums is not None:
            return sketch_edges()
        return hist_edges(self.hist.shape[1])

    def __len__(self) -> int:
        return len(self.grid)

    @property
    def mean_active(self) -> np.ndarray:
        """Readable alias: mean active sequences per decode step."""
        return self.mean_batch

    def point(self, i: int) -> SimResult:
        return SimResult(
            lam=float(self.grid.lam[i]),
            n_jobs=int(self.n_jobs[i]),
            mean_latency=float(self.mean_latency[i]),
            mean_batch=float(self.mean_batch[i]),
            batch_m2=float(self.batch_m2[i]),
            utilization=float(self.utilization[i]),
            latency_p50=float(self.latency_p50[i]),
            latency_p95=float(self.latency_p95[i]),
            latency_p99=float(self.latency_p99[i]),
            n_batches=int(self.n_steps[i]),
            backend="gen",
            stderr=(float(self.stderr[i]) if self.stderr is not None
                    else float("nan")),
            ci_halfwidth=(float(self.ci_halfwidth[i])
                          if self.ci_halfwidth is not None
                          else float("nan")),
            discipline=DISC_NAME[int(self.grid.discipline[i])],
            goodput_frac=float(self.goodput_frac[i]),
            reject_frac=float(self.reject_frac[i]),
            abandon_frac=float(self.abandon_frac[i]),
            retry_inflation=float(self.retry_inflation[i]),
        )

    def to_results(self) -> List[SimResult]:
        return [self.point(i) for i in range(len(self))]
