"""Scalar numpy references for the loss regimes — the port's copy.

Own copy of the reference package's ``repro.core.loss_ref``: the port
imports nothing of ``repro``, not even this module, which loads no JAX
(it imports ``math``, ``dataclasses`` and ``numpy`` only).  It is the
port's own oracle for the loss paths of ``repro_torch.core.sweep`` and
``repro_torch.core.gen_sweep`` on the card, as ``continuous_sim``'s
numpy loops are for the generate sweep, and it keeps the fleet and
failure mirrors for the slices that port those kernels.  The code is
the reference's, unchanged.

The reference module's description follows.

Scalar numpy references for the admission-control (loss) regimes.

The JAX kernels in ``repro.core.sweep`` / ``repro.core.gen_sweep``
implement finite waiting rooms, deadlines with reneging, and the
bounded retry orbit behind a compile-time ``has_loss`` flag.  This
module re-implements the same stochastic laws as plain chronological
numpy event loops — independent RNG, no vectorization tricks — so the
statistical tests (``tests/test_backpressure.py``) can pin the kernels'
goodput / reject / abandon fractions on a seed ladder, the same
cross-check contract the lossless kernels have against
``repro.core.simulate`` and ``repro.core.continuous_sim``.

Shared loss semantics (all three mirrors, matching the kernels):

- ``reject`` ("429"): each arrival is tested at its own epoch against
  the admission room (``q_max``, or the physical ``q_cap`` when
  ``q_max = 0``); a turned-away arrival is an overflow loss.
- ``drop`` ("503"): arrivals always buffer (up to ``q_cap``); at each
  batch-formation epoch the NEWEST waiting jobs beyond ``q_max`` are
  evicted as overflow losses.
- deadline: at each formation epoch, waiting jobs whose wait exceeds
  ``deadline`` renege (the expired set is a FIFO prefix).  A batch can
  be emptied by reneging — it then forms nothing and no service time
  elapses.  The SLO check on completions is total latency ≤ deadline.
- retry: lost jobs (abandoned filed first, then overflow) enter a
  bounded orbit of ``r_cap`` jobs; whatever the orbit cannot hold is a
  terminal loss in its own class.  At every *event epoch* each orbit
  job re-fires independently with p = 1 − exp(−retry_rate·Δ) over the
  inter-event gap Δ (exact Binomial thinning of exponential backoff
  clocks, discretized to event epochs), re-arriving at that epoch
  against the physical room; the unfired/unadmitted remainder stays in
  orbit.  A job's losses are filed AFTER the epoch's retry draw, so a
  loss can first re-fire at the NEXT event — matching the kernels.

Accounting (identical to ``repro.core.grid._LossAccounting``): every
measured *offered* job — fresh arrivals, counted once even if it later
retries — ends in exactly one of four classes: completed in SLO
(goodput), completed late, finally rejected (overflow), finally
abandoned.  ``retry_inflation = (fresh + retry arrivals)/fresh``.

Server failures (``mtbf``/``mttr``/``fail_disc``/``throttle``): the
mirrors implement the kernels' breakdown/repair law per server — an
exponential MTBF clock that runs only while executing, Exp(mttr)
repairs, preempt-resume / preempt-restart / fail-drop interruption
disciplines, and a ×throttle degraded first batch after any repair.
The one deliberate difference: the restart attempt count is sampled
UNBOUNDED here where the kernels truncate the geometric at a fixed
block of 16 attempts (P ≈ 4e-7 at the loads tested) — the mirrors are
statistical references on a seed ladder, not bitwise ones.  fail-drop
routes the aborted batch's jobs through the abandonment/retry path,
exactly like the kernels; the fleet mirror skips *impaired* replicas
(last formation hit a failure) in random/round-robin routing and
penalizes them under JSQ, falling back to all replicas when every one
is impaired.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = ["LossRefResult", "simulate_loss_numpy",
           "simulate_fleet_loss_numpy", "simulate_gen_loss_numpy"]


@dataclass
class LossRefResult:
    """Loss-path accounting of one reference run (measured window)."""

    mean_latency: float
    utilization: float
    n_jobs: int                 # completed jobs
    offered: int                # fresh measured arrivals incl. losses
    n_in_slo: int
    overflow_dropped: int       # terminal overflow losses
    abandoned: int              # terminal reneging losses
    n_fresh: int
    n_retry: int                # retry re-arrival attempts

    @property
    def goodput_frac(self) -> float:
        return self.n_in_slo / max(self.offered, 1)

    @property
    def reject_frac(self) -> float:
        return self.overflow_dropped / max(self.offered, 1)

    @property
    def abandon_frac(self) -> float:
        return self.abandoned / max(self.offered, 1)

    @property
    def late_frac(self) -> float:
        return (self.n_jobs - self.n_in_slo) / max(self.offered, 1)

    # breakdown/repair accounting (zeros when failures are off)
    n_failures: int = 0
    down_time: float = 0.0          # repair time, summed over servers
    lost_work: float = 0.0          # re-executed / aborted partial work
    span: float = 0.0               # measured wall-clock, × k servers

    @property
    def retry_inflation(self) -> float:
        return (self.n_fresh + self.n_retry) / max(self.n_fresh, 1)

    @property
    def availability(self) -> float:
        return 1.0 - self.down_time / max(self.span, 1e-30)

    @property
    def work_loss_frac(self) -> float:
        tot = self.down_time + self.lost_work
        busy = self.utilization * max(self.span, 1e-30)
        return self.lost_work / max(busy + self.lost_work, 1e-30) \
            if tot > 0.0 else 0.0


def _rooms(q_max: int, overflow: str, q_cap: int):
    """(admission room, drop-mode trim level, retry re-entry room)."""
    if overflow not in ("reject", "drop"):
        raise ValueError(f"unknown overflow mode {overflow!r}")
    if q_max > q_cap:
        raise ValueError("q_max exceeds q_cap")
    is_reject = overflow == "reject"
    roomv = q_max if (q_max > 0 and is_reject) else q_cap
    trim_to = q_max if (q_max > 0 and not is_reject) else q_cap
    retry_room = min(q_max, q_cap) if q_max > 0 else q_cap
    return roomv, trim_to, retry_room


class _Orbit:
    """Bounded retry orbit with the kernels' draw-then-file ordering."""

    def __init__(self, rng, retry_rate: float, r_cap: int):
        self.rng, self.rate, self.r_cap = rng, float(retry_rate), r_cap
        self.on = self.rate > 0.0
        self.R = 0

    def draws(self, elapsed: float) -> int:
        if not self.on or self.R == 0 or elapsed <= 0.0:
            return 0
        p = 1.0 - math.exp(-self.rate * elapsed)
        n = int(self.rng.binomial(self.R, p))
        self.R -= n
        return n

    def unfired(self, n: int) -> None:
        self.R += n

    def file(self, lost_ab: int, lost_ov: int):
        """File this epoch's losses, abandoned first; returns the
        terminal (abandoned, overflow) remainders."""
        room = max(self.r_cap - self.R, 0) if self.on else 0
        take_a = min(lost_ab, room)
        take_b = min(lost_ov, room - take_a)
        self.R += take_a + take_b
        return lost_ab - take_a, lost_ov - take_b


class _Failures:
    """Per-server breakdown/repair law (see module docstring).

    ``scale(r)`` is the degraded-phase service multiplier consumed at
    the next formation; ``draw(s, r)`` runs the failure clock over one
    execution of length ``s`` and returns
    ``(comp, busy, repair, lost, n_failures, aborted)`` — wall-clock
    completion, productive execution, repair time, lost partial work,
    failure count, and the fail-drop abort flag."""

    def __init__(self, rng, mtbf: float, mttr: float, fail_disc: str,
                 throttle: float, k: int = 1):
        self.rng = rng
        self.on = mtbf is not None and mtbf > 0.0
        self.mtbf = float(mtbf or 0.0)
        self.mttr = float(mttr or 0.0)
        self.disc = fail_disc
        self.throttle = float(throttle if throttle else 1.0)
        self.deg = [False] * k
        if self.on:
            if self.mttr <= 0.0:
                raise ValueError("mttr must be > 0 when mtbf is set")
            if fail_disc not in ("resume", "restart", "drop"):
                raise ValueError(f"unknown fail_disc {fail_disc!r}")

    def scale(self, r: int = 0) -> float:
        return self.throttle if (self.on and self.deg[r]) else 1.0

    def draw(self, s: float, r: int = 0):
        if not self.on:
            return s, s, 0.0, 0.0, 0, False
        if s <= 0.0:
            # kernels compute deg = fail_on & (n_f > 0) even on a
            # batchless step — the degraded phase does not survive idle
            self.deg[r] = False
            return s, s, 0.0, 0.0, 0, False
        rng, xi = self.rng, 1.0 / self.mtbf
        if self.disc == "resume":
            M = int(rng.poisson(xi * s))
            rep = float(rng.gamma(M, self.mttr)) if M > 0 else 0.0
            out = (s + rep, s, rep, 0.0, M, False)
        elif self.disc == "restart":
            n, lost, rep = 0, 0.0, 0.0
            while True:
                e = rng.exponential(self.mtbf)
                if e >= s:
                    break
                n += 1
                lost += e
                rep += rng.exponential(self.mttr)
            out = (s + lost + rep, s, rep, lost, n, False)
        else:                                        # fail-drop
            e = rng.exponential(self.mtbf)
            if e < s:
                rp = rng.exponential(self.mttr)
                out = (e + rp, 0.0, rp, e, 1, True)
            else:
                out = (s, s, 0.0, 0.0, 0, False)
        self.deg[r] = out[4] > 0
        return out


def simulate_loss_numpy(lam: float, model, b_max: int, *,
                        q_max: int = 0, deadline: float = 0.0,
                        overflow: str = "reject",
                        retry_rate: float = 0.0,
                        q_cap: int = 4096, r_cap: int = 256,
                        dist: str = "det", cv: float = 1.0,
                        mtbf: float = 0.0, mttr: float = 0.0,
                        fail_disc: str = "resume",
                        throttle: float = 1.0,
                        n_batches: int = 20_000,
                        warmup: int | None = None,
                        seed: int = 0) -> LossRefResult:
    """Single-server mirror of the ``sweep`` kernel's loss step.

    One loop iteration is one service completion: idle jump (one
    arrival a.s. ends an idle period), renege at the formation epoch,
    pop ``min(q, b_max)``, drop-mode trim, Poisson arrivals over the
    service window admitted one-by-one against the room, then the
    retry-orbit assessment at the departure epoch.  ``model`` is any
    object with ``alpha``/``tau0`` (e.g. ``LinearServiceModel``).
    """
    rng = np.random.default_rng(seed)
    if warmup is None:
        warmup = max(1, n_batches // 10)
    alpha, tau0 = float(model.alpha), float(model.tau0)
    b_cap = b_max if b_max and b_max > 0 else q_cap
    roomv, trim_to, retry_room = _rooms(q_max, overflow, q_cap)
    orbit = _Orbit(rng, retry_rate, r_cap)
    fail = _Failures(rng, mtbf, mttr, fail_disc, throttle)
    gamma_shape = 1.0 if dist == "exp" else 1.0 / (cv * cv)

    queue: list[float] = []       # waiting arrival epochs, FIFO
    prev_depart = 0.0
    lat_sum = busy = span = down = lwork = 0.0
    lat_n = slo_n = ov_n = ab_n = fresh_n = retry_n = nfail_n = 0

    for i in range(n_batches):
        meas = i >= warmup
        fresh = lost_ab = lost_ov = 0

        now = prev_depart
        if not queue:
            now += rng.exponential(1.0 / lam)
            queue.append(now)
            fresh += 1
        release = now

        if deadline > 0.0:
            while queue and queue[0] < release - deadline:
                queue.pop(0)
                lost_ab += 1

        b = min(len(queue), b_cap)
        if b > 0:
            s = alpha * b + tau0
            if dist != "det":
                s *= rng.gamma(gamma_shape) / gamma_shape
            s *= fail.scale()
        else:
            s = 0.0
        comp, s_busy, rep, lost, n_f, aborted = fail.draw(s)
        depart = release + comp

        popped, queue = queue[:b], queue[b:]
        if aborted:
            lost_ab += b          # the aborted batch retries/abandons
        if meas:
            if not aborted:
                for arr in popped:
                    w = depart - arr
                    lat_sum += w
                    slo_n += int(deadline <= 0.0 or w <= deadline)
                lat_n += b
            busy += s_busy
            span += depart - prev_depart
            down += rep
            lwork += lost
            nfail_n += n_f

        while len(queue) > trim_to:       # drop-mode formation trim
            queue.pop()
            lost_ov += 1

        t = release                        # service-window arrivals
        while True:
            t += rng.exponential(1.0 / lam)
            if t > depart:
                break
            fresh += 1
            if len(queue) < roomv:
                queue.append(t)
            else:
                lost_ov += 1

        n_r = orbit.draws(depart - prev_depart)
        admit_r = min(n_r, max(retry_room - len(queue), 0))
        queue.extend([depart] * admit_r)
        orbit.unfired(n_r - admit_r)
        term_ab, term_ov = orbit.file(lost_ab, lost_ov)

        if meas:
            ab_n += term_ab
            ov_n += term_ov
            fresh_n += fresh
            retry_n += n_r
        prev_depart = depart

    return LossRefResult(
        mean_latency=lat_sum / max(lat_n, 1),
        utilization=busy / max(span, 1e-30),
        n_jobs=lat_n, offered=lat_n + ov_n + ab_n, n_in_slo=slo_n,
        overflow_dropped=ov_n, abandoned=ab_n,
        n_fresh=fresh_n, n_retry=retry_n,
        n_failures=nfail_n, down_time=down, lost_work=lwork, span=span)


def simulate_fleet_loss_numpy(lam: float, model, b_max: int, *,
                              k: int = 1, routing: str = "random",
                              q_max: int = 0, deadline: float = 0.0,
                              overflow: str = "reject",
                              retry_rate: float = 0.0,
                              q_cap: int = 4096, r_cap: int = 256,
                              dist: str = "det", cv: float = 1.0,
                              mtbf: float = 0.0, mttr: float = 0.0,
                              fail_disc: str = "resume",
                              throttle: float = 1.0,
                              n_events: int = 40_000,
                              warmup: int | None = None,
                              seed: int = 0) -> LossRefResult:
    """Fleet mirror of the ``fleet_sweep`` kernel's loss semantics.

    Chronological event loop over ``k`` replica queues: arrivals are
    routed at their own epoch (random / round_robin / jsq on
    ``q + in_service``, ties to the lowest index) and tested against
    the per-replica room; each replica decision event reneges its
    expired prefix, forms ``min(q, b_max)``, trims (drop mode), and
    the retry orbit is assessed once per decision event with the block
    routed whole to one replica (round-robin reads the cursor without
    advancing it; JSQ uses the post-event load) — the kernel's exact
    convention.  Losses file after the event's retry draw.
    """
    rng = np.random.default_rng(seed)
    if warmup is None:
        warmup = max(1, n_events // 10)
    alpha, tau0 = float(model.alpha), float(model.tau0)
    b_cap = b_max if b_max and b_max > 0 else q_cap
    roomv, trim_to, retry_room = _rooms(q_max, overflow, q_cap)
    orbit = _Orbit(rng, retry_rate, r_cap)
    fail = _Failures(rng, mtbf, mttr, fail_disc, throttle, k=k)
    gamma_shape = 1.0 if dist == "exp" else 1.0 / (cv * cv)
    INF = float("inf")
    IMP_PENALTY = 1 << 19         # JSQ load penalty on impaired replicas

    queues: list[list[float]] = [[] for _ in range(k)]
    in_service = [0] * k
    committed = [False] * k
    imp = [False] * k             # last formation hit a failure
    t_free = [INF] * k
    rr = 0
    clock = 0.0
    t_arr = rng.exponential(1.0 / lam)
    lost_ov_pending = 0
    lat_sum = busy = span = down = lwork = 0.0
    lat_n = slo_n = ov_n = ab_n = fresh_n = retry_n = nfail_n = 0
    events = 0

    def _eligible() -> list[int]:
        """Replicas arrivals may target: the non-impaired ones, or all
        of them when every replica is impaired (never stall)."""
        ok = [j for j in range(k) if not imp[j]]
        return ok if ok else list(range(k))

    def _route_one(advance_rr: bool) -> int:
        nonlocal rr
        if routing == "random":
            cand = _eligible()
            return cand[int(rng.integers(len(cand)))]
        if routing == "round_robin":
            cand = set(_eligible())
            start = rr % k
            if advance_rr:
                rr += 1
            for off in range(k):
                j = (start + off) % k
                if j in cand:
                    return j
            return start                           # unreachable
        loads = [len(queues[j]) + in_service[j]
                 + (IMP_PENALTY if imp[j] else 0) for j in range(k)]
        return int(np.argmin(loads))

    def _route_arrival() -> int:
        return _route_one(advance_rr=True)

    while events < n_events:
        t_dec = min(t_free)
        if t_arr <= t_dec:
            # arrival: route, admit against the per-replica room
            d = _route_arrival()
            if events >= warmup:
                fresh_n += 1
            if len(queues[d]) < roomv:
                queues[d].append(t_arr)
                if not committed[d]:
                    committed[d] = True
                    t_free[d] = t_arr
            else:
                lost_ov_pending += 1
            t_arr += rng.exponential(1.0 / lam)
            continue

        # decision event on the earliest committed replica
        r = int(np.argmin(t_free))
        t_ev = t_free[r]
        meas = events >= warmup
        q = queues[r]
        lost_ab = 0
        if deadline > 0.0:
            while q and q[0] < t_ev - deadline:
                q.pop(0)
                lost_ab += 1

        b = min(len(q), b_cap)
        if b > 0:
            s = alpha * b + tau0
            if dist != "det":
                s *= rng.gamma(gamma_shape) / gamma_shape
            s *= fail.scale(r)
            comp, s_busy, rep, lost, n_f, aborted = fail.draw(s, r)
            imp[r] = n_f > 0
            popped, queues[r] = q[:b], q[b:]
            q = queues[r]
            if aborted:
                lost_ab += b      # aborted batch retries/abandons
            if meas:
                if not aborted:
                    for arr in popped:
                        w = t_ev + comp - arr
                        lat_sum += w
                        slo_n += int(deadline <= 0.0 or w <= deadline)
                    lat_n += b
                busy += s_busy
                down += rep
                lwork += lost
                nfail_n += n_f
            in_service[r] = 0 if aborted else b
            t_free[r] = t_ev + comp
            while len(q) > trim_to:        # drop-mode formation trim
                q.pop()
                lost_ov_pending += 1
        else:
            in_service[r] = 0
            committed[r] = False
            imp[r] = False
            t_free[r] = INF

        # retry orbit, assessed once per decision event; the firing
        # block re-arrives whole at ONE replica (round-robin reads the
        # cursor without advancing; impaired replicas are skipped the
        # same way arrivals skip them)
        n_r = orbit.draws(t_ev - clock)
        if n_r > 0:
            d = _route_one(advance_rr=False)
            admit_r = min(n_r, max(retry_room - len(queues[d]), 0))
            queues[d].extend([t_ev] * admit_r)
            if admit_r > 0 and not committed[d]:
                committed[d] = True
                t_free[d] = t_ev
            orbit.unfired(n_r - admit_r)
        term_ab, term_ov = orbit.file(lost_ab, lost_ov_pending)
        lost_ov_pending = 0
        if meas:
            ab_n += term_ab
            ov_n += term_ov
            retry_n += n_r
            span += t_ev - clock
        clock = t_ev
        events += 1

    return LossRefResult(
        mean_latency=lat_sum / max(lat_n, 1),
        utilization=busy / max(k * span, 1e-30),
        n_jobs=lat_n, offered=lat_n + ov_n + ab_n, n_in_slo=slo_n,
        overflow_dropped=ov_n, abandoned=ab_n,
        n_fresh=fresh_n, n_retry=retry_n,
        n_failures=nfail_n, down_time=down, lost_work=lwork,
        span=k * span)


def simulate_gen_loss_numpy(lam: float, model, *, prompt_len: int,
                            gen_tokens: int, max_active: int,
                            discipline: str = "continuous",
                            q_max: int = 0, deadline: float = 0.0,
                            overflow: str = "reject",
                            retry_rate: float = 0.0,
                            q_cap: int = 4096, r_cap: int = 256,
                            mtbf: float = 0.0, mttr: float = 0.0,
                            fail_disc: str = "resume",
                            throttle: float = 1.0,
                            n_steps: int = 30_000,
                            warmup: int | None = None,
                            seed: int = 0) -> LossRefResult:
    """Token-level mirror of the ``gen_sweep`` kernel's loss step.

    Run-structured like the kernel (idle jump → renege → admission
    gate → drop trim → closed-form decode run to the next natural
    event → window arrivals vs the room → retry at the run end), minus
    the ``a_cap`` coverage split — statistically exact whenever the
    kernel's pre-drawn chain covers its windows (size the kernel's
    ``a_cap`` generously when comparing).  ``model`` is a
    ``GenServiceModel``-shaped object (``alpha_decode``/…).
    """
    rng = np.random.default_rng(seed)
    if warmup is None:
        warmup = max(1, n_steps // 10)
    a_d, t0_d = float(model.alpha_decode), float(model.tau0_decode)
    a_p, t0_p = float(model.alpha_prefill), float(model.tau0_prefill)
    roomv, trim_to, retry_room = _rooms(q_max, overflow, q_cap)
    orbit = _Orbit(rng, retry_rate, r_cap)
    fail = _Failures(rng, mtbf, mttr, fail_disc, throttle)
    continuous = discipline == "continuous"
    BIG = 1 << 24

    waiting: list[float] = []
    active: list[list] = []       # [remaining_tokens, arrival_epoch]
    now = 0.0
    next_arr = rng.exponential(1.0 / lam)
    lat_sum = busy = span = down = lwork = 0.0
    lat_n = slo_n = ov_n = ab_n = fresh_n = retry_n = nfail_n = 0

    for i in range(n_steps):
        meas = i >= warmup
        t_step0 = now
        fresh = lost_ab = lost_ov = 0

        if not waiting and not active:
            now = max(now, next_arr)
            waiting.append(next_arr)
            next_arr += rng.exponential(1.0 / lam)
            fresh += 1

        if deadline > 0.0:
            while waiting and waiting[0] < now - deadline:
                waiting.pop(0)
                lost_ab += 1

        gate = continuous or not active
        n_join = min(len(waiting), max_active - len(active)) \
            if gate else 0
        thr = fail.scale()                 # degraded phase, this run
        t_pf = (a_p * prompt_len * n_join + t0_p) * thr \
            if n_join > 0 else 0.0
        for arr in waiting[:n_join]:
            active.append([gen_tokens, arr])
        waiting = waiting[n_join:]

        while len(waiting) > trim_to:      # drop-mode formation trim
            waiting.pop()
            lost_ov += 1

        b = len(active)
        if b > 0:
            dt = (a_d * b + t0_d) * thr
            t0r = now + t_pf
            m_min = min(a[0] for a in active)
            watch = continuous and b < max_active
            k_run = m_min
            if watch:
                k_arr = math.ceil((next_arr - t0r) / dt)
                k_run = min(k_run, k_arr)
            k_run = min(max(k_run, 1), BIG)
            t_end = t0r + k_run * dt
        else:
            k_run, t_end = 0, now

        # failure clock over the run's busy span (run granularity);
        # repairs/rework extend t_end — arrivals during them below
        w_run = t_pf + k_run * dt if b > 0 else 0.0
        comp, w_busy, rep, lost, n_f, aborted = fail.draw(w_run)
        if b > 0:
            t_end = now + comp             # == old t_end + extension

        while next_arr <= t_end:           # window arrivals vs room
            fresh += 1
            if len(waiting) < roomv:
                waiting.append(next_arr)
            else:
                lost_ov += 1
            next_arr += rng.exponential(1.0 / lam)

        fins = []
        if k_run > 0 and not aborted:
            for a in active:
                a[0] -= k_run
            fins, active = ([a for a in active if a[0] == 0],
                            [a for a in active if a[0] > 0])
        if aborted:
            # fail-drop: the whole run aborts — decode progress is not
            # resumed, every active job leaves via the retry path
            lost_ab += len(active)
            active = []
        if meas:
            for _, arr in fins:
                w = t_end - arr
                lat_sum += w
                slo_n += int(deadline <= 0.0 or w <= deadline)
            lat_n += len(fins)
            busy += w_busy
            span += t_end - t_step0
            down += rep
            lwork += lost
            nfail_n += n_f

        n_r = orbit.draws(t_end - t_step0)
        admit_r = min(n_r, max(retry_room - len(waiting), 0))
        waiting.extend([t_end] * admit_r)
        orbit.unfired(n_r - admit_r)
        term_ab, term_ov = orbit.file(lost_ab, lost_ov)
        if meas:
            ab_n += term_ab
            ov_n += term_ov
            fresh_n += fresh
            retry_n += n_r
        now = t_end

    return LossRefResult(
        mean_latency=lat_sum / max(lat_n, 1),
        utilization=busy / max(span, 1e-30),
        n_jobs=lat_n, offered=lat_n + ov_n + ab_n, n_in_slo=slo_n,
        overflow_dropped=ov_n, abandoned=ab_n,
        n_fresh=fresh_n, n_retry=retry_n,
        n_failures=nfail_n, down_time=down, lost_work=lwork, span=span)
