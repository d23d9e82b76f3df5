"""Tensor building blocks of the port's Monte Carlo sweep.

Torch counterparts of the trace-time helpers in the reference package's
``repro.core.engine``.  The reference writes each op for one point and
``vmap``s it; here every op takes the point axis first, written out:
a FIFO buffer is ``(P, n)``, a per-point scalar is ``(P,)``.

Two things differ from a line-by-line translation, both for the
per-point contract (a point's result depends only on its parameters,
the seed and its global index — never on how many points share the
dispatch):

- ``exp_offsets`` scans along a dimension that is not the innermost
  one.  torch's CUDA scan picks its thread layout from the row count
  when it scans the innermost dimension, so the summation order of a
  row would follow P; over an outer dimension one thread sums each
  column in sequence, in float32 (the CPU scan accumulates in
  float64 instead, so the two devices differ in the last bits).
- ``row_sum`` adds in a fixed pairwise order with elementwise adds, for
  the same reason: torch's reductions choose their split by shape;
  ``padded_row_sum`` pads to a power of two first, so the order does
  not depend on the row's width either.

``fifo_append`` is a scatter at ``q + arange(a_cap)``: where the
reference's ``lax.dynamic_update_slice`` silently clamps its start
index, an index past the buffer raises here (a device assert on CUDA).
The sizing ``buf_len = q_cap + a_cap`` (``+ r_cap`` with the retry
orbit) with ``q <= q_cap`` (kept by ``accept_window``) means it never
does.

The loss helpers (``push_poisson_window_loss``, ``renege_prefix``,
``orbit_draws``, ``orbit_file``) take the step's pre-drawn random block
where the reference takes a key, so a point draws the same words
whatever its state; their integer results equal the reference's on the
same inputs.

The capacity helpers, with ``completion_inflation`` (the failure
regime's sizing law), are numpy copies of the reference's, so both
packages size their buffers alike.  ``fail_capacity`` and its two tail
bounds are the port's own: the reference draws its failure counts
unbounded, the port a fixed block a step, sized here.

A run's plan (``KernelPlan``, made by ``sweep_plan`` / ``gen_plan`` /
``fleet_plan``) holds the devices its points spread over
(``resolve_shards``, the reference's rule, on CUDA's visible devices);
``dispatch_device`` runs contiguous slices of the point axis on them,
each further device's in a worker process of its own, and gathers the
outputs in point order on the plan's device, bit for bit the one-device
run's.  Every slice runs the whole superstep loop, so only a run whose
kernels outlast their host loop gains from more devices: ``sweep``
spreads over every visible GPU by default (``shard=None``, as in the
reference); ``fleet_sweep``, ``gen_sweep`` and ``campaign``, which ran
slower spread over four GPUs than on one, only when ``shard`` asks for
it.
"""
from __future__ import annotations

import atexit
import contextlib
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

__all__ = ["exp_offsets", "fifo_append", "fifo_gather", "fifo_pop_shift",
           "accept_window", "push_poisson_window",
           "push_poisson_window_loss", "renege_prefix", "orbit_draws",
           "orbit_file", "welford_block", "row_sum", "padded_row_sum",
           "scatter_hist",
           "scatter_hist_sums", "completion_inflation", "queue_capacity",
           "window_capacity", "orbit_capacity", "failure_count_bound",
           "restart_attempt_bound", "fail_capacity", "KernelPlan",
           "resolve_shards", "plan_devices", "SliceKernel", "WorkerLost",
           "dispatch_device", "dispatch", "host_outputs"]


def exp_offsets(exps: torch.Tensor, rate: torch.Tensor) -> torch.Tensor:
    """Constructive Poisson-process epochs: partial sums of Exp(1) gaps
    over dim 1 of ``exps`` (``(S, n, P)`` or ``(n, P)`` with the point
    axis last), scaled by the per-point ``1/rate``.  Exact — the count
    inside a window of length w is Poisson(rate·w) — and branch-free."""
    return torch.cumsum(exps, dim=exps.dim() - 2) / rate


def fifo_append(buf: torch.Tensor, pos: torch.Tensor,
                block: torch.Tensor) -> torch.Tensor:
    """Contiguous FIFO tail-append, in place: row p gets ``block[p]`` at
    ``buf[p, pos[p]:pos[p] + block.shape[1]]``.  The whole block is
    written; entries past the accepted count land in the free region,
    where they stay garbage until a later append overwrites them."""
    idx = pos.unsqueeze(1).long() + torch.arange(
        block.shape[1], device=buf.device)
    return buf.scatter_(1, idx, block)


def fifo_gather(buf: torch.Tensor, head: torch.Tensor,
                rank: torch.Tensor) -> torch.Tensor:
    """Per-point gather ``buf[p, head[p] + rank[p, j]]`` of a ``(P, S)``
    rank block.  The index is clamped into the row, as the reference's
    ``jnp.take(buf, clip(head + rank, 0, n - 1))``: slots whose rank
    the caller masks out may point past the live range (or past the
    buffer, where torch's ``gather`` would fail) and read some entry."""
    idx = (head.unsqueeze(1) + rank).clamp_(0, buf.shape[1] - 1)
    return torch.gather(buf, 1, idx.long())


def fifo_pop_shift(buf: torch.Tensor, k: torch.Tensor,
                   max_shift: int) -> torch.Tensor:
    """Drop the ``k[p]`` oldest entries of each row and shift the rest
    down (``k <= max_shift``); entries shifted in from past the end are
    +0.0, as the reference's zero pad gives."""
    n = buf.shape[1]
    idx = k.unsqueeze(1).long() + torch.arange(n, device=buf.device)
    inside = idx < n
    vals = torch.gather(buf, 1, idx.clamp_(max=n - 1))
    return vals.masked_fill_(~inside, 0.0)


def accept_window(count: torch.Tensor, q: torch.Tensor,
                  q_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clamp a window's arrival count by queue capacity: returns
    ``(accepted, overflow)``; overflow feeds ``buffer_dropped``."""
    a = torch.minimum(count, q_cap - q)
    return a, count - a


def push_poisson_window(buf, q, dropped, offs, t0, win, *, q_cap: int):
    """Append the arrivals of a window of length ``win`` starting at
    ``t0`` to the FIFO buffer, in order.  ``offs`` is this step's
    ``(a_cap + 1, P)`` block of ``exp_offsets``: the first ``a_cap``
    epochs are candidate arrivals and the last is the sentinel whose
    coverage means the window held more than ``a_cap`` (counted in
    ``dropped``, as are arrivals clamped by queue capacity).  Returns
    ``(buf, q, dropped)``; ``buf`` is updated in place."""
    a_cap = offs.shape[0] - 1
    cand = offs[:a_cap]
    count = (cand <= win).sum(0, dtype=torch.int32)
    dropped = dropped + (offs[a_cap] <= win).to(torch.int32)
    a, over = accept_window(count, q, q_cap)
    fifo_append(buf, q, (t0 + cand).t())
    return buf, q + a, dropped + over


def push_poisson_window_loss(buf, q, dropped, offs, t0, win, *, q_cap: int,
                             room):
    """``push_poisson_window`` with a per-point admission bound ``room``
    (``(P,)`` int32), tested by each arrival at its own epoch — the
    immediate "reject" regime; the "drop" regime passes ``room = q_cap``
    and trims at formation instead.  Occupancy only grows inside a
    window, so exactly the first ``(room − q)⁺`` arrivals enter.
    Returns ``(buf, q, dropped, accepted, rejected)``: ``rejected`` is a
    measured loss (``overflow_dropped``), ``dropped`` still counts only
    the sentinel and the buffer clamp."""
    a_cap = offs.shape[0] - 1
    cand = offs[:a_cap]
    count = (cand <= win).sum(0, dtype=torch.int32)
    dropped = dropped + (offs[a_cap] <= win).to(torch.int32)
    admit = torch.minimum(count, torch.clamp(room - q, min=0))
    a, over = accept_window(admit, q, q_cap)
    fifo_append(buf, q, (t0 + cand).t())
    return buf, q + a, dropped + over, a, count - admit


def renege_prefix(buf, q, now, deadline, max_pop: int):
    """Pop each row's deadline-expired jobs (age ``now − buf > deadline``)
    from the compacted FIFO: arrival times ascend, so they are a prefix,
    counted and removed by one ``fifo_pop_shift``.  ``deadline <= 0``
    disables reneging.  Returns ``(buf, q, n_expired)``."""
    idx = torch.arange(buf.shape[1], device=buf.device)
    expired = (idx < q.unsqueeze(1)) & (buf < (now - deadline).unsqueeze(1))
    n_exp = torch.where(deadline > 0, expired.sum(1, dtype=torch.int32), 0)
    return fifo_pop_shift(buf, n_exp, max_pop), q - n_exp, n_exp


def orbit_draws(u: torch.Tensor, R: torch.Tensor,
                p: torch.Tensor) -> torch.Tensor:
    """Retry-orbit jobs re-arriving this step: an exact Binomial(R, p)
    thinning — orbit job j < R fires when its uniform ``u[j] < p``.
    ``u`` is the step's ``(r_cap, P)`` uniform block, drawn whole
    whatever the orbit holds."""
    j = torch.arange(u.shape[0], device=u.device).unsqueeze(1)
    return ((j < R) & (u < p)).sum(0, dtype=torch.int32)


def orbit_file(R, lost_a, lost_b, r_cap: int, enabled):
    """File this step's losses into the bounded retry orbit, ``lost_a``
    (abandoned) before ``lost_b`` (overflow).  What does not fit — or
    all of it where ``enabled`` is false (``retry_rate == 0``) — stays a
    terminal loss in its class.  Returns ``(R, final_a, final_b)``."""
    room = torch.where(enabled, torch.clamp(r_cap - R, min=0), 0)
    take_a = torch.minimum(lost_a, room)
    take_b = torch.minimum(lost_b, room - take_a)
    return R + take_a + take_b, lost_a - take_a, lost_b - take_b


def welford_block(bm, d_sum: torch.Tensor, d_n: torch.Tensor):
    """One Welford update of the batch-means accumulator ``bm = (mean,
    m2, n_blocks)`` with a block of ``d_n`` jobs whose latencies sum to
    ``d_sum``; blocks without measured jobs are skipped."""
    mean, m2, n = bm
    has = d_n > 0
    x = d_sum / torch.clamp(d_n, min=1).to(d_sum.dtype)
    n1 = n + has.to(n.dtype)
    delta = x - mean
    mean1 = mean + delta / torch.clamp(n1, min=1).to(d_sum.dtype)
    m21 = m2 + delta * (x - mean1)
    return (torch.where(has, mean1, mean), torch.where(has, m21, m2), n1)


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension in a fixed pairwise order (element j
    with j + n/2, halving; an odd tail is carried), so a row's float
    sum does not depend on the number of rows or the device."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        y = x[..., :h] + x[..., h:2 * h]
        x = torch.cat((y, x[..., 2 * h:]), -1) if x.shape[-1] % 2 else y
    return x[..., 0]


def padded_row_sum(x: torch.Tensor) -> torch.Tensor:
    """``row_sum`` of the last dimension zero-padded to a power of two:
    trailing zeros then leave the result unchanged, so two rows that
    differ only in how many zeros follow their entries sum alike."""
    n = x.shape[-1]
    w = 1 << max(0, (n - 1).bit_length())
    if w != n:
        x = torch.nn.functional.pad(x, (0, w - n))
    return row_sum(x)


def scatter_hist(hist: torch.Tensor, bins: torch.Tensor,
                 inc: torch.Tensor) -> torch.Tensor:
    """Add each row's included entries into its histogram row, in
    place: ``hist`` is ``(P, n_bins)`` int32, ``bins``/``inc`` are
    ``(P, …)``.  Integer adds, so the order does not matter."""
    p = hist.shape[0]
    return hist.scatter_add_(1, bins.reshape(p, -1).long(),
                             inc.reshape(p, -1).to(hist.dtype))


def scatter_hist_sums(sums: torch.Tensor, bins: torch.Tensor,
                      inc: torch.Tensor, vals: torch.Tensor
                      ) -> torch.Tensor:
    """Sketch companion of ``scatter_hist``: add the included latencies
    into per-bin float32 sums, in place.  The block's per-bin partial
    sums are taken in float64 and added to ``sums`` once, so the result
    does not depend on the order of the adds (to within a float64
    rounding) — the CUDA kernel, whose atomics add in no fixed order,
    computes the same."""
    p = sums.shape[0]
    masked = torch.where(inc, vals, 0.0).reshape(p, -1).double()
    part = torch.zeros(sums.shape, dtype=torch.float64,
                       device=sums.device)
    part.scatter_add_(1, bins.reshape(p, -1).long(), masked)
    return sums.add_(part.to(torch.float32))


# ---------------------------------------------------------------------------
# adaptive capacity sizing (numpy copies of the reference's helpers)
# ---------------------------------------------------------------------------

def _pow2ceil(x: float) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(1.0, float(x))))))


def _occupancy_scale(lam, alpha, tau0, b_max, wait_max=0.0):
    """Per-point (mean, sd) scale of the waiting-room occupancy:
    finite-b_max aware utilization u, mean λτ₀/(1−u) + λ·wait_max, and
    the AR(1) batch recursion's sd inflated by 1/(1−u²)."""
    lam = np.asarray(lam, dtype=np.float64)
    cap = np.where(np.asarray(b_max) > 0, np.asarray(b_max), np.inf)
    u = np.clip(lam * (np.asarray(alpha) + np.asarray(tau0) / cap),
                0.0, 0.98)
    m = lam * np.asarray(tau0) / (1.0 - u) + lam * np.asarray(wait_max)
    sd = np.sqrt(np.maximum(m, 1.0) / np.maximum(1.0 - u * u, 0.04))
    return m, sd


def completion_inflation(lam, alpha, tau0, b_max, mtbf, mttr,
                         restart=None, throttle=None) -> np.ndarray:
    """Per-point multiplicative service-time inflation E[C]/s from the
    breakdown/repair regime, evaluated at each point's occupancy-scale
    batch size.  Preempt-resume (and fail-drop) inflate by 1 + ξ·mttr
    (ξ = 1/MTBF); preempt-restart re-executes the batch from scratch a
    Geometric number of times, the classical
    E[C] = (1/ξ + mttr)·(e^{ξs} − 1), which *exponentiates* in ξ·s.
    Clipped to [1, 64]: beyond that the point is far past ρ_eff = 1 and
    no finite buffer sizing is meaningful anyway."""
    lam64 = np.asarray(lam, dtype=np.float64)
    mtbf64 = np.asarray(mtbf, dtype=np.float64) * np.ones_like(lam64)
    r = np.asarray(mttr, dtype=np.float64) * np.ones_like(lam64)
    xi = np.where(mtbf64 > 0, 1.0 / np.maximum(mtbf64, 1e-300), 0.0)
    m0, _ = _occupancy_scale(lam, alpha, tau0, b_max)
    cap = np.where(np.asarray(b_max) > 0, np.asarray(b_max), np.inf)
    b_eff = np.minimum(np.maximum(m0, 1.0), cap)
    s_b = (np.asarray(alpha, dtype=np.float64) * b_eff
           + np.asarray(tau0, dtype=np.float64))
    infl = 1.0 + xi * r
    if restart is not None:
        xs = np.minimum(xi * s_b, 32.0)
        infl_restart = ((1.0 / np.maximum(xi, 1e-300) + r)
                        * np.expm1(xs) / np.maximum(s_b, 1e-300))
        rmask = np.asarray(restart, dtype=bool) \
            * np.ones_like(lam64, dtype=bool)
        infl = np.where(rmask & (xi > 0),
                        np.maximum(infl_restart, infl), infl)
    if throttle is not None:
        infl = infl * np.maximum(
            np.asarray(throttle, dtype=np.float64), 1.0)
    return np.clip(np.where(xi > 0, infl, 1.0), 1.0, 64.0)


def queue_capacity(lam, alpha, tau0, b_max, wait_max=0.0, *,
                   q_max=None, mtbf=None, mttr=None, restart=None,
                   throttle=None, floor: int = 64,
                   ceil: int = 8192) -> int:
    """Adaptive ``q_cap`` for a request-level grid: sized from the
    dispatched grid's own maximum load instead of a global worst case.

    Power-of-two bucketed (bounds recompiles across campaigns), with a
    ~10σ fluctuation margin over the occupancy scale so multi-thousand
    -step runs keep ``buffer_dropped == 0`` (overflow is still counted,
    never silent — the kernels report it and the tests assert on it).

    A finite waiting room caps a point's need regardless of its load:
    with ``q_max`` given, a ``q_max > 0`` point never holds more than
    ``q_max`` waiting jobs plus one window's worth of pre-trim ("drop"
    mode) arrivals — this is what keeps super-critical (ρ > 1) loss
    points inside finite buffers.

    Breakdown/repair points (``mtbf``/``mttr`` given, with ``restart``
    a per-point preempt-restart mask and ``throttle`` the degraded-
    phase factor) size against the *completion-time* law instead of
    the bare service time: the occupancy scale inflates by E[C]/s
    (restart re-execution exponentiates in s/MTBF — see
    ``completion_inflation``), and an additive repair-burst margin
    λ·mttr + 10σ covers the arrivals that pile up across a repair
    window, keeping ``buffer_dropped == 0`` the witness at MTTR up to
    ~10·τ[b_max]."""
    lam64 = np.asarray(lam, dtype=np.float64)
    alpha_eff = np.asarray(alpha, dtype=np.float64) * np.ones_like(lam64)
    tau0_eff = np.asarray(tau0, dtype=np.float64) * np.ones_like(lam64)
    burst = 0.0
    if mtbf is not None and np.any(np.asarray(mtbf) > 0):
        infl = completion_inflation(lam, alpha, tau0, b_max, mtbf,
                                    0.0 if mttr is None else mttr,
                                    restart=restart, throttle=throttle)
        alpha_eff = alpha_eff * infl
        tau0_eff = tau0_eff * infl
        lr = lam64 * (np.asarray(mttr, dtype=np.float64)
                      * np.ones_like(lam64))
        # repairs cluster inside busy periods: two back-to-back mean
        # repairs' worth of arrivals plus a 10σ Poisson margin
        burst = 2.0 * lr + 10.0 * np.sqrt(lr + 1.0)
    m, sd = _occupancy_scale(lam, alpha_eff, tau0_eff, b_max, wait_max)
    need = np.maximum(m + 10.0 * sd, 0.0) + burst + 32.0
    if q_max is not None:
        qm = np.asarray(q_max, dtype=np.float64) * np.ones_like(lam64)
        cap = np.where(np.asarray(b_max) > 0, np.asarray(b_max), np.inf)
        b_eff = np.minimum(np.maximum(qm, 1.0), cap)
        w_mu = lam64 * (alpha_eff * b_eff + tau0_eff
                        + np.asarray(wait_max))
        room_need = qm + w_mu + 10.0 * np.sqrt(w_mu + 1.0) \
            + burst + 32.0
        # the room bound caps the load estimate, but the buffer must
        # still physically hold a full waiting room (the plan layer
        # rejects q_cap < q_max) — a lightly-loaded q_max = 256 chunk
        # would otherwise size below its own room
        need = np.where(qm > 0,
                        np.minimum(np.maximum(need, qm + 1.0), room_need),
                        need)
    need = float(np.max(need))
    b_top = float(np.max(np.where(np.asarray(b_max) > 0, b_max, 0)))
    return int(min(ceil, max(floor, _pow2ceil(max(need, 2.0 * b_top)))))


def window_capacity(lam, window, *, slack: float = 8.0, floor: int = 16,
                    bucket: int = 16, ceil: int = 4096) -> int:
    """Adaptive ``a_cap``: arrivals that must be visible inside one
    service window — Poisson mean + ``slack``·√mean, bucketed to
    multiples of ``bucket``."""
    mu = float(np.max(np.asarray(lam, dtype=np.float64)
                      * np.asarray(window, dtype=np.float64)))
    need = mu + slack * np.sqrt(mu + 1.0) + slack
    return int(min(ceil, max(floor, -(-int(np.ceil(need)) // bucket)
                             * bucket)))


def orbit_capacity(lam, retry_rate, *, floor: int = 16,
                   ceil: int = 1024) -> int:
    """Adaptive ``r_cap``, the retry orbit's bound: the orbit's drift
    balances at ``R* = λ/retry_rate`` even when every arrival is lost,
    so ``R* + 10·√R*`` bounds its excursions; power-of-two bucketed.
    Reaching ``r_cap`` is modelled (the excess loss is terminal), not a
    silent clamp."""
    lam64 = np.asarray(lam, dtype=np.float64)
    rr = np.asarray(retry_rate, dtype=np.float64) * np.ones_like(lam64)
    r_star = np.where(rr > 0, lam64 / np.maximum(rr, 1e-12), 0.0)
    need = float(np.max(r_star + 10.0 * np.sqrt(r_star + 1.0))) + 8.0
    return int(min(ceil, max(floor, _pow2ceil(need))))


# ---------------------------------------------------------------------------
# the failure block's sizing (the port's own: the reference samples its
# failure counts unbounded, the port draws a fixed block a step)
# ---------------------------------------------------------------------------

# the tail probability, per busy span, that the sizing below leaves to
# the ``fail_truncated`` and ``buffer_dropped`` counters
FAIL_TAIL = 1e-9


def failure_count_bound(x: float, kshape: float = np.inf, *,
                        ceil: int = 1024) -> int:
    """Smallest n with P(M ≥ n) < FAIL_TAIL for the breakdowns M in one
    busy span whose mean holds ``x`` MTBFs: Poisson(x) for a fixed span
    (``kshape`` infinite), its Gamma(kshape) mixture — the negative
    binomial with r = kshape and mean x — for a random one.  ``ceil``
    when the tail is still above FAIL_TAIL there."""
    if x <= 0.0:
        return 0
    if np.isinf(kshape):
        log_p = -x
    else:
        q = x / (kshape + x)
        log_p = kshape * np.log1p(-q)
    cdf = 0.0
    for n in range(ceil):
        if 1.0 - cdf < FAIL_TAIL:
            return n
        cdf += float(np.exp(log_p))
        # pmf(n + 1) / pmf(n)
        log_p += (np.log(x / (n + 1)) if np.isinf(kshape)
                  else np.log(q * (kshape + n) / (n + 1)))
    return ceil


def restart_attempt_bound(x: float, *, ceil: int = 1024) -> int:
    """Smallest n with P(n attempts in a row fail) < FAIL_TAIL for a
    preempt-restart span of ``x`` MTBFs: each attempt fails with
    p = 1 − e^{−x}, so n = ⌈ln FAIL_TAIL / ln p⌉; ``ceil`` when p
    rounds to 1."""
    if x <= 0.0:
        return 0
    p = -np.expm1(-x)
    if p >= 1.0:
        return ceil
    return int(min(ceil, max(1, np.ceil(np.log(FAIL_TAIL) / np.log(p)))))


def fail_capacity(mtbf, span, kshape=np.inf, *, floor: int = 16,
                  bucket: int = 16, ceil: int = 512) -> int:
    """Adaptive ``f_cap``, the failure block a step draws: ``f_cap``
    failure epochs and as many repairs.  Resume counts a busy span's
    breakdowns among the block's partial sums, so the count is
    truncated at ``f_cap``; it is sized so that P(M ≥ f_cap) < FAIL_TAIL
    at every failing point's longest busy span ``span`` (fixed, or the
    mean of a Gamma(``kshape``) span), bucketed to ``bucket`` and at
    least ``floor`` (the reference's restart block).  A run counts the
    steps where the block binds in ``fail_truncated``."""
    mtbf, span, kshape = np.broadcast_arrays(
        np.asarray(mtbf, np.float64), np.asarray(span, np.float64),
        np.asarray(kshape, np.float64))
    on = mtbf > 0.0
    need = floor
    for x, k in set(zip((span[on] / mtbf[on]).tolist(),
                        kshape[on].tolist())):
        need = max(need, failure_count_bound(x, k, ceil=ceil))
    return int(min(ceil, -(-need // bucket) * bucket))


# ---------------------------------------------------------------------------
# the plan / dispatch split (the campaign's entry to the three sweeps),
# and the dispatch over several devices
# ---------------------------------------------------------------------------

# the private seam of the tests: a device list that every plan made
# inside ``_over_devices`` takes instead of its resolved one, and whether
# its slices past the first go to worker processes even where they name
# the plan's own device
_FORCED: Optional[List[torch.device]] = None
_FORCE_WORKERS = False

# one worker process a device that is not the plan's (spawned at first
# use, kept for later dispatches, shut down at exit)
_WORKERS: Dict[str, ProcessPoolExecutor] = {}


def resolve_shards(shard, n_points: int, device) -> List[torch.device]:
    """The devices a dispatch of ``n_points`` points runs on, counted as
    the reference's ``engine.resolve_shards`` counts them: ``None`` or
    ``True`` → every visible device of ``device``'s type, ``False`` → 1,
    an int → that many, clamped to the visible devices; always clamped
    to the point count.  The CPU counts as one device.  Several CUDA
    devices are ``cuda:0 … cuda:n−1`` (the reference takes
    ``jax.devices()[:n]``); one is ``device`` itself.  Raises
    ``ValueError`` below 1."""
    dev = torch.device(device)
    if shard is False:
        n_dev = 1
    else:
        avail = torch.cuda.device_count() if dev.type == "cuda" else 1
        if shard is None or shard is True:
            n_dev = avail
        else:
            n_dev = int(shard)
            if n_dev < 1:
                raise ValueError(f"shard must be >= 1 (got {shard})")
            n_dev = min(n_dev, avail)
    n_dev = max(1, min(n_dev, int(n_points)))
    if n_dev == 1:
        return [dev]
    return [torch.device("cuda", i) for i in range(n_dev)]


def plan_devices(shard, n_points: int, device, tap=None
                 ) -> List[torch.device]:
    """A plan's device list: ``resolve_shards``, or one device where a
    ``metrics_tap`` reads the lanes back (as in the reference, whose
    tapped runs take one device; the results do not depend on it)."""
    devices = resolve_shards(shard, n_points, device)
    if _FORCED is not None:
        devices = _FORCED[:max(1, int(n_points))]
    return [torch.device(device)] if tap is not None else devices


@contextlib.contextmanager
def _over_devices(devices: Sequence, workers: bool = False):
    """Make every plan inside the block dispatch over ``devices``, which
    may name one device more than once (the tests' seam: several slices
    on one CPU or one card); with ``workers``, the slices past the first
    run in worker processes even on the plan's own device."""
    global _FORCED, _FORCE_WORKERS
    saved = _FORCED, _FORCE_WORKERS
    _FORCED, _FORCE_WORKERS = [torch.device(d) for d in devices], workers
    try:
        yield
    finally:
        _FORCED, _FORCE_WORKERS = saved


class SliceKernel:
    """A plan's kernel: the superstep loop ``fn(grid, keys, device=,
    **cfg)`` over the validated grid with its pinned caps and grid-wide
    flags, or over a slice of its points.  It is picklable (a module
    function, a grid of numpy arrays, a dict of plain values), so that a
    slice can run in a worker process on a device of its own."""

    def __init__(self, fn: Callable, grid, cfg: Dict[str, Any],
                 device: torch.device) -> None:
        self.fn, self.grid, self.cfg, self.device = fn, grid, cfg, device

    def __call__(self, keys, points=None, device=None):
        grid = self.grid if points is None else self.grid.take(points)
        return self.fn(grid, keys, device=self.device if device is None
                       else device, **self.cfg)

    def on(self, points) -> "SliceKernel":
        """The kernel of the points ``points`` alone (the slice a worker
        receives)."""
        return SliceKernel(self.fn, self.grid.take(points), self.cfg,
                           self.device)


class KernelPlan(NamedTuple):
    """A fully resolved sweep run, before it starts: what ``sweep_plan``
    / ``fleet_plan`` / ``gen_plan`` return.

    ``kernel(keys)`` (a ``SliceKernel``) runs the superstep loop on the
    plan's device and returns the per-point outputs as device tensors;
    ``kernel(keys, points, device)`` runs the points ``points`` (a slice
    of the grid) on ``device``, with ``keys`` that slice's.  ``params``
    holds the per-point inputs the campaign's fold reads (``lam``),
    ``keys`` the per-point Threefry keys (``prng.point_keys``; the
    adaptive campaign swaps in ``prng.point_keys_at`` of a compacted
    index set).  ``devices`` are the devices the run spreads its points
    over (``plan_devices``: one where the plan runs on one).  ``sketch``
    / ``has_loss`` record the output schema (``hist_sums``, the loss
    counters).  A run may add ``"_limits"`` to its outputs: name →
    (device scalar, bound, message) invariants that ``host_outputs`` and
    the campaign check once the values reach the host."""

    kernel: Callable
    params: Dict[str, Any]
    keys: Any
    n: int
    sketch: bool
    has_loss: bool
    devices: Sequence[torch.device]


class WorkerLost(Exception):
    """A device's worker process died twice on one slice.  Not a
    ``RuntimeError``: the campaign's dispatch retry, which would run the
    chunk again and then quarantine it, lets it through."""


def _rows(x, lo: int, hi: int, device):
    """Points ``[lo, hi)`` of a tensor, or of each tensor of a tuple
    (the keys), on ``device``."""
    if isinstance(x, tuple):
        return tuple(t[lo:hi].to(device) for t in x)
    return x[lo:hi].to(device)


def _gather(outs: List[Dict[str, Any]], home) -> Dict[str, Any]:
    """The slices' outputs, in point order, on ``home``; each
    ``"_limits"`` value is the max over the slices."""
    out = {}
    for name in outs[0]:
        if name == "_limits":
            out[name] = {
                k: (torch.stack([o[name][k][0].to(home) for o in outs])
                    .max(), bound, msg)
                for k, (_, bound, msg) in outs[0][name].items()}
        else:
            out[name] = torch.cat([o[name].to(home) for o in outs])
    return out


def _counters() -> Dict[str, Callable]:
    """The launch counters a sweep's loop advances: B1 and B2."""
    from repro_torch.kernels import superstep as ss
    return {"hist_update": ss.hist_update, "fifo_compact": ss.fifo_compact}


def _worker_run(kernel: SliceKernel, keys, device: str):
    """A slice in its worker process: the kernel on ``device``, its
    outputs copied to the host, and the launches it counted."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    before = {k: f.launches for k, f in _counters().items()}
    out = kernel(tuple(t.to(dev) for t in keys), None, dev)
    host = {k: v.cpu() for k, v in out.items() if k != "_limits"}
    if "_limits" in out:
        host["_limits"] = {k: (v.cpu(), bound, msg)
                           for k, (v, bound, msg) in out["_limits"].items()}
    return host, {k: f.launches - before[k]
                  for k, f in _counters().items()}


def _worker(device: torch.device) -> ProcessPoolExecutor:
    """The worker process of ``device`` (spawned: a CUDA context cannot
    cross a fork)."""
    key = str(device)
    if key not in _WORKERS:
        _WORKERS[key] = ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    return _WORKERS[key]


def _drop_worker(device: torch.device, pool: ProcessPoolExecutor) -> None:
    """Forget ``device``'s worker if it is still ``pool`` (whose process
    died), so that the next slice spawns a fresh one."""
    if _WORKERS.get(str(device)) is pool:
        del _WORKERS[str(device)]
    pool.shutdown(wait=False, cancel_futures=True)


def _submit(device: torch.device, *args):
    """``_worker_run(*args)`` on ``device``'s worker: the pool and the
    future.  A pool that broke after its last slice is replaced once."""
    pool = _worker(device)
    try:
        return pool, pool.submit(_worker_run, *args)
    except BrokenProcessPool:
        _drop_worker(device, pool)
        pool = _worker(device)
        return pool, pool.submit(_worker_run, *args)


def _remote_result(device: torch.device, pool, fut, args):
    """A worker's slice, awaited.  If its process died (killed, out of
    memory, a fault in its CUDA context), the slice runs once more in a
    fresh worker; a second death raises ``WorkerLost``."""
    try:
        return fut.result()
    except BrokenProcessPool:
        _drop_worker(device, pool)
    pool, fut = _submit(device, *args)
    try:
        return fut.result()
    except BrokenProcessPool as e:
        _drop_worker(device, pool)
        raise WorkerLost(f"the worker process of {device} died twice on "
                         f"one slice") from e


@atexit.register
def _stop_workers() -> None:
    for pool in _WORKERS.values():
        pool.shutdown(wait=True, cancel_futures=True)
    _WORKERS.clear()


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device
    return (a.index if a.index is not None else cur()) == (
        b.index if b.index is not None else cur())


def dispatch_device(plan: KernelPlan):
    """Run a plan's kernel and keep its outputs on the plan's device
    (where its keys lie).  Over several ``plan.devices`` the point axis
    is cut into contiguous slices whose sizes differ by at most one,
    slice i on ``devices[i]``.  The slices on the plan's own device run
    in this process, one after another; every other device runs its
    slices in a worker process of its own (``SliceKernel.on``: the
    slice's grid, keys and caps are sent, its outputs and launch counts
    come back through the host), all submitted before the first is
    awaited, so that no host loop waits on another's (threads of one
    process would: their host loops share the GIL).  The outputs are
    gathered in point order on the plan's device.  A point's result
    depends only on its parameters, the seed and its global index, so
    the gathered outputs are the one-device run's bits."""
    kernel, keys, devices = plan.kernel, plan.keys, plan.devices
    if len(devices) <= 1:
        return kernel(keys)
    key0 = keys[0] if isinstance(keys, tuple) else keys
    home, n, k = key0.device, key0.shape[0], len(devices)
    cuts = [i * (n // k) + min(i, n % k) for i in range(k + 1)]
    devs = [torch.device(d) for d in devices]
    live = [i for i in range(k) if cuts[i + 1] > cuts[i]]
    remote = {i: (kernel.on(slice(cuts[i], cuts[i + 1])),
                  _rows(keys, cuts[i], cuts[i + 1], "cpu"), str(devs[i]))
              for i in live if (_FORCE_WORKERS and i > 0)
              or not _same_device(devs[i], home)}
    futures = {i: _submit(devs[i], *args) for i, args in remote.items()}
    outs: Dict[int, Any] = {}
    for i in live:
        if i not in futures:
            lo, hi = cuts[i], cuts[i + 1]
            outs[i] = kernel(_rows(keys, lo, hi, home), slice(lo, hi), home)
    counters = _counters()
    for i, (pool, fut) in futures.items():
        # the worker's launches join this process's counts
        outs[i], counted = _remote_result(devs[i], pool, fut, remote[i])
        for name, launched in counted.items():
            counters[name].launches += launched
    return _gather([outs[i] for i in live], home)


def host_outputs(out: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A run's device outputs as numpy arrays, after checking the run's
    ``"_limits"`` invariants (a violated one raises ``RuntimeError``)."""
    out = dict(out)
    for val, bound, msg in out.pop("_limits", {}).values():
        got = int(val)
        if got > bound:
            raise RuntimeError(msg.format(got=got, bound=bound))
    return {k: v.cpu().numpy() for k, v in out.items()}


def dispatch(plan: KernelPlan) -> Dict[str, np.ndarray]:
    """Run a plan (over its devices, as ``dispatch_device``) and return
    its outputs as host numpy arrays."""
    return host_outputs(dispatch_device(plan))
