"""The k-replica fleet sweep in PyTorch.

Port of the reference package's ``repro.core.sweep.fleet_sweep`` (its
``_build_fleet_kernel``): every grid point is a fleet of ``k`` replica
queues behind a router, each replica running the point's regenerative
batch law.  The replicas overlap in time and a router (JSQ above all)
must see the queue state at each arrival, so the fleet steps event by
event: each step routes, in one vectorized block, every arrival that
precedes the earliest pending replica decision, then processes that one
decision (a completion, usually rolling straight into the next batch
start).  Between two decisions no batch departs, so the routing inside
the window has a closed form for every discipline — random and
round-robin are state-free, and JSQ is discrete water-filling over the
load vector (``jsq_destinations``) — with no per-arrival loop.

Where the reference ``vmap``s one point's ``lax.scan`` over the grid,
this runs every point at once: the carry is a set of ``(P, …)``
tensors — per point a flat ``(k_max · q_cap,)`` stack of ring FIFOs
with their heads, the ``(P, k_max)`` vectors ``q``, ``in_service``,
``committed``, ``t_free`` and ``jobs_rep``, and ``next_arr``, ``rr``
and ``clock`` — and the scan is a Python loop, 32 steps (one
superstep) at a time.  Per superstep it draws all of the block's words
in one Threefry call (``core.prng``) on named streams, stacks the
(thinned) steps' latencies into a ``(P, rows, pop_cap)`` block, adds it
into the histograms with one ``kernels.superstep.hist_update`` (the CUDA
kernel on the card), makes one batch-means update and rebases the clock
to the last processed event once.

Loss grids (``q_max``, ``deadline``, ``retry_rate``) add, in the
reference's order: admission against the per-replica room, deadline
reneging of the deciding replica's expired FIFO prefix, the "drop" trim
after each pop, and the bounded retry orbit assessed once per event,
its re-arrival block routed whole to one replica.  Failure grids
(``mtbf``) draw a forming replica's breakdowns over its batch at
formation with the single-server sweeps' law (``sweep.FailParams``), flag
the replica impaired until its next decision, and route around impaired
replicas.  Every loss and failure op sits behind the grid's ``has_loss``
/ ``has_fail``, so a neutral point of such a grid gives the base path's
bits, and a point's result depends only on its parameters, the seed
and its global index.

``fleet_plan`` is the run's plan (``engine.KernelPlan``, device
outputs), as ``sweep_plan`` is the sweep's; a ``metrics_tap`` reads the
per-lane counters back once a superstep, the queue summed over a
fleet's replicas.  ``shard`` is clamped as in ``sweep``: one that would
use more than one device (ROADMAP Queue A 3f) raises
``NotImplementedError``.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import engine, metrics, prng, variance
from repro_torch.core.grid import (DIST_CODE, ROUTE_CODE, FleetGrid,
                                   FleetResult)
from repro_torch.core.hist import (SKETCH_BINS, hist_percentiles,
                                   sketch_edges, thinned_rows)
from repro_torch.core.sweep import (_MISC_WORDS, FailParams, LossParams,
                                    _fail_cap, _gamma, _require_pinned_caps,
                                    _require_ported_options,
                                    fail_capacity_args, fail_fields,
                                    loss_fields, observe_summary,
                                    resolve_device)
from repro_torch.kernels import superstep as _ss

__all__ = ["fleet_sweep", "fleet_plan", "fleet_caps", "jsq_destinations",
           "random_destinations", "round_robin_destinations"]

# events per superstep: the clock rebase, the histogram update and the
# batch-means sample are taken once per block of this many steps
_REBASE_EVERY = 32

# "no time": an empty slot's t_free and a masked minimum
_INF = 3.0e38
# an inactive replica's JSQ load, and the penalty that sorts impaired
# replicas after every healthy load but before inactive ones; both keep
# the water-filling's int32 sums free of overflow
BIG_LOAD = 1 << 20
IMP_LOAD = 1 << 19

# named random streams of one step (``prng.draw_words``): the route
# uniforms and the arrival gaps (a_cap words each), the gamma service
# words (``sweep._gamma``'s layout, word 0 unused), the orbit (grids
# with a retry rate: the retry block's route uniform, then r_cap orbit
# uniforms),
# the failure block (failure grids: 2·f_cap words), and the first
# arrival gap (step 0 only)
_S_ROUTE, _S_GAPS, _S_SERVICE, _S_ORBIT, _S_FAIL, _S_INIT = range(6)

_R_RANDOM, _R_RR, _R_JSQ = (ROUTE_CODE["random"], ROUTE_CODE["round_robin"],
                            ROUTE_CODE["jsq"])


# ---------------------------------------------------------------------------
# routing: the closed-form destination sequences of one window
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _arange(n: int, device: torch.device,
            dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """``torch.arange(n)``, made once per shape and device: the step
    loop asks for the same few ranges every step."""
    return torch.arange(n, dtype=dtype, device=device)


def _nth_true(mask_t: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Index of the ``rank``-th (0-based) True along dim 0 of the
    replica-major mask ``mask_t`` (``(k, …)``, broadcast against
    ``rank``): the count of positions whose running count of Trues is
    still ≤ rank.  The running count is a scan over the outer dimension
    (torch's scan over a short innermost one is slow on CUDA)."""
    cum = torch.cumsum(mask_t.to(torch.int32), 0, dtype=torch.int32)
    return (cum <= rank).sum(0)


def random_destinations(u: torch.Tensor, k: torch.Tensor,
                        eff: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Random routing of a window: ``u`` is the ``(P, n)`` route-uniform
    block, ``k`` the ``(P,)`` replica counts.  Without ``eff`` arrival j
    goes to ``min(⌊u_j·k⌋, k − 1)``; with the ``(P, k_max)`` eligibility
    mask ``eff`` (failure grids) it goes to the ``⌊u_j·n_eff⌋``-th
    eligible replica by index.  Returns ``(P, n)`` int64."""
    if eff is None:
        k = k.unsqueeze(1)
        return torch.minimum((u * k.to(torch.float32)).to(torch.int32),
                             k - 1).long()
    n_eff = eff.sum(1, dtype=torch.int32).unsqueeze(1)
    rank = torch.minimum((u * n_eff.to(torch.float32)).to(torch.int32),
                         n_eff - 1)
    return _nth_true(eff.t().unsqueeze(2), rank)


def round_robin_destinations(rr: torch.Tensor, k: torch.Tensor, n: int,
                             eff: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Round-robin routing of a window of ``n`` arrivals from the cursor
    ``rr``: arrival j goes to ``(rr + j) mod k``, or with ``eff`` to the
    cyclically next eligible replica from there.  Returns ``(P, n)``
    int64."""
    start = (rr.unsqueeze(1) + _arange(n, rr.device)) % k.unsqueeze(1)
    if eff is None:
        return start.long()
    cyc = (_arange(eff.shape[1], rr.device) - start.unsqueeze(2)) \
        % k.view(-1, 1, 1)
    cyc = torch.where(eff.unsqueeze(1), cyc, BIG_LOAD)
    return torch.argmin(cyc, 2)


def jsq_destinations(load: torch.Tensor, n: int) -> torch.Tensor:
    """Join-shortest-queue routing of a window of ``n`` arrivals with no
    departure inside it, as discrete water-filling: each arrival tops up
    the lowest current load, ties to the lowest index.  ``load`` is the
    ``(P, k_max)`` int32 load vector (``BIG_LOAD`` on inactive rows).
    S(c) counts the arrivals needed to raise every load below level c
    up to c; arrival j fills level c_j = max{c : S(c) ≤ j} and lands on
    the (j − S(c_j))-th replica by index among those with load ≤ c_j.
    Exact integer logic, equal to a per-arrival argmin loop.  Returns
    ``(P, n)`` int64."""
    steps = _arange(n + 1, load.device, torch.int32)
    lmin = load.amin(1, keepdim=True)
    # S at the levels lmin + m, m = 0 … n (replica-major: k outermost)
    load_t = load.t().unsqueeze(2)                          # (k, P, 1)
    S = torch.clamp(lmin + steps - load_t, min=0).sum(
        0, dtype=torch.int32)                               # (P, n + 1)
    # arrival j's level index: the levels m ≥ 1 with S(m) ≤ j (S is
    # nondecreasing and S(0) = 0)
    m = (S[:, 1:].unsqueeze(1) <= steps[:n].view(1, -1, 1)).sum(
        2, dtype=torch.int32)                               # (P, n)
    rank = steps[:n] - torch.gather(S, 1, m.long())
    return _nth_true(load_t <= lmin + m, rank)


# ---------------------------------------------------------------------------
# caps and the entry point
# ---------------------------------------------------------------------------

def fleet_caps(grid: FleetGrid, *, q_cap: Optional[int] = None) -> dict:
    """The capacities ``fleet_sweep`` would derive from ``grid`` —
    compute them once on the FULL grid and splat into every chunk of a
    split dispatch (``fleet_sweep(chunk, key_offset=...,
    **fleet_caps(full_grid))``).  ``q_cap`` is each replica's room,
    sized from the per-replica load λ/k; ``r_cap`` (loss grids) the
    retry orbit's bound at the total rate; ``f_cap`` (failure grids)
    the failure block a step draws.  ``a_cap`` is a static default,
    never grid-derived, so it is not among them."""
    if q_cap is None:
        q_cap = engine.queue_capacity(
            grid.lam / np.maximum(grid.k, 1), grid.alpha, grid.tau0,
            grid.b_max, grid.wait_max,
            q_max=grid.q_max if grid.has_loss else None,
            **fail_capacity_args(grid))
    caps = dict(q_cap=int(q_cap))
    if grid.has_loss:
        caps["r_cap"] = int(engine.orbit_capacity(grid.lam,
                                                  grid.retry_rate))
    if grid.has_fail:
        caps["f_cap"] = _fail_cap(grid, int(q_cap))
    return caps


def fleet_plan(grid: FleetGrid, *, n_steps: int = 6000,
               warmup: Optional[int] = None, q_cap: Optional[int] = None,
               a_cap: int = 32, r_cap: Optional[int] = None,
               f_cap: Optional[int] = None, n_bins: int = 512,
               seed: int = 0, key_offset: int = 0, hist_every: int = 1,
               shard=None, sketch: bool = False,
               superstep_backend: Optional[str] = None,
               metrics_tap=None, device=None) -> engine.KernelPlan:
    """Everything ``fleet_sweep`` does before the run (validate, pin the
    caps, resolve the device and backend, make the keys); same
    signature, returns an ``engine.KernelPlan`` with device outputs."""
    if not isinstance(grid, FleetGrid):
        raise TypeError("fleet_sweep needs a FleetGrid "
                        "(see FleetGrid.from_points/from_product)")
    if len(grid) == 0:
        raise ValueError("empty grid")
    _require_ported_options(shard, len(grid), device)
    dev = resolve_device(device)
    n_steps = -(-int(n_steps) // _REBASE_EVERY) * _REBASE_EVERY
    if warmup is None:
        warmup = max(1, n_steps // 10)
    if not 0 <= warmup < n_steps:
        raise ValueError(f"warmup {warmup} must lie in [0, {n_steps})")
    if np.any(grid.k < 1):
        raise ValueError("k must be >= 1")
    if int(hist_every) < 1:
        raise ValueError(f"hist_every must be >= 1 (got {hist_every})")
    has_loss, has_fail = grid.has_loss, grid.has_fail
    if key_offset:
        _require_pinned_caps(
            "fleet", key_offset, q_cap=q_cap is not None,
            r_cap=not has_loss or r_cap is not None,
            f_cap=not has_fail or f_cap is not None)
    if (q_cap is None or (has_loss and r_cap is None)
            or (has_fail and f_cap is None)):
        caps = fleet_caps(grid, q_cap=q_cap)
        q_cap = caps["q_cap"] if q_cap is None else q_cap
        if has_loss and r_cap is None:
            r_cap = caps["r_cap"]
        if has_fail and f_cap is None:
            f_cap = caps["f_cap"]
    q_cap = int(q_cap)
    r_cap = int(r_cap) if has_loss else 0
    f_cap = int(f_cap) if has_fail else 0
    if np.any(grid.b_max > q_cap):
        raise ValueError("b_max exceeds q_cap; raise q_cap")
    if not set(np.unique(grid.routing)) <= set(ROUTE_CODE.values()):
        raise ValueError(f"unknown routing code in grid "
                         f"(valid: {ROUTE_CODE})")
    if has_loss and np.any(grid.q_max > q_cap):
        raise ValueError("q_max exceeds q_cap; raise q_cap")
    if sketch:
        n_bins = SKETCH_BINS
    cfg = dict(n_steps=n_steps, warmup=int(warmup), q_cap=q_cap,
               a_cap=int(a_cap), r_cap=r_cap, f_cap=f_cap,
               n_bins=int(n_bins), hist_every=int(hist_every),
               sketch=bool(sketch),
               ss_backend=_ss.resolve_backend(superstep_backend, dev),
               tap=metrics_tap, device=dev)

    def kernel(params, keys):
        return _run(grid, keys, **cfg)

    return engine.KernelPlan(
        kernel=kernel,
        params={"lam": torch.as_tensor(np.asarray(grid.lam),
                                       dtype=torch.float32, device=dev)},
        keys=prng.point_keys(int(seed), int(key_offset), len(grid), dev),
        n=len(grid), sketch=bool(sketch),
        has_loss=grid.has_loss)


def fleet_sweep(grid: FleetGrid, *, n_steps: int = 6000,
                warmup: Optional[int] = None, q_cap: Optional[int] = None,
                a_cap: int = 32, r_cap: Optional[int] = None,
                f_cap: Optional[int] = None, n_bins: int = 512,
                seed: int = 0, key_offset: int = 0, hist_every: int = 1,
                shard=None, sketch: bool = False,
                superstep_backend: Optional[str] = None,
                metrics_tap=None, device=None) -> FleetResult:
    """Simulate every fleet point for ``n_steps`` replica decisions
    (rounded up to a multiple of 32) on ``device`` — CUDA unless
    ``device="cpu"`` is asked for.

    ``n_steps`` counts fleet-wide events: at moderate load nearly every
    event is a completion that starts the next batch, so size it k×
    larger to give each replica a single-server ``sweep``'s run length.
    ``q_cap`` bounds each replica's waiting room (overflowing it is
    counted in ``buffer_dropped``, 0 in a correct run; ``None`` sizes it
    from the per-replica load, ``fleet_caps``).  ``a_cap`` only tiles
    the arrival routing: a window denser than it defers its event a
    step, exact but slower.  ``hist_every = N > 1`` records a 1-in-N
    step subsample in the histogram (``hist.thinned_rows``); means and
    counters use every job.  ``r_cap`` bounds a loss grid's retry orbit
    and ``f_cap`` a failure grid's failure block (``None``: sized from
    the grid).  Split dispatches (``key_offset != 0``) must pin the
    grid-derived caps (``**fleet_caps(full_grid)``) or this raises.
    ``sketch``, ``superstep_backend`` and ``metrics_tap`` behave as in
    ``sweep``."""
    plan = fleet_plan(grid, n_steps=n_steps, warmup=warmup, q_cap=q_cap,
                      a_cap=a_cap, r_cap=r_cap, f_cap=f_cap, n_bins=n_bins,
                      seed=seed, key_offset=key_offset,
                      hist_every=hist_every, shard=shard, sketch=sketch,
                      superstep_backend=superstep_backend,
                      metrics_tap=metrics_tap, device=device)
    out = engine.dispatch(plan.kernel, plan.params, plan.keys)
    r = _to_result(grid, out, sketch=plan.sketch)
    observe_summary(metrics_tap, "fleet", r)
    return r


def _run(grid: FleetGrid, keys, *, n_steps: int, warmup: int, q_cap: int,
         a_cap: int, r_cap: int, f_cap: int, n_bins: int, hist_every: int,
         sketch: bool, ss_backend: str, tap, device: torch.device) -> dict:
    """The superstep loop over every fleet at once, keyed by ``keys``;
    returns the per-point outputs as device tensors."""
    f32, i32 = torch.float32, torch.int32
    n = len(grid)
    R = _REBASE_EVERY
    has_loss, has_fail = grid.has_loss, grid.has_fail
    k_max = int(grid.k.max())
    has_timeout = bool(np.any(grid.wait_max > 0.0))
    all_det = bool(np.all(grid.dist == DIST_CODE["det"]))
    routes = set(np.unique(grid.routing).tolist())
    # the per-job latency ops run on pop_cap slots: b never exceeds it
    # (the largest b_max, or q_cap where a point batches unboundedly);
    # a deadline's renege scan must see the whole ring
    pop_cap = (q_cap if np.any(grid.b_max == 0)
               or (has_loss and np.any(grid.deadline > 0.0))
               else int(grid.b_max.max()))
    trash = k_max * q_cap               # the buffer slot masked writes hit

    def param(a, dt):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    lam, alpha, tau0 = (param(grid.lam, f32), param(grid.alpha, f32),
                        param(grid.tau0, f32))
    b_cap = param(np.where(grid.b_max > 0, grid.b_max, q_cap), i32)
    dist = param(grid.dist, i32)
    wait_max = param(grid.wait_max, f32)
    wait_target = param(grid.wait_target, i32)
    k = param(np.clip(grid.k, 1, k_max), i32)
    routing = param(grid.routing, i32)
    cv = param(grid.cv, f32)
    kshape = torch.where(dist == DIST_CODE["exp"], torch.ones_like(cv),
                         1.0 / (cv * cv))
    ridx = _arange(k_max, device)
    active = ridx < k.unsqueeze(1)
    slots = _arange(pop_cap, device)
    # the loss ops a grid runs: reneging only where a deadline is set,
    # the retry orbit only where a retry rate is (a point without either
    # gives the same bits through the ops as without them)
    has_deadline = has_loss and bool(np.any(grid.deadline > 0.0))
    has_retry = has_loss and bool(np.any(grid.retry_rate > 0.0))
    if has_timeout:
        do_wait = (wait_max > 0.0) & (wait_target > 1)
    streams = [(_S_ROUTE, a_cap), (_S_GAPS, a_cap)]
    if not all_det:
        streams.append((_S_SERVICE, _MISC_WORDS))
    if has_loss:
        lp = LossParams(grid, q_cap, device)
    if has_retry:
        streams.append((_S_ORBIT, r_cap + 1))
        jr = _arange(r_cap, device)
    if has_fail:
        streams.append((_S_FAIL, 2 * f_cap))
        fp = FailParams(grid, f_cap, device)
    stream_at = {sid: j for j, (sid, _) in enumerate(streams)}

    def zeros(*shape, dt=f32):
        return torch.zeros(n, *shape, dtype=dt, device=device)

    # state: replica r's waiting arrivals are its ring row, oldest at
    # head[r]; times are relative to the superstep's origin
    q, head, in_service = (zeros(k_max, dt=i32) for _ in range(3))
    buf = zeros(trash + 1)
    committed = zeros(k_max, dt=torch.bool)
    t_free = torch.full((n, k_max), _INF, dtype=f32, device=device)
    init = prng.draw_words(keys, 0, 1, ((_S_INIT, 1),))[0]
    next_arr = prng.exponential(init[0, 0]) / lam
    rr, clock = zeros(dt=i32), zeros()
    lat_sum, sum_b, sum_b2, sum_bs, busy, span = (zeros() for _ in range(6))
    lat_n, n_meas, q_max, dropped = (zeros(dt=i32) for _ in range(4))
    jobs_rep = zeros(k_max, dt=i32)
    if has_loss:
        # the orbit, then the measured overflow and abandonment losses,
        # completions in SLO, fresh arrivals and orbit re-arrivals
        orbit, ov_n, ab_n, slo_n, fresh_n, retry_n = (zeros(dt=i32)
                                                      for _ in range(6))
    if has_fail:
        # per replica the degraded phase (its next batch runs at the
        # throttle) and the impaired flag (its batch in flight failed,
        # until its next decision); then the measured failures, repair
        # time and lost work, and the steps whose count the block cut
        deg, imp = zeros(k_max, dt=torch.bool), zeros(k_max, dt=torch.bool)
        n_fail, trunc = zeros(dt=i32), zeros(dt=i32)
        down, lost_work = zeros(), zeros()
    bm = (zeros(), zeros(), zeros(dt=i32))
    hists = (zeros(n_bins, dt=i32),)
    if sketch:
        hists = hists + (zeros(n_bins),)
    # the histogram block holds only the (thinned) rows it bins
    rows = thinned_rows(R, hist_every)
    row_of = {int(t): j for j, t in enumerate(rows)}
    lat_blk = zeros(len(rows), pop_cap)
    inc_blk = zeros(len(rows), pop_cap, dt=torch.bool)

    def gather1(x, idx):
        """``x[p, idx[p]]`` of a ``(P, k_max)`` state row."""
        return torch.gather(x, 1, idx.unsqueeze(1)).squeeze(1)

    def retry_orbit(orbit, lost_ab, lost_ov, t):
        """The bounded retry orbit, once per processed event (Binomial
        thinning over the inter-event gap); the firing block re-arrives
        at t_ev, routed whole to ONE replica by the point's discipline
        (round-robin reads the cursor without advancing it).  Then this
        step's fresh losses are filed, abandoned first; what the orbit
        cannot hold is a terminal loss.  Updates the loop's rings and
        replica state; returns ``(orbit, n_r, terminal abandoned,
        terminal overflow)``."""
        nonlocal q, committed, t_free
        elapsed = torch.clamp(t_ev - clock, min=0.0)
        p_fire = torch.where(
            do_event, 1.0 - torch.exp(-lp.retry_rate * elapsed), 0.0)
        n_r = engine.orbit_draws(u_orb[t], orbit, p_fire)
        orbit = orbit - n_r
        eff2 = None
        if has_fail:
            # the retry block steers around impaired replicas too
            avail2 = active & ~imp
            eff2 = torch.where(avail2.any(1, keepdim=True), avail2, active)
        dest_r = None
        if _R_RANDOM in routes:
            dest_r = random_destinations(u_ret[t].unsqueeze(1), k,
                                         eff2).squeeze(1)
        if _R_RR in routes:
            d = (round_robin_destinations(rr, k, 1, eff2).squeeze(1)
                 if has_fail else (rr % k).long())
            dest_r = d if dest_r is None else torch.where(
                routing == _R_RR, d, dest_r)
        if _R_JSQ in routes:
            load2 = torch.where(active, q + in_service, BIG_LOAD)
            if has_fail:
                load2 = load2 + torch.where(imp & active, IMP_LOAD, 0)
            d = torch.argmin(load2, 1)
            dest_r = d if dest_r is None else torch.where(
                routing == _R_JSQ, d, dest_r)
        q_d, h_d = gather1(q, dest_r), gather1(head, dest_r)
        admit_r = torch.minimum(n_r, torch.clamp(lp.retry_room - q_d, min=0))
        orbit = orbit + (n_r - admit_r)
        flat_r = torch.where(
            jr < admit_r.unsqueeze(1),
            dest_r.unsqueeze(1) * q_cap
            + (h_d.unsqueeze(1) + q_d.unsqueeze(1) + jr) % q_cap, trash)
        buf.scatter_(1, flat_r, t_ev.unsqueeze(1).expand(n, r_cap))
        oh_r = ridx == dest_r.unsqueeze(1)
        q = q + torch.where(oh_r, admit_r.unsqueeze(1), 0)
        # an idle destination schedules its decision at t_ev (plus the
        # policy's timeout delay), like any arrival
        was_comm = (oh_r & committed).any(1)
        rel_r = t_ev
        if has_timeout:
            rel_r = torch.where(do_wait, t_ev + wait_max, t_ev)
        sched_r = oh_r & (~was_comm & (admit_r > 0)).unsqueeze(1)
        committed = committed | sched_r
        t_free = torch.where(sched_r, rel_r.unsqueeze(1), t_free)
        orbit, term_ab, term_ov = engine.orbit_file(
            orbit, lost_ab, lost_ov, r_cap, lp.retry_on)
        return orbit, n_r, term_ab, term_ov

    for i_base in range(0, n_steps, R):
        words = prng.draw_words(keys, i_base, R, streams)
        u_route = prng.uniform(words[0]).permute(0, 2, 1)     # (R, P, A)
        # the window's epochs past next_arr: partial sums of the gaps
        # over an outer dimension (points innermost), so a point's sum
        # does not depend on P
        offs = engine.exp_offsets(prng.exponential(words[1]),
                                  lam).permute(0, 2, 1)       # (R, P, A)
        if not all_det:
            g = _gamma(words[stream_at[_S_SERVICE]], kshape) / kshape
        if has_retry:
            u_orb = prng.uniform(words[stream_at[_S_ORBIT]])
            u_ret, u_orb = u_orb[:, 0], u_orb[:, 1:]
        if has_fail:
            fail_blk = fp.block(words[stream_at[_S_FAIL]])
        del words
        s0, n0 = lat_sum, lat_n

        for t in range(R):
            meas = i_base + t >= warmup
            # 1) route the arrivals that precede the earliest pending
            #    decision (closed form: no departure inside the window;
            #    prefix-stable, so truncating the window below cannot
            #    change an earlier arrival's destination)
            t_dep0 = torch.where(committed, t_free, _INF).amin(1)
            ts_ext = torch.cat((next_arr.unsqueeze(1),
                                next_arr.unsqueeze(1) + offs[t]), 1)
            ts = ts_ext[:, :a_cap]
            eff = None
            if has_fail:
                # steer around impaired replicas (imp only flips at
                # formations, so it is constant inside the window); when
                # every active replica is impaired, all actives take
                # arrivals again — never stalled, only steered
                avail = active & ~imp
                eff = torch.where(avail.any(1, keepdim=True), avail, active)
            dest = None
            if _R_RANDOM in routes:
                dest = random_destinations(u_route[t], k, eff)
            if _R_RR in routes:
                d = round_robin_destinations(rr, k, a_cap, eff)
                dest = d if dest is None else torch.where(
                    (routing == _R_RR).unsqueeze(1), d, dest)
            if _R_JSQ in routes:
                load = torch.where(active, q + in_service, BIG_LOAD)
                if has_fail:
                    load = load + torch.where(imp & active, IMP_LOAD, 0)
                d = jsq_destinations(load, a_cap)
                dest = d if dest is None else torch.where(
                    (routing == _R_JSQ).unsqueeze(1), d, dest)

            # a free replica's first arrival schedules its decision (free
            # means its queue was empty, so that job is the oldest); a
            # decision earlier than t_dep0 shrinks the window
            oh_a = dest.unsqueeze(2) == ridx                 # (P, A, k)
            t_first = torch.where(oh_a, ts.unsqueeze(2), _INF).amin(1)
            rel_k = t_first
            if has_timeout:
                rel_k = torch.where(do_wait.unsqueeze(1),
                                    t_first + wait_max.unsqueeze(1),
                                    t_first)
            free = active & ~committed
            t_dep = torch.minimum(
                t_dep0, torch.where(free, rel_k, _INF).amin(1))
            sched = free & (t_first <= t_dep.unsqueeze(1))
            committed = committed | sched
            t_free = torch.where(sched, rel_k, t_free)

            proc = ts <= t_dep.unsqueeze(1)
            n_proc = proc.sum(1, dtype=i32)
            rr = torch.where(routing == _R_RR, (rr + n_proc) % k, rr)
            # the first unprocessed epoch carries to the next step; if
            # even the block's last epoch precedes the event, the event
            # is deferred and the next step goes on routing (exact)
            mn = torch.where(ts_ext > t_dep.unsqueeze(1), ts_ext,
                             _INF).amin(1)
            next_arr = torch.where(mn < _INF, mn, ts_ext[:, -1])
            do_event = ts_ext[:, -1] > t_dep

            # bulk push: arrival j lands in its replica's ring at head +
            # q + (earlier accepted window arrivals there); a masked
            # write goes to the trash slot past the rings
            onehot = oh_a & proc.unsqueeze(2)
            oi = onehot.to(i32)
            prior = torch.cumsum(oi, 1, dtype=i32) - oi
            fill = torch.gather(q, 1, dest) + torch.gather(
                prior, 2, dest.unsqueeze(2)).squeeze(2)
            if has_loss:
                # admission against the per-replica room: a turned-away
                # arrival is a measured overflow (prefix-greedy: later
                # arrivals see the fill the rejected one never added)
                ok = proc & (fill < lp.room.unsqueeze(1))
                lost_ov = (proc & ~ok).sum(1, dtype=i32)
                lost_ab = zeros(dt=i32)
            else:
                ok = proc & (fill < q_cap)
                dropped = dropped + (proc & ~ok).sum(1, dtype=i32)
            pos = (torch.gather(head, 1, dest) + fill) % q_cap
            buf.scatter_(1, torch.where(ok, dest * q_cap + pos, trash), ts)
            q = q + (onehot & ok.unsqueeze(2)).sum(1, dtype=i32)

            # 2) the event: the earliest committed replica decides; its
            #    batch is read as a pop_cap-wide wrapped gather of its
            #    ring
            t_pend = torch.where(committed, t_free, _INF)
            t_ev, r = t_pend.min(1)
            oh = (ridx == r.unsqueeze(1)) & do_event.unsqueeze(1)
            release = (torch.where(oh, in_service, 1) == 0).any(1)
            qr = torch.where(oh, q, 0).sum(1, dtype=i32)
            hr = torch.where(oh, head, 0).sum(1, dtype=i32)
            row = torch.gather(buf, 1, r.unsqueeze(1) * q_cap
                               + (hr.unsqueeze(1) + slots) % q_cap)

            if has_deadline:
                # deadline reneging: the deciding replica's expired jobs
                # are a FIFO prefix of its row (qr = 0 masks a step
                # without an event)
                n_exp = ((slots < qr.unsqueeze(1))
                         & (row < (t_ev - lp.deadline).unsqueeze(1))).sum(
                             1, dtype=i32)
                n_exp = torch.where(lp.deadline > 0.0, n_exp, 0)
                qr = qr - n_exp
                row = engine.fifo_pop_shift(row, n_exp, pop_cap)
                lost_ab = lost_ab + n_exp

            # a completion whose queue holds jobs re-decides at once:
            # without a (due) timeout it starts the next batch in this
            # same step; a delayed one schedules the release
            if has_timeout:
                want_delay = ((wait_max > 0.0) & (qr < wait_target)
                              & (row[:, 0] + wait_max > t_ev))
                rel_next = torch.where(want_delay, row[:, 0] + wait_max,
                                       t_ev)
                form = release | ((qr > 0) & ~want_delay)
            else:
                rel_next = t_ev
                form = release | (qr > 0)
            if has_loss:
                # reneging can empty a committed replica's queue: the
                # release forms nothing and un-commits
                form = form & (qr > 0)

            # batch formation; the completion time is drawn whole here
            b = torch.minimum(qr, b_cap)
            mean_s = alpha * b.to(f32) + tau0
            s = mean_s if all_det else torch.where(
                dist == DIST_CODE["det"], mean_s, mean_s * g[t])
            comp = s_busy = s
            if has_fail:
                # the batch after a repair runs degraded; breakdowns over
                # the batch stretch its completion (a drop abort ends it
                # at the failure's repair); a failed formation flags the
                # replica impaired until its next decision
                s = s * torch.where((oh & deg).any(1), fp.throttle, 1.0)
                fail = fp.interrupt(fail_blk, t, s, form & (b > 0))
                aborts = fail["aborts"]
                comp = torch.where(aborts, fail["abort_end"], s + fail["ext"])
                s_busy = torch.where(aborts, 0.0, s)
                hit = fail["degraded"].unsqueeze(1)
                imp = torch.where(oh, hit, imp)
                deg = torch.where(oh & form.unsqueeze(1), hit, deg)
                trunc = trunc + fail["trunc"]
            depart = t_ev + comp
            popmask = slots < b.unsqueeze(1)
            done = form
            if has_fail:
                # an aborted batch completes nothing; its jobs re-enter
                # through the abandonment path below
                popmask = popmask & ~aborts.unsqueeze(1)
                done = form & ~aborts
            lats = torch.where(popmask, depart.unsqueeze(1) - row, 0.0)

            if has_loss:
                # prefix removals (reneged + popped) advance the head;
                # the drop-mode trim cuts the newest waiting jobs beyond
                # q_max at the formation epoch
                trim = torch.where(form, torch.clamp(qr - b - lp.trim_to,
                                                     min=0), 0)
                lost_ov = lost_ov + trim
                take = torch.where(form, b, 0)
                if has_deadline:
                    take = n_exp + take
                q = q - torch.where(oh, (take + trim).unsqueeze(1), 0)
                head = torch.where(oh, ((hr + take) % q_cap).unsqueeze(1),
                                   head)
            else:
                ohf = oh & form.unsqueeze(1)
                q = q - torch.where(ohf, b.unsqueeze(1), 0)
                head = torch.where(ohf, ((hr + b) % q_cap).unsqueeze(1),
                                   head)
            in_service = torch.where(oh, torch.where(form, b, 0)
                                     .unsqueeze(1), in_service)
            committed = torch.where(oh, (form | (qr > 0)).unsqueeze(1),
                                    committed)
            t_free = torch.where(oh, torch.where(form, depart, rel_next)
                                 .unsqueeze(1), t_free)

            # 3) statistics (latency recorded at batch start: the depart
            #    epoch is known at formation); busy is productive
            #    execution, repairs and lost work are counted apart
            if meas:
                b_done = torch.where(done, b, 0)
                bf = b_done.to(f32)
                # zero-padded to a power of two: the nonzero latencies
                # sit in the batch's first b slots, so the sum does not
                # depend on pop_cap (which follows the chunk's b_max)
                lat_sum = lat_sum + torch.where(
                    done, engine.padded_row_sum(lats), 0.0)
                lat_n = lat_n + b_done
                sum_b = sum_b + bf
                sum_b2 = sum_b2 + bf * bf
                sum_bs = sum_bs + bf * comp
                n_meas = n_meas + done.to(i32)
                busy = busy + torch.where(form, s_busy, 0.0)
                jobs_rep = jobs_rep + torch.where(oh, b_done.unsqueeze(1), 0)
                span = span + torch.where(do_event, t_ev - clock, 0.0)
                if has_fail:
                    n_fail = n_fail + fail["n_f"]
                    down = down + fail["rep"]
                    lost_work = lost_work + fail["lost"]
            q_max = torch.maximum(q_max, q.amax(1))
            j = row_of.get(t)
            if j is not None:
                lat_blk[:, j] = lats
                inc_blk[:, j] = (popmask & form.unsqueeze(1)) if meas \
                    else False

            if has_loss:
                if has_fail:
                    # fail-drop: the aborted batch's jobs are filed
                    # through the abandonment / retry path
                    lost_ab = lost_ab + torch.where(aborts, b, 0)
                in_slo = torch.where(aborts, 0, b) if has_fail else b
                if has_deadline:
                    in_slo = torch.where(
                        lp.deadline > 0.0,
                        (popmask & (lats <= lp.deadline.unsqueeze(1)))
                        .sum(1, dtype=i32), in_slo)
                # with no retry rate in the grid every loss is terminal
                term_ab, term_ov = lost_ab, lost_ov
                if has_retry:
                    orbit, n_r, term_ab, term_ov = retry_orbit(
                        orbit, lost_ab, lost_ov, t)
                if meas:
                    ab_n = ab_n + term_ab
                    ov_n = ov_n + term_ov
                    slo_n = slo_n + torch.where(form, in_slo, 0)
                    fresh_n = fresh_n + n_proc
                    if has_retry:
                        retry_n = retry_n + n_r

            # the clock tracks the last processed event
            clock = torch.where(do_event, t_ev, clock)

        _ss.hist_update(hists, lat_blk, inc_blk, n_bins=n_bins,
                        backend=ss_backend, sketch=sketch)
        bm = engine.welford_block(bm, lat_sum - s0, lat_n - n0)
        if tap is not None:
            metrics.tap_superstep(
                tap, i_base // R, queue=q.sum(1), jobs=lat_n, busy=busy,
                span=span, dropped=dropped,
                **(dict(overflow=ov_n, abandoned=ab_n) if has_loss
                   else {}))
        # rebase every time to the last processed event
        buf.sub_(clock.unsqueeze(1))
        t_free = t_free - clock.unsqueeze(1)
        next_arr = next_arr - clock
        clock = torch.zeros_like(clock)

    jobs = torch.clamp(lat_n, min=1).to(f32)
    nb = torch.clamp(n_meas, min=1).to(f32)
    out = {
        "mean_latency": lat_sum / jobs,
        "mean_batch": sum_b / nb,
        "batch_m2": sum_b2 / nb,
        "mean_service": sum_bs / torch.clamp(sum_b, min=1e-30),
        "utilization": busy / torch.clamp(k.to(f32) * span, min=1e-30),
        "n_jobs": lat_n,
        "n_batches": n_meas,
        "max_queue": q_max,
        "dropped": dropped,
        "lat_bm_m2": bm[1],
        "lat_bm_n": bm[2],
        "hist": hists[0],
        "jobs_by_replica": jobs_rep,
    }
    if sketch:
        out["hist_sums"] = hists[1]
    if has_loss:
        out.update(overflow_dropped=ov_n, abandoned=ab_n, n_in_slo=slo_n,
                   n_fresh=fresh_n, n_retry=retry_n)
    if has_fail:
        out.update(n_failures=n_fail, down_time=down, lost_work=lost_work,
                   span=span, fail_truncated=trunc)
    return out


def _to_result(grid: FleetGrid, out: dict, *, sketch: bool) -> FleetResult:
    p50, p95, p99 = hist_percentiles(
        out["hist"], (50, 95, 99), edges=sketch_edges() if sketch else None)
    stderr, ci = variance.batch_means_stats(out["lat_bm_m2"],
                                            out["lat_bm_n"])
    f64 = np.float64
    return FleetResult(
        grid=grid,
        mean_latency=out["mean_latency"].astype(f64),
        latency_p50=p50, latency_p95=p95, latency_p99=p99,
        mean_batch=out["mean_batch"].astype(f64),
        batch_m2=out["batch_m2"].astype(f64),
        mean_service=out["mean_service"].astype(f64),
        utilization=np.clip(out["utilization"].astype(f64), 0.0, 1.0),
        n_jobs=out["n_jobs"],
        n_batches=out["n_batches"],
        max_queue=out["max_queue"],
        buffer_dropped=out["dropped"],
        hist=out["hist"],
        hist_sums=out["hist_sums"].astype(f64) if sketch else None,
        stderr=stderr, ci_halfwidth=ci,
        n_blocks=out["lat_bm_n"],
        jobs_by_replica=out["jobs_by_replica"],
        **loss_fields(out), **fail_fields(out),
    )
