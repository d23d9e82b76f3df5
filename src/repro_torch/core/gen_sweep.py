"""The token-level (generate) Monte Carlo sweep in PyTorch.

Port of the reference package's ``repro.core.gen_sweep.gen_sweep``.  A
request is a prefill of
``prompt_len`` tokens plus ``gen_tokens`` decode steps; one step of the
simulation is one cycle of the scheduler:

1. if the system is empty, jump the clock to the carried next arrival
   and enqueue it;
2. admit waiting requests into free decode slots, FIFO, paying one
   batched prefill α_p·(prompt·n_join) + τ0_p inline — ``continuous``
   admits whenever a slot is free, ``static`` only when no sequence is
   active (the paper's batch held to completion, ``max_active`` as
   b_max);
3. decode a *run* of k identical steps in closed form up to the next
   scheduler event (the earliest retirement, the first step boundary
   past an admittable arrival, or the edge of the pre-drawn arrival
   chain), weighting the batch-size moments by k;
4. push the Poisson arrivals of the elapsed window into the waiting
   buffer, and retire the sequences whose remaining tokens ran out.

See the reference module's docstring and docs/theory.md §"Token-level
service law" for why the run-length skipping is exact.

Where the reference ``vmap``s one point's ``lax.scan``, this runs every
point at once: the carry is a set of ``(P, …)`` tensors and the scan a
Python loop, 16 steps (one superstep) at a time.  The waiting room of a
point is a tail-pointer FIFO row ``buf[p, head:tail]`` (admission
advances ``head``, arrivals append at ``tail``).  Per superstep the
loop makes one Threefry draw of the ``(16, a_cap + 1)`` exponential
gaps of every point (``core.prng``), one ``kernels.superstep
.hist_update`` of the block's latencies, one batch-means update, and
one ``kernels.superstep.fifo_compact``, which re-compacts every buffer
to ``head = 0`` with the clock rebase folded in, out of place into a
second buffer that the loop swaps with the first.  Dtypes are the
reference's: float32 clocks and sums, int32 counts.

Loss grids take the loss path, in the reference's order: deadline
reneging at the scheduler epoch as a head advance over the live prefix
(a step whose queue it empties forms no batch and advances no time),
the "drop" trim to ``q_max`` after admission, the window arrivals
admitted against the point's room ("reject"), and the bounded retry
orbit at the run end, whose re-arrivals join the tail at ``t_end``.
Every loss op sits behind the grid's ``has_loss``, so loss-free grids
run the code they ran before, and a neutral point of a loss grid gives
the base path's bits at the same ``q_cap``/``a_cap``.

Failure grids add the breakdown/repair regime at run granularity (the
run — prefill plus k decode steps — is the unit of preemptible work):
a failure clock at rate 1/MTBF runs over the run's busy span, *resume*
extends the run end by its repairs, *restart* prepends the lost
attempts and their repairs, and *drop* aborts the run at its first
failure and files all of its active sequences through the
abandonment/retry path.  Arrivals during repairs join the queue (the
window push uses the extended run end), and the run after a repair
runs degraded: prefill and decode times scale by ``throttle``.  Every
failure op sits behind the grid's ``has_fail`` with a random stream of
its own, so an ``mtbf = 0`` point gives the base path's bits at the
same caps.

A point's result depends only on its parameters, the seed and its
global index, so ``key_offset`` chunks with pinned caps reproduce the
whole-grid dispatch bit for bit.

``gen_plan`` is the run's plan (``engine.KernelPlan``, device
outputs), as ``sweep_plan`` is the sweep's; a ``metrics_tap`` reads the
per-lane counters back once a superstep.  ``shard`` is clamped as in
``sweep``: a ``shard`` that would use more than one device raises
``NotImplementedError`` naming ROADMAP Queue A item 3f.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import engine, metrics, prng, variance
from repro_torch.core.grid import (DISC_CODE, DISC_NAME,  # noqa: F401
                                   FAIL_DISC_CODE, GenGrid, GenResult)
from repro_torch.core.hist import (SKETCH_BINS, hist_percentiles,
                                   sketch_edges, thinned_rows)
from repro_torch.core.sweep import (FailParams,
                                    LossParams, _require_pinned_caps,
                                    _require_ported_options,
                                    fail_capacity_args, fail_fields,
                                    loss_fields, observe_summary,
                                    resolve_device)
from repro_torch.kernels import superstep as _ss

__all__ = ["DISC_CODE", "DISC_NAME", "GenGrid", "GenResult", "gen_sweep",
           "gen_plan", "gen_caps", "buffer_length"]

# scan steps per superstep: the clock rebase, buffer compaction,
# histogram update and batch-means sample happen once per block
_REBASE_EVERY = 16
# n_steps rounds up to a multiple of this (the reference bounds its
# recompiles with it; the port keeps it so both run the same steps)
_STEP_BUCKET = 2048

# named random streams (``prng.draw_words``), keyed by (seed, global
# point index) with counter (step, stream + word): the superstep's
# arrival gaps, the first arrival epoch (drawn once, at step 0), on
# loss grids the retry orbit's r_cap uniforms a step and on failure
# grids the failure epochs and repairs (``f_cap`` each a
# step).  They are disjoint, and a point draws the same words per
# superstep whatever its state, so its bits never depend on the other
# points
_S_GAPS, _S_INIT, _S_ORBIT, _S_FAIL = 0, 1, 2, 3

_BIG = 2 ** 24
_INF = 3.0e38


def buffer_length(q_cap: int, a_cap: int, s_cap: int,
                  r_cap: Optional[int] = None) -> int:
    """Length of a point's FIFO row between two compactions (``r_cap``
    given: a loss grid's).

    The waiting room holds at most ``q_cap`` jobs, and within one
    superstep the tail moves past it by at most the tighter of (a) the
    appends — every accepted arrival plus one idle enqueue per step,
    ≤ (a_cap + 2)·R — and (b) conservation — tail = head + waiting,
    and the head advances by ≤ s_cap joiners per step, ≤ (s_cap + 1)·R.
    An append writes a whole (a_cap + 1) block at the tail.  So
    ``tail + a_cap + 1 <= buffer_length`` holds at every write (the
    reference's sizing, ``gen_sweep.py``'s ``_build_gen_kernel``).
    Under loss, retries append ≤ r_cap more a step (an r_cap block
    write) and reneging breaks the conservation bound, so only the
    append bound holds."""
    if r_cap is not None:
        return (q_cap + (a_cap + 2 + r_cap) * _REBASE_EVERY
                + a_cap + 1 + r_cap)
    return (q_cap + min((a_cap + 2) * _REBASE_EVERY,
                        (s_cap + 1) * _REBASE_EVERY) + a_cap + 1)


def gen_caps(grid: GenGrid, *, q_cap: Optional[int] = None) -> dict:
    """The capacities ``gen_sweep`` would derive from ``grid`` — compute
    once on the FULL grid and splat into every chunk of a split
    dispatch (``gen_sweep(chunk, key_offset=..., **gen_caps(full))``).
    Returns ``q_cap``/``a_cap``, ``r_cap`` on loss grids and ``f_cap``
    on failure grids.  ``q_cap`` and ``r_cap`` are the reference's
    integers on the same grid, and so is ``a_cap`` on failure-free
    grids; on failure grids ``a_cap`` also covers each point's longest
    extended run (``_fail_caps``), which the reference's sizing does
    not."""
    fail_kw = fail_capacity_args(grid)
    if q_cap is None:
        # sized from the static-equivalent request-level law
        q_cap = engine.queue_capacity(
            grid.lam, grid.equivalent_alpha, grid.equivalent_tau0,
            grid.max_active, q_max=grid.q_max if grid.has_loss else None,
            **fail_kw)
    # the densest indivisible window: the batched prefill of a full
    # batch plus the decode step it precedes
    window = (grid.alpha_prefill * grid.prompt_len * grid.max_active
              + grid.tau0_prefill
              + grid.alpha_decode * grid.max_active
              + grid.tau0_decode)
    a_cap = int(engine.window_capacity(grid.lam, window))
    if fail_kw:
        # repairs and rework stretch a run past its nominal span, and
        # the arrival chain must still cover the extended window: scale
        # by the completion inflation and add an MTTR burst allowance
        infl = float(np.max(engine.completion_inflation(
            grid.lam, grid.equivalent_alpha, grid.equivalent_tau0,
            grid.max_active, **fail_kw)))
        burst = float(np.max(2.0 * grid.lam * grid.mttr
                             + 10.0 * np.sqrt(grid.lam * grid.mttr
                                              + 1.0)))
        a_cap = int(np.ceil(a_cap * infl + burst))
    caps = dict(q_cap=int(q_cap), a_cap=a_cap)
    if grid.has_loss:
        caps["r_cap"] = engine.orbit_capacity(grid.lam, grid.retry_rate)
    if fail_kw:
        caps["f_cap"], cover = _fail_caps(grid)
        caps["a_cap"] = max(a_cap, cover)
    return caps


def _fail_caps(grid: GenGrid) -> tuple:
    """``f_cap`` and the arrival chain a failure grid's runs need.  A
    run's busy span is at most a full batch's prefill and ``gen_tokens``
    decode steps, at the throttle.  A run ends inside the chain, and
    its breakdowns then extend it: restart by its lost attempts (each
    shorter than the span, at most ``f_cap`` of them), every
    discipline by its repairs.  The chain must cover the extended run,
    or the arrivals past its edge are lost (``buffer_dropped``): each
    failing point needs the arrivals of its span plus its extension at
    the sizing's tail, ``n`` attempts (restart) or breakdowns (resume;
    drop has one) and the 1e-9 quantile of n repairs, bounded by
    (n + 6√n + 21)·mttr."""
    cap = grid.max_active.astype(np.float64)
    span = ((grid.alpha_prefill * grid.prompt_len * cap + grid.tau0_prefill
             + grid.gen_tokens * (grid.alpha_decode * cap
                                  + grid.tau0_decode))
            * np.maximum(np.asarray(grid.throttle, np.float64), 1.0))
    f_cap = engine.fail_capacity(grid.mtbf, span)
    ext = np.zeros(len(grid))
    on = grid.mtbf > 0
    cells = np.stack([span[on], grid.mtbf[on], grid.mttr[on],
                      grid.fail_disc[on]], 1)
    uniq, inv = np.unique(cells, axis=0, return_inverse=True)
    need = np.zeros(len(uniq))
    for j, (w, mtbf, mttr, disc) in enumerate(uniq):
        if disc == FAIL_DISC_CODE["restart"]:
            n = min(f_cap, engine.restart_attempt_bound(w / mtbf))
            need[j] = n * w
        elif disc == FAIL_DISC_CODE["drop"]:
            n = 1
        else:
            n = min(f_cap, engine.failure_count_bound(w / mtbf))
        need[j] += (n + 6.0 * np.sqrt(n) + 21.0) * mttr
    ext[on] = need[inv.ravel()]
    return f_cap, engine.window_capacity(grid.lam, span + ext)


def gen_plan(grid: GenGrid, *, n_steps: int = 4096,
             warmup: Optional[int] = None, q_cap: Optional[int] = None,
             a_cap: Optional[int] = None, r_cap: Optional[int] = None,
             f_cap: Optional[int] = None,
             n_bins: int = 512, seed: int = 0, key_offset: int = 0,
             hist_every: int = 1, shard=None, sketch: bool = False,
             superstep_backend: Optional[str] = None,
             metrics_tap=None, device=None) -> engine.KernelPlan:
    """Everything ``gen_sweep`` does before the run (validate, pin the
    caps, resolve the device and backend, make the keys); same
    signature, returns an ``engine.KernelPlan`` with device outputs."""
    if not isinstance(grid, GenGrid):
        raise TypeError("gen_sweep needs a GenGrid "
                        "(see GenGrid.from_points/from_product)")
    if len(grid) == 0:
        raise ValueError("empty grid")
    _require_ported_options(shard, len(grid), device)
    dev = resolve_device(device)
    n_steps = -(-int(n_steps) // _STEP_BUCKET) * _STEP_BUCKET
    if warmup is None:
        warmup = max(1, n_steps // 10)
    if not 0 <= warmup < n_steps:
        raise ValueError(f"warmup {warmup} must lie in [0, {n_steps})")
    if int(hist_every) < 1:
        raise ValueError(f"hist_every must be >= 1 (got {hist_every})")
    s_cap = int(grid.max_active.max())
    has_loss, has_fail = grid.has_loss, grid.has_fail
    if key_offset:
        _require_pinned_caps("gen_sweep", key_offset,
                             q_cap=q_cap is not None,
                             a_cap=a_cap is not None,
                             r_cap=not has_loss or r_cap is not None,
                             f_cap=not has_fail or f_cap is not None)
    if (q_cap is None or a_cap is None or (has_loss and r_cap is None)
            or (has_fail and f_cap is None)):
        caps = gen_caps(grid, q_cap=q_cap)
        q_cap = caps["q_cap"] if q_cap is None else q_cap
        a_cap = caps["a_cap"] if a_cap is None else a_cap
        if has_loss and r_cap is None:
            r_cap = caps["r_cap"]
        if has_fail and f_cap is None:
            f_cap = caps["f_cap"]
    q_cap, a_cap = int(q_cap), int(a_cap)
    r_cap = int(r_cap) if has_loss else None
    f_cap = int(f_cap) if has_fail else 0
    if s_cap > q_cap:
        raise ValueError("max_active exceeds q_cap; raise q_cap")
    if has_loss and np.any(grid.q_max > q_cap):
        raise ValueError("q_max exceeds q_cap; raise q_cap")
    if not set(np.unique(grid.discipline)) <= set(DISC_CODE.values()):
        raise ValueError(f"unknown discipline code in grid "
                         f"(valid: {DISC_CODE})")
    if sketch:
        n_bins = SKETCH_BINS
    cfg = dict(n_steps=n_steps, warmup=int(warmup), s_cap=s_cap,
               q_cap=q_cap, a_cap=a_cap, r_cap=r_cap, f_cap=f_cap,
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
        n=len(grid), sketch=bool(sketch), has_loss=has_loss)




def gen_sweep(grid: GenGrid, *, n_steps: int = 4096,
              warmup: Optional[int] = None, q_cap: Optional[int] = None,
              a_cap: Optional[int] = None, r_cap: Optional[int] = None,
              f_cap: Optional[int] = None,
              n_bins: int = 512, seed: int = 0, key_offset: int = 0,
              hist_every: int = 1, shard=None, sketch: bool = False,
              superstep_backend: Optional[str] = None,
              metrics_tap=None, device=None) -> GenResult:
    """Simulate every grid point for ``n_steps`` scheduler decisions
    (rounded up to a multiple of 2048) on ``device`` — CUDA unless
    ``device="cpu"`` is asked for.

    Each step advances a *run* of identical decode steps up to the next
    scheduler event.  ``q_cap`` bounds the waiting buffer and ``a_cap``
    the arrival chain visible per step; exceeding either clamps and
    counts in ``buffer_dropped`` (0 in a correct run).  ``None`` sizes
    them from the grid (``gen_caps``); split dispatches
    (``key_offset != 0``) must pin them from the full grid.
    ``hist_every > 1`` feeds only a fixed scrambled 1-in-N subsample of
    each superstep's steps to the percentile histogram
    (``hist.thinned_rows``); means and counters use every step.
    ``sketch``/``superstep_backend``/``metrics_tap`` behave as in
    ``sweep``.
    ``r_cap`` bounds a loss grid's retry orbit and ``f_cap`` a failure
    grid's failure block (``None``: ``gen_caps``); a grid without the
    regime ignores them."""
    plan = gen_plan(grid, n_steps=n_steps, warmup=warmup, q_cap=q_cap,
                    a_cap=a_cap, r_cap=r_cap, f_cap=f_cap, n_bins=n_bins,
                    seed=seed, key_offset=key_offset, hist_every=hist_every,
                    shard=shard, sketch=sketch,
                    superstep_backend=superstep_backend,
                    metrics_tap=metrics_tap, device=device)
    out = engine.dispatch(plan.kernel, plan.params, plan.keys)
    r = _to_result(grid, out, sketch=plan.sketch)
    observe_summary(metrics_tap, "gen", r)
    return r


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """A float → int32 cast that gives the same run length on every
    device.  XLA's conversion saturates; torch's cast of an out-of-range
    or infinite float is undefined and differs between the CPU and
    CUDA.  Clamping to ±2**24 in float first gives the reference's k:
    every caller takes the min with the remaining-token count (≤ 2**24)
    and clips the result to [1, 2**24]."""
    return x.clamp(-float(_BIG), float(_BIG)).to(torch.int32)


def _run(grid: GenGrid, keys, *, n_steps: int, warmup: int, s_cap: int,
         q_cap: int, a_cap: int, r_cap: Optional[int], f_cap: int,
         n_bins: int, hist_every: int, sketch: bool, ss_backend: str, tap,
         device: torch.device) -> dict:
    """The superstep loop over every point at once, keyed by ``keys``;
    returns the per-point outputs as device tensors, with the buffer
    reach under ``"_limits"`` (checked where the outputs reach the
    host).  ``r_cap`` is None on a loss-free grid."""
    f32, i32 = torch.float32, torch.int32
    n = len(grid)
    R = _REBASE_EVERY
    has_loss, has_fail = r_cap is not None, grid.has_fail
    buf_len = buffer_length(q_cap, a_cap, s_cap, r_cap)
    width = a_cap + 1

    def param(a, dt):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    lam = param(grid.lam, f32)
    a_d, t0_d = param(grid.alpha_decode, f32), param(grid.tau0_decode, f32)
    a_p = param(grid.alpha_prefill, f32)
    t0_p = param(grid.tau0_prefill, f32)
    prompt = param(grid.prompt_len, f32)
    gen = param(grid.gen_tokens, i32).unsqueeze(1)
    cap = param(np.clip(grid.max_active, 1, s_cap), i32)
    is_cont = param(grid.discipline == DISC_CODE["continuous"], torch.bool)
    streams = ((_S_GAPS, width),)
    if has_loss:
        streams += ((_S_ORBIT, r_cap),)
        lp = LossParams(grid, q_cap, device)
        ranks = torch.arange(q_cap, device=device)
    if has_fail:
        streams += ((_S_FAIL, 2 * f_cap),)
        fp = FailParams(grid, f_cap, device)

    def zeros(*shape, dt=f32):
        return torch.zeros(n, *shape, dtype=dt, device=device)

    # state: buf[p, head:tail] are the waiting arrival epochs, oldest
    # first, relative to the superstep origin; the decode pool holds
    # each slot's remaining tokens and its request's arrival epoch
    head, tail = zeros(dt=i32), zeros(dt=i32)
    buf, spare = zeros(buf_len), zeros(buf_len)
    rem, arr_s = zeros(s_cap, dt=i32), zeros(s_cap)
    now = zeros()
    init = prng.draw_words(keys, 0, 1, ((_S_INIT, 1),))[0]
    next_arr = prng.exponential(init[0, 0]) / lam
    lat_sum, sum_b, sum_b2, busy, span = (zeros() for _ in range(5))
    lat_n, n_meas, q_max, dropped = (zeros(dt=i32) for _ in range(4))
    if has_loss:
        # the orbit, then the measured overflow and abandonment losses,
        # completions in SLO, fresh arrivals and orbit re-arrivals
        orbit, ov_n, ab_n, slo_n, fresh_n, retry_n = (zeros(dt=i32)
                                                      for _ in range(6))
    if has_fail:
        # the degraded phase (the next run is throttled), then the
        # measured failures, repair time and lost work, and the steps
        # (warmup too) whose failure count the block truncated
        deg, n_fail, trunc = (zeros(dt=torch.bool), zeros(dt=i32),
                              zeros(dt=i32))
        down, lost_work = zeros(), zeros()
    # the furthest any block write reached, checked after the loop
    reach = zeros(dt=i32)
    bm = (zeros(), zeros(), zeros(dt=i32))
    hists = (zeros(n_bins, dt=i32),)
    if sketch:
        hists = hists + (zeros(n_bins),)
    # the histogram block holds only the (thinned) rows it bins
    rows = thinned_rows(R, hist_every)
    row_of = {int(t): j for j, t in enumerate(rows)}
    lat_blk = zeros(len(rows), s_cap)
    inc_blk = zeros(len(rows), s_cap, dt=torch.bool)

    for i_base in range(0, n_steps, R):
        words = prng.draw_words(keys, i_base, R, streams)
        # epochs of the pre-drawn arrival chain past next_arr, per step:
        # partial sums of the gaps over an outer dimension (points
        # innermost), so a point's sum does not depend on P
        offs = engine.exp_offsets(prng.exponential(words[0]), lam)
        offs = offs.permute(0, 2, 1).contiguous()         # (R, P, width)
        if has_loss:
            u_orb = prng.uniform(words[1])                # (R, r_cap, P)
        if has_fail:
            fail_blk = fp.block(words[-1])
        del words
        s0, n0 = lat_sum, lat_n

        for t in range(R):
            meas = i_base + t >= warmup
            q = tail - head
            t_step0 = now
            active = rem > 0
            n_act = active.sum(1, dtype=i32)

            # 1) idle: system empty — jump to the carried next arrival
            #    and enqueue it.  The write lands at the tail
            #    unconditionally (past-tail slots are garbage until a
            #    later append overwrites them); only the tail advance is
            #    gated.  lax.dynamic_update_slice clamps its start so the
            #    write fits, torch's scatter would fail past the end:
            #    the start is clamped alike (it never binds — see
            #    buffer_length and the check after the loop).
            due = (q == 0) & (n_act == 0)
            now = torch.where(due, torch.maximum(now, next_arr), now)
            buf.scatter_(1, tail.clamp(max=buf_len - 1).unsqueeze(1).long(),
                         next_arr.unsqueeze(1))
            tail = tail + due.to(i32)
            q = q + due.to(i32)

            if has_loss:
                # deadline reneging at the scheduler epoch: the live
                # range is FIFO-sorted epochs, so the expired jobs are a
                # prefix and leave by a head advance.  A point never
                # holds more than q_cap waiting jobs (every admission is
                # bounded by a room <= q_cap), so the live range lies in
                # the q_cap entries from the head
                live = engine.fifo_gather(buf, head,
                                          ranks.expand(n, q_cap))
                expired = ((ranks < q.unsqueeze(1))
                           & (live < (now - lp.deadline).unsqueeze(1)))
                lost_ab = torch.where(lp.deadline > 0.0,
                                      expired.sum(1, dtype=i32), 0)
                head = head + lost_ab
                q = q - lost_ab

            # the pre-drawn arrival chain: entry 0 IS next_arr (consumed
            # above in the idle case), the last entry is the coverage
            # sentinel
            ts_ext = torch.cat((next_arr.unsqueeze(1),
                                next_arr.unsqueeze(1) + offs[t]), 1)

            # 2) admission gate: continuous fills any free slot; static
            #    only starts a fresh batch on an idle server.  Slot s
            #    with free-rank r < n_join reads buf[head + r]; the rank
            #    is an exact int32 scan along the slot axis
            gate = is_cont | (n_act == 0)
            n_join = torch.where(gate, torch.minimum(q, cap - n_act), 0)
            t_pf = torch.where(n_join > 0,
                               a_p * prompt * n_join.to(f32) + t0_p, 0.0)
            if has_fail:
                # a run after a repair is degraded: prefill and decode
                # times scale by the throttle
                thr = torch.where(deg, fp.throttle, 1.0)
                t_pf = t_pf * thr
            inactive = ~active
            rank = torch.cumsum(inactive.to(i32), 1, dtype=i32) - 1
            take = inactive & (rank < n_join.unsqueeze(1))
            arr_s = torch.where(take, engine.fifo_gather(buf, head, rank),
                                arr_s)
            rem = torch.where(take, gen, rem)
            head = head + n_join
            q = q - n_join

            if has_loss:
                # "drop" mode: the newest waiting jobs beyond q_max leave
                # by a tail cut (later appends overwrite the slots)
                lost_ov = torch.clamp(q - lp.trim_to, min=0)
                tail = tail - lost_ov
                q = q - lost_ov

            # 3) run length: k identical decode steps up to the next
            #    event — the earliest retirement, the first step
            #    boundary past the next pending arrival (continuous with
            #    a free slot only), or the edge of the arrival chain
            b = n_act + n_join
            dt = a_d * b.to(f32) + t0_d
            if has_fail:
                dt = dt * thr
            if has_loss:
                # a queue emptied by reneging forms no batch: the step
                # advances no time (dt keeps a safe divisor)
                has_b = b > 0
                dt = torch.where(has_b, dt, 1.0)
            t0r = now + t_pf
            m_min = torch.where(rem > 0, rem, _BIG).amin(1)
            na = torch.where(ts_ext > now.unsqueeze(1), ts_ext,
                             _INF).amin(1)
            watch = is_cont & (b < cap)
            k_arr = torch.where(watch & (na < _INF),
                                _to_i32(torch.ceil((na - t0r) / dt)), _BIG)
            k_cov = _to_i32(torch.floor((ts_ext[:, -1] - t0r) / dt))
            k = torch.minimum(torch.minimum(m_min, k_arr),
                              k_cov).clamp_(1, _BIG)
            if has_loss:
                k = torch.where(has_b, k, 1)
            kf = k.to(f32)
            t_end = t0r + kf * dt
            if has_loss:
                t_end = torch.where(has_b, t_end, now)
            if has_fail:
                # breakdowns over the run's busy span: the extended run
                # end feeds the window push below, so arrivals during
                # repairs join the queue; a drop abort ends the run at
                # the failure's repair
                w = t_pf + kf * dt
                if has_loss:
                    w = torch.where(has_b, w, 0.0)
                fail = fp.interrupt(fail_blk, t, w, w > 0.0)
                aborts = fail["aborts"]
                t_end = torch.where(aborts, now + fail["abort_end"],
                                    t_end + fail["ext"])
                deg = fail["degraded"]
                trunc = trunc + fail["trunc"]

            # 4) window arrivals (now, t_end] join the waiting buffer:
            #    the chain minus the consumed entry 0 in the idle case
            #    (lax.dynamic_slice at start due ∈ {0, 1} of an
            #    (a_cap + 2) chain never needs its clamp); its accepted
            #    prefix is contiguous, so one block write at the tail
            #    appends it FIFO.  The block write's start is clamped as
            #    lax.dynamic_update_slice clamps it (never binding).
            ts_push = torch.where(due.unsqueeze(1), ts_ext[:, 1:],
                                  ts_ext[:, :-1])
            count = ((ts_push > now.unsqueeze(1))
                     & (ts_push <= t_end.unsqueeze(1))).sum(1, dtype=i32)
            sentinel = (ts_ext[:, -1] <= t_end).to(i32)
            if has_loss:
                # each arrival against its point's room: the accepted
                # set is the first (room − q)⁺ (occupancy only grows
                # inside a run); the turned-away ones are overflow
                a = torch.minimum(count, torch.clamp(lp.room - q, min=0))
                lost_ov = lost_ov + (count - a)
                dropped = dropped + sentinel
            else:
                a = torch.minimum(count, q_cap - q)
                dropped = dropped + (count - a) + sentinel
            reach = torch.maximum(reach, tail + width)
            engine.fifo_append(buf, tail.clamp(max=buf_len - width),
                               ts_push)
            tail = tail + a
            q = q + a
            mn = torch.where(ts_ext > t_end.unsqueeze(1), ts_ext,
                             _INF).amin(1)
            next_arr = torch.where(mn < _INF, mn, ts_ext[:, -1])

            # 5) the run retires exactly the rem == k sequences; an
            #    aborted run completes nothing: every active sequence is
            #    dropped whole and filed through the abandonment path
            rem = torch.where(rem > 0, rem - k.unsqueeze(1), 0)
            fin = (take | active) & (rem == 0)
            if has_fail:
                fin &= ~aborts.unsqueeze(1)
                rem = torch.where(aborts.unsqueeze(1), 0, rem)
            lats = torch.where(fin, (t_end.unsqueeze(1) - arr_s), 0.0)
            now = t_end

            # statistics after warmup, weighted by the run length; span
            # includes the idle gap, so utilization = busy/span
            if meas:
                bf = b.to(f32)
                n_fin = fin.sum(1, dtype=i32)
                # a fixed pairwise order over the slots: torch's own
                # reductions pick their split by shape, which would tie
                # a point's float sum to P (and break split dispatch)
                lat_sum = lat_sum + engine.row_sum(lats)
                lat_n = lat_n + n_fin
                # decode-step statistics count the runs that formed a
                # batch and completed; busy is productive execution
                # (repairs and lost work are counted apart)
                kc, ran = kf, (has_b if has_loss else None)
                if has_fail:
                    kc = torch.where(aborts, 0.0, kf)
                    ran = ~aborts if ran is None else ran & ~aborts
                    n_fail = n_fail + fail["n_f"]
                    down = down + fail["rep"]
                    lost_work = lost_work + fail["lost"]
                sum_b = sum_b + kc * bf
                sum_b2 = sum_b2 + kc * bf * bf
                if ran is None:
                    n_meas = n_meas + k
                    busy = busy + (t_pf + kf * dt)
                else:
                    n_meas = n_meas + torch.where(ran, k, 0)
                    busy = busy + torch.where(ran, t_pf + kf * dt, 0.0)
                span = span + (t_end - t_step0)
            q_max = torch.maximum(q_max, q)

            if has_loss:
                # the retry orbit at the run end (Binomial thinning over
                # the whole step); admitted re-arrivals join the tail at
                # t_end.  Then this step's losses are filed, abandoned
                # first; what the orbit cannot hold is a terminal loss.
                # An aborted run's b sequences are filed as abandoned
                if has_fail:
                    lost_ab = lost_ab + torch.where(aborts, b, 0)
                p_fire = 1.0 - torch.exp(-lp.retry_rate * (t_end - t_step0))
                n_r = engine.orbit_draws(u_orb[t], orbit, p_fire)
                admit_r = torch.minimum(
                    n_r, torch.clamp(lp.retry_room - q, min=0))
                orbit = orbit - admit_r
                reach = torch.maximum(reach, tail + r_cap)
                engine.fifo_append(buf, tail.clamp(max=buf_len - r_cap),
                                   t_end.unsqueeze(1).expand(n, r_cap))
                tail = tail + admit_r
                q = q + admit_r
                orbit, term_ab, term_ov = engine.orbit_file(
                    orbit, lost_ab, lost_ov, r_cap, lp.retry_on)
                if meas:
                    ab_n = ab_n + term_ab
                    ov_n = ov_n + term_ov
                    slo_n = slo_n + torch.where(
                        lp.deadline > 0.0,
                        (fin & (lats <= lp.deadline.unsqueeze(1)))
                        .sum(1, dtype=i32), n_fin)
                    fresh_n = fresh_n + due.to(i32) + count
                    retry_n = retry_n + n_r
            j = row_of.get(t)
            if j is not None:
                lat_blk[:, j] = lats
                inc_blk[:, j] = fin if meas else False

        _ss.hist_update(hists, lat_blk, inc_blk, n_bins=n_bins,
                        backend=ss_backend, sketch=sketch)
        bm = engine.welford_block(bm, lat_sum - s0, lat_n - n0)
        if tap is not None:
            metrics.tap_superstep(
                tap, i_base // R, queue=tail - head, jobs=lat_n, busy=busy,
                span=span, dropped=dropped,
                **(dict(overflow=ov_n, abandoned=ab_n) if has_loss
                   else {}))
        # rebase the clock to the superstep end and re-compact every
        # buffer to head = 0, out of place into the spare buffer
        buf, spare = _ss.fifo_compact(buf, head, now, backend=ss_backend,
                                      out=spare), buf
        arr_s = torch.where(rem > 0, arr_s - now.unsqueeze(1), 0.0)
        tail = tail - head
        head = torch.zeros_like(head)
        next_arr = next_arr - now
        now = torch.zeros_like(now)

    jobs = torch.clamp(lat_n, min=1).to(f32)
    nst = torch.clamp(n_meas, min=1).to(f32)
    out = {
        "mean_latency": lat_sum / jobs,
        "mean_batch": sum_b / nst,
        "batch_m2": sum_b2 / nst,
        "utilization": busy / torch.clamp(span, min=1e-30),
        "n_jobs": lat_n,
        "n_steps": n_meas,
        "max_queue": q_max,
        "dropped": dropped,
        "lat_bm_m2": bm[1],
        "lat_bm_n": bm[2],
        "hist": hists[0],
    }
    if sketch:
        out["hist_sums"] = hists[1]
    if has_loss:
        out.update(overflow_dropped=ov_n, abandoned=ab_n, n_in_slo=slo_n,
                   n_fresh=fresh_n, n_retry=retry_n)
    if has_fail:
        out.update(n_failures=n_fail, down_time=down, lost_work=lost_work,
                   span=span, fail_truncated=trunc)
    out["_limits"] = {"reach": (
        reach.max(), buf_len,
        "gen_sweep: a FIFO append reached {got} > buffer length {bound}; "
        "the buffer sizing invariant does not hold")}
    return out


def _to_result(grid: GenGrid, out: dict, *, sketch: bool) -> GenResult:
    p50, p95, p99 = hist_percentiles(
        out["hist"], (50, 95, 99), edges=sketch_edges() if sketch else None)
    stderr, ci = variance.batch_means_stats(out["lat_bm_m2"],
                                            out["lat_bm_n"])
    f64 = np.float64
    return GenResult(
        grid=grid,
        mean_latency=out["mean_latency"].astype(f64),
        latency_p50=p50, latency_p95=p95, latency_p99=p99,
        mean_batch=out["mean_batch"].astype(f64),
        batch_m2=out["batch_m2"].astype(f64),
        utilization=np.clip(out["utilization"].astype(f64), 0.0, 1.0),
        n_jobs=out["n_jobs"],
        n_steps=out["n_steps"],
        max_queue=out["max_queue"],
        buffer_dropped=out["dropped"],
        hist=out["hist"],
        hist_sums=out["hist_sums"].astype(f64) if sketch else None,
        stderr=stderr, ci_halfwidth=ci,
        n_blocks=out["lat_bm_n"],
        **loss_fields(out), **fail_fields(out),
    )
