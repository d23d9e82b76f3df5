"""The token-level (generate) Monte Carlo sweep in PyTorch.

Port of the reference package's ``repro.core.gen_sweep.gen_sweep`` for
grids without loss regimes or failures.  A request is a prefill of
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

A point's result depends only on its parameters, the seed and its
global index, so ``key_offset`` chunks with pinned caps reproduce the
whole-grid dispatch bit for bit.

Not in this slice — each raises ``NotImplementedError`` naming the
ROADMAP item that adds it: loss grids (Queue A 3c), failure grids (3d),
``metrics_tap`` (3e) and ``shard`` > 1 (multi-GPU dispatch, 3f).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import engine, prng, variance
from repro_torch.core.grid import (DISC_CODE, DISC_NAME, GenGrid,  # noqa: F401
                                   GenResult)
from repro_torch.core.hist import (SKETCH_BINS, hist_percentiles,
                                   sketch_edges, thinned_rows)
from repro_torch.core.sweep import (_require_pinned_caps,
                                    _require_ported_options,
                                    _require_supported, resolve_device)
from repro_torch.kernels import superstep as _ss

__all__ = ["DISC_CODE", "DISC_NAME", "GenGrid", "GenResult", "gen_sweep",
           "gen_caps", "buffer_length"]

# scan steps per superstep: the clock rebase, buffer compaction,
# histogram update and batch-means sample happen once per block
_REBASE_EVERY = 16
# n_steps rounds up to a multiple of this (the reference bounds its
# recompiles with it; the port keeps it so both run the same steps)
_STEP_BUCKET = 2048

# named random streams (``prng.draw_words``), keyed by (seed, global
# point index) with counter (step, stream + word): the superstep's
# arrival gaps, and the first arrival epoch (drawn once, at step 0).
# The two are disjoint, and a point draws the same words per superstep
# whatever its state, so its bits never depend on the other points
_S_GAPS, _S_INIT = 0, 1

_BIG = 2 ** 24
_INF = 3.0e38


def buffer_length(q_cap: int, a_cap: int, s_cap: int) -> int:
    """Length of a point's FIFO row between two compactions.

    The waiting room holds at most ``q_cap`` jobs, and within one
    superstep the tail moves past it by at most the tighter of (a) the
    appends — every accepted arrival plus one idle enqueue per step,
    ≤ (a_cap + 2)·R — and (b) conservation — tail = head + waiting,
    and the head advances by ≤ s_cap joiners per step, ≤ (s_cap + 1)·R.
    An append writes a whole (a_cap + 1) block at the tail.  So
    ``tail + a_cap + 1 <= buffer_length`` holds at every write (the
    reference's sizing, ``gen_sweep.py``'s ``_build_gen_kernel``)."""
    return (q_cap + min((a_cap + 2) * _REBASE_EVERY,
                        (s_cap + 1) * _REBASE_EVERY) + a_cap + 1)


def gen_caps(grid: GenGrid, *, q_cap: Optional[int] = None) -> dict:
    """The capacities ``gen_sweep`` would derive from ``grid`` — compute
    once on the FULL grid and splat into every chunk of a split
    dispatch (``gen_sweep(chunk, key_offset=..., **gen_caps(full))``).
    Returns ``q_cap``/``a_cap``, the reference's integers on the same
    grid."""
    _require_supported(grid)
    if q_cap is None:
        # sized from the static-equivalent request-level law
        q_cap = engine.queue_capacity(
            grid.lam, grid.equivalent_alpha, grid.equivalent_tau0,
            grid.max_active)
    # the densest indivisible window: the batched prefill of a full
    # batch plus the decode step it precedes
    window = (grid.alpha_prefill * grid.prompt_len * grid.max_active
              + grid.tau0_prefill
              + grid.alpha_decode * grid.max_active
              + grid.tau0_decode)
    a_cap = int(engine.window_capacity(grid.lam, window))
    return dict(q_cap=int(q_cap), a_cap=a_cap)


def gen_sweep(grid: GenGrid, *, n_steps: int = 4096,
              warmup: Optional[int] = None, q_cap: Optional[int] = None,
              a_cap: Optional[int] = None, r_cap: Optional[int] = None,
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
    ``sketch``/``superstep_backend`` behave as in ``sweep``.
    ``r_cap`` is accepted for signature parity and unused: it only
    sizes the loss kernel's retry orbit."""
    if not isinstance(grid, GenGrid):
        raise TypeError("gen_sweep needs a GenGrid "
                        "(see GenGrid.from_points/from_product)")
    if len(grid) == 0:
        raise ValueError("empty grid")
    _require_supported(grid)
    _require_ported_options(shard, metrics_tap)
    dev = resolve_device(device)
    n_steps = -(-int(n_steps) // _STEP_BUCKET) * _STEP_BUCKET
    if warmup is None:
        warmup = max(1, n_steps // 10)
    if not 0 <= warmup < n_steps:
        raise ValueError(f"warmup {warmup} must lie in [0, {n_steps})")
    if int(hist_every) < 1:
        raise ValueError(f"hist_every must be >= 1 (got {hist_every})")
    s_cap = int(grid.max_active.max())
    if key_offset:
        _require_pinned_caps("gen_sweep", key_offset,
                             q_cap=q_cap is not None,
                             a_cap=a_cap is not None)
    if q_cap is None or a_cap is None:
        caps = gen_caps(grid, q_cap=q_cap)
        q_cap = caps["q_cap"] if q_cap is None else q_cap
        a_cap = caps["a_cap"] if a_cap is None else a_cap
    q_cap, a_cap = int(q_cap), int(a_cap)
    if s_cap > q_cap:
        raise ValueError("max_active exceeds q_cap; raise q_cap")
    if not set(np.unique(grid.discipline)) <= set(DISC_CODE.values()):
        raise ValueError(f"unknown discipline code in grid "
                         f"(valid: {DISC_CODE})")
    if sketch:
        n_bins = SKETCH_BINS
    ss_backend = _ss.resolve_backend(superstep_backend, dev)
    out = _run(grid, n_steps=n_steps, warmup=int(warmup), s_cap=s_cap,
               q_cap=q_cap, a_cap=a_cap, n_bins=int(n_bins),
               seed=int(seed), key_offset=int(key_offset),
               hist_every=int(hist_every), sketch=bool(sketch),
               ss_backend=ss_backend, device=dev)
    return _to_result(grid, out, sketch=bool(sketch))


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """A float → int32 cast that gives the same run length on every
    device.  XLA's conversion saturates; torch's cast of an out-of-range
    or infinite float is undefined and differs between the CPU and
    CUDA.  Clamping to ±2**24 in float first gives the reference's k:
    every caller takes the min with the remaining-token count (≤ 2**24)
    and clips the result to [1, 2**24]."""
    return x.clamp(-float(_BIG), float(_BIG)).to(torch.int32)


def _run(grid: GenGrid, *, n_steps: int, warmup: int, s_cap: int,
         q_cap: int, a_cap: int, n_bins: int, seed: int, key_offset: int,
         hist_every: int, sketch: bool, ss_backend: str,
         device: torch.device) -> dict:
    """The superstep loop over every point at once; returns the
    per-point outputs as numpy arrays."""
    f32, i32 = torch.float32, torch.int32
    n = len(grid)
    R = _REBASE_EVERY
    buf_len = buffer_length(q_cap, a_cap, s_cap)
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
    keys = prng.point_keys(seed, key_offset, n, device)

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
    tail_hi = zeros(dt=i32)
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
        gaps = prng.draw_words(keys, i_base, R, ((_S_GAPS, width),))[0]
        # epochs of the pre-drawn arrival chain past next_arr, per step:
        # partial sums of the gaps over an outer dimension (points
        # innermost), so a point's sum does not depend on P
        offs = engine.exp_offsets(prng.exponential(gaps), lam)
        offs = offs.permute(0, 2, 1).contiguous()         # (R, P, width)
        del gaps
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
            inactive = ~active
            rank = torch.cumsum(inactive.to(i32), 1, dtype=i32) - 1
            take = inactive & (rank < n_join.unsqueeze(1))
            arr_s = torch.where(take, engine.fifo_gather(buf, head, rank),
                                arr_s)
            rem = torch.where(take, gen, rem)
            head = head + n_join
            q = q - n_join

            # 3) run length: k identical decode steps up to the next
            #    event — the earliest retirement, the first step
            #    boundary past the next pending arrival (continuous with
            #    a free slot only), or the edge of the arrival chain
            b = n_act + n_join
            dt = a_d * b.to(f32) + t0_d
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
            kf = k.to(f32)
            t_end = t0r + kf * dt

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
            a = torch.minimum(count, q_cap - q)
            dropped = (dropped + (count - a)
                       + (ts_ext[:, -1] <= t_end).to(i32))
            tail_hi = torch.maximum(tail_hi, tail)
            engine.fifo_append(buf, tail.clamp(max=buf_len - width),
                               ts_push)
            tail = tail + a
            q = q + a
            mn = torch.where(ts_ext > t_end.unsqueeze(1), ts_ext,
                             _INF).amin(1)
            next_arr = torch.where(mn < _INF, mn, ts_ext[:, -1])

            # 5) the run retires exactly the rem == k sequences
            rem = torch.where(rem > 0, rem - k.unsqueeze(1), 0)
            fin = (take | active) & (rem == 0)
            lats = torch.where(fin, (t_end.unsqueeze(1) - arr_s), 0.0)
            now = t_end

            # statistics after warmup, weighted by the run length; span
            # includes the idle gap, so utilization = busy/span
            if meas:
                bf = b.to(f32)
                # a fixed pairwise order over the slots: torch's own
                # reductions pick their split by shape, which would tie
                # a point's float sum to P (and break split dispatch)
                lat_sum = lat_sum + engine.row_sum(lats)
                lat_n = lat_n + fin.sum(1, dtype=i32)
                sum_b = sum_b + kf * bf
                sum_b2 = sum_b2 + kf * bf * bf
                n_meas = n_meas + k
                busy = busy + (t_pf + kf * dt)
                span = span + (t_end - t_step0)
            q_max = torch.maximum(q_max, q)
            j = row_of.get(t)
            if j is not None:
                lat_blk[:, j] = lats
                inc_blk[:, j] = fin if meas else False

        _ss.hist_update(hists, lat_blk, inc_blk, n_bins=n_bins,
                        backend=ss_backend, sketch=sketch)
        bm = engine.welford_block(bm, lat_sum - s0, lat_n - n0)
        # rebase the clock to the superstep end and re-compact every
        # buffer to head = 0, out of place into the spare buffer
        buf, spare = _ss.fifo_compact(buf, head, now, backend=ss_backend,
                                      out=spare), buf
        arr_s = torch.where(rem > 0, arr_s - now.unsqueeze(1), 0.0)
        tail = tail - head
        head = torch.zeros_like(head)
        next_arr = next_arr - now
        now = torch.zeros_like(now)

    worst = int((tail_hi + width).max())
    if worst > buf_len:
        raise RuntimeError(f"gen_sweep: a FIFO append reached {worst} > "
                           f"buffer length {buf_len}; the buffer sizing "
                           f"invariant does not hold")
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
    return {k: v.cpu().numpy() for k, v in out.items()}


def _to_result(grid: GenGrid, out: dict, *, sketch: bool) -> GenResult:
    n_jobs = out["n_jobs"]
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
        n_jobs=n_jobs,
        n_steps=out["n_steps"],
        max_queue=out["max_queue"],
        buffer_dropped=out["dropped"],
        # a loss-free grid completes every measured arrival in SLO
        overflow_dropped=np.zeros_like(n_jobs),
        abandoned=np.zeros_like(n_jobs),
        n_in_slo=n_jobs.copy(),
        n_fresh=n_jobs.copy(),
        n_retry=np.zeros_like(n_jobs),
        hist=out["hist"],
        hist_sums=out["hist_sums"].astype(f64) if sketch else None,
        stderr=stderr, ci_halfwidth=ci,
        n_blocks=out["lat_bm_n"],
    )
