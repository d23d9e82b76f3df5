"""The single-server Monte Carlo sweep in PyTorch.

Port of the reference package's ``repro.core.sweep.sweep``.  The
dynamics are the reference's regenerative batch-by-batch law (see its
module docstring and docs/theory.md): one step per service completion
— an idle gap when the queue is empty, the optional TimeoutBatch delay,
batch formation ``min(q, b_max)``, a det / exp / gamma service time,
the popped jobs' latencies, and the Poisson arrivals of the service
window appended to a linear FIFO buffer whose clock is rebased to the
departure.

Where the reference ``vmap``s one point's ``lax.scan`` over the grid,
this runs every point at once: the carry is a set of ``(P, …)``
tensors and the scan is a Python loop, 32 steps (one superstep) at a
time.  Per superstep it draws all of the block's random words in one
Threefry call (``core.prng``), stacks the 32 steps' latencies into a
``(P, 32, q_cap)`` block, adds that block into the histograms with one
``kernels.superstep.hist_update`` (the CUDA kernel on the card), and
makes one batch-means update.  Dtypes are the reference's: float32
clocks and sums, int32 counts.

Loss grids (any point with ``q_max``, ``deadline`` or ``retry_rate``
set) take the loss path, in the reference's step order: arrivals
admitted against the point's room ("reject"), deadline reneging of the
expired FIFO prefix at the formation epoch (a queue emptied so forms no
batch and takes no service time), the "drop" trim to ``q_max`` after
the pop, and the bounded retry orbit at the departure epoch, whose
re-arrivals join at ``depart``.  Every loss op sits behind the grid's
``has_loss``, so loss-free grids run the code they ran before, bit for
bit, and a neutral point of a loss grid gives the base path's bits.

Failure grids (any point with ``mtbf`` set) add the breakdown/repair
regime, also in the reference's order: a failure clock at rate 1/MTBF
runs while a batch executes, repairs are Exp(MTTR), and the point's
``fail_disc`` handles the batch in flight — *resume* adds its repairs
to the completion, *restart* prepends the lost attempts and their
repairs, *drop* aborts the batch at the first failure and files its
jobs through the abandonment/retry path (so a drop grid is a loss
grid).  The batch after a repair runs degraded, its service scaled by
``throttle``.  Arrivals join over the whole completion window, repairs
included.  Every failure op sits behind the grid's ``has_fail`` and
draws its words from a stream of its own, so failure-free grids run
the code they ran before, and an ``mtbf = 0`` point of a failure grid
gives the base path's bits.

A point's result depends only on its parameters, the seed and its
global index, so ``key_offset`` chunks with pinned caps reproduce the
whole-grid dispatch bit for bit.

``sweep_plan`` is everything ``sweep`` does before the run — validate,
pin the caps, make the keys — and returns an ``engine.KernelPlan``
whose kernel leaves the outputs on the device: ``sweep`` is plan → run
→ host copy → ``SweepResult``, and the campaign driver
(``core.campaign``) folds the device outputs on the card instead.  A
``metrics_tap`` reads the per-lane counters back once a superstep
(``metrics.tap_superstep``).

The k-replica ``fleet_sweep`` and its ``fleet_caps`` live in
``core.fleet`` and are re-exported here, as the reference's module
holds both kernels.

``shard`` is resolved as the reference resolves it, clamped to the
visible devices and the point count; one device runs every call, and a
``shard`` that would use several raises ``NotImplementedError`` naming
ROADMAP Queue A item 3f (multi-GPU dispatch).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import engine, metrics, prng, variance
from repro_torch.core.grid import (DIST_CODE, FAIL_DISC_CODE, OVERFLOW_CODE,
                                   FleetGrid, SweepGrid, SweepResult)
from repro_torch.core.hist import (SKETCH_BINS, hist_percentiles,
                                   sketch_edges)
from repro_torch.kernels import superstep as _ss

__all__ = ["sweep", "sweep_plan", "sweep_caps", "fleet_sweep", "fleet_plan",
           "fleet_caps", "FleetGrid", "resolve_device"]

# steps per superstep: the histogram update and the batch-means sample
# are taken once per block of this many steps
_REBASE_EVERY = 32

# Marsaglia–Tsang tries materialized per gamma draw (fixed-shape RNG).
# Each try accepts with probability > 0.95 for shape ≥ 1 (the k < 1
# case samples shape k + 1 and boosts by U^{1/k}), so all 8 fail with
# probability < 0.05**8 ≈ 4e-11; the draw then falls back to d = k − 1/3,
# a truncation far below Monte Carlo noise.
_GAMMA_TRIES = 8

# failure attempts materialized per step (fixed-shape RNG): each step
# draws f_cap unit-exponential failure epochs and as many repairs
# (``engine.fail_capacity`` sizes f_cap from the grid, at least the
# reference's 16).  Restart's geometric attempt count is truncated at
# the block (the reference's own rule, at 16); resume's Poisson(ξ·s)
# failure count is the number of the block's partial sums inside s,
# truncated at the block too, where the reference samples it unbounded.
# f_cap makes P(M ≥ f_cap) < 1e-9 at each point's longest busy span,
# and a run counts the steps where the block binds in
# ``fail_truncated``.  loss_ref's mirrors sample both counts unbounded

# named random streams of one step (``prng.draw_words``); the misc
# stream holds the idle gap (word 0), the gamma boost uniform (1), the
# gamma accept uniforms (2 … 9) and the Box–Muller words (10 … 17); the
# orbit stream (loss grids only) holds the retry orbit's r_cap uniforms,
# the failure stream (failure grids only) the failure epochs and repairs
_S_MISC, _S_SERVICE, _S_TIMEOUT, _S_ORBIT, _S_FAIL = 0, 1, 2, 3, 4
_MISC_WORDS = 2 + 2 * _GAMMA_TRIES


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU.  Raises when CUDA is asked for (or defaulted to) and
    none is present — there is no quiet CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on CUDA by default and no "
                           "CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class LossParams:
    """A loss grid's per-point tensors, shared by both sweeps: the
    arrival room ``room`` (``q_max`` in "reject" mode, else ``q_cap``),
    the formation bound ``trim_to`` (``q_max`` in "drop" mode, else
    ``q_cap``), the physical room ``retry_room`` re-arrivals meet in
    both modes, the ``deadline`` (0: none), and the retry rate."""

    def __init__(self, grid, q_cap: int, device) -> None:
        def param(a, dt):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        q_lim = param(grid.q_max, torch.int32)
        limited = q_lim > 0
        reject = param(grid.overflow == OVERFLOW_CODE["reject"], torch.bool)
        self.room = torch.where(limited & reject, q_lim, q_cap)
        self.trim_to = torch.where(limited & ~reject, q_lim, q_cap)
        self.retry_room = torch.where(limited,
                                      torch.clamp(q_lim, max=q_cap), q_cap)
        self.deadline = param(grid.deadline, torch.float32)
        self.retry_rate = param(grid.retry_rate, torch.float32)
        self.retry_on = self.retry_rate > 0.0


class FailParams:
    """A failure grid's per-point tensors and its per-step breakdown
    law, shared by both sweeps.  ``block`` turns a superstep's failure
    words into the steps' attempt epochs (Exp with mean MTBF) and the
    partial sums of the epochs and of the repairs (Exp with mean MTTR);
    ``interrupt`` applies one step's breakdowns to a busy span."""

    def __init__(self, grid, f_cap: int, device) -> None:
        def param(a, dt):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        self.f_cap = f_cap
        mtbf = param(grid.mtbf, torch.float32)
        self.on = mtbf > 0.0
        self.scale = torch.where(self.on, mtbf, 1.0)
        self.mttr = param(grid.mttr, torch.float32)
        self.throttle = param(grid.throttle, torch.float32)
        disc = param(grid.fail_disc, torch.int32)
        self.restart = disc == FAIL_DISC_CODE["restart"]
        self.drop = disc == FAIL_DISC_CODE["drop"]

    def block(self, words: torch.Tensor) -> tuple:
        """``(S, 2·f_cap, P)`` words → the attempt epochs and
        the partial sums of epochs and repairs, each ``(S, F, P)``; the
        sums run over an outer dimension, so a point's sums do not
        depend on P."""
        x = prng.exponential(words)
        e = x[:, :self.f_cap] * self.scale
        return (e, torch.cumsum(e, 1),
                torch.cumsum(x[:, self.f_cap:] * self.mttr, 1))

    def interrupt(self, blk: tuple, t: int, w: torch.Tensor,
                  busy: torch.Tensor) -> dict:
        """Step ``t``'s breakdowns over the busy span ``w`` of the points
        where ``busy``.  Resume: the failures are the epochs' partial
        sums inside w, each followed by its repair.  Restart: attempt k
        fails iff its epoch lands inside w, losing that partial work
        plus a repair; the first surviving attempt runs the full w.
        Drop: the work aborts at the first epoch if it lands inside w,
        and only that repair follows.  Returns the aborts, the failure
        count, the repair time, the lost work, the extension of the
        completion past w (not on aborts), the abort's completion
        ``e1 + r1`` and where the block bound the count (resume: all
        f_cap epochs inside w; restart: all f_cap attempts failed)."""
        e_blk, e_cum, r_cum = (x[t] for x in blk)
        on = self.on & busy
        m = (e_cum < w).sum(0, dtype=torch.int32)
        n_rst = torch.cumprod((e_blk < w).to(torch.int32), 0).sum(
            0, dtype=torch.int32)

        def prefix(cum, k):
            # cum[k − 1], 0 where k = 0
            at = torch.gather(cum, 0, (k - 1).clamp(min=0).long()
                              .unsqueeze(0)).squeeze(0)
            return torch.where(k > 0, at, 0.0)

        rep_res, rep_rst = prefix(r_cum, m), prefix(r_cum, n_rst)
        lost_rst = prefix(e_cum, n_rst)
        e1, r1 = e_blk[0], r_cum[0]
        aborts = on & self.drop & (e1 < w)
        restarted = on & self.restart
        n_f = torch.where(on, torch.where(
            self.restart, n_rst,
            torch.where(self.drop, aborts.to(torch.int32), m)), 0)
        rep = torch.where(on, torch.where(
            self.restart, rep_rst,
            torch.where(self.drop, torch.where(aborts, r1, 0.0), rep_res)),
            0.0)
        lost = torch.where(aborts, e1,
                           torch.where(restarted, lost_rst, 0.0))
        trunc = on & ~self.drop & (n_f == self.f_cap)
        return dict(aborts=aborts, n_f=n_f, rep=rep, lost=lost,
                    ext=rep + torch.where(restarted, lost_rst, 0.0),
                    abort_end=e1 + r1, degraded=on & (n_f > 0),
                    trunc=trunc.to(torch.int32))


def _require_ported_options(shard, n_points: int, device=None) -> None:
    """Resolve ``shard`` as the reference's ``engine.resolve_shards``
    does for an integer: clamped to the visible devices
    (``torch.cuda.device_count()`` on a CUDA request, 1 on the CPU) and
    to ``n_points``, so ``shard=2`` on one device runs as one shard, bit
    for bit.  ``None``, ``True`` and ``False`` run on one device.  Raises
    ``ValueError`` below 1 and ``NotImplementedError`` (ROADMAP Queue A
    item 3f) only where more than one device would be used."""
    if shard is None or shard is True or shard is False:
        return
    n_dev = int(shard)
    if n_dev < 1:
        raise ValueError(f"shard must be >= 1 (got {shard})")
    dev = torch.device("cuda" if device is None else device)
    avail = torch.cuda.device_count() if dev.type == "cuda" else 1
    if min(n_dev, avail, n_points) > 1:
        raise NotImplementedError(
            f"shard={shard} would dispatch over {min(n_dev, avail, n_points)}"
            f" devices: multi-GPU dispatch is not ported yet (ROADMAP "
            f"Queue A item 3f)")


def _require_pinned_caps(entry: str, key_offset: int, **pinned) -> None:
    """``key_offset != 0`` marks a chunk of a larger dispatch; every cap
    the defaults would size from this chunk's own grid must be pinned
    from the full grid, or the chunks would run other shapes than the
    whole-grid dispatch.  ``entry`` names the caller (``"sweep"`` or
    ``"gen_sweep"``); its caps helper is ``sweep_caps`` / ``gen_caps``."""
    missing = [k for k, ok in pinned.items() if not ok]
    if missing:
        caps = entry.replace("_sweep", "") + "_caps"
        raise ValueError(
            f"{entry}(key_offset={key_offset}) dispatches a chunk of a "
            f"split campaign, but {', '.join(missing)} would be sized "
            f"adaptively from this chunk's own grid — chunks would run "
            f"different shapes than the whole-grid dispatch. Pin them "
            f"from the FULL grid, e.g. **{caps}(full_grid).")


def _window_sized(grid: SweepGrid) -> bool:
    """Whether ``a_cap`` is sized from the grid (deterministic service,
    no timeout, every b_max finite, no failures), rather than coupled to
    q_cap."""
    return (bool(np.all(grid.dist == DIST_CODE["det"]))
            and not bool(np.any(grid.wait_max > 0.0))
            and not bool(np.any(grid.b_max == 0))
            and not grid.has_fail)


def fail_capacity_args(grid) -> dict:
    """``engine.queue_capacity``'s failure arguments for a grid (none
    on a failure-free one): the room is sized for the completion-time
    law and the repair burst."""
    if not grid.has_fail:
        return {}
    return dict(mtbf=grid.mtbf, mttr=grid.mttr,
                restart=grid.fail_disc == FAIL_DISC_CODE["restart"],
                throttle=grid.throttle)


def sweep_caps(grid: SweepGrid, *, q_cap: Optional[int] = None) -> dict:
    """The capacities ``sweep`` would derive from ``grid`` — compute them
    once on the FULL grid and splat into every chunk of a split
    dispatch (``sweep(chunk, key_offset=..., **sweep_caps(full))``).
    Pass ``q_cap`` to mirror a pinned queue capacity.  Returns
    ``q_cap``/``a_cap``, ``r_cap`` on loss grids and ``f_cap`` on
    failure grids."""
    if q_cap is None:
        q_cap = engine.queue_capacity(
            grid.lam, grid.alpha, grid.tau0, grid.b_max, grid.wait_max,
            q_max=grid.q_max if grid.has_loss else None,
            **fail_capacity_args(grid))
    if _window_sized(grid):
        # deterministic service with a finite cap bounds the service
        # window at α·b_max + τ0, so the per-window draw can be sized
        # to it; otherwise a queue excursion can stretch the window
        # toward τ(q_cap), and a failed batch's completion has no bound
        # at all, so a_cap stays coupled to q_cap
        window = grid.alpha * grid.b_max + grid.tau0
        a_cap = min(int(q_cap), engine.window_capacity(grid.lam, window))
    else:
        a_cap = int(q_cap)
    caps = dict(q_cap=int(q_cap), a_cap=int(a_cap))
    if grid.has_loss:
        caps["r_cap"] = engine.orbit_capacity(grid.lam, grid.retry_rate)
    if grid.has_fail:
        caps["f_cap"] = _fail_cap(grid, int(q_cap))
    return caps


def _fail_cap(grid: SweepGrid, q_cap: int) -> int:
    """``f_cap`` for a sweep grid: the longest busy span is a full
    batch's service at the throttle, its mean when the service law is
    random (exp: Gamma(1), gamma: Gamma(1/cv²))."""
    b = np.where(grid.b_max > 0, grid.b_max, q_cap).astype(np.float64)
    span = ((grid.alpha * b + grid.tau0)
            * np.maximum(np.asarray(grid.throttle, np.float64), 1.0))
    cv = np.asarray(grid.cv, np.float64)
    kshape = np.where(grid.dist == DIST_CODE["det"], np.inf,
                      np.where(grid.dist == DIST_CODE["exp"], 1.0,
                               1.0 / np.maximum(cv * cv, 1e-12)))
    return engine.fail_capacity(grid.mtbf, span, kshape)


def _gamma(misc: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Gamma(k) draws for a superstep, Marsaglia–Tsang with
    ``_GAMMA_TRIES`` fixed tries: ``misc`` is the ``(S, _MISC_WORDS, P)``
    word block, ``k`` the per-point shape; returns ``(S, P)``."""
    boost = k < 1.0
    ka = torch.where(boost, k + 1.0, k)
    d = ka - 1.0 / 3.0
    c = 1.0 / torch.sqrt(d * 9.0)
    x = prng.normal_pairs(misc[:, 2 + _GAMMA_TRIES:])
    u = prng.uniform(misc[:, 2:2 + _GAMMA_TRIES])
    t = x * c + 1.0
    v = t * t * t
    pos = v > 0.0
    logv = torch.log(torch.where(pos, v, 1.0))
    ok = pos & (torch.log(u) < x * x * 0.5 + d - d * v + d * logv)
    first = ok.to(torch.uint8).argmax(dim=1, keepdim=True)
    g = torch.gather(v, 1, first).squeeze(1) * d
    g = torch.where(ok.any(dim=1), g, d.expand_as(g))
    ub = prng.uniform(misc[:, 1])
    return torch.where(boost, g * torch.exp(torch.log(ub) / k), g)


def sweep_plan(grid: SweepGrid, *, n_batches: int = 3000,
               warmup: Optional[int] = None, q_cap: Optional[int] = None,
               a_cap: Optional[int] = None, r_cap: Optional[int] = None,
               f_cap: Optional[int] = None,
               n_bins: int = 512, seed: int = 0, key_offset: int = 0,
               shard=None, sketch: bool = False,
               superstep_backend: Optional[str] = None,
               metrics_tap=None, device=None) -> engine.KernelPlan:
    """Everything ``sweep`` does before the run: validate the grid,
    derive (or check) the caps, resolve the device and the superstep
    backend, and make the keys.  Same signature as ``sweep``; returns an
    ``engine.KernelPlan`` whose kernel returns the device outputs.
    ``sweep`` runs the plan and builds a ``SweepResult`` on the host;
    the campaign driver folds the outputs on the card instead."""
    if len(grid) == 0:
        raise ValueError("empty grid")
    if warmup is not None and not 0 <= warmup < int(n_batches):
        raise ValueError(f"warmup {warmup} must lie in [0, {n_batches})")
    _require_ported_options(shard, len(grid), device)
    dev = resolve_device(device)
    n_batches = -(-int(n_batches) // _REBASE_EVERY) * _REBASE_EVERY
    if warmup is None:
        warmup = max(1, n_batches // 10)
    has_loss, has_fail = grid.has_loss, grid.has_fail
    if key_offset:
        _require_pinned_caps(
            "sweep", key_offset, q_cap=q_cap is not None,
            a_cap=a_cap is not None or not _window_sized(grid),
            r_cap=not has_loss or r_cap is not None,
            f_cap=not has_fail or f_cap is not None)
    if (q_cap is None or a_cap is None or (has_loss and r_cap is None)
            or (has_fail and f_cap is None)):
        caps = sweep_caps(grid, q_cap=q_cap)
        q_cap = caps["q_cap"] if q_cap is None else q_cap
        a_cap = caps["a_cap"] if a_cap is None else a_cap
        if has_loss and r_cap is None:
            r_cap = caps["r_cap"]
        if has_fail and f_cap is None:
            f_cap = caps["f_cap"]
    q_cap, a_cap = int(q_cap), int(a_cap)
    r_cap = int(r_cap) if has_loss else 0
    f_cap = int(f_cap) if has_fail else 0
    if a_cap > q_cap:
        raise ValueError("a_cap must be <= q_cap (ring-buffer invariant)")
    if np.any(grid.b_max > q_cap):
        raise ValueError("b_max exceeds q_cap; raise q_cap")
    if has_loss and np.any(grid.q_max > q_cap):
        raise ValueError("q_max exceeds q_cap; raise q_cap")
    if sketch:
        n_bins = SKETCH_BINS
    cfg = dict(n_batches=n_batches, warmup=int(warmup), q_cap=q_cap,
               a_cap=a_cap, r_cap=r_cap, f_cap=f_cap, n_bins=int(n_bins),
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


def sweep(grid: SweepGrid, *, n_batches: int = 3000,
          warmup: Optional[int] = None, q_cap: Optional[int] = None,
          a_cap: Optional[int] = None, r_cap: Optional[int] = None,
          f_cap: Optional[int] = None,
          n_bins: int = 512, seed: int = 0, key_offset: int = 0,
          shard=None, sketch: bool = False,
          superstep_backend: Optional[str] = None,
          metrics_tap=None, device=None) -> SweepResult:
    """Simulate every grid point for ``n_batches`` service completions
    (rounded up to a multiple of 32) on ``device`` — CUDA unless
    ``device="cpu"`` is asked for.

    ``q_cap`` bounds the waiting room and ``a_cap`` the per-window
    arrival draw; points whose dynamics exceed them report the clamped
    arrivals in ``buffer_dropped`` (0 in a correct run).  ``None`` sizes
    them from the grid (``sweep_caps``).  Split dispatches
    (``key_offset != 0``) must pin them from the full grid.
    ``sketch=True`` keeps the 64-bin sketch and its per-bin latency sums
    instead of the 512-bin histogram.  ``superstep_backend`` picks the
    histogram update (``"cuda"``/``"torch"``/``"auto"`` — see
    ``repro_torch.kernels.superstep``).  ``r_cap`` bounds a loss grid's
    retry orbit (``None``: ``engine.orbit_capacity``) and ``f_cap`` a
    failure grid's failure block (``None``: ``engine.fail_capacity``);
    a grid without the regime ignores them.  ``metrics_tap`` attaches a
    ``repro_torch.core.metrics.MetricsTap`` that receives one record a
    superstep and a final ``summary``."""
    plan = sweep_plan(grid, n_batches=n_batches, warmup=warmup,
                      q_cap=q_cap, a_cap=a_cap, r_cap=r_cap, f_cap=f_cap,
                      n_bins=n_bins, seed=seed, key_offset=key_offset,
                      shard=shard, sketch=sketch,
                      superstep_backend=superstep_backend,
                      metrics_tap=metrics_tap, device=device)
    out = engine.dispatch(plan.kernel, plan.params, plan.keys)
    r = _to_result(grid, out, sketch=plan.sketch)
    observe_summary(metrics_tap, "sweep", r)
    return r


def observe_summary(tap, kind: str, r) -> None:
    """A tapped sweep's final ``summary`` record: points, measured jobs
    and the medians of the per-point percentiles."""
    if tap is not None:
        tap.observe_summary(
            kind=kind, points=len(r.grid), jobs_total=int(r.n_jobs.sum()),
            p50_median=float(np.nanmedian(r.latency_p50)),
            p95_median=float(np.nanmedian(r.latency_p95)),
            p99_median=float(np.nanmedian(r.latency_p99)))


def _run(grid: SweepGrid, keys, *, n_batches: int, warmup: int,
         q_cap: int, a_cap: int, r_cap: int, f_cap: int, n_bins: int,
         sketch: bool, ss_backend: str, tap, device: torch.device) -> dict:
    """The superstep loop over every point at once, keyed by ``keys``;
    returns the per-point outputs as device tensors."""
    f32, i32 = torch.float32, torch.int32
    n = len(grid)
    has_timeout = bool(np.any(grid.wait_max > 0.0))
    all_det = bool(np.all(grid.dist == DIST_CODE["det"]))
    has_loss, has_fail = grid.has_loss, grid.has_fail

    def param(a, dt):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    lam, alpha, tau0 = (param(grid.lam, f32), param(grid.alpha, f32),
                        param(grid.tau0, f32))
    b_cap = param(np.where(grid.b_max > 0, grid.b_max, q_cap), i32)
    dist = param(grid.dist, i32)
    wait_max = param(grid.wait_max, f32)
    wait_target = param(grid.wait_target, i32)
    cv = param(grid.cv, f32)
    kshape = torch.where(dist == DIST_CODE["exp"],
                         torch.ones_like(cv), 1.0 / (cv * cv))
    streams = [(_S_MISC, _MISC_WORDS), (_S_SERVICE, a_cap + 1)]
    if has_timeout:
        streams.append((_S_TIMEOUT, a_cap + 1))
    if has_loss:
        streams.append((_S_ORBIT, r_cap))
        lp = LossParams(grid, q_cap, device)
    if has_fail:
        streams.append((_S_FAIL, 2 * f_cap))
        fp = FailParams(grid, f_cap, device)
    stream_at = {sid: j for j, (sid, _) in enumerate(streams)}

    # state: the FIFO buffer holds arrival times relative to the last
    # departure; buf[:, :q] are the waiting jobs, oldest first.  The
    # retry block appends after the service window's, also at q <= q_cap
    q = torch.zeros(n, dtype=i32, device=device)
    buf = torch.zeros(n, q_cap + a_cap + r_cap, dtype=f32, device=device)
    def zeros(dt):
        return torch.zeros(n, dtype=dt, device=device)

    lat_sum, sum_b, sum_b2, sum_bs, busy, span = (zeros(f32)
                                                  for _ in range(6))
    lat_n, q_max, dropped = zeros(i32), zeros(i32), zeros(i32)
    if has_loss:
        # the orbit, then the measured overflow and abandonment losses,
        # completions in SLO, fresh arrivals and orbit re-arrivals
        orbit, ov_n, ab_n, slo_n, fresh_n, retry_n = (zeros(i32)
                                                      for _ in range(6))
    if has_fail:
        # the degraded phase (the next batch runs at throttle), then the
        # measured failures, repair time and lost work, and the steps
        # (warmup too) whose failure count the block truncated
        deg, n_fail, trunc = zeros(torch.bool), zeros(i32), zeros(i32)
        down, lost_work = zeros(f32), zeros(f32)
    bm = (zeros(f32), zeros(f32), zeros(i32))
    hists = (torch.zeros(n, n_bins, dtype=i32, device=device),)
    if sketch:
        hists = hists + (torch.zeros(n, n_bins, dtype=f32, device=device),)
    lat_blk = torch.zeros(n, _REBASE_EVERY, q_cap, dtype=f32, device=device)
    inc_blk = torch.zeros(n, _REBASE_EVERY, q_cap, dtype=torch.bool,
                          device=device)
    slots = torch.arange(q_cap, device=device)
    # measured steps; under loss, per point, the steps that completed a
    # batch (a queue emptied by reneging forms none, an aborted batch
    # completes none)
    n_steps = 0
    if has_loss:
        n_meas = zeros(i32)

    def push(buf, q, dropped, lost_ov, fresh, offs, t0, win):
        """A window's arrivals; under loss, each against its point's
        room, the turned-away ones counted as overflow."""
        if not has_loss:
            buf, q, dropped = engine.push_poisson_window(
                buf, q, dropped, offs, t0, win, q_cap=q_cap)
            return buf, q, dropped, lost_ov, fresh
        buf, q, dropped, acc, rej = engine.push_poisson_window_loss(
            buf, q, dropped, offs, t0, win, q_cap=q_cap, room=lp.room)
        return buf, q, dropped, lost_ov + rej, fresh + acc + rej

    for i_base in range(0, n_batches, _REBASE_EVERY):
        words = prng.draw_words(keys, i_base, _REBASE_EVERY, streams)
        misc = words[0]
        gap = prng.exponential(misc[:, 0]) / lam
        offs_s = engine.exp_offsets(prng.exponential(words[1]), lam)
        if has_timeout:
            offs_t = engine.exp_offsets(
                prng.exponential(words[stream_at[_S_TIMEOUT]]), lam)
        if has_loss:
            u_orb = prng.uniform(words[stream_at[_S_ORBIT]])
        if has_fail:
            fail_blk = fp.block(words[stream_at[_S_FAIL]])
        if not all_det:
            g = _gamma(misc, kshape) / kshape
        del words, misc
        s0, n0 = lat_sum, lat_n

        for t in range(_REBASE_EVERY):
            meas = i_base + t >= warmup
            lost_ov = lost_ab = fresh = None
            # idle period: the step begins when a job arrives to an
            # empty system; the queue is empty, so the slot is 0
            empty = q == 0
            now = torch.where(empty, gap[t], 0.0)
            buf[:, 0] = torch.where(empty, now, buf[:, 0])
            q = q + empty.to(i32)
            if has_loss:
                lost_ov, fresh = zeros(i32), empty.to(i32)

            if has_timeout:
                # delay service until oldest + wait_max while fewer than
                # wait_target wait; arrivals meanwhile join the queue
                do_wait = (wait_max > 0.0) & (q < wait_target)
                release = torch.where(
                    do_wait, torch.maximum(now, buf[:, 0] + wait_max), now)
                buf, q, dropped, lost_ov, fresh = push(
                    buf, q, dropped, lost_ov, fresh, offs_t[t], now,
                    release - now)
            else:
                release = now

            if has_loss:
                # deadline reneging at the formation epoch: the expired
                # jobs are a FIFO prefix
                buf, q, lost_ab = engine.renege_prefix(
                    buf, q, release, lp.deadline, q_cap)

            # form the batch: take min(waiting, cap), FIFO
            b = torch.minimum(q, b_cap)
            mean_s = alpha * b.to(f32) + tau0
            s = mean_s if all_det else torch.where(
                dist == DIST_CODE["det"], mean_s, mean_s * g[t])
            if has_loss:
                # a queue emptied by reneging forms no batch: no service
                # time elapses and the next step idles
                s = torch.where(b > 0, s, 0.0)
            comp = s
            if has_fail:
                # the batch after a repair runs degraded; breakdowns
                # while it executes stretch its completion (a drop
                # abort ends it at the failure's repair instead)
                s = s * torch.where(deg, fp.throttle, 1.0)
                fail = fp.interrupt(fail_blk, t, s, b > 0)
                aborts = fail["aborts"]
                comp = torch.where(aborts, fail["abort_end"],
                                   s + fail["ext"])
                deg = fail["degraded"]
                trunc = trunc + fail["trunc"]
            depart = release + comp

            # pop the b oldest jobs; their latency ends at `depart`.  An
            # aborted batch completes none: its jobs leave through the
            # abandonment path
            popmask = slots < b.unsqueeze(1)
            b_done = b
            if has_fail:
                popmask &= ~aborts.unsqueeze(1)
                b_done = torch.where(aborts, 0, b)
            lats = torch.where(popmask,
                               depart.unsqueeze(1) - buf[:, :q_cap], 0.0)
            buf = engine.fifo_pop_shift(buf, b, q_cap)
            q = q - b
            if has_loss:
                # "drop" mode: the newest waiting jobs beyond q_max leave
                # at the formation epoch
                trim = torch.clamp(q - lp.trim_to, min=0)
                q = q - trim
                lost_ov = lost_ov + trim

            # arrivals during the service period join the queue; under
            # failures the period is the whole completion, repairs and
            # rework included
            buf, q, dropped, lost_ov, fresh = push(
                buf, q, dropped, lost_ov, fresh, offs_s[t], release, comp)

            if has_loss:
                # the retry orbit at the departure epoch: each orbit job
                # fires with p = 1 − exp(−rate·elapsed); admitted
                # re-arrivals join at `depart`, the rest stay in orbit.
                # Then this step's losses are filed, abandoned first;
                # what the orbit cannot hold is a terminal loss.  An
                # aborted batch's b jobs are filed as abandoned
                if has_fail:
                    lost_ab = lost_ab + torch.where(aborts, b, 0)
                p_fire = 1.0 - torch.exp(-lp.retry_rate * depart)
                n_r = engine.orbit_draws(u_orb[t], orbit, p_fire)
                admit_r = torch.minimum(
                    n_r, torch.clamp(lp.retry_room - q, min=0))
                orbit = orbit - admit_r
                engine.fifo_append(buf, q, depart.unsqueeze(1).expand(
                    n, r_cap))
                q = q + admit_r
                orbit, term_ab, term_ov = engine.orbit_file(
                    orbit, lost_ab, lost_ov, r_cap, lp.retry_on)
                if meas:
                    ab_n = ab_n + term_ab
                    ov_n = ov_n + term_ov
                    fresh_n = fresh_n + fresh
                    retry_n = retry_n + n_r
                    slo_n = slo_n + torch.where(
                        lp.deadline > 0.0,
                        (popmask & (lats <= lp.deadline.unsqueeze(1)))
                        .sum(1, dtype=i32), b_done)
            # rebase the clock: the departure becomes the next origin
            buf.sub_(depart.unsqueeze(1))

            lat_blk[:, t] = lats
            if meas:
                inc_blk[:, t] = popmask
                # batch statistics count completed batches: an aborted
                # one adds nothing, and a job's service is the whole
                # completion; busy is productive execution only (repairs
                # and lost work are counted apart)
                lat_sum = lat_sum + engine.row_sum(lats)
                lat_n = lat_n + b_done
                bf = b_done.to(f32)
                sum_b = sum_b + bf
                sum_b2 = sum_b2 + bf * bf
                sum_bs = sum_bs + bf * comp
                busy = busy + (torch.where(aborts, 0.0, s) if has_fail
                               else s)
                span = span + depart
                n_steps += 1
                if has_loss:
                    n_meas = n_meas + (b_done > 0).to(i32)
                if has_fail:
                    n_fail = n_fail + fail["n_f"]
                    down = down + fail["rep"]
                    lost_work = lost_work + fail["lost"]
            else:
                inc_blk[:, t] = False
            q_max = torch.maximum(q_max, q)

        _ss.hist_update(hists, lat_blk, inc_blk, n_bins=n_bins,
                        backend=ss_backend, sketch=sketch)
        # one batch-means sample per superstep: the mean latency of the
        # jobs that completed inside this block
        bm = engine.welford_block(bm, lat_sum - s0, lat_n - n0)
        if tap is not None:
            metrics.tap_superstep(
                tap, i_base // _REBASE_EVERY, queue=q, jobs=lat_n,
                busy=busy, span=span, dropped=dropped,
                **(dict(overflow=ov_n, abandoned=ab_n) if has_loss
                   else {}))

    jobs = torch.clamp(lat_n, min=1).to(f32)
    nb = float(max(n_steps, 1))
    mean_batch, batch_m2 = sum_b / nb, sum_b2 / nb
    if has_loss:
        # a point that formed a batch at every measured step divides as
        # the loss-free path does (on CUDA a host-scalar divisor is a
        # multiply by its reciprocal), so neutral points keep its bits
        full = n_meas == n_steps
        nbt = torch.clamp(n_meas, min=1).to(f32)
        mean_batch = torch.where(full, mean_batch, sum_b / nbt)
        batch_m2 = torch.where(full, batch_m2, sum_b2 / nbt)
    out = {
        "mean_latency": lat_sum / jobs,
        "mean_batch": mean_batch,
        "batch_m2": batch_m2,
        "mean_service": sum_bs / torch.clamp(sum_b, min=1e-30),
        "utilization": busy / torch.clamp(span, min=1e-30),
        "n_jobs": lat_n,
        "max_queue": q_max,
        "dropped": dropped,
        "lat_bm_m2": bm[1],
        "lat_bm_n": bm[2],
        "hist": hists[0],
    }
    if sketch:
        out["hist_sums"] = hists[1]
    if has_loss:
        out.update(n_batches=n_meas, overflow_dropped=ov_n, abandoned=ab_n,
                   n_in_slo=slo_n, n_fresh=fresh_n, n_retry=retry_n)
    if has_fail:
        out.update(n_failures=n_fail, down_time=down, lost_work=lost_work,
                   span=span, fail_truncated=trunc)
    if not has_loss:
        out["n_batches"] = torch.full((n,), n_steps, dtype=i32,
                                      device=device)
    return out


def loss_fields(out: dict) -> dict:
    """A run's loss counters for its result; a loss-free run completes
    every measured arrival in SLO, so its counters are synthesised."""
    if "n_in_slo" in out:
        return {k: out[k] for k in ("overflow_dropped", "abandoned",
                                    "n_in_slo", "n_fresh", "n_retry")}
    n_jobs = out["n_jobs"]
    return dict(overflow_dropped=np.zeros_like(n_jobs),
                abandoned=np.zeros_like(n_jobs), n_in_slo=n_jobs.copy(),
                n_fresh=n_jobs.copy(), n_retry=np.zeros_like(n_jobs))


def fail_fields(out: dict) -> dict:
    """A failure run's accounting for its result (none otherwise: the
    result's fields stay None, and availability reads 1)."""
    if "n_failures" not in out:
        return {}
    f64 = np.float64
    return dict(n_failures=out["n_failures"],
                down_time=out["down_time"].astype(f64),
                lost_work=out["lost_work"].astype(f64),
                span=out["span"].astype(f64),
                fail_truncated=out["fail_truncated"])


def _to_result(grid: SweepGrid, out: dict, *, sketch: bool) -> SweepResult:
    n_jobs = out["n_jobs"]
    p50, p95, p99 = hist_percentiles(
        out["hist"], (50, 95, 99), edges=sketch_edges() if sketch else None)
    stderr, ci = variance.batch_means_stats(out["lat_bm_m2"],
                                            out["lat_bm_n"])
    f64 = np.float64
    return SweepResult(
        grid=grid,
        mean_latency=out["mean_latency"].astype(f64),
        latency_p50=p50, latency_p95=p95, latency_p99=p99,
        mean_batch=out["mean_batch"].astype(f64),
        batch_m2=out["batch_m2"].astype(f64),
        mean_service=out["mean_service"].astype(f64),
        utilization=np.clip(out["utilization"].astype(f64), 0.0, 1.0),
        n_jobs=n_jobs,
        n_batches=out["n_batches"],
        max_queue=out["max_queue"],
        buffer_dropped=out["dropped"],
        hist=out["hist"],
        hist_sums=out["hist_sums"].astype(f64) if sketch else None,
        stderr=stderr, ci_halfwidth=ci,
        n_blocks=out["lat_bm_n"],
        **loss_fields(out), **fail_fields(out),
    )


# the fleet kernel shares this module's helpers; it is imported last so
# that they exist when it loads
from repro_torch.core.fleet import fleet_caps, fleet_sweep  # noqa: E402
