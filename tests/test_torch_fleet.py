"""The port's k-replica fleet sweep (``repro_torch.core.sweep
.fleet_sweep``) against the reference package and the host oracles.

- ``FleetGrid``, ``FleetResult`` and the routing codes field for field,
  and ``fleet_caps`` equal to ``repro.core.sweep.fleet_caps`` on the
  reference's own test grids and the availability benchmark's.
- The closed-form window routing (random, round-robin, JSQ
  water-filling, with and without impaired replicas) bit for bit
  against a per-arrival loop.
- ``fleet_sweep(device="cpu")`` against the reference ``fleet_sweep``
  on ``tests/test_fleet.py``'s grid at 3σ; k = 1 against the port's
  ``sweep``; a random split against the single queue at λ/k; JSQ
  against ``simulate_jsq_numpy``; the ``FL_CFG`` loss and failure
  ladders of ``tests/test_backpressure.py`` and ``tests/test_failures.py``
  against the port's ``loss_ref.simulate_fleet_loss_numpy``.
- Bitwise: split dispatch, the neutral points of loss and failure
  grids, and ``hist_every`` (only the histogram thins).
- B1's plain version on a fleet block captured mid-run, against the
  reference's ``hist_update``.
- ``evaluate(backend="fleet")`` and ``simulate_jsq`` with the
  reference's guards and messages.

Monte Carlo output cannot match the reference bit for bit (the two
packages draw different random streams), so it is held statistically.
The ``cuda``-marked case needs the card and skips elsewhere.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sweep as ref_sweep_mod
from repro.core.evaluate import evaluate as ref_evaluate
from repro.core.grid import FleetGrid as RefFleetGrid
from repro.core.grid import FleetResult as RefFleetResult
from repro.core.grid import ROUTE_CODE as REF_ROUTE_CODE
from repro.core.grid import ROUTE_NAME as REF_ROUTE_NAME
from repro.core.grid import SweepGrid as RefGrid
from repro.kernels import superstep as ref_ss
from repro_torch import convert
from repro_torch.core import evaluate, fleet, replicas
from repro_torch.core.analytic import LinearServiceModel
from repro_torch.core.grid import (ROUTE_CODE, ROUTE_NAME, FleetGrid,
                                   FleetResult, SweepGrid)
from repro_torch.core.loss_ref import simulate_fleet_loss_numpy
from repro_torch.core.markov import solve
from repro_torch.core.sweep import fleet_caps, fleet_sweep, sweep
from repro_torch.kernels import superstep as pt_ss

# the test workers run side by side: one intra-op thread each keeps
# torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

CPU = dict(device="cpu")
V100 = LinearServiceModel(alpha=0.1438, tau0=1.8874)
ALPHA, TAU0 = V100.alpha, V100.tau0
MODEL = LinearServiceModel(alpha=0.05, tau0=1.0)

# tests/test_fleet.py's shared dispatch
KW = dict(n_steps=4992, q_cap=128, a_cap=32, seed=7)
LAM1 = 0.5 / ALPHA
N_JSQ = 6


def _fleet_axes():
    lam = [LAM1] * 3 + [4 * LAM1] * 2 + [LAM1] + [4 * LAM1] * N_JSQ
    return (lam, ALPHA, TAU0), dict(
        k=[1, 1, 1, 4, 4, 1] + [4] * N_JSQ,
        routing=(["random", "round_robin", "jsq", "random", "round_robin",
                  "random"] + ["jsq"] * N_JSQ),
        b_max=[0] * 5 + [64] + [0] * N_JSQ,
        wait_max=[0.0] * 5 + [5.0] + [0.0] * N_JSQ,
        wait_target=[0] * 5 + [32] + [0] * N_JSQ)


# tests/test_backpressure.py's and tests/test_failures.py's fleet ladders
N_REPS, N_REF = 6, 3
BP_CFG = [("random", "reject", 6, 4.0, 0.5), ("jsq", "drop", 12, 1.8, 0.5)]
BP_LAM, BP_K, BP_B = 8.0, 2, 4
LOSS_FIELDS = ("goodput_frac", "reject_frac", "abandon_frac",
               "retry_inflation", "mean_latency")
FAIL_CFG = [("resume", "jsq"), ("restart", "random"), ("drop", "round_robin")]
FAIL_LAM, FAIL_K, FAIL_B, FAIL_MTBF, FAIL_MTTR = 6.0, 2, 4, 8.0, 0.5
FAIL_FIELDS = ("mean_latency", "utilization", "availability",
               "work_loss_frac")


def _bp_axes():
    cfg = [c for c in BP_CFG for _ in range(N_REPS)]
    return ([BP_LAM] * len(cfg), MODEL.alpha, MODEL.tau0), dict(
        k=BP_K, routing=[c[0] for c in cfg], b_max=BP_B,
        q_max=[c[2] for c in cfg], deadline=[c[3] for c in cfg],
        overflow=[c[1] for c in cfg], retry_rate=[c[4] for c in cfg])


def _fail_axes():
    cfg = [c for c in FAIL_CFG for _ in range(N_REPS)]
    return ([FAIL_LAM] * len(cfg), MODEL.alpha, MODEL.tau0), dict(
        k=FAIL_K, b_max=FAIL_B, routing=[c[1] for c in cfg],
        fail_disc=[c[0] for c in cfg], mtbf=FAIL_MTBF, mttr=FAIL_MTTR)


def _availability_axes():
    """benchmarks/availability.py's fleet half: 2 ρ × k 1, 4 × 3 (mtbf,
    mttr) × 3 disciplines, JSQ, b_max 8."""
    cap = 8 / (ALPHA * 8 + TAU0)
    cells = [(rho, kk, p, d) for rho in (0.5, 0.75) for kk in (1, 4)
             for p in ((0.0, 0.0), (250.0, 12.0), (60.0, 12.0))
             for d in ("resume", "restart", "drop")]
    return ([c[0] * c[1] * cap for c in cells], ALPHA, TAU0), dict(
        k=[c[1] for c in cells], routing="jsq", b_max=8,
        mtbf=[c[2][0] for c in cells], mttr=[c[2][1] for c in cells],
        fail_disc=[c[3] for c in cells])


def _split_axes():
    return ([1.0, 2.0, 2.0, 3.0], 0.1438, 1.8874), dict(
        k=[4, 4, 2, 4], routing=["jsq", "random", "round_robin", "jsq"])


GRIDS = {"fleet": _fleet_axes, "split": _split_axes, "bp": _bp_axes,
         "fail": _fail_axes, "availability": _availability_axes}


def _grids(name):
    args, kw = GRIDS[name]()
    return FleetGrid.from_points(*args, **kw), RefFleetGrid.from_points(
        *args, **kw)


def _se(a, b, floor):
    return max(math.sqrt(np.var(a, ddof=1) / len(a)
                         + np.var(b, ddof=1) / len(b)), floor)


# -- records, codes and caps ------------------------------------------------

def test_fleet_grid_and_result_field_for_field():
    assert ROUTE_CODE == REF_ROUTE_CODE and ROUTE_NAME == REF_ROUTE_NAME
    assert ([f.name for f in dataclasses.fields(FleetGrid)]
            == [f.name for f in dataclasses.fields(RefFleetGrid)])
    # the port's results add the failure block's witness,
    # ``fail_truncated``, to the reference's fields
    assert ([f.name for f in dataclasses.fields(FleetResult)
             if f.name != "fail_truncated"]
            == [f.name for f in dataclasses.fields(RefFleetResult)])
    pairs = [_grids(name) for name in GRIDS]
    pairs.append((
        FleetGrid.from_product([1.0, 2.0], [0.1], [1.0], ks=(1, 2, 4),
                               routings=("jsq", "random"), b_maxes=(0, 8)),
        RefFleetGrid.from_product([1.0, 2.0], [0.1], [1.0], ks=(1, 2, 4),
                                  routings=("jsq", "random"),
                                  b_maxes=(0, 8))))
    pairs.append((
        FleetGrid.from_rhos([0.2, 0.8], 0.1, 1.0, ks=range(1, 5),
                            routings=("random", "round_robin", "jsq"),
                            q_max=8, mtbf=40.0, mttr=1.0),
        RefFleetGrid.from_rhos([0.2, 0.8], 0.1, 1.0, ks=range(1, 5),
                               routings=("random", "round_robin", "jsq"),
                               q_max=8, mtbf=40.0, mttr=1.0)))
    for g, rg in pairs:
        for a, b in zip(g._arrays(), rg._arrays()):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(g.rho, rg.rho)
        assert g.routing_names == rg.routing_names
        assert (g.has_loss, g.has_fail) == (rg.has_loss, rg.has_fail)
        t, rt = g.take(slice(1, 3)), rg.take(slice(1, 3))
        assert all(np.array_equal(a, b)
                   for a, b in zip(t._arrays(), rt._arrays()))
    with pytest.raises(TypeError):
        SweepGrid.from_points([1.0], 0.1, 1.0).concat(pairs[0][0])


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_fleet_caps_equal_the_reference(name):
    g, rg = _grids(name)
    got, want = fleet_caps(g), ref_sweep_mod.fleet_caps(rg)
    assert {k: got[k] for k in want} == want
    assert ("f_cap" in got) == g.has_fail
    if g.has_fail:
        assert got["f_cap"] >= 16 and got["f_cap"] % 16 == 0
    # a pinned q_cap passes through as the reference's does
    assert fleet_caps(g, q_cap=96)["q_cap"] == ref_sweep_mod.fleet_caps(
        rg, q_cap=96)["q_cap"] == 96


# -- the window routing ------------------------------------------------------

def _routing_inputs(seed, impaired):
    """64 fleets of up to 8 replicas: k, loads with ties, impaired masks
    (some fleets impaired whole), the eligibility mask the kernel
    builds, the cursor and the route uniforms."""
    rng = np.random.default_rng(seed)
    p, kmax, n = 64, 8, 33
    k = rng.integers(1, kmax + 1, p).astype(np.int32)
    active = np.arange(kmax) < k[:, None]
    q = rng.integers(0, 6, (p, kmax)).astype(np.int32)
    imp = (rng.random((p, kmax)) < 0.4) & impaired
    imp[:4] = active[:4] & impaired           # every replica impaired
    load = np.where(active, q, fleet.BIG_LOAD)
    load = load + np.where(imp & active, fleet.IMP_LOAD, 0)
    avail = active & ~imp
    eff = np.where(avail.any(1, keepdims=True), avail, active)
    rr = rng.integers(0, 100, p).astype(np.int32)
    u = rng.random((p, n)).astype(np.float32)
    return k, load.astype(np.int32), eff, rr, u, n


def _loop_jsq(load, n):
    out = np.empty((len(load), n), np.int64)
    for i, row in enumerate(load):
        cur = row.astype(np.int64).copy()
        for j in range(n):
            d = int(np.argmin(cur))
            out[i, j] = d
            cur[d] += 1
    return out


def _loop_random(u, k, eff):
    out = np.empty(u.shape, np.int64)
    for i in range(len(u)):
        cand = (np.arange(int(k[i])) if eff is None
                else np.flatnonzero(eff[i]))
        n_c = np.float32(len(cand))
        for j, x in enumerate(u[i]):
            out[i, j] = cand[min(int(np.float32(x) * n_c), len(cand) - 1)]
    return out


def _loop_rr(rr, k, n, eff):
    out = np.empty((len(rr), n), np.int64)
    for i in range(len(rr)):
        ki = int(k[i])
        for j in range(n):
            start = (int(rr[i]) + j) % ki
            if eff is None:
                out[i, j] = start
                continue
            out[i, j] = next((start + o) % ki for o in range(ki)
                             if eff[i, (start + o) % ki])
    return out


@pytest.mark.parametrize("impaired", [False, True],
                         ids=["healthy", "impaired"])
@pytest.mark.parametrize("routing", ["random", "round_robin", "jsq"])
def test_window_routing_equals_a_per_arrival_loop(routing, impaired):
    k, load, eff, rr, u, n = _routing_inputs(3 + impaired, impaired)
    t = torch.from_numpy
    e = t(eff) if impaired else None
    if routing == "jsq":
        got, want = fleet.jsq_destinations(t(load), n), _loop_jsq(load, n)
    elif routing == "random":
        got = fleet.random_destinations(t(u), t(k), e)
        want = _loop_random(u, k, eff if impaired else None)
    else:
        got = fleet.round_robin_destinations(t(rr), t(k), n, e)
        want = _loop_rr(rr, k, n, eff if impaired else None)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    if impaired and routing != "jsq":
        # never routed to an ineligible replica
        assert np.take_along_axis(eff, got.numpy(), 1).all()


# -- the fleet against the reference and the oracles ------------------------

@pytest.fixture(scope="module")
def fleet_runs():
    args, kw = _fleet_axes()
    got = fleet_sweep(FleetGrid.from_points(*args, **kw), **KW, **CPU)
    want = ref_sweep_mod.fleet_sweep(RefFleetGrid.from_points(*args, **kw),
                                     **KW)
    return got, want


@pytest.fixture(scope="module")
def single_server():
    """The port's sweep at LAM1: the k = 1 points' and the random
    split's single queue, with and without the timeout policy."""
    g = SweepGrid.from_points([LAM1, LAM1], ALPHA, TAU0, b_max=[0, 64],
                              wait_max=[0.0, 5.0], wait_target=[0, 32])
    return sweep(g, n_batches=6016, seed=5, **CPU)


def test_fleet_matches_the_reference_kernel(fleet_runs):
    """Point for point within 3σ of the two batch-means errors (1% floor)
    on E[W]; the batch and utilization within the reference tests'
    tolerances; no drops on either side."""
    got, want = fleet_runs
    assert int(got.buffer_dropped.sum()) == int(want.buffer_dropped.sum()) \
        == 0
    se = np.maximum(np.hypot(got.stderr, want.stderr),
                    0.01 * want.mean_latency)
    z = np.abs(got.mean_latency - want.mean_latency) / se
    assert np.all(z < 3.0), z
    np.testing.assert_allclose(got.mean_batch, want.mean_batch, rtol=0.05)
    np.testing.assert_allclose(got.utilization, want.utilization, atol=0.02)
    np.testing.assert_allclose(got.latency_p99, want.latency_p99, rtol=0.08)
    # the JSQ ladder as a ladder
    sl = slice(6, 6 + N_JSQ)
    a, b = got.mean_latency[sl], want.mean_latency[sl]
    assert abs(a.mean() - b.mean()) < 3.0 * _se(a, b, 0.005 * b.mean())


def test_k1_and_random_split_match_the_single_server_sweep(fleet_runs,
                                                           single_server):
    """k = 1 reduces to the single queue for every routing, and a random
    1/k split of Poisson(λ) is k independent queues at λ/k: the fleet's
    E[W] within 3σ of the port's sweep at LAM1 (the timeout point
    against the sweep's timeout point)."""
    got, _ = fleet_runs
    s = single_server
    for i, j in ((0, 0), (1, 0), (2, 0), (3, 0), (5, 1)):
        se = max(math.hypot(got.stderr[i], s.stderr[j]),
                 0.01 * s.mean_latency[j])
        assert abs(got.mean_latency[i] - s.mean_latency[j]) < 3.0 * se, i
        assert got.mean_batch[i] == pytest.approx(s.mean_batch[j],
                                                  rel=0.06), i
    m = solve(LAM1, V100)
    assert got.mean_latency[3] == pytest.approx(m.mean_latency, rel=0.04)


def test_jsq_matches_the_numpy_loop(fleet_runs):
    """Fleet JSQ against the per-event numpy loop (the port's copy of
    simulate_jsq_numpy), 3σ over the seed ladders."""
    got, _ = fleet_runs
    fl = got.mean_latency[6:6 + N_JSQ]
    legacy = np.array([replicas.simulate_jsq_numpy(
        4 * LAM1, V100, 4, n_jobs=40_000, seed=s) for s in range(3)])
    assert abs(fl.mean() - legacy.mean()) < 3.0 * _se(
        fl, legacy, 0.01 * legacy.mean())


def test_fleet_accounting_and_result_records(fleet_runs):
    got, want = fleet_runs
    grid = got.grid
    for i in range(len(grid)):
        assert int(got.jobs_by_replica[i].sum()) == int(got.n_jobs[i])
        assert np.all(got.jobs_by_replica[i, int(grid.k[i]):] == 0)
    bal = got.balance(4)                       # round-robin, k = 4
    assert bal.shape == (4,) and np.all(np.abs(bal - 0.25) < 0.05)
    p = got.point(3)
    assert (p.backend, p.k, p.routing) == ("fleet", 4, "random")
    p.check()
    # the records read alike: the reference's FleetResult built from
    # the port's fields gives the same points and balances
    kw = {f.name: getattr(got, f.name)
          for f in dataclasses.fields(RefFleetResult) if f.name != "grid"}
    twin = RefFleetResult(grid=RefFleetGrid.from_points(
        *_fleet_axes()[0], **_fleet_axes()[1]), **kw)
    for i in (0, 4, 8):
        assert dataclasses.asdict(got.point(i)) == dataclasses.asdict(
            twin.point(i))
        assert np.array_equal(got.balance(i), twin.balance(i))


@pytest.fixture(scope="module")
def ladders():
    """Both ladders in one dispatch: the loss copies (failure-free
    points of a failure grid, whose bits are the failure-free path's)
    then the failure copies."""
    g = _grids("bp")[0].concat(_grids("fail")[0])
    r = fleet_sweep(g, n_steps=8000, q_cap=64, a_cap=32, r_cap=64, seed=7,
                    **CPU)
    n = len(BP_CFG) * N_REPS
    return r, n


def _gate(kernel_vals, ref_vals, label):
    se = _se(kernel_vals, ref_vals, max(0.015 * abs(ref_vals.mean()), 0.004))
    assert abs(kernel_vals.mean() - ref_vals.mean()) < 3.0 * se, \
        (label, float(kernel_vals.mean()), float(ref_vals.mean()))


@pytest.mark.parametrize("ci", range(len(BP_CFG)))
def test_loss_ladder_matches_the_mirror(ladders, ci):
    r, _ = ladders
    route, ov, qm, dl, rr = BP_CFG[ci]
    sl = slice(ci * N_REPS, (ci + 1) * N_REPS)
    refs = [simulate_fleet_loss_numpy(
        BP_LAM, MODEL, BP_B, k=BP_K, routing=route, q_max=qm, deadline=dl,
        overflow=ov, retry_rate=rr, q_cap=64, r_cap=64, n_events=40_000,
        seed=s) for s in range(N_REF)]
    for f in LOSS_FIELDS:
        _gate(np.asarray(getattr(r, f)[sl], float),
              np.array([getattr(x, f) for x in refs]), (ci, f))


@pytest.mark.parametrize("ci", range(len(FAIL_CFG)))
def test_failure_ladder_matches_the_mirror(ladders, ci):
    r, n = ladders
    disc, route = FAIL_CFG[ci]
    sl = slice(n + ci * N_REPS, n + (ci + 1) * N_REPS)
    refs = [simulate_fleet_loss_numpy(
        FAIL_LAM, MODEL, FAIL_B, k=FAIL_K, routing=route, mtbf=FAIL_MTBF,
        mttr=FAIL_MTTR, fail_disc=disc, q_cap=64, r_cap=64,
        n_events=40_000, seed=s) for s in range(N_REF)]
    for f in FAIL_FIELDS:
        _gate(np.asarray(getattr(r, f)[sl], float),
              np.array([getattr(x, f) for x in refs]), (disc, route, f))


def test_loss_and_failure_accounting(ladders):
    """tests/test_backpressure.py's and tests/test_failures.py's exact
    laws: no capacity drops, offered = jobs + overflow + abandoned, the
    four fractions sum to 1, no truncated failure count, resume loses
    no work while restart and drop do, and only drop abandons."""
    r, n = ladders
    assert int(r.buffer_dropped.sum()) == 0
    assert np.array_equal(r.offered,
                          r.n_jobs + r.overflow_dropped + r.abandoned)
    total = r.goodput_frac + r.late_frac + r.reject_frac + r.abandon_frac
    assert np.allclose(total, 1.0, atol=1e-6)
    assert np.all(r.n_in_slo <= r.n_jobs)
    assert np.all(r.retry_inflation >= 1.0 - 1e-6)
    assert int(r.fail_truncated.sum()) == 0
    assert int(r.n_failures[:n].sum()) == 0
    sl = slice(n, None)
    n_failures, down, span = r.n_failures[sl], r.down_time[sl], r.span[sl]
    assert np.all(n_failures > 0) and np.all(down > 0.0)
    av = np.asarray(r.availability)[sl]
    assert np.all((av > 0.0) & (av < 1.0))
    assert np.allclose(av, 1.0 - down / (FAIL_K * span))
    lost = np.asarray(r.lost_work)[sl]
    assert np.all(lost[:N_REPS] == 0.0) and np.all(lost[N_REPS:] > 0.0)
    ab = r.abandoned[sl]
    assert int(ab[:2 * N_REPS].sum()) == 0 and np.all(ab[2 * N_REPS:] > 0)


# -- the bitwise contracts ----------------------------------------------------

SPLIT = {
    "base": (_split_axes, dict(n_steps=512, q_cap=64, a_cap=16)),
    "loss": (lambda: (([6.0, 5.0, 6.0, 4.0], MODEL.alpha, MODEL.tau0),
                      dict(k=[2, 2, 1, 2], b_max=BP_B,
                           routing=["jsq", "random", "round_robin", "jsq"],
                           q_max=[6, 0, 12, 0], deadline=[4.0, 1.8, 0.0,
                                                          0.0],
                           overflow=["reject", "drop", "drop", "reject"],
                           retry_rate=[0.5, 0.0, 0.5, 0.0])),
             dict(n_steps=512, a_cap=16)),
    "fail": (lambda: (([6.0, 6.0, 5.0, 6.0], MODEL.alpha, MODEL.tau0),
                      dict(k=[2, 2, 1, 2], b_max=FAIL_B,
                           routing=["jsq", "random", "round_robin", "jsq"],
                           fail_disc=["resume", "restart", "drop", "resume"],
                           mtbf=[8.0, 8.0, 8.0, 0.0],
                           mttr=[0.5, 0.5, 0.5, 0.0],
                           dist=["det", "gamma", "det", "exp"],
                           throttle=[1.0, 0.85, 1.0, 1.0])),
             dict(n_steps=512, a_cap=16)),
}
SPLIT_FIELDS = ("mean_latency", "mean_batch", "batch_m2", "utilization",
                "n_jobs", "n_batches", "hist", "jobs_by_replica", "stderr",
                "max_queue", "abandoned", "overflow_dropped", "n_retry")


@pytest.mark.parametrize("name", sorted(SPLIT))
def test_split_dispatch_is_bitwise(name):
    """A grid dispatched whole equals its chunks (``key_offset``, every
    grid-derived cap pinned from the full grid), bit for bit; a chunk
    whose caps are not pinned is refused."""
    axes, kw = SPLIT[name]
    args, gkw = axes()
    g = FleetGrid.from_points(*args, **gkw)
    kw = dict(kw, seed=13, **CPU)
    if "q_cap" not in kw:
        kw.update(fleet_caps(g))
    whole = fleet_sweep(g, **kw)
    a = fleet_sweep(g.take(slice(0, 2)), **kw)
    b = fleet_sweep(g.take(slice(2, None)), key_offset=2, **kw)
    fields = SPLIT_FIELDS + (("n_failures", "down_time", "lost_work",
                              "fail_truncated") if g.has_fail else ())
    for f in fields:
        got = np.concatenate([getattr(a, f), getattr(b, f)])
        if f == "jobs_by_replica":
            want = getattr(whole, f)[:, :got.shape[1]]
            assert np.all(getattr(whole, f)[:, got.shape[1]:] == 0)
        else:
            want = getattr(whole, f)
        assert np.array_equal(got, want, equal_nan=True), f
    kw.pop("q_cap")
    with pytest.raises(ValueError, match="fleet_caps"):
        fleet_sweep(g.take(slice(2, None)), key_offset=2, **kw)


NEUTRAL_FIELDS = ("mean_latency", "mean_batch", "batch_m2", "utilization",
                  "n_jobs", "n_batches", "hist", "latency_p50",
                  "latency_p99", "max_queue", "stderr", "jobs_by_replica",
                  "mean_service")


@pytest.mark.parametrize("regime", ["loss", "fail"])
def test_neutral_points_give_the_base_path_bits(regime):
    """The q_max = deadline = retry_rate = 0 points of a loss grid, and
    the mtbf = 0 points of a failure grid, give the loss-free /
    failure-free path's bits at pinned caps — for every routing."""
    if regime == "loss":
        extra = dict(q_max=[10, 0, 0, 0], deadline=[6.0, 0.0, 0.0, 0.0],
                     retry_rate=[0.5, 0.0, 0.0, 0.0])
    else:
        extra = dict(fail_disc=["drop", "resume", "resume", "resume"],
                     mtbf=[8.0, 0.0, 0.0, 0.0], mttr=[0.5, 0.0, 0.0, 0.0],
                     throttle=[0.85, 1.0, 1.0, 1.0])
    args = ([9.0, 5.0, 4.0, 5.5], MODEL.alpha, MODEL.tau0)
    gkw = dict(k=[2, 2, 3, 2], b_max=BP_B,
               routing=["jsq", "jsq", "random", "round_robin"])
    g = FleetGrid.from_points(*args, **gkw, **extra)
    assert g.has_loss and (g.has_fail == (regime == "fail"))
    kw = dict(n_steps=512, q_cap=64, a_cap=16, seed=11, **CPU)
    mixed = fleet_sweep(g, r_cap=32, f_cap=16, **kw)
    base = fleet_sweep(g.take(slice(1, None)), key_offset=1, **kw)
    assert not g.take(slice(1, None)).has_loss
    for f in NEUTRAL_FIELDS:
        assert np.array_equal(getattr(mixed, f)[1:], getattr(base, f),
                              equal_nan=True), f
    if regime == "fail":
        assert int(mixed.n_failures[0]) > 0
        assert int(mixed.n_failures[1:].sum()) == 0
        assert np.all(mixed.availability[1:] == 1.0)
    else:
        assert int(mixed.overflow_dropped[0] + mixed.abandoned[0]) > 0


def test_hist_every_thins_only_the_histogram():
    """hist_every = 4 bins 8 of each superstep's 32 steps: every mean and
    counter keeps its bits, the histogram holds a fraction of the jobs."""
    g = FleetGrid.from_points([3.0, 6.0, 9.0], ALPHA, TAU0, k=[1, 2, 4],
                              routing=["jsq", "random", "jsq"])
    kw = dict(n_steps=1024, q_cap=128, a_cap=32, seed=5, **CPU)
    full = fleet_sweep(g, **kw)
    thin = fleet_sweep(g, hist_every=4, **kw)
    for f in ("mean_latency", "mean_batch", "utilization", "n_jobs",
              "jobs_by_replica", "stderr", "max_queue"):
        assert np.array_equal(getattr(full, f), getattr(thin, f)), f
    assert np.array_equal(full.hist.sum(1), full.n_jobs)
    frac = thin.hist.sum(1) / full.hist.sum(1)
    assert np.all((frac > 0.15) & (frac < 0.35)), frac
    sk = fleet_sweep(g, hist_every=4, sketch=True, **kw)
    assert np.array_equal(sk.hist.sum(1), thin.hist.sum(1))
    assert np.array_equal(sk.mean_latency, full.mean_latency)


def test_b1_plain_on_a_captured_fleet_block_matches_the_reference(
        monkeypatch):
    """The replicas grid's block shape: b_max 0 (pop_cap = q_cap) thinned
    by hist_every 4 to 8 of 32 rows.  Superstep 5's block, captured as
    the fleet hands it to hist_update, binned by the port's plain
    version and by the reference's lax update: the same counts."""
    captured = []
    real = pt_ss.hist_update

    def spy(hists, lats, inc, **kw):
        if len(captured) == 4:
            captured.append((tuple(h.clone() for h in hists), lats.clone(),
                             inc.clone(), kw))
        else:
            captured.append(None)
        return real(hists, lats, inc, **kw)

    monkeypatch.setattr(pt_ss, "hist_update", spy)
    g = FleetGrid.from_points([6.0, 9.0, 12.0], ALPHA, TAU0, k=[2, 4, 4],
                              routing=["jsq", "round_robin", "jsq"])
    fleet_sweep(g, n_steps=256, q_cap=128, a_cap=32, hist_every=4, seed=3,
                **CPU)
    monkeypatch.setattr(pt_ss, "hist_update", real)
    hists, lats, inc, kw = captured[4]
    assert lats.shape == (3, 8, 128) and int(inc.sum()) > 0
    counts = hists[0].numpy().copy()     # the plain version adds in place
    got = pt_ss.hist_update_plain(hists, lats, inc, n_bins=kw["n_bins"])
    fn = jax.jit(jax.vmap(lambda h, l, i: ref_ss.hist_update(
        h, l, i, n_bins=512, backend="lax")))
    want = fn((jnp.asarray(counts),), jnp.asarray(lats.numpy()),
              jnp.asarray(inc.numpy()))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[0].sum() - counts.sum()) == int(inc.sum())
    # and the sketch mode's counts and sums on the same block
    sums = (np.random.default_rng(1).random(counts.shape) * 50).astype(
        np.float32)
    sk = pt_ss.hist_update_plain(
        convert.hist_state_from_arrays(counts[:, :64].copy(), sums[:, :64],
                                       device="cpu"),
        lats, inc, n_bins=64, sketch=True)
    fk = jax.jit(jax.vmap(lambda h, l, i: ref_ss.hist_update(
        h, l, i, n_bins=64, backend="lax", sketch=True)))
    wk = fk((jnp.asarray(counts[:, :64]), jnp.asarray(sums[:, :64])),
            jnp.asarray(lats.numpy()), jnp.asarray(inc.numpy()))
    assert np.array_equal(sk[0].numpy(), np.asarray(wk[0]))
    np.testing.assert_allclose(sk[1].numpy(), np.asarray(wk[1]), rtol=1e-6)


# -- evaluate, simulate_jsq and the guards -----------------------------------

def _message(err) -> str:
    return str(err.value).replace("repro_torch.", "repro.")


def test_evaluate_fleet_backend_promotes_and_guards_as_the_reference():
    g1 = SweepGrid.from_points([LAM1], ALPHA, TAU0)
    (res,) = evaluate(g1, backend="fleet", n_steps=2048, q_cap=128,
                      seed=3, **CPU)
    assert (res.backend, res.k, res.routing) == ("fleet", 1, "random")
    assert res.mean_latency == pytest.approx(solve(LAM1, V100).mean_latency,
                                             rel=0.06)
    cases = [(lambda m: m.from_points([1.0], 0.1, 1.0, k=4), b)
             for b in ("analytic", "markov", "sim", "sweep")]
    cases.append((lambda m: m.from_points([1.0], 0.1, 1.0, k=1), "sweep"))
    for make, backend in cases:
        with pytest.raises(ValueError) as want:
            ref_evaluate(make(RefFleetGrid), backend=backend)
        with pytest.raises(ValueError) as got:
            evaluate(make(FleetGrid), backend=backend)
        assert _message(got) == str(want.value)


def test_fleet_sweep_guards_as_the_reference(monkeypatch):
    cases = [
        (lambda m, s: s.from_points([1.0], [0.1], [1.0]), {}, TypeError),
        (lambda m, s: m.from_points([1.0], 0.1, 1.0, k=2),
         dict(q_cap=64, n_steps=64, warmup=64), ValueError),
        (lambda m, s: m.from_points([1.0], 0.1, 1.0, k=0), {}, ValueError),
        (lambda m, s: m.from_points([1.0], 0.1, 1.0, k=2, b_max=128),
         dict(q_cap=64), ValueError),
        (lambda m, s: m.from_points([1.0], 0.1, 1.0, k=2, routing=7),
         dict(q_cap=64), ValueError),
    ]
    for make, kw, exc in cases:
        with pytest.raises(exc) as want:
            ref_sweep_mod.fleet_sweep(make(RefFleetGrid, RefGrid), **kw)
        with pytest.raises(exc) as got:
            fleet_sweep(make(FleetGrid, SweepGrid), **kw, **CPU)
        assert _message(got) == str(want.value)
    g = FleetGrid.from_points([1.0], 0.1, 1.0, k=2)
    # the metrics tap (3e) raised here until it was ported
    from repro_torch.core.metrics import MetricsTap
    tap = MetricsTap(expected_points=1)
    a = fleet_sweep(g, n_steps=64, seed=3, **CPU)
    b = fleet_sweep(g, n_steps=64, seed=3, metrics_tap=tap, **CPU)
    assert np.array_equal(a.hist, b.hist) and tap.supersteps == 2
    # shard > 1 (3f) raised here too: on one device it now runs as one
    # shard, bitwise, as the reference's clamped shard=2 does
    c = fleet_sweep(g, n_steps=64, seed=3, shard=2, **CPU)
    assert np.array_equal(a.hist, c.hist)
    assert np.array_equal(a.mean_latency, c.mean_latency)
    rg = RefFleetGrid.from_points([1.0], 0.1, 1.0, k=2)
    r1, r2 = (ref_sweep_mod.fleet_sweep(rg, n_steps=64, seed=3, shard=n)
              for n in (1, 2))
    assert np.array_equal(np.asarray(r1.hist), np.asarray(r2.hist))
    with pytest.raises(ValueError, match="hist_every"):
        fleet_sweep(g, hist_every=0, **CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fleet_sweep(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate(g, backend="fleet")


def test_simulate_jsq_and_fleet_latency():
    """The replicas module's entry points run the port's fleet sweep:
    JSQ at k = 1 is the single queue."""
    ew = replicas.simulate_jsq(LAM1, V100, 1, n_jobs=12_000, seed=2, **CPU)
    assert ew == pytest.approx(solve(LAM1, V100).mean_latency, rel=0.05)
    with pytest.raises(ValueError, match="unknown backend"):
        replicas.simulate_jsq(LAM1, V100, 2, backend="nope", **CPU)
    assert replicas.simulate_jsq(LAM1, V100, 2, n_jobs=2_000, seed=1,
                                 backend="numpy") > 0.0
    ews = replicas.fleet_latency([LAM1, 2 * LAM1], V100, [1, 2],
                                 routing="round_robin", n_steps=1024,
                                 q_cap=128, **CPU)
    assert ews.shape == (2,) and np.all(np.isfinite(ews))


@pytest.mark.cuda
def test_fleet_on_the_card():
    """On the card: no drops, one hist_update launch per superstep, and
    the CUDA B1 bit for bit against its plain version on a fleet block."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode")
    g = FleetGrid.from_points([6.0, 9.0, 12.0], ALPHA, TAU0, k=[2, 4, 4],
                              routing=["jsq", "round_robin", "random"])
    before = pt_ss.hist_update.launches
    r = fleet_sweep(g, n_steps=512, q_cap=128, a_cap=32, hist_every=4,
                    seed=3, device="cuda")
    assert pt_ss.hist_update.launches == before + 512 // 32
    assert int(r.buffer_dropped.sum()) == 0
    rng = np.random.default_rng(0)
    lats = torch.from_numpy(rng.lognormal(1.0, 1.0, (33, 8, 128)).astype(
        np.float32)).cuda()
    inc = torch.from_numpy(rng.random((33, 8, 128)) < 0.1).cuda()
    a = (torch.zeros(33, 512, dtype=torch.int32, device="cuda"),)
    b = (torch.zeros(33, 512, dtype=torch.int32, device="cuda"),)
    pt_ss.hist_update(a, lats, inc, n_bins=512, backend="cuda")
    pt_ss.hist_update_plain(b, lats, inc, n_bins=512)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0])
