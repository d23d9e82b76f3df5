"""The port's single-server sweep (repro_torch.core.sweep) on the CPU:
against the exact chain, against the reference JAX sweep on one
converted grid, against the paper's bounds, and its own bitwise
split-dispatch contract.

The two packages draw from different random streams, so agreement is
statistical: within 4% of the exact chain (as tests/test_sweep.py holds
the reference), and within 3 combined standard errors of the reference
sweep.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import analytic as ref_an
from repro.core.evaluate import evaluate as ref_evaluate
from repro.core.grid import SweepGrid as RefGrid
from repro.core.markov import solve
from repro.core.results import SimResult as RefSimResult
from repro.core.sweep import sweep as ref_sweep
from repro_torch import convert
from repro_torch.core import analytic as an
from repro_torch.core import evaluate, sweep, sweep_caps
from repro_torch.core.grid import SweepGrid
from repro_torch.core.results import SimResult
from repro_torch.kernels import superstep as pt_ss

# the test workers run side by side: one intra-op thread each keeps
# torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

V100 = ref_an.LinearServiceModel(alpha=0.1438, tau0=1.8874)
RHOS = [0.2, 0.5, 0.8]
CPU = dict(device="cpu")


def _converted(ref_grid):
    return convert.grid_from_arrays(
        {f: getattr(ref_grid, f) for f in ref_grid.__dataclass_fields__})


@pytest.fixture(scope="module")
def base_result():
    grid = SweepGrid.from_rhos(RHOS, V100.alpha, V100.tau0)
    return grid, sweep(grid, n_batches=4000, q_cap=1024, seed=7, **CPU)


def test_matches_markov_exact(base_result):
    _, r = base_result
    assert int(r.buffer_dropped.sum()) == 0
    for i, rho in enumerate(RHOS):
        m = solve(rho / V100.alpha, V100)
        assert r.mean_latency[i] == pytest.approx(m.mean_latency, rel=0.04)
        assert r.mean_batch[i] == pytest.approx(m.mean_batch, rel=0.04)
        assert r.batch_m2[i] == pytest.approx(m.batch_m2, rel=0.15)
        assert r.utilization[i] == pytest.approx(m.utilization, abs=0.02)


# one grid for both packages: det / gamma / exp service and two
# TimeoutBatch points, all stable at moderate load
_MIXED = dict(
    lam=[0.5 / V100.alpha, 0.5 / V100.alpha, 0.4 / V100.alpha,
         0.3 / V100.alpha, 0.3 / V100.alpha, 0.4 / V100.alpha],
    b_max=[0, 0, 0, 0, 64, 16],
    dist=["det", "gamma", "exp", "gamma", "det", "gamma"],
    cv=[0.5, 0.5, 0.5, 1.5, 0.5, 0.7],
    wait_max=[0.0, 0.0, 0.0, 0.0, 5.0, 2.0],
    wait_target=[0, 0, 0, 0, 32, 8])
_TIMEOUT = [4, 5]


@pytest.fixture(scope="module")
def mixed_pair():
    rg = RefGrid.from_points(_MIXED["lam"], V100.alpha, V100.tau0,
                             **{k: v for k, v in _MIXED.items()
                                if k != "lam"})
    kw = dict(n_batches=6000, q_cap=1024, seed=11)
    return rg, sweep(_converted(rg), **kw, **CPU), ref_sweep(rg, **kw)


@pytest.mark.parametrize("group", ["service_families", "timeout"])
def test_matches_reference_sweep(mixed_pair, group):
    _, pt, ref = mixed_pair
    idx = _TIMEOUT if group == "timeout" else \
        [i for i in range(len(pt)) if i not in _TIMEOUT]
    assert int(pt.buffer_dropped.sum()) == 0
    for i in idx:
        d = abs(pt.mean_latency[i] - ref.mean_latency[i])
        assert d <= 3.0 * np.hypot(pt.stderr[i], ref.stderr[i]), i
        assert pt.mean_batch[i] == pytest.approx(ref.mean_batch[i],
                                                 rel=0.05), i
        assert pt.utilization[i] == pytest.approx(ref.utilization[i],
                                                  abs=0.02), i
        assert pt.latency_p50[i] == pytest.approx(ref.latency_p50[i],
                                                  rel=0.08), i


def test_timeout_delay_hurts(mixed_pair):
    """Delaying for batch accumulation raises mean latency over the
    batch-all-waiting point at the same load (ρ = 0.3, det)."""
    grid, pt, _ = mixed_pair
    plain = SweepGrid.from_points([grid.lam[4]], V100.alpha, V100.tau0)
    r = sweep(plain, n_batches=2000, q_cap=1024, seed=19, **CPU)
    assert pt.mean_latency[4] > r.mean_latency[0] * 1.2


@pytest.fixture(scope="module")
def bounds_result():
    grid = SweepGrid.from_product([1.0, 2.0, 3.0], [0.1438, 0.25],
                                  [0.75, 1.8874])
    return grid, sweep(grid, n_batches=4000, q_cap=1024, seed=13, **CPU)


def test_theorem2_det_infinite_bmax(bounds_result):
    grid, r = bounds_result
    assert int(r.buffer_dropped.sum()) == 0
    bounds = an.phi(grid.lam, grid.alpha, grid.tau0)
    # the bound is tight at moderate/high load: allow MC noise up
    assert np.all(r.mean_latency <= bounds * 1.05)


def test_remark5_mean_batch_lower_bound(bounds_result):
    grid, r = bounds_result
    lbs = an.mean_batch_lower(grid.lam, grid.alpha, grid.tau0)
    assert np.all(r.mean_batch >= lbs * 0.93)
    assert np.all(r.mean_batch >= 1.0)


def test_service_variability_ordering():
    """Example 1 families: E[W] det < gamma(cv=.5) < exp."""
    lam = 0.5 / V100.alpha
    g = SweepGrid.from_product([lam], [V100.alpha], [V100.tau0],
                               dists=("det", "gamma", "exp"), cvs=(0.5,))
    r = sweep(g, n_batches=8000, q_cap=1024, seed=11, **CPU)
    det, gam, exp_ = r.mean_latency
    assert det < gam < exp_


def _fields(r):
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)
            if f.name != "grid" and getattr(r, f.name) is not None}


@pytest.mark.parametrize("case", ["det_capped", "mixed_sketch"])
def test_pinned_caps_split_is_bitwise_whole(case):
    if case == "det_capped":
        g = SweepGrid.from_product([1.0, 2.0, 3.0], [V100.alpha],
                                   [V100.tau0], b_maxes=(8,))
        extra = {}
    else:
        g = SweepGrid.from_points(
            [2.0, 3.0, 1.5, 2.5], V100.alpha, V100.tau0,
            b_max=[0, 16, 0, 32], dist=["gamma", "exp", "det", "gamma"],
            cv=[0.5, 0.5, 0.5, 1.3], wait_max=[0.0, 2.0, 0.0, 1.0],
            wait_target=[0, 8, 0, 4])
        extra = dict(sketch=True)
    caps = sweep_caps(g)
    kw = dict(n_batches=256, seed=11, **caps, **extra, **CPU)
    full = sweep(g, **kw)
    a = sweep(g.take(slice(0, 2)), **kw)
    b = sweep(g.take(slice(2, None)), key_offset=2, **kw)
    fa, fb = _fields(a), _fields(b)
    for name, whole in _fields(full).items():
        split = np.concatenate([fa[name], fb[name]])
        assert np.array_equal(whole, split, equal_nan=True), name


def test_unpinned_split_raises():
    g = SweepGrid.from_product([1.0, 2.0], [V100.alpha], [V100.tau0],
                               b_maxes=(8,))
    with pytest.raises(ValueError, match="sweep_caps"):
        sweep(g.take(slice(1, None)), n_batches=64, key_offset=1, **CPU)
    with pytest.raises(ValueError, match="a_cap"):
        sweep(g.take(slice(1, None)), n_batches=64, key_offset=1,
              q_cap=sweep_caps(g)["q_cap"], **CPU)


def test_evaluate_returns_simresults_with_reference_fields():
    grid = SweepGrid.from_rhos([0.3, 0.6], V100.alpha, V100.tau0)
    res = evaluate(grid, backend="sweep", n_batches=512, seed=3, **CPU)
    names = [f.name for f in dataclasses.fields(RefSimResult)]
    assert [f.name for f in dataclasses.fields(SimResult)] == names
    for r in res:
        assert isinstance(r, SimResult) and r.backend == "sweep"
        assert r.n_jobs > 0 and np.isfinite(r.ci_halfwidth)
        r.check()
    ref_grid = RefGrid.from_rhos([0.3, 0.6], V100.alpha, V100.tau0)
    pt_an = evaluate(grid, backend="analytic")
    for a, b in zip(pt_an, ref_evaluate(ref_grid, backend="analytic")):
        assert dataclasses.asdict(a).keys() == dataclasses.asdict(b).keys()
        assert (a.mean_latency, a.mean_batch, a.utilization) == \
            (b.mean_latency, b.mean_batch, b.utilization)


def test_sweep_runs_the_superstep_update_once_per_block(monkeypatch):
    calls = []
    orig = pt_ss.hist_update

    def counting(*a, **kw):
        calls.append(kw["backend"])
        return orig(*a, **kw)
    monkeypatch.setattr(pt_ss, "hist_update", counting)
    g = SweepGrid.from_rhos([0.4], V100.alpha, V100.tau0)
    r = sweep(g, n_batches=100, q_cap=256, seed=1, **CPU)
    assert len(calls) == 128 // 32 and set(calls) == {"torch"}
    assert int(r.hist.sum()) == int(r.n_jobs[0])


@pytest.mark.parametrize("what", ["loss", "fail", "tap", "shard",
                                  "markov"])
def test_unported_features_raise(what):
    """Failure grids, with and without a loss regime, the "markov"
    backend, the metrics tap (3e) and ``shard`` > 1 (3f) raised here
    until they were ported; their cases now hold what runs: the failure
    grid's accounting, the exact chain's answer equal to the
    reference's, a tapped run bitwise equal to an untapped one, and
    ``shard=2`` on one device bitwise equal to ``shard=1``, as in the
    reference, whose ``resolve_shards`` clamps to the visible devices."""
    g = SweepGrid.from_rhos([0.5], V100.alpha, V100.tau0)
    kw = dict(n_batches=64, **CPU)
    if what in ("loss", "fail"):
        extra = dict(q_maxes=(8,)) if what == "loss" else {}
        g = SweepGrid.from_rhos([0.5], V100.alpha, V100.tau0,
                                mtbfs=(50.0,), mttrs=(1.0,), **extra)
        assert g.has_fail and g.has_loss == (what == "loss")
        r = sweep(g, n_batches=512, seed=3, **CPU)
        assert int(r.buffer_dropped.sum()) == 0
        assert int(r.fail_truncated.sum()) == 0
        assert int(r.n_failures[0]) > 0 and float(r.lost_work[0]) == 0.0
        assert 0.0 < float(r.availability[0]) < 1.0
        total = r.goodput_frac + r.late_frac + r.reject_frac + r.abandon_frac
        assert np.allclose(total, 1.0, atol=1e-6)
        return
    if what == "markov":
        (x,) = evaluate(g, backend="markov")
        (y,) = ref_evaluate(RefGrid.from_rhos([0.5], V100.alpha,
                                              V100.tau0), backend="markov")
        assert isinstance(x, SimResult) and x.backend == "markov"
        assert (x.mean_latency, x.mean_batch, x.utilization) == \
            (y.mean_latency, y.mean_batch, y.utilization)
        return
    if what == "tap":
        # ported since: the tap observes and changes no bit
        from repro_torch.core.metrics import MetricsTap
        tap = MetricsTap(expected_points=len(g))
        a, b = sweep(g, seed=3, **kw), sweep(g, seed=3, metrics_tap=tap,
                                             **kw)
        assert np.array_equal(a.hist, b.hist)
        assert np.array_equal(a.mean_latency, b.mean_latency)
        assert tap.supersteps == 2
        return
    one, two = sweep(g, seed=3, shard=1, **kw), sweep(g, seed=3, shard=2,
                                                      **kw)
    for f in ("hist", "mean_latency", "mean_batch", "n_jobs"):
        assert np.array_equal(getattr(one, f), getattr(two, f)), f
    rg = RefGrid.from_rhos([0.5], V100.alpha, V100.tau0)
    r1, r2 = (ref_sweep(rg, n_batches=64, seed=3, shard=n) for n in (1, 2))
    assert np.array_equal(np.asarray(r1.hist), np.asarray(r2.hist))
    assert np.array_equal(np.asarray(r1.mean_latency),
                          np.asarray(r2.mean_latency))


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = SweepGrid.from_rhos([0.5], V100.alpha, V100.tau0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep(g, n_batches=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate(g, backend="sweep", n_batches=64)
