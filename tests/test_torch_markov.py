"""The port's host oracles against the reference package: its copies of
``markov`` (the failure chain included), the numpy paths of
``chain_solver``, ``simulate``, ``stochastic`` and ``planner``, and
``evaluate``'s ``"markov"`` and ``"sim"`` backends on base, loss and
failure grids, with the reference's guards.

Both sides run the same numpy code on the same inputs in one process,
so the results are equal, not merely close.  The reference's JAX grid
solver is left out (it is broken on this host, ROADMAP C-R1): the
port's float64 torch grid solver, ``grid_solve(method="torch")`` and
``solve_grid``'s default, runs here with ``device="cpu"`` and is held
against the numpy host loop at rel 1e-10 (abs 1e-12 on ``tail_mass``),
the bound of ``tests/test_chain_solver.py``.
"""
import dataclasses
import importlib
import math

import numpy as np
import pytest
import torch

from repro.core import chain_solver as ref_cs
from repro.core import markov as ref_markov
from repro.core import planner as ref_planner
from repro.core import stochastic as ref_stochastic
from repro.core.analytic import LinearServiceModel as RefModel
from repro.core.energy import LinearEnergyModel as RefEnergy
from repro.core.evaluate import evaluate as ref_evaluate
from repro.core.grid import MarkovGrid as RefMarkovGrid
from repro.core.grid import SweepGrid as RefGrid
from repro_torch.core import chain_solver as pt_cs
from repro_torch.core import evaluate
from repro_torch.core import markov as pt_markov
from repro_torch.core import planner as pt_planner
from repro_torch.core import stochastic as pt_stochastic
from repro_torch.core.analytic import LinearServiceModel
from repro_torch.core.energy import LinearEnergyModel
from repro_torch.core.grid import GenGrid, MarkovGrid, SweepGrid

# both packages re-export the function ``simulate`` under the module's
# name, so the modules are fetched by path
ref_simulate = importlib.import_module("repro.core.simulate")
pt_simulate = importlib.import_module("repro_torch.core.simulate")

MODEL, REF_MODEL = LinearServiceModel(0.05, 1.0), RefModel(0.05, 1.0)
V100, REF_V100 = (LinearServiceModel(0.1438, 1.8874),
                  RefModel(0.1438, 1.8874))


def _message(err) -> str:
    """An error's text with the port's module names read as the
    reference's (the copies name their own modules)."""
    return str(err.value).replace("repro_torch.", "repro.")


def _same(a, b) -> None:
    """Two results of the copies: every field equal (arrays element for
    element, NaN equal to NaN)."""
    da = a if isinstance(a, dict) else dataclasses.asdict(a)
    db = b if isinstance(b, dict) else dataclasses.asdict(b)
    assert da.keys() == db.keys()
    for k in da:
        x, y = da[k], db[k]
        if isinstance(x, (np.ndarray, float, np.floating)):
            assert np.array_equal(np.asarray(x), np.asarray(y),
                                  equal_nan=True), k
        else:
            assert x == y, k


# -- markov ---------------------------------------------------------------

SOLVE_CASES = {
    "inf_dense": dict(lam=3.0),
    "bmax_auto": dict(lam=3.0, b_max=8),
    "bmax_gth": dict(lam=4.0, b_max=8, method="gth"),
    "bmax_dense": dict(lam=4.0, b_max=8, method="dense"),
    "v100_trunc": dict(lam=4.0, b_max=16, truncation=512, model="v100"),
    "resume": dict(lam=3.0, b_max=8, mtbf=8.0, mttr=0.5,
                   fail_disc="resume"),
    "restart": dict(lam=3.0, b_max=8, mtbf=8.0, mttr=0.5,
                    fail_disc="restart"),
    "resume_long_mttr": dict(lam=1.2, b_max=8, mtbf=40.0, mttr=2.0,
                             fail_disc="resume", model="v100"),
}


@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_markov_solve_equals_the_reference(case):
    kw = dict(SOLVE_CASES[case])
    lam = kw.pop("lam")
    v100 = kw.pop("model", None) == "v100"
    got = pt_markov.solve(lam, V100 if v100 else MODEL, **kw)
    want = ref_markov.solve(lam, REF_V100 if v100 else REF_MODEL, **kw)
    _same(got, want)
    if "mtbf" in kw:
        assert 0.0 < got.availability < 1.0


@pytest.mark.parametrize("q_max", [4, 8, 16])
def test_markov_solve_loss_equals_the_reference(q_max):
    for method in ("auto", "gth", "dense"):
        _same(pt_markov.solve_loss(5.0, MODEL, b_max=4, q_max=q_max,
                                   method=method),
              ref_markov.solve_loss(5.0, REF_MODEL, b_max=4, q_max=q_max,
                                    method=method))


def test_markov_solve_batch_and_completion_moments_equal_the_reference():
    lams = [0.5, 1.5, 3.0, 4.5]
    for b_max in (4, math.inf):
        for a, b in zip(pt_markov.solve_batch(lams, MODEL, b_max=b_max),
                        ref_markov.solve_batch(lams, REF_MODEL,
                                               b_max=b_max)):
            _same(a, b)
    for s, mtbf, mttr in ((1.4, 8.0, 0.5), (3.0, 60.0, 12.0),
                          (1.4, 0.0, 0.0)):
        for restart in (False, True):
            assert pt_markov.completion_moments(
                s, mtbf, mttr, restart=restart) == \
                ref_markov.completion_moments(s, mtbf, mttr,
                                              restart=restart)
    assert np.array_equal(pt_markov.poisson_pmf_row(7.3, 40),
                          ref_markov.poisson_pmf_row(7.3, 40))


@pytest.mark.parametrize("kw", [
    dict(lam=6.0, b_max=8, mtbf=1.0, mttr=2.0, fail_disc="restart"),
    dict(lam=2.0, b_max=8, mtbf=8.0, mttr=0.5, fail_disc="drop"),
    dict(lam=2.0, mtbf=8.0, mttr=0.5),
], ids=["rho_eff", "drop", "inf_b_max"])
def test_markov_failure_guards_raise_as_the_reference(kw):
    kw = dict(kw)
    lam = kw.pop("lam")
    with pytest.raises(ValueError) as want:
        ref_markov.solve(lam, REF_MODEL, **kw)
    with pytest.raises(ValueError) as got:
        pt_markov.solve(lam, MODEL, **kw)
    assert _message(got) == str(want.value)


GRID_FIELDS = ("mean_latency", "mean_batch", "utilization", "batch_m2",
               "mean_queue")


def _close_to_numpy(got, want) -> None:
    """The torch grid solver against the numpy host loop: rel 1e-10 on
    the metrics, abs 1e-12 on the truncation witness."""
    get = (lambda r, f: r[f]) if isinstance(got, dict) else getattr
    for f in GRID_FIELDS:
        a, b = np.asarray(get(got, f)), np.asarray(get(want, f))
        assert np.max(np.abs(a - b) / np.abs(b)) <= 1e-10, f
    assert np.max(np.abs(np.asarray(get(got, "tail_mass"))
                         - np.asarray(get(want, "tail_mass")))) <= 1e-12


def test_solve_grid_numpy_equals_the_reference_and_torch_raises_6b(
        monkeypatch):
    """The numpy method equals the reference's; the default method, the
    torch grid solver (it raised, naming ROADMAP item 6b, until that
    landed), agrees with it and picks the same truncation; it runs on
    CUDA unless asked for the CPU."""
    axes = ([0.2, 0.6, 0.9], 0.1438, 1.8874)
    g = MarkovGrid.from_fracs(*axes, b_maxes=[2, 8, 32])
    rg = RefMarkovGrid.from_fracs(*axes, b_maxes=[2, 8, 32])
    got = pt_markov.solve_grid(g, method="numpy")
    want = ref_markov.solve_grid(rg, method="numpy")
    assert got.truncation == want.truncation and got.method == "numpy"
    for f in ("mean_latency", "mean_batch", "batch_m2", "utilization",
              "mean_queue", "pi0", "tail_mass"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    for a, b in zip(got.to_results(), want.to_results()):
        _same(a, b)
    card = pt_markov.solve_grid(g, device="cpu")
    assert card.method == "torch" and card.truncation == got.truncation
    _close_to_numpy(card, got)
    with pytest.raises(ValueError, match="unknown grid method"):
        pt_markov.solve_grid(g, method="jax")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_markov.solve_grid(g)


# -- chain_solver's numpy paths --------------------------------------------

@pytest.mark.parametrize("lam,b_max,K", [(3.0, 8, 256), (6.0, 8, 512),
                                         (0.9, 2, 128)])
def test_chain_solver_numpy_paths_equal_the_reference(lam, b_max, K):
    ch = pt_cs.build_chain(lam, MODEL, b_max, K)
    rch = ref_cs.build_chain(lam, REF_MODEL, b_max, K)
    _same(dataclasses.asdict(ch), dataclasses.asdict(rch))
    for fn in ("solve_pi_gth", "solve_pi_banded"):
        assert np.array_equal(getattr(pt_cs, fn)(ch),
                              getattr(ref_cs, fn)(rch)), fn
    for method in ("band", "gth"):
        pi = pt_cs.solve_pi(ch, method=method)
        assert np.array_equal(pi, ref_cs.solve_pi(rch, method=method))
        _same(pt_cs.chain_metrics(lam, pi, ch.t_of, ch.b_of),
              ref_cs.chain_metrics(lam, pi, rch.t_of, rch.b_of))
    # the truncation as the waiting room (markov.solve_loss's use)
    pi = pt_cs.solve_pi(ch)
    _same(pt_cs.chain_loss_metrics(lam, pi, ch.t_of, ch.b_of, K),
          ref_cs.chain_loss_metrics(lam, pi, rch.t_of, rch.b_of, K))
    args = ([lam, 0.5 * lam], [0.05, 0.05], [1.0, 1.0], [b_max, b_max], K)
    want = pt_cs.grid_solve(*args, method="numpy")
    _same(want, ref_cs.grid_solve(*args, method="numpy"))
    # the default method, the torch grid solver (it raised until ROADMAP
    # item 6b landed), on the same cells
    _close_to_numpy(pt_cs.grid_solve(*args, device="cpu"), want)


# -- the torch grid solver (grid_solve(method="torch")) ----------------------

# tests/test_chain_solver.py's grids: (fracs, b_maxes, truncation; 0 is
# the adaptive K)
TORCH_GRIDS = {
    "three_way": ([0.3, 0.7, 0.9], [2, 8, 32], 512),
    "low_load_wide_bmax": ([0.1, 0.2], [128], 512),
    "evaluate_backend": ([0.4, 0.8], [4, 16], 0),
    "adaptive": ([0.5, 0.95], [8, 64], 0),
}


@pytest.mark.parametrize("name", sorted(TORCH_GRIDS))
def test_torch_grid_solver_matches_numpy(name):
    """The batched float64 recursion against the banded host solver on
    the reference's own test grids, at K 512 and at the adaptive K —
    which both methods must pick alike."""
    fracs, b_maxes, K = TORCH_GRIDS[name]
    g = MarkovGrid.from_fracs(fracs, V100.alpha, V100.tau0, b_maxes=b_maxes)
    got = pt_markov.solve_grid(g, truncation=K, device="cpu")
    want = pt_markov.solve_grid(g, truncation=K, method="numpy")
    assert got.truncation == want.truncation
    if not K:
        assert float(got.tail_mass.max()) <= 1e-10
    _close_to_numpy(got, want)
    for f in ("mean_latency", "mean_batch", "utilization"):
        assert getattr(got, f).dtype == np.float64


def test_torch_grid_solver_is_chunk_invariant():
    """A cell's result does not depend on its chunk: every
    cells_per_dispatch gives the same bits (fixed-order sums), and a
    cell solved alone gives them too."""
    g = MarkovGrid.from_fracs([0.2, 0.55, 0.9], V100.alpha, V100.tau0,
                              b_maxes=[1, 4, 16, 64])
    args = (g.lam, g.alpha, g.tau0, g.b_max, 512)
    runs = [pt_cs.grid_solve(*args, cells_per_dispatch=c, device="cpu")
            for c in (64, 5, 1)]
    for r in runs[1:]:
        for f, v in r.items():
            assert np.array_equal(v, runs[0][f]), f
    alone = pt_cs.grid_solve(g.lam[7:8], g.alpha[7:8], g.tau0[7:8],
                             g.b_max[7:8], 512, device="cpu")
    # a grid of one cell has its own (V, D); the metrics still agree
    for f in GRID_FIELDS:
        assert alone[f][0] == pytest.approx(runs[0][f][7], rel=1e-12), f


def test_torch_grid_solver_guards_as_the_reference():
    """The domain guard and the finite-b_max guard, with the reference's
    messages, before any work on the device."""
    lam = 2.0 * 256 / (V100.alpha * 256 + V100.tau0)
    args = ([lam], [V100.alpha], [V100.tau0], [256], 256)
    with pytest.raises(ValueError) as want:
        ref_cs.grid_solve(*args, method="numpy")
    with pytest.raises(ValueError) as got:
        pt_cs.grid_solve(*args, device="cpu")
    assert "domain" in str(got.value) and _message(got) == str(want.value)
    bad = ([1.0], [V100.alpha], [V100.tau0], [0], 256)
    with pytest.raises(ValueError) as want:
        ref_cs.grid_solve(*bad, method="numpy")
    with pytest.raises(ValueError) as got:
        pt_cs.grid_solve(*bad, device="cpu")
    assert _message(got) == str(want.value)


def test_torch_grid_solver_keeps_float64_under_a_float32_default():
    """Every operation is float64 whatever torch's default dtype: the
    answers match the host loop at 1e-10 with float32 as the default."""
    g = MarkovGrid.from_fracs([0.6, 0.9], V100.alpha, V100.tau0,
                              b_maxes=[8, 32])
    assert torch.get_default_dtype() == torch.float32
    got = pt_cs.grid_solve(g.lam, g.alpha, g.tau0, g.b_max, 512,
                           device="cpu")
    want = pt_cs.grid_solve(g.lam, g.alpha, g.tau0, g.b_max, 512,
                            method="numpy")
    _close_to_numpy(got, want)


# -- simulate, stochastic, planner -------------------------------------------

@pytest.mark.parametrize("dist,b_max", [("det", math.inf), ("det", 8),
                                        ("exp", 16), ("gamma", math.inf)])
def test_simulate_equals_the_reference(dist, b_max):
    kw = dict(n_jobs=20_000, b_max=b_max, dist=dist, cv=0.7, seed=3,
              keep_latencies=True)
    _same(pt_simulate.simulate(3.0, MODEL, **kw),
          ref_simulate.simulate(3.0, REF_MODEL, **kw))


def test_stochastic_and_planner_equal_the_reference():
    for dist in ("det", "exp", "gamma"):
        for b in (1, 8):
            p = pt_stochastic.a_pmf(3.0, b, MODEL, 60, dist=dist, cv=0.7,
                                    n_quad=64)
            assert np.array_equal(p, ref_stochastic.a_pmf(
                3.0, b, REF_MODEL, 60, dist=dist, cv=0.7, n_quad=64))
    lo = pt_stochastic.a_pmf(2.0, 4, MODEL, 60)
    hi = pt_stochastic.a_pmf(3.0, 4, MODEL, 60)
    assert np.array_equal(pt_stochastic.survival(hi),
                          ref_stochastic.survival(hi))
    assert pt_stochastic.st_leq(lo, hi) == ref_stochastic.st_leq(lo, hi)
    assert pt_stochastic.st_leq(lo, hi) and not pt_stochastic.st_leq(hi, lo)
    pl = pt_planner.Planner(V100, LinearEnergyModel(beta=0.8, c0=12.0))
    rpl = ref_planner.Planner(REF_V100, RefEnergy(beta=0.8, c0=12.0))
    for lam in (0.5, 3.0, 6.5):
        _same(pl.operating_point(lam), rpl.operating_point(lam))
    for slo in (3.0, 10.0, 50.0):
        assert pl.max_rate_for_slo(slo) == rpl.max_rate_for_slo(slo)
    assert pl.min_latency() == rpl.min_latency()
    with pytest.raises(ValueError, match="unstable"):
        pl.operating_point(10.0)


# -- evaluate's "markov" and "sim" backends ----------------------------------

GRIDS = {
    "base": (([1.0, 3.0, 5.0], 0.05, 1.0), dict(b_max=[0, 8, 16])),
    "loss": (([4.0, 6.0, 7.0], 0.05, 1.0),
             dict(b_max=8, q_max=[0, 8, 16], overflow="reject")),
    "fail": (([2.0, 3.0, 3.0], 0.05, 1.0),
             dict(b_max=8, mtbf=[0.0, 8.0, 8.0], mttr=[0.0, 0.5, 0.5],
                  fail_disc=["resume", "resume", "restart"])),
}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_evaluate_markov_equals_the_reference(name):
    args, kw = GRIDS[name]
    got = evaluate(SweepGrid.from_points(*args, **kw), backend="markov")
    want = ref_evaluate(RefGrid.from_points(*args, **kw), backend="markov")
    assert len(got) == len(want) == len(args[0])
    for a, b in zip(got, want):
        assert a.backend == "markov"
        _same(a, b)


def test_evaluate_sim_equals_the_reference():
    args = ([1.0, 3.0], 0.05, 1.0)
    kw = dict(b_max=[0, 8], dist=["det", "gamma"], cv=0.7)
    run = dict(n_jobs=20_000, seed=5)
    got = evaluate(SweepGrid.from_points(*args, **kw), backend="sim", **run)
    want = ref_evaluate(RefGrid.from_points(*args, **kw), backend="sim",
                        **run)
    for a, b in zip(got, want):
        assert a.backend == "sim"
        _same(a, b)


GUARDS = [
    ("sim", dict(wait_max=2.0, wait_target=4)),
    ("sim", dict(q_max=8)),
    ("sim", dict(mtbf=8.0, mttr=0.5)),
    ("markov", dict(dist="gamma")),
    ("markov", dict(wait_max=2.0, wait_target=4)),
    ("markov", dict(q_max=8, deadline=3.0)),
    ("markov", dict(retry_rate=0.5)),
    ("markov", dict(q_max=8, overflow="drop")),
    ("markov", dict(mtbf=8.0, mttr=0.5, q_max=8)),
    ("markov", dict(mtbf=8.0, mttr=0.5, throttle=0.85)),
    ("analytic", dict(mtbf=8.0, mttr=0.5)),
]


@pytest.mark.parametrize("backend,kw", GUARDS,
                         ids=[f"{b}-{'-'.join(k)}" for b, k in GUARDS])
def test_evaluate_guards_raise_as_the_reference(backend, kw):
    with pytest.raises(ValueError) as want:
        ref_evaluate(RefGrid.from_points([2.0], 0.05, 1.0, b_max=8, **kw),
                     backend=backend)
    with pytest.raises(ValueError) as got:
        evaluate(SweepGrid.from_points([2.0], 0.05, 1.0, b_max=8, **kw),
                 backend=backend)
    assert _message(got) == str(want.value)


def test_evaluate_markov_grid():
    axes = ([0.3, 0.8], 0.1438, 1.8874)
    g, rg = (MarkovGrid.from_fracs(*axes, b_maxes=[4, 8]),
             RefMarkovGrid.from_fracs(*axes, b_maxes=[4, 8]))
    for a, b in zip(evaluate(g, backend="markov", method="numpy"),
                    ref_evaluate(rg, backend="markov", method="numpy")):
        _same(a, b)
    # the default is the torch grid solver (it raised until ROADMAP
    # item 6b landed), here on the CPU
    for a, b in zip(evaluate(g, backend="markov", device="cpu"),
                    evaluate(g, backend="markov", method="numpy")):
        assert a.backend == "markov"
        for f in ("mean_latency", "mean_batch", "utilization"):
            assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-10)
    for backend in ("sim", "sweep", "analytic"):
        with pytest.raises(ValueError, match="MarkovGrid"):
            evaluate(g, backend=backend)
    gg = GenGrid.from_points([0.05], 0.1, 1.0, 0.1, 1.0)
    for backend in ("markov", "sim"):
        with pytest.raises(ValueError, match="GenGrid"):
            evaluate(gg, backend=backend)
