"""The port's token-level generate sweep (repro_torch.core.gen_sweep) on
the CPU: its grid and caps against the reference's, its results against
the reference JAX ``gen_sweep`` on one converted grid, against the
port's own exact numpy loops, and (static discipline) against the
port's request-level ``sweep`` at the equivalent law; and its own
bitwise contracts.

The two packages draw from different random streams, so agreement is
statistical: within 3 combined standard errors over seed ladders, with
the 1.5% floor of tests/test_gen_sweep.py.  Most points share one
module-scoped dispatch per package.
"""
import dataclasses
import importlib
import math

import numpy as np
import pytest
import torch

from repro.core.continuous_sim import GenServiceModel as RefModel
from repro.core.gen_sweep import gen_caps as ref_gen_caps
from repro.core.gen_sweep import gen_sweep as ref_gen_sweep
from repro.core.grid import GenGrid as RefGenGrid
from repro.core.analytic import LinearServiceModel
from repro.core.hist import thinned_rows as ref_thinned_rows
from repro.core.markov import solve
from repro.core.results import SimResult as RefSimResult
from repro_torch import convert
from repro_torch.core import (ContinuousResult, GenGrid, GenServiceModel,
                              SweepGrid, evaluate, gen_caps, gen_sweep,
                              simulate_continuous,
                              simulate_static_generate, sweep)
from repro_torch.core.continuous_sim import (
    simulate_continuous_numpy, simulate_static_generate_numpy)
from repro_torch.core.hist import SKETCH_BINS, thinned_rows
from repro_torch.core.results import SimResult
from repro_torch.kernels import superstep as pt_ss

# the module (``repro_torch.core.gen_sweep`` names the function too)
gen_mod = importlib.import_module("repro_torch.core.gen_sweep")

# the test workers run side by side: one intra-op thread each keeps
# torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

CONST = dict(alpha_decode=0.14, tau0_decode=1.9, alpha_prefill=0.035,
             tau0_prefill=1.9)
MODEL = GenServiceModel(**CONST)
GEN, PROMPT, CAP = 32, 128, 64
ALPHA_EQ = PROMPT * MODEL.alpha_prefill + GEN * MODEL.alpha_decode
TAU0_EQ = MODEL.tau0_prefill + GEN * MODEL.tau0_decode
LAM = 0.5 / ALPHA_EQ
N_REPS = 5
KW = dict(n_steps=8192, q_cap=256, a_cap=64, seed=11)
CPU = dict(device="cpu")
DISCS = ("continuous", "static")


def _ref_grid():
    """tests/test_gen_sweep.py's grid: ρ = 0.5 seed ladders of both
    disciplines, a low-load continuous and a mid-load static point."""
    lam = [LAM] * (2 * N_REPS) + [0.1 / ALPHA_EQ, 0.6 / ALPHA_EQ]
    disc = (["continuous"] * N_REPS + ["static"] * N_REPS
            + ["continuous", "static"])
    return RefGenGrid.from_points(
        lam, CONST["alpha_decode"], CONST["tau0_decode"],
        CONST["alpha_prefill"], CONST["tau0_prefill"], prompt_len=PROMPT,
        gen_tokens=GEN, max_active=CAP, discipline=disc)


def _converted(ref_grid):
    return convert.gen_grid_from_arrays(
        {f: getattr(ref_grid, f) for f in ref_grid.__dataclass_fields__})


@pytest.fixture(scope="module")
def pair():
    rg = _ref_grid()
    grid = _converted(rg)
    return grid, gen_sweep(grid, **KW, **CPU), ref_gen_sweep(rg, **KW)


def _ladder(disc):
    lo = 0 if disc == "continuous" else N_REPS
    return slice(lo, lo + N_REPS)


def _ladder_se(a, b, floor_frac=0.015):
    se = math.sqrt(np.var(a, ddof=1) / len(a) + np.var(b, ddof=1) / len(b))
    return max(se, floor_frac * float(np.mean(b)))


def test_converted_grid_is_the_reference_grid_bitwise():
    rg = RefGenGrid.from_rhos([0.2, 0.5, 0.8], RefModel(**CONST),
                              gen_tokens=(8, 32), max_actives=(4, 16),
                              disciplines=DISCS)
    g = _converted(rg)
    own = GenGrid.from_rhos([0.2, 0.5, 0.8], MODEL, gen_tokens=(8, 32),
                            max_actives=(4, 16), disciplines=DISCS)
    for f in rg.__dataclass_fields__:
        want = getattr(rg, f)
        for got in (getattr(g, f), getattr(own, f)):
            assert got.dtype == want.dtype, f
            assert np.array_equal(got, want), f
    for prop in ("rho", "equivalent_alpha", "equivalent_tau0"):
        assert np.array_equal(getattr(g, prop), getattr(rg, prop)), prop
    assert g.discipline_names == rg.discipline_names
    assert not g.has_loss and not g.has_fail


def _benchmark_grid(cls, model):
    """benchmarks/continuous.py's grid: 16 ρ × gen × cap × discipline,
    λ normalized by the cap-limited capacity."""
    lam, gens, caps, discs = [], [], [], []
    for rho in [round(r, 4) for r in np.linspace(0.15, 0.85, 16)]:
        for g in (8, 32, 64, 256):
            for c in (8, 16, 32, 64):
                for d in DISCS:
                    lam.append(rho * model.capped_capacity(PROMPT, g, c))
                    gens.append(g)
                    caps.append(c)
                    discs.append(d)
    return cls.from_points(lam, model.alpha_decode, model.tau0_decode,
                           model.alpha_prefill, model.tau0_prefill,
                           prompt_len=PROMPT, gen_tokens=gens,
                           max_active=caps, discipline=discs)


@pytest.mark.parametrize("which", ["test_grid", "benchmark_grid",
                                   "one_point", "pinned_q_cap"])
def test_gen_caps_equal_the_reference(which):
    if which == "benchmark_grid":
        rg = _benchmark_grid(RefGenGrid, RefModel(**CONST))
        assert np.array_equal(
            _benchmark_grid(GenGrid, MODEL).lam, rg.lam)
    elif which == "one_point":
        rg = RefGenGrid.from_points([0.02], 0.1, 1.0, 0.05, 2.0,
                                    max_active=3, gen_tokens=500)
    else:
        rg = _ref_grid()
    kw = dict(q_cap=512) if which == "pinned_q_cap" else {}
    want = ref_gen_caps(rg, **kw)
    got = gen_caps(_converted(rg), **kw)
    assert got == want
    assert all(type(v) is int for v in got.values())


@pytest.mark.parametrize("hist_every", [1, 2, 3, 16])
def test_thinned_rows_equal_the_reference(hist_every):
    got = thinned_rows(16, hist_every)
    want = ref_thinned_rows(16, hist_every)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("disc", DISCS)
def test_matches_reference_gen_sweep(pair, disc):
    _, pt, ref = pair
    assert int(pt.buffer_dropped.sum()) == 0
    assert int(ref.buffer_dropped.sum()) == 0
    ix = _ladder(disc)
    for i in range(ix.start, ix.stop):
        d = abs(pt.mean_latency[i] - ref.mean_latency[i])
        assert d <= 3.0 * np.hypot(pt.stderr[i], ref.stderr[i]), i
    for field in ("mean_latency", "utilization", "mean_batch"):
        a, b = getattr(pt, field)[ix], getattr(ref, field)[ix]
        assert abs(a.mean() - b.mean()) < 3.0 * _ladder_se(a, b), field


def test_single_points_match_reference(pair):
    _, pt, ref = pair
    for i in (2 * N_REPS, 2 * N_REPS + 1):
        d = abs(pt.mean_latency[i] - ref.mean_latency[i])
        assert d <= max(3.0 * np.hypot(pt.stderr[i], ref.stderr[i]),
                        0.015 * ref.mean_latency[i]), i
        assert pt.utilization[i] == pytest.approx(ref.utilization[i],
                                                  abs=0.02), i
        assert pt.mean_batch[i] == pytest.approx(ref.mean_batch[i],
                                                 rel=0.05), i


@pytest.mark.parametrize("disc", DISCS)
def test_matches_own_numpy_loops(pair, disc):
    _, pt, _ = pair
    if disc == "continuous":
        ref = [simulate_continuous_numpy(
            LAM, MODEL, prompt_len=PROMPT, gen_tokens=GEN, max_active=CAP,
            n_jobs=12_000, seed=s) for s in range(3)]
    else:
        ref = [simulate_static_generate_numpy(
            LAM, MODEL, prompt_len=PROMPT, gen_tokens=GEN, b_max=CAP,
            n_jobs=12_000, seed=s) for s in range(3)]
    ix = _ladder(disc)
    for field in ("mean_latency", "mean_batch"):
        a = getattr(pt, field)[ix]
        b = np.array([getattr(r, field) for r in ref])
        assert abs(a.mean() - b.mean()) < 3.0 * _ladder_se(a, b), field
    u = np.mean([r.utilization for r in ref])
    assert abs(pt.utilization[ix].mean() - u) < 0.015


def test_static_matches_port_sweep_at_equivalent_law(pair):
    """The static discipline is the paper's batch queue at α' =
    prompt·α_p + gen·α_d, τ0' = τ0_p + gen·τ0_d, b_max = max_active."""
    grid, pt, _ = pair
    idx = list(range(N_REPS, 2 * N_REPS)) + [2 * N_REPS + 1]
    sg = SweepGrid.from_points(grid.lam[idx], ALPHA_EQ, TAU0_EQ, b_max=CAP)
    r = sweep(sg, n_batches=4000, q_cap=256, seed=5, **CPU)
    assert int(r.buffer_dropped.sum()) == 0
    for j, i in enumerate(idx):
        tol = max(3.0 * np.hypot(pt.ci_halfwidth[i], r.ci_halfwidth[j]),
                  0.04 * r.mean_latency[j])
        assert abs(pt.mean_latency[i] - r.mean_latency[j]) <= tol, i


def test_static_matches_exact_chain(pair):
    """The static ladder and the mid-load static point against the
    exact truncated chain at the equivalent request-level law (the
    tolerances of tests/test_gen_sweep.py)."""
    grid, pt, _ = pair
    law = LinearServiceModel(ALPHA_EQ, TAU0_EQ)
    m = solve(LAM, law, b_max=CAP)
    ladder = pt.mean_latency[_ladder("static")]
    assert ladder.mean() == pytest.approx(m.mean_latency, rel=0.04)
    i = 2 * N_REPS + 1
    m = solve(float(grid.lam[i]), law, b_max=CAP)
    assert pt.mean_latency[i] == pytest.approx(m.mean_latency, rel=0.06)


def test_max_active_one_disciplines_bitwise():
    """With one slot the admission gate is the only difference between
    the disciplines: same seed, same point index ⇒ the same bits."""
    lam1 = 0.4 / (ALPHA_EQ + TAU0_EQ)
    res = {}
    for disc in DISCS:
        g = GenGrid.from_points([lam1], *CONST.values(), prompt_len=PROMPT,
                                gen_tokens=GEN, max_active=1,
                                discipline=disc)
        res[disc] = gen_sweep(g, n_steps=2048, q_cap=128, seed=3, **CPU)
    a, b = res["static"], res["continuous"]
    for f in ("mean_latency", "mean_batch", "utilization", "n_jobs",
              "hist", "stderr"):
        assert np.array_equal(getattr(a, f), getattr(b, f),
                              equal_nan=True), f
    assert a.n_jobs[0] > 100 and int(a.buffer_dropped[0]) == 0


def _fields(r):
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)
            if f.name != "grid" and getattr(r, f.name) is not None}


def _split_grid():
    return GenGrid.from_points(
        [LAM, 0.8 * LAM, LAM, 0.6 * LAM], *CONST.values(),
        prompt_len=PROMPT, gen_tokens=[8, 16, 8, 32],
        # the largest slot count is odd, so a thinned hist_every = 3
        # block holds 5 × 31 = 155 entries per point: not a multiple of
        # 16, and most points' mask rows start off a 16-byte boundary
        max_active=[15, 31, 15, 7],
        discipline=["continuous", "static", "static", "continuous"])


@pytest.mark.parametrize("extra", [{}, dict(sketch=True, hist_every=3)],
                         ids=["full", "sketch_thinned"])
def test_pinned_caps_split_is_bitwise_whole(extra):
    g = _split_grid()
    kw = dict(n_steps=2048, seed=13, **gen_caps(g), **extra, **CPU)
    full = gen_sweep(g, **kw)
    a = gen_sweep(g.take(slice(0, 2)), **kw)
    b = gen_sweep(g.take(slice(2, None)), key_offset=2, **kw)
    fa, fb = _fields(a), _fields(b)
    for name, whole in _fields(full).items():
        split = np.concatenate([fa[name], fb[name]])
        assert np.array_equal(whole, split, equal_nan=True), name


def test_unpinned_split_raises():
    g = _split_grid()
    with pytest.raises(ValueError, match="gen_caps"):
        gen_sweep(g.take(slice(2, None)), n_steps=2048, key_offset=2,
                  **CPU)


def test_sketch_and_thinned_histograms():
    """Sketch mode keeps 64 bins and their sums; hist_every = 3 bins
    only the thinned rows (s_cap = 31: 5 × 31 entries per point and
    superstep) and still runs without drops."""
    g = _split_grid()
    sk = gen_sweep(g, n_steps=2048, seed=2, sketch=True, **CPU)
    assert sk.hist.shape == (4, SKETCH_BINS)
    assert sk.hist_sums.shape == (4, SKETCH_BINS)
    assert np.array_equal(sk.hist.sum(1), sk.n_jobs)
    # the per-bin sums add back up to the jobs' total latency
    np.testing.assert_allclose(sk.hist_sums.sum(1),
                               sk.mean_latency * sk.n_jobs, rtol=1e-4)
    th = gen_sweep(g, n_steps=2048, seed=2, hist_every=3, **CPU)
    assert int(th.buffer_dropped.sum()) == 0
    assert np.all(th.hist.sum(1) < th.n_jobs)
    assert np.all(th.hist.sum(1) > 0.15 * th.n_jobs)
    assert np.isfinite(th.latency_p99).all()


def test_each_superstep_runs_both_kernels_once(monkeypatch):
    calls = []
    for name in ("hist_update", "fifo_compact"):
        orig = getattr(pt_ss, name)

        def counting(*a, _name=name, _orig=orig, **kw):
            calls.append((_name, kw["backend"]))
            return _orig(*a, **kw)
        monkeypatch.setattr(pt_ss, name, counting)
    g = _split_grid()
    r = gen_sweep(g, n_steps=100, seed=1, **CPU)
    n_super = 2048 // 16
    assert calls.count(("hist_update", "torch")) == n_super
    assert calls.count(("fifo_compact", "torch")) == n_super
    assert len(calls) == 2 * n_super
    assert np.array_equal(r.hist.sum(1), r.n_jobs)


def test_float_to_int_cast_saturates_like_xla():
    x = torch.tensor([math.inf, -math.inf, 1e30, -1e30, 5.0, -3.0, 2.0e7])
    got = gen_mod._to_i32(x).tolist()
    big = 2 ** 24
    assert got == [big, -big, big, -big, 5, -3, big]


def test_buffer_length_is_the_reference_sizing():
    # q_cap + min((a_cap + 2)·16, (s_cap + 1)·16) + a_cap + 1; 1,409 on
    # the benchmark grid (q_cap 256, a_cap 112, s_cap 64)
    assert gen_mod.buffer_length(256, 112, 64) == 1409
    assert gen_mod.buffer_length(256, 64, 128) == 256 + 66 * 16 + 65


def test_evaluate_gen_backend_fields_and_bits(pair):
    grid, pt, _ = pair
    res = evaluate(grid.take(slice(0, 2)), backend="gen", **KW, **CPU)
    names = [f.name for f in dataclasses.fields(RefSimResult)]
    assert [f.name for f in dataclasses.fields(SimResult)] == names
    assert [x.backend for x in res] == ["gen", "gen"]
    assert [x.discipline for x in res] == ["continuous", "continuous"]
    # the same points at the same global indices: the same bits
    assert res[0].mean_latency == pt.point(0).mean_latency
    assert pt.point(N_REPS).discipline == "static"
    for r in res:
        assert isinstance(r, SimResult)
        r.check()


def test_backends_guard_their_grids():
    g = GenGrid.from_points([0.05], 0.1, 1.0, 0.1, 1.0)
    for backend in ("analytic", "sweep", "markov", "sim", "fleet"):
        with pytest.raises(ValueError, match="GenGrid"):
            evaluate(g, backend=backend, **({} if backend == "analytic"
                                            else CPU))
    sg = SweepGrid.from_points([1.0], [0.1], [1.0])
    with pytest.raises(ValueError, match="needs a GenGrid"):
        evaluate(sg, backend="gen", **CPU)
    with pytest.raises(TypeError):
        gen_sweep(sg, **CPU)
    wide = GenGrid.from_points([0.05], 0.1, 1.0, 0.1, 1.0, max_active=512)
    with pytest.raises(ValueError, match="q_cap"):
        gen_sweep(wide, q_cap=256, **CPU)


@pytest.mark.parametrize("what", ["loss", "fail", "tap", "shard"])
def test_unported_features_raise(what):
    kw = dict(n_steps=64, **CPU)
    extra = {}
    if what == "loss":
        # loss grids run; one with failures still waits for 3d
        extra, match = dict(q_max=8, mtbf=50.0, mttr=1.0), "3d"
    elif what == "fail":
        extra, match = dict(mtbf=50.0, mttr=1.0), "3d"
    elif what == "tap":
        kw["metrics_tap"], match = object(), "3e"
    else:
        kw["shard"], match = 2, "3f"
    g = GenGrid.from_points([0.05], *CONST.values(), **extra)
    with pytest.raises(NotImplementedError, match=match):
        gen_sweep(g, **kw)


def test_simulate_wrappers_run_the_port_kernel():
    r = simulate_continuous(LAM, MODEL, prompt_len=PROMPT, gen_tokens=GEN,
                            max_active=CAP, n_jobs=600, seed=1, **CPU)
    assert isinstance(r, ContinuousResult)
    assert r.backend == "gen" and r.discipline == "continuous"
    assert r.mean_latency > 0 and r.n_jobs > 100
    s = simulate_static_generate(LAM, MODEL, prompt_len=PROMPT,
                                 gen_tokens=GEN, b_max=CAP, n_jobs=600,
                                 seed=1, **CPU)
    assert s.backend == "gen" and s.discipline == "static"
    n = simulate_continuous(LAM, MODEL, prompt_len=PROMPT, gen_tokens=GEN,
                            max_active=CAP, n_jobs=300, seed=1,
                            backend="numpy")
    assert n.backend == "sim"
    with pytest.raises(ValueError, match="finite b_max"):
        simulate_static_generate(LAM, MODEL, b_max=None, **CPU)
    with pytest.raises(ValueError):
        simulate_continuous(LAM, MODEL, backend="nope")
    # an overloaded point overflows the waiting room: the wrapper
    # refuses the biased result, as the reference's does
    with pytest.raises(RuntimeError, match="dropped"):
        simulate_continuous(5.0 * LAM, MODEL, prompt_len=PROMPT,
                            gen_tokens=GEN, max_active=4, n_jobs=200,
                            **CPU)


@pytest.mark.parametrize("entry", ["gen_sweep", "evaluate", "continuous",
                                   "static"])
def test_default_device_raises_without_gpu(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = GenGrid.from_points([0.05], *CONST.values())
    calls = {
        "gen_sweep": lambda: gen_sweep(g, n_steps=64),
        "evaluate": lambda: evaluate(g, backend="gen", n_steps=64),
        "continuous": lambda: simulate_continuous(0.05, MODEL, n_jobs=50),
        "static": lambda: simulate_static_generate(0.05, MODEL,
                                                   n_jobs=50),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


@pytest.mark.cuda
def test_gen_sweep_on_card_matches_numpy_loop():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode")
    g = GenGrid.from_points([LAM] * N_REPS, *CONST.values(),
                            prompt_len=PROMPT, gen_tokens=GEN,
                            max_active=CAP, discipline="continuous")
    before = (pt_ss.hist_update.launches, pt_ss.fifo_compact.launches)
    r = gen_sweep(g, **KW, device="cuda")
    assert pt_ss.hist_update.launches - before[0] == 8192 // 16
    assert pt_ss.fifo_compact.launches - before[1] == 8192 // 16
    assert int(r.buffer_dropped.sum()) == 0
    ref = np.array([simulate_continuous_numpy(
        LAM, MODEL, prompt_len=PROMPT, gen_tokens=GEN, max_active=CAP,
        n_jobs=12_000, seed=s).mean_latency for s in range(3)])
    assert abs(r.mean_latency.mean() - ref.mean()) < \
        3.0 * _ladder_se(r.mean_latency, ref)
