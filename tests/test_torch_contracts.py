"""The sketch and confidence-interval contracts (ROADMAP A3b), held
against the port's own sweeps.

- ``tests/test_hist_edges.py:85`` and ``:112``: the sketch's percentile
  lies within ``SKETCH_REL_ERR`` of the exact sample percentile, and the
  full 512-bin histogram resolves finer than the sketch — here on the
  latencies a port sweep actually binned (every superstep block the
  sweep hands ``hist_update`` is recorded, so the exact samples are
  known), for a sketch sweep and a full-histogram sweep of the same
  grid and seed, and on the port's binning of a lognormal sample.
- ``tests/test_variance.py:202`` and ``:219``: the sweep's 95%
  batch-means CI covers the exact chain's mean, and the generate sweep's
  covers the equivalent batch law's chain mean (the port's ``markov``).
  The reference runs 30 seeds; here 30 copies of the point run in one
  dispatch, which are as independent (each copy's stream is keyed by
  its own global index).  Seeds are stated in each test.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import hist as h
from repro_torch.core.analytic import LinearServiceModel
from repro_torch.core.continuous_sim import GenServiceModel
from repro_torch.core.gen_sweep import gen_sweep
from repro_torch.core.grid import GenGrid, SweepGrid
from repro_torch.core.markov import solve
from repro_torch.core.sweep import sweep
from repro_torch.core.variance import Z95
from repro_torch.kernels import superstep as ss

CPU = dict(device="cpu")
V100 = LinearServiceModel(alpha=0.1438, tau0=1.8874)
QS = (50, 95, 99)


def _binned_samples(monkeypatch, run):
    """Run ``run()`` recording every latency the sweep bins: one array a
    point."""
    kernel, seen = ss.hist_update, []

    def record(hists, lats, inc, **kw):
        seen.append([lats[p][inc[p]].clone() for p in range(lats.shape[0])])
        return kernel(hists, lats, inc, **kw)

    monkeypatch.setattr(ss, "hist_update", record)
    r = run()
    monkeypatch.setattr(ss, "hist_update", kernel)
    return r, [torch.cat([blk[p] for blk in seen]).double().numpy()
               for p in range(len(seen[0]))]


def test_sweep_percentiles_hold_the_sketch_and_full_bounds(monkeypatch):
    """Seed 4, four points (det and exp service, ρ 0.5 and 0.85 of the
    b_max-16 limit), 2,048 batches: against the exact samples each point
    binned, the sketch sweep's percentiles are within SKETCH_REL_ERR and
    the full sweep's within one full bin (2**-3 relative), and the full
    histogram's worst error is below the sketch's."""
    fr = np.array([0.5, 0.85, 0.5, 0.85], np.float32)
    lam = fr * 16 / (V100.alpha * 16 + V100.tau0)
    g = SweepGrid.from_points(lam, V100.alpha, V100.tau0, b_max=16,
                              dist=[0, 0, 1, 1])
    kw = dict(n_batches=2048, q_cap=256, seed=4, **CPU)
    full, samples = _binned_samples(monkeypatch, lambda: sweep(g, **kw))
    sk, samples_sk = _binned_samples(monkeypatch,
                                     lambda: sweep(g, sketch=True, **kw))
    full_w = 2.0 ** -3
    errs = {"full": [], "sketch": []}
    for p in range(len(g)):
        # the histogram mode changes no latency: both runs binned the
        # same samples
        assert np.array_equal(samples[p], samples_sk[p])
        assert samples[p].size == int(full.n_jobs[p]) > 0
        exact = np.percentile(samples[p], QS)
        for name, r in (("full", full), ("sketch", sk)):
            est = np.array([r.latency_p50[p], r.latency_p95[p],
                            r.latency_p99[p]])
            errs[name].append(np.abs(est - exact) / exact)
    errs = {k: np.array(v) for k, v in errs.items()}
    assert errs["sketch"].max() <= h.SKETCH_REL_ERR, errs["sketch"]
    assert errs["full"].max() <= full_w, errs["full"]
    assert errs["full"].max() < errs["sketch"].max()
    # the sketch's per-bin sums hold every binned latency
    assert np.allclose(sk.hist_sums.sum(1),
                       [s.sum() for s in samples], rtol=1e-5)


def test_sketch_relative_error_on_the_ports_binning():
    """tests/test_hist_edges.py:85 on the port's device-side binning
    (``hist_update_plain`` in sketch mode): lognormal samples (seed 7)
    at two scales."""
    rng = np.random.default_rng(7)
    for scale in (0.5, 2.0):
        lats = torch.as_tensor(rng.lognormal(scale, 1.2, 20_000)
                               .astype(np.float32)).view(1, 1, -1)
        hists = (torch.zeros(1, h.SKETCH_BINS, dtype=torch.int32),
                 torch.zeros(1, h.SKETCH_BINS))
        ss.hist_update_plain(hists, lats, torch.ones_like(lats,
                                                          dtype=torch.bool),
                             n_bins=h.SKETCH_BINS, sketch=True)
        est = h.sketch_percentiles(hists[0].numpy(), QS)
        exact = np.percentile(lats.double().numpy().ravel(), QS)
        for e, x in zip(est, exact):
            assert abs(e[0] - x) / x <= h.SKETCH_REL_ERR, (e, x)


def test_full_hist_beats_sketch_resolution():
    """tests/test_hist_edges.py:112 on the port's edges."""
    full = h.hist_edges(512)
    full_w = full[100:-1] / full[99:-2] - 1.0
    assert np.max(full_w) < h.SKETCH_REL_ERR
    widths = h.sketch_edges()[1:] / h.sketch_edges()[:-1] - 1.0
    assert np.max(widths) == pytest.approx(h.SKETCH_REL_ERR, rel=1e-9)


def test_sweep_ci_covers_exact_chain_mean():
    """tests/test_variance.py:202: ρ 0.5 at b_max 4, det service, 2,048
    batches, 30 copies at seed 0."""
    lam = 0.5 * 4 / (V100.alpha * 4 + V100.tau0)
    exact = solve(lam, V100, b_max=4).mean_latency
    g = SweepGrid.from_points(np.full(30, lam, np.float32), V100.alpha,
                              V100.tau0, b_max=4, dist="det")
    r = sweep(g, n_batches=2048, seed=0, **CPU)
    hw = r.ci_halfwidth
    assert np.all(hw > 0)
    np.testing.assert_allclose(r.stderr, hw / Z95, rtol=1e-12)
    hits = np.abs(r.mean_latency - exact) <= hw
    assert hits.mean() >= 0.75, hits.mean()
    assert abs(np.mean(r.mean_latency - exact)) <= exact * 0.01


def test_gen_ci_covers_equivalent_law_chain_mean():
    """tests/test_variance.py:219: a static generate grid (32 tokens,
    prompt 128, cap 64) at ρ 0.5 of its equivalent batch law, 8,192
    steps, q_cap 256, a_cap 64, 30 copies at seed 0."""
    model = GenServiceModel(alpha_decode=0.14, tau0_decode=1.9,
                            alpha_prefill=0.035, tau0_prefill=1.9)
    gen_tok, prompt, cap = 32, 128, 64
    alpha_eq = prompt * model.alpha_prefill + gen_tok * model.alpha_decode
    tau0_eq = model.tau0_prefill + gen_tok * model.tau0_decode
    lam = 0.5 / alpha_eq
    exact = solve(lam, LinearServiceModel(alpha_eq, tau0_eq),
                  b_max=cap).mean_latency
    g = GenGrid.from_points(
        np.full(30, lam, np.float32), model.alpha_decode,
        model.tau0_decode, model.alpha_prefill, model.tau0_prefill,
        prompt_len=prompt, gen_tokens=gen_tok, max_active=cap,
        discipline="static")
    r = gen_sweep(g, n_steps=8192, q_cap=256, a_cap=64, seed=0, **CPU)
    assert np.all(r.ci_halfwidth > 0)
    hits = np.abs(r.mean_latency - exact) <= r.ci_halfwidth
    assert hits.mean() >= 0.70, hits.mean()


# ---------------------------------------------------------------------------
# the rest of variance: the port's numpy copies against the reference
# ---------------------------------------------------------------------------

def test_variance_formulas_equal_the_reference():
    from types import SimpleNamespace

    from repro.core import variance as ref_var
    from repro_torch.core import variance as pt_var

    rng = np.random.default_rng(3)
    ci = np.concatenate([rng.exponential(1.0, 40), [np.nan, 0.0, 2.0, 2.1]])
    for kw in (dict(target_ci=0.5), dict(target_ci=0.5, safety=4.0),
               dict(refine_budget=4000), dict(target_ci=1e9)):
        assert np.array_equal(
            pt_var.allocate_cycles(ci, 64, n_max=2048, **kw),
            ref_var.allocate_cycles(ci, 64, n_max=2048, **kw))
    for bad in (dict(), dict(target_ci=1.0, refine_budget=5)):
        with pytest.raises(ValueError, match="exactly one"):
            pt_var.allocate_cycles([1.0], 10, n_max=100, **bad)
    sy, sc = rng.exponential(1.0, 9), np.r_[rng.exponential(1.0, 7), 0, 1]
    sy[3] = np.nan
    assert np.array_equal(pt_var.estimate_beta(sy, sc),
                          ref_var.estimate_beta(sy, sc))
    y, c_mc, c_ref, beta = rng.normal(size=(4, 6))
    assert np.array_equal(pt_var.cv_adjust(y, c_mc, c_ref, beta),
                          ref_var.cv_adjust(y, c_mc, c_ref, beta))
    assert np.array_equal(pt_var.cv_adjust(y, c_mc, c_ref),
                          ref_var.cv_adjust(y, c_mc, c_ref))
    a = SimpleNamespace(mean_latency=rng.normal(size=5),
                        stderr=rng.exponential(size=5))
    b = SimpleNamespace(mean_latency=rng.normal(size=5),
                        stderr=rng.exponential(size=5))
    got, want = pt_var.crn_pair_diff(a, b), ref_var.crn_pair_diff(a, b)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="equal point counts"):
        pt_var.crn_pair_diff(a, SimpleNamespace(mean_latency=np.zeros(1),
                                                stderr=np.zeros(1)))


def test_companion_grid_and_reference():
    from repro.core import variance as ref_var
    from repro.core.grid import SweepGrid as RefGrid
    from repro_torch.core import variance as pt_var
    from repro_torch.core.analytic import phi

    kw = dict(b_max=[4, 0, 8], dist=["exp", "det", "gamma"], cv=0.5)
    g = SweepGrid.from_points([1.0, 2.5, 2.0], V100.alpha, V100.tau0, **kw)
    rg = RefGrid.from_points([1.0, 2.5, 2.0], V100.alpha, V100.tau0, **kw)
    comp = pt_var.companion_grid(g)
    assert np.all(comp.dist == 0) and np.array_equal(comp.lam, g.lam)
    ref, exact = pt_var.companion_reference(comp)
    want, want_exact = ref_var.companion_reference(
        ref_var.companion_grid(rg))
    assert np.array_equal(exact, want_exact)
    assert exact.tolist() == [True, False, True]
    np.testing.assert_allclose(ref, want, rtol=1e-12)
    assert ref[1] == pytest.approx(phi(2.5, V100.alpha, V100.tau0))
    # a det grid is its own companion: the same keys, the same bits,
    # and with β = 1 the adjusted estimate collapses onto the reference
    d = SweepGrid.from_points([2.0, 3.0], V100.alpha, V100.tau0, b_max=8,
                              dist="det")
    a = sweep(d, n_batches=256, seed=5, **CPU)
    b = sweep(pt_var.companion_grid(d), n_batches=256, seed=5, **CPU)
    assert np.array_equal(a.mean_latency, b.mean_latency)
    ref_d, _ = pt_var.companion_reference(d)
    assert pt_var.cv_adjust(a.mean_latency, b.mean_latency, ref_d) == \
        pytest.approx(ref_d)
