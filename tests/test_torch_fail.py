"""The port's failure regimes (breakdown, repair, the degraded phase) on
the CPU, against the reference package.

- ``engine.completion_inflation`` and ``queue_capacity``'s failure
  arguments equal the reference's bit for bit; ``sweep_caps`` /
  ``gen_caps`` give the reference's integers on
  ``tests/test_failures.py``'s grids.
- ``tests/test_failures.py``'s seed ladders (``SW_CFG``: resume,
  restart, and drop with throttle 0.85; ``GEN_CFG``: the three
  disciplines; 6 copies each): the port against the JAX kernels on the
  same grid and against the port's own ``loss_ref`` failure mirrors,
  3σ of the paired error with that file's floors (1.5% relative,
  0.004 absolute), on mean latency, utilization, availability and the
  work-loss fraction.
- Resume and restart against the exact completion-time chain
  (``markov.solve(mtbf=, mttr=)``), the accounting laws, no buffer drops
  at an MTTR of 10·τ[b_max], ``mtbf = 0`` points and split dispatch bit
  for bit.
- The failure block: ``f_cap`` is the smallest block whose tail is under
  1e-9 at the longest busy span, no run truncates a failure count
  (``fail_truncated``), and on a static generate run of 15 MTBFs — where
  a block of 16 would undercount — resume matches the mirror and its
  breakdowns arrive at rate 1/MTBF over the busy time.  The restart run
  there is covered by ``gen_caps``' arrival chain.

The two packages draw from different random streams, so the ladders
agree statistically, not bitwise.
"""
import contextlib
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch
from scipy.stats import nbinom, poisson

from repro.core import engine as ref_engine
from repro.core import markov as ref_markov
from repro.core.continuous_sim import GenServiceModel as RefGenModel
from repro.core.gen_sweep import gen_caps as ref_gen_caps
from repro.core.gen_sweep import gen_sweep as ref_gen_sweep
from repro.core.grid import GenGrid as RefGenGrid
from repro.core.grid import SweepGrid as RefGrid
from repro.core.sweep import sweep as ref_sweep
from repro.core.sweep import sweep_caps as ref_sweep_caps
from repro_torch.core import (GenGrid, GenServiceModel, SweepGrid,
                              gen_caps, gen_sweep, sweep, sweep_caps)
from repro_torch.core import engine as pt_engine
from repro_torch.core import loss_ref as pt_loss_ref
from repro_torch.core.analytic import LinearServiceModel
from repro_torch.core.sweep import FailParams

# the test workers run side by side: one intra-op thread each keeps
# torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

CPU = dict(device="cpu")
MODEL = LinearServiceModel(alpha=0.05, tau0=1.0)
GMODEL = GenServiceModel(alpha_decode=0.14, tau0_decode=1.9,
                         alpha_prefill=0.035, tau0_prefill=1.9)
REF_GMODEL = RefGenModel(**dataclasses.asdict(GMODEL))
GEN, PROMPT, CAP = 32, 128, 64
ALPHA_EQ = GMODEL.alpha_decode * GEN + GMODEL.alpha_prefill * PROMPT
GEN_LAM = 0.7 / ALPHA_EQ

# tests/test_failures.py's ladders: (fail_disc, mtbf, mttr, throttle,
# lam) on MODEL at b_max 8, and (fail_disc, mtbf, mttr) at GEN_LAM
SW_CFG = [("resume", 8.0, 0.5, 1.0, 4.0),
          ("restart", 8.0, 0.5, 1.0, 4.0),
          ("drop", 8.0, 0.5, 0.85, 4.0)]
SW_BMAX = 8
GEN_CFG = [("resume", 200.0, 5.0), ("restart", 200.0, 5.0),
           ("drop", 200.0, 5.0)]
N_REPS, N_REF = 6, 3
FAIL_FIELDS = ("mean_latency", "utilization", "availability",
               "work_loss_frac")


def _ladder_se(kernel_vals, ref_vals, floor_frac=0.015, floor_abs=0.0):
    se = math.sqrt(kernel_vals.var(ddof=1) / len(kernel_vals)
                   + ref_vals.var(ddof=1) / len(ref_vals))
    return max(se, floor_frac * abs(float(ref_vals.mean())), floor_abs)


def _gate(kernel_vals, ref_vals, label):
    """tests/test_failures.py's 3σ gate (floors 1.5% of the reference
    mean and 0.004 absolute)."""
    se = _ladder_se(kernel_vals, ref_vals, floor_abs=0.004)
    assert abs(kernel_vals.mean() - ref_vals.mean()) < 3.0 * se, \
        (label, float(kernel_vals.mean()), float(ref_vals.mean()))


def _sw_axes():
    cfg = [c for c in SW_CFG for _ in range(N_REPS)]
    return ([c[4] for c in cfg], MODEL.alpha, MODEL.tau0), dict(
        b_max=SW_BMAX, fail_disc=[c[0] for c in cfg],
        mtbf=[c[1] for c in cfg], mttr=[c[2] for c in cfg],
        throttle=[c[3] for c in cfg])


def _gen_axes():
    cfg = [c for c in GEN_CFG for _ in range(N_REPS)]
    return ([GEN_LAM] * len(cfg), GMODEL.alpha_decode, GMODEL.tau0_decode,
            GMODEL.alpha_prefill, GMODEL.tau0_prefill), dict(
        prompt_len=PROMPT, gen_tokens=GEN, max_active=CAP,
        fail_disc=[c[0] for c in cfg], mtbf=[c[1] for c in cfg],
        mttr=[c[2] for c in cfg])


SW_RUN = dict(n_batches=6000, q_cap=64, a_cap=64, r_cap=64, seed=11)
GEN_RUN = dict(n_steps=4096, q_cap=96, a_cap=96, r_cap=64, seed=5)

# ξ·w of every busy step of the runs made under ``_spans_of(name)``, by
# discipline: each failing point's busy span in units of its MTBF
SPANS = {}


@contextlib.contextmanager
def _spans_of(name: str):
    seen = {"resume": [], "restart": []}
    interrupt = FailParams.interrupt

    def recorded(self, blk, t, w, busy):
        on = self.on & busy
        x = (w / self.scale).double()
        seen["restart"].append(x[on & self.restart])
        seen["resume"].append(x[on & ~self.restart & ~self.drop])
        seen["f_cap"] = self.f_cap
        return interrupt(self, blk, t, w, busy)

    FailParams.interrupt = recorded
    try:
        yield
    finally:
        FailParams.interrupt = interrupt
        f_cap = seen.pop("f_cap")
        SPANS[name] = {k: torch.cat(v).numpy() for k, v in seen.items()}
        SPANS[name]["f_cap"] = f_cap


@pytest.fixture(scope="module")
def sweep_ladder():
    args, kw = _sw_axes()
    with _spans_of("sw_cfg"):
        r = sweep(SweepGrid.from_points(*args, **kw), **SW_RUN, **CPU)
    return r, ref_sweep(RefGrid.from_points(*args, **kw), **SW_RUN)


@pytest.fixture(scope="module")
def gen_ladder():
    args, kw = _gen_axes()
    with _spans_of("gen_cfg"):
        r = gen_sweep(GenGrid.from_points(*args, **kw), **GEN_RUN, **CPU)
    return r, ref_gen_sweep(RefGenGrid.from_points(*args, **kw), **GEN_RUN)


# the chain cross-check's resume and restart ladders, one run
CHAIN = dict(lam=3.0, mtbf=8.0, mttr=0.5, n_lad=8)


@pytest.fixture(scope="module")
def chain_ladder():
    c = CHAIN
    g = SweepGrid.from_points(
        [c["lam"]] * (2 * c["n_lad"]), MODEL.alpha, MODEL.tau0,
        b_max=SW_BMAX, fail_disc=["resume"] * c["n_lad"]
        + ["restart"] * c["n_lad"], mtbf=c["mtbf"], mttr=c["mttr"])
    with _spans_of("chain"):
        return sweep(g, n_batches=8000, q_cap=64, a_cap=64, seed=3, **CPU)


# the static generate point of the chip's user-size grid with the
# longest run (gen 256 at cap 64, ρ 0.85): 3.07 s of busy span, 15
# MTBFs of resume at 200 ms, where a block of 16 epochs truncates the
# breakdown count with probability 0.37; 6 resume copies, and 2 restart
# copies at 20,000 ms, whose lost attempts stretch a run past the
# failure-free arrival chain
LONG = dict(gen=256, cap=64, n_res=6, n_rst=2)
LONG_LAM = 0.85 * GMODEL.capped_capacity(PROMPT, LONG["gen"], LONG["cap"])


@pytest.fixture(scope="module")
def long_static():
    n_res, n_rst = LONG["n_res"], LONG["n_rst"]
    g = GenGrid.from_points(
        [LONG_LAM] * (n_res + n_rst), GMODEL.alpha_decode,
        GMODEL.tau0_decode, GMODEL.alpha_prefill, GMODEL.tau0_prefill,
        prompt_len=PROMPT, gen_tokens=LONG["gen"], max_active=LONG["cap"],
        discipline="static", fail_disc=["resume"] * n_res
        + ["restart"] * n_rst, mtbf=[200.0] * n_res + [20_000.0] * n_rst,
        mttr=5.0)
    caps = gen_caps(g)
    with _spans_of("long_static"):
        r = gen_sweep(g, n_steps=2048, seed=3, **caps, **CPU)
    return r, caps


# -- the sizing laws, bit for bit -----------------------------------------

LAM = np.array([0.5, 3.0, 7.5, 1.2])
ALPHA = np.array([0.05, 0.1438, 0.05, 0.2])
TAU0 = np.array([1.0, 1.8874, 1.0, 0.5])
B_MAX = np.array([8, 0, 32, 4])


@pytest.mark.parametrize("case", ["resume", "restart", "mixed", "throttle",
                                  "q_max", "scalar"])
def test_completion_inflation_and_queue_capacity_bitwise(case):
    mtbf = np.array([8.0, 60.0, 0.0, 200.0])
    mttr = np.array([0.5, 12.0, 0.0, 5.0])
    kw = {}
    if case == "restart":
        kw["restart"] = np.ones(4, bool)
    elif case == "mixed":
        kw["restart"] = np.array([True, False, True, False])
    elif case == "throttle":
        kw.update(restart=np.array([False, True, False, True]),
                  throttle=np.array([0.85, 1.0, 1.2, 1.0]))
    elif case == "scalar":
        mtbf, mttr = 60.0, 14.0
    args = (LAM, ALPHA, TAU0, B_MAX)
    got = pt_engine.completion_inflation(*args, mtbf, mttr, **kw)
    want = ref_engine.completion_inflation(*args, mtbf, mttr, **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.all(got >= 1.0) and np.any(got > 1.0)
    q_max = [4, 0, 32, 256] if case == "q_max" else None
    for wait in (0.0, np.array([0.0, 2.0, 0.0, 1.0])):
        assert pt_engine.queue_capacity(*args, wait, q_max=q_max,
                                        mtbf=mtbf, mttr=mttr, **kw) == \
            ref_engine.queue_capacity(*args, wait, q_max=q_max, mtbf=mtbf,
                                      mttr=mttr, **kw)


def _caps_grids():
    args, kw = _sw_axes()
    yield "sw_cfg", SweepGrid.from_points(*args, **kw), \
        RefGrid.from_points(*args, **kw)
    mixed = dict(b_max=SW_BMAX, fail_disc=["restart", "resume", "resume"],
                 mtbf=[8.0, 0.0, 0.0], mttr=[0.5, 0.0, 0.0])
    yield "mixed", SweepGrid.from_points([4.0, 3.0, 2.0], MODEL.alpha,
                                         MODEL.tau0, **mixed), \
        RefGrid.from_points([4.0, 3.0, 2.0], MODEL.alpha, MODEL.tau0,
                            **mixed)
    headroom = dict(b_max=SW_BMAX, fail_disc="restart", mtbf=60.0,
                    mttr=14.0, q_max=[0, 24], retry_rate=[0.0, 0.3])
    yield "headroom", SweepGrid.from_points([2.0, 2.0], MODEL.alpha,
                                            MODEL.tau0, **headroom), \
        RefGrid.from_points([2.0, 2.0], MODEL.alpha, MODEL.tau0, **headroom)
    args, kw = _gen_axes()
    yield "gen_cfg", GenGrid.from_points(*args, **kw), \
        RefGenGrid.from_points(*args, **kw)
    kw.update(q_max=[0, 20] * (len(args[0]) // 2), throttle=0.85)
    yield "gen_loss", GenGrid.from_points(*args, **kw), \
        RefGenGrid.from_points(*args, **kw)


@pytest.mark.parametrize("name", ["sw_cfg", "mixed", "headroom", "gen_cfg",
                                  "gen_loss"])
def test_caps_equal_the_reference(name):
    (g, rg), = [(g, rg) for n, g, rg in _caps_grids() if n == name]
    if isinstance(g, GenGrid):
        caps, want = gen_caps(g), ref_gen_caps(rg)
        assert caps["a_cap"] > gen_caps(dataclasses.replace(
            g, mtbf=np.zeros_like(g.mtbf)))["a_cap"]
        # the chain also covers each point's longest extended run, which
        # the reference's inflation-and-burst sizing does not
        assert caps.pop("a_cap") >= want.pop("a_cap")
    else:
        caps, want = sweep_caps(g), ref_sweep_caps(rg)
        # a failed batch's completion has no bound: a_cap follows q_cap
        assert caps["a_cap"] == caps["q_cap"]
        pinned = sweep_caps(g, q_cap=512)
        assert pinned.pop("f_cap") >= 16
        assert pinned == ref_sweep_caps(rg, q_cap=512)
    # the failure block is the port's own (the reference draws its
    # counts unbounded); the reference's restart block is its floor
    assert caps.pop("f_cap") >= 16
    assert caps == want
    assert ("r_cap" in caps) == g.has_loss


# -- seed ladders ---------------------------------------------------------

@pytest.mark.parametrize("ci", range(len(SW_CFG)))
def test_sweep_ladder_against_reference_and_mirror(sweep_ladder, ci):
    r, rr = sweep_ladder
    disc, mtbf, mttr, thr, lam = SW_CFG[ci]
    sl = slice(ci * N_REPS, (ci + 1) * N_REPS)
    mirror = [pt_loss_ref.simulate_loss_numpy(
        lam, MODEL, SW_BMAX, mtbf=mtbf, mttr=mttr, fail_disc=disc,
        throttle=thr, q_cap=64, r_cap=64, n_batches=15_000, seed=s)
        for s in range(N_REF)]
    for f in FAIL_FIELDS:
        got = np.asarray(getattr(r, f)[sl], dtype=float)
        _gate(got, np.asarray(getattr(rr, f)[sl], dtype=float),
              (disc, f, "jax sweep"))
        _gate(got, np.array([getattr(x, f) for x in mirror]),
              (disc, f, "loss_ref"))


@pytest.mark.parametrize("ci", range(len(GEN_CFG)))
def test_gen_ladder_against_reference_and_mirror(gen_ladder, ci):
    r, rr = gen_ladder
    disc, mtbf, mttr = GEN_CFG[ci]
    sl = slice(ci * N_REPS, (ci + 1) * N_REPS)
    mirror = [pt_loss_ref.simulate_gen_loss_numpy(
        GEN_LAM, GMODEL, prompt_len=PROMPT, gen_tokens=GEN, max_active=CAP,
        mtbf=mtbf, mttr=mttr, fail_disc=disc, q_cap=96, r_cap=64,
        n_steps=20_000, seed=s) for s in range(N_REF)]
    for f in FAIL_FIELDS:
        got = np.asarray(getattr(r, f)[sl], dtype=float)
        _gate(got, np.asarray(getattr(rr, f)[sl], dtype=float),
              (disc, f, "jax gen_sweep"))
        _gate(got, np.array([getattr(x, f) for x in mirror]),
              (disc, f, "loss_ref"))


@pytest.mark.parametrize("disc", ["resume", "restart"])
def test_latency_and_availability_against_the_exact_chain(chain_ladder,
                                                          disc):
    """tests/test_failures.py's TestChainVsMC: the completion-time
    transform of the exact chain against the port's failing sweep."""
    c = CHAIN
    n_lad = c["n_lad"]
    ex = ref_markov.solve(c["lam"], MODEL, b_max=SW_BMAX, mtbf=c["mtbf"],
                          mttr=c["mttr"], fail_disc=disc)
    sl = slice(0, n_lad) if disc == "resume" else slice(n_lad, 2 * n_lad)
    lat = np.asarray(chain_ladder.mean_latency[sl], dtype=float)
    se = max(lat.std(ddof=1) / math.sqrt(n_lad), 0.003 * ex.mean_latency)
    z = (lat.mean() - ex.mean_latency) / se
    assert abs(z) < 3.0, (disc, float(lat.mean()), ex.mean_latency, z)
    av = float(np.asarray(chain_ladder.availability[sl], dtype=float).mean())
    assert abs(av - ex.availability) < 0.01, (disc, av, ex.availability)


# -- exact laws and bitwise contracts ------------------------------------

@pytest.mark.parametrize("which", ["sweep", "gen"])
def test_accounting_laws(sweep_ladder, gen_ladder, which):
    r = (sweep_ladder if which == "sweep" else gen_ladder)[0]
    assert int(r.buffer_dropped.sum()) == 0
    av = np.asarray(r.availability, dtype=float)
    assert np.all((av > 0.0) & (av <= 1.0))
    wl = np.asarray(r.work_loss_frac, dtype=float)
    assert np.all((wl >= 0.0) & (wl < 1.0))
    assert np.all(r.span > 0.0) and np.all(r.n_failures > 0)
    assert np.all(r.down_time > 0.0)
    # availability is the share of the measured span not under repair
    assert np.allclose(av, 1.0 - r.down_time / r.span)
    lost = np.asarray(r.lost_work, dtype=float)
    # resume loses no work; restart re-executes; drop abandons
    assert np.all(lost[:N_REPS] == 0.0)
    assert np.all(lost[N_REPS:] > 0.0)
    sl = slice(2 * N_REPS, 3 * N_REPS)
    offered = (r.n_jobs + r.overflow_dropped + r.abandoned)[sl]
    total = (r.goodput_frac + r.late_frac + r.reject_frac
             + r.abandon_frac)[sl]
    assert np.all(offered > 0) and np.allclose(total, 1.0, atol=1e-6)
    # drop's aborted jobs are abandoned, the other disciplines lose none
    assert np.all(r.abandoned[sl] > 0)
    assert int(r.abandoned[:2 * N_REPS].sum()) == 0


@pytest.mark.parametrize("disc", ["resume", "restart"])
def test_no_buffer_drops_at_long_mttr(disc):
    """tests/test_failures.py's TestQueueCapacityHeadroom: q_cap sized by
    the completion-time law keeps buffer_dropped at 0 at an MTTR of
    10·τ[b_max]."""
    lam = 2.0
    mttr, mtbf = 10.0 * MODEL.tau(SW_BMAX), 60.0
    q_cap = pt_engine.queue_capacity(
        np.array([lam]), MODEL.alpha, MODEL.tau0, SW_BMAX,
        mtbf=np.array([mtbf]), mttr=np.array([mttr]),
        restart=np.array([disc == "restart"]))
    g = SweepGrid.from_points([lam] * 4, MODEL.alpha, MODEL.tau0,
                              b_max=SW_BMAX, fail_disc=disc, mtbf=mtbf,
                              mttr=mttr)
    r = sweep(g, n_batches=4000, q_cap=q_cap, a_cap=q_cap, seed=2, **CPU)
    assert int(r.buffer_dropped.sum()) == 0
    assert np.all(np.asarray(r.n_failures) > 0)


@functools.lru_cache(maxsize=None)
def _neutral_base(which: str):
    """The failure-free points of the mtbf = 0 grids, run alone (the
    same run for both variants: only point 0 differs)."""
    g = _neutral_grid(which, False).take(slice(1, None))
    run, kw = _neutral_run(which)
    return run(g, key_offset=1, **kw)


def _neutral_grid(which: str, with_loss: bool):
    discs = ["drop" if with_loss else "restart", "resume", "resume"]
    if which == "sweep":
        return SweepGrid.from_points(
            [4.0, 3.0, 2.0], MODEL.alpha, MODEL.tau0, b_max=SW_BMAX,
            fail_disc=discs, mtbf=[8.0, 0.0, 0.0], mttr=[0.5, 0.0, 0.0],
            throttle=[0.85, 1.0, 1.0])
    return GenGrid.from_points(
        [GEN_LAM, 0.8 * GEN_LAM, 0.6 * GEN_LAM], GMODEL.alpha_decode,
        GMODEL.tau0_decode, GMODEL.alpha_prefill, GMODEL.tau0_prefill,
        prompt_len=PROMPT, gen_tokens=GEN, max_active=[64, 32, 16],
        discipline=["continuous", "continuous", "static"],
        fail_disc=discs, mtbf=[200.0, 0.0, 0.0], mttr=[5.0, 0.0, 0.0])


def _neutral_run(which: str):
    if which == "sweep":
        return sweep, dict(n_batches=1024, q_cap=64, a_cap=64, seed=11,
                           **CPU)
    return gen_sweep, dict(n_steps=1024, q_cap=64, a_cap=96, seed=13, **CPU)


NEUTRAL = ("mean_latency", "mean_batch", "batch_m2", "mean_service",
           "utilization", "n_jobs", "n_batches", "latency_p50",
           "latency_p99", "hist", "stderr", "max_queue")


@pytest.mark.parametrize("which", ["sweep", "gen"])
@pytest.mark.parametrize("with_loss", [False, True], ids=["fail", "drop"])
def test_mtbf_0_points_reduce_to_the_base_path_bitwise(which, with_loss):
    """An mtbf = 0 point of a failure grid (with a drop point, a loss
    grid too) gives the failure-free path's bits at the same caps, seed
    and global index."""
    g = _neutral_grid(which, with_loss)
    run, kw = _neutral_run(which)
    mixed = run(g, r_cap=32, **kw)
    base = _neutral_base(which)
    fields = NEUTRAL if which == "sweep" else tuple(
        f for f in NEUTRAL if f not in ("mean_service", "n_batches")
    ) + ("n_steps",)
    rest = g.take(slice(1, None))
    assert g.has_fail and g.has_loss == with_loss
    assert not rest.has_fail and not rest.has_loss
    for f in fields:
        assert np.array_equal(getattr(mixed, f)[1:], getattr(base, f),
                              equal_nan=True), f
    assert np.all(mixed.availability[1:] == 1.0)
    assert np.all(mixed.n_failures[1:] == 0) and mixed.n_failures[0] > 0
    assert np.all(mixed.lost_work[1:] == 0.0)


SPLIT = ("mean_latency", "n_jobs", "n_failures", "down_time", "lost_work",
         "utilization", "hist", "abandoned", "max_queue")


@pytest.mark.parametrize("which", ["sweep", "gen"])
def test_split_dispatch_with_failures_bitwise(which):
    discs = ["resume", "restart", "drop", "resume"]
    if which == "sweep":
        g = SweepGrid.from_points(
            [4.0, 3.5, 3.0, 2.5], MODEL.alpha, MODEL.tau0, b_max=SW_BMAX,
            fail_disc=discs, mtbf=[8.0, 8.0, 8.0, 0.0],
            mttr=[0.5, 0.5, 0.5, 0.0], throttle=[1.0, 0.85, 1.0, 1.0],
            dist=["det", "gamma"] * 2)
        run, caps = sweep, sweep_caps(g)
        kw = dict(n_batches=512, seed=11, **caps, **CPU)
    else:
        g = GenGrid.from_points(
            [GEN_LAM] * 4, GMODEL.alpha_decode, GMODEL.tau0_decode,
            GMODEL.alpha_prefill, GMODEL.tau0_prefill, prompt_len=PROMPT,
            gen_tokens=GEN, max_active=[64, 32, 64, 16],
            discipline=["continuous", "static", "continuous", "static"],
            fail_disc=discs, mtbf=[200.0, 200.0, 200.0, 0.0],
            mttr=[5.0, 5.0, 5.0, 0.0], throttle=[0.85, 1.0, 1.0, 1.0])
        run, caps = gen_sweep, gen_caps(g)
        kw = dict(n_steps=1024, seed=13, **caps, **CPU)
    assert g.has_fail and "r_cap" in caps
    full = run(g, **kw)
    a = run(g.take(slice(0, 2)), **kw)
    b = run(g.take(slice(2, None)), key_offset=2, **kw)
    for f in SPLIT:
        merged = np.concatenate([getattr(a, f), getattr(b, f)])
        assert np.array_equal(getattr(full, f), merged), f
    assert np.all(full.n_failures[:3] > 0)
    # a chunk of a failure grid must pin its caps, the failure block too
    kw.pop("q_cap")
    with pytest.raises(ValueError, match="q_cap"):
        run(g.take(slice(2, None)), key_offset=2, **kw)
    kw["q_cap"] = caps["q_cap"]
    kw.pop("f_cap")
    with pytest.raises(ValueError, match="f_cap"):
        run(g.take(slice(2, None)), key_offset=2, **kw)


def test_failure_block_truncation_is_negligible(sweep_ladder, gen_ladder,
                                                chain_ladder, long_static):
    """Resume's failure count M is Poisson(ξ·w) truncated at the block
    of f_cap epochs, and restart's attempt count is truncated there too:
    no run here truncates (``fail_truncated``), and averaged over every
    busy step of each regime's runs (the ladders, the chain cells and
    the 15-MTBF static generate run) P(M ≥ f_cap) on the resume points
    and P(f_cap attempts fail) on the restart points stay under 1e-6."""
    runs = (sweep_ladder[0], gen_ladder[0], chain_ladder, long_static[0])
    for r in runs:
        assert int(r.fail_truncated.sum()) == 0
    assert long_static[1]["f_cap"] > 16
    for name in ("sw_cfg", "gen_cfg", "chain", "long_static"):
        x, f_cap = SPANS[name], SPANS[name]["f_cap"]
        assert len(x["resume"]) >= 500, name
        p_m = float(poisson.sf(f_cap - 1, x["resume"]).mean())
        assert p_m < 1e-6, (name, p_m, x["resume"].max())
        if len(x["restart"]):
            p_rst = float(((-np.expm1(-x["restart"])) ** f_cap).mean())
            assert p_rst < 1e-6, (name, p_rst, x["restart"].max())


@pytest.mark.parametrize("kshape", [np.inf, 1.0, 4.0, 0.25])
@pytest.mark.parametrize("x", [0.05, 0.3, 3.18, 15.3])
def test_failure_count_bound_is_the_smallest_tail(x, kshape):
    """``engine.failure_count_bound``: the smallest n with P(M ≥ n) under
    1e-9, for Poisson(x) breakdowns in a fixed span and their negative
    binomial mixture over a Gamma(kshape) span of mean x MTBFs; the
    ceiling where the tail is still above 1e-9 there."""
    n = pt_engine.failure_count_bound(x, kshape, ceil=1024)

    def tail(m):
        if np.isinf(kshape):
            return poisson.sf(m - 1, x)
        return nbinom.sf(m - 1, kshape, kshape / (kshape + x))

    if tail(1024) >= 1e-9:
        assert n == 1024
    else:
        assert tail(n) < 1e-9 <= tail(n - 1)


def test_fail_capacity_covers_the_longest_span():
    """``f_cap`` is the bucketed bound at the grid's longest busy span
    in MTBFs, at least 16, and the restart bound is ⌈ln 1e-9 / ln p⌉."""
    span = np.array([3068.78, 100.0, 5.0])
    assert pt_engine.fail_capacity([200.0, 200.0, 0.0], span) == 48
    assert pt_engine.fail_capacity([8.0], [1.4]) == 16
    p = -math.expm1(-0.155)
    n = pt_engine.restart_attempt_bound(0.155)
    assert p ** n < 1e-9 <= p ** (n - 1)


def test_long_static_run_matches_the_mirror(long_static):
    """Resume over 15 MTBFs: the breakdowns arrive at rate 1/MTBF over
    the measured busy time (a block of 16 would count 7% fewer), and the
    copies hold against the mirror, which draws M unbounded, at 3σ."""
    r, caps = long_static
    sl = slice(0, LONG["n_res"])
    busy = np.asarray(r.utilization * r.span, dtype=float)[sl]
    want = busy.sum() / 200.0
    got = float(r.n_failures[sl].sum())
    assert abs(got - want) < 3.0 * math.sqrt(want), (got, want)
    mirror = [pt_loss_ref.simulate_gen_loss_numpy(
        LONG_LAM, GMODEL, prompt_len=PROMPT, gen_tokens=LONG["gen"],
        max_active=LONG["cap"], discipline="static", mtbf=200.0, mttr=5.0,
        fail_disc="resume", q_cap=caps["q_cap"], n_steps=12_000, seed=s)
        for s in range(N_REF)]
    for f in FAIL_FIELDS:
        _gate(np.asarray(getattr(r, f)[sl], dtype=float),
              np.array([getattr(x, f) for x in mirror]), ("long", f))


def test_restart_extension_stays_inside_the_arrival_chain(long_static):
    """gen_caps sizes the arrival chain for a run stretched by its lost
    restart attempts: at 20,000 ms (0.15 MTBFs a run) the static point
    fails and restarts, and no arrival falls past the chain's edge."""
    r, caps = long_static
    sl = slice(LONG["n_res"], None)
    assert int(r.buffer_dropped.sum()) == 0
    assert np.all(r.n_failures[sl] > 0) and np.all(r.lost_work[sl] > 0.0)
