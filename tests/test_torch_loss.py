"""The port's loss regimes (finite waiting rooms in both overflow modes,
deadlines with reneging, the bounded retry orbit) on the CPU, against
the reference package.

- The engine's loss helpers equal the reference's bit for bit on the
  same inputs (the port takes the step's pre-drawn block where the
  reference takes a key: the same offsets, the same uniforms).
- ``sweep_caps`` / ``gen_caps`` and the generate sweep's loss buffer
  length are the reference's integers.
- The port's ``loss_ref`` copy gives the reference's results field for
  field on the same seeds.
- ``tests/test_backpressure.py``'s seed ladders (``SW_CFG``,
  ``GEN_CFG``, 6 copies each): the port against the JAX kernels on the
  same grid and against the reference's numpy mirrors, 3σ of the paired
  error with that file's floors (1.5% relative, 0.004 absolute); reject
  fractions of q_max-only points against the exact finite-room chain.
- The exact accounting laws, the neutral reduction and split dispatch
  with loss bit for bit, and the guards.

The two packages draw from different random streams, so the ladders
agree statistically, not bitwise.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import loss_ref as ref_loss_ref
from repro.core.analytic import LinearServiceModel
from repro.core.continuous_sim import GenServiceModel as RefGenModel
from repro.core.gen_sweep import gen_caps as ref_gen_caps
from repro.core.gen_sweep import gen_plan as ref_gen_plan
from repro.core.gen_sweep import gen_sweep as ref_gen_sweep
from repro.core.grid import GenGrid as RefGenGrid
from repro.core.grid import SweepGrid as RefGrid
from repro.core.markov import solve_loss
from repro.core.sweep import sweep as ref_sweep
from repro.core.sweep import sweep_caps as ref_sweep_caps
from repro_torch.core import (GenGrid, GenServiceModel, SweepGrid,
                              evaluate, gen_caps, gen_sweep, sweep,
                              sweep_caps)
from repro_torch.core import engine as pt_engine
from repro_torch.core import loss_ref as pt_loss_ref
from repro_torch.core.gen_sweep import buffer_length

# the test workers run side by side: one intra-op thread each keeps
# torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

CPU = dict(device="cpu")
MODEL = LinearServiceModel(alpha=0.05, tau0=1.0)
V100 = LinearServiceModel(alpha=0.1438, tau0=1.8874)
GMODEL = GenServiceModel(alpha_decode=0.14, tau0_decode=1.9,
                         alpha_prefill=0.035, tau0_prefill=1.9)
REF_GMODEL = RefGenModel(**dataclasses.asdict(GMODEL))
GEN, PROMPT, CAP = 32, 128, 64
GEN_LAM = 1.08 / (GMODEL.alpha_decode * GEN + GMODEL.alpha_prefill * PROMPT)

# tests/test_backpressure.py's ladders: (q_max, deadline, overflow,
# retry_rate, lam) and (discipline, overflow, q_max, deadline, retry)
SW_CFG = [(10, 6.0, "reject", 0.5, 6.0),
          (10, 6.0, "drop", 0.5, 6.0),
          (24, 3.0, "reject", 0.3, 7.5)]
GEN_CFG = [("continuous", "reject", 20, 40.0, 0.05),
           ("static", "drop", 20, 40.0, 0.05)]
N_REPS, N_REF = 6, 3
FIELDS = ("goodput_frac", "reject_frac", "abandon_frac",
          "retry_inflation", "mean_latency")
# benchmarks/backpressure.py's grid axes (192 points)
BP_B_MAX = 8
BP_RHOS = [0.7, 0.9, 1.1, 1.3]
BP_Q_MAXES = [4, 8, 16, 32]
BP_DEADLINES = [0.0, 6.0, 12.0]
BP_OVERFLOWS = ("reject", "drop")
BP_RETRY = [0.0, 0.2]


def _gate(kernel_vals, ref_vals, label):
    """tests/test_backpressure.py's 3σ gate: the combined standard error
    of two ladders' means, floored at 1.5% of the reference mean and at
    0.004 absolute."""
    se = math.sqrt(kernel_vals.var(ddof=1) / len(kernel_vals)
                   + ref_vals.var(ddof=1) / len(ref_vals))
    se = max(se, 0.015 * abs(float(ref_vals.mean())), 0.004)
    assert abs(kernel_vals.mean() - ref_vals.mean()) < 3.0 * se, \
        (label, float(kernel_vals.mean()), float(ref_vals.mean()))


def _sw_axes():
    cfg = [c for c in SW_CFG for _ in range(N_REPS)]
    return ([c[4] for c in cfg], MODEL.alpha, MODEL.tau0), dict(
        b_max=8, q_max=[c[0] for c in cfg], deadline=[c[1] for c in cfg],
        overflow=[c[2] for c in cfg], retry_rate=[c[3] for c in cfg])


def _gen_axes():
    cfg = [c for c in GEN_CFG for _ in range(N_REPS)]
    return ([GEN_LAM] * len(cfg), GMODEL.alpha_decode, GMODEL.tau0_decode,
            GMODEL.alpha_prefill, GMODEL.tau0_prefill), dict(
        prompt_len=PROMPT, gen_tokens=GEN, max_active=CAP,
        discipline=[c[0] for c in cfg], q_max=[c[2] for c in cfg],
        deadline=[c[3] for c in cfg], overflow=[c[1] for c in cfg],
        retry_rate=[c[4] for c in cfg])


def _bp_axes():
    cap = BP_B_MAX / V100.tau(BP_B_MAX)
    return ([r * cap for r in BP_RHOS], [V100.alpha], [V100.tau0]), dict(
        b_maxes=[BP_B_MAX], q_maxes=BP_Q_MAXES, deadlines=BP_DEADLINES,
        overflows=BP_OVERFLOWS, retry_rates=BP_RETRY)


@pytest.fixture(scope="module")
def sweep_ladder():
    args, kw = _sw_axes()
    run = dict(n_batches=6000, q_cap=64, a_cap=64, r_cap=64, seed=11)
    return (sweep(SweepGrid.from_points(*args, **kw), **run, **CPU),
            ref_sweep(RefGrid.from_points(*args, **kw), **run))


@pytest.fixture(scope="module")
def gen_ladder():
    args, kw = _gen_axes()
    # a_cap sized so the pre-drawn arrival chain always covers its
    # windows: the run-structured numpy mirror has no coverage splits
    run = dict(n_steps=6000, q_cap=64, a_cap=96, r_cap=64, seed=5)
    return (gen_sweep(GenGrid.from_points(*args, **kw), **run, **CPU),
            ref_gen_sweep(RefGenGrid.from_points(*args, **kw), **run))


# -- the engine's loss helpers, bit for bit ----------------------------

P, A_CAP, Q_CAP, R_CAP = 6, 12, 16, 20


def test_push_poisson_window_loss_bitwise():
    rng = np.random.default_rng(0)
    buf = rng.normal(size=(P, Q_CAP + A_CAP)).astype(np.float32)
    q = np.array([0, 3, 9, 16, 12, 5], np.int32)
    dropped = np.array([0, 1, 0, 2, 0, 0], np.int32)
    room = np.array([16, 4, 10, 16, 12, 16], np.int32)
    t0 = rng.uniform(0, 2, P).astype(np.float32)
    win = np.array([0.5, 3.0, 1.0, 2.0, 9.0, 0.0], np.float32)
    rate = np.float32(4.0)
    keys = jax.random.split(jax.random.PRNGKey(3), P)

    def ref_one(b, qq, d, k, tt, w, r):
        return ref_engine.push_poisson_window_loss(
            b, qq, d, k, rate, tt, w, a_cap=A_CAP, q_cap=Q_CAP, room=r)
    want = jax.vmap(ref_one)(jnp.asarray(buf), jnp.asarray(q),
                             jnp.asarray(dropped), keys, jnp.asarray(t0),
                             jnp.asarray(win), jnp.asarray(room))
    offs = np.asarray(jax.vmap(
        lambda k: ref_engine.exp_offsets(k, A_CAP + 1, rate))(keys))
    got = pt_engine.push_poisson_window_loss(
        torch.from_numpy(buf.copy()), torch.from_numpy(q),
        torch.from_numpy(dropped), torch.from_numpy(offs.T.copy()),
        torch.from_numpy(t0), torch.from_numpy(win), q_cap=Q_CAP,
        room=torch.from_numpy(room))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.array_equal(g.numpy().view(w.dtype), w)
    assert int(got[4].sum()) > 0 and int(got[3].sum()) > 0


def test_renege_prefix_bitwise():
    rng = np.random.default_rng(1)
    buf = np.sort(rng.uniform(-20, 0, (P, Q_CAP + A_CAP)),
                  axis=1).astype(np.float32)
    q = np.array([0, 4, 16, 10, 7, 16], np.int32)
    now = rng.uniform(0, 3, P).astype(np.float32)
    deadline = np.array([5.0, 0.0, 8.0, 12.0, 30.0, 1.0], np.float32)
    want = jax.vmap(lambda b, qq, t, d: ref_engine.renege_prefix(
        b, qq, t, d, Q_CAP))(jnp.asarray(buf), jnp.asarray(q),
                             jnp.asarray(now), jnp.asarray(deadline))
    got = pt_engine.renege_prefix(torch.from_numpy(buf), torch.from_numpy(q),
                                  torch.from_numpy(now),
                                  torch.from_numpy(deadline), Q_CAP)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.array_equal(g.numpy().view(w.dtype), w)
    assert int(got[2].sum()) > 0


def test_orbit_draws_bitwise_on_the_reference_uniforms():
    keys = jax.random.split(jax.random.PRNGKey(7), P)
    R = np.array([0, 1, 5, R_CAP, 12, 20], np.int32)
    p = np.array([0.5, 0.9, 0.3, 0.1, 0.0, 1.0], np.float32)
    want = jax.vmap(lambda k, r, pp: ref_engine.orbit_draws(
        k, r, pp, R_CAP))(keys, jnp.asarray(R), jnp.asarray(p))
    u = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (R_CAP,)))(keys))
    got = pt_engine.orbit_draws(torch.from_numpy(u.T.copy()),
                                torch.from_numpy(R), torch.from_numpy(p))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


def test_orbit_file_bitwise():
    R = np.array([0, 10, 20, 15, 3, 0], np.int32)
    a = np.array([3, 8, 2, 0, 30, 5], np.int32)
    b = np.array([4, 5, 1, 9, 2, 0], np.int32)
    on = np.array([True, True, True, True, True, False])
    want = jax.vmap(lambda r, x, y, e: ref_engine.orbit_file(
        r, x, y, R_CAP, e))(*(jnp.asarray(v) for v in (R, a, b, on)))
    got = pt_engine.orbit_file(*(torch.from_numpy(v) for v in (R, a, b)),
                               R_CAP, torch.from_numpy(on))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("q_max", [None, 0, 8, [4, 0, 32, 256]])
def test_capacity_helpers_equal_the_reference(q_max):
    lam = np.array([0.5, 3.0, 7.5, 1.2])
    alpha = np.array([0.05, 0.1438, 0.05, 0.2])
    tau0 = np.array([1.0, 1.8874, 1.0, 0.5])
    b_max = np.array([8, 0, 32, 4])
    for wait in (0.0, np.array([0.0, 2.0, 0.0, 1.0])):
        assert pt_engine.queue_capacity(lam, alpha, tau0, b_max, wait,
                                        q_max=q_max) == \
            ref_engine.queue_capacity(lam, alpha, tau0, b_max, wait,
                                      q_max=q_max)
    for rr in (0.0, 0.05, [0.5, 0.0, 0.3, 2.0]):
        assert pt_engine.orbit_capacity(lam, rr) == \
            ref_engine.orbit_capacity(lam, rr)


# -- capacities and the loss buffer length -----------------------------

def test_sweep_caps_equal_the_reference_on_the_backpressure_grid():
    args, kw = _bp_axes()
    g, rg = SweepGrid.from_product(*args, **kw), RefGrid.from_product(
        *args, **kw)
    assert len(g) == 192
    assert sweep_caps(g) == ref_sweep_caps(rg)
    assert sweep_caps(g)["r_cap"] == 128
    assert sweep_caps(g, q_cap=256) == ref_sweep_caps(rg, q_cap=256)
    args, kw = _sw_axes()
    assert sweep_caps(SweepGrid.from_points(*args, **kw)) == \
        ref_sweep_caps(RefGrid.from_points(*args, **kw))


def test_gen_caps_and_buffer_length_equal_the_reference():
    args, kw = _gen_axes()
    g, rg = GenGrid.from_points(*args, **kw), RefGenGrid.from_points(
        *args, **kw)
    caps = gen_caps(g)
    assert caps == ref_gen_caps(rg) and "r_cap" in caps
    # the reference's buffer is the (P, buf_len) float32 carry of its
    # scan; read its length off the traced program
    plan = ref_gen_plan(rg.take(slice(0, 2)), n_steps=2048, q_cap=64,
                        a_cap=32, r_cap=128, shard=1)
    jaxpr = str(jax.make_jaxpr(plan.kernel)(plan.params, plan.keys))
    length = buffer_length(64, 32, CAP, r_cap=128)
    assert length == 64 + 162 * 16 + 161 == 2817
    assert f"f32[2,{length}]" in jaxpr
    # the loss-free form of the same caps appears nowhere in it
    assert f"f32[2,{buffer_length(64, 32, CAP)}]" not in jaxpr


# -- the numpy mirrors: the port's copy is the reference's -------------

@pytest.mark.parametrize("which", ["sweep", "gen", "fleet"])
def test_loss_ref_copy_equals_the_reference(which):
    if which == "sweep":
        kw = dict(q_max=10, deadline=6.0, overflow="drop", retry_rate=0.5,
                  q_cap=64, r_cap=64, n_batches=3000, dist="gamma", cv=0.7)
        runs = [m.simulate_loss_numpy(6.0, MODEL, 8, seed=s, **kw)
                for m in (pt_loss_ref, ref_loss_ref) for s in (0, 1)]
    elif which == "gen":
        kw = dict(prompt_len=PROMPT, gen_tokens=GEN, max_active=CAP,
                  discipline="continuous", q_max=20, deadline=40.0,
                  overflow="reject", retry_rate=0.05, q_cap=64, r_cap=64,
                  n_steps=3000)
        runs = [pt_loss_ref.simulate_gen_loss_numpy(GEN_LAM, GMODEL, seed=s,
                                                    **kw) for s in (0, 1)]
        runs += [ref_loss_ref.simulate_gen_loss_numpy(GEN_LAM, REF_GMODEL,
                                                      seed=s, **kw)
                 for s in (0, 1)]
    else:
        kw = dict(k=2, routing="jsq", q_max=12, deadline=1.8,
                  overflow="drop", retry_rate=0.5, q_cap=64, r_cap=64,
                  n_events=6000, mtbf=40.0, mttr=2.0, fail_disc="restart")
        runs = [m.simulate_fleet_loss_numpy(8.0, MODEL, 4, seed=s, **kw)
                for m in (pt_loss_ref, ref_loss_ref) for s in (0, 1)]
    for a, b in zip(runs[:2], runs[2:]):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.offered > 0 and (a.overflow_dropped + a.abandoned) > 0


# -- seed ladders --------------------------------------------------------

@pytest.mark.parametrize("ci", range(len(SW_CFG)))
def test_sweep_ladder_against_reference_and_mirror(sweep_ladder, ci):
    r, rr = sweep_ladder
    qm, dl, ov, rate, lam = SW_CFG[ci]
    sl = slice(ci * N_REPS, (ci + 1) * N_REPS)
    mirror = [ref_loss_ref.simulate_loss_numpy(
        lam, MODEL, 8, q_max=qm, deadline=dl, overflow=ov, retry_rate=rate,
        q_cap=64, r_cap=64, n_batches=20_000, seed=s) for s in range(N_REF)]
    for f in FIELDS:
        got = np.asarray(getattr(r, f)[sl], dtype=float)
        _gate(got, np.asarray(getattr(rr, f)[sl], dtype=float),
              (ci, f, "jax sweep"))
        _gate(got, np.array([getattr(x, f) for x in mirror]),
              (ci, f, "loss_ref"))


@pytest.mark.parametrize("ci", range(len(GEN_CFG)))
def test_gen_ladder_against_reference_and_mirror(gen_ladder, ci):
    r, rr = gen_ladder
    disc, ov, qm, dl, rate = GEN_CFG[ci]
    sl = slice(ci * N_REPS, (ci + 1) * N_REPS)
    mirror = [ref_loss_ref.simulate_gen_loss_numpy(
        GEN_LAM, REF_GMODEL, prompt_len=PROMPT, gen_tokens=GEN,
        max_active=CAP, discipline=disc, q_max=qm, deadline=dl, overflow=ov,
        retry_rate=rate, q_cap=64, r_cap=64, n_steps=20_000, seed=s)
        for s in range(N_REF)]
    for f in FIELDS:
        got = np.asarray(getattr(r, f)[sl], dtype=float)
        _gate(got, np.asarray(getattr(rr, f)[sl], dtype=float),
              (ci, f, "jax gen_sweep"))
        _gate(got, np.array([getattr(x, f) for x in mirror]),
              (ci, f, "loss_ref"))


def test_reject_fraction_matches_the_exact_finite_room_chain():
    """q_max-only reject points (no deadline, no retry) against
    ``markov.solve_loss``'s numpy band path, as tests/test_chain_loss.py
    holds the reference; the copies of a cell are its seed ladder."""
    cells = [(0.9, 4), (1.1, 8), (1.3, 16)]
    reps = 5
    cap = 4 / V100.tau(4)
    lams = [rho * cap for rho, _ in cells for _ in range(reps)]
    g = SweepGrid.from_points(lams, V100.alpha, V100.tau0, b_max=4,
                              q_max=[q for _, q in cells for _ in range(reps)],
                              overflow="reject")
    r = sweep(g, n_batches=8000, q_cap=64, a_cap=64, seed=100, **CPU)
    assert int(r.buffer_dropped.sum()) == 0
    for i, (rho, q_max) in enumerate(cells):
        sl = slice(i * reps, (i + 1) * reps)
        ex = solve_loss(float(g.lam[i * reps]),
                        LinearServiceModel(float(g.alpha[0]),
                                           float(g.tau0[0])),
                        q_max=q_max, b_max=4)
        loss, w = r.reject_frac[sl], r.mean_latency[sl]
        se_l = max(loss.std(ddof=1) / math.sqrt(reps), 0.003)
        se_w = max(w.std(ddof=1) / math.sqrt(reps), 0.01 * ex.mean_latency)
        assert abs(loss.mean() - ex.loss_frac) < 3.0 * se_l, (rho, q_max)
        assert abs(w.mean() - ex.mean_latency) < 3.0 * se_w, (rho, q_max)
        assert ex.loss_frac > 0.01


# -- exact laws and bitwise contracts -----------------------------------

@pytest.mark.parametrize("which", ["sweep", "gen"])
def test_accounting_laws(sweep_ladder, gen_ladder, which):
    r = (sweep_ladder if which == "sweep" else gen_ladder)[0]
    assert int(r.buffer_dropped.sum()) == 0
    offered = r.n_jobs + r.overflow_dropped + r.abandoned
    assert np.array_equal(r.offered, offered)
    total = r.goodput_frac + r.late_frac + r.reject_frac + r.abandon_frac
    assert np.allclose(total[offered > 0], 1.0, atol=1e-6)
    assert np.all(r.n_in_slo <= r.n_jobs)
    assert np.all(r.retry_inflation >= 1.0 - 1e-6)
    if which == "sweep":
        # retries are on in every configuration
        assert np.all(r.retry_inflation > 1.01)
        assert np.all(r.n_batches > 0) and np.all(r.n_batches <= 6016)


NEUTRAL = ("mean_latency", "mean_batch", "batch_m2", "utilization",
           "n_jobs", "latency_p50", "latency_p99", "hist", "stderr")


@pytest.mark.parametrize("which", ["sweep", "gen"])
def test_neutral_points_reduce_to_the_base_path_bitwise(which):
    """tests/test_backpressure.py's shapes: a q_max = 0 / deadline = 0 /
    retry = 0 point of a loss grid gives the loss-free path's bits at
    the same caps, seed and global index."""
    if which == "sweep":
        g = SweepGrid.from_points(
            [6.0, 4.0, 5.0], MODEL.alpha, MODEL.tau0, b_max=8,
            q_max=[10, 0, 0], deadline=[6.0, 0.0, 0.0],
            retry_rate=[0.5, 0.0, 0.0])
        kw = dict(n_batches=1024, q_cap=64, a_cap=64, seed=11, **CPU)
        mixed = sweep(g, r_cap=32, **kw)
        base = sweep(g.take(slice(1, None)), key_offset=1, **kw)
    else:
        g = GenGrid.from_points(
            [GEN_LAM, 0.6 * GEN_LAM, 0.4 * GEN_LAM], GMODEL.alpha_decode,
            GMODEL.tau0_decode, GMODEL.alpha_prefill, GMODEL.tau0_prefill,
            prompt_len=PROMPT, gen_tokens=GEN, max_active=[32, 32, 16],
            discipline=["continuous", "continuous", "static"],
            q_max=[20, 0, 0], deadline=[40.0, 0.0, 0.0],
            retry_rate=[0.05, 0.0, 0.0])
        kw = dict(n_steps=1024, q_cap=64, a_cap=64, seed=13, **CPU)
        mixed = gen_sweep(g, r_cap=32, **kw)
        base = gen_sweep(g.take(slice(1, None)), key_offset=1, **kw)
    assert g.has_loss and not g.take(slice(1, None)).has_loss
    for f in NEUTRAL:
        assert np.array_equal(getattr(mixed, f)[1:], getattr(base, f),
                              equal_nan=True), f
    assert int(mixed.overflow_dropped[1:].sum()) == 0
    assert int(mixed.abandoned[1:].sum()) == 0
    assert np.all(mixed.goodput_frac[1:] == 1.0)
    assert int(mixed.overflow_dropped[0] + mixed.abandoned[0]) > 0


SPLIT = ("mean_latency", "mean_batch", "n_jobs", "overflow_dropped",
         "abandoned", "n_in_slo", "n_fresh", "n_retry", "hist", "max_queue")


@pytest.mark.parametrize("which", ["sweep", "gen"])
def test_split_dispatch_with_loss_bitwise(which):
    if which == "sweep":
        g = SweepGrid.from_points(
            [6.0, 7.0, 6.0, 5.0], MODEL.alpha, MODEL.tau0, b_max=8,
            q_max=[10, 12, 0, 8], deadline=[6.0, 0.0, 0.0, 3.0],
            overflow=["reject", "drop", "reject", "reject"],
            retry_rate=[0.5, 0.0, 0.0, 1.0], dist=["det", "gamma"] * 2)
        run, caps = sweep, sweep_caps(g)
        kw = dict(n_batches=512, seed=11, **caps, **CPU)
    else:
        g = GenGrid.from_points(
            [GEN_LAM] * 4, GMODEL.alpha_decode, GMODEL.tau0_decode,
            GMODEL.alpha_prefill, GMODEL.tau0_prefill, prompt_len=PROMPT,
            gen_tokens=GEN, max_active=[16, 32, 16, 8],
            discipline=["continuous", "static", "static", "continuous"],
            q_max=[20, 0, 12, 20], deadline=[40.0, 30.0, 0.0, 0.0],
            overflow=["reject", "drop", "drop", "reject"],
            retry_rate=[0.05, 0.0, 0.1, 0.0])
        run, caps = gen_sweep, gen_caps(g)
        kw = dict(n_steps=1024, seed=13, **caps, **CPU)
    assert "r_cap" in caps
    full = run(g, **kw)
    a = run(g.take(slice(0, 2)), **kw)
    b = run(g.take(slice(2, None)), key_offset=2, **kw)
    for f in SPLIT:
        merged = np.concatenate([getattr(a, f), getattr(b, f)])
        assert np.array_equal(getattr(full, f), merged), f
    assert int(full.overflow_dropped.sum() + full.abandoned.sum()) > 0
    # a chunk must pin r_cap too
    kw.pop("r_cap")
    with pytest.raises(ValueError, match="r_cap"):
        run(g.take(slice(2, None)), key_offset=2, **kw)


@pytest.mark.parametrize("which", ["sweep", "gen"])
@pytest.mark.parametrize("grid", ["fail_drop", "loss_mtbf"])
def test_failure_grids_raise_3d(which, grid):
    """Loss grids with failures (a fail-drop grid is a loss grid through
    its failures) raised "3d" until the failure regimes were ported;
    they now run, and hold the exact accounting laws."""
    extra = (dict(mtbf=50.0, mttr=1.0, fail_disc="drop") if grid == "fail_drop"
             else dict(q_max=8, deadline=5.0, mtbf=50.0, mttr=1.0))
    if which == "sweep":
        g = SweepGrid.from_points([2.0], V100.alpha, V100.tau0, **extra)
        r = sweep(g, n_batches=512, seed=3, **CPU)
    else:
        g = GenGrid.from_points([0.05], 0.1, 1.0, 0.1, 1.0, **extra)
        r = gen_sweep(g, n_steps=64, seed=3, **CPU)
    assert g.has_loss and g.has_fail
    assert int(r.buffer_dropped.sum()) == 0
    assert int(r.fail_truncated.sum()) == 0
    offered = r.n_jobs + r.overflow_dropped + r.abandoned
    total = r.goodput_frac + r.late_frac + r.reject_frac + r.abandon_frac
    assert np.all(offered > 0) and np.allclose(total, 1.0, atol=1e-6)
    assert int(r.n_failures[0]) > 0 and 0.0 < float(r.availability[0]) < 1.0
    if grid == "fail_drop":
        # aborted work is lost work, and its jobs are abandoned
        assert float(r.lost_work[0]) > 0.0 and int(r.abandoned[0]) > 0


def test_q_max_above_q_cap_raises():
    g = SweepGrid.from_points([2.0], V100.alpha, V100.tau0, q_max=128)
    with pytest.raises(ValueError, match="q_max exceeds q_cap"):
        sweep(g, n_batches=64, q_cap=64, **CPU)
    gg = GenGrid.from_points([0.05], 0.1, 1.0, 0.1, 1.0, q_max=128)
    with pytest.raises(ValueError, match="q_max exceeds q_cap"):
        gen_sweep(gg, n_steps=64, q_cap=64, **CPU)


def test_evaluate_carries_the_loss_fractions(sweep_ladder):
    args, kw = _sw_axes()
    g = SweepGrid.from_points(*args, **kw).take(slice(0, 2))
    res = evaluate(g, backend="sweep", n_batches=256, q_cap=64, a_cap=64,
                   r_cap=64, seed=11, **CPU)
    for x in res:
        x.check()
        assert x.reject_frac > 0.0 and x.retry_inflation > 1.0
        assert x.goodput_frac + x.reject_frac + x.abandon_frac <= 1 + 1e-9
    gargs, gkw = _gen_axes()
    gg = GenGrid.from_points(*gargs, **gkw).take(slice(0, 1))
    (x,) = evaluate(gg, backend="gen", n_steps=2048, q_cap=64, a_cap=96,
                    r_cap=64, seed=5, **CPU)
    x.check()
    assert not math.isnan(x.abandon_frac) and x.retry_inflation > 1.0
    lossy = SweepGrid.from_points([0.5], V100.alpha, V100.tau0, q_max=8)
    with pytest.raises(ValueError, match="lossless"):
        evaluate(lossy, backend="analytic")
