"""The port's campaign driver (``repro_torch.core.campaign``) and its
chunk fold (``repro_torch.kernels.campaign_fold``), on the CPU.

- The fold: the port's ``campaign_fold_plain`` against the reference's
  jitted fold (``repro.core.campaign._build_fold``, called directly in a
  ``jax.enable_x64`` scope) on the same seeded chunks: every field
  bitwise — the integer fields, ``max_ci``, the top-K lists and the
  float64 sums (no multiply-add of the fold is contracted: each product
  is multiplied by the 0/1 weight before it is added, so a fused
  multiply-add would round the same sum).
- The port's campaign against its own contracts, at the reference
  tests' sizes (``tests/test_campaign.py``, ``test_campaign_faults.py``,
  ``test_adaptive_campaign.py``): chunked = whole bitwise, resume,
  faults, the tap, the adaptive witnesses.
- Against the reference statistically: the port's pipelined campaign
  and the reference ``campaign(mode="serial")`` (the reference mode
  that runs on this host, ROADMAP C-R1) agree on the aggregate E[W] and
  utilisation within 3 standard errors of a seed ladder; the
  reference ``_host_fold`` over the port's per-point results equals the
  port's.
- The plan split: ``sweep`` / ``gen_sweep`` / ``fleet_sweep`` equal
  plan → run → ``_to_result`` bit for bit.
"""
import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import campaign as ref_campaign
from repro.core.grid import SweepGrid as RefGrid
from repro_torch.core import campaign as pt_campaign
from repro_torch.core import engine
from repro_torch.core.campaign import (CampaignKilled, FaultPlan, campaign,
                                       operating_points, plan_chunks,
                                       verify_resume)
from repro_torch.core.fleet import _to_result as fleet_result
from repro_torch.core.fleet import fleet_plan, fleet_sweep
from repro_torch.core.gen_sweep import _to_result as gen_result
from repro_torch.core.gen_sweep import gen_plan, gen_sweep
from repro_torch.core.grid import FleetGrid, GenGrid, SweepGrid
from repro_torch.core.metrics import MetricsTap
from repro_torch.core.sweep import _to_result as sweep_result
from repro_torch.core.sweep import sweep, sweep_plan
from repro_torch.kernels.campaign_fold import FoldAcc, campaign_fold

CPU = dict(device="cpu")
ALPHA, TAU0 = 0.1438, 1.8874
N_BATCHES = 12


def _loss_grid(n=48, cls=SweepGrid):
    """tests/test_campaign.py's grid: every loss axis and both service
    families."""
    i = np.arange(n)
    b = np.where(i % 2 == 0, 4, 16).astype(np.int32)
    fr = np.linspace(0.3, 0.9, n, dtype=np.float32)
    lam = fr * b / (ALPHA * b + TAU0)
    return cls.from_points(
        lam, ALPHA, TAU0, b_max=b,
        dist=np.where(i % 2 == 0, 0, 1).astype(np.int32),
        q_max=np.where(i % 3 == 0, 0, 16).astype(np.int32),
        deadline=np.where(i % 4 == 0, 50.0, 0.0).astype(np.float32),
        retry_rate=np.where(i % 5 == 0, 0.25, 0.0).astype(np.float32))


# ---------------------------------------------------------------------------
# the fold against the reference's
# ---------------------------------------------------------------------------

def _chunk(rng, m, n_bins, has_loss, sketch, poison):
    c = {
        "hist": rng.integers(0, 50, (m, n_bins)).astype(np.int32),
        "n_jobs": rng.integers(0, 1000, m).astype(np.int32),
        "batches": rng.integers(0, 100, m).astype(np.int32),
        "dropped": rng.integers(0, 3, m).astype(np.int32),
        "mean_latency": rng.lognormal(1.0, 1.0, m).astype(np.float32),
        "utilization": rng.uniform(0, 1, m).astype(np.float32),
        "mean_batch": rng.uniform(1, 30, m).astype(np.float32),
        "lam": rng.uniform(0.1, 10, m).astype(np.float32),
        "lat_bm_m2": rng.exponential(3.0, m).astype(np.float32),
        "lat_bm_n": rng.integers(0, 40, m).astype(np.int32),
    }
    # tied latencies and rates: the first minimal slot and the earliest
    # index must win
    c["mean_latency"][::5] = c["mean_latency"][0]
    c["lam"][1::7] = c["lam"][1]
    if sketch:
        c["hist_sums"] = (c["hist"] * rng.lognormal(0, 1, (m, n_bins))
                          ).astype(np.float32)
    if has_loss:
        for k in ("overflow_dropped", "abandoned", "n_in_slo", "n_fresh",
                  "n_retry"):
            c[k] = rng.integers(0, 200, m).astype(np.int32)
        c["n_jobs"][3] = c["overflow_dropped"][3] = c["abandoned"][3] = 0
    if poison:
        c["mean_latency"][2] = np.nan
        c["utilization"][m // 2] = np.inf
        c["lat_bm_m2"][m - 2] = np.nan
        if sketch:
            c["hist_sums"][m - 3, 3] = np.nan
    return c


@pytest.mark.parametrize("m,n_valid", [(8, 8), (37, 30), (64, 50)])
@pytest.mark.parametrize("sketch", [False, True])
@pytest.mark.parametrize("has_loss", [False, True])
@pytest.mark.parametrize("poison", [False, True])
def test_fold_plain_equals_the_reference_fold(m, n_valid, sketch, has_loss,
                                              poison):
    """Two chunks in a row, k_top 4 (so the top-K lists fill and
    replace), the second from the first's accumulator: every field
    bitwise, float64 sums included, and the summaries."""
    n_bins, k_top = (64 if sketch else 512), 4
    rng = np.random.default_rng(m + 100 * n_valid + 7 * sketch)
    chunks = [_chunk(rng, m, n_bins, has_loss, sketch, poison)
              for _ in range(2)]
    acc = FoldAcc.from_host(pt_campaign._init_acc(n_bins, k_top), "cpu")
    with jax.enable_x64(True):
        fold = ref_campaign._build_fold(m, n_bins, k_top, has_loss, sketch,
                                        True, False)
        ref = {k: jnp.asarray(v)
               for k, v in ref_campaign._init_acc(n_bins, k_top).items()}
        for j, c in enumerate(chunks):
            gidx = np.arange(j * m, (j + 1) * m, dtype=np.int64)
            ref, want = fold(ref, {k: jnp.asarray(v) for k, v in c.items()},
                             gidx, np.int64(n_valid))
            got = campaign_fold(acc, {k: torch.as_tensor(v)
                                      for k, v in c.items()},
                                torch.as_tensor(gidx), n_valid,
                                has_loss=has_loss, sketch=sketch)
            keys = ("points", "jobs", "buffer_dropped", "quarantined")
            keys += ("overflow_dropped", "abandoned") if has_loss else ()
            assert got.tolist() == [int(want[k]) for k in keys]
        ref = {k: np.asarray(v) for k, v in ref.items()}
    mine = acc.to_host()
    assert set(mine) == set(ref)
    for k in ref:
        assert mine[k].dtype == ref[k].dtype and \
            mine[k].shape == ref[k].shape, k
        assert np.array_equal(mine[k], ref[k]), k
    if poison:
        assert int(mine["quarantined_points"]) > 0
    if sketch:
        assert np.any(mine["hist_sums"] > 0)
    assert (mine["top_lat_idx"] >= 0).all()


def test_fold_wrapper_guards():
    acc = FoldAcc.from_host(pt_campaign._init_acc(512, 4), "cpu")
    c = {k: torch.as_tensor(v) for k, v in _chunk(
        np.random.default_rng(0), 8, 512, False, False, False).items()}
    g = torch.arange(8)
    with pytest.raises(ValueError, match="hist"):
        campaign_fold(FoldAcc.from_host(pt_campaign._init_acc(64, 4), "cpu"),
                      c, g, 8, has_loss=False, sketch=False)
    with pytest.raises(ValueError, match="lacks"):
        campaign_fold(acc, c, g, 8, has_loss=True, sketch=False)
    with pytest.raises(ValueError, match="n_valid"):
        campaign_fold(acc, c, g, 9, has_loss=False, sketch=False)
    c["lam"] = c["lam"].double()
    with pytest.raises(ValueError, match="lam"):
        campaign_fold(acc, c, g, 8, has_loss=False, sketch=False)
    before = campaign_fold.launches
    c["lam"] = c["lam"].float()
    campaign_fold(acc, c, g, 8, has_loss=False, sketch=False)
    assert campaign_fold.launches == before    # the plain version


def test_fold_acc_round_trips_the_reference_layout():
    host = pt_campaign._init_acc(64, 3)
    host["hist"][5] = 7
    host["top_good_val"][1] = 2.5
    host["sum_util"] = np.float64(0.25)
    back = FoldAcc.from_host(host, "cpu").to_host()
    assert list(back) == list(ref_campaign._init_acc(64, 3))
    for k in host:
        assert back[k].dtype == host[k].dtype and \
            np.array_equal(back[k], host[k]), k


# ---------------------------------------------------------------------------
# chunk determinism (tests/test_campaign.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweep_pair():
    g = _loss_grid(48)
    chunked = campaign(g, chunk_size=16, n_batches=N_BATCHES, seed=3, **CPU)
    whole = campaign(g, chunk_size=48, n_batches=N_BATCHES, seed=3, **CPU)
    return chunked, whole


def test_sweep_chunked_equals_whole(sweep_pair):
    chunked, whole = sweep_pair
    assert chunked.n_chunks == 3 and whole.n_chunks == 1
    assert chunked.fingerprint() == whole.fingerprint()
    assert chunked.totals == whole.totals
    assert chunked.totals["jobs"] > 0
    assert chunked.totals["overflow_dropped"] > 0
    assert chunked.totals["buffer_dropped"] == 0
    assert chunked.quarantined_chunks == []


def test_top_k_and_percentiles_chunk_invariant(sweep_pair):
    chunked, whole = sweep_pair
    assert chunked.top_latency == whole.top_latency
    assert chunked.top_goodput == whole.top_goodput
    p = chunked.percentiles((50, 95, 99))
    assert p == whole.percentiles((50, 95, 99))
    assert np.all(np.isfinite(p)) and p[0] <= p[1] <= p[2]


def test_fleet_chunked_equals_whole():
    k = np.tile([1, 2, 4], 8).astype(np.int32)
    lam = np.linspace(0.5, 2.0, 24, dtype=np.float32) * k
    g = FleetGrid.from_points(lam, ALPHA, TAU0, k=k, routing="jsq", b_max=8,
                              q_max=np.where(np.arange(24) % 2 == 0, 0,
                                             12).astype(np.int32))
    a = campaign(g, chunk_size=8, n_steps=48, seed=7, **CPU)
    b = campaign(g, chunk_size=24, n_steps=48, seed=7, **CPU)
    assert a.kind == "fleet" and a.n_chunks == 3
    assert a.fingerprint() == b.fingerprint()


def test_gen_chunked_equals_whole():
    lam = np.linspace(0.05, 0.4, 18, dtype=np.float32)
    g = GenGrid.from_points(
        lam, 0.02, 0.5, 0.01, 2.0, prompt_len=32, gen_tokens=8,
        max_active=16,
        q_max=np.where(np.arange(18) % 3 == 0, 0, 8).astype(np.int32))
    a = campaign(g, chunk_size=6, n_steps=64, seed=9, **CPU)
    b = campaign(g, chunk_size=18, n_steps=64, seed=9, **CPU)
    assert a.kind == "gen" and a.n_chunks == 3
    assert a.fingerprint() == b.fingerprint()


def test_sketch_chunked_equals_whole():
    g = _loss_grid(32)
    a = campaign(g, chunk_size=16, sketch=True, n_batches=N_BATCHES, seed=3,
                 **CPU)
    b = campaign(g, chunk_size=32, sketch=True, n_batches=N_BATCHES, seed=3,
                 **CPU)
    assert a.fingerprint() == b.fingerprint()
    assert np.isfinite(a.percentiles((95,))[0])
    assert a.acc["hist_sums"].sum() > 0


# ---------------------------------------------------------------------------
# resume, the tap, pad accounting, host memory
# ---------------------------------------------------------------------------

def test_kill_and_resume_matches_uninterrupted(tmp_path):
    g = _loss_grid(48)
    kw = dict(chunk_size=16, n_batches=N_BATCHES, seed=3, **CPU)
    full = campaign(g, **kw)
    part = campaign(g, out_dir=tmp_path / "c", checkpoint_every=1,
                    stop_after_chunks=2, **kw)
    assert not part.completed
    res = campaign(g, out_dir=tmp_path / "c", resume=True,
                   checkpoint_every=1, **kw)
    assert res.completed
    assert res.fingerprint() == full.fingerprint()
    rows = [json.loads(line) for line in
            (tmp_path / "c" / "chunks.jsonl").read_text().splitlines()]
    assert [r["chunk"] for r in rows] == [0, 1, 2]
    assert sum(r["points"] for r in rows) == 48


@pytest.mark.parametrize("change", ["config", "grid"])
def test_resume_rejects_a_changed_campaign(tmp_path, change):
    campaign(_loss_grid(32), chunk_size=16, n_batches=N_BATCHES, seed=3,
             out_dir=tmp_path / "c", stop_after_chunks=1, **CPU)
    g2, n_b = _loss_grid(32), N_BATCHES
    if change == "grid":
        g2.lam[0] += 0.125
    else:
        n_b += 1
    with pytest.raises(ValueError, match="does not match"):
        campaign(g2, chunk_size=16, n_batches=n_b, seed=3,
                 out_dir=tmp_path / "c", resume=True, **CPU)


def test_tapped_bitwise_equals_untapped(tmp_path):
    g = _loss_grid(32)
    plain = campaign(g, chunk_size=16, n_batches=N_BATCHES, seed=3, **CPU)
    jsonl = tmp_path / "m.jsonl"
    with MetricsTap(jsonl, label="camp", expected_points=16) as tap:
        tapped = campaign(g, chunk_size=16, n_batches=N_BATCHES, seed=3,
                          metrics_tap=tap, tap_every=2, **CPU)
    assert tapped.fingerprint() == plain.fingerprint()
    assert tapped.tapped_chunks == 1          # chunk 0 of {0, 1}
    recs = [json.loads(line) for line in jsonl.read_text().splitlines()]
    kinds = [r["type"] for r in recs]
    assert kinds.count("chunk") == tapped.n_chunks
    # n_batches 12 rounds up to one 32-step superstep, tapped once
    assert kinds.count("superstep") == 1
    assert [r["chunk"] for r in recs if r["type"] == "chunk"] == [0, 1]


def test_plan_chunks_prefers_divisors():
    assert plan_chunks(96, 40) == (32, 3, 0)
    assert plan_chunks(64, 48) == (32, 2, 0)
    assert plan_chunks(29, 8) == (8, 4, 3)
    for n, c in ((96, 40), (64, 48), (29, 8), (1000, 333)):
        assert plan_chunks(n, c) == ref_campaign.plan_chunks(n, c)


def test_padded_rows_sum_to_plan():
    r = campaign(_loss_grid(29), chunk_size=8, n_batches=N_BATCHES, seed=3,
                 **CPU)
    assert r.padded_points == 3
    assert sum(row["padded"] for row in r.rows) == 3
    assert r.totals["points"] == 29


def test_pipelined_peak_is_size_independent():
    g_small, g_big = _loss_grid(32), _loss_grid(96)
    a = campaign(g_small, chunk_size=16, n_batches=N_BATCHES, seed=3, **CPU)
    b = campaign(g_big, chunk_size=16, n_batches=N_BATCHES, seed=3, **CPU)
    assert b.peak_host_result_bytes <= a.peak_host_result_bytes * 1.5
    s = campaign(g_big, chunk_size=16, n_batches=N_BATCHES, seed=3,
                 mode="serial", **CPU)
    assert s.peak_host_result_bytes > 10 * b.peak_host_result_bytes


def test_serial_runs_lightly_loaded_finite_room():
    g = SweepGrid.from_points(np.full(16, 0.3, np.float32), ALPHA, TAU0,
                              b_max=4, q_max=256)
    r = campaign(g, chunk_size=8, n_batches=N_BATCHES, seed=3, mode="serial",
                 **CPU)
    assert r.totals["points"] == 16


def test_guards_raise_before_any_chunk(monkeypatch):
    g = _loss_grid(16)
    # shard > 1 (3f) raised here too: on one device it now runs as one
    # shard, bitwise, as the reference's clamped shard does
    one, two = (campaign(g, chunk_size=8, n_batches=N_BATCHES, seed=3,
                         shard=n, **CPU) for n in (1, 2))
    assert one.fingerprint() == two.fingerprint()
    with pytest.raises(ValueError, match="unknown campaign mode"):
        campaign(g, mode="eager", **CPU)
    with pytest.raises(TypeError, match="cannot stream"):
        campaign([1, 2], **CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        campaign(g, chunk_size=8, n_batches=N_BATCHES)


# ---------------------------------------------------------------------------
# faults (tests/test_campaign_faults.py)
# ---------------------------------------------------------------------------

N_POINTS = 32
KW = dict(chunk_size=8, n_batches=256, fault_backoff_s=0.0, **CPU)


@pytest.fixture(scope="module")
def fgrid():
    return SweepGrid.from_points(np.linspace(0.3, 0.9, N_POINTS), 0.05, 1.0,
                                 b_max=4)


@pytest.fixture(scope="module")
def clean(fgrid):
    return campaign(fgrid, **KW)


def test_fault_plan_rolls_as_the_reference():
    for kw in (dict(seed=7, p_dispatch=0.5), dict(seed=3, p_nan=0.3),
               dict(seed=1, p_corrupt=1.0, max_per_chunk=1)):
        p, q = FaultPlan(**kw), ref_campaign.FaultPlan(**kw)
        for kind in ("dispatch", "nan", "corrupt"):
            assert [p.roll(kind, c, a) for c in range(16) for a in range(3)] \
                == [q.roll(kind, c, a) for c in range(16) for a in range(3)]
        assert p.to_config() == q.to_config()
    with pytest.raises(ValueError):
        FaultPlan(p_nan=1.5)
    with pytest.raises(ValueError):
        FaultPlan().roll("meteor", 0)


def test_faults_require_pipelined_mode(fgrid):
    with pytest.raises(ValueError, match="pipelined"):
        campaign(fgrid, mode="serial", fault_plan=FaultPlan(), chunk_size=8,
                 n_batches=256, **CPU)


def test_retry_heals_bitwise(fgrid, clean):
    r = campaign(fgrid, fault_plan=FaultPlan(seed=3, p_dispatch=0.7,
                                             max_per_chunk=2),
                 fault_retries=4, **KW)
    assert r.fingerprint() == clean.fingerprint()
    assert r.quarantined_chunks == []
    assert any(row["retries"] > 0 for row in r.rows)


def test_exhausted_retries_quarantine_never_drop(fgrid, tmp_path):
    r = campaign(fgrid, fault_plan=FaultPlan(seed=3, p_dispatch=1.0,
                                             max_per_chunk=8),
                 fault_retries=1, out_dir=str(tmp_path), **KW)
    assert r.completed
    assert len(r.quarantined_chunks) == r.n_chunks
    assert all(q["reason"] == "dispatch" and "error" in q
               for q in r.quarantined_chunks)
    assert r.quarantined_points == N_POINTS
    assert r.totals["points"] == 0
    man = json.loads((tmp_path / "manifest.json").read_text())
    assert man["quarantined"] == r.quarantined_chunks
    assert sum(row["quarantined"] for row in r.rows) == N_POINTS


def test_partial_quarantine_keeps_other_chunks(fgrid):
    r = campaign(fgrid, fault_plan=FaultPlan(seed=5, p_dispatch=0.4,
                                             max_per_chunk=8),
                 fault_retries=0, **KW)
    lost = sum(q["points"] for q in r.quarantined_chunks)
    assert 0 < lost < N_POINTS
    assert r.totals["points"] == N_POINTS - lost
    assert r.quarantined_points == lost


def test_nan_chunk_is_quarantined_and_clean_points_kept(fgrid, clean,
                                                        tmp_path):
    plan = FaultPlan(seed=5, p_nan=0.6)
    r = campaign(fgrid, fault_plan=plan, out_dir=str(tmp_path), **KW)
    assert r.completed and r.quarantined_chunks
    assert all(q["reason"] == "nonfinite" for q in r.quarantined_chunks)
    for k in ("sum_latency_jobs", "sum_latency", "sum_util", "sum_batch",
              "hist_sums", "max_ci"):
        assert np.all(np.isfinite(r.acc[k])), k
    q_pts = sum(q["points"] for q in r.quarantined_chunks)
    assert r.totals["points"] + q_pts == N_POINTS
    assert r.totals["quarantined_points"] == q_pts
    man = json.loads((tmp_path / "manifest.json").read_text())
    assert man["quarantined"] == r.quarantined_chunks
    # the clean chunks fold exactly their points' own results
    bad = {q["chunk"] for q in r.quarantined_chunks}
    keep = np.concatenate([np.arange(8 * c, 8 * c + 8)
                           for c in range(4) if c not in bad])
    per_point = sweep(fgrid, n_batches=256, **CPU)
    assert np.array_equal(per_point.hist[keep].sum(0), r.hist)
    assert int(per_point.n_jobs[keep].sum()) == r.totals["jobs"]


def test_clean_grid_quarantines_nothing(clean):
    assert clean.quarantined_chunks == []
    assert clean.totals["quarantined_points"] == 0
    assert clean.totals["points"] == N_POINTS


def test_corrupt_checkpoint_detected_on_resume(fgrid, tmp_path):
    plan = FaultPlan(seed=1, p_corrupt=1.0, max_per_chunk=1)
    with pytest.raises(CampaignKilled):
        campaign(fgrid, out_dir=str(tmp_path), checkpoint_every=1,
                 fault_plan=plan, _kill_after_chunks=3, **KW)
    man = json.loads((tmp_path / "manifest.json").read_text())
    disk = (tmp_path / "accumulator.npz").read_bytes()
    assert hashlib.sha256(disk).hexdigest() != man["acc_sha"]
    res = campaign(fgrid, out_dir=str(tmp_path), checkpoint_every=1,
                   fault_plan=plan, resume=True, **KW)
    assert "checkpoint_corrupt" in [e["event"] for e in res.fault_events]
    assert res.fingerprint() == campaign(fgrid, fault_plan=plan,
                                         **KW).fingerprint()


def test_prev_generation_fallback(fgrid, clean, tmp_path):
    seed = next(s for s in range(200)
                if FaultPlan(seed=s, p_corrupt=0.5).roll("corrupt", 3)
                and not FaultPlan(seed=s, p_corrupt=0.5).roll("corrupt", 1))
    plan = FaultPlan(seed=seed, p_corrupt=0.5)
    r = campaign(fgrid, out_dir=str(tmp_path), checkpoint_every=2,
                 fault_plan=plan, **KW)
    assert r.completed and r.n_chunks == 4
    res = campaign(fgrid, out_dir=str(tmp_path), checkpoint_every=2,
                   fault_plan=plan, resume=True, **KW)
    recov = [e for e in res.fault_events
             if e["event"] == "checkpoint_recovered"]
    assert recov and recov[0]["chunks_done"] == 2
    assert res.fingerprint() == clean.fingerprint()


@pytest.mark.parametrize("kill,every,resumed", [(2, 1, 2), (3, 2, 2)])
def test_verify_resume(fgrid, tmp_path, kill, every, resumed):
    w = verify_resume(fgrid, out_dir=str(tmp_path), kill_after_chunks=kill,
                      checkpoint_every=every, **KW)
    assert w["match"] and w["killed_after"] == kill
    assert w["resumed_from"] == resumed


def test_kill_resume_under_all_faults(fgrid, tmp_path):
    plan = FaultPlan(seed=9, p_dispatch=0.5, p_nan=0.3, p_corrupt=0.5,
                     max_per_chunk=2)
    w = verify_resume(fgrid, out_dir=str(tmp_path), kill_after_chunks=3,
                      checkpoint_every=1, fault_plan=plan, fault_retries=4,
                      **KW)
    assert w["match"]


def test_kill_guards(fgrid, tmp_path):
    with pytest.raises(ValueError, match="never fired"):
        verify_resume(fgrid, out_dir=str(tmp_path / "a"),
                      kill_after_chunks=99, **KW)
    with pytest.raises(CampaignKilled) as ei:
        campaign(fgrid, out_dir=str(tmp_path / "b"), checkpoint_every=1,
                 _kill_after_chunks=2, **KW)
    assert ei.value.chunks_drained == 2
    plan = FaultPlan(seed=1, p_dispatch=0.2)
    with pytest.raises(CampaignKilled):
        campaign(fgrid, out_dir=str(tmp_path / "c"), checkpoint_every=1,
                 fault_plan=plan, _kill_after_chunks=2, **KW)
    with pytest.raises(ValueError, match="does not match"):
        campaign(fgrid, out_dir=str(tmp_path / "c"), resume=True,
                 fault_plan=FaultPlan(seed=2, p_dispatch=0.2),
                 checkpoint_every=1, **KW)


# ---------------------------------------------------------------------------
# adaptive mode (tests/test_adaptive_campaign.py)
# ---------------------------------------------------------------------------

PILOT, N_MAX = 64, 512


def _agrid(n=24):
    fr = np.linspace(0.2, 0.7, n)
    b = np.where(np.arange(n) % 2 == 0, 4, 8).astype(np.int32)
    lam = fr * b / (ALPHA * b + TAU0)
    dist = np.where(np.arange(n) < n - 6, 0, 1).astype(np.int32)
    return SweepGrid.from_points(lam, ALPHA, TAU0, b_max=b, dist=dist)


AKW = dict(chunk_size=8, mode="adaptive", n_batches=N_MAX, pilot=PILOT,
           target_ci=0.5, safety=4.0, seed=11, **CPU)


@pytest.fixture(scope="module")
def adaptive_run():
    return campaign(_agrid(), keep_point_stats=True, **AKW)


@pytest.mark.parametrize("whole", [8, 24])
def test_uniform_adaptive_equals_pipelined_at_pilot(whole):
    """The fixed-allocation witness: an unreachable target keeps every
    point at the pilot, and the adaptive run equals a pipelined one at
    the pilot length, at two chunk sizes."""
    g = _agrid()
    a = campaign(g, chunk_size=8, mode="adaptive", n_batches=N_MAX,
                 pilot=PILOT, target_ci=1e9, seed=11, **CPU)
    b = campaign(g, chunk_size=whole, n_batches=PILOT, seed=11, **CPU)
    assert a.fingerprint() == b.fingerprint()
    assert a.pilot_jobs == int(b.totals["jobs"])
    assert a.simulated_jobs == 2 * b.totals["jobs"]


def test_adaptive_repeat_is_bitwise_identical(adaptive_run):
    again = campaign(_agrid(), keep_point_stats=True, **AKW)
    assert again.fingerprint() == adaptive_run.fingerprint()
    assert np.array_equal(again.point_stats["alloc"],
                          adaptive_run.point_stats["alloc"])


def test_adaptive_stop_and_resume_matches_uninterrupted(adaptive_run,
                                                        tmp_path):
    kw = dict(AKW, out_dir=str(tmp_path), checkpoint_every=1)
    part = campaign(_agrid(), stop_after_chunks=1, **kw)
    assert not part.completed
    full = campaign(_agrid(), resume=True, **kw)
    assert full.completed
    assert full.fingerprint() == adaptive_run.fingerprint()


def test_adaptive_refinement_tightens_the_pilot_max_ci(adaptive_run):
    """The capped 8× tier ladder buys about the CLT √8 ≈ 2.8×
    tightening of the largest half-width.  The ratio is a random
    quantity of the run — the pilot's half-widths come from two blocks
    each — so the port holds the reference's factor 0.5 on the mean of
    a five-seed ladder (seeds 11–15)."""
    ratios = []
    for seed in range(11, 16):
        r = adaptive_run if seed == 11 else campaign(
            _agrid(), keep_point_stats=True, **dict(AKW, seed=seed))
        pilot_max = float(np.nanmax(r.point_stats["pilot_ci"]))
        assert r.max_ci_halfwidth < pilot_max
        ratios.append(r.max_ci_halfwidth / pilot_max)
    assert np.mean(ratios) <= 0.5, ratios


def test_adaptive_precision_and_accounting(adaptive_run):
    alloc = adaptive_run.point_stats["alloc"]
    assert alloc.min() >= PILOT and alloc.max() <= N_MAX
    k = alloc // PILOT
    assert np.all((k & (k - 1)) == 0) and alloc.max() > PILOT
    assert adaptive_run.simulated_jobs == (adaptive_run.pilot_jobs
                                           + int(adaptive_run.acc["jobs"]))
    assert adaptive_run.pilot_jobs > 0
    assert np.all(np.isfinite(adaptive_run.point_stats["mean_latency"]))


def test_pipelined_max_ci_matches_the_sweep_halfwidths():
    g = _agrid()
    r = campaign(g, chunk_size=8, n_batches=PILOT, seed=11, **CPU)
    direct = sweep(g, n_batches=PILOT, seed=11, **CPU)
    assert r.max_ci_halfwidth == float(np.nanmax(np.nan_to_num(
        direct.ci_halfwidth)))


def test_adaptive_guards():
    g = _agrid()
    with pytest.raises(ValueError, match="adaptive"):
        campaign(g, chunk_size=8, n_batches=64, target_ci=0.5, **CPU)
    for extra in (dict(), dict(target_ci=0.5, refine_budget=100)):
        with pytest.raises(ValueError, match="exactly one"):
            campaign(g, chunk_size=8, mode="adaptive", n_batches=64,
                     pilot=32, **extra, **CPU)
    with pytest.raises(ValueError, match="metrics_tap"):
        campaign(g, chunk_size=8, mode="adaptive", n_batches=64, pilot=32,
                 target_ci=0.5, metrics_tap=lambda *a: None, **CPU)
    with pytest.raises(ValueError, match="pilot"):
        campaign(g, chunk_size=8, mode="adaptive", n_batches=64, pilot=128,
                 target_ci=0.5, **CPU)


def test_operating_points_equal_the_reference():
    lam = [1.0, 2.0, 3.0, 1.0, 2.0, 3.0]
    kw = dict(b_max=[4, 4, 4, 16, 16, 16], dist="det")
    g, rg = (SweepGrid.from_points(lam, ALPHA, TAU0, **kw),
             RefGrid.from_points(lam, ALPHA, TAU0, **kw))
    lat = np.array([3.0, 6.0, 12.0, np.nan, 4.0, 8.0])
    hw = np.array([0.0, 1.0, 0.0, np.nan, 0.0, 0.0])
    for slo in (1.0, 6.5, 20.0):
        assert operating_points(g, lat, slo=slo, ci_halfwidth=hw) == \
            ref_campaign.operating_points(rg, lat, slo=slo,
                                          ci_halfwidth=hw)
    with pytest.raises(ValueError, match="entries"):
        operating_points(g, np.zeros(3), slo=1.0)


# ---------------------------------------------------------------------------
# against the reference, statistically and through its host fold
# ---------------------------------------------------------------------------

def _stat_grid(cls, n=24):
    fr = np.linspace(0.3, 0.8, n, dtype=np.float32)
    b = np.where(np.arange(n) % 2 == 0, 4, 8).astype(np.int32)
    lam = fr * b / (ALPHA * b + TAU0)
    return cls.from_points(lam, ALPHA, TAU0, b_max=b, dist="det")


def test_pipelined_agrees_with_the_reference_serial_campaign():
    """Aggregate E[W] and utilisation: the reference's serial campaign
    (one chunk, one compile) against the mean of a six-seed ladder of
    the port's pipelined campaign, within 3 standard errors of the
    difference (the ladder's spread, scaled by √(1 + 1/6))."""
    kw = dict(chunk_size=24, n_batches=512)
    ref = ref_campaign.campaign(_stat_grid(RefGrid), mode="serial", seed=5,
                                **kw)
    ladder = [campaign(_stat_grid(SweepGrid), seed=s, **kw, **CPU)
              for s in range(6)]
    for f in ("mean_latency", "mean_utilization"):
        xs = np.array([getattr(r, f) for r in ladder])
        se = xs.std(ddof=1) * np.sqrt(1 + 1 / len(xs))
        assert abs(xs.mean() - getattr(ref, f)) <= 3 * se, (f, xs,
                                                            getattr(ref, f))
    assert ref.totals["points"] == ladder[0].totals["points"] == 24


def test_reference_host_fold_on_the_port_results_equals_the_port():
    """The reference ``_host_fold`` applied to the port's per-point
    sweep results, chunk by chunk, equals the port's ``_host_fold``:
    integer fields equal, float sums within rounding (1e-12 rel)."""
    g = _loss_grid(24)
    caps = pt_campaign._kind_fns("sweep")[1](g)
    ref_acc = ref_campaign._init_acc(512, 8)
    pt_acc = pt_campaign._init_acc(512, 8)
    for start in (0, 8, 16):
        r = sweep(g.take(np.arange(start, start + 8)), n_batches=64, seed=2,
                  key_offset=start, **caps, **CPU)
        ref_campaign._host_fold(ref_acc, r, start, 8, 8)
        pt_campaign._host_fold(pt_acc, r, start, 8, 8)
    for k in ref_acc:
        if ref_acc[k].dtype == np.int64:
            assert np.array_equal(ref_acc[k], pt_acc[k]), k
        else:
            np.testing.assert_allclose(pt_acc[k], ref_acc[k], rtol=1e-12,
                                       err_msg=k)
    assert int(pt_acc["points"]) == 24


def test_serial_campaign_past_256_top_k_slots_equals_the_reference():
    """``k_top`` 257, past the 256 slots the card's fold once refused
    (ROADMAP C-P4), in the reference's serial mode (the one that runs
    on this host, C-R1) and the port's: the fields the grid decides
    equal (points, batches, the loss-free goodput list bitwise, every
    point in the latency list, the padding), and the reference's
    ``_host_fold`` over the port's own chunk results at ``k_top`` 257
    equal to the port's accumulator (integers exact, float sums 1e-12
    rel)."""
    n, k = 40, 257
    kw = dict(chunk_size=16, n_batches=64, seed=5, k_top=k, mode="serial")
    ref = ref_campaign.campaign(_stat_grid(RefGrid, n), **kw)
    got = campaign(_stat_grid(SweepGrid, n), **kw, **CPU)
    for key in ("points", "batches", "quarantined_points", "top_good_val",
                "top_good_idx"):
        assert np.array_equal(np.asarray(ref.acc[key]),
                              np.asarray(got.acc[key])), key
    for acc in (ref.acc, got.acc):
        assert acc["top_lat_val"].shape == acc["top_lat_idx"].shape == (k,)
        assert sorted(acc["top_lat_idx"][:n]) == list(range(n))
        assert (acc["top_lat_idx"][n:] == -1).all()
        assert np.isneginf(acc["top_lat_val"][n:]).all()
    g = _stat_grid(SweepGrid, n)
    caps_fn = pt_campaign._kind_fns("sweep")[1]
    fold = ref_campaign._init_acc(512, k)
    for start in range(0, n, 16):
        cgrid, n_valid = pt_campaign._chunk_grid(g, start, 16, n)
        r = sweep(cgrid, key_offset=start, n_batches=64, seed=5,
                  **caps_fn(cgrid), **CPU)
        ref_campaign._host_fold(fold, r, start, n_valid, k)
    for key in fold:
        if fold[key].dtype == np.int64:
            assert np.array_equal(fold[key], got.acc[key]), key
        else:
            np.testing.assert_allclose(got.acc[key], fold[key], rtol=1e-12,
                                       err_msg=key)


# ---------------------------------------------------------------------------
# the plan split
# ---------------------------------------------------------------------------

def _same_result(a, b):
    for f in ("mean_latency", "hist", "n_jobs", "utilization", "mean_batch",
              "latency_p99", "ci_halfwidth", "buffer_dropped", "n_in_slo"):
        assert np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True), f


@pytest.mark.parametrize("which", ["sweep", "gen", "fleet"])
def test_sweeps_equal_plan_run_result(which):
    if which == "sweep":
        g, entry, plan_fn, to_result = (_loss_grid(12), sweep, sweep_plan,
                                        sweep_result)
        kw = dict(n_batches=64, seed=4, sketch=True)
    elif which == "gen":
        g = GenGrid.from_points(np.linspace(0.05, 0.3, 6, dtype=np.float32),
                                0.02, 0.5, 0.01, 2.0, prompt_len=32,
                                gen_tokens=8, max_active=16, q_max=8)
        entry, plan_fn, to_result = gen_sweep, gen_plan, gen_result
        kw = dict(n_steps=64, seed=4)
    else:
        g = FleetGrid.from_points(np.float32([1.0, 2.0, 4.0]), ALPHA, TAU0,
                                  k=[1, 2, 4], b_max=8)
        entry, plan_fn, to_result = fleet_sweep, fleet_plan, fleet_result
        kw = dict(n_steps=64, seed=4)
    plan = plan_fn(g, **kw, **CPU)
    out = engine.dispatch_device(plan.kernel, plan.params, plan.keys)
    assert all(isinstance(v, torch.Tensor) for k, v in out.items()
               if k != "_limits")
    assert ("_limits" in out) == (which == "gen")
    _same_result(entry(g, **kw, **CPU),
                 to_result(g, engine.host_outputs(out), sketch=plan.sketch))
