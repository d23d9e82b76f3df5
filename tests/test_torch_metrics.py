"""The port's metrics tap (``repro_torch.core.metrics``).

- The host read against the reference's callback: the reference
  ``MetricsTap._record`` fed lane by lane in lane order and the port's
  ``tap_superstep`` fed the same per-lane tensors write equal JSONL
  records on every field but the host clock's (``wall_s``,
  ``jobs_per_sec``).
- ``tests/test_metrics.py``'s checks against the port's tap on its own
  sweeps: the tap's aggregation, flush order, Prometheus text and
  summary; a tapped sweep, fleet and generate run bitwise equal to the
  untapped one, one ``superstep`` record a superstep, the final
  ``jobs_total`` equal to the result's ``n_jobs.sum()``.
"""
import json

import numpy as np
import pytest
import torch

from repro.core.metrics import MetricsTap as RefTap
from repro_torch.core.fleet import fleet_sweep
from repro_torch.core.gen_sweep import gen_sweep
from repro_torch.core.grid import FleetGrid, GenGrid, SweepGrid
from repro_torch.core.metrics import FIELDS, MetricsTap, tap_superstep
from repro_torch.core.sweep import sweep

CPU = dict(device="cpu")
ALPHA, TAU0 = 0.1438, 1.8874
SUPERSTEP_KEYS = {
    "type", "step", "lanes", "queue_depth_mean", "jobs_total",
    "occupancy", "dropped_total", "overflow_total", "abandoned_total",
    "wall_s", "jobs_per_sec", "label",
}
CLOCK = ("wall_s", "jobs_per_sec")


def _lanes(rng, p):
    return {"queue": torch.as_tensor(rng.integers(0, 40, p),
                                     dtype=torch.int32),
            "jobs": torch.as_tensor(rng.integers(0, 10**6, p),
                                    dtype=torch.int32),
            "busy": torch.as_tensor(rng.uniform(0, 1e4, p),
                                    dtype=torch.float32),
            "span": torch.as_tensor(rng.uniform(1e4, 2e4, p),
                                    dtype=torch.float32),
            "dropped": torch.as_tensor(rng.integers(0, 3, p),
                                       dtype=torch.int32),
            "overflow": torch.as_tensor(rng.integers(0, 90, p),
                                        dtype=torch.int32),
            "abandoned": torch.as_tensor(rng.integers(0, 90, p),
                                         dtype=torch.int32)}


@pytest.mark.parametrize("lossy", [False, True])
def test_host_read_equals_the_reference_callback(tmp_path, lossy):
    rng = np.random.default_rng(5)
    p = 37
    steps = [_lanes(rng, p) for _ in range(3)]
    with RefTap(tmp_path / "ref.jsonl", label="x",
                expected_points=p) as ref:
        for s, vals in enumerate(steps):
            for lane in range(p):
                args = [vals[f][lane].item() if (lossy or f not in
                        ("overflow", "abandoned")) else 0 for f in FIELDS]
                ref._record(s, *args)
    with MetricsTap(tmp_path / "pt.jsonl", label="x",
                    expected_points=p) as tap:
        for s, vals in enumerate(steps):
            if not lossy:
                vals = {k: v for k, v in vals.items()
                        if k not in ("overflow", "abandoned")}
            tap_superstep(tap, s, **vals)
    want = [json.loads(x) for x in
            (tmp_path / "ref.jsonl").read_text().splitlines()]
    got = [json.loads(x) for x in
           (tmp_path / "pt.jsonl").read_text().splitlines()]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) == SUPERSTEP_KEYS
        assert {k: v for k, v in g.items() if k not in CLOCK} == \
            {k: v for k, v in w.items() if k not in CLOCK}
    assert tap.records == ref.records == 3 * p


# ---------------------------------------------------------------------------
# tests/test_metrics.py's unit checks, on the port's tap
# ---------------------------------------------------------------------------

def test_aggregates_and_flushes_per_superstep(tmp_path):
    jsonl = tmp_path / "m.jsonl"
    with MetricsTap(jsonl, label="unit", expected_points=2) as tap:
        for lane_jobs in (10, 30):
            tap._record(0, 4.0, lane_jobs, 1.0, 2.0, 0, 0, 0)
        for lane_jobs in (20, 60):
            tap._record(1, 6.0, lane_jobs, 3.0, 4.0, 1, 2, 3)
    r0, r1 = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert set(r0) == SUPERSTEP_KEYS
    assert (r0["step"], r0["lanes"], r0["jobs_total"]) == (0, 2, 40)
    assert r0["queue_depth_mean"] == pytest.approx(4.0)
    assert r0["occupancy"] == pytest.approx(0.5)
    assert r0["jobs_per_sec"] is None
    assert r1["jobs_total"] == 80
    assert (r1["dropped_total"], r1["overflow_total"],
            r1["abandoned_total"]) == (2, 4, 6)


def test_close_flushes_stragglers_in_order(tmp_path):
    jsonl = tmp_path / "m.jsonl"
    tap = MetricsTap(jsonl, label="unit")
    for step, jobs in ((2, 5), (0, 1), (1, 3)):
        tap._record(step, 1.0, jobs, 1.0, 1.0, 0, 0, 0)
    assert jsonl.read_text() == ""
    tap.close()
    tap.close()
    assert [json.loads(line)["step"]
            for line in jsonl.read_text().splitlines()] == [0, 1, 2]


def test_prometheus_text_rewritten_atomically(tmp_path):
    prom = tmp_path / "m.prom"
    with MetricsTap(prom_path=prom, label="p", expected_points=1) as tap:
        tap._record(0, 2.0, 7, 1.0, 2.0, 1, 0, 0)
        text = prom.read_text()
    for line in ('repro_supersteps_total{label="p"} 1',
                 'repro_jobs_total{label="p"} 7',
                 'repro_dropped_total{label="p"} 1'):
        assert line in text
    for name in ("repro_queue_depth_mean", "repro_occupancy",
                 "repro_jobs_per_sec"):
        assert f'{name}{{label="p"}}' in text
    assert not list(tmp_path.glob("*.tmp"))


def test_summary_records_and_snapshot(tmp_path):
    jsonl = tmp_path / "m.jsonl"
    with MetricsTap(jsonl, label="s") as tap:
        tap.observe_summary(kind="sweep", p50_median=float("nan"),
                            jobs_total=12)
    rec = json.loads(jsonl.read_text().splitlines()[0])
    assert (rec["type"], rec["label"], rec["p50_median"],
            rec["jobs_total"]) == ("summary", "s", None, 12)
    tap = MetricsTap(expected_points=1)
    tap._record(0, 1.0, 9, 1.0, 2.0, 0, 0, 0)
    s = tap.summary()
    assert (s["supersteps"], s["records"], s["pending"],
            s["jobs_total"]) == (1, 1, 0, 9)


def test_tap_superstep_none_is_a_noop_and_fields_keep_their_order():
    tap_superstep(None, 0, queue=torch.zeros(2))
    assert FIELDS == ("queue", "jobs", "busy", "span", "dropped",
                      "overflow", "abandoned")


# ---------------------------------------------------------------------------
# tapped runs of the three sweeps
# ---------------------------------------------------------------------------

def _run(which, tap):
    if which == "sweep":
        g = SweepGrid.from_product([1.0, 2.5], [ALPHA], [TAU0],
                                   b_maxes=(8,))
        kw = dict(n_batches=128, q_cap=64, seed=3, sketch=True)
        return g, sweep(g, metrics_tap=tap, **kw, **CPU), 128 // 32
    if which == "loss":
        g = SweepGrid.from_points([1.0, 2.5, 3.5], ALPHA, TAU0, b_max=8,
                                  q_max=[0, 6, 6], deadline=[0.0, 30.0, 0.0])
        return g, sweep(g, metrics_tap=tap, n_batches=96, seed=2,
                        **CPU), 96 // 32
    if which == "fleet":
        g = FleetGrid.from_points([1.0, 3.0], ALPHA, TAU0, k=[1, 2], b_max=8,
                                  q_max=[0, 10])
        return g, fleet_sweep(g, metrics_tap=tap, n_steps=96, seed=2,
                              **CPU), 96 // 32
    g = GenGrid.from_points([0.05, 0.2], 0.02, 0.5, 0.01, 2.0, prompt_len=32,
                            gen_tokens=8, max_active=16)
    return g, gen_sweep(g, metrics_tap=tap, n_steps=64, seed=2,
                        **CPU), 2048 // 16


@pytest.mark.parametrize("which", ["sweep", "loss", "fleet", "gen"])
def test_tapped_run_is_bitwise_the_untapped_one(tmp_path, which):
    d = tmp_path
    g, plain, supersteps = _run(which, None)
    with MetricsTap(d / "m.jsonl", d / "m.prom", label="e2e",
                    expected_points=len(g)) as tap:
        _, r, _ = _run(which, tap)
    for f in ("mean_latency", "n_jobs", "hist", "hist_sums", "latency_p99",
              "n_in_slo", "overflow_dropped", "abandoned", "utilization"):
        a, b = getattr(plain, f), getattr(r, f)
        assert (a is None and b is None) or np.array_equal(a, b), f
    recs = [json.loads(line)
            for line in (d / "m.jsonl").read_text().splitlines()]
    steps = [x for x in recs if x["type"] == "superstep"]
    assert [x["step"] for x in steps] == list(range(supersteps))
    assert all(x["lanes"] == len(g) for x in steps)
    assert all(set(x) == SUPERSTEP_KEYS for x in steps)
    assert tap.records == supersteps * len(g)
    assert steps[-1]["jobs_total"] == int(r.n_jobs.sum())
    assert all(b["jobs_total"] >= a["jobs_total"]
               for a, b in zip(steps, steps[1:]))
    if which == "loss":
        assert steps[-1]["overflow_total"] == int(r.overflow_dropped.sum())
        assert steps[-1]["abandoned_total"] == int(r.abandoned.sum())
    summaries = [x for x in recs if x["type"] == "summary"]
    assert len(summaries) == 1
    assert summaries[0]["kind"] == {"loss": "sweep"}.get(which, which)
    assert summaries[0]["points"] == len(g)
    assert summaries[0]["jobs_total"] == int(r.n_jobs.sum())
    for k in ("p50_median", "p95_median", "p99_median"):
        assert k in summaries[0]
    text = (d / "m.prom").read_text()
    assert f'repro_supersteps_total{{label="e2e"}} {supersteps}' in text
    assert f'repro_jobs_total{{label="e2e"}} {int(r.n_jobs.sum())}' in text
