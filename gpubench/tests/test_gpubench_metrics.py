"""The benchmark's arithmetic against hand-worked values: operations and
bytes, statistics and spreads, the trace's busy union and range
attribution, and each per-layer reader on a made-up window."""
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest

from gpubench.drivers import serve
from gpubench.lib import catalog, flops, peaks, stats, trace
from gpubench.tests import tiny


def test_causal_pairs_and_request_flops_by_hand():
    assert flops.causal_pairs(4) == 10
    c = tiny.config(tiny.DENSE)          # d 64, 4 heads over 2, d_ff 96
    d, hd, v = 64, 16, 97
    attn = d * (4 + 2 * 2) * hd + 4 * hd * d
    ffn = 3 * d * 96
    per_layer = 2 * (attn + ffn) * 12 + 4 * 4 * hd * flops.causal_pairs(12)
    assert flops.request_flops(c, 12) == 2 * per_layer + 2 * d * v
    # two decode steps: keys 13 and 14, two more unembeddings
    step = 2 * (attn + ffn)
    dec = 2 * (2 * step + 4 * 4 * hd * (13 + 14))
    assert flops.request_flops(c, 12, 2) == (2 * per_layer + dec
                                             + 3 * 2 * d * v)


def test_moe_request_flops_count_top_k_and_shared_experts():
    c = tiny.config(tiny.MOE)
    d, h, e, f = 64, 4, 8, 24
    moe_ffn = d * e + 3 * d * f * (3 + 2)
    dense_ffn = 3 * d * 96
    attn = d * h * 24 + d * 32 + d * 8 + 32 * h * 32 + h * 16 * d
    pair = 2 * (16 + 8 + 16)
    want = (2 * (attn + dense_ffn) * 5 + h * pair * 15
            + 2 * (2 * (attn + moe_ffn) * 5 + h * pair * 15) + 2 * d * 97)
    assert flops.request_flops(c, 5) == want


def test_kernel_bounds_by_hand():
    # B3: causal S 4, B 1, H 2 over KV 1, hd 8: 10 pairs a head
    t = flops.flash_bound_s((1, 4, 2, 8), (1, 4, 1, 8), (1, 4, 1, 8), 2,
                            True, 0)
    fl = 2 * 16 * 1 * 2 * 10
    nb = 2 * (4 * 2 * 8 + 4 * 8 + 4 * 8 + 4 * 2 * 8)
    assert t == max(fl / peaks.BF16_FLOPS, nb / peaks.HBM_BYTES_PER_S)
    m = flops.mla_decode_bound_s((2, 16, 512), 64, (2, 100, 512), 2, 50)
    nb = 2 * 576 * 2 * 50 + 4 * (2 * 16 * 512 * 2 + 2 * 16 * 64) + 8
    assert m == pytest.approx(nb / peaks.HBM_BYTES_PER_S)


def test_statistics_by_hand():
    assert stats.percentile(range(1, 101), 95) == pytest.approx(95.05)
    assert stats.merged([(5, 6), (0, 2), (1, 3), (5.5, 5.7)]) == [[0, 3],
                                                                 [5, 6]]


def _trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "gpubench.model_call",
         "ts": 0, "dur": 70},
        {"ph": "X", "cat": "user_annotation", "name": "gpubench.moe",
         "ts": 2, "dur": 6},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 30, "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 3, "dur": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 12, "dur": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k_moe", "ts": 10, "dur": 10,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k_mm", "ts": 15, "dur": 15,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k_mm", "ts": 50, "dur": 10,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "k_out", "ts": 95, "dur": 20,
         "args": {"correlation": 4}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.reduce(str(path), ("gpubench.moe",))


def test_trace_union_ranges_and_gaps(tmp_path):
    s = _trace(tmp_path)
    assert s.window_s == pytest.approx(100e-6)
    # [10, 30] ∪ [50, 60] ∪ [95, 100] (the last kernel clipped)
    assert s.busy_s == pytest.approx(35e-6)
    assert s.kernel_s == pytest.approx(40e-6)
    assert s.by_name["k_mm"] == pytest.approx(25e-6)
    assert s.in_range == {"gpubench.moe": pytest.approx(10e-6)}
    label, gap = s.gaps[0]
    assert gap == pytest.approx(35e-6) and label == "gpubench.model_call"
    assert s.gaps[1] == ("gpubench.model_call / aten::mm",
                         pytest.approx(20e-6))


def _window(traced_from=float("inf")):
    b = [serve.Batch([0, 1, 2], 4, 1.0, 2.0, True),
         serve.Batch([3], 1, 2.5, 3.0, True),
         serve.Batch([4, 5], 2, 4.0, 5.0, False)]
    due = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.5])
    start = np.array([1.0, 1.0, 1.0, 2.5, 4.0, 4.0])
    done = np.array([2.0, 2.0, 2.0, 3.0, 5.0, 5.0])
    return serve.Window(due, start, done, b, [0.001],
                        traced_from=traced_from)


def _ctx(tmp_path=None, traced_from=float("inf")):
    w = _window(traced_from)
    w.trace = _trace(tmp_path) if tmp_path is not None else None
    return serve.context({}, tiny.DENSE, dict(prompt_len=12), w, [
        ("attn", (1, 4, 2, 8), (1, 4, 1, 8), (1, 4, 1, 8), 2, True, 0)])


def _read(ctx):
    names = [p.stem for p in (catalog.HERE / "metrics").glob("*.py")
             if p.stem != "__init__"]
    return {n: catalog.metric(n).read(ctx) for n in names}


def test_readers_on_a_made_up_window(tmp_path):
    # the profiler started at 3.5 s: the host's records of the third
    # batch, which it slowed, are left out
    ctx = _ctx(tmp_path, traced_from=3.5)
    read = _read(ctx)
    assert read["queue_wait_ms"] == pytest.approx(
        np.mean([1.0, 0.5, 0.0, 1.0]) * 1e3)
    assert read["batch_fill_pct"] == pytest.approx(100 * 4 / 5)
    # the gap before the third batch is in the traced part: one counts
    assert read["host_gap_ms"] == pytest.approx(500.0)
    assert read["mfu_pct"] == pytest.approx(
        100 * 4 * ctx.request_flops / (1.5 * peaks.BF16_FLOPS))
    assert read["device_idle_pct"] == pytest.approx(65.0)
    assert read["moe_share_pct"] == pytest.approx(25.0)
    assert read["attn_roofline"] is None       # no attention range
    assert read["mla_decode_roofline"] is None
    # a metric's twin for the answering cells reads with the same file
    assert catalog.metric("queue_wait_ms.answer").read(ctx) == read[
        "queue_wait_ms"]


def test_host_readers_take_every_batch_of_an_untraced_window():
    read = _read(_ctx())
    assert read["queue_wait_ms"] == pytest.approx(
        np.mean([1.0, 0.5, 0.0, 1.0, 2.0, 0.5]) * 1e3)
    assert read["batch_fill_pct"] == pytest.approx(100 * 6 / 7)
    assert read["host_gap_ms"] == pytest.approx(np.mean([0.5, 1.0]) * 1e3)
    assert read["device_idle_pct"] is None


def test_end_to_end_metrics_by_hand():
    m = serve.end_to_end(_window(), 12.5)
    lat = [2.0, 1.5, 1.0, 1.5, 3.0, 1.5]
    assert m["latency_mean_ms"] == pytest.approx(np.mean(lat) * 1e3)
    assert m["latency_p95_ms"] == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert m["throughput_rps"] == pytest.approx(6 / 5.0)
    assert m["setup_s"] == 12.5
    answer = serve.end_to_end(_window(), 12.5, serve.ANSWER)
    assert answer == {("answer_" + k if k != "setup_s" else k): v
                      for k, v in m.items()}


@pytest.mark.parametrize("cfg,traffic,rows,want", [
    (tiny.DENSE, dict(prompt_len=1024), 32, 1),
    (tiny.MOE, dict(prompt_len=1024), 32, 2),
    (tiny.MOE, dict(prompt_len=1024), 1, 1),
    (tiny.MOE, dict(prompt_len=2048), 32, 1),
    (tiny.MOE, dict(prompt_len=2048, gen_tokens=16), 32, 32),
    (tiny.MOE, dict(prompt_len=3000), 4, 4),
])
def test_coupled_rows(cfg, traffic, rows, want):
    assert serve.coupled_rows(cfg, traffic, rows) == want


def test_sample_takes_the_fullest_unit_and_whole_groups():
    w = _window()
    got = serve.sample(w, tiny.MOE, dict(prompt_len=1024), 3, seed=5)
    rows = {id(b): r for b, r in got}
    assert rows[id(w.batches[0])] in ([0, 1], [0, 1, 2, 3])
    assert sum(sum(r < len(b.ids) for r in rr) for b, rr in got) >= 3
    again = serve.sample(w, tiny.MOE, dict(prompt_len=1024), 3, seed=5)
    assert [r for _, r in again] == [r for _, r in got]


def test_arrivals_keep_their_count_and_window():
    from gpubench.lib.traffic import arrival_times
    tr = tiny.traffic(rate=40.0)
    a = arrival_times(tr, 2 ** 33 + 1, 2.5)
    b = arrival_times(tr, 2 ** 33 + 2, 2.5)
    assert len(a) == len(b) == 100
    assert (np.diff(a) >= 0).all() and 0 <= a[0] and a[-1] < 2.5
    assert not np.array_equal(a, b)
    assert np.array_equal(a, arrival_times(tr, 2 ** 33 + 1, 2.5))
    assert math.isclose(a.mean(), 1.25, abs_tol=0.25)
