"""The order of the campaign fold's two passes (``csrc/campaign_fold.cu``)
on the CPU, bit for bit.

The kernel no longer walks the chunk in one block: a wide pass prepares
every row (its folded flag, the four float64 terms, the two top-K
candidates, the half-width; the integer counters summed per block;
max_ci combined per 64-row block by a shuffle tree over neighbouring
lanes), and an ordered tail adds the prepared terms in point order and
walks each top-K list with a ballot over 32 rows: a row is a candidate
when it is folded and beats the list's running minimum, the candidates
are taken in order, each re-checked against the minimum, and after a
replacement the first minimal slot is found again by a shuffle
reduction over 32 lanes with ties to the lowest slot.

A test-local emulation of exactly that order (numpy float64, whose
operations round to nearest like the kernel's ``__d*_rn`` intrinsics)
is held bitwise against ``campaign_fold_plain`` (the sequential fold)
and, at a few shapes, against the reference's ``_build_fold`` under
``jax.enable_x64``: ties, NaN and inf points, padded tails, ``n_valid``
0, every latency and rate tied, ``k_top`` in {1, 4, 16, 256, 257, 1,024}
(lists in shared memory) and 2,048 (past the 1,908 slots the kernel
keeps there: walked in the accumulator's own slots, in the same order),
two chunks in a row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import campaign as ref_campaign
from repro_torch.core import campaign as pt_campaign
from repro_torch.kernels.campaign_fold import (ACC_F64, ACC_INT, LOSS_KEYS,
                                               Z95, FoldAcc,
                                               campaign_fold_plain)

ROWS = 64          # rows a block of the wide pass
LANES = 32


def _chunk(rng, m, n_bins, has_loss, sketch, kind):
    c = {"hist": rng.integers(0, 50, (m, n_bins)).astype(np.int32),
         "n_jobs": rng.integers(0, 1000, m).astype(np.int32),
         "batches": rng.integers(0, 100, m).astype(np.int32),
         "dropped": rng.integers(0, 3, m).astype(np.int32),
         "mean_latency": rng.lognormal(1.0, 1.0, m).astype(np.float32),
         "utilization": rng.uniform(0, 1, m).astype(np.float32),
         "mean_batch": rng.uniform(1, 30, m).astype(np.float32),
         "lam": rng.uniform(0.1, 10, m).astype(np.float32),
         "lat_bm_m2": rng.exponential(3.0, m).astype(np.float32),
         "lat_bm_n": rng.integers(0, 40, m).astype(np.int32)}
    c["mean_latency"][::5] = c["mean_latency"][0]
    c["lam"][1::7] = c["lam"][min(1, m - 1)]
    if kind == "tied":
        # every latency and every rate equal: the first minimal slot
        # decides every replacement, and only the first entries enter
        c["mean_latency"][:] = 3.0
        c["lam"][:] = 2.0
    if sketch:
        c["hist_sums"] = (c["hist"] * rng.lognormal(0, 1, (m, n_bins))
                          ).astype(np.float32)
    if has_loss:
        for k in LOSS_KEYS:
            c[k] = rng.integers(0, 200, m).astype(np.int32)
        c["n_jobs"][3 % m] = c["overflow_dropped"][3 % m] = 0
        c["abandoned"][3 % m] = 0
        if kind == "tied":
            c["n_in_slo"][:] = 0
    if kind == "poison":
        c["mean_latency"][2 % m] = np.nan
        c["utilization"][m // 2] = np.inf
        c["lat_bm_m2"][m - 2] = np.nan
        if sketch:
            c["hist_sums"][m - 3, 3] = np.nan
    return c


# ------------------------------------------------------------ emulation

def _max_after(x, c):
    """max_ci's order-kept maximum: x, then c."""
    return c if (not np.isnan(x) and (np.isnan(c) or c > x)) else x


def _block_max(ci):
    """One 64-row block's max_ci as the kernel forms it: in each warp
    ``shfl_down`` by 1, 2, 4, 8, 16 (lane l takes lane l + off, its own
    value past the warp), lane 0's value; then warp 0's, warp 1's."""
    out = []
    for w0 in range(0, ROWS, LANES):
        v = list(ci[w0:w0 + LANES])
        for off in (1, 2, 4, 8, 16):
            v = [_max_after(v[l], v[l + off] if l + off < LANES else v[l])
                 for l in range(LANES)]
        out.append(v[0])
    return _max_after(out[0], out[1])


def _first_min(vals, k):
    """The first minimal slot of vals[0, k) and its value, as the tail's
    warp finds it: each lane's slots ascending (a strictly smaller value
    replaces: the lane keeps its first minimum, numpy's ``argmin``, the
    values never NaN), then ``shfl_down`` by 16, 8, 4, 2, 1 on (value,
    slot) with ties to the lower slot."""
    best = [0.0] * LANES
    bi = [-1] * LANES
    arr = np.asarray(vals[:k], np.float64)
    for lane in range(min(LANES, k)):
        j = int(np.argmin(arr[lane::LANES]))
        best[lane], bi[lane] = float(arr[lane + LANES * j]), lane + LANES * j
    for off in (16, 8, 4, 2, 1):
        nb, ni = list(best), list(bi)
        for lane in range(LANES):
            src = lane + off if lane + off < LANES else lane
            ob, oi = best[src], bi[src]
            if oi >= 0 and (bi[lane] < 0 or ob < best[lane]
                            or (ob == best[lane] and oi < bi[lane])):
                nb[lane], ni[lane] = ob, oi
        best, bi = nb, ni
    return bi[0], best[0]


def emulate(acc, c, gidx, n_valid, has_loss, sketch):
    """The two passes on a reference-layout numpy accumulator ``acc``
    (updated in place); returns the chunk's summary."""
    f64, i64 = np.float64, np.int64
    m = len(c["mean_latency"])
    k = len(acc["top_lat_val"])
    # the wide pass: every row at once
    valid = np.arange(m) < n_valid
    lat, util, batch, lam, m2 = (c[key].astype(f64) for key in (
        "mean_latency", "utilization", "mean_batch", "lam", "lat_bm_m2"))
    fin = (np.isfinite(lat) & np.isfinite(util) & np.isfinite(batch)
           & np.isfinite(lam) & np.isfinite(m2))
    if sketch:
        fin &= np.isfinite(c["hist_sums"]).all(1)
    ok = valid & fin
    wf = ok.astype(f64)
    jobs = c["n_jobs"].astype(i64)
    with np.errstate(invalid="ignore"):
        lat_s, util_s, batch_s = (np.where(ok, x, 0.0)
                                  for x in (lat, util, batch))
        terms = [lat_s * jobs.astype(f64) * wf, lat_s * wf, util_s * wf,
                 batch_s * wf]
        gfrac = np.ones(m)
        if has_loss:
            offered = (jobs + c["overflow_dropped"].astype(i64)
                       + c["abandoned"].astype(i64))
            pos = offered > 0
            gfrac[pos] = (c["n_in_slo"].astype(f64)[pos]
                          / np.maximum(offered[pos], 1).astype(f64))
        vgood = lam * gfrac
        nbk = c["lat_bm_n"].astype(f64)
        ci = Z95 * np.sqrt(m2 / np.maximum(nbk - 1.0, 1.0)
                           / np.maximum(nbk, 1.0))
    ci = np.where(ok & (nbk >= 2.0), ci, 0.0)
    w = ok.astype(i64)
    counters = {"points": w.sum(), "jobs": (jobs * w).sum(),
                "batches": (c["batches"].astype(i64) * w).sum(),
                "buffer_dropped": (c["dropped"].astype(i64) * w).sum(),
                "quarantined_points": (valid & ~fin).astype(i64).sum()}
    if has_loss:
        for key in LOSS_KEYS:
            counters[key] = (c[key].astype(i64) * w).sum()
    else:
        counters["n_in_slo"] = counters["n_fresh"] = counters["jobs"]
    for key in ACC_INT:
        acc[key] = acc[key] + counters.get(key, 0)
    acc["hist"] = acc["hist"] + (c["hist"].astype(i64) * w[:, None]).sum(0)
    padded = -(-m // ROWS) * ROWS
    ci_pad = np.concatenate([ci, np.full(padded - m, -np.inf)])
    bmax = [_block_max(ci_pad[b0:b0 + ROWS])
            for b0 in range(0, padded, ROWS)]

    # the ordered tail
    sums = [float(acc[key]) for key in ACC_F64]
    for i in range(m):
        sums = [s + float(t[i]) for s, t in zip(sums, terms)]
    for key, s in zip(ACC_F64, sums):
        acc[key] = np.float64(s)
    mx = float(acc["max_ci"])
    for b in bmax:
        mx = _max_after(mx, b)
    acc["max_ci"] = np.float64(mx)
    if sketch:
        hs = np.where(ok[:, None], c["hist_sums"].astype(f64), 0.0)
        col = acc["hist_sums"].copy()
        for i in range(m):
            col = col + hs[i]
        acc["hist_sums"] = col
    for name, v in (("lat", lat_s), ("good", vgood)):
        vals = [float(x) for x in acc[f"top_{name}_val"]]
        idxs = [int(x) for x in acc[f"top_{name}_idx"]]
        am, cur = _first_min(vals, k)
        for r0 in range(0, m, LANES):
            cand = [r for r in range(r0, min(m, r0 + LANES))
                    if ok[r] and v[r] > cur]
            for r in cand:
                if v[r] > cur:
                    vals[am], idxs[am] = float(v[r]), int(gidx[r])
                    am, cur = _first_min(vals, k)
        acc[f"top_{name}_val"] = np.asarray(vals, f64)
        acc[f"top_{name}_idx"] = np.asarray(idxs, i64)
    summary = [counters["points"], counters["jobs"],
               counters["buffer_dropped"], counters["quarantined_points"]]
    if has_loss:
        summary += [counters["overflow_dropped"], counters["abandoned"]]
    return [int(s) for s in summary]


# ---------------------------------------------------------------- tests

def _same(a, b) -> bool:
    """Bitwise equality of two reference-layout accumulators."""
    assert set(a) == set(b)
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        if x.dtype.kind == "f":
            x, y = x.view(np.int64), y.astype(np.float64).view(np.int64)
        if not np.array_equal(x, y):
            return False
    return True


# (m, n_valid, k_top, n_bins, has_loss, sketch, kind)
CASES = {
    "ties_k4": (100, 100, 4, 32, False, False, "plain"),
    "poison_loss_tail": (150, 131, 16, 32, True, False, "poison"),
    "sketch_poison": (97, 97, 4, 16, False, True, "poison"),
    "sketch_loss_tail": (70, 41, 16, 16, True, True, "plain"),
    "n_valid_0": (64, 0, 16, 8, True, False, "plain"),
    "tied": (300, 300, 16, 8, True, False, "tied"),
    "tied_k1": (90, 90, 1, 8, False, False, "tied"),
    "k1": (130, 120, 1, 8, False, False, "plain"),
    "k256": (600, 600, 256, 8, False, False, "plain"),
    "k256_loss": (333, 300, 256, 8, True, False, "poison"),
    "k257": (300, 290, 257, 8, True, False, "plain"),
    "k257_tied": (300, 300, 257, 8, False, False, "tied"),
    "k1024": (600, 600, 1024, 8, True, False, "poison"),
    "k2048_global": (1100, 1090, 2048, 8, False, True, "plain"),
    "one_row": (1, 1, 4, 8, False, False, "plain"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_two_passes_equal_the_sequential_fold(name):
    """Two chunks in a row into one accumulator: the emulated passes
    bitwise equal to ``campaign_fold_plain``, summaries included."""
    m, n_valid, k, n_bins, has_loss, sketch, kind = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name) + 1)
    acc = pt_campaign._init_acc(n_bins, k)
    plain = FoldAcc.from_host(acc, "cpu")
    for j in range(2):
        c = _chunk(rng, m, n_bins, has_loss, sketch, kind)
        gidx = np.arange(j * m, (j + 1) * m, dtype=np.int64)
        got = emulate(acc, c, gidx, n_valid, has_loss, sketch)
        want = campaign_fold_plain(
            plain, {key: torch.as_tensor(v) for key, v in c.items()},
            torch.as_tensor(gidx), n_valid, has_loss=has_loss, sketch=sketch)
        assert got == want.tolist()
        assert _same(acc, plain.to_host()), f"chunk {j}"
    if kind == "poison" and n_valid:
        assert int(acc["quarantined_points"]) > 0
    if kind == "tied":
        # only the first chunk's first k points entered, in order
        assert acc["top_lat_idx"].tolist() == list(range(k))


@pytest.mark.parametrize("name", ["poison_loss_tail", "sketch_poison",
                                  "tied", "k256_loss", "k257"])
def test_two_passes_equal_the_reference_fold(name):
    """At a few shapes, against the reference's jitted fold
    (``repro.core.campaign._build_fold`` under ``jax.enable_x64``), two
    chunks in a row."""
    m, n_valid, k, n_bins, has_loss, sketch, kind = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name) + 101)
    acc = pt_campaign._init_acc(n_bins, k)
    with jax.enable_x64(True):
        fold = ref_campaign._build_fold(m, n_bins, k, has_loss, sketch,
                                        True, False)
        ref = {key: jnp.asarray(v)
               for key, v in ref_campaign._init_acc(n_bins, k).items()}
        for j in range(2):
            c = _chunk(rng, m, n_bins, has_loss, sketch, kind)
            gidx = np.arange(j * m, (j + 1) * m, dtype=np.int64)
            got = emulate(acc, c, gidx, n_valid, has_loss, sketch)
            ref, want = fold(ref, {key: jnp.asarray(v)
                                   for key, v in c.items()},
                             gidx, np.int64(n_valid))
            keys = ("points", "jobs", "buffer_dropped", "quarantined")
            keys += ("overflow_dropped", "abandoned") if has_loss else ()
            assert got == [int(want[key]) for key in keys]
        ref = {key: np.asarray(v) for key, v in ref.items()}
    assert _same(acc, ref)


def test_block_max_keeps_the_first_maximum_and_the_first_nan():
    """The shuffle tree over neighbours is the sequential order-kept
    maximum: ties keep the earlier value (−0.0 before 0.0 stays −0.0),
    the first NaN wins once one comes, and rows past the chunk (−inf)
    never do."""
    rng = np.random.default_rng(5)
    for trial in range(50):
        ci = rng.choice([0.0, -0.0, 1.5, 2.5, np.nan, -np.inf], ROWS)
        if trial % 3 == 0:
            ci[ci != ci] = 0.0
        want = ci[0]
        for x in ci[1:]:
            want = _max_after(want, x)
        got = _block_max(ci)
        assert np.array_equal(np.float64(got).view(np.int64),
                              np.float64(want).view(np.int64))
