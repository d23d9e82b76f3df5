#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``src/repro_torch/kernels/csrc`` and
runs, in order, printing one JSON line per phase:

1. build     — compile ``hist_update.cu`` with nvcc; the card's name and
               power limit from nvidia-smi.
2. kernel    — the CUDA ``hist_update`` against its plain torch version
               at the sweep's user-size shapes (8,160 points, 32 × 768
               block; full 512-bin and 64-bin sketch modes): counts bit
               for bit, sums within rtol 1e-6; kernel, plain, library
               (one ``scatter_add_`` over precomputed bins) and bound
               times.
3. contracts — Threefry known-answer vectors on the card, and a split
               dispatch bitwise equal to the whole one.
4. main      — ``evaluate(SweepGrid.from_rhos([.1 … .9], V100),
               backend="sweep", n_batches=4000, q_cap=1024, seed=7)``:
               no buffer drops, mean latency at φ (ρ ≥ 0.3), Remark 5,
               one kernel launch per superstep.
5. user_size — the examples/sweep_grid.py grid at 8,192 requested
               points (8,160 run), n_batches=3000, q_cap=768, seed=0:
               no drops, the example's Theorem 2 / Remark 5 checks,
               wall time (first call and warm), jobs/s, peak memory,
               kernel launches.

Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and the last
line ``{"ok": true, "device": {...}}``.  Any failed check raises and the
script exits non-zero; without a CUDA device it exits non-zero before
any phase.  Imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import SweepGrid, evaluate, sweep, sweep_caps  # noqa: E402
from repro_torch.core.analytic import (mean_batch_lower, phi,  # noqa: E402
                                       stability_limit)
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.hist import bit_bins  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import superstep as ss  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
V100 = (0.1438, 1.8874)            # README's V100 (α, τ0)
SOURCE = "src/repro_torch/kernels/csrc/hist_update.cu"
REPLACES = "src/repro/kernels/superstep.py:105"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_build() -> str:
    t0 = time.perf_counter()
    _build.library("hist_update")
    smi = nvidia_smi()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=_build.build_seconds.get("hist_update"),
         flags=" ".join(_build.NVCC_FLAGS), nvidia_smi=smi)
    print(smi, flush=True)
    return smi


def phase_kernel(dev, sketch: bool, p: int = 8160, rows: int = 32,
                 width: int = 768) -> dict:
    """The CUDA kernel against its plain version on the same inputs."""
    n_bins = 64 if sketch else 512
    gen = torch.Generator(device=dev).manual_seed(1234 + sketch)
    lats = torch.empty(p, rows, width, device=dev).log_normal_(
        1.0, 1.5, generator=gen)
    inc = torch.rand(p, rows, width, device=dev, generator=gen) < 0.5
    counts0 = torch.randint(0, 1000, (p, n_bins), dtype=torch.int32,
                            device=dev, generator=gen)
    start = (counts0,)
    if sketch:
        start += (torch.rand(p, n_bins, device=dev, generator=gen) * 100,)
    got = tuple(t.clone() for t in start)
    want = tuple(t.clone() for t in start)
    ss.hist_update(got, lats, inc, n_bins=n_bins, backend="cuda",
                   sketch=sketch)
    ss.hist_update_plain(want, lats, inc, n_bins=n_bins, sketch=sketch)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]),
          f"hist_update counts bitwise equal (sketch={sketch})")
    err = float((got[0] - want[0]).abs().max())
    if sketch:
        check(torch.allclose(got[1], want[1], rtol=1e-6, atol=0.0),
              "hist_update sums within rtol 1e-6")
        err = max(err, float((got[1] - want[1]).abs().max()))

    scratch = tuple(t.clone() for t in start)
    kernel_ms = time_ms(lambda: ss.hist_update(
        scratch, lats, inc, n_bins=n_bins, backend="cuda", sketch=sketch))
    plain_ms = time_ms(lambda: ss.hist_update_plain(
        scratch, lats, inc, n_bins=n_bins, sketch=sketch))
    # library yardstick: one scatter_add_ of the counts over bins
    # computed beforehand (binning and the sums are not in it)
    bins = bit_bins(lats, n_bins, sketch).reshape(p, -1).long()
    ones = inc.reshape(p, -1).to(torch.int32)
    library_ms = time_ms(lambda: scratch[0].scatter_add_(1, bins, ones))
    del bins, ones
    n_inc = int(inc.sum())
    acc_bytes = 2 * p * n_bins * 4 * (2 if sketch else 1)
    bytes_moved = inc.numel() + 4 * n_inc + acc_bytes
    out = dict(sketch=sketch, points=p, block=[rows, width], n_bins=n_bins,
               included=n_inc, bytes=bytes_moved, kernel_ms=kernel_ms,
               plain_ms=plain_ms, library_ms=library_ms,
               library_note="scatter_add_ of counts over precomputed bins",
               bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
               max_abs_err=err, matches_plain=True)
    emit("kernel", **out)
    return out


def phase_contracts(dev) -> None:
    """Threefry's known answers and split-dispatch invariance, on the
    card."""
    kat = [((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
           ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
            (0xc4923a9c, 0x483df7a0))]
    for (k0, k1), (c0, c1), want in kat:
        args = [torch.from_numpy(np.array([v], np.uint32).view(np.int32))
                .to(dev) for v in (k0, k1, c0, c1)]
        got = [int(x.item()) & 0xFFFFFFFF for x in prng.threefry2x32(*args)]
        check(got == list(want), f"threefry known answer {want}")
    g = SweepGrid.from_points([2.0, 3.0, 1.5, 2.5], V100[0], V100[1],
                              b_max=[0, 16, 0, 32],
                              dist=["gamma", "exp", "det", "gamma"],
                              cv=[0.5, 0.5, 0.5, 1.3],
                              wait_max=[0.0, 2.0, 0.0, 1.0],
                              wait_target=[0, 8, 0, 4])
    kw = dict(n_batches=256, seed=11, device=dev, **sweep_caps(g))
    whole = sweep(g, **kw)
    a = sweep(g.take(slice(0, 1)), **kw)
    b = sweep(g.take(slice(1, None)), key_offset=1, **kw)
    for f in ("mean_latency", "mean_batch", "n_jobs", "hist",
              "max_queue", "stderr"):
        split = np.concatenate([getattr(a, f), getattr(b, f)])
        check(np.array_equal(getattr(whole, f), split, equal_nan=True),
              f"split dispatch bitwise equal to whole on {f}")
    emit("contracts", threefry_kat=True, split_bitwise=True)


def phase_main(dev, n_batches: int = 4000, q_cap: int = 1024) -> None:
    rhos = [0.1, 0.3, 0.5, 0.7, 0.9]
    grid = SweepGrid.from_rhos(rhos, *V100)
    ss.hist_update.launches = 0
    t0 = time.perf_counter()
    res = evaluate(grid, backend="sweep", n_batches=n_batches,
                   q_cap=q_cap, seed=7, device=dev)
    seconds = time.perf_counter() - t0
    launches = ss.hist_update.launches
    supersteps = -(-n_batches // 32)
    check(launches == supersteps,
          f"main path launched hist_update {launches} times, expected "
          f"one per superstep ({supersteps})")
    # the same call through sweep() for the buffer witness (and the
    # same bits: the run is deterministic)
    r = sweep(grid, n_batches=n_batches, q_cap=q_cap, seed=7, device=dev)
    check(int(r.buffer_dropped.sum()) == 0, "main path buffer_dropped == 0")
    check(np.array_equal(r.mean_latency,
                         [x.mean_latency for x in res]),
          "evaluate and sweep give the same bits")
    rows = []
    for rho, x in zip(rhos, res):
        bound = float(phi(x.lam, *V100))
        eb_lo = float(mean_batch_lower(x.lam, *V100))
        check(np.isfinite(x.mean_latency) and x.n_jobs > 0,
              f"finite result at rho={rho}")
        if rho >= 0.3:
            tol = max(3.0 * x.ci_halfwidth, 0.04 * bound)
            check(abs(x.mean_latency - bound) <= tol,
                  f"rho={rho}: E[W]={x.mean_latency} within {tol} of "
                  f"phi={bound}")
        check(x.mean_batch >= 0.93 * eb_lo,
              f"rho={rho}: Remark 5 E[B]={x.mean_batch} >= 0.93*{eb_lo}")
        rows.append(dict(rho=rho, mean_latency=x.mean_latency, phi=bound,
                         ci_halfwidth=x.ci_halfwidth,
                         mean_batch=x.mean_batch, eb_lower=eb_lo,
                         p99=x.latency_p99))
    emit("main", seconds=seconds, launches=launches,
         supersteps=supersteps, points=rows)


def build_grid(target_points: int) -> SweepGrid:
    """examples/sweep_grid.py's grid: (load-fraction × α × τ0 × b_max),
    λ scaled to each point's own stability limit."""
    n_frac = max(8, target_points // (5 * 4 * 3))
    fracs = np.linspace(0.10, 0.85, n_frac)
    alphas = np.array([0.10, 0.1438, 0.25, 0.40, 0.5833])
    tau0s = np.array([0.75, 1.4284, 1.8874, 3.0])
    b_maxes = np.array([0, 32, 128])
    f, a, t, b = [x.reshape(-1) for x in
                  np.meshgrid(fracs, alphas, tau0s, b_maxes, indexing="ij")]
    lims = np.array([stability_limit(ai, ti, bi if bi > 0 else np.inf)
                     for ai, ti, bi in zip(a, t, b)])
    return SweepGrid.from_points(f * lims, a, t, b_max=b.astype(int))


def phase_user_size(dev, target_points: int = 8192, n_batches: int = 3000,
                    q_cap: int = 768) -> int:
    grid = build_grid(target_points)
    kw = dict(n_batches=n_batches, q_cap=q_cap, seed=0, device=dev)
    ss.hist_update.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = sweep(grid, **kw)
    first_s = time.perf_counter() - t0
    launches = ss.hist_update.launches
    supersteps = -(-n_batches // 32)
    check(launches == supersteps,
          f"user-size sweep launched hist_update {launches} times, "
          f"expected {supersteps}")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    r2 = sweep(grid, **kw)
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    check(np.array_equal(r.hist, r2.hist)
          and np.array_equal(r.mean_latency, r2.mean_latency),
          "two user-size runs give the same bits")
    check(int(r.buffer_dropped.sum()) == 0, "user-size buffer_dropped == 0")
    inf_mask = grid.b_max == 0
    bounds = phi(grid.lam[inf_mask], grid.alpha[inf_mask],
                 grid.tau0[inf_mask])
    excess = r.mean_latency[inf_mask] / bounds - 1.0
    tol = 0.05 * math.sqrt(3000 / n_batches)
    frac_ok = float((excess < tol).mean())
    check(excess.mean() < 0.01 and frac_ok >= 0.95,
          f"Theorem 2: mean excess {excess.mean():+.4%}, {frac_ok:.1%} "
          f"within phi*(1+{tol:.0%})")
    eb_def = float((r.mean_batch / mean_batch_lower(
        grid.lam, grid.alpha, grid.tau0) - 1.0).min())
    tol_eb = 0.12 * math.sqrt(3000 / n_batches)
    check(eb_def > -tol_eb, f"Remark 5: min E[B]/bound - 1 = {eb_def}")
    jobs = int(r.n_jobs.sum())
    emit("user_size", points=len(grid), n_batches=n_batches, q_cap=q_cap,
         first_call_s=first_s, warm_s=warm_s, jobs=jobs,
         jobs_per_s_warm=jobs / warm_s, peak_mem_bytes=peak,
         launches=launches, supersteps=supersteps,
         theorem2_mean_excess=float(excess.mean()),
         theorem2_frac_within=frac_ok, remark5_min_def=eb_def)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = phase_build()
    full = phase_kernel(dev, sketch=False)
    sketch = phase_kernel(dev, sketch=True)
    phase_contracts(dev)
    phase_main(dev)
    launches = phase_user_size(dev)
    print(json.dumps({"kernels": [{
        "name": "hist_update", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES,
        "tpu_ref": "src/repro/kernels/superstep.py:_hist_body",
        "impl": "cuda", "launches": launches,
        "max_abs_err": max(full["max_abs_err"], sketch["max_abs_err"]),
        "ms": full["kernel_ms"], "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"], "bound_by": "bytes",
        "library_ms": full["library_ms"], "matches_plain": True}]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
