#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, started together) and runs, in order,
printing one JSON line per phase:

1. build         — compile ``hist_update.cu``, ``fifo_compact.cu``,
                   ``flash_attention.cu``, ``decode_attention.cu`` and
                   ``ssd_scan.cu``; the card's name and power limit
                   from nvidia-smi.
2. kernel        — the CUDA ``hist_update`` against its plain torch
                   version on random blocks (lognormal latencies, an
                   i.i.d. 50% mask) of each path's user-size shape: the
                   sweep's (8,160 points, 32 × 768 block; full 512-bin
                   and 64-bin sketch modes) and the generate sweep's
                   (8,192 points, 16 × 64), and on a thinned generate
                   block whose size is not a multiple of 16 (8,192 × 5
                   × 63): counts bit for bit, sums within rtol 1e-6;
                   kernel, plain, library (one ``scatter_add_`` over
                   precomputed bins) and bound times.  The bound is
                   ``hist_update_min_bytes`` (32-byte sectors counted
                   on the block) over 3.35 TB/s; ``bound_ms_bytes4`` is
                   the earlier count (every included latency at 4
                   bytes, every row whole), kept for comparison.
3. fifo_compact  — the CUDA ``fifo_compact`` against its plain version
                   at the generate sweep's user-size shape (8,192 ×
                   1,409, random k and now): bit for bit; kernel,
                   plain, library (one ``torch.gather`` with its index
                   built beforehand) and bound times.
4. hist_cases    — the CUDA ``hist_update`` bit for bit against its
                   plain version, launched twice, on blocks random
                   inputs never give: ``bit_bins``' special values (±0,
                   denormals, ±inf, ±NaN, negatives, every bin edge),
                   all entries in one bin, the sweep's prefix masks,
                   n_bins 100 and 101, odd sizes (4,100 × 5 × 63, 33 ×
                   5 × 7, 37 × 7 × 1,001) and misaligned bases, in full
                   and sketch mode, covering one warp and one block a
                   point, the vector and the scalar loop and both
                   flushes; and ``fifo_compact`` at k ∈ {0, 1, n − 1,
                   n}, small k, an odd row of 77 and a misaligned
                   buffer.
5. contracts     — Threefry known-answer vectors on the card, and a
                   split sweep dispatch bitwise equal to the whole one.
6. main          — ``evaluate(SweepGrid.from_rhos([.1 … .9], V100),
                   backend="sweep", n_batches=4000, q_cap=1024,
                   seed=7)``: no buffer drops, mean latency at φ
                   (ρ ≥ 0.3), Remark 5, one kernel launch per superstep.
7. user_size     — the examples/sweep_grid.py grid at 8,192 requested
                   points (8,160 run), n_batches=3000, q_cap=768,
                   seed=0: no drops, the example's Theorem 2 / Remark 5
                   checks, wall time (first call and warm), jobs/s, peak
                   memory, kernel launches.  A third run, not timed,
                   stops after superstep 60 of 94, whose block is cloned
                   as the kernel received it, and a ``path_kernel``
                   line times ``hist_update`` on that block as
                   ``kernel`` does on random ones.
8. gen_contracts — the generate sweep on the card: split dispatch
                   bitwise equal to the whole one, the two disciplines
                   bitwise equal at max_active = 1, and a hist_every=3
                   run whose blocks are 5 × 31 (no multiple of 16)
                   without drops, each of its hist_update calls held
                   bit for bit against the plain version.
9. gen_user_size — ``gen_sweep`` on the benchmarks/continuous.py grid
                   (16 ρ × gen_tokens 8/32/64/256 × max_active
                   8/16/32/64 × both disciplines, prompt 128) tiled 16
                   times into 8,192 points, n_steps=4096, adaptive caps:
                   no drops, every static point within max(3·CI, 4%) of
                   the port's ``sweep`` at its equivalent request-level
                   law, two continuous points against the port's exact
                   numpy loop (3σ over 3 seeds), wall time (first and
                   warm), requests/s, peak memory, launches of both
                   kernels (one each per 16-step superstep).  Both
                   kernels' inputs at superstep 160 of 256 are cloned
                   from a third run as in ``user_size``, and timed in
                   two ``path_kernel`` lines.
10. loss_contracts — the loss paths on the card: the neutral points of a
                   mixed loss grid bitwise equal to the loss-free path
                   (both sweeps), split dispatch with loss bitwise (caps,
                   r_cap included, pinned from the full grid), and
                   tests/test_backpressure.py's seed ladders (3 sweep and
                   2 generate configurations, 6 copies each) against the
                   port's own ``loss_ref`` mirrors on 3 seeds, 3σ with
                   floors of 1.5% and 0.004; the exact accounting laws;
                   one hist_update (and fifo_compact) launch per
                   superstep of every loss run.
11. loss_user_size — the benchmarks/backpressure.py grid (V100 law,
                   b_max 8, 4 ρ × 4 rooms × 3 deadlines × 2 overflow
                   modes × 2 retry rates = 192 points) tiled 43 times
                   into 8,256, n_batches=3000, a_cap 64, r_cap 96, seed
                   29: two runs bitwise equal, no buffer drops, the
                   accounting laws, reject_frac falling as q_max grows;
                   the benchmark's frontier and retry tax as tile means
                   with standard errors; wall time (first and warm),
                   jobs/s, peak memory.  Superstep 60's hist_update
                   block, from a third untimed run, timed as a
                   ``path_kernel`` line.
12. gen_loss_user_size — ``gen_user_size``'s grid with loss tiles (0–3
                   neutral, 4–7 reject at q_max 20, 8–11 drop at q_max 20
                   with retries, 12–15 reject with retries and a deadline
                   of twice the unloaded latency), its caps pinned and
                   r_cap from the loss grid: tiles 0–3 bitwise equal to
                   ``gen_user_size``'s points, no drops, the accounting
                   laws, launch counts; superstep 160's hist_update and
                   fifo_compact inputs (rows of the loss buffer length)
                   timed as ``path_kernel`` lines.

13. attn_kernel   — the CUDA ``flash_attention`` and ``decode_attention``
                   against their plain versions (float32 matmuls, TF32
                   off): at the serve path's shapes (batch 1…32, prompt
                   32, cache 37, 16 heads of 64, bf16), at the long
                   serve shapes (32 × 1,024, cache 1,057) and at batch
                   1 on them (B4 splits the cache there), at
                   phi4-mini's GQA heads (24 over 8, hd 128), with a
                   window, ragged lengths (at batch 1 on the long cache
                   lengths that leave splits empty, and -1), and in
                   float32: bf16 within 2e-2 and float32 within 2e-5
                   max abs, a row of length -1 exactly 0, and every case
                   launched twice with bitwise equal outputs; kernel,
                   plain, library (``scaled_dot_product_attention``) and
                   bound times at the serve, long and batch-1 shapes.
14. serve        — ``python -m repro_torch.launch.serve --arch
                   qwen1.5-0.5b --full --workload generate --rho 0.5
                   --jobs 300 --max-batch 32`` through its ``run``: all
                   jobs served with finite latencies, τ^[b] per bucket,
                   α, τ0, R², E[W] against φ, p99, utilisation, peak
                   memory, and exactly 24 ``flash_attention`` and 24 × 4
                   ``decode_attention`` launches per batch.
15. serve_long   — the same model generating 32 tokens after a 1,024-
                   token prompt, ``calibrate(samples=3)`` on batches
                   1…32, then 300 Poisson requests at ρ = 0.5: τ^[b],
                   α, τ0, R², E[W] against φ, p99, peak memory, exact
                   launch counts.
16. model_consistency — qwen1.5-0.5b at full width in float32 from the
                   port's seeded init, batch 2: prefill(32) and three
                   decode steps against the forward logits of all 35
                   tokens, within 3e-4 (abs + rel): the two kernels held
                   against each other through the whole model.
17. ssd_kernel   — the CUDA ``ssd_scan`` against its plain version
                   (float32 matmuls) at mamba2-2.7b's heads (80 × 64,
                   d_state 128, one group, B and C strided slices of
                   one activation as in the model): the serve shape
                   (B 32, S 32, bf16), the long shape (B 32, S 1,024),
                   ragged lengths (S 1,000 at B 32 and at B 1, where
                   the time axis is split), batch 1, 2 and 4 at S
                   1,024 (4, 2 and 1 pieces), batch 1 at S 32, one
                   float32 case and one with two groups: y and the
                   final state each within 2e-3 (bf16) and 1e-4
                   (float32) max abs, the reference API's y bit for bit
                   the model call's rounded to x's dtype, and every
                   bf16 case launched twice with bitwise equal y and
                   state; each case's split count; kernel, plain and
                   bound times (no single PyTorch call computes the
                   SSD, so no library time).
18. serve_ssm    — ``python -m repro_torch.launch.serve --arch
                   mamba2-2.7b --full --workload generate --rho 0.5
                   --jobs 300 --max-batch 32`` through its ``run``: all
                   jobs served with finite latencies, τ^[b], α, τ0, R²,
                   E[W] against φ, p99, utilisation, peak memory, and
                   exactly 64 ``ssd_scan`` launches and no attention
                   launch per batch.
19. ssm_consistency — mamba2-2.7b at full width in float32 from the
                   port's seeded init, batch 2: prefill(300), which
                   crosses a 256-token chunk, and three decode steps
                   against the forward logits of all 303 tokens, within
                   3e-4 (abs + rel): the kernel's final state held
                   against the eager recurrence.

Then a ``phase_seconds`` line (each phase's wall seconds), a
``{"kernels": [...]}`` line (one row per kernel and path: the
launches of that path's user-size run beside the times at that path's
shape; the ``hist_update`` and ``fifo_compact`` rows add ``path_ms``,
``path_plain_ms``, ``path_bound_ms`` and ``path_library_ms`` from the
path's own block, and ``bound_ms_bytes4`` beside each recounted
bound; the loss paths' rows time B1 and B2 on their captured blocks
only), the nvidia-smi line, and the last
line ``{"ok": true, "device": {...}}``.  Any failed check raises and the
script exits non-zero; without a CUDA device it exits non-zero before
any phase.  Imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import dataclasses
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

from repro_torch.core import (  # noqa: E402
    GenGrid, GenServiceModel, SweepGrid, evaluate, gen_caps, gen_sweep,
    sweep, sweep_caps)
from repro_torch.core.analytic import (  # noqa: E402
    LinearServiceModel, mean_batch_lower, phi, stability_limit)
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.continuous_sim import (  # noqa: E402
    simulate_continuous_numpy)
from repro_torch.core.gen_sweep import buffer_length  # noqa: E402
from repro_torch.core.grid import OVERFLOW_CODE  # noqa: E402
from repro_torch.core.hist import (bit_bins, hist_edges,  # noqa: E402
                                   sketch_edges, thinned_rows)
from repro_torch.core.loss_ref import (  # noqa: E402
    simulate_gen_loss_numpy, simulate_loss_numpy)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.calibrate import fit_service_model  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import superstep as ss  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain, decode_splits)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_chunked, ssd_scan, ssd_scan_plain, ssd_splits)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import build as build_model  # noqa: E402
from repro_torch.serving import InferenceEngine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
SLEEP_CYCLES = 40_000_000          # ≈ 20 ms at the H100's 1.98 GHz
# H100 SXM dense peaks: bf16 on the tensor cores, float32 on the CUDA
# cores (the float32 kernels must not round through TF32)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
V100 = (0.1438, 1.8874)            # README's V100 (α, τ0)
# name: (source, TPU kernel it replaces as file:line and as function)
KERNELS = {
    "hist_update": ("src/repro_torch/kernels/csrc/hist_update.cu",
                    "src/repro/kernels/superstep.py:105",
                    "src/repro/kernels/superstep.py:_hist_body"),
    "fifo_compact": ("src/repro_torch/kernels/csrc/fifo_compact.cu",
                     "src/repro/kernels/superstep.py:180",
                     "src/repro/kernels/superstep.py:_compact_body"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:30",
                        "src/repro/kernels/flash_attention.py:_kernel"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:27",
                         "src/repro/kernels/decode_attention.py:_kernel"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:28",
                 "src/repro/kernels/ssd_scan.py:_kernel"),
}
# the served model and the serve path's shapes (launch.serve: prompt 32,
# 4 generated tokens, a cache of 32 + 4 + 1 slots, batches 1…32)
SERVE_ARCH = "qwen1.5-0.5b"
SERVE_ARGS = ["--arch", SERVE_ARCH, "--full", "--workload", "generate",
              "--rho", "0.5", "--jobs", "300", "--max-batch", "32"]
SERVE_PROMPT, SERVE_GEN = 32, 4
LONG_PROMPT, LONG_GEN = 1024, 32
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# the Mamba2 serve path: launch.serve's arguments on mamba2-2.7b, one
# ssd_scan launch per layer per batch (in the prefill)
SSM_ARCH = "mamba2-2.7b"
SSM_ARGS = ["--arch", SSM_ARCH, "--full", "--workload", "generate",
            "--rho", "0.5", "--jobs", "300", "--max-batch", "32"]
SSM_PROMPT, SSM_LONG = 32, 1024
SSD_TOL = {torch.bfloat16: 2e-3, torch.float32: 1e-4}
# benchmarks/continuous.py's token-level V100-like constants (ms) and
# grid axes
GEN_MODEL = GenServiceModel(alpha_decode=0.14, tau0_decode=1.9,
                            alpha_prefill=0.035, tau0_prefill=1.9)
GEN_PROMPT = 128
GEN_RHOS = [round(r, 4) for r in np.linspace(0.15, 0.85, 16)]
GEN_GENS = (8, 32, 64, 256)
GEN_CAPS = (8, 16, 32, 64)
GEN_DISCS = ("static", "continuous")


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
    """Mean milliseconds per call over ``reps`` calls, by CUDA events.
    The calls are queued behind a device sleep of ≈ 20 ms, so that a
    short kernel is timed at the card's pace and not at the host's rate
    of launching it."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_build() -> str:
    """Build every kernel source at once, one nvcc each, and load it."""
    t0 = time.perf_counter()
    _build.build(*KERNELS)
    for name in KERNELS:
        _build.library(name)
    smi = nvidia_smi()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds={k: _build.build_seconds.get(k) for k in KERNELS},
         flags=" ".join(_build.NVCC_FLAGS), nvidia_smi=smi)
    print(smi, flush=True)
    return smi


def hist_report(dev, start, lats, inc, *, n_bins: int, sketch: bool,
                block: str, emit_as: str = "kernel") -> dict:
    """The CUDA hist_update against its plain version on one block
    (``start`` the rows before the update): counts bit for bit, sums
    within rtol 1e-6; kernel, plain, library and bound times."""
    p = lats.shape[0]
    got = tuple(t.clone() for t in start)
    want = tuple(t.clone() for t in start)
    ss.hist_update(got, lats, inc, n_bins=n_bins, backend="cuda",
                   sketch=sketch)
    ss.hist_update_plain(want, lats, inc, n_bins=n_bins, sketch=sketch)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]),
          f"hist_update counts bitwise equal (sketch={sketch}, {block})")
    err = float((got[0] - want[0]).abs().max())
    if sketch:
        check(torch.allclose(got[1], want[1], rtol=1e-6, atol=0.0),
              f"hist_update sums within rtol 1e-6 ({block})")
        err = max(err, float((got[1] - want[1]).abs().max()))
    # the bound's row sectors are those of the rows the path updates
    min_bytes = ss.hist_update_min_bytes(got, lats, inc, n_bins=n_bins,
                                         sketch=sketch)
    scratch = got
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
    # the earlier bound: every latency read at 4 bytes, every row whole
    bytes4 = inc.numel() + 4 * n_inc + 2 * p * n_bins * 4 * len(start)
    plan = ss.hist_update_plan(p, lats[0].numel(), n_bins, sketch=sketch,
                               lats_ptr=lats.data_ptr(),
                               inc_ptr=inc.data_ptr(),
                               row_ptrs=[h.data_ptr() for h in got])
    out = dict(block=block, sketch=sketch, shape=list(lats.shape),
               n_bins=n_bins, included=n_inc, bytes=min_bytes,
               kernel_ms=kernel_ms, plain_ms=plain_ms,
               library_ms=library_ms,
               library_note="scatter_add_ of counts over precomputed bins",
               bound_ms=min_bytes / HBM_BYTES_PER_S * 1e3,
               bytes4=bytes4,
               bound_ms_bytes4=bytes4 / HBM_BYTES_PER_S * 1e3,
               plan=plan._asdict(), max_abs_err=err, matches_plain=True)
    emit(emit_as, **out)
    return out


def random_hist_block(dev, p: int, rows: int, width: int, n_bins: int,
                      sketch: bool, seed: int):
    """Lognormal(1, 1.5) latencies, an i.i.d. 50% mask and random rows:
    the random blocks every PR has timed."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lats = torch.empty(p, rows, width, device=dev).log_normal_(
        1.0, 1.5, generator=gen)
    inc = torch.rand(p, rows, width, device=dev, generator=gen) < 0.5
    start = (torch.randint(0, 1000, (p, n_bins), dtype=torch.int32,
                           device=dev, generator=gen),)
    if sketch:
        start += (torch.rand(p, n_bins, device=dev, generator=gen) * 100,)
    return start, lats, inc


def phase_kernel(dev, sketch: bool, p: int = 8160, rows: int = 32,
                 width: int = 768, block: str = "sweep") -> dict:
    """The CUDA hist_update against its plain version on a random
    block of a path's shape."""
    n_bins = 64 if sketch else 512
    start, lats, inc = random_hist_block(dev, p, rows, width, n_bins,
                                         sketch, 1234 + sketch)
    return hist_report(dev, start, lats, inc, n_bins=n_bins, sketch=sketch,
                       block=block)


def _hist_case(dev, name: str, lats, inc, n_bins: int, sketch: bool,
               seed: int) -> dict:
    """One block held bit for bit against the plain version, twice."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = lats.shape[0]
    start = (torch.randint(0, 1000, (p, n_bins), dtype=torch.int32,
                           device=dev, generator=gen),)
    if sketch:
        start += (torch.rand(p, n_bins, device=dev, generator=gen) * 100,)
    want = tuple(t.clone() for t in start)
    ss.hist_update_plain(want, lats, inc, n_bins=n_bins, sketch=sketch)
    for rep in range(2):
        got = tuple(t.clone() for t in start)
        ss.hist_update(got, lats, inc, n_bins=n_bins, backend="cuda",
                       sketch=sketch)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]),
              f"hist_update case {name}: counts differ (launch {rep})")
        if sketch:
            # the special values' sums are ±inf and NaN where they are
            # the plain version's
            check(torch.allclose(got[1], want[1], rtol=1e-6, atol=0.0,
                                 equal_nan=True),
                  f"hist_update case {name}: sums outside rtol 1e-6")
    plan = ss.hist_update_plan(p, lats[0].numel(), n_bins, sketch=sketch,
                               lats_ptr=lats.data_ptr(),
                               inc_ptr=inc.data_ptr(),
                               row_ptrs=[h.data_ptr() for h in got])
    return dict(shape=list(lats.shape), n_bins=n_bins, sketch=sketch,
                included=int(inc.sum()), warps_per_point=plan.warps_per_point,
                vec_loads=plan.vec_loads, vec_rows=plan.vec_rows)


def _special_values(dev) -> torch.Tensor:
    """bit_bins' edge cases: ±0.0, denormals, ±inf, ±NaN, negatives,
    every bin edge of both modes and the floats beside each."""
    edges = np.concatenate([hist_edges(512), sketch_edges()])
    special = [0.0, -0.0, 1e-45, 1e-40, 2.0 ** -149, 2.0 ** 40, -1.0,
               -2.0 ** 40, np.inf, -np.inf, np.nan, 1.0,
               np.finfo(np.float32).max]
    vals = np.concatenate([edges, special]).astype(np.float32)
    with np.errstate(over="ignore"):
        vals = np.concatenate([vals, np.nextafter(vals, np.float32(-np.inf)),
                               np.nextafter(vals, np.float32(np.inf))])
    vals = np.append(vals, np.array([0xFFC00000], np.uint32)
                     .view(np.float32))             # a negative NaN
    return torch.from_numpy(vals).to(dev)


def phase_hist_cases(dev) -> None:
    """The CUDA hist_update bit for bit against its plain version on the
    blocks random inputs never give: special values, one bin, prefix
    masks, n_bins = 100 and 101 (a row flushed element by element), odd
    sizes and misaligned bases; then
    fifo_compact at k in {0, n} and small k, an odd row and a misaligned
    buffer."""
    gen = torch.Generator(device=dev).manual_seed(4242)
    cases = {}
    vals = _special_values(dev)
    for name, (p, r, w) in {"special_warp": (4096, 16, 64),
                            "special_block": (16, 8, 1024)}.items():
        idx = torch.randint(0, len(vals), (p, r, w), device=dev,
                            generator=gen)
        lats = vals[idx]
        inc = torch.rand(p, r, w, device=dev, generator=gen) < 0.7
        for n_bins, sk in ((512, False), (100, False), (64, True)):
            cases[f"{name}_{n_bins}"] = _hist_case(dev, name, lats, inc,
                                                   n_bins, sk, 1)
    for name, (p, r, w) in {"one_bin_gen": (8192, 16, 64),
                            "one_bin_sweep": (256, 32, 768)}.items():
        # [3.0, 3.25) is one bin of the full histogram and of the sketch
        lats = 3.0 + 0.25 * torch.rand(p, r, w, device=dev, generator=gen)
        inc = torch.rand(p, r, w, device=dev, generator=gen) < 0.5
        for n_bins, sk in ((512, False), (64, True)):
            cases[f"{name}_{n_bins}"] = _hist_case(dev, name, lats, inc,
                                                   n_bins, sk, 2)
    # the sweep's prefix masks: each row includes its first b slots
    p, r, w = 512, 32, 768
    b = torch.randint(0, 40, (p, r, 1), device=dev, generator=gen)
    inc = torch.arange(w, device=dev) < b
    lats = 2.0 + torch.rand(p, r, w, device=dev, generator=gen)
    for n_bins, sk in ((512, False), (100, False), (101, False), (64, True)):
        cases[f"prefix_{n_bins}"] = _hist_case(dev, "prefix", lats, inc,
                                               n_bins, sk, 3)
    # odd sizes: rows start off every alignment (head and tail steps)
    for name, (p, r, w) in {"odd_warp": (4100, 5, 63),
                            "odd_tiny": (33, 5, 7),
                            "odd_block": (37, 7, 1001)}.items():
        _, lats, inc = random_hist_block(dev, p, r, w, 512, False, 5)
        for n_bins, sk in ((512, False), (101, False), (64, True)):
            cases[f"{name}_{n_bins}"] = _hist_case(dev, name, lats, inc,
                                                   n_bins, sk, 4)
    # misaligned bases: a mask one byte off (scalar loop), and latencies
    # and mask off together by one entry (vector loop, every row a head)
    for name, (lat_off, inc_off) in {"mask_off1": (0, 1),
                                     "both_off1": (1, 1)}.items():
        for p, r, w in ((4096, 16, 64), (16, 8, 1024)):
            n = p * r * w
            lats = torch.empty(n + 4, device=dev).log_normal_(
                1.0, 1.5, generator=gen)[lat_off:lat_off + n].view(p, r, w)
            inc = (torch.rand(n + 4, device=dev, generator=gen) < 0.5)[
                inc_off:inc_off + n].view(p, r, w)
            for n_bins, sk in ((512, False), (64, True)):
                cases[f"{name}_{w}_{n_bins}"] = _hist_case(
                    dev, name, lats, inc, n_bins, sk, 6)
    check(any(not c["vec_loads"] for c in cases.values())
          and any(c["vec_loads"] for c in cases.values())
          and {c["warps_per_point"] for c in cases.values()} == {1, 8}
          and any(not c["vec_rows"] for c in cases.values()),
          "hist cases cover both loops, both groupings and both flushes")

    compact = {}
    for name, (p, n, kmax, off) in {"small_k": (512, 1409, 8, 0),
                                    "random_k": (512, 1409, 1409, 0),
                                    "odd_row": (300, 77, 77, 0),
                                    "buf_off1": (300, 1409, 1409, 1)}.items():
        buf = (torch.randn(p * n + 4, device=dev, generator=gen)
               * 50.0)[off:off + p * n].view(p, n)
        k = torch.randint(0, kmax + 1, (p,), dtype=torch.int32, device=dev,
                          generator=gen)
        k[:4] = torch.tensor([0, n, 1, n - 1], dtype=torch.int32)
        now = torch.rand(p, device=dev, generator=gen) * 500.0
        want = ss.fifo_compact_plain(buf, k, now, out=torch.empty_like(buf))
        for rep in range(2):
            got = ss.fifo_compact(buf, k, now, backend="cuda",
                                  out=torch.empty_like(buf))
            torch.cuda.synchronize()
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"fifo_compact case {name} bitwise (launch {rep})")
        compact[name] = ss.fifo_compact_plan(
            p, n, buf_ptr=buf.data_ptr(), out_ptr=got.data_ptr())._asdict()
    check(any(not c["vec"] for c in compact.values()),
          "compact cases cover the scalar loop")
    emit("hist_cases", hist=cases, compact=compact, matches_plain=True)


CAPTURED = ("hist_update", "fifo_compact")


class _Stop(Exception):
    """Ends a capture run at the captured call."""


def capture_blocks(run, at: int, stop_after: str) -> dict:
    """Run ``run()`` with ``ss.hist_update`` and ``ss.fifo_compact``
    wrapped: each clones the inputs of its ``at``-th call (the histogram
    rows as they were before it) into the returned dict, as ``(args,
    kwargs)`` under its name, and passes every call on to the kernel.
    The run ends right after the ``at``-th call of ``stop_after``.  The
    kernels count their launches on the module's names, which are the
    wrappers meanwhile: the counts carry over and back."""
    blocks, kernels = {}, {}
    for name in CAPTURED:
        kernel = kernels[name] = getattr(ss, name)
        calls = [0]

        def wrapped(*args, _kernel=kernel, _name=name, _calls=calls, **kw):
            _calls[0] += 1
            if _calls[0] == at:
                first = (tuple(h.clone() for h in args[0])
                         if _name == "hist_update" else args[0].clone())
                blocks[_name] = ((first, *(a.clone() for a in args[1:])),
                                 kw)
            out = _kernel(*args, **kw)
            if _calls[0] == at and _name == stop_after:
                raise _Stop
            return out
        wrapped.launches = kernel.launches
        setattr(ss, name, wrapped)
    try:
        run()
    except _Stop:
        pass
    finally:
        for name, kernel in kernels.items():
            kernel.launches = getattr(ss, name).launches
            setattr(ss, name, kernel)
    check(stop_after in blocks, f"the run made no {at}-th {stop_after} call")
    return blocks


def compact_report(dev, buf, k, now, block: str,
                   emit_as: str = "fifo_compact") -> dict:
    """The CUDA fifo_compact against its plain version on one block:
    bit for bit; kernel, plain, library and bound times."""
    p, n = buf.shape
    got = ss.fifo_compact(buf, k, now, backend="cuda",
                          out=torch.empty_like(buf))
    want = ss.fifo_compact_plain(buf, k, now, out=torch.empty_like(buf))
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          f"fifo_compact bitwise equal to its plain version ({block})")
    err = float((got - want).abs().max())
    out_buf = torch.empty_like(buf)
    kernel_ms = time_ms(lambda: ss.fifo_compact(
        buf, k, now, backend="cuda", out=out_buf))
    plain_ms = time_ms(lambda: ss.fifo_compact_plain(buf, k, now,
                                                     out=out_buf))
    # library yardstick: the gather alone, its index built beforehand
    # (the subtraction of now and the fill past the end are left out)
    idx = (k.unsqueeze(1).long()
           + torch.arange(n, device=dev)).clamp_(max=n - 1)
    library_ms = time_ms(lambda: torch.gather(buf, 1, idx, out=out_buf))
    del idx
    survivors = int((n - k.long()).sum())
    bytes_moved = 4 * survivors + 4 * p * n + 8 * p
    out = dict(block=block, points=p, n=n, survivors=survivors,
               mean_k=float(k.float().mean()), bytes=bytes_moved,
               kernel_ms=kernel_ms, plain_ms=plain_ms,
               library_ms=library_ms,
               library_note="torch.gather with a prebuilt index; the "
                            "subtraction and the tail fill left out",
               bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
               plan=ss.fifo_compact_plan(
                   p, n, buf_ptr=buf.data_ptr(),
                   out_ptr=out_buf.data_ptr())._asdict(),
               max_abs_err=err, matches_plain=True)
    emit(emit_as, **out)
    return out


def phase_fifo_compact(dev, p: int = 8192, n: int = 1409) -> dict:
    """The CUDA fifo_compact against its plain version on the generate
    sweep's user-size shape (``buffer_length(256, 112, 64)``), random k
    and now."""
    gen = torch.Generator(device=dev).manual_seed(99)
    buf = torch.randn(p, n, device=dev, generator=gen) * 50.0
    k = torch.randint(0, n + 1, (p,), dtype=torch.int32, device=dev,
                      generator=gen)
    k[:4] = torch.tensor([0, 1, n - 1, n], dtype=torch.int32)
    now = torch.rand(p, device=dev, generator=gen) * 500.0
    now[0] = 0.0
    return compact_report(dev, buf, k, now, "random")


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
                    q_cap: int = 768, capture_at: int = 60) -> tuple:
    """Returns the run's hist_update launches and the path block: the
    inputs of superstep ``capture_at`` (past the warm-up), cloned as the
    kernel received them in a third run that is not timed."""
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
    blocks = capture_blocks(lambda: sweep(grid, **kw), capture_at,
                            "hist_update")
    return launches, blocks["hist_update"]


def gen_grid(tiles: int = 16) -> GenGrid:
    """benchmarks/continuous.py's grid (16 ρ × gen_tokens × max_active
    × discipline = 512 points, λ normalized by the cap-limited
    capacity), tiled ``tiles`` times: the copies of a point differ only
    in their global index, so they form a seed ladder."""
    lam, gens, caps, discs = [], [], [], []
    for rho in GEN_RHOS:
        for g in GEN_GENS:
            for c in GEN_CAPS:
                for d in GEN_DISCS:
                    lam.append(rho * GEN_MODEL.capped_capacity(
                        GEN_PROMPT, g, c))
                    gens.append(g)
                    caps.append(c)
                    discs.append(d)
    m = GEN_MODEL
    return GenGrid.from_points(
        np.tile(lam, tiles), m.alpha_decode, m.tau0_decode,
        m.alpha_prefill, m.tau0_prefill, prompt_len=GEN_PROMPT,
        gen_tokens=np.tile(gens, tiles), max_active=np.tile(caps, tiles),
        discipline=[d for _ in range(tiles) for d in discs])


def gen_index(rho: float, gen: int, cap: int, disc: str) -> int:
    """Index of a point in the first tile of ``gen_grid``."""
    return (((GEN_RHOS.index(rho) * len(GEN_GENS) + GEN_GENS.index(gen))
             * len(GEN_CAPS) + GEN_CAPS.index(cap))
            * len(GEN_DISCS) + GEN_DISCS.index(disc))


def phase_gen_contracts(dev) -> None:
    """The generate sweep's bitwise contracts and a thinned run whose
    histogram blocks are no multiple of 16 bytes, on the card."""
    m = GEN_MODEL
    # s_cap = max(max_active) = 31 is odd: with hist_every = 3 each
    # point bins 5 × 31 = 155 mask bytes per superstep, so the CUDA
    # hist_update runs its scalar head and tail on the real path
    g = GenGrid.from_points(
        [0.02, 0.012, 0.02, 0.015], m.alpha_decode, m.tau0_decode,
        m.alpha_prefill, m.tau0_prefill, prompt_len=GEN_PROMPT,
        gen_tokens=[8, 16, 8, 32], max_active=[15, 31, 15, 7],
        discipline=["continuous", "static", "static", "continuous"])
    block = len(thinned_rows(16, 3)) * int(g.max_active.max())
    check(block % 16 != 0, f"thinned block of {block} entries is odd")
    kw = dict(n_steps=2048, seed=13, device=dev, **gen_caps(g))
    for extra in ({}, dict(sketch=True, hist_every=3)):
        whole = gen_sweep(g, **kw, **extra)
        a = gen_sweep(g.take(slice(0, 2)), **kw, **extra)
        b = gen_sweep(g.take(slice(2, None)), key_offset=2, **kw, **extra)
        for f in ("mean_latency", "mean_batch", "utilization", "n_jobs",
                  "hist", "max_queue", "stderr"):
            split = np.concatenate([getattr(a, f), getattr(b, f)])
            check(np.array_equal(getattr(whole, f), split, equal_nan=True),
                  f"gen split dispatch bitwise equal to whole on {f} "
                  f"({extra})")
    alpha_eq = GEN_PROMPT * m.alpha_prefill + 32 * m.alpha_decode
    tau0_eq = m.tau0_prefill + 32 * m.tau0_decode
    one = {}
    for disc in GEN_DISCS:
        g1 = GenGrid.from_points([0.4 / (alpha_eq + tau0_eq)],
                                 m.alpha_decode, m.tau0_decode,
                                 m.alpha_prefill, m.tau0_prefill,
                                 prompt_len=GEN_PROMPT, gen_tokens=32,
                                 max_active=1, discipline=disc)
        one[disc] = gen_sweep(g1, n_steps=2048, q_cap=128, seed=3,
                              device=dev)
    for f in ("mean_latency", "mean_batch", "utilization", "n_jobs",
              "hist"):
        check(np.array_equal(getattr(one["static"], f),
                             getattr(one["continuous"], f)),
              f"max_active=1 disciplines bitwise equal on {f}")
    # every histogram update of the thinned run is held against the
    # plain version on the same block, on the real path: the counts
    # must agree bit for bit (the plain calls launch nothing)
    kernel = ss.hist_update
    same = []

    def checked(hists, lats, inc, *, n_bins, backend, sketch=False):
        want = tuple(h.clone() for h in hists)
        ss.hist_update_plain(want, lats, inc, n_bins=n_bins, sketch=sketch)
        got = kernel(hists, lats, inc, n_bins=n_bins, backend=backend,
                     sketch=sketch)
        same.append(torch.equal(got[0], want[0]))
        return got

    # the wrapper counts its launches on the module's name, which is
    # `checked` during the run: carry the count over and back
    before = checked.launches = kernel.launches
    ss.hist_update = checked
    try:
        th = gen_sweep(g, n_steps=4096, seed=5, hist_every=3, device=dev)
    finally:
        ss.hist_update = kernel
        kernel.launches = checked.launches
    th_launches = kernel.launches - before
    check(th_launches == 4096 // 16,
          f"thinned run launched hist_update {th_launches} times")
    check(len(same) == th_launches and all(same),
          f"thinned run: {same.count(False)} of {len(same)} CUDA "
          f"hist_update calls differ from the plain version")
    check(int(th.buffer_dropped.sum()) == 0,
          f"hist_every=3 run ({block} entries per block) without drops")
    check(bool(np.all(th.hist.sum(1) > 0)), "thinned histograms filled")
    emit("gen_contracts", split_bitwise=True, max_active_1_bitwise=True,
         thinned_block=block, thinned_launches=th_launches,
         thinned_matches_plain=True, thinned_jobs=th.n_jobs.tolist(),
         thinned_binned=th.hist.sum(1).tolist())


def _ladder_se(a, b, floor_frac: float = 0.015) -> float:
    """tests/test_gen_sweep.py's combined standard error of two seed
    ladders' means, floored at 1.5% of the reference mean."""
    se = math.sqrt(np.var(a, ddof=1) / len(a) + np.var(b, ddof=1) / len(b))
    return max(se, floor_frac * float(np.mean(b)))


def phase_gen_user_size(dev, grid: GenGrid, n_steps: int = 4096,
                        sweep_batches: int = 4000,
                        capture_at: int = 160) -> tuple:
    """Returns the phase's record and the path blocks of both kernels:
    their inputs at superstep ``capture_at``, cloned in a third run that
    is not timed."""
    caps = gen_caps(grid)
    kw = dict(n_steps=n_steps, seed=29, device=dev)
    ss.hist_update.launches = 0
    ss.fifo_compact.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = gen_sweep(grid, **kw)
    first_s = time.perf_counter() - t0
    launches = {"hist_update": ss.hist_update.launches,
                "fifo_compact": ss.fifo_compact.launches}
    supersteps = n_steps // 16
    for name, n in launches.items():
        check(n == supersteps, f"gen user-size sweep launched {name} {n} "
              f"times, expected one per superstep ({supersteps})")
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r2 = gen_sweep(grid, **kw)
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    check(np.array_equal(r.hist, r2.hist)
          and np.array_equal(r.mean_latency, r2.mean_latency),
          "two gen user-size runs give the same bits")
    check(int(r.buffer_dropped.sum()) == 0,
          "gen user-size buffer_dropped == 0")
    check(bool(np.all(np.isfinite(r.mean_latency)) and np.all(r.n_jobs > 0)),
          "gen user-size results finite, every point completed jobs")

    # the static discipline is the paper's batch queue at the
    # equivalent request-level law: hold every static point against the
    # port's request-level sweep there
    st = np.flatnonzero(grid.discipline == 0)
    sg = SweepGrid.from_points(grid.lam[st], grid.equivalent_alpha[st],
                               grid.equivalent_tau0[st],
                               b_max=grid.max_active[st])
    rs = sweep(sg, n_batches=sweep_batches, seed=31, device=dev)
    check(int(rs.buffer_dropped.sum()) == 0,
          "equivalent-law sweep buffer_dropped == 0")
    gap = np.abs(r.mean_latency[st] - rs.mean_latency)
    tol = np.maximum(3.0 * np.hypot(r.ci_halfwidth[st], rs.ci_halfwidth),
                     0.04 * rs.mean_latency)
    worst = int(np.argmax(gap / tol))
    check(bool(np.all(gap <= tol)),
          f"{int((gap > tol).sum())} of {len(st)} static points outside "
          f"max(3·CI, 4%) of the equivalent-law sweep (worst: point "
          f"{int(st[worst])}, {r.mean_latency[st[worst]]} vs "
          f"{rs.mean_latency[worst]})")

    # two continuous points against the exact numpy loop; the tiles of
    # a point are its seed ladder.  The loop runs 60,000 jobs: at 12,000
    # its start-up transient still lifts the mean by ≈ 2% at ρ ≈ 0.76
    # (103.6 against 101.3 at 60,000, six seeds each, on the CPU),
    # which is more than the kernels' standard error
    cont = []
    n_base = len(GEN_RHOS) * len(GEN_GENS) * len(GEN_CAPS) * len(GEN_DISCS)
    for rho, gen, cap in ((GEN_RHOS[7], 32, 64), (GEN_RHOS[13], 8, 16)):
        i = gen_index(rho, gen, cap, "continuous")
        ladder = r.mean_latency[i::n_base]
        ref = np.array([simulate_continuous_numpy(
            float(grid.lam[i]), GEN_MODEL, prompt_len=GEN_PROMPT,
            gen_tokens=gen, max_active=cap, n_jobs=60_000,
            seed=s).mean_latency for s in range(3)])
        se = _ladder_se(ladder, ref)
        check(abs(ladder.mean() - ref.mean()) < 3.0 * se,
              f"continuous rho={rho} gen={gen} cap={cap}: "
              f"{ladder.mean()} vs numpy {ref.mean()} (3se={3 * se})")
        cont.append(dict(rho=rho, gen=gen, cap=cap,
                         kernel=float(ladder.mean()),
                         numpy=float(ref.mean()), se=se))
    jobs = int(r.n_jobs.sum())
    out = dict(points=len(grid), n_steps=n_steps, caps=caps,
               buffer_length=buffer_length(caps["q_cap"], caps["a_cap"],
                                           int(grid.max_active.max())),
               first_call_s=first_s, warm_s=warm_s, requests=jobs,
               requests_per_s_warm=jobs / warm_s, peak_mem_bytes=peak,
               launches=launches, supersteps=supersteps,
               static_points=len(st),
               static_worst_gap_over_tol=float(gap[worst] / tol[worst]),
               static_median_rel_gap=float(np.median(
                   gap / rs.mean_latency)),
               continuous_vs_numpy=cont)
    emit("gen_user_size", **out)
    return out, capture_blocks(lambda: gen_sweep(grid, **kw), capture_at,
                               "fifo_compact"), r


# tests/test_backpressure.py's seed ladders: (q_max, deadline, overflow,
# retry_rate, lam) on MODEL_BP, and (discipline, overflow, q_max,
# deadline, retry_rate) at GEN_BP_LAM on GEN_MODEL
MODEL_BP = LinearServiceModel(alpha=0.05, tau0=1.0)
SW_CFG = [(10, 6.0, "reject", 0.5, 6.0),
          (10, 6.0, "drop", 0.5, 6.0),
          (24, 3.0, "reject", 0.3, 7.5)]
GEN_CFG = [("continuous", "reject", 20, 40.0, 0.05),
           ("static", "drop", 20, 40.0, 0.05)]
GEN_BP_LAM = 1.08 / (GEN_MODEL.alpha_decode * 32
                     + GEN_MODEL.alpha_prefill * GEN_PROMPT)
LADDER_FIELDS = ("goodput_frac", "reject_frac", "abandon_frac",
                 "retry_inflation", "mean_latency")
# benchmarks/backpressure.py's grid on the V100 law: 4 ρ × 4 rooms × 3
# deadlines (ms) × 2 overflow modes × 2 retry rates (per ms) = 192 points
BP_B_MAX = 8
BP_RHOS = [0.7, 0.9, 1.1, 1.3]
BP_Q_MAXES = [4, 8, 16, 32]
BP_DEADLINES = [0.0, 6.0, 12.0]
BP_OVERFLOWS = ("reject", "drop")
BP_RETRY = [0.0, 0.2]


def check_accounting(r, what: str) -> None:
    """tests/test_backpressure.py's exact accounting laws on one run."""
    check(int(r.buffer_dropped.sum()) == 0, f"{what}: buffer_dropped == 0")
    offered = r.n_jobs + r.overflow_dropped + r.abandoned
    check(np.array_equal(r.offered, offered),
          f"{what}: offered = jobs + overflow + abandoned")
    total = r.goodput_frac + r.late_frac + r.reject_frac + r.abandon_frac
    check(bool(np.allclose(total[offered > 0], 1.0, atol=1e-6)),
          f"{what}: the four fractions sum to 1")
    check(bool(np.all(r.n_in_slo <= r.n_jobs)), f"{what}: n_in_slo <= n_jobs")
    check(bool(np.all(r.retry_inflation >= 1.0 - 1e-6)),
          f"{what}: retry_inflation >= 1")


def _gate_ladder(kernel_vals, ref_vals, label) -> dict:
    """tests/test_backpressure.py's 3σ gate (floors 1.5% relative and
    0.004 absolute)."""
    se = max(_ladder_se(kernel_vals, ref_vals), 0.004)
    gap = abs(float(np.mean(kernel_vals)) - float(np.mean(ref_vals)))
    check(gap < 3.0 * se, f"{label}: {np.mean(kernel_vals)} vs loss_ref "
          f"{np.mean(ref_vals)} (3se={3 * se})")
    return dict(kernel=float(np.mean(kernel_vals)),
                loss_ref=float(np.mean(ref_vals)), se=se)


def _counted(run, supersteps: int, what: str, compact: bool = False):
    """Run ``run()`` with the launch counts at 0; check one hist_update
    (and one fifo_compact) launch per superstep."""
    ss.hist_update.launches = 0
    ss.fifo_compact.launches = 0
    r = run()
    names = ("hist_update", "fifo_compact") if compact else ("hist_update",)
    for name in names:
        n = getattr(ss, name).launches
        check(n == supersteps, f"{what} launched {name} {n} times, expected "
              f"one per superstep ({supersteps})")
    return r


def phase_loss_contracts(dev) -> None:
    """The loss paths' bitwise contracts and seed ladders on the card."""
    m = GEN_MODEL
    # neutral reduction: the q_max = deadline = retry = 0 points of a
    # loss grid give the loss-free path's bits (tests/test_backpressure.py
    # shapes, pinned q_cap / a_cap, the same global indices)
    g = SweepGrid.from_points([6.0, 4.0, 5.0], MODEL_BP.alpha, MODEL_BP.tau0,
                              b_max=8, q_max=[10, 0, 0],
                              deadline=[6.0, 0.0, 0.0],
                              retry_rate=[0.5, 0.0, 0.0])
    kw = dict(n_batches=1024, q_cap=64, a_cap=64, seed=11, device=dev)
    mixed = sweep(g, r_cap=32, **kw)
    base = sweep(g.take(slice(1, None)), key_offset=1, **kw)
    gg = GenGrid.from_points(
        [GEN_BP_LAM, 0.6 * GEN_BP_LAM, 0.4 * GEN_BP_LAM], m.alpha_decode,
        m.tau0_decode, m.alpha_prefill, m.tau0_prefill,
        prompt_len=GEN_PROMPT, gen_tokens=32, max_active=[32, 32, 16],
        discipline=["continuous", "continuous", "static"],
        q_max=[20, 0, 0], deadline=[40.0, 0.0, 0.0],
        retry_rate=[0.05, 0.0, 0.0])
    gkw = dict(n_steps=1024, q_cap=64, a_cap=64, seed=13, device=dev)
    gmixed = gen_sweep(gg, r_cap=32, **gkw)
    gbase = gen_sweep(gg.take(slice(1, None)), key_offset=1, **gkw)
    for name, (mx, bs) in {"sweep": (mixed, base),
                           "gen": (gmixed, gbase)}.items():
        for f in ("mean_latency", "mean_batch", "batch_m2", "utilization",
                  "n_jobs", "hist", "latency_p50", "latency_p99"):
            check(np.array_equal(getattr(mx, f)[1:], getattr(bs, f)),
                  f"{name} neutral points bitwise equal to the base path "
                  f"on {f}")
        check(int(mx.overflow_dropped[0] + mx.abandoned[0]) > 0
              and int(mx.overflow_dropped[1:].sum()
                      + mx.abandoned[1:].sum()) == 0,
              f"{name}: losses on the loss point only")

    # split dispatch with loss: chunks with key_offset and every cap,
    # r_cap included, pinned from the full grid
    g = SweepGrid.from_points(
        [6.0, 7.0, 6.0, 5.0], MODEL_BP.alpha, MODEL_BP.tau0, b_max=8,
        q_max=[10, 12, 0, 8], deadline=[6.0, 0.0, 0.0, 3.0],
        overflow=["reject", "drop", "reject", "reject"],
        retry_rate=[0.5, 0.0, 0.0, 1.0], dist=["det", "gamma"] * 2)
    gg = GenGrid.from_points(
        [GEN_BP_LAM] * 4, m.alpha_decode, m.tau0_decode, m.alpha_prefill,
        m.tau0_prefill, prompt_len=GEN_PROMPT, gen_tokens=32,
        max_active=[16, 32, 16, 8],
        discipline=["continuous", "static", "static", "continuous"],
        q_max=[20, 0, 12, 20], deadline=[40.0, 30.0, 0.0, 0.0],
        overflow=["reject", "drop", "drop", "reject"],
        retry_rate=[0.05, 0.0, 0.1, 0.0])
    for name, run, grid, kw in (
            ("sweep", sweep, g, dict(n_batches=512, seed=11,
                                     **sweep_caps(g))),
            ("gen", gen_sweep, gg, dict(n_steps=1024, seed=13,
                                        **gen_caps(gg)))):
        whole = run(grid, device=dev, **kw)
        a = run(grid.take(slice(0, 2)), device=dev, **kw)
        b = run(grid.take(slice(2, None)), key_offset=2, device=dev, **kw)
        for f in ("mean_latency", "mean_batch", "n_jobs", "hist",
                  "overflow_dropped", "abandoned", "n_in_slo", "n_fresh",
                  "n_retry", "max_queue"):
            split = np.concatenate([getattr(a, f), getattr(b, f)])
            check(np.array_equal(getattr(whole, f), split),
                  f"{name} split dispatch with loss bitwise on {f}")

    # the seed ladders against the port's own numpy mirrors; each loss
    # run launches hist_update (and fifo_compact) once per superstep
    cfg = [c for c in SW_CFG for _ in range(6)]
    g = SweepGrid.from_points(
        [c[4] for c in cfg], MODEL_BP.alpha, MODEL_BP.tau0, b_max=8,
        q_max=[c[0] for c in cfg], deadline=[c[1] for c in cfg],
        overflow=[c[2] for c in cfg], retry_rate=[c[3] for c in cfg])
    r = _counted(lambda: sweep(g, n_batches=6000, q_cap=64, a_cap=64,
                               r_cap=64, seed=11, device=dev),
                 -(-6000 // 32), "sweep ladder")
    check_accounting(r, "sweep ladder")
    check(bool(np.all(r.retry_inflation > 1.01)),
          "sweep ladder: retries inflate every point's arrivals")
    ladders = {}
    for ci, (qm, dl, ov, rate, lam) in enumerate(SW_CFG):
        refs = [simulate_loss_numpy(lam, MODEL_BP, 8, q_max=qm, deadline=dl,
                                    overflow=ov, retry_rate=rate, q_cap=64,
                                    r_cap=64, n_batches=20_000, seed=s)
                for s in range(3)]
        sl = slice(ci * 6, (ci + 1) * 6)
        ladders[f"sweep_{ci}"] = {f: _gate_ladder(
            np.asarray(getattr(r, f)[sl], float),
            np.array([getattr(x, f) for x in refs]), f"sweep cfg {ci} {f}")
            for f in LADDER_FIELDS}
    cfg = [c for c in GEN_CFG for _ in range(6)]
    gg = GenGrid.from_points(
        [GEN_BP_LAM] * len(cfg), m.alpha_decode, m.tau0_decode,
        m.alpha_prefill, m.tau0_prefill, prompt_len=GEN_PROMPT,
        gen_tokens=32, max_active=64, discipline=[c[0] for c in cfg],
        q_max=[c[2] for c in cfg], deadline=[c[3] for c in cfg],
        overflow=[c[1] for c in cfg], retry_rate=[c[4] for c in cfg])
    # a_cap sized so the arrival chain always covers its windows: the
    # run-structured numpy mirror has no coverage splits
    r = _counted(lambda: gen_sweep(gg, n_steps=6000, q_cap=64, a_cap=96,
                                   r_cap=64, seed=5, device=dev),
                 -(-6000 // 2048) * 2048 // 16, "gen ladder", compact=True)
    check_accounting(r, "gen ladder")
    for ci, (disc, ov, qm, dl, rate) in enumerate(GEN_CFG):
        refs = [simulate_gen_loss_numpy(
            GEN_BP_LAM, m, prompt_len=GEN_PROMPT, gen_tokens=32,
            max_active=64, discipline=disc, q_max=qm, deadline=dl,
            overflow=ov, retry_rate=rate, q_cap=64, r_cap=64,
            n_steps=20_000, seed=s) for s in range(3)]
        sl = slice(ci * 6, (ci + 1) * 6)
        ladders[f"gen_{ci}"] = {f: _gate_ladder(
            np.asarray(getattr(r, f)[sl], float),
            np.array([getattr(x, f) for x in refs]), f"gen cfg {ci} {f}")
            for f in LADDER_FIELDS}
    emit("loss_contracts", neutral_bitwise=True, split_bitwise=True,
         accounting=True, launches_per_superstep=True, ladders=ladders)


def loss_grid(tiles: int = 43) -> SweepGrid:
    """benchmarks/backpressure.py's 192-point grid tiled ``tiles`` times:
    the copies of a point differ only in their global index, so they
    form a seed ladder."""
    cap = BP_B_MAX / (V100[0] * BP_B_MAX + V100[1])
    base = SweepGrid.from_product([r * cap for r in BP_RHOS], [V100[0]],
                                  [V100[1]], b_maxes=[BP_B_MAX],
                                  q_maxes=BP_Q_MAXES, deadlines=BP_DEADLINES,
                                  overflows=BP_OVERFLOWS,
                                  retry_rates=BP_RETRY)
    return base.take(np.tile(np.arange(len(base)), tiles))


def _tile_stats(vals: np.ndarray, n_base: int, i: int) -> dict:
    """Mean and standard error of point ``i``'s copies across tiles."""
    x = np.asarray(vals, float)[i::n_base]
    return {"mean": float(x.mean()),
            "se": float(x.std(ddof=1) / math.sqrt(len(x)))}


def phase_loss_user_size(dev, tiles: int = 43, n_batches: int = 3000,
                         capture_at: int = 60) -> tuple:
    """The backpressure benchmark's grid at 8,256 points, its run
    (a_cap 64, r_cap 96, seed 29); returns the record, the hist_update
    launches and the path block of superstep ``capture_at``."""
    grid = loss_grid(tiles)
    n_base = len(grid) // tiles
    kw = dict(n_batches=n_batches, a_cap=64, r_cap=96, seed=29, device=dev)
    supersteps = -(-n_batches // 32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = _counted(lambda: sweep(grid, **kw), supersteps, "loss user-size sweep")
    first_s = time.perf_counter() - t0
    launches = ss.hist_update.launches
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    r2 = sweep(grid, **kw)
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    for f in ("hist", "mean_latency", "overflow_dropped", "abandoned",
              "n_in_slo", "n_retry"):
        check(np.array_equal(getattr(r, f), getattr(r2, f)),
              f"two loss user-size runs give the same bits on {f}")
    check_accounting(r, "loss user-size")
    cap = BP_B_MAX / (V100[0] * BP_B_MAX + V100[1])

    def index(rho, q_max, deadline, overflow, retry) -> int:
        m = (np.isclose(grid.lam[:n_base], np.float32(rho * cap))
             & (grid.q_max[:n_base] == q_max)
             & (grid.deadline[:n_base] == np.float32(deadline))
             & (grid.overflow[:n_base] == OVERFLOW_CODE[overflow])
             & (grid.retry_rate[:n_base] == np.float32(retry)))
        (i,) = np.flatnonzero(m)
        return int(i)

    # a larger room turns fewer arrivals away (reject, no deadline, no
    # retry), at every load
    rooms = {}
    for rho in BP_RHOS:
        fr = [_tile_stats(r.reject_frac, n_base,
                          index(rho, q, 0.0, "reject", 0.0))["mean"]
              for q in BP_Q_MAXES]
        check(all(a >= b for a, b in zip(fr, fr[1:])) and fr[0] > fr[-1],
              f"rho={rho}: reject_frac {fr} falls as q_max grows")
        rooms[str(rho)] = fr
    frontier = {}
    for q in BP_Q_MAXES:
        i = index(1.1, q, 12.0, "reject", 0.0)
        frontier[str(q)] = {f: _tile_stats(getattr(r, f), n_base, i)
                            for f in ("mean_latency", "goodput_frac",
                                      "reject_frac")}
    i0 = index(1.3, 8, 12.0, "reject", 0.0)
    i1 = index(1.3, 8, 12.0, "reject", 0.2)
    tax = {"retry_inflation": _tile_stats(r.retry_inflation, n_base, i1),
           "goodput_frac_no_retry": _tile_stats(r.goodput_frac, n_base, i0),
           "goodput_frac_retry": _tile_stats(r.goodput_frac, n_base, i1),
           "EW_no_retry": _tile_stats(r.mean_latency, n_base, i0),
           "EW_retry": _tile_stats(r.mean_latency, n_base, i1)}
    jobs = int(r.n_jobs.sum())
    out = dict(points=len(grid), tiles=tiles, n_batches=n_batches,
               caps=dict(sweep_caps(grid), a_cap=64, r_cap=96),
               first_call_s=first_s, warm_s=warm_s, jobs=jobs,
               jobs_per_s_warm=jobs / warm_s, peak_mem_bytes=peak,
               launches=launches, supersteps=supersteps,
               reject_frac_by_room=rooms, frontier_rho_1_1=frontier,
               retry_tax_rho_1_3_q8=tax,
               goodput_frac_mean=float(r.goodput_frac.mean()),
               retry_inflation_max=float(r.retry_inflation.max()))
    emit("loss_user_size", **out)
    blocks = capture_blocks(lambda: sweep(grid, **kw), capture_at,
                            "hist_update")
    return out, launches, blocks["hist_update"]


def gen_loss_grid(grid: GenGrid, tiles: int = 16) -> GenGrid:
    """``gen_grid``'s points with loss axes by tile: tiles 0–3 neutral,
    4–7 reject at q_max 20, 8–11 drop at q_max 20 with retries at 0.05,
    12–15 reject at q_max 20 with retries at 0.05 and a deadline of
    twice the point's unloaded latency (prefill + gen decode steps)."""
    n = len(grid)
    tile = np.arange(n) // (n // tiles)
    band = tile // (tiles // 4)
    unloaded = (grid.alpha_prefill * grid.prompt_len + grid.tau0_prefill
                + grid.gen_tokens * (grid.alpha_decode + grid.tau0_decode))
    return dataclasses.replace(
        grid, q_max=np.where(band > 0, 20, 0).astype(np.int32),
        overflow=np.where(band == 2, OVERFLOW_CODE["drop"],
                          OVERFLOW_CODE["reject"]).astype(np.int32),
        retry_rate=np.where(band >= 2, 0.05, 0.0).astype(np.float32),
        deadline=np.where(band == 3, 2.0 * unloaded, 0.0).astype(np.float32))


def phase_gen_loss_user_size(dev, grid: GenGrid, base, n_steps: int = 4096,
                             capture_at: int = 160) -> tuple:
    """The generate sweep's loss path at full width: ``gen_grid`` with
    loss tiles, caps pinned to the base run's; tiles 0–3 bitwise equal
    to ``base`` (``gen_user_size``'s run: same seed, same indices).
    Returns the record and the path blocks of superstep
    ``capture_at``."""
    lgrid = gen_loss_grid(grid)
    caps = gen_caps(grid)
    caps["r_cap"] = gen_caps(lgrid)["r_cap"]
    kw = dict(n_steps=n_steps, seed=29, device=dev, **caps)
    supersteps = n_steps // 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = _counted(lambda: gen_sweep(lgrid, **kw), supersteps,
                 "gen loss user-size sweep", compact=True)
    first_s = time.perf_counter() - t0
    launches = {"hist_update": ss.hist_update.launches,
                "fifo_compact": ss.fifo_compact.launches}
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r2 = gen_sweep(lgrid, **kw)
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    check(np.array_equal(r.hist, r2.hist)
          and np.array_equal(r.n_in_slo, r2.n_in_slo),
          "two gen loss user-size runs give the same bits")
    check_accounting(r, "gen loss user-size")
    neutral = np.arange(4 * len(grid) // 16)
    check(bool(np.all(lgrid.q_max[neutral] == 0)
               and np.all(lgrid.retry_rate[neutral] == 0)
               and np.all(lgrid.deadline[neutral] == 0)), "tiles 0-3 neutral")
    for f in ("mean_latency", "mean_batch", "batch_m2", "utilization",
              "n_jobs", "n_steps", "max_queue", "hist", "stderr"):
        check(np.array_equal(getattr(r, f)[neutral],
                             getattr(base, f)[neutral], equal_nan=True),
              f"gen loss tiles 0-3 bitwise equal to gen_user_size on {f}")
    bands = {}
    per = len(grid) // 4
    for bi, name in enumerate(("neutral", "reject", "drop_retry",
                               "reject_deadline_retry")):
        sl = slice(bi * per, (bi + 1) * per)
        bands[name] = {f: float(np.mean(getattr(r, f)[sl])) for f in (
            "goodput_frac", "reject_frac", "abandon_frac", "retry_inflation",
            "mean_latency")}
    # each loss band shows its regime at work: turned-away arrivals,
    # re-arrivals from the orbit, completions past the deadline
    check(bands["reject"]["reject_frac"] > 0
          and bands["drop_retry"]["retry_inflation"] > 1
          and bands["reject_deadline_retry"]["retry_inflation"] > 1
          and bands["reject_deadline_retry"]["goodput_frac"] < 1,
          f"the loss bands show their regimes: {bands}")
    jobs = int(r.n_jobs.sum())
    out = dict(points=len(lgrid), n_steps=n_steps, caps=caps,
               buffer_length=buffer_length(caps["q_cap"], caps["a_cap"],
                                           int(grid.max_active.max()),
                                           caps["r_cap"]),
               first_call_s=first_s, warm_s=warm_s, requests=jobs,
               requests_per_s_warm=jobs / warm_s, peak_mem_bytes=peak,
               launches=launches, supersteps=supersteps,
               neutral_tiles_bitwise=True, bands=bands)
    emit("gen_loss_user_size", **out)
    return out, capture_blocks(lambda: gen_sweep(lgrid, **kw), capture_at,
                               "fifo_compact")


def _attn_inputs(dev, dtype, b, s, h, kv, hd, seed, decode=False):
    gen = torch.Generator(device=dev).manual_seed(seed)
    qshape = (b, h, hd) if decode else (b, s, h, hd)
    q, k, v = (torch.randn(shape, device=dev, generator=gen).to(dtype)
               for shape in (qshape, (b, s, kv, hd), (b, s, kv, hd)))
    return q, k, v


def _attn_bound(dtype, io_elems: int, pairs: int, hd: int) -> dict:
    """Least time for attention over ``pairs`` admitted (query head,
    key) pairs: ``io_elems`` elements read once or written once, and
    2·hd multiply-adds (q·k and p·v) per admitted pair."""
    elt = torch.finfo(dtype).bits // 8
    bytes_moved = elt * io_elems
    flops = 4 * hd * pairs
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bytes=bytes_moved, flops=flops,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _check_flash(dev, dtype, b, s, h, kv, hd, *, causal=True, window=0,
                 seed=0, timed=False) -> dict:
    q, k, v = _attn_inputs(dev, dtype, b, s, h, kv, hd, seed)
    got = flash_attention(q, k, v, causal=causal, window=window)
    again = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    case = dict(kernel="flash_attention", dtype=str(dtype), batch=b, seq=s,
                heads=h, kv_heads=kv, head_dim=hd, causal=causal,
                window=window, max_abs_err=err)
    check(bool(torch.isfinite(got).all()) and err <= ATTN_TOL[dtype],
          f"flash_attention vs plain: {case}")
    check(torch.equal(got, again), f"flash_attention repeats bitwise: {case}")
    if timed:
        pos = torch.arange(s)
        adm = torch.ones(s, s, dtype=torch.bool)
        if causal:
            adm &= pos[None, :] <= pos[:, None]
        if window:
            adm &= pos[:, None] - pos[None, :] < window
        case.update(_attn_bound(dtype, 2 * q.numel() + 2 * k.numel(),
                                b * h * int(adm.sum()), hd))
        case["kernel_ms"] = time_ms(lambda: flash_attention(
            q, k, v, causal=causal, window=window))
        case["plain_ms"] = time_ms(lambda: flash_attention_plain(
            q, k, v, causal=causal, window=window), reps=3, warm=1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        case["library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
        case["library_note"] = ("scaled_dot_product_attention(is_causal) "
                                "on (B, H, S, hd) copies made beforehand")
    return case


def _check_decode(dev, dtype, b, s, h, kv, hd, lengths, *, window=0,
                  seed=0, timed=False) -> dict:
    q, k, v = _attn_inputs(dev, dtype, b, s, h, kv, hd, seed, decode=True)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    got = decode_attention(q, k, v, lens, window=window)
    again = decode_attention(q, k, v, lens, window=window)
    want = decode_attention_plain(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    splits = decode_splits(b, kv, s, hd, torch.cuda.get_device_properties(
        dev).multi_processor_count)[0]
    case = dict(kernel="decode_attention", dtype=str(dtype), batch=b,
                cache=s, heads=h, kv_heads=kv, head_dim=hd, window=window,
                lengths=[min(lengths), max(lengths)], splits=splits,
                max_abs_err=err)
    check(bool(torch.isfinite(got).all()) and err <= ATTN_TOL[dtype],
          f"decode_attention vs plain: {case}")
    check(torch.equal(got, again),
          f"decode_attention repeats bitwise (split merge): {case}")
    empty = [i for i, n in enumerate(lengths) if n < 0]
    check(bool((got[empty] == 0).all()),
          f"decode_attention: a row of length -1 gives 0: {case}")
    if timed:
        admitted = [max(0, min(s, n + 1) - (max(0, n - window + 1)
                                            if window else 0))
                    for n in lengths]
        cache_elems = 2 * sum(admitted) * kv * hd
        case.update(_attn_bound(dtype, 2 * q.numel() + cache_elems,
                                sum(admitted) * h, hd))
        case["bytes"] += 4 * b
        case["kernel_ms"] = time_ms(lambda: decode_attention(
            q, k, v, lens, window=window))
        case["plain_ms"] = time_ms(lambda: decode_attention_plain(
            q, k, v, lens, window=window))
        pos = torch.arange(s, device=dev)
        mask = (pos[None, :] <= lens.long()[:, None])[:, None, None, :]
        qt = q[:, :, None, :]
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        case["library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
        case["library_note"] = ("scaled_dot_product_attention with a "
                                "boolean length mask on (B, KV, S, hd) "
                                "copies made beforehand")
    return case


def phase_attn_kernel(dev) -> dict:
    """B3 and B4 against their plain versions on the card, at the serve
    path's shapes and the long serve shapes (timed), at phi4-mini's GQA
    heads, with a window, ragged lengths and in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_config(SERVE_ARCH)
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cache = SERVE_PROMPT + SERVE_GEN + 1
    long_cache = LONG_PROMPT + LONG_GEN + 1
    cases = []
    for b in (1, 2, 4, 8, 16):
        cases.append(_check_flash(dev, bf16, b, SERVE_PROMPT, h, kv, hd,
                                  seed=b))
        cases.append(_check_decode(dev, bf16, b, cache, h, kv, hd,
                                   [SERVE_PROMPT + i % SERVE_GEN
                                    for i in range(b)], seed=b))
    out = {}
    # timed: the serve path's largest batch at its last decode step, and
    # the long shapes at theirs
    out["flash_serve"] = _check_flash(dev, bf16, 32, SERVE_PROMPT, h, kv, hd,
                                      seed=32, timed=True)
    out["decode_serve"] = _check_decode(
        dev, bf16, 32, cache, h, kv, hd, [SERVE_PROMPT + SERVE_GEN - 1] * 32,
        seed=32, timed=True)
    out["flash_long"] = _check_flash(dev, bf16, 32, LONG_PROMPT, h, kv, hd,
                                     seed=33, timed=True)
    out["decode_long"] = _check_decode(
        dev, bf16, 32, long_cache, h, kv, hd,
        [LONG_PROMPT + LONG_GEN - 1] * 32, seed=33, timed=True)
    # batch 1 at the long shapes: one request's prefill, and its decode
    # over the cache split across blocks
    out["flash_batch1"] = _check_flash(dev, bf16, 1, LONG_PROMPT, h, kv, hd,
                                       seed=34, timed=True)
    out["decode_batch1"] = _check_decode(
        dev, bf16, 1, long_cache, h, kv, hd, [LONG_PROMPT + LONG_GEN - 1],
        seed=34, timed=True)
    cases += list(out.values())
    # batch 1 on the long cache with lengths that leave all, all but one
    # or some of the splits empty, and four ragged rows
    for i, n in enumerate((-1, 0, 63, 64, 500)):
        cases.append(_check_decode(dev, bf16, 1, long_cache, h, kv, hd, [n],
                                   seed=35 + i))
    cases.append(_check_decode(dev, bf16, 4, long_cache, h, kv, hd,
                               [-1, 5, 600, long_cache - 1], seed=40))
    phi4 = get_config("phi4-mini-3.8b")
    gh, gkv, ghd = phi4.num_heads, phi4.num_kv_heads, phi4.head_dim
    ragged = [0, 1, 250, 299, 511, 300, 17, 400]
    for dt in (bf16, f32):
        cases.append(_check_flash(dev, dt, 3, 300, gh, gkv, ghd, seed=40))
        cases.append(_check_decode(dev, dt, 8, 523, gh, gkv, ghd, ragged,
                                   seed=41))
        cases.append(_check_flash(dev, dt, 2, 200, h, kv, hd, window=64,
                                  seed=42))
        cases.append(_check_flash(dev, dt, 2, 77, h, kv, hd, causal=False,
                                  window=9, seed=43))
        cases.append(_check_decode(dev, dt, 8, 523, h, kv, hd, ragged,
                                   window=100, seed=44))
    cases.append(_check_flash(dev, f32, 32, SERVE_PROMPT, h, kv, hd,
                              seed=45))
    cases.append(_check_decode(dev, f32, 32, cache, h, kv, hd,
                               list(range(SERVE_PROMPT, SERVE_PROMPT + 32)),
                               seed=46))
    # a row whose length admits no position gives 0
    q, k, v = _attn_inputs(dev, bf16, 2, cache, h, kv, hd, 47, decode=True)
    lens = torch.tensor([-1, 5], dtype=torch.int32, device=dev)
    got = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    check(bool((got[0] == 0).all()), "decode_attention: no admitted "
          "position gives 0")
    emit("attn_kernel", cases=cases,
         worst_bf16=max(c["max_abs_err"] for c in cases
                        if c["dtype"] == str(bf16)),
         worst_f32=max(c["max_abs_err"] for c in cases
                       if c["dtype"] == str(f32)))
    return out


def _attn_launches() -> dict:
    return {"flash_attention": flash_attention.launches,
            "decode_attention": decode_attention.launches}


def _reset_attn_launches() -> None:
    flash_attention.launches = 0
    decode_attention.launches = 0


def _check_per_batch(n_layers: int, gen_tokens: int, batches: int,
                     launches: dict, what: str) -> None:
    want = {"flash_attention": n_layers * batches,
            "decode_attention": n_layers * gen_tokens * batches}
    check(launches == want, f"{what}: {batches} batches launched "
          f"{launches}, expected {want}")


def phase_serve(dev) -> dict:
    """The port's launch.serve path as a user runs it."""
    cfg = get_config(SERVE_ARCH)
    args = serve_cli.parse_args(SERVE_ARGS)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_attn_launches()
    t0 = time.perf_counter()
    out = serve_cli.run(args)
    seconds = time.perf_counter() - t0
    launches = _attn_launches()
    eng, res = out["engine"], out["result"]
    batches = eng.batches_run
    peak = torch.cuda.max_memory_allocated(dev)
    _check_per_batch(cfg.num_layers, SERVE_GEN, batches, launches, "serve")
    check(res.n_jobs == args.jobs and len(res.latencies) == args.jobs
          and int(res.batch_sizes.sum()) >= args.jobs,
          f"serve: {len(res.latencies)} of {args.jobs} jobs served")
    check(bool(np.all(np.isfinite(res.latencies))
               and np.all(res.latencies > 0)), "serve: finite latencies")
    check(all(t > 0 for t in out["tau_s"]), "serve: positive τ^[b]")
    # one more batch, outside the counted run: exactly 24 and 24 × 4
    before = _attn_launches()
    eng.run_batch(eng.max_batch)
    one = {k: n - before[k] for k, n in _attn_launches().items()}
    _check_per_batch(cfg.num_layers, SERVE_GEN, 1, one, "one batch")
    batch = eng._make_batch(eng.max_batch)
    toks = eng._fns[eng.max_batch](eng.params, batch)
    check(tuple(toks.shape) == (eng.max_batch, SERVE_GEN)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "serve: generated tokens in the vocabulary")
    with torch.inference_mode():
        logits, _ = eng.bundle.forward(eng.params, batch)
    check(bool(torch.isfinite(logits).all()), "serve: finite bf16 logits")
    info = dict(arch=SERVE_ARCH, dtype=cfg.dtype, args=SERVE_ARGS,
                seconds=seconds, buckets=out["buckets"],
                tau_ms=[t * 1e3 for t in out["tau_s"]],
                alpha_ms=out["alpha_s"] * 1e3, tau0_ms=out["tau0_s"] * 1e3,
                r2=out["r2"], lam_per_s=out["lam"],
                mean_latency_ms=res.mean_latency * 1e3,
                phi_ms=out["phi_s"] * 1e3,
                p50_ms=res.latency_p50 * 1e3, p99_ms=res.latency_p99 * 1e3,
                mean_batch=res.mean_batch, utilization=res.utilization,
                jobs=res.n_jobs, served_batches=len(res.batch_sizes),
                batches_run=batches, launches=launches,
                peak_mem_bytes=peak)
    emit("serve", **info)
    del eng, out, batch, logits
    torch.cuda.empty_cache()
    return info


def phase_serve_long(dev, jobs: int = 300) -> dict:
    """The served model on a 1,024-token prompt and 32 generated tokens:
    calibrated on batches 1…32, then serving ``jobs`` Poisson requests
    at ρ = 0.5 of the fit, as ``launch.serve`` does."""
    cfg = get_config(SERVE_ARCH)
    eng = InferenceEngine(cfg, workload="generate", seq_len=LONG_PROMPT,
                          gen_tokens=LONG_GEN, max_batch=32)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_attn_launches()
    t0 = time.perf_counter()
    b, tau = eng.calibrate(samples=3)
    model, r2 = fit_service_model(b, tau)
    lam = 0.5 / model.alpha
    res = eng.serve_poisson(lam, n_jobs=jobs, seed=0, warmup=False)
    seconds = time.perf_counter() - t0
    launches = _attn_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    _check_per_batch(cfg.num_layers, LONG_GEN, eng.batches_run, launches,
                     "serve_long")
    check(bool(np.all(np.isfinite(tau)) and np.all(tau > 0)),
          "serve_long: positive τ^[b]")
    check(len(res.latencies) == jobs
          and bool(np.all(np.isfinite(res.latencies))),
          "serve_long: every job served, finite latencies")
    info = dict(arch=SERVE_ARCH, dtype=cfg.dtype, prompt=LONG_PROMPT,
                gen_tokens=LONG_GEN, seconds=seconds, buckets=b.tolist(),
                tau_ms=(tau * 1e3).tolist(), alpha_ms=model.alpha * 1e3,
                tau0_ms=model.tau0 * 1e3, r2=r2, lam_per_s=lam,
                mean_latency_ms=res.mean_latency * 1e3,
                phi_ms=float(phi(lam, model.alpha, model.tau0)) * 1e3,
                p50_ms=res.latency_p50 * 1e3, p99_ms=res.latency_p99 * 1e3,
                mean_batch=res.mean_batch, utilization=res.utilization,
                served_batches=len(res.batch_sizes),
                batches_run=eng.batches_run, launches=launches,
                peak_mem_bytes=peak)
    emit("serve_long", **info)
    del eng
    torch.cuda.empty_cache()
    return info


def _consistency(dev, arch: str, prompt: int, extra: int = 3) -> dict:
    """``arch`` at full width in float32 from the port's seeded init,
    batch 2: the logits of prefill(prompt) and ``extra`` decode steps
    against the forward logits of the whole sequence, within 3e-4 (abs
    + rel)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=dev).manual_seed(5))
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(2, prompt + extra)), device=dev)
    with torch.inference_mode():
        ref, _ = bundle.forward(params, {"tokens": toks})
        lg, cache = bundle.prefill(params, {"tokens": toks[:, :prompt]},
                                   prompt + extra)
        got = [lg[:, 0]]
        lengths = torch.full((2,), prompt, dtype=torch.int32, device=dev)
        for t in range(extra):
            lg, cache = bundle.decode_step(
                params, toks[:, prompt + t:prompt + t + 1], cache, lengths)
            got.append(lg[:, 0])
            lengths = lengths + 1
    want = ref[:, prompt - 1:]
    got = torch.stack(got, dim=1)
    diff = (got - want).abs()
    tol = 3e-4
    worst = float((diff / (tol + tol * want.abs())).max())
    info = dict(arch=arch, dtype="float32", batch=2, prompt=prompt,
                decode_steps=extra, max_abs_diff=float(diff.max()),
                max_abs_logit=float(want.abs().max()),
                tolerance=f"|diff| <= {tol} + {tol}*|forward|",
                worst_over_tol=worst)
    check(bool(torch.isfinite(got).all()) and worst <= 1.0,
          f"consistency of {arch}: {info}")
    del params, cache, ref
    torch.cuda.empty_cache()
    return info


def phase_model_consistency(dev) -> dict:
    """qwen1.5-0.5b at full width in float32: prefill + decode logits
    against the forward logits of the whole sequence."""
    info = _consistency(dev, SERVE_ARCH, SERVE_PROMPT)
    emit("model_consistency", **info)
    return info


def _ssd_inputs(dev, dtype, b, s, nh, g, hd, ds, seed):
    """tests/test_kernels.py's distributions; B and C are strided slices
    of one (b, s, 2·g·ds) activation, as the model passes them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(b, s, nh, hd, device=dev, generator=gen) * 0.5
         ).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, nh, device=dev, generator=gen))
    a = -torch.exp(torch.randn(nh, device=dev, generator=gen) * 0.3)
    bc = (torch.randn(b, s, 2 * g * ds, device=dev, generator=gen) * 0.3
          ).to(dtype)
    return (x, dt, a, bc[..., :g * ds].reshape(b, s, g, ds),
            bc[..., g * ds:].reshape(b, s, g, ds))


def _check_ssd(dev, dtype, b, s, *, g=1, seed=0, timed=False) -> dict:
    model = get_config(SSM_ARCH)
    cfg = model.ssm
    nh, hd, ds = cfg.n_heads(model.d_model), cfg.head_dim, cfg.d_state
    args = _ssd_inputs(dev, dtype, b, s, nh, g, hd, ds, seed)
    y, h = ssd_chunked(*args, cfg.chunk_size)
    again = ssd_chunked(*args, cfg.chunk_size)
    want_y, want_h = ssd_scan_plain(*args, cfg.chunk_size)
    api = ssd_scan(*args, chunk=cfg.chunk_size)
    torch.cuda.synchronize()
    err_y = float((y - want_y).abs().max())
    err_state = float((h - want_h).abs().max())
    # the bf16 route splits the time axis at small batch; float32 never
    splits = (ssd_splits(b, s, nh, torch.cuda.get_device_properties(
        dev).multi_processor_count)[0] if dtype == torch.bfloat16 else 1)
    case = dict(kernel="ssd_scan", dtype=str(dtype), batch=b, seq=s,
                heads=nh, groups=g, head_dim=hd, d_state=ds, splits=splits,
                max_abs_err=max(err_y, err_state), err_y=err_y,
                err_state=err_state, max_abs_y=float(want_y.abs().max()),
                max_abs_state=float(want_h.abs().max()))
    check(bool(torch.isfinite(y).all() and torch.isfinite(h).all())
          and case["max_abs_err"] <= SSD_TOL[dtype],
          f"ssd_scan vs plain: {case}")
    check(torch.equal(api, y.to(dtype)),
          f"ssd_scan's y is the model call's, rounded: {case}")
    check(dtype != torch.bfloat16
          or (torch.equal(y, again[0]) and torch.equal(h, again[1])),
          f"ssd_scan repeats bitwise (split combine included): {case}")
    if timed:
        elt = torch.finfo(dtype).bits // 8
        x, dt, a, bm, cm = args
        bytes_moved = (elt * (x.numel() + bm.numel() + cm.numel())
                       + 4 * (dt.numel() + a.numel() + y.numel()
                              + h.numel()))
        # the recurrence's two products per step and head: x ⊗ B into
        # the state, and the state against C
        flops = 4 * b * s * nh * hd * ds
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        case.update(bytes=bytes_moved, flops=flops,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations")
        case["kernel_ms"] = time_ms(lambda: ssd_chunked(*args,
                                                        cfg.chunk_size))
        case["plain_ms"] = time_ms(lambda: ssd_scan_plain(
            *args, cfg.chunk_size), reps=3, warm=1)
        case["library_ms"] = None
        case["library_note"] = ("no single PyTorch call computes the SSD "
                                "scan")
    del args, y, h, again, want_y, want_h, api
    torch.cuda.empty_cache()
    return case


def phase_ssd_kernel(dev) -> dict:
    """B5 against its plain version on the card at the Mamba2 serve
    path's shapes (timed), the batches around the split rule's steps
    (B 1, 2, 4 at S 1,024), ragged lengths split and unsplit, batch 1
    at the serve prompt, float32 and two groups; every bf16 case twice,
    bitwise."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    out = {"serve": _check_ssd(dev, bf16, 32, SSM_PROMPT, seed=1,
                               timed=True),
           "long": _check_ssd(dev, bf16, 32, SSM_LONG, seed=2, timed=True),
           "batch1": _check_ssd(dev, bf16, 1, SSM_LONG, seed=3, timed=True)}
    cases = list(out.values()) + [
        _check_ssd(dev, bf16, 32, 1000, seed=4),
        _check_ssd(dev, f32, 4, 300, seed=5),
        _check_ssd(dev, bf16, 4, 1000, g=2, seed=6),
        _check_ssd(dev, bf16, 2, SSM_LONG, seed=7),
        _check_ssd(dev, bf16, 4, SSM_LONG, seed=8),
        _check_ssd(dev, bf16, 1, 1000, seed=9),
        _check_ssd(dev, bf16, 1, SSM_PROMPT, seed=10)]
    emit("ssd_kernel", cases=cases,
         worst_bf16=max(c["max_abs_err"] for c in cases
                        if c["dtype"] == str(bf16)),
         worst_f32=max(c["max_abs_err"] for c in cases
                       if c["dtype"] == str(f32)),
         splits={f"{c['batch']}x{c['seq']}": c["splits"] for c in cases
                 if c["dtype"] == str(bf16)})
    return out


def _all_launches() -> dict:
    return {**_attn_launches(), "ssd_scan": ssd_scan.launches}


def phase_serve_ssm(dev) -> dict:
    """The port's launch.serve path on mamba2-2.7b as a user runs it."""
    cfg = get_config(SSM_ARCH)
    args = serve_cli.parse_args(SSM_ARGS)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_attn_launches()
    ssd_scan.launches = 0
    t0 = time.perf_counter()
    out = serve_cli.run(args)
    seconds = time.perf_counter() - t0
    launches = _all_launches()
    eng, res = out["engine"], out["result"]
    batches = eng.batches_run
    peak = torch.cuda.max_memory_allocated(dev)
    want = {"flash_attention": 0, "decode_attention": 0,
            "ssd_scan": cfg.num_layers * batches}
    check(launches == want, f"serve_ssm: {batches} batches launched "
          f"{launches}, expected {want}")
    check(res.n_jobs == args.jobs and len(res.latencies) == args.jobs
          and int(res.batch_sizes.sum()) >= args.jobs,
          f"serve_ssm: {len(res.latencies)} of {args.jobs} jobs served")
    check(bool(np.all(np.isfinite(res.latencies))
               and np.all(res.latencies > 0)),
          "serve_ssm: finite latencies")
    check(all(t > 0 for t in out["tau_s"]), "serve_ssm: positive τ^[b]")
    # one more batch, outside the counted run: exactly 64 launches
    before = _all_launches()
    eng.run_batch(eng.max_batch)
    one = {k: n - before[k] for k, n in _all_launches().items()}
    want_one = dict(want, ssd_scan=cfg.num_layers)
    check(one == want_one, f"serve_ssm: one batch launched {one}, "
          f"expected {want_one}")
    batch = eng._make_batch(eng.max_batch)
    toks = eng._fns[eng.max_batch](eng.params, batch)
    check(tuple(toks.shape) == (eng.max_batch, SERVE_GEN)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "serve_ssm: generated tokens in the vocabulary")
    with torch.inference_mode():
        logits, _ = eng.bundle.forward(eng.params, batch)
    check(bool(torch.isfinite(logits).all()),
          "serve_ssm: finite bf16 logits")
    info = dict(arch=SSM_ARCH, dtype=cfg.dtype, args=SSM_ARGS,
                seconds=seconds, buckets=out["buckets"],
                tau_ms=[t * 1e3 for t in out["tau_s"]],
                alpha_ms=out["alpha_s"] * 1e3, tau0_ms=out["tau0_s"] * 1e3,
                r2=out["r2"], lam_per_s=out["lam"],
                mean_latency_ms=res.mean_latency * 1e3,
                phi_ms=out["phi_s"] * 1e3,
                p50_ms=res.latency_p50 * 1e3, p99_ms=res.latency_p99 * 1e3,
                mean_batch=res.mean_batch, utilization=res.utilization,
                jobs=res.n_jobs, served_batches=len(res.batch_sizes),
                batches_run=batches, launches=launches,
                peak_mem_bytes=peak)
    emit("serve_ssm", **info)
    del eng, out, batch, logits
    torch.cuda.empty_cache()
    return info


def phase_ssm_consistency(dev) -> dict:
    """mamba2-2.7b in float32: prefill(300) crosses the 256-token chunk,
    so the kernel's final state carries into the decode steps."""
    info = _consistency(dev, SSM_ARCH, 300)
    emit("ssm_consistency", **info)
    return info


def _kernel_row(name: str, path: str, launches: int, k: dict,
                **extra) -> dict:
    source, replaces, tpu_ref = KERNELS[name]
    return {"name": name, "path": path, "route": "cuda", "source": source,
            "replaces": replaces, "tpu_ref": tpu_ref, "impl": "cuda",
            "launches": launches,
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k.get("bound_by", "bytes"),
            "library_ms": k["library_ms"],
            "matches_plain": True, **extra}


def _path_keys(k: dict) -> dict:
    """A path block's numbers for the ``kernels`` line."""
    keys = {"path_ms": k["kernel_ms"], "path_plain_ms": k["plain_ms"],
            "path_bound_ms": k["bound_ms"],
            "path_library_ms": k["library_ms"]}
    if "bound_ms_bytes4" in k:
        keys["path_bound_ms_bytes4"] = k["bound_ms_bytes4"]
    return keys


def path_hist(dev, captured, block: str) -> dict:
    """hist_update on a path block from ``capture_blocks``."""
    args, kw = captured
    return hist_report(dev, *args, n_bins=kw["n_bins"],
                       sketch=kw.get("sketch", False), block=block,
                       emit_as="path_kernel")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    seconds = {}

    def phase(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = round(time.perf_counter() - t0, 3)
        return out

    smi = phase("build", phase_build)
    grid = gen_grid()
    # each path's own hist_update block: the sweep's 32 × 768 and the
    # generate sweep's 16 × s_cap (one 16-step superstep, hist_every=1)
    full = phase("kernel", phase_kernel, dev, sketch=False)
    sketch = phase("kernel_sketch", phase_kernel, dev, sketch=True)
    gen_block = phase("kernel_gen", phase_kernel, dev, sketch=False,
                      p=len(grid), rows=16,
                      width=int(grid.max_active.max()), block="gen")
    thin = phase("kernel_thinned", phase_kernel, dev, sketch=False,
                 p=len(grid), rows=len(thinned_rows(16, 3)), width=63,
                 block="gen_thinned")
    compact = phase("fifo_compact", phase_fifo_compact, dev)
    phase("hist_cases", phase_hist_cases, dev)
    phase("contracts", phase_contracts, dev)
    phase("main", phase_main, dev)
    sweep_launches, captured = phase("user_size", phase_user_size, dev)
    # the sweep's own block, captured mid-run: the kernel on the data
    # the path hands it
    sweep_path = path_hist(dev, captured, "sweep_path")
    phase("gen_contracts", phase_gen_contracts, dev)
    gen, blocks, gen_base = phase("gen_user_size", phase_gen_user_size,
                                  dev, grid)
    gen_path = path_hist(dev, blocks["hist_update"], "gen_path")
    compact_path = compact_report(dev, *blocks["fifo_compact"][0],
                                  "gen_path", emit_as="path_kernel")
    del captured, blocks
    torch.cuda.empty_cache()
    phase("loss_contracts", phase_loss_contracts, dev)
    _, loss_launches, captured = phase("loss_user_size",
                                       phase_loss_user_size, dev)
    loss_path = path_hist(dev, captured, "sweep_loss_path")
    gen_loss, blocks = phase("gen_loss_user_size", phase_gen_loss_user_size,
                             dev, grid, gen_base)
    gen_loss_path = path_hist(dev, blocks["hist_update"], "gen_loss_path")
    compact_loss_path = compact_report(dev, *blocks["fifo_compact"][0],
                                       "gen_loss_path",
                                       emit_as="path_kernel")
    del captured, blocks, gen_base
    torch.cuda.empty_cache()
    attn = phase("attn_kernel", phase_attn_kernel, dev)
    served = phase("serve", phase_serve, dev)
    phase("serve_long", phase_serve_long, dev)
    phase("model_consistency", phase_model_consistency, dev)
    ssd = phase("ssd_kernel", phase_ssd_kernel, dev)
    served_ssm = phase("serve_ssm", phase_serve_ssm, dev)
    phase("ssm_consistency", phase_ssm_consistency, dev)
    emit("phase_seconds", **seconds)
    long_keys = ("kernel_ms", "plain_ms", "bound_ms", "library_ms",
                 "max_abs_err")
    batch1_keys = (("ms", "kernel_ms"), ("plain_ms", "plain_ms"),
                   ("bound_ms", "bound_ms"), ("library_ms", "library_ms"),
                   ("max_abs_err", "max_abs_err"))
    print(json.dumps({"kernels": [
        _kernel_row(
            "hist_update", "gen_user_size", gen["launches"]["hist_update"],
            gen_block,
            max_abs_err=max(gen_block["max_abs_err"], thin["max_abs_err"],
                            gen_path["max_abs_err"]),
            bound_ms_bytes4=gen_block["bound_ms_bytes4"],
            thinned_ms=thin["kernel_ms"], thinned_plain_ms=thin["plain_ms"],
            thinned_bound_ms=thin["bound_ms"],
            thinned_bound_ms_bytes4=thin["bound_ms_bytes4"],
            thinned_library_ms=thin["library_ms"],
            **_path_keys(gen_path)),
        _kernel_row(
            "hist_update", "sweep_user_size", sweep_launches, full,
            max_abs_err=max(full["max_abs_err"], sketch["max_abs_err"],
                            sweep_path["max_abs_err"]),
            bound_ms_bytes4=full["bound_ms_bytes4"],
            sketch_ms=sketch["kernel_ms"], sketch_plain_ms=sketch["plain_ms"],
            sketch_bound_ms=sketch["bound_ms"],
            sketch_bound_ms_bytes4=sketch["bound_ms_bytes4"],
            sketch_library_ms=sketch["library_ms"],
            **_path_keys(sweep_path)),
        _kernel_row("fifo_compact", "gen_user_size",
                    gen["launches"]["fifo_compact"], compact,
                    max_abs_err=max(compact["max_abs_err"],
                                    compact_path["max_abs_err"]),
                    **_path_keys(compact_path)),
        # the loss paths, timed on their own captured blocks
        _kernel_row("hist_update", "sweep_loss_user_size", loss_launches,
                    loss_path, bound_ms_bytes4=loss_path["bound_ms_bytes4"],
                    **_path_keys(loss_path)),
        _kernel_row("hist_update", "gen_loss_user_size",
                    gen_loss["launches"]["hist_update"], gen_loss_path,
                    bound_ms_bytes4=gen_loss_path["bound_ms_bytes4"],
                    **_path_keys(gen_loss_path)),
        _kernel_row("fifo_compact", "gen_loss_user_size",
                    gen_loss["launches"]["fifo_compact"], compact_loss_path,
                    **_path_keys(compact_loss_path)),
        *(_kernel_row(
            name, "serve", served["launches"][name], attn[f"{short}_serve"],
            **{f"long_{k}": attn[f"{short}_long"][k] for k in long_keys},
            long_bound_by=attn[f"{short}_long"]["bound_by"],
            **{f"batch1_{k}": attn[f"{short}_batch1"][key]
               for k, key in batch1_keys},
            batch1_bound_by=attn[f"{short}_batch1"]["bound_by"], **extra)
          for name, short, extra in (
              ("flash_attention", "flash", {}),
              ("decode_attention", "decode",
               {"splits": {k: attn[f"decode_{k}"]["splits"]
                           for k in ("serve", "long", "batch1")}}))),
        _kernel_row(
            "ssd_scan", "serve_ssm", served_ssm["launches"]["ssd_scan"],
            ssd["serve"], library_note=ssd["serve"]["library_note"],
            **{f"long_{k}": ssd["long"][k] for k in long_keys},
            long_bound_by=ssd["long"]["bound_by"],
            **{f"batch1_{k}": ssd["batch1"][key] for k, key in batch1_keys},
            batch1_bound_by=ssd["batch1"]["bound_by"],
            splits={k: ssd[k]["splits"] for k in ("serve", "long",
                                                   "batch1")}),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
