#!/usr/bin/env python3
"""The superstep kernels' variants (B1 ``hist_update``, B2
``fifo_compact``) on the blocks the sweeps really hand them, on the GPU.

    python3 tools/ablate_torch_superstep.py [--parent DIR] [--reps 10]

Captures one mid-run superstep of each path and stops the run there
(``chip_smoke.capture_blocks``): the user-size sweep (``chip_smoke.py``'s
grid, 8,160 points, a 32 × 768 block whose masks are prefixes), the
user-size generate sweep (8,192 points: its 16 × 64 histogram block and
its 8,192 × 1,409 FIFO buffer) and ``chip_smoke.py``'s ``main`` sweep
(5 points, 32 × 1,024).  Beside them, ``chip_smoke.py``'s random blocks
(sweep 32 × 768 in full and sketch mode, generate 16 × 64, thinned 5 ×
63; FIFO with k uniform on [0, n]).  On each block:

- ``hist_update`` under the wrapper's launch plan and with one choice
  of ``hist_update_plan`` changed at a time: the other grouping (one
  warp or a block of 8 warps a point) and the scalar loop in place of
  the vector loop;
- both groupings on the first P points of the two user-size path
  blocks, P from 5 to all of them, the sweep's also cut to its first
  1, 2, 4, 8 or 16 of 32 rows (768 to 12,288 entries a point), and on
  the ``main`` block: the measurement that sets ``hist_update_plan``'s
  grouping rule;
- ``fifo_compact`` with its float4 stores and with the scalar loop.

A variant is a plan of its own passed to this tree's C entry points
(``hist_update_launch``, ``fifo_compact_launch``), which the tool calls
itself: the port's wrappers always take their own plan.  Also,

- with ``--parent DIR`` (the root of another checkout of the
  repository, e.g. a ``git archive`` of the parent commit), that
  checkout's ``hist_update.cu`` and ``fifo_compact.cu``, built into
  ``build/ablate_superstep/`` and called through their own C entry
  points (their own signatures, without a launch plan), timed in
  turns with the wrapper's plan (parent, this, this, parent).

Every variant is held against the plain version on its block (counts
and compaction bit for bit, sketch sums within rtol 1e-6) before it is
timed; each is timed in two rounds, the second in reverse order.
Prints one JSON line with ptxas's registers and spills for this tree's
kernels and the card's name and power limit.  Needs one CUDA device;
imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (V100, build_grid, capture_blocks,  # noqa: E402
                        gen_grid, nvidia_smi, random_hist_block, time_ms)
from repro_torch.core import SweepGrid, gen_sweep, sweep  # noqa: E402
from repro_torch.core import hist as hist_mod  # noqa: E402
from repro_torch.core.hist import thinned_rows  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import superstep as ss  # noqa: E402

OUT = ROOT / "build" / "ablate_superstep"
NAMES = ("hist_update", "fifo_compact")
# point counts of the grouping ladder (capped at the block's own), and
# the rows of the sweep's path block it also runs on
LADDER = (5, 32, 128, 512, 1024, 2048, 3072, 4096, 6144, 8192)
LADDER_ROWS = (1, 2, 4, 8, 16)


def _nvcc(src: Path, out: Path, extra=()) -> subprocess.Popen:
    OUT.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *extra,
                             "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _ptxas(text: str) -> dict:
    """ptxas -v's registers and spill stores for each entry function."""
    rows, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            rows.setdefault(fn, {})
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            rows[fn]["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            rows[fn]["registers"] = int(m.group(1))
    return {f: r for f, r in rows.items() if "registers" in r}


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _this_fns():
    """This tree's two C launch functions, each called with a plan of
    the tool's choosing."""
    h = _build.library("hist_update").hist_update_launch
    h.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + \
        [ctypes.c_int] * 5 + [ctypes.c_int64] + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p]
    h.restype = ctypes.c_int
    c = _build.library("fifo_compact").fifo_compact_launch
    c.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + \
        [ctypes.c_int, ctypes.c_void_p]
    c.restype = ctypes.c_int

    def hist(plan, hists, lats, inc, n_bins, sketch):
        shift, base, _ = hist_mod.bin_params(sketch)
        err = h(lats.data_ptr(), inc.data_ptr(), hists[0].data_ptr(),
                hists[1].data_ptr() if sketch else None, lats.shape[0],
                lats[0].numel(), n_bins, shift, base, plan.warps_per_point,
                plan.points_per_block, plan.smem_bytes, int(plan.vec_loads),
                int(plan.vec_rows), _stream())
        if err:
            raise RuntimeError(f"hist_update {plan}: CUDA error {err}")

    def compact(plan, buf, k, now, out):
        err = c(buf.data_ptr(), k.data_ptr(), now.data_ptr(), out.data_ptr(),
                buf.shape[0], buf.shape[1], int(plan.vec), _stream())
        if err:
            raise RuntimeError(f"fifo_compact {plan}: CUDA error {err}")
    return hist, compact


def _parent_fns(procs: dict):
    """The parent checkout's two C launch functions, with their own
    signatures."""
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's {name}.cu:\n"
                               f"{err}")
        libs[name] = ctypes.CDLL(str(OUT / f"libparent_{name}.so"))
    h = libs["hist_update"].hist_update_launch
    h.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    h.restype = ctypes.c_int
    c = libs["fifo_compact"].fifo_compact_launch
    c.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + \
        [ctypes.c_void_p]
    c.restype = ctypes.c_int

    def hist(hists, lats, inc, n_bins, sketch):
        shift, base, _ = hist_mod.bin_params(sketch)
        err = h(lats.data_ptr(), inc.data_ptr(), hists[0].data_ptr(),
                hists[1].data_ptr() if sketch else None, lats.shape[0],
                lats[0].numel(), n_bins, shift, base, _stream())
        if err:
            raise RuntimeError(f"parent hist_update: CUDA error {err}")

    def compact(buf, k, now, out):
        err = c(buf.data_ptr(), k.data_ptr(), now.data_ptr(), out.data_ptr(),
                buf.shape[0], buf.shape[1], _stream())
        if err:
            raise RuntimeError(f"parent fifo_compact: CUDA error {err}")
    return hist, compact


def _grouping(plan: ss.HistPlan, warps: int, n_points: int) -> ss.HistPlan:
    """``plan`` with ``warps`` warps a point, cut as
    ``hist_update_plan`` cuts that grouping."""
    slice_bytes = plan.smem_bytes // plan.points_per_block
    ppb = min(8 // warps, ss._SMEM_LIMIT // slice_bytes)
    return plan._replace(warps_per_point=warps, points_per_block=ppb,
                         threads=32 * warps * ppb,
                         blocks=-(-n_points // ppb),
                         smem_bytes=ppb * slice_bytes)


def _plan(start, lats, inc, n_bins, sketch) -> ss.HistPlan:
    return ss.hist_update_plan(lats.shape[0], lats[0].numel(), n_bins,
                               sketch=sketch, lats_ptr=lats.data_ptr(),
                               inc_ptr=inc.data_ptr(),
                               row_ptrs=[t.data_ptr() for t in start])


def _rounds(fns: dict, reps: int) -> dict:
    """Each function timed twice, the second round in reverse order."""
    out = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            out[name].append(time_ms(fns[name], reps=reps))
    return out


def _timed_plans(name, launch, plans, start, lats, inc, n_bins, sketch,
                 reps) -> dict:
    """Each plan held against the plain version on the block, then
    timed."""
    want = tuple(t.clone() for t in start)
    ss.hist_update_plain(want, lats, inc, n_bins=n_bins, sketch=sketch)
    fns = {}
    for key, plan in plans.items():
        got = tuple(t.clone() for t in start)
        launch(plan, got, lats, inc, n_bins, sketch)
        torch.cuda.synchronize()
        if not torch.equal(got[0], want[0]) or (sketch and not torch.allclose(
                got[1], want[1], rtol=1e-6, atol=0.0)):
            raise SystemExit(f"ablate: hist_update plan {key} differs from "
                             f"the plain version on {name}")
        fns[key] = (lambda g=got, pl=plan: launch(pl, g, lats, inc, n_bins,
                                                  sketch))
    return _rounds(fns, reps)


def hist_block(name, launch, start, lats, inc, n_bins, sketch, parent,
               reps):
    p = lats.shape[0]
    default = _plan(start, lats, inc, n_bins, sketch)
    other = 9 - default.warps_per_point          # 1 <-> 8
    plans = {"default": default, f"g{other}": _grouping(default, other, p),
             "scalar_loop": default._replace(vec_loads=False)}
    row = {"block": name, "shape": list(lats.shape), "n_bins": n_bins,
           "sketch": sketch, "included": int(inc.sum()),
           "default_plan": default._asdict(),
           "variants_ms": _timed_plans(name, launch, plans, start, lats, inc,
                                       n_bins, sketch, reps)}
    if parent is not None:
        want = tuple(t.clone() for t in start)
        ss.hist_update_plain(want, lats, inc, n_bins=n_bins, sketch=sketch)
        got = tuple(t.clone() for t in start)
        parent(got, lats, inc, n_bins, sketch)
        torch.cuda.synchronize()
        if not torch.equal(got[0], want[0]):
            raise SystemExit(f"ablate: the parent's hist_update differs on "
                             f"{name}")
        scratch = tuple(t.clone() for t in start)
        old = (lambda: parent(scratch, lats, inc, n_bins, sketch))
        new = (lambda: ss.hist_update(scratch, lats, inc, n_bins=n_bins,
                                      backend="cuda", sketch=sketch))
        row["parent_vs_this_ms"] = [time_ms(f, reps=reps)
                                    for f in (old, new, new, old)]
    return row


def grouping_ladder(name, launch, start, lats, inc, n_bins, sketch, reps):
    """One warp and a block of 8 warps a point on the block's first P
    points, P up the ladder (and the whole block)."""
    rows = []
    total = lats.shape[0]
    for p in sorted({min(q, total) for q in LADDER}):
        blk = (tuple(t[:p] for t in start), lats[:p], inc[:p])
        plan = _plan(*blk, n_bins, sketch)
        plans = {f"g{w}": _grouping(plan, w, p) for w in (1, 8)}
        rows.append({"block": name, "points": p, "per_point":
                     lats[0].numel(), "wrapper_warps": plan.warps_per_point,
                     "ms": _timed_plans(f"{name}[:{p}]", launch, plans, *blk,
                                        n_bins, sketch, reps)})
    return rows


def compact_block(name, launch, buf, k, now, parent, reps):
    p, n = buf.shape
    want = ss.fifo_compact_plain(buf, k, now, out=torch.empty_like(buf))
    out = torch.empty_like(buf)
    default = ss.fifo_compact_plan(p, n, buf_ptr=buf.data_ptr(),
                                   out_ptr=out.data_ptr())
    fns = {}
    for key, plan in (("default", default),
                      ("scalar_loop", default._replace(vec=False))):
        got = torch.empty_like(buf)
        launch(plan, buf, k, now, got)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise SystemExit(f"ablate: fifo_compact ({key}) differs on "
                             f"{name}")
        fns[key] = (lambda pl=plan: launch(pl, buf, k, now, out))
    row = {"block": name, "shape": [p, n],
           "mean_k": float(k.float().mean()),
           "variants_ms": _rounds(fns, reps)}
    if parent is not None:
        got = torch.empty_like(buf)
        parent(buf, k, now, got)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise SystemExit(f"ablate: the parent's fifo_compact differs on "
                             f"{name}")
        old = (lambda: parent(buf, k, now, out))
        new = (lambda: ss.fifo_compact(buf, k, now, backend="cuda", out=out))
        row["parent_vs_this_ms"] = [time_ms(f, reps=reps)
                                    for f in (old, new, new, old)]
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout whose kernels to time")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_torch_superstep: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    procs = {}
    if args.parent is not None:
        csrc = args.parent / "src" / "repro_torch" / "kernels" / "csrc"
        procs = {name: _nvcc(csrc / f"{name}.cu",
                             OUT / f"libparent_{name}.so") for name in NAMES}
    verbose = {name: _nvcc(_build.CSRC / f"{name}.cu",
                           OUT / f"libptxas_{name}.so", ("-Xptxas", "-v"))
               for name in NAMES}
    _build.build(*NAMES)
    ptxas = {}
    for name, proc in verbose.items():
        _, err = proc.communicate()
        ptxas[name] = _ptxas(err)
    hist, compact = _this_fns()
    parent_hist = parent_compact = None
    if procs:
        parent_hist, parent_compact = _parent_fns(procs)

    # the paths' own blocks, one mid-run superstep each (past the
    # warm-up: 10% of the run)
    sweep_blk = capture_blocks(lambda: sweep(
        build_grid(8192), n_batches=3000, q_cap=768, seed=0, device=dev),
        60, "hist_update")["hist_update"]
    main_blk = capture_blocks(lambda: sweep(
        SweepGrid.from_rhos([0.1, 0.3, 0.5, 0.7, 0.9], *V100),
        n_batches=4000, q_cap=1024, seed=7, device=dev), 60,
        "hist_update")["hist_update"]
    gen_blks = capture_blocks(lambda: gen_sweep(
        gen_grid(), n_steps=4096, seed=29, device=dev), 160, "fifo_compact")
    torch.cuda.empty_cache()

    hist_rows, ladder = [], []
    for name, ((start, lats, inc), kw) in (
            ("sweep_path", sweep_blk), ("gen_path", gen_blks["hist_update"]),
            ("main_path", main_blk)):
        n_bins, sketch = kw["n_bins"], kw.get("sketch", False)
        hist_rows.append(hist_block(name, hist, start, lats, inc, n_bins,
                                    sketch, parent_hist, args.reps))
        ladder += grouping_ladder(name, hist, start, lats, inc, n_bins,
                                  sketch, args.reps)
        if name == "sweep_path":
            for r in LADDER_ROWS:
                ladder += grouping_ladder(
                    f"sweep_path_rows{r}", hist, start,
                    lats[:, :r].contiguous(), inc[:, :r].contiguous(),
                    n_bins, sketch, args.reps)
    del start, lats, inc, sweep_blk, main_blk
    for name, shape, n_bins, sketch, seed in (
            ("sweep", (8160, 32, 768), 512, False, 1234),
            ("sweep_sketch", (8160, 32, 768), 64, True, 1235),
            ("gen", (8192, 16, 64), 512, False, 1234),
            ("gen_thinned", (8192, len(thinned_rows(16, 3)), 63), 512,
             False, 1234)):
        start, lats, inc = random_hist_block(dev, *shape, n_bins, sketch,
                                             seed)
        hist_rows.append(hist_block(name, hist, start, lats, inc, n_bins,
                                    sketch, parent_hist, args.reps))
        del start, lats, inc
        torch.cuda.empty_cache()

    compact_rows = []
    (buf, k, now), _ = gen_blks["fifo_compact"]
    compact_rows.append(compact_block("gen_path", compact, buf, k, now,
                                      parent_compact, args.reps))
    gen = torch.Generator(device=dev).manual_seed(99)
    p, n = buf.shape
    buf = torch.randn(p, n, device=dev, generator=gen) * 50.0
    k = torch.randint(0, n + 1, (p,), dtype=torch.int32, device=dev,
                      generator=gen)
    now = torch.rand(p, device=dev, generator=gen) * 500.0
    compact_rows.append(compact_block("random", compact, buf, k, now,
                                      parent_compact, args.reps))

    print(json.dumps({"hist_update": hist_rows, "grouping_ladder": ladder,
                      "fifo_compact": compact_rows, "ptxas": ptxas,
                      "parent": str(args.parent) if args.parent else None,
                      "reps": args.reps, "nvidia_smi": nvidia_smi()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
