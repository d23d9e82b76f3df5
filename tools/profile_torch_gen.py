#!/usr/bin/env python3
"""Where the port's user-size generate sweep spends its time on the GPU.

    python3 tools/profile_torch_gen.py [--supersteps 3] [--loss | --fail]
        [--out DIR]

Runs the superstep loop of ``repro_torch.core.gen_sweep`` on
``chip_smoke.py``'s generate grid (benchmarks/continuous.py's 512
points tiled 16 times: 8,192 points, adaptive caps) for a few 16-step
supersteps — once to warm up, once on the host clock, once under
``torch.profiler`` — and prints one JSON line:

- ``wall_ms_per_superstep`` — host clock around a synchronised run
  without the profiler;
- ``kernel_ms_per_superstep`` — summed kernel time per superstep;
- ``device_busy_share`` — kernel time over the unprofiled wall time
  (every kernel runs on one stream, so they do not overlap); one minus
  it is the device's idle share, the time the card waits on the host;
- ``kernels_per_superstep`` — kernel launches per superstep;
- ``top_kernels`` — device time by kernel name;
- ``hist_update_ms`` / ``fifo_compact_ms`` — the two CUDA kernels per
  launch, on the sweep's own data;
- ``prng_ms_per_superstep`` and ``prng_share`` — the superstep's
  Threefry draw and its float transforms alone, timed with CUDA events,
  and their share of the kernel time.

With ``--loss`` it profiles the loss path instead, on
``chip_smoke.py``'s ``gen_loss_user_size`` grid (the same points with
loss tiles, the same caps, ``r_cap`` from the loss grid), and the draw
includes the retry orbit's uniforms.  With ``--fail`` it profiles the
failure path, on ``chip_smoke.py``'s ``gen_fail_user_size`` grid (the
same points with failure tiles, its own ``gen_caps``), and the draw
includes the orbit's uniforms (its drop tiles make it a loss grid) and
the failure epochs and repairs.

The public ``gen_sweep`` rounds ``n_steps`` up to 2,048; this tool calls
its loop (``gen_sweep._run``) directly so that a profile covers only a
few supersteps, with measurement on from the first step.  With ``--out``
it also writes the Chrome trace there.  Needs one CUDA device; imports
nothing of JAX or of the reference package.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (gen_fail_grid, gen_grid, gen_loss_grid,  # noqa: E402
                        nvidia_smi)
from repro_torch.core import engine, gen_caps, prng  # noqa: E402

# the module (``repro_torch.core.gen_sweep`` names the function too)
gen_mod = importlib.import_module("repro_torch.core.gen_sweep")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _per_launch_ms(kernels, name: str) -> float:
    hits = [e for e in kernels if name in e.key]
    return (sum(_device_us(e) for e in hits) / 1e3
            / max(1, sum(e.count for e in hits)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", type=int, default=16)
    ap.add_argument("--supersteps", type=int, default=3)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--loss", action="store_true")
    mode.add_argument("--fail", action="store_true")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_gen: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    grid = gen_grid(args.tiles)
    caps = dict(gen_caps(grid), r_cap=None, f_cap=0)
    if args.loss:
        grid = gen_loss_grid(grid, args.tiles)
        caps["r_cap"] = gen_caps(grid)["r_cap"]
    elif args.fail:
        grid = gen_fail_grid(grid, args.tiles)
        caps = gen_caps(grid)
    s_cap = int(grid.max_active.max())
    R = gen_mod._REBASE_EVERY
    kw = dict(n_steps=R * args.supersteps, warmup=0, s_cap=s_cap,
              n_bins=512, hist_every=1, sketch=False, ss_backend="cuda",
              tap=None, device=dev, **caps)
    keys = prng.point_keys(29, 0, len(grid), dev)

    def run():
        gen_mod._run(grid, keys, **kw)

    run()                                           # build + warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.out / "gen_trace.json"))

    # the superstep's random draw and its transforms alone
    keys = prng.point_keys(29, 0, len(grid), dev)
    lam = torch.as_tensor(grid.lam, device=dev)

    streams = ((gen_mod._S_GAPS, caps["a_cap"] + 1),)
    if caps["r_cap"] is not None:
        streams += ((gen_mod._S_ORBIT, caps["r_cap"]),)
    if args.fail:
        streams += ((gen_mod._S_FAIL, 2 * caps["f_cap"]),)

    def draw():
        words = prng.draw_words(keys, 0, R, streams)
        engine.exp_offsets(prng.exponential(words[0]), lam).permute(
            0, 2, 1).contiguous()
        if caps["r_cap"] is not None:
            prng.uniform(words[1])
        if args.fail:
            x = prng.exponential(words[-1])
            torch.cumsum(x[:, :caps["f_cap"]], 1)
            torch.cumsum(x[:, caps["f_cap"]:], 1)
    draw()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.supersteps):
        draw()
    end.record()
    end.synchronize()
    prng_ms = start.elapsed_time(end) / args.supersteps
    kernel_ms = busy_us / 1e3 / args.supersteps

    print(json.dumps({
        "points": len(grid), "loss": args.loss, "fail": args.fail,
        "caps": caps,
        "supersteps": args.supersteps,
        "steps_per_superstep": R,
        "wall_ms_per_superstep": plain_wall_ms / args.supersteps,
        "profiled_wall_ms_per_superstep": wall_ms / args.supersteps,
        "kernel_ms_per_superstep": kernel_ms,
        "device_busy_share": busy_us / 1e3 / plain_wall_ms,
        "kernels_per_superstep": launches / args.supersteps,
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "ms_total": _device_us(e) / 1e3} for e in top],
        "hist_update_ms": _per_launch_ms(kernels, "hist_update_kernel"),
        "fifo_compact_ms": _per_launch_ms(kernels, "fifo_compact_kernel"),
        "prng_ms_per_superstep": prng_ms,
        "prng_share": prng_ms / kernel_ms if kernel_ms else None,
        "nvidia_smi": nvidia_smi(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
