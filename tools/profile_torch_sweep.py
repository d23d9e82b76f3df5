#!/usr/bin/env python3
"""Where the port's user-size sweep spends its time on the GPU.

    python3 tools/profile_torch_sweep.py [--supersteps 3] [--loss | --fail]
        [--out DIR]

Runs ``repro_torch.core.sweep`` on the examples/sweep_grid.py grid
(8,192 requested points → 8,160, ``q_cap=768``) once to warm up, then
under ``torch.profiler`` for a few supersteps, and prints one JSON line:

- ``wall_ms_per_superstep`` — host clock around a synchronised run
  without the profiler, and ``profiled_wall_ms_per_superstep`` the same
  under it (the profiler slows the host, not the card);
- ``kernel_ms_per_superstep`` — summed kernel time per superstep;
- ``device_busy_share`` — kernel time over the unprofiled wall time
  (every kernel runs on one stream, so they do not overlap); one minus
  it is the device's idle share, the time the card waits on the host;
- ``kernels_per_superstep`` — kernel launches per 32-step superstep;
- ``top_kernels`` — device time by kernel name;
- ``hist_update_ms`` — the CUDA histogram kernel per launch, on the
  sweep's own (sparse) masks;
- ``prng_ms_per_superstep`` — the superstep's Threefry draw and its
  float transforms alone, timed with CUDA events.

With ``--loss`` it profiles the loss path instead, on ``chip_smoke.py``'s
``loss_user_size`` grid (benchmarks/backpressure.py's 192 points tiled
43 times, ``a_cap=64``, ``r_cap=96``, seed 29), and adds
``prng_base_ms_per_superstep``: the same draw without the retry orbit's
uniforms, so the difference is the orbit's share.

With ``--fail`` it profiles the failure path, on ``chip_smoke.py``'s
``fail_user_size`` grid (benchmarks/availability.py's 26 single-server
cells tiled 316 times, ``q_cap = a_cap = 512``, ``r_cap=64``, seed 31;
its drop cells make it a loss grid too), and
``prng_base_ms_per_superstep`` is the draw of the misc and service
streams alone, without the orbit's and the failures' words.

With ``--out`` it also writes the Chrome trace there.  Needs one CUDA
device; imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (AV_B_MAX, AV_RHOS, V100, build_grid,  # noqa: E402
                        fail_grid, loss_grid, nvidia_smi)
from repro_torch.core import engine, prng, sweep, sweep_caps  # noqa: E402
from repro_torch.core.sweep import (_MISC_WORDS, _S_FAIL,  # noqa: E402
                                    _S_MISC, _S_ORBIT, _S_SERVICE)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--q-cap", type=int, default=768)
    ap.add_argument("--supersteps", type=int, default=3)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--loss", action="store_true")
    mode.add_argument("--fail", action="store_true")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    n_batches = 32 * args.supersteps
    if args.loss:
        grid = loss_grid()
        kw = dict(a_cap=64, r_cap=96, seed=29, device=dev)
        q_cap, a_cap = sweep_caps(grid)["q_cap"], 64
    elif args.fail:
        grid, _ = fail_grid()
        cap = AV_B_MAX / (V100[0] * AV_B_MAX + V100[1])
        q_cap = a_cap = engine.queue_capacity(
            max(AV_RHOS) * cap, V100[0], V100[1], AV_B_MAX, mtbf=60.0,
            mttr=12.0, restart=True)
        kw = dict(q_cap=q_cap, a_cap=a_cap, r_cap=64, seed=31, device=dev)
        kw["f_cap"] = sweep_caps(grid, q_cap=q_cap)["f_cap"]
    else:
        grid = build_grid(args.points)
        kw = dict(q_cap=args.q_cap, seed=0, device=dev)
        q_cap = a_cap = args.q_cap
    sweep(grid, n_batches=n_batches, **kw)          # build + warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep(grid, n_batches=n_batches, **kw)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep(grid, n_batches=n_batches, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    hist = [e for e in kernels if "hist_update_kernel" in e.key]
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.out / "sweep_trace.json"))

    # the superstep's random draw and its transforms alone
    keys = prng.point_keys(kw["seed"], 0, len(grid), dev)
    lam = torch.as_tensor(grid.lam, device=dev)
    base = ((_S_MISC, _MISC_WORDS), (_S_SERVICE, a_cap + 1))

    def draw_ms(streams) -> float:
        def draw():
            words = prng.draw_words(keys, 0, 32, streams)
            prng.exponential(words[0][:, 0])
            engine.exp_offsets(prng.exponential(words[1]), lam)
            for (sid, _), w in zip(streams[2:], words[2:]):
                if sid == _S_ORBIT:
                    prng.uniform(w)
                else:
                    x = prng.exponential(w)
                    torch.cumsum(x[:, :kw["f_cap"]], 1)
                    torch.cumsum(x[:, kw["f_cap"]:], 1)
        draw()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            draw()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 3

    extra = {}
    if args.loss or args.fail:
        extra["prng_base_ms_per_superstep"] = draw_ms(base)
        more = ((_S_ORBIT, kw["r_cap"]),)
        if args.fail:
            more += ((_S_FAIL, 2 * kw["f_cap"]),)
        prng_ms = draw_ms(base + more)
    else:
        prng_ms = draw_ms(base)

    print(json.dumps({
        "points": len(grid), "loss": args.loss, "fail": args.fail,
        "q_cap": q_cap, "a_cap": a_cap,
        "supersteps": args.supersteps,
        "wall_ms_per_superstep": plain_wall_ms / args.supersteps,
        "profiled_wall_ms_per_superstep": wall_ms / args.supersteps,
        "kernel_ms_per_superstep": busy_us / 1e3 / args.supersteps,
        "device_busy_share": busy_us / 1e3 / plain_wall_ms,
        "kernels_per_superstep": launches / args.supersteps,
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "ms_total": _device_us(e) / 1e3} for e in top],
        "hist_update_ms": (sum(_device_us(e) for e in hist) / 1e3
                           / max(1, sum(e.count for e in hist))),
        "prng_ms_per_superstep": prng_ms, **extra,
        "nvidia_smi": nvidia_smi(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
