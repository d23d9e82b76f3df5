#!/usr/bin/env python3
"""Where the port's user-size fleet sweep spends its time on the GPU.

    python3 tools/profile_torch_fleet.py [--supersteps 3] [--fail]
        [--out DIR]

Runs ``repro_torch.core.sweep.fleet_sweep`` on ``chip_smoke.py``'s
``fleet_user_size`` grid (benchmarks/replicas.py's 528 points tiled 16
times: 8,448 fleets of k 1…16 under random, round-robin and JSQ
routing, a_cap 32, hist_every 4, seed 17, q_cap from ``fleet_caps``)
once to warm up, then under ``torch.profiler`` for a few supersteps,
and prints one JSON line:

- ``wall_ms_per_superstep`` — host clock around a synchronised run
  without the profiler, and ``profiled_wall_ms_per_superstep`` the same
  under it;
- ``kernel_ms_per_superstep`` and ``kernels_per_superstep`` (and a
  step: a superstep is 32 replica decisions);
- ``device_busy_share`` — kernel time over the unprofiled wall time
  (one stream: kernels do not overlap); one minus it is the idle share,
  the time the card waits on the host;
- ``top_kernels`` — device time by kernel name;
- ``hist_update_ms`` — B1 per launch on the fleet's own blocks;
- ``prng_ms_per_superstep`` and ``prng_share`` — the superstep's
  Threefry draw and its float transforms alone, timed with CUDA events,
  over the kernel time.

With ``--fail`` it profiles ``chip_smoke.py``'s ``fleet_fail_user_size``
grid instead (benchmarks/availability.py's 36 JSQ fleet points tiled
228 times, q_cap 512 as the benchmark sizes it, a_cap 64, r_cap 64,
seed 31: the loss and failure paths), whose draw adds the orbit's and
the failures' words.  With ``--out`` it also writes the Chrome trace
there.  Needs one CUDA device; imports nothing of JAX or of the
reference package.
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

from chip_smoke import (AV_B_MAX, AV_RHOS, V100,  # noqa: E402
                        fleet_fail_grid, nvidia_smi, replicas_grid)
from repro_torch.core import engine, fleet_caps, fleet_sweep, prng  # noqa: E402
from repro_torch.core.fleet import (_S_FAIL, _S_GAPS, _S_ORBIT,  # noqa: E402
                                    _S_ROUTE)
from repro_torch.core.sweep import FailParams  # noqa: E402


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--supersteps", type=int, default=3)
    ap.add_argument("--fail", action="store_true")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_fleet: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    n_steps = 32 * args.supersteps
    if args.fail:
        grid, _ = fleet_fail_grid()
        cap = AV_B_MAX / (V100[0] * AV_B_MAX + V100[1])
        q_cap = engine.queue_capacity(max(AV_RHOS) * cap, V100[0], V100[1],
                                      AV_B_MAX, mtbf=60.0, mttr=12.0,
                                      restart=True)
        caps = fleet_caps(grid, q_cap=q_cap)
        kw = dict(q_cap=q_cap, a_cap=64, r_cap=64, f_cap=caps["f_cap"],
                  seed=31, device=dev)
    else:
        grid, _ = replicas_grid()
        kw = dict(a_cap=32, hist_every=4, seed=17, device=dev,
                  q_cap=fleet_caps(grid)["q_cap"])
    fleet_sweep(grid, n_steps=n_steps, **kw)          # build + warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fleet_sweep(grid, n_steps=n_steps, **kw)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fleet_sweep(grid, n_steps=n_steps, **kw)
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
        prof.export_chrome_trace(str(args.out / "fleet_trace.json"))

    # the superstep's random draw and its transforms alone (the grids
    # are deterministic, so no service stream)
    keys = prng.point_keys(kw["seed"], 0, len(grid), dev)
    lam = torch.as_tensor(grid.lam, device=dev)
    a_cap = kw["a_cap"]
    streams = [(_S_ROUTE, a_cap), (_S_GAPS, a_cap)]
    if args.fail:
        streams += [(_S_ORBIT, kw["r_cap"] + 1), (_S_FAIL, 2 * kw["f_cap"])]
        fp = FailParams(grid, kw["f_cap"], dev)

    def draw():
        words = prng.draw_words(keys, 0, 32, streams)
        prng.uniform(words[0]).permute(0, 2, 1)
        engine.exp_offsets(prng.exponential(words[1]), lam).permute(0, 2, 1)
        if args.fail:
            prng.uniform(words[2])
            fp.block(words[3])

    draw()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        draw()
    end.record()
    end.synchronize()
    prng_ms = start.elapsed_time(end) / 3
    kernel_ms = busy_us / 1e3 / args.supersteps

    print(json.dumps({
        "points": len(grid), "fail": args.fail,
        "caps": {k: v for k, v in kw.items() if k.endswith("cap")},
        "words_per_step": sum(n for _, n in streams),
        "supersteps": args.supersteps,
        "wall_ms_per_superstep": plain_wall_ms / args.supersteps,
        "profiled_wall_ms_per_superstep": wall_ms / args.supersteps,
        "kernel_ms_per_superstep": kernel_ms,
        "device_busy_share": busy_us / 1e3 / plain_wall_ms,
        "kernels_per_superstep": launches / args.supersteps,
        "kernels_per_step": launches / args.supersteps / 32,
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "ms_total": _device_us(e) / 1e3} for e in top],
        "hist_update_ms": (sum(_device_us(e) for e in hist) / 1e3
                           / max(1, sum(e.count for e in hist))),
        "prng_ms_per_superstep": prng_ms,
        "prng_share": prng_ms / kernel_ms if kernel_ms else None,
        "nvidia_smi": nvidia_smi(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
