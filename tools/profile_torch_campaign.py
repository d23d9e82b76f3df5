#!/usr/bin/env python3
"""Where the port's user-size campaign spends its time on the GPU.

    python3 tools/profile_torch_campaign.py [--chunks 8] [--out DIR]

Runs ``repro_torch.core.campaign.campaign`` on ``chip_smoke.py``'s
``campaign_user_size`` grid (benchmarks/campaign.py's 2**20-point grid,
caps pinned from the full grid, chunk 8,192, n_batches 32, seed 11,
pipelined) over its first ``--chunks`` chunks: once to warm up, once
timed with the driver's host work measured, and once under
``torch.profiler``, and prints one JSON line:

- ``wall_ms_per_chunk`` — host clock around a synchronised run without
  the profiler;
- ``kernel_ms_per_chunk`` and ``kernels_per_chunk`` (a chunk is one
  32-step superstep of 8,192 points, then its fold);
- ``device_busy_share`` — kernel time over the unprofiled wall time
  (one stream: kernels do not overlap); one minus it is the idle share;
- ``fold_share`` — the ``campaign_fold`` kernel's share of the kernel
  time, and ``fold_ms`` per launch;
- ``prng_share`` — the chunk's Threefry draw and its float transforms
  (the misc, service and retry-orbit streams at the grid's caps), timed
  alone with CUDA events, over the kernel time per chunk;
- ``host_ms_per_chunk_outside_sweep`` — host time of the driver per
  chunk that is neither the sweep's own enqueue nor a wait for the card
  (slicing the grid, planning, the fold's enqueue, the host copies,
  the rows), and ``sweep_host_ms_per_chunk`` / ``wait_ms_per_chunk``
  beside it;
- ``hist_update_ms`` — B1 per launch on the campaign's own blocks;
- ``top_kernels`` — device time by kernel name.

With ``--out`` it also writes the Chrome trace there.  Needs one CUDA
device; imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import million_grid, nvidia_smi  # noqa: E402
from repro_torch.core import campaign as camp_mod  # noqa: E402
from repro_torch.core import engine, prng, sweep_caps  # noqa: E402
from repro_torch.core.sweep import (_MISC_WORDS, _S_MISC,  # noqa: E402
                                    _S_ORBIT, _S_SERVICE)

CHUNK, N_BATCHES, SEED = 8192, 32, 11


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


class _HostClock:
    """Times the driver's calls into the sweep and its waits on the card
    (wrapping ``engine.dispatch_device`` and ``_HostCopies.wait``)."""

    def __init__(self) -> None:
        self.sweep_s = self.wait_s = 0.0
        self._dispatch = engine.dispatch_device
        self._wait = camp_mod._HostCopies.wait

    def __enter__(self):
        def dispatch(*a, **k):
            t0 = time.perf_counter()
            try:
                return self._dispatch(*a, **k)
            finally:
                self.sweep_s += time.perf_counter() - t0

        def wait(ev):
            t0 = time.perf_counter()
            try:
                return self._wait(ev)
            finally:
                self.wait_s += time.perf_counter() - t0

        engine.dispatch_device = dispatch
        camp_mod._HostCopies.wait = staticmethod(wait)
        return self

    def __exit__(self, *exc) -> None:
        engine.dispatch_device = self._dispatch
        camp_mod._HostCopies.wait = staticmethod(self._wait)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_campaign: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    full = million_grid()
    caps = sweep_caps(full)
    grid = full.take(np.arange(args.chunks * CHUNK))
    kw = dict(chunk_size=CHUNK, n_batches=N_BATCHES, seed=SEED, caps=caps,
              device=dev)

    def run():
        r = camp_mod.campaign(grid, **kw)
        torch.cuda.synchronize()
        return r

    camp_mod.campaign(full.take(np.arange(CHUNK)), **kw)   # build + warm
    torch.cuda.synchronize()

    with _HostClock() as clock:
        t0 = time.perf_counter()
        r = run()
        wall = time.perf_counter() - t0
    if r.quarantined_points:
        raise SystemExit("profile_torch_campaign: the run quarantined "
                         f"points: {r.quarantined_chunks}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    hist = [e for e in kernels if "hist_update_kernel" in e.key]
    fold = [e for e in kernels if "campaign_fold_kernel" in e.key]
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.out / "campaign_trace.json"))

    # one chunk's random draw and its transforms alone: the loss sweep
    # draws the misc, service and orbit streams every step
    keys = prng.point_keys(SEED, 0, CHUNK, dev)
    lam = torch.as_tensor(grid.lam[:CHUNK], device=dev)
    streams = ((_S_MISC, _MISC_WORDS), (_S_SERVICE, caps["a_cap"] + 1),
               (_S_ORBIT, caps["r_cap"]))

    def draw():
        words = prng.draw_words(keys, 0, 32, streams)
        prng.exponential(words[0][:, 0])
        engine.exp_offsets(prng.exponential(words[1]), lam)
        prng.uniform(words[2])

    draw()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        draw()
    end.record()
    end.synchronize()
    prng_ms = start.elapsed_time(end) / 3
    n = args.chunks
    kernel_ms = busy_us / 1e3 / n
    host_out = wall - clock.sweep_s - clock.wait_s

    def per_launch(evts):
        return (sum(_device_us(e) for e in evts) / 1e3
                / max(1, sum(e.count for e in evts)))

    print(json.dumps({
        "points": len(grid), "chunks": n, "chunk_size": CHUNK,
        "n_batches": N_BATCHES, "caps": caps,
        "wall_ms_per_chunk": wall * 1e3 / n,
        "kernel_ms_per_chunk": kernel_ms,
        "kernels_per_chunk": launches / n,
        "device_busy_share": busy_us / 1e6 / wall,
        "fold_ms": per_launch(fold),
        "fold_share": sum(_device_us(e) for e in fold) / busy_us,
        "prng_ms_per_chunk": prng_ms,
        "prng_share": prng_ms / kernel_ms,
        "host_ms_per_chunk_outside_sweep": host_out * 1e3 / n,
        "sweep_host_ms_per_chunk": clock.sweep_s * 1e3 / n,
        "wait_ms_per_chunk": clock.wait_s * 1e3 / n,
        "hist_update_ms": per_launch(hist),
        "top_kernels": [{"name": e.key[:80], "count": e.count,
                         "ms_total": _device_us(e) / 1e3} for e in top],
        "nvidia_smi": nvidia_smi(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
