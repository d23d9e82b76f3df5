#!/usr/bin/env python3
"""Where the port's inference server spends a batch's time on the GPU.

    python3 tools/profile_torch_serve.py [--arch ARCH] [--out DIR]

Builds ``InferenceEngine(ARCH, workload="generate")`` (default
qwen1.5-0.5b; mamba2-2.7b for the SSM serve path, olmoe-1b-7b for the
MoE one) at full width (bf16,
the port's seeded init) at two sizes — ``serve``
(``launch.serve``'s prompt of 32 and 4 generated tokens) and
``serve_long`` (a 1,024-token prompt and 32 tokens) — and, for batch 1
and batch 32 of each, runs one batch to warm up, three on the host
clock and one under ``torch.profiler``.  It prints one JSON line with,
per (size, batch):

- ``wall_ms`` — the median host clock of ``run_batch``'s timed call
  (the model's execution, synchronised), without the profiler;
- ``kernel_ms`` — the batch's summed kernel time;
- ``device_busy_share`` — kernel time over the unprofiled wall time
  (one stream, so kernels do not overlap); one minus it is the share of
  the batch the card waits on the host;
- ``kernels`` — kernel launches per batch;
- ``top_kernels`` — device time by kernel name;
- ``flash_attention_ms`` / ``decode_attention_ms`` / ``ssd_scan_ms``
  — the port's model kernels' time in the batch, their launches, and
  their share of the kernel time;
- ``moe_ms`` / ``moe_share`` / ``moe_calls`` (MoE configs) — the
  kernel time of every ``apply_moe`` call (router, routing, dispatch,
  the experts' products, combine), read off a ``record_function`` range
  around it, and its share of the kernel time.

With ``--out`` it also writes the Chrome traces there.  Needs one CUDA
device; imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import nvidia_smi  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import InferenceEngine  # noqa: E402

SIZES = {"serve": (32, 4), "serve_long": (1024, 32)}
# the profiler range around each MoE FFN call
MOE_RANGE = "apply_moe"


def _device_us(evt, prefix: str = "self_") -> float:
    """A kernel's own device time; with ``prefix=""``, a CPU range's:
    the kernels launched inside it."""
    for name in (f"{prefix}device_time_total", f"{prefix}cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _annotated(fn, label: str):
    def wrapped(*args, **kw):
        with torch.profiler.record_function(label):
            return fn(*args, **kw)
    return wrapped


def _kernel_sum(kernels, name: str):
    hits = [e for e in kernels if name in e.key]
    return (sum(_device_us(e) for e in hits) / 1e3,
            sum(e.count for e in hits))


def profile_batch(eng: InferenceEngine, b: int, trace: Path = None) -> dict:
    eng.run_batch(b)                                # warm this shape
    wall_ms = statistics.median(eng.run_batch(b) * 1e3 for _ in range(3))
    batch = eng._make_batch(b)
    fn = eng._fns[eng.bucket_of(b)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(eng.params, batch)
        torch.cuda.synchronize()
    # the device's kernels (the MoE range's own device-side annotation
    # is a span, not a kernel)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key != MOE_RANGE]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:10]
    if trace is not None:
        prof.export_chrome_trace(str(trace))
    out = {"batch": b, "wall_ms": wall_ms, "kernel_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms,
           "kernels": sum(e.count for e in kernels),
           "top_kernels": [{"name": e.key[:80], "count": e.count,
                            "ms": _device_us(e) / 1e3} for e in top]}
    for name in ("flash_attention", "decode_attention", "ssd_scan"):
        ms, n = _kernel_sum(kernels, f"{name}_kernel")
        out[f"{name}_ms"] = ms
        out[f"{name}_launches"] = n
        out[f"{name}_share"] = ms / busy_ms if busy_ms else None
    if eng.cfg.moe is not None:
        moe = [e for e in prof.key_averages() if e.key == MOE_RANGE
               and e.device_type == torch.autograd.DeviceType.CPU]
        moe_ms = sum(_device_us(e, prefix="") for e in moe) / 1e3
        out.update(moe_ms=moe_ms, moe_calls=sum(e.count for e in moe),
                   moe_share=moe_ms / busy_ms if busy_ms else None)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: needs a CUDA device", file=sys.stderr)
        return 1
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    cfg = get_config(args.arch)
    # a profiler range around each MoE FFN call
    transformer.apply_moe = _annotated(transformer.apply_moe, MOE_RANGE)
    rows = {}
    t0 = time.perf_counter()
    for label, (prompt, gen) in SIZES.items():
        eng = InferenceEngine(cfg, workload="generate", seq_len=prompt,
                              gen_tokens=gen, max_batch=32)
        for b in (1, 32):
            trace = (None if args.out is None
                     else args.out / f"{cfg.name}_{label}_b{b}_trace.json")
            rows[f"{label}/b{b}"] = profile_batch(eng, b, trace)
        del eng
        torch.cuda.empty_cache()
    print(json.dumps({"arch": cfg.name, "dtype": cfg.dtype, "sizes": SIZES,
                      "rows": rows,
                      "seconds": time.perf_counter() - t0,
                      "nvidia_smi": nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
