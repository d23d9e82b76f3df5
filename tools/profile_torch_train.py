#!/usr/bin/env python3
"""Where the port's train step spends its time on the GPU.

    python3 tools/profile_torch_train.py [--arch ARCH] [--remat]
        [--batch 8] [--seq 512] [--out DIR]

Builds ARCH (default qwen1.5-0.5b; ``mamba2-2.7b`` for the SSM step,
whole at full width) at full width in its config's dtype
from the port's seeded init, and the train step of ``launch.train``
(AdamW, the chunked cross-entropy where ``S · V`` asks for it, remat
with ``--remat``) on the synthetic corpus; runs two steps to warm up,
three on the host clock (each ended by reading its loss) and one under
``torch.profiler``.  It prints one JSON line with:

- ``wall_ms`` — the median host-clock step, without the profiler;
- ``kernel_ms``, ``device_busy_share`` (kernel time over the unprofiled
  wall; one stream), ``kernels`` (launches a step), ``top_kernels``;
- ``b3_forward_*`` / ``b3_backward_*`` — B3's forward kernels and its
  backward's three (``delta_kernel``, ``dkdv_kernel*``, ``dq_kernel*``):
  ms, launches and share of the kernel time;
- ``b5_forward_*`` / ``b5_backward_*`` — B5's forward kernel and its
  backward's three (float32: ``ssd_state_kernel``,
  ``ssd_backward_kernel``; bf16: ``ssd_bwd_state_kernel_bf16``,
  ``ssd_bwd_tile_kernel_bf16``; then ``ssd_reduce_kernel``): ms,
  launches and share (on SSM and hybrid models);
- ``products_*`` — the matrix products (cuBLAS / CUTLASS kernels, by
  name), forward and backward: the projections, the MLP and the tied
  unembedding;
- ``optimizer_*`` — the kernels inside ``apply_updates``'s span on the
  device timeline (one ``record_function`` range around it);
- ``ce_chunk_ms`` / ``ce_chunk_share`` — the cross-entropy's forward and
  backward (every chunk: the unembedding product, its float32
  log-sum-exp, the recompute and the two products of its backward)
  timed apart by CUDA events on the step's own shapes, and its share of
  the profiled step's kernel time; the profiler cannot tell its
  backward kernels from the model's;
- ``conv_ms`` / ``conv_share`` (SSM and hybrid models) — the Mamba2
  layers' causal convolutions (``models.mamba2._causal_conv``, its
  float32 tap loop over the x and the B/C channels), forward and
  backward, timed apart in the same way on the step's shapes, for all
  the model's Mamba2 layers.

With ``--out`` it also writes the Chrome trace there.  Needs one CUDA
device; imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))

from chip_smoke import nvidia_smi  # noqa: E402
from profile_torch_serve import _device_us  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticCorpus  # noqa: E402

OPT_RANGE = "apply_updates"
B3_FORWARD = ("flash_attention_kernel",)
B3_BACKWARD = ("delta_kernel", "dkdv_kernel", "dq_kernel")
B5_FORWARD = ("ssd_scan_kernel",)
B5_BACKWARD = ("ssd_state_kernel", "ssd_backward_kernel",
               "ssd_bwd_state_kernel", "ssd_bwd_tile_kernel",
               "ssd_reduce_kernel")
PRODUCTS = ("gemm", "cutlass", "xmma", "nvjet", "sm90_")


def _matching(kernels, patterns):
    hits = [e for e in kernels if any(p in e.key for p in patterns)]
    return (sum(_device_us(e) for e in hits) / 1e3,
            sum(e.count for e in hits))


def _span_ms(prof, name: str) -> float:
    """Kernel time on the device timeline inside the device-side spans
    of the range ``name`` (one stream, so a span holds exactly the
    kernels its range enqueued)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == name)
    starts = [s for s, _ in spans]
    total = 0.0
    for e in events:
        if e.name == name:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start < spans[i][1]:
            total += e.time_range.elapsed_us()
    return total / 1e3


def _ce_ms(cfg, model, batch: int, seq: int, dev) -> float:
    """The chunked (or plain) cross-entropy's forward and backward on
    the step's shapes, by CUDA events, mean of 3 after 1 warm-up."""
    hidden = torch.randn(batch, seq, cfg.d_model, device=dev,
                         dtype=model.embed.dtype, requires_grad=True)
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), device=dev)

    def once():
        if seq % loop.CE_CHUNK == 0 and \
                seq * cfg.vocab_size >= loop.CE_CHUNK_THRESHOLD:
            ce = loop.chunked_cross_entropy(cfg, model, hidden, labels)
        else:
            ce = loop.cross_entropy(tfm._logits(cfg, model, hidden), labels)
        ce.backward()

    once()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        once()
    end.record()
    end.synchronize()
    model.zero_grad(set_to_none=True)
    return start.elapsed_time(end) / 3


def _conv_ms(cfg, model, batch: int, seq: int, dev) -> float:
    """All the Mamba2 layers' causal convolutions of one step, forward
    and backward, by CUDA events on the step's shapes (mean of 3 after 1
    warm-up); 0 without Mamba2 layers."""
    layers = [layer["ssm"] for layer in model.layers if "ssm" in layer]
    if not layers:
        return 0.0
    p = layers[0]
    ins = [torch.randn(batch, seq, w.shape[1], device=dev, dtype=w.dtype,
                       requires_grad=True)
           for w in (p["conv_wx"], p["conv_wbc"])]

    def once():
        out = (mamba2._causal_conv(ins[0], p["conv_wx"], p["conv_bx"]).sum()
               + mamba2._causal_conv(ins[1], p["conv_wbc"],
                                     p["conv_bbc"]).sum())
        out.backward()

    once()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        once()
    end.record()
    end.synchronize()
    model.zero_grad(set_to_none=True)
    return start.elapsed_time(end) / 3 * len(layers)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    loop.require_trainable(cfg, dev)
    model = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    state = opt.init_state(model)
    inner = loop.apply_updates

    def ranged(*a, **kw):
        with torch.profiler.record_function(OPT_RANGE):
            return inner(*a, **kw)

    loop.apply_updates = ranged
    step = loop.make_train_step(cfg, opt.AdamWConfig(), remat=args.remat)
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.batch)).batches()

    def run_step():
        nonlocal model, state
        b = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
             for k, v in next(data).items()}
        t0 = time.perf_counter()
        model, state, m = step(model, state, b)
        float(m["loss"])
        return (time.perf_counter() - t0) * 1e3

    for _ in range(2):
        run_step()
    wall_ms = statistics.median(run_step() for _ in range(3))
    torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_step()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key != OPT_RANGE]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    out = {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "batch": args.batch, "seq": args.seq, "remat": args.remat,
           "wall_ms": wall_ms, "kernel_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms,
           "kernels": sum(e.count for e in kernels),
           "tokens_per_s": args.batch * args.seq / (wall_ms / 1e3),
           "peak_bytes": peak,
           "top_kernels": [{"name": e.key[:90], "count": e.count,
                            "ms": _device_us(e) / 1e3} for e in top]}
    for label, patterns in (("b3_forward", B3_FORWARD),
                            ("b3_backward", B3_BACKWARD),
                            ("b5_forward", B5_FORWARD),
                            ("b5_backward", B5_BACKWARD),
                            ("products", PRODUCTS)):
        ms, n = _matching(kernels, patterns)
        out.update({f"{label}_ms": ms, f"{label}_launches": n,
                    f"{label}_share": ms / busy_ms})
    opt_ms = _span_ms(prof, OPT_RANGE)
    out.update({"optimizer_ms": opt_ms, "optimizer_share": opt_ms / busy_ms})
    ce = _ce_ms(cfg, model, args.batch, args.seq, dev)
    out.update({"ce_chunk_ms": ce, "ce_chunk_share": ce / busy_ms})
    conv = _conv_ms(cfg, model, args.batch, args.seq, dev)
    out.update({"conv_ms": conv, "conv_share": conv / busy_ms})
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.out / f"{cfg.name}_train.json"))
    out["device"] = torch.cuda.get_device_name(0)
    out["nvidia_smi"] = nvidia_smi()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
