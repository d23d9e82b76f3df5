#!/usr/bin/env python3
"""B3 (``flash_attention``) and its backward against an earlier
checkout's, on the shapes ``chip_smoke.py`` launches.

    git archive <commit> | tar -x -C build/parent
    python3 tools/compare_torch_flash_parent.py --parent build/parent

Builds the parent's ``src/repro_torch/kernels/csrc/flash_attention.cu``
and ``flash_attention_backward.cu`` with the port's ``nvcc`` flags into
``build/parent_flash/`` and calls their C entry points with the
argument lists they export (the forward with a key length and a null
``lse``: q, k, v, out, lse, B, S, SK, H, KV, hd, hdv, dtype, scale,
causal, window, stream; the backward: q, k, v, out, dout, lse, delta,
dq, dk, dv, B, S, SK, H, KV, hd, hdv, dtype, scale, causal, window,
stream), and the current ``flash_attention`` / ``flash_attention_
backward`` on the same random inputs:

- bf16 forward, served (``inference_mode``) and under autograd, and
  bf16 backward (on the same ``out`` and ``lse``): bit for bit equal to
  the parent's;
- float32 forward and backward: each within the card's gates of the
  plain version (2e-5 on the output, 2e-5 of each gradient's largest
  magnitude), the parent's error beside it, not bitwise (the two
  kernels sum in another order);
- timed, in turns (parent, current, current, parent, CUDA events behind
  a device sleep): the float32 forward at whisper's encoder (B 32 and 1
  × 1,500, 16 × 64, unmasked), its cross prefill (32 queries over 1,500
  keys, B 32, 4, 2, 1), and the float32 backward at the training shape
  (B 8 × 512, 16 × 64, causal), with SDPA's time on the same inputs and
  the plain version's.

The serve, long, batch-1 and continuous shapes at 16 × 64, phi4-mini's
24 over 8 × 128, OLMoE's 16 × 128, MLA's (192, 128) pair, Jamba's 32
over 8 × 128, windowed, unmasked and float32 cases, whisper's and
InternVL2's shapes and the training shapes.  Prints one JSON line with
the counts, the cases that differ and the timings, with the card's
name and power limit, and exits 1 if any case fails.  Needs one CUDA
device and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels._launch import DTYPE_CODE  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
GATE = 2e-5
SLEEP_CYCLES = 40_000_000          # ≈ 20 ms at the H100's 1.98 GHz


def cases() -> list:
    """(dtype, B, S, H, KV, hd, hdv, causal, window, SK) of the phases'
    B3 launches (SK 0: the query length)."""
    out = []
    for b in (1, 2, 4, 8, 16, 32):
        out += [(BF16, b, 32, 16, 16, 64, 64, True, 0),
                (BF16, b, 32, 16, 16, 128, 128, True, 0),
                (BF16, b, 32, 16, 16, 192, 128, True, 0),
                (BF16, b, 32, 32, 8, 128, 128, True, 0)]
    out += [(BF16, 32, 1024, 16, 16, 64, 64, True, 0),
            (BF16, 1, 1024, 16, 16, 64, 64, True, 0),
            (BF16, 1, 128, 16, 16, 64, 64, True, 0),
            (BF16, 32, 1024, 16, 16, 192, 128, True, 0),
            (BF16, 1, 1024, 16, 16, 192, 128, True, 0),
            (F32, 32, 32, 16, 16, 64, 64, True, 0),
            (F32, 32, 32, 16, 16, 192, 128, True, 0),
            (F32, 2, 303, 16, 16, 128, 128, True, 0),
            (F32, 2, 303, 32, 8, 128, 128, True, 0)]
    for dt in (BF16, F32):
        out += [(dt, 3, 300, 24, 8, 128, 128, True, 0),
                (dt, 2, 200, 16, 16, 64, 64, True, 64),
                (dt, 2, 77, 16, 16, 64, 64, False, 9),
                (dt, 2, 200, 16, 16, 192, 128, True, 64),
                (dt, 2, 303, 16, 16, 192, 128, True, 0),
                (dt, 2, 37, 6, 2, 32, 32, False, 0),
                (dt, 2, 300, 16, 16, 64, 64, False, 0)]
    out = [c + (0,) for c in out]
    # a key length of its own (whisper's cross-attention, split at B 1,
    # 2 and 4), the encoder, InternVL2's prefill and the training shapes
    out += [(F32, 32, 32, 16, 16, 64, 64, False, 0, 1500),
            (F32, 4, 32, 16, 16, 64, 64, False, 0, 1500),
            (F32, 2, 32, 16, 16, 64, 64, False, 0, 1500),
            (F32, 1, 32, 16, 16, 64, 64, False, 0, 1500),
            (F32, 2, 7, 16, 16, 64, 64, False, 0, 1499),
            (F32, 2, 1500, 16, 16, 64, 64, False, 0, 0),
            (BF16, 2, 1500, 16, 16, 64, 64, False, 0, 0),
            (BF16, 32, 288, 14, 2, 64, 64, True, 0, 0),
            (BF16, 8, 512, 16, 16, 64, 64, True, 0, 0),
            (F32, 2, 512, 16, 16, 64, 64, True, 0, 0),
            (BF16, 1, 4096, 16, 16, 64, 64, True, 0, 0)]
    return out


def backward_cases() -> list:
    """``chip_smoke.py``'s ``attn_backward`` shapes, both dtypes."""
    out = []
    for dt in (BF16, F32):
        out += [(dt, 8, 512, 16, 16, 64, 64, True, 0, 0),
                (dt, 2, 300, 32, 8, 128, 128, True, 64, 0),
                (dt, 2, 512, 16, 16, 128, 128, True, 0, 0),
                (dt, 2, 300, 16, 16, 192, 128, True, 0, 0),
                (dt, 2, 32, 16, 16, 64, 64, False, 0, 1500),
                (dt, 2, 500, 16, 16, 64, 64, True, 0, 0),
                (dt, 1, 1023, 6, 2, 32, 32, True, 0, 0)]
    return out + [(BF16, 1, 4096, 16, 16, 64, 64, True, 0, 0),
                  (BF16, 1, 512, 16, 16, 64, 64, True, 0, 0)]


def _nvcc_library(parent: Path, name: str):
    src = parent / f"src/repro_torch/kernels/csrc/{name}.cu"
    out_dir = ROOT / "build" / "parent_flash"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"lib{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True)
    return ctypes.CDLL(str(so))


def parent_launches(parent: Path):
    fwd = _nvcc_library(parent, "flash_attention").flash_attention_launch
    fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = _nvcc_library(
        parent, "flash_attention_backward").flash_attention_backward_launch
    bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return fwd, bwd


def _inputs(dev, seed, dt, b, s, h, kv, hd, hdv, sk):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, device=dev, generator=gen).to(dt)
                 for shape in ((b, s, h, hd), (b, sk, kv, hd),
                               (b, sk, kv, hdv), (b, s, h, hdv)))


def time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean ms a call over ``reps`` calls by CUDA events, queued behind
    a device sleep so that the card, not the host, sets the pace."""
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


def _err(x, w) -> float:
    return float((x.float() - w.float()).abs().max())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_torch_flash_parent: needs a CUDA device",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    old_fwd, old_bwd = parent_launches(args.parent)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def parent_forward(q, k, v, causal, window):
        b, s, h, hd = q.shape
        sk, kv, hdv = k.shape[1], k.shape[2], v.shape[3]
        out = q.new_empty(b, s, h, hdv)
        err = old_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), None, b, s, sk, h, kv, hd, hdv,
                      DTYPE_CODE[q.dtype], hd ** -0.5, int(causal), window,
                      stream)
        return out, err

    def parent_backward(q, k, v, out, lse, do, causal, window):
        b, s, h, hd = q.shape
        sk, kv, hdv = k.shape[1], k.shape[2], v.shape[3]
        delta = torch.empty(b * h * s, dtype=torch.float32, device=dev)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        err = old_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                      delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), b, s, sk, h, kv, hd, hdv,
                      DTYPE_CODE[q.dtype], hd ** -0.5, int(causal), window,
                      stream)
        return (dq, dk, dv), err

    fwd_rows, fwd_ok, f32_worst = [], 0, dict(current=0.0, parent=0.0)
    for i, (dt, b, s, h, kv, hd, hdv, causal, window, sk) in enumerate(
            cases()):
        q, k, v, _ = _inputs(dev, 500 + i, dt, b, s, h, kv, hd, hdv,
                             sk or s)
        with torch.inference_mode():
            served = fa.flash_attention(q, k, v, causal=causal,
                                        window=window)
        grads = [t.clone().requires_grad_(True) for t in (q, k, v)]
        trained = fa.flash_attention(*grads, causal=causal,
                                     window=window).detach()
        ref, err = parent_forward(q, k, v, causal, window)
        torch.cuda.synchronize()
        if dt == BF16:
            ok = (err == 0 and torch.equal(served, ref)
                  and torch.equal(trained, ref))
        else:
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            cur, par = _err(served, want), _err(ref, want)
            f32_worst["current"] = max(f32_worst["current"], cur / GATE)
            f32_worst["parent"] = max(f32_worst["parent"], par / GATE)
            ok = (err == 0 and cur <= GATE and torch.equal(served, trained))
        fwd_ok += ok
        if not ok:
            fwd_rows.append([str(dt), b, s, h, kv, hd, hdv, causal, window,
                             sk, err])

    bwd_rows, bwd_ok = [], 0
    for i, (dt, b, s, h, kv, hd, hdv, causal, window, sk) in enumerate(
            backward_cases()):
        q, k, v, do = _inputs(dev, 700 + i, dt, b, s, h, kv, hd, hdv,
                              sk or s)
        mode = dict(causal=causal, window=window)
        out, lse = fa.flash_attention_with_lse(q, k, v, **mode)
        got = fa.flash_attention_backward(q, k, v, out, lse, do, **mode)
        ref, err = parent_backward(q, k, v, out, lse, do, causal, window)
        torch.cuda.synchronize()
        if dt == BF16:
            ok = err == 0 and all(torch.equal(x, y)
                                  for x, y in zip(got, ref))
        else:
            want = fa.flash_attention_backward_plain(q, k, v, out, lse, do,
                                                     **mode)
            over = [_err(x, w) / (GATE * max(float(w.abs().max()), 1e-6))
                    for x, w in zip(got, want)]
            par = [_err(x, w) / (GATE * max(float(w.abs().max()), 1e-6))
                   for x, w in zip(ref, want)]
            f32_worst["current_backward"] = max(
                f32_worst.get("current_backward", 0.0), *over)
            f32_worst["parent_backward"] = max(
                f32_worst.get("parent_backward", 0.0), *par)
            ok = err == 0 and max(over) <= 1.0
        bwd_ok += ok
        if not ok:
            bwd_rows.append([str(dt), b, s, h, kv, hd, hdv, causal, window,
                             sk, err])

    timed = {}
    for name, (b, s, sk) in {"encoder_b32": (32, 1500, 1500),
                             "encoder_b1": (1, 1500, 1500),
                             "cross_b32": (32, 32, 1500),
                             "cross_b4": (4, 32, 1500),
                             "cross_b2": (2, 32, 1500),
                             "cross_b1": (1, 32, 1500)}.items():
        q, k, v, _ = _inputs(dev, 900, F32, b, s, 16, 16, 64, 64, sk)
        reps = 5 if b == 32 and s > 32 else 20
        run_old = lambda: parent_forward(q, k, v, False, 0)  # noqa: E731
        run_new = lambda: fa.flash_attention(  # noqa: E731
            q, k, v, causal=False)
        turns = [time_ms(run_old, reps), time_ms(run_new, reps),
                 time_ms(run_new, reps), time_ms(run_old, reps)]
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        timed[name] = dict(
            parent_ms=turns[0::3], current_ms=turns[1:3],
            splits=fa.flash_splits(b, 16, s, sk,
                                   torch.cuda.get_device_properties(
                                       dev).multi_processor_count)[0],
            sdpa_ms=time_ms(lambda:
                            torch.nn.functional.scaled_dot_product_attention(
                                qt, kt, vt), reps),
            plain_ms=time_ms(lambda: fa.flash_attention_plain(
                q, k, v, causal=False), 3, 1))
    q, k, v, do = _inputs(dev, 901, F32, 8, 512, 16, 16, 64, 64, 512)
    out, lse = fa.flash_attention_with_lse(q, k, v)
    run_old = lambda: parent_backward(q, k, v, out, lse, do, True, 0)  # noqa
    run_new = lambda: fa.flash_attention_backward(  # noqa: E731
        q, k, v, out, lse, do)
    turns = [time_ms(run_old), time_ms(run_new), time_ms(run_new),
             time_ms(run_old)]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                         is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    timed["backward_train"] = dict(
        parent_ms=turns[0::3], current_ms=turns[1:3],
        sdpa_backward_ms=time_ms(lambda: torch.autograd.grad(
            o, (qt, kt, vt), dot, retain_graph=True)),
        plain_ms=time_ms(lambda: fa.flash_attention_backward_plain(
            q, k, v, out, lse, do), 3, 1))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    n_fwd, n_bwd = len(cases()), len(backward_cases())
    print(json.dumps({"forward_cases": n_fwd, "forward_ok": fwd_ok,
                      "backward_cases": n_bwd, "backward_ok": bwd_ok,
                      "differ": fwd_rows + bwd_rows,
                      "f32_worst_over_gate": f32_worst, "timed": timed,
                      "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    return 0 if fwd_ok == n_fwd and bwd_ok == n_bwd else 1


if __name__ == "__main__":
    sys.exit(main())
