#!/usr/bin/env python3
"""B3 (``flash_attention``) against an earlier checkout's B3, bitwise, on
the shapes ``chip_smoke.py`` launches for serving: the forward as
serving runs it (no ``lse``) and, on CUDA tensors that require grad,
the forward of the autograd path (which also writes ``lse``).

    git archive <commit> | tar -x -C build/parent
    python3 tools/compare_torch_flash_parent.py --parent build/parent

Builds the parent's ``src/repro_torch/kernels/csrc/flash_attention.cu``
with the port's ``nvcc`` flags into ``build/parent_flash/``, calls its
``flash_attention_launch`` with the argument list it exports (with a
key length and a null ``lse``: q, k, v, out, lse, B, S, SK, H, KV, hd,
hdv, dtype, scale, causal, window, stream) and the current
``flash_attention`` on the same random inputs, once under
``inference_mode`` and once with grad on inputs that require it, and
requires the outputs equal bit for bit: the serve, long, batch-1 and
continuous shapes at 16 × 64, phi4-mini's 24 over 8 × 128, OLMoE's 16 ×
128, MLA's (192, 128) pair, Jamba's 32 over 8 × 128, windowed, unmasked
and float32 cases, whisper's and InternVL2's shapes (a key length of its
own: 32 queries over 1,500 keys) and the training shapes.  Prints one JSON line with
the count of cases and of bitwise-equal ones, and exits 1 if any
differs.  Needs one CUDA device and ``nvcc``; imports nothing of JAX.
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
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


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
    # a key length of its own (whisper's cross-attention), the encoder,
    # InternVL2's prefill and the training shapes
    out += [(F32, 32, 32, 16, 16, 64, 64, False, 0, 1500),
            (F32, 1, 32, 16, 16, 64, 64, False, 0, 1500),
            (F32, 2, 7, 16, 16, 64, 64, False, 0, 1499),
            (F32, 2, 1500, 16, 16, 64, 64, False, 0, 0),
            (BF16, 2, 1500, 16, 16, 64, 64, False, 0, 0),
            (BF16, 32, 288, 14, 2, 64, 64, True, 0, 0),
            (BF16, 8, 512, 16, 16, 64, 64, True, 0, 0),
            (F32, 2, 512, 16, 16, 64, 64, True, 0, 0),
            (BF16, 1, 4096, 16, 16, 64, 64, True, 0, 0)]
    return out


def parent_launch(parent: Path):
    src = parent / "src/repro_torch/kernels/csrc/flash_attention.cu"
    out_dir = ROOT / "build" / "parent_flash"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libflash_attention.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True)
    fn = ctypes.CDLL(str(so)).flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_torch_flash_parent: needs a CUDA device",
              file=sys.stderr)
        return 1
    old = parent_launch(args.parent)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows, same = [], 0
    for i, (dt, b, s, h, kv, hd, hdv, causal, window, sk) in enumerate(
            cases()):
        sk = sk or s
        gen = torch.Generator(device=dev).manual_seed(500 + i)
        q, k, v = (torch.randn(shape, device=dev, generator=gen).to(dt)
                   for shape in ((b, s, h, hd), (b, sk, kv, hd),
                                 (b, sk, kv, hdv)))
        with torch.inference_mode():
            served = flash_attention(q, k, v, causal=causal, window=window)
        grads = [t.clone().requires_grad_(True) for t in (q, k, v)]
        trained = flash_attention(*grads, causal=causal,
                                  window=window).detach()
        ref = torch.empty_like(served)
        err = old(q.data_ptr(), k.data_ptr(), v.data_ptr(), ref.data_ptr(),
                  None, b, s, sk, h, kv, hd, hdv, DTYPE_CODE[dt], hd ** -0.5,
                  int(causal), window, stream)
        torch.cuda.synchronize()
        ok = (err == 0 and torch.equal(served, ref)
              and torch.equal(trained, ref))
        same += ok
        if not ok:
            rows.append([str(dt), b, s, h, kv, hd, hdv, causal, window, sk,
                         err, torch.equal(served, ref),
                         torch.equal(trained, ref)])
    print(json.dumps({"cases": len(cases()), "bitwise_equal": same,
                      "differ": rows,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if same == len(cases()) else 1


if __name__ == "__main__":
    sys.exit(main())
