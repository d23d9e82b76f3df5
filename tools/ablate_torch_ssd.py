#!/usr/bin/env python3
"""Where the SSD scan kernels (B5) spend their time, on the GPU.

    python3 tools/ablate_torch_ssd.py

Builds copies of ``src/repro_torch/kernels/csrc/ssd_scan.cu`` into
``build/ablate_ssd/`` with one tile phase of ``ssd_scan_kernel_bf16``
compiled out each — ``no_ab`` (the scores C·Bᵀ, M and y += M·x),
``no_c`` (y += exp(cum)·C·hᵀ), ``no_d`` (the state update), ``only_d``
(no y products at all: staging, prefix sum, state update and the
stores) — and, of the float32 ``ssd_scan_kernel_f32``, ``f32_no_a``
(the scores C·Bᵀ and M), ``f32_no_c`` (C·hᵀ), ``f32_no_b`` (M·x),
``f32_no_d`` (the state update) and ``f32_only_stage`` (all four out:
staging, prefix sum and the stores) — beside the whole kernel, and
times each through ``ssd_chunked`` at mamba2-2.7b's heads on
``chip_smoke.py``'s serve (B 32, S 32), long (B 32, S 1,024) and
batch-1 (S 1,024) shapes in bf16 and its float32 shape (B 4 × 300), in
two rounds that alternate the variants.  Then it times the whole kernel at
batch 1 with the time axis cut into 1, 2, 3, 4, 6 and 8 pieces (the
split rule picks 4).  An ablated copy computes wrong results: it is
timed, never checked.  Prints one JSON line, with ptxas's registers
and spills for each kernel instance of ``ssd_scan.cu`` and of
``ssd_scan_backward.cu`` (bf16 and float32; the backward built beside,
not timed) and the card's name and power limit.  Needs one CUDA device; imports nothing of JAX or of the
reference package.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (SSM_ARCH, SSM_LONG, SSM_PROMPT,  # noqa: E402
                        _ssd_inputs, nvidia_smi, time_ms)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

OUT = ROOT / "build" / "ablate_ssd"
# the macro that compiles a phase of a kernel out: the kernel it is in
# (the text that opens its definition), then (text that opens the
# phase, text that follows its last line), cut in this order (the end of
# NO_C is where the second NO_AB part starts, the end of F32_NO_C where
# F32_NO_B starts)
BF16, F32 = "ssd_scan_kernel_bf16(", "ssd_scan_kernel_f32("
PHASES = {
    "NO_C": (BF16, [("      if (k > 0 || it > 0) {",
                     "#pragma unroll\n      for (int kj = 0; kj < kMT; ++kj) {\n"
                     "        if (16 * kj >= n) break;\n        uint32_t xf[4];")]),
    "NO_AB": (BF16, [("      for (int ib = warp; ib < kMT; ib += L::kWarps) {",
                      "      __syncthreads();\n\n      // y[:, d0"),
                     ("#pragma unroll\n      for (int kj = 0; kj < kMT; ++kj) {\n"
                      "        if (16 * kj >= n) break;\n        uint32_t xf[4];",
                      "#pragma unroll\n      for (int mi = 0; mi < kMT; ++mi)\n"
                      "#pragma unroll\n        for (int hf = 0; hf < 2; ++hf) {")]),
    "NO_D": (BF16, [("      const float decay = expf(total);",
                     "    }\n  }\n\n  float* dst = nullptr;")]),
    "F32_NO_A": (F32, [("    for (int p = warp; p < 3; p += L::kWarps) {",
                        "    __syncthreads();\n\n    // y[:, d0")]),
    "F32_NO_C": (F32, [("    if (it > 0) {\n#pragma unroll\n      for (int ks = 0; ks < "
                        "kSN; ++ks) {",
                        "#pragma unroll\n    for (int kj = 0; kj < kKT; ++kj) {\n"
                        "      if (8 * kj >= n) break;\n      uint32_t xb2")]),
    "F32_NO_B": (F32, [("#pragma unroll\n    for (int kj = 0; kj < kKT; ++kj) {\n"
                        "      if (8 * kj >= n) break;\n      uint32_t xb2",
                        "#pragma unroll\n    for (int mi = 0; mi < kMT; ++mi)\n"
                        "#pragma unroll\n      for (int hf = 0; hf < 2; ++hf) {\n"
                        "        const int i = 16 * mi + g4 + 8 * hf;")]),
    "F32_NO_D": (F32, [("      const float decay = expf(total);\n"
                        "      uint32_t wb[kKT][4]",
                        "    }\n  }\n\n  if (h_out != nullptr) {")]),
}
VARIANTS = {"whole": [], "no_ab": ["NO_AB"], "no_c": ["NO_C"],
            "no_d": ["NO_D"], "only_d": ["NO_AB", "NO_C"],
            "f32_no_a": ["F32_NO_A"], "f32_no_c": ["F32_NO_C"],
            "f32_no_b": ["F32_NO_B"], "f32_no_d": ["F32_NO_D"],
            "f32_only_stage": ["F32_NO_A", "F32_NO_B", "F32_NO_C",
                               "F32_NO_D"]}


def guarded_source() -> str:
    """The kernel source with each phase inside ``#ifndef`` its macro;
    raises if the kernel no longer has the text a phase is cut at."""
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    for macro, (kernel, cuts) in PHASES.items():
        for start, end in cuts:
            i = src.find(start, src.find(kernel))
            j = src.find(end, i)
            if i < 0 or j < 0:
                raise RuntimeError(f"ablate_torch_ssd: {macro} cut "
                                   f"{start.strip()[:40]!r} not found")
            src = (src[:i] + f"#ifndef {macro}\n" + src[i:j] + "#endif\n"
                   + src[j:])
    return src


def ptxas_kernels(text: str) -> dict:
    """``-Xptxas -v``'s report, kernel instance by kernel instance:
    "Compiling entry function '<mangled>'", then its spills and "Used N
    registers" lines, keyed ``name<template arguments>``."""
    out, kernel = {}, None
    for line in text.splitlines():
        if "entry function" in line:
            m = re.search(r"\d(ssd_[a-z0-9_]*kernel[a-z0-9_]*)I"
                          r"((?:L[ib]\d+E)+)E", line)
            kernel = (None if m is None else "{}<{}>".format(
                m.group(1), ", ".join(re.findall(r"L[ib](\d+)E",
                                                 m.group(2)))))
        elif kernel and ("Used" in line or "spill" in line):
            out.setdefault(kernel, []).append(line.split(":", 1)[-1].strip())
    return out


def build_variants():
    """The variants' loaded libraries, and ptxas's register and spill
    report for each kernel instance of the whole scan and of the
    backward."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "ssd_scan.cu"
    src.write_text(guarded_source())
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{m}" for m in macros),
         # the copy includes csrc/'s headers from the sources' folder
         "-I", str(_build.CSRC),
         *(["-Xptxas", "-v"] if name == "whole" else []),
         "-o", str(OUT / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, macros in VARIANTS.items()}
    backward = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(OUT / "backward.so"),
         str(_build.CSRC / "ssd_scan_backward.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs, ptxas = {}, {}
    for name, proc in list(procs.items()) + [("backward", backward)]:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        if name in ("whole", "backward"):
            ptxas.update(ptxas_kernels(err))
        if name != "backward":
            libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    return libs, ptxas


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_torch_ssd: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    libs, ptxas = build_variants()
    model = get_config(SSM_ARCH)
    cfg = model.ssm
    nh, hd, ds = cfg.n_heads(model.d_model), cfg.head_dim, cfg.d_state
    shapes = {"serve": (32, SSM_PROMPT), "long": (32, SSM_LONG),
              "batch1": (1, SSM_LONG), "f32": (4, 300)}
    args = {k: _ssd_inputs(dev, torch.float32 if k == "f32"
                           else torch.bfloat16, b, s, nh, 1, hd, ds, i)
            for i, (k, (b, s)) in enumerate(shapes.items())}
    library, rule = _build.library, ss.ssd_splits
    phases = {}
    try:
        for rnd in range(2):
            order = list(libs) if rnd == 0 else list(reversed(libs))
            for name in order:
                _build.library = lambda _n, lib=libs[name]: lib
                for k, a in args.items():
                    phases.setdefault(name, {}).setdefault(k, []).append(
                        time_ms(lambda: ss.ssd_chunked(*a, cfg.chunk_size),
                                reps=20))
        _build.library = lambda _n: libs["whole"]
        pieces = {}
        b, s = shapes["batch1"]
        for tiles in (16, 8, 6, 4, 3, 2):      # 1, 2, 3, 4, 6, 8 pieces
            piece = tiles * ss.TILE
            ss.ssd_splits = lambda *_a, p=piece: (-(-s // p), p)
            pieces[f"{-(-s // piece)}x{piece}"] = time_ms(
                lambda: ss.ssd_chunked(*args["batch1"], cfg.chunk_size),
                reps=20)
    finally:
        _build.library, ss.ssd_splits = library, rule
    print(json.dumps({
        "shapes": shapes, "ptxas": ptxas, "phases_ms": phases,
        "batch1_pieces_ms": pieces,
        "split_rule": rule(b, s, nh, torch.cuda.get_device_properties(
            dev).multi_processor_count),
        "seconds": time.perf_counter() - t0,
        "nvidia_smi": nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
