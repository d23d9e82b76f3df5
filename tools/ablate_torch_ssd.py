#!/usr/bin/env python3
"""Where the bf16 SSD scan kernel (B5) spends its time, on the GPU.

    python3 tools/ablate_torch_ssd.py

Builds copies of ``src/repro_torch/kernels/csrc/ssd_scan.cu`` into
``build/ablate_ssd/`` with one tile phase of ``ssd_scan_kernel_bf16``
compiled out each — ``no_ab`` (the scores C·Bᵀ, M and y += M·x),
``no_c`` (y += exp(cum)·C·hᵀ), ``no_d`` (the state update), ``only_d``
(no y products at all: staging, prefix sum, state update and the
stores) — beside the whole kernel, and times each through
``ssd_chunked`` at mamba2-2.7b's heads on ``chip_smoke.py``'s serve
(B 32, S 32), long (B 32, S 1,024) and batch-1 (S 1,024) shapes, in two
rounds that alternate the variants.  Then it times the whole kernel at
batch 1 with the time axis cut into 1, 2, 3, 4, 6 and 8 pieces (the
split rule picks 4).  An ablated copy computes wrong results: it is
timed, never checked.  Prints one JSON line, with ptxas's registers
and spills for each bf16 kernel instance and the card's name and
power limit.  Needs one CUDA device; imports nothing of JAX or of the
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
# the macro that compiles a phase of the bf16 kernel out: (text that
# opens the phase, text that follows its last line), cut in this order
# (the end of the NO_C phase is where the second NO_AB part starts)
PHASES = {
    "NO_C": [("      if (k > 0 || it > 0) {",
              "#pragma unroll\n      for (int kj = 0; kj < kMT; ++kj) {\n"
              "        if (16 * kj >= n) break;\n        uint32_t xf[4];")],
    "NO_AB": [("      for (int ib = warp; ib < kMT; ib += L::kWarps) {",
               "      __syncthreads();\n\n      // y[:, d0"),
              ("#pragma unroll\n      for (int kj = 0; kj < kMT; ++kj) {\n"
               "        if (16 * kj >= n) break;\n        uint32_t xf[4];",
               "#pragma unroll\n      for (int mi = 0; mi < kMT; ++mi)\n"
               "#pragma unroll\n        for (int hf = 0; hf < 2; ++hf) {")],
    "NO_D": [("      const float decay = expf(total);",
              "    }\n  }\n\n  float* dst = nullptr;")],
}
VARIANTS = {"whole": [], "no_ab": ["NO_AB"], "no_c": ["NO_C"],
            "no_d": ["NO_D"], "only_d": ["NO_AB", "NO_C"]}


def guarded_source() -> str:
    """The kernel source with each phase inside ``#ifndef`` its macro;
    raises if the kernel no longer has the text a phase is cut at."""
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    for macro, cuts in PHASES.items():
        for start, end in cuts:
            i = src.find(start)
            j = src.find(end, i)
            if i < 0 or j < 0:
                raise RuntimeError(f"ablate_torch_ssd: {macro} cut "
                                   f"{start.strip()[:40]!r} not found")
            src = (src[:i] + f"#ifndef {macro}\n" + src[i:j] + "#endif\n"
                   + src[j:])
    return src


def build_variants():
    """The variants' loaded libraries, and ptxas's register and spill
    report for each bf16 kernel instance of the whole one."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "ssd_scan.cu"
    src.write_text(guarded_source())
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{m}" for m in macros),
         *(["-Xptxas", "-v"] if name == "whole" else []),
         "-o", str(OUT / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, macros in VARIANTS.items()}
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
        if name == "whole":
            # "Compiling entry function '<mangled>'", then its spills and
            # "Used N registers" lines
            kernel = None
            for line in err.splitlines():
                if "entry function" in line:
                    m = re.search(r"ssd_scan_kernel_bf16ILi(\d+)ELi(\d+)"
                                  r"ELi(\d+)ELb(\d)E", line)
                    kernel = (None if m is None else "<{}, {}, {}, {}>".format(
                        *m.groups()[:3], "true" if m.group(4) == "1"
                        else "false"))
                elif kernel and ("Used" in line or "spill" in line):
                    ptxas.setdefault(kernel, []).append(
                        line.split(":", 1)[-1].strip())
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
              "batch1": (1, SSM_LONG)}
    args = {k: _ssd_inputs(dev, torch.bfloat16, b, s, nh, 1, hd, ds, i)
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
