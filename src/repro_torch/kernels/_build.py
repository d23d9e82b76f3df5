"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launch function (no PyTorch
headers, so ``nvcc`` takes seconds, not minutes) and is compiled for
Hopper (``sm_90a``) into ``build/repro_torch/lib<name>-<hash>.so`` at
the root of the checkout; ``.gitignore`` lists ``build/``.  The hash
covers the source, the headers it includes from ``csrc/`` (``#include
"<file>"``, followed into those headers too) and the flags, so an
edited source or one of its headers builds afresh.
A build or load failure raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "library", "build",
           "build_seconds"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
# wall seconds from the start of a build() call to the end of each
# library's nvcc, in this process (0 when the .so was already on disk)
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                       "built from source at first use and need the "
                       "CUDA toolkit")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: Dict[Path, bytes]) -> Dict[Path, bytes]:
    """``path`` and the ``csrc/`` headers it includes, transitively."""
    if path not in seen:
        seen[path] = path.read_bytes()
        for inc in _LOCAL_INCLUDE.findall(seen[path]):
            _sources(CSRC / inc.decode(), seen)
    return seen


def _out_path(name: str) -> Path:
    text = b"".join(_sources(CSRC / f"{name}.cu", {}).values())
    digest = hashlib.sha256(text
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(*names: str) -> List[Path]:
    """Compile each ``csrc/<name>.cu`` whose current build is missing,
    one ``nvcc`` per source, all started together; returns the shared
    libraries' paths in the order of ``names``."""
    outs = [_out_path(name) for name in names]
    procs = []
    t0 = time.perf_counter()
    for name, out in zip(names, outs):
        if out.exists():
            build_seconds.setdefault(name, 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu "
                          f"(exit {proc.returncode}):\n{err}")
            continue
        os.replace(tmp, out)
        build_seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)[0]))
            _LOADED[name] = lib
        return lib
