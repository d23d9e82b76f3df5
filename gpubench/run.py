#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell (``gpubench/workloads/<cell>.json``)
names its configuration, traffic and driver, each found by name
(``lib.catalog``).  The last line on standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; ``checks``, each number compared with its limit, comes last,
and the same numbers close standard error.  The run exits non-zero and
prints no result without as many CUDA devices as the cell asks for, and
when JAX, Flax or the JAX package was loaded.  The program's kernels build
into ``build/`` inside the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# caches the program's libraries may keep, at fixed paths in the checkout
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "nv"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's, Flax's or the JAX package's."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from gpubench.lib import catalog

    cell = catalog.cell(args.workload)
    cfg = catalog.config(cell["config"])
    traffic = catalog.traffic(cell["traffic"])
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    driver = catalog.driver(cell["driver"])
    result = driver.run(cell, cfg, traffic, seed=args.seed,
                        seconds=args.seconds, trace=bool(args.trace),
                        t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: the run loaded {bad}", file=sys.stderr)
        return 3
    if not args.trace:
        keep = catalog.end_to_end(args.workload)
        result["metrics"] = {k: v for k, v in result["metrics"].items()
                             if k in keep}
    checks = result.pop("checks")
    result["checks"] = checks
    info = result.get("info", {})
    print(f"run.py: {args.workload} seed {args.seed}: "
          f"{json.dumps(info)}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
