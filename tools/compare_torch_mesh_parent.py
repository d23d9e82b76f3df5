#!/usr/bin/env python3
"""The train step on the one-rank device mesh against an earlier
checkout's, in turns on one card.

    git archive <commit> | tar -x -C build/parent
    python3 tools/compare_torch_mesh_parent.py --parent build/parent

Runs ``launch.train``'s ``run`` of qwen1.5-0.5b whole (5 steps at 8 ×
512, bf16, ``chip_smoke.py``'s ``mesh_train`` arguments) plain and with
``distribute=True`` on the one-rank NCCL host mesh, each tree in a
process of its own (its ``src`` on ``PYTHONPATH``, its kernels built
into its own ``build/``), in turns: parent, current, current, parent.
Prints one JSON line a run (the tree, the median warm step of each mode
in host-clock ms, their ratio and the losses) and a last line with each
tree's mean of those medians over its two runs, beside the card's name
and power limit.  The losses of the two trees must agree bit for bit
(exit 1 otherwise).
Needs one CUDA device and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "qwen1.5-0.5b", "--steps", "5", "--batch", "8", "--seq",
        "512"]
RUN = """
import json, sys
import numpy as np, torch
from repro_torch.launch import train
args = train.parse_args(json.loads(sys.argv[1]))
dev = torch.device("cuda", 0)
out = {}
for mode in ("plain", "mesh"):
    res = train.run(args, device=dev, log=False, distribute=mode == "mesh")
    out[mode] = {"step_ms_warm_median": float(np.median(res["step_ms"][1:])),
                 "losses": res["losses"]}
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def _run(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    proc = subprocess.run([sys.executable, "-c", RUN, json.dumps(ARGS)],
                          cwd=tree, env=env, capture_output=True, text=True,
                          check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path)
    parent = ap.parse_args().parent.resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    runs = {"parent": [], "current": []}
    for name in ("parent", "current", "current", "parent"):
        got = _run(parent if name == "parent" else ROOT)
        runs[name].append(got)
        plain = got["plain"]["step_ms_warm_median"]
        mesh = got["mesh"]["step_ms_warm_median"]
        print(json.dumps({"tree": name, "plain_step_ms": plain,
                          "mesh_step_ms": mesh, "ratio": mesh / plain,
                          "losses": got["mesh"]["losses"],
                          "nvidia_smi": smi}), flush=True)
    same = all(r[m]["losses"] == runs["parent"][0]["plain"]["losses"]
               for rs in runs.values() for r in rs for m in ("plain", "mesh"))

    def mean(name, mode):
        return sum(r[mode]["step_ms_warm_median"]
                   for r in runs[name]) / len(runs[name])

    print(json.dumps({
        "arch": "qwen1.5-0.5b", "args": ARGS, "losses_bitwise": same,
        **{f"{n}_{m}_step_ms": mean(n, m) for n in runs
           for m in ("plain", "mesh")}, "nvidia_smi": smi}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
