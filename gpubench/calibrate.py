#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, on the chip.

    python3 gpubench/calibrate.py --workload <cell> --seeds a,b,... \
        [--control-seeds a,b,c] [--seconds s]

One process, one set-up: for each seed, the seed's weights are drawn
into the model, a window of ``--seconds`` runs at the cell's own load,
and the plain reference judges the sampled batches as a run does
(``drivers.serve.judge``).  On the control seeds the control (the
reference in the program's place, every product's operands rounded to
float8 e4m3) is judged against the same reference on the same batches.
Prints a JSON line a seed, then the lower reading of each number (the
largest the program gave) and the upper one (the smallest the control
gave).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from gpubench.drivers.serve import (NUMBERS, Server, judge, sample,  # noqa: E402
                                    serve, served)
from gpubench.lib import catalog  # noqa: E402
from gpubench.lib.traffic import Requests  # noqa: E402


def readings(cell: dict, cfg: dict, traffic: dict, seeds, control_seeds,
             seconds: float, device, strict: bool = True) -> dict:
    server = Server(cfg, traffic, seeds[0], device, strict=strict)
    low = {k: 0.0 for k in NUMBERS}
    high = {k: float("inf") for k in NUMBERS}
    rows = []
    for i, seed in enumerate(seeds):
        if i:
            server.reseed(seed)
        req = Requests(traffic, seed, seconds, cfg["vocab_size"], device)
        if i == 0:
            server.warm(req)
        w = serve(server, req)
        items = [served(b, rows) for b, rows in sample(
            w, cfg, traffic, int(cell["check"]["requests"]), seed)]
        del w, req
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        got = judge(cfg, items, server.weights, device,
                    control=seed in control_seeds)
        row = {"seed": seed, **got}
        if "control" in got:
            row["control"] = got["control"]
            for k in NUMBERS:
                high[k] = min(high[k], got["control"][k])
        for k in NUMBERS:
            low[k] = max(low[k], got[k])
        print(json.dumps(row), flush=True)
        rows.append(row)
    return {"lower": low, "upper": high, "seeds": len(seeds)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    cell = catalog.cell(args.workload)
    cfg = catalog.config(cell["config"])
    traffic = catalog.traffic(cell["traffic"])
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    out = readings(cell, cfg, traffic, seeds, ctl, args.seconds,
                   torch.device("cuda"))
    print(json.dumps({"workload": args.workload, **out,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
