#!/usr/bin/env python3
"""Find the highest rate a cell's server sustains, once, on the chip.

    python3 gpubench/sweep.py --workload <cell> --seed <n> --seconds <s> \
        [--fractions 0.6,0.8,0.9,1.0,1.1]

One process: the cell's set-up, then each bucket's batch time τ^[b]
(the median of three calls), then one open-loop window at each fraction
of ``b_max / τ^[b_max]``, the rate at which full batches back to back
would serve.  A window's backlog grows when the requests due in its last
third wait more than twice as long as those due in its first third and
longer than one full batch.  Prints a JSON line a rate and a summary
line with the highest rate that did not grow a backlog.

    python3 gpubench/sweep.py --workload <cell> --simulate '<tau line>' \
        --rates 41,45 --seconds 51 --seeds 12

With ``--simulate`` (no card needed) it replays the cell's arrivals,
seed by seed, through batch-all over pow2 buckets that take the printed
τ^[b] each, and prints for each rate the median and the quartile spread
of E[W] and p95 over the seeds, and the range of batch counts.  Between
about half and all of the knee, batch-all over pow2 buckets whose time
grows with the bucket can settle in more than one bucket size for a
whole window; a rate where the seeds' E[W] spread little has one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gpubench.drivers.serve import Server, serve  # noqa: E402
from gpubench.lib import catalog  # noqa: E402
from gpubench.lib.traffic import Requests, arrival_times  # noqa: E402


def grows(window, seconds: float, tau_full: float) -> bool:
    wait = window.start - window.due
    first = wait[window.due < seconds / 3].mean()
    last = wait[window.due >= 2 * seconds / 3].mean()
    return bool(last > 2 * first and last > tau_full)


HOST_GAP_S = 0.002      # the host's time between batches, a little above
                        # the 0.6 ms a traced phi4 window reads


def simulate(tau: dict, traffic: dict, seed: int, seconds: float) -> dict:
    """One window of the cell's arrivals for ``seed`` through batch-all
    capped at ``b_max``, each batch taking its bucket's ``tau`` (seconds,
    keyed by bucket) plus ``HOST_GAP_S``."""
    due = arrival_times(traffic, seed, seconds)
    b_max = int(traffic["b_max"])
    buckets = sorted(int(k) for k in tau)
    done = np.empty(len(due))
    t, i, batches = 0.0, 0, 0
    while i < len(due):
        t = max(t, due[i])
        b = min(int(np.searchsorted(due, t, side="right")) - i, b_max)
        t += HOST_GAP_S + float(tau[str(next(k for k in buckets if k >= b))])
        done[i:i + b] = t
        i += b
        batches += 1
    lat = (done - due) * 1e3
    return {"latency_mean_ms": float(lat.mean()),
            "latency_p95_ms": float(np.percentile(lat, 95)),
            "batches": batches}


def _spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def simulate_rates(traffic: dict, tau: dict, rates, seconds: float,
                   seeds: int) -> None:
    for rate in rates:
        tr = dict(traffic, rate_rps=rate)
        runs = [simulate(tau, tr, 2 ** 31 + k, seconds) for k in range(seeds)]
        row = {"rate_rps": rate}
        for key in ("latency_mean_ms", "latency_p95_ms"):
            v = [r[key] for r in runs]
            row[key] = statistics.median(v)
            row[key + "_spread"] = _spread(v)
        row["batches"] = [min(r["batches"] for r in runs),
                          max(r["batches"] for r in runs)]
        print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--fractions", default="0.6,0.8,0.9,1.0,1.1")
    ap.add_argument("--simulate", help="a tau line this script printed")
    ap.add_argument("--rates", default="")
    ap.add_argument("--seeds", type=int, default=12)
    args = ap.parse_args()
    cell = catalog.cell(args.workload)
    cfg = catalog.config(cell["config"])
    traffic = dict(catalog.traffic(cell["traffic"]))
    if args.simulate:
        simulate_rates(traffic, json.loads(args.simulate)["tau_s"],
                       [float(r) for r in args.rates.split(",")],
                       args.seconds, args.seeds)
        return 0
    dev = torch.device("cuda")
    server = Server(cfg, traffic, args.seed, dev)
    probe = Requests(traffic, args.seed, 1.0, cfg["vocab_size"], dev)
    server.warm(probe)
    tau = {}
    for bb in server.engine.buckets:
        ts = []
        for _ in range(3):
            t = time.perf_counter()
            server.call(probe.batch([], bb))
            ts.append(time.perf_counter() - t)
        tau[bb] = statistics.median(ts)
    full = tau[server.b_max]
    mu = server.b_max / full
    print(json.dumps({"tau_s": tau, "full_batch_rate_rps": mu}), flush=True)
    best = None
    for i, f in enumerate(float(x) for x in args.fractions.split(",")):
        traffic["rate_rps"] = f * mu
        req = Requests(traffic, args.seed + 1 + i, args.seconds,
                       cfg["vocab_size"], dev)
        w = serve(server, req)
        lat = w.latencies() * 1e3
        g = grows(w, args.seconds, full)
        row = {"fraction": f, "rate_rps": f * mu, "requests": len(req),
               "throughput_rps": len(req) / w.seconds,
               "latency_mean_ms": float(lat.mean()),
               "latency_p95_ms": float(np.percentile(lat, 95)),
               "mean_batch": float(np.mean([len(b.ids) for b in w.batches])),
               "drain_s": w.seconds - args.seconds, "backlog_grows": g}
        print(json.dumps(row), flush=True)
        if not g:
            best = f * mu
        del req, w
    print(json.dumps({"workload": args.workload, "knee_rps": best,
                      "cell_rate_rps": None if best is None else 0.8 * best,
                      "card": torch.cuda.get_device_name(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
