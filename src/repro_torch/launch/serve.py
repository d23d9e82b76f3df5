"""Serving entrypoint: the dynamic-batching engine (the paper's system)
driven by a Poisson load generator, on one NVIDIA GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --full --workload generate --rho 0.5 --jobs 300

Port of the reference package's ``repro.launch.serve`` with its options.
It calibrates τ^[b] on every bucket (3 samples each), fits (α, τ0),
serves ``--jobs`` Poisson requests at λ = ρ/α and prints the measured
E[W] beside the paper's bound φ.  ``run(args)`` returns the same
numbers as a dict.  It runs on CUDA and raises without a GPU.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.configs import get_config, list_archs, reduced as reduce_cfg
from repro_torch.configs.base import ModelConfig
from repro_torch.core import (BatchAllWaiting, CappedBatch, TimeoutBatch,
                              fit_service_model, phi)
from repro_torch.serving import InferenceEngine

POLICIES = {
    "batch-all": lambda a: BatchAllWaiting(),
    "capped": lambda a: CappedBatch(cap=a.max_batch),
    "timeout": lambda a: TimeoutBatch(cap=a.max_batch),
}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--full", action="store_true",
                    help="full config (published widths); default reduced")
    ap.add_argument("--workload", default="forward",
                    choices=["forward", "generate"])
    ap.add_argument("--rho", type=float, default=0.5)
    ap.add_argument("--jobs", type=int, default=300)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--policy", default="batch-all", choices=list(POLICIES))
    return ap.parse_args(argv)


def run(args: argparse.Namespace, device=None,
        cfg: Optional[ModelConfig] = None) -> dict:
    """Calibrate, fit and serve; returns τ^[b] per bucket (s), α, τ0, R²,
    λ, E[W], φ and the served trace's statistics.  ``cfg``, when given,
    is served in place of ``--arch``'s config (a depth cut of it, say:
    the command line has no flag for that, as the reference's has
    none)."""
    if cfg is None:
        cfg = get_config(args.arch)
    if not args.full:
        cfg = reduce_cfg(cfg)
    eng = InferenceEngine(cfg, workload=args.workload, seq_len=32,
                          max_batch=args.max_batch, device=device)
    b, tau = eng.calibrate(samples=3)
    model, r2 = fit_service_model(b, tau)
    lam = args.rho / model.alpha
    res = eng.serve_poisson(lam, n_jobs=args.jobs,
                            policy=POLICIES[args.policy](args), seed=0)
    return dict(engine=eng, buckets=b.tolist(), tau_s=tau.tolist(),
                alpha_s=model.alpha, tau0_s=model.tau0, r2=r2, lam=lam,
                result=res, phi_s=float(phi(lam, model.alpha, model.tau0)))


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    out = run(args)
    res = out["result"]
    print(f"calibrated: alpha={out['alpha_s'] * 1e3:.3f} ms "
          f"tau0={out['tau0_s'] * 1e3:.3f} ms (R^2={out['r2']:.4f})")
    print(f"rho={args.rho}: served {res.n_jobs} jobs  "
          f"E[W]={res.mean_latency * 1e3:.1f} ms "
          f"(phi={out['phi_s'] * 1e3:.1f} ms) "
          f"E[B]={res.mean_batch:.1f} util={res.utilization:.3f} "
          f"p99={res.latency_p99 * 1e3:.1f} ms")


if __name__ == "__main__":
    main()
