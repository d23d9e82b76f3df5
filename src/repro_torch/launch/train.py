"""Training entrypoint: the train step on one NVIDIA GPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 20 --batch 8 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \\
      --steps 10 --batch 2 --seq 512

Port of the reference package's ``repro.launch.train`` with its options:
the full config unless ``--reduced``, the port's seeded weights (seed 0),
AdamW with a cosine schedule over ``--steps`` (warm-up a tenth of them),
the synthetic corpus (tokens and labels only, as the reference's
launcher feeds), ``--remat`` checkpointing the repeated layers.  The
reference's meshes (``--production``, ``--multi-pod``) belong to ROADMAP
A11 and raise ``NotImplementedError``.  On the card the attention
layers train through B3 and its backward kernels, and the Mamba2 layers
of the SSM and hybrid families through B5 and its backward kernels; a
depth cut (one period of Jamba, say) goes in through ``run(args,
cfg=...)``.  ``run(args)`` returns the losses, the host-clock ms of each
step (each ended by reading its loss) and the peak device bytes as a
dict.  It runs on CUDA and raises without a GPU
unless ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch.configs import get_config, list_archs, reduced as reduce_cfg
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.train.data import DataConfig, SyntheticCorpus
from repro_torch.train.loop import (make_train_step, require_trainable,
                                    resolve_device)
from repro_torch.train.optimizer import AdamWConfig, init_state


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--production", action="store_true",
                    help="the production mesh (ROADMAP A11: not ported)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--remat", action="store_true")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, cfg: Optional[ModelConfig] = None,
        device=None, log: bool = True) -> dict:
    """Train ``args.steps`` steps of ``--arch`` (or ``cfg``, e.g. a depth
    cut) and return ``losses``, ``grad_norms``, ``step_ms`` (each step,
    host clock to its loss on the host), ``step_ms_warm`` (all but the
    first), ``peak_bytes`` (CUDA: the allocator's peak over the run) and
    the run's shape."""
    if args.production or args.multi_pod:
        raise NotImplementedError(
            "--production / --multi-pod: the port's meshes and sharding "
            "are ROADMAP A11, not ported; the port trains on one card")
    if cfg is None:
        cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    require_trainable(cfg, device if device is not None else "cuda")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt_state = init_state(model)
    opt = AdamWConfig(total_steps=args.steps,
                      warmup_steps=max(args.steps // 10, 1))
    step_fn = make_train_step(cfg, opt, remat=args.remat)
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.batch))
    losses, norms, step_ms = [], [], []
    for i, batch in zip(range(args.steps), data.batches()):
        jb = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
              for k, v in batch.items()}
        t0 = time.perf_counter()
        model, opt_state, m = step_fn(model, opt_state, jb)
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(m["grad_norm"]))
        if log and (i % max(args.steps // 10, 1) == 0
                    or i == args.steps - 1):
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"({step_ms[-1]:.0f} ms)", flush=True)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    return dict(arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
                device=str(dev), steps=args.steps, batch=args.batch,
                seq=args.seq, remat=args.remat,
                tokens_per_step=args.batch * args.seq, losses=losses,
                grad_norms=norms, step_ms=step_ms,
                step_ms_warm=step_ms[1:], peak_bytes=peak)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    out = run(args)
    warm = sorted(out["step_ms_warm"]) or [float("nan")]
    print(f"{out['arch']}: loss {out['losses'][0]:.4f} -> "
          f"{out['losses'][-1]:.4f}, median warm step "
          f"{warm[len(warm) // 2]:.1f} ms, peak {out['peak_bytes']} bytes")


if __name__ == "__main__":
    main()
