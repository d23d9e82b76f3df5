"""Training entrypoint: the train step on the host's device mesh (one
NVIDIA GPU, or every rank of a ``torch.distributed`` group), or on the
production mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 20 --batch 8 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \\
      --steps 10 --batch 2 --seq 512
  torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \\
      --production [--multi-pod] --arch qwen1.5-4b --batch 256 --seq 4096

Port of the reference package's ``repro.launch.train`` with its options:
the full config unless ``--reduced``, the port's seeded weights (seed 0),
AdamW with a cosine schedule over ``--steps`` (warm-up a tenth of them),
the synthetic corpus (``launch_batch``: tokens and labels, and for an
audio model the reference trainer's float32 zero ``frames``, without
which whisper's encoder has no input; a VLM keeps tokens and labels
only, as the reference's launcher feeds it), ``--remat`` checkpointing
the repeated layers.  The mesh
is ``launch.mesh.make_host_mesh()`` over the process group's world (a
one-rank group of its own when none is initialised, destroyed at the
end), or with ``--production`` / ``--multi-pod`` the 16 × 16 / 2 × 16 ×
16 production mesh, for a run of 256 / 512 ranks under ``torchrun``
(the group comes from torchrun's environment; any other world raises
``ValueError``).  On a mesh of more than one rank the parameters, the
AdamW moments (``REPRO_ZERO1=1``: ZeRO-1's) and each batch are placed
by their partition specs (``launch.sharding``) as DTensors, the step
runs on them, its kernels through ``local_map``, and the loss and the
grad norm are read with ``full_tensor()``.  Every family of the registry
runs so: the dense and SSM stacks, MoE (each rank routes whole groups of
tokens, the reference's, over experts sharded on "model"), MLA, the
hybrid interleave, whisper and InternVL2.  On a mesh of one device every
placement is the identity, so the run keeps plain tensors unless
``distribute=True`` asks for DTensors (``chip_smoke.py``'s
``mesh_train``).  On the card the attention layers train through B3 and
its backward kernels, and the Mamba2 layers of the SSM and hybrid
families through B5 and its backward kernels; a depth cut (one period of
Jamba, say) goes in through ``run(args, cfg=...)``.  ``run(args)``
returns the losses, the host-clock ms of each step (each ended by
reading its loss) and the peak device bytes as a dict.  It runs on CUDA
and raises without a GPU unless ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, list_archs, reduced as reduce_cfg
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import distribute as dst
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     owned_group)
from repro_torch.models import transformer as tfm
from repro_torch.train.data import DataConfig, SyntheticCorpus
from repro_torch.train.loop import (device_batch, make_train_step,
                                    require_trainable, resolve_device)
from repro_torch.train.optimizer import AdamWConfig, init_state


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--production", action="store_true",
                    help="use make_production_mesh (256 ranks; 512 with "
                         "--multi-pod), under torchrun")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--remat", action="store_true")
    return ap.parse_args(argv)


def launch_batch(cfg: ModelConfig, batch, dev: torch.device) -> dict:
    """A corpus batch as the launcher feeds it: ``device_batch``'s
    int64 tokens and labels and an audio model's float32 zero
    ``frames``, but no VLM ``patch_embeds``: the reference's launcher
    trains the VLM on its text alone, and zero patch rows overflow the
    gradient at InternVL2's depth."""
    out = device_batch(cfg, batch, dev)
    out.pop("patch_embeds", None)
    return out


def _mesh(args: argparse.Namespace, dev: torch.device):
    """The run's mesh and device: the production mesh over torchrun's
    group (its local rank's GPU), or the host mesh."""
    if not (args.production or args.multi_pod):
        return make_host_mesh(device_type=dev.type), dev
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return make_production_mesh(multi_pod=args.multi_pod,
                                device_type=dev.type), dev


def run(args: argparse.Namespace, cfg: Optional[ModelConfig] = None,
        device=None, log: bool = True,
        distribute: Optional[bool] = None) -> dict:
    """Train ``args.steps`` steps of ``--arch`` (or ``cfg``, e.g. a depth
    cut) and return ``losses``, ``grad_norms``, ``step_ms`` (each step,
    host clock to its loss on the host), ``step_ms_warm`` (all but the
    first), ``peak_bytes`` (CUDA: the allocator's peak over the run), the
    mesh's shape and the run's shape.  ``distribute``: place the model,
    the moments and the batches as DTensors (default: where the mesh has
    more than one rank)."""
    if cfg is None:
        cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    require_trainable(cfg, device if device is not None else "cuda")
    dev = resolve_device(device)
    with owned_group():
        mesh, dev = _mesh(args, dev)
        if distribute is None:
            distribute = mesh.size() > 1
        return _train(args, cfg, dev, mesh if distribute else None, log)


def _train(args: argparse.Namespace, cfg: ModelConfig, dev: torch.device,
           mesh, log: bool) -> dict:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt_state = init_state(model)
    if mesh is not None:
        pspecs = shd.param_specs(cfg, model, mesh)
        dst.shard_model(model, mesh, pspecs)
        opt_state = dst.shard_opt_state(
            opt_state, mesh, dst.moment_specs(model, pspecs, mesh))
    opt = AdamWConfig(total_steps=args.steps,
                      warmup_steps=max(args.steps // 10, 1))
    step_fn = make_train_step(cfg, opt, remat=args.remat)
    data = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.batch))
    losses, norms, step_ms = [], [], []
    for i, batch in zip(range(args.steps), data.batches()):
        jb = launch_batch(cfg, batch, dev)
        if mesh is not None:
            # the batch axis sharded, every other axis whole
            jb = dst.shard_batch(jb, mesh, {
                k: shd.P(shd.batch_axes(mesh), *[None] * (v.dim() - 1))
                for k, v in jb.items()})
        t0 = time.perf_counter()
        with dst.step_scope(mesh):
            model, opt_state, m = step_fn(model, opt_state, jb)
        losses.append(float(dst.full(m["loss"])))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(dst.full(m["grad_norm"])))
        if log and (i % max(args.steps // 10, 1) == 0
                    or i == args.steps - 1):
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"({step_ms[-1]:.0f} ms)", flush=True)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    return dict(arch=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype,
                device=str(dev), steps=args.steps, batch=args.batch,
                seq=args.seq, remat=args.remat,
                mesh=None if mesh is None else dict(
                    zip(mesh.mesh_dim_names, mesh.shape)),
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
