#!/usr/bin/env python3
"""The port's dispatch over several GPUs and its decode kernels' partials
entries on a real device mesh, on a host with four GPUs.

    python3 tools/check_torch_multi_gpu.py [--only dispatch|mesh_decode]

1. dispatch — ``sweep`` on examples/sweep_grid.py's 8,160-point grid
   (``chip_smoke.build_grid``, n_batches 3,000, q_cap 768),
   ``fleet_sweep`` on the replicas benchmark's 8,448 points
   (``chip_smoke.replicas_grid``, n_steps 4,000, a_cap 32, hist_every
   4), ``gen_sweep`` on benchmarks/continuous.py's grid tiled 16×
   (``chip_smoke.gen_grid``, 8,192 points, n_steps 2,048) and
   ``campaign`` over the first 16 chunks of 8,192 of
   benchmarks/campaign.py's grid (``chip_smoke.million_grid``, n_batches
   32), each with ``shard=1`` (one GPU) and ``shard=True`` (every
   visible GPU: this process runs cuda:0's slice, a worker process each
   further GPU's): bitwise equal, every B1 (and B2) launch counted, the
   workers' included; the warm wall of each (the second of two calls,
   synchronised on every GPU), and the devices the entry's default
   ``shard=None`` takes.
2. mesh decode — DeepSeek-V2-Lite's first 3 layers and whisper-medium
   whole, float32, on a (2, 2) NCCL mesh of four processes, one a GPU,
   with the layout hints on: a prefill on each rank's GPU, the model and
   its cache placed by ``launch.sharding`` (the cache's sequence over
   "model"), one decode step.  Each rank's decode kernels take their
   partials entry over its half of the cache (one launch a decode layer
   a rank; whisper's cross cache, split over heads, the one-pass B4),
   and the merged logits are held within 2e-5 of the plain prefill +
   decode on one GPU.

Prints one JSON line a check, then the card's name and power limit.
Needs at least two CUDA devices and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import json
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import fleet_sweep, gen_sweep, sweep  # noqa: E402
from repro_torch.core.campaign import campaign  # noqa: E402
from repro_torch.kernels import superstep as ss  # noqa: E402

TOL = 2e-5
# the mesh decode's batch (2 rows a "data" rank), prompt and cache; the
# lengths put rows wholly before the second "model" rank's half
B, PROMPT, CACHE = 4, 64, 128
LENGTHS = [64, 41, 64, 3]

WORKER = r"""
import dataclasses, os, sys
rank, root, out, port = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                         sys.argv[4])
sys.path.insert(0, root + "/src")
os.environ["REPRO_SHARD_HEADS_AXIS"] = "model"
os.environ["REPRO_SHARD_SEQ_AXIS"] = "model"
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as da, mla_decode as md
from repro_torch.launch import distribute as dst
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.cuda.set_device(rank)
dev = torch.device("cuda", rank)
dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4, device_id=dev)
mesh = make_host_mesh(2, device_type="cuda")
res = {}
for name, job in torch.load(out + "/inputs.pt").items():
    cfg = dataclasses.replace(get_config(job["arch"]), dtype="float32")
    if job["layers"]:
        cfg = dataclasses.replace(cfg, num_layers=job["layers"])
    model = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0))
    batch = {k: v.to(dev) for k, v in job["batch"].items()}
    with torch.no_grad():
        _, cache = transformer.prefill(cfg, model, batch, job["cache_len"])
    dst.shard_model(model, mesh, shd.param_specs(cfg, model, mesh))
    specs = shd.cache_specs(cfg, cache, mesh)
    cache = dst.shard_cache(cache, mesh, specs)
    tok = dst.distribute(job["tok"].to(dev), mesh, shd.P("data", None))
    lens = dst.distribute(job["lengths"].to(dev), mesh, shd.P("data"))
    calls, saved = [0, 0], [da._launch_partials, md._launch_partials]

    def counter(j):
        def counted(*a, **k):
            calls[j] += 1
            return saved[j](*a, **k)
        return counted

    da._launch_partials, md._launch_partials = counter(0), counter(1)
    n0 = (da.decode_attention.launches, md.mla_decode_attention.launches)
    with torch.no_grad(), dst.step_scope(mesh):
        logits, _ = transformer.decode_step(cfg, model, tok, cache, lens)
    full = dst.full(logits).float().cpu()
    da._launch_partials, md._launch_partials = saved
    res[name] = {"logits": full,
                 "launches": (da.decode_attention.launches - n0[0],
                              md.mla_decode_attention.launches - n0[1]),
                 "partials": tuple(calls),
                 "cache_specs": [{k: tuple(v) for k, v in c.items()}
                                 for c in specs][0]}
    del model, cache
    torch.cuda.empty_cache()
torch.save(res, out + f"/result{rank}.pt")
dist.barrier()
dist.destroy_process_group()
"""


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def launches() -> dict:
    return {"hist_update": ss.hist_update.launches,
            "fifo_compact": ss.fifo_compact.launches}


def timed(run) -> tuple:
    """The second of two calls of ``run``: its result, its wall seconds
    and its launches."""
    run()
    sync_all()
    ss.hist_update.launches = ss.fifo_compact.launches = 0
    t0 = time.perf_counter()
    out = run()
    sync_all()
    return out, time.perf_counter() - t0, launches()


def check_dispatch(dev) -> list:
    n_dev = torch.cuda.device_count()
    grid = cs.build_grid(8192)
    ggrid = cs.gen_grid()
    cgrid = cs.million_grid().take(np.arange(16 * 8192))
    fgrid, _ = cs.replicas_grid(16)
    # the devices each entry's default (shard=None) takes
    default = {"sweep": n_dev, "fleet_sweep": 1, "gen_sweep": 1,
               "campaign": 1}
    entries = (
        ("sweep", lambda shard: sweep(grid, n_batches=3000, q_cap=768,
                                      seed=0, shard=shard, device=dev)),
        ("fleet_sweep", lambda shard: fleet_sweep(
            fgrid, n_steps=4000, a_cap=32, hist_every=4, seed=17,
            shard=shard, device=dev)),
        ("gen_sweep", lambda shard: gen_sweep(ggrid, n_steps=2048, seed=5,
                                              shard=shard, device=dev)),
        ("campaign", lambda shard: campaign(cgrid, chunk_size=8192,
                                            n_batches=32, seed=11,
                                            shard=shard, device=dev)))
    out = []
    for name, run in entries:
        one, one_s, one_n = timed(lambda: run(1))
        many, many_s, many_n = timed(lambda: run(True))
        if name == "campaign":
            same = (one.fingerprint() == many.fingerprint()
                    and one.totals == many.totals)
        else:
            same = all(np.array_equal(getattr(one, f), getattr(many, f),
                                      equal_nan=True)
                       for f in one.__dataclass_fields__
                       if isinstance(getattr(one, f), np.ndarray))
        row = dict(check="dispatch", entry=name, gpus=n_dev,
                   points=len({"campaign": cgrid, "gen_sweep": ggrid,
                               "fleet_sweep": fgrid}.get(name, grid)),
                   default_gpus=default[name],
                   bitwise=bool(same), one_gpu_s=one_s, all_gpus_s=many_s,
                   speedup=one_s / many_s, one_gpu_launches=one_n,
                   all_gpus_launches=many_n)
        # every slice launches B1 (and B2) once a superstep: n_dev times
        # the one-GPU count
        row["launches_ok"] = all(many_n[k] == n_dev * one_n[k]
                                 for k in one_n)
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_mesh_decode(dev) -> list:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jobs, cfgs = {}, {}
    for arch, layers in (("deepseek-v2-lite-16b", 3), ("whisper-medium", 0)):
        cfg = dataclasses.replace(get_config(arch), dtype="float32")
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        gen = torch.Generator(device=dev).manual_seed(3)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, PROMPT),
                                         generator=gen, device=dev)}
        if cfg.family == "audio":
            batch["frames"] = torch.randn(B, cfg.encoder.n_ctx, cfg.d_model,
                                          generator=gen, device=dev)
        tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                            device=dev)
        cfgs[cfg.name] = cfg
        jobs[cfg.name] = {"arch": arch, "layers": layers, "cache_len": CACHE,
                          "batch": {k: v.cpu() for k, v in batch.items()},
                          "tok": tok.cpu(),
                          "lengths": torch.tensor(LENGTHS,
                                                  dtype=torch.int32)}
    work = Path(tempfile.mkdtemp(prefix="multi_gpu_", dir=ROOT / "build"))
    torch.save(jobs, work / "inputs.pt")
    port = str(_free_port())
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-X", "faulthandler", "-c",
                               WORKER, str(r), str(ROOT), str(work), port],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise SystemExit(f"rank {r} exited {p.returncode}: "
                             f"{log[-4000:]}")
    seconds = time.perf_counter() - t0
    got = [torch.load(work / f"result{r}.pt") for r in range(4)]
    out = []
    for name, job in jobs.items():
        cfg = cfgs[name]
        model = transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0))
        with torch.no_grad():
            _, cache = transformer.prefill(
                cfg, model, {k: v.to(dev) for k, v in job["batch"].items()},
                CACHE)
            want, _ = transformer.decode_step(
                cfg, model, job["tok"].to(dev), cache,
                job["lengths"].to(dev))
        want = want.float().cpu()
        n_dec = cfg.layer_kinds().count("attn")
        mla = cfg.mla is not None
        row = dict(check="mesh_decode", arch=cfg.name,
                   layers=cfg.num_layers, dtype=cfg.dtype,
                   mesh={"data": 2, "model": 2}, backend="nccl",
                   cache_specs=got[0][name]["cache_specs"],
                   lengths=LENGTHS, cache_len=CACHE,
                   max_abs_err=max(float((g[name]["logits"] - want).abs()
                                         .max()) for g in got),
                   max_abs_logit=float(want.abs().max()), tolerance=TOL,
                   launches_per_rank=[g[name]["launches"] for g in got],
                   partials_launches_per_rank=[g[name]["partials"]
                                               for g in got],
                   want_partials=(0, n_dec) if mla else (n_dec, 0),
                   workers_s=seconds)
        row["ok"] = (row["max_abs_err"] <= TOL and all(
            tuple(p) == row["want_partials"]
            for p in row["partials_launches_per_rank"]))
        print(json.dumps(row), flush=True)
        out.append(row)
        del model, cache
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if torch.cuda.device_count() < 2:
        print("check_torch_multi_gpu: needs at least two CUDA devices",
              file=sys.stderr)
        return 1
    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv \
        else None
    dev = torch.device("cuda", 0)
    smi = cs.phase_build()
    rows = check_dispatch(dev) if only in (None, "dispatch") else []
    if torch.cuda.device_count() >= 4 and only in (None, "mesh_decode"):
        rows += check_mesh_decode(dev)
    print(smi, flush=True)
    ok = all(r.get("bitwise", True) and r.get("launches_ok", True)
             and r.get("ok", True) for r in rows)
    print(json.dumps({"ok": ok, "gpus": torch.cuda.device_count()}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
