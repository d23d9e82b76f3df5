"""The train step and decode on a device mesh, on the CPU.

- On a one-rank gloo mesh (``launch.mesh.make_host_mesh``), the DTensor
  step of reduced qwen1.5-0.5b and mamba2-2.7b (2 layers, float32) equals
  the plain step bit for bit: gradients, losses, grad norms, updated
  weights and the checkpoint file.  It is the CPU form of
  ``chip_smoke.py``'s ``mesh_train`` gate.
- On a real 2 × 2 gloo mesh (4 processes joined over a ``FileStore``),
  with the reference dry run's layout hints on, two float32 steps of
  reduced qwen1.5-0.5b on the reference's weights (through
  ``convert.model_params_from_jax``) give one device's losses within 1e-5
  relative and its updated weights within ``tests/test_torch_train_step.
  py``'s tolerances (1e-6 where |g| >= 1e-5, 2 lr elsewhere), and one
  decode step over the sequence-sharded cache (batch over "data", cache
  positions over "model") gives one device's logits within 2e-5: each
  rank attends its own slice of the keys and the ranks merge their
  partials.  The workers also pin DTensor's chunk order for a dimension
  over ("data", "model"): rank (d, m) holds chunk 2·d + m.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as ref_config
from repro.configs import reduced as ref_reduced
from repro.models import transformer as ref_tfm
from repro_torch.configs import get_config, reduced
from repro_torch.convert import model_params_from_jax
from repro_torch.launch import distribute as dst
from repro_torch.launch import mesh as meshes
from repro_torch.launch import sharding as shd
from repro_torch.models import transformer as tfm
from repro_torch.train import checkpoint, loop
from repro_torch.train.optimizer import AdamWConfig, init_state

ROOT = Path(__file__).resolve().parents[1]
OPT = AdamWConfig(total_steps=4, warmup_steps=1)


@pytest.fixture(autouse=True)
def _no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _cfg(arch):
    return dataclasses.replace(reduced(get_config(arch)), dtype="float32")


def _batch(cfg, b=2, s=32, seed=1):
    rng = np.random.default_rng(seed)
    return {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                               dtype=torch.int64)
            for k in ("tokens", "labels")}


def _grads(cfg, model, batch):
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    loss, _ = loop.loss_fn(cfg, model, batch)
    return loss, dict(zip(params, torch.autograd.grad(loss,
                                                      list(params.values()))))


# ---------------------------------------------------------------------------
# one rank: bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-2.7b"])
def test_one_rank_mesh_step_is_bitwise_the_plain_step(arch, tmp_path):
    cfg = _cfg(arch)
    batch = _batch(cfg)

    def fresh():
        return tfm.init_params(cfg, torch.Generator().manual_seed(0))

    plain = fresh()
    loss0, g0 = _grads(cfg, plain, batch)
    state0 = init_state(plain)
    step = loop.make_train_step(cfg, OPT)
    plain_m = []
    for _ in range(2):
        plain, state0, m = step(plain, state0, batch)
        plain_m.append((float(m["loss"]), float(m["grad_norm"])))
    checkpoint.save(str(tmp_path / "plain.npz"), plain, state0)

    with meshes.owned_group():
        mesh = meshes.make_host_mesh(device_type="cpu")
        model = fresh()
        pspecs = shd.param_specs(cfg, model, mesh)
        dst.shard_model(model, mesh, pspecs)
        assert all(dst.is_dtensor(p) for p in model.parameters())
        bspec = shd.P(shd.batch_axes(mesh), None)
        db = dst.shard_batch(batch, mesh, {k: bspec for k in batch})
        with dst.step_scope(mesh):
            loss1, g1 = _grads(cfg, model, db)
        assert torch.equal(dst.full(loss1), loss0)
        for n, g in g0.items():
            assert torch.equal(dst.full(g1[n]), g), n
        state1 = dst.shard_opt_state(init_state(model), mesh,
                                     dst.moment_specs(model, pspecs, mesh))
        mesh_m = []
        for _ in range(2):
            with dst.step_scope(mesh):
                model, state1, m = step(model, state1, db)
            mesh_m.append((float(dst.full(m["loss"])),
                           float(dst.full(m["grad_norm"]))))
        assert mesh_m == plain_m
        for (n, a), (_, b) in zip(plain.named_parameters(),
                                  model.named_parameters()):
            assert torch.equal(a, dst.full(b)), n
        checkpoint.save(str(tmp_path / "mesh.npz"), model, state1)
    with np.load(tmp_path / "plain.npz") as a, \
            np.load(tmp_path / "mesh.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k


def test_launch_train_distributes_on_request_with_the_same_bits():
    from repro_torch.launch import train as launch_train

    args = launch_train.parse_args(["--reduced", "--steps", "2", "--batch",
                                    "2", "--seq", "32"])
    plain = launch_train.run(args, device="cpu", log=False)
    mesh = launch_train.run(args, device="cpu", log=False, distribute=True)
    assert plain["mesh"] is None and mesh["mesh"] == {"data": 1, "model": 1}
    assert mesh["losses"] == plain["losses"]
    assert mesh["grad_norms"] == plain["grad_norms"]


# ---------------------------------------------------------------------------
# a real 2 x 2 mesh of four gloo processes
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent("""
    import dataclasses, os, sys
    import torch, torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import distribute as dst, sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.train import loop
    from repro_torch.train.optimizer import AdamWConfig, init_state

    rank, out = int(sys.argv[1]), sys.argv[2]
    os.environ["REPRO_SHARD_HEADS_AXIS"] = "model"
    os.environ["REPRO_SHARD_SEQ_AXIS"] = "model"
    dist.init_process_group("gloo", store=dist.FileStore(out + "/store", 4),
                            rank=rank, world_size=4)
    mesh = make_host_mesh(2, device_type="cpu")
    coord = tuple(mesh.get_coordinate())
    # the chunk order of a dimension over ("data", "model")
    seq = dst.distribute(torch.arange(8.0), mesh, shd.P(("data", "model")))
    assert seq.placements == (Shard(0), Shard(0))
    want = 2 * coord[0] + coord[1]
    assert seq.to_local().tolist() == [2.0 * want, 2.0 * want + 1], coord

    cfg = dataclasses.replace(reduced(get_config("qwen1.5-0.5b")),
                              dtype="float32")
    inp = torch.load(out + "/inputs.pt")

    def model():
        m = tfm.init_params(cfg, torch.Generator().manual_seed(5))
        m.load_state_dict(inp["weights"])
        return m

    net = model()
    pspecs = shd.param_specs(cfg, net, mesh)
    dst.shard_model(net, mesh, pspecs)
    state = dst.shard_opt_state(init_state(net), mesh,
                                dst.moment_specs(net, pspecs, mesh))
    bspec = shd.P(shd.batch_axes(mesh), None)
    step = loop.make_train_step(cfg, AdamWConfig(total_steps=4,
                                                 warmup_steps=1))
    losses = []
    for batch in inp["batches"]:
        db = dst.shard_batch(batch, mesh, {k: bspec for k in batch})
        with dst.step_scope(mesh):
            net, state, m = step(net, state, db)
        losses.append(float(dst.full(m["loss"])))
    weights = {n: dst.full(p).detach() for n, p in net.named_parameters()}

    # decode over the sequence-sharded cache
    net = model()
    with torch.no_grad():
        _, cache = tfm.prefill(cfg, net, {"tokens": inp["prompt"]},
                               inp["cache_len"])
    dst.shard_model(net, mesh, shd.param_specs(cfg, net, mesh))
    cspecs = shd.cache_specs(cfg, cache, mesh)
    assert cspecs[0]["k"] == shd.P("data", "model", None, None)
    cache = dst.shard_cache(cache, mesh, cspecs)
    tok = dst.distribute(inp["next"], mesh, shd.P("data", None))
    lens = dst.distribute(inp["lengths"], mesh, shd.P("data"))
    with torch.no_grad(), dst.step_scope(mesh):
        logits, _ = tfm.decode_step(cfg, net, tok, cache, lens)
    logits = dst.full(logits)
    if rank == 0:
        torch.save({"losses": losses, "weights": weights,
                    "logits": logits}, out + "/result.pt")
    dist.barrier()
    dist.destroy_process_group()
""")


def _spawn(out: Path, timeout: float = 120.0):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r),
                               str(out)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    end = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > end:
                raise TimeoutError(f"the 2 x 2 workers ran past {timeout} s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [p.stdout.read() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]


def test_two_by_two_gloo_mesh_matches_one_device(tmp_path):
    cfg = dataclasses.replace(ref_reduced(ref_config("qwen1.5-0.5b")),
                              dtype="float32")
    pcfg = _cfg("qwen1.5-0.5b")
    params = ref_tfm.init_params(cfg, jax.random.PRNGKey(3))
    model = model_params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    weights = {n: p.detach().clone() for n, p in model.named_parameters()}
    batches = [_batch(pcfg, b=4, s=32, seed=s) for s in (11, 12)]
    rng = np.random.default_rng(13)
    prompt = torch.as_tensor(rng.integers(0, pcfg.vocab_size, (4, 16)))
    nxt = torch.as_tensor(rng.integers(0, pcfg.vocab_size, (4, 1)))
    lengths = torch.tensor([16, 9, 16, 3], dtype=torch.int32)
    torch.save({"weights": weights, "batches": batches, "prompt": prompt,
                "next": nxt, "lengths": lengths, "cache_len": 32},
               tmp_path / "inputs.pt")
    _spawn(tmp_path)
    got = torch.load(tmp_path / "result.pt")

    # one device, the same weights and batches
    step = loop.make_train_step(pcfg, OPT)
    state = init_state(model)
    losses, first_grads = [], None
    for batch in batches:
        if first_grads is None:
            _, first_grads = _grads(pcfg, model, batch)
        model, state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    held = total = 0
    for n, p in model.named_parameters():
        diff = (got["weights"][n] - p.detach()).abs()
        firm = first_grads[n].abs() >= 1e-5
        held, total = held + int(firm.sum()), total + firm.numel()
        if firm.any():
            assert float(diff[firm].max()) <= 1e-6, n
        assert float(diff.max()) <= 2 * OPT.lr, n
    assert held > total / 2

    plain = tfm.init_params(pcfg, torch.Generator().manual_seed(5))
    plain.load_state_dict(weights)
    with torch.no_grad():
        _, cache = tfm.prefill(pcfg, plain, {"tokens": prompt}, 32)
        want, _ = tfm.decode_step(pcfg, plain, nxt, cache, lengths)
    np.testing.assert_allclose(got["logits"].numpy(), want.numpy(),
                               atol=2e-5, rtol=0)
