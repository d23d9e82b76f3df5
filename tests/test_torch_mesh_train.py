"""The train step and decode on a device mesh, on the CPU.

- On a one-rank gloo mesh (``launch.mesh.make_host_mesh``), the DTensor
  step of every family at reduced size (2 layers, float32: qwen1.5-0.5b,
  mamba2-2.7b, OLMoE, DeepSeek-V2-Lite's MLA, Jamba's interleave,
  whisper with its frames and InternVL2 with its patch embeddings)
  equals the plain step bit for bit: gradients, losses, grad norms,
  updated weights and the checkpoint file; and ``launch.train.
  run(distribute=True)`` equals ``run()`` bit for bit for all ten archs.
  It is the CPU form of ``chip_smoke.py``'s ``mesh_train`` gate.  These
  tests run on one thread (``one_thread``): with torch's default thread
  count the plain CPU step itself does not repeat bit for bit (reduced
  qwen1.5-0.5b's grad norm came out 3.8261823654174805 in one run and
  3.8261821269989014 in others).
- On a real 2 × 2 gloo mesh (4 processes joined over a ``FileStore``),
  with the reference dry run's layout hints on, two float32 steps of
  reduced qwen1.5-0.5b, OLMoE (capacity factor 1.0, so that tokens
  drop), DeepSeek-V2-Lite, Jamba, whisper and InternVL2 on the
  reference's weights (through ``convert.model_params_from_jax``) give
  one device's losses within 1e-5 relative and its updated weights within
  ``tests/test_torch_train_step.py``'s tolerances (1e-6 where |g| >=
  1e-5, 2 lr elsewhere), and one decode step of each over the
  sequence-sharded cache (batch over "data", cache positions over
  "model"; whisper's cross cache keeps its heads over "model") gives one
  device's logits within 2e-5: each rank attends its own slice of the
  keys (DeepSeek's latent cache through ``mla_decode_partials_plain``)
  and the ranks merge their partials.  MLA decode on a latent cache split
  over "model" is also held against ``mla_decode_attention_plain`` at
  lengths -1, 0, the last position of rank 0's slice and the first of
  rank 1's, with and without a window.  DeepSeek's and whisper's decode
  step also runs through both decode kernels' CUDA route on the mesh
  (``kernel_device`` true on the CPU tensors, the launchers stubbed by
  their plain versions, as the backward tests stub ``_launch``): each
  rank takes the partials entry over its slice, one counted launch a
  decode layer, and the merged logits match one device's within 2e-5.
  The workers also pin DTensor's chunk order for a dimension over
  ("data", "model"): rank (d, m) holds chunk 2·d + m.
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
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.convert import model_params_from_jax
from repro_torch.kernels.mla_decode import mla_decode_attention_plain
from repro_torch.launch import distribute as dst
from repro_torch.launch import mesh as meshes
from repro_torch.launch import sharding as shd
from repro_torch.models import attention
from repro_torch.models import transformer as tfm
from repro_torch.train import checkpoint, loop
from repro_torch.train.optimizer import AdamWConfig, init_state

ROOT = Path(__file__).resolve().parents[1]
OPT = AdamWConfig(total_steps=4, warmup_steps=1)
# the families of the registry beside the dense and SSM ones
FAMILIES = ["olmoe-1b-7b", "deepseek-v2-lite-16b", "jamba-v0.1-52b",
            "whisper-medium", "internvl2-1b"]
MESH_ARCHS = ["qwen1.5-0.5b"] + FAMILIES
# OLMoE on the 2 x 2 mesh: a capacity factor at which tokens drop there
MOE_CAPACITY = 1.0


@pytest.fixture(autouse=True)
def _no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


@pytest.fixture
def one_thread():
    """One CPU thread for a bitwise comparison, the previous count
    restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(arch):
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    if arch == "olmoe-1b-7b":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_CAPACITY))
    return cfg


def _batch(cfg, b=2, s=32, seed=1):
    """Tokens and labels, and a VLM's patch embeddings (0.02 · N(0, 1))
    or whisper's frames (N(0, 1)), from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                              dtype=torch.int64)
           for k in ("tokens", "labels")}
    if cfg.family in ("vlm", "audio"):
        rows = rng.standard_normal((b, cfg.encoder.n_ctx, cfg.d_model))
        key = "patch_embeds" if cfg.family == "vlm" else "frames"
        out[key] = torch.as_tensor(
            (0.02 * rows if cfg.family == "vlm" else rows).astype(np.float32))
    return out


def _bspecs(batch, mesh):
    """Each batch tensor's batch axis over the mesh's batch axes."""
    return {k: shd.P(shd.batch_axes(mesh), *[None] * (v.dim() - 1))
            for k, v in batch.items()}


def _grads(cfg, model, batch):
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    loss, _ = loop.loss_fn(cfg, model, batch)
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss, {n: torch.zeros_like(p) if g is None else g
                  for (n, p), g in zip(params.items(), got)}


# ---------------------------------------------------------------------------
# one rank: bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-2.7b"] + FAMILIES)
def test_one_rank_mesh_step_is_bitwise_the_plain_step(arch, tmp_path,
                                                      one_thread):
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
        db = dst.shard_batch(batch, mesh, _bspecs(batch, mesh))
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


def _launch_same_bits(argv):
    from repro_torch.launch import train as launch_train

    args = launch_train.parse_args(argv + ["--reduced", "--steps", "2",
                                           "--batch", "2", "--seq", "32"])
    plain = launch_train.run(args, device="cpu", log=False)
    mesh = launch_train.run(args, device="cpu", log=False, distribute=True)
    assert plain["mesh"] is None and mesh["mesh"] == {"data": 1, "model": 1}
    assert mesh["losses"] == plain["losses"]
    assert mesh["grad_norms"] == plain["grad_norms"]


def test_launch_train_distributes_on_request_with_the_same_bits(one_thread):
    _launch_same_bits([])


@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if a != "qwen1.5-0.5b"])
def test_launch_train_distributes_every_arch_with_the_same_bits(arch,
                                                                one_thread):
    _launch_same_bits(["--arch", arch])


# ---------------------------------------------------------------------------
# a real 2 x 2 mesh of four gloo processes
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent("""
    import dataclasses, os, sys
    import torch, torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.mla_decode import mla_decode_attention
    from repro_torch.launch import distribute as dst, sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention, transformer as tfm
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

    from repro_torch.kernels import decode_attention as da, mla_decode as md

    # one decode step through both decode kernels' CUDA route:
    # kernel_device true on these CPU tensors, each launcher stubbed by
    # its plain version; returns the logits and the launches
    def cuda_route(cfg, net, tok, cache, lens):
        def launch(q, k, v, lengths, out, window, scales=None,
                   partials=None):
            out.copy_(da._attend_plain(q, k, v, lengths, window,
                                       *(scales or ())))

        def partials(q, k, v, lengths, parts, window, scales=None):
            return da._partials_plain(q, k, v, lengths, window,
                                      *(scales or ()))

        def mla_launch(qa, qp, c, kp, lens, out, scale, window,
                       stats=None):
            out.copy_(md.mla_decode_attention_plain(
                qa, qp, c, kp, lens, scale=scale, window=window))

        def mla_partials(qa, qp, c, kp, lens, parts, scale, window):
            return md.mla_decode_partials_plain(qa, qp, c, kp, lens,
                                                scale=scale, window=window)

        stubs = {da: dict(kernel_device=lambda t, name: True, _launch=launch,
                          _launch_partials=partials),
                 md: dict(kernel_device=lambda t, name: True,
                          _launch=mla_launch,
                          _launch_partials=mla_partials)}
        saved = {mod: {k: getattr(mod, k) for k in kw}
                 for mod, kw in stubs.items()}
        n0 = (da.decode_attention.launches,
              md.mla_decode_attention.launches)
        for mod, kw in stubs.items():
            for k, f in kw.items():
                setattr(mod, k, f)
        try:
            with torch.no_grad(), dst.step_scope(mesh):
                logits, _ = tfm.decode_step(cfg, net, tok, cache, lens)
        finally:
            for mod, kw in saved.items():
                for k, f in kw.items():
                    setattr(mod, k, f)
        return {"logits": dst.full(logits),
                "launches": (da.decode_attention.launches - n0[0],
                             md.mla_decode_attention.launches - n0[1])}

    inp = torch.load(out + "/inputs.pt")
    results = {}
    for arch, job in inp["jobs"].items():
        cfg = dataclasses.replace(reduced(get_config(arch)),
                                  dtype="float32")
        if "capacity" in job:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=job["capacity"]))

        def model():
            m = tfm.init_params(cfg, torch.Generator().manual_seed(5))
            m.load_state_dict(job["weights"])
            return m

        net = model()
        pspecs = shd.param_specs(cfg, net, mesh)
        dst.shard_model(net, mesh, pspecs)
        state = dst.shard_opt_state(init_state(net), mesh,
                                    dst.moment_specs(net, pspecs, mesh))
        step = loop.make_train_step(cfg, AdamWConfig(total_steps=4,
                                                     warmup_steps=1))
        losses = []
        for batch in job["batches"]:
            db = dst.shard_batch(batch, mesh, {
                k: shd.P(shd.batch_axes(mesh), *[None] * (v.dim() - 1))
                for k, v in batch.items()})
            with dst.step_scope(mesh):
                net, state, m = step(net, state, db)
            losses.append(float(dst.full(m["loss"])))
        weights = {n: dst.full(p).detach()
                   for n, p in net.named_parameters()}

        # decode over the sequence-sharded cache
        net = model()
        with torch.no_grad():
            _, cache = tfm.prefill(cfg, net, job["prompt"], job["cache_len"])
        dst.shard_model(net, mesh, shd.param_specs(cfg, net, mesh))
        cspecs = shd.cache_specs(cfg, cache, mesh)
        cache = dst.shard_cache(cache, mesh, cspecs)
        tok = dst.distribute(job["next"], mesh, shd.P("data", None))
        lens = dst.distribute(job["lengths"], mesh, shd.P("data"))
        with torch.no_grad(), dst.step_scope(mesh):
            logits, _ = tfm.decode_step(cfg, net, tok, cache, lens)
        results[arch] = {"losses": losses, "weights": weights,
                         "logits": dst.full(logits),
                         "cache_specs": [{k: tuple(v) for k, v in c.items()}
                                         for c in cspecs]}
        if arch in ("deepseek-v2-lite-16b", "whisper-medium"):
            results[arch]["cuda_route"] = cuda_route(cfg, net, tok, cache,
                                                     lens)

    # MLA decode over a latent cache whose positions are split over "model"
    mla = inp["mla"]
    cspec = shd.P("data", "model", None)
    args = [dst.distribute(mla["q_abs"], mesh, cspec),
            dst.distribute(mla["q_pe"], mesh, cspec),
            dst.distribute(mla["c_kv"], mesh, cspec),
            dst.distribute(mla["k_pe"], mesh, cspec)]
    assert args[2].placements == (Shard(0), Shard(1))
    merged = []
    for lengths, window in mla["cases"]:
        lens = dst.distribute(lengths, mesh, shd.P("data"))
        with torch.no_grad(), dst.step_scope(mesh):
            got = mla_decode_attention(*args, lens, scale=mla["scale"],
                                       window=window)
        merged.append(dst.full(got))
    results["mla"] = merged

    # the output projection over a wo whose head width is split over
    # "model" (3 heads do not divide it), forward and backward
    proj = inp["out_proj"]
    heads = dst.distribute(proj["out"], mesh,
                           shd.P("data", None, None, None))
    wo = dst.distribute(proj["wo"], mesh, shd.P(None, "model", None))
    assert wo.placements == (Replicate(), Shard(1))
    heads.requires_grad_(True)
    wo.requires_grad_(True)
    with dst.step_scope(mesh):
        y = attention._out_proj(heads, wo)
        (y * proj["r"]).sum().backward()
    results["out_proj"] = {"y": dst.full(y).detach(),
                           "out": dst.full(heads.grad),
                           "wo": dst.full(wo.grad)}
    if rank == 0:
        torch.save(results, out + "/result.pt")
    dist.barrier()
    dist.destroy_process_group()
""")


def _spawn(out: Path, timeout: float = 300.0):
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


def _ref_model(arch):
    """The port's model on the reference's weights (``PRNGKey(3)``)."""
    cfg = dataclasses.replace(ref_reduced(ref_config(arch)), dtype="float32")
    pcfg = _cfg(arch)
    if pcfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=pcfg.moe.capacity_factor))
    params = ref_tfm.init_params(cfg, jax.random.PRNGKey(3))
    return pcfg, model_params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                       device="cpu")


def _job(arch):
    """One family's inputs for the workers: the reference's weights, two
    4 x 32 batches, and a prompt (with its frames or patch embeddings),
    the next tokens and ragged lengths for one decode step over a
    64-position cache."""
    pcfg, model = _ref_model(arch)
    batches = [_batch(pcfg, b=4, s=32, seed=s) for s in (11, 12)]
    prompt = _batch(pcfg, b=4, s=16, seed=13)
    del prompt["labels"]
    rng = np.random.default_rng(14)
    nxt = torch.as_tensor(rng.integers(0, pcfg.vocab_size, (4, 1)))
    # a VLM's cache holds its patch rows in front of the prompt
    fill = 16 + (pcfg.encoder.n_ctx if pcfg.family == "vlm" else 0)
    job = {"weights": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
           "batches": batches, "prompt": prompt, "next": nxt,
           "lengths": torch.tensor([fill, fill - 7, fill, 3],
                                   dtype=torch.int32), "cache_len": 64}
    if pcfg.moe is not None and arch == "olmoe-1b-7b":
        job["capacity"] = pcfg.moe.capacity_factor
    return job


# MLA decode over a split latent cache: B 4, 8 heads, rank 64, rope 16,
# 32 positions (16 a "model" rank); (lengths, window) cases: no admitted
# position, position 0 only, the last position of rank 0's slice, the
# first of rank 1's, and a window across the boundary
MLA_CASES = [([-1, 0, 15, 16], 0), ([31, 16, 20, 7], 8), ([15, 16, -1, 0], 4)]


def _mla_inputs():
    rng = np.random.default_rng(21)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32))

    return {"q_abs": t(4, 8, 64), "q_pe": t(4, 8, 16), "c_kv": t(4, 32, 64),
            "k_pe": t(4, 32, 16), "scale": 48 ** -0.5,
            "cases": [(torch.tensor(lens, dtype=torch.int32), w)
                      for lens, w in MLA_CASES]}


def _out_proj_inputs():
    """``_out_proj``'s operands with 3 heads of width 8, which the 2 x 2
    mesh splits over "model" by width: out (4, 5, 3, 8), wo (3, 8, 6),
    and the weights of the summed product."""
    rng = np.random.default_rng(22)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32))

    return {"out": t(4, 5, 3, 8), "wo": t(3, 8, 6), "r": t(4, 5, 6)}


@pytest.fixture(scope="module")
def two_by_two(tmp_path_factory):
    """Every family of ``MESH_ARCHS``, the MLA cases and the output
    projection over head widths through the same four gloo workers;
    returns (inputs, results)."""
    out = tmp_path_factory.mktemp("two_by_two")
    inp = {"jobs": {arch: _job(arch) for arch in MESH_ARCHS},
           "mla": _mla_inputs(), "out_proj": _out_proj_inputs()}
    torch.save(inp, out / "inputs.pt")
    _spawn(out)
    return inp, torch.load(out / "result.pt")


def _matches_one_device(arch, job, got):
    pcfg = _cfg(arch)
    model = tfm.init_params(pcfg, torch.Generator().manual_seed(5))
    model.load_state_dict(job["weights"])
    step = loop.make_train_step(pcfg, OPT)
    state = init_state(model)
    losses, first_grads = [], None
    for batch in job["batches"]:
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

    np.testing.assert_allclose(got["logits"].numpy(),
                               _one_device_logits(arch, job).numpy(),
                               atol=2e-5, rtol=0)


def _one_device_logits(arch, job):
    """One decode step of the job's prompt on one device, plain."""
    pcfg = _cfg(arch)
    plain = tfm.init_params(pcfg, torch.Generator().manual_seed(5))
    plain.load_state_dict(job["weights"])
    with torch.no_grad():
        _, cache = tfm.prefill(pcfg, plain, job["prompt"], job["cache_len"])
        want, _ = tfm.decode_step(pcfg, plain, job["next"], cache,
                                  job["lengths"])
    return want


def test_two_by_two_gloo_mesh_matches_one_device(two_by_two):
    inp, got = two_by_two
    assert got["qwen1.5-0.5b"]["cache_specs"][0]["k"] == \
        ("data", "model", None, None)
    _matches_one_device("qwen1.5-0.5b", inp["jobs"]["qwen1.5-0.5b"],
                        got["qwen1.5-0.5b"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_two_by_two_gloo_mesh_matches_one_device_every_family(two_by_two,
                                                              arch):
    inp, got = two_by_two
    specs = got[arch]["cache_specs"]
    if arch == "deepseek-v2-lite-16b":
        assert specs[0]["c_kv"] == ("data", "model", None)
    if arch == "whisper-medium":
        assert specs[0]["cross_k"] == ("data", None, "model", None)
    _matches_one_device(arch, inp["jobs"][arch], got[arch])


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "whisper-medium"])
def test_two_by_two_decode_kernels_cuda_route(two_by_two, arch):
    """The decode kernels' CUDA route on a sequence-split cache: each rank
    launches the partials entry over its slice (one launch a decode
    layer: DeepSeek's latent decode; whisper's self-attention B4, beside
    its cross cache's one-pass B4 over the heads it holds) and the ranks'
    merge gives one device's logits within 2e-5."""
    inp, got = two_by_two
    route = got[arch]["cuda_route"]
    layers = _cfg(arch).num_layers
    assert route["launches"] == ((0, layers) if arch.startswith("deepseek")
                                 else (2 * layers, 0))
    np.testing.assert_allclose(
        route["logits"].numpy(),
        _one_device_logits(arch, inp["jobs"][arch]).numpy(), atol=2e-5,
        rtol=0)


def test_two_by_two_moe_groups_drop_tokens():
    """OLMoE's 2 x 2 case drops tokens on one device: the mesh's groups
    are the reference's only if the same tokens drop there."""
    from repro_torch.models import moe

    pcfg, model = _ref_model("olmoe-1b-7b")
    dropped = []
    route = moe._route

    def counted(logits, cfg, capacity):
        got = route(logits, cfg, capacity)
        dropped.append(int((~got[2]).sum()))
        return got

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "_route", counted)
        with torch.no_grad():
            tfm.forward(pcfg, model, _batch(pcfg, b=4, s=32, seed=11))
    assert sum(dropped) > 0, dropped


@pytest.mark.parametrize("case", range(len(MLA_CASES)))
def test_two_by_two_mla_decode_merges_the_ranks_partials(two_by_two, case):
    inp, got = two_by_two
    mla = inp["mla"]
    lengths, window = mla["cases"][case]
    want = mla_decode_attention_plain(
        mla["q_abs"], mla["q_pe"], mla["c_kv"], mla["k_pe"], lengths,
        scale=mla["scale"], window=window)
    np.testing.assert_allclose(got["mla"][case].numpy(), want.numpy(),
                               atol=2e-5, rtol=0)
    if case == 0:
        # no admitted position gives 0 on the mesh as in the plain version
        assert torch.equal(got["mla"][case][0], torch.zeros_like(want[0]))


def test_two_by_two_out_proj_over_head_widths(two_by_two):
    """A wo whose heads do not divide "model" is split by head width
    (InternVL2's 14 heads over 16): each rank contracts its own widths
    into a sum across ranks; the product and both gradients match one
    device's."""
    inp, got = two_by_two
    proj = inp["out_proj"]
    out = proj["out"].clone().requires_grad_(True)
    wo = proj["wo"].clone().requires_grad_(True)
    y = attention._out_proj(out, wo)
    (y * proj["r"]).sum().backward()
    for name, want in (("y", y.detach()), ("out", out.grad),
                       ("wo", wo.grad)):
        np.testing.assert_allclose(got["out_proj"][name].numpy(),
                                   want.numpy(), atol=1e-5, rtol=0)
