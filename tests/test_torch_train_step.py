"""The port's train step, remat, checkpoints, driver and launcher
against the reference's ``repro.train`` on the CPU (the optimizer, the
corpus and the loss are ``tests/test_torch_train.py``'s, whose helpers
this file shares).

Held: one train step's parameters against the reference's;
microbatching, remat and ``REPRO_REMAT_GROUP`` against the plain step;
whisper's encoder under remat; checkpoints bitwise in float32 and bf16;
``train``'s loss falling; ``launch.train`` on the CPU; the SSM and
hybrid families admitted on CUDA (A10b), the reference's zero VLM patch
rows overflowing the gradient at depth in both packages (C-R5), the A11
refusals, and the card's entry points refusing a machine without one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.train.loop as ref_loop
from repro.train import optimizer as ref_opt
from repro_torch.configs import get_config as pt_get_config
from repro_torch.configs import reduced as pt_reduced
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as pt_attention
from repro_torch.models import transformer as tfm
from repro_torch.train import checkpoint, loop
from repro_torch.train import optimizer as opt
from test_torch_train import _batches, _grads, _named, _port, _rig


def test_one_train_step_matches_the_reference():
    cfg, params, pcfg, model = _rig("qwen1.5-0.5b")
    jb, tb = _batches(cfg, b=4, s=32, seed=9)
    kw = dict(total_steps=10, warmup_steps=1)
    new, _, rm = jax.jit(ref_loop.make_train_step(
        cfg, ref_opt.AdamWConfig(**kw)))(params, ref_opt.init_state(params),
                                         jb)
    step = loop.make_train_step(pcfg, opt.AdamWConfig(**kw))
    model, state, m = step(model, opt.init_state(model), tb)
    for k in ("loss", "ce", "aux", "grad_norm"):
        assert m[k].dtype == torch.float32 and m[k].dim() == 0
        assert float(m[k]) == pytest.approx(float(rm[k]), rel=1e-4,
                                            abs=1e-7), k
    # Adam's first step moves a weight by lr · g / (|g| + eps): where |g|
    # is of the order of eps, a gradient that differs in its ninth
    # decimal moves the update by a visible fraction of lr, so the
    # update is held at 1e-6 where |g| >= 1e-5 and within 2 lr elsewhere
    want = _named(pcfg, new)
    ref_g = _named(pcfg, jax.grad(lambda p: ref_loop.loss_fn(cfg, p,
                                                             jb)[0])(params))
    held = total = 0
    for n, p in model.named_parameters():
        diff = (p.detach() - want[n]).abs()
        firm = ref_g[n].abs() >= 1e-5
        held, total = held + int(firm.sum()), total + firm.numel()
        if firm.any():
            assert float(diff[firm].max()) <= 1e-6, n
        assert float(diff.max()) <= 2 * 3e-4, n
    assert held > total / 2
    assert int(state.step) == 1


def test_microbatches_match_one_batch():
    """Four microbatches accumulate float32 gradients to the single
    step's update (the reference's tolerances)."""
    cfg, params, pcfg, _ = _rig("qwen1.5-0.5b", seed=9)
    _, tb = _batches(cfg, b=4, s=32, seed=9)
    o = opt.AdamWConfig(total_steps=10, warmup_steps=1)
    runs = []
    for k in (1, 4):
        model = _port(pcfg, params)
        model, _, m = loop.make_train_step(pcfg, o, microbatches=k)(
            model, opt.init_state(model), tb)
        runs.append((dict(model.named_parameters()), m))
    (p1, m1), (p4, m4) = runs
    assert float(m4["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    for n, p in p1.items():
        np.testing.assert_allclose(p4[n].detach().numpy(),
                                   p.detach().numpy(), rtol=5e-3, atol=5e-4,
                                   err_msg=n)
    with pytest.raises(ValueError, match="microbatches"):
        loop.make_train_step(pcfg, o, microbatches=3)(
            _port(pcfg, params), opt.init_state(model), tb)


def _counted(monkeypatch):
    calls = [0]
    inner = pt_attention.flash_attention

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    monkeypatch.setattr(pt_attention, "flash_attention", counted)
    return calls


@pytest.mark.parametrize("group", ["", "2"])
def test_remat_matches_no_remat(monkeypatch, group):
    """Remat (and its two-level grouping, through REPRO_REMAT_GROUP) gives
    the same loss and gradients.  Single-level remat runs each layer's
    attention twice (forward, recompute); with groups of two periods the
    group's recompute stops after its first period (torch's checkpoint
    recomputes only up to the last tensor it saved: the second period's
    input), and each period then recomputes itself: 4 + 2 + 4."""
    cfg, params, pcfg, model = _rig("qwen1.5-0.5b", layers=4)
    _, tb = _batches(cfg, seed=4)
    monkeypatch.setenv("REPRO_REMAT_GROUP", group)
    calls = _counted(monkeypatch)
    l1, _, g1 = _grads(pcfg, model, tb)
    plain = calls[0]
    calls[0] = 0
    l2, _, g2 = _grads(pcfg, model, tb, remat=True)
    assert plain == 4 and calls[0] == (10 if group else 8)
    assert float(l2) == pytest.approx(float(l1), rel=1e-6)
    for n, g in g1.items():
        np.testing.assert_allclose(g2[n].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=n)


def test_encoder_remat_matches(monkeypatch):
    cfg, params, pcfg, model = _rig("whisper-medium")
    _, tb = _batches(cfg, seed=6)
    calls = _counted(monkeypatch)
    l1, _, g1 = _grads(pcfg, model, tb)
    plain = calls[0]
    calls[0] = 0
    l2, _, g2 = _grads(pcfg, model, tb, remat=True)
    # encoder 2 + decoder 2 self + 2 cross, each checkpointed
    assert plain == 6 and calls[0] == 12
    assert float(l2) == pytest.approx(float(l1), rel=1e-6)
    for n, g in g1.items():
        np.testing.assert_allclose(g2[n].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=n)


# ---------------------------------------------------------------------------
# Checkpoints, the driver, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip_is_bitwise(tmp_path, dtype):
    pcfg = dataclasses.replace(pt_reduced(pt_get_config("qwen1.5-0.5b")),
                               dtype=dtype)
    model = tfm.init_params(pcfg, torch.Generator().manual_seed(1))
    _, tb = _batches(pcfg, seed=2)
    model, state, _ = loop.make_train_step(pcfg, opt.AdamWConfig())(
        model, opt.init_state(model), tb)
    path = str(tmp_path / "ckpt" / "step1.npz")
    checkpoint.save(path, model, state)
    other = tfm.init_params(pcfg, torch.Generator().manual_seed(2))
    back, bstate = checkpoint.restore(path, (other, opt.init_state(other)))
    for (n, p), (_, q) in zip(model.named_parameters(),
                              back.named_parameters()):
        assert q.dtype == p.dtype and torch.equal(q, p), n
    for name in ("mu", "nu"):
        for n, t in getattr(state, name).items():
            assert torch.equal(getattr(bstate, name)[n], t), n
    assert bstate.step.dtype == torch.int32 and int(bstate.step) == 1
    wrong = dataclasses.replace(pcfg, d_model=128, num_heads=4,
                                num_kv_heads=4)
    small = tfm.init_params(wrong, torch.Generator().manual_seed(0))
    with pytest.raises(AssertionError):
        checkpoint.restore(path, (small, opt.init_state(small)))


def test_train_lowers_the_loss():
    r = loop.train(pt_reduced(pt_get_config("qwen1.5-0.5b")), steps=40,
                   global_batch=8, seq_len=32, log_every=0, device="cpu")
    assert r.steps == 40 and len(r.losses) == 40
    assert np.isfinite(r.losses).all()
    assert r.last_loss < r.first_loss - 0.2


def test_launch_train_runs_on_the_cpu_when_asked():
    out = launch_train.run(launch_train.parse_args(
        ["--reduced", "--steps", "3", "--batch", "2", "--seq", "32",
         "--remat"]), device="cpu", log=False)
    assert out["steps"] == 3 and len(out["losses"]) == 3
    assert len(out["step_ms_warm"]) == 2 and out["peak_bytes"] is None
    assert np.isfinite(out["losses"]).all() and out["remat"]
    assert out["tokens_per_step"] == 64 and out["device"] == "cpu"


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_b5_families_refuse_the_card(arch):
    """SSM and hybrid training on the card was refused until B5 had a
    backward kernel (A10b).  Now ``require_trainable`` admits both
    families on CUDA, reduced and whole, and without a GPU the only
    refusal left is the missing device."""
    pcfg = pt_reduced(pt_get_config(arch))
    for cfg in (pcfg, pt_get_config(arch)):
        loop.require_trainable(cfg, "cuda")
        loop.require_trainable(cfg, "cpu")
    assert not hasattr(loop, "B5_FAMILIES")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="GPU"):
            loop.train(pcfg, steps=1, device="cuda")
        with pytest.raises(RuntimeError, match="GPU"):
            launch_train.run(launch_train.parse_args(
                ["--arch", arch, "--reduced", "--steps", "1"]),
                device="cuda")


@pytest.mark.parametrize("patches", ["zero", "random"])
def test_vlm_zero_patch_rows_overflow_the_gradient_in_both(patches):
    """ROADMAP C-R5, the reference's own: on all-zero patch rows at
    InternVL2's depth (24 layers) each RMSNorm multiplies those rows'
    gradient by rsqrt(1e-6) = 1,000, float32 overflows, and inf · 0 in
    the weight gradients gives NaN, in the reference's ``jax.grad`` as in
    the port; 0.02 · N(0, 1) rows, as ``_batches`` draws them, train."""
    cfg, params, pcfg, model = _rig("internvl2-1b", layers=24)
    jb, tb = _batches(cfg)
    if patches == "zero":
        jb["patch_embeds"] = jnp.zeros_like(jb["patch_embeds"])
        tb["patch_embeds"] = torch.zeros_like(tb["patch_embeds"])
    ref = jax.grad(lambda p: ref_loop.loss_fn(cfg, p, jb)[0])(params)
    ref_finite = all(bool(np.isfinite(np.asarray(x)).all())
                     for x in jax.tree.leaves(ref))
    _, _, grads = _grads(pcfg, model, tb)
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert ref_finite == finite == (patches == "random")


@pytest.mark.parametrize("flag", ["--production", "--multi-pod"])
def test_meshes_are_a11(flag):
    """A11 landed: the production meshes need a group of 256 / 512 ranks
    (under torchrun); one process is refused by the world size, and no
    process group is left behind."""
    need = 512 if flag == "--multi-pod" else 256
    with pytest.raises(ValueError, match=f"{need} ranks.*world size of 1"):
        launch_train.run(launch_train.parse_args(["--reduced", flag]),
                         device="cpu")
    assert not torch.distributed.is_initialized()


def test_launch_train_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="GPU"):
        launch_train.run(launch_train.parse_args(["--reduced",
                                                  "--steps", "1"]))
    with pytest.raises(RuntimeError, match="GPU"):
        loop.train(pt_reduced(pt_get_config("qwen1.5-0.5b")), steps=1)
