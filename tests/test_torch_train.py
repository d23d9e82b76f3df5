"""The port's optimizer, corpus and loss (``repro_torch.train``)
against the reference's ``repro.train`` on the CPU (the train step,
remat, checkpoints and the launcher: ``tests/test_torch_train_step.py``,
which shares this file's helpers).

Weights come from the reference ``init_params`` and cross through
``convert.model_params_from_jax``; so do the reference's gradients and
updated parameters, which the conversion keys by the port's parameter
names.  Held: the schedule at every step; AdamW on shared gradients,
its clip and float32 moments, and its weight decay, which follows the
reference's stacked tree (the norms of repeated and encoder layers
decay, ``norm_f`` and a lead layer's do not); the corpus bit for bit;
the cross-entropy, chunked and plain; the loss and every gradient of
six families (reduced Jamba at 4 layers and without its experts)
against ``jax.grad`` at 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.train.loop as ref_loop
from repro.configs import get_config, reduced
from repro.models import transformer as ref_tfm
from repro.train import optimizer as ref_opt
from repro.train.data import DataConfig as RefDataConfig
from repro.train.data import SyntheticCorpus as RefCorpus
from repro_torch.configs import get_config as pt_get_config
from repro_torch.configs import reduced as pt_reduced
from repro_torch.convert import model_params_from_jax
from repro_torch.models import transformer as tfm
from repro_torch.train import loop
from repro_torch.train import optimizer as opt
from repro_torch.train.data import DataConfig, SyntheticCorpus

LOSS_ARCHS = ["qwen1.5-0.5b", "olmoe-1b-7b", "internvl2-1b",
              "whisper-medium", "mamba2-2.7b"]
# reduced Jamba, the hybrid interleave: at 4 layers (two periods, each
# with its attention layer and a MoE layer) and without its experts
HYBRID_VARIANTS = {"jamba-4-layers": dict(layers=4),
                   "jamba-no-moe": dict(moe=None)}
DECAY_ARCHS = ["qwen1.5-0.5b", "olmoe-1b-7b", "whisper-medium",
               "deepseek-v2-lite-16b"]
TOL = 1e-4


def _rig(arch, layers=None, seed=0, **replace):
    cfg, pcfg = reduced(get_config(arch)), pt_reduced(pt_get_config(arch))
    if layers:
        replace["num_layers"] = layers
    if replace:
        cfg = dataclasses.replace(cfg, **replace)
        pcfg = dataclasses.replace(pcfg, **replace)
    params = ref_tfm.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, params, pcfg, _port(pcfg, params)


def _port(pcfg, tree):
    return model_params_from_jax(pcfg, jax.tree.map(np.asarray, tree),
                                 device="cpu")


def _named(pcfg, tree):
    """A reference pytree (parameters, gradients, flags) by the port's
    parameter names."""
    return {n: p.detach() for n, p in _port(pcfg, tree).named_parameters()}


def _batches(cfg, b=2, s=32, seed=1):
    """The same batch for both packages: int32 tokens and labels, and a
    VLM's patch embeddings or whisper's frames."""
    rng = np.random.default_rng(seed)
    arrays = {k: rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
              for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        arrays["patch_embeds"] = 0.02 * rng.standard_normal(
            (b, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        arrays["frames"] = rng.standard_normal(
            (b, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
    ref = {k: jnp.asarray(v) for k, v in arrays.items()}
    port = {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in arrays.items()}
    return ref, port


def _grads(pcfg, model, batch, remat=False):
    model.requires_grad_(True)
    loss, parts = loop.loss_fn(pcfg, model, batch, remat=remat)
    names, ps = zip(*model.named_parameters())
    got = torch.autograd.grad(loss, ps, allow_unused=True)
    return loss.detach(), parts, {
        n: (g if g is not None else torch.zeros_like(p))
        for n, p, g in zip(names, ps, got)}


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max())), (
        f"{what}: max |diff| {err}")


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warm,total", [(10, 100), (0, 100), (100, 100),
                                        (1, 20)])
def test_schedule_at_every_step(warm, total):
    cfg = opt.AdamWConfig(lr=3e-4, warmup_steps=warm, total_steps=total)
    rcfg = ref_opt.AdamWConfig(lr=3e-4, warmup_steps=warm, total_steps=total)
    for step in range(total):
        got = opt.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = float(ref_opt.schedule(rcfg, jnp.asarray(step, jnp.int32)))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12), step


@pytest.mark.parametrize("arch", DECAY_ARCHS)
def test_decay_follows_the_reference_tree(arch):
    """A parameter decays exactly when its reference leaf has two axes
    or more (the stacked layers' vectors do)."""
    cfg, params, pcfg, model = _rig(arch)
    flags = _named(pcfg, jax.tree.map(
        lambda x: np.full(x.shape, x.ndim >= 2, np.float32), params))
    lead = tfm.split_pattern(pcfg)[0]
    for n, p in model.named_parameters():
        assert opt.decays(n, p, lead) == bool(flags[n].all()), n
    names = opt.decay_names(pcfg, model)
    assert "norm_f.scale" not in names
    assert f"layers.{lead}.norm1.scale" in names
    if lead:
        assert "layers.0.norm1.scale" not in names
    if pcfg.encoder is not None and pcfg.encoder.num_layers:
        assert "encoder.layers.0.norm1.scale" in names
        assert "encoder.norm.scale" not in names


@pytest.mark.parametrize("arch", DECAY_ARCHS)
def test_apply_updates_matches_the_reference(arch):
    """Two AdamW steps on the same random gradients, with a large lr and
    decay so that a wrong decay set shows, at 1e-6."""
    cfg, params, pcfg, model = _rig(arch)
    kw = dict(lr=1e-2, weight_decay=0.5, warmup_steps=1, total_steps=10)
    rcfg, pcfg_opt = ref_opt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    rng = np.random.default_rng(2)
    grads = [jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
        x.shape).astype(np.float32)), params) for _ in range(2)]
    rstate = ref_opt.init_state(params)
    pstate = opt.init_state(model)
    pparams = dict(model.named_parameters())
    decay = opt.decay_names(pcfg, model)
    ref_step = jax.jit(lambda p, g, st: ref_opt.apply_updates(rcfg, p, g,
                                                              st))
    for g in grads:
        params, rstate, rnorm = ref_step(params, g, rstate)
        pstate, pnorm = opt.apply_updates(pcfg_opt, pparams, _named(pcfg, g),
                                          pstate, decay)
        assert float(pnorm) == pytest.approx(float(rnorm), rel=1e-6)
    want = _named(pcfg, params)
    for n, p in pparams.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=n)
    for name, moments in (("mu", rstate.mu), ("nu", rstate.nu)):
        mine = getattr(pstate, name)
        for n, t in _named(pcfg, moments).items():
            assert mine[n].dtype == torch.float32
            np.testing.assert_allclose(mine[n].numpy(), t.numpy(),
                                       rtol=1e-5, atol=1e-9, err_msg=n)
    assert int(pstate.step) == int(rstate.step) == 2


def test_clip_and_float32_moments():
    kw = dict(grad_clip=1.0, weight_decay=0.1, warmup_steps=1)
    p = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    state = opt.init_state(p)
    assert state.mu["w"].dtype == state.nu["w"].dtype == torch.float32
    state, gnorm = opt.apply_updates(opt.AdamWConfig(**kw), p,
                                     {"w": torch.full((4, 4), 100.0)},
                                     state, {"w"})
    assert float(gnorm) == pytest.approx(400.0)
    rp = {"w": jnp.ones((4, 4), jnp.bfloat16)}
    rp, _, _ = ref_opt.apply_updates(ref_opt.AdamWConfig(**kw), rp,
                                     {"w": jnp.full((4, 4), 100.0)},
                                     ref_opt.init_state(rp))
    assert p["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p["w"].float().numpy(),
                                  np.asarray(rp["w"], np.float32))
    assert float((1 - p["w"].float()).abs().max()) < 2 * 3e-4
    # the clipped gradient 100 / 400, times 1 - beta1
    np.testing.assert_allclose(state.mu["w"].numpy(), 0.025, rtol=1e-6)


# ---------------------------------------------------------------------------
# Data and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_corpus_matches_the_reference_bitwise(seed):
    kw = dict(vocab_size=151, seq_len=17, global_batch=3, seed=seed)
    mine, ref = SyntheticCorpus(DataConfig(**kw)).batches(), \
        RefCorpus(RefDataConfig(**kw)).batches()
    for _ in range(3):
        a, b = next(mine), next(ref)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_cross_entropy_matches_the_reference():
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((2, 9, 50))).astype(np.float32)
    labels = rng.integers(0, 50, size=(2, 9)).astype(np.int32)
    got = loop.cross_entropy(torch.from_numpy(logits),
                             torch.from_numpy(labels).long())
    want = ref_loop.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_chunked_cross_entropy_equals_the_plain_path(monkeypatch):
    """CE_CHUNK 16 and threshold 0 force the chunked path: the same loss
    and gradients as the plain one, and as the reference's chunked
    path."""
    cfg, params, pcfg, model = _rig("qwen1.5-0.5b")
    jb, tb = _batches(cfg, b=2, s=64, seed=5)
    l_plain, _, g_plain = _grads(pcfg, model, tb)
    monkeypatch.setattr(loop, "CE_CHUNK", 16)
    monkeypatch.setattr(loop, "CE_CHUNK_THRESHOLD", 0)
    monkeypatch.setattr(ref_loop, "CE_CHUNK", 16)
    monkeypatch.setattr(ref_loop, "CE_CHUNK_THRESHOLD", 0)
    l_chunk, _, g_chunk = _grads(pcfg, model, tb)
    assert float(l_chunk) == pytest.approx(float(l_plain), rel=1e-6)
    for n, g in g_plain.items():
        np.testing.assert_allclose(g_chunk[n].numpy(), g.numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=n)
    ref_l, _ = ref_loop.loss_fn(cfg, params, jb)
    assert float(l_chunk) == pytest.approx(float(ref_l), rel=1e-5)


@pytest.mark.parametrize("arch", LOSS_ARCHS + list(HYBRID_VARIANTS))
def test_loss_and_every_gradient_match_jax_grad(arch):
    if arch in HYBRID_VARIANTS:
        cfg, params, pcfg, model = _rig("jamba-v0.1-52b",
                                        **HYBRID_VARIANTS[arch])
    else:
        cfg, params, pcfg, model = _rig(arch)
    jb, tb = _batches(cfg)
    (ref_l, ref_parts), ref_g = jax.jit(jax.value_and_grad(
        lambda p: ref_loop.loss_fn(cfg, p, jb), has_aux=True))(params)
    loss, parts, grads = _grads(pcfg, model, tb)
    assert float(loss) == pytest.approx(float(ref_l), rel=TOL)
    _close(parts["aux"].detach(), ref_parts["aux"], f"{arch}: aux")
    if cfg.moe is not None:
        assert float(parts["aux"].detach()) > 0.5
    want = _named(pcfg, ref_g)
    assert set(want) == set(grads)
    for n, g in grads.items():
        _close(g, want[n], f"{arch}: d{n}")
