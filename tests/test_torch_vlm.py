"""The port's VLM stack (internvl2-1b, reduced) against the reference's,
on the same weights, and the engines' handling of both new families.

The reduced config (2 layers, d 256, 8 query heads over 1 kv head of
32, QKV bias, RoPE, float32, ``n_ctx`` 32 patch rows) takes its weights
from the reference ``init_params``.  The patch embeddings go in front
of the prompt: forward attends over n_ctx + S positions, prefill fills
n_ctx + S cache rows and decoding starts at ``seq_len + n_ctx``.  The
reference is called directly with a cache long enough for that: its
engine sizes the cache without the patch rows, and its ``generate``
fails (ROADMAP C-R4), which the port's engine routes around.  Logits
and caches agree at 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import build as ref_build
from repro.serving.continuous import ContinuousEngine as RefContinuous
from repro.serving.engine import InferenceEngine as RefEngine
from repro_torch.configs import get_config as pt_get_config
from repro_torch.configs import reduced as pt_reduced
from repro_torch.convert import model_params_from_jax
from repro_torch.models import build
from repro_torch.serving import ContinuousEngine, InferenceEngine

ARCH = "internvl2-1b"
ATOL = 1e-4
B, S, EXTRA = 2, 10, 3


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.long() if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def rig():
    cfg = reduced(get_config(ARCH))
    ref = ref_build(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = build(pt_reduced(pt_get_config(ARCH)))
    pparams = model_params_from_jax(
        port.cfg, jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + EXTRA)).astype(
        np.int32)
    patches = rng.standard_normal(
        (B, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
    return cfg, ref, params, port, pparams, toks, patches


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want),
                               rtol=0, atol=ATOL)


def test_reduced_config_is_what_the_tests_say(rig):
    cfg, *_ = rig
    assert cfg.family == "vlm" and cfg.encoder.num_layers == 0
    assert (cfg.encoder.n_ctx, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim) == (32, 8, 1, 32)
    assert not cfg.learned_positions and cfg.qkv_bias


def test_forward_with_patch_embeddings_matches_reference(rig):
    cfg, ref, params, port, pparams, toks, patches = rig
    want, _ = ref.forward(params, {"tokens": jnp.asarray(toks),
                                   "patch_embeds": jnp.asarray(patches)})
    with torch.inference_mode():
        got, _ = port.forward(pparams, {
            "tokens": _t(toks), "patch_embeds": _t(patches, torch.float32)})
    assert got.shape == want.shape == (B, cfg.encoder.n_ctx + S + EXTRA,
                                       cfg.vocab_size)
    _close(got, want)


def test_forward_on_text_alone_matches_reference(rig):
    _, ref, params, port, pparams, toks, _ = rig
    want, _ = ref.forward(params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, _ = port.forward(pparams, {"tokens": _t(toks)})
    assert got.shape == want.shape
    _close(got, want)


def test_prefill_and_decode_from_past_the_patches_match_reference(rig):
    cfg, ref, params, port, pparams, toks, patches = rig
    n = cfg.encoder.n_ctx
    cache_len = n + S + EXTRA
    want, rc = ref.prefill(params, {"tokens": jnp.asarray(toks[:, :S]),
                                    "patch_embeds": jnp.asarray(patches)},
                           cache_len)
    with torch.inference_mode():
        got, pc = port.prefill(pparams, {
            "tokens": _t(toks[:, :S]),
            "patch_embeds": _t(patches, torch.float32)}, cache_len)
    _close(got, want)

    def check_cache():
        for i, layer in enumerate(pc):
            for name in ("k", "v"):
                _close(layer[name], np.asarray(rc["stack"][0][name])[i])
    check_cache()
    assert pc[0]["k"].shape == (B, cache_len, cfg.num_kv_heads,
                                cfg.head_dim)
    lens = jnp.full((B,), S + n, jnp.int32)
    plens = torch.full((B,), S + n, dtype=torch.int32)
    for t in range(EXTRA):
        tok = toks[:, S + t:S + t + 1]
        want, rc = ref.decode_step(params, jnp.asarray(tok), rc, lens)
        with torch.inference_mode():
            got, pc = port.decode_step(pparams, _t(tok), pc, plens)
        _close(got, want)
        check_cache()
        lens, plens = lens + 1, plens + 1


def test_prefill_refuses_a_cache_without_room_for_the_patches(rig):
    cfg, _, _, port, pparams, toks, patches = rig
    with pytest.raises(ValueError, match="cannot hold"):
        port.prefill(pparams, {"tokens": _t(toks[:, :S]),
                               "patch_embeds": _t(patches, torch.float32)},
                     S + EXTRA + 1)


def test_reference_engine_generate_cannot_run_c_r4():
    """C-R4: the reference engine sizes the cache as seq_len + gen_tokens
    + 1 and prefills n_ctx + seq_len positions into it."""
    eng = RefEngine(reduced(get_config(ARCH)), workload="generate",
                    seq_len=8, gen_tokens=2, max_batch=1)
    with pytest.raises(ValueError, match="negative"):
        eng.run_batch(1)


def test_engine_generates_the_reference_models_tokens(rig):
    """The port's engine (float32 zero patch embeddings, decoding from
    seq_len + n_ctx over a cache of n_ctx + seq_len + gen_tokens + 1) on
    the converted weights gives the reference model's greedy tokens."""
    cfg, ref, params, port, pparams, _, _ = rig
    n = cfg.encoder.n_ctx
    eng = InferenceEngine(port.cfg, workload="generate", seq_len=8,
                          gen_tokens=4, max_batch=4, device="cpu")
    eng.params = pparams
    batch = eng._make_batch(4)
    assert batch["patch_embeds"].shape == (4, n, cfg.d_model)
    assert batch["patch_embeds"].dtype == torch.float32
    got = eng._fns[4](pparams, batch)
    lg, cache = ref.prefill(params, {
        "tokens": jnp.asarray(batch["tokens"].numpy(), jnp.int32),
        "patch_embeds": jnp.asarray(batch["patch_embeds"].numpy())},
        n + 8 + 4 + 1)
    tok = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
    lens = jnp.full((4,), 8 + n, jnp.int32)
    want = []
    for _ in range(4):
        lg, cache = ref.decode_step(params, tok, cache, lens)
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok[:, 0]))
        lens = lens + 1
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))
    assert eng.run_batch(3) > 0


def test_forward_engine_runs_on_the_patches(rig):
    cfg, _, _, port, pparams, _, _ = rig
    eng = InferenceEngine(port.cfg, workload="forward", seq_len=8,
                          max_batch=2, device="cpu")
    eng.params = pparams
    batch = eng._make_batch(2)
    with torch.inference_mode():
        logits, _ = port.forward(pparams, batch)
    assert logits.shape[1] == cfg.encoder.n_ctx + 8
    np.testing.assert_array_equal(eng._fns[2](pparams, batch).numpy(),
                                  logits[:, -1].argmax(-1).numpy())


def test_continuous_engine_runs_the_vlm_on_its_text():
    """As the reference's, the continuous engine prefills the prompt's
    tokens alone (its parity with the reference engine is in
    tests/test_torch_continuous.py)."""
    eng = ContinuousEngine(pt_reduced(pt_get_config(ARCH)), prompt_len=6,
                           gen_tokens=3, max_active=2, device="cpu")
    res = eng.serve_poisson(20.0, n_jobs=6, seed=0)
    assert res.n_jobs == 6 and np.all(np.isfinite(res.latencies))


def test_continuous_engine_refuses_whisper_for_want_of_frames():
    """Whisper needs its encoder's frames, which the continuous engine
    (the reference's too) does not supply: the port raises ValueError
    naming them at the first prefill, the reference fails there too."""
    arch = "whisper-medium"
    eng = ContinuousEngine(pt_reduced(pt_get_config(arch)), prompt_len=6,
                           gen_tokens=3, max_active=2, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        eng.warmup()
    ref = RefContinuous(reduced(get_config(arch)), prompt_len=6,
                        gen_tokens=3, max_active=2)
    with pytest.raises(KeyError, match="frames"):
        ref.warmup()
