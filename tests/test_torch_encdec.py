"""The port's enc-dec stack (whisper-medium, reduced) against the
reference's, on the same weights.

The reduced config (2 encoder + 2 decoder layers, n_ctx 32, d 256, 8
heads of 32, learned positions, float32) takes its weights from the
reference ``init_params``, carried over by
``convert.model_params_from_jax``; frames and tokens come from numpy.
On the CPU the port's attention takes its kernels' plain versions: B3
with a key length of its own for the cross-attention of forward and
prefill, B4 at ``lengths = n_ctx - 1`` for the cross-attention of
decode.  The encoder and the cross-attention agree with the reference
at 1e-5, the model's forward, prefill (self and cross caches) and three
decode steps at 1e-4 (the reference's ``tests/test_arch_smoke.py``
tolerance), the int8 KV cache at 1e-4 (prefill) / 1e-3 (decode), as in
``tests/test_torch_kv_int8.py``.  B3's key length of its own is held
against the reference in ``tests/test_torch_flash_key_length.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import attention as ref_attn
from repro.models import build as ref_build
from repro.models import transformer as ref_tfm
from repro_torch.configs import get_config as pt_get_config
from repro_torch.configs import reduced as pt_reduced
from repro_torch.convert import model_params_from_jax
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as pt_attn
from repro_torch.models import build
from repro_torch.models import transformer as tfm
from repro_torch.serving import InferenceEngine

ARCH = "whisper-medium"
ATOL = 1e-4
B, S, EXTRA = 2, 12, 3


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.long() if dtype is None else t.to(dtype)


def _rig(cfg, pcfg, seed=0):
    ref = ref_build(cfg)
    params = ref.init(jax.random.PRNGKey(seed))
    port = build(pcfg)
    pparams = model_params_from_jax(
        pcfg, jax.tree.map(np.asarray, params), device="cpu")
    return ref, params, port, pparams


@pytest.fixture(scope="module")
def rig():
    cfg, pcfg = reduced(get_config(ARCH)), pt_reduced(pt_get_config(ARCH))
    ref, params, port, pparams = _rig(cfg, pcfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + EXTRA)).astype(
        np.int32)
    frames = rng.standard_normal(
        (B, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
    return cfg, ref, params, port, pparams, toks, frames


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want),
                               rtol=0, atol=atol)


def test_reduced_config_is_what_the_tests_say(rig):
    cfg, *_ = rig
    e = cfg.encoder
    assert (cfg.num_layers, e.num_layers, e.n_ctx, cfg.d_model,
            cfg.num_heads, cfg.head_dim) == (2, 2, 32, 256, 8, 32)
    assert cfg.learned_positions and cfg.dtype == "float32"


def test_converted_weights_are_the_reference_weights(rig):
    cfg, _, params, _, pparams, _, _ = rig
    np.testing.assert_array_equal(pparams.pos_embed.numpy(),
                                  params["pos_embed"])
    assert pparams.pos_embed.shape[0] == min(cfg.max_position_embeddings,
                                             65536)
    enc = params["encoder"]
    np.testing.assert_array_equal(pparams.encoder.pos.numpy(), enc["pos"])
    np.testing.assert_array_equal(pparams.encoder.norm["scale"].numpy(),
                                  enc["norm"]["scale"])
    for i, blk in enumerate(pparams.encoder.layers):
        assert set(blk) == set(enc["stack"])
        np.testing.assert_array_equal(
            blk["attn"]["wq"].numpy(),
            np.asarray(enc["stack"]["attn"]["wq"])[i])
        np.testing.assert_array_equal(
            blk["ffn"]["w_up"].numpy(),
            np.asarray(enc["stack"]["ffn"]["w_up"])[i])
    for i, blk in enumerate(pparams.layers):
        assert {"norm_x", "xattn"} <= set(blk)
        # a cross block has biases and no q/k norms
        assert set(blk["xattn"]) == {"wq", "wk", "wv", "wo", "bq", "bk",
                                     "bv"}
        np.testing.assert_array_equal(
            blk["xattn"]["wk"].numpy(),
            np.asarray(params["stack"][0]["xattn"]["wk"])[i])


def test_seeded_init_has_the_reference_shapes():
    cfg = reduced(get_config(ARCH))
    pcfg = pt_reduced(pt_get_config(ARCH))
    want = jax.eval_shape(lambda: ref_build(cfg).init(
        jax.random.PRNGKey(0)))
    got = build(pcfg).init(torch.Generator().manual_seed(3))
    assert got.pos_embed.shape == want["pos_embed"].shape
    assert got.encoder.pos.shape == want["encoder"]["pos"].shape
    assert len(got.encoder.layers) == cfg.encoder.num_layers
    for name, sub in got.encoder.layers[0].items():
        for key, w in sub.items():
            assert w.shape == want["encoder"]["stack"][name][key].shape[1:]
    for name, sub in got.layers[0].items():
        for key, w in sub.items():
            assert w.shape == want["stack"][0][name][key].shape[1:]


def test_encode_matches_reference(rig):
    cfg, _, params, port, pparams, _, frames = rig
    want = ref_tfm.encode(cfg, params, jnp.asarray(frames))
    with torch.inference_mode():
        got = tfm.encode(port.cfg, pparams, _t(frames, torch.float32))
    assert got.shape == want.shape
    _close(got, want, 1e-5)


def test_encoder_promotes_like_the_reference():
    """bf16 weights: float32 frames (the engine's) give a float32
    encoder output and cross cache in both packages, within 1e-5;
    bf16 frames keep bf16 in both."""
    cfg = dataclasses.replace(reduced(get_config(ARCH)), dtype="bfloat16")
    pcfg = dataclasses.replace(pt_reduced(pt_get_config(ARCH)),
                               dtype="bfloat16")
    ref, params, port, pparams = _rig(cfg, pcfg, seed=2)
    frames = np.random.default_rng(2).standard_normal(
        (1, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
    want = ref_tfm.encode(cfg, params, jnp.asarray(frames))
    with torch.inference_mode():
        got = tfm.encode(pcfg, pparams, _t(frames, torch.float32))
        assert want.dtype == jnp.float32 and got.dtype == torch.float32
        _close(got, want, 1e-5)
        half = tfm.encode(pcfg, pparams, _t(frames, torch.bfloat16))
        assert half.dtype == torch.bfloat16
        assert ref_tfm.encode(cfg, params, jnp.asarray(
            frames, jnp.bfloat16)).dtype == jnp.bfloat16
        _, cache = port.prefill(pparams, {
            "tokens": torch.zeros(1, 4, dtype=torch.long),
            "frames": _t(frames, torch.float32)}, 8)
    # the reference's prefill caches cross_kv's output: float32 here
    p = jax.tree.map(lambda a: a[0], params["stack"][0]["xattn"])
    assert ref_attn.cross_kv(p, want)[0].dtype == jnp.float32
    assert cache[0]["cross_k"].dtype == torch.float32
    assert cache[0]["k"].dtype == torch.bfloat16


def test_cross_attention_matches_reference(rig):
    cfg, _, params, _, pparams, _, frames = rig
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    p = jax.tree.map(lambda a: np.asarray(a)[0], params["stack"][0]["xattn"])
    pp = pparams.layers[0]["xattn"]
    enc = rng.standard_normal((B, cfg.encoder.n_ctx, cfg.d_model)).astype(
        np.float32)
    k, v = ref_attn.cross_kv(p, jnp.asarray(enc))
    pk, pv = pt_attn.cross_kv(pp, _t(enc, torch.float32))
    _close(pk, k, 1e-5)
    _close(pv, v, 1e-5)
    want = ref_attn.cross_attend(p, jnp.asarray(x), k, v)
    got = pt_attn.cross_attend(pp, _t(x, torch.float32), pk, pv)
    _close(got, want, 1e-5)
    # decode: one query a row through B4 at lengths n_ctx - 1
    want1 = ref_attn.cross_attend(p, jnp.asarray(x[:, :1]), k, v)
    got1 = pt_attn.cross_attend(pp, _t(x[:, :1], torch.float32), pk, pv,
                                decode=True)
    _close(got1, want1, 1e-5)


def test_cross_attention_with_float32_kv_under_a_bf16_query(rig):
    """The engine's case: a bf16 decoder over the float32 cross K/V.
    The query is cast to float32 for the kernel and the output back to
    bf16, the reference's promotion; the core agrees at 1e-5 before the
    bf16 rounding of the output."""
    cfg, _, params, _, pparams, _, _ = rig
    rng = np.random.default_rng(5)
    p = jax.tree.map(lambda a: np.asarray(a)[1], params["stack"][0]["xattn"])
    ph = {k: jnp.asarray(a, jnp.bfloat16) for k, a in p.items()}
    pp = {k: _t(np.asarray(a.astype(jnp.float32)), torch.bfloat16)
          for k, a in ph.items()}
    x = jnp.asarray(rng.standard_normal((B, 4, cfg.d_model)), jnp.bfloat16)
    xt = _t(np.asarray(x.astype(jnp.float32)), torch.bfloat16)
    enc = rng.standard_normal((B, cfg.encoder.n_ctx, cfg.d_model)).astype(
        np.float32)
    k, v = ref_attn.cross_kv(ph, jnp.asarray(enc))
    pk, pv = pt_attn.cross_kv(pp, _t(enc, torch.float32))
    assert k.dtype == jnp.float32 and pk.dtype == torch.float32
    _close(pk, k, 1e-5)
    for decode, xs in ((False, slice(None)), (True, slice(0, 1))):
        want = ref_attn.cross_attend(ph, x[:, xs], k, v)
        got = pt_attn.cross_attend(pp, xt[:, xs], pk, pv, decode=decode)
        assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
        # the attention core before wo: the reference's sdpa in float32
        q = jnp.einsum("bsd,dhk->bshk", x[:, xs], ph["wq"]) + ph["bq"]
        core = ref_attn.sdpa(q.astype(jnp.float32), k, v,
                             jnp.ones((1, q.shape[1], k.shape[1]), bool))
        # (the same bf16 query: torch's and XLA's bf16 products may
        # round an element one ulp apart)
        qt = _t(np.asarray(q.astype(jnp.float32)), torch.float32)
        if decode:
            got_core = da.decode_attention(
                qt[:, 0].contiguous(), pk, pv,
                torch.full((B,), pk.shape[1] - 1, dtype=torch.int32))
            got_core = got_core[:, None]
        else:
            got_core = fa.flash_attention(qt, pk, pv, causal=False)
        _close(got_core, core, 1e-5)
        # and the block's bf16 output within a few bf16 roundings
        _close(got, want.astype(jnp.float32), 2e-2)


def test_forward_matches_reference(rig):
    cfg, ref, params, port, pparams, toks, frames = rig
    want, _ = ref.forward(params, {"tokens": jnp.asarray(toks),
                                   "frames": jnp.asarray(frames)})
    with torch.inference_mode():
        got, aux = port.forward(pparams, {"tokens": _t(toks),
                                          "frames": _t(frames,
                                                       torch.float32)})
    assert got.shape == want.shape == (B, S + EXTRA, cfg.vocab_size)
    assert float(aux) == 0.0
    _close(got, want, ATOL)


def _check_cache(pc, rc, atol=ATOL):
    for i, layer in enumerate(pc):
        want = jax.tree.map(lambda a: np.asarray(a)[i], rc["stack"][0])
        assert set(layer) == set(want)
        for name, t in layer.items():
            assert t.shape == want[name].shape, name
            assert t.numpy().dtype == want[name].dtype, name
            np.testing.assert_allclose(t.float().numpy(),
                                       want[name].astype(np.float32),
                                       rtol=0, atol=atol)


def _prefill_decode(rig, decode_atol=ATOL):
    cfg, ref, params, port, pparams, toks, frames = rig
    batch = {"tokens": toks[:, :S], "frames": frames}
    want, rc = ref.prefill(params, jax.tree.map(jnp.asarray, batch),
                           S + EXTRA)
    with torch.inference_mode():
        got, pc = port.prefill(pparams, {"tokens": _t(toks[:, :S]),
                                         "frames": _t(frames,
                                                      torch.float32)},
                               S + EXTRA)
    _close(got, want, ATOL)
    _check_cache(pc, rc)
    assert pc[0]["cross_k"].shape == (B, cfg.encoder.n_ctx, cfg.num_heads,
                                      cfg.head_dim)
    lens = jnp.full((B,), S, jnp.int32)
    plens = torch.full((B,), S, dtype=torch.int32)
    for t in range(EXTRA):
        tok = toks[:, S + t:S + t + 1]
        want, rc = ref.decode_step(params, jnp.asarray(tok), rc, lens)
        with torch.inference_mode():
            got, pc = port.decode_step(pparams, _t(tok), pc, plens)
        _close(got, want, decode_atol)
        _check_cache(pc, rc)
        lens, plens = lens + 1, plens + 1
    return pc


def test_prefill_and_decode_match_reference(rig):
    _prefill_decode(rig)


def test_int8_kv_cache_keeps_the_cross_cache_float(rig, monkeypatch):
    monkeypatch.setenv("REPRO_KV_INT8", "1")
    pc = _prefill_decode(rig, decode_atol=1e-3)
    assert pc[0]["k"].dtype == torch.int8 and "k_scale" in pc[0]
    assert pc[0]["cross_k"].dtype == torch.float32
    cache = tfm.init_cache(rig[3].cfg, 1, 8, device="cpu")[0]
    assert cache["k"].dtype == torch.int8
    assert cache["cross_v"].dtype == torch.float32


def test_decode_clips_learned_positions_past_the_table(rig):
    """A row whose length is past the position table's last row takes
    that row's position, as in the reference (its cache write falls
    outside the cache and writes nothing)."""
    cfg, ref, params, port, pparams, toks, frames = rig
    rows = pparams.pos_embed.shape[0]
    batch = {"tokens": toks[:, :S], "frames": frames}
    _, rc = ref.prefill(params, jax.tree.map(jnp.asarray, batch), S + 1)
    with torch.inference_mode():
        _, pc = port.prefill(pparams, {"tokens": _t(toks[:, :S]),
                                       "frames": _t(frames, torch.float32)},
                             S + 1)
    tok = toks[:, S:S + 1]
    outs = []
    for lengths in ([rows - 1, rows + 7], [rows + 100, rows + 3]):
        want, _ = ref.decode_step(params, jnp.asarray(tok), rc,
                                  jnp.asarray(lengths, jnp.int32))
        with torch.inference_mode():
            got, _ = port.decode_step(
                pparams, _t(tok), pc, torch.tensor(lengths,
                                                   dtype=torch.int32))
        _close(got, want, ATOL)
        outs.append(got)
    # rows - 1, rows + 3, rows + 7 and rows + 100 all read its last row
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_missing_frames_raise(rig):
    _, _, _, port, pparams, toks, _ = rig
    with pytest.raises(ValueError, match="frames"):
        port.prefill(pparams, {"tokens": _t(toks)}, S + EXTRA + 1)
    with pytest.raises(ValueError, match="frames"):
        port.forward(pparams, {"tokens": _t(toks)})


def test_engine_generates_the_reference_models_tokens(rig):
    """The port's engine (float32 zero frames, as the reference's) on the
    converted weights: its greedy tokens are those of the reference's
    prefill and decode on the same batch."""
    cfg, ref, params, port, pparams, _, _ = rig
    eng = InferenceEngine(port.cfg, workload="generate", seq_len=8,
                          gen_tokens=4, max_batch=4, device="cpu")
    eng.params = pparams
    batch = eng._make_batch(4)
    assert batch["frames"].dtype == torch.float32
    assert batch["frames"].shape == (4, cfg.encoder.n_ctx, cfg.d_model)
    got = eng._fns[4](pparams, batch)
    rb = {"tokens": jnp.asarray(batch["tokens"].numpy(), jnp.int32),
          "frames": jnp.asarray(batch["frames"].numpy())}
    lg, cache = ref.prefill(params, rb, 8 + 4 + 1)
    tok = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
    lens = jnp.full((4,), 8, jnp.int32)
    want = []
    for _ in range(4):
        lg, cache = ref.decode_step(params, tok, cache, lens)
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok[:, 0]))
        lens = lens + 1
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))
    assert eng.run_batch(3) > 0
