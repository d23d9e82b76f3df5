"""The port's models against the reference's, on the same weights: two
dense transformers, the Mamba2 SSM, DeepSeek-V2-Lite (MLA beside a
dense lead layer and MoE layers) and the Jamba hybrid.

Each reduced config's weights come from the reference ``init_params``
and cross through ``convert.model_params_from_jax``; both models then
run the same tokens in float32 on the CPU, where the port's attention
and SSD scan take their kernels' plain versions.  ``forward``,
``prefill`` (logits and caches: KV, or Mamba2's conv windows and state)
and three ``decode_step``s (logits and caches) agree to 1e-4 absolute
(measured: ≤ 1.6e-6 on the dense models' logits of magnitude ≤ 1.6,
≤ 5e-6 on their caches; ≤ 7e-6 on Mamba2's logits of magnitude ≤ 5.1,
≤ 5e-6 on its caches).  Mamba2's and Jamba's prompts are 70 tokens, so
that the scan carries its state across chunks of 32.  DeepSeek's cache
is the latent ``c_kv`` / ``k_pe``, Jamba's K/V on its attention layer
beside the Mamba2 layer's windows and state; the reference keeps
DeepSeek's dense lead layer apart (``"lead"``) and stacks the rest.  The port's own prefill + decode
is held against its forward at the reference's 3e-4
(tests/test_arch_smoke.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import build as ref_build
from repro.models import layers as ref_layers
from repro.models import rope as ref_rope
from repro_torch.configs import get_config as pt_get_config
from repro_torch.configs import list_archs as pt_list_archs
from repro_torch.configs import reduced as pt_reduced
from repro_torch.convert import model_params_from_jax
from repro_torch.models import build
from repro_torch.models import layers as pt_layers
from repro_torch.models import rope as pt_rope
from repro_torch.models import transformer as tfm

# MHA + QKV bias; GQA + 0.75 rope; attention-free SSD; MLA + MoE; the
# Mamba2 / attention hybrid
ARCHS = ["qwen1.5-0.5b", "phi4-mini-3.8b", "mamba2-2.7b",
         "deepseek-v2-lite-16b", "jamba-v0.1-52b"]
ATTN_ARCHS = ARCHS[:2]
ATOL = 1e-4
B, EXTRA = 2, 3
# prompt length per arch: the SSM layers' crosses their reduced chunk
# of 32
PROMPT = {"mamba2-2.7b": 70, "jamba-v0.1-52b": 70}


@pytest.fixture(scope="module")
def rigs():
    out = {}
    for arch in ARCHS:
        cfg = reduced(get_config(arch))
        ref = ref_build(cfg)
        params = ref.init(jax.random.PRNGKey(0))
        pcfg = pt_reduced(pt_get_config(arch))
        port = build(pcfg)
        pparams = model_params_from_jax(
            pcfg, jax.tree.map(np.asarray, params), device="cpu")
        toks = np.random.default_rng(1).integers(
            0, cfg.vocab_size, size=(B, PROMPT.get(arch, 32) + EXTRA)
        ).astype(np.int32)
        out[arch] = (ref, params, port, pparams, toks)
    return out


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _ref_layer(cfg, tree, i):
    """Layer ``i``'s entry of a reference pytree of ``{"lead",
    "stack"}`` (parameters or cache): repeat ``(i - lead) // p`` of
    stack entry ``(i - lead) % p``."""
    lead, p, _ = tfm.split_pattern(cfg)
    if i < lead:
        return tree["lead"][i]
    j, r = (i - lead) % p, (i - lead) // p
    return jax.tree.map(lambda a: np.asarray(a)[r], tree["stack"][j])


def _check_caches(cfg, pc, rc, n_layers):
    assert len(pc) == n_layers
    for i in range(n_layers):
        ref_layer = _ref_layer(cfg, rc, i)
        assert set(pc[i]) == set(ref_layer)
        for name, got in pc[i].items():
            want = np.asarray(ref_layer[name])
            assert got.shape == want.shape, name
            assert got.numpy().dtype == want.dtype, name
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_config_is_the_reference_config(arch):
    a, b = get_config(arch), pt_get_config(arch)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(reduced(a)) == dataclasses.asdict(
        pt_reduced(b))


def test_port_registry_lists_the_reference_archs():
    from repro.configs import list_archs
    assert pt_list_archs() == list_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_converted_weights_are_the_reference_weights(arch, rigs):
    _, params, port, pparams, _ = rigs[arch]
    np.testing.assert_array_equal(pparams.embed.numpy(), params["embed"])
    for i, blk in enumerate(pparams.layers):
        want = _ref_layer(port.cfg, params, i)
        assert set(blk) == set(want)
        flat = jax.tree_util.tree_flatten_with_path(want)[0]
        got = dict(blk.named_parameters())
        assert len(got) == len(flat)
        for path, w in flat:
            key = ".".join(str(getattr(k, "key", k)) for k in path)
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(w))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, rigs):
    ref, params, port, pparams, toks = rigs[arch]
    want, want_aux = ref.forward(params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, aux = port.forward(pparams, {"tokens": _t(toks)})
    assert got.shape == want.shape
    if port.cfg.moe is None:
        assert float(aux) == 0.0
    else:
        assert float(aux) > 0
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, rigs):
    ref, params, port, pparams, toks = rigs[arch]
    cfg = port.cfg
    S = toks.shape[1] - EXTRA
    want, rc = ref.prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                           S + EXTRA)
    with torch.inference_mode():
        got, pc = port.prefill(pparams, {"tokens": _t(toks[:, :S])},
                               S + EXTRA)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    _check_caches(cfg, pc, rc, cfg.num_layers)
    if arch in ATTN_ARCHS:
        assert pc[0]["k"].shape == (B, S + EXTRA, cfg.num_kv_heads,
                                    cfg.head_dim)
    lens = jnp.full((B,), S, jnp.int32)
    plens = torch.full((B,), S, dtype=torch.int32)
    for t in range(EXTRA):
        tok = toks[:, S + t:S + t + 1]
        want, rc = ref.decode_step(params, jnp.asarray(tok), rc, lens)
        with torch.inference_mode():
            got, pc = port.decode_step(pparams, _t(tok), pc, plens)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
        _check_caches(cfg, pc, rc, cfg.num_layers)
        lens, plens = lens + 1, plens + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_port_prefill_decode_matches_its_forward(arch, rigs):
    _, _, port, pparams, toks = rigs[arch]
    S = toks.shape[1] - EXTRA
    with torch.inference_mode():
        full, _ = port.forward(pparams, {"tokens": _t(toks)})
        lg, cache = port.prefill(pparams, {"tokens": _t(toks[:, :S])},
                                 S + EXTRA)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, S - 1].numpy(),
                                   rtol=3e-4, atol=3e-4)
        lens = torch.full((B,), S, dtype=torch.int32)
        for t in range(EXTRA):
            lg, cache = port.decode_step(
                pparams, _t(toks[:, S + t:S + t + 1]), cache, lens)
            np.testing.assert_allclose(lg[:, 0].numpy(),
                                       full[:, S + t].numpy(), rtol=3e-4,
                                       atol=3e-4)
            lens = lens + 1


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_sliding_window_decode_differs(arch, rigs):
    _, _, port, pparams, toks = rigs[arch]
    S = toks.shape[1] - EXTRA
    with torch.inference_mode():
        _, cache = port.prefill(pparams, {"tokens": _t(toks[:, :S])},
                                S + 2)
        lens = torch.full((B,), S, dtype=torch.int32)
        tok = _t(toks[:, S - 1:S])
        # both steps write the same K/V into slot S of the (in-place)
        # cache, so the second one sees what the first one saw
        full, _ = port.decode_step(pparams, tok, cache, lens)
        win, _ = port.decode_step(pparams, tok, cache, lens, window=8)
    assert bool(torch.isfinite(win).all())
    assert float((win - full).abs().max()) > 1e-6


def test_seeded_init_is_deterministic_and_shaped_like_the_reference():
    cfg = pt_reduced(pt_get_config("phi4-mini-3.8b"))
    a = build(cfg).init(torch.Generator().manual_seed(7))
    b = build(cfg).init(torch.Generator().manual_seed(7))
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    ref = jax.eval_shape(lambda: ref_build(reduced(get_config(
        "phi4-mini-3.8b"))).init(jax.random.PRNGKey(0)))
    assert a.embed.shape == ref["embed"].shape
    for name, sub in a.layers[0].items():
        for key, w in sub.items():
            assert w.shape == ref["stack"][0][name][key].shape[1:]
            assert not w.requires_grad


def _hybrid_without_moe():
    """Jamba's Mamba2 / attention interleave alone (its MoE taken out)."""
    return dataclasses.replace(pt_reduced(pt_get_config("jamba-v0.1-52b")),
                               moe=None)


def _unported(arch):
    """A config of each kind the port did not serve before MLA, the
    hybrid interleave and the enc-dec / VLM stacks were ported.  OLMoE
    itself is ported; its case is OLMoE with learned positions."""
    if arch == "jamba-interleave":
        return _hybrid_without_moe()
    cfg = pt_reduced(pt_get_config(arch))
    if arch == "olmoe-1b-7b":
        return dataclasses.replace(cfg, learned_positions=True)
    return cfg


# ported since: they build and match the reference
NOW_PORTED = ("jamba-interleave", "olmoe-1b-7b", "deepseek-v2-lite-16b",
              "whisper-medium", "internvl2-1b", "jamba-v0.1-52b")


@pytest.mark.parametrize("arch", NOW_PORTED)
def test_unported_families_raise_and_name_their_item(arch):
    """The cases that once raised and named their ROADMAP item (8b-hybrid,
    8c, 8e) are all ported: the interleave alone, OLMoE with learned
    positions, DeepSeek-V2-Lite, whisper (its frames), InternVL2 (its
    patch embeddings) and Jamba build and give the reference's forward
    logits on its weights."""
    cfg = _unported(arch)
    rcfg = reduced(get_config(cfg.name.removesuffix("-reduced")))
    if arch == "jamba-interleave":
        rcfg = dataclasses.replace(rcfg, moe=None)
    if arch == "olmoe-1b-7b":
        rcfg = dataclasses.replace(rcfg, learned_positions=True)
    ref = ref_build(rcfg)
    params = ref.init(jax.random.PRNGKey(3))
    port = build(cfg)
    pparams = model_params_from_jax(cfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, size=(1, 40))
    batch = {"tokens": toks}
    extra = {"audio": "frames", "vlm": "patch_embeds"}.get(cfg.family)
    if extra is not None:
        batch[extra] = rng.standard_normal(
            (1, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
    want, _ = ref.forward(params, jax.tree.map(jnp.asarray, batch))
    with torch.inference_mode():
        got, _ = port.forward(pparams, {
            k: _t(a) if k == "tokens" else torch.from_numpy(a)
            for k, a in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_int8_kv_cache_raises(monkeypatch):
    """The int8 cache is ported (``REPRO_KV_INT8=1`` gives int8 codes and
    scales); the float decode attention raises on its codes, and its own
    decode attention on a float cache."""
    from repro_torch.kernels import decode_attention as da
    monkeypatch.setenv("REPRO_KV_INT8", "1")
    cfg = pt_reduced(pt_get_config("qwen1.5-0.5b"))
    cache = tfm.init_cache(cfg, 1, 8, device="cpu")[0]
    assert cache["k"].dtype == torch.int8 and "k_scale" in cache
    q = torch.zeros(1, cfg.num_heads, cfg.head_dim)
    lens = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        da.decode_attention(q, cache["k"], cache["v"], lens)
    with pytest.raises(ValueError, match="int8"):
        da.decode_attention_int8(q, cache["k"].float(), cache["k_scale"],
                                 cache["v"].float(), cache["v_scale"], lens)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_reference(kind):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32) * 3
    scale = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    p = {"scale": scale, "bias": bias}
    want = ref_layers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), kind)
    got = pt_layers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                               torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_apply_mlp_matches_reference(activation):
    params = ref_layers.init_mlp(jax.random.PRNGKey(3), 16, 40, activation,
                                 jnp.float32)
    if activation == "gelu":
        params = {k: v + 0.1 for k, v in params.items()}
    x = np.random.default_rng(3).standard_normal((2, 7, 16)).astype(
        np.float32)
    want = ref_layers.apply_mlp(params, jnp.asarray(x), activation)
    got = pt_layers.apply_mlp(
        {k: torch.from_numpy(np.array(v)) for k, v in params.items()},
        torch.from_numpy(x), activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


def test_embed_and_tied_unembed_match_reference():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    toks = rng.integers(0, 50, size=(2, 9))
    got = pt_layers.embed(torch.from_numpy(table), torch.from_numpy(toks))
    want = ref_layers.embed(jnp.asarray(table), jnp.asarray(toks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for tied, w in ((True, table), (False, table.T.copy())):
        got = pt_layers.unembed(torch.from_numpy(w), torch.from_numpy(
            np.array(want)), tied)
        ref = ref_layers.unembed(jnp.asarray(w), want, tied)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=2e-6)


@pytest.mark.parametrize("partial", [1.0, 0.75])
@pytest.mark.parametrize("decode", [False, True],
                         ids=["positions-S", "positions-B1"])
def test_rope_matches_reference(partial, decode):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 1 if decode else 40, 4, 32)).astype(
        np.float32)
    pos = (np.array([[0], [17], [39]], np.int32) if decode
           else np.arange(40, dtype=np.int32))
    for theta in (10_000.0, 1_000_000.0):
        want = ref_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta,
                                   partial)
        got = pt_rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                 theta, partial)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-5)
        np.testing.assert_array_equal(got.numpy()[..., int(32 * partial):],
                                      x[..., int(32 * partial):])
