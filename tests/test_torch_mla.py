"""The port's DeepSeek-V2 multi-head latent attention (MLA) against the
reference's.

On the CPU the attention cores take their kernels' plain versions:
B3's (``flash_attention``) at a (query/key, value) width pair, and the
absorbed MLA decode's (``mla_decode_attention``), which has no Pallas
counterpart and is held against the reference's own einsum chain
(``repro.models.attention.mla_decode``) on the same numpy inputs.  The
MLA block runs on reduced deepseek-v2-lite-16b (rank 64, nope 32, rope
16, v 32, so B3's pair is (48, 32)) with weights carried across by
``convert.model_params_from_jax``, in float32, at 1e-5 (measured:
≤ 1.7e-6): prefill in full and under a window, and decode at ragged
lengths, under a window, and at lengths −1, S and S + 5, which write
nothing into the cache.  The CUDA kernels are held against the plain
versions in chip_smoke.py on the card.
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
from repro_torch.configs import get_config as pt_get_config
from repro_torch.configs import reduced as pt_reduced
from repro_torch.convert import model_params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mla_decode as md
from repro_torch.models import attention as pt_attn
from repro_torch.models import transformer as tfm

ARCH = "deepseek-v2-lite-16b"
ATOL = 1e-5
B, S = 3, 24


@pytest.fixture(scope="module")
def rig():
    """The reduced config and the reference's first MLA block's weights
    (layer 0, the dense lead), in both packages."""
    cfg = reduced(get_config(ARCH))
    params = ref_build(cfg).init(jax.random.PRNGKey(0))
    pcfg = pt_reduced(pt_get_config(ARCH))
    pparams = model_params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    return cfg, params["lead"][0]["attn"], pcfg, pparams.layers[0]["attn"]


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def test_init_mla_shapes_are_the_reference_shapes():
    cfg = pt_reduced(pt_get_config(ARCH))
    got = pt_attn.init_mla(torch.Generator().manual_seed(0), cfg,
                           torch.float32)
    want = jax.eval_shape(lambda: ref_attn.init_mla(
        jax.random.PRNGKey(0), reduced(get_config(ARCH)), jnp.float32))
    assert set(got) == set(want)
    for name, w in got.items():
        assert tuple(w.shape) == want[name].shape, name
        assert not w.requires_grad
    m = cfg.mla
    assert tuple(got["wq"].shape) == (
        cfg.d_model, cfg.num_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    assert tuple(got["wo"].shape) == (cfg.num_heads, m.v_head_dim,
                                      cfg.d_model)
    assert bool((got["norm_ckv"] == 1).all())


@pytest.mark.parametrize("window", [0, 7])
def test_mla_forward_matches_reference(rig, window):
    cfg, p, pcfg, pp = rig
    x = _x(1, B, S, cfg.d_model)
    pos = np.arange(S)
    want, (c_want, k_want) = ref_attn.mla_forward(
        p, cfg, jnp.asarray(x), jnp.asarray(pos), window=window)
    with torch.inference_mode():
        got, (c_got, k_got) = pt_attn.mla_forward(
            pp, pcfg, torch.from_numpy(x), torch.from_numpy(pos),
            window=window)
    for g, w in ((got, want), (c_got, c_want), (k_got, k_want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


LENGTHS = {"ragged": [0, 11, S - 1], "empty": [-1, 5, S - 2],
           "past": [S, S + 5, 3]}


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("lengths", list(LENGTHS), ids=list(LENGTHS))
def test_mla_decode_matches_reference(rig, lengths, window):
    """The output and the latent cache after one step; a length outside
    [0, S) writes nothing."""
    cfg, p, pcfg, pp = rig
    m = cfg.mla
    rng = np.random.default_rng(2)
    cache = {"c_kv": rng.standard_normal((B, S, m.kv_lora_rank)),
             "k_pe": rng.standard_normal((B, S, m.qk_rope_head_dim))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    lens = np.asarray(LENGTHS[lengths], np.int32)
    x = _x(3, B, 1, cfg.d_model)
    want, wc = ref_attn.mla_decode(
        p, cfg, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(lens), window=window)
    pc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    with torch.inference_mode():
        got, gc = pt_attn.mla_decode(pp, pcfg, torch.from_numpy(x), pc,
                                     torch.from_numpy(lens), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    for name in cache:
        np.testing.assert_allclose(gc[name].numpy(), np.asarray(wc[name]),
                                   rtol=0, atol=ATOL)
        for b, n in enumerate(lens):
            if not 0 <= n < S:
                np.testing.assert_array_equal(gc[name][b].numpy(),
                                              cache[name][b])


def _chain_ref(q_abs, q_pe, c_kv, k_pe, lengths, scale, window):
    """The reference's einsum chain of ``mla_decode``, from q_abs to
    the context (src/repro/models/attention.py, float32)."""
    q_abs, q_pe = jnp.asarray(q_abs)[:, None], jnp.asarray(q_pe)[:, None]
    c = jnp.asarray(c_kv).astype(jnp.float32)
    sc = jnp.einsum("bshr,btr->bsht", q_abs, c)
    sc += jnp.einsum("bshk,btk->bsht", q_pe,
                     jnp.asarray(k_pe).astype(jnp.float32))
    sc *= scale
    lengths = jnp.asarray(lengths)
    mask = ref_attn._mask(lengths[:, None], jnp.arange(c.shape[1])[None, :],
                          causal=True, window=window, kv_len=None)
    pattn = ref_attn._masked_softmax(sc, mask[:, :, None, :])
    return np.asarray(jnp.einsum("bsht,btr->bshr", pattn, c))[:, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 9])
def test_mla_decode_plain_matches_reference_chain(dtype, window):
    """DeepSeek-V2-Lite's widths (16 heads, rank 512, rope 64) over a
    ragged batch; rows of length −1 give 0."""
    rng = np.random.default_rng(4)
    b, s, h, r, p = 4, 40, 16, 512, 64
    q_abs = rng.standard_normal((b, h, r)).astype(np.float32)
    q_pe = rng.standard_normal((b, h, p)).astype(np.float32)
    c_kv = rng.standard_normal((b, s, r)).astype(np.float32)
    k_pe = rng.standard_normal((b, s, p)).astype(np.float32)
    if dtype == "bfloat16":
        c_kv, k_pe = (np.array(jnp.asarray(a, jnp.bfloat16)
                               .astype(jnp.float32)) for a in (c_kv, k_pe))
    lens = np.asarray([-1, 0, 17, s + 3], np.int32)
    scale = 192 ** -0.5
    want = _chain_ref(q_abs, q_pe, c_kv, k_pe, lens, scale, window)
    tdt = getattr(torch, dtype)
    got = md.mla_decode_attention(
        torch.from_numpy(q_abs), torch.from_numpy(q_pe),
        torch.from_numpy(c_kv).to(tdt), torch.from_numpy(k_pe).to(tdt),
        torch.from_numpy(lens), scale=scale, window=window)
    assert got.dtype == torch.float32 and got.shape == (b, h, r)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    assert bool((got[0] == 0).all())


def _merged_partials(q_abs, q_pe, c_kv, k_pe, lens, scale, window,
                     ranks):
    """What the mesh route computes across ``ranks`` slices of the cache's
    sequence: each slice's ``mla_decode_partials_plain`` at lengths
    shifted by its offset, merged by the max and the two sums."""
    s = c_kv.shape[1] // ranks
    parts = [md.mla_decode_partials_plain(
        q_abs, q_pe, c_kv[:, r * s:(r + 1) * s].contiguous(),
        k_pe[:, r * s:(r + 1) * s].contiguous(), lens - r * s, scale=scale,
        window=window) for r in range(ranks)]
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    w = [torch.exp(m - top) for m, _, _ in parts]
    lsum = sum(l * wi for (_, l, _), wi in zip(parts, w))
    asum = sum(acc * wi for (_, _, acc), wi in zip(parts, w))
    return asum / (lsum + 1e-30)


@pytest.mark.parametrize("ranks", [1, 2, 4])
@pytest.mark.parametrize("window", [0, 9])
def test_mla_decode_partials_merge_to_the_plain_version(ranks, window):
    """DeepSeek-V2-Lite's widths over a 40-position cache split into
    ``ranks`` slices, at lengths −1, 0, the last position of the first
    slice and the first of the second: within 2e-5 of
    ``mla_decode_attention_plain`` over the whole cache; a row with no
    admitted position gives 0."""
    rng = np.random.default_rng(8)
    b, s, h, r, p = 4, 40, 16, 512, 64
    q_abs, q_pe, c_kv, k_pe = (
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        for shape in ((b, h, r), (b, h, p), (b, s, r), (b, s, p)))
    edge = s // max(ranks, 2)
    lens = torch.tensor([-1, 0, edge - 1, edge], dtype=torch.int32)
    scale = 192 ** -0.5
    want = md.mla_decode_attention_plain(q_abs, q_pe, c_kv, k_pe, lens,
                                         scale=scale, window=window)
    got = _merged_partials(q_abs, q_pe, c_kv, k_pe, lens, scale, window,
                           ranks)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)
    assert bool((got[0] == 0).all())


def test_flash_plain_at_a_width_pair_matches_reference_sdpa():
    """B3's plain version at (qk 48, v 32), the reduced MLA's pair,
    against the reference model's ``sdpa`` under a causal and a
    windowed mask."""
    rng = np.random.default_rng(5)
    b, s, h = 2, 29, 4
    q = rng.standard_normal((b, s, h, 48)).astype(np.float32)
    k = rng.standard_normal((b, s, h, 48)).astype(np.float32)
    v = rng.standard_normal((b, s, h, 32)).astype(np.float32)
    pos = jnp.arange(s)
    for window in (0, 6):
        mask = ref_attn._mask(pos, pos, causal=True, window=window,
                              kv_len=None)
        want = ref_attn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             mask[None])
        got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=True, window=window)
        assert got.shape == (b, s, h, 32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-5)


def test_launch_guards_without_the_card():
    """What the CUDA routes refuse before they reach the card: a width
    pair B3 is not built for, MLA decode widths other than
    DeepSeek-V2-Lite's; and the split rule's cover of the cache."""
    q = torch.zeros(1, 4, 2, 48)
    v = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="value width"):
        fa._launch(q, q, v, torch.empty(1, 4, 2, 32), True, 0)
    assert (192, 128) in fa.WIDTHS and (128, 128) in fa.WIDTHS
    args = [torch.zeros(2, 8, 64), torch.zeros(2, 8, 16),
            torch.zeros(2, 5, 64), torch.zeros(2, 5, 16)]
    with pytest.raises(ValueError, match="heads, rank, rope"):
        md._launch(*args, torch.zeros(2, dtype=torch.int32),
                   torch.empty(2, 8, 64), 0.1, 0)
    for b, s in ((1, 1057), (32, 37), (32, 1057), (3, 1)):
        splits, chunk = md.mla_splits(b, s, 132)
        assert chunk % md.TILE == 0 and splits * chunk >= s
        assert (splits - 1) * chunk < s and splits <= md.MAX_SPLITS


@pytest.mark.parametrize("bad", ["q-bf16", "cache-f16", "mixed", "lengths",
                                 "shape"])
def test_mla_decode_wrapper_refuses(bad):
    q_abs, q_pe = torch.zeros(2, 16, 512), torch.zeros(2, 16, 64)
    c_kv, k_pe = torch.zeros(2, 9, 512), torch.zeros(2, 9, 64)
    lens = torch.zeros(2, dtype=torch.int32)
    if bad == "q-bf16":
        q_abs = q_abs.bfloat16()
    elif bad == "cache-f16":
        c_kv, k_pe = c_kv.half(), k_pe.half()
    elif bad == "mixed":
        k_pe = k_pe.bfloat16()
    elif bad == "lengths":
        lens = lens.long()
    elif bad == "shape":
        k_pe = k_pe[:, :-1]
    with pytest.raises(ValueError):
        md.mla_decode_attention(q_abs, q_pe, c_kv, k_pe, lens, scale=0.1)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = md.mla_decode_attention.launches
    rng = np.random.default_rng(6)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((2, 16, 512), (2, 16, 64), (2, 7, 512), (2, 7, 64))]
    lens = torch.tensor([3, 6], dtype=torch.int32)
    got = md.mla_decode_attention(*args, lens, scale=0.07)
    want = md.mla_decode_attention_plain(*args, lens, scale=0.07)
    assert torch.equal(got, want)
    assert md.mla_decode_attention.launches == before


def test_latent_cache_stays_float_under_int8(monkeypatch):
    """``REPRO_KV_INT8=1`` leaves an MLA cache in the model's dtype, as
    the reference checks MLA before the int8 switch."""
    monkeypatch.setenv("REPRO_KV_INT8", "1")
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(pt_reduced(pt_get_config(ARCH)),
                                  dtype=dtype)
        m = cfg.mla
        for layer in tfm.init_cache(cfg, 2, 9, device="cpu"):
            assert set(layer) == {"c_kv", "k_pe"}
            assert layer["c_kv"].shape == (2, 9, m.kv_lora_rank)
            assert layer["k_pe"].shape == (2, 9, m.qk_rope_head_dim)
            assert {t.dtype for t in layer.values()} == {getattr(torch,
                                                                 dtype)}
