"""The port's int8 KV cache against the reference's (``REPRO_KV_INT8=1``).

``quantize_kv`` is held bit for bit against the reference's on random
rows, rows of exact halves (round half to even) and all-zero rows.
Reduced qwen1.5-4b runs on the reference's weights (through
``convert.model_params_from_jax``) in float32 on the CPU: its int8
prefill agrees with the reference's int8 path to 1e-4 on the logits,
and three decode steps to 1e-3 (a code a step apart, from activations a
few ulps apart, moves a logit by up to 2.4e-4), the prefill's scales to
1e-5 relative (measured 1.5e-6; the decode steps' new rows to 1e-4,
measured 3.9e-5) and the codes to one step in under 1e-3 of them
(measured, 1 code in 17,920), and the first decode step stays within the reference's own 0.1 of the
float cache's forward logits (``tests/test_arch_smoke.py``).  B4's
int8 form, whose CPU path is ``decode_attention_int8_plain``, is held
against the reference's int8 attention arithmetic at 2e-5 in float32;
its CUDA kernel is held against the plain version in a ``cuda``-marked
test.  The switch is set through ``monkeypatch`` only.
"""
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
from repro_torch.kernels import decode_attention as da
from repro_torch.models import attention as pt_attn
from repro_torch.models import build

ARCH = "qwen1.5-4b"
B, S, EXTRA = 2, 32, 3
ATOL = 1e-4


def _quantize_both(x: np.ndarray):
    want = ref_attn.quantize_kv(jnp.asarray(x))
    got = pt_attn.quantize_kv(torch.from_numpy(x))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_kv_is_the_reference_bitwise(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 17, 4, 64)) * 2).astype(np.float32)
    if dtype == "bfloat16":
        want = ref_attn.quantize_kv(jnp.asarray(x, jnp.bfloat16))
        got = pt_attn.quantize_kv(torch.from_numpy(x).to(torch.bfloat16))
        want, got = [np.asarray(w) for w in want], [g.numpy() for g in got]
    else:
        want, got = _quantize_both(x)
    assert got[0].dtype == np.int8 and got[1].dtype == np.float32
    assert got[1].shape == x.shape[:-1] + (1,)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_quantize_kv_rounds_exact_halves_to_even():
    # amax 127 gives a scale of 1 + 1e-12 == 1.0f: x / scale is x
    halves = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 0.0,
                        -126.5, 126.5, 5.5]], np.float32)
    want, got = _quantize_both(halves)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        got[0][0], [127, 0, 2, 2, 0, -2, -2, 4, 0, -126, 126, 6])
    zeros = np.zeros((2, 8), np.float32)
    want, got = _quantize_both(zeros)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not got[0].any()


@pytest.fixture(scope="module")
def rig():
    cfg = reduced(get_config(ARCH))
    ref = ref_build(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    pcfg = pt_reduced(pt_get_config(ARCH))
    port = build(pcfg)
    pparams = model_params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(B, S + EXTRA)).astype(np.int32)
    return ref, params, port, pparams, toks


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _check_caches(pc, rc, rtol=1e-5):
    for i, layer in enumerate(pc):
        assert set(layer) == {"k", "k_scale", "v", "v_scale"}
        for name, got in layer.items():
            want = np.asarray(rc["stack"][0][name][i])
            assert got.shape == want.shape and got.numpy().dtype == want.dtype
            if name.endswith("scale"):
                np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                                           atol=0)
                continue
            # a projection a last bit apart can cross a rounding half:
            # a code may then differ by one step, and rarely does
            diff = np.abs(got.numpy().astype(np.int32) - want)
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def _port_cache(rc):
    """The reference's int8 cache as the port's list of layer dicts."""
    return [{name: torch.from_numpy(np.array(t[i]))
             for name, t in rc["stack"][0].items()}
            for i in range(rc["stack"][0]["k"].shape[0])]


def test_int8_prefill_and_decode_match_reference(rig, monkeypatch):
    """The prefill's logits at 1e-4.  Each decode step is held at 1e-3,
    from the reference's cache (its written rows against the
    reference's) and from the port's own: a new row's activations a few
    ulps apart can put one of its codes a step apart, which moves a
    logit by up to 2.4e-4 (measured); the attention over equal codes is
    held at 2e-5 below."""
    monkeypatch.setenv("REPRO_KV_INT8", "1")
    ref, params, port, pparams, toks = rig
    want, rc = ref.prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                           S + EXTRA)
    with torch.inference_mode():
        got, pc = port.prefill(pparams, {"tokens": _t(toks[:, :S])},
                               S + EXTRA)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    _check_caches(pc, rc)
    lens = jnp.full((B,), S, jnp.int32)
    plens = torch.full((B,), S, dtype=torch.int32)
    for t in range(EXTRA):
        tok = toks[:, S + t:S + t + 1]
        forced = _port_cache(rc)
        want, rc = ref.decode_step(params, jnp.asarray(tok), rc, lens)
        with torch.inference_mode():
            got, forced = port.decode_step(pparams, _t(tok), forced, plens)
            free, pc = port.decode_step(pparams, _t(tok), pc, plens)
        for logits in (got, free):
            np.testing.assert_allclose(logits.numpy(), np.asarray(want),
                                       rtol=0, atol=10 * ATOL)
        # a code a step apart upstream moves the later layers' new rows
        _check_caches(forced, rc, rtol=1e-4)
        lens, plens = lens + 1, plens + 1


def test_int8_decode_within_the_reference_gate_of_the_float_cache(
        rig, monkeypatch):
    _, _, port, pparams, toks = rig
    with torch.inference_mode():
        full, _ = port.forward(pparams, {"tokens": _t(toks[:, :S + 1])})
        monkeypatch.setenv("REPRO_KV_INT8", "1")
        _, cache = port.prefill(pparams, {"tokens": _t(toks[:, :S])}, S + 1)
        lg, _ = port.decode_step(pparams, _t(toks[:, S:S + 1]), cache,
                                 torch.full((B,), S, dtype=torch.int32))
    err = float((lg[:, 0] - full[:, S]).abs().max())
    assert 0 < err < 0.1, err


def test_cache_dtypes_and_scale_shapes(monkeypatch):
    cfg = pt_reduced(pt_get_config(ARCH))
    monkeypatch.setenv("REPRO_KV_INT8", "1")
    cache = build(cfg).init_cache(3, 9, device="cpu")
    assert len(cache) == cfg.num_layers
    shape = (3, 9, cfg.num_kv_heads, cfg.head_dim)
    for layer in cache:
        assert layer["k"].dtype == layer["v"].dtype == torch.int8
        assert tuple(layer["k"].shape) == tuple(layer["v"].shape) == shape
        for name in ("k_scale", "v_scale"):
            assert layer[name].dtype == torch.float32
            assert tuple(layer[name].shape) == shape[:3] + (1,)
    monkeypatch.delenv("REPRO_KV_INT8")
    plain = build(cfg).init_cache(3, 9, device="cpu")
    assert set(plain[0]) == {"k", "v"} and plain[0]["k"].dtype == torch.float32


def _int8_inputs(b, s, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32) * 2
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    kq, ks = ref_attn.quantize_kv(jnp.asarray(k))
    vq, vs = ref_attn.quantize_kv(jnp.asarray(v))
    return q, [np.asarray(t) for t in (kq, ks, vq, vs)]


def _reference_int8_attention(q, cache, lengths, window):
    """The reference's int8 ``gqa_decode`` attention, written with its own
    helpers (``_gqa_scores``, ``_mask``, ``_masked_softmax``,
    ``_gqa_out``) on a cache that already holds the new token."""
    kq, ks, vq, vs = (jnp.asarray(t) for t in cache)
    qj = jnp.asarray(q)[:, None]                        # (B, 1, H, hd)
    g = q.shape[1] // kq.shape[2]
    sc = ref_attn._gqa_scores(qj, kq.astype(qj.dtype))
    ksc = jnp.repeat(ks[..., 0], g, axis=2)
    sc = sc * ksc.transpose(0, 2, 1)[:, None, :, :]
    mask = ref_attn._mask(jnp.asarray(lengths)[:, None],
                          jnp.arange(kq.shape[1])[None, :], causal=True,
                          window=window, kv_len=None)
    p = ref_attn._masked_softmax(sc, mask[:, :, None, :])
    vsc = jnp.repeat(vs[..., 0], g, axis=2)
    p = p * vsc.transpose(0, 2, 1)[:, None, :, :]
    return np.asarray(ref_attn._gqa_out(p, vq.astype(qj.dtype))[:, 0])


@pytest.mark.parametrize("case", [
    # (b, s, h, kv, hd, lengths, window)
    (4, 37, 4, 4, 32, [0, 5, 36, 20], 0),
    (3, 50, 8, 2, 32, [-1, 49, 10], 0),
    (5, 64, 6, 3, 64, [63, 64, 69, 7, 30], 0),
    (2, 40, 4, 2, 32, [39, 25], 9),
])
def test_int8_attention_matches_reference_arithmetic(case):
    b, s, h, kv, hd, lengths, window = case
    q, cache = _int8_inputs(b, s, h, kv, hd, seed=b * s)
    want = _reference_int8_attention(q, cache, np.int32(lengths), window)
    t = [torch.from_numpy(np.array(a)) for a in cache]
    lens = torch.tensor(lengths, dtype=torch.int32)
    got = da.decode_attention_int8(torch.from_numpy(q), t[0], t[1], t[2],
                                   t[3], lens, window=window)
    assert da.decode_attention_int8.launches == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    empty = np.asarray(lengths) < 0
    assert not got.numpy()[empty].any()


def test_int8_attention_refuses_a_float_cache_and_bad_scales():
    q, cache = _int8_inputs(2, 9, 4, 2, 32, seed=1)
    kq, ks, vq, vs = (torch.from_numpy(np.array(a)) for a in cache)
    lens = torch.tensor([3, 8], dtype=torch.int32)
    qt = torch.from_numpy(q)
    with pytest.raises(ValueError, match="int8 codes"):
        da.decode_attention_int8(qt, kq.float(), ks, vq, vs, lens)
    with pytest.raises(ValueError, match="scales"):
        da.decode_attention_int8(qt, kq, ks[..., 0], vq, vs, lens)
    with pytest.raises(ValueError, match="scales"):
        da.decode_attention_int8(qt, kq, ks.double(), vq, vs, lens)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        da.decode_attention(qt, kq, vq, lens)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_int8_decode_matches_plain(dtype):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    for b, s, h, kv, hd, window in [(4, 37, 16, 16, 64, 0),
                                    (5, 300, 24, 8, 128, 20),
                                    (1, 1057, 16, 16, 64, 0),
                                    (3, 161, 8, 8, 32, 0)]:
        q = torch.randn(b, h, hd, device="cuda", generator=g).to(dtype)
        k, v = (torch.randn(b, s, kv, hd, device="cuda", generator=g)
                for _ in range(2))
        kq, ks = pt_attn.quantize_kv(k)
        vq, vs = pt_attn.quantize_kv(v)
        lens = torch.randint(-1, s + 6, (b,), device="cuda", generator=g,
                             dtype=torch.int32)
        n = da.decode_attention_int8.launches
        got = da.decode_attention_int8(q, kq, ks, vq, vs, lens,
                                       window=window)
        again = da.decode_attention_int8(q, kq, ks, vq, vs, lens,
                                         window=window)
        torch.cuda.synchronize()
        assert da.decode_attention_int8.launches == n + 2
        assert torch.equal(got, again)
        want = da.decode_attention_int8_plain(q, kq, ks, vq, vs, lens,
                                              window=window)
        err = float((got.float() - want.float()).abs().max())
        assert err <= (2e-2 if dtype == torch.bfloat16 else 2e-5)
