"""B3's backward on the CPU: ``flash_attention_backward_plain`` (the
explicit formula from the forward's ``out`` and ``lse``) against
autograd of ``flash_attention_plain`` and against ``jax.vjp`` of the
reference's ``sdpa`` under its ``_mask``, at 1e-5, in every mode the
forward takes: causal, windowed, unmasked with a key length of its own,
GQA groups, MLA's (192, 128) width pair, a ragged length and a length
past ``Q_CHUNK``; zero gradients on a row with no admitted key; the
``lse`` the kernel is asked for against the reference's log-sum-exp.
The kernel's own cases need the card and live in
``tests/test_torch_flash_backward_cuda.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import _mask, sdpa
from repro_torch.kernels.flash_attention import (
    Q_CHUNK, flash_attention, flash_attention_backward,
    flash_attention_backward_plain, flash_attention_lse_plain,
    flash_attention_plain, flash_attention_with_lse)

TOL = 1e-5
# (B, S, H, KV, hd, hdv, causal, window, S_k)
CASES = {
    "causal": (2, 33, 4, 4, 16, 16, True, 0, 0),
    "windowed": (2, 40, 4, 2, 16, 16, True, 7, 0),
    "unmasked_window": (1, 29, 2, 2, 16, 16, False, 9, 0),
    "cross_sk": (2, 7, 4, 4, 16, 16, False, 0, 45),
    "gqa": (1, 24, 8, 2, 32, 32, True, 0, 0),
    "mla_pair": (1, 21, 2, 2, 48, 32, True, 0, 0),
    "ragged": (2, 37, 2, 1, 8, 8, True, 0, 0),
    "past_q_chunk": (1, Q_CHUNK + 37, 1, 1, 8, 8, True, 0, 0),
}


def _inputs(b, s, h, kv, hd, hdv, sk, seed=0):
    rng = np.random.default_rng(seed)
    sk = sk or s
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, hdv)).astype(np.float32)
    do = rng.standard_normal((b, s, h, hdv)).astype(np.float32)
    return q, k, v, do


def _reference(q, k, v, do, causal, window):
    s, sk = q.shape[1], k.shape[1]
    mask = _mask(jnp.arange(s), jnp.arange(sk), causal=causal,
                 window=window, kv_len=None)
    out, vjp = jax.vjp(lambda a, b, c: sdpa(a, b, c, mask[None]),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= TOL * scale, f"{what}: max |diff| {err} (scale {scale})"


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_autograd_and_the_reference_vjp(name):
    b, s, h, kv, hd, hdv, causal, window, sk = CASES[name]
    q, k, v, do = _inputs(b, s, h, kv, hd, hdv, sk)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = flash_attention_plain(qt, kt, vt, causal=causal, window=window)
    auto = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    lse = flash_attention_lse_plain(qt.detach(), kt.detach(),
                                    causal=causal, window=window)
    plain = flash_attention_backward_plain(
        qt.detach(), kt.detach(), vt.detach(), out.detach(), lse,
        torch.from_numpy(do), causal=causal, window=window)
    ref_out, ref_grads = _reference(q, k, v, do, causal, window)
    _close(out.detach().numpy(), ref_out, f"{name}: forward")
    for what, p, a, r in zip("qkv", plain, auto, ref_grads):
        assert p.dtype == torch.float32 and p.shape == a.shape
        _close(p.numpy(), a.numpy(), f"{name}: d{what} vs autograd")
        _close(p.numpy(), r, f"{name}: d{what} vs jax.vjp(sdpa)")


@pytest.mark.parametrize("name", ["causal", "windowed", "cross_sk",
                                  "mla_pair"])
def test_lse_is_the_reference_log_sum_exp(name):
    b, s, h, kv, hd, hdv, causal, window, sk = CASES[name]
    q, k, _, _ = _inputs(b, s, h, kv, hd, hdv, sk)
    g = h // kv
    sc = np.einsum("bskgh,btkh->bkgst", q.reshape(b, s, kv, g, hd),
                   k).astype(np.float64) * hd ** -0.5
    mask = np.asarray(_mask(jnp.arange(s), jnp.arange(k.shape[1]),
                            causal=causal, window=window, kv_len=None))
    want = np.log(np.where(mask, np.exp(sc), 0.0).sum(-1)).reshape(b, h, s)
    got = flash_attention_lse_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_a_row_with_no_admitted_key_has_zero_gradients(causal):
    """A negative window admits no key on some rows (every row when
    causal): their output, lse and gradients are 0, +inf and 0, not
    NaN."""
    q, k, v, do = _inputs(2, 20, 2, 2, 8, 8, 0)
    window = -3
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = flash_attention_plain(qt, kt, vt, causal=causal, window=window)
    lse = flash_attention_lse_plain(qt.detach(), kt.detach(),
                                    causal=causal, window=window)
    empty = torch.isinf(lse)                       # (B, H, S)
    assert bool(empty.any()) and bool(empty.all()) == causal
    rows = empty.permute(0, 2, 1)                  # (B, S, H)
    assert bool((out.detach()[rows] == 0).all())
    dq, dk, dv = flash_attention_backward_plain(
        qt.detach(), kt.detach(), vt.detach(), out.detach(), lse,
        torch.from_numpy(do), causal=causal, window=window)
    for g in (dq, dk, dv):
        assert bool(torch.isfinite(g).all())
    assert bool((dq[rows] == 0).all())
    auto = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    for p, a in zip((dq, dk, dv), auto):
        _close(p.numpy(), a.numpy(), "no admitted key: vs autograd")
    if causal:
        assert all(bool((g == 0).all()) for g in (dq, dk, dv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrappers_take_the_plain_versions(dtype):
    """On CPU tensors ``flash_attention_with_lse`` and
    ``flash_attention_backward`` are the plain versions, in the inputs'
    dtype, and ``flash_attention`` keeps autograd of the plain forward
    (no backward launch counted)."""
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _inputs(1, 19, 4, 2, 16, 16, 0, seed=3))
    before = flash_attention.backward_launches
    out, lse = flash_attention_with_lse(q, k, v, window=5)
    assert torch.equal(out, flash_attention_plain(q, k, v, window=5))
    assert torch.equal(lse, flash_attention_lse_plain(q, k, window=5))
    grads = flash_attention_backward(q, k, v, out, lse, do, window=5)
    want = flash_attention_backward_plain(q, k, v, out, lse, do, window=5)
    for g, w, t in zip(grads, want, (q, k, v)):
        assert g.dtype == dtype and torch.equal(g, w)
    qg = q.clone().requires_grad_(True)
    flash_attention(qg, k, v, window=5).float().sum().backward()
    assert qg.grad is not None and qg.grad.dtype == dtype
    assert flash_attention.backward_launches == before


def test_causal_with_another_key_length_is_refused():
    q, k, v, do = _inputs(1, 8, 2, 2, 8, 8, 12)
    out = torch.zeros(1, 8, 2, 8)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="causal"):
        flash_attention_backward_plain(
            *(torch.from_numpy(a) for a in (q, k, v)), out, lse,
            torch.from_numpy(do), causal=True)
