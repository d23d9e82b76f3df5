"""The port's engine ops (repro_torch.core.engine) against the
reference's (repro.core.engine, vmapped over points) on the same numpy
arrays, and the port's counter-based random streams (core.prng).

Data movement and integer arithmetic match bit for bit.  Random draws
cannot match jax.random's bits; they are held to Threefry's published
known-answer vectors and to their distributions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.core import engine as ref_engine
from repro_torch.core import engine as pt_engine
from repro_torch.core import prng
from repro_torch.core.sweep import _GAMMA_TRIES, _MISC_WORDS, _gamma

# the test workers run side by side: one intra-op thread each keeps
# torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

P, N = 5, 40


def _buf(seed=0):
    return np.random.default_rng(seed).normal(size=(P, N)).astype(
        np.float32)


def test_fifo_append_bitwise():
    buf = _buf()
    pos = np.array([0, 3, 17, 20, 30], np.int32)
    block = np.random.default_rng(1).normal(size=(P, 10)).astype(
        np.float32)
    want = jax.vmap(ref_engine.fifo_append)(
        jnp.asarray(buf), jnp.asarray(pos), jnp.asarray(block))
    got = pt_engine.fifo_append(torch.from_numpy(buf.copy()),
                                torch.from_numpy(pos),
                                torch.from_numpy(block))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_fifo_append_past_the_buffer_raises():
    buf = torch.zeros(2, 8)
    with pytest.raises(RuntimeError):
        pt_engine.fifo_append(buf, torch.tensor([0, 5], dtype=torch.int32),
                              torch.ones(2, 4))


@pytest.mark.parametrize("max_shift", [10, N])
def test_fifo_pop_shift_bitwise(max_shift):
    buf = _buf(2)
    k = np.array([0, 1, 7, max_shift, max_shift // 2], np.int32)
    want = jax.vmap(lambda b, kk: ref_engine.fifo_pop_shift(
        b, kk, max_shift))(jnp.asarray(buf), jnp.asarray(k))
    got = pt_engine.fifo_pop_shift(torch.from_numpy(buf),
                                   torch.from_numpy(k), max_shift)
    want = np.asarray(want)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_accept_window_bitwise():
    count = np.array([0, 5, 40, 7, 100], np.int32)
    q = np.array([0, 60, 10, 64, 1], np.int32)
    want = jax.vmap(lambda c, qq: ref_engine.accept_window(c, qq, 64))(
        jnp.asarray(count), jnp.asarray(q))
    got = pt_engine.accept_window(torch.from_numpy(count),
                                  torch.from_numpy(q), 64)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_welford_block_bitwise():
    rng = np.random.default_rng(3)
    bm_ref = (jnp.zeros(P, jnp.float32), jnp.zeros(P, jnp.float32),
              jnp.zeros(P, jnp.int32))
    bm_pt = (torch.zeros(P), torch.zeros(P),
             torch.zeros(P, dtype=torch.int32))
    # op by op: under jit XLA contracts m2 + delta·(x − mean1) into one
    # fused multiply-add, which rounds once where the op sequence rounds
    # twice
    step = jax.vmap(ref_engine.welford_block)
    for _ in range(20):
        d_sum = (rng.random(P) * 50).astype(np.float32)
        d_n = rng.integers(0, 4, P).astype(np.int32)   # some empty blocks
        bm_ref = step(bm_ref, jnp.asarray(d_sum), jnp.asarray(d_n))
        bm_pt = pt_engine.welford_block(bm_pt, torch.from_numpy(d_sum),
                                        torch.from_numpy(d_n))
    for g, w in zip(bm_pt, bm_ref):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", range(4))
def test_capacity_helpers_equal_reference(case):
    rng = np.random.default_rng(case)
    lam = rng.uniform(0.5, 6.0, 20)
    alpha = rng.choice([0.1, 0.1438, 0.25], 20)
    tau0 = rng.choice([0.75, 1.8874, 3.0], 20)
    b_max = rng.choice([0, 8, 32, 128], 20)
    wait = rng.choice([0.0, 0.0, 2.0, 5.0], 20)
    assert pt_engine.queue_capacity(lam, alpha, tau0, b_max, wait) \
        == ref_engine.queue_capacity(lam, alpha, tau0, b_max, wait)
    window = alpha * np.maximum(b_max, 1) + tau0
    assert pt_engine.window_capacity(lam, window) \
        == ref_engine.window_capacity(lam, window)


def test_row_sum_is_independent_of_the_row_count():
    x = torch.from_numpy(np.random.default_rng(4).lognormal(
        0, 2, (9, 37)).astype(np.float32))
    whole = pt_engine.row_sum(x)
    for i in range(x.shape[0]):
        assert torch.equal(pt_engine.row_sum(x[i:i + 1])[0], whole[i])
    np.testing.assert_allclose(whole.numpy(),
                               x.double().sum(1).numpy(), rtol=1e-5)


def test_exp_offsets_are_partial_sums_independent_of_the_point_count():
    e = np.random.default_rng(5).exponential(size=(4, 33, P)).astype(
        np.float32)
    rate = np.array([0.5, 1.0, 2.0, 3.0, 7.0], np.float32)
    got = pt_engine.exp_offsets(torch.from_numpy(e), torch.from_numpy(rate))
    for p in range(P):
        alone = pt_engine.exp_offsets(torch.from_numpy(e[..., p:p + 1]),
                                      torch.from_numpy(rate[p:p + 1]))
        assert torch.equal(alone[..., 0], got[..., p])
    want = np.cumsum(e.astype(np.float64), axis=1) / rate
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# counter-based streams
# ---------------------------------------------------------------------------

def _np_threefry(k0, k1, x0, x1):
    """Threefry-2x32-20 in numpy uint32 — an independent re-statement."""
    k0, k1, x0, x1 = (np.asarray(v, np.uint32) for v in (k0, k1, x0, x1))
    with np.errstate(over="ignore"):
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
        x0, x1 = x0 + k0, x1 + k1
        rots = [(13, 15, 26, 6), (17, 29, 16, 24)]
        for g in range(5):
            for r in rots[g % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(g + 1) % 3]
            x1 = x1 + ks[(g + 2) % 3] + np.uint32(g + 1)
    return x0, x1


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32))


@pytest.mark.parametrize("vec", [
    ((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
    ((0xffffffff,) * 2, (0xffffffff,) * 2, (0x1cb996fc, 0xbb002be7)),
    ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
     (0xc4923a9c, 0x483df7a0)),
], ids=["zeros", "ones", "pi"])
def test_threefry_known_answers(vec):
    (k0, k1), (c0, c1), want = vec
    got = prng.threefry2x32(_t([k0]), _t([k1]), _t([c0]), _t([c1]))
    assert [int(g.numpy().view(np.uint32)[0]) for g in got] == list(want)


def test_threefry_matches_numpy_restatement():
    rng = np.random.default_rng(6)
    args = [rng.integers(0, 2 ** 32, 1000, dtype=np.uint64)
            .astype(np.uint32) for _ in range(4)]
    got = prng.threefry2x32(*[_t(a) for a in args])
    want = _np_threefry(*args)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.uint32), w)


def test_point_stream_depends_only_on_global_index():
    streams = ((0, _MISC_WORDS), (1, 49))
    whole = prng.draw_words(prng.point_keys(11, 0, 12, "cpu"), 64, 32,
                            streams)
    part = prng.draw_words(prng.point_keys(11, 5, 3, "cpu"), 64, 32,
                           streams)
    for w, p in zip(whole, part):
        assert torch.equal(w[..., 5:8], p)
    # a stream's first words do not change when it is asked for more
    longer = prng.draw_words(prng.point_keys(11, 0, 12, "cpu"), 64, 32,
                             ((1, 200),))
    assert torch.equal(longer[0][:, :49], whole[1])
    # nor does one stream change when another is drawn beside it
    alone = prng.draw_words(prng.point_keys(11, 0, 12, "cpu"), 64, 32,
                            ((1, 49),))
    assert torch.equal(alone[0], whole[1])
    other_seed = prng.draw_words(prng.point_keys(12, 0, 12, "cpu"), 64,
                                 32, streams)
    assert not torch.equal(other_seed[1], whole[1])


def test_exponential_draws_pass_ks():
    words = prng.draw_words(prng.point_keys(3, 0, 4, "cpu"), 0, 64,
                            ((1, 256),))[0]
    e = prng.exponential(words).double().numpy().ravel()
    assert e.min() > 0.0
    assert stats.kstest(e, "expon").pvalue > 1e-3
    u = prng.uniform(words).double().numpy().ravel()
    assert 0.0 < u.min() and u.max() < 1.0
    assert stats.kstest(u, "uniform").pvalue > 1e-3


@pytest.mark.parametrize("cv", [0.5, 1.5])
def test_gamma_mean_and_variance(cv):
    k = 1.0 / (cv * cv)
    n_pts, n_steps = 64, 512
    words = prng.draw_words(prng.point_keys(4, 0, n_pts, "cpu"), 0,
                            n_steps, ((0, _MISC_WORDS),))[0]
    kt = torch.full((n_pts,), k, dtype=torch.float32)
    g = (_gamma(words, kt) / kt).double().numpy().ravel()
    n = g.size
    # Gamma(k)/k has mean 1 and variance 1/k = cv²
    assert abs(g.mean() - 1.0) < 4.0 * cv / np.sqrt(n)
    assert g.var() == pytest.approx(cv * cv, rel=0.05)
    assert stats.kstest(g, stats.gamma(k, scale=1.0 / k).cdf).pvalue > 1e-3
    assert _GAMMA_TRIES == 8
