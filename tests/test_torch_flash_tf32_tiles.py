"""The arithmetic of B3's float32 kernels (``flash_attention`` and its
backward on float32 inputs), on the CPU.

The float32 kernels of ``csrc/flash_attention.cu`` and
``csrc/flash_attention_backward.cu`` run on the TF32 tensor cores as
3xTF32: each float32 operand x is split into ``big``, x rounded to TF32
(``cvt.rna.tf32.f32``'s rounding: to nearest, ties away from zero, the
low 13 bits cleared; the kernels add half an ulp and mask), and ``small
= x - big``, which the tensor cores read truncated to TF32; every
product is summed as small·big + big·small + big·big in float32, which
keeps about 21 bits of each product.  A test-local emulation of the
kernels is held here against the plain versions at the card's float32
gates (2e-5 absolute on the output, 2e-5 of each gradient's largest
magnitude):

- the rounding itself, by integer bit operations;
- the m16n8k8 fragment layouts, and the key relabelling that lets the
  accumulators of one product (C) serve as the A operand of the next
  (A's k-index c is key 2c, c + 4 is key 2c + 1, so B reads rows 2c and
  2c + 1);
- the forward's tile walk (64-row query tiles, 64-key tiles, masks only
  on the tiles the mask cuts, the online softmax with ``ex2`` of one
  fma), and the split key axis with its merge of (m, l, acc) into the
  output and ``lse``;
- the backward's two walks (dK/dV over key tiles, dQ over query tiles);

over causal, windowed (also a negative window), unmasked with a key
length of its own (32 queries over 1,500 keys), GQA, ragged lengths and
MLA's (192, 128) pair, at small batch; at one shape also against the
JAX reference's Pallas kernel in interpret mode.  And one case shows
that a single TF32 term (big·big alone) misses the gate.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as fa

TILE = 64
GATE = 2e-5
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
NEG_INF = np.float32(fa.NEG_INF)


# ------------------------------------------------------------ rounding

def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on finite float32 values: add half of the
    dropped part to the magnitude bits (a tie goes away from zero) and
    clear the low 13 bits."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncated(x: torch.Tensor) -> torch.Tensor:
    """A float32 value as the tensor cores read a TF32 operand: its low
    13 bits dropped."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)


def split(x: torch.Tensor):
    """The kernels' split: ``big`` rounded, ``small = x - big`` (exact)
    as the tensor cores read it."""
    big = tf32(x)
    return big, truncated(x - big)


def mm(eq: str, a: torch.Tensor, b: torch.Tensor, terms: int = 3):
    """The float32 product ``einsum(eq, a, b)`` as the kernels form it:
    3xTF32 (small·big + big·small + big·big), or one TF32 term."""
    (ab, asm), (bb, bsm) = split(a), split(b)
    if terms == 1:
        return torch.einsum(eq, ab, bb)
    return (torch.einsum(eq, asm, bb) + torch.einsum(eq, ab, bsm)
            + torch.einsum(eq, ab, bb))


def fma_exp2(x, c, base):
    """``ex2(fma(x, c, -base))`` in float32: the product exact in
    float64, one rounding to float32."""
    arg = (x.double() * float(c) - base.double()).float()
    return torch.exp2(arg)


def test_tf32_rounding_is_rna_on_the_bits():
    """Ties go away from zero, the rest to nearest; the result has 10
    explicit mantissa bits; the split keeps x to ~2^-21."""
    ulp = 2.0 ** -10                       # tf32's ulp at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 3 * ulp / 2, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, -0.0],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    assert torch.equal(truncated(x), torch.tensor(
        [1.0, -1.0, 1.0, 1 + ulp, 3.0, -0.0], dtype=torch.float32))
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(10_000)
                         .astype(np.float32))
    big, small = split(r)
    assert (big.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (small.view(torch.int32) & 0x1FFF).eq(0).all()
    rel = ((big.double() + small.double() - r.double()).abs()
           / r.double().abs()).max()
    assert float(((big - r).abs() / r.abs()).max()) <= 2.0 ** -11
    assert float(rel) <= 2.0 ** -21


# ----------------------------------------------------------- fragments

def _lanes():
    lane = torch.arange(32)
    return lane // 4, lane % 4


def _c_coords():
    """C/D of mma.m16n8k8 (16 x 8): c0, c1 = (g, 2c..2c+1), c2, c3 =
    (g + 8, 2c..2c+1)."""
    g, c = _lanes()
    return (torch.stack([g, g, g + 8, g + 8], 1),
            torch.stack([2 * c, 2 * c + 1, 2 * c, 2 * c + 1], 1))


def _a_coords():
    """A (16 x 8, row, tf32): a0 = (g, c), a1 = (g + 8, c), a2 = (g,
    c + 4), a3 = (g + 8, c + 4)."""
    g, c = _lanes()
    return (torch.stack([g, g + 8, g, g + 8], 1),
            torch.stack([c, c, c + 4, c + 4], 1))


def _b_coords():
    """B (8 x 8, col, tf32): b0 = (k c, n g), b1 = (k c + 4, n g)."""
    g, c = _lanes()
    return torch.stack([c, c + 4], 1), torch.stack([g, g], 1)


def _mma(a_regs, b_regs):
    """D = A · B of one m16n8k8 from each lane's registers, returned as
    each lane's D registers."""
    a = torch.zeros(16, 8, dtype=torch.float64)
    b = torch.zeros(8, 8, dtype=torch.float64)
    a[_a_coords()] = a_regs
    b[_b_coords()] = b_regs
    return (a @ b)[_c_coords()]


def test_c_fragment_feeds_the_next_product_by_relabelling_keys():
    """The scores' C registers (s0, s1, s2, s3) go in as A (a0, a1, a2,
    a3) = (s0, s2, s1, s3), so A's k-index c holds key 2c and c + 4 key
    2c + 1; B then reads V's rows 2c and 2c + 1 at column g, as the
    kernels index it (``vt[(8 j + 2 c + e) * stride + 8 d + g]``).  The
    same mapping serves P·V in the forward, Pᵀ·dO and dSᵀ·q in the
    dK/dV kernel and dS·K in the dQ kernel.  Q·Kᵀ's own operands load in
    the natural order: A (g, 8 kk + c), B (key 8 j + g, column 8 kk +
    c)."""
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.standard_normal((16, 8)))
    v = torch.from_numpy(rng.standard_normal((8, 8)))
    rows, cols = _c_coords()
    s_regs = p[rows, cols]
    a_regs = s_regs[:, [0, 2, 1, 3]]
    g, c = _lanes()
    b_regs = torch.stack([v[2 * c, g], v[2 * c + 1, g]], 1)
    assert torch.allclose(_mma(a_regs, b_regs), (p @ v)[rows, cols])
    # Q·Kᵀ: q (16 rows x 8 of hd), k (8 keys x 8 of hd), natural order
    q = torch.from_numpy(rng.standard_normal((16, 8)))
    k = torch.from_numpy(rng.standard_normal((8, 8)))
    a_rows, a_cols = _a_coords()
    qa = q[a_rows, a_cols]
    kb = torch.stack([k[g, c], k[g, c + 4]], 1)
    assert torch.allclose(_mma(qa, kb), (q @ k.T)[rows, cols])
    # the plain (unrelabelled) use of C as A is wrong: the check bites
    assert not torch.allclose(_mma(s_regs, b_regs), (p @ v)[rows, cols])


# ------------------------------------------------------------- inputs

def _inputs(seed, b, s, h, kv, hd, hdv, sk):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((b, s, h, hd), (b, sk, kv, hd),
                                   (b, sk, kv, hdv), (b, s, h, hdv)))


def _rows(t, r0, n, axis=1, rows=TILE):
    """Rows ``r0 … r0 + rows`` of ``t`` along ``axis``, zero past ``n``
    (the kernels' zero-filled copies)."""
    part = t.narrow(axis, r0, max(0, min(rows, n - r0)))
    pad = rows - part.shape[axis]
    if pad:
        shape = list(part.shape)
        shape[axis] = pad
        part = torch.cat([part, part.new_zeros(shape)], dim=axis)
    return part


def _admit(pq, pk, s, sk, causal, window):
    ok = (pq < s) & (pk < sk)
    if causal:
        ok &= pk <= pq
    if window:
        ok &= pq - pk < window
    return ok


def _key_range(q0, sk, causal, window):
    """Keys any row of the query tile at ``q0`` admits: [lo, hi)."""
    hi = min(sk, q0 + TILE) if causal else sk
    lo = min(sk, max(0, q0 - window + 1)) if window else 0
    return lo, hi


def _scale_log2(hd):
    return np.float32(np.float32(hd ** -0.5) * LOG2E)


# ------------------------------------------------------------ forward

def _tile_forward(q, k, v, causal, window, splits=1, terms=3):
    """out and lse as the float32 kernel computes them: per 64-row
    query tile, its key range cut into ``splits`` pieces of whole
    64-key tiles from the range's start; per piece the online softmax
    (m, l, acc), masks on cut tiles only, ``p = ex2(fma(s, c, -m c))``;
    then the merge of the pieces in split order."""
    b, s, h, hd = q.shape
    sk, kvh, hdv = k.shape[1], k.shape[2], v.shape[3]
    g = h // kvh
    c = _scale_log2(hd)
    kh, vh = (t.repeat_interleave(g, dim=2) for t in (k, v))
    key_tiles = -(-sk // TILE)
    chunk = -(-key_tiles // splits) * TILE           # keys a piece
    ar = torch.arange(TILE)
    out = torch.zeros(b, s, h, hdv)
    lse = torch.zeros(b, h, s)
    for q0 in range(0, s, TILE):
        lo, hi = _key_range(q0, sk, causal, window)
        qt = _rows(q, q0, s)
        parts = []
        for z in range(splits):
            p_lo, p_hi = lo + z * chunk, min(hi, lo + (z + 1) * chunk)
            m = torch.full((b, h, TILE), float(NEG_INF))
            l = torch.zeros(b, h, TILE)
            acc = torch.zeros(b, h, TILE, hdv)
            for t0 in range(p_lo, p_hi, TILE):
                cut = (t0 + TILE > sk or (causal and t0 + TILE - 1 > q0)
                       or (window and t0 <= q0 + TILE - 1 - window))
                kt, vt = _rows(kh, t0, sk), _rows(vh, t0, sk)
                st = mm("bqhd,bkhd->bhqk", qt, kt, terms)
                if cut:
                    ok = _admit((q0 + ar)[:, None], (t0 + ar)[None, :],
                                1 << 30, sk, causal, window)
                    st = torch.where(ok, st, float(NEG_INF))
                mx = torch.maximum(m, st.amax(-1))
                base = torch.where(mx == NEG_INF, 0.0,
                                   (mx.double() * float(c)).float())
                alpha = fma_exp2(m, c, base)
                p = fma_exp2(st, c, base[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + mm("bhqk,bkhd->bhqd", p, vt,
                                                  terms)
                m = mx
            # the partial's max in log2 units, NEG_INF where nothing
            # was admitted
            mp = torch.where(m == NEG_INF, float(NEG_INF),
                             (m.double() * float(c)).float())
            parts.append((mp, l, acc))
        if splits == 1:
            mp, l, acc = parts[0]
        else:
            top = torch.stack([p_[0] for p_ in parts]).amax(0)
            l = torch.zeros(b, h, TILE)
            acc = torch.zeros(b, h, TILE, hdv)
            for mp_s, l_s, acc_s in parts:
                w = torch.exp2(mp_s - top)
                l = l + w * l_s
                acc = acc + w[..., None] * acc_s
            mp = top
        n = min(TILE, s - q0)
        o = acc / (l + 1e-30)[..., None]
        out[:, q0:q0 + n] = o[:, :, :n].transpose(1, 2)
        row_lse = torch.where(l > 0, (mp + torch.log2(l)) * LN2, torch.inf)
        lse[:, :, q0:q0 + n] = row_lse[:, :, :n]
    return out, lse


# (b, s, h, kv, hd, hdv, causal, window, sk, splits)
FORWARD = {
    "causal": (2, 130, 4, 4, 64, 64, True, 0, 0, 1),
    "causal_split": (1, 130, 4, 4, 64, 64, True, 0, 0, 3),
    "windowed_gqa": (1, 150, 8, 2, 128, 128, True, 40, 0, 1),
    "windowed_gqa_split": (1, 150, 8, 2, 128, 128, True, 40, 0, 2),
    "cross": (1, 32, 2, 2, 64, 64, False, 0, 1500, 1),
    "cross_split": (1, 32, 2, 2, 64, 64, False, 0, 1500, 12),
    "cross_ragged_split": (2, 7, 2, 2, 64, 64, False, 0, 1499, 8),
    "ragged_window": (2, 61, 6, 2, 32, 32, False, 9, 0, 1),
    "negative_window": (1, 40, 2, 2, 32, 32, False, -3, 0, 1),
    "mla": (1, 77, 4, 4, 192, 128, True, 0, 0, 1),
    "mla_split": (1, 77, 4, 4, 192, 128, True, 0, 0, 2),
}


@pytest.mark.parametrize("name", list(FORWARD))
def test_forward_tiles_hold_the_float32_gate(name):
    """The kernel's tile walk in 3xTF32 (and, split, its merge) gives
    the plain output within 2e-5 and its lse within 2e-5, a row with no
    admitted key 0 and +inf."""
    b, s, h, kv, hd, hdv, causal, window, sk, splits = FORWARD[name]
    q, k, v, _ = _inputs(41, b, s, h, kv, hd, hdv, sk or s)
    mode = dict(causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, **mode)
    want_lse = fa.flash_attention_lse_plain(q, k, **mode)
    got, lse = _tile_forward(q, k, v, causal, window, splits)
    assert float((got - want).abs().max()) <= GATE / 4
    fin = torch.isfinite(want_lse)
    assert torch.equal(fin, torch.isfinite(lse))
    assert float((lse - want_lse)[fin].abs().max()) <= GATE
    assert bool((got.transpose(1, 2)[~fin] == 0).all())


def test_forward_matches_the_pallas_kernel_in_interpret_mode():
    """At one small shape, the emulation against the JAX reference's
    own Pallas kernel (``repro.kernels.flash_attention``, interpret
    mode, as its tests run it)."""
    q, k, v, _ = _inputs(42, 2, 64, 4, 2, 32, 32, 64)
    want = pallas_flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                        causal=True, window=24, bq=16, bk=16,
                        interpret=True)
    got, _ = _tile_forward(q, k, v, True, 24, splits=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=GATE)


# ----------------------------------------------------------- backward

def _tile_backward(q, k, v, out, lse, do, causal, window, terms=3):
    """dq, dk, dv as the two float32 kernels compute them: their tile
    ranges (64 resident rows; streamed steps of 64 rows, 32 at (192,
    128)), masks on cut tiles only, ``p = ex2(fma(s, c, -lse log2 e))``
    and every product in 3xTF32."""
    b, s, h, hd = q.shape
    sk, kvh, hdv = k.shape[1], k.shape[2], v.shape[3]
    g = h // kvh
    step = 32 if hd + hdv > 256 else TILE
    scale = np.float32(hd ** -0.5)
    c = _scale_log2(hd)
    kh, vh = (t.repeat_interleave(g, dim=2) for t in (k, v))
    delta = (do * out).sum(-1).transpose(1, 2)                 # (b, h, s)
    l2 = (lse.double() * float(LOG2E)).float()
    ar, sr = torch.arange(TILE), torch.arange(step)

    dk = torch.zeros(b, sk, kvh, hd)
    dv = torch.zeros(b, sk, kvh, hdv)
    for t0 in range(0, sk, TILE):
        qlo = t0 if causal else 0
        qhi = min(s, t0 + TILE - 1 + window) if window else s
        kt, vt = _rows(kh, t0, sk), _rows(vh, t0, sk)
        dka = torch.zeros(b, TILE, h, hd)
        dva = torch.zeros(b, TILE, h, hdv)
        for r0 in range(qlo, qhi, step):
            cut = (r0 + step > s or (causal and t0 + TILE - 1 > r0)
                   or (window and r0 + step - 1 - t0 >= window))
            qt, dot = _rows(q, r0, s, rows=step), _rows(do, r0, s, rows=step)
            # rows past S: zero q and dO, lse and D as copied (0)
            lt = _rows(l2, r0, s, 2, rows=step)
            dt = _rows(delta, r0, s, 2, rows=step)
            st = mm("bkhd,bqhd->bhkq", kt, qt, terms)
            p = fma_exp2(st, c, lt[:, :, None, :])
            if cut:
                ok = _admit((r0 + sr)[None, :], (t0 + ar)[:, None], s,
                            1 << 30, causal, window)
                p = torch.where(ok, p, 0.0)
            dpt = mm("bkhd,bqhd->bhkq", vt, dot, terms)
            dst = p * (dpt - dt[:, :, None, :])
            dva += mm("bhkq,bqhd->bkhd", p, dot, terms)
            dka += mm("bhkq,bqhd->bkhd", dst, qt, terms)
        n = min(TILE, sk - t0)
        dk[:, t0:t0 + n] = (dka[:, :n] * scale).reshape(
            b, n, kvh, g, hd).sum(3)
        dv[:, t0:t0 + n] = dva[:, :n].reshape(b, n, kvh, g, hdv).sum(3)

    dq = torch.zeros(b, s, h, hd)
    for q0 in range(0, s, TILE):
        lo, hi = _key_range(q0, sk, causal, window)
        qt, dot = _rows(q, q0, s), _rows(do, q0, s)
        lt = _rows(l2, q0, s, 2)
        lt = torch.where((q0 + ar < s)[None, None, :], lt, torch.inf)
        dt = _rows(delta, q0, s, 2)
        dqa = torch.zeros(b, TILE, h, hd)
        for t0 in range(lo, hi, step):
            cut = (t0 + step > sk or (causal and t0 + step - 1 > q0)
                   or (window and t0 <= q0 + TILE - 1 - window))
            kt = _rows(kh, t0, sk, rows=step)
            vt = _rows(vh, t0, sk, rows=step)
            sc = mm("bqhd,bkhd->bhqk", qt, kt, terms)
            p = fma_exp2(sc, c, lt[..., None])
            if cut:
                ok = _admit((q0 + ar)[:, None], (t0 + sr)[None, :], s, sk,
                            causal, window)
                p = torch.where(ok, p, 0.0)
            dp = mm("bqhd,bkhd->bhqk", dot, vt, terms)
            ds = p * (dp - dt[..., None])
            dqa += mm("bhqk,bkhd->bqhd", ds, kt, terms)
        n = min(TILE, s - q0)
        dq[:, q0:q0 + n] = dqa[:, :n] * scale
    return dq, dk, dv


def _over_gate(got, want) -> dict:
    """Each gradient's error against the plain version over the gate
    (2e-5 of the gradient's largest magnitude)."""
    return {name: float((x - w).abs().max())
            / (GATE * max(float(w.abs().max()), 1e-6))
            for name, x, w in zip(("dq", "dk", "dv"), got, want)}


# (b, s, h, kv, hd, hdv, causal, window, sk)
BACKWARD = {
    "causal": (2, 130, 4, 4, 64, 64, True, 0, 0),
    "windowed_gqa": (1, 150, 8, 2, 128, 128, True, 40, 0),
    "cross": (2, 32, 2, 2, 64, 64, False, 0, 1500),
    "ragged_window": (2, 61, 6, 2, 32, 32, False, 9, 0),
    "negative_window": (1, 40, 2, 2, 32, 32, False, -3, 0),
    "mla": (1, 77, 4, 4, 192, 128, True, 0, 0),
}


@pytest.mark.parametrize("name", list(BACKWARD))
def test_backward_tiles_hold_the_float32_gate(name):
    """The two kernels' walks in 3xTF32 give the plain gradients within
    a quarter of the gate (2e-5 of each gradient's largest magnitude)."""
    b, s, h, kv, hd, hdv, causal, window, sk = BACKWARD[name]
    q, k, v, do = _inputs(43, b, s, h, kv, hd, hdv, sk or s)
    mode = dict(causal=causal, window=window)
    out = fa.flash_attention_plain(q, k, v, **mode)
    lse = fa.flash_attention_lse_plain(q, k, **mode)
    want = fa.flash_attention_backward_plain(q, k, v, out, lse, do, **mode)
    got = _tile_backward(q, k, v, out, lse, do, causal, window)
    over = _over_gate(got, want)
    assert max(over.values()) <= 0.25, over


# --------------------------------------------------------- one term

def test_one_tf32_term_misses_the_gate():
    """big·big alone (plain TF32, what the earlier kernels' comments
    ruled out) misses the float32 gate by several times, in the forward
    and in every gradient, at whisper's width over 256 keys; the three
    terms stay under a quarter of it."""
    b, s, h, hd, sk = 1, 64, 2, 64, 256
    q, k, v, do = _inputs(44, b, s, h, h, hd, hd, sk)
    mode = dict(causal=False, window=0)
    want = fa.flash_attention_plain(q, k, v, **mode)
    one, _ = _tile_forward(q, k, v, False, 0, terms=1)
    three, _ = _tile_forward(q, k, v, False, 0, terms=3)
    assert float((one - want).abs().max()) > 3 * GATE
    assert float((three - want).abs().max()) <= GATE / 4
    lse = fa.flash_attention_lse_plain(q, k, **mode)
    gw = fa.flash_attention_backward_plain(q, k, v, want, lse, do, **mode)
    over_one = _over_gate(_tile_backward(q, k, v, want, lse, do, False, 0,
                                         terms=1), gw)
    over_three = _over_gate(_tile_backward(q, k, v, want, lse, do, False, 0),
                            gw)
    assert min(over_one.values()) > 3, over_one
    assert max(over_three.values()) <= 0.25, over_three


# ------------------------------------------------------------- splits

@pytest.mark.parametrize("b,s,h,sk,want", [
    (1, 32, 16, 1500, True),      # whisper's cross prefill at B 1
    (2, 32, 16, 1500, True),
    (4, 32, 16, 1500, True),
    (32, 32, 16, 1500, False),    # B 32: 512 blocks
    (1, 1500, 16, 1500, False),   # the encoder at B 1: 384 blocks
    (32, 1500, 16, 1500, False),
    (1, 32, 16, 32, False),       # one key tile: nothing to split
])
def test_split_rule(b, s, h, sk, want):
    """The key axis splits only under one wave of blocks, into whole
    64-key tiles, the pieces covering every key tile."""
    splits, chunk = fa.flash_splits(b, h, s, sk, 132)
    assert (splits > 1) == want
    tiles = -(-sk // TILE)
    assert chunk % TILE == 0 and splits * chunk >= tiles * TILE
    assert (splits - 1) * chunk < tiles * TILE
    if want:
        assert b * h * -(-s // TILE) * splits >= 132
