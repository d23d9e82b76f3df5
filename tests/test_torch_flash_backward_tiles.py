"""The arithmetic of B3's redesigned bf16 backward (``flash_attention_
backward`` on bf16 inputs), on the CPU.

The bf16 kernels of ``csrc/flash_attention_backward.cu`` run on the
tensor cores: a dK/dV kernel per 64-key tile that walks the query tiles
its keys are admitted by, and a dQ kernel per 64-row query tile that
walks the key tiles its rows admit; each masks only the tiles the mask
cuts.  q, k, v and dO are bf16, so the scores S and dP are exact
products summed in float32; only P and dS are rounded to enter the
next products, as one bf16 term or as hi + lo.  A test-local emulation
of those tile walks — the kernels' tile ranges, their mask-only-a-cut-
tile rule, and P and dS rounded as the kernel rounds them (hi + lo) —
is held here against ``flash_attention_backward_plain`` at the card's
gate, 2⁻⁷ of each gradient's largest magnitude after the bf16 rounding:
causal, windowed, unmasked with a key length of its own, GQA, ragged
lengths and MLA's (192, 128) pair.  And, per rounding choice, what one
bf16 term of P or of dS would cost in its place.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

TILE = 64
GATE = 2.0 ** -7


def _inputs(seed, b, s, h, kv, hd, hdv, sk):
    """q, k, v, dO drawn with numpy, rounded to bf16; the plain forward's
    out and lse on them."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape)).to(
        torch.bfloat16) for shape in ((b, s, h, hd), (b, sk, kv, hd),
                                      (b, sk, kv, hdv), (b, s, h, hdv)))
    return q, k, v, do


def _terms(t, n):
    """``t`` as ``n`` bf16 terms, summed in float32."""
    used, rest = torch.zeros_like(t), t
    for _ in range(n):
        term = rest.to(torch.bfloat16).float()
        used, rest = used + term, rest - term
    return used


def _rows(t, r0, n, axis=1):
    """Rows ``r0 … r0 + TILE`` of ``t`` along ``axis``, zero past ``n``
    (the kernels' zero-filled copies)."""
    part = t.narrow(axis, r0, min(TILE, n - r0))
    pad = TILE - part.shape[axis]
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


def _tile_backward(q, k, v, out, lse, do, causal, window, p_terms=2,
                   ds_terms=2):
    """dq, dk, dv (float32) as the two bf16 kernels compute them: their
    tile ranges, masks applied only to the tiles the mask cuts, and P
    and dS handed to the gradient products as that many bf16 terms."""
    b, s, h, hd = q.shape
    sk, kvh, hdv = k.shape[1], k.shape[2], v.shape[3]
    g = h // kvh
    scale = hd ** -0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    # per query head: its kv head's k and v, (b, sk, h, width)
    kh, vh = (t.repeat_interleave(g, dim=2) for t in (kf, vf))
    delta = (dof * out.float()).sum(-1).transpose(1, 2)      # (b, h, s)
    ar = torch.arange(TILE)

    # the dK/dV kernel: per key tile, the query tiles from qlo to qhi
    dk = torch.zeros(b, sk, kvh, hd)
    dv = torch.zeros(b, sk, kvh, hdv)
    for t0 in range(0, sk, TILE):
        qlo = t0 if causal else 0
        qhi = min(s, t0 + TILE - 1 + window) if window else s
        kt, vt = _rows(kh, t0, sk), _rows(vh, t0, sk)
        dka = torch.zeros(b, TILE, h, hd)
        dva = torch.zeros(b, TILE, h, hdv)
        for r0 in range(qlo, qhi, TILE):
            cut = (r0 + TILE > s or (causal and t0 + TILE - 1 > r0)
                   or (window and r0 + TILE - 1 - t0 >= window))
            qt, dot = _rows(qf, r0, s), _rows(dof, r0, s)
            # zero-filled rows past S: lse 0 and D 0, as copied
            lt, dt = _rows(lse, r0, s, 2), _rows(delta, r0, s, 2)
            st = torch.einsum("bkhd,bqhd->bhkq", kt, qt)
            p = torch.exp(st * scale - lt[:, :, None, :])
            if cut:
                ok = _admit((r0 + ar)[None, :], (t0 + ar)[:, None], s, sk,
                            causal, window)
                ok |= (t0 + ar)[:, None] >= sk    # rows never stored
                p = torch.where(ok, p, 0.0)
            dpt = torch.einsum("bkhd,bqhd->bhkq", vt, dot)
            dst = p * (dpt - dt[:, :, None, :])
            dva += torch.einsum("bhkq,bqhd->bkhd", _terms(p, p_terms), dot)
            dka += torch.einsum("bhkq,bqhd->bkhd", _terms(dst, ds_terms), qt)
        n = min(TILE, sk - t0)
        dk[:, t0:t0 + n] = (dka[:, :n] * scale).reshape(
            b, n, kvh, g, hd).sum(3)
        dv[:, t0:t0 + n] = dva[:, :n].reshape(b, n, kvh, g, hdv).sum(3)

    # the dQ kernel: per query tile, the key tiles from lo to hi
    dq = torch.zeros(b, s, h, hd)
    for q0 in range(0, s, TILE):
        hi = min(sk, q0 + TILE) if causal else sk
        lo = min(sk, max(0, q0 - window + 1)) if window else 0
        qt, dot = _rows(qf, q0, s), _rows(dof, q0, s)
        lt = _rows(lse, q0, s, 2)
        lt = torch.where((q0 + ar < s)[None, None, :], lt, torch.inf)
        dt = _rows(delta, q0, s, 2)
        dqa = torch.zeros(b, TILE, h, hd)
        for t0 in range(lo, hi, TILE):
            cut = (t0 + TILE > sk or (causal and t0 + TILE - 1 > q0)
                   or (window and t0 <= q0 + TILE - 1 - window))
            kt, vt = _rows(kh, t0, sk), _rows(vh, t0, sk)
            sc = torch.einsum("bqhd,bkhd->bhqk", qt, kt)
            p = torch.exp(sc * scale - lt[..., None])
            if cut:
                ok = _admit((q0 + ar)[:, None], (t0 + ar)[None, :], s, sk,
                            causal, window)
                p = torch.where(ok, p, 0.0)
            dp = torch.einsum("bqhd,bkhd->bhqk", dot, vt)
            ds = p * (dp - dt[..., None])
            dqa += torch.einsum("bhqk,bkhd->bqhd", _terms(ds, ds_terms), kt)
        n = min(TILE, s - q0)
        dq[:, q0:q0 + n] = dqa[:, :n] * scale
    return dq, dk, dv


def _over_gate(got, want) -> dict:
    """Each gradient rounded to bf16 as the kernel returns it, its error
    against the plain version over the gate."""
    return {name: float((x.to(torch.bfloat16).float() - w.float()).abs()
                        .max()) / (GATE * max(float(w.float().abs().max()),
                                              1e-6))
            for name, x, w in zip(("dq", "dk", "dv"), got, want)}


# (b, s, h, kv, hd, hdv, causal, window, sk)
CASES = {
    "causal": (2, 192, 4, 4, 64, 64, True, 0, 0),
    "windowed_gqa": (1, 300, 8, 2, 128, 128, True, 64, 0),
    "key_length": (2, 40, 4, 4, 64, 64, False, 0, 150),
    "ragged_window": (2, 61, 6, 2, 32, 32, False, 9, 0),
    "ragged": (1, 500, 4, 4, 64, 64, True, 0, 0),
    "mla": (1, 77, 4, 4, 192, 128, True, 0, 0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_tile_walks_with_hi_lo_hold_the_gate(name):
    """The kernels' tile ranges and masks give the plain gradients, and
    with P and dS as hi + lo every gradient stays under half the gate
    (the rest is one bf16 rounding flip)."""
    b, s, h, kv, hd, hdv, causal, window, sk = CASES[name]
    q, k, v, do = _inputs(31, b, s, h, kv, hd, hdv, sk or s)
    mode = dict(causal=causal, window=window)
    out = fa.flash_attention_plain(q, k, v, **mode)
    lse = fa.flash_attention_lse_plain(q, k, **mode)
    want = fa.flash_attention_backward_plain(q, k, v, out, lse, do, **mode)
    got = _tile_backward(q, k, v, out, lse, do, causal, window)
    over = _over_gate(got, want)
    assert max(over.values()) <= 0.5, over


@pytest.fixture(scope="module")
def training_rows():
    """qwen1.5-0.5b's attention (16 heads of 64, causal) at S 512, two
    rows: inputs, the plain gradients, and P, dS and D in float32."""
    b, s, h, hd = 2, 512, 16, 64
    q, k, v, do = _inputs(32, b, s, h, h, hd, hd, s)
    out = fa.flash_attention_plain(q, k, v)
    lse = fa.flash_attention_lse_plain(q, k)
    want = fa.flash_attention_backward_plain(q, k, v, out, lse, do)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    sc = torch.einsum("bshd,bthd->bhst", qf, kf) * hd ** -0.5
    tri = torch.ones(s, s, dtype=torch.bool).tril()
    p = torch.where(tri, torch.exp(sc - lse[..., None]), 0.0)
    d = (dof * out.float()).sum(-1).transpose(1, 2)[..., None]
    ds = p * (torch.einsum("bshd,bthd->bhst", dof, vf) - d)
    return (qf, kf, dof), want, p, ds


def _dense(tensors, p, ds, p_terms, ds_terms):
    qf, kf, dof = tensors
    scale = qf.shape[-1] ** -0.5
    pq, dsq = _terms(p, p_terms), _terms(ds, ds_terms)
    return (torch.einsum("bhst,bthd->bshd", dsq, kf) * scale,
            torch.einsum("bhst,bshd->bthd", dsq, qf) * scale,
            torch.einsum("bhst,bshd->bthd", pq, dof))


@pytest.mark.parametrize("operand", ["P", "dS"])
def test_one_bf16_term_costs_more_than_hi_lo(operand, training_rows):
    """One bf16 term of P moves dv, of dS moves dq and dk, to about half
    the gate or more (measured here: 0.76 on dv; 0.57 on dq and 0.47 on
    dk; at the training shape, B 8, 0.62, 0.49 and 0.57), where hi + lo
    leaves one rounding flip (0.095; 0.28 and 0.12): the kernel carries
    both as hi + lo."""
    tensors, want, p, ds = training_rows
    one = dict(P=(1, 2), dS=(2, 1))[operand]
    over_one = _over_gate(_dense(tensors, p, ds, *one), want)
    over_two = _over_gate(_dense(tensors, p, ds, 2, 2), want)
    moved = ("dv",) if operand == "P" else ("dq", "dk")
    assert max(over_one[n] for n in moved) > 0.4, over_one
    assert all(over_one[n] >= over_two[n] for n in moved), over_one
    assert max(over_two.values()) <= 0.3, over_two
