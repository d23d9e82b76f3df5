"""The arithmetic of B5's float32 kernels (``ssd_scan`` and its backward
on float32 inputs), on the CPU.

The float32 kernels of ``csrc/ssd_scan.cu`` and
``csrc/ssd_scan_backward.cu`` run every product on the TF32 tensor cores
as 3xTF32 (``mma.sync`` m16n8k8): each float32 operand x is split into
``big``, x rounded to TF32 (to nearest, ties away from zero: half an ulp
added to the bits, the low 13 bits cleared), and ``small = x - big``,
which the tensor cores read truncated; a product is small·big +
big·small + big·big.  The tensor cores' float32 sums truncate, so a
fragment that many k-steps feed drifts toward zero: the kernels sum each
tile's products in zeroed fragments, the long chains (the scores C·Bᵀ,
C·hᵀ, and the state updates) with the small terms' two products in one
fragment and big·big in another, and add them in round-to-nearest.  A
test-local emulation of both kernels' tile walks, with every m16n8k8 sum
(one k-step of 8, exact) truncated to float32, is held here:

- the forward (32-step tiles: scores, M, C·hᵀ, M·x, the state update)
  against ``ssd_scan_plain`` within the card's float32 gate (1e-4 on y
  and on the final state), and against the recurrence stepped in
  float64 within a tenth of it (the plain version's own float32 dual
  form over 256-step chunks is ten times farther from it);
- the backward (the state kernel's two walks over 64-step tiles, then
  every tile on its own: S = C·Bᵀ and P = dy·xᵀ, G, E and K, dx, dC, dB
  and the CUDA-core sums for da, ddt and dA) against
  ``ssd_scan_backward_plain`` within 1e-4 of each gradient's largest
  magnitude;

at mamba2-2.7b's widths (64, 128) at S 1,024, Jamba's (64, 16) and a
ragged grouped (32, 16) case; at one small shape also against the
reference's ``_ssd_chunked``, ``jax.vjp`` of it and the interpret-mode
Pallas ``ssd_scan``.  One case shows that a single TF32 term (big·big
alone) misses the gate.

``torch.exp`` runs through a float64 round trip in every test here (the
``accurate_exp`` fixture): PyTorch's vectorised float32 exp on the CPU
has been seen, in some processes and not others, to err by 1.5e-4
relative (exp(-7.97)), which moves the plain version's y by 3.8e-4 at
mamba2's widths; the kernels' ``expf`` is within a few ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SSMConfig
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models import mamba2 as ref_mamba2
from repro_torch.kernels import ssd_scan as ss

GATE = 1e-4                  # the card's float32 gates
_EXP = torch.exp


@pytest.fixture(autouse=True)
def accurate_exp(monkeypatch):
    """``torch.exp`` of a float32 tensor correctly rounded, through
    float64, for the plain versions and the emulation alike."""
    def exp(t, *args, **kwargs):
        if t.dtype == torch.float32:
            return _EXP(t.double(), *args, **kwargs).float()
        return _EXP(t, *args, **kwargs)
    monkeypatch.setattr(torch, "exp", exp)
T_FWD, T_BWD = 32, 64        # the kernels' tile lengths
NAMES = ("dx", "ddt", "dA", "dB", "dC")


# ------------------------------------------------------------ rounding

def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as the kernels do it: half an ulp added to the
    magnitude bits, the low 13 bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncated(x: torch.Tensor) -> torch.Tensor:
    """A float32 value as the tensor cores read a TF32 operand."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, truncated(x - big)


def rz(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32 toward zero: a tensor-core sum."""
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def mma(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One m16n8k8 per output tile: ``c + a · bᵀ`` over one k-step,
    exact, then truncated."""
    return rz(c.double() + a.double() @ b.double().transpose(-1, -2))


def tc(a: torch.Tensor, b: torch.Tensor, mode: str = "one",
       c: torch.Tensor = None, terms: int = 3) -> torch.Tensor:
    """``a · bᵀ`` (k the last axis of both) as the kernels form it: k in
    steps of 8, each operand split as it is loaded; ``mode`` "one": the
    three products into one fragment (starting from ``c``, else 0) in
    the kernels' order small·big, big·small, big·big; "apart": small·big
    and big·small into one zeroed fragment, big·big into another, added
    in round-to-nearest at the end.  ``terms`` 1: big·big alone."""
    (ab, asm), (bb, bsm) = split(a), split(b)
    shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + (
        a.shape[-2], b.shape[-2])
    hi = torch.zeros(shape) if c is None else c.float()
    lo = torch.zeros(shape)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        if terms == 1:
            hi = mma(hi, ab[..., ks], bb[..., ks])
        elif mode == "apart":
            lo = mma(lo, asm[..., ks], bb[..., ks])
            hi = mma(hi, ab[..., ks], bb[..., ks])
            lo = mma(lo, ab[..., ks], bsm[..., ks])
        else:
            hi = mma(hi, asm[..., ks], bb[..., ks])
            hi = mma(hi, ab[..., ks], bsm[..., ks])
            hi = mma(hi, ab[..., ks], bb[..., ks])
    return hi + lo if mode == "apart" else hi


def test_tf32_split_and_truncated_sum():
    """The split keeps x to ~2⁻²¹ with both terms on TF32's grid; a
    truncated sum never rounds away from zero and is within one float32
    ulp of the exact sum."""
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(10_000)
                         .astype(np.float32))
    big, small = split(r)
    assert (big.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (small.view(torch.int32) & 0x1FFF).eq(0).all()
    rel = ((big.double() + small.double() - r.double()).abs()
           / r.double().abs()).max()
    assert float(rel) <= 2.0 ** -21
    x = r.double() * (1 + 1e-9)
    t = rz(x)
    assert bool((t.double().abs() <= x.abs()).all())
    assert bool(((x - t.double()).abs() <= x.abs() * 2.0 ** -23).all())


# -------------------------------------------------------------- inputs

def _inputs(seed, b, s, nh, g, hd, ds, with_dh=False):
    """tests/test_kernels.py's distributions, drawn with numpy (float32),
    and a gradient dy (and dh_end) for the backward."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, s, nh, hd)) * 0.5,
            np.logaddexp(rng.standard_normal((b, s, nh)), 0.0),
            -np.exp(rng.standard_normal(nh) * 0.3),
            rng.standard_normal((b, s, g, ds)) * 0.3,
            rng.standard_normal((b, s, g, ds)) * 0.3,
            rng.standard_normal((b, s, nh, hd)),
            rng.standard_normal((b, nh, hd, ds)) if with_dh else None]
    return [None if v is None else torch.from_numpy(v.astype(np.float32))
            for v in arrs]


def _tiles(t, s, tile):
    """``t`` (b, s, ...) zero-padded to whole tiles (the kernels'
    zero-filled rows past S: dt = 0 identity steps)."""
    pad = (-s) % tile
    return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def _per_head(m, nh):
    """B or C (b, S, g, ds) as each head reads it: (b, nh, S, ds)."""
    return m.repeat_interleave(nh // m.shape[2], dim=2).transpose(1, 2)


def _lower(cum):
    """L_ij = exp(cum_i - cum_j) for j <= i, else 0 (the mask before the
    exp); cum (b, nh, T)."""
    n = cum.shape[-1]
    tri = torch.ones(n, n, dtype=torch.bool).tril()
    diff = cum[..., :, None] - cum[..., None, :]
    return torch.exp(torch.where(tri, diff, -torch.inf))


def float64_scan(x, dt, A, B, C):
    """y and the final state of the recurrence stepped one step at a
    time in float64."""
    b, s, nh, hd = x.shape
    rep_ = nh // B.shape[2]
    xd, dd, ad = x.double(), dt.double(), A.double()
    bd = B.double().repeat_interleave(rep_, 2)
    cd = C.double().repeat_interleave(rep_, 2)
    h = torch.zeros(b, nh, hd, B.shape[3], dtype=torch.float64)
    ys = []
    for t in range(s):
        h = (h * torch.exp(dd[:, t] * ad)[..., None, None]
             + dd[:, t, :, None, None] * xd[:, t, :, :, None]
             * bd[:, t, :, None, :])
        ys.append(torch.einsum("bhds,bhs->bhd", h, cd[:, t]))
    return torch.stack(ys, 1), h


# ------------------------------------------------------------- forward

def emulate_forward(x, dt, A, B, C, terms=3):
    """y and the final state as ``ssd_scan_kernel_f32`` computes them:
    32-step tiles, (a) scores C·Bᵀ apart, M = scores ∘ L ∘ dt; (c) C·hᵀ
    apart, scaled by exp(cum); (b) M·x in one fragment; y = (c) + (b);
    (d) h ← h·exp(total) + ((w∘x)ᵀ·B apart)."""
    b, s, nh, hd = x.shape
    ds = B.shape[3]
    xs = _tiles(x, s, T_FWD).transpose(1, 2)           # (b, nh, S', hd)
    dts = _tiles(dt, s, T_FWD).transpose(1, 2)         # (b, nh, S')
    bs = _per_head(_tiles(B, s, T_FWD), nh)
    cs = _per_head(_tiles(C, s, T_FWD), nh)
    h = torch.zeros(b, nh, hd, ds)
    ys = []
    for t0 in range(0, xs.shape[2], T_FWD):
        sl = slice(t0, t0 + T_FWD)
        xt, dtt, bt, ct = xs[:, :, sl], dts[:, :, sl], bs[:, :, sl], cs[:, :, sl]
        cum = torch.cumsum(dtt * A[:, None], dim=-1)
        total = cum[..., -1]
        w = torch.exp(total[..., None] - cum) * dtt
        scores = tc(ct, bt, "apart", terms=terms)
        m = scores * _lower(cum) * dtt[..., None, :]
        yh = torch.exp(cum)[..., None] * tc(ct, h, "apart", terms=terms)
        ym = tc(m, xt.transpose(-1, -2), "one", terms=terms)
        ys.append(yh + ym)
        upd = tc((w[..., None] * xt).transpose(-1, -2), bt.transpose(-1, -2),
                 "apart", terms=terms)
        h = h * torch.exp(total)[..., None, None] + upd
    y = torch.cat(ys, dim=2)[:, :, :s].transpose(1, 2)
    return y, h


# ------------------------------------------------------------ backward

def emulate_backward(x, dt, A, B, C, dy, dh_end, terms=3):
    """(dx, ddt, dA, dB, dC) as the float32 backward computes them: the
    state kernel's walks (h_in, then dh from dh_S backwards; each update
    apart), then every 64-step tile on its own: S = C·Bᵀ apart, P =
    dy·xᵀ, G = S∘L∘dt, E = P∘L∘dt, K = S∘L∘P; dx = Gᵀ·dy + w∘(B·dhᵀ);
    dC = exp(cum)∘(dy·h_in) + E·B and dB = w∘(x·dh) + Eᵀ·C, each second
    product continuing the first's fragment; the rest on the CUDA
    cores; dB and dC summed over a group's heads in head order."""
    b, s, nh, hd = x.shape
    g, ds = B.shape[2], B.shape[3]
    rep = nh // g
    xs = _tiles(x, s, T_BWD).transpose(1, 2)
    dys = _tiles(dy, s, T_BWD).transpose(1, 2)
    dts = _tiles(dt, s, T_BWD).transpose(1, 2)
    bs = _per_head(_tiles(B, s, T_BWD), nh)
    cs = _per_head(_tiles(C, s, T_BWD), nh)
    tiles = xs.shape[2] // T_BWD
    tri = torch.ones(T_BWD, T_BWD, dtype=torch.bool).tril()

    def cut(t, i):
        return t[:, :, i * T_BWD:(i + 1) * T_BWD]

    cums = [torch.cumsum(cut(dts, i) * A[:, None], dim=-1)
            for i in range(tiles)]
    h = torch.zeros(b, nh, hd, ds)
    h_in = []
    for i in range(tiles):
        h_in.append(h)
        total = cums[i][..., -1]
        w = torch.exp(total[..., None] - cums[i]) * cut(dts, i)
        upd = tc((w[..., None] * cut(xs, i)).transpose(-1, -2),
                 cut(bs, i).transpose(-1, -2), "apart", terms=terms)
        h = h * torch.exp(total)[..., None, None] + upd
    dh = torch.zeros(b, nh, hd, ds) if dh_end is None else dh_end.clone()
    dhs = [None] * tiles
    for i in reversed(range(tiles)):
        dhs[i] = dh
        total = cums[i][..., -1]
        e = torch.exp(cums[i])
        upd = tc((e[..., None] * cut(dys, i)).transpose(-1, -2),
                 cut(cs, i).transpose(-1, -2), "apart", terms=terms)
        dh = dh * torch.exp(total)[..., None, None] + upd

    dx, ddt, dbs, dcs = [], [], [], []
    dA = torch.zeros(nh)
    for i in range(tiles):
        xt, dtt, dyt = cut(xs, i), cut(dts, i), cut(dys, i)
        bt, ct = cut(bs, i), cut(cs, i)
        cum = cums[i]
        total = cum[..., -1]
        ecum = torch.exp(cum)
        edec = torch.exp(total[..., None] - cum)
        w = edec * dtt
        L = _lower(cum)
        S = tc(ct, bt, "apart", terms=terms)
        P = tc(dyt, xt, "one", terms=terms)
        G = S * L * dtt[..., None, :]
        E = P * L * dtt[..., None, :]
        K = S * L * P
        acc = tc(G.transpose(-1, -2), dyt.transpose(-1, -2), terms=terms)
        bdh = tc(bt, dhs[i], terms=terms)
        dx.append(w[..., None] * bdh + acc)
        dyh = tc(dyt, h_in[i].transpose(-1, -2), terms=terms)
        r = ecum * (dyh * ct).sum(-1)
        dcs.append(tc(E, bt.transpose(-1, -2), c=ecum[..., None] * dyh,
                      terms=terms))
        xdh = tc(xt, dhs[i].transpose(-1, -2), terms=terms)
        dbs.append(tc(E.transpose(-1, -2), ct.transpose(-1, -2),
                      c=w[..., None] * xdh, terms=terms))
        v = edec * (xt * bdh).sum(-1)
        colk = K.sum(-2)
        q = K * dtt[..., None, :]
        pre = torch.cumsum(q, -1) - q
        pairs = (pre * tri).sum(-2)
        rsum = r.flip(-1).cumsum(-1).flip(-1)
        usum = torch.cumsum(dtt * v, -1) - dtt * v
        dot = (dhs[i] * h_in[i]).sum((-2, -1))
        da = pairs + rsum + usum + (torch.exp(total) * dot)[..., None]
        ddt.append(A[:, None] * da + colk + v)
        dA += (dtt * da).sum((0, 2))

    def whole(parts):
        return torch.cat(parts, dim=2)[:, :, :s].transpose(1, 2)

    def grouped(parts):
        t = whole(parts).reshape(b, s, g, rep, ds)
        out = t[:, :, :, 0]
        for r_ in range(1, rep):
            out = out + t[:, :, :, r_]
        return out

    return whole(dx), whole(ddt), dA, grouped(dbs), grouped(dcs)


def _over_gate(got, want):
    """Each gradient's error over 1e-4 of its largest magnitude."""
    return {n: float((k - w).abs().max())
            / (GATE * max(float(w.abs().max()), 1e-30))
            for n, k, w in zip(NAMES, got, want)}


# (b, s, nh, g, hd, ds, with_dh): mamba2's widths at S 1,024, Jamba's,
# and a ragged length over two groups at the reduced config's
CASES = {
    "mamba2": (1, 1024, 2, 1, 64, 128, True),
    "jamba": (1, 1024, 4, 1, 64, 16, False),
    "ragged_grouped": (2, 150, 4, 2, 32, 16, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_forward_tiles_hold_the_float32_gate(name):
    """The emulated forward within the 1e-4 gate of the plain version, y
    and the final state, and within a tenth of it of the float64
    recurrence (measured at mamba2's widths: 5.0e-6 from float64, the
    plain version 7.4e-6).  The plain version runs 64-step chunks here:
    over the model's 256 its float32 cumulative sum of dt·A grows to a
    few hundred and its exponents' differences keep fewer bits (2.6e-5
    from float64 on these inputs)."""
    x, dt, a, bm, cm, _, _ = _inputs(31, *CASES[name])
    want_y, want_h = ss.ssd_scan_plain(x, dt, a, bm, cm, 64)
    y, h = emulate_forward(x, dt, a, bm, cm)
    assert float((y - want_y).abs().max()) <= GATE
    assert float((h - want_h).abs().max()) <= GATE
    true_y, true_h = float64_scan(x, dt, a, bm, cm)
    assert float((y.double() - true_y).abs().max()) <= GATE / 10
    assert float((h.double() - true_h).abs().max()) <= GATE / 10


@pytest.mark.parametrize("name", list(CASES))
def test_backward_tiles_hold_the_float32_gate(name):
    """The emulated backward: every gradient within a quarter of 1e-4 of
    its largest magnitude against the plain backward (measured ≤
    0.13), which runs 64-step chunks as above."""
    args = _inputs(32, *CASES[name])
    want = ss.ssd_scan_backward_plain(*args, 64)
    over = _over_gate(emulate_backward(*args), want)
    assert max(over.values()) <= 0.25, over


def test_one_tf32_term_misses_the_gate():
    """big·big alone (one TF32 term, ~11 bits an operand) moves y and
    the gradients far past their gates at mamba2's widths, where 3xTF32
    stays well inside them (y against the float64 recurrence)."""
    args = _inputs(33, 1, 256, 2, 1, 64, 128, True)
    x, dt, a, bm, cm, _, _ = args
    true_y, _ = float64_scan(x, dt, a, bm, cm)
    one_y, _ = emulate_forward(x, dt, a, bm, cm, terms=1)
    three_y, _ = emulate_forward(x, dt, a, bm, cm)
    assert float((one_y.double() - true_y).abs().max()) > 10 * GATE
    assert float((three_y.double() - true_y).abs().max()) <= GATE / 10
    want = ss.ssd_scan_backward_plain(*args, 64)
    one = _over_gate(emulate_backward(*args, terms=1), want)
    three = _over_gate(emulate_backward(*args), want)
    assert min(one.values()) > 1.0 and max(three.values()) <= 0.25, (one,
                                                                     three)


def test_emulation_matches_the_reference_and_the_pallas_kernel():
    """At one small grouped shape: the emulated forward against
    the reference model's ``_ssd_chunked`` (y and the final state within
    2e-5: both float32 dual forms, at other tile lengths) and against
    the interpret-mode Pallas ``ssd_scan`` (y within 2e-5), and the
    emulated backward against ``jax.vjp`` of ``_ssd_chunked`` within
    1e-4 of each gradient's largest magnitude plus 1e-6, as the plain
    backward is held to it."""
    x, dt, a, bm, cm, dy, dh = _inputs(34, 2, 128, 4, 2, 32, 16, True)
    cfg = SSMConfig(d_state=16, head_dim=32, n_groups=2, chunk_size=64)
    prim = [jnp.asarray(t.numpy()) for t in (x, dt, a, bm, cm)]
    y, h = emulate_forward(x, dt, a, bm, cm)
    ry, rh = ref_mamba2._ssd_chunked(*prim, cfg)
    assert float(np.abs(y.numpy() - np.asarray(ry)).max()) <= 2e-5
    assert float(np.abs(h.numpy() - np.asarray(rh)).max()) <= 2e-5
    pallas = pallas_ssd(*prim, chunk=64, interpret=True)
    assert float(np.abs(y.numpy() - np.asarray(pallas)).max()) <= 2e-5
    _, vjp = jax.vjp(lambda *t: ref_mamba2._ssd_chunked(*t, cfg), *prim)
    want = vjp((jnp.asarray(dy.numpy()), jnp.asarray(dh.numpy())))
    got = emulate_backward(x, dt, a, bm, cm, dy, dh)
    for name, g_, w in zip(NAMES, got, want):
        w = np.asarray(w)
        err = float(np.abs(g_.numpy() - w).max())
        assert err <= GATE * float(np.abs(w).max()) + 1e-6, name
