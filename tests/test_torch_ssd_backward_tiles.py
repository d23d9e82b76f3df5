"""The arithmetic of B5's redesigned bf16 backward (``ssd_scan_backward``
on bf16 inputs), on the CPU.

The bf16 kernels of ``csrc/ssd_scan_backward.cu`` run in three steps: a
state kernel walks each (batch row, head) twice over its 64-step tiles,
writing the state entering every tile (h_in) and, from the final
state's gradient backwards, the gradient of the state leaving it (dh);
a tile kernel then forms every tile's gradients on its own, from its x,
dt, B, C, dy and those two states, for a block of heads that share B
and C; a last kernel sums the head blocks' dB and dC over a group and
the (batch row, tile) parts of dA.  Every tile product runs on the
tensor cores, so each float32 operand — dy, h_in, dh, the L∘dt-weighted
tile matrices G = S∘L∘dt and E = P∘L∘dt, and the state updates' w∘x
and exp(cum)∘dy — enters as one bf16 term or as hi + lo.  A test-local
emulation of those tiles, each operand rounded as the kernel rounds it,
is held here against ``ssd_scan_backward_plain`` at the card's gates
(2⁻⁷ of each bf16 gradient's largest magnitude, 1e-4 of ddt's and
dA's), at mamba2-2.7b's widths (64, 128), Jamba's (64, 16), two groups,
a ragged length and a non-zero final-state gradient; and, per operand,
what one bf16 term would cost in its place.  The rule that picks the
heads a block serves, ``backward_heads``, is held to its shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ssd_scan as ss

H100_SMS = 132
TILE = 64


def _inputs(seed, b, s, nh, g, hd, ds, with_dh):
    """chip_smoke.py's ``_ssd_inputs`` distributions, drawn with numpy;
    x, B and C rounded to bf16 as the kernel takes them."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, s, nh, hd)) * 0.5)
    dt = torch.from_numpy(np.logaddexp(rng.standard_normal((b, s, nh)), 0.0))
    a = torch.from_numpy(-np.exp(rng.standard_normal(nh) * 0.3))
    bc = torch.from_numpy(rng.standard_normal((b, s, 2 * g * ds)) * 0.3)
    dy = torch.from_numpy(rng.standard_normal((b, s, nh, hd)))
    dh = (torch.from_numpy(rng.standard_normal((b, nh, hd, ds)))
          if with_dh else None)
    x, bc = (t.to(torch.bfloat16) for t in (x, bc))
    bm = bc[..., :g * ds].reshape(b, s, g, ds)
    cm = bc[..., g * ds:].reshape(b, s, g, ds)
    return (x, dt.float(), a.float(), bm, cm, dy.float(),
            None if dh is None else dh.float())


def _terms(t, n):
    """``t`` as ``n`` bf16 terms, summed in float32 (0: ``t`` itself)."""
    if n == 0:
        return t
    used, rest = torch.zeros_like(t), t
    for _ in range(n):
        term = rest.to(torch.bfloat16).float()
        used, rest = used + term, rest - term
    return used


# the kernel's choice: every float32 operand as hi + lo
KERNEL = dict(dy=2, ge=2, h=2, w=2)


def _tile_backward(x, dt, A, B, C, dy, dh_end, dy_terms=2, ge_terms=2,
                   h_terms=2, w_terms=2):
    """The bf16 kernels' algebra in float32: the two state walks, then
    every tile on its own, with dy, G and E, h_in and dh, and the state
    updates' float32 operands handed to their products as that many
    bf16 terms.  Returns ``(dx, ddt, dA, dB, dC)`` in float32."""
    b, s, nh, hd = x.shape
    g, ds = B.shape[2], B.shape[3]
    rep = nh // g
    tiles = -(-s // TILE)
    pad = tiles * TILE - s

    def padded(t):
        return torch.nn.functional.pad(
            t.float(), (0, 0) * (t.dim() - 2) + (0, pad))

    xs, dts, dys = padded(x), padded(dt), padded(dy)
    bs = padded(B).repeat_interleave(rep, dim=2)      # (b, S, nh, ds)
    cs = padded(C).repeat_interleave(rep, dim=2)
    tri = torch.ones(TILE, TILE, dtype=torch.bool).tril()

    def cut(t, i):
        return t[:, i * TILE:(i + 1) * TILE]

    # per tile: cum, total and the weights
    cums = [torch.cumsum(cut(dts, i) * A, dim=1) for i in range(tiles)]
    # walk 1: h_in; walk 2: dh leaving each tile
    h = torch.zeros(b, nh, hd, ds)
    h_in = []
    for i in range(tiles):
        h_in.append(h)
        total = cums[i][:, -1]
        w = torch.exp(total[:, None] - cums[i]) * cut(dts, i)
        h = h * torch.exp(total)[..., None, None] + torch.einsum(
            "bjhd,bjhs->bhds", _terms(cut(xs, i) * w[..., None], w_terms),
            cut(bs, i))
    dh = torch.zeros(b, nh, hd, ds) if dh_end is None else dh_end.float()
    dhs = [None] * tiles
    for i in reversed(range(tiles)):
        dhs[i] = dh
        total = cums[i][:, -1]
        e = torch.exp(cums[i])
        dh = dh * torch.exp(total)[..., None, None] + torch.einsum(
            "bihd,bihs->bhds", _terms(cut(dys, i) * e[..., None], w_terms),
            cut(cs, i))

    dx, ddt, dbs, dcs = [], [], [], []
    dA = torch.zeros(nh)
    for i in range(tiles):
        xt, dtt, dyt = cut(xs, i), cut(dts, i), cut(dys, i)
        bt, ct = cut(bs, i), cut(cs, i)
        cum = cums[i]                                  # (b, T, nh)
        total = cum[:, -1]
        ecum = torch.exp(cum)
        edec = torch.exp(total[:, None] - cum)
        w = edec * dtt
        diff = cum[:, :, None, :] - cum[:, None, :, :]   # (b, i, j, nh)
        L = torch.exp(torch.where(tri[None, :, :, None], diff, -torch.inf))
        S = torch.einsum("bihs,bjhs->bijh", ct, bt)
        dyq = _terms(dyt, dy_terms)
        P = torch.einsum("bihd,bjhd->bijh", dyq, xt)
        G = S * L * dtt[:, None]
        E = P * L * dtt[:, None]
        K = S * L * P
        hq, dhq = _terms(h_in[i], h_terms), _terms(dhs[i], h_terms)
        Gq, Eq = _terms(G, ge_terms), _terms(E, ge_terms)
        bdh = torch.einsum("bjhs,bhds->bjhd", bt, dhq)
        dx.append(torch.einsum("bijh,bihd->bjhd", Gq, dyq)
                  + w[..., None] * bdh)
        dyh = torch.einsum("bihd,bhds->bihs", dyq, hq)
        dcs.append(torch.einsum("bijh,bjhs->bihs", Eq, bt)
                   + ecum[..., None] * dyh)
        xdh = torch.einsum("bjhd,bhds->bjhs", xt, dhq)
        dbs.append(torch.einsum("bijh,bihs->bjhs", Eq, ct)
                   + w[..., None] * xdh)
        v = edec * (xt * bdh).sum(-1)                  # (b, T, nh)
        r = ecum * (dyh * ct).sum(-1)
        colk = K.sum(1)
        q = K * dtt[:, None]
        # pairs_m = sum over i >= m and j < m of q_ij
        pre = torch.cumsum(q, 2) - q                   # sum_{j < m} q_im'
        pairs = (pre * tri[None, :, :, None]).sum(1)
        rsum = r.flip(1).cumsum(1).flip(1)
        usum = torch.cumsum(dtt * v, 1) - dtt * v
        dot = (dhs[i] * h_in[i]).sum((-2, -1))         # (b, nh)
        da = pairs + rsum + usum + (torch.exp(total) * dot)[:, None]
        ddt.append(A * da + colk + v)
        dA += (dtt * da).sum((0, 1))

    def whole(parts):
        return torch.cat(parts, dim=1)[:, :s]

    def grouped(parts):
        t = whole(parts)
        return t.reshape(b, s, g, rep, ds).sum(3)

    return whole(dx), whole(ddt), dA, grouped(dbs), grouped(dcs)


GATES = dict(dx=2.0 ** -7, ddt=1e-4, dA=1e-4, dB=2.0 ** -7, dC=2.0 ** -7)
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _over_gate(got, want) -> dict:
    """Each gradient's error over its gate: bf16 ones (dx, dB, dC)
    rounded to bf16 as the kernel returns them, relative to the plain
    version's largest magnitude."""
    out = {}
    for name, k, w in zip(NAMES, got, want):
        if name in ("dx", "dB", "dC"):
            k = k.to(torch.bfloat16)
        scale = max(float(w.float().abs().max()), 1e-30)
        out[name] = (float((k.float() - w.float()).abs().max())
                     / (GATES[name] * scale))
    return out


# (b, s, nh, g, hd, ds, with_dh): mamba2's widths, Jamba's, two groups
# at the reduced config's, a ragged length and a final-state gradient
CASES = {
    "mamba2": (1, 192, 4, 1, 64, 128, False),
    "jamba": (1, 192, 4, 1, 64, 16, False),
    "two_groups_ragged": (2, 150, 4, 2, 32, 16, True),
    "mamba2_ragged_dh": (1, 100, 2, 1, 64, 128, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_tile_form_holds_the_card_gates(name):
    """The kernel's rounding (every float32 operand as hi + lo) keeps
    ddt and dA under a quarter of their gate against the plain backward
    (measured ≤ 0.13), and dx, dB and dC, which are rounded to bf16,
    under half of theirs (measured ≤ 0.30: one bf16 rounding flip)."""
    args = _inputs(21, *CASES[name])
    want = ss.ssd_scan_backward_plain(*args, 64)
    got = _tile_backward(*args, **{f"{k}_terms": v
                                   for k, v in KERNEL.items()})
    over = _over_gate(got, want)
    assert max(over["ddt"], over["dA"]) <= 0.25, over
    assert max(over["dx"], over["dB"], over["dC"]) <= 0.5, over


@pytest.mark.parametrize("name", ["mamba2", "two_groups_ragged"])
def test_tile_form_in_float32_is_the_plain_algebra(name):
    """With no rounding at all, tiles computed apart from the two state
    walks are the plain backward up to the order of float32 sums."""
    args = _inputs(22, *CASES[name])
    x, dt, a, bm, cm, dy, dh = args
    want = ss.ssd_scan_backward_plain(x.float(), dt, a, bm.float(),
                                      cm.float(), dy, dh, 64)
    got = _tile_backward(*args, 0, 0, 0, 0)
    for name_, k, w in zip(NAMES, got, want):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((k - w).abs().max()) <= 2e-5 * scale, name_


@pytest.fixture(scope="module")
def mamba2_long():
    """mamba2's widths at S 1,024, 2 heads: the inputs and the plain
    backward's gradients."""
    args = _inputs(23, 1, 1024, 2, 1, 64, 128, True)
    return args, ss.ssd_scan_backward_plain(*args, 256)


@pytest.mark.parametrize("operand", ["dy", "h", "w", "ge"])
def test_one_bf16_term_of_an_operand_costs_the_gate(operand, mamba2_long):
    """One bf16 term of an operand, the others as hi + lo, at mamba2's
    widths and S 1,024 (measured, over each gate): dy moves ddt 21.7×
    and dA 53×; h_in and dh 6.0× and 6.7×; the state updates' w∘x and
    exp(cum)∘dy 2.0× and 4.6×; G and E, which feed only the bf16
    gradients, move dB to 0.76 of its gate and dx to 0.62, where hi + lo
    keeps every gradient within 0.19 of its own.  So the kernel carries
    each as hi + lo."""
    args, want = mamba2_long
    one = dict(KERNEL, **{operand: 1})
    over_one = _over_gate(_tile_backward(
        *args, **{f"{k}_terms": v for k, v in one.items()}), want)
    over_two = _over_gate(_tile_backward(
        *args, **{f"{k}_terms": v for k, v in KERNEL.items()}), want)
    assert max(over_two.values()) <= 0.25, over_two
    if operand == "ge":
        assert over_one["dB"] > 0.5 > 2 * over_two["dB"], over_one
    else:
        assert max(over_one["ddt"], over_one["dA"]) > 1.0, over_one


@pytest.mark.parametrize("shape,want", [
    ((2, 512, 80, 1), 4),        # mamba2's training shape: 320 blocks
    ((2, 512, 128, 1), 4),       # Jamba's 128 heads: 512 blocks
    ((1, 4096, 80, 1), 8),       # mamba2 at B 1 x 4,096: 640 blocks
    ((1, 1023, 8, 2), 1),        # the reduced config: too few blocks
    ((2, 300, 80, 1), 2),        # a ragged row: 400 blocks
])
def test_backward_heads_fill_the_card(shape, want):
    b, s, nh, g = shape
    hpb = ss.backward_heads(b, s, nh, g, H100_SMS)
    assert hpb == want
    assert (nh // g) % hpb == 0 and hpb <= ss.MAX_BACKWARD_HEADS
    tiles = -(-s // TILE)
    if hpb > 1:   # the grid still gives every SM two blocks
        assert (nh // hpb) * tiles * b >= ss.BLOCKS_PER_SM * H100_SMS
