"""The redesigned SSD scan's arithmetic (kernel B5), on the CPU.

At small batch the bf16 kernel cuts each row's time axis into pieces:
a state pass gives every piece its own final state from zero and its
total sum of dt·A, and a second pass starts each piece from the states
of the earlier ones, combined in piece order.  The split rule
``ssd_splits`` and that algebra in plain torch
(``ssd_piece_states_plain`` → ``ssd_combine_plain`` →
``ssd_piece_plain``) are held here against the plain version (float32,
within 1e-5) for 1 … 8 pieces, and against the JAX package's
``_ssd_chunked``, ``ssd_scan_ref`` and interpret-mode Pallas
``ssd_scan`` at tests/test_kernels.py's tolerance, 2e-3.  The bf16
kernel feeds three float32 operands to the tensor cores — M = (C·Bᵀ) ∘
L ∘ dt, the carried state h and w ∘ x; a test-local tile scan estimates
what one bf16 term of each costs and what the kernel's two terms (hi +
lo) cost.  The ``cuda``-marked test runs the kernel itself and skips
without a GPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SSMConfig
from repro.kernels.ref import ssd_scan_ref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models import mamba2 as ref_mamba2
from repro_torch.kernels import ssd_scan as ss

H100_SMS = 132
MAMBA2_HEADS = 80
SPLITS = list(range(1, 9))


def _inputs(seed, b, s, nh, g, hd, ds):
    """tests/test_kernels.py's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, hd)) * 0.5
    dt = np.logaddexp(rng.standard_normal((b, s, nh)), 0.0)
    a = -np.exp(rng.standard_normal(nh) * 0.3)
    bm = rng.standard_normal((b, s, g, ds)) * 0.3
    cm = rng.standard_normal((b, s, g, ds)) * 0.3
    return [v.astype(np.float32) for v in (x, dt, a, bm, cm)]


def _split_scan(x, dt, a, bm, cm, splits, chunk=64):
    """The split kernel's algebra end to end: pieces of ceil(S / splits)
    steps, their states and totals, the in-order combine, and each
    piece's y from its starting state; y, the final state, and the
    pieces' states and totals."""
    s = x.shape[1]
    piece = -(-s // splits)
    local, totals = ss.ssd_piece_states_plain(x, dt, a, bm, cm, piece,
                                              chunk)
    h_in = ss.ssd_combine_plain(local, totals)
    ys, h = [], None
    for k in range(local.shape[0]):
        sl = slice(k * piece, min(s, (k + 1) * piece))
        y, h = ss.ssd_piece_plain(x[:, sl], dt[:, sl], a, bm[:, sl],
                                  cm[:, sl], h_in[k], chunk)
        ys.append(y)
    return torch.cat(ys, dim=1), h, local, totals


# a ragged length and two groups, at the reduced config's widths
RAGGED = (2, 300, 4, 2, 32, 16)


@pytest.mark.parametrize("splits", SPLITS)
def test_split_algebra_equals_plain(splits):
    b, s, nh, g, hd, ds = RAGGED
    args = [torch.from_numpy(v) for v in _inputs(11, *RAGGED)]
    y, h, local, totals = _split_scan(*args, splits)
    want_y, want_h = ss.ssd_scan_plain(*args, 64)
    assert local.shape == (splits, b, nh, hd, ds)
    assert totals.shape == (splits, b, nh)
    # measured ≤ 6.8e-6: only the order of float32 sums differs
    assert float((y - want_y).abs().max()) <= 1e-5
    assert float((h - want_h).abs().max()) <= 1e-5
    # the final state is also the combine carried one piece further
    last = ss.ssd_combine_plain(torch.cat([local, local[:1]]),
                                torch.cat([totals, totals[:1]]))[-1]
    assert float((last - want_h).abs().max()) <= 1e-5


@pytest.mark.parametrize("splits", SPLITS)
def test_split_over_dt_zero_padding(splits):
    """Steps with dt = 0 are identities: pieces wholly in such padding
    have a zero state and total, and leave y on the real steps and the
    final state as they were without the padding."""
    b, s, nh, g, hd, ds = RAGGED
    real = [torch.from_numpy(v) for v in _inputs(12, *RAGGED)]
    pad = [torch.from_numpy(v) for v in _inputs(13, b, 212, nh, g, hd, ds)]
    pad[1] = torch.zeros_like(pad[1])
    x, dt, bm, cm = (torch.cat([r, p], dim=1) for r, p in
                     zip((real[0], real[1], real[3], real[4]),
                         (pad[0], pad[1], pad[3], pad[4])))
    y, h, local, totals = _split_scan(x, dt, real[2], bm, cm, splits)
    want_y, want_h = ss.ssd_scan_plain(*real, 64)
    assert float((y[:, :s] - want_y).abs().max()) <= 1e-5
    assert float((h - want_h).abs().max()) <= 1e-5
    piece = -(-x.shape[1] // splits)
    padded = [k for k in range(splits) if k * piece >= s]
    assert bool(padded) == (splits >= 3)
    for k in padded:
        assert not bool(local[k].any()) and not bool(totals[k].any())


# S a multiple of the Pallas kernel's chunk (64), and a ragged one for
# the references that take it
JAX_SHAPES = {"S256": (2, 256, 4, 2, 32, 16), "S200": (1, 200, 8, 1, 64, 64)}


@pytest.fixture(scope="module")
def jax_refs():
    out = {}
    for name, shape in JAX_SHAPES.items():
        arrs = _inputs(14, *shape)
        ja = [jnp.asarray(v) for v in arrs]
        b, s, nh, g, hd, ds = shape
        cfg = SSMConfig(d_state=ds, head_dim=hd, n_groups=g, chunk_size=64)
        ry, rh = ref_mamba2._ssd_chunked(*ja, cfg)
        ref = {"chunked_y": np.asarray(ry), "chunked_h": np.asarray(rh),
               "oracle_y": np.asarray(ssd_scan_ref(*ja))}
        if s % 64 == 0:
            ref["pallas_y"] = np.asarray(pallas_ssd(*ja, chunk=64,
                                                    interpret=True))
        out[name] = (arrs, ref)
    return out


@pytest.mark.parametrize("name", list(JAX_SHAPES))
@pytest.mark.parametrize("splits", [1, 3, 4, 7])
def test_split_matches_the_jax_references(splits, name, jax_refs):
    arrs, ref = jax_refs[name]
    y, h, _, _ = _split_scan(*(torch.from_numpy(v) for v in arrs), splits)
    np.testing.assert_allclose(y.numpy(), ref["chunked_y"], rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(h.numpy(), ref["chunked_h"], rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(y.numpy(), ref["oracle_y"], rtol=2e-3,
                               atol=2e-3)
    if "pallas_y" in ref:
        np.testing.assert_allclose(y.numpy(), ref["pallas_y"], rtol=2e-3,
                                   atol=2e-3)


# (batch, seq): the serve shape, the long shape at batch 1 … 32, ragged
# lengths, and a row shorter than a tile
SPLIT_SHAPES = [(32, 32), (1, 32), (1, 1024), (2, 1024), (3, 1024),
                (4, 1024), (32, 1024), (1, 1000), (1, 65), (1, 1), (1, 0),
                (1, 1 << 16)]


@pytest.mark.parametrize("shape", SPLIT_SHAPES,
                         ids=[f"{b}x{s}" for b, s in SPLIT_SHAPES])
def test_ssd_splits_cover_the_row_in_whole_tiles(shape):
    b, s = shape
    splits, piece = ss.ssd_splits(b, s, MAMBA2_HEADS, H100_SMS)
    assert 1 <= splits <= ss.MAX_SPLITS
    assert piece >= ss.TILE and piece % ss.TILE == 0
    assert splits * piece >= s                 # every step in a piece
    assert (splits - 1) * piece < max(s, 1)    # no piece wholly past S
    if splits > 1:                             # never more than ~2 an SM
        assert (splits - 1) * b * MAMBA2_HEADS < 2 * H100_SMS


def test_ssd_splits_at_mamba2_width():
    """80 heads: 4 pieces at batch 1 and S 1,024 (320 blocks), 2 at
    batch 2, 1 from batch 4 up and at the serve prompt, whose one tile
    is never split."""
    assert ss.ssd_splits(1, 1024, 80, H100_SMS) == (4, 256)
    assert ss.ssd_splits(1, 1000, 80, H100_SMS) == (4, 256)
    assert ss.ssd_splits(2, 1024, 80, H100_SMS) == (2, 512)
    for b in (4, 8, 32):
        assert ss.ssd_splits(b, 1024, 80, H100_SMS)[0] == 1
    assert ss.ssd_splits(32, 32, 80, H100_SMS)[0] == 1
    assert ss.ssd_splits(1, 32, 80, H100_SMS)[0] == 1
    # the reduced config's 16 heads: capped by the row's tiles
    assert ss.ssd_splits(1, 100, 16, H100_SMS) == (2, 64)


def test_bf16_launch_guard_wants_16_byte_rows():
    """The bf16 kernel stages x, B and C by 16-byte copies: B and C
    sliced out of the model's activation pass, a slice that starts off
    a 16-byte boundary or strides by a width no multiple of 8 is
    refused before any launch (float32 takes both: its launch copies
    such rows first)."""
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in
                        _inputs(17, 2, 40, 4, 1, 32, 16))
    x = x.bfloat16()
    bcc = torch.cat([bm, cm], dim=-1).reshape(2, 40, 32).bfloat16()
    ss.launchable(x, dt, a, bcc[..., :16].reshape(2, 40, 1, 16),
                  bcc[..., 16:].reshape(2, 40, 1, 16))
    # one activation whose slices start 2 bytes in, and one whose rows
    # are 36 elements apart
    for width, first in ((40, 1), (36, 0)):
        for dtype in (torch.bfloat16, torch.float32):
            act = torch.zeros(2, 40, width, dtype=dtype)
            bv, cv = (act[..., first + o:first + o + 16].reshape(2, 40, 1, 16)
                      for o in (0, 16))
            if dtype == torch.bfloat16:
                with pytest.raises(ValueError, match="16-byte"):
                    ss.launchable(x, dt, a, bv, cv)
            else:   # copied to 16-byte rows before the launch
                ss.launchable(x.float(), dt, a, bv, cv)
                xf, bf, cf = ss._aligned_f32(x.float(), bv, cv)
                assert not any(ss._misaligned(t) for t in (xf, bf, cf))
                assert torch.equal(bf, bv) and torch.equal(cf, cv)


def test_split_workspace_is_kept_and_grown_not_allocated_per_call(
        monkeypatch):
    monkeypatch.setattr(ss, "_WORK", {})
    dev = torch.device("cpu")
    ws = ss._workspace(dev, 100)
    assert ws.numel() == 100 and ws.dtype == torch.float32
    assert ss._workspace(dev, 60) is ws
    grown = ss._workspace(dev, 150)
    assert grown.numel() == 150 and ss._workspace(dev, 100) is grown


# ---------------------------------------------------------------------------
# The cost of rounding the tensor cores' float32 operands
# ---------------------------------------------------------------------------

def _terms(t, n):
    """``t`` as ``n`` bf16 terms, summed in float32 (0: ``t`` itself)."""
    if n == 0:
        return t
    used, rest = torch.zeros_like(t), t
    for _ in range(n):
        term = rest.to(torch.bfloat16).float()
        used, rest = used + term, rest - term
    return used


def _tile_scan(x, dt, A, B, C, n_m, n_h, n_wx, tile=64):
    """The bf16 kernel's tile algebra in float32 (one group), with M, h
    and w∘x handed to their products as ``n_m``, ``n_h`` and ``n_wx``
    bf16 terms."""
    b, s, nh, hd = x.shape
    h = torch.zeros(b, nh, hd, B.shape[-1])
    tri = torch.ones(tile, tile, dtype=torch.bool).tril()[None, :, :, None]
    ys = []
    for t0 in range(0, s, tile):
        xt, dtt = x[:, t0:t0 + tile], dt[:, t0:t0 + tile]
        bt, ct = B[:, t0:t0 + tile, 0], C[:, t0:t0 + tile, 0]
        cum = torch.cumsum(dtt * A, dim=1)
        total = cum[:, -1]
        sc = torch.einsum("bis,bjs->bij", ct, bt)[..., None]
        diff = cum[:, :, None, :] - cum[:, None, :, :]
        M = sc * torch.exp(torch.where(tri, diff, -torch.inf)) \
            * dtt[:, None, :, :]
        y = torch.einsum("bijh,bjhd->bihd", _terms(M, n_m), xt)
        y = y + torch.einsum("bis,bhds->bihd", ct, _terms(h, n_h)) \
            * torch.exp(cum)[..., None]
        w = torch.exp(total[:, None] - cum) * dtt
        h = h * torch.exp(total)[..., None, None] + torch.einsum(
            "bjhd,bjs->bhds", _terms(xt * w[..., None], n_wx), bt)
        ys.append(y)
    return torch.cat(ys, dim=1), h


@pytest.fixture(scope="module")
def mamba2_tile_inputs():
    """mamba2-2.7b's widths (hd 64, ds 128, one group) at S 1,024 and 4
    heads, chip_smoke.py's ``_ssd_inputs`` distributions with x, B and C
    rounded to bf16, and the plain version's float32 result on them."""
    rng = np.random.default_rng(15)
    b, s, nh, hd, ds = 1, 1024, 4, 64, 128
    x = torch.from_numpy(rng.standard_normal((b, s, nh, hd)) * 0.5)
    dt = torch.from_numpy(np.logaddexp(rng.standard_normal((b, s, nh)),
                                       0.0))
    a = torch.from_numpy(-np.exp(rng.standard_normal(nh) * 0.3))
    bc = torch.from_numpy(rng.standard_normal((b, s, 2 * ds)) * 0.3)
    x, bc = (t.to(torch.bfloat16).float() for t in (x, bc))
    dt, a = dt.float(), a.float()
    B = bc[..., :ds].reshape(b, s, 1, ds)
    C = bc[..., ds:].reshape(b, s, 1, ds)
    return (x, dt, a, B, C), ss.ssd_scan_plain(x, dt, a, B, C, 256)


GATE = 2e-3          # chip_smoke.py's SSD_TOL for bf16, on y and state


@pytest.mark.parametrize("operand", ["M", "h", "wx"])
def test_bf16_operand_rounding_cost(operand, mamba2_tile_inputs):
    """One bf16 term of any of the three operands moves y past a
    quarter of the gate (measured: M 1.8e-2, h 5.3e-3, w∘x 5.2e-3 on y
    and 4.5e-3 on the state; |y| ≤ 8.0, |h| ≤ 2.6), so the kernel
    carries each as hi + lo; with all three so, the tile form stays
    near the float32 tile form's own distance from the plain version
    (measured 4.9e-5 on y and 1.3e-5 on the state, against 6.0e-5 and
    7.6e-6), more than 4× under the gate."""
    args, (want_y, want_h) = mamba2_tile_inputs
    terms = {"M": (1, 2, 2), "h": (2, 1, 2), "wx": (2, 2, 1)}[operand]
    one_y, one_h = _tile_scan(*args, *terms)
    two_y, two_h = _tile_scan(*args, 2, 2, 2)
    f32_y, f32_h = _tile_scan(*args, 0, 0, 0)
    err = lambda a, b: float((a - b).abs().max())  # noqa: E731
    assert max(err(one_y, want_y), err(one_h, want_h)) > GATE / 4
    assert max(err(two_y, want_y), err(two_h, want_h)) <= GATE / 4
    assert err(two_y, want_y) <= 2 * err(f32_y, want_y) + 1e-5
    assert err(two_h, want_h) <= 2 * err(f32_h, want_h) + 1e-5


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 32), (1, 32), (1, 1024), (2, 1024),
                                   (4, 1024), (1, 1000), (32, 300)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_cuda_bf16_kernel_matches_plain_and_repeats(shape):
    """The bf16 tensor-core kernel at mamba2's widths, split (batch 1
    and 2) and unsplit: y and state within 2e-3 of the plain version,
    and a second launch gives the same bits."""
    _need_cuda()
    b, s = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x, dt, a, bm, cm = (torch.from_numpy(v).cuda() for v in
                        _inputs(16, b, s, MAMBA2_HEADS, 1, 64, 128))
    x, bm, cm = x.bfloat16(), bm.bfloat16(), cm.bfloat16()
    n = ss.ssd_scan.launches
    y, h = ss.ssd_chunked(x, dt, a, bm, cm, 256)
    again = ss.ssd_chunked(x, dt, a, bm, cm, 256)
    torch.cuda.synchronize()
    assert ss.ssd_scan.launches == n + 2      # one per call, split or not
    want_y, want_h = ss.ssd_scan_plain(x, dt, a, bm, cm, 256)
    assert float((y - want_y).abs().max()) <= 2e-3
    assert float((h - want_h).abs().max()) <= 2e-3
    assert torch.equal(y, again[0]) and torch.equal(h, again[1])
    if b <= 2 and s > 64:
        assert ss.ssd_splits(b, s, MAMBA2_HEADS, sms)[0] > 1
