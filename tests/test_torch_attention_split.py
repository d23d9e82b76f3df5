"""The redesigned attention kernels' arithmetic, on the CPU.

B4 (``decode_attention``) splits the cache axis across blocks and
merges the splits' softmax statistics in the same launch: the split
rule ``decode_splits`` and the split-and-merge algebra
(``decode_partials_plain`` + ``merge_partials_plain``) are held here
against the plain version (float32, within 2e-6) and the JAX package's
Pallas kernel in interpret mode, for every split count from 1 to 17.
B3's bf16 kernel (``flash_attention``) rounds P for its tensor-core
P·V; a test-local attention estimates what one bf16 term costs and what
the kernel's two terms (hi + lo) cost.  The ``cuda``-marked tests run
the kernels themselves and skip without a GPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa

H100_SMS = 132
SPLITS = list(range(1, 18))
# (batch, cache, heads, kv heads, head_dim): the serve path's shapes
# and phi4-mini's GQA heads at batch 1
SHAPES = [(32, 37, 16, 16, 64), (32, 1057, 16, 16, 64),
          (1, 1057, 16, 16, 64), (1, 37, 16, 16, 64),
          (8, 523, 24, 8, 128), (1, 523, 24, 8, 128), (3, 1, 6, 2, 32),
          (1, 0, 16, 16, 64)]


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_decode_splits_cover_the_cache_in_whole_tiles(shape):
    b, s, _, kv, hd = shape
    splits, chunk = da.decode_splits(b, kv, s, hd, H100_SMS)
    tile = da.TILE_ELEMS // hd
    assert splits >= 1 and chunk >= tile and chunk % tile == 0
    assert splits * chunk >= s                 # every slot in a split
    assert (splits - 1) * chunk < max(s, 1)    # no split wholly past S


def test_decode_splits_at_the_serve_and_batch1_shapes():
    """One split where the grid already fills the card (the serve shape
    is 32 × 16 = 512 blocks), and at batch 1 on the long cache enough
    splits that the 16 kv heads give every SM two blocks."""
    assert da.decode_splits(32, 16, 37, 64, H100_SMS) == (1, 64)
    assert da.decode_splits(32, 16, 1057, 64, H100_SMS)[0] == 1
    splits, chunk = da.decode_splits(1, 16, 1057, 64, H100_SMS)
    assert splits * 16 >= 2 * H100_SMS and chunk == 64
    # never more splits than the cache has tiles, nor than MAX_SPLITS
    assert da.decode_splits(1, 16, 100, 64, H100_SMS) == (2, 64)
    assert da.decode_splits(1, 1, 1 << 20, 64, H100_SMS)[0] == da.MAX_SPLITS


def test_split_workspace_is_kept_and_grown_not_allocated_per_call(
        monkeypatch):
    """The wrapper's workspace and ticket counters are made once per
    device, zeroed, reused while they suffice and replaced (zeroed) only
    when a launch needs more."""
    monkeypatch.setattr(da, "_WORK", {})
    dev = torch.device("cpu")
    ws, tickets = da._workspace(dev, 100, 4)
    assert ws.numel() == 100 and tickets.numel() == 4
    assert not bool(ws.any()) and not bool(tickets.any())
    tickets[0] = 3                              # a counter in use
    again = da._workspace(dev, 50, 2)
    assert again[0] is ws and again[1] is tickets
    grown_ws, grown_tickets = da._workspace(dev, 80, 9)
    assert grown_ws.numel() == 100 and grown_tickets.numel() == 9
    assert not bool(grown_tickets.any())


def _decode_inputs(seed=21, b=4, s=300, h=6, kv=2, hd=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, hd), (b, s, kv, hd), (b, s, kv, hd))]


# row 0 admits nothing, rows 1-3 end in the first, a middle and the last
# split, so most split counts leave some splits empty
LENGTHS = np.asarray([-1, 5, 150, 299], np.int32)


@pytest.fixture(scope="module")
def pallas_out():
    q, k, v = _decode_inputs()
    return {w: np.asarray(pallas_decode(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(LENGTHS),
        window=w, bk=100, interpret=True)) for w in (0, 40)}


@pytest.mark.parametrize("window", [0, 40], ids=["no-window", "window"])
@pytest.mark.parametrize("splits", SPLITS)
def test_split_merge_equals_plain_and_pallas(splits, window, pallas_out):
    q, k, v = (torch.from_numpy(x) for x in _decode_inputs())
    lens = torch.from_numpy(LENGTHS)
    chunk = -(-k.shape[1] // splits)
    m, l, acc = da.decode_partials_plain(q, k, v, lens, splits, chunk,
                                         window=window)
    assert m.shape == l.shape == (4, 2, splits, 3)
    assert acc.shape == (4, 2, splits, 3, 32)
    # an empty split carries m = NEG_INF, l = 0, acc = 0
    empty = l == 0
    assert bool(empty[0].all())
    assert bool((m[empty] == da.NEG_INF).all())
    assert bool((acc[empty] == 0).all())
    got = da.merge_partials_plain(m, l, acc, torch.float32)
    want = da.decode_attention_plain(q, k, v, lens, window=window)
    # measured ≤ 2.3e-7: only the order of the float32 sums differs
    assert float((got - want).abs().max()) <= 2e-6
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    np.testing.assert_allclose(got.numpy(), pallas_out[window], rtol=0,
                               atol=2e-5)


def _flash_probs(q, k, v, p_terms):
    """Causal attention in float32 with P handed to P·V as ``p_terms``
    bf16 terms (0: P kept in float32), l from the unrounded P."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    sc = torch.einsum("bskgh,btkh->bkgst",
                      q.reshape(b, s, kv, h // kv, hd), k) * hd ** -0.5
    pos = torch.arange(s)
    mask = pos[None, :] <= pos[:, None]
    sc = torch.where(mask, sc, fa.NEG_INF)
    p = torch.where(mask, torch.exp(sc - sc.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    used, rest = torch.zeros_like(p), p
    for _ in range(p_terms):
        term = rest.to(torch.bfloat16).float()
        used, rest = used + term, rest - term
    if not p_terms:
        used = p
    acc = torch.einsum("bkgst,btkh->bkgsh", used, v)
    return (acc / (l + 1e-30)).permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)


# (batch, seq): the serve shape, and the long shape cut to 256 keys
@pytest.mark.parametrize("b,s", [(32, 32), (2, 256)],
                         ids=["serve", "reduced-long"])
def test_bf16_probabilities_cost(b, s):
    """On bf16 inputs at qwen's heads (16 of 64): one bf16 term of P
    moves the float32 output by ≤ 5e-3 against the plain version
    (measured 3.9e-3 at the serve shape, 2.8e-3 at the reduced long
    one — enough to flip bf16 output roundings by 1.6e-2, too near the
    2e-2 gate, so the kernel uses two); two terms (hi + lo) move it by
    ≤ 1e-4 (measured ≤ 7.7e-6)."""
    rng = np.random.default_rng(b + s)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16).float()
        for shape in ((b, s, 16, 64), (b, s, 16, 64), (b, s, 16, 64)))
    want = fa.flash_attention_plain(q, k, v)
    assert float((_flash_probs(q, k, v, 0) - want).abs().max()) <= 2e-6
    one = float((_flash_probs(q, k, v, 1) - want).abs().max())
    two = float((_flash_probs(q, k, v, 2) - want).abs().max())
    assert 0 < one <= 5e-3
    assert two <= 1e-4 and two < one / 30


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")


@pytest.mark.cuda
def test_cuda_decode_split_lengths_and_repeats():
    """Batch 1 on the long cache (17 splits): a length of -1 gives
    exactly 0, lengths that leave splits empty match the plain version,
    and a second launch gives the same bits."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(1, 16, 64, device="cuda", generator=g).bfloat16()
    k, v = (torch.randn(1, 1057, 16, 64, device="cuda",
                        generator=g).bfloat16() for _ in range(2))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert da.decode_splits(1, 16, 1057, 64, sms)[0] > 1
    for n in (-1, 0, 63, 64, 500, 1056):
        lens = torch.tensor([n], dtype=torch.int32, device="cuda")
        got = da.decode_attention(q, k, v, lens)
        again = da.decode_attention(q, k, v, lens)
        want = da.decode_attention_plain(q, k, v, lens)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        if n < 0:
            assert torch.equal(got, torch.zeros_like(got))
        assert float((got.float() - want.float()).abs().max()) <= 2e-2


@pytest.mark.cuda
def test_cuda_flash_bf16_repeats_bitwise():
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = (torch.randn(2, 300, 16, 64, device="cuda",
                           generator=g).bfloat16() for _ in range(3))
    first = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(first, fa.flash_attention(q, k, v))
