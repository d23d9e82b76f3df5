"""The port's attention kernels B3 (``flash_attention``) and B4
(``decode_attention``) against the reference's oracles.

On the CPU the wrappers take their plain versions, which follow the
Pallas kernels' arithmetic in float32; they are held against
``repro.kernels.ref`` on the same numpy inputs at the tolerances of
tests/test_kernels.py (float32 2e-5, bf16 2e-2 max abs), and in one
case each against the Pallas kernel itself in interpret mode.  The
CUDA kernels are held against the plain versions in the ``cuda``-marked
tests, which skip without a GPU (and in chip_smoke.py on the card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ref import decode_attention_ref, flash_attention_ref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (batch, seq, heads, kv heads, head_dim, causal, window): GQA groups 1
# and 3, seq lengths that are no multiple of any tile
FLASH_CASES = [
    (2, 37, 6, 2, 32, True, 0),
    (1, 50, 4, 4, 64, False, 0),
    (2, 45, 6, 2, 32, True, 8),
    (1, 33, 3, 1, 16, False, 5),
]
# (batch, cache, heads, kv heads, head_dim, window, ragged lengths)
DECODE_CASES = [
    (3, 37, 6, 2, 32, 0, [0, 17, 36]),
    (3, 41, 4, 4, 64, 5, [3, 40, 20]),
    (2, 53, 3, 1, 16, 0, [52, 7]),
]


def _inputs(seed, *shapes, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":
        # round once, so both packages start from the same bf16 values
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in arrs]
    return arrs


def _jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[str(c) for c in FLASH_CASES])
def test_flash_plain_matches_reference_oracle(case, dtype):
    b, s, h, kv, hd, causal, window = case
    q, k, v = _inputs(s, (b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd),
                      dtype=dtype)
    want = flash_attention_ref(*(_jax(x, dtype) for x in (q, k, v)),
                               causal=causal, window=window)
    got = fa.flash_attention(*(_torch(x, dtype) for x in (q, k, v)),
                             causal=causal, window=window)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (b, s, h, hd)
    # measured max abs error: ≤ 6e-7 (float32), ≤ 4e-3 (bf16: one bf16
    # ulp of the output, where the oracle's softmax rounds otherwise)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=[str(c[:6]) for c in DECODE_CASES])
def test_decode_plain_matches_reference_oracle(case, dtype):
    b, s, h, kv, hd, window, lengths = case
    q, k, v = _inputs(s, (b, h, hd), (b, s, kv, hd), (b, s, kv, hd),
                      dtype=dtype)
    lens = np.asarray(lengths, np.int32)
    want = decode_attention_ref(*(_jax(x, dtype) for x in (q, k, v)),
                                jnp.asarray(lens), window=window)
    got = da.decode_attention(*(_torch(x, dtype) for x in (q, k, v)),
                              torch.from_numpy(lens), window=window)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, h, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.parametrize("lengths,window", [([-1, 4], 0), ([60, 4], 8)],
                         ids=["before-the-cache", "outside-the-window"])
def test_decode_row_with_no_admitted_position_is_zero(lengths, window):
    """Row 0 admits no cache position (its length is -1, or the window
    ends before the cache does): the kernel's contract is 0, not the
    uniform average a plain softmax would give."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(
        3, (2, 4, 32), (2, 40, 2, 32), (2, 40, 2, 32)))
    out = da.decode_attention(q, k, v, torch.tensor(lengths,
                                                    dtype=torch.int32),
                              window=window)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert bool(out[1].abs().sum() > 0)


def test_flash_plain_matches_pallas_kernel_interpret():
    """One case against the Pallas kernel itself (interpret mode)."""
    q, k, v = _inputs(11, (1, 32, 4, 32), (1, 32, 2, 32), (1, 32, 2, 32))
    want = pallas_flash(*(jnp.asarray(x) for x in (q, k, v)), causal=True,
                        window=12, bq=16, bk=16, interpret=True)
    got = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=True, window=12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_decode_plain_matches_pallas_kernel_interpret():
    q, k, v = _inputs(12, (2, 6, 32), (2, 64, 2, 32), (2, 64, 2, 32))
    lens = np.asarray([10, 63], np.int32)
    want = pallas_decode(*(jnp.asarray(x) for x in (q, k, v)),
                         jnp.asarray(lens), bk=32, interpret=True)
    got = da.decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_flash_queries_in_chunks_equal_one_pass(monkeypatch):
    """The plain version scores Q_CHUNK rows at a time; chunking changes
    no bit of the output."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(
        13, (1, 40, 4, 32), (1, 40, 2, 32), (1, 40, 2, 32)))
    whole = fa.flash_attention_plain(q, k, v, window=9)
    monkeypatch.setattr(fa, "Q_CHUNK", 16)
    assert torch.equal(fa.flash_attention_plain(q, k, v, window=9), whole)


def _flash_args(dtype=torch.float32, h=4, kv=2):
    g = torch.Generator().manual_seed(0)
    return (torch.randn(1, 8, h, 32, generator=g).to(dtype),
            torch.randn(1, 8, kv, 32, generator=g).to(dtype),
            torch.randn(1, 8, kv, 32, generator=g).to(dtype))


def _decode_args(dtype=torch.float32, h=4, kv=2,
                 lengths_dtype=torch.int32):
    g = torch.Generator().manual_seed(0)
    return (torch.randn(2, h, 32, generator=g).to(dtype),
            torch.randn(2, 8, kv, 32, generator=g).to(dtype),
            torch.randn(2, 8, kv, 32, generator=g).to(dtype),
            torch.tensor([3, 7], dtype=lengths_dtype))


@pytest.mark.parametrize("bad", ["float16", "int", "noncontiguous",
                                 "uneven-heads", "mixed-dtype", "meta"])
def test_flash_wrapper_refuses(bad):
    q, k, v = _flash_args()
    if bad == "float16":
        q, k, v = (t.half() for t in (q, k, v))
    elif bad == "int":
        q, k, v = (t.int() for t in (q, k, v))
    elif bad == "noncontiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "uneven-heads":
        q, k, v = _flash_args(h=5, kv=2)
    elif bad == "mixed-dtype":
        k = k.to(torch.bfloat16)
    elif bad == "meta":
        q, k, v = (t.to("meta") for t in (q, k, v))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)


@pytest.mark.parametrize("bad", ["float16", "lengths-int64", "uneven-heads",
                                 "meta"])
def test_decode_wrapper_refuses(bad):
    args = _decode_args()
    if bad == "float16":
        args = (*(t.half() for t in args[:3]), args[3])
    elif bad == "lengths-int64":
        args = _decode_args(lengths_dtype=torch.int64)
    elif bad == "uneven-heads":
        args = _decode_args(h=3, kv=2)
    elif bad == "meta":
        args = tuple(t.to("meta") for t in args)
    with pytest.raises(ValueError):
        da.decode_attention(*args)


def test_kernel_launch_guards_without_the_card():
    """What the CUDA route refuses before it reaches the card: head
    widths it is not compiled for, misaligned pointers, and more query
    heads per kv head than a decode block serves."""
    with pytest.raises(ValueError, match="head_dim"):
        fa.launchable("flash_attention", 80)
    x = torch.zeros(9)
    with pytest.raises(ValueError, match="aligned"):
        fa.launchable("flash_attention", 64, x[1:])
    q, k, v, lens = _decode_args(h=18, kv=2)
    with pytest.raises(ValueError, match="query heads per kv head"):
        da._launch(q, k, v, lens, torch.empty_like(q), 0)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = (fa.flash_attention.launches, da.decode_attention.launches)
    q, k, v = _flash_args()
    assert torch.equal(fa.flash_attention(q, k, v, window=3),
                       fa.flash_attention_plain(q, k, v, window=3))
    args = _decode_args()
    assert torch.equal(da.decode_attention(*args, window=4),
                       da.decode_attention_plain(*args, window=4))
    assert (fa.flash_attention.launches,
            da.decode_attention.launches) == before


def test_launch_counters_count_one_per_launch(monkeypatch):
    """On the kernel route each call counts exactly one launch; the
    launch itself is stubbed here (no card)."""
    launched = []
    for mod in (fa, da):
        monkeypatch.setattr(mod, "kernel_device", lambda t, name: True)
        monkeypatch.setattr(mod, "_launch",
                            lambda *a, m=mod: launched.append(m))
    monkeypatch.setattr(fa.flash_attention, "launches", 0)
    monkeypatch.setattr(da.decode_attention, "launches", 0)
    for _ in range(3):
        fa.flash_attention(*_flash_args())
    da.decode_attention(*_decode_args())
    assert fa.flash_attention.launches == 3
    assert da.decode_attention.launches == 1
    assert launched == [fa, fa, fa, da]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_matches_plain(dtype):
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)
    # ragged S (77, 300: no multiple of the 64-row bf16 tiles) and
    # phi4-mini's GQA heads (24 over 8, hd 128)
    for b, s, h, kv, hd, causal, window in [(3, 37, 16, 16, 64, True, 0),
                                            (2, 100, 24, 8, 128, True, 16),
                                            (2, 70, 6, 2, 32, False, 9),
                                            (2, 77, 16, 16, 64, True, 0),
                                            (2, 300, 16, 16, 64, True, 0),
                                            (2, 300, 24, 8, 128, True, 0)]:
        q = torch.randn(b, s, h, hd, device="cuda", generator=g).to(dtype)
        k = torch.randn(b, s, kv, hd, device="cuda", generator=g).to(dtype)
        v = torch.randn(b, s, kv, hd, device="cuda", generator=g).to(dtype)
        n = fa.flash_attention.launches
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == n + 1
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
        err = float((got.float() - want.float()).abs().max())
        assert err <= TOL[str(dtype).split(".")[1]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_matches_plain(dtype):
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(2)
    # batch 1 on the long cache splits it across blocks (splits > 1)
    for b, s, h, kv, hd, window in [(4, 37, 16, 16, 64, 0),
                                    (5, 300, 24, 8, 128, 20),
                                    (1, 1057, 16, 16, 64, 0),
                                    (2, 1057, 24, 8, 128, 300)]:
        q = torch.randn(b, h, hd, device="cuda", generator=g).to(dtype)
        k = torch.randn(b, s, kv, hd, device="cuda", generator=g).to(dtype)
        v = torch.randn(b, s, kv, hd, device="cuda", generator=g).to(dtype)
        lens = torch.randint(-1, s, (b,), device="cuda", generator=g,
                             dtype=torch.int32)
        n = da.decode_attention.launches
        got = da.decode_attention(q, k, v, lens, window=window)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == n + 1
        want = da.decode_attention_plain(q, k, v, lens, window=window)
        err = float((got.float() - want.float()).abs().max())
        assert err <= TOL[str(dtype).split(".")[1]]
