"""The arithmetic of the absorbed MLA decode kernel
(``csrc/mla_decode.cu``) on the CPU.

The kernel runs both products on the TF32 tensor cores: the scores
``Q (16 x 576) · [c_kv ‖ k_pe]ᵀ`` and the context ``P (16 x T) ·
c_kv``.  q and P are float32, each split into ``big`` (x rounded to
TF32: to nearest, ties away from zero, the low 13 bits cleared) and
``small = x - big``, which the tensor cores read truncated.  A bf16
cache value is exact in TF32, so a bf16 cache takes two products a
product (small·c + big·c), a float32 cache three (3xTF32).  The tensor
cores' float32 sums truncate: the emulation rounds every m16n8k8 sum
toward zero, as the kernel's fragments see it, and adds the kernel's
round-to-nearest sums where it makes them (a 32-wide depth group's
products, the small and big terms apart, into the scores; the two
depth halves; a tile's P·V into the context as ``o·alpha + tile``),
with the kernel's grouping of the depths into k-steps.

A test-local emulation of the kernel's walk — 64-position tiles (32
for a float32 cache) with the online softmax, the split cache axis of
``mla_splits`` and the last block's merge in split order — is held
within the card's 2e-5 gate of ``mla_decode_attention_plain`` and of
the JAX reference's einsum chain, over bf16 and float32 caches, a
window, ragged lengths with −1, 0, S − 1 and S + 5, and batch 1 with
many splits; at one shape it replaces the kernel inside the port's MLA
block against ``repro.models.attention.mla_decode``.  One case shows
that a single TF32 term (big·big alone) misses the gate, and one that
the other route the kernel could take, m16n8k16 bf16 with q and P as
three bf16 terms each, also holds it (the kernel takes TF32: one
instruction stream for both caches, and the float32 cache needs 3xTF32
anyway).
"""
import dataclasses

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
from repro_torch.kernels import mla_decode as md
from repro_torch.models import attention as pt_attn

GATE = 2e-5
SCALE = 192 ** -0.5
NEG_INF = np.float32(md.NEG_INF)
H, R, P = 16, 512, 64


# ------------------------------------------------------------ rounding

def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` as the kernel does it: half an ulp added to
    the magnitude bits, the low 13 bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncated(x: torch.Tensor) -> torch.Tensor:
    """A float32 value as the tensor cores read a TF32 operand."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, truncated(x - big)


def bf16_terms(x: torch.Tensor, n: int = 3):
    """x as ``n`` bf16 terms, each the remainder's nearest."""
    out, rest = [], x.float()
    for _ in range(n):
        t = rest.bfloat16().float()
        out.append(t)
        rest = rest - t
    return out


def rz(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32 toward zero: a tensor-core sum."""
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def mma(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, eq: str):
    """One mma.sync: ``c + einsum(eq, a, b)`` over its k-step, exact,
    then truncated."""
    return rz(c.double() + torch.einsum(eq, a.double(), b.double()))


# ------------------------------------------------------------- the walk

def _groups(k: int):
    """The depth indices of each k-step of each 32-wide depth group, as
    the kernel relabels them: lane c's 8 depths of group grp start at
    32 grp + 8 c (one 16-byte chunk of a bf16 row, two of a float32
    one), and k-step i takes depths first + 2i and first + 2i + 1 of
    every lane.  The first half of the groups is one depth half, the
    rest the other."""
    return [[torch.tensor([32 * grp + 8 * c + 2 * i + e for c in range(4)
                           for e in range(2)]) for i in range(4)]
            for grp in range(k // 32)]


def _scores(q, kc, route):
    """Raw scores (B, H, T) of q (B, H, K) against the tile's keys
    (B, T, K): per depth half, per group of 32, the small and big terms'
    products in zeroed fragments, added in round-to-nearest; then the
    halves.  ``route``: "tf32" (2 terms for a bf16 cache, 3 for
    float32), "one" (big·big alone) or "bf16" (m16n8k16, q as three bf16
    terms, the bf16 cache exact)."""
    b, h, k = q.shape
    t = kc.shape[1]
    assert k % 64 == 0, "whole groups of 32 in each depth half"
    eq = "bhd,btd->bht"
    exact_cache = bool((truncated(kc) == kc).all())
    groups = _groups(k)
    halves = []
    for part in (groups[:len(groups) // 2], groups[len(groups) // 2:]):
        sc = torch.zeros(b, h, t)
        for steps in part:
            lo, hi = torch.zeros(b, h, t), torch.zeros(b, h, t)
            if route == "bf16":
                # the high term in one fragment, the two others in another
                idx = torch.cat(steps)
                big, mid, low = bf16_terms(q[..., idx])
                for s0 in range(0, 32, 16):
                    c = kc[..., idx[s0:s0 + 16]]
                    lo = mma(lo, low[..., s0:s0 + 16], c, eq)
                    lo = mma(lo, mid[..., s0:s0 + 16], c, eq)
                    hi = mma(hi, big[..., s0:s0 + 16], c, eq)
                sc = sc + (lo + hi)
                continue
            for idx in steps:
                (qb, qs), (cb, cs) = split(q[..., idx]), split(kc[..., idx])
                if route == "one":
                    hi = mma(hi, qb, cb, eq)
                    continue
                lo = mma(lo, qs, cb, eq)
                if not exact_cache:
                    lo = mma(lo, qb, cs, eq)
                hi = mma(hi, qb, cb, eq)
            sc = sc + (lo + hi)
        halves.append(sc)
    return halves[0] + halves[1]


def _pv(p, v, route):
    """The tile's P·V (B, H, R) in zeroed fragments, k-steps of 8
    positions (16 for the bf16 route), the small term first."""
    b, h, t = p.shape
    eq = "bht,btr->bhr"
    ot = torch.zeros(b, h, v.shape[2])
    exact_cache = bool((truncated(v) == v).all())
    if route == "bf16":
        for s0 in range(0, t, 16):
            vs = v[:, s0:s0 + 16]
            for pt in reversed(bf16_terms(p[..., s0:s0 + 16])):
                ot = mma(ot, pt, vs, eq)
        return ot
    for s0 in range(0, t, 8):
        (pb, ps), (vb, vsm) = split(p[..., s0:s0 + 8]), split(v[:, s0:s0 + 8])
        if route == "one":
            ot = mma(ot, pb, vb, eq)
            continue
        ot = mma(ot, ps, vb, eq)
        if not exact_cache:
            ot = mma(ot, pb, vsm, eq)
        ot = mma(ot, pb, vb, eq)
    return ot


def _block(q, c_kv, k_pe, lo, hi, tile, route, scale):
    """One block's walk over positions [lo, hi) (per row): its (m, l,
    acc) in float32.  lo and hi are (B,) int tensors."""
    b, h, _ = q.shape
    r = c_kv.shape[2]
    m = torch.full((b, h), float(NEG_INF))
    l = torch.zeros(b, h)
    o = torch.zeros(b, h, r)
    keys = torch.cat([c_kv, k_pe], -1).float()
    n = int((hi - lo).clamp(min=0).max())
    ar = torch.arange(tile)
    for i0 in range(0, n, tile):
        pos = lo[:, None] + i0 + ar[None, :]                     # (B, T)
        ok = pos < hi[:, None]
        idx = pos.clamp(max=keys.shape[1] - 1)
        kc = torch.where(ok[..., None], torch.gather(
            keys, 1, idx[..., None].expand(-1, -1, keys.shape[2])), 0.0)
        s = _scores(q, kc, route) * np.float32(scale)
        s = torch.where(ok[:, None, :], s, float(NEG_INF))
        mn = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - mn)
        p = torch.where(ok[:, None, :], torch.exp(s - mn[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        ot = _pv(p, kc[..., :r], route)
        o = (o.double() * alpha[..., None].double() + ot.double()).float()
        m = mn
    return m, l, o


def emulate(q_abs, q_pe, c_kv, k_pe, lengths, window=0, sms=132,
            route="tf32", scale=SCALE):
    """The kernel's output: the split cache axis of ``mla_splits``
    (tiles of 64 positions, 32 for a float32 cache), each split's
    block, and the merge in split order."""
    b, s = c_kv.shape[:2]
    tile = md.TILE if c_kv.dtype == torch.bfloat16 else md.TILE // 2
    splits, chunk = md.mla_splits(b, s, sms)
    q = torch.cat([q_abs, q_pe], -1)
    n = lengths.long()
    hi_all = torch.minimum(torch.full_like(n, s), n + 1)
    lo_all = (n - window + 1).clamp(min=0) if window else torch.zeros_like(n)
    parts = []
    for z in range(splits):
        lo = torch.maximum(lo_all, torch.full_like(n, z * chunk))
        hi = torch.minimum(hi_all, torch.full_like(n, (z + 1) * chunk))
        parts.append(_block(q, c_kv.float(), k_pe.float(), lo, hi, tile,
                            route, scale))
    if splits == 1:
        m, l, o = parts[0]
        return o / (l + np.float32(1e-30))[..., None]
    top = torch.stack([p_[0] for p_ in parts]).amax(0)
    l = torch.zeros_like(top)
    acc = torch.zeros_like(parts[0][2])
    for m_z, l_z, a_z in parts:
        w = torch.exp(m_z - top)
        l = (l_z.double() * w.double() + l.double()).float()
        acc = (a_z.double() * w[..., None].double() + acc.double()).float()
    return acc / (l + np.float32(1e-30))[..., None]


# ------------------------------------------------------------ inputs

def _inputs(seed, b, s, dtype):
    rng = np.random.default_rng(seed)
    f = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
         for shape in ((b, H, R), (b, H, P), (b, s, R), (b, s, P))]
    return f[0], f[1], f[2].to(dtype), f[3].to(dtype)


def _err(got, want) -> float:
    return float((got - want).abs().max())


# (batch, cache, lengths, window, sms)
CASES = {
    "serve": (4, 37, [35, 34, 33, 32], 0, 132),
    "ragged_edges": (6, 150, [-1, 0, 63, 149, 155, 100], 0, 132),
    "window": (4, 200, [199, 150, 40, 0], 37, 132),
    "batch1_splits": (1, 1057, [1055], 0, 132),
    "batch1_many_splits": (1, 700, [699], 0, 528),
    "ragged_splits": (3, 523, [-1, 300, 522], 100, 132),
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", list(CASES))
def test_emulated_kernel_holds_the_gate(name, dtype):
    """The emulated walk, splits and merge within a quarter of the 2e-5
    gate of the plain version; rows of length −1 exactly 0."""
    b, s, lens, window, sms = CASES[name]
    q_abs, q_pe, c_kv, k_pe = _inputs(11, b, s, getattr(torch, dtype))
    lengths = torch.tensor(lens, dtype=torch.int32)
    want = md.mla_decode_attention_plain(q_abs, q_pe, c_kv, k_pe, lengths,
                                         scale=SCALE, window=window)
    got = emulate(q_abs, q_pe, c_kv, k_pe, lengths, window, sms)
    assert _err(got, want) <= GATE / 4, _err(got, want)
    empty = [i for i, n in enumerate(lens) if n < 0]
    assert bool((got[empty] == 0).all())
    if name.startswith("batch1"):
        assert md.mla_splits(b, s, sms)[0] >= 5


def _chain_ref(q_abs, q_pe, c_kv, k_pe, lengths, scale, window):
    """The reference's einsum chain of ``mla_decode`` from q_abs to the
    context (as ``tests/test_torch_mla.py`` runs it)."""
    q_abs, q_pe = jnp.asarray(q_abs)[:, None], jnp.asarray(q_pe)[:, None]
    c = jnp.asarray(c_kv).astype(jnp.float32)
    sc = jnp.einsum("bshr,btr->bsht", q_abs, c)
    sc += jnp.einsum("bshk,btk->bsht", q_pe,
                     jnp.asarray(k_pe).astype(jnp.float32))
    sc *= scale
    lengths = jnp.asarray(lengths)
    mask = ref_attn._mask(lengths[:, None], jnp.arange(c.shape[1])[None, :],
                          causal=True, window=window, kv_len=None)
    pattn = ref_attn._masked_softmax(sc, mask[:, :, None, :])
    return np.asarray(jnp.einsum("bsht,btr->bshr", pattn, c))[:, 0]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_emulated_kernel_matches_the_reference_chain(dtype):
    """Against the JAX reference's own chain on the same numpy inputs
    (a bf16 cache as its float32 values), ragged, under a window, split."""
    b, s, window = 4, 300, 90
    q_abs, q_pe, c_kv, k_pe = _inputs(12, b, s, getattr(torch, dtype))
    lens = np.asarray([-1, 0, 170, s + 5], np.int32)
    want = _chain_ref(q_abs.numpy(), q_pe.numpy(), c_kv.float().numpy(),
                      k_pe.float().numpy(), lens, SCALE, window)
    got = emulate(q_abs, q_pe, c_kv, k_pe, torch.from_numpy(lens), window,
                  sms=16)
    assert md.mla_splits(b, s, 16)[0] > 1
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GATE / 2)


def test_emulated_kernel_inside_the_mla_block():
    """The emulation in place of the kernel inside the port's MLA decode
    against ``repro.models.attention.mla_decode``, reduced
    deepseek-v2-lite-16b with a rope width of 64 (so each depth half is
    whole groups of 32), float32, ragged lengths."""
    arch = "deepseek-v2-lite-16b"
    cfg = reduced(get_config(arch))
    cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
        cfg.mla, qk_rope_head_dim=64))
    pcfg = pt_reduced(pt_get_config(arch))
    pcfg = dataclasses.replace(pcfg, mla=dataclasses.replace(
        pcfg.mla, qk_rope_head_dim=64))
    params = ref_build(cfg).init(jax.random.PRNGKey(3))
    pparams = model_params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    p, pp = params["lead"][0]["attn"], pparams.layers[0]["attn"]
    m = cfg.mla
    b, s = 3, 70
    rng = np.random.default_rng(13)
    cache = {"c_kv": rng.standard_normal((b, s, m.kv_lora_rank)),
             "k_pe": rng.standard_normal((b, s, m.qk_rope_head_dim))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    lens = np.asarray([5, 69, 40], np.int32)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    want, _ = ref_attn.mla_decode(
        p, cfg, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(lens))
    calls = []

    def kernel(q_abs, q_pe, c_kv, k_pe, lengths, *, scale, window=0):
        calls.append(scale)
        return emulate(q_abs, q_pe, c_kv, k_pe, lengths, window, sms=4,
                       scale=scale)

    pc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    orig = pt_attn.mla_decode_attention
    pt_attn.mla_decode_attention = kernel
    try:
        with torch.inference_mode():
            got, _ = pt_attn.mla_decode(pp, pcfg, torch.from_numpy(x), pc,
                                        torch.from_numpy(lens))
    finally:
        pt_attn.mla_decode_attention = orig
    assert calls
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_one_tf32_term_misses_the_gate():
    """big·big alone, in both products, misses the 2e-5 gate several
    times over at the serve shape's widths; the kernel's terms stay
    under a quarter of it."""
    q_abs, q_pe, c_kv, k_pe = _inputs(14, 2, 256, torch.float32)
    lengths = torch.tensor([255, 200], dtype=torch.int32)
    want = md.mla_decode_attention_plain(q_abs, q_pe, c_kv, k_pe, lengths,
                                         scale=SCALE)
    one = emulate(q_abs, q_pe, c_kv, k_pe, lengths, route="one")
    three = emulate(q_abs, q_pe, c_kv, k_pe, lengths)
    assert _err(one, want) > 3 * GATE, _err(one, want)
    assert _err(three, want) <= GATE / 4


def test_the_bf16_route_also_holds_the_gate():
    """The alternative route: m16n8k16 bf16 with q and P as three bf16
    terms each against the exact bf16 cache.  It holds the gate as well
    (so the choice of TF32 rests on one code path for both caches, not
    on precision)."""
    q_abs, q_pe, c_kv, k_pe = _inputs(15, 2, 256, torch.bfloat16)
    lengths = torch.tensor([255, 130], dtype=torch.int32)
    want = md.mla_decode_attention_plain(q_abs, q_pe, c_kv, k_pe, lengths,
                                         scale=SCALE)
    got = emulate(q_abs, q_pe, c_kv, k_pe, lengths, route="bf16")
    assert _err(got, want) <= GATE / 4, _err(got, want)


# ------------------------------------------------------------- splits

@pytest.mark.parametrize("b,s,want", [
    (32, 37, 1),          # serve_mla: one tile, no merge
    (16, 37, 1),
    (1, 37, 1),
    (32, 1057, 4),        # the long cache: 128 blocks, one wave
    (1, 1057, 17),        # batch 1: one tile a block
    (8, 523, 9),
])
def test_split_rule(b, s, want):
    """At 132 SMs: one wave where it can, the fewest splits on a tie,
    whole 64-position tiles covering the cache."""
    splits, chunk = md.mla_splits(b, s, 132)
    assert splits == want
    assert chunk % md.TILE == 0 and splits * chunk >= s
    assert (splits - 1) * chunk < s and splits <= md.MAX_SPLITS
