"""B5's backward (``repro_torch.kernels.ssd_scan``) on the CPU: the plain
backward against autograd and against the reference, the bf16 rounding,
and the dispatch that puts the CUDA kernels under autograd.

``ssd_scan_backward_plain`` writes the backward kernel's algebra out in
plain torch.  It is held against ``torch.autograd.grad`` of
``ssd_scan_plain`` within 1e-5 of each gradient's largest magnitude,
and against ``jax.vjp`` of the reference model's ``_ssd_chunked`` with
numpy cotangents ``(dy, dh_end)`` within 1e-4 · max|g| + 1e-6 (the
``TOL`` of ``tests/test_torch_train.py``): a ragged grouped case and a
longer one, chunks of 64 and 256, ``dh_end`` zero and non-zero.

dA is the one gradient held elsewhere.  It is a sum over batch and
time of ``dt · da``, where ``da`` is the gradient of the step's ``a = dt
· A``, and the terms can be far larger than their sum: float32 rounding
of such a sum scales with the terms, not with the result.  Autograd of
the float32 forward forms each ``da`` from row sums less column sums of
a chunk's pair terms, which cancel; against the float64 recurrence its
dA is off by up to 1e-4 of max|dA| on one of these inputs.  The plain
backward (and the kernel) sums each ``da`` without cancellation.  dA is
held against the float64 recurrence within 1e-5 of each head's Σ |dt ·
da|.  torch's CPU ``cumsum`` accumulates float32 in float64 and XLA's
in float32 (a ROADMAP difference): the reference's gradients differ in
the last bits by that too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SSMConfig
from repro.models import mamba2 as ref_mamba2
from repro_torch.kernels import ssd_scan as ss

# (batch, seq, heads, groups, head_dim, d_state)
SHAPES = {"ragged-grouped": (2, 100, 8, 2, 32, 16),
          "long": (1, 300, 4, 1, 64, 16)}
CHUNKS = (64, 256)
NAMES = ("dx", "ddt", "dA", "dB", "dC")
PLAIN_TOL = 1e-5
REF_TOL = 1e-4


def _inputs(seed, b, s, nh, g, hd, ds):
    """tests/test_kernels.py's distributions and standard-normal
    cotangents, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, hd)) * 0.5
    dt = np.logaddexp(rng.standard_normal((b, s, nh)), 0.0)
    a = -np.exp(rng.standard_normal(nh) * 0.3)
    bm = rng.standard_normal((b, s, g, ds)) * 0.3
    cm = rng.standard_normal((b, s, g, ds)) * 0.3
    dy = rng.standard_normal((b, s, nh, hd))
    dh = rng.standard_normal((b, nh, hd, ds))
    return [v.astype(np.float32) for v in (x, dt, a, bm, cm, dy, dh)]


def _recurrence64(x, dt, ad, bm, cm):
    """The exact SSM recurrence, step by step, with the decay exponents
    ``ad = dt·A`` given."""
    rep = x.shape[2] // bm.shape[2]
    bh, ch = (t.repeat_interleave(rep, dim=2) for t in (bm, cm))
    h = torch.zeros(x.shape[0], x.shape[2], x.shape[3], bm.shape[3],
                    dtype=x.dtype)
    ys = []
    for t in range(x.shape[1]):
        h = (h * torch.exp(ad[:, t])[..., None, None]
             + (dt[:, t, :, None] * x[:, t])[..., None] * bh[:, t, :, None])
        ys.append(torch.einsum("bhds,bhs->bhd", h, ch[:, t]))
    return torch.stack(ys, 1), h


def _exact(x, dt, a, bm, cm, dy, dh):
    """The five gradients of the recurrence in float64, and each head's
    Σ |dt · da| over batch and time, the scale of dA's terms."""
    leaves = [t.double().requires_grad_(True) for t in (x, dt, a, bm, cm)]
    ad = leaves[1] * leaves[2]
    y, h = _recurrence64(leaves[0], leaves[1], ad, *leaves[3:])
    outs, cots = [y], [dy.double()]
    if dh is not None:
        outs, cots = outs + [h], cots + [dh.double()]
    *grads, da = torch.autograd.grad(outs, leaves + [ad], cots)
    return grads, (leaves[1].detach() * da).abs().sum((0, 1))


def _grads_of(fn, inputs, dy, dh):
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    y, h = fn(*leaves)
    outs, cots = [y], [dy]
    if dh is not None:
        outs, cots = outs + [h], cots + [dh]
    return torch.autograd.grad(outs, leaves, cots)


def _worst(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return float((got.double() - want.double()).abs().max()
                 / max(float(want.abs().max()), 1e-30))


@pytest.mark.parametrize("with_dh", [False, True], ids=["dh0", "dh"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_backward_matches_autograd(shape, chunk, with_dh):
    arrs = [torch.from_numpy(v) for v in _inputs(7, *SHAPES[shape])]
    x, dt, a, bm, cm, dy, dh = arrs
    dh = dh if with_dh else None
    got = ss.ssd_scan_backward_plain(x, dt, a, bm, cm, dy, dh, chunk)
    want = _grads_of(lambda *t: ss.ssd_scan_plain(*t, chunk),
                     (x, dt, a, bm, cm), dy, dh)
    exact, scale = _exact(x, dt, a, bm, cm, dy, dh)
    for name, g, w, e in zip(NAMES, got, want, exact):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        if name == "dA":
            err = (g.double() - e).abs()
            assert bool((err <= PLAIN_TOL * scale).all()), (err, scale)
        else:
            assert _worst(g, w) <= PLAIN_TOL, name


@pytest.mark.parametrize("with_dh", [False, True], ids=["dh0", "dh"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_backward_matches_the_reference_vjp(shape, chunk, with_dh):
    arrs = _inputs(8, *SHAPES[shape])
    x, dt, a, bm, cm, dy, dh = arrs
    if not with_dh:
        dh = np.zeros_like(dh)
    cfg = SSMConfig(d_state=bm.shape[3], head_dim=x.shape[3],
                    n_groups=bm.shape[2], chunk_size=chunk)
    _, vjp = jax.vjp(lambda *t: ref_mamba2._ssd_chunked(*t, cfg),
                     *(jnp.asarray(v) for v in (x, dt, a, bm, cm)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = ss.ssd_scan_backward_plain(
        *(torch.from_numpy(v) for v in (x, dt, a, bm, cm, dy)),
        torch.from_numpy(dh) if with_dh else None, chunk)
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        err = float(np.abs(g.numpy() - w).max())
        assert err <= REF_TOL * float(np.abs(w).max()) + 1e-6, name


@pytest.mark.parametrize("with_dh", [False, True], ids=["dh0", "dh"])
def test_plain_backward_rounds_bf16_gradients_once(with_dh):
    """On bf16 x, B and C the plain backward computes in float32 from
    the inputs' values and rounds dx, dB and dC once; ddt and dA stay
    float32."""
    arrs = [torch.from_numpy(v) for v in _inputs(9, *SHAPES["ragged-grouped"])]
    x, dt, a, bm, cm, dy, dh = arrs
    dh = dh if with_dh else None
    xb, bb, cb = (t.to(torch.bfloat16) for t in (x, bm, cm))
    got = ss.ssd_scan_backward_plain(xb, dt, a, bb, cb, dy, dh, 64)
    f32 = ss.ssd_scan_backward_plain(xb.float(), dt, a, bb.float(),
                                     cb.float(), dy, dh, 64)
    for name, g, w in zip(NAMES, got, f32):
        want = w.to(torch.bfloat16) if name in ("dx", "dB", "dC") else w
        assert g.dtype == want.dtype and torch.equal(g, want), name


def _args(requires_grad: bool):
    arrs = [torch.from_numpy(v) for v in _inputs(10, 1, 70, 4, 2, 32, 16)]
    x, dt, a, bm, cm = (t.requires_grad_(requires_grad) for t in arrs[:5])
    return (x, dt, a, bm, cm), arrs[5], arrs[6]


def test_cpu_tensors_never_take_the_kernel_route(monkeypatch):
    """On CPU tensors autograd differentiates the plain version: the
    autograd Function is never built and nothing launches."""
    def refuse(*a, **kw):
        raise AssertionError("no kernel route on CPU tensors")

    monkeypatch.setattr(ss._SSDChunkedFn, "apply", refuse)
    monkeypatch.setattr(ss, "_launch", refuse)
    monkeypatch.setattr(ss, "_launch_backward", refuse)
    monkeypatch.setattr(ss.ssd_scan, "launches", 0)
    monkeypatch.setattr(ss.ssd_scan, "backward_launches", 0)
    inputs, dy, dh = _args(True)
    y, h = ss.ssd_chunked(*inputs, 64)
    got = torch.autograd.grad([y, h], inputs, [dy, dh])
    want = _grads_of(lambda *t: ss.ssd_scan_plain(*t, 64),
                     [t.detach() for t in inputs], dy, dh)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name
    assert ss.ssd_scan.launches == 0 and ss.ssd_scan.backward_launches == 0


def _stub_kernels(monkeypatch):
    """The kernel route without a card: the launches write the plain
    versions' results into the wrapper's outputs."""
    calls = []

    def launch(x, dt, A, B, C, y, h):
        want_y, want_h = ss.ssd_scan_plain(x, dt, A, B, C, 64)
        y.copy_(want_y)
        if h is not None:
            h.copy_(want_h)
        calls.append("forward")

    def launch_backward(x, dt, A, B, C, dy, dh_end, *outs):
        for out, g in zip(outs, ss.ssd_scan_backward_plain(
                x, dt, A, B, C, dy, dh_end, 64)):
            out.copy_(g)
        calls.append("backward")

    monkeypatch.setattr(ss, "kernel_device", lambda t, name: True)
    monkeypatch.setattr(ss, "_launch", launch)
    monkeypatch.setattr(ss, "_launch_backward", launch_backward)
    monkeypatch.setattr(ss.ssd_scan, "launches", 0)
    monkeypatch.setattr(ss.ssd_scan, "backward_launches", 0)
    return calls


@pytest.mark.parametrize("with_dh", [False, True], ids=["dh0", "dh"])
def test_kernel_route_counts_one_forward_and_one_backward(monkeypatch,
                                                          with_dh):
    """Under grad, one forward and backward through ``ssd_chunked`` is
    one launch and one backward launch, and autograd hands each input
    its own gradient (an unused final state counts as zero)."""
    calls = _stub_kernels(monkeypatch)
    inputs, dy, dh = _args(True)
    y, h = ss.ssd_chunked(*inputs, 64)
    assert y.grad_fn is not None
    outs, cots = ([y, h], [dy, dh]) if with_dh else ([y], [dy])
    got = torch.autograd.grad(outs, inputs, cots)
    assert calls == ["forward", "backward"]
    assert ss.ssd_scan.launches == 1 and ss.ssd_scan.backward_launches == 1
    want = ss.ssd_scan_backward_plain(*(t.detach() for t in inputs), dy,
                                      dh if with_dh else None, 64)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name


def test_kernel_route_without_grad_saves_nothing(monkeypatch):
    """Under ``no_grad``, or with no input that requires grad (serving),
    the kernel route is one launch and builds no graph."""
    calls = _stub_kernels(monkeypatch)
    inputs, _, _ = _args(True)
    with torch.no_grad():
        y, h = ss.ssd_chunked(*inputs, 64)
    assert y.grad_fn is None and h.grad_fn is None
    y, h = ss.ssd_chunked(*(t.detach() for t in inputs), 64)
    assert y.grad_fn is None
    assert calls == ["forward", "forward"]
    assert ss.ssd_scan.launches == 2 and ss.ssd_scan.backward_launches == 0
    # the reference kernel's API takes the same autograd route under grad
    y = ss.ssd_scan(*inputs, chunk=64)
    assert y.grad_fn is not None and ss.ssd_scan.launches == 3


def test_backward_of_an_empty_sequence_is_empty():
    inputs, dy, _ = _args(False)
    cut = [t[:, :0] if t.dim() > 1 else t for t in inputs]
    got = ss.ssd_scan_backward(*cut, dy[:, :0])
    assert [tuple(g.shape) for g in got] == [
        (1, 0, 4, 32), (1, 0, 4), (4,), (1, 0, 2, 16), (1, 0, 2, 16)]
    assert not got[2].any()
