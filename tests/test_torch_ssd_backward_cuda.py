"""B5's backward kernels and SSM / hybrid train steps on the card, without
the reference (``cuda``-marked: they skip without a GPU; the CPU tests
of the same code are ``tests/test_torch_ssd_backward.py``).

On the card: ``ssd_scan_backward`` against ``ssd_scan_backward_plain``
at each width pair the kernel is built for, ragged lengths, two groups,
B and C as strided views of one activation, ``dh_end`` zero and not
(float32 gradients within 1e-4 of each gradient's largest magnitude,
bf16 ones within 2^-7 of it: both compute in float32 from the same
inputs, and a bf16 gradient is rounded once), twice bitwise, and equal
to autograd through ``ssd_chunked``; the forward under
``inference_mode`` saves nothing and counts no backward; one train step
of reduced mamba2-2.7b and of reduced Jamba launches B5's forward and
backward once a Mamba2 layer each (and B3's once an attention layer),
and, in float32, matches the same step through B5's plain version.
Here, on the CPU, the wrapper's guards and its plain route.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import mamba2 as pt_mamba2
from repro_torch.models import transformer as tfm
from repro_torch.train import loop
from repro_torch.train import optimizer as opt

TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
# (dtype, B, S, heads, groups, head_dim, d_state, dh_end)
CASES = [
    (torch.bfloat16, 2, 256, 8, 1, 64, 128, False),
    (torch.float32, 2, 256, 8, 1, 64, 128, True),
    (torch.bfloat16, 2, 200, 16, 1, 64, 16, True),
    (torch.float32, 1, 130, 16, 1, 64, 16, False),
    (torch.bfloat16, 1, 1023, 8, 2, 32, 16, True),
    (torch.float32, 3, 65, 4, 2, 32, 16, False),
    (torch.float32, 1, 7, 4, 1, 32, 16, True),
]
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")


def _inputs(dev, dtype, b, s, nh, g, hd, ds, seed):
    """tests/test_kernels.py's distributions; B and C are strided slices
    of one (b, s, 2·g·ds) activation, as the model passes them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(b, s, nh, hd, device=dev, generator=gen) * 0.5
         ).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, nh, device=dev, generator=gen))
    a = -torch.exp(torch.randn(nh, device=dev, generator=gen) * 0.3)
    bc = (torch.randn(b, s, 2 * g * ds, device=dev, generator=gen) * 0.3
          ).to(dtype)
    dy = torch.randn(b, s, nh, hd, device=dev, generator=gen)
    dh = torch.randn(b, nh, hd, ds, device=dev, generator=gen)
    return (x, dt, a, bc[..., :g * ds].reshape(b, s, g, ds),
            bc[..., g * ds:].reshape(b, s, g, ds), dy, dh)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES,
                         ids=[str(i) for i in range(len(CASES))])
def test_cuda_backward_matches_plain_twice_bitwise(case):
    _need_cuda()
    dtype, b, s, nh, g, hd, ds, with_dh = case
    x, dt, a, bm, cm, dy, dh = _inputs("cuda", dtype, b, s, nh, g, hd, ds,
                                       seed=s)
    dh = dh if with_dh else None
    before = ss.ssd_scan.backward_launches
    got = ss.ssd_scan_backward(x, dt, a, bm, cm, dy, dh)
    again = ss.ssd_scan_backward(x, dt, a, bm, cm, dy, dh)
    want = ss.ssd_scan_backward_plain(x, dt, a, bm, cm, dy, dh)
    torch.cuda.synchronize()
    assert ss.ssd_scan.backward_launches == before + 2
    for name, k, k2, w in zip(NAMES, got, again, want):
        assert k.dtype == w.dtype and k.shape == w.shape, name
        assert torch.equal(k, k2), name
        tol = TOL[k.dtype] * max(float(w.float().abs().max()), 1e-6)
        assert float((k.float() - w.float()).abs().max()) <= tol, name
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, dt, a, bm, cm)]
    y, h = ss.ssd_chunked(*leaves, 256)
    torch.autograd.backward([y, h] if with_dh else [y],
                            [dy, dh] if with_dh else [dy])
    for name, leaf, k in zip(NAMES, leaves, got):
        assert torch.equal(leaf.grad, k), name


@pytest.mark.cuda
def test_cuda_serving_forward_saves_nothing():
    _need_cuda()
    x, dt, a, bm, cm, _, _ = _inputs("cuda", torch.bfloat16, 1, 64, 8, 1,
                                     64, 128, seed=3)
    x.requires_grad_(True)
    launches = ss.ssd_scan.launches
    with torch.inference_mode():
        y, h = ss.ssd_chunked(x, dt, a, bm, cm, 256)
    assert y.grad_fn is None and h.grad_fn is None
    with torch.no_grad():
        assert ss.ssd_chunked(x, dt, a, bm, cm, 256)[0].grad_fn is None
    assert ss.ssd_chunked(x, dt, a, bm, cm, 256)[0].grad_fn is not None
    assert ss.ssd_scan(x, dt, a, bm, cm).grad_fn is not None
    assert ss.ssd_scan.launches == launches + 4


def _step(cfg, dev, plain: bool):
    model = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 96), device=dev,
                              generator=g) for k in ("tokens", "labels")}
    grads = {}
    real = loop.apply_updates

    def captured(c, params, gr, state, decay):
        grads.update({n: t.detach().clone() for n, t in gr.items()})
        return real(c, params, gr, state, decay)

    def plain_ssd(x, dt, A, B, C, chunk):
        return ss.ssd_scan_plain(x, dt, A, B, C, chunk)

    loop.apply_updates = captured
    if plain:
        pt_mamba2.ssd_chunked = plain_ssd
    try:
        model, _, m = loop.make_train_step(cfg, opt.AdamWConfig())(
            model, opt.init_state(model), batch)
        torch.cuda.synchronize()
    finally:
        loop.apply_updates = real
        pt_mamba2.ssd_chunked = ss.ssd_chunked
    return m, grads


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_cuda_train_step_runs_b5_forward_and_backward_once_a_layer(arch):
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    kinds = cfg.layer_kinds()
    ss.ssd_scan.launches = ss.ssd_scan.backward_launches = 0
    fa.flash_attention.launches = fa.flash_attention.backward_launches = 0
    m, grads = _step(cfg, "cuda", plain=False)
    n_ssm = ss.ssd_scan.launches
    assert n_ssm == kinds.count("ssm") == ss.ssd_scan.backward_launches
    assert (fa.flash_attention.launches == fa.flash_attention.backward_launches
            == kinds.count("attn"))
    assert all(bool(torch.isfinite(t)) for t in m.values())
    m_plain, grads_plain = _step(cfg, "cuda", plain=True)
    assert ss.ssd_scan.launches == n_ssm
    assert abs(float(m["loss"]) - float(m_plain["loss"])) \
        <= 1e-6 * abs(float(m_plain["loss"]))
    for n, g in grads_plain.items():
        tol = 1e-4 * float(g.abs().max()) + 1e-6
        assert float((grads[n] - g).abs().max()) <= tol, n


def test_backward_wrapper_guards_and_plain_route():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; a dy or dh_end of the wrong shape raises."""
    x, dt, a, bm, cm, dy, dh = _inputs("cpu", torch.float32, 1, 70, 4, 2,
                                       32, 16, seed=5)
    before = ss.ssd_scan.backward_launches
    got = ss.ssd_scan_backward(x, dt, a, bm, cm, dy, dh, chunk=64)
    want = ss.ssd_scan_backward_plain(x, dt, a, bm, cm, dy, dh, chunk=64)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ss.ssd_scan.backward_launches == before
    with pytest.raises(ValueError, match="dy must be"):
        ss.ssd_scan_backward(x, dt, a, bm, cm, dy[:, :-1], dh)
    with pytest.raises(ValueError, match="dh_end"):
        ss.ssd_scan_backward(x, dt, a, bm, cm, dy, dh[..., :-1])
