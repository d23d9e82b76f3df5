"""The port's Mamba2 SSD scan (kernel B5) and Mamba2 block against the
reference's.

On the CPU the wrappers take the plain version, the chunked dual form
of the reference model's ``_ssd_chunked``.  It is held against
``repro.kernels.ref.ssd_scan_ref`` (the exact sequential recurrence)
and the interpret-mode Pallas ``ssd_scan`` on tests/test_kernels.py's
shapes at its tolerance, 2e-3 (measured: ≤ 7e-6 against the oracle and
≤ 2e-5 against the Pallas kernel); against ``_ssd_chunked`` itself,
y and the final state agree to 1e-5 in float32 (measured ≤ 2.4e-6).
The Mamba2 block runs on weights converted from the reference's init.
The CUDA kernel is held against the plain version in the
``cuda``-marked test, which skips without a GPU (and in
chip_smoke.py on the card).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.configs.base import SSMConfig
from repro.kernels.ref import ssd_scan_ref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models import build as ref_build
from repro.models import mamba2 as ref_mamba2
from repro_torch.configs import get_config as pt_get_config
from repro_torch.configs import reduced as pt_reduced
from repro_torch.convert import model_params_from_jax
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import build
from repro_torch.models import mamba2 as pt_mamba2

# (batch, seq, heads, groups, head_dim, d_state): tests/test_kernels.py's
SHAPES = [(1, 128, 2, 1, 32, 16), (2, 256, 4, 2, 64, 16),
          (1, 256, 8, 1, 32, 64)]


def _inputs(seed, b, s, nh, g, hd, ds):
    """tests/test_kernels.py's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, hd)) * 0.5
    dt = np.logaddexp(rng.standard_normal((b, s, nh)), 0.0)
    a = -np.exp(rng.standard_normal(nh) * 0.3)
    bm = rng.standard_normal((b, s, g, ds)) * 0.3
    cm = rng.standard_normal((b, s, g, ds)) * 0.3
    return [v.astype(np.float32) for v in (x, dt, a, bm, cm)]


def _jax(arrs):
    return [jnp.asarray(a) for a in arrs]


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_plain_matches_oracle_and_pallas_kernel(shape):
    arrs = _inputs(0, *shape)
    got = ss.ssd_scan(*_torch(arrs), chunk=64)
    assert got.dtype == torch.float32 and got.shape == shape[:3] + shape[4:5]
    want = ssd_scan_ref(*_jax(arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)
    pallas = pallas_ssd(*_jax(arrs), chunk=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_chunk_invariance(chunk):
    arrs = _inputs(1, *SHAPES[0])
    got = ss.ssd_scan(*_torch(arrs), chunk=chunk)
    want = ssd_scan_ref(*_jax(arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("shape", [(2, 100, 4, 2, 32, 16),
                                   (1, 70, 4, 1, 64, 64)],
                         ids=["S100-g2", "S70-g1"])
def test_ragged_length_and_final_state_match_the_model_ssd(shape):
    """No multiple of the chunk: the padding steps are identities, so y
    and the final state are those of exactly S steps."""
    b, s, nh, g, hd, ds = shape
    arrs = _inputs(2, *shape)
    y, h = ss.ssd_chunked(*_torch(arrs), chunk=32)
    assert y.shape == (b, s, nh, hd) and h.shape == (b, nh, hd, ds)
    assert y.dtype == h.dtype == torch.float32
    scfg = SSMConfig(d_state=ds, head_dim=hd, n_groups=g, chunk_size=32)
    ry, rh = ref_mamba2._ssd_chunked(*_jax(arrs), scfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=0, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), rtol=0, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(ssd_scan_ref(
        *_jax(arrs))), rtol=2e-3, atol=2e-3)


def test_bf16_inputs_compute_in_float32():
    """bf16 x, B, C are widened exactly: the result is the float32 scan
    of the rounded values, and the API rounds y once, to x's dtype."""
    arrs = _inputs(3, *SHAPES[1])
    t = _torch(arrs)
    for i in (0, 3, 4):
        t[i] = t[i].to(torch.bfloat16)
    y, _ = ss.ssd_chunked(*t, chunk=64)
    wide = [v.float() if v.dtype == torch.bfloat16 else v for v in t]
    assert torch.equal(y, ss.ssd_chunked(*wide, chunk=64)[0])
    api = ss.ssd_scan(*t, chunk=64)
    assert api.dtype == torch.bfloat16 and torch.equal(api, y.bfloat16())


# ---------------------------------------------------------------------------
# The Mamba2 block on converted weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block():
    cfg = reduced(get_config("mamba2-2.7b"))
    s = cfg.ssm
    p = ref_mamba2.init_mamba2(jax.random.PRNGKey(4), cfg.d_model, s,
                               jnp.float32)
    # non-zero conv biases and norm scale, so that they count
    rng = np.random.default_rng(4)
    p = dict(p)
    for k in ("conv_bx", "conv_bbc", "norm"):
        p[k] = p[k] + jnp.asarray(rng.standard_normal(p[k].shape) * 0.1,
                                  jnp.float32)
    pp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x = rng.standard_normal((2, 70, cfg.d_model)).astype(np.float32)
    return cfg, p, pp, x


def test_mamba2_forward_and_decode_match_reference(block):
    cfg, p, pp, x = block
    s, d = cfg.ssm, cfg.d_model
    want, rc = ref_mamba2.mamba2_forward(p, d, s, jnp.asarray(x[:, :67]))
    got, pc = pt_mamba2.mamba2_forward(pp, d, s, torch.from_numpy(x[:, :67]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert set(pc) == set(rc) == {"conv_x", "conv_bc", "ssm"}
    for k in rc:
        assert pc[k].dtype == torch.float32
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(rc[k]), rtol=0,
                                   atol=1e-5)
    for t in range(67, 70):
        xt = x[:, t:t + 1]
        want, rc = ref_mamba2.mamba2_decode(p, d, s, jnp.asarray(xt), rc)
        got, pc2 = pt_mamba2.mamba2_decode(pp, d, s, torch.from_numpy(xt),
                                           pc)
        assert pc2 is pc              # updated in place
        # the decode conv sums its four taps in torch's order
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
        for k in rc:
            np.testing.assert_allclose(pc[k].numpy(), np.asarray(rc[k]),
                                       rtol=0, atol=1e-5)


def test_converted_bf16_weights_keep_float32_ssm_scalars():
    cfg = dataclasses.replace(reduced(get_config("mamba2-2.7b")),
                              dtype="bfloat16")
    params = ref_build(cfg).init(jax.random.PRNGKey(5))
    pcfg = dataclasses.replace(pt_reduced(pt_get_config("mamba2-2.7b")),
                               dtype="bfloat16")
    port = model_params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    seeded = build(pcfg).init(torch.Generator().manual_seed(5))
    stack = params["stack"][0]["ssm"]
    for model in (port, seeded):
        for layer in model.layers:
            ssm = layer["ssm"]
            for k, w in ssm.items():
                want = (torch.float32 if k in ("A_log", "D", "dt_bias")
                        else torch.bfloat16)
                assert w.dtype == want, k
                assert w.shape == stack[k].shape[1:], k
    for i, layer in enumerate(port.layers):
        for k, w in layer["ssm"].items():
            np.testing.assert_array_equal(
                w.float().numpy(), np.asarray(stack[k][i], np.float32))


# ---------------------------------------------------------------------------
# The wrappers: guards and the launch counter
# ---------------------------------------------------------------------------

def _args(dtype=torch.float32, nh=4, g=2, hd=32, ds=16):
    t = _torch(_inputs(6, 2, 40, nh, g, hd, ds))
    return [v.to(dtype) if i in (0, 3, 4) else v for i, v in enumerate(t)]


@pytest.mark.parametrize("bad", ["float16", "dt-float64", "mixed-dtype",
                                 "uneven-groups", "shape", "meta",
                                 "chunk"])
def test_wrappers_refuse(bad):
    x, dt, a, bm, cm = _args()
    chunk = 32
    if bad == "float16":
        x, bm, cm = x.half(), bm.half(), cm.half()
    elif bad == "dt-float64":
        dt = dt.double()
    elif bad == "mixed-dtype":
        bm = bm.to(torch.bfloat16)
    elif bad == "uneven-groups":
        x, dt, a, bm, cm = _args(nh=3, g=2)
    elif bad == "shape":
        dt = dt[:, :-1]
    elif bad == "meta":
        # since the launch slice a meta tensor takes the kernel's shape
        # function (the dry run): no arithmetic, no launch counted
        launches = ss.ssd_scan.launches
        meta = tuple(t.to("meta") for t in (x, dt, a, bm, cm))
        y, h = ss.ssd_chunked(*meta, chunk)
        want = ss.ssd_scan_plain(x, dt, a, bm, cm, chunk)
        assert (y.shape, h.shape) == (want[0].shape, want[1].shape)
        assert y.device.type == h.device.type == "meta"
        assert ss.ssd_scan(*meta, chunk=chunk).shape == x.shape
        assert ss.ssd_scan.launches == launches
        return
    elif bad == "chunk":
        chunk = 0
    for fn in (lambda: ss.ssd_chunked(x, dt, a, bm, cm, chunk),
               lambda: ss.ssd_scan(x, dt, a, bm, cm, chunk=chunk)):
        with pytest.raises(ValueError):
            fn()


def test_launch_guards_without_the_card():
    """What the CUDA route refuses before it reaches the card, and that
    it takes the model's B and C: strided slices of one activation."""
    x, dt, a, bm, cm = _args(hd=32, ds=16)
    ss.launchable(x, dt, a, bm, cm)
    bcc = torch.cat([bm, cm], dim=-1).reshape(2, 40, 2 * 2 * 16)
    b_view = bcc[..., :32].reshape(2, 40, 2, 16)
    c_view = bcc[..., 32:].reshape(2, 40, 2, 16)
    assert not b_view.is_contiguous()
    ss.launchable(x, dt, a, b_view, c_view)
    ss.launchable(*_args(hd=64))             # jamba-v0.1-52b's (64, 16)
    with pytest.raises(ValueError, match="head_dim"):
        ss.launchable(*_args(hd=48))
    with pytest.raises(ValueError, match="d_state"):
        ss.launchable(*_args(ds=32))
    with pytest.raises(ValueError, match="contiguous"):
        ss.launchable(x.transpose(0, 1).contiguous().transpose(0, 1), dt, a,
                      bm, cm)
    with pytest.raises(ValueError, match="packed"):
        ss.launchable(x, dt, a, bm.transpose(2, 3).contiguous()
                      .transpose(2, 3), cm)
    with pytest.raises(ValueError, match="layout"):
        ss.launchable(x, dt, a, b_view, cm)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = ss.ssd_scan.launches
    args = _args()
    y, h = ss.ssd_chunked(*args, 32)
    want_y, want_h = ss.ssd_scan_plain(*args, 32)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert torch.equal(ss.ssd_scan(*args, chunk=32), want_y)
    assert ss.ssd_scan.launches == before


def test_launch_counter_counts_one_per_launch(monkeypatch):
    """On the kernel route each call of either wrapper counts exactly one
    launch; the launch itself is stubbed here (no card)."""
    launched = []
    monkeypatch.setattr(ss, "kernel_device", lambda t, name: True)
    monkeypatch.setattr(ss, "_launch",
                        lambda *a: launched.append(a[-1] is None))
    monkeypatch.setattr(ss.ssd_scan, "launches", 0)
    for _ in range(3):
        ss.ssd_chunked(*_args(), 32)
    ss.ssd_scan(*_args())
    assert ss.ssd_scan.launches == 4
    assert launched == [False, False, False, True]   # h_T, then none


def test_reduced_mamba2_runs_the_plain_scan_on_the_cpu():
    """The whole model on CPU tensors goes through the plain version."""
    cfg = pt_reduced(pt_get_config("mamba2-2.7b"))
    bundle = build(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    before = ss.ssd_scan.launches
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        logits, cache = bundle.prefill(params, {"tokens": toks}, 0)
    assert ss.ssd_scan.launches == before
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert [c["ssm"].shape for c in cache] == [(2, 16, 32, 16)] * 2
    empty = bundle.init_cache(2, 0, device="cpu")
    assert [{k: (v.shape, v.dtype) for k, v in c.items()} for c in cache] \
        == [{k: (v.shape, v.dtype) for k, v in c.items()} for c in empty]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_scan_matches_plain(dtype):
    _need_cuda()
    tol = 1e-4 if dtype == torch.float32 else 2e-3
    for shape in [(2, 100, 4, 2, 32, 16), (3, 300, 80, 1, 64, 128),
                  (2, 64, 8, 4, 64, 128)]:
        x, dt, a, bm, cm = (torch.from_numpy(v).cuda()
                            for v in _inputs(7, *shape))
        x, bm, cm = x.to(dtype), bm.to(dtype), cm.to(dtype)
        n = ss.ssd_scan.launches
        y, h = ss.ssd_chunked(x, dt, a, bm, cm, 256)
        torch.cuda.synchronize()
        assert ss.ssd_scan.launches == n + 1
        want_y, want_h = ss.ssd_scan_plain(x, dt, a, bm, cm, 256)
        assert float((y - want_y).abs().max()) <= tol
        assert float((h - want_h).abs().max()) <= tol
        assert torch.equal(ss.ssd_scan(x, dt, a, bm, cm), y.to(dtype))
