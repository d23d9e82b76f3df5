"""The port's superstep histogram update (repro_torch.kernels.superstep)
against the reference's (repro.kernels.superstep), on the same numpy
inputs.

Counts are integer adds, so the port's plain version must equal the
reference's lax scatter and its interpret-mode Pallas kernel bit for
bit; the sketch's float sums agree within rtol 1e-6 (another order of
adds, as the reference's own backend-parity test allows).  The CUDA
kernel is held against the plain version on the card only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hist as ref_hist
from repro.kernels import superstep as ref_ss
from repro_torch import convert
from repro_torch.core import hist as pt_hist
from repro_torch.kernels import superstep as pt_ss

# the test workers run side by side: one intra-op thread each keeps
# torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)


def _block(seed, p=3, rows=32, width=24, p_inc=0.6):
    rng = np.random.default_rng(seed)
    lats = rng.lognormal(1.0, 1.5, (p, rows, width)).astype(np.float32)
    lats[:, :, 0] = 0.0                 # masked slots carry 0.0
    lats[0, 1, 1] = -0.0                # a rebased latency can be −0.0
    inc = rng.random((p, rows, width)) < p_inc
    return lats, inc


def _state(seed, p, n_bins, sketch):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 50, (p, n_bins)).astype(np.int32)
    sums = (rng.random((p, n_bins)) * 100).astype(np.float32) \
        if sketch else None
    return counts, sums


def _reference(backend, counts, sums, lats, inc, n_bins, sketch):
    hists = (jnp.asarray(counts),)
    if sketch:
        hists = hists + (jnp.asarray(sums),)
    fn = jax.jit(jax.vmap(lambda h, l, i: ref_ss.hist_update(
        h, l, i, n_bins=n_bins, backend=backend, sketch=sketch)))
    return [np.asarray(x) for x in fn(hists, jnp.asarray(lats),
                                       jnp.asarray(inc))]


@pytest.mark.parametrize("sketch", [False, True], ids=["full", "sketch"])
@pytest.mark.parametrize("backend", ["lax", "pallas"])
def test_plain_matches_reference(backend, sketch):
    n_bins = pt_hist.SKETCH_BINS if sketch else 512
    lats, inc = _block(3 + sketch)
    counts, sums = _state(5, lats.shape[0], n_bins, sketch)
    want = _reference(backend, counts, sums, lats, inc, n_bins, sketch)

    hists = convert.hist_state_from_arrays(counts, sums, device="cpu")
    got = pt_ss.hist_update(hists, torch.from_numpy(lats),
                            torch.from_numpy(inc), n_bins=n_bins,
                            backend="torch", sketch=sketch)
    assert np.array_equal(got[0].numpy(), want[0])
    assert int(got[0].sum()) == int(counts.sum()) + int(inc.sum())
    if sketch:
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-6)


def _edge_values():
    edges = np.concatenate([ref_hist.hist_edges(512),
                            ref_hist.sketch_edges()])
    special = [0.0, -0.0, 1e-45, 1e-40, 2.0 ** -149, 2.0 ** 40, -1.0,
               -2.0 ** 40, np.inf, -np.inf, np.nan, -np.nan, 1.0,
               np.finfo(np.float32).max]
    vals = np.concatenate([edges, special]).astype(np.float32)
    # the float just below and above each edge too (max steps to inf)
    with np.errstate(over="ignore"):
        return np.concatenate([vals,
                               np.nextafter(vals, np.float32(-np.inf)),
                               np.nextafter(vals, np.float32(np.inf))])


@pytest.mark.parametrize("sketch,n_bins", [(False, 512), (False, 100),
                                           (True, 64)],
                         ids=["full", "full100", "sketch"])
def test_bit_bins_edge_values_bitwise(sketch, n_bins):
    vals = _edge_values()
    # a negative NaN's sign bit must survive: build it from its bits
    vals = np.append(vals, np.array([0xFFC00000], np.uint32)
                     .view(np.float32))
    want = np.asarray(ref_hist.bit_bins(jnp.asarray(vals), n_bins, sketch))
    got = pt_hist.bit_bins(torch.from_numpy(vals), n_bins, sketch)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_edges_and_percentiles_match_reference():
    assert np.array_equal(pt_hist.hist_edges(512), ref_hist.hist_edges(512))
    assert np.array_equal(pt_hist.sketch_edges(), ref_hist.sketch_edges())
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 9, (4, 64))
    for a, b in zip(pt_hist.sketch_percentiles(counts, (50, 99)),
                    ref_hist.sketch_percentiles(counts, (50, 99))):
        assert np.array_equal(a, b)


def test_cuda_backend_on_cpu_tensors_raises():
    lats, inc = _block(0)
    hists = convert.hist_state_from_arrays(
        np.zeros((lats.shape[0], 512), np.int32), device="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pt_ss.hist_update(hists, torch.from_numpy(lats),
                          torch.from_numpy(inc), n_bins=512,
                          backend="cuda")
    assert pt_ss.hist_update.launches == 0


def test_resolve_backend_honours_env(monkeypatch):
    monkeypatch.delenv(pt_ss.ENV_VAR, raising=False)
    assert pt_ss.resolve_backend(None, "cpu") == "torch"
    assert pt_ss.resolve_backend("auto", "cpu") == "torch"
    monkeypatch.setenv(pt_ss.ENV_VAR, "cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pt_ss.resolve_backend(None, "cpu")
    # an explicit request wins over the environment
    assert pt_ss.resolve_backend("torch", "cpu") == "torch"
    monkeypatch.setenv(pt_ss.ENV_VAR, "pallas")
    with pytest.raises(ValueError, match="unknown superstep"):
        pt_ss.resolve_backend(None, "cpu")
    monkeypatch.setenv(pt_ss.ENV_VAR, "torch")
    assert pt_ss.resolve_backend(None, "cpu") == "torch"
    # the plain version never takes CUDA tensors through the wrapper
    with pytest.raises(ValueError, match="plain version"):
        pt_ss.resolve_backend("torch", "cuda")


@pytest.mark.parametrize("bad", ["dtype", "shape", "bins", "sketch_hists"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    lats, inc = _block(1)
    lats_t, inc_t = torch.from_numpy(lats), torch.from_numpy(inc)
    hists = (torch.zeros(lats.shape[0], 512, dtype=torch.int32),)
    kw = dict(n_bins=512, backend="torch")
    if bad == "dtype":
        lats_t = lats_t.double()
    elif bad == "shape":
        inc_t = inc_t[:, :, :-1]
    elif bad == "bins":
        kw["n_bins"] = 256
    else:
        kw.update(n_bins=64, sketch=True)
        hists = (torch.zeros(lats.shape[0], 64, dtype=torch.int32),)
    with pytest.raises(ValueError):
        pt_ss.hist_update(hists, lats_t, inc_t, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("sketch", [False, True], ids=["full", "sketch"])
def test_kernel_matches_plain_on_card(sketch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    n_bins = pt_hist.SKETCH_BINS if sketch else 512
    lats, inc = _block(7, p=64, rows=32, width=96)
    counts, sums = _state(9, lats.shape[0], n_bins, sketch)
    dev = "cuda"
    a = convert.hist_state_from_arrays(counts, sums, device=dev)
    b = convert.hist_state_from_arrays(counts, sums, device=dev)
    lt, it = torch.from_numpy(lats).to(dev), torch.from_numpy(inc).to(dev)
    before = pt_ss.hist_update.launches
    pt_ss.hist_update(a, lt, it, n_bins=n_bins, backend="cuda",
                      sketch=sketch)
    pt_ss.hist_update_plain(b, lt, it, n_bins=n_bins, sketch=sketch)
    torch.cuda.synchronize()
    assert pt_ss.hist_update.launches == before + 1
    assert torch.equal(a[0], b[0])
    if sketch:
        torch.testing.assert_close(a[1], b[1], rtol=1e-6, atol=0)
