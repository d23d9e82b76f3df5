"""The port's superstep FIFO compaction (repro_torch.kernels.superstep
.fifo_compact) against the reference's, and the port's histogram update
on the generate sweep's thinned blocks, on the same numpy inputs.

The compaction is data movement plus one float32 subtraction per
element, so the port's plain version must equal the reference's lax
path and its interpret-mode Pallas kernel bit for bit.  Histogram counts
are integer adds, so they match bit for bit too, at block sizes that
are not a multiple of 16.  The CUDA kernels are held against the plain
versions on the card only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hist import thinned_rows as ref_thinned_rows
from repro.kernels import superstep as ref_ss
from repro_torch import convert
from repro_torch.core import hist as pt_hist
from repro_torch.kernels import superstep as pt_ss

# the test workers run side by side: one intra-op thread each keeps
# torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

N = 77          # an odd row length, like the benchmark grid's 1,409


def _compact_inputs(seed, now_kind):
    """One row per pop count of interest: 0, 1, buf_len − 1, buf_len and
    random ones."""
    rng = np.random.default_rng(seed)
    k = np.array([0, 1, N - 1, N] + list(rng.integers(0, N + 1, 6)),
                 np.int32)
    buf = rng.normal(3.0, 2.0, (len(k), N)).astype(np.float32)
    buf[0, 5] = -0.0
    if now_kind == "zero":
        now = np.zeros(len(k), np.float32)
    else:
        now = rng.uniform(0.1, 50.0, len(k)).astype(np.float32)
    return buf, k, now


@pytest.mark.parametrize("now_kind", ["zero", "positive"])
@pytest.mark.parametrize("backend", ["lax", "pallas"])
def test_plain_matches_reference_bitwise(backend, now_kind):
    buf, k, now = _compact_inputs(3, now_kind)
    fn = jax.jit(jax.vmap(lambda b, kk, t: ref_ss.fifo_compact(
        b, kk, t, backend=backend)))
    want = np.asarray(fn(jnp.asarray(buf), jnp.asarray(k),
                         jnp.asarray(now)))
    buf = torch.from_numpy(buf)
    got = pt_ss.fifo_compact(buf, torch.from_numpy(k), torch.from_numpy(now),
                             backend="torch", out=torch.empty_like(buf))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.uint32),
                          want.view(np.uint32))


def test_out_of_place_into_a_given_buffer():
    buf, k, now = (torch.from_numpy(x) for x in _compact_inputs(5, "p"))
    before = buf.clone()
    out = torch.full_like(buf, 7.0)
    got = pt_ss.fifo_compact(buf, k, now, backend="torch", out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(buf, before)
    assert torch.equal(out, pt_ss.fifo_compact_plain(
        buf, k, now, out=torch.empty_like(buf)))
    with pytest.raises(ValueError, match="out of place"):
        pt_ss.fifo_compact(buf, k, now, backend="torch", out=buf)
    assert pt_ss.fifo_compact.launches == 0


@pytest.mark.parametrize("bad", ["buf_dtype", "k_dtype", "now_shape",
                                 "out_shape", "cuda_on_cpu"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    buf, k, now = (torch.from_numpy(x) for x in _compact_inputs(1, "p"))
    kw = dict(backend="torch", out=torch.empty_like(buf))
    if bad == "buf_dtype":
        buf = buf.double()
    elif bad == "k_dtype":
        k = k.long()
    elif bad == "now_shape":
        now = now[:-1]
    elif bad == "out_shape":
        kw["out"] = torch.empty(buf.shape[0], N + 1)
    else:
        kw["backend"] = "cuda"
    with pytest.raises(ValueError):
        pt_ss.fifo_compact(buf, k, now, **kw)


def _thinned_block(seed, p, s_cap, rows, p_inc=0.4):
    rng = np.random.default_rng(seed)
    lats = rng.lognormal(2.0, 1.0, (p, 16, s_cap)).astype(np.float32)
    inc = rng.random((p, 16, s_cap)) < p_inc
    return lats, inc


@pytest.mark.parametrize("sketch", [False, True], ids=["full", "sketch"])
@pytest.mark.parametrize("hist_every,s_cap", [(3, 7), (2, 5), (16, 9)])
def test_hist_update_on_thinned_blocks_matches_reference(hist_every, s_cap,
                                                         sketch):
    """The generate sweep bins only ``thinned_rows`` of each 16-step
    block: ``len(rows) * s_cap`` entries per point, here never a
    multiple of 16."""
    n_bins = pt_hist.SKETCH_BINS if sketch else 512
    rows = pt_hist.thinned_rows(16, hist_every)
    assert (len(rows) * s_cap) % 16
    p = 4
    lats, inc = _thinned_block(hist_every, p, s_cap, rows)
    rng = np.random.default_rng(9)
    counts = rng.integers(0, 50, (p, n_bins)).astype(np.int32)
    sums = (rng.random((p, n_bins)) * 100).astype(np.float32) \
        if sketch else None
    ref_h = (jnp.asarray(counts),) + ((jnp.asarray(sums),) if sketch
                                      else ())
    fn = jax.jit(jax.vmap(lambda h, l, i: ref_ss.hist_update(
        h, l, i, n_bins=n_bins, backend="lax", sketch=sketch,
        hist_rows=ref_thinned_rows(16, hist_every))))
    want = [np.asarray(x) for x in fn(ref_h, jnp.asarray(lats),
                                       jnp.asarray(inc))]
    hists = convert.hist_state_from_arrays(counts, sums, device="cpu")
    got = pt_ss.hist_update(
        hists, torch.from_numpy(np.ascontiguousarray(lats[:, rows])),
        torch.from_numpy(np.ascontiguousarray(inc[:, rows])),
        n_bins=n_bins, backend="torch", sketch=sketch)
    assert np.array_equal(got[0].numpy(), want[0])
    if sketch:
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-6)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode")
    dev = "cuda"
    buf, k, now = (torch.from_numpy(x).to(dev)
                   for x in _compact_inputs(7, "p"))
    before = pt_ss.fifo_compact.launches
    got = pt_ss.fifo_compact(buf, k, now, backend="cuda",
                             out=torch.empty_like(buf))
    want = pt_ss.fifo_compact_plain(buf, k, now, out=torch.empty_like(buf))
    torch.cuda.synchronize()
    assert pt_ss.fifo_compact.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    rows = pt_hist.thinned_rows(16, 3)
    lats, inc = _thinned_block(1, 33, 7, rows)
    lt = torch.from_numpy(np.ascontiguousarray(lats[:, rows])).to(dev)
    it = torch.from_numpy(np.ascontiguousarray(inc[:, rows])).to(dev)
    a = (torch.zeros(33, 512, dtype=torch.int32, device=dev),)
    b = (torch.zeros(33, 512, dtype=torch.int32, device=dev),)
    pt_ss.hist_update(a, lt, it, n_bins=512, backend="cuda")
    pt_ss.hist_update_plain(b, lt, it, n_bins=512)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0])
