"""The redesigned superstep kernels' layout, on the CPU: the bound that
``hist_update_min_bytes`` counts, the launch plans of ``hist_update``
and ``fifo_compact``, and the plain versions against the reference on
the blocks the paths really produce (prefix masks, one bin, small pop
counts) rather than random ones.

The bound is held against a count of 32-byte sectors in numpy, whose
binning is written here from the bit pattern, independent of the
port's ``bit_bins``.  The plain versions must equal the reference's lax
path and its interpret-mode Pallas kernels bit for bit (counts and
compaction), the sketch sums within rtol 1e-6.  The CUDA kernels run
only on the card: their cases here are marked ``cuda`` and skip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import superstep as ref_ss
from repro_torch import convert
from repro_torch.core import hist as pt_hist
from repro_torch.kernels import superstep as pt_ss

# the test workers run side by side: one intra-op thread each keeps
# torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

SECTOR = 32


def _block(kind, seed, p=6, rows=8, width=40):
    """Latencies and include mask of one block kind, as numpy."""
    rng = np.random.default_rng(seed)
    if kind == "one_bin":
        # [3.0, 3.25) is one bin of the full histogram and of the sketch
        lats = (3.0 + 0.25 * rng.random((p, rows, width))).astype(np.float32)
    else:
        lats = rng.lognormal(1.0, 1.5, (p, rows, width)).astype(np.float32)
    if kind == "prefix":
        # the sweep's popmask: each row includes its first b slots
        b = rng.integers(0, width // 3, (p, rows, 1))
        inc = np.arange(width) < b
        lats = np.where(inc, lats, 0.0).astype(np.float32)
    else:
        inc = rng.random((p, rows, width)) < 0.5
    return lats, inc


def _offset_view(a: np.ndarray, off: int, device="cpu") -> torch.Tensor:
    """``a`` as a contiguous tensor on ``device`` whose data starts
    ``off`` elements into its storage, so its base is misaligned by
    ``off`` elements (a copy to another device would realign it)."""
    flat = torch.zeros(a.size + off + 8, dtype=torch.from_numpy(a).dtype,
                       device=device)
    flat[off:off + a.size] = torch.from_numpy(a.reshape(-1)).to(device)
    return flat[off:off + a.size].view(a.shape)


def _numpy_bins(lats: np.ndarray, n_bins: int, sketch: bool) -> np.ndarray:
    shift, base, _ = pt_hist.bin_params(sketch)
    bits = lats.view(np.int32).astype(np.int64) >> shift
    return np.clip(bits - base, 0, n_bins - 1)


def _numpy_sectors(hists, lats, inc, n_bins, sketch):
    """The same count from numpy, in parts: mask bytes, latency sectors
    holding an included entry, and for each row tensor the sectors
    receiving a count."""
    lat_np = lats.numpy().reshape(lats.shape[0], -1)
    inc_np = inc.numpy().reshape(lats.shape[0], -1)
    pts, slots = np.nonzero(inc_np)
    flat = pts * inc_np.shape[1] + slots
    lat_sec = np.unique((lats.data_ptr() + 4 * flat) // SECTOR).size
    bins = _numpy_bins(lat_np[pts, slots], n_bins, sketch)
    cells = pts * n_bins + bins
    rows = [np.unique((h.data_ptr() + 4 * cells) // SECTOR).size
            for h in hists]
    return inc_np.size, lat_sec, rows


@pytest.mark.parametrize("sketch", [False, True], ids=["full", "sketch"])
@pytest.mark.parametrize("kind", ["random", "prefix", "one_bin",
                                  "misaligned"])
def test_min_bytes_counts_sectors(kind, sketch):
    n_bins = pt_hist.SKETCH_BINS if sketch else 512
    lats_np, inc_np = _block("random" if kind == "misaligned" else kind,
                             seed=11)
    p = lats_np.shape[0]
    if kind == "misaligned":
        # mask one byte off, latencies and rows one element off
        lats, inc = _offset_view(lats_np, 1), _offset_view(inc_np, 1)
        hists = tuple(_offset_view(np.zeros((p, n_bins), dt), 1)
                      for dt in (np.int32, np.float32)[:1 + sketch])
    else:
        lats, inc = torch.from_numpy(lats_np), torch.from_numpy(inc_np)
        hists = tuple(torch.zeros(p, n_bins, dtype=dt)
                      for dt in (torch.int32, torch.float32)[:1 + sketch])
    got = pt_ss.hist_update_min_bytes(hists, lats, inc, n_bins=n_bins,
                                      sketch=sketch)
    mask, lat_sec, rows = _numpy_sectors(hists, lats, inc, n_bins, sketch)
    assert got == mask + SECTOR * lat_sec + 2 * SECTOR * sum(rows)
    all_lat = -(-(lats.data_ptr() % SECTOR + 4 * lats.numel()) // SECTOR)
    if kind == "one_bin":
        # a point's latencies all fall in one bin: one sector a row
        # tensor per point that includes anything
        assert rows == [int(inc_np.reshape(p, -1).any(1).sum())] * len(rows)
    elif kind == "prefix":
        # a third of the slots at most: most latency sectors untouched
        assert lat_sec < all_lat / 2
    else:
        # an i.i.d. half: nearly every latency sector holds an entry
        assert lat_sec > 0.9 * all_lat


def test_min_bytes_of_an_empty_mask_is_the_mask():
    lats_np, _ = _block("random", seed=3)
    inc = torch.zeros(lats_np.shape, dtype=torch.bool)
    hists = (torch.zeros(lats_np.shape[0], 512, dtype=torch.int32),)
    assert pt_ss.hist_update_min_bytes(
        hists, torch.from_numpy(lats_np), inc, n_bins=512) == inc.numel()


# the paths' shapes: (points, entries a point, n_bins, sketch)
PLAN_SHAPES = {
    "sweep": (8160, 32 * 768, 512, False),
    "sweep_sketch": (8160, 32 * 768, 64, True),
    "gen": (8192, 16 * 64, 512, False),
    "gen_thinned": (8192, 5 * 63, 512, False),
    "main": (5, 32 * 1024, 512, False),
    "tiny_5x7": (33, 5 * 7, 512, False),
    "bins_100": (8192, 5 * 63, 100, False),
    "odd_block": (37, 7 * 1001, 101, False),
}


@pytest.mark.parametrize("name", list(PLAN_SHAPES))
def test_hist_plan_at_the_paths_shapes(name):
    p, per_point, n_bins, sketch = PLAN_SHAPES[name]
    plan = pt_ss.hist_update_plan(p, per_point, n_bins, sketch=sketch,
                                  lats_ptr=1 << 20, inc_ptr=1 << 20,
                                  row_ptrs=[1 << 21, 1 << 22])
    many = p >= pt_ss.WARP_POINTS_COEF * np.sqrt(per_point)
    assert plan.warps_per_point == (1 if many else 8)
    assert plan.points_per_block == (8 if many else 1)
    assert plan.threads == 32 * plan.warps_per_point * plan.points_per_block
    assert plan.threads <= 256
    assert plan.blocks * plan.points_per_block >= p
    assert (plan.blocks - 1) * plan.points_per_block < p
    slice_bytes = n_bins * (4 + (8 if sketch else 0))
    assert plan.smem_bytes == plan.points_per_block * slice_bytes
    assert plan.smem_bytes <= 48 * 1024        # no opt-in needed
    assert plan.vec_loads
    assert plan.vec_rows == (n_bins % 4 == 0)


def test_hist_plan_threshold_is_inclusive():
    # one warp a point from 28 * sqrt(entries a point) points: 896 at
    # the generate block's 1,024 entries, 4,389.5 at the sweep's 24,576
    assert pt_ss.WARP_POINTS_COEF == 28
    for per_point, at in ((1024, 896), (24_576, 4390)):
        for p, warps in ((at, 1), (at - 1, 8)):
            plan = pt_ss.hist_update_plan(p, per_point, 512)
            assert plan.warps_per_point == warps, (per_point, p)


@pytest.mark.parametrize("lats_off,inc_off,vec", [
    (0, 0, True),     # both bases aligned
    (4, 1, True),     # off together by one entry: rows take a head step
    (0, 1, False),    # mask one byte off the latencies: scalar loop
    (2, 0, False),    # latencies not 4-byte aligned
    (12, 3, True),    # off together by three entries
])
def test_hist_plan_vector_or_scalar_loads(lats_off, inc_off, vec):
    plan = pt_ss.hist_update_plan(100, 315, 512, lats_ptr=4096 + lats_off,
                                  inc_ptr=8192 + inc_off)
    assert plan.vec_loads is vec


@pytest.mark.parametrize("row_off,n_bins,vec", [
    (0, 512, True), (4, 512, False), (0, 100, True), (0, 101, False),
    (8, 64, False), (16, 64, True)])
def test_hist_plan_vector_or_scalar_flush(row_off, n_bins, vec):
    plan = pt_ss.hist_update_plan(10, 64, n_bins,
                                  row_ptrs=[4096 + row_off])
    assert plan.vec_rows is vec


def test_hist_plan_shrinks_blocks_for_wide_rows_and_refuses_too_wide():
    # 4,096 bins: 16 KB a slice, so a block holds 3 one-warp points
    plan = pt_ss.hist_update_plan(8192, 64, 4096)
    assert (plan.points_per_block, plan.smem_bytes) == (3, 3 * 16384)
    assert plan.threads == 96 and plan.blocks == -(-8192 // 3)
    # a block-wide point: one slice, 12 KB in sketch mode at 1,024 bins
    wide = pt_ss.hist_update_plan(100, 50_000, 1024, sketch=True)
    assert (wide.points_per_block, wide.smem_bytes) == (1, 12 * 1024)
    with pytest.raises(ValueError, match="shared memory"):
        pt_ss.hist_update_plan(10, 64, 13_000)
    with pytest.raises(ValueError, match="shared memory"):
        pt_ss.hist_update_plan(10, 64, 4097, sketch=True)


@pytest.mark.parametrize("buf_off,out_off,vec", [
    (0, 0, True), (4, 0, False), (0, 8, False), (16, 32, True)])
def test_compact_plan(buf_off, out_off, vec):
    plan = pt_ss.fifo_compact_plan(8192, 1409, buf_ptr=1024 + buf_off,
                                   out_ptr=2048 + out_off)
    assert (plan.rows_per_block, plan.threads, plan.blocks) == (8, 256, 1024)
    assert plan.vec is vec


def _reference_hist(backend, counts, sums, lats, inc, n_bins, sketch):
    hists = (jnp.asarray(counts),) + ((jnp.asarray(sums),) if sketch
                                      else ())
    fn = jax.jit(jax.vmap(lambda h, l, i: ref_ss.hist_update(
        h, l, i, n_bins=n_bins, backend=backend, sketch=sketch)))
    return [np.asarray(x) for x in fn(hists, jnp.asarray(lats),
                                       jnp.asarray(inc))]


@pytest.mark.parametrize("sketch", [False, True], ids=["full", "sketch"])
@pytest.mark.parametrize("backend", ["lax", "pallas"])
@pytest.mark.parametrize("kind", ["prefix", "one_bin"])
def test_plain_matches_reference_on_path_like_blocks(kind, backend, sketch):
    n_bins = pt_hist.SKETCH_BINS if sketch else 512
    lats, inc = _block(kind, seed=7, p=3, rows=32, width=24)
    rng = np.random.default_rng(8)
    counts = rng.integers(0, 50, (3, n_bins)).astype(np.int32)
    sums = ((rng.random((3, n_bins)) * 100).astype(np.float32)
            if sketch else None)
    want = _reference_hist(backend, counts, sums, lats, inc, n_bins, sketch)
    hists = convert.hist_state_from_arrays(counts, sums, device="cpu")
    got = pt_ss.hist_update_plain(hists, torch.from_numpy(lats),
                                  torch.from_numpy(inc), n_bins=n_bins,
                                  sketch=sketch)
    assert np.array_equal(got[0].numpy(), want[0])
    if kind == "one_bin":
        # every included latency in one bin of each point's row
        assert np.count_nonzero(got[0].numpy() - counts) <= 3
    if sketch:
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-6)


N = 1409        # the benchmark grid's buffer length, odd


def _compact_inputs(kind, seed, p=12):
    rng = np.random.default_rng(seed)
    if kind == "small":
        k = rng.integers(0, 9, p)            # a superstep's few pops
    elif kind == "zero":
        k = np.zeros(p, np.int64)
    else:
        k = np.full(p, N)
    buf = rng.normal(40.0, 20.0, (p, N)).astype(np.float32)
    now = rng.uniform(0.1, 500.0, p).astype(np.float32)
    return buf, k.astype(np.int32), now


@pytest.mark.parametrize("backend", ["lax", "pallas"])
@pytest.mark.parametrize("kind", ["small", "zero", "full"])
def test_compact_plain_matches_reference_at_path_pop_counts(kind, backend):
    buf, k, now = _compact_inputs(kind, 5)
    fn = jax.jit(jax.vmap(lambda b, kk, t: ref_ss.fifo_compact(
        b, kk, t, backend=backend)))
    want = np.asarray(fn(jnp.asarray(buf), jnp.asarray(k), jnp.asarray(now)))
    bt = torch.from_numpy(buf)
    got = pt_ss.fifo_compact_plain(bt, torch.from_numpy(k),
                                   torch.from_numpy(now),
                                   out=torch.empty_like(bt))
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    if kind == "full":
        assert np.array_equal(got.numpy(), np.broadcast_to(
            np.float32(0.0) - now[:, None], buf.shape))


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


# (points, rows, width, n_bins, sketch, latency offset, mask offset):
# one case per path through the kernel
CARD_HIST = {
    "warp_per_point": (4096, 16, 64, 512, False, 0, 0),
    "block_per_point": (20, 32, 768, 512, True, 0, 0),
    "head_and_tail": (4100, 5, 63, 101, False, 0, 0),
    # the mask one byte off its latencies: no float4 matches a mask word
    "scalar_loop": (40, 7, 33, 64, True, 0, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_HIST))
def test_hist_kernel_paths_match_plain_on_card(name):
    _needs_card()
    p, r, w, n_bins, sketch, lat_off, inc_off = CARD_HIST[name]
    lats, inc = _block("prefix" if name == "block_per_point" else "random",
                       seed=13, p=p, rows=r, width=w)
    rng = np.random.default_rng(14)
    counts = rng.integers(0, 50, (p, n_bins)).astype(np.int32)
    sums = ((rng.random((p, n_bins)) * 100).astype(np.float32)
            if sketch else None)
    dev = "cuda"
    lt = _offset_view(lats, lat_off, dev)
    it = _offset_view(inc, inc_off, dev)
    plan = pt_ss.hist_update_plan(p, r * w, n_bins, sketch=sketch,
                                  lats_ptr=lt.data_ptr(),
                                  inc_ptr=it.data_ptr())
    assert plan.vec_loads is (name != "scalar_loop")
    if name in ("warp_per_point", "block_per_point"):
        assert plan.warps_per_point == (1 if name == "warp_per_point" else 8)
    a = convert.hist_state_from_arrays(counts, sums, device=dev)
    b = convert.hist_state_from_arrays(counts, sums, device=dev)
    before = pt_ss.hist_update.launches
    pt_ss.hist_update(a, lt, it, n_bins=n_bins, backend="cuda",
                      sketch=sketch)
    pt_ss.hist_update_plain(b, lt, it, n_bins=n_bins, sketch=sketch)
    torch.cuda.synchronize()
    assert pt_ss.hist_update.launches == before + 1
    assert torch.equal(a[0], b[0])
    if sketch:
        torch.testing.assert_close(a[1], b[1], rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["small", "zero", "full"])
def test_compact_kernel_matches_plain_on_card(kind):
    _needs_card()
    buf, k, now = (torch.from_numpy(x).to("cuda")
                   for x in _compact_inputs(kind, 6, p=33))
    got = pt_ss.fifo_compact(buf, k, now, backend="cuda",
                             out=torch.empty_like(buf))
    want = pt_ss.fifo_compact_plain(buf, k, now, out=torch.empty_like(buf))
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
