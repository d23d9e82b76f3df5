"""The port's meshes (``repro_torch.launch.mesh``) and its kernels' shape
functions on ``meta`` tensors (no JAX: these have no reference
counterpart beyond the reference's mesh shapes, 16 × 16 ("data",
"model") and 2 × 16 × 16 ("pod", "data", "model")).

Each test leaves no process group behind: under xdist the next test file
on the same worker must find none.
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch.kernels import _launch
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_int8)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_backward,
                                                 flash_attention_with_lse)
from repro_torch.kernels.mla_decode import mla_decode_attention
from repro_torch.kernels.ssd_scan import (ssd_chunked, ssd_scan,
                                          ssd_scan_backward)
from repro_torch.launch import dryrun, mesh as meshes


@pytest.fixture(autouse=True)
def _no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


@pytest.mark.parametrize("multi_pod,world,shape,names", [
    (False, 256, (16, 16), ("data", "model")),
    (True, 512, (2, 16, 16), ("pod", "data", "model")),
])
def test_production_mesh_over_a_fake_group(multi_pod, world, shape, names):
    with dryrun.fake_group(world):
        m = meshes.make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
        assert tuple(m.shape) == shape
        assert tuple(m.mesh_dim_names) == names
        assert m.size() == world


def test_production_mesh_refuses_another_world():
    with pytest.raises(ValueError, match="world size of 1"):
        meshes.make_production_mesh(device_type="cpu")
    with dryrun.fake_group(256):
        with pytest.raises(ValueError, match="512 ranks.*world size of 256"):
            meshes.make_production_mesh(multi_pod=True, device_type="cpu")


def test_host_mesh_on_the_cpu_makes_and_releases_its_own_group():
    with meshes.owned_group():
        m = meshes.make_host_mesh(device_type="cpu")
        assert tuple(m.shape) == (1, 1)
        assert tuple(m.mesh_dim_names) == ("data", "model")
        assert dist.get_backend() == "gloo"
        with pytest.raises(ValueError, match="does not divide"):
            meshes.make_host_mesh(3, device_type="cpu")


def test_host_mesh_leaves_a_callers_group_alone():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with meshes.owned_group():
            assert tuple(meshes.make_host_mesh(device_type="cpu").shape) \
                == (1, 1)
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the kernels' shape functions
# ---------------------------------------------------------------------------

def _pair(*shapes, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    cpu = [torch.randn(s, generator=gen).to(dtype) for s in shapes]
    return cpu, [t.to("meta") for t in cpu]


def _same(meta_out, cpu_out):
    if isinstance(cpu_out, tuple):
        assert len(meta_out) == len(cpu_out)
        for m, c in zip(meta_out, cpu_out):
            _same(m, c)
        return
    assert meta_out.device.type == "meta"
    assert (tuple(meta_out.shape), meta_out.dtype) == \
        (tuple(cpu_out.shape), cpu_out.dtype)


def _counts(fn):
    return (fn.launches, getattr(fn, "meta_calls", 0),
            getattr(fn, "meta_backward_calls", 0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hdv", [None, 24])
def test_flash_attention_meta_shapes(dtype, hdv):
    b, s, h, kv, hd = 2, 40, 4, 2, 32
    (q, k, v), (mq, mk, mv) = _pair((b, s, h, hd), (b, s, kv, hd),
                                    (b, s, kv, hdv or hd), dtype=dtype)
    before = _counts(flash_attention)
    _same(flash_attention(mq, mk, mv, window=7),
          flash_attention(q, k, v, window=7))
    out, lse = flash_attention_with_lse(q, k, v)
    _same(flash_attention_with_lse(mq, mk, mv), (out, lse))
    dout = torch.randn_like(out)
    _same(flash_attention_backward(mq, mk, mv, out.to("meta"),
                                   lse.to("meta"), dout.to("meta")),
          flash_attention_backward(q, k, v, out, lse, dout))
    after = _counts(flash_attention)
    assert after[0] == before[0]                   # no launch counted
    assert (after[1] - before[1], after[2] - before[2]) == (2, 1)


def test_flash_attention_meta_under_autograd():
    (_, _, _), (mq, mk, mv) = _pair((1, 16, 2, 32), (1, 16, 2, 32),
                                    (1, 16, 2, 32))
    mq.requires_grad_(True)
    before = _counts(flash_attention)
    out = flash_attention(mq, mk, mv)
    out.sum().backward()
    assert mq.grad.shape == mq.shape and mq.grad.device.type == "meta"
    after = _counts(flash_attention)
    assert (after[1] - before[1], after[2] - before[2]) == (1, 1)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_meta_shapes(window):
    b, s, h, kv, hd = 3, 20, 4, 2, 32
    (q, k, v), (mq, mk, mv) = _pair((b, h, hd), (b, s, kv, hd),
                                    (b, s, kv, hd))
    lengths = torch.tensor([0, 7, 19], dtype=torch.int32)
    before = _counts(decode_attention)
    _same(decode_attention(mq, mk, mv, lengths.to("meta"), window=window),
          decode_attention(q, k, v, lengths, window=window))
    assert _counts(decode_attention)[:2] == (before[0], before[1] + 1)
    codes = torch.randint(-127, 128, (b, s, kv, hd), dtype=torch.int8)
    scale = torch.rand(b, s, kv, 1)
    _same(decode_attention_int8(mq, codes.to("meta"), scale.to("meta"),
                                codes.to("meta"), scale.to("meta"),
                                lengths.to("meta"), window=window),
          decode_attention_int8(q, codes, scale, codes, scale, lengths,
                                window=window))


def test_mla_decode_meta_shapes():
    b, s, h, r, p = 2, 12, 4, 16, 8
    (qa, qp, ckv, kpe), meta = _pair((b, h, r), (b, h, p), (b, s, r),
                                     (b, s, p))
    lengths = torch.tensor([3, 11], dtype=torch.int32)
    _same(mla_decode_attention(*meta, lengths.to("meta"), scale=0.1),
          mla_decode_attention(qa, qp, ckv, kpe, lengths, scale=0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_meta_shapes(dtype):
    b, s, nh, hd, g, ds = 2, 70, 4, 32, 2, 16
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(b, s, nh, hd, generator=gen).to(dtype)
    dt = torch.rand(b, s, nh, generator=gen) * 0.1
    A = -torch.rand(nh, generator=gen) - 0.5
    B = torch.randn(b, s, g, ds, generator=gen).to(dtype)
    C = torch.randn(b, s, g, ds, generator=gen).to(dtype)
    args = (x, dt, A, B, C)
    meta = tuple(t.to("meta") for t in args)
    before = _counts(ssd_scan)
    _same(ssd_chunked(*meta, 32), ssd_chunked(*args, 32))
    _same(ssd_scan(*meta, chunk=32), ssd_scan(*args, chunk=32))
    dy = torch.randn(b, s, nh, hd)
    _same(ssd_scan_backward(*meta, dy.to("meta")),
          ssd_scan_backward(*args, dy))
    after = _counts(ssd_scan)
    assert after[0] == before[0]
    assert (after[1] - before[1], after[2] - before[2]) == (2, 1)


def test_shape_only_reports_the_kernel_operations():
    (_, _, _), (mq, mk, mv) = _pair((2, 64, 4, 32), (2, 64, 4, 32),
                                    (2, 64, 4, 32))
    ops0 = getattr(flash_attention, "meta_ops", 0.0)
    flash_attention(mq, mk, mv)
    # 2·(hd + hdv) flops a head and admitted (causal) pair
    assert flash_attention.meta_ops - ops0 == 2 * 64 * 2 * 4 * 64 * 65 / 2


def test_only_cpu_cuda_and_meta_are_kernel_devices():
    assert _launch.kernel_device(torch.empty(1, device="meta"), "k")
    assert not _launch.kernel_device(torch.empty(1), "k")

    class Elsewhere:
        device = torch.device("xpu")

    with pytest.raises(ValueError, match="runs on CUDA"):
        _launch.kernel_device(Elsewhere(), "k")
