"""The campaign fold's top-K lists past 256 slots (ROADMAP C-P4), without
the reference.

On the card (``cuda``-marked: they skip without a GPU): the CUDA fold at
``k_top`` 257 and 1,024 (lists in shared memory) and 2,048 (past the
1,908 slots kept there: walked in the accumulator's own slots) bitwise
equal to ``campaign_fold_plain`` over two chunks in a row, each launched
twice.  Here, on the CPU: the wrapper takes any ``k_top >= 1`` and
refuses 0.  The fold's order is emulated on the CPU in
``tests/test_torch_fold_order.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.campaign import _init_acc
from repro_torch.kernels import campaign_fold as cf
from repro_torch.kernels.campaign_fold import (LOSS_KEYS, FoldAcc,
                                               campaign_fold,
                                               campaign_fold_plain)


def _chunk(rng, m, n_bins, has_loss):
    c = {"hist": rng.integers(0, 50, (m, n_bins)).astype(np.int32),
         "n_jobs": rng.integers(0, 1000, m).astype(np.int32),
         "batches": rng.integers(0, 100, m).astype(np.int32),
         "dropped": rng.integers(0, 3, m).astype(np.int32),
         "mean_latency": rng.lognormal(1.0, 1.0, m).astype(np.float32),
         "utilization": rng.uniform(0, 1, m).astype(np.float32),
         "mean_batch": rng.uniform(1, 30, m).astype(np.float32),
         "lam": rng.uniform(0.1, 10, m).astype(np.float32),
         "lat_bm_m2": rng.exponential(3.0, m).astype(np.float32),
         "lat_bm_n": rng.integers(0, 40, m).astype(np.int32)}
    # ties in both lists: the first minimal slot decides
    c["mean_latency"][::5] = c["mean_latency"][0]
    c["lam"][1::7] = c["lam"][1]
    c["mean_latency"][7 % m] = np.nan
    if has_loss:
        for k in LOSS_KEYS:
            c[k] = rng.integers(0, 200, m).astype(np.int32)
    return c


def _same(a: FoldAcc, b: FoldAcc) -> bool:
    return (torch.equal(a.ints, b.ints)
            and torch.equal(a.floats.view(torch.int64),
                            b.floats.view(torch.int64)))


def _fold_twice_each(dev, k, m, n_bins, has_loss, seed):
    """Two chunks into one accumulator through ``campaign_fold`` (twice
    from the same state) and the plain version, held bitwise; returns
    the wrapper's accumulator."""
    rng = np.random.default_rng(seed)
    acc = FoldAcc.from_host(_init_acc(n_bins, k), dev)
    plain = FoldAcc.from_host(_init_acc(n_bins, k), dev)
    for j in range(2):
        c = {key: torch.as_tensor(v, device=dev)
             for key, v in _chunk(rng, m, n_bins, has_loss).items()}
        g = torch.arange(j * m, (j + 1) * m, dtype=torch.int64, device=dev)
        again = FoldAcc(acc.ints.clone(), acc.floats.clone(), n_bins, k)
        kw = dict(has_loss=has_loss, sketch=False)
        s_k = campaign_fold(acc, c, g, m - 3, **kw)
        s_2 = campaign_fold(again, c, g, m - 3, **kw)
        s_p = campaign_fold_plain(plain, c, g, m - 3, **kw)
        assert torch.equal(s_k, s_p) and torch.equal(s_k, s_2), j
        assert _same(acc, plain), f"chunk {j}"
        assert _same(acc, again), f"chunk {j} repeated"
    return acc


@pytest.mark.cuda
@pytest.mark.parametrize("k", [257, 1024, 2048])
def test_cuda_fold_past_256_slots_equals_plain(k):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    before = campaign_fold.launches
    acc = _fold_twice_each(torch.device("cuda"), k, 3000, 64, k != 1024, k)
    assert campaign_fold.launches == before + 4
    idx = acc.views()["top_lat_idx"]
    assert int((idx >= 0).sum()) == k


@pytest.mark.parametrize("k", [1, 257, 2048])
def test_cpu_wrapper_takes_any_k_top(k):
    """No refusal by list length is left: on CPU tensors the wrapper is
    the plain version, which keeps any ``k_top >= 1``."""
    assert not hasattr(cf, "K_TOP_MAX")
    before = campaign_fold.launches
    acc = _fold_twice_each(torch.device("cpu"), k, 300, 8, True, k + 1)
    assert campaign_fold.launches == before
    idx = acc.views()["top_lat_idx"]
    assert int((idx >= 0).sum()) == min(k, 2 * 300 - 2 * 4)


def test_zero_slots_refused():
    acc = FoldAcc.from_host(_init_acc(8, 1), "cpu")
    acc.k_top = 0
    c = {key: torch.as_tensor(v)
         for key, v in _chunk(np.random.default_rng(0), 4, 8, False).items()}
    with pytest.raises(ValueError, match="at least one top-K slot"):
        campaign_fold(acc, c, torch.arange(4), 4, has_loss=False,
                      sketch=False)
