"""B3's backward kernels and the train step on the card, without the
reference (``cuda``-marked: they skip without a GPU; the CPU tests of
the same code are ``tests/test_torch_flash_backward.py`` and
``tests/test_torch_train.py``).

On the card: ``flash_attention_backward`` against
``flash_attention_backward_plain`` on the forward kernel's own ``out``
and ``lse`` (float32 within 2e-5 of the largest gradient, bf16 within
1/128 of it: both compute in float32 from the same inputs, and bf16
rounds each gradient once), twice bitwise, and equal to autograd through
``flash_attention``; the forward under ``inference_mode`` saves nothing
and counts no backward; one train step of reduced qwen1.5-0.5b launches
B3's forward and backward once a layer each.  Without a GPU the entry
points refuse the card (here, on the CPU).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import transformer as tfm
from repro_torch.train import loop
from repro_torch.train import optimizer as opt

TOL = {torch.float32: 2e-5, torch.bfloat16: 2 ** -7}
# (dtype, B, S, H, KV, hd, hdv, causal, window, S_k)
CASES = [
    (torch.bfloat16, 2, 128, 4, 4, 64, 64, True, 0, 0),
    (torch.float32, 2, 128, 4, 4, 64, 64, True, 0, 0),
    (torch.bfloat16, 1, 300, 8, 2, 128, 128, True, 64, 0),
    (torch.bfloat16, 1, 77, 4, 4, 192, 128, True, 0, 0),
    (torch.float32, 1, 77, 4, 4, 192, 128, True, 0, 0),
    (torch.float32, 2, 16, 4, 4, 64, 64, False, 0, 300),
    (torch.bfloat16, 2, 61, 6, 2, 32, 32, False, 9, 0),
    (torch.float32, 1, 40, 2, 2, 32, 32, False, -3, 0),
]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES,
                         ids=[str(i) for i in range(len(CASES))])
def test_cuda_backward_matches_plain_twice_bitwise(case):
    _need_cuda()
    dt, b, s, h, kv, hd, hdv, causal, window, sk = case
    sk = sk or s
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, do = (torch.randn(*shape, device="cuda", generator=g).to(dt)
                   for shape in ((b, s, h, hd), (b, sk, kv, hd),
                                 (b, sk, kv, hdv), (b, s, h, hdv)))
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal,
                                           window=window)
    before = fa.flash_attention.backward_launches
    got = fa.flash_attention_backward(q, k, v, out, lse, do, causal=causal,
                                      window=window)
    again = fa.flash_attention_backward(q, k, v, out, lse, do,
                                        causal=causal, window=window)
    want = fa.flash_attention_backward_plain(q, k, v, out, lse, do,
                                             causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.backward_launches == before + 2
    for x, y, w in zip(got, again, want):
        assert x.dtype == dt and torch.equal(x, y)
        scale = max(float(w.float().abs().max()), 1e-6)
        assert float((x.float() - w.float()).abs().max()) <= TOL[dt] * scale
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.flash_attention(*leaves, causal=causal, window=window).backward(do)
    for leaf, x in zip(leaves, got):
        assert torch.equal(leaf.grad, x)


@pytest.mark.cuda
def test_cuda_serving_forward_saves_nothing():
    _need_cuda()
    q = torch.randn(1, 64, 4, 64, device="cuda", requires_grad=True)
    k, v = torch.randn(2, 1, 64, 4, 64, device="cuda")
    with torch.inference_mode():
        out = fa.flash_attention(q, k, v)
    assert out.grad_fn is None
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None
    assert fa.flash_attention(q, k, v).grad_fn is not None


@pytest.mark.cuda
def test_cuda_train_step_runs_b3_forward_and_backward_once_a_layer():
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config("qwen1.5-0.5b"))
    model = tfm.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                              generator=g) for k in ("tokens", "labels")}
    step = loop.make_train_step(cfg, opt.AdamWConfig())
    fa.flash_attention.launches = fa.flash_attention.backward_launches = 0
    model, state, m = step(model, opt.init_state(model), batch)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == cfg.num_layers
    assert fa.flash_attention.backward_launches == cfg.num_layers
    assert all(bool(torch.isfinite(t)) for t in m.values())


def test_training_the_card_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="GPU"):
        loop.resolve_device("cuda")
    assert loop.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_device_batch_adds_the_reference_trainers_zero_inputs(family):
    arch = {"vlm": "internvl2-1b", "audio": "whisper-medium"}[family]
    cfg = reduced(get_config(arch))
    batch = {"tokens": np.zeros((3, 8), np.int32),
             "labels": np.ones((3, 8), np.int32)}
    out = loop.device_batch(cfg, batch, "cpu")
    key = "patch_embeds" if family == "vlm" else "frames"
    assert out["tokens"].dtype == torch.int64
    assert out[key].shape == (3, cfg.encoder.n_ctx, cfg.d_model)
    assert out[key].dtype == torch.float32 and not out[key].any()
