"""The enc-dec and VLM slice without the reference: every registered
config builds, and (``cuda``-marked, skipped without a GPU) B3 with a
key length of its own and B4 at the enc-dec and VLM shapes against
their plain versions on the card.

The card's cases: whisper's cross-attention (queries over the 1,500
encoder rows, unmasked, in float32 as the engine's frames make it and in
bf16), its encoder (unmasked, S 1,500), the cross decode (B4 at lengths
1,499 over the 1,500-row cache, batch 1 splitting it) and InternVL2's
decode (14 query heads over 2 kv heads: group 7 over its 293-slot
cache); each launch counted, repeated bitwise, and within the kernels'
gates (float32 2e-5, bf16 2e-2).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as attn
from repro_torch.models import build
from repro_torch.models import transformer as tfm

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("arch", list_archs())
def test_every_registered_config_builds(arch):
    for cfg in (get_config(arch), reduced(get_config(arch))):
        assert build(cfg).cfg is cfg


def test_require_supported_names_an_unknown_family():
    cfg = dataclasses.replace(reduced(get_config("qwen1.5-0.5b")),
                              family="diffusion")
    with pytest.raises(NotImplementedError, match="diffusion"):
        tfm.require_supported(cfg)


def test_pad_time_refuses_a_shorter_target():
    x = torch.zeros(2, 5, 3)
    assert tfm._pad_time(x, 7).shape == (2, 7, 3)
    with pytest.raises(ValueError, match="cannot hold"):
        tfm._pad_time(x, 4)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")


def _randn(g, *shape, dtype):
    return torch.randn(*shape, device="cuda", generator=g).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_with_its_own_key_length_matches_plain(dtype):
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(3)
    # whisper's cross prefill (32 over 1,500), a ragged pair, its
    # encoder (unmasked at 1,500), fewer keys than queries
    for b, s, sk, h, kv, hd in [(4, 32, 1500, 16, 16, 64),
                                (2, 7, 1499, 16, 16, 64),
                                (1, 1500, 1500, 16, 16, 64),
                                (2, 70, 33, 14, 2, 64)]:
        q = _randn(g, b, s, h, hd, dtype=dtype)
        k = _randn(g, b, sk, kv, hd, dtype=dtype)
        v = _randn(g, b, sk, kv, hd, dtype=dtype)
        n = fa.flash_attention.launches
        got = fa.flash_attention(q, k, v, causal=False)
        again = fa.flash_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == n + 2
        assert torch.equal(got, again)
        want = fa.flash_attention_plain(q, k, v, causal=False)
        assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]
    with pytest.raises(ValueError, match="as many keys as queries"):
        fa.flash_attention(q, k, v, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_at_the_encdec_and_vlm_shapes_matches_plain(dtype):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(4)
    for b, s, h, kv, lengths in [(1, 1500, 16, 16, [1499]),
                                 (3, 1500, 16, 16, [1499] * 3),
                                 (8, 293, 14, 2,
                                  [-1, 0, 1, 255, 288, 292, 293, 298])]:
        q = _randn(g, b, h, 64, dtype=dtype)
        k = _randn(g, b, s, kv, 64, dtype=dtype)
        v = _randn(g, b, s, kv, 64, dtype=dtype)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        n = da.decode_attention.launches
        got = da.decode_attention(q, k, v, lens)
        again = da.decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == n + 2
        assert torch.equal(got, again)
        want = da.decode_attention_plain(q, k, v, lens)
        assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]


@pytest.mark.cuda
def test_cuda_cross_attend_matches_its_cpu_plain_path():
    """A bf16 block over float32 cross K/V (the engine's case) on the
    card against the same call on the CPU, where the kernels' plain
    versions run."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config("whisper-medium"))
    gen = torch.Generator(device="cuda").manual_seed(5)
    p = attn.init_gqa(gen, cfg, torch.bfloat16, cross=True)
    for name in ("bq", "bk", "bv"):
        p[name].data.normal_(generator=gen)
    x = _randn(gen, 2, 6, cfg.d_model, dtype=torch.bfloat16)
    enc = _randn(gen, 2, 1500, cfg.d_model, dtype=torch.float32)
    k, v = attn.cross_kv(p, enc)
    cpu = {n: w.cpu() for n, w in p.items()}
    kc, vc = attn.cross_kv(cpu, enc.cpu())
    for decode, xs in ((False, slice(None)), (True, slice(0, 1))):
        got = attn.cross_attend(p, x[:, xs], k, v, decode=decode)
        want = attn.cross_attend(cpu, x[:, xs].cpu(), kc, vc, decode=decode)
        assert got.dtype == torch.bfloat16
        assert float((got.cpu().float() - want.float()).abs().max()) <= 2e-2
