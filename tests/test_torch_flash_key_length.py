"""B3 (``flash_attention``) with a key length of its own against the
reference, on the CPU, where the wrapper takes its plain version:
queries over ``S_k != S`` keys, unmasked (cross-attention), against the
reference model's ``sdpa`` with a mask of ones (float32 at 1e-5; bf16
at 2e-2, where the reference rounds the probabilities to bf16 before
P·V); ``S_k == S`` unmasked against the Pallas kernel in interpret
mode; and ``causal`` with ``S_k != S`` refused.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import attention as ref_attn
from repro_torch.kernels import flash_attention as fa


def _t(a, dtype):
    return torch.from_numpy(np.array(a)).to(dtype)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("sq,sk,h,kv", [(7, 33, 4, 4), (1, 50, 6, 2),
                                        (12, 5, 4, 1), (40, 40, 4, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_with_its_own_key_length_matches_sdpa(sq, sk, h, kv,
                                                          dtype):
    rng = np.random.default_rng(sq * 100 + sk)
    hd = 32
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, sq, h, hd), (2, sk, kv, hd), (2, sk, kv, hd)))
    jt = getattr(jnp, dtype)
    want = ref_attn.sdpa(*(jnp.asarray(a, jt) for a in (q, k, v)),
                         jnp.ones((1, sq, sk), bool))
    tt = getattr(torch, dtype)
    got = fa.flash_attention(
        *(_t(np.asarray(jnp.asarray(a, jt).astype(jnp.float32)), tt)
          for a in (q, k, v)), causal=False)
    assert got.shape == (2, sq, h, hd) and got.dtype == tt
    # bf16: the reference rounds the probabilities to bf16 before P·V
    _close(got, want.astype(jnp.float32),
           1e-5 if dtype == "float32" else 2e-2)


def test_flash_plain_unmasked_matches_pallas_kernel_interpret():
    """S_k = S_q with causal=False against the Pallas kernel itself."""
    rng = np.random.default_rng(13)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 32, 4, 32), (2, 32, 2, 32), (2, 32, 2, 32)))
    want = pallas_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=False,
                        bq=16, bk=16, interpret=True)
    got = fa.flash_attention(*(_t(a, torch.float32) for a in (q, k, v)),
                             causal=False)
    _close(got, want, 2e-5)


def test_flash_refuses_causal_with_another_key_length():
    q = torch.zeros(1, 4, 2, 32)
    k = torch.zeros(1, 6, 2, 32)
    for fn in (fa.flash_attention, fa.flash_attention_plain):
        with pytest.raises(ValueError, match="as many keys as queries"):
            fn(q, k, k, causal=True)
    with pytest.raises(ValueError, match=r"k \(B,S_k,KV,hd\)"):
        fa.flash_attention(q[0], k, k, causal=False)
    # the key length's own S_k == S case is unchanged
    assert fa.flash_attention(q, q, q, causal=True).shape == q.shape
