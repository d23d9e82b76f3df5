"""The port's hybrid Mamba2 / attention interleave (Jamba) against the
reference's, and B5 at Jamba's widths.

Reduced jamba-v0.1-52b is a period-2 hybrid (a Mamba2 layer, then an
attention layer with the MoE FFN); it runs with its MoE, without it,
and at 4 layers, where the reference stacks two repeats of the period
under ``lax.scan`` and ``convert.model_params_from_jax`` unstacks them.
Weights come from the reference's init; both models run the same
tokens in float32 on the CPU, where the attention cores and the SSD
scan take their kernels' plain versions.  Forward, prefill (logits and
every layer's cache: K/V beside Mamba2's conv windows and state) and
three decode steps agree to 1e-4 (measured: ≤ 1.6e-5).  The prompt is
70 tokens, so the scan carries its state across chunks of 32.  Under
``REPRO_KV_INT8=1`` (set through ``monkeypatch`` only) the attention
layers hold int8 codes and the Mamba2 layers their float state;
prefill agrees at 1e-4, decode at 1e-3, as in tests/test_torch_kv_int8.py.
B5's plain version at Jamba's (head_dim 64, d_state 16) is held
against ``ssd_scan_ref``; the CUDA kernel at that pair is held against
the plain version in chip_smoke.py on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.kernels.ref import ssd_scan_ref
from repro.models import build as ref_build
from repro_torch.configs import get_config as pt_get_config
from repro_torch.configs import reduced as pt_reduced
from repro_torch.convert import model_params_from_jax
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import build
from repro_torch.models import transformer as tfm

ARCH = "jamba-v0.1-52b"
ATOL = 1e-4
B, PROMPT, EXTRA = 2, 70, 3
VARIANTS = {
    "jamba": {},
    "jamba-no-moe": {"moe": None},
    "jamba-4-layers": {"num_layers": 4},
}


def _cfgs(variant):
    kw = VARIANTS[variant]
    return (dataclasses.replace(reduced(get_config(ARCH)), **kw),
            dataclasses.replace(pt_reduced(pt_get_config(ARCH)), **kw))


def _rig(variant):
    cfg, pcfg = _cfgs(variant)
    ref = ref_build(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    pparams = model_params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(B, PROMPT + EXTRA)).astype(np.int32)
    return ref, params, build(pcfg), pparams, toks


@pytest.fixture(scope="module")
def rigs():
    return {v: _rig(v) for v in VARIANTS}


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _ref_layer(cfg, tree, i):
    """Layer ``i``'s entry of a reference pytree of ``{"lead",
    "stack"}``: repeat ``(i - lead) // p`` of stack entry ``(i - lead) %
    p``."""
    lead, p, _ = tfm.split_pattern(cfg)
    if i < lead:
        return tree["lead"][i]
    j, r = (i - lead) % p, (i - lead) // p
    return jax.tree.map(lambda a: np.asarray(a)[r], tree["stack"][j])


def _check_caches(cfg, pc, rc, atol=ATOL):
    assert len(pc) == cfg.num_layers
    for i, (kind, layer) in enumerate(zip(cfg.layer_kinds(), pc)):
        want = _ref_layer(cfg, rc, i)
        assert set(layer) == set(want), (i, kind)
        for name, got in layer.items():
            assert got.shape == want[name].shape, (i, name)
            assert got.numpy().dtype == want[name].dtype, (i, name)
            np.testing.assert_allclose(got.float().numpy(),
                                       want[name].astype(np.float32),
                                       rtol=0, atol=atol, err_msg=f"{i} {name}")


def test_stack_pattern_is_the_reference_pattern():
    for variant in VARIANTS:
        cfg, pcfg = _cfgs(variant)
        assert tfm.layer_specs(pcfg) == [tuple(s) for s in zip(
            cfg.layer_kinds(), cfg.moe_layers())]
    full = pt_get_config(ARCH)
    assert tfm.split_pattern(full) == (0, 8, 4)
    cut = dataclasses.replace(full, num_layers=16)
    kinds = cut.layer_kinds()
    assert [i for i, k in enumerate(kinds) if k == "attn"] == [4, 12]
    assert [i for i, m in enumerate(cut.moe_layers()) if m] == list(
        range(1, 16, 2))
    assert tfm.split_pattern(cut) == (0, 8, 2)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_converted_weights_are_the_reference_weights(variant, rigs):
    _, params, port, pparams, _ = rigs[variant]
    cfg = port.cfg
    for i, blk in enumerate(pparams.layers):
        want = _ref_layer(cfg, params, i)
        assert set(blk) == set(want)
        flat = jax.tree_util.tree_flatten_with_path(want)[0]
        got = dict(blk.named_parameters())
        assert len(got) == len(flat)
        for path, w in flat:
            key = ".".join(str(getattr(k, "key", k)) for k in path)
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(w))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_reference(variant, rigs):
    ref, params, port, pparams, toks = rigs[variant]
    want, want_aux = ref.forward(params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, aux = port.forward(pparams, {"tokens": _t(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    assert (float(aux) > 0) == (port.cfg.moe is not None)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_match_reference(variant, rigs):
    ref, params, port, pparams, toks = rigs[variant]
    cfg = port.cfg
    S = PROMPT
    want, rc = ref.prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                           S + EXTRA)
    with torch.inference_mode():
        got, pc = port.prefill(pparams, {"tokens": _t(toks[:, :S])},
                               S + EXTRA)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    _check_caches(cfg, pc, rc)
    lens = jnp.full((B,), S, jnp.int32)
    plens = torch.full((B,), S, dtype=torch.int32)
    for t in range(EXTRA):
        tok = toks[:, S + t:S + t + 1]
        want, rc = ref.decode_step(params, jnp.asarray(tok), rc, lens)
        with torch.inference_mode():
            got, pc = port.decode_step(pparams, _t(tok), pc, plens)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
        _check_caches(cfg, pc, rc)
        lens, plens = lens + 1, plens + 1


def test_int8_kv_cache_on_the_attention_layers(rigs, monkeypatch):
    """``REPRO_KV_INT8=1``: int8 codes and float32 scales on the
    attention layers, the float conv windows and state on the Mamba2
    layers; prefill at 1e-4 and three decode steps at 1e-3 against the
    reference under the same switch."""
    monkeypatch.setenv("REPRO_KV_INT8", "1")
    ref, params, port, pparams, toks = rigs["jamba-4-layers"]
    cfg = port.cfg
    S = PROMPT
    want, rc = ref.prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                           S + EXTRA)
    with torch.inference_mode():
        got, pc = port.prefill(pparams, {"tokens": _t(toks[:, :S])},
                               S + EXTRA)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    for kind, layer in zip(cfg.layer_kinds(), pc):
        if kind == "attn":
            assert set(layer) == {"k", "k_scale", "v", "v_scale"}
            assert layer["k"].dtype == layer["v"].dtype == torch.int8
        else:
            assert set(layer) == {"conv_x", "conv_bc", "ssm"}
            assert layer["ssm"].dtype == torch.float32
    lens = jnp.full((B,), S, jnp.int32)
    plens = torch.full((B,), S, dtype=torch.int32)
    for t in range(EXTRA):
        tok = toks[:, S + t:S + t + 1]
        want, rc = ref.decode_step(params, jnp.asarray(tok), rc, lens)
        with torch.inference_mode():
            got, pc = port.decode_step(pparams, _t(tok), pc, plens)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-3)
        lens, plens = lens + 1, plens + 1


def test_ssd_plain_at_jamba_widths_matches_the_oracle():
    """B5's plain version at (head_dim 64, d_state 16), one group, a
    ragged 70 steps in chunks of 32, against the sequential recurrence
    at tests/test_kernels.py's 2e-3; and the CUDA route takes the pair."""
    b, s, nh, g, hd, ds = 2, 70, 4, 1, 64, 16
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((b, s, nh, hd)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, nh)), 0.0).astype(
        np.float32)
    a = (-np.exp(rng.standard_normal(nh) * 0.3)).astype(np.float32)
    bm = (rng.standard_normal((b, s, g, ds)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, g, ds)) * 0.3).astype(np.float32)
    arrs = (x, dt, a, bm, cm)
    got = ss.ssd_scan(*(torch.from_numpy(v) for v in arrs), chunk=32)
    want = ssd_scan_ref(*(jnp.asarray(v) for v in arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)
    assert (64, 16) in ss.WIDTHS
    ss.launchable(*(torch.from_numpy(v) for v in arrs))
    bf = [torch.from_numpy(v) for v in arrs]
    for i in (0, 3, 4):
        bf[i] = bf[i].to(torch.bfloat16)
    ss.launchable(*bf)
