"""The port's MoE FFN and q/k norms against the reference's.

``_capacity`` is the reference's for every group size.  ``_route`` takes
the same float32 logits: at the published capacity factor 1.25, on
logits skewed so that experts overflow, the dense dispatch tensor and
the combine's mask built from the port's (expert, position, keep,
weight) are the reference's bit for bit, the combine weights agree to
two ulps (torch's exp and XLA's differ in the last bit on some inputs)
and the aux loss to 1e-6; on a padded
tail (group 8, 20 tokens) the zero rows' tied probabilities take the
lowest-indexed experts, as ``lax.top_k`` does.  ``apply_moe`` with and
without shared experts agrees to 1e-5 in float32 (measured ≤ 1e-6).
Reduced olmoe-1b-7b (capacity factor E/k, q/k norms) runs on the
reference's weights through ``convert.model_params_from_jax``:
``forward`` (logits and aux), ``prefill`` with its caches and three
``decode_step``s agree to 1e-4, as the other model tests do; and a dense
config with ``qk_norm=True`` alone does too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import build as ref_build
from repro.models import moe as ref_moe
from repro_torch.configs import get_config as pt_get_config
from repro_torch.configs import reduced as pt_reduced
from repro_torch.convert import model_params_from_jax
from repro_torch.models import build
from repro_torch.models import moe as pt_moe
from repro_torch.models import transformer as tfm

ATOL = 1e-4
B, EXTRA = 2, 3


def _olmoe(capacity_factor=1.25, **kw):
    ref = dataclasses.replace(get_config("olmoe-1b-7b").moe,
                              capacity_factor=capacity_factor, **kw)
    port = dataclasses.replace(pt_get_config("olmoe-1b-7b").moe,
                               capacity_factor=capacity_factor, **kw)
    return ref, port


@pytest.mark.parametrize("t", [1, 2, 3, 7, 8, 31, 32, 100, 1024, 2048])
@pytest.mark.parametrize("factor", [1.25, 8.0])
def test_capacity_is_the_reference(t, factor):
    ref, port = _olmoe(factor)
    assert pt_moe._capacity(t, port) == ref_moe._capacity(t, ref)


def _dense(expert, pos, keep, weight, e, cap):
    """The reference's (G, T, E, C) dispatch and combine from the port's
    routing."""
    g, t, k = expert.shape
    disp = torch.zeros(g, t, e, cap)
    comb = torch.zeros(g, t, e, cap)
    gi, ti, ki = torch.nonzero(keep, as_tuple=True)
    disp[gi, ti, expert[gi, ti, ki], pos[gi, ti, ki]] = 1.0
    comb[gi, ti, expert[gi, ti, ki], pos[gi, ti, ki]] = weight[gi, ti, ki]
    return disp.numpy(), comb.numpy()


def test_route_drops_as_the_reference_at_the_published_factor():
    ref, port = _olmoe(1.25, num_experts=8, top_k=2)
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 64, 8)).astype(np.float32)
    logits[..., :2] += 2.0                # experts 0 and 1 overflow
    cap = ref_moe._capacity(64, ref)
    want_d, want_c, want_aux = ref_moe._route(jnp.asarray(logits), ref, cap)
    expert, pos, keep, weight, aux = pt_moe._route(
        torch.from_numpy(logits), port, cap)
    got_d, got_c = _dense(expert, pos, keep, weight, 8, cap)
    assert not bool(keep.all())                          # tokens dropped
    np.testing.assert_array_equal(got_d, np.asarray(want_d))
    # the combine's mask bit for bit; its weights are the softmax's, whose
    # exp differs from XLA's in the last bit on some entries
    np.testing.assert_array_equal(got_c != 0, np.asarray(want_c) != 0)
    np.testing.assert_allclose(got_c, np.asarray(want_c), rtol=3e-7,
                               atol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0,
                               atol=1e-6)


def test_padded_tail_ties_take_the_reference_experts():
    ref, port = _olmoe(1.25, num_experts=8, top_k=2, d_expert=24)
    rng = np.random.default_rng(1)
    d = 16
    p = ref_moe.init_moe(jax.random.PRNGKey(1), d, ref, "swiglu",
                         jnp.float32)
    x = rng.standard_normal((1, 20, d)).astype(np.float32)
    # the group of 8 pads 20 tokens with 4 zero rows, whose logits are 0
    xg = np.concatenate([x[0], np.zeros((4, d), np.float32)]).reshape(
        3, 8, d)
    logits = xg @ np.asarray(p["router"])
    cap = ref_moe._capacity(8, ref)
    want_d, _, _ = ref_moe._route(jnp.asarray(logits), ref, cap)
    expert, pos, keep, weight, _ = pt_moe._route(torch.from_numpy(logits),
                                                 port, cap)
    np.testing.assert_array_equal(expert[2, 4:].numpy(),
                                  np.tile([0, 1], (4, 1)))
    got_d, _ = _dense(expert, pos, keep, weight, 8, cap)
    np.testing.assert_array_equal(got_d, np.asarray(want_d))
    want, _ = ref_moe.apply_moe(p, ref, jnp.asarray(x), "swiglu",
                                group_size=8)
    pp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    got, _ = pt_moe.apply_moe(pp, port, torch.from_numpy(x), "swiglu",
                              group_size=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def _params_dict(p):
    return {k: (_params_dict(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v))) for k, v in p.items()}


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_apply_moe_matches_reference(shared, activation):
    kw = dict(num_experts=8, top_k=2, d_expert=24)
    if shared:
        kw.update(num_shared_experts=2, d_shared=12)
    ref, port = _olmoe(1.25, **kw)
    d = 32
    p = ref_moe.init_moe(jax.random.PRNGKey(2), d, ref, activation,
                         jnp.float32)
    assert ("shared" in p) == shared
    x = np.random.default_rng(2).standard_normal((3, 50, d)).astype(
        np.float32)
    for group in (ref_moe.DEFAULT_GROUP, 64):
        want, want_aux = ref_moe.apply_moe(p, ref, jnp.asarray(x),
                                           activation, group_size=group)
        got, aux = pt_moe.apply_moe(_params_dict(p), port,
                                    torch.from_numpy(x), activation,
                                    group_size=group)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=0,
                                   atol=1e-6)


def test_apply_moe_repeats_bitwise():
    ref, port = _olmoe(1.25, num_experts=8, top_k=2, d_expert=24)
    p = _params_dict(ref_moe.init_moe(jax.random.PRNGKey(3), 32, ref,
                                      "swiglu", jnp.float32))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 40, 32)).astype(np.float32))
    a, _ = pt_moe.apply_moe(p, port, x, "swiglu", group_size=16)
    b, _ = pt_moe.apply_moe(p, port, x, "swiglu", group_size=16)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# reduced olmoe-1b-7b and q/k norms on a dense config
# ---------------------------------------------------------------------------

def _qk_norm_dense(get, red):
    return dataclasses.replace(red(get("qwen1.5-0.5b")), qk_norm=True)


CONFIGS = {
    "olmoe-1b-7b": (lambda: reduced(get_config("olmoe-1b-7b")),
                    lambda: pt_reduced(pt_get_config("olmoe-1b-7b"))),
    "dense-qk-norm": (lambda: _qk_norm_dense(get_config, reduced),
                      lambda: _qk_norm_dense(pt_get_config, pt_reduced)),
}


@pytest.fixture(scope="module")
def rigs():
    out = {}
    for name, (ref_cfg, port_cfg) in CONFIGS.items():
        cfg = ref_cfg()
        ref = ref_build(cfg)
        params = ref.init(jax.random.PRNGKey(0))
        # q/k norm scales of ones would hide a wrong axis
        params = jax.tree_util.tree_map_with_path(
            lambda path, v: (v * (1.0 + 0.1 * jnp.arange(v.shape[-1]))
                             if jax.tree_util.keystr(path).endswith(
                                 "_norm']") else v), params)
        pcfg = port_cfg()
        pparams = model_params_from_jax(pcfg,
                                        jax.tree.map(np.asarray, params),
                                        device="cpu")
        toks = np.random.default_rng(1).integers(
            0, cfg.vocab_size, size=(B, 32 + EXTRA)).astype(np.int32)
        out[name] = (ref, params, build(pcfg), pparams, toks)
    return out


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_olmoe_layers_are_moe_with_qk_norms(rigs):
    _, params, port, pparams, _ = rigs["olmoe-1b-7b"]
    assert port.cfg.moe_layers() == [True] * port.cfg.num_layers
    for blk in pparams.layers:
        assert set(blk["ffn"]) == {"router", "w_gate", "w_up", "w_down"}
        assert blk["ffn"]["router"].dtype == torch.float32
        assert {"q_norm", "k_norm"} <= set(blk["attn"])
    stack = params["stack"][0]
    for i, blk in enumerate(pparams.layers):
        for key, w in blk["ffn"].items():
            np.testing.assert_array_equal(w.numpy(),
                                          np.asarray(stack["ffn"][key][i]))
        np.testing.assert_array_equal(blk["attn"]["q_norm"].numpy(),
                                      np.asarray(stack["attn"]["q_norm"][i]))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_reference(name, rigs):
    ref, params, port, pparams, toks = rigs[name]
    want, want_aux = ref.forward(params, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got, aux = port.forward(pparams, {"tokens": _t(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0,
                               atol=1e-5)
    assert (float(aux) > 0) == (name == "olmoe-1b-7b")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_and_decode_match_reference(name, rigs):
    ref, params, port, pparams, toks = rigs[name]
    S = toks.shape[1] - EXTRA
    want, rc = ref.prefill(params, {"tokens": jnp.asarray(toks[:, :S])},
                           S + EXTRA)
    with torch.inference_mode():
        got, pc = port.prefill(pparams, {"tokens": _t(toks[:, :S])},
                               S + EXTRA)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)

    def check(pc, rc):
        for i, layer in enumerate(pc):
            for key, t in layer.items():
                np.testing.assert_allclose(
                    t.numpy(), np.asarray(rc["stack"][0][key][i]), rtol=0,
                    atol=ATOL)
    check(pc, rc)
    lens = jnp.full((B,), S, jnp.int32)
    plens = torch.full((B,), S, dtype=torch.int32)
    for t in range(EXTRA):
        tok = toks[:, S + t:S + t + 1]
        want, rc = ref.decode_step(params, jnp.asarray(tok), rc, lens)
        with torch.inference_mode():
            got, pc = port.decode_step(pparams, _t(tok), pc, plens)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
        check(pc, rc)
        lens, plens = lens + 1, plens + 1


def test_still_unported_features_raise_on_the_moe_family():
    """Learned positions (8e) and the attention interleave (8b-hybrid),
    once unported, both build on the MoE family and give the reference's
    forward logits and aux loss: OLMoE's MoE and q/k norms with a
    learned position table in place of RoPE, and on a period-2
    interleave with reduced Jamba's Mamba2 layers."""
    cfg = pt_reduced(pt_get_config("olmoe-1b-7b"))
    tfm.require_supported(cfg)
    ssm = pt_reduced(pt_get_config("jamba-v0.1-52b")).ssm
    for kw, kinds in ((dict(learned_positions=True), ["attn", "attn"]),
                      (dict(attn_layer_period=2, ssm=ssm), ["attn", "ssm"])):
        pcfg = dataclasses.replace(cfg, **kw)
        rcfg = dataclasses.replace(reduced(get_config("olmoe-1b-7b")), **kw)
        assert pcfg.layer_kinds() == kinds
        ref = ref_build(rcfg)
        params = ref.init(jax.random.PRNGKey(4))
        pparams = model_params_from_jax(
            pcfg, jax.tree.map(np.asarray, params), device="cpu")
        assert (pparams.pos_embed is not None) == pcfg.learned_positions
        toks = np.random.default_rng(4).integers(0, pcfg.vocab_size,
                                                 size=(B, 40))
        want, want_aux = ref.forward(params, {"tokens": jnp.asarray(toks)})
        with torch.inference_mode():
            got, aux = build(pcfg).forward(
                pparams, {"tokens": torch.from_numpy(toks).long()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
