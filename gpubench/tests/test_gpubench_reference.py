"""The plain reference against hand-worked values and against the program
at tiny sizes on the CPU (float32, where both must agree to rounding)."""
import math

import pytest
import torch

from gpubench.lib import port
from gpubench.lib.weights import Weights, param_spec
from gpubench.reference import model as ref
from gpubench.tests import tiny


def test_rope_rotates_the_first_dims_half_split():
    x = torch.tensor([[[[1.0, 0.0, 5.0]]]])            # (B, L, H, D)
    out = ref.rope(x, torch.tensor([1]), theta=10000.0, rot=2)
    assert torch.allclose(out[0, 0, 0], torch.tensor(
        [math.cos(1.0), math.sin(1.0), 5.0]))


YARN = {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
        "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
        "type": "yarn"}


def test_yarn_at_factor_one_is_plain_rope_bit_for_bit():
    x = torch.randn(2, 5, 3, 64, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(2000, 2005)
    plain = ref.rope(x, pos, 10000.0, 64)
    assert torch.equal(ref.rope(x, pos, 10000.0, 64, dict(YARN, factor=1)),
                       plain)
    assert not torch.allclose(ref.rope(x, pos, 10000.0, 64, YARN), plain,
                              atol=1e-2)


def test_yarn_blends_deepseek_v2_lites_frequencies():
    # correction range for 64 rope dims over 4096 positions: [10, 23]
    inv = 1.0 / 10000.0 ** (torch.arange(0, 64, 2).float() / 64)
    out, m = ref.yarn(inv, YARN, 64, 10000.0)
    assert torch.equal(out[:11], inv[:11])
    assert torch.allclose(out[23:], inv[23:] / 40)
    assert torch.all(out[11:23] < inv[11:23])
    assert torch.all(out[11:23] > inv[11:23] / 40)
    assert m == 1.0                     # mscale == mscale_all_dim
    assert ref.yarn_mscale(40, 0.707) == pytest.approx(
        0.1 * 0.707 * math.log(40) + 1)
    assert ref.yarn_mscale(1, 0.707) == 1.0


def test_mla_scores_take_yarns_mscale():
    cfg = tiny.config(tiny.MOE)
    assert ref.Reference(cfg, None, "cpu").score_mscale == 1.0
    scaled = ref.Reference(dict(cfg, rope_scaling=YARN), None, "cpu")
    assert scaled.score_mscale == pytest.approx(
        (0.1 * 0.707 * math.log(40) + 1) ** 2)
    one = ref.Reference(dict(cfg, rope_scaling=dict(YARN, factor=1)), None,
                        "cpu")
    assert one.score_mscale == 1.0


def test_port_refuses_a_rope_scaling_it_does_not_run():
    cfg = tiny.config(tiny.MOE)
    with pytest.raises(ValueError, match="plain RoPE"):
        port.port_config(dict(cfg, rope_scaling=YARN), strict=False)
    port.port_config(dict(cfg, rope_scaling=dict(YARN, factor=1)),
                     strict=False)


def test_rms_norm_and_capacity_by_hand():
    y = ref.rms_norm(torch.tensor([3.0, 4.0]), torch.tensor([1.0, 2.0]), 0.0)
    assert torch.allclose(y, torch.tensor([3.0, 8.0]) / math.sqrt(12.5))
    assert ref.capacity(2048, 6, 1.25, 64) == 244       # int(240) + 1 → 244
    assert ref.capacity(32, 6, 1.25, 64) == 4
    assert ref.capacity(8, 1, 1.0, 8) == 4               # at least 4


def test_route_counts_slots_slot_major_and_drops_past_capacity():
    # two tokens, both prefer expert 0, then expert 1
    logits = torch.tensor([[[2.0, 1.0, 0.0], [2.0, 1.0, 0.0]]])
    expert, weight, keep = ref.route(logits, top_k=2, cap=1)
    assert expert.tolist() == [[[0, 1], [0, 1]]]
    # slot 0 of token 0 and of token 1 come before slot 1 of either:
    # expert 0 keeps token 0's slot 0, expert 1 token 0's slot 1
    assert keep.tolist() == [[[True, True], [False, False]]]
    p = torch.softmax(logits[0, 0], -1)
    assert torch.allclose(weight[0, 0], p[:2])


def test_route_breaks_ties_to_the_lower_expert():
    expert, _, _ = ref.route(torch.zeros(1, 1, 4), top_k=2, cap=4)
    assert expert.tolist() == [[[0, 1]]]


def test_gap_and_logit_error_by_hand():
    r = torch.tensor([[1.0, 3.0, 2.0], [0.0, 0.0, 1.0]])
    assert ref.widest_gap(r, torch.tensor([2, 2])).tolist() == [1.0, 0.0]
    got = r + torch.tensor([[0.0, 0.5, 0.0], [0.0, 0.0, 0.0]])
    err = ref.logit_error(got, r)
    assert math.isclose(err[0].item(), 0.5 / r[0].std().item(), rel_tol=1e-6)
    assert err[1].item() == 0.0


def test_fp8_control_rounds_operands():
    P = ref.Precision("fp8")
    x = torch.tensor([[1.0, 1.0 / 3.0]])
    w = torch.tensor([[1.0], [1.0]])
    assert P.mm(x, w).item() != pytest.approx(4.0 / 3.0, abs=1e-6)
    assert ref.Precision().mm(x, w).item() == pytest.approx(4.0 / 3.0)


def _program(cfg):
    from repro_torch.models import transformer
    pcfg = port.port_config(cfg, strict=False)
    params = transformer.abstract_params(pcfg).to_empty(device="cpu")
    w = Weights(cfg, 7, "cpu")
    w.fill(params)
    return pcfg, params, w


def test_weights_match_the_program_by_name_and_redraw_alike():
    cfg = tiny.config(tiny.MOE)
    _, params, w = _program(cfg)
    named = dict(params.named_parameters())
    again = w.float32("layers.1")
    assert torch.equal(named["layers.1.ffn.w_up"].float(), again["ffn.w_up"])
    assert set(param_spec(cfg)) == {"embed", "head", "layers.0", "layers.1",
                                    "layers.2"}


def test_dense_reference_matches_the_program():
    from repro_torch.models import transformer
    cfg = tiny.config(tiny.DENSE)
    pcfg, params, w = _program(cfg)
    toks = torch.randint(0, cfg["vocab_size"], (3, 10),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = transformer.forward(pcfg, params, {"tokens": toks})[0][:, -1]
    got, _ = ref.Reference(cfg, w.float32, "cpu").logits(toks)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)


def test_moe_reference_matches_prefill_and_decode_with_drops():
    from repro_torch.models import transformer
    cfg = tiny.config(tiny.MOE, moe_capacity_factor=0.5)
    pcfg, params, w = _program(cfg)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg["vocab_size"], (4, 9), generator=gen)
    dec = torch.randint(0, cfg["vocab_size"], (4, 3), generator=gen)
    with torch.no_grad():
        lg, cache = transformer.prefill(pcfg, params, {"tokens": toks}, 13)
        steps = []
        lengths = torch.full((4,), 9, dtype=torch.int32)
        for t in range(3):
            s, cache = transformer.decode_step(pcfg, params, dec[:, t:t + 1],
                                               cache, lengths)
            steps.append(s[:, 0])
            lengths = lengths + 1
    last, got = ref.Reference(cfg, w.float32, "cpu").logits(toks, dec)
    assert torch.allclose(last, lg[:, 0], atol=2e-5, rtol=1e-5)
    assert torch.allclose(got, torch.stack(steps, 1), atol=2e-5, rtol=1e-5)
    # the capacity dropped slots in the prompt's routing
    x = torch.randn(36, cfg["hidden_size"], generator=gen)
    _, _, keep = ref.route((x @ w.float32("layers.1")["ffn.router"])[None],
                           3, ref.capacity(36, 3, 0.5, 8))
    assert not keep.all()
