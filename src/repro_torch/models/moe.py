"""Mixture-of-experts FFN with GShard-style capacity routing.

Port of the reference package's ``repro.models.moe``.  The routing is
the reference's: a float32 router, softmax, top-k, and each expert's
slots counted slot-major and token-minor (slot 0 of every token of the
group before slot 1 of any), so that a token's later choices are the
first dropped once an expert holds ``_capacity`` tokens.  Tokens are
routed in groups of ``DEFAULT_GROUP``; the last group is padded with
zero rows, which are routed like real ones (their probabilities tie, and
take the lowest-indexed experts).

Where the reference dispatches and combines with one-hot ``(G, T, E,
C)`` einsums, the port moves rows by index: ``_route`` gives each
(token, slot) its expert, its position in that expert and its combine
weight (0 when dropped); ``apply_moe`` copies each kept token's row into
its ``(G, E, C, d)`` expert slot (every slot takes at most one row, so
the copy is exact and needs no atomics), runs the experts as batched
matrix products over the padded slots, as the reference's einsums do,
and sums a token's k weighted expert rows in slot order, in float32.
The tensors are the reference's, the drops the same, and two runs agree
bit for bit.  The one-hot tensors would be ≈ 2.7 GB each in float32 at
a prompt of 32 × 1,024 tokens (16 groups, C 324).

``lax.top_k`` returns the lowest index first among equal values and
``torch.topk`` promises no order there, so the top-k is a stable
descending sort.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import _init_w

__all__ = ["DEFAULT_GROUP", "init_moe", "apply_moe"]

DEFAULT_GROUP = 2048


def init_moe(gen: torch.Generator, d_model: int, moe: MoEConfig,
             activation: str, dtype: torch.dtype) -> nn.ParameterDict:
    """``router`` (d, E) float32, the experts' ``w_gate``, ``w_up`` (E, d,
    f) and ``w_down`` (E, f, d), and with shared experts a ``shared``
    dict of one (d, n·f_shared) MLP."""
    e, f = moe.num_experts, moe.d_expert
    p = nn.ParameterDict({
        "router": _init_w(gen, (d_model, e), torch.float32),
        "w_gate": _init_w(gen, (e, d_model, f), dtype),
        "w_up": _init_w(gen, (e, d_model, f), dtype),
        "w_down": _init_w(gen, (e, f, d_model), dtype),
    })
    if moe.num_shared_experts:
        fs = moe.num_shared_experts * moe.d_shared
        p["shared"] = nn.ParameterDict({
            "w_gate": _init_w(gen, (d_model, fs), dtype),
            "w_up": _init_w(gen, (d_model, fs), dtype),
            "w_down": _init_w(gen, (fs, d_model), dtype),
        })
    return p


def _capacity(tokens_per_group: int, moe: MoEConfig) -> int:
    c = int(tokens_per_group * moe.top_k * moe.capacity_factor
            / moe.num_experts) + 1
    return max(4, c + (-c) % 4)


def _route(logits: torch.Tensor, moe: MoEConfig, capacity: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor, torch.Tensor]:
    """GShard top-k routing of logits (G, T, E) float32.

    Returns ``(expert, pos, keep, weight, aux)``: for each (group, token,
    slot) ``(G, T, K)`` the expert chosen, the token's position in that
    expert's slots, whether it is within ``capacity``, and its combine
    weight (the probability, 0 when dropped); and the Switch/GShard
    load-balance loss ``E · mean_g Σ_e f_e · P_e``."""
    g, t, e = logits.shape
    k = moe.top_k
    probs = torch.softmax(logits, dim=-1)
    top_p, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, expert = top_p[..., :k], expert[..., :k]            # (G,T,K)
    sel = F.one_hot(expert, e).to(torch.int32)                 # (G,T,K,E)
    # positions counted slot-major, token-minor
    sel_f = sel.transpose(1, 2).reshape(g, k * t, e)
    pos_f = torch.cumsum(sel_f, dim=1) - sel_f
    pos = (pos_f.reshape(g, k, t, e).transpose(1, 2) * sel).sum(-1)
    keep = pos < capacity                                       # (G,T,K)
    weight = torch.where(keep, top_p, 0.0)
    frac = (sel * keep[..., None]).sum(dim=2).float().mean(dim=1)  # (G,E)
    aux = e * (frac * probs.mean(dim=1)).sum(-1).mean()
    return expert, pos, keep, weight, aux


def _expert_mlp(p, xin: torch.Tensor, activation: str) -> torch.Tensor:
    """xin: (G,E,C,d) -> (G,E,C,d) through each expert's own MLP, as
    batched products over the experts."""
    g, e, c, d = xin.shape
    xe = xin.transpose(0, 1).reshape(e, g * c, d)
    gte = torch.bmm(xe, p["w_gate"])
    up = torch.bmm(xe, p["w_up"])
    h = (F.silu(gte) if activation == "swiglu"
         else F.gelu(gte, approximate="tanh")) * up
    out = torch.bmm(h, p["w_down"])                            # (E,G·C,d)
    return out.reshape(e, g, c, d).transpose(0, 1)


def apply_moe(p, moe: MoEConfig, x: torch.Tensor, activation: str,
              group_size: int = DEFAULT_GROUP
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (out (B,S,d), aux_loss ())."""
    b, s, d = x.shape
    t_total = b * s
    tg = min(group_size, t_total)
    pad = (-t_total) % tg
    xf = x.reshape(t_total, d)
    if pad:
        xf = torch.cat([xf, xf.new_zeros(pad, d)], dim=0)
    g = xf.shape[0] // tg
    xg = xf.reshape(g, tg, d)

    logits = xg.float() @ p["router"]
    cap = _capacity(tg, moe)
    expert, pos, keep, weight, aux = _route(logits, moe, cap)

    # dispatch: each kept (token, slot) row into its expert slot; the
    # dropped ones go to a spare slot C that is cut off
    e, k = moe.num_experts, moe.top_k
    slot = torch.where(keep, pos, cap)
    gi = torch.arange(g, device=x.device)[:, None, None].expand_as(slot)
    xin = xg.new_zeros(g, e, cap + 1, d)
    xin[gi, expert, slot] = xg[:, :, None, :].expand(g, tg, k, d)
    xout = _expert_mlp(p, xin[:, :, :cap], activation)

    # combine: Σ_k weight_k · out[expert_k, pos_k], k in order, in
    # float32 (a dropped slot reads any row, at weight 0)
    w = weight.to(x.dtype).float()
    slot = slot.clamp(max=cap - 1)
    yg = xg.new_zeros(g, tg, d, dtype=torch.float32)
    for i in range(k):
        row = xout[gi[..., i], expert[..., i], slot[..., i]]    # (G,T,d)
        yg = yg + row.float() * w[..., i, None]
    y = yg.to(x.dtype).reshape(-1, d)[:t_total].reshape(b, s, d)

    if "shared" in p:
        sh = p["shared"]
        gt = x @ sh["w_gate"]
        up = x @ sh["w_up"]
        h = (F.silu(gt) if activation == "swiglu"
             else F.gelu(gt, approximate="tanh")) * up
        y = y + h @ sh["w_down"]
    return y, aux
