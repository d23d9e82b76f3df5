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

On a device mesh (DTensors) the groups stay the reference's: each rank
holds whole rows of its batch shard where the shard is a whole number of
groups, and every token otherwise (``_whole_groups``), so the capacity
drops the same tokens.  The grouping, the dispatch, the combine and the
ungrouping run on each rank's own groups under ``local_map`` (the card's
DTensor has no sharding rule for the index moves); the router and the
routing run as DTensor propagates them, and the experts' products over
their weights' own layout, sharded over "model" by
``launch.sharding``.  The combine then gathers every expert's rows of
the rank's groups; an expert-parallel dispatch that moves only the
routed rows is ROADMAP A11g.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels._mesh import is_dtensor, local_call, ranks
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


def _whole_groups(x: torch.Tensor, tg: int) -> Optional[List[Any]]:
    """On a DTensor ``x (B, S, d)``, the placements under which each rank
    holds whole groups of ``tg`` consecutive tokens of the flattened
    ``(B, S)``, the reference's groups, whose token sets decide what the
    capacity drops: whole rows of its batch shard (the sequence and
    ``d`` gathered, a ``Partial`` reduced) where each batch shard holds a
    whole number of groups and none is padded, else every token on
    every rank (a mesh dimension of one rank replicates, which is the
    same).  None for a plain tensor."""
    if not is_dtensor(x):
        return None
    mesh = x.device_mesh
    b, s, _ = x.shape
    dims = [i for i, p in enumerate(x.placements)
            if p == Shard(0) and mesh.size(i) > 1]
    shards = ranks(mesh, dims)
    keep = b % shards == 0 and (b // shards) * s % tg == 0
    return [Shard(0) if i in dims and keep else Replicate()
            for i in range(mesh.ndim)]


def _group(x: torch.Tensor, tg: int) -> torch.Tensor:
    """``x (B, S, d)`` as ``(G, tg, d)`` groups of consecutive tokens, the
    last one padded with zero rows."""
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    pad = (-xf.shape[0]) % tg
    if pad:
        xf = torch.cat([xf, xf.new_zeros(pad, d)], dim=0)
    return xf.reshape(-1, tg, d)


def _ungroup(y: torch.Tensor, rows: int, s: int) -> torch.Tensor:
    """``_group``'s inverse: ``(G, tg, d)`` back to ``(rows, s, d)``, the
    padding cut."""
    d = y.shape[-1]
    return y.reshape(-1, d)[:rows * s].reshape(rows, s, d)


def _dispatch(xg: torch.Tensor, expert: torch.Tensor, slot: torch.Tensor,
              e: int, cap: int) -> torch.Tensor:
    """Each (token, slot) row of ``xg (G, T, d)`` copied into its expert
    slot of ``(G, E, cap + 1, d)`` (a dropped one into the spare slot
    ``cap``, which is cut off)."""
    g, tg, d = xg.shape
    k = expert.shape[-1]
    gi = torch.arange(g, device=xg.device)[:, None, None].expand_as(slot)
    xin = xg.new_zeros(g, e, cap + 1, d)
    xin[gi, expert, slot] = xg[:, :, None, :].expand(g, tg, k, d)
    return xin


def _combine(xout: torch.Tensor, expert: torch.Tensor, slot: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """Σ_k w_k · xout[expert_k, slot_k], k in order, in float32: ``(G, T,
    d)`` (a dropped slot reads any row, at weight 0)."""
    g, tg, k = expert.shape
    gi = torch.arange(g, device=xout.device)[:, None, None].expand_as(slot)
    yg = xout.new_zeros(g, tg, xout.shape[-1], dtype=torch.float32)
    for i in range(k):
        row = xout[gi[..., i], expert[..., i], slot[..., i]]    # (G,T,d)
        yg = yg + row.float() * w[..., i, None]
    return yg


def apply_moe(p, moe: MoEConfig, x: torch.Tensor, activation: str,
              group_size: int = DEFAULT_GROUP
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (out (B,S,d), aux_loss ())."""
    b, s, d = x.shape
    t_total = b * s
    tg = min(group_size, t_total)
    g = -(-t_total // tg)
    e, k = moe.num_experts, moe.top_k
    cap = _capacity(tg, moe)
    lay = _whole_groups(x, tg)
    if lay is not None and list(x.placements) != lay:
        x = x.redistribute(x.device_mesh, lay)
    rows = b if lay is None else x.to_local().shape[0]

    def per_group(fn, shape, *args):
        """``fn(*args)``; on a mesh, on each rank's whole groups
        (``local_map``): the index moves have no DTensor sharding rule on
        the card's torch, and the groups' gradients come back in the
        same layout."""
        if lay is None:
            return fn(*args)
        return local_call(fn, x.device_mesh, (lay,) * len(args), lay, *args,
                          out_shapes=shape)

    xg = per_group(lambda t: _group(t, tg), (g, tg, d), x)
    logits = xg.float() @ p["router"]
    expert, pos, keep, weight, aux = _route(logits, moe, cap)
    slot = torch.where(keep, pos, cap)
    xin = per_group(lambda a, ex, sl: _dispatch(a, ex, sl, e, cap),
                    (g, e, cap + 1, d), xg, expert, slot)
    # the experts' products over their weights' own layout ("model")
    xout = _expert_mlp(p, xin[:, :, :cap], activation)
    w = weight.to(x.dtype).float()
    yg = per_group(_combine, (g, tg, d), xout, expert,
                   slot.clamp(max=cap - 1), w)
    y = per_group(lambda t: _ungroup(t, rows, s), (b, s, d),
                  yg.to(x.dtype))

    if "shared" in p:
        sh = p["shared"]
        gt = x @ sh["w_gate"]
        up = x @ sh["w_up"]
        h = (F.silu(gt) if activation == "swiglu"
             else F.gelu(gt, approximate="tanh")) * up
        y = y + h @ sh["w_down"]
    return y, aux
