"""Mamba2 / SSD (state-space duality) block: chunked scan + O(1) decode.

Port of the reference package's ``repro.models.mamba2``.  The forward
pass (train / prefill) runs the SSD scan, on the card through the
hand-written CUDA kernel (``kernels.ssd_scan.ssd_chunked``), which also
gives the final state; in training its gradients come from the
hand-written backward kernels behind the same call on the card, and from
autograd of the plain version on the CPU.  Decode is the exact diagonal
SSM recurrence ``h <- exp(dt·A)·h + dt·(x ⊗ B)``, ``y = C·h + D·x``, in
plain torch ops, as in the reference.  Parameters live in an
``nn.ParameterDict`` under the reference's keys; ``A_log``, ``D`` and
``dt_bias`` stay float32 whatever the model's dtype.  The
head-sharding constraint of the reference (``_shard_dim``) belongs to
the launch slice and is left out.

Cache layout per layer: ``conv_x (B, d_conv-1, d_inner)`` and
``conv_bc (B, d_conv-1, 2·g·ds)`` in the model's dtype, ``ssm (B, nh,
hd, ds)`` float32.  ``mamba2_decode`` updates it in place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.models.layers import _init_w, apply_norm, param

__all__ = ["conv_dim", "init_mamba2", "mamba2_forward", "mamba2_decode"]

Cache = Dict[str, torch.Tensor]


def conv_dim(d_model: int, s: SSMConfig) -> int:
    return s.d_inner(d_model) + 2 * s.n_groups * s.d_state


def init_mamba2(gen: torch.Generator, d_model: int, s: SSMConfig,
                dtype: torch.dtype) -> nn.ParameterDict:
    """The reference's separate projections (z / x / BC / dt) and split
    depthwise conv, drawn from ``gen`` on its device."""
    d_in = s.d_inner(d_model)
    nh = s.n_heads(d_model)
    gs2 = 2 * s.n_groups * s.d_state
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return nn.ParameterDict({
        "in_z": _init_w(gen, (d_model, d_in), dtype),
        "in_x": _init_w(gen, (d_model, d_in), dtype),
        "in_bc": _init_w(gen, (d_model, gs2), dtype),
        "in_dt": _init_w(gen, (d_model, nh), dtype),
        "conv_wx": _init_w(gen, (s.d_conv, d_in), dtype),
        "conv_bx": param(torch.zeros(d_in, dtype=dtype, device=dev)),
        "conv_wbc": _init_w(gen, (s.d_conv, gs2), dtype),
        "conv_bbc": param(torch.zeros(gs2, dtype=dtype, device=dev)),
        "A_log": param(torch.log(torch.linspace(1.0, 16.0, nh, **f32))),
        "D": param(torch.ones(nh, **f32)),
        "dt_bias": param(torch.log(torch.expm1(
            torch.linspace(1e-3, 1e-1, nh, **f32)))),
        "norm": param(torch.ones(d_in, dtype=dtype, device=dev)),
        "out_proj": _init_w(gen, (d_in, d_model), dtype),
    })


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. xbc: (B,S,C), w: (K,C).  The
    taps accumulate in order in float32, then bias, silu and the cast
    to xbc's dtype, as in the reference."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(k):
        out = out + pad[:, i:i + s].float() * w[i].float()
    return F.silu(out + b.float()).to(xbc.dtype)


def _gated_out(p, x: torch.Tensor, y: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """y (float32, D term included) cast to x's dtype, gated by
    silu(z), RMS-normalised over d_inner and projected out."""
    y = apply_norm({"scale": p["norm"]},
                   y.to(x.dtype) * F.silu(z.float()).to(x.dtype), "rmsnorm")
    return y @ p["out_proj"]


def mamba2_forward(p, d_model: int, s: SSMConfig, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence SSD. x: (B,S,d). Returns (y, cache_at_end)."""
    b, S, _ = x.shape
    d_in = s.d_inner(d_model)
    nh = s.n_heads(d_model)
    gs = s.n_groups * s.d_state
    z = x @ p["in_z"]
    xi = x @ p["in_x"]
    bc = x @ p["in_bc"]
    dt_raw = x @ p["in_dt"]
    xc = _causal_conv(xi, p["conv_wx"], p["conv_bx"])
    bcc = _causal_conv(bc, p["conv_wbc"], p["conv_bbc"])
    xs = xc.reshape(b, S, nh, s.head_dim)
    # B and C stay strided views of bcc: the kernel takes their strides
    B = bcc[..., :gs].reshape(b, S, s.n_groups, s.d_state)
    C = bcc[..., gs:].reshape(b, S, s.n_groups, s.d_state)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, h_end = ssd_chunked(xs, dt, A, B, C, s.chunk_size)
    y = y + xs.float() * p["D"][:, None]
    out = _gated_out(p, x, y.reshape(b, S, d_in), z)
    tail = x[:, -(s.d_conv - 1):]
    cache = {"conv_x": tail @ p["in_x"], "conv_bc": tail @ p["in_bc"],
             "ssm": h_end}
    return out, cache


def _window_conv(cache: torch.Tensor, new: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """The decode conv over the window ``cache ++ new`` in float32, and
    the window moved on by one step in place.  The reference sums the
    four products with ``jnp.sum``; torch's sum may order them
    otherwise (within float32 rounding)."""
    win = torch.cat([cache, new[:, None, :]], dim=1)
    o = (win.float() * w.float()[None]).sum(dim=1)
    cache.copy_(win[:, 1:])
    return F.silu(o + bias.float())


def mamba2_decode(p, d_model: int, s: SSMConfig, x: torch.Tensor,
                  cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """Single-token recurrent step. x: (B,1,d).  The conv windows and
    the state in ``cache`` are updated in place; returns (y, cache)."""
    b = x.shape[0]
    d_in = s.d_inner(d_model)
    nh = s.n_heads(d_model)
    gs = s.n_groups * s.d_state
    rep = nh // s.n_groups
    x1 = x[:, 0]
    z = x1 @ p["in_z"]
    xbc = _window_conv(cache["conv_x"], x1 @ p["in_x"], p["conv_wx"],
                       p["conv_bx"])
    bcc = _window_conv(cache["conv_bc"], x1 @ p["in_bc"], p["conv_wbc"],
                       p["conv_bbc"])
    xs = xbc.reshape(b, nh, s.head_dim)
    Bh = bcc[:, :gs].reshape(b, s.n_groups, s.d_state).repeat_interleave(
        rep, dim=1)                                   # (b,nh,ds)
    Ch = bcc[:, gs:].reshape(b, s.n_groups, s.d_state).repeat_interleave(
        rep, dim=1)
    dt = F.softplus((x1 @ p["in_dt"]).float() + p["dt_bias"])   # (b,nh)
    A = -torch.exp(p["A_log"])
    h = cache["ssm"]
    h.mul_(torch.exp(dt * A)[:, :, None, None])
    h.addcmul_((dt[:, :, None] * xs)[:, :, :, None], Bh[:, :, None, :])
    y = torch.einsum("bhds,bhs->bhd", h, Ch) + xs * p["D"][:, None]
    out = _gated_out(p, x, y.reshape(b, 1, d_in), z[:, None])
    return out, cache
