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
``dt_bias`` stay float32 whatever the model's dtype.  On a device
mesh the reference's head hint (§Perf M2, ``_shard_dim``, under
``REPRO_SHARD_HEADS_AXIS``, read at each call) pins the scan's head
axis — of x and dt, the kernel's inputs, where the reference pins its
chunk states — to that mesh axis when the head count is a multiple of
16; on plain tensors it does nothing.

Cache layout per layer: ``conv_x (B, d_conv-1, d_inner)`` and
``conv_bc (B, d_conv-1, 2·g·ds)`` in the model's dtype, ``ssm (B, nh,
hd, ds)`` float32.  ``mamba2_decode`` updates it in place.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels._mesh import is_dtensor, local_call
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.models.layers import (_init_w, apply_norm, batch_rows,
                                       param, shard_hint)

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


def _shard_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The reference's §Perf M2 hint: a head dimension over
    ``REPRO_SHARD_HEADS_AXIS`` when it is a multiple of 16."""
    if t.shape[dim] % 16:
        return t
    return shard_hint(t, dim, os.environ.get("REPRO_SHARD_HEADS_AXIS"))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. xbc: (B,S,C), w: (K,C).  The
    taps accumulate in order in float32, then bias, silu and the cast
    to xbc's dtype, as in the reference.  On a mesh each rank convolves
    its own rows and channels (``local_map``; the time axis whole)."""
    if is_dtensor(xbc):
        return _causal_conv_mesh(xbc, w, b)
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    # (new_zeros: on a mesh the accumulator is laid out as xbc is)
    out = xbc.new_zeros(xbc.shape, dtype=torch.float32)
    for i in range(k):
        out = out + pad[:, i:i + s].float() * w[i].float()
    return F.silu(out + b.float()).to(xbc.dtype)


def _causal_conv_mesh(xbc, w, b):
    lay = [p if p in (Shard(0), Shard(2)) else Replicate()
           for p in xbc.placements]
    wl = [Shard(1) if p == Shard(2) else Replicate() for p in lay]
    bl = [Shard(0) if p == Shard(2) else Replicate() for p in lay]
    # the weights' gradients on a rank cover only its own rows
    wg = [Partial() if p == Shard(0) else q for p, q in zip(lay, wl)]
    bg = [Partial() if p == Shard(0) else q for p, q in zip(lay, bl)]
    return local_call(_causal_conv, xbc.device_mesh, (lay, wl, bl), lay,
                      xbc, w, b, out_shapes=xbc.shape,
                      in_grad_placements=(lay, wg, bg))


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
    x = batch_rows(x)           # on a mesh: one gather for the projections
    z = x @ p["in_z"]
    xi = x @ p["in_x"]
    bc = x @ p["in_bc"]
    dt_raw = x @ p["in_dt"]
    xc = _causal_conv(xi, p["conv_wx"], p["conv_bx"])
    bcc = _causal_conv(bc, p["conv_wbc"], p["conv_bbc"])
    xs = _shard_dim(xc.reshape(b, S, nh, s.head_dim), 2)
    # B and C stay strided views of bcc: the kernel takes their strides
    B = bcc[..., :gs].reshape(b, S, s.n_groups, s.d_state)
    C = bcc[..., gs:].reshape(b, S, s.n_groups, s.d_state)
    dt = _shard_dim(F.softplus(dt_raw.float() + p["dt_bias"]), 2)
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
    args = (cache["ssm"], dt, A, xs, Bh, Ch, p["D"])
    y = (_ssm_step_mesh(*args) if is_dtensor(cache["ssm"])
         else _ssm_step(*args))
    out = _gated_out(p, x, y.reshape(b, 1, d_in), z[:, None])
    return out, cache


def _ssm_step(h, dt, A, xs, Bh, Ch, D):
    """The recurrence's step on the state ``h (B, nh, hd, ds)``, in place;
    returns y ``(B, nh, hd)`` with the D term."""
    h.mul_(torch.exp(dt * A)[:, :, None, None])
    h.addcmul_((dt[:, :, None] * xs)[:, :, :, None], Bh[:, :, None, :])
    return torch.einsum("bhds,bhs->bhd", h, Ch) + xs * D[:, None]


def _ssm_step_mesh(h, dt, A, xs, Bh, Ch, D):
    """``_ssm_step`` on each rank's own rows and heads of the state
    (``local_map``), laid out as the state is (``launch.sharding``: the
    batch over the data axes, the heads over "model")."""
    lay = [p if p in (Shard(0), Shard(1)) else Replicate()
           for p in h.placements]
    heads = [Shard(0) if p == Shard(1) else Replicate() for p in lay]
    return local_call(_ssm_step, h.device_mesh,
                      (lay, lay, heads, lay, lay, lay, heads), lay, h, dt,
                      A, xs, Bh, Ch, D, out_shapes=xs.shape)
