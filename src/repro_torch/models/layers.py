"""Basic neural layers of the port: norms, MLPs, embeddings.

Port of the reference package's ``repro.models.layers``.  Parameters
live in ``nn.ParameterDict``s keyed as the reference's pytrees are, so
every ``apply_*`` reads ``p["w_gate"]`` where the reference reads the
same key; every ``init_*`` draws from an explicit ``torch.Generator``
on the device the parameters are made on.  The weights are built with
``requires_grad`` off, so serving runs no autograd; a trainer turns
gradients on for its own model (``model.requires_grad_(True)``, as
``repro_torch.train`` does).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["_dtype", "_init_w", "init_norm", "apply_norm", "init_mlp",
           "apply_mlp", "init_embedding", "embed", "unembed", "param",
           "matmul"]


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def param(t: torch.Tensor) -> nn.Parameter:
    """A weight, built frozen (``requires_grad`` off)."""
    return nn.Parameter(t, requires_grad=False)


def _gen_kw(gen: torch.Generator) -> dict:
    return dict(generator=gen, device=gen.device, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(gen: torch.Generator, d: int, kind: str,
              dtype: torch.dtype) -> nn.ParameterDict:
    p = {"scale": param(torch.ones(d, dtype=dtype, device=gen.device))}
    if kind == "layernorm":
        p["bias"] = param(torch.zeros(d, dtype=dtype, device=gen.device))
    return nn.ParameterDict(p)


def apply_norm(p, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """Normalise in float32, cast to x's dtype, then scale (the
    reference's order)."""
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    else:
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.to(x.dtype) * p["scale"].to(x.dtype)
    if kind == "layernorm":
        y = y + p["bias"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# Dense / MLP
# ---------------------------------------------------------------------------

def _init_w(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
            scale: Optional[float] = None) -> nn.Parameter:
    fan_in = shape[0]
    scale = scale if scale is not None else fan_in ** -0.5
    return param((torch.randn(*shape, **_gen_kw(gen)) * scale).to(dtype))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the two operands' promoted dtype: the reference's
    einsum takes a bf16 weight against float32 activations (whisper's
    encoder over the engine's float32 frames) as float32, where torch's
    product takes one dtype."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    return x @ w


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype: torch.dtype) -> nn.ParameterDict:
    if activation == "swiglu":
        return nn.ParameterDict({
            "w_gate": _init_w(gen, (d_model, d_ff), dtype),
            "w_up": _init_w(gen, (d_model, d_ff), dtype),
            "w_down": _init_w(gen, (d_ff, d_model), dtype),
        })
    dev = gen.device
    return nn.ParameterDict({
        "w_up": _init_w(gen, (d_model, d_ff), dtype),
        "b_up": param(torch.zeros(d_ff, dtype=dtype, device=dev)),
        "w_down": _init_w(gen, (d_ff, d_model), dtype),
        "b_down": param(torch.zeros(d_model, dtype=dtype, device=dev)),
    })


def apply_mlp(p, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        g = matmul(x, p["w_gate"])
        u = matmul(x, p["w_up"])
        return matmul(F.silu(g) * u, p["w_down"])
    h = F.gelu(matmul(x, p["w_up"]) + p["b_up"], approximate="tanh")
    return matmul(h, p["w_down"]) + p["b_down"]


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype: torch.dtype) -> nn.Parameter:
    return param((torch.randn(vocab, d_model, **_gen_kw(gen))
                  * 0.02).to(dtype))


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(table_or_w: torch.Tensor, x: torch.Tensor,
            tied: bool) -> torch.Tensor:
    """Logits: ``x @ table.T`` for a tied ``(V, d)`` table, else
    ``x @ w`` for a ``(d, V)`` matrix."""
    if tied:
        return x @ table_or_w.T
    return x @ table_or_w
