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
from torch.distributed.tensor import (Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.kernels._mesh import is_dtensor, local_call, seq_offset

__all__ = ["_dtype", "_init_w", "init_norm", "apply_norm", "init_mlp",
           "apply_mlp", "init_embedding", "embed", "unembed", "param",
           "matmul", "shard_hint", "batch_rows"]


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def param(t: torch.Tensor) -> nn.Parameter:
    """A weight, built frozen (``requires_grad`` off)."""
    return nn.Parameter(t, requires_grad=False)


def _gen_kw(gen: torch.Generator) -> dict:
    """The draw's keywords; on the ``meta`` device (``transformer.
    abstract_params``) there is no generator and nothing is drawn."""
    if gen.device.type == "meta":
        return dict(device=gen.device, dtype=torch.float32)
    return dict(generator=gen, device=gen.device, dtype=torch.float32)


def shard_hint(x: torch.Tensor, dim: int,
               axis: Optional[str]) -> torch.Tensor:
    """The reference's layout hints (``with_sharding_constraint`` of
    ``P(UNCONSTRAINED…, axis at dim, UNCONSTRAINED…)``) on a DTensor:
    ``x`` redistributed so that mesh axis ``axis`` shards dimension
    ``dim``, every other mesh dimension keeping its placement.  A plain
    tensor, an unset ``axis`` or a mesh without it: ``x`` as it is."""
    if not axis or not is_dtensor(x) or axis not in (
            x.device_mesh.mesh_dim_names or ()):
        return x
    i = x.device_mesh.mesh_dim_names.index(axis)
    want = list(x.placements)
    want[i] = Shard(dim)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def batch_rows(x: torch.Tensor) -> torch.Tensor:
    """A DTensor sharded on its batch alone (every other placement
    replicated: a sequence-sharded residual gathered, a ``Partial``
    reduced); a plain tensor as it is.  The unembedding takes its
    activations so, and its vocabulary-sharded weight then gives
    vocabulary-sharded logits with no all-to-all."""
    if not is_dtensor(x):
        return x
    want = [p if p == Shard(0) else Replicate() for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(gen: torch.Generator, d: int, kind: str,
              dtype: torch.dtype) -> nn.ParameterDict:
    p = {"scale": param(torch.ones(d, dtype=dtype, device=gen.device))}
    if kind == "layernorm":
        p["bias"] = param(torch.zeros(d, dtype=dtype, device=gen.device))
    return nn.ParameterDict(p)


def _split_rows(x: torch.Tensor) -> list:
    """On a DTensor, the placements of a per-row statistic of ``x`` when a
    mesh dimension of more than one rank splits ``x``'s last dimension
    (that dimension replicated); otherwise None."""
    if not is_dtensor(x):
        return None
    last = Shard(x.dim() - 1)
    mesh = x.device_mesh
    if not any(p == last and mesh.size(i) > 1
               for i, p in enumerate(x.placements)):
        return None
    return [Replicate() if p == last or p.is_partial() else p
            for p in x.placements]


def _row_sum(t: torch.Tensor, rows: list) -> torch.Tensor:
    """``t.sum(-1, keepdim=True)`` all-reduced to every shard of the row:
    DTensor would otherwise often reduce-scatter the statistic onto
    another dimension and gather the whole activation to apply it."""
    return t.sum(dim=-1, keepdim=True).redistribute(t.device_mesh, rows)


def apply_norm(p, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """Normalise in float32, cast to x's dtype, then scale (the
    reference's order)."""
    xf = x.float()
    rows = _split_rows(xf)
    if rows is not None:
        # a mesh splits the normalised axis: sums, all-reduced, over d
        d = xf.shape[-1]
        if kind == "rmsnorm":
            y = xf * torch.rsqrt(_row_sum(xf.square(), rows) / d + eps)
        else:
            mean = _row_sum(xf, rows) / d
            var = _row_sum((xf - mean).square(), rows) / d
            y = (xf - mean) * torch.rsqrt(var + eps)
    elif kind == "rmsnorm":
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
    x = batch_rows(x)           # on a mesh: one gather for both products
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
    """``table[tokens]``.  On a DTensor table, a gather on each rank's
    own rows (``local_map``); where the vocabulary is sharded (a tied
    table, ``launch.sharding``), the vocab-parallel lookup: each rank
    gathers the tokens its rows hold and zeros elsewhere, and the result
    is a sum across the vocabulary shards (DTensor ``Partial``), never
    an all-gather of the table."""
    if is_dtensor(table):
        return _embed_mesh(table, tokens)
    return table[tokens]


def _embed_mesh(table, tokens):
    mesh = table.device_mesh
    if not is_dtensor(tokens):
        tokens = distribute_tensor(tokens, mesh, [Replicate()] * mesh.ndim)
    vocab = [i for i, p in enumerate(table.placements)
             if p == Shard(0) and mesh.size(i) > 1]
    rows = [p if p in (Shard(0), Shard(1)) and i not in vocab
            else Replicate() for i, p in enumerate(tokens.placements)]
    lay = [Shard(0) if i in vocab else (p if p == Shard(1) else Replicate())
           for i, p in enumerate(table.placements)]
    out = [Partial() if i in vocab else (Shard(2) if lay[i] == Shard(1)
                                        else rows[i])
           for i in range(mesh.ndim)]
    v_all = table.shape[0]

    def local(t, ids):
        if not vocab:
            return t[ids]
        idx = ids.long() - seq_offset(mesh, vocab, v_all)
        ok = (idx >= 0) & (idx < t.shape[0])
        e = t[idx.clamp(0, t.shape[0] - 1)]
        return torch.where(ok[..., None], e, torch.zeros((), dtype=e.dtype))

    # the table's gradient on a rank covers only the rows of its tokens:
    # a sum across the shards of the batch (or sequence)
    grad = [Partial() if rows[i] != Replicate() else lay[i]
            for i in range(mesh.ndim)]
    return local_call(local, mesh, (lay, rows), out, table, tokens,
                      out_shapes=tuple(tokens.shape) + (table.shape[1],),
                      in_grad_placements=(grad, rows))


def unembed(table_or_w: torch.Tensor, x: torch.Tensor,
            tied: bool) -> torch.Tensor:
    """Logits: ``x @ table.T`` for a tied ``(V, d)`` table, else
    ``x @ w`` for a ``(d, V)`` matrix."""
    if tied:
        return x @ table_or_w.T
    return x @ table_or_w
