"""Carry the reference package's inputs, state and weights into the port.

The sweeps have no weights: their parameters are the grids' arrays and
their state is the histogram and batch-means accumulators.  The models'
parameters are the reference's pytree of arrays.  All of them cross as
numpy arrays, so this module needs nothing of the reference package.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.grid import GenGrid, SweepGrid
from repro_torch.models.layers import param
from repro_torch.models.transformer import (Encoder, Transformer,
                                            require_supported,
                                            split_pattern)

__all__ = ["BASE_FIELDS", "GEN_BASE_FIELDS", "grid_from_arrays",
           "gen_grid_from_arrays", "hist_state_from_arrays",
           "model_params_from_jax"]

# the reference SweepGrid's base fields; its loss and failure fields
# are optional and default to their neutral values
BASE_FIELDS = ("lam", "alpha", "tau0", "b_max", "dist", "cv", "wait_max",
               "wait_target")


def grid_from_arrays(d: Dict[str, np.ndarray]) -> SweepGrid:
    """A port ``SweepGrid`` from the reference grid's field arrays (e.g.
    ``{f: getattr(ref_grid, f) for f in ref_grid.__dataclass_fields__}``).
    The eight base fields are required; loss and failure fields that are
    missing take their neutral values, and an unknown field raises."""
    missing = [f for f in BASE_FIELDS if f not in d]
    if missing:
        raise KeyError(f"grid fields {missing} are required")
    kw = {k: np.asarray(v) for k, v in d.items()}
    return SweepGrid.from_points(kw.pop("lam"), kw.pop("alpha"),
                                 kw.pop("tau0"), **kw)


# the reference GenGrid's token-level fields; its loss and failure
# fields are optional as for SweepGrid
GEN_BASE_FIELDS = ("lam", "alpha_decode", "tau0_decode", "alpha_prefill",
                   "tau0_prefill", "prompt_len", "gen_tokens",
                   "max_active", "discipline")


def gen_grid_from_arrays(d: Dict[str, np.ndarray]) -> GenGrid:
    """A port ``GenGrid`` from the reference ``GenGrid``'s field arrays
    (e.g. ``{f: getattr(g, f) for f in g.__dataclass_fields__}``), with
    the same arrays bit for bit.  The nine token-level fields are
    required; loss and failure fields that are missing take their
    neutral values, and an unknown field raises."""
    missing = [f for f in GEN_BASE_FIELDS if f not in d]
    if missing:
        raise KeyError(f"gen grid fields {missing} are required")
    kw = {k: np.asarray(v) for k, v in d.items()}
    rates = [kw.pop(f) for f in GEN_BASE_FIELDS[:5]]
    return GenGrid.from_points(*rates, **kw)


def hist_state_from_arrays(counts: np.ndarray,
                           sums: Optional[np.ndarray] = None,
                           device="cuda") -> Tuple[torch.Tensor, ...]:
    """The port's ``hist_update`` accumulators from a reference histogram
    state: ``(counts,)`` or ``(counts, sums)`` as contiguous ``(P,
    n_bins)`` int32 / float32 tensors on ``device``."""
    c = np.atleast_2d(np.asarray(counts))
    if not np.issubdtype(c.dtype, np.integer):
        raise TypeError(f"counts must be integers, got {c.dtype}")
    out = (torch.as_tensor(c.astype(np.int32), device=device)
           .contiguous(),)
    if sums is not None:
        s = np.atleast_2d(np.asarray(sums, dtype=np.float32))
        if s.shape != c.shape:
            raise ValueError(f"sums {s.shape} and counts {c.shape} differ")
        out = out + (torch.as_tensor(s, device=device).contiguous(),)
    return out


def _tensor(a, device) -> torch.Tensor:
    """A tensor of ``a``'s values and dtype (bfloat16 numpy arrays, which
    torch cannot read directly, go through float32 exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _params(tree: Dict, device, index=None) -> nn.ParameterDict:
    """A ``ParameterDict`` of ``tree``'s leaves (entry ``index`` of each
    when given), nesting a ``ParameterDict`` for each sub-dict (a MoE
    layer's ``shared`` experts)."""
    return nn.ParameterDict({
        k: (_params(v, device, index) if isinstance(v, dict) else
            param(_tensor(v if index is None else np.asarray(v)[index],
                          device)))
        for k, v in tree.items()})


def model_params_from_jax(cfg: ModelConfig, params: Dict,
                          device="cuda") -> Transformer:
    """The port's ``Transformer`` from the reference ``init_params``
    pytree as numpy arrays (``jax.tree.map(np.asarray, params)``), the
    same values in the same dtypes, on ``device``.  Repeat ``i`` of the
    stacked ``params["stack"][j]`` leaves is layer ``lead + i·p + j``,
    with the ``(d, h, hd)`` and ``(h, hd, d)`` projection layouts kept;
    a MoE ``ffn`` keeps its float32 ``router``, its ``(E, d, f)`` /
    ``(E, f, d)`` expert stacks and its nested ``shared`` dict, q/k
    norms their ``(hd,)`` scales, an MLA ``attn`` its ``wq``, ``w_dkv``,
    ``w_kpe``, ``norm_ckv``, ``w_uk``, ``w_uv`` and ``wo``, a hybrid's
    period (Jamba: 8 layers) its ``attn`` / ``ssm`` blocks, and an
    enc-dec decoder block its ``norm_x`` / ``xattn``.  Learned positions
    carry ``pos_embed``; an enc-dec model's ``encoder`` carries ``pos``,
    ``norm`` and its stacked ``stack`` (encoder layer ``i`` is index
    ``i`` on the leading axis)."""
    require_supported(cfg)
    lead, p, r = split_pattern(cfg)
    layers = [nn.ModuleDict({name: _params(sub, device)
                             for name, sub in blk.items()})
              for blk in params["lead"]]
    layers += [None] * (cfg.num_layers - lead)
    for j, stack in enumerate(params["stack"]):
        for i in range(r):
            layers[lead + i * p + j] = nn.ModuleDict(
                {name: _params(sub, device, i)
                 for name, sub in stack.items()})
    unembed, pos_embed = (
        param(_tensor(params[k], device)) if k in params else None
        for k in ("unembed", "pos_embed"))
    encoder = None
    if "encoder" in params:
        enc = params["encoder"]
        depth = cfg.encoder.num_layers
        encoder = Encoder(
            param(_tensor(enc["pos"], device)),
            [nn.ModuleDict({name: _params(sub, device, i)
                            for name, sub in enc["stack"].items()})
             for i in range(depth)],
            _params(enc["norm"], device))
    return Transformer(param(_tensor(params["embed"], device)),
                       _params(params["norm_f"], device), layers, unembed,
                       pos_embed, encoder)
