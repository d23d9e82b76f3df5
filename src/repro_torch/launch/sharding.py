"""Partition specs for params, inputs and caches, and their DTensor
placements.

Port of the reference package's ``repro.launch.sharding``, with its
policy (single-pod mesh ("data", "model"); multi-pod prepends "pod",
which extends the batch — or, for long_500k, the cache-sequence — axis):

- tensor-parallel over "model": attention heads (falling back to head_dim
  when the head count doesn't divide the axis — qwen4b's 20 heads,
  internvl2's 14, phi4's 24/kv8), FFN hidden, MoE experts (expert
  parallelism), Mamba inner channels, vocab (falling back to d_model for
  non-divisible vocabs: whisper, internvl2, mamba2),
- data-parallel over "data" (+"pod"): the request/batch dimension; for
  long_500k (batch=1) the KV-cache *sequence* dimension instead
  (flash-decode style partial-softmax sharding; the decode kernels merge
  the ranks' partials).

Every rule is guarded by divisibility — a dimension that doesn't divide
its mesh axis is replicated rather than padded.

What differs from the reference:

- a spec is the port's own ``PartitionSpec``, a tuple with one entry a
  tensor dimension: ``None`` (replicated), an axis name, or a tuple of
  axis names, major first;
- the rules take the mesh's *shape*, a mapping from axis name to size
  (``{"data": 16, "model": 16}``), or a ``DeviceMesh``, read through
  ``mesh_shape``; nothing needs a process group;
- ``param_specs`` maps the port's ``named_parameters()`` (one module a
  layer) where the reference maps its stacked tree: reference repeat
  ``i`` of ``stack[j]`` is port layer ``lead + i·p + j``, and a port
  layer's spec is the reference's at its stacked path with the leading
  stack ``None`` dropped; the cache specs likewise, layer by layer;
- ``zero1_opt_specs`` works on each layer's own shape, so it cannot pick
  the reference's stack axis: where the reference shards the repeats of
  a stacked moment over "data" (mamba2-2.7b's 64 layers), the port
  shards the next dimension the rule admits;
- ``to_placements`` turns a spec into a DTensor placement list, one entry
  a mesh dimension (the counterpart of ``to_named``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.transformer import layer_specs

__all__ = ["MODEL_AXIS", "PartitionSpec", "P", "mesh_shape", "param_specs",
           "batch_axes", "input_spec_tree", "cache_specs", "zero1_opt_specs",
           "to_placements"]

MODEL_AXIS = "model"


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None``, an axis name, or a tuple
    of axis names (the first the major one)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, from a mapping or a ``DeviceMesh``."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axis, (tuple, list)):
        return int(np.prod([shape[a] for a in axis]))
    return shape[axis]


def _guard(spec: Tuple, shape: Tuple[int, ...], mesh) -> P:
    """Replicate any dimension whose size doesn't divide its mesh axis."""
    fixed = []
    for dim, axis in zip(shape, spec):
        if isinstance(axis, (tuple, list)) and len(axis) == 1:
            # ('data',) and 'data' shard identically: keep the scalar form
            axis = axis[0]
        fixed.append(axis if axis is not None
                     and dim % _axis_size(mesh, axis) == 0 else None)
    return P(*fixed)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _block_param_spec(name: str, shape: Tuple[int, ...], kind: str,
                      moe_flag: bool, in_shared: bool, stacked: int,
                      mesh) -> P:
    """Spec for one block-level parameter (canonical, unstacked shape is
    shape[stacked:]). Returns the full spec including stack dims; the
    port's layers are unstacked (``stacked=0``)."""
    M = MODEL_AXIS
    m = mesh_shape(mesh)[M]
    cshape = shape[stacked:]
    nd = len(cshape)

    def out(*axes):
        return _guard((None,) * stacked + tuple(axes),
                      (0,) * stacked + cshape, mesh)

    # the reference's §Perf T1: heads when they divide, else head_dim —
    # never replicated
    if name in ("wq", "wk", "wv"):           # (d, H, hd)
        if cshape[1] % m == 0:
            return out(None, M, None)
        return out(None, None, M)
    if name == "wo":                          # (H, hd, d)
        if cshape[0] % m == 0:
            return out(M, None, None)
        return out(None, M, None)
    if name in ("bq", "bk", "bv"):            # (H, hd)
        if cshape[0] % m == 0:
            return out(M, None)
        return out(None, M)
    if name in ("w_uk", "w_uv"):              # (rank, H, hd) — MLA
        return out(None, M, None)
    if name in ("w_dkv", "w_kpe", "router"):
        return out(None, None)
    if name in ("w_gate", "w_up"):
        if not in_shared and moe_flag and nd == 3:   # (E, d, f) routed
            return out(M, None, None)
        return out(None, M)                   # (d, f) dense / shared
    if name == "w_down":
        if not in_shared and moe_flag and nd == 3:   # (E, f, d)
            return out(M, None, None)
        return out(M, None)                   # (f, d)
    if name == "b_up":
        return out(M)
    if name == "b_down":
        return out(None)
    # the reference's §Perf M1: split Mamba projections
    if name in ("in_z", "in_x", "in_bc", "in_dt"):    # (d, ·)
        return out(None, M)
    if name == "out_proj":                    # (d_in, d)
        return out(M, None)
    if name in ("conv_wx", "conv_wbc"):       # (k, ·)
        return out(None, M)
    if name in ("conv_bx", "conv_bbc"):
        return out(M)
    if name in ("A_log", "D", "dt_bias", "norm"):
        return out(M) if name == "norm" else out(None)
    # norms / scales / everything else: replicated
    return P(*((None,) * len(shape)))


def _named_shapes(params) -> Dict[str, Tuple[int, ...]]:
    """name -> shape, from a module's ``named_parameters()`` or a mapping
    of names to tensors."""
    items = (params.named_parameters() if hasattr(params, "named_parameters")
             else params.items())
    return {n: tuple(t.shape) for n, t in items}


def param_specs(cfg: ModelConfig, params, mesh) -> Dict[str, P]:
    """Spec of each of the port's parameters (a ``Transformer``, e.g.
    ``transformer.abstract_params(cfg)``, or name -> tensor), by name."""
    specs = layer_specs(cfg)
    M = MODEL_AXIS
    m = mesh_shape(mesh)[M]

    def spec_for(path: str, shape: Tuple[int, ...]) -> P:
        keys = path.split(".")
        name = keys[-1]
        if keys[0] == "embed":
            # the reference's §Perf T1c / T4: untied tables shard on
            # d_model, tied ones on a divisible vocab, else replicate
            if not cfg.tie_embeddings:
                return _guard((None, M), shape, mesh)
            if shape[0] % m == 0:
                return P(M, None)
            return P(None, None)
        if keys[0] == "pos_embed":
            return P(None, None)
        if keys[0] == "unembed":
            if shape[1] % m == 0:
                return P(None, M)
            return _guard((M, None), shape, mesh)
        if keys[0] == "norm_f":
            return P(None)
        if keys[0] == "encoder":
            if name == "pos":
                return P(None, None)
            if keys[1] == "layers":
                return _block_param_spec(name, shape, "attn", False,
                                         "shared" in keys, 0, mesh)
            return P(*((None,) * len(shape)))
        if keys[0] == "layers":
            kind, mf = specs[int(keys[1])]
            return _block_param_spec(name, shape, kind, mf,
                                     "shared" in keys, 0, mesh)
        return P(*((None,) * len(shape)))

    return {n: spec_for(n, s) for n, s in _named_shapes(params).items()}


# ---------------------------------------------------------------------------
# input / cache specs
# ---------------------------------------------------------------------------

def batch_axes(mesh) -> Tuple:
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def input_spec_tree(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    inputs: Dict[str, Any]) -> Dict[str, Any]:
    """Specs for the abstract inputs from ``models.registry.input_specs``
    (or real inputs of the same layout)."""
    B = batch_axes(mesh)
    long_ctx = shape.kind == "decode" and shape.global_batch < \
        _axis_size(mesh, B)

    out: Dict[str, Any] = {}
    for k, v in inputs.items():
        if k in ("tokens", "labels"):
            out[k] = _guard((B if not long_ctx else None, None),
                            tuple(v.shape), mesh)
        elif k in ("patch_embeds", "frames"):
            out[k] = _guard((B, None, None), tuple(v.shape), mesh)
        elif k == "lengths":
            out[k] = _guard((B if not long_ctx else None,), tuple(v.shape),
                            mesh)
        elif k == "cache":
            out[k] = cache_specs(cfg, v, mesh, seq_axes=B if long_ctx
                                 else None)
        else:
            out[k] = P(*((None,) * v.dim()))
    return out


def cache_specs(cfg: ModelConfig, cache: List[Dict[str, Any]], mesh, *,
                seq_axes: Optional[Tuple] = None) -> List[Dict[str, P]]:
    """Decode-cache layout, one dict a layer (the reference's §Perf D1):

    - batch over the data axes; the cache *sequence* over "model"
      (flash-decode context parallelism: per-shard partial softmax, the
      ranks merge the partials). This keeps the KV cache fully sharded
      even when kv-head counts don't divide the model axis.
    - long-context (batch < data axis): sequence over (data, model) both.
    - SSM states have no sequence dim: heads over model.
    """
    del cfg
    M = MODEL_AXIS
    if seq_axes:                       # long_500k: batch can't fill 'data'
        bspec = None
        sspec = tuple(seq_axes) + (M,)
    else:
        bspec = batch_axes(mesh)
        sspec = M

    def spec_for(name: str, shape: Tuple[int, ...]) -> P:
        if name in ("k", "v", "k_scale", "v_scale"):   # (B, S, KV, ·)
            return _guard((bspec, sspec, None, None), shape, mesh)
        if name in ("c_kv", "k_pe"):      # (B, S, rank)
            return _guard((bspec, sspec, None), shape, mesh)
        if name in ("cross_k", "cross_v"):  # (B, n_ctx, H, hd)
            return _guard((bspec, None, M, None), shape, mesh)
        if name in ("conv_x", "conv_bc"):  # (B, k, channels)
            return _guard((bspec, None, M), shape, mesh)
        if name == "ssm":                 # (B, nh, hd, ds)
            return _guard((bspec, M, None, None), shape, mesh)
        return P(*((None,) * len(shape)))

    return [{n: spec_for(n, tuple(t.shape)) for n, t in layer.items()}
            for layer in cache]


def zero1_opt_specs(params, pspecs: Dict[str, P], mesh) -> Dict[str, P]:
    """ZeRO-1: AdamW moments additionally shard over the 'data' axis on
    the first dimension not already covered by a mesh axis (and divisible
    by it). Enable with REPRO_ZERO1=1."""
    dsize = mesh_shape(mesh)["data"]

    def add_data(shape, spec):
        axes = tuple(spec) + (None,) * (len(shape) - len(spec))
        for i, (dim, ax) in enumerate(zip(shape, axes)):
            if ax is None and dim % dsize == 0 and dim >= dsize:
                new = list(axes)
                new[i] = "data"
                return P(*new)
        return P(*axes)

    return {n: add_data(s, pspecs[n])
            for n, s in _named_shapes(params).items()}


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def to_placements(spec: P, mesh) -> List[Any]:
    """The DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``),
    one a mesh dimension: ``Shard(d)`` on each mesh dimension that shards
    tensor dimension ``d``, ``Replicate()`` on the others.  A tensor
    dimension over a tuple of axes becomes ``Shard(d)`` on each of them;
    DTensor splits over the lower mesh dimension first, so the tuple must
    list its axes in the mesh's order (the reference's major-first
    order: ``("pod", "data")``, ``("data", "model")``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate() for _ in names]
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: the axes {axes} of dimension "
                             f"{d} are not in the mesh's order {names}")
        for md in dims:
            if not isinstance(out[md], Replicate):
                raise ValueError(f"spec {spec} uses mesh axis "
                                 f"{names[md]!r} twice")
            out[md] = Shard(d)
    return out

