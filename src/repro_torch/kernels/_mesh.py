"""The port's kernels under a device mesh (DTensor inputs).

A wrapper that a DTensor reaches runs its kernel through
``torch.distributed.tensor.experimental.local_map``: the inputs are
redistributed to placements the kernel can run on shard by shard, each
rank calls the wrapper on its local tensors (the CUDA kernel on the
card, the plain version on the CPU, the shape function on ``meta``), and
the outputs come back as DTensors.  Autograd flows through ``local_map``
to the kernels' own ``autograd.Function``s.

The placement rule of the attention and scan kernels: on each mesh
dimension the batch stays sharded where the input shards it
(``Shard(0)``), the heads stay sharded where the input shards them and
every rank's query heads read only its own kv heads (or, for the scan,
its own groups), and anything else is replicated first.  The decode
kernels' sequence-sharded cache (``launch.sharding.cache_specs``) has
its own route, ``seq_dims`` / ``seq_offset``: each rank attends its own
slice of the keys and the ranks merge their partials.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

__all__ = ["is_dtensor", "head_placements", "remap", "local_call",
           "seq_dims", "seq_offset", "ranks", "all_reduce", "merge_partials"]


def is_dtensor(t: Any) -> bool:
    return isinstance(t, DTensor)


def head_placements(t, head_dim: int,
                    heads_ok: Callable[[int], bool]) -> List[Any]:
    """Per mesh dimension of ``t``'s mesh: ``Shard(0)`` where ``t`` shards
    its batch, ``Shard(head_dim)`` where it shards its heads and
    ``heads_ok(n)`` holds for the number ``n`` of head shards so far,
    else ``Replicate()``."""
    out: List[Any] = []
    split = 1
    for size, p in zip(t.device_mesh.shape, t.placements):
        if isinstance(p, Shard) and p.dim == 0:
            out.append(Shard(0))
        elif (isinstance(p, Shard) and p.dim == head_dim
              and heads_ok(split * size)):
            split *= size
            out.append(Shard(head_dim))
        else:
            out.append(Replicate())
    return out


def remap(placements: Sequence[Any], dims: dict) -> List[Any]:
    """``placements`` with each ``Shard(d)`` moved to ``Shard(dims[d])``
    (a missing ``d``: ``Replicate()``)."""
    return [Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
            else (p if not isinstance(p, Shard) else Replicate())
            for p in placements]


def local_call(fn: Callable, mesh, in_placements: Sequence[Optional[Any]],
               out_placements, *args, out_shapes, in_grad_placements=None):
    """``fn(*local args)`` on every rank through ``local_map``: each
    DTensor argument redistributed to its entry of ``in_placements``
    first (``None`` for a non-tensor argument).  ``out_shapes``: the
    outputs' global shapes (one shape, or a tuple of them for a tuple of
    outputs).  ``local_map`` infers a global shape as the local one times
    the shard count, which is wrong where DTensor chunked a dimension
    unevenly (20 heads over 16 ranks: two heads on ten ranks, none on
    six); such an output is re-wrapped at its true shape."""
    moved = tuple(a.redistribute(mesh, tuple(p)) if p is not None else a
                  for a, p in zip(args, in_placements))
    ins = tuple(tuple(p) if p is not None else None for p in in_placements)
    grads = (None if in_grad_placements is None else
             tuple(tuple(p) if p is not None else None
                   for p in in_grad_placements))
    out = local_map(fn, out_placements=out_placements, in_placements=ins,
                    in_grad_placements=grads, device_mesh=mesh)(*moved)
    single = not isinstance(out, tuple)
    outs, shapes = ((out,), (out_shapes,)) if single else (out, out_shapes)
    fixed = []
    for o, shape in zip(outs, shapes):
        shape = tuple(shape)
        if tuple(o.shape) != shape:
            stride = [1] * len(shape)
            for d in range(len(shape) - 2, -1, -1):
                stride[d] = stride[d + 1] * shape[d + 1]
            o = DTensor.from_local(o.to_local(), mesh, o.placements,
                                   run_check=False, shape=torch.Size(shape),
                                   stride=tuple(stride))
        fixed.append(o)
    return fixed[0] if single else tuple(fixed)


def seq_dims(t, seq_dim: int = 1) -> List[int]:
    """The mesh dimensions over which ``t`` shards its sequence axis."""
    return [i for i, p in enumerate(t.placements)
            if isinstance(p, Shard) and p.dim == seq_dim]


def seq_offset(mesh, dims: Sequence[int], length: int) -> int:
    """The first global position of this rank's slice of a sequence of
    ``length`` sharded over mesh ``dims`` (major first, as DTensor splits
    them); the split must be even."""
    coord = mesh.get_coordinate()
    n, idx = 1, 0
    for d in dims:
        idx = idx * mesh.size(d) + coord[d]
        n *= mesh.size(d)
    if length % n:
        raise ValueError(f"a sequence of {length} does not split evenly "
                         f"over {n} ranks")
    return idx * (length // n)


def ranks(mesh, dims: Sequence[int]) -> int:
    """The number of ranks over mesh ``dims``."""
    n = 1
    for d in dims:
        n *= mesh.size(d)
    return n


def all_reduce(t: torch.Tensor, op: str, mesh, dims: Sequence[int]
               ) -> torch.Tensor:
    """``t`` reduced (``"max"`` or ``"sum"``) over the ranks of mesh
    ``dims``, one functional all-reduce a dimension."""
    for d in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, d)))
    return t


def merge_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                   mesh, dims: Sequence[int]) -> torch.Tensor:
    """The decode kernels' merge of each rank's float32 softmax partials
    over its slice of the keys (running max ``m``, sum ``l``, unnormalised
    ``acc``) across the ranks of mesh ``dims``: each rescaled by
    ``exp(m - max m)``, then ``Σ acc / (Σ l + 1e-30)``."""
    top = all_reduce(m, "max", mesh, dims)
    w = torch.exp(m - top)
    lsum = all_reduce(l * w, "sum", mesh, dims)
    asum = all_reduce(acc * w, "sum", mesh, dims)
    return asum / (lsum + 1e-30)
