"""Production and host meshes, as ``torch.distributed`` device meshes.

Port of the reference package's ``repro.launch.mesh``.  The production
mesh is the reference's 16 × 16 ("data", "model") layout, or 2 × 16 × 16
("pod", "data", "model") across two pods: a run of 256 or 512 ranks (for
instance under ``torchrun``), or a fake process group of that size for
the dry run (``launch.dryrun``).  The host mesh spans whatever world the
process group has, ``(world // model_parallel, model_parallel)``.

Both are functions, never module-level constants, so importing this
module touches no device and no process group.  When no group is
initialised, ``make_host_mesh`` makes a one-rank group itself (NCCL over
a ``HashStore`` on the card, gloo on the CPU), so a single process needs
no TCP rendezvous; ``owned_group()`` destroys on exit any group this
module made inside it.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "make_host_mesh", "owned_group"]

# whether this module initialised the current default process group
_OWNED = {"group": False}


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``, over an initialised group of exactly 256 or 512
    ranks; any other world raises ``ValueError``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    world = _world()
    if world != need:
        raise ValueError(f"the {'x'.join(map(str, shape))} production mesh "
                         f"needs a process group of {need} ranks, got a "
                         f"world size of {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def _own_one_rank_group(device_type: str) -> None:
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    _OWNED["group"] = True


def make_host_mesh(model_parallel: int = 1, *,
                   device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh over the process group's world, ``(world //
    model_parallel, model_parallel)``; without a group, a one-rank group
    of this module's own (see ``owned_group``)."""
    if not dist.is_initialized():
        _own_one_rank_group(device_type)
    world = _world()
    if world % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} does not divide "
                         f"the world size {world}")
    return init_device_mesh(device_type, (world // model_parallel,
                                          model_parallel),
                            mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def owned_group() -> Iterator[None]:
    """Run a block that may build a host mesh; on exit destroy any group
    this module made for it (a group the caller made stays)."""
    try:
        yield
    finally:
        if _OWNED["group"] and dist.is_initialized():
            dist.destroy_process_group()
        _OWNED["group"] = False
