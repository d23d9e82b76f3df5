"""Placing a model, its AdamW moments, a batch and a decode cache on a
device mesh by their partition specs (port-only: the reference places
its pytrees with ``jax.device_put`` / ``out_shardings``).

Every tensor becomes a DTensor through ``distribute_tensor`` with the
placements ``sharding.to_placements`` gives its spec.  On a real group
of several ranks each rank passes the same whole tensor (the port's
seeded weights and the corpus are the same on every rank) and keeps its
shard; on a fake group (the dry run) the tensors are ``meta`` and
nothing is allocated.

``step_scope(mesh)`` is the context a step runs in on a mesh: DTensor's
implicit replication, so the plain tensors a step makes itself
(positions from ``arange``, masks, the learning rate) enter DTensor ops
as replicated, which they are on every rank.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, List

import torch
from torch import nn
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.kernels._mesh import is_dtensor
from repro_torch.launch.sharding import P, to_placements, zero1_opt_specs
from repro_torch.train.optimizer import AdamWState

__all__ = ["is_dtensor", "distribute", "shard_model", "shard_batch",
           "shard_cache", "shard_opt_state", "moment_specs", "step_scope",
           "full"]


def distribute(t: torch.Tensor, mesh, spec: P) -> torch.Tensor:
    """``t`` as a DTensor on ``mesh`` placed by ``spec``."""
    return distribute_tensor(t, mesh, to_placements(spec, mesh))


def shard_model(model: nn.Module, mesh, specs: Dict[str, P]) -> nn.Module:
    """Replace each parameter of ``model`` by a DTensor parameter placed by
    ``specs[name]`` (``sharding.param_specs``), in place; returns the
    model."""
    for name, p in list(model.named_parameters()):
        path, _, attr = name.rpartition(".")
        owner = model.get_submodule(path) if path else model
        new = nn.Parameter(distribute(p.detach(), mesh, specs[name]),
                           requires_grad=p.requires_grad)
        if isinstance(owner, nn.ParameterDict):
            owner[attr] = new
        else:
            setattr(owner, attr, new)
    return model


def shard_batch(batch: Dict[str, torch.Tensor], mesh,
                specs: Dict[str, P]) -> Dict[str, torch.Tensor]:
    """A batch's tensors as DTensors placed by ``specs``
    (``sharding.input_spec_tree``)."""
    return {k: distribute(v, mesh, specs[k]) for k, v in batch.items()}


def shard_cache(cache: List[Dict[str, torch.Tensor]], mesh,
                specs: List[Dict[str, P]]) -> List[Dict[str, torch.Tensor]]:
    """A decode cache, layer by layer, placed by ``specs``
    (``sharding.cache_specs``)."""
    return [{k: distribute(t, mesh, s[k]) for k, t in layer.items()}
            for layer, s in zip(cache, specs)]


def moment_specs(model: nn.Module, pspecs: Dict[str, P],
                 mesh) -> Dict[str, P]:
    """The AdamW moments' specs: the parameters' ``pspecs``, or with
    ``REPRO_ZERO1=1`` (read at each call, as the reference's dry run
    reads it) ``sharding.zero1_opt_specs``."""
    if os.environ.get("REPRO_ZERO1"):
        return zero1_opt_specs(model, pspecs, mesh)
    return pspecs


def shard_opt_state(state: AdamWState, mesh,
                    specs: Dict[str, P]) -> AdamWState:
    """``state``'s moments placed by ``specs`` and its step replicated."""
    return AdamWState(
        step=distribute(state.step, mesh, P()),
        mu={n: distribute(t, mesh, specs[n]) for n, t in state.mu.items()},
        nu={n: distribute(t, mesh, specs[n]) for n, t in state.nu.items()})


@contextlib.contextmanager
def step_scope(mesh) -> Iterator[None]:
    """Where ``mesh`` is set, DTensor's implicit replication of plain
    tensors; nothing otherwise."""
    if mesh is None:
        yield
        return
    with implicit_replication():
        yield


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole value of a DTensor (``full_tensor()``), a plain tensor
    as it is."""
    return t.full_tensor() if is_dtensor(t) else t
