"""Checkpoints of a model and its AdamW state to ``.npz`` (no external
dependencies).

Port of the reference package's ``repro.train.checkpoint``, keyed by the
model's parameter names, ``mu/<name>``, ``nu/<name>`` and ``step``.
numpy has no bfloat16, so every floating tensor is stored as float32,
which holds a bfloat16 exactly, and cast back to the live tensor's dtype
on restore: the round trip is bitwise.  A model and state on a device
mesh (DTensors) are saved gathered: every rank calls ``save``, each
tensor is gathered whole (``full_tensor()``), and rank 0 writes the same
file the plain model's would be; ``restore`` places each array back by
its live tensor's placements.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from repro_torch.kernels._mesh import is_dtensor
from repro_torch.train.optimizer import AdamWState

__all__ = ["save", "restore"]


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.cpu()
    if t.is_floating_point():
        t = t.float()
    return t.numpy()


def save(path: str, model: torch.nn.Module, opt_state: AdamWState) -> None:
    """Write the model's parameters and ``opt_state`` to ``path``."""
    arrays: Dict[str, np.ndarray] = {
        n: _array(p) for n, p in model.named_parameters()}
    for name, moments in (("mu", opt_state.mu), ("nu", opt_state.nu)):
        arrays.update({f"{name}/{n}": _array(t) for n, t in moments.items()})
    arrays["step"] = _array(opt_state.step)
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)


def _load(data, key: str, like: torch.Tensor) -> torch.Tensor:
    arr = data[key]
    assert arr.shape == tuple(like.shape), (key, arr.shape,
                                            tuple(like.shape))
    t = torch.from_numpy(arr).to(like.device, like.dtype)
    if is_dtensor(like):
        t = distribute_tensor(t, like.device_mesh, like.placements)
    return t


def restore(path: str, like: Tuple[torch.nn.Module, AdamWState]
            ) -> Tuple[torch.nn.Module, AdamWState]:
    """Load ``path`` into ``like = (model, opt_state)``: the model's
    parameters are overwritten in place, the state is rebuilt; every
    array's shape must match its live tensor's."""
    model, state = like
    with np.load(path, allow_pickle=False) as data:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(_load(data, n, p))
        mu = {n: _load(data, f"mu/{n}", t) for n, t in state.mu.items()}
        nu = {n: _load(data, f"nu/{n}", t) for n, t in state.nu.items()}
        step = _load(data, "step", state.step)
    return model, AdamWState(step=step, mu=mu, nu=nu)
