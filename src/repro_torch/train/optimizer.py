"""AdamW with a cosine schedule and global-norm clipping, in place on a
model's parameters.

Port of the reference package's ``repro.train.optimizer``.  The state
keeps float32 moments ``mu`` / ``nu`` keyed by the model's parameter
names, whatever the parameters' dtype, and an int32 ``step``.  The
arithmetic is the reference's: the learning rate at the step before the
increment and the bias corrections at the one after it, the clip scale
``min(1, clip / (gnorm + 1e-9))``, each update in float32 and cast back
to the parameter's dtype.  Weight decay follows the reference's pytree,
not the port's module tree (``decays``).  Everything stays on the
parameters' device: no step reads a value back to the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, NamedTuple, Set, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import split_pattern

__all__ = ["AdamWConfig", "AdamWState", "init_state", "schedule",
           "global_norm", "decays", "decay_names", "apply_updates"]

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor        # int32 scalar: updates applied so far
    mu: Params                # float32 first moments, by parameter name
    nu: Params                # float32 second moments


def init_state(params: Union[torch.nn.Module, Params]) -> AdamWState:
    """Zero moments for every parameter (a module's named parameters or
    a name → tensor dict), on its device."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    dev = next(iter(params.values())).device
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros,
                      nu={n: z.clone() for n, z in zeros.items()})


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor), float32: a linear
    warm-up over ``warmup_steps``, then a cosine down to ``min_lr_frac``
    of ``lr`` at ``total_steps``."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square, in float32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def decays(name: str, p: torch.Tensor, lead: int) -> bool:
    """Whether AdamW decays parameter ``name`` of a model whose first
    ``lead`` layers are not repeated (``split_pattern``'s ``lead``): the
    reference decays a leaf of its pytree when ``p.ndim >= 2``
    (``repro/train/optimizer.py:76``), and it stacks the repeated layers
    (index ``lead`` and past) and every encoder layer on a leading layer
    axis (``repro/models/transformer.py:307–314``), where the port keeps
    each layer apart.  So a parameter decays when it has two axes or
    more, or when it belongs to a repeated layer or an encoder layer
    (their norm scales and q/k norms, biases, Mamba2's ``A_log``, ``D``
    and ``dt_bias``); ``norm_f``, the encoder's final ``norm`` and a lead
    layer's vectors do not."""
    if p.dim() >= 2 or name.startswith("encoder.layers."):
        return True
    parts = name.split(".")
    return parts[0] == "layers" and int(parts[1]) >= lead


def decay_names(cfg: ModelConfig, model: torch.nn.Module) -> Set[str]:
    """The names of ``model``'s parameters that ``decays``."""
    lead = split_pattern(cfg)[0]
    return {n for n, p in model.named_parameters() if decays(n, p, lead)}


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Params, grads: Params,
                  state: AdamWState, decay: Set[str]
                  ) -> Tuple[AdamWState, torch.Tensor]:
    """One AdamW step, in place on ``params`` (name → parameter) from
    ``grads`` (name → gradient, any float dtype); ``decay``: the names
    that take weight decay (``decay_names``).  Returns the new state and
    the gradients' global norm (before clipping)."""
    gnorm = global_norm(grads[n] for n in params)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    step = state.step + 1
    lr = schedule(cfg, state.step)
    b1c = 1 - cfg.beta1 ** step.float()
    b2c = 1 - cfg.beta2 ** step.float()
    mu, nu = {}, {}
    for n, p in params.items():
        g = grads[n].float() * scale
        mu[n] = cfg.beta1 * state.mu[n] + (1 - cfg.beta1) * g
        nu[n] = cfg.beta2 * state.nu[n] + (1 - cfg.beta2) * g.square()
        delta = (mu[n] / b1c) / (torch.sqrt(nu[n] / b2c) + cfg.eps)
        if n in decay:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return AdamWState(step=step, mu=mu, nu=nu), gnorm
