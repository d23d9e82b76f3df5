"""Rotary position embeddings (full and partial-rotary).

Port of the reference package's ``repro.models.rope``: the half-split
convention (rotate_half, as in Llama/Qwen), angles and rotation in
float32, the result cast back to the input's dtype.
"""
from __future__ import annotations

import torch

__all__ = ["rope_freqs", "apply_rope"]


def rope_freqs(head_dim: int, theta: float, partial: float = 1.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies for the rotary dims (rot_dim = head_dim*partial)."""
    rot = int(head_dim * partial)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               partial: float = 1.0) -> torch.Tensor:
    """Apply RoPE.

    x: (..., S, H, head_dim) — positions: broadcastable to (..., S).
    """
    head_dim = x.shape[-1]
    inv = rope_freqs(head_dim, theta, partial, device=x.device)
    rot = inv.shape[0] * 2
    angles = positions[..., None].float() * inv           # (..., S, rot/2)
    cos = torch.cos(angles)[..., None, :]                 # (..., S, 1, r/2)
    sin = torch.sin(angles)[..., None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    xf1 = x_rot[..., : rot // 2].float()
    xf2 = x_rot[..., rot // 2:].float()
    out1 = xf1 * cos - xf2 * sin
    out2 = xf2 * cos + xf1 * sin
    out = torch.cat([out1, out2], dim=-1).to(x.dtype)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out
