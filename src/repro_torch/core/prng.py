"""Counter-based per-point random streams for the port's sweep.

The reference keys every grid point with ``fold_in(PRNGKey(seed), i)``
(``repro.core.engine.point_keys``): a point's result depends only on
(params[i], seed, global index i), so a grid dispatched whole, split
into chunks (``key_offset``) or spread over devices gives the same
bits.  A ``torch.Generator`` is one sequential stream and cannot give
that, so the port uses Threefry-2x32 with 20 rounds (Salmon et al.,
SC'11 — the generator JAX itself uses), written in plain int32 tensor
ops:

- the point key is ``threefry(key=(seed_lo, seed_hi), ctr=(i, 0))`` for
  global point index ``i``;
- a draw is ``threefry(key=point_key, ctr=(step, stream + slot))``, two
  32-bit words per counter, so word ``w`` of a step's stream is a pure
  function of (seed, i, step, stream, w).

Nothing depends on how many points are drawn at once or in which order,
and a step draws the same words whatever the state (the sweep asks for a
fixed count per step).  Bitwise equality with ``jax.random`` is not a
goal: the port is held to the reference statistically.

int32 arithmetic: adds wrap (two's complement on every torch backend),
and ``>>`` on int32 is arithmetic, so the rotate masks the bits the
sign extension would smear in.  ``uint32`` tensors would avoid the
mask, but torch implements no add for them.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["threefry2x32", "point_keys", "draw_words", "uniform",
           "exponential", "normal_pairs", "STREAM_STRIDE"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# counter-word offset between two named streams of one step: a stream
# may use up to 2**24 counters (2**25 words) per step
STREAM_STRIDE = 1 << 24


def _i32(x: int) -> int:
    """A Python int's low 32 bits as a signed int32 value."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    low = (x >> (32 - r)).bitwise_and_((1 << r) - 1)
    return (x << r).bitwise_or_(low)


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32-20 of counters (x0, x1) under keys (k0, k1); all
    int32 tensors that broadcast together.  Matches the Random123
    known-answer vectors bit for bit (checked by the tests)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + k0
    x1 = x1 + k1
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(g + 1) % 3]
        x1 = x1 + ks[(g + 2) % 3] + (g + 1)
    return x0, x1


def point_keys(seed: int, offset: int, n: int,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point keys ``(k0, k1)``, each an int32 ``(n,)`` tensor, for
    global point indices ``offset … offset + n − 1``."""
    idx = torch.arange(offset, offset + n, dtype=torch.int64,
                       device=device)
    lo = torch.where(idx >= 1 << 31, idx - (1 << 32), idx)
    zero = torch.zeros(n, dtype=torch.int32, device=device)
    s0 = torch.tensor(_i32(seed), dtype=torch.int32, device=device)
    s1 = torch.tensor(_i32(seed >> 32), dtype=torch.int32, device=device)
    return threefry2x32(s0, s1, lo.to(torch.int32), zero)


def draw_words(keys: Tuple[torch.Tensor, torch.Tensor], step0: int,
               n_steps: int, streams: Tuple[Tuple[int, int], ...]
               ) -> Tuple[torch.Tensor, ...]:
    """Random int32 words of ``n_steps`` consecutive steps from
    ``step0``, for every point, in one Threefry call.

    ``streams`` lists ``(stream_id, n_words)``; the result holds one
    ``(n_steps, n_words, P)`` tensor per stream (points innermost).
    Word ``2j`` and ``2j + 1`` of a stream are the two outputs of its
    counter ``j``, so a stream's first words do not change when it is
    asked for more."""
    k0, k1 = keys
    device = k0.device
    pairs = [(sid, (nw + 1) // 2) for sid, nw in streams]
    c1 = torch.cat([sid * STREAM_STRIDE + torch.arange(npair,
                                                       dtype=torch.int32,
                                                       device=device)
                    for sid, npair in pairs])
    c0 = torch.arange(step0, step0 + n_steps, dtype=torch.int32,
                      device=device)
    x0, x1 = threefry2x32(k0.view(1, 1, -1), k1.view(1, 1, -1),
                          c0.view(-1, 1, 1), c1.view(1, -1, 1))
    words = torch.stack((x0, x1), dim=2).reshape(n_steps, -1, k0.numel())
    out, at = [], 0
    for (_, nw), (_, npair) in zip(streams, pairs):
        out.append(words[:, at:at + nw])
        at += 2 * npair
    return tuple(out)


def uniform(words: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in (0, 1) from int32 words: the top 23 bits plus
    one half, times 2**-23 — exact in float32, never 0 or 1."""
    top = (words >> 9).bitwise_and_(0x7FFFFF)
    return (top.to(torch.float32) + 0.5) * (2.0 ** -23)


def exponential(words: torch.Tensor) -> torch.Tensor:
    """Exp(1) draws, −log U: strictly positive, at most 16.6."""
    return torch.log(uniform(words)).neg_()


def normal_pairs(words: torch.Tensor) -> torch.Tensor:
    """Standard normals by Box–Muller: the words' dim 1 (even length)
    pairs up into (u1, u2) → (r·cos 2πu2, r·sin 2πu2); returns a tensor
    of the same shape as ``words``."""
    u = uniform(words)
    h = u.shape[1] // 2
    r = torch.sqrt(torch.log(u[:, :h]) * -2.0)
    theta = u[:, h:] * (2.0 * torch.pi)
    return torch.cat((r * torch.cos(theta), r * torch.sin(theta)), dim=1)
