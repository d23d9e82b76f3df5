"""Structured exact-chain solver — the port's copy, with its grid
solver on the card.

Own copy of the reference package's ``repro.core.chain_solver``: the
numpy paths (``build_chain``, ``solve_pi_gth``, ``solve_pi_banded``,
``solve_pi``, ``chain_metrics``, ``chain_loss_metrics`` and
``grid_solve(method="numpy")``) unchanged, and the reference's
one-dispatch JAX grid kernel as ``grid_solve(method="torch")``: the
same GTH level recursion in float64 torch, every cell of a chunk at
once on ``device`` (CUDA unless the caller asks for the CPU).  Where
the reference ``vmap``s one cell's ``lax.scan``, the chunk's cells
share a ``(C, V, V + 1)`` sliding window and a Python loop runs over
the levels; sums run in a fixed pairwise order, so a cell's result does
not depend on how many cells share its chunk.

The reference module's description follows.

Structured exact-chain solver: banded level recursion for the
embedded batching chain.

The embedded chain behind ``repro_torch.core.markov`` (queue length at
service completions, deterministic linear batch times) has far more
structure than a dense transition matrix exposes.  From level l the
chain jumps to ``carry(l) + Poisson(λ·τ[b(l)])`` with
``carry(l) = max(0, l − b_max)`` — so for finite b_max every level
above b_max has the *identical* shifted-Poisson row (an M/G/1-type
chain with a repeating Toeplitz band), and every row's support lives in
a window of width ``V ≈ O(λτ[b_max] + √(λτ[b_max]))`` around its
carry.  Nothing outside a (K+1)×(V+1) band is ever nonzero beyond the
band-construction tolerance (1e-18 of row mass), so no K×K matrix need
ever be materialized.

Three solvers share that band:

- ``solve_pi_gth``   — censored-chain (GTH-style) level reduction:
  eliminate levels K → 1 (each elimination is a rank-one band update
  using only additions/multiplications of nonnegative censored
  probabilities — no subtractions, the numerically stable analogue of
  the Ramaswami recursion for this scalar-level chain), then recover π
  level-by-level going back up.  O(K·V·b) flops, O(K·V) memory.  Pure
  NumPy, always available; also the reference the other two paths are
  pinned against.
- ``solve_pi_banded`` — the same band solved as an anchored banded
  linear system via LAPACK ``gbsv`` (SciPy) — the fastest CPU path
  (~60–100× over dense LU at the legacy K = 8192 truncation).  Falls
  back to ``solve_pi_gth`` when SciPy is absent.
- ``grid_solve`` — the GTH level recursion batched over cells: a loop
  over levels with an O(V²) sliding-window carry (the repeating
  Toeplitz band is regenerated on the fly per level, and the
  elimination emits exactly the frozen column values the backward pass
  needs), over a chunk of (λ, b_max) cells at once — a whole exact
  surface in float64 on the card.

The truncation-cell witness is unchanged: every row's residual mass is
absorbed at the end of its band (the same place the dense solver's
truncation cell absorbs it), so ``π[K]`` remains the a-posteriori
truncation-error estimate callers already rely on.

Domain: the level recursion divides by the per-level probability of
moving *down* (``s_n`` > 0), which a positive-recurrent chain
guarantees; cells at/above the finite-b_max stability limit whose band
detaches from the diagonal raise ``ValueError`` (use the dense
reference for truncated-chain answers in that regime).  b_max = ∞ has
no repeating band (row means grow with the level, so the band width
grows with K) — ``markov.solve`` keeps those on the dense path, whose
adaptive truncation stays small precisely because the ∞-chain's queue
is short.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.core.analytic import LinearServiceModel
from repro_torch.core.engine import padded_row_sum as _rsum

__all__ = ["BandedChain", "build_chain", "solve_pi", "solve_pi_gth",
           "solve_pi_banded", "chain_metrics", "chain_loss_metrics",
           "grid_solve", "BAND_TOL"]

# per-row probability mass the band construction may drop (absorbed at
# the band edge, exactly like the dense solver's truncation cell) — far
# below the 1e-10 parity the structured solver is pinned to
BAND_TOL = 1e-18
_LOG_INV_TOL = math.log(1.0 / BAND_TOL)
_TINY = 1e-300          # guards 0/0 for band-unreachable levels


def _poisson_window(mu):
    """(lo, hi) covering Poisson(mu) up to ~BAND_TOL tail mass per
    side (Chernoff-style half-width; generous constants).  Monotone
    nondecreasing in mu, which the band layout relies on."""
    mu = np.asarray(mu, dtype=float)
    half = np.sqrt(2.0 * mu * _LOG_INV_TOL)
    lo = np.maximum(0.0, np.floor(mu - half - 4)).astype(np.int64)
    hi = np.ceil(mu + half + 8).astype(np.int64) + 2
    return lo, hi


@dataclass
class BandedChain:
    """The embedded chain, stored as its nonzero band.

    ``B[l, j]`` is the transition probability from level l to absolute
    level ``c[l] + j``; ``width[l]`` is the last valid band index of
    row l (its residual row mass is absorbed there); ``V`` the shared
    band width.  ``c`` is nondecreasing in l — the invariant that keeps
    censored-chain fill inside the band."""

    lam: float
    b_max: float
    K: int
    V: int
    B: np.ndarray                 # (K+1, V+1) float64
    c: np.ndarray                 # (K+1,) first absolute column per row
    width: np.ndarray             # (K+1,) last valid band index per row
    b_of: np.ndarray              # (K+1,) batch size taken at level l
    t_of: np.ndarray              # (K+1,) service time of that batch


def build_chain(lam: float, model: LinearServiceModel, b_max: float,
                K: int) -> BandedChain:
    """Construct the banded transition structure at truncation K."""
    if lam <= 0:
        raise ValueError("lam must be > 0")
    ls = np.arange(K + 1)
    cap = b_max if not math.isinf(b_max) else K + 1
    b_of = np.minimum(np.maximum(ls, 1), cap).astype(np.int64)
    t_of = model.tau(b_of)
    carry = np.maximum(0, ls - b_of)
    mu = lam * t_of
    plo, phi = _poisson_window(mu)
    c = np.minimum(carry + plo, K)
    hi = np.minimum(carry + phi, K)
    if np.any(c[1:] >= ls[1:]):
        raise ValueError(
            "banded chain detached from the diagonal (λ at or beyond "
            "the structured solver's positive-recurrence domain for "
            f"b_max={b_max}); solve with method='dense' instead")
    V = int(np.max(hi - c))
    width = (hi - c).astype(np.int64)

    j = np.arange(V + 1)
    pidx = (c - carry)[:, None] + j[None, :]          # Poisson index
    cumlogfact = np.concatenate(
        [[0.0], np.cumsum(np.log(np.arange(1, K + V + 2, dtype=float)))])
    logp = (pidx * np.log(mu)[:, None] - cumlogfact[pidx] - mu[:, None])
    B = np.exp(logp)
    B[j[None, :] > width[:, None]] = 0.0
    # absorb each row's residual (right tail past the band or past K,
    # plus the ~BAND_TOL left tail) at its last valid cell — rows stay
    # exactly stochastic and π[K] keeps its witness role
    B[ls, width] += np.maximum(0.0, 1.0 - B.sum(axis=1))
    return BandedChain(lam=float(lam), b_max=b_max, K=K, V=V, B=B, c=c,
                       width=width, b_of=b_of, t_of=t_of)


# ---------------------------------------------------------------------------
# NumPy solvers on the band
# ---------------------------------------------------------------------------

def solve_pi_gth(chain: BandedChain) -> np.ndarray:
    """Censored-chain (GTH) level reduction on the band.

    Downward pass: censor level n out of the chain (n = K..1); the
    rank-one fill ``P(i,j) += P(i,n)·P(n,j)/s_n`` lands only in columns
    [c_n, n) of rows i ∈ (n−V, n), i.e. inside the band, because ``c``
    is nondecreasing.  Upward pass: expected visits x_n between visits
    to level 0, read off the frozen column-n entries.  Only additions,
    multiplications and divisions of nonnegative terms — entrywise
    stable regardless of load."""
    B, c, K, V = chain.B.copy(), chain.c, chain.K, chain.V
    s = np.empty(K + 1)
    for n in range(K, 0, -1):
        d = n - c[n]
        g = B[n, :d]
        sn = g.sum()
        s[n] = sn
        lo = np.searchsorted(c, n - V, side="left")
        if lo < n:
            ii = np.arange(lo, n)
            f = B[ii, n - c[ii]]
            cols = (c[n] - c[ii])[:, None] + np.arange(d)[None, :]
            B[ii[:, None], cols] += f[:, None] * (g / max(sn, _TINY))
    x = np.zeros(K + 1)
    x[0] = 1.0
    for n in range(1, K + 1):
        lo = np.searchsorted(c, n - V, side="left")
        ii = np.arange(lo, n)
        x[n] = (x[ii] @ B[ii, n - c[ii]]) / max(s[n], _TINY)
    return x / x.sum()


def _scipy_solve_banded():
    try:
        from scipy.linalg import solve_banded
        return solve_banded
    except Exception:                                 # pragma: no cover
        return None


def solve_pi_banded(chain: BandedChain) -> np.ndarray:
    """π via LAPACK ``gbsv`` on the anchored band system.

    Setting π_0 = 1 and dropping the level-0 balance equation leaves
    the nonsingular banded system over x_1..x_K
    ``Σ_{l≥1} x_l (P(l,j) − δ_lj) = −P(0,j)`` whose bandwidths are the
    chain's own up/down move spans — O(K·V²) flops, no fill beyond the
    band.  Falls back to the GTH recursion when SciPy is missing, and
    when the anchored solve breaks down: near saturation at a large
    b_max π_0 falls to ~1e-15 and below, the anchor π_0 = 1 leaves the
    system ill-conditioned, and the solved x comes out negative
    (entries below −1e-9·max|x|), which the clip below would turn into
    π = (1, 0, …, 0).  Past the stability limit the chain has no
    stationary law and the banded answer stands, as in the reference
    package, which keeps the bare solve everywhere."""
    solve_banded = _scipy_solve_banded()
    if solve_banded is None:                          # pragma: no cover
        return solve_pi_gth(chain)
    B, c, width, K, V = chain.B, chain.c, chain.width, chain.K, chain.V
    ls = np.arange(1, K + 1)
    jd = np.arange(V + 1)
    J = c[1:, None] + jd[None, :]                     # absolute column
    ok = (J >= 1) & (J <= K) & (jd[None, :] <= width[1:, None])
    ku = int(np.max((ls[:, None] - J)[ok], initial=0))    # down-moves
    kl = int(np.max((J - ls[:, None])[ok], initial=0))    # up-moves
    ab = np.zeros((kl + ku + 1, K))
    rows_ab = ku + J - ls[:, None]
    cols_ab = np.broadcast_to(ls[:, None] - 1, J.shape)
    ab[rows_ab[ok], cols_ab[ok]] = B[1:][ok]
    ab[ku, :] -= 1.0
    rhs = np.zeros(K)
    j0 = c[0] + jd
    ok0 = (j0 >= 1) & (j0 <= K) & (jd <= width[0])
    np.add.at(rhs, j0[ok0] - 1, -B[0, ok0])
    x = solve_banded((kl, ku), ab, rhs, overwrite_ab=True,
                     overwrite_b=True, check_finite=False)
    # below the stability limit (λ·τ[b_max] < b_max) a negative x is
    # the anchored solve breaking down, not the chain
    stable = chain.lam * chain.t_of[-1] < chain.b_of[-1]
    if stable and x.size and x.min() < -1e-9 * np.abs(x).max():
        return solve_pi_gth(chain)
    pi = np.concatenate([[1.0], x])
    pi = np.clip(pi, 0.0, None)
    return pi / pi.sum()


def solve_pi(chain: BandedChain, method: str = "band") -> np.ndarray:
    """Stationary distribution of the banded chain.

    ``method="band"`` → LAPACK banded solve (GTH fallback);
    ``method="gth"`` → force the pure-NumPy level recursion."""
    if method == "band":
        return solve_pi_banded(chain)
    if method == "gth":
        return solve_pi_gth(chain)
    raise ValueError(f"unknown band method {method!r}")


def chain_metrics(lam: float, pi: np.ndarray, t_of: np.ndarray,
                  b_of: np.ndarray) -> Dict[str, float]:
    """Markov-regenerative renewal-reward metrics from π (shared with
    the dense solver in ``repro_torch.core.markov``): a cycle from
    completion(l) is idle (only l = 0) + the service of batch b(l);
    E[L] integrates jobs-in-system over the cycle, E[W] = E[L]/λ."""
    K = len(pi) - 1
    ls = np.arange(K + 1)
    idle = np.where(ls == 0, 1.0 / lam, 0.0)
    cyc_len = idle + t_of
    in_sys = np.maximum(ls, 1).astype(float)
    integral = in_sys * t_of + lam * t_of ** 2 / 2.0
    mean_cycle = float(pi @ cyc_len)
    e_l = float(pi @ integral) / mean_cycle
    bf = b_of.astype(float)
    return {
        "mean_latency": e_l / lam,
        "mean_batch": float(pi @ bf),
        "batch_m2": float(pi @ (bf * bf)),
        "utilization": float(pi @ t_of) / mean_cycle,
        "mean_queue": e_l,
        "pi0": float(pi[0]),
        "tail_mass": float(pi[-1]),
    }


def chain_loss_metrics(lam: float, pi: np.ndarray, t_of: np.ndarray,
                       b_of: np.ndarray, q_max: int) -> Dict[str, float]:
    """Renewal-reward metrics when the truncation IS the waiting room.

    The truncated chain at K = q_max is *exactly* the embedded chain of
    the finite-waiting-room M/D[b]/1/q_max system under
    reject-at-arrival ("429") admission: each row's tail mass past K —
    which the truncated construction lumps at state K — is precisely
    the event "the room filled mid-service and later arrivals were
    turned away", so π[K] is legitimate stationary mass, not a
    truncation-error witness.  What changes versus ``chain_metrics``
    is only the reward structure of a cycle from level l
    (``w = max(l − b, 0)`` carried jobs, room ``m = q_max − w``,
    A ~ Poisson(λτ[b])):

    - rejected jobs per cycle  E[(A − m)⁺] = Σ_{j} p_j (j − m)⁺,
    - the occupancy integral clips at the full room:
      ∫₀^τ E[min(N(t), m)] dt = λτ²/2 − E[(A−m)⁺(A−m−1)⁺]/(2λ)
      (swap the sum in Σ_{k>m} ∫₀^τ P(N(t) ≥ k) dt, using
      ∫₀^τ P(N_t ≥ k) dt = E[(A − k)⁺]/λ),

    giving loss_frac = π·E[(A−m)⁺] / (λ·E[cycle]) and, by Little's law
    over *admitted* jobs, E[W] = E[L] / (λ(1 − loss_frac))."""
    K = len(pi) - 1
    if K != q_max:
        raise ValueError("loss metrics need the chain truncated at the "
                         f"waiting room itself (K={K}, q_max={q_max})")
    ls = np.arange(K + 1)
    w = np.maximum(0, ls - b_of)
    m = q_max - w                                      # room in service
    mu = lam * t_of
    _, phi = _poisson_window(mu)
    n_max = int(phi.max())
    j = np.arange(n_max + 1)
    cumlogfact = np.concatenate(
        [[0.0], np.cumsum(np.log(np.arange(1, n_max + 1, dtype=float)))])
    p = np.exp(j[None, :] * np.log(mu)[:, None] - cumlogfact[None, :]
               - mu[:, None])                          # (K+1, n_max+1)
    ex1 = np.maximum(j[None, :] - m[:, None], 0.0)     # (A − m)⁺
    e_excess = (p * ex1).sum(axis=1)
    x_clip = (p * ex1 * np.maximum(ex1 - 1.0, 0.0)).sum(axis=1) \
        / (2.0 * lam)

    idle = np.where(ls == 0, 1.0 / lam, 0.0)
    mean_cycle = float(pi @ (idle + t_of))
    loss_frac = float(pi @ e_excess) / mean_cycle / lam
    in_sys = np.maximum(ls, 1).astype(float)
    integral = in_sys * t_of + lam * t_of ** 2 / 2.0 - x_clip
    e_l = float(pi @ integral) / mean_cycle
    lam_adm = lam * (1.0 - loss_frac)
    bf = b_of.astype(float)
    return {
        "mean_latency": e_l / lam_adm,
        "mean_batch": float(pi @ bf),
        "batch_m2": float(pi @ (bf * bf)),
        "utilization": float(pi @ t_of) / mean_cycle,
        "mean_queue": e_l,
        "pi0": float(pi[0]),
        "loss_frac": loss_frac,
        "goodput": lam_adm,
        "pi_full": float(pi[-1]),
    }


# ---------------------------------------------------------------------------
# the batched float64 grid solver (torch)
# ---------------------------------------------------------------------------

def _grid_shapes(lams: np.ndarray, alphas: np.ndarray, tau0s: np.ndarray,
                 b_maxes: np.ndarray, K: int):
    """Static (V, D) for a dispatch: the widest per-cell band (row
    means are maximal at b_max, where the repeating band sits) and the
    largest down-move span.  Bucketed to limit recompiles.

    D is clamped to V + 1: a level's nonzero below-diagonal entries
    all live inside its own band (initial support by construction,
    censored fill by the nondecreasing-c invariant), so at low loads
    where the Poisson window is narrower than b_max the down-move
    vector is just the whole band row."""
    mu_top = lams * (alphas * b_maxes + tau0s)
    lo, hi = _poisson_window(mu_top)
    V = int(min(K, np.max(hi - lo)))
    V = min(K, -(-V // 16) * 16)                      # round up to 16
    D = int(min(np.max(b_maxes), K, V + 1))
    return V, D


def _grid_chunk(lam: torch.Tensor, alpha: torch.Tensor, tau0: torch.Tensor,
                b: torch.Tensor, K: int, V: int, D: int,
                cumlogfact: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The GTH level recursion for a chunk of C cells, specialized to
    (K, V, D): the reference's ``_build_grid_kernel`` cell body with the
    cell axis first.  ``lam``/``alpha``/``tau0`` are float64 ``(C,)``,
    ``b`` int64 ``(C,)``, ``cumlogfact`` the float64 log-factorial
    table of K + V + 2 entries.

    Downward pass over levels n = K..1, carrying only the V-row sliding
    window of band rows still subject to fill; initial rows — the
    repeating Toeplitz band too — are regenerated O(V) a level from the
    per-row scalars (μ, carry, c, width) and the table, so the band is
    never built whole.  Each level emits the frozen column ``f`` and
    the down-probability ``s_n``; the upward O(V) pass turns them into
    the expected visits x, then π and the renewal-reward metrics."""
    f64, i64 = torch.float64, torch.int64
    dev = lam.device
    C = lam.shape[0]
    lam_, alpha_, tau0_, b_ = (t.unsqueeze(1) for t in (lam, alpha, tau0, b))

    # per-row scalars of rows i = -V … K (row i at column i + V)
    rows = torch.arange(-V, K + 1, dtype=i64, device=dev).unsqueeze(0)
    bi = torch.minimum(torch.clamp(rows, min=1), b_)
    mu = lam_ * (alpha_ * bi.to(f64) + tau0_)
    carry = torch.clamp(rows - bi, min=0)
    half = torch.sqrt(2.0 * mu * _LOG_INV_TOL)
    plo = torch.clamp(torch.floor(mu - half - 4.0), min=0.0).to(i64)
    phi = torch.ceil(mu + half + 8.0).to(i64) + 2
    c_tab = torch.clamp(carry + plo, max=K)
    width = torch.clamp(torch.clamp(carry + phi, max=K) - c_tab, 0, V)
    log_mu = torch.log(mu)
    shift = c_tab - carry
    jV = torch.arange(V + 1, dtype=i64, device=dev)
    jD = torch.arange(D, dtype=i64, device=dev)

    def init_rows(lo: int, hi: int) -> torch.Tensor:
        """Band rows lo … hi − 1 of the raw chain, ``(C, hi − lo, V + 1)``
        (zeros for rows below 0); each row's residual mass is absorbed
        at its last valid cell."""
        sl = slice(lo + V, hi + V)
        pidx = shift[:, sl, None] + jV
        logp = (pidx.to(f64) * log_mu[:, sl, None]
                - cumlogfact[pidx] - mu[:, sl, None])
        wd = width[:, sl, None]
        r = torch.where(jV <= wd, torch.exp(logp), 0.0)
        r = r + torch.where(jV == wd,
                            torch.clamp(1.0 - _rsum(r), min=0.0)
                            .unsqueeze(-1), 0.0)
        below = rows[0, sl] < 0
        return torch.where(below[None, :, None], 0.0, r)

    # the frozen columns and down-probabilities, level n at index n − 1
    fs = torch.empty(K, C, V - 1, dtype=f64, device=dev)
    s = torch.empty(K, C, dtype=f64, device=dev)
    W = init_rows(K - V + 1, K + 1)               # rows n − V + 1 … n
    irow_off = torch.arange(-V + 1, 0, dtype=i64, device=dev)
    gpad = torch.zeros(C, D + 2 * (V + 1), dtype=f64, device=dev)
    for n in range(K, 0, -1):
        row_n = W[:, V - 1]
        c_win = c_tab[:, n + 1:n + V + 1]          # rows n − V + 1 … n
        c_n = c_win[:, V - 1]
        g = torch.where(jD < torch.clamp(n - c_n, max=D).unsqueeze(1),
                        row_n[:, :D], 0.0)
        s_n = _rsum(g)
        g = g / torch.clamp(s_n, min=_TINY).unsqueeze(1)
        cw = c_win[:, :V - 1]
        bidx = n - cw                              # band index of col n
        valid = (n + irow_off >= 0) & (bidx >= 1) & (bidx <= V)
        f = torch.gather(W[:, :V - 1], 2,
                         torch.clamp(bidx, 0, V).unsqueeze(2)).squeeze(2)
        f = torch.where(valid, f, 0.0)
        # rank-one fill, shifted per row by the band offset — the
        # Toeplitz-band convolution step of the recursion; g sits in a
        # zero-padded row, so a shifted read outside it reads 0
        gpad[:, V + 1:V + 1 + D] = g
        gidx = (V + 1 - (c_n.unsqueeze(1) - cw)).unsqueeze(2) + jV
        gv = torch.gather(gpad, 1, gidx.clamp_(min=0).reshape(C, -1)).reshape(
            C, V - 1, V + 1)
        W = torch.cat((init_rows(n - V, n - V + 1),
                       W[:, :V - 1] + f.unsqueeze(2) * gv), 1)
        fs[n - 1] = f
        s[n - 1] = s_n

    # upward pass: x_n from the window x_{n−V+1} … x_{n−1}; x_0 = 1
    X = torch.zeros(C, V - 1 + K, dtype=f64, device=dev)
    X[:, V - 2] = 1.0
    for n in range(1, K + 1):
        X[:, V - 2 + n] = (_rsum(X[:, n - 1:n + V - 2] * fs[n - 1])
                           / torch.clamp(s[n - 1], min=_TINY))
    pi = X[:, V - 2:]                              # levels 0 … K
    pi = pi / _rsum(pi).unsqueeze(1)

    ls = torch.arange(K + 1, dtype=i64, device=dev)
    b_of = torch.minimum(torch.clamp(ls, min=1), b_).to(f64)
    t_of = alpha_ * b_of + tau0_
    idle = torch.where(ls == 0, 1.0 / lam_, 0.0)
    integral = (torch.clamp(ls, min=1).to(f64) * t_of
                + lam_ * t_of * t_of / 2.0)
    mean_cycle = _rsum(pi * (idle + t_of))
    e_l = _rsum(pi * integral) / mean_cycle
    return {"mean_latency": e_l / lam,
            "mean_batch": _rsum(pi * b_of),
            "batch_m2": _rsum(pi * (b_of * b_of)),
            "utilization": _rsum(pi * t_of) / mean_cycle,
            "mean_queue": e_l,
            "pi0": pi[:, 0],
            "tail_mass": pi[:, K]}


def _check_grid_domain(lams, alphas, tau0s, b_maxes, K: int):
    """The band-attachment check ``build_chain`` enforces, without
    building any band: level l detaches iff plo(μ_l) ≥ l − carry(l),
    and the gap plo(μ_l) − l is monotone decreasing in l for λα < 1
    and convex otherwise, so checking the endpoints l = 1 and
    l = min(b_max, K) covers every level — O(cells), K-free."""
    bad = np.zeros(len(lams), dtype=bool)
    for l_end in (np.ones_like(b_maxes), np.minimum(b_maxes, K)):
        mu = lams * (alphas * l_end + tau0s)
        plo, _ = _poisson_window(mu)
        bad |= plo >= l_end
    if np.any(bad):
        i = int(np.argmax(bad))
        lim = b_maxes[i] / (alphas[i] * b_maxes[i] + tau0s[i])
        raise ValueError(
            f"cell {i} (λ={lams[i]:.4g}, b_max={int(b_maxes[i])}, "
            f"{lams[i] / lim:.3f}× its stability limit) is outside "
            "the structured solver's positive-recurrence domain; "
            "use markov.solve(..., method='dense') for it")



def grid_solve(lams, alphas, tau0s, b_maxes, K: int, *,
               cells_per_dispatch: int = 64, method: str = "torch",
               device=None) -> Dict[str, np.ndarray]:
    """Solve every (λ, α, τ0, b_max) cell at truncation K.

    ``method="torch"`` (the default): the float64 level recursion over
    ``cells_per_dispatch`` cells at a time on ``device`` (CUDA unless
    ``device="cpu"``); the chunk bounds memory through the per-level
    frozen-column stack of K × (V − 1) × cells float64.  All cells share
    one (K, V, D), so a cell's result does not depend on its chunk.
    ``method="numpy"``: the banded CPU solver per cell — same chain,
    same answers, the reference's host loop.

    Returns a dict of per-cell metric arrays (float64), including the
    ``tail_mass`` witness the adaptive-K loop in ``markov.solve_grid``
    checks."""
    if method not in ("torch", "numpy"):
        raise ValueError(f"unknown grid method {method!r}")
    lams = np.asarray(lams, dtype=np.float64).reshape(-1)
    alphas = np.asarray(alphas, dtype=np.float64).reshape(-1)
    tau0s = np.asarray(tau0s, dtype=np.float64).reshape(-1)
    b_maxes = np.asarray(b_maxes, dtype=np.int64).reshape(-1)
    if np.any(b_maxes < 1):
        raise ValueError("grid_solve needs finite b_max >= 1 per cell")
    _check_grid_domain(lams, alphas, tau0s, b_maxes, K)
    n = len(lams)
    keys = ("mean_latency", "mean_batch", "batch_m2", "utilization",
            "mean_queue", "pi0", "tail_mass")
    out = {k: np.empty(n) for k in keys}

    if method == "numpy":
        for i in range(n):
            model = LinearServiceModel(float(alphas[i]), float(tau0s[i]))
            ch = build_chain(float(lams[i]), model, float(b_maxes[i]), K)
            m = chain_metrics(float(lams[i]), solve_pi(ch), ch.t_of,
                              ch.b_of)
            for k in keys:
                out[k][i] = m[k]
        return out

    from repro_torch.core.sweep import resolve_device
    dev = resolve_device(device)
    V, D = _grid_shapes(lams, alphas, tau0s, b_maxes, K)
    cumlogfact = torch.as_tensor(np.concatenate(
        [[0.0], np.cumsum(np.log(np.arange(1, K + V + 2,
                                           dtype=np.float64)))]),
        dtype=torch.float64, device=dev)
    chunk = max(1, min(int(cells_per_dispatch), n))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)

        def cells(a, dt):
            return torch.as_tensor(a[lo:hi], dtype=dt, device=dev)

        res = _grid_chunk(cells(lams, torch.float64),
                          cells(alphas, torch.float64),
                          cells(tau0s, torch.float64),
                          cells(b_maxes, torch.int64), K, V, D, cumlogfact)
        for k in keys:
            if res[k].dtype != torch.float64:
                raise RuntimeError(f"grid_solve: {k} left float64 "
                                   f"({res[k].dtype})")
            out[k][lo:hi] = res[k].cpu().numpy()
    return out
