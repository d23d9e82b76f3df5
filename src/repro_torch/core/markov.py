"""Numerical baseline for the batching queue — the port's copy.

Own copy of the reference package's ``repro.core.markov``: the port
imports nothing of ``repro``, not even this module, which loads no JAX.
It is the ``"markov"`` backend of ``repro_torch.core.evaluate`` and the
port's exact oracle on the card, the failure chain (``solve(mtbf=,
mttr=)``) included.  The code is the reference's, except
``solve_grid``: its default method is the float64 torch grid solver
(``chain_solver.grid_solve(method="torch")``) on the card, in place of
the reference's JAX kernel, and it takes ``device``; ``method="numpy"``
is the reference's host loop.

The reference module's description follows.

Numerical (matrix-analytic style) baseline for the batching queue.

The paper notes that with finite maximum batch size b_max, the system is a
GI/G/1-type Markov chain that can be solved numerically ([20, §4.2]); with
b_max = ∞ only the closed-form bound is available. This module implements
the truncated-chain numerical solution for *deterministic linear* service
times (the §3.3/§4 setting) and serves as the exact reference the
closed-form φ is validated against (paper Fig. 4, Fig. 8).

Embedded chain: L_n = number of waiting jobs at the n-th service completion,
truncated at K. Transition from l:
  l = 0 : idle Exp(λ); then a batch of 1 starts; L' ~ Poisson(λ·τ[1])
  l > 0 : batch b = min(l, b_max) starts; L' = (l−b) + Poisson(λ·τ[b])
E[W] follows by Markov-regenerative renewal reward + Little's law.

Solver methods (``method=`` on ``solve``/``solve_batch``):

- ``"auto"`` (default) — the structured banded solver for finite b_max,
  the dense reference for b_max = ∞ (whose rows have no repeating band;
  its adaptive truncation stays small because the ∞-chain's queue is
  short).
- ``"struct"`` / ``"gth"`` — the banded level recursion of
  ``repro_torch.core.chain_solver``: for finite b_max every level above b_max
  has the identical shifted-Poisson row (an M/G/1-type chain with a
  repeating Toeplitz band), so π is computed level-by-level on a
  (K+1)×(V+1) band — O(K·V²) work and O(K·V) memory, no K×K matrix
  ever materialized.  "struct" uses the LAPACK banded solve when SciPy
  is present; "gth" forces the pure-NumPy censored-chain recursion.
- ``"dense"`` — the legacy dense LU at O(K³)/O(K²), kept as the
  cross-check the structured solver is pinned against (≤1e-10 on E[W])
  and as the fallback outside the structured solver's
  positive-recurrence domain.

The dense transition matrix is built as one vectorized
shifted-Poisson-row construction (row l is the Poisson(λ·τ[b(l)]) pmf
shifted right by the carry l−b(l), tail mass absorbed in the truncation
cell — no Python row loop), and the truncation K is chosen
*adaptively*: start small, solve, and double K until the stationary
mass at the truncation cell falls under ``tail_tol``.  The truncation
cell absorbs the entire tail of every row, so ``tail_mass = π[K]`` is a
direct a-posteriori error witness for *both* solvers — empirically it
tracks the relative error of E[W] to within an order of magnitude.

Truncation guards are per-method: the structured path is O(K·V) in
memory, so its adaptive cap ``_TRUNC_CAP_STRUCT`` (65536) and hard
guard sit far above the dense ones — the 0.5 GB dense matrix at
K = 8192 is no longer the binding constraint, it only binds
``method="dense"`` (``_TRUNC_CAP_DENSE``/``_TRUNC_HARD_DENSE``, where
an explicit truncation beyond the hard cap still raises rather than
silently allocating gigabytes).

``solve_batch`` runs a λ grid through the same machinery sharing the
per-model structure and warm-starting each λ's truncation from the
previous one's converged K, so a sorted sweep skips the grow-and-retry
solves entirely.  ``solve_grid`` takes a ``MarkovGrid`` of
(λ, α, τ0, b_max) cells and solves the whole grid through the
structured solver (``repro_torch.core.chain_solver.grid_solve``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core import chain_solver
from repro_torch.core.analytic import LinearServiceModel
from repro_torch.core.grid import MarkovGrid, MarkovGridResult

__all__ = ["MarkovResult", "MarkovLossResult", "solve", "solve_batch",
           "solve_grid", "solve_loss", "poisson_pmf_row",
           "completion_moments"]

_TRUNC_START = 256           # adaptive growth starts here
_TRUNC_CAP_DENSE = 8192      # dense adaptive growth stops here (0.5 GB)
_TRUNC_HARD_DENSE = 16384    # explicit dense truncation beyond this raises
_TRUNC_CAP_STRUCT = 65536    # structured adaptive cap (O(K·V) memory)
_TRUNC_HARD_STRUCT = 1 << 20  # explicit structured truncation guard
_TAIL_TOL = 1e-10            # stationary mass allowed at the truncation

# back-compat aliases (pre-structured names; dense semantics)
_TRUNC_CAP = _TRUNC_CAP_DENSE
_TRUNC_HARD = _TRUNC_HARD_DENSE

_STRUCT_METHODS = ("struct", "gth")


def poisson_pmf_row(mean: float, kmax: int) -> np.ndarray:
    """Poisson pmf p_0..p_kmax (log-space, final cell absorbs the tail)."""
    if mean <= 0:
        row = np.zeros(kmax + 1)
        row[0] = 1.0
        return row
    ks = np.arange(1, kmax + 1, dtype=float)
    logp = np.concatenate([[0.0], np.cumsum(np.log(mean / ks))]) - mean
    p = np.exp(logp)
    tail = max(0.0, 1.0 - p.sum())
    p[-1] += tail
    return p


@dataclass
class MarkovResult:
    lam: float
    mean_latency: float
    mean_batch: float
    batch_m2: float
    utilization: float
    mean_queue: float                # time-average jobs in system E[L]
    pi: np.ndarray                   # stationary dist of waiting count L_n
    truncation: int
    tail_mass: float                 # stationary mass at the truncation cell
    method: str = "dense"            # solver that produced this result
    # breakdown/repair regime only (mtbf set on ``solve``): fraction of
    # time NOT spent in repair, and re-executed work as a fraction of
    # all work performed — both match the MC kernels' definitions
    availability: float = 1.0
    work_loss_frac: float = 0.0


# above this truncation the cached λ-independent log-pmf core —
# a dense (K+1)² array — is not worth its memory; rebuild per λ instead
_CORE_CACHE_MAX = 2048


class _ChainStructure:
    """Per-(model, b_max) arrays shared by every truncation and λ:
    the batch-size ladder b(l), its service times τ[b(l)], the
    log-factorial table, and (lazily) the λ-independent part of the
    log-Poisson-pmf matrix  core[l, j] = j·log τ[b(l)] − log j!  —
    per λ the full log-pmf is just core + j·log λ − λ·τ[b(l)], two
    broadcast adds instead of an outer product, which is the bulk of
    what ``solve_batch`` shares across a λ grid on the dense path."""

    def __init__(self, model: LinearServiceModel, b_max: float, kmax: int):
        self.model, self.b_max, self.kmax = model, b_max, kmax
        ls = np.arange(kmax + 1)
        self.b_of = np.minimum(np.maximum(ls, 1),
                               b_max if not math.isinf(b_max)
                               else kmax + 1).astype(int)
        self.t_of = model.tau(self.b_of)
        self.carry = np.maximum(0, ls - self.b_of)
        self.cumlogfact = np.concatenate(
            [[0.0], np.cumsum(np.log(ls[1:].astype(float)))])
        self._core: Optional[np.ndarray] = None

    def log_core(self, K: int) -> Optional[np.ndarray]:
        if self.kmax > _CORE_CACHE_MAX:
            return None
        if self._core is None:
            j = np.arange(self.kmax + 1)
            self._core = (j[None, :] * np.log(self.t_of)[:, None]
                          - self.cumlogfact[None, :])
        return self._core[:K + 1, :K + 1]

    def grow(self, kmax: int) -> "_ChainStructure":
        if kmax <= self.kmax:
            return self
        return _ChainStructure(self.model, self.b_max, kmax)


def _transition_matrix(lam: float, s: _ChainStructure, K: int, *,
                       use_core: bool = False) -> np.ndarray:
    """All K+1 shifted-Poisson rows in one vectorized construction.

    ``use_core`` amortizes the λ-independent log-pmf core across calls
    that share ``s`` (the ``solve_batch`` path); a one-shot ``solve``
    would pay to build a cache it immediately discards, so it uses the
    direct construction."""
    means = lam * s.t_of[:K + 1]                       # (K+1,) all > 0
    carry = s.carry[:K + 1]
    width = K - carry                                  # last valid offset
    j = np.arange(K + 1)
    core = s.log_core(K) if use_core else None
    if core is not None:
        logp = core + math.log(lam) * j[None, :] - means[:, None]
    else:
        logp = (j[None, :] * np.log(means)[:, None]
                - s.cumlogfact[None, :K + 1] - means[:, None])
    p = np.exp(logp, out=logp)                         # in-place
    p[j[None, :] > width[:, None]] = 0.0
    rows = np.arange(K + 1)
    p[rows, width] += np.maximum(0.0, 1.0 - p.sum(axis=1))
    if carry[-1] == 0:                                 # b_max = ∞: no shift
        return p
    # shifted rows: scatter in row blocks so the index/mask temporaries
    # stay O(block·K) rather than a second dense (K+1)² array
    P = np.zeros((K + 1, K + 1))
    block = max(1, (1 << 22) // (K + 1))
    for lo in range(0, K + 1, block):
        hi = min(lo + block, K + 1)
        cols = (carry[lo:hi, None] + j[None, :]).astype(np.int32)
        valid = j[None, :] <= width[lo:hi, None]
        P[np.broadcast_to(rows[lo:hi, None], cols.shape)[valid],
          cols[valid]] = p[lo:hi][valid]
    return P


def _result_from_pi(lam: float, pi: np.ndarray, t_of: np.ndarray,
                    b_of: np.ndarray, K: int, method: str) -> MarkovResult:
    m = chain_solver.chain_metrics(lam, pi, t_of, b_of)
    return MarkovResult(
        lam=lam, mean_latency=m["mean_latency"],
        mean_batch=m["mean_batch"], batch_m2=m["batch_m2"],
        utilization=m["utilization"], mean_queue=m["mean_queue"],
        pi=pi, truncation=K, tail_mass=m["tail_mass"], method=method)


def _solve_at(lam: float, s: _ChainStructure, K: int, *,
              use_core: bool = False) -> MarkovResult:
    """One dense truncated solve at a fixed K (the legacy solver)."""
    P = _transition_matrix(lam, s, K, use_core=use_core)
    # stationary distribution: solve pi (P - I) = 0, sum(pi) = 1
    A = (P - np.eye(K + 1)).T
    A[-1, :] = 1.0
    rhs = np.zeros(K + 1)
    rhs[-1] = 1.0
    pi = np.linalg.solve(A, rhs)
    pi = np.clip(pi, 0.0, None)
    pi /= pi.sum()
    return _result_from_pi(lam, pi, s.t_of[:K + 1], s.b_of[:K + 1], K,
                           "dense")


def _solve_struct_at(lam: float, model: LinearServiceModel, b_max: float,
                     K: int, method: str) -> MarkovResult:
    ch = chain_solver.build_chain(lam, model, b_max, K)
    pi = chain_solver.solve_pi(
        ch, method="gth" if method == "gth" else "band")
    return _result_from_pi(lam, pi, ch.t_of, ch.b_of, K, method)


def _resolve_method(method: str, b_max: float) -> str:
    if method == "auto":
        return "dense" if math.isinf(b_max) else "struct"
    if method in _STRUCT_METHODS or method == "dense":
        return method
    raise ValueError(f"unknown method {method!r}; pick from "
                     f"('auto', 'struct', 'gth', 'dense')")


def _check_truncation(truncation: int, method: str) -> None:
    if method == "dense":
        if truncation > _TRUNC_HARD_DENSE:
            raise ValueError(
                f"truncation {truncation} would allocate a "
                f"{(truncation + 1) ** 2 * 8 / 1e9:.1f} GB dense chain; "
                f"the dense hard cap is {_TRUNC_HARD_DENSE} — use the "
                "structured solver (method='struct', O(K·V) memory) for "
                "deeper truncations")
    elif truncation > _TRUNC_HARD_STRUCT:
        raise ValueError(
            f"truncation {truncation} exceeds the structured guard "
            f"{_TRUNC_HARD_STRUCT}")


def _start_truncation(lam: float, model: LinearServiceModel,
                      b_max: float) -> int:
    """Initial K for the adaptive growth — a light-weight version of the
    old closed-form estimate (the growth loop makes over-shooting
    pointless, so this only needs the right order of magnitude)."""
    rho = lam * model.alpha
    eb_est = max(1.0, lam * model.tau0 / max(1e-9, 1.0 - rho))
    if not math.isinf(b_max):
        eb_est = min(eb_est, float(b_max) * 4 + lam * model.tau0)
    k = int(32 + 4 * eb_est)
    return min(max(k, _TRUNC_START), _TRUNC_CAP_DENSE)


def _adaptive_cap(method: str) -> int:
    return _TRUNC_CAP_DENSE if method == "dense" else _TRUNC_CAP_STRUCT


def solve(lam: float, model: LinearServiceModel, *,
          b_max: float = math.inf, truncation: int = 0,
          tail_tol: float = _TAIL_TOL, method: str = "auto",
          mtbf: Optional[float] = None, mttr: Optional[float] = None,
          fail_disc: str = "resume") -> MarkovResult:
    """Solve the embedded chain and return exact (up to truncation)
    metrics.

    With ``truncation=0`` (default) the truncation level grows
    adaptively — doubling from a small start until the stationary mass
    at the truncation cell is below ``tail_tol`` (or the method's cap
    is reached; the returned ``tail_mass`` always reports the achieved
    level).  An explicit ``truncation`` is used as-is.  See the module
    docstring for ``method``; with the default "auto", finite-b_max
    cells outside the structured solver's positive-recurrence domain
    fall back to the dense reference transparently.

    ``mtbf``/``mttr``/``fail_disc`` switch on the breakdown/repair
    completion-time transform (see the module section above
    ``completion_moments``): service times become completion times with
    exponential failures-while-serving and Exp(mttr) repairs, under
    preempt-``"resume"`` or preempt-``"restart"``.  ``mtbf`` unset or
    ≤ 0 is the failure-free chain, bitwise identical to the base
    solve.  The failure chain keeps the banded structure, so it always
    runs the structured solver ("gth" forces the pure-NumPy recursion);
    it needs a finite ``b_max``, and ``fail_disc="drop"`` has no chain
    (its reference is the ``loss_ref`` mirror)."""
    if lam <= 0:
        raise ValueError("lam must be > 0")
    if mtbf is not None and mtbf > 0:
        return _solve_failure(
            lam, model, b_max=b_max, truncation=truncation,
            tail_tol=tail_tol, method=method, mtbf=float(mtbf),
            mttr=float(mttr) if mttr is not None else 0.0,
            fail_disc=fail_disc)
    auto = method == "auto"
    method = _resolve_method(method, b_max)

    def solve_at(K: int) -> MarkovResult:
        if method == "dense":
            return _solve_at(lam, _ChainStructure(model, b_max, K), K)
        return _solve_struct_at(lam, model, b_max, K, method)

    if truncation:
        _check_truncation(truncation, method)
        try:
            return solve_at(truncation)
        except ValueError:
            if not (auto and method in _STRUCT_METHODS):
                raise
            method = "dense"
            _check_truncation(truncation, method)
            return solve_at(truncation)
    K = _start_truncation(lam, model, b_max)
    while True:
        try:
            res = solve_at(K)
        except ValueError:
            if not (auto and method in _STRUCT_METHODS):
                raise
            method = "dense"          # outside the structured domain
            continue
        if res.tail_mass <= tail_tol or K >= _adaptive_cap(method):
            return res
        K = min(2 * K, _adaptive_cap(method))


# ---------------------------------------------------------------------------
# Breakdown/repair: the completion-time transform
# ---------------------------------------------------------------------------
#
# With an exponential MTBF clock (rate ξ = 1/MTBF, ticking only while
# the server executes) and Exp(MTTR) repairs, the *service time* τ[b]
# of a batch becomes a *completion time* C_b — wall-clock from batch
# start to batch finish, repairs included.  The embedded chain is
# otherwise unchanged: L' = carry(l) + (arrivals during C_{b(l)}), and
# since C_b depends on the state only through b(l), every level above
# b_max keeps the identical row — the banded M/G/1-type structure of
# ``chain_solver`` survives the transform verbatim; only the row pmf
# (arrival *count* during C_b instead of during τ[b]) and the
# renewal-reward layer (E[C], E[C²] instead of τ, τ²) change.
#
#   preempt-resume  : C = s + Σ_{i≤M} R_i,  M ~ Poisson(ξs), R ~ Exp(r)
#       E[C] = s(1 + ξr),   Var C = 2ξs r²
#       count pmf = Poisson(λs) ⊛ CompoundPoisson(μ = ξs, geometric
#       per-repair arrival jumps), the compound part by Panjer's
#       recursion (its f_0 > 0 case).
#   preempt-restart : C = Σ_{i≤G}(U_i + R_i) + s,  G ~ Geom(q = e^{−ξs})
#       failures U ~ Exp(ξ) | U < s; the batch re-executes from scratch
#       E[C] = (1/ξ + r)(e^{ξs} − 1) + s·... (see completion_moments)
#       count pmf = CompoundGeometric(arrivals per failed attempt) ⊛
#       Poisson(λs), the compound-geometric by its defective renewal
#       recursion.
#
# fail-drop has no single-server transform here (the aborted batch
# leaves through the loss/retry accounting, coupling the chain to the
# orbit) — its exact reference is the chronological numpy mirror in
# ``repro_torch.core.loss_ref``.

_PMF_TOL = 1e-12            # completion-count pmf tail mass kept
_PMF_CAP = 1 << 16          # hard length cap on one pmf row


def completion_moments(s, mtbf: float, mttr: float, *,
                       restart: bool = False):
    """First two moments (E[C], E[C²]) of the completion time of a
    batch whose failure-free execution takes ``s`` (scalar or array),
    under Exp(1/mtbf) failures-while-serving and Exp(mttr) repairs.
    ``restart=False`` is preempt-resume, ``True`` preempt-restart;
    ``mtbf <= 0`` disables failures (C ≡ s)."""
    s = np.asarray(s, dtype=float)
    if mtbf is None or mtbf <= 0:
        return s + 0.0, s * s
    ec, ec2, _, _ = _completion_stats(s, 1.0 / float(mtbf), float(mttr),
                                      restart)
    return ec, ec2


def _completion_stats(s, xi: float, r: float, restart: bool):
    """(E[C], E[C²], E[repair time per batch], E[lost work per batch])
    — vectorized over the service-time array ``s``."""
    s = np.asarray(s, dtype=float)
    if not restart:
        m = xi * s                                  # E[#failures]
        ec = s * (1.0 + xi * r)
        ec2 = ec * ec + 2.0 * m * r * r             # Var C = m·E[R²]
        return ec, ec2, m * r, np.zeros_like(s)
    q = np.exp(-xi * s)
    omq = np.maximum(-np.expm1(-xi * s), 1e-300)    # 1 − q
    eg = omq / q                                    # E[#failed attempts]
    vg = omq / (q * q)
    # U ~ Exp(ξ) truncated to [0, s]
    eu = 1.0 / xi - s * q / omq
    eu2 = 2.0 / xi ** 2 - (s * s + 2.0 * s / xi) * q / omq
    ex = eu + r                                     # X = U + R per attempt
    vx = (eu2 - eu * eu) + r * r
    es = eg * ex                                    # S = Σ_{i≤G} X_i
    vs = eg * vx + vg * ex * ex
    ec = s + es
    ec2 = ec * ec + vs
    return ec, ec2, eg * r, eg * eu


def _raw_poisson_pmf(mean: float, length: int) -> np.ndarray:
    """Poisson pmf p_0..p_{length-1} with NO tail absorption (internal
    convolution building block; residuals are absorbed once, at the
    band edge)."""
    row = np.zeros(length)
    if mean <= 0:
        row[0] = 1.0
        return row
    ks = np.arange(1, length, dtype=float)
    row[:] = np.exp(np.concatenate(
        [[0.0], np.cumsum(np.log(mean / ks))]) - mean)
    return row


def _completion_count_pmf(lam: float, s: float, xi: float, r: float,
                          restart: bool) -> np.ndarray:
    """pmf of the number of Poisson(λ) arrivals during one completion
    time C (the failure-regime transition row before the carry shift).
    Length adapts until the dropped tail is below ``_PMF_TOL``."""
    ec, ec2, _, _ = _completion_stats(np.asarray(s), xi, r, restart)
    mean_n = lam * float(ec)
    var_n = mean_n + lam * lam * max(float(ec2 - ec * ec), 0.0)
    L = int(math.ceil(mean_n + 12.0 * math.sqrt(max(var_n, 1.0)) + 40.0))
    while True:
        L = min(L, _PMF_CAP)
        p = (_resume_count_pmf(lam, s, xi, r, L) if not restart
             else _restart_count_pmf(lam, s, xi, r, L))
        if 1.0 - p.sum() <= _PMF_TOL or L >= _PMF_CAP:
            return p
        L *= 2


def _resume_count_pmf(lam: float, s: float, xi: float, r: float,
                      L: int) -> np.ndarray:
    # arrivals during one Exp(r) repair: Geom over {0, 1, ...}
    f0 = 1.0 / (1.0 + lam * r)
    ratio = lam * r / (1.0 + lam * r)
    mu = xi * s                                     # failure count mean
    j = np.arange(L, dtype=float)
    jf = j * f0 * ratio ** j                        # j·f_j for Panjer
    g = np.zeros(L)
    g[0] = math.exp(-mu * (1.0 - f0))
    for n in range(1, L):
        g[n] = (mu / n) * float(np.dot(jf[1:n + 1], g[n - 1::-1][:n]))
    return np.convolve(_raw_poisson_pmf(lam * s, L), g)[:L]


def _restart_count_pmf(lam: float, s: float, xi: float, r: float,
                       L: int) -> np.ndarray:
    q = math.exp(-xi * s)
    omq = max(-math.expm1(-xi * s), 1e-300)
    beta = lam + xi
    # arrivals during one failed attempt U ~ Exp(ξ) | U < s:
    #   P(N_U = n) = (ξ/β)(λ/β)^n · P(Gamma(n+1, β) ≤ s) / (1 − q)
    pm = _raw_poisson_pmf(beta * s, L + 1)
    sf = np.concatenate([pm[::-1].cumsum()[::-1][1:], [0.0]])  # P(A > n)
    n = np.arange(L, dtype=float)
    with np.errstate(under="ignore"):
        a = (xi / beta) * np.exp(n * math.log(lam / beta)) \
            * sf[:L] / omq
    rep = (1.0 / (1.0 + lam * r)) \
        * (lam * r / (1.0 + lam * r)) ** n          # repair arrivals
    a1 = np.convolve(a, rep)[:L]                    # one failed attempt
    denom = 1.0 - (1.0 - q) * a1[0]
    B = np.zeros(L)
    B[0] = q / denom
    for k in range(1, L):
        B[k] = (1.0 - q) / denom \
            * float(np.dot(a1[1:k + 1], B[k - 1::-1][:k]))
    return np.convolve(B, _raw_poisson_pmf(lam * s, L))[:L]


def _failure_chain(lam: float, model: LinearServiceModel, b_max: float,
                   K: int, xi: float, r: float, restart: bool,
                   pmfs: List[np.ndarray]) -> chain_solver.BandedChain:
    """Banded chain whose rows are completion-count pmfs.  ``pmfs[b-1]``
    is the count pmf of batch size b (λ-dependent, K-independent — the
    adaptive-truncation loop computes them once)."""
    bcap = int(b_max)
    Lmax = max(len(p) for p in pmfs)
    P = np.zeros((bcap + 1, Lmax))
    los = np.zeros(bcap + 1, dtype=np.int64)
    his = np.zeros(bcap + 1, dtype=np.int64)
    for b, p in enumerate(pmfs, start=1):
        P[b, :len(p)] = p
        cdf = np.cumsum(p)
        los[b] = max(0, int(np.searchsorted(cdf, chain_solver.BAND_TOL))
                     - 1)
        his[b] = min(len(p) - 1,
                     int(np.searchsorted(cdf,
                                         1.0 - chain_solver.BAND_TOL)) + 2)
    ls = np.arange(K + 1)
    b_of = np.minimum(np.maximum(ls, 1), bcap).astype(np.int64)
    t_of = model.tau(b_of)
    carry = np.maximum(0, ls - b_of)
    c = np.minimum(carry + los[b_of], K)
    c = np.minimum(np.maximum.accumulate(c), K)     # keep nondecreasing
    hi = np.minimum(carry + his[b_of], K)
    if np.any(c[1:] >= ls[1:]):
        raise ValueError("detached")                # caller names ρ_eff
    V = int(np.max(hi - c))
    width = np.maximum(hi - c, 0).astype(np.int64)
    j = np.arange(V + 1)
    pidx = (c - carry)[:, None] + j[None, :]
    valid = (j[None, :] <= width[:, None]) & (pidx >= 0) & (pidx < Lmax)
    B = np.where(valid, P[b_of[:, None], np.clip(pidx, 0, Lmax - 1)], 0.0)
    B[ls, width] += np.maximum(0.0, 1.0 - B.sum(axis=1))
    return chain_solver.BandedChain(
        lam=float(lam), b_max=float(b_max), K=K, V=V, B=B, c=c,
        width=width, b_of=b_of, t_of=t_of)


def _failure_metrics(lam: float, pi: np.ndarray, t_of: np.ndarray,
                     b_of: np.ndarray, ec: np.ndarray, ec2: np.ndarray,
                     e_down: np.ndarray, e_lost: np.ndarray) -> dict:
    """``chain_metrics`` with the occupancy integral generalized to the
    random completion time:  ∫ jobs dt over one cycle from level l is
    in_sys·E[C_l] + λ·E[C_l²]/2 (arrivals are independent of C)."""
    K = len(pi) - 1
    ls = np.arange(K + 1)
    idle = np.where(ls == 0, 1.0 / lam, 0.0)
    mean_cycle = float(pi @ (idle + ec))
    in_sys = np.maximum(ls, 1).astype(float)
    e_l = float(pi @ (in_sys * ec + lam * ec2 / 2.0)) / mean_cycle
    util = float(pi @ t_of) / mean_cycle            # productive fraction
    down = float(pi @ e_down) / mean_cycle
    lost = float(pi @ e_lost) / mean_cycle
    bf = b_of.astype(float)
    return {
        "mean_latency": e_l / lam,
        "mean_batch": float(pi @ bf),
        "batch_m2": float(pi @ (bf * bf)),
        "utilization": util,
        "mean_queue": e_l,
        "pi0": float(pi[0]),
        "tail_mass": float(pi[-1]),
        "availability": 1.0 - down,
        "work_loss_frac": lost / (util + lost) if lost > 0.0 else 0.0,
    }


def _solve_failure(lam: float, model: LinearServiceModel, *,
                   b_max: float, truncation: int, tail_tol: float,
                   method: str, mtbf: float, mttr: float,
                   fail_disc: str) -> MarkovResult:
    """Adaptive-truncation solve of the completion-time chain."""
    if math.isinf(b_max):
        raise ValueError("the completion-time chain needs a finite "
                         "b_max (b_max = ∞ has no repeating band and "
                         "the failure MC kernels pin finite caps)")
    if fail_disc == "drop":
        raise ValueError(
            "fail-drop couples the chain to the retry orbit and has no "
            "single-server completion-time transform; use the "
            "chronological numpy mirror (repro_torch.core.loss_ref) as its "
            "reference")
    if fail_disc not in ("resume", "restart"):
        raise ValueError(f"unknown fail_disc {fail_disc!r}; pick from "
                         "('resume', 'restart', 'drop')")
    if mttr is None or mttr <= 0:
        raise ValueError("mttr must be > 0 when mtbf is set")
    restart = fail_disc == "restart"
    xi = 1.0 / mtbf
    bcap = int(b_max)
    taus = model.tau(np.arange(1, bcap + 1))
    ec_b, ec2_b, down_b, lost_b = _completion_stats(taus, xi, mttr,
                                                    restart)
    rho_eff = lam * float(ec_b[-1]) / bcap
    if rho_eff >= 1.0:
        raise ValueError(
            f"failure-inflated load is unstable: rho_eff = "
            f"λ·E[C(τ[b_max])]/b_max = {rho_eff:.4f} >= 1 — "
            f"(MTBF={mtbf:g}, MTTR={mttr:g}, {fail_disc}) inflates the "
            f"τ[{bcap}]={float(taus[-1]):g} batch to "
            f"E[C]={float(ec_b[-1]):g}; lower λ, shorten repairs, or "
            "raise b_max")
    pmfs = [_completion_count_pmf(lam, float(s), xi, mttr, restart)
            for s in taus]
    meth = "gth" if method == "gth" else "band"

    def solve_at(K: int) -> MarkovResult:
        try:
            ch = _failure_chain(lam, model, b_max, K, xi, mttr, restart,
                                pmfs)
        except ValueError:
            raise ValueError(
                "banded completion-time chain detached from the "
                f"diagonal: rho_eff = λ·E[C(τ[b_max])]/b_max = "
                f"{rho_eff:.4f} under (MTBF={mtbf:g}, MTTR={mttr:g}, "
                f"{fail_disc}) sits at the positive-recurrence "
                "boundary; lower λ or the repair load") from None
        pi = chain_solver.solve_pi(ch, method=meth)
        m = _failure_metrics(lam, pi, ch.t_of, ch.b_of,
                             ec_b[ch.b_of - 1], ec2_b[ch.b_of - 1],
                             down_b[ch.b_of - 1], lost_b[ch.b_of - 1])
        return MarkovResult(
            lam=lam, mean_latency=m["mean_latency"],
            mean_batch=m["mean_batch"], batch_m2=m["batch_m2"],
            utilization=m["utilization"], mean_queue=m["mean_queue"],
            pi=pi, truncation=K, tail_mass=m["tail_mass"], method=meth,
            availability=m["availability"],
            work_loss_frac=m["work_loss_frac"])

    if truncation:
        _check_truncation(truncation, "struct")
        return solve_at(truncation)
    K = _start_truncation(lam, model, b_max)
    K = min(max(K, int(32 + 8 * lam * float(ec_b[-1])
                       / max(1e-9, 1.0 - rho_eff))), _TRUNC_CAP_STRUCT)
    while True:
        res = solve_at(K)
        if res.tail_mass <= tail_tol or K >= _TRUNC_CAP_STRUCT:
            return res
        K = min(2 * K, _TRUNC_CAP_STRUCT)


@dataclass
class MarkovLossResult:
    """Exact metrics of the finite-waiting-room M/D[b]/1/q_max chain
    under reject-at-arrival admission (the "429" overflow mode)."""

    lam: float
    q_max: int
    mean_latency: float              # E[W] of *admitted* jobs (Little)
    mean_batch: float
    batch_m2: float
    utilization: float
    mean_queue: float                # time-average jobs in system
    loss_frac: float                 # P(arrival finds the room full)
    goodput: float                   # λ·(1 − loss_frac)
    pi: np.ndarray                   # stationary dist over 0..q_max
    method: str = "band"


def solve_loss(lam: float, model: LinearServiceModel, *,
               q_max: int, b_max: float = math.inf,
               method: str = "auto") -> MarkovLossResult:
    """Solve the finite-waiting-room chain exactly — no truncation
    error at all, because the waiting room IS the state space.

    The embedded chain of the q_max-room system under reject admission
    coincides with the K = q_max *truncated* chain: lumping each row's
    tail at state K is exactly "the room filled and later arrivals were
    rejected".  So the banded machinery of ``repro_torch.core.chain_solver``
    applies verbatim — only the renewal-reward layer changes
    (``chain_loss_metrics``: loss fraction from the per-cycle expected
    excess, occupancy integral clipped at the room, Little's law over
    admitted jobs).  Unlike the infinite-room chain this one is
    positive recurrent at ANY load — ρ > 1 is a perfectly good regime
    (that is what admission control is for) — but the *banded* path
    inherits ``build_chain``'s diagonal-attachment domain, so
    ``method="auto"`` (default) takes the band and falls back to the
    dense LU transparently; "band"/"gth"/"dense" force a path."""
    if lam <= 0:
        raise ValueError("lam must be > 0")
    if q_max < 1:
        raise ValueError("q_max must be >= 1 (use the lossless solve "
                         "for an infinite room)")
    if not math.isinf(b_max) and b_max < 1:
        raise ValueError("b_max must be >= 1")
    if method not in ("auto", "band", "gth", "dense"):
        raise ValueError(f"unknown method {method!r}; pick from "
                         f"('auto', 'band', 'gth', 'dense')")
    K = int(q_max)
    _check_truncation(K, "dense" if method == "dense" else "struct")

    resolved = method
    if method == "dense":
        pi = None
    else:
        try:
            ch = chain_solver.build_chain(lam, model, b_max, K)
            pi = chain_solver.solve_pi(
                ch, method="gth" if method == "gth" else "band")
            resolved = "gth" if method == "gth" else "band"
        except ValueError:
            if method != "auto":
                raise
            pi = None
    if pi is None:
        s = _ChainStructure(model, b_max, K)
        P = _transition_matrix(lam, s, K)
        A = (P - np.eye(K + 1)).T
        A[-1, :] = 1.0
        rhs = np.zeros(K + 1)
        rhs[-1] = 1.0
        pi = np.clip(np.linalg.solve(A, rhs), 0.0, None)
        pi /= pi.sum()
        t_of, b_of = s.t_of[:K + 1], s.b_of[:K + 1]
        resolved = "dense"
    else:
        t_of, b_of = ch.t_of, ch.b_of
    m = chain_solver.chain_loss_metrics(lam, pi, t_of, b_of, K)
    return MarkovLossResult(
        lam=lam, q_max=K, mean_latency=m["mean_latency"],
        mean_batch=m["mean_batch"], batch_m2=m["batch_m2"],
        utilization=m["utilization"], mean_queue=m["mean_queue"],
        loss_frac=m["loss_frac"], goodput=m["goodput"], pi=pi,
        method=resolved)


def solve_batch(lams: Sequence[float], model: LinearServiceModel, *,
                b_max: float = math.inf, truncation: int = 0,
                tail_tol: float = _TAIL_TOL, method: str = "auto"
                ) -> List[MarkovResult]:
    """Solve the chain for every λ in one pass, reusing the shared
    per-model structure and warm-starting each λ's truncation level.

    λs are processed in ascending order (results return in input
    order): the converged K of the previous λ seeds the next one, so
    the grow-and-retry solves that dominate a cold ``solve`` at high
    load happen at most once per grid instead of once per point."""
    lams = list(lams)
    if not lams:
        return []
    if any(lam <= 0 for lam in lams):
        raise ValueError("every lam must be > 0")
    auto = method == "auto"
    resolved = _resolve_method(method, b_max)
    s: Optional[_ChainStructure] = None     # dense structure, lazy/shared

    def solve_at(lam: float, K: int, meth: str) -> MarkovResult:
        nonlocal s
        if meth == "dense":
            s = _ChainStructure(model, b_max, K) if s is None \
                else s.grow(K)
            return _solve_at(lam, s, K, use_core=True)
        return _solve_struct_at(lam, model, b_max, K, meth)

    if truncation:
        _check_truncation(truncation, resolved)
        out: List[Optional[MarkovResult]] = []
        for lam in lams:
            try:
                out.append(solve_at(float(lam), truncation, resolved))
            except ValueError:
                if not (auto and resolved in _STRUCT_METHODS):
                    raise
                _check_truncation(truncation, "dense")
                out.append(solve_at(float(lam), truncation, "dense"))
        return out       # type: ignore[return-value]
    order = np.argsort(lams)
    out = [None] * len(lams)
    warm = 0
    for i in order:
        lam = float(lams[i])
        meth = resolved
        K = max(warm, _start_truncation(lam, model, b_max))
        K = min(K, _adaptive_cap(meth))
        while True:
            try:
                res = solve_at(lam, K, meth)
            except ValueError:
                if not (auto and meth in _STRUCT_METHODS):
                    raise
                meth = "dense"       # outside the structured domain
                K = min(K, _adaptive_cap(meth))
                continue
            if res.tail_mass <= tail_tol or K >= _adaptive_cap(meth):
                break
            K = min(2 * K, _adaptive_cap(meth))
        warm = max(warm, res.truncation)
        out[i] = res
    return out       # type: ignore[return-value]


def solve_grid(grid: MarkovGrid, *, tail_tol: float = _TAIL_TOL,
               truncation: int = 0, method: str = "torch",
               cells_per_dispatch: int = 64,
               device=None) -> MarkovGridResult:
    """Exact-chain metrics for a whole (λ, α, τ0, b_max) grid through
    the structured solver.

    ``method="torch"`` (the default) runs every cell through the batched
    float64 level recursion on ``device`` — CUDA unless ``device="cpu"``
    — ``cells_per_dispatch`` cells at a time; ``method="numpy"`` loops
    the banded CPU solver — same chain, same answers.  All cells share
    one truncation level K, grown adaptively (doubling) until every
    cell's ``tail_mass`` witness clears ``tail_tol``; an explicit
    ``truncation`` is used as-is."""
    if not isinstance(grid, MarkovGrid):
        raise TypeError("solve_grid takes a MarkovGrid (use "
                        "MarkovGrid.from_product/from_fracs)")
    if truncation:
        _check_truncation(truncation, "struct")
        K = truncation
    else:
        K = max(_start_truncation(float(grid.lam[i]),
                                  LinearServiceModel(float(grid.alpha[i]),
                                                     float(grid.tau0[i])),
                                  float(grid.b_max[i]))
                for i in range(len(grid)))
        K = 1 << max(8, (K - 1).bit_length())        # pow2 bucket
    while True:
        out = chain_solver.grid_solve(
            grid.lam, grid.alpha, grid.tau0, grid.b_max, K,
            cells_per_dispatch=cells_per_dispatch, method=method,
            device=device)
        if truncation or float(out["tail_mass"].max()) <= tail_tol \
                or K >= _TRUNC_CAP_STRUCT:
            break
        K = min(2 * K, _TRUNC_CAP_STRUCT)
    return MarkovGridResult(
        grid=grid, mean_latency=out["mean_latency"],
        mean_batch=out["mean_batch"], batch_m2=out["batch_m2"],
        utilization=out["utilization"], mean_queue=out["mean_queue"],
        pi0=out["pi0"], tail_mass=out["tail_mass"], truncation=K,
        method=method)
