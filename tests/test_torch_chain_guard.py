"""The port's banded chain solve on the two cells where the reference's
breaks down (ROADMAP C-R2).

``examples/exact_surface.py``'s grid (24 load fractions from 0.10 to
0.95 of the stability limit × b_max 1…128, V100's α and τ0) at
truncation K 512: cells 190 and 191 are b_max 128 at 0.913 and 0.95.
There π_0 is ~1e-15 and ~1e-17, the solve anchored at π_0 = 1 returns
a negative x, and the reference's clip leaves π = (1, 0, …, 0): an
E[W] below the service time α + τ0.  The port falls back to the GTH
recursion there.  The reference keeps its answer, and the test records
that it still does, so the divergence stays visible.
"""
import numpy as np
import pytest

from repro.core import chain_solver as ref_cs
from repro.core.analytic import LinearServiceModel as RefModel
from repro_torch.core import chain_solver as pt_cs
from repro_torch.core import markov as pt_markov
from repro_torch.core.analytic import LinearServiceModel
from repro_torch.core.grid import MarkovGrid

ALPHA, TAU0 = 0.1438, 1.8874
B_MAXES = (1, 2, 4, 8, 16, 32, 64, 128)
K = 512


def _cell(i):
    grid = MarkovGrid.from_fracs(np.linspace(0.10, 0.95, 24), ALPHA, TAU0,
                                 b_maxes=B_MAXES)
    return float(grid.lam[i]), float(grid.b_max[i])


@pytest.mark.parametrize("cell", [190, 191])
def test_banded_solve_equals_gth_where_the_reference_breaks(cell):
    lam, b_max = _cell(cell)
    assert b_max == 128
    model = LinearServiceModel(ALPHA, TAU0)
    ch = pt_cs.build_chain(lam, model, b_max, K)
    gth = pt_cs.solve_pi_gth(ch)
    want = pt_cs.chain_metrics(lam, gth, ch.t_of, ch.b_of)
    band = pt_cs.solve_pi_banded(ch)
    np.testing.assert_allclose(band, gth, rtol=1e-10, atol=0.0)
    got = pt_cs.chain_metrics(lam, band, ch.t_of, ch.b_of)
    solved = pt_markov.solve(lam, model, b_max=b_max, truncation=K)
    for f in ("mean_latency", "utilization", "mean_batch"):
        assert got[f] == pytest.approx(want[f], rel=1e-10), f
        assert getattr(solved, f) == pytest.approx(want[f], rel=1e-10), f
    # above the service time of a full batch, as a queue must be
    assert want["mean_latency"] > ALPHA + TAU0

    # the reference's own banded solve still returns π = (1, 0, …, 0)
    rch = ref_cs.build_chain(lam, RefModel(ALPHA, TAU0), b_max, K)
    rpi = ref_cs.solve_pi_banded(rch)
    ref = ref_cs.chain_metrics(lam, rpi, rch.t_of, rch.b_of)
    assert ref["mean_latency"] < ALPHA + TAU0
    assert rpi[0] == 1.0 and not rpi[1:].any()


def test_guard_keeps_well_conditioned_cells_bitwise():
    """Cell 189 (0.876 of the limit, π_0 ~7e-14) and a light cell still
    take the banded solve, bit for bit the reference's."""
    for cell in (189, 100):
        lam, b_max = _cell(cell)
        ch = pt_cs.build_chain(lam, LinearServiceModel(ALPHA, TAU0), b_max,
                               K)
        rch = ref_cs.build_chain(lam, RefModel(ALPHA, TAU0), b_max, K)
        assert np.array_equal(pt_cs.solve_pi_banded(ch),
                              ref_cs.solve_pi_banded(rch))
