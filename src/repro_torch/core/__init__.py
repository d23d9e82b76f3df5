"""The port's queueing core: the paper's closed forms, the grid and
result records, and the PyTorch Monte Carlo sweep behind
``evaluate(grid, backend="sweep")``."""
from repro_torch.core.analytic import (  # noqa: F401
    LinearServiceModel,
    is_stable,
    mean_batch_lower,
    mu_b,
    phi,
    phi0,
    phi1,
    pi0_lower,
    rho,
    stability_limit,
    utilization_upper,
)
from repro_torch.core.energy import (  # noqa: F401
    LinearEnergyModel,
    eta_given_EB,
    eta_lower,
)
from repro_torch.core.evaluate import evaluate  # noqa: F401
from repro_torch.core.grid import SweepGrid, SweepResult  # noqa: F401
from repro_torch.core.results import SimResult  # noqa: F401
from repro_torch.core.sweep import sweep, sweep_caps  # noqa: F401
