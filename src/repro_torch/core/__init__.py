"""The port's queueing core: the paper's closed forms, the grid and
result records, the PyTorch Monte Carlo sweep behind
``evaluate(grid, backend="sweep")`` and the token-level generate sweep
behind ``evaluate(grid, backend="gen")``."""
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
from repro_torch.core.continuous_sim import (  # noqa: F401
    ContinuousResult,
    GenServiceModel,
    simulate_continuous,
    simulate_static_generate,
)
from repro_torch.core.evaluate import evaluate  # noqa: F401
from repro_torch.core.gen_sweep import gen_caps, gen_sweep  # noqa: F401
from repro_torch.core.grid import (  # noqa: F401
    DISC_CODE,
    DISC_NAME,
    GenGrid,
    GenResult,
    SweepGrid,
    SweepResult,
)
from repro_torch.core.results import SimResult  # noqa: F401
from repro_torch.core.sweep import sweep, sweep_caps  # noqa: F401
