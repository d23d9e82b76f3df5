"""The port's queueing core: the paper's closed forms, the grid and
result records, the PyTorch Monte Carlo sweep behind
``evaluate(grid, backend="sweep")``, the k-replica fleet sweep behind
``evaluate(grid, backend="fleet")``, the token-level generate sweep
behind ``evaluate(grid, backend="gen")``, the exact references they are
held against (the event simulator and the truncated-chain numerics,
``"sim"`` and ``"markov"``), the planner, and the batching policies
and linear-fit calibration of the serving engine."""
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
from repro_torch.core.calibrate import (  # noqa: F401
    LinearFit,
    fit_linear,
    fit_service_model,
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
    FleetGrid,
    FleetResult,
    GenGrid,
    GenResult,
    MarkovGrid,
    MarkovGridResult,
    ROUTE_CODE,
    SweepGrid,
    SweepResult,
)
from repro_torch.core.markov import solve as solve_markov  # noqa: F401
from repro_torch.core.markov import (  # noqa: F401
    solve_grid as solve_markov_grid,
)
from repro_torch.core.planner import Planner  # noqa: F401
from repro_torch.core.policy import (  # noqa: F401
    BatchAllWaiting,
    BatchPolicy,
    CappedBatch,
    TimeoutBatch,
)
from repro_torch.core.results import SimResult  # noqa: F401
from repro_torch.core.simulate import simulate  # noqa: F401
from repro_torch.core.sweep import (  # noqa: F401
    fleet_caps,
    fleet_sweep,
    sweep,
    sweep_caps,
)
