"""The port's servers: the dynamic-batching ``InferenceEngine`` and the
continuous-batching ``ContinuousEngine``."""
from repro_torch.serving.continuous import (  # noqa: F401
    ContinuousEngine,
    ContinuousServeResult,
)
from repro_torch.serving.engine import (  # noqa: F401
    InferenceEngine,
    ServeResult,
)
