"""The port's dynamic-batching inference server (``InferenceEngine``);
the continuous-batching engine comes with a later slice."""
from repro_torch.serving.engine import (  # noqa: F401
    InferenceEngine,
    ServeResult,
)
