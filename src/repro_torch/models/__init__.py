"""The port's model stack: the dense GQA decoder transformer, with its
attention cores on the hand-written CUDA kernels."""
from repro_torch.models.registry import ModelBundle, build  # noqa: F401
