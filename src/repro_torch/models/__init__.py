"""The port's model stack: dense and MoE GQA decoder transformers and
Mamba2, with their attention cores and SSD scan on the hand-written CUDA
kernels."""
from repro_torch.models.registry import ModelBundle, build  # noqa: F401
