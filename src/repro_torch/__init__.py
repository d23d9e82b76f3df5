"""PyTorch/CUDA port of the dynamic-batching queue reproduction.

A second package beside the JAX reference ``repro``: it imports torch and
numpy and nothing of ``repro`` or ``jax``.  Entry points run on CUDA
unless the caller passes ``device="cpu"``.  See README "PyTorch/CUDA
port" and ROADMAP for what is ported so far.
"""
