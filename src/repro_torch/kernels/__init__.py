"""Hand-written Hopper kernels of the port, each beside its plain torch
version.  CUDA sources live in ``csrc/`` and are built at first use by
``_build``."""
