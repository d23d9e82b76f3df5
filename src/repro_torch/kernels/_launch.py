"""Launch helpers shared by the port's attention and scan wrappers: the
dtype codes their CUDA sources take, the device rule (a CUDA tensor
launches the kernel, a CPU tensor takes the plain version, a ``meta``
tensor takes the kernel's shape function, any other device raises), the
16-byte alignment check, the per-device float32 split workspace and the
SM count that sizes a split.

The shape function (``shape_only``) is what a wrapper does on ``meta``
tensors (the dry run): it makes the kernel's outputs, empty, in their
shapes and dtypes, does no arithmetic and launches nothing; it counts in
the wrapper's own ``meta_calls`` (``meta_backward_calls`` for a
backward), never in ``launches``.  A CUDA call whose outputs have no
element (a mesh rank whose shard holds no head) launches nothing either:
a zero-size grid is a launch error."""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["DTYPE_CODE", "kernel_device", "shape_only", "check_aligned",
           "float_workspace", "sm_count"]

# the dtype argument of every ``*_launch`` entry point
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_SMS: Dict[torch.device, int] = {}


def kernel_device(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel) or a ``meta`` one (the
    kernel's shape function, ``shape_only``), False for a CPU one (take
    the plain version); any other device raises."""
    if t.device.type in ("cuda", "meta"):
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on CUDA (kernel) or CPU (plain "
                     f"version), got device {t.device}")


def shape_only(fn, t: torch.Tensor, *outs: torch.Tensor,
               backward: bool = False, ops: float = 0.0) -> bool:
    """True where the wrapper ``fn`` returns ``outs`` as they are, with no
    launch: on ``meta`` (one more ``fn.meta_calls``, or
    ``fn.meta_backward_calls`` with ``backward``; ``ops``, the kernel's
    operation count for these shapes, added to ``fn.meta_ops``, which
    the dry run reads since the shape function does no arithmetic), or
    when an output has no element; False where it launches its
    kernel."""
    if t.device.type == "meta":
        name = "meta_backward_calls" if backward else "meta_calls"
        setattr(fn, name, getattr(fn, name, 0) + 1)
        fn.meta_ops = getattr(fn, "meta_ops", 0.0) + float(ops)
        return True
    return any(o.numel() == 0 for o in outs)


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every pointer is 16-byte aligned."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"the CUDA {name} needs 16-byte aligned "
                             f"tensors")


def float_workspace(store: Dict[torch.device, torch.Tensor],
                    dev: torch.device, floats: int) -> torch.Tensor:
    """A kernel's float32 split workspace on ``dev``, kept in ``store``
    and grown when a launch needs more; never allocated per call (the
    kernels write every float they read back)."""
    have = store.get(dev)
    if have is None or have.numel() < floats:
        store[dev] = torch.empty(floats, dtype=torch.float32, device=dev)
    return store[dev]


def sm_count(dev: torch.device) -> int:
    """The device's streaming multiprocessors, read once."""
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev]
