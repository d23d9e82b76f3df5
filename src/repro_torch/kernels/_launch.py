"""Launch helpers shared by the port's attention and scan wrappers: the
dtype codes their CUDA sources take, the device rule (a CUDA tensor
launches the kernel, a CPU tensor takes the plain version, any other
device raises), the 16-byte alignment check, the per-device float32
split workspace and the SM count that sizes a split."""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["DTYPE_CODE", "kernel_device", "check_aligned",
           "float_workspace", "sm_count"]

# the dtype argument of every ``*_launch`` entry point
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_SMS: Dict[torch.device, int] = {}


def kernel_device(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (take the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on CUDA (kernel) or CPU (plain "
                     f"version), got device {t.device}")


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
