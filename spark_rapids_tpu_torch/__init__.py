"""spark_rapids_tpu_torch: the PyTorch and CUDA port of the engine.

The package mirrors ``spark_rapids_tpu``'s module layout (the JAX package
is the reference it is held against) but imports neither JAX nor anything
from the reference: modules it needs from there are copied. Plain tensor
work is torch; every Pallas kernel on a ported path is a CUDA C++ kernel
under ``kernels/csrc``.

Execution runs on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, as the CPU tests do). There is no silent fallback: with
no CUDA device, asking for the default device raises.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The device a session computes on when the caller names none:
    the current CUDA device. Raises when no CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "spark_rapids_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' to run the plain torch versions "
            "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """``None`` -> :func:`default_device`; anything else -> torch.device.
    A CUDA device that is not present raises."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"device type {dev.type!r}")
    return dev
