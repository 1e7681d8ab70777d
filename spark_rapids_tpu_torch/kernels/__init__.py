"""The port's hand-written CUDA kernels, one module per TPU kernel.

Each module holds the kernel's wrapper, its plain PyTorch version and a
launch counter (``<wrapper>.launches``, a plain int that the wrapper
raises by one where it launches the kernel, and nowhere else). A wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches its kernel or raises. Nothing catches a build or launch error
and carries on: the reference's demotion machinery (``guarded``,
``demote``, the ineligible-shape route to XLA) is deliberately not ported.

Kernels launch on torch's current CUDA stream and allocate nothing; the
wrappers allocate outputs and check device, dtype, shape and contiguity.
"""

from __future__ import annotations

from typing import Dict

import torch

#: (module, wrapper) of every ported kernel, by the name chip_smoke.py and
#: PERF.md use
KERNELS = (
    ("segreduce", "onehot_partials"),
    ("segreduce", "fused_minmax"),
    ("compact", "gather_compact"),
    ("sort", "sort_with_payload"),
    ("hashprobe", "probe_rowids"),
)


def _wrapper(module: str, fn: str):
    import importlib
    return getattr(importlib.import_module(
        f"spark_rapids_tpu_torch.kernels.{module}"), fn)


def launch_counts() -> Dict[str, int]:
    """{wrapper name: launches so far} for every ported kernel."""
    return {fn: _wrapper(m, fn).launches for m, fn in KERNELS}


def reset_launch_counts() -> None:
    for m, fn in KERNELS:
        _wrapper(m, fn).launches = 0


def stream_handle(t: torch.Tensor) -> int:
    """The raw cudaStream_t of torch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(lib, rc: int, what: str) -> None:
    """Raise when a kernel's C entry point reports a CUDA error."""
    if rc != 0:
        msg = lib.srt_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: expected a CUDA or CPU tensor, got "
                           f"{t.device}")


def require_contiguous(t: torch.Tensor, what: str) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
