"""The port's hand-written CUDA kernels, one module per TPU kernel, and
``decimal`` (DECIMAL128 division, CUDA work beyond the TPU kernels).

Each module holds the kernel's wrapper, its plain PyTorch version and a
launch counter (``<wrapper>.launches``, a plain int that the wrapper
raises by one where it launches the kernel, and nowhere else). A wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches its kernel or raises. Nothing catches a build or launch error
and carries on: the reference's demotion machinery (``guarded``,
``demote``, the ineligible-shape route to XLA) is deliberately not ported.

Kernels launch on torch's current CUDA stream and allocate nothing; the
wrappers allocate outputs and check device, dtype, shape and contiguity.

Every launch runs inside :class:`kernel_launch`: the ``dispatch.kernel``,
``dispatch.wedge`` and ``device.lost`` fault points fire once before it, in
that order (a wedge stalls the launching thread on the host; the card is
never left running a kernel that does not end), it is a named range
on the profiler's timeline (``runtime/profiler.py::op_range``), and a
launch that returns counts one dispatch (``dispatch.py``). It adds no
synchronisation and no copy.
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
    ("decimal", "dec128_divide"),
)


class kernel_launch:
    """The launch helper every wrapper runs its C call in, beside the
    line that raises its ``.launches``: the fault points
    ``dispatch.kernel``, ``dispatch.wedge`` and ``device.lost`` (op: the
    wrapper's name), a named range, and one counted dispatch when the
    launch returns."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        from spark_rapids_tpu_torch.runtime.faults import fault_point
        from spark_rapids_tpu_torch.runtime.profiler import op_range
        fault_point("dispatch.kernel", op=self.name)
        fault_point("dispatch.wedge", op=self.name)
        fault_point("device.lost", op=self.name)
        self._range = op_range(self.name, "kernel")
        self._range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._range.__exit__(exc_type, exc, tb)
        if exc_type is None:
            from spark_rapids_tpu_torch.dispatch import count_dispatch
            count_dispatch()
        return False


def _wrapper(module: str, fn: str):
    import importlib
    return getattr(importlib.import_module(
        f"spark_rapids_tpu_torch.kernels.{module}"), fn)


#: None, or a list that gets (wrapper name, inputs, outputs) of every
#: launch, each tensor cloned, so that a caller can hold a run's launches
#: against their plain versions on the same inputs afterwards
calls = None


def record(name: str, inputs: tuple, outputs) -> None:
    """Append one launch to ``calls`` when it is a list."""
    if calls is None:
        return

    def keep(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, (list, tuple)):
            return type(v)(keep(x) for x in v)
        return v

    calls.append((name, keep(inputs), keep(outputs)))


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
