"""Dispatch accounting (port of the accounting half of
``spark_rapids_tpu/dispatch.py``): the per-query dispatch count, the
sanctioned host fetches, the compile accounting and the ``compile``
metric scope the executable cache shares.

What the words mean in the port (deviations, pinned by
``tests/test_torch_observability.py``):

* a **dispatch** is one launch of a hand-written CUDA kernel
  (``kernels.kernel_launch``; on the CPU, a call of its plain version).
  The reference counts every jitted XLA
  program; each torch op is a launch of its own here, and only the
  profiler sees those;
* a **trace** is a kernel library that ``kernels/build.py::build``
  compiles with ``nvcc`` during the query, and ``kernelCompileTime`` is
  that build's seconds (the reference counts XLA traces and their
  trace + lower + compile wall).

Not ported: the device-constant interning (``device_const``,
``device_scalar``, ``prep_aux``), which answers a TPU host-to-device
stall (the port keeps constants as Python ints), and ``pallas_program``,
``tpu_jit`` and the pad-waste accounting, which have no CUDA meaning
(``last_pad_waste_rows`` reads 0).
"""

from __future__ import annotations

import contextvars
import threading
from typing import Tuple

from spark_rapids_tpu_torch.obs.metrics import metric_scope, register_metric

register_metric("kernelTraces", "count", "ESSENTIAL",
                "kernel libraries compiled by nvcc (kernels/build.py) "
                "during the query: the port's cold-build cost")
register_metric("kernelCompileTime", "timing", "ESSENTIAL",
                "seconds of the nvcc builds counted in kernelTraces")
register_metric("dispatches", "count", "MODERATE",
                "launches of the hand-written CUDA kernels in the query "
                "(a torch op is a launch too; only the profiler sees "
                "those)")

#: the process-wide `compile` scope: the kernel builds and the executable
#: cache's counters
COMPILE_SCOPE = metric_scope("compile")


class _ThreadCounter(threading.local):
    """Per-thread counter: a query executes whole on one thread, so the
    per-query counts stay right under concurrent queries."""

    def __init__(self):
        self.n = 0


class _ThreadFloat(threading.local):
    def __init__(self):
        self.v = 0.0


#: ``spark.sql.ansi.enabled``, set per query by the placement layer in the
#: thread that runs it (runtime/placement.py::ansi_mode)
ANSI_MODE: "contextvars.ContextVar[bool]" = contextvars.ContextVar(
    "rapids_torch_ansi_mode", default=False)

_DISPATCHES = _ThreadCounter()
_HOST_FETCHES = _ThreadCounter()
_TRACES = _ThreadCounter()
_COMPILE_S = _ThreadFloat()


# -- dispatch accounting ------------------------------------------------------

def count_dispatch(n: int = 1) -> None:
    """Record ``n`` kernel launches on this thread."""
    _DISPATCHES.n += n


def dispatch_count() -> int:
    return _DISPATCHES.n


def reset_dispatch_count() -> int:
    old = _DISPATCHES.n
    _DISPATCHES.n = 0
    return old


# -- sanctioned host synchronization -----------------------------------------

def host_fetch(scalars):
    """THE counted device-to-host read of the engine's deferred 0-d device
    counts: all of them in ONE copy, back as a list of ints."""
    import torch
    _HOST_FETCHES.n += 1
    if not scalars:
        return []
    return torch.stack([v.to(torch.int64) for v in scalars]).cpu().tolist()


def note_host_fetch(n: int = 1) -> None:
    """Count a download made at one of the port's own sites
    (``DeviceColumn.to_host``, the placement drain)."""
    _HOST_FETCHES.n += n


def host_fetch_count() -> int:
    return _HOST_FETCHES.n


# -- compile accounting -------------------------------------------------------

def note_kernel_build(n_libraries: int, seconds: float) -> None:
    """``kernels/build.py::build`` compiled ``n_libraries`` sources in
    ``seconds`` on this thread."""
    if n_libraries <= 0:
        return
    _TRACES.n += n_libraries
    _COMPILE_S.v += seconds
    COMPILE_SCOPE.add("kernelTraces", n_libraries)
    COMPILE_SCOPE.add("kernelCompileTime", seconds)


def compile_stats() -> Tuple[int, float]:
    """(libraries built, build seconds) on THIS thread since the last
    reset: the session reads them per query."""
    return _TRACES.n, _COMPILE_S.v


def reset_compile_stats() -> None:
    _TRACES.n = 0
    _COMPILE_S.v = 0.0
