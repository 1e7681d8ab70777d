"""Fatal-error capture and debug dumps (port of
``spark_rapids_tpu/runtime/crash_handler.py``).

Reference (SURVEY.md §5): ``GpuCoreDumpHandler.scala`` captures a GPU core
dump on a fatal CUDA error, then ``RapidsExecutorPlugin.onTaskFailed``
exits the process with code 20 so Spark reschedules the work elsewhere;
``DumpUtils.scala`` dumps tables to Parquet for debugging.

On CUDA a fatal error is one that poisons the context: an illegal memory
access, a device-side assert, an unspecified launch failure, a misaligned
address, an ECC error, an unavailable device. Every later CUDA call of
the process fails with the same sticky error, so the recovery is a report
(the plan, the exception and its traceback, a thread dump, the buffer
catalog's state and ``torch.cuda.memory_stats()``), then the health
monitor (runtime/health.py) or, with ``spark.rapids.fatalError.exit``, an
exit with ``FATAL_EXIT_CODE``. Every read of the device in the report is
guarded: after a sticky error it may raise itself, and recovery never
raises out of the report."""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Optional

from spark_rapids_tpu_torch.conf import CRASH_DUMP_DIR, EXIT_ON_FATAL

FATAL_EXIT_CODE = 20  # reference: RapidsExecutorPlugin exits 20

#: the CUDA runtime's texts of the errors that poison a context
#: (cudaErrorIllegalAddress, cudaErrorAssert, cudaErrorLaunchFailure,
#: cudaErrorMisalignedAddress, cudaErrorECCUncorrectable,
#: cudaErrorDevicesUnavailable, cudaErrorIllegalInstruction,
#: cudaErrorLaunchTimeout)
FATAL_CUDA_TEXTS = (
    "illegal memory access",
    "device-side assert",
    "unspecified launch failure",
    "misaligned address",
    "ecc error",
    "busy or unavailable",
    "illegal instruction",
    "the launch timed out",
)


def is_fatal_device_error(exc: BaseException) -> bool:
    """True when the DEVICE is gone, not one operator: a DeviceLostError
    (an injected loss, or one already classified), or a CUDA runtime
    error that poisons the context, matched by type (torch raises them as
    RuntimeError, ``torch.AcceleratorError`` in newer releases) and by the
    "CUDA error" text. Never true for torch.cuda.OutOfMemoryError or
    anything the retry framework accepts as an OOM."""
    from spark_rapids_tpu_torch.errors import DeviceLostError
    from spark_rapids_tpu_torch.runtime.retry import is_device_oom
    if isinstance(exc, DeviceLostError):
        return True
    if is_device_oom(exc) or not isinstance(exc, RuntimeError):
        return False
    msg = str(exc)
    low = msg.lower()
    return "CUDA error" in msg and any(k in low for k in FATAL_CUDA_TEXTS)


def _guarded(fn):
    try:
        return fn()
    except Exception as e:  # a sticky CUDA error makes any read raise
        return f"unavailable ({type(e).__name__}: {e})"


def _device_state() -> dict:
    import torch
    out = {"cuda_available": _guarded(torch.cuda.is_available)}
    if out["cuda_available"] is True:
        out["name"] = _guarded(lambda: torch.cuda.get_device_name(0))
        out["memory_stats"] = _guarded(lambda: {
            k: (int(v) if isinstance(v, (int, float)) else v)
            for k, v in torch.cuda.memory_stats().items()})
    return out


def _catalog_state() -> dict:
    from spark_rapids_tpu_torch.runtime.spill import BufferCatalog
    cat = BufferCatalog.get()
    return {
        "buffers": len(cat.buffers()),
        "device_bytes": sum(b.device_bytes for b in cat.buffers()),
        "host_bytes": cat.host_bytes(),
        "spill_device_count": getattr(cat, "spill_device_count", 0),
        "spill_disk_count": getattr(cat, "spill_disk_count", 0),
    }


def _thread_dump() -> str:
    names = {t.ident: t.name for t in threading.enumerate()}
    return "\n".join(
        f"Thread {names.get(tid, tid)}:\n"
        + "".join(traceback.format_stack(frame))
        for tid, frame in sys._current_frames().items())


def tree_string(node) -> str:
    """An exec or plan tree, one node a line, children indented."""
    lines = []

    def walk(n, depth):
        origin = getattr(n, "_plan_origin", None)
        lines.append("  " * depth + type(n).__name__
                     + (f" <- {origin}" if origin else ""))
        for c in getattr(n, "children", ()):
            walk(c, depth + 1)

    walk(node, 0)
    return "\n".join(lines)


def write_crash_report(exc: BaseException, conf,
                       plan_description: str = "") -> Optional[str]:
    """Write a crash report as JSON into ``spark.rapids.memory.crashDump.
    dir``; returns its path, or None when even that failed (a crash
    handler never raises)."""
    try:
        dump_dir = str(conf.get_entry(CRASH_DUMP_DIR))
        os.makedirs(dump_dir, exist_ok=True)
        path = os.path.join(
            dump_dir, f"crash_{os.getpid()}_{time.time_ns()}.json")
        report = {
            "timestamp": time.time(),
            "exception_type": type(exc).__name__,
            "exception": str(exc),
            "traceback": "".join(traceback.format_exception(
                type(exc), exc, exc.__traceback__)),
            "plan": plan_description,
            "fault_op": getattr(exc, "fault_op", None),
            "device": _guarded(_device_state),
            "buffer_catalog": _guarded(_catalog_state),
            "thread_dump": _guarded(_thread_dump),
        }
        with open(path, "w") as f:
            json.dump(report, f, indent=2, default=str)
        return path
    except Exception:
        return None


def handle_fatal(exc: BaseException, conf,
                 plan_description: str = "") -> Optional[str]:
    """The executor's fatal-error protocol: write the report, then exit
    with FATAL_EXIT_CODE when ``spark.rapids.fatalError.exit`` is set
    (after sweeping the disk-tier spill files and the write jobs in
    flight, which ``os._exit`` would leave behind). Returns the report's
    path when it does not exit."""
    path = write_crash_report(exc, conf, plan_description)
    if path:
        print(f"[spark-rapids-tpu] fatal device error; crash report at "
              f"{path}", file=sys.stderr)
    if bool(conf.get_entry(EXIT_ON_FATAL)):
        try:
            from spark_rapids_tpu_torch.runtime.spill import (
                _atexit_spill_sweep,
            )
            _atexit_spill_sweep()
        except Exception:
            pass
        try:
            from spark_rapids_tpu_torch.io.committer import (
                sweep_active_jobs,
            )
            sweep_active_jobs()
        except Exception:
            pass
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(FATAL_EXIT_CODE)
    return path


def dump_table(table, path: str) -> str:
    """Dump a host or device table to Parquet through the port's own
    writer, for debugging (DumpUtils.scala analog)."""
    from spark_rapids_tpu_torch.io.parquet_format import write_table
    host = table.to_host() if hasattr(table, "to_host") else table
    write_table(host, path)
    return path
