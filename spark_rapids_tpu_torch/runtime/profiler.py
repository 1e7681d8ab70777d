"""Profiler (port of ``spark_rapids_tpu/runtime/profiler.py``).

Reference: NVTX ranges around operators (``NvtxWithMetrics.scala``) for
Nsight timelines, and the built-in profiler (``profiler.scala``) that
collects CUPTI traces for a window of queries keyed by
``spark.rapids.profile.*``. The port collects with ``torch.profiler``
over the CPU and CUDA activities (CUPTI underneath) and exports a Chrome
trace per profiled query to ``<pathPrefix>/query_<N>/trace.json``, with
the operator table (``ops.txt``, torch's ``key_averages``) beside it.

* :func:`parse_ranges` reads ``spark.rapids.profile.queryRanges``
  ("2-5,8", RangeConfMatcher semantics); a malformed spec raises naming
  the key when the profiler is built.
* :class:`TorchProfiler` is a session's driver: :meth:`profile_query`
  wraps one top-level query; a nested or concurrent query yields None and
  burns no query index.
* :func:`op_range` opens a named range on both timelines: a
  ``torch.profiler.record_function`` while a trace is being recorded
  (so engine operators and the kernels' launches show as named ranges
  over the device's kernels), an NVTX range whenever CUDA is available,
  and a host span while the span tracer collects.
* :func:`record_trace` is the one piece of code that runs
  ``torch.profiler``; ``chip_smoke.py --profile`` uses it too.

CUPTI can hand back a trace without its device events (its buffers are
dropped, seen on the first trace of a process). The profiler does not
retry: it writes ``NO_DEVICE_EVENTS.txt`` into the trace directory
saying so, and counts ``profileTracesWithoutDeviceEvents``.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Optional, Set

from spark_rapids_tpu_torch.conf import (
    PROFILE_ENABLED,
    PROFILE_PATH,
    PROFILE_QUERY_RANGES,
    RapidsConf,
)
from spark_rapids_tpu_torch.lockorder import ordered_lock
from spark_rapids_tpu_torch.obs.metrics import metric_scope, register_metric

register_metric("profileTracesWritten", "count", "MODERATE",
                "torch.profiler traces the engine's profiler exported")
register_metric("profileTracesWithoutDeviceEvents", "count", "MODERATE",
                "exported CUDA traces that hold no device event (CUPTI "
                "dropped its buffers); each trace directory says so")

#: the device-side event categories of a torch.profiler chrome trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

#: recording traces in this process (torch.profiler allows one at a time)
_RECORDING = [0]
_RECORDING_LOCK = ordered_lock("profiler.recording")


def parse_ranges(spec: str) -> Optional[Set[int]]:
    """\"1-3,8\" -> {1,2,3,8}; empty/blank -> None (match all)
    (RangeConfMatcher.scala analog). Malformed specs raise a ValueError
    naming the conf key."""
    key = PROFILE_QUERY_RANGES.key

    def _bound(text: str, part: str) -> int:
        text = text.strip()
        try:
            v = int(text)
        except ValueError:
            raise ValueError(
                f"{key}: range entry {part!r} has non-integer bound "
                f"{text!r} (expected e.g. \"0-2,5\")") from None
        if v < 0:
            raise ValueError(
                f"{key}: range entry {part!r} has negative bound {v}")
        return v

    spec = (spec or "").strip()
    if not spec:
        return None
    out: Set[int] = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo_s, _, hi_s = part.partition("-")
            if not lo_s.strip() or not hi_s.strip():
                raise ValueError(
                    f"{key}: range entry {part!r} is missing a bound "
                    f"(expected \"<lo>-<hi>\")")
            lo, hi = _bound(lo_s, part), _bound(hi_s, part)
            if lo > hi:
                raise ValueError(
                    f"{key}: range entry {part!r} is reversed "
                    f"({lo} > {hi})")
            out.update(range(lo, hi + 1))
        else:
            out.add(_bound(part, part))
    return out


def device_event_count(trace_path: str) -> int:
    """Kernels, copies and memsets in a torch.profiler chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    return sum(1 for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATEGORIES)


class TraceHandle:
    """What :func:`record_trace` yields: the directory, and after the
    block the exported trace's path, the profiler (its ``key_averages``)
    and the number of device events in the trace (None for a CPU-only
    trace)."""

    def __init__(self, path: str, cuda: bool):
        self.path = path
        self.cuda = cuda
        self.trace_path = os.path.join(path, "trace.json")
        self.prof = None
        self.device_events: Optional[int] = None


@contextlib.contextmanager
def record_trace(path: str, cuda: bool):
    """Record one torch.profiler session (CPU, and CUDA when ``cuda``)
    around the block and export it to ``<path>/trace.json`` with the
    operator table in ``<path>/ops.txt``. A CUDA trace without device
    events gets ``<path>/NO_DEVICE_EVENTS.txt``; nothing retries."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(path, exist_ok=True)
    handle = TraceHandle(path, cuda)
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with _RECORDING_LOCK:
        _RECORDING[0] += 1
    try:
        with profile(activities=activities) as prof:
            yield handle
            if cuda:
                torch.cuda.synchronize()
    finally:
        with _RECORDING_LOCK:
            _RECORDING[0] -= 1
    handle.prof = prof
    prof.export_chrome_trace(handle.trace_path)
    sort_by = "cuda_time_total" if cuda else "cpu_time_total"
    with open(os.path.join(path, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort_by, row_limit=60))
    scope = metric_scope("profile")
    scope.add("profileTracesWritten", 1)
    if cuda:
        handle.device_events = device_event_count(handle.trace_path)
        if not handle.device_events:
            scope.add("profileTracesWithoutDeviceEvents", 1)
            with open(os.path.join(path, "NO_DEVICE_EVENTS.txt"), "w") as f:
                f.write("torch.profiler exported this trace without any "
                        "device event (kernel, memcpy, memset): CUPTI "
                        "dropped its buffers. The trace is kept as it "
                        "is; profile the query again for device times.\n")


def recording() -> bool:
    """Is a trace being recorded in this process?"""
    return _RECORDING[0] > 0


class TorchProfiler:
    """Per-session profiler driver (ProfilerOnExecutor analog)."""

    def __init__(self, conf: RapidsConf, device):
        self.enabled = bool(conf.get_entry(PROFILE_ENABLED))
        self.path_prefix = str(conf.get_entry(PROFILE_PATH))
        # conf-read-time validation: a malformed queryRanges spec fails
        # HERE with the conf key named, not at the first profiled query
        self.ranges = parse_ranges(str(conf.get_entry(PROFILE_QUERY_RANGES)))
        self.cuda = getattr(device, "type", str(device)) == "cuda"
        self._query_index = 0
        self._lock = ordered_lock("profiler")
        self._active = 0
        self.sessions_written = 0
        #: the last profiled query's TraceHandle
        self.last_trace: Optional[TraceHandle] = None

    def should_profile(self, query_index: int) -> bool:
        return self.enabled and (self.ranges is None
                                 or query_index in self.ranges)

    @contextlib.contextmanager
    def profile_query(self):
        """Wrap one query's execution in a trace session; the trace lands
        under ``<prefix>/query_<N>/``. Only top-level queries advance the
        index: a nested query (a cached relation's materialization inside
        an outer execute) rides the outer session and burns no
        ``queryRanges`` slot, and so does a query that starts while
        another trace is being recorded (torch.profiler records one at a
        time). Both yield None."""
        with self._lock:
            nested = self._active > 0
            self._active += 1
            if not nested:
                idx = self._query_index
                self._query_index += 1
        try:
            if nested or not self.should_profile(idx) or recording():
                yield None
                return
            path = os.path.join(self.path_prefix, f"query_{idx}")
            with record_trace(path, self.cuda) as handle:
                yield path
            self.sessions_written += 1
            self.last_trace = handle
        finally:
            with self._lock:
                self._active -= 1


_NVTX = []
_NVTX_LOCK = ordered_lock("profiler.nvtx")


def _nvtx_enabled() -> bool:
    """NVTX ranges where CUDA is available; a CPU-only torch has no NVTX
    library (its ``torch.cuda.nvtx`` raises when called). Decided once,
    by the first caller (query workers pull execs concurrently)."""
    if not _NVTX:
        import torch
        with _NVTX_LOCK:
            if not _NVTX:
                _NVTX.append(torch.cuda.is_available())
    return _NVTX[0]


class _OpRange:
    __slots__ = ("name", "cat", "_rf", "_span", "_nvtx")

    def __init__(self, name: str, cat: str):
        self.name = name
        self.cat = cat
        self._rf = self._span = None
        self._nvtx = False

    def __enter__(self):
        from spark_rapids_tpu_torch.obs.spans import TRACER
        if TRACER.enabled:
            self._span = TRACER.begin(self.name, self.cat)
        if _nvtx_enabled():
            import torch
            torch.cuda.nvtx.range_push(self.name)
            self._nvtx = True
        if recording():
            import torch
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if self._nvtx:
            import torch
            torch.cuda.nvtx.range_pop()
        if self._span is not None:
            from spark_rapids_tpu_torch.obs.spans import TRACER
            TRACER.end(self._span)
        return False


def op_range(name: str, cat: str = "op") -> _OpRange:
    """A named range on both timelines (NvtxWithMetrics analog): NVTX on
    a CUDA build, ``record_function`` while a trace records, a host span
    while the tracer collects."""
    return _OpRange(name, cat)
