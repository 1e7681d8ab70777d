"""Host-side span tracer and exec-boundary instrumentation (port of
``spark_rapids_tpu/obs/spans.py``).

The profiler (runtime/profiler.py) puts operator ranges on the DEVICE
timeline; this tracer records HOST spans (enter and exit wall times,
thread, parent, query attribution) and exports Chrome trace-event JSON
that loads in Perfetto beside the profiler's trace.

* :class:`SpanTracer` and the process-wide :data:`TRACER`: collection is
  enabled per query by the session (``spark.rapids.trace.enabled``, or
  while the event log needs the span summary). Disabled, a site costs one
  attribute read.
* :func:`install_observation`: every exec's ``execute`` and
  ``execute_masked`` get a named range per batch pull
  (``runtime/profiler.py::op_range``: a span while tracing, NVTX on a
  CUDA build, a ``record_function`` while the profiler records), and always
  the ESSENTIAL ``opTime``, ``numOutputRows`` and ``numOutputBatches``.
  ``opTime`` is HOST time around the pull: launches are asynchronous, so
  it is not the operator's device time (the profiler's trace has that).
  A batch whose live row count exists only on the card defers it;
  :func:`finalize_observation` fetches every deferred count in ONE
  batched read, and the session calls it only when the event log or
  tracing is on, so a query with both off gains no host sync.

* :meth:`SpanTracer.add_remote_spans`: span summaries a cluster executor
  ships back with its scan (runtime/cluster.py) merge into the query's
  trace on one ``executor-<host>`` lane a host.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

from spark_rapids_tpu_torch.lockorder import ordered_lock
from spark_rapids_tpu_torch.obs.metrics import register_metric

register_metric("opTime", "timing", "ESSENTIAL",
                "host seconds around each batch pull of the operator, its "
                "children's included (launches are asynchronous: device "
                "time is the profiler's)")
register_metric("numOutputRows", "count", "ESSENTIAL",
                "rows the operator output")
register_metric("numOutputBatches", "count", "ESSENTIAL",
                "batches the operator output")

#: hard cap on buffered spans per query (a runaway batch loop must
#: degrade the trace, not the process); dropped spans are counted
_MAX_SPANS = 200_000


class Span:
    __slots__ = ("sid", "name", "cat", "t0", "t1", "tid", "tname",
                 "parent", "args", "ctx")

    def __init__(self, sid, name, cat, t0, tid, tname, parent, args,
                 ctx=None):
        self.sid = sid
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.t1 = None
        self.tid = tid
        self.tname = tname
        self.parent = parent
        self.args = args
        self.ctx = ctx

    @property
    def dur(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _LiveSpan:
    __slots__ = ("tracer", "span")

    def __init__(self, tracer, span):
        self.tracer = tracer
        self.span = span

    def __enter__(self):
        return self.span

    def __exit__(self, *exc):
        self.tracer.end(self.span)
        return False


class _QueryCtx:
    """One query's span buffer, owned by the thread that called
    ``begin_query``. Per-thread span stacks live ON the context (keyed by
    thread id) so helper-thread stacks die with the query instead of
    leaking stale parents into the next query on that thread."""

    __slots__ = ("query_id", "owner_tid", "spans", "dropped", "t0",
                 "stacks", "closed")

    def __init__(self, query_id: int, owner_tid: int):
        self.query_id = query_id
        self.owner_tid = owner_tid
        self.spans: List[Span] = []
        self.dropped = 0
        self.t0 = time.perf_counter()
        self.stacks: Dict[int, list] = {}
        self.closed = False


#: sentinel bound to a thread's ctx slot while it runs an UNOBSERVED
#: query — blocks the single-active-context adoption below
_ADOPT_BLOCKED = object()


class SpanTracer:
    """Process-wide span collector, safe for CONCURRENT queries: each
    ``begin_query`` opens a :class:`_QueryCtx` bound to the calling
    thread (the query service executes every query on its own worker
    thread), and spans recorded on that thread land in that context.
    A thread with no bound context (a shuffle/IO pool helper) adopts the
    single active context when exactly one query is in flight — under
    concurrency its spans are dropped rather than misattributed.
    ``enabled`` is True while ANY query collects; record sites keep
    their one-attribute-read disabled cost."""

    def __init__(self):
        self.enabled = False
        self._lock = ordered_lock("obs.spans")
        self._ctxs: Dict[int, _QueryCtx] = {}  # owner tid -> ctx
        self._next_id = 0
        self._tls = threading.local()
        self._unobserved = 0  # in-flight queries with NO envelope

    # -- context resolution -------------------------------------------------
    def _ctx(self) -> Optional[_QueryCtx]:
        ctx = getattr(self._tls, "ctx", None)
        if ctx is _ADOPT_BLOCKED:
            # this thread runs an UNOBSERVED query concurrently with an
            # observed one: its spans belong to neither active ctx
            return None
        if ctx is not None and not ctx.closed:
            return ctx
        # helper thread: adopt the only active query, but ONLY while no
        # unobserved query is in flight anywhere — an unobserved
        # query's shuffle/IO pool work is indistinguishable from the
        # observed query's here, and misattribution is worse than a
        # dropped helper span
        with self._lock:
            if len(self._ctxs) == 1 and not self._unobserved:
                return next(iter(self._ctxs.values()))
        return None

    def begin_unobserved_query(self) -> None:
        """Mark this thread as executing a query WITHOUT an observation
        envelope (event log and tracing off for its session): neither
        its own spans nor its helper-pool work may be adopted into some
        other session's concurrently active query context."""
        self._tls.ctx = _ADOPT_BLOCKED
        with self._lock:
            self._unobserved += 1

    def end_unobserved_query(self) -> None:
        if getattr(self._tls, "ctx", None) is _ADOPT_BLOCKED:
            self._tls.ctx = None
            with self._lock:
                self._unobserved -= 1

    def _stack(self, ctx: _QueryCtx) -> list:
        return ctx.stacks.setdefault(threading.get_ident(), [])

    # -- compat / introspection --------------------------------------------
    @property
    def _spans(self) -> List[Span]:
        """All in-flight spans across active contexts (tests/debug)."""
        with self._lock:
            return [s for c in self._ctxs.values() for s in c.spans]

    @property
    def main_tid(self) -> Optional[int]:
        """Owner thread of the CURRENT thread's query context."""
        ctx = self._ctx()
        return ctx.owner_tid if ctx is not None else None

    @property
    def query_id(self) -> Optional[int]:
        ctx = self._ctx()
        return ctx.query_id if ctx is not None else None

    @property
    def dropped(self) -> int:
        ctx = self._ctx()
        return ctx.dropped if ctx is not None else 0

    # -- collection --------------------------------------------------------
    def begin_query(self, query_id: int) -> _QueryCtx:
        tid = threading.get_ident()
        ctx = _QueryCtx(query_id, tid)
        with self._lock:
            self._ctxs[tid] = ctx
            self.enabled = True
        self._tls.ctx = ctx
        return ctx

    def end_query(self) -> List[Span]:
        """Stop collecting THIS thread's query and return its finished
        spans."""
        tid = threading.get_ident()
        with self._lock:
            ctx = self._ctxs.pop(tid, None)
            self.enabled = bool(self._ctxs)
        self._tls.ctx = None
        if ctx is None:
            return []
        ctx.closed = True
        return [s for s in ctx.spans if s.t1 is not None]

    def begin(self, name: str, cat: str = "op", **args) -> Optional[Span]:
        if not self.enabled:
            return None
        ctx = self._ctx()
        if ctx is None:
            return None
        st = self._stack(ctx)
        parent = st[-1].sid if st else None
        tid = threading.get_ident()
        with self._lock:
            if ctx.closed:
                return None
            if len(ctx.spans) >= _MAX_SPANS:
                ctx.dropped += 1
                return None
            self._next_id += 1
            sp = Span(self._next_id, name, cat, time.perf_counter(), tid,
                      threading.current_thread().name, parent, args or None,
                      ctx)
            ctx.spans.append(sp)
        st.append(sp)
        return sp

    def end(self, span: Optional[Span]) -> None:
        if span is None or span.t1 is not None:
            return  # idempotent: an error path may re-end a closed span
        span.t1 = time.perf_counter()
        ctx = span.ctx
        st = ctx.stacks.get(span.tid) if ctx is not None else None
        if not st:
            return
        if st[-1] is span:
            st.pop()
        elif span in st:        # exception unwound past nested spans
            while st and st[-1] is not span:
                st.pop().t1 = span.t1
            if st:
                st.pop()

    def span(self, name: str, cat: str = "op", **args):
        """Context manager; zero-allocation no-op when disabled."""
        if not self.enabled:
            return _NOOP
        return _LiveSpan(self, self.begin(name, cat, **args))

    def add_remote_spans(self, source: str, payload, anchor_t0: float,
                         cap: int = 256) -> int:
        """Merge span summaries shipped back by a cluster EXECUTOR into
        this thread's active query context (runtime/cluster.py scan
        replies). Each payload entry is ``{name, cat, t0, dur[, args]}``
        with ``t0`` relative to the executor's scan start; spans land on
        a synthetic per-source thread row (``executor-<host>``) so the
        Chrome trace shows one lane per executor host next to the
        driver's lanes. The executor clock is a DIFFERENT perf_counter
        domain — ``anchor_t0`` (the driver's dispatch-send time) anchors
        the remote window, so remote spans are positioned relative to
        the dispatch, exact in duration, approximate in offset by the
        one-way wire latency. Returns the number of spans merged."""
        if not self.enabled or not payload:
            return 0
        ctx = self._ctx()
        if ctx is None:
            return 0
        # stable synthetic tid per source, far above real thread idents'
        # typical range and deterministic across runs of one process
        tid = 0x52000000 + (hash(str(source)) & 0xFFFFF)
        tname = f"executor-{source}"
        merged = 0
        with self._lock:
            if ctx.closed:
                return 0
            for p in payload[:max(0, int(cap))]:
                if len(ctx.spans) >= _MAX_SPANS:
                    ctx.dropped += 1
                    continue
                try:
                    t0 = anchor_t0 + float(p["t0"])
                    dur = max(0.0, float(p["dur"]))
                    name = str(p["name"])
                except (KeyError, TypeError, ValueError):
                    continue  # a malformed entry degrades the trace only
                self._next_id += 1
                sp = Span(self._next_id, name, str(p.get("cat", "remote")),
                          t0, tid, tname, None, p.get("args") or None, ctx)
                sp.t1 = t0 + dur
                ctx.spans.append(sp)
                merged += 1
        return merged


TRACER = SpanTracer()


def span(name: str, cat: str = "op", **args):
    return TRACER.span(name, cat, **args)


# ---------------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------------


def to_chrome_trace(spans: List[Span], query_id=None) -> dict:
    """Chrome trace-event JSON (the ``traceEvents`` array form) — loads
    in Perfetto / chrome://tracing. Timestamps are microseconds on the
    perf_counter clock; complete events (``ph: "X"``) carry durations."""
    events = []
    threads = {}
    for s in spans:
        threads.setdefault(s.tid, s.tname)
        ev = {"name": s.name, "cat": s.cat, "ph": "X",
              "ts": round(s.t0 * 1e6, 3), "dur": round(s.dur * 1e6, 3),
              "pid": 1, "tid": s.tid}
        if s.args:
            ev["args"] = dict(s.args)
        events.append(ev)
    for tid, tname in sorted(threads.items()):
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": tid, "args": {"name": tname}})
    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    if query_id is not None:
        trace["otherData"] = {"query": query_id}
    return trace


def write_chrome_trace(path: str, spans: List[Span], query_id=None) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(spans, query_id), f)
    return path


# ---------------------------------------------------------------------------
# Span aggregation (the event record's span summary)
# ---------------------------------------------------------------------------


def union_seconds(intervals) -> float:
    """Total length covered by at least one [t0, t1) interval."""
    total = 0.0
    end = None
    for t0, t1 in sorted(intervals):
        if end is None or t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total


def summarize_spans(spans: List[Span], exec_tid: Optional[int],
                    wall_s: float) -> dict:
    """Per-query span summary: category totals (union per category, so
    nesting never double-counts), attribution of the query wall to
    NAMED spans on the thread that EXECUTED the query (the thread that
    opened the query context — the process main thread for direct
    ``session.execute`` calls, a service worker thread for scheduled
    queries), and helper-thread totals."""
    by_cat: Dict[str, list] = {}
    main_intervals = []
    worker: Dict[str, list] = {}
    for s in spans:
        by_cat.setdefault(s.cat, []).append((s.t0, s.t1))
        if s.tid == exec_tid:
            if s.cat != "query":
                main_intervals.append((s.t0, s.t1))
        else:
            worker.setdefault(s.cat, []).append((s.t0, s.t1))
    attributed = min(union_seconds(main_intervals), wall_s)
    return {
        "byCategoryS": {c: round(union_seconds(iv), 6)
                        for c, iv in sorted(by_cat.items())},
        "workerByCategoryS": {c: round(union_seconds(iv), 6)
                              for c, iv in sorted(worker.items())},
        "attributedS": round(attributed, 6),
        "untrackedS": round(max(wall_s - attributed, 0.0), 6),
        "spanCount": len(spans),
    }


# ---------------------------------------------------------------------------
# Exec-boundary instrumentation
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Exec-boundary instrumentation
# ---------------------------------------------------------------------------


def _observed(fn, e, name: str):
    from spark_rapids_tpu_torch.runtime.profiler import op_range

    """Wrap one execute/execute_masked with per-pull spans and metrics.
    The per-instance ``_obs_depth`` guard keeps the two protocol layers of
    one exec (``execute`` over ``execute_masked``, both wrapped) from
    counting a batch twice."""

    def wrapped(*args, **kwargs):
        it = fn(*args, **kwargs)
        while True:
            if e._obs_depth:
                # the inner protocol layer of the SAME exec: pass through
                try:
                    out = [next(it)]
                except StopIteration:
                    return
                yield out.pop()
                continue
            e._obs_depth = 1
            t0 = time.perf_counter()
            stop = False
            try:
                # a span while tracing, an NVTX range on a CUDA build, a
                # record_function while the profiler records
                with op_range(name, "exec"):
                    try:
                        batch = next(it)
                    except StopIteration:
                        stop = True
            finally:
                e._obs_depth = 0
                e.add_metric("opTime", time.perf_counter() - t0)
            if stop:
                # an exec that ran to exhaustion reports its counts, even
                # when zero
                e.add_metric("numOutputBatches", 0)
                e.add_metric("numOutputRows", 0)
                return
            e.add_metric("numOutputBatches", 1)
            nh = getattr(batch, "_nrows_host", None)
            if nh is not None:
                e.add_metric("numOutputRows", int(nh))
            else:
                # a 0-d device count: finalize_observation reads every
                # deferred one at once
                e._obs_pending_rows.append(batch.nrows_dev)
            # yield through a popped list: a generator local would keep
            # the batch alive (and accounted) while the consumer works
            out = [batch]
            del batch
            yield out.pop()

    return wrapped


def install_observation(executable) -> None:
    """Wrap every exec of the converted tree with the observation
    boundary: installed per query by the session AFTER
    install_fault_boundaries, so spans and metrics see the injected
    failures too. Idempotent per instance."""
    from spark_rapids_tpu_torch.execs.base import TpuExec
    from spark_rapids_tpu_torch.lore import _iter_tree
    for e in _iter_tree(executable):
        if not isinstance(e, TpuExec) or e.__dict__.get("_obs_installed"):
            continue
        e._obs_installed = True
        e._obs_depth = 0
        e._obs_pending_rows = []
        name = type(e).__name__
        e.execute = _observed(e.execute, e, name)
        e.execute_masked = _observed(e.execute_masked, e, name)


def finalize_observation(executable) -> None:
    """Resolve every deferred device row count of the tree with ONE
    batched host read, adding each exec's sum to its ``numOutputRows``.
    A query nobody inspects never pays it."""
    from spark_rapids_tpu_torch.lore import _iter_tree
    owners = []
    scalars = []
    for e in _iter_tree(executable):
        pend = e.__dict__.get("_obs_pending_rows")
        if pend:
            owners.append((e, len(pend)))
            scalars.extend(pend)
            e._obs_pending_rows = []
    if not scalars:
        return
    from spark_rapids_tpu_torch.dispatch import host_fetch
    fetched = host_fetch(scalars)
    i = 0
    for e, n in owners:
        e.add_metric("numOutputRows", sum(int(v) for v in fetched[i:i + n]))
        i += n
