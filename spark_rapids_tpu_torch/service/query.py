"""Query lifecycle: the handle's state machine and cooperative
cancellation (port of ``spark_rapids_tpu/service/query.py``).

Reference: Spark's ``SparkContext.cancelJobGroup`` and the task kill flag
(``TaskContext.isInterrupted``, checked between columnar batches). Every
submitted query gets a :class:`QueryHandle` whose ``cancel()`` (and the
scheduler's deadline sweep) sets a flag that :func:`install_cancellation`
checks at every exec boundary's batch pull, so a long plan stops between
batches instead of after the query.

:func:`install_cancellation` is the third per-query exec-boundary wrapper
beside ``install_fault_boundaries`` (runtime/faults.py) and
``install_observation`` (obs/spans.py), installed outermost by
``TorchSession._plan_and_drain``. It checks the scope of the executing
thread (a context variable the service's worker sets), so a cached tree
reused by another query checks that query's scope, and a query run
outside the service checks nothing.
"""

from __future__ import annotations

import contextvars
import threading
import time
from typing import Optional

from spark_rapids_tpu_torch.errors import (
    QueryCancelledError,
    QueryTimeoutError,
)
from spark_rapids_tpu_torch.lockorder import ordered_lock


class QueryState:
    """Lifecycle states (string constants; the handle's ``state``)."""

    QUEUED = "QUEUED"        # admitted to a pool queue, waiting
    ADMITTED = "ADMITTED"    # popped by a worker, about to run
    RUNNING = "RUNNING"      # executing on a worker thread
    FINISHED = "FINISHED"    # result available
    FAILED = "FAILED"        # raised a non-cancellation error
    CANCELLED = "CANCELLED"  # cancel() won the race
    TIMED_OUT = "TIMED_OUT"  # deadline expired (queued or running)

    TERMINAL = frozenset((FINISHED, FAILED, CANCELLED, TIMED_OUT))


class CancelScope:
    """The cooperative-interruption contract between a handle and the
    exec boundary: ``check()`` raises the typed interruption when the
    query was cancelled or its deadline passed. Deadlines are monotonic
    (``time.monotonic``), so a wall-clock step cannot fire them."""

    __slots__ = ("cancelled", "deadline", "checks")

    def __init__(self, deadline: Optional[float] = None):
        self.cancelled = threading.Event()
        self.deadline = deadline
        self.checks = 0

    def cancel(self) -> None:
        self.cancelled.set()

    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() > self.deadline

    def check(self) -> None:
        self.checks += 1
        if self.cancelled.is_set():
            raise QueryCancelledError("query cancelled")
        if self.expired():
            raise QueryTimeoutError("query deadline expired while running")


#: the executing thread's active cancel scope: set by the service worker
#: around session.execute, read at every exec boundary's pull
_SCOPE: contextvars.ContextVar[Optional[CancelScope]] = \
    contextvars.ContextVar("rapids_cancel_scope", default=None)


def current_cancel_scope() -> Optional[CancelScope]:
    return _SCOPE.get()


class cancel_scope:
    """``with cancel_scope(scope): session.execute(...)``."""

    def __init__(self, scope: CancelScope):
        self.scope = scope
        self._token = None

    def __enter__(self) -> CancelScope:
        self._token = _SCOPE.set(self.scope)
        return self.scope

    def __exit__(self, *exc):
        _SCOPE.reset(self._token)
        return False


def check_cancelled() -> None:
    """Check the executing thread's scope once (a no-op outside one)."""
    scope = _SCOPE.get()
    if scope is not None:
        scope.check()


def _cancellable(fn):
    """The boundary reads the ACTIVE scope at every pull instead of
    closing over one: converted trees are cached and reused across
    queries (plan/executable_cache.py), so a wrapper installed for query
    A must check query B's scope when B reuses the tree, and nothing at
    all for a query running without a scope. The batch passes through a
    popped list: a generator local would keep it (and its device memory)
    alive across the yield."""
    def wrapped(*args, **kwargs):
        check_cancelled()
        it = fn(*args, **kwargs)
        while True:
            check_cancelled()   # between batches: the cooperative point
            try:
                out = [next(it)]
            except StopIteration:
                return
            yield out.pop()

    return wrapped


def install_cancellation(executable) -> None:
    """Wrap every exec's execute()/execute_masked() (and a DeviceToHost
    transition's execute_cpu) with a pre-pull check of the executing
    thread's cancel scope. Installed per query after the fault and the
    observation boundaries, so a cancellation is never counted as an
    operator's crash or time. Idempotent per exec instance."""
    from spark_rapids_tpu_torch.execs.base import DeviceToHost, TpuExec
    from spark_rapids_tpu_torch.lore import _iter_tree
    for e in _iter_tree(executable):
        if not isinstance(e, TpuExec) or e.__dict__.get("_cancel_installed"):
            continue
        e._cancel_installed = True
        e.execute = _cancellable(e.execute)
        e.execute_masked = _cancellable(e.execute_masked)
        if isinstance(e, DeviceToHost):
            e.execute_cpu = _cancellable(e.execute_cpu)


class QueryHandle:
    """One submitted query. Callers hold it to wait, inspect or cancel;
    the scheduler drives the state machine. Every transition goes through
    :meth:`_transition` under the handle's lock, and terminal states
    latch (a cancel racing a finish cannot un-finish it)."""

    _seq_lock = ordered_lock("service.handle.seq")
    _seq = 0

    def __init__(self, *, tenant: str, pool: str, tag: Optional[str],
                 sql_text: Optional[str], plan,
                 deadline: Optional[float]):
        with QueryHandle._seq_lock:
            QueryHandle._seq += 1
            self.query_id = QueryHandle._seq
        self.tenant = tenant
        self.pool = pool
        self.tag = tag
        self.sql_text = sql_text
        self.plan = plan
        self.scope = CancelScope(deadline)
        self._lock = ordered_lock("service.handle")
        self._done = threading.Event()
        self._state = QueryState.QUEUED
        self.submit_t = time.monotonic()
        self.start_t: Optional[float] = None
        self.end_t: Optional[float] = None
        self.result_table = None
        self.error: Optional[BaseException] = None
        self.cache_hit = False
        self.queue_wait_s: Optional[float] = None
        self.event_record: Optional[dict] = None
        #: the literal-stripped structural fingerprint, the quarantine key
        #: (computed lazily by the scheduler, only when the quarantine
        #: ledger has strikes to check, or at strike time). None means
        #: "not computed yet" (_template_fp_done False) or "unfingerprintable
        #: plan" (True)
        self.template_fp: Optional[str] = None
        self._template_fp_done = False
        #: times the scheduler put this handle back in its queue after its
        #: worker or the device died under it
        self.requeues = 0
        #: set by the scheduler so that cancel() can pull a QUEUED handle
        self._service = None

    # -- state machine --------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def _transition(self, new_state: str, *, error=None, result=None) -> bool:
        """Move to ``new_state``; False when already terminal (the
        transition lost a race and must not apply)."""
        with self._lock:
            if self._state in QueryState.TERMINAL:
                return False
            self._state = new_state
            if new_state == QueryState.RUNNING:
                self.start_t = time.monotonic()
                self.queue_wait_s = self.start_t - self.submit_t
            if new_state in QueryState.TERMINAL:
                self.end_t = time.monotonic()
                self.error = error
                if result is not None:
                    self.result_table = result
        if new_state in QueryState.TERMINAL:
            self._done.set()
        return True

    # -- caller surface -------------------------------------------------------
    def cancel(self) -> bool:
        """Request cancellation. A QUEUED query transitions at once (it
        never runs); a RUNNING one stops at its next exec boundary.
        False when already terminal."""
        self.scope.cancel()
        svc = self._service
        if svc is not None and svc._remove_queued(self):
            done = self._transition(
                QueryState.CANCELLED,
                error=QueryCancelledError("cancelled while queued"))
            if done:
                svc._count_event("cancelled")
            return done
        with self._lock:
            return self._state not in QueryState.TERMINAL

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None):
        """Block for the result HostTable; raises the query's error for
        FAILED, CANCELLED and TIMED_OUT."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"query {self.query_id} still {self.state} after "
                f"{timeout}s wait")
        if self.error is not None:
            raise self.error
        return self.result_table

    @property
    def latency_s(self) -> Optional[float]:
        """Submit to terminal wall time (queue wait included)."""
        if self.end_t is None:
            return None
        return self.end_t - self.submit_t

    @property
    def run_s(self) -> Optional[float]:
        """RUNNING to terminal wall time (None when it never ran)."""
        if self.end_t is None or self.start_t is None:
            return None
        return self.end_t - self.start_t

    def __repr__(self):
        return (f"QueryHandle(id={self.query_id}, tenant={self.tenant!r}, "
                f"pool={self.pool!r}, state={self.state})")
