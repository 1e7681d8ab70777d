"""Helpers of the port's query-service tests (tests/test_torch_service*.py,
tests/test_torch_telemetry.py): a scan gate that holds a query RUNNING at
a batch boundary until the test releases it, the process-wide state both
packages keep (fault registries, circuit breakers, health monitors,
quarantines, the executable cache, the scans' device images, the
speculation blocklists, the memory arbiters), and the shape reduction the
event record and the introspection documents are compared by.

Every hand-off is an Event with a bounded wait: no test sleeps for a
state, and no wait is unbounded (``WAIT_S``)."""

import contextlib
import faulthandler
import sys
import threading

import numpy as np

#: the bound on every wait of these tests: a hang fails its test (and the
#: dump below names where) instead of stalling the run
WAIT_S = 60.0


@contextlib.contextmanager
def per_test_timeout(seconds: float = 2 * WAIT_S):
    """Dump every thread's stack if the test outlives ``seconds`` (the
    bounded waits then fail it)."""
    faulthandler.dump_traceback_later(seconds, exit=False, file=sys.stderr)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


def reset_process_state() -> None:
    """Reset the process-wide runtime state of both packages, their scans'
    device images included (accounted in each package's memory arbiter,
    which later test files of the worker budget against)."""
    from spark_rapids_tpu.columnar.table import (
        evict_device_caches as j_evict,
    )
    from spark_rapids_tpu.runtime.faults import CIRCUIT_BREAKER as JCB
    from spark_rapids_tpu.runtime.faults import FAULTS as JF
    from spark_rapids_tpu.runtime.health import HEALTH as JH
    from spark_rapids_tpu.runtime.health import QUARANTINE as JQ
    from spark_rapids_tpu.runtime.memory import MEMORY as JMEMORY
    from spark_rapids_tpu.runtime.speculation import _BLOCKLIST
    from spark_rapids_tpu_torch.columnar.table import evict_device_caches
    from spark_rapids_tpu_torch.obs.telemetry import flush_incidents
    from spark_rapids_tpu_torch.plan.executable_cache import EXEC_CACHE
    from spark_rapids_tpu_torch.runtime.faults import (
        CIRCUIT_BREAKER,
        FAULTS,
    )
    from spark_rapids_tpu_torch.runtime.health import HEALTH, QUARANTINE
    from spark_rapids_tpu_torch.runtime.memory import MEMORY
    from spark_rapids_tpu_torch.runtime.speculation import clear_blocklist
    flush_incidents()
    for reg in (FAULTS, JF):
        reg.disarm()
    for obj in (CIRCUIT_BREAKER, JCB, HEALTH, JH, QUARANTINE, JQ):
        obj.reset()
    EXEC_CACHE.clear()
    evict_device_caches()
    j_evict()
    # the speculation blocklists and the memory arbiters are process-wide
    # in both packages: a corpus query's leftovers here (a blocklisted
    # join site, the arbiter's configured budget and ledger) would change
    # a later file's routes and spills
    _BLOCKLIST.clear()
    clear_blocklist()
    MEMORY.reset()
    JMEMORY.reset()


class ScanGate:
    """Holds the ``at``-th scan landing (1-based, counted over every
    ``TpuScanExec._land`` call while installed) until ``release``:
    ``entered`` is set when a query reaches it. A query over a
    multi-batch scan is then RUNNING between two batches."""

    def __init__(self, monkeypatch, at: int = 2):
        from spark_rapids_tpu_torch.execs.basic import TpuScanExec
        self.at = at
        self.calls = 0
        self.entered = threading.Event()
        self.release = threading.Event()
        self._lock = threading.Lock()
        real = TpuScanExec._land
        gate = self

        def land(exec_self, *args, **kwargs):
            with gate._lock:
                gate.calls += 1
                hold = gate.calls == gate.at
            if hold:
                gate.entered.set()
                if not gate.release.wait(WAIT_S):
                    raise TimeoutError("scan gate never released")
            return real(exec_self, *args, **kwargs)

        monkeypatch.setattr(TpuScanExec, "_land", land)

    def wait_entered(self) -> None:
        assert self.entered.wait(WAIT_S), "no query reached the scan gate"


def kv_table(n: int = 4096, seed: int = 3):
    """(names, types, arrays) of a seeded key/value table: k a string of
    4 values, v an int64, x a double."""
    rng = np.random.default_rng(seed)
    k = np.array(["a", "b", "c", "d"], dtype=object)[rng.integers(0, 4, n)]
    v = rng.integers(-1000, 1000, n).astype(np.int64)
    x = rng.standard_normal(n)
    ones = np.ones(n, bool)
    return (["k", "v", "x"], ["string", "bigint", "double"],
            [(k, ones), (v, ones), (x, ones)])


def port_table(spec):
    from spark_rapids_tpu_torch.interop import host_table_from_arrays
    return host_table_from_arrays(*spec)


def reference_table(spec):
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.columnar import HostColumn as JHostColumn
    from spark_rapids_tpu.columnar import HostTable as JHostTable
    names, types, arrays = spec
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, np.asarray(v, dtype=bool))
        for ty, (d, v) in zip(types, arrays)])


def as_reference(table):
    """A port HostTable as the reference's, for its comparators."""
    return reference_table(table.to_arrays())


def key_shape(obj, depth: int = 0, maps=()):
    """Nested dict keys only (values reduced to their kind), ``maps``
    keys reduced to "map": what two documents are compared by."""
    if isinstance(obj, dict) and depth < 4:
        return {k: ("map" if k in maps else key_shape(v, depth + 1, maps))
                for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        return "list"
    if isinstance(obj, bool) or obj is None:
        return "bool-or-null"
    if isinstance(obj, (int, float)):
        return "number"
    return type(obj).__name__
