"""The port's task semaphore (spark_rapids_tpu_torch/runtime/semaphore.py)
on the CPU: reentrant per thread, at most N holders across threads,
``SemaphoreTimeoutError`` on a timed-out acquisition, its ``acquires``,
``acquireWaitTime`` and ``acquireTimeouts`` counters; and queries from
several threads through one session's drain, which never has more than
``spark.rapids.sql.concurrentGpuTasks`` holders, each giving the
single-thread answer.

Comparators: counters and holder counts as integers; query results with
``scale_test.tables_differ`` (bitwise, in order)."""

import threading
import time

import numpy as np
import pytest

from scale_test import tables_differ
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.errors import SemaphoreTimeoutError
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.obs.metrics import metric_scope
from spark_rapids_tpu_torch.ops.expr import col
from spark_rapids_tpu_torch.plan import from_host_table
from spark_rapids_tpu_torch.runtime.semaphore import TpuSemaphore, acquired
from spark_rapids_tpu_torch.session import TorchSession

SCOPE = metric_scope("semaphore")


def test_reentrant_per_thread():
    sem = TpuSemaphore(1)
    a0 = SCOPE.get("acquires", 0)
    with acquired(sem):
        with acquired(sem):
            assert sem.holders == 1
        assert sem.holders == 1
    assert sem.holders == 0
    assert SCOPE.get("acquires", 0) == a0 + 1  # re-entries not counted
    with acquired(None) as nothing:
        assert nothing is None


def test_at_most_n_holders_across_threads():
    sem = TpuSemaphore(2)
    inside, peak, lock = [0], [0], threading.Lock()

    def task():
        with acquired(sem):
            with lock:
                inside[0] += 1
                peak[0] = max(peak[0], inside[0])
            time.sleep(0.02)
            with lock:
                inside[0] -= 1

    w0 = SCOPE.get("acquireWaitTime", 0.0)
    threads = [threading.Thread(target=task) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert peak[0] == 2 and sem.peak_holders == 2
    assert sem.holders == 0
    assert SCOPE.get("acquireWaitTime", 0.0) > w0  # some waited


def test_timeout_raises_typed_error():
    sem = TpuSemaphore(1)
    held, done = threading.Event(), threading.Event()

    def holder():
        with acquired(sem):
            held.set()
            done.wait(5)

    t = threading.Thread(target=holder)
    t.start()
    held.wait(5)
    t0 = SCOPE.get("acquireTimeouts", 0)
    with pytest.raises(SemaphoreTimeoutError, match="already on device"):
        sem.acquire_if_necessary(timeout=0.05)
    assert isinstance(SemaphoreTimeoutError("x"), TimeoutError)
    assert SCOPE.get("acquireTimeouts", 0) == t0 + 1
    done.set()
    t.join()
    sem.acquire_if_necessary(timeout=1.0)  # free again
    sem.release_if_held()


def test_live_resize_keeps_holders():
    sem = TpuSemaphore.initialize(3)
    assert TpuSemaphore.initialize(1) is sem and sem.max_tasks == 1
    TpuSemaphore.initialize(2)


def test_concurrent_queries_hold_at_most_the_conf_slots():
    """Four threads run one aggregate through one session under
    concurrentGpuTasks = 2: the drain's holders never exceed 2, every
    answer equals the single-thread one, each query acquired once."""
    rng = np.random.default_rng(2)
    n = 20_000
    arrays = (["k", "v"], ["bigint", "double"], [
        (rng.integers(0, 40, n), np.ones(n, bool)),
        (rng.standard_normal(n), np.ones(n, bool))])
    session = TorchSession({"spark.rapids.sql.concurrentGpuTasks": "2"},
                           device="cpu")
    df = from_host_table(host_table_from_arrays(*arrays), session, 2)
    q = df.group_by("k").agg(TF.sum(col("v")).alias("s"),
                             TF.count(col("v")).alias("c")).sort("k")
    want = q.collect_table()
    sem = TpuSemaphore.current()
    assert sem is not None and sem.max_tasks == 2
    sem.reset_peak()
    got, errors = [None] * 4, []

    def run(i):
        try:
            got[i] = q.collect_table()
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert 1 <= sem.peak_holders <= 2

    def ref(t):
        names, types, arrs = t.to_arrays()
        return JHostTable(names, [JHostColumn(JT.parse_type(ty),
                                              np.asarray(d), v)
                                  for ty, (d, v) in zip(types, arrs)])

    for g in got:
        assert tables_differ(ref(g), ref(want)) is None
