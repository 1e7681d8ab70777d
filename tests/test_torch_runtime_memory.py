"""The port's memory arbiter (spark_rapids_tpu_torch/runtime/memory.py)
against the JAX package's (spark_rapids_tpu/runtime/memory.py) on the
CPU: one sequence of reserve, account and drop gives the same snapshots
(occupancy, ledger, reservations, peak, accounted tables, violations),
the same ``budgetRaises`` and a RetryOOM at the same step; ``scan_chunks``
of one host table gives the same row splits; the per-row byte estimate
agrees for every flat type. Then what is the port's own: storages shared
by several views count once, and ``account`` makes room before it adds
bytes past the budget.

Comparators: snapshot dicts compared with ``==``; chunk row counts as
lists; host tables with ``scale_test.tables_differ`` (bitwise, in
order)."""

import gc

import numpy as np
import pytest
import torch

from scale_test import tables_differ
from spark_rapids_tpu import conf as JC
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import DeviceTable as JDeviceTable
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.errors import RetryOOM as JRetryOOM
from spark_rapids_tpu.runtime import memory as jmem
from spark_rapids_tpu.runtime.spill import BufferCatalog as JCatalog
from spark_rapids_tpu_torch import conf as TC
from spark_rapids_tpu_torch import types as TT
from spark_rapids_tpu_torch.columnar import DeviceColumn, DeviceTable
from spark_rapids_tpu_torch.errors import RetryOOM
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.runtime import memory as tmem
from spark_rapids_tpu_torch.runtime.spill import BufferCatalog, SpillableBatch

BUDGET = 100_000


@pytest.fixture(autouse=True)
def _fresh_catalogs():
    """Both packages' spill catalogs empty (the arbiters spill through
    them), and their global arbiters back to the default afterwards."""
    JCatalog.reset()
    BufferCatalog.reset()
    yield
    JCatalog.reset()
    BufferCatalog.reset()
    jmem.MEMORY.reset()
    tmem.MEMORY.reset()


def _port_table(rows: int, dtype: torch.dtype) -> DeviceTable:
    """One column of ``rows`` slots (capacity = rows) on the CPU."""
    col = DeviceColumn(TT.LONG if dtype == torch.int64 else TT.INT,
                       torch.zeros(rows, dtype=dtype),
                       torch.zeros(rows, dtype=torch.bool))
    return DeviceTable(["a"], [col], rows, rows, torch.device("cpu"))


def _ref_table(rows: int, np_dtype) -> JDeviceTable:
    ty = JT.LONG if np_dtype == np.int64 else JT.INT
    host = JHostTable(["a"], [JHostColumn(ty, np.zeros(rows, np_dtype))])
    return JDeviceTable.from_host(host, capacity=rows)


def _sequence(arb, mem_scope, make_table, retry_oom, long_t, int_t):
    """Reserve, account, refuse, release, account, drop, reserve: the
    snapshot and the budgetRaises count after every step, and the step a
    RetryOOM was raised at."""
    snaps = []
    raises0 = mem_scope.get("budgetRaises", 0)

    def snap(step):
        s = dict(arb.snapshot())
        s["budgetRaises"] = mem_scope.get("budgetRaises", 0) - raises0
        snaps.append((step, s))

    r1 = arb.reserve(30_000, label="t1")
    snap("reserve 30000")
    t1 = make_table(4096, long_t)  # 4096 x (8 + 1) = 36864 bytes
    arb.account(t1, r1)
    snap("account t1")
    r2 = arb.reserve(40_000)
    snap("reserve 40000")
    raised = None
    try:
        arb.reserve(30_000)
    except retry_oom:
        raised = "reserve 30000 over budget"
    snap("refused")
    r2.release()
    snap("release r2")
    t2 = make_table(2048, int_t)  # 2048 x (4 + 1) = 10240 bytes
    arb.account(t2)
    snap("account t2")
    arb.account(t2)  # accounted once
    snap("account t2 again")
    del t1
    gc.collect()
    snap("drop t1")
    r3 = arb.reserve(60_000)
    snap("reserve 60000")
    r3.release()
    del t2
    gc.collect()
    snap("drop t2")
    return snaps, raised


def test_arbiter_sequence_matches_reference():
    budget_conf = {"spark.rapids.memory.device.budgetBytes": str(BUDGET)}
    jarb = jmem.MemoryArbiter()
    jarb.configure(JC.RapidsConf(budget_conf))
    tarb = tmem.MemoryArbiter()
    tarb.configure(TC.RapidsConf(budget_conf))
    want, want_raise = _sequence(jarb, jmem.MEM_SCOPE, _ref_table,
                                 JRetryOOM, np.int64, np.int32)
    got, got_raise = _sequence(tarb, tmem.MEM_SCOPE, _port_table, RetryOOM,
                               torch.int64, torch.int32)
    assert got_raise == want_raise == "reserve 30000 over budget"
    assert got == want
    assert got[-1][1]["occupancyBytes"] == 0
    assert got[3][1]["budgetRaises"] == 1


def _mixed_host(n: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    names = ["l", "d", "i", "s", "dt", "b", "dec"]
    types = ["bigint", "double", "int", "string", "date", "boolean",
             "decimal(12,2)"]
    arrays = [
        (rng.integers(-9, 9, n), rng.random(n) > 0.1),
        (rng.standard_normal(n), np.ones(n, bool)),
        (rng.integers(0, 99, n).astype(np.int32), np.ones(n, bool)),
        (np.array([f"s{v}" for v in rng.integers(0, 50, n)], dtype=object),
         rng.random(n) > 0.2),
        (rng.integers(0, 20000, n).astype(np.int32), np.ones(n, bool)),
        (rng.random(n) > 0.5, np.ones(n, bool)),
        (rng.integers(-10**9, 10**9, n), np.ones(n, bool)),
    ]
    port = host_table_from_arrays(names, types, arrays)
    ref = JHostTable(names, [JHostColumn(JT.parse_type(t), np.asarray(d),
                                         np.asarray(v, dtype=bool))
                             for t, (d, v) in zip(types, arrays)])
    return port, ref


@pytest.mark.parametrize("budget,fraction", [(1 << 20, "0.25"),
                                             (200_000, "0.5"),
                                             (64 << 20, "0.25")])
def test_scan_chunks_match_reference(budget, fraction):
    """The same row splits of one host table (every column a flat type,
    where the two byte tables agree), and the same ``scanChunks``."""
    conf = {"spark.rapids.memory.device.budgetBytes": str(budget),
            "spark.rapids.memory.device.scanChunkFraction": fraction}
    jmem.MEMORY.configure(JC.RapidsConf(conf))
    tmem.MEMORY.configure(TC.RapidsConf(conf))
    port, ref = _mixed_host(30_000)
    j0 = jmem.MEM_SCOPE.get("scanChunks", 0)
    t0 = tmem.MEM_SCOPE.get("scanChunks", 0)
    want = [c.num_rows for c in jmem.scan_chunks(ref)]
    got_chunks = tmem.scan_chunks(port)
    assert [c.num_rows for c in got_chunks] == want
    assert (tmem.MEM_SCOPE.get("scanChunks", 0) - t0
            == jmem.MEM_SCOPE.get("scanChunks", 0) - j0)
    assert tmem.estimate_device_nbytes(port) == \
        jmem.estimate_device_nbytes(ref)
    assert tmem.MEMORY.scan_chunk_bytes() == jmem.MEMORY.scan_chunk_bytes()
    if len(want) > 1:
        # the chunks are the table's rows in order
        from spark_rapids_tpu_torch.columnar.table import concat_host
        back = concat_host(got_chunks)
        assert back.num_rows == port.num_rows
        names, types, arrays = back.to_arrays()
        assert tables_differ(JHostTable(names, [
            JHostColumn(JT.parse_type(t), np.asarray(d), v)
            for t, (d, v) in zip(types, arrays)]), ref) is None


@pytest.mark.parametrize("type_name", [
    "boolean", "tinyint", "smallint", "int", "bigint", "float", "double",
    "date", "timestamp", "string", "decimal(10,2)", "decimal(18,0)",
    "decimal(38,6)"])
def test_row_bytes_match_reference(type_name):
    """Every flat type lands at the reference's bytes a row (nested
    types take the reference's 8 + 1 too: tests/
    test_torch_nested_columns.py counts their buffers)."""
    assert tmem._device_row_bytes(TT.parse_type(type_name)) == \
        jmem._device_row_bytes(JT.parse_type(type_name))


def test_shared_storage_counts_once():
    """The masked views of one split share their buffers: the ledger
    counts the buffers once however many views are accounted (a ledger
    by view, the reference's, would count this split four times)."""
    arb = tmem.MemoryArbiter()
    arb.configure(TC.RapidsConf(
        {"spark.rapids.memory.device.budgetBytes": str(BUDGET)}))
    base = _port_table(4096, torch.int64)
    views = []
    for p in range(4):
        live = torch.arange(4096) % 4 == p
        v = DeviceTable(base.names, base.columns, int(live.sum()), 4096,
                        base.device, live=live)
        views.append(v)
        arb.account(v)
    assert arb.snapshot()["ledgerBytes"] == base.device_nbytes() == 36864
    assert arb.snapshot()["accountedTables"] == 4
    # a view of the first rows is the same storage too
    arb.account(DeviceTable(base.names, [c.with_arrays(c.data[:128],
                                                       c.validity[:128])
                                         for c in base.columns], 100, 128,
                            base.device))
    assert arb.snapshot()["ledgerBytes"] == 36864
    del views, v, base
    gc.collect()
    assert arb.snapshot()["ledgerBytes"] == 0


def test_account_makes_room_before_adding():
    """An unreserved account past the budget (a kernel output registered
    as a spillable) spills idle catalog entries first: the spillable
    moves to the host, the peak never passes the budget and no violation
    is counted."""
    conf = {"spark.rapids.memory.device.budgetBytes": "60000"}
    tmem.MEMORY.reset()
    tmem.MEMORY.configure(TC.RapidsConf(conf))
    v0 = tmem.MEM_SCOPE.get("budgetViolations", 0)
    catalog = BufferCatalog.get()
    idle = SpillableBatch(_port_table(4096, torch.int64), catalog)
    tmem.MEMORY.reset_peak()
    busy = SpillableBatch(_port_table(4096, torch.int64), catalog)
    assert idle.tier == "HOST" and busy.tier == "DEVICE"
    assert tmem.MEMORY.peak_bytes() <= 60000
    assert tmem.MEM_SCOPE.get("budgetViolations", 0) == v0
    # pinned, nothing can move: a third account is a violation
    with busy.pinned_batch():
        t3 = tmem.MEMORY.account(_port_table(4096, torch.int64))
        assert tmem.MEM_SCOPE.get("budgetViolations", 0) == v0 + 1
    del t3
    idle.release()
    busy.release()


def test_forced_chunking_overrides_the_budget_share():
    """Inside ``forced_chunking`` every scan chunks to the forced bytes, as
    the reference's (its memory ladder's 'chunk' rung sets it)."""
    conf = {"spark.rapids.memory.device.budgetBytes": str(64 << 20)}
    jmem.MEMORY.configure(JC.RapidsConf(conf))
    tmem.MEMORY.configure(TC.RapidsConf(conf))
    port, ref = _mixed_host(30_000)
    assert len(tmem.scan_chunks(port)) == 1
    with tmem.forced_chunking(100_000), jmem.forced_chunking(100_000):
        assert tmem.forced_chunk_bytes() == 100_000
        want = [c.num_rows for c in jmem.scan_chunks(ref)]
        assert [c.num_rows for c in tmem.scan_chunks(port)] == want
        assert len(want) > 1
    assert tmem.forced_chunk_bytes() is None


def test_host_arbiter_spills_the_host_tier_then_raises():
    """The host arbiter (HostAlloc): grants within its limit, grants a
    request of the whole limit alone, frees host memory by moving the
    spill catalog's host tier to disk, then waits and raises CpuRetryOOM;
    the pinned pool hands out page-locked buffers (pageable here, where
    there is no CUDA), None when empty or too small, and refuses a double
    release."""
    from spark_rapids_tpu_torch.errors import (
        ColumnarProcessingError,
        CpuRetryOOM,
    )
    from spark_rapids_tpu_torch.runtime.host_alloc import (
        HostMemoryArbiter,
        PinnedMemoryPool,
    )
    arb = HostMemoryArbiter.reset(1000)
    a = arb.alloc(600)
    assert arb.used_bytes == 600
    whole = arb.alloc(1000)  # alone: it may pass the limit
    assert arb.used_bytes == 1600
    whole.release()
    catalog = BufferCatalog.get()
    sb = SpillableBatch(_port_table(1024, torch.int64), catalog)
    sb.spill_to_host()
    assert sb.tier == "HOST"
    with pytest.raises(CpuRetryOOM, match="host memory exhausted"):
        arb.alloc(500, timeout_s=0.05)
    assert sb.tier == "DISK" and arb.spill_triggered_count == 1
    a.release()
    with arb.alloc(500):
        assert arb.used_bytes == 500
    assert arb.used_bytes == 0
    sb.release()
    pool = PinnedMemoryPool.initialize(2 << 20, buffer_bytes=1 << 20)
    assert PinnedMemoryPool.get() is pool and pool.total_buffers == 2
    assert pool.acquire(2 << 20) is None  # larger than a buffer
    b1, b2 = pool.acquire(100), pool.acquire(100)
    assert b1.dtype == torch.uint8 and b1.numel() == 1 << 20
    assert pool.acquire(100) is None and pool.misses == 2
    pool.release(b1)
    pool.release(b2)
    with pytest.raises(ColumnarProcessingError, match="double release"):
        pool.release(b2)
    assert PinnedMemoryPool.initialize(0) is None


def test_a_finalizer_run_inside_the_lock_does_not_deadlock():
    """The garbage collector may free an accounted table (its release
    callback takes the arbiter's lock) in the middle of an arbiter call on
    the same thread: the lock is reentrant, so the collection returns and
    the bytes are released."""
    import threading
    arb = tmem.MemoryArbiter()
    arb.configure(TC.RapidsConf(
        {"spark.rapids.memory.device.budgetBytes": str(BUDGET)}))
    t = _port_table(1024, torch.int64)
    arb.account(t)
    cycle = [t]
    cycle.append(cycle)  # only the cyclic collector frees it
    del t, cycle
    done = []

    def collect_inside_the_lock():
        with arb._lock:
            gc.collect()
        done.append(arb.snapshot()["ledgerBytes"])

    th = threading.Thread(target=collect_inside_the_lock, daemon=True)
    th.start()
    th.join(10)
    assert done == [0]
