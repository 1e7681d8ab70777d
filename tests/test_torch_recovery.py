"""The runtime's fault boundaries, recovery and crash handling in the
PyTorch port (spark_rapids_tpu_torch: ``runtime/faults.py``'s circuit
breaker, exec boundaries and ``mem.*`` points, ``runtime/health.py``,
``runtime/crash_handler.py`` and ``TorchSession._execute_with_recovery``)
against the reference on the same inputs and fault schedules: the cases
of ``tests/test_faults_recovery.py:543-635`` (a transient crash replays,
the switch off surfaces the crash, every fault point names an existing
site) and ``tests/test_memory.py:254``/``:288`` (the memory ladder's unit
walk, and end to end), the CUDA classification from constructed errors,
the crash report's contents and the exit-20 protocol. Where the port
raises instead of moving work to a CPU path, the test's name says so.
Results compare with ``scale_test.tables_differ`` (bit for bit), the
chunked replay with ``scale_test.tables_close`` (its f64 sums add
per-chunk partials)."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from scale_test import tables_close, tables_differ
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.errors import DeviceLostError as JDeviceLostError
from spark_rapids_tpu.errors import KernelCrashError as JKernelCrashError
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.ops.expr import lit as jlit
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.runtime import faults as jfaults
from spark_rapids_tpu.runtime import health as jhealth
from spark_rapids_tpu.runtime import retry as jretry
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import DeviceColumn, DeviceTable
from spark_rapids_tpu_torch.columnar.table import evict_device_caches
from spark_rapids_tpu_torch.errors import (
    DeviceLostError,
    FatalDeviceOOM,
    KernelCrashError,
    RetryOOM,
    SpillCorruptionError,
)
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.models.tpch import lineitem_table, q1_dataframe
from spark_rapids_tpu_torch.ops.expr import col, lit
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.runtime import crash_handler as CH
from spark_rapids_tpu_torch.runtime import faults as tfaults
from spark_rapids_tpu_torch.runtime import health as thealth
from spark_rapids_tpu_torch.runtime import retry as tretry
from spark_rapids_tpu_torch.runtime.memory import (
    MEMORY,
    estimate_device_nbytes,
)
from spark_rapids_tpu_torch.runtime.spill import BufferCatalog, SpillableBatch
from spark_rapids_tpu_torch.session import TorchSession

ROOT = pathlib.Path(__file__).resolve().parent.parent
NO_CACHE = {"spark.rapids.sql.executableCache.enabled": "false"}


def _reset():
    """Both packages' process-wide recovery state: armed faults, the
    breakers, the health monitors and this thread's injections."""
    for mod in (jfaults, tfaults):
        mod.FAULTS.disarm()
        mod.CIRCUIT_BREAKER.reset()
    jhealth.HEALTH.reset()
    thealth.HEALTH.reset()
    jretry.RMM_TPU.clear()
    tretry.RMM_TPU.clear()
    evict_device_caches()


@pytest.fixture(autouse=True)
def _fresh():
    _reset()
    yield
    _reset()


def _tables(names, types, arrays):
    """Fresh port and reference HostTables of the same columns (fresh, so
    no scan's device cache serves a landing the faults should meet)."""
    t = host_table_from_arrays(names, types, arrays)
    return t, JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), c.data, c.validity)
        for ty, c in zip(types, t.columns)])


def _as_reference(t) -> JHostTable:
    names, types, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, v)
        for ty, (d, v) in zip(types, arrays)])


def _keyed(n=600, seed=1):
    rng = np.random.default_rng(seed)
    ones = np.ones(n, dtype=np.bool_)
    return (["k", "v"], ["bigint", "double"],
            [(rng.integers(0, 7, n), ones), (rng.random(n), ones)])


def _agg_query(s, frm, api_col, api_lit, Fn, table):
    return (frm(table, s).filter(api_col("v") > api_lit(0.25))
            .group_by("k").agg(Fn.sum("v").alias("sv"),
                               Fn.count().alias("c")).sort("k"))


def _filter_query(s, frm, api_col, api_lit, Fn, table):
    return frm(table, s).filter(api_col("v") > api_lit(0.25))


def _run_both(port_conf, ref_conf, query=_agg_query):
    """``query`` on both engines, each on fresh tables: (port table,
    reference table, port session, reference session)."""
    pt, rt = _tables(*_keyed())
    ps = TorchSession(port_conf, device="cpu")
    rs = TpuSession({**NO_CACHE, **ref_conf})
    got = query(ps, tfrom, col, lit, F, pt).collect_table()
    want = query(rs, jfrom, jcol, jlit, JF, rt).collect_table()
    return got, want, ps, rs


def _plain(query=_agg_query):
    pt, _ = _tables(*_keyed())
    return query(TorchSession(device="cpu"), tfrom, col, lit, F,
                 pt).collect_table()


# -- the circuit breaker and the exec boundaries ------------------------------

def test_transient_crash_replays_without_tripping():
    conf = {"spark.rapids.test.faults": "exec.execute@Filter:crash:1",
            "spark.rapids.sql.runtimeFallback.maxFailures": "2"}
    got, want, ps, rs = _run_both(conf, conf, _filter_query)
    assert tables_differ(_as_reference(got), want) is None
    assert tables_differ(got, _plain(_filter_query)) is None
    assert ps.last_metrics()["runtimeFaultReplays"] == \
        rs.last_fault_replays == 1
    assert ps.last_metrics()["query_replays"] == 1
    assert tfaults.CIRCUIT_BREAKER.tripped_ops() == {}
    assert jfaults.CIRCUIT_BREAKER.demoted_ops() == {}


def test_runtime_fallback_disabled_surfaces_the_crash():
    conf = {"spark.rapids.test.faults": "exec.execute@Filter:crash:999",
            "spark.rapids.sql.runtimeFallback.enabled": "false"}
    pt, rt = _tables(*_keyed())
    with pytest.raises(KernelCrashError) as e:
        tfrom(pt, TorchSession(conf, device="cpu")).filter(
            col("v") > lit(0.5)).collect_table()
    assert e.value.fault_op == "Filter"
    with pytest.raises(JKernelCrashError):
        jfrom(rt, TpuSession({**NO_CACHE, **conf})).filter(
            jcol("v") > jlit(0.5)).collect_table()
    assert tfaults.CIRCUIT_BREAKER.tripped_ops() == {}
    assert jfaults.CIRCUIT_BREAKER.demoted_ops() == {}


def test_deterministic_crash_raises_where_the_reference_demotes():
    """A Filter that crashes every time: the reference's breaker demotes it
    to the CPU at the second failure and the query answers; the port's
    breaker trips at the same failure and raises KernelCrashError with
    ``fault_op`` and the breaker's reason, and every later conversion of a
    Filter raises it until the breaker resets."""
    conf = {"spark.rapids.test.faults": "exec.execute@Filter:crash:999",
            "spark.rapids.sql.runtimeFallback.maxFailures": "2"}
    pt, rt = _tables(*_keyed())
    ps = TorchSession(conf, device="cpu")
    with pytest.raises(KernelCrashError, match="circuit breaker") as e:
        tfrom(pt, ps).filter(col("v") > lit(0.5)).collect_table()
    assert e.value.fault_op == "Filter"
    assert "CPU path, which is not ported" in str(e.value)
    reason = tfaults.CIRCUIT_BREAKER.reason("Filter")
    assert "tripped after 2 device failures" in reason
    assert "injected kernel crash" in reason
    want = jfrom(rt, TpuSession({**NO_CACHE, **conf})).filter(
        jcol("v") > jlit(0.5)).collect_table()
    assert "Filter" in jfaults.CIRCUIT_BREAKER.demoted_ops()
    tfaults.FAULTS.disarm()
    with pytest.raises(KernelCrashError, match="circuit breaker"):
        tfrom(pt, TorchSession(device="cpu")).filter(
            col("v") > lit(0.5)).collect_table()
    tfaults.CIRCUIT_BREAKER.reset()
    got = tfrom(pt, TorchSession(device="cpu")).filter(
        col("v") > lit(0.5)).collect_table()
    assert tables_differ(_as_reference(got), want) is None


def test_boundaries_tag_the_innermost_converted_exec():
    """An injected crash under the aggregate is attributed to the plan
    node whose exec it crossed first (a helper coalesce carries none),
    and the replayed query equals the plain one."""
    s = TorchSession({"spark.rapids.test.faults":
                      "exec.execute@TpuCoalesceExec:crash:1;"
                      "exec.execute@LocalScan:crash:1"}, device="cpu")
    pt, _ = _tables(*_keyed())
    got = _agg_query(s, tfrom, col, lit, F, pt).collect_table()
    assert tables_differ(got, _plain()) is None
    assert s.last_metrics()["runtimeFaultReplays"] == 2
    # the first coalesce drained is the sort's
    assert tfaults.CIRCUIT_BREAKER._failures == {"Sort": 1, "LocalScan": 1}
    assert all(getattr(e, "_fault_guarded", False)
               for e in _execs(s._last_root))
    origins = {getattr(e, "_plan_origin", None) for e in _execs(s._last_root)}
    assert {"Aggregate", "Filter", "LocalScan", "Sort", None} >= origins


def _execs(root):
    out, stack = [], [root]
    while stack:
        e = stack.pop()
        out.append(e)
        stack.extend(e.children)
    return out


def _fault_calls(root: pathlib.Path):
    """{point: {module relative paths}} of every fault_point("...") call."""
    calls = {}
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", getattr(node.func, "attr", None)) \
                    == "fault_point" and node.args and isinstance(
                        node.args[0], ast.Constant):
                calls.setdefault(node.args[0].value, set()).add(
                    str(path.relative_to(ROOT)))
    return calls


def test_every_fault_point_names_an_existing_site():
    """The registry and the call sites cannot drift: every registered
    point has a call in the module it names, and every call names a
    registered point (the reference's RL-FAULT-POINT contract); the
    points the reference keeps for this port's modules are here."""
    calls = _fault_calls(ROOT / "spark_rapids_tpu_torch")
    assert set(calls) == set(tfaults.FAULT_POINTS)
    for point, (module, _doc) in tfaults.FAULT_POINTS.items():
        assert module in calls[point], (point, module, calls[point])
    assert {"exec.execute", "mem.reserve", "mem.spill", "mem.unspill"} <= \
        set(tfaults.FAULT_POINTS) <= set(jfaults.FAULT_POINTS)


# -- the memory ladder -----------------------------------------------------------

def test_memory_ladder_unit_walk():
    conf = TorchSession(device="cpu").conf
    exc = FatalDeviceOOM("device OOM persisted after 2 spill-retries")
    jexc = jhealth.HEALTH  # noqa: F841 (walked below with the same rungs)
    H = thealth.HEALTH
    assert H.on_memory_pressure(exc, conf) == "retry"
    assert H.on_memory_pressure(exc, conf) == "chunk"
    assert H.on_memory_pressure(exc, conf) == "abort"
    exc.fault_op = "SomeOp"
    assert H.on_memory_pressure(exc, conf) == "abort"
    err = H.abort_error(exc)
    assert isinstance(err, FatalDeviceOOM) and err.fault_op == "SomeOp"
    assert "cpu_demote" in str(err) and "2 spill-retries" in str(err)
    snap = H.snapshot()
    assert (snap["memoryPressureEvents"], snap["memoryChunkedReexecutions"],
            snap["memoryConsecutive"]) == (4, 1, 4)
    H.note_success()
    assert H.snapshot()["memoryConsecutive"] == 0
    # the reference's rungs, for the same escalations: the same two, then
    # its CPU demotion where an op is attributed
    from spark_rapids_tpu.conf import RapidsConf
    from spark_rapids_tpu.errors import FatalDeviceOOM as JFatal
    jconf = RapidsConf({})
    jx = JFatal("device OOM persisted after 2 spill-retries")
    assert [jhealth.HEALTH.on_memory_pressure(jx, jconf)
            for _ in range(3)] == ["retry", "chunk", "abort"]
    jx.fault_op = "SomeOp"
    assert jhealth.HEALTH.on_memory_pressure(jx, jconf) == "cpu_demote"


@pytest.mark.parametrize("n,rungs", [(3, (1, 0)), (6, (2, 1))],
                         ids=["retry rung", "chunk rung"])
def test_memory_ladder_end_to_end(n, rungs):
    """``mem.reserve:oom:N`` past the two OOM retries of each attempt
    walks the ladder: 3 injections fail one attempt (rung ``retry``), 6
    fail two (``retry``, then ``chunk``); the replay equals the
    reference's run of the same schedule and the plain query, bit for
    bit."""
    conf = {"spark.rapids.test.faults": f"mem.reserve:oom:{n}"}
    got, want, ps, rs = _run_both(conf, conf)
    assert tables_differ(_as_reference(got), want) is None
    assert tables_differ(got, _plain()) is None
    m = ps.last_metrics()
    assert (m.get("memoryPressure", 0),
            m.get("memoryChunkedReexecutions", 0)) == rungs
    assert m["oomRetries"] == 2 * rungs[0]
    assert m["query_replays"] == rungs[0]
    jsnap = jhealth.HEALTH.memory_snapshot()
    assert (jsnap["memoryPressureEvents"],
            jsnap["memoryChunkedReexecutions"]) == rungs


def test_memory_ladder_abort_raises_where_the_reference_demotes():
    """Nine injections fail three attempts: the reference demotes the
    attributed scan to its CPU path and answers; the port re-raises the
    FatalDeviceOOM with its ``fault_op``, naming the rung."""
    conf = {"spark.rapids.test.faults": "mem.reserve:oom:9"}
    pt, rt = _tables(*_keyed())
    ps = TorchSession(conf, device="cpu")
    with pytest.raises(FatalDeviceOOM, match="cpu_demote") as e:
        _agg_query(ps, tfrom, col, lit, F, pt).collect_table()
    assert e.value.fault_op == "LocalScan"
    assert ps.last_metrics()["memoryPressure"] == 3
    want = _agg_query(TpuSession({**NO_CACHE, **conf}), jfrom, jcol, jlit,
                      JF, rt).collect_table()
    assert jhealth.HEALTH.memory_snapshot()["memoryCpuDemotions"] == 1
    assert tables_differ(_as_reference(_plain()), want) is None


def test_more_retryable_injections_than_retries_walk_the_ladder():
    """``injectRetryOOM`` arms its OOMs on every attempt, as the
    reference's: each attempt fails, the ladder walks retry and chunk,
    then raises the FatalDeviceOOM."""
    s = TorchSession({"spark.rapids.sql.test.injectRetryOOM": "retry:3"},
                     device="cpu")
    pt, _ = _tables(*_keyed())
    with pytest.raises(FatalDeviceOOM, match="2 spill-retries"):
        tfrom(pt, s).collect_table()
    m = s.last_metrics()
    assert (m["memoryPressure"], m["memoryChunkedReexecutions"],
            m["oomRetries"]) == (3, 1, 6)


def test_squeezed_budget_walks_the_chunk_rung():
    """A budget whose free part, beside an unspillable ballast (a
    co-resident query's pinned working set), holds three quarters of one
    scan chunk of q1's lineitem: the first attempt and rung ``retry``'s
    full spill fail at the landing; rung ``chunk``'s half-share chunks
    fit. The result equals the unsqueezed q1 (f64 sums within 1e-9)."""
    t = lineitem_table(40_000, 3)
    want = q1_dataframe(TorchSession(device="cpu"), t).collect_table()
    cap = 1 << (t.num_rows - 1).bit_length()
    budget = estimate_device_nbytes(t, cap)
    per_row = budget / cap
    rows = 128
    while rows * 2 <= int(budget * 0.25 / per_row):
        rows *= 2
    chunk = int(per_row * rows)
    s = TorchSession({"spark.rapids.memory.device.budgetBytes":
                      str(budget)}, device="cpu")
    MEMORY.configure(s.conf)
    n = (budget - 3 * chunk // 4) // 9
    ballast = DeviceTable(["b"], [DeviceColumn(
        T.LONG, torch.ones(n, dtype=torch.int64),
        torch.ones(n, dtype=torch.bool))], n, n, torch.device("cpu"))
    MEMORY.account(ballast)
    try:
        got = q1_dataframe(s, t).collect_table()
    finally:
        del ballast
    m = s.last_metrics()
    assert (m["memoryPressure"], m["memoryChunkedReexecutions"]) == (2, 1)
    assert tables_close(_as_reference(got), _as_reference(want),
                        rtol=1e-9) is None


# -- the spill points ---------------------------------------------------------

def _small_batch(n=1000):
    return DeviceTable(["x"], [DeviceColumn(
        T.LONG, torch.arange(n, dtype=torch.int64),
        torch.ones(n, dtype=torch.bool))], n, n, torch.device("cpu"))


def test_spill_crash_leaves_the_buffer_on_the_device(tmp_path):
    cat = BufferCatalog(disk_dir=str(tmp_path))
    sb = SpillableBatch(_small_batch(), cat)
    tfaults.FAULTS.arm("mem.spill:crash:1")
    with pytest.raises(KernelCrashError, match="mem.spill"):
        sb.spill_to_host()
    assert sb.tier == "DEVICE"
    assert sb.spill_to_host() > 0  # the schedule is spent
    assert sb.tier == "HOST"
    sb.release()


def test_unspill_corruption_is_caught_by_the_crc(tmp_path):
    cat = BufferCatalog(disk_dir=str(tmp_path))
    sb = SpillableBatch(_small_batch(), cat)
    assert sb.spill_to_host() and sb.spill_to_disk()
    tfaults.FAULTS.arm("mem.unspill:corrupt:1:5")
    with pytest.raises(SpillCorruptionError, match="CRC") as e:
        sb.get()
    assert isinstance(e.value, KernelCrashError)
    assert tfaults.FAULTS.counters() == {"mem.unspill": 1}
    sb.release()


def test_unspill_corruption_replays_the_query(tmp_path):
    """A corrupt disk-tier frame mid-query raises SpillCorruptionError, a
    KernelCrashError, so the query replays and re-lands the data: the
    result equals the unsqueezed one, bit for bit."""
    names, types, arrays = _keyed(20_000, 9)
    pt, _ = _tables(names, types, arrays)
    want = tfrom(pt, TorchSession(device="cpu"), num_batches=4) \
        .sort("v").collect_table()
    conf = {"spark.rapids.memory.device.budgetBytes": str(200_000),
            "spark.rapids.memory.host.spillStorageSize": "1",
            "spark.rapids.test.faults": "mem.unspill:corrupt:1:3"}
    BufferCatalog.reset(host_limit_bytes=1, disk_dir=str(tmp_path))
    try:
        s = TorchSession(conf, device="cpu")
        got = tfrom(pt, s, num_batches=4).sort("v").collect_table()
    finally:
        BufferCatalog.reset()
    m = s.last_metrics()
    assert tfaults.FAULTS.counters().get("mem.unspill") == 1
    # (the memory and spill scopes both count the corruption)
    assert m["spillCorruptions"] >= 1 and m["runtimeFaultReplays"] == 1
    assert tables_differ(got, want) is None


def test_a_corruption_counts_once_in_last_metrics(tmp_path):
    """ROADMAP Queue 3 item 8: the spill catalog's ``spill`` scope and the
    arbiter's ``memory`` scope both count one corrupt frame, as the
    reference's event record shows it (once in each scope); the
    session's ``last_metrics()`` reports that one corruption once, not
    their sum."""
    names, types, arrays = _keyed(20_000, 9)
    pt, _ = _tables(names, types, arrays)
    conf = {"spark.rapids.memory.device.budgetBytes": str(200_000),
            "spark.rapids.memory.host.spillStorageSize": "1",
            "spark.rapids.test.faults": "mem.unspill:corrupt:1:3",
            "spark.rapids.sql.eventLog.enabled": "true",
            "spark.rapids.sql.eventLog.dir": str(tmp_path / "log")}
    BufferCatalog.reset(host_limit_bytes=1, disk_dir=str(tmp_path))
    try:
        s = TorchSession(conf, device="cpu")
        tfrom(pt, s, num_batches=4).sort("v").collect_table()
    finally:
        BufferCatalog.reset()
    assert tfaults.FAULTS.counters().get("mem.unspill") == 1
    scopes = s.last_event_record["scopes"]
    assert scopes["memory"]["spillCorruptions"] == 1
    assert scopes["spill"]["spillCorruptions"] == 1
    assert s.last_metrics()["spillCorruptions"] == 1


# -- device loss and crash handling ---------------------------------------------

CUDA_FATAL = (
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: device-side assert triggered",
    "CUDA error: unspecified launch failure",
    "CUDA error: misaligned address",
    "CUDA error: uncorrectable ECC error encountered",
    "CUDA error: CUDA-capable device(s) is/are busy or unavailable",
)


@pytest.mark.parametrize("text", CUDA_FATAL)
def test_fatal_cuda_errors_are_classified(text):
    msg = (f"{text}\nCUDA kernel errors might be asynchronously reported at "
           "some other API call, so the stacktrace below might be "
           "incorrect.")
    assert CH.is_fatal_device_error(RuntimeError(msg))
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        assert CH.is_fatal_device_error(accel(msg))
    assert not CH.is_fatal_device_error(ValueError(msg))


def test_what_is_not_a_fatal_device_error():
    assert CH.is_fatal_device_error(DeviceLostError("injected"))
    for exc in (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                            "allocate 2.00 GiB"),
                RuntimeError("CUDA error: out of memory"),
                RetryOOM("device budget exhausted"),
                KernelCrashError("CUDA error: an illegal memory access"),
                RuntimeError("an illegal memory access in Python code")):
        assert not CH.is_fatal_device_error(exc), exc


def test_crash_report_contents(tmp_path):
    from spark_rapids_tpu_torch.conf import RapidsConf
    conf = RapidsConf({"spark.rapids.memory.crashDump.dir": str(tmp_path)})
    try:
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")
    except RuntimeError as caught:
        exc = caught
    exc.fault_op = "Aggregate"
    path = CH.write_crash_report(exc, conf, "TpuHashAggregateExec")
    report = json.loads(pathlib.Path(path).read_text())
    assert report["exception_type"] == "RuntimeError"
    assert "illegal memory access" in report["exception"]
    assert "raise RuntimeError" in report["traceback"]
    assert report["plan"] == "TpuHashAggregateExec"
    assert report["fault_op"] == "Aggregate"
    assert "Thread MainThread" in report["thread_dump"]
    assert {"buffers", "device_bytes", "host_bytes"} <= set(
        report["buffer_catalog"])
    assert "cuda_available" in report["device"]
    # a report that cannot be written returns None and never raises
    bad = RapidsConf({"spark.rapids.memory.crashDump.dir":
                      str(tmp_path / "f" / "x")})
    (tmp_path / "f").write_text("a file where a directory should be")
    assert CH.write_crash_report(exc, bad) is None


def test_dump_table_writes_parquet_through_the_port(tmp_path):
    pt, _ = _tables(*_keyed(50))
    path = CH.dump_table(pt, str(tmp_path / "t.parquet"))
    back = TorchSession(device="cpu").read_parquet(path).collect_table()
    assert tables_differ(back, pt) is None


def test_transient_device_loss_recovers_on_the_device(tmp_path):
    """An injected loss writes a report naming the plan, raises
    DeviceLostError (as the reference's does), counts a re-initialisation
    after the context probe, and the next query runs and matches."""
    conf = {"spark.rapids.test.faults": "exec.execute:device_lost:1",
            "spark.rapids.memory.crashDump.dir": str(tmp_path)}
    pt, rt = _tables(*_keyed())
    ps = TorchSession(conf, device="cpu")
    with pytest.raises(DeviceLostError, match="the next query runs") as e:
        _agg_query(ps, tfrom, col, lit, F, pt).collect_table()
    report = json.loads(pathlib.Path(e.value.report_path).read_text())
    assert "TpuHashAggregateExec <- Aggregate" in report["plan"]
    assert report["exception_type"] == "DeviceLostError"
    m = ps.last_metrics()
    assert (m["deviceLost"], m["deviceReinits"]) == (1, 1)
    got = _agg_query(ps, tfrom, col, lit, F, pt).collect_table()
    assert tables_differ(got, _plain()) is None
    assert thealth.HEALTH.snapshot()["consecutiveLosses"] == 0
    with pytest.raises(JDeviceLostError):
        _agg_query(TpuSession({**NO_CACHE, **conf}), jfrom, jcol, jlit, JF,
                   rt).collect_table()


def test_device_loss_latch_raises_where_the_reference_demotes(tmp_path):
    """Past ``deviceLoss.maxReinits`` consecutive losses the reference
    latches CPU-only mode; the port latches the process, and every later
    execute raises DeviceLostError naming the latch and the report."""
    conf = {"spark.rapids.test.faults": "exec.execute:device_lost:2",
            "spark.rapids.service.deviceLoss.maxReinits": "2",
            "spark.rapids.memory.crashDump.dir": str(tmp_path)}
    pt, _ = _tables(*_keyed())
    s = TorchSession(conf, device="cpu")
    with pytest.raises(DeviceLostError, match="the next query runs"):
        tfrom(pt, s).collect_table()
    with pytest.raises(DeviceLostError, match="latched after 2 consecutive"):
        tfrom(pt, s).collect_table()
    tfaults.FAULTS.disarm()
    with pytest.raises(DeviceLostError, match="latched") as e:
        tfrom(pt, TorchSession(device="cpu")).collect_table()
    assert "crash report" in str(e.value) and "CPU-only" in str(e.value)
    assert thealth.HEALTH.snapshot()["latched"]


def test_failed_context_probe_latches_at_once(tmp_path, monkeypatch):
    monkeypatch.setattr(thealth, "_probe_context",
                        lambda device: "RuntimeError: CUDA error: "
                                       "device-side assert triggered")
    conf = {"spark.rapids.test.faults": "exec.execute:device_lost:1",
            "spark.rapids.memory.crashDump.dir": str(tmp_path)}
    pt, _ = _tables(*_keyed())
    with pytest.raises(DeviceLostError, match="context probe failed"):
        tfrom(pt, TorchSession(conf, device="cpu")).collect_table()
    assert thealth.HEALTH.snapshot()["deviceReinits"] == 0
    with pytest.raises(DeviceLostError, match="latched"):
        tfrom(pt, TorchSession(device="cpu")).collect_table()


def test_fatal_error_exit_code_and_report(tmp_path):
    """Under ``spark.rapids.fatalError.exit`` a fatal device error exits
    the process with 20 after writing the report."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import numpy as np\n"
        "from spark_rapids_tpu_torch.interop import host_table_from_arrays\n"
        "from spark_rapids_tpu_torch.plan import from_host_table\n"
        "from spark_rapids_tpu_torch.session import TorchSession\n"
        "s = TorchSession({'spark.rapids.test.faults': "
        "'exec.execute:device_lost:1', 'spark.rapids.fatalError.exit': "
        f"'true', 'spark.rapids.memory.crashDump.dir': {str(tmp_path)!r}}},"
        " device='cpu')\n"
        "t = host_table_from_arrays(['a'], ['bigint'], "
        "[(np.arange(10), np.ones(10, bool))])\n"
        "from_host_table(t, s).collect_table()\n"
        "print('not reached')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == CH.FATAL_EXIT_CODE == 20, out.stderr
    assert "not reached" not in out.stdout
    reports = list(tmp_path.glob("crash_*.json"))
    assert len(reports) == 1
    report = json.loads(reports[0].read_text())
    assert "TpuScanExec <- LocalScan" in report["plan"]


def test_an_escaped_retryable_oom_walks_the_ladder():
    """A RetryOOM raised where no retry block wraps it (here at the
    filter's boundary) escapes to the session, which wraps it as a
    FatalDeviceOOM and walks the ladder's ``retry`` rung, as the
    reference's does; the replay equals the reference's run."""
    conf = {"spark.rapids.test.faults": "exec.execute@Filter:oom:1"}
    got, want, ps, _ = _run_both(conf, conf, _filter_query)
    assert tables_differ(_as_reference(got), want) is None
    m = ps.last_metrics()
    assert (m["memoryPressure"], m["query_replays"]) == (1, 1)
    assert jhealth.HEALTH.memory_snapshot()["memoryPressureEvents"] == 1


def test_a_spill_crash_mid_query_is_recovered(tmp_path):
    """A failed spill (``mem.spill:crash``) under a squeezed budget leaves
    its buffer on the device: in a retry's spill pass the framework
    counts it and replays the block; in the arbiter's pass it fails the
    attempt with a KernelCrashError, which replays the query (the
    reference's "circuit-breaker/replay territory"). Either way the sort
    equals the unsqueezed one."""
    names, types, arrays = _keyed(20_000, 4)
    pt, _ = _tables(names, types, arrays)
    want = tfrom(pt, TorchSession(device="cpu"), num_batches=4) \
        .sort("v").collect_table()
    before = tretry.DEVICE_MEMORY_EVENT_HANDLER.spill_crashes
    s = TorchSession({"spark.rapids.memory.device.budgetBytes": "200000",
                      "spark.rapids.test.faults": "mem.spill:crash:1"},
                     device="cpu")
    got = tfrom(pt, s, num_batches=4).sort("v").collect_table()
    assert tfaults.FAULTS.counters().get("mem.spill") == 1
    handled = tretry.DEVICE_MEMORY_EVENT_HANDLER.spill_crashes - before
    assert handled + s.last_metrics()["runtimeFaultReplays"] == 1
    assert tables_differ(got, want) is None


def test_a_crash_in_a_pruned_join_replays_with_the_same_prune(tmp_path):
    """A transient crash at the join of a pruned star join replays the
    query; the replay prunes the same files and answers as the
    reference's run of the same schedule."""
    from spark_rapids_tpu_torch.io.parquet import write_parquet
    rng = np.random.default_rng(2)
    n = 800
    fact, _ = _tables(["v", "region"], ["double", "bigint"], [
        (rng.random(n), np.ones(n, bool)),
        (np.repeat(np.arange(8), n // 8), np.ones(n, bool))])
    root = str(tmp_path / "fact")
    write_parquet(fact, root, partition_by=["region"])
    pdim, rdim = _tables(["region"], ["bigint"],
                         [(np.array([2, 5]), np.ones(2, bool))])
    conf = {"spark.rapids.test.faults": "exec.execute@Join:crash:1"}
    ps, rs = TorchSession(conf, device="cpu"), TpuSession({**NO_CACHE,
                                                           **conf})
    got = ps.read_parquet(root).join(tfrom(pdim, ps), on="region") \
        .group_by("region").agg(F.sum("v").alias("sv")).sort("region") \
        .collect_table()
    want = rs.read_parquet(root).join(jfrom(rdim, rs), on="region") \
        .group_by("region").agg(JF.sum("v").alias("sv")).sort("region") \
        .collect_table()
    assert tables_differ(_as_reference(got), want) is None
    m = ps.last_metrics()
    assert m["runtimeFaultReplays"] == rs.last_fault_replays == 1
    assert (m["dppPrunedFiles"], m["dppScannedFiles"]) == (6, 2)
