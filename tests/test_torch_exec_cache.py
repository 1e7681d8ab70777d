"""The plan fingerprint and the executable cache against the reference.

The fingerprint's equivalence classes are held pair by pair against the
reference's ``plan/fingerprint.py`` over the same plans: both packages
must agree, for every pair, on "same fingerprint" and "same template".
The cache's cases (a hit, a template hit, invalidations, eviction, a
failed run's drop, concurrent checkouts, a breaker trip) compare their
results with the reference's through ``scale_test.tables_differ``
(bitwise) or ``tables_close`` (rtol 1e-9, q1's f64 sums); counters are
exact. Also: a cached tree run twice stacks no boundary wrapper, and the
memory ladder's ``chunk`` rung strikes the template in the quarantine."""

import threading

import numpy as np
import pytest
import torch

from scale_test import tables_differ, tables_differ_unordered
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.conf import RapidsConf as JConf
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.ops.expr import lit as jlit
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.plan import fingerprint as jfp
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import DeviceColumn, DeviceTable
from spark_rapids_tpu_torch.conf import RapidsConf as TConf
from spark_rapids_tpu_torch.dispatch import COMPILE_SCOPE
from spark_rapids_tpu_torch.errors import KernelCrashError
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.lore import _iter_tree
from spark_rapids_tpu_torch.models.tpch import lineitem_table, q1_dataframe
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.ops.expr import lit as tlit
from spark_rapids_tpu_torch.plan import fingerprint as tfp
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.plan.executable_cache import EXEC_CACHE
from spark_rapids_tpu_torch.runtime import faults as tfaults
from spark_rapids_tpu_torch.runtime.health import HEALTH, QUARANTINE
from spark_rapids_tpu_torch.runtime.memory import (
    MEMORY,
    estimate_device_nbytes,
)
from spark_rapids_tpu_torch.session import TorchSession


@pytest.fixture(autouse=True)
def _clean():
    EXEC_CACHE.clear()
    yield
    EXEC_CACHE.clear()
    tfaults.FAULTS.disarm()
    tfaults.CIRCUIT_BREAKER.reset()
    HEALTH.reset()
    QUARANTINE.reset()


def _arrays(n=400, seed=0):
    rng = np.random.default_rng(seed)
    ok = np.ones(n, bool)
    return (["k", "s", "v", "f"], ["bigint", "string", "bigint", "double"],
            [(rng.integers(0, 7, n), ok),
             (np.array(["a", "b", "c", "d"] * (n // 4), dtype=object), ok),
             (np.arange(n, dtype=np.int64), ok),
             (rng.random(n), ok)])


def _pair_tables(seed=0):
    names, types, arrays = _arrays(seed=seed)
    j = JHostTable(names, [JHostColumn(JT.parse_type(t), d, v)
                           for t, (d, v) in zip(types, arrays)])
    return j, host_table_from_arrays(names, types, arrays)


# each builder takes (F, col, lit, frm, table, other table) and returns a
# DataFrame; a case pairs two builders (and the confs they run under)
def _agg(F, col, lit, frm, t, o, cut=10, fn="sum", key="k"):
    return frm(t).filter(col("v") > lit(cut)).group_by(key).agg(
        getattr(F, fn)("v").alias("x"))


def _strfilter(F, col, lit, frm, t, o, s="a"):
    return frm(t).filter(col("s") == lit(s)).select("k", "v")


CASES = {
    "the same query twice": (_agg, _agg, None),
    "a literal variant": (_agg, lambda *a: _agg(*a, cut=11), None),
    "a string literal variant": (_strfilter,
                                 lambda *a: _strfilter(*a, s="b"), None),
    "another table": (_agg, lambda F, c, l, frm, t, o: _agg(F, c, l, frm, o,
                                                            t), None),
    "another aggregate": (_agg, lambda *a: _agg(*a, fn="max"), None),
    "another key": (_agg, lambda *a: _agg(*a, key="s"), None),
    "a null literal": (_agg, lambda F, c, l, frm, t, o: frm(t).filter(
        c("v") > l(None)).group_by("k").agg(F.sum("v").alias("x")), None),
    "an int against a double literal": (
        _agg, lambda F, c, l, frm, t, o: frm(t).filter(
            c("v") > l(10.5)).group_by("k").agg(F.sum("v").alias("x")),
        None),
    "another alias": (_agg, lambda F, c, l, frm, t, o: frm(t).filter(
        c("v") > l(10)).group_by("k").agg(F.sum("v").alias("y")), None),
    "a limit of another size": (
        lambda F, c, l, frm, t, o: frm(t).sort("v").limit(10),
        lambda F, c, l, frm, t, o: frm(t).sort("v").limit(20), None),
    "another sort direction": (
        lambda F, c, l, frm, t, o: frm(t).sort("v"),
        lambda F, c, l, frm, t, o: frm(t).sort("v", ascending=False), None),
    "a projection": (
        lambda F, c, l, frm, t, o: frm(t).select("k", "v"),
        lambda F, c, l, frm, t, o: frm(t).select("v", "k"), None),
    "an arithmetic literal": (
        lambda F, c, l, frm, t, o: frm(t).select(
            (c("v") + l(1)).alias("w")),
        lambda F, c, l, frm, t, o: frm(t).select(
            (c("v") + l(2)).alias("w")), None),
    "a conf that changes the plan": (
        _agg, _agg, {"spark.rapids.tpu.agg.maxDictGroups": "1024"}),
    "an observability conf": (
        _agg, _agg, {"spark.rapids.sql.eventLog.enabled": "true"}),
    "a metrics level": (
        _agg, _agg, {"spark.rapids.sql.metrics.level": "DEBUG"}),
    "the executable cache's own conf": (
        _agg, _agg, {"spark.rapids.sql.executableCache.maxPlans": "8"}),
    "a join and its swap": (
        lambda F, c, l, frm, t, o: frm(t).join(frm(o), on=["k"]),
        lambda F, c, l, frm, t, o: frm(o).join(frm(t), on=["k"]), None),
    "a filter on another column": (
        _agg, lambda F, c, l, frm, t, o: frm(t).filter(
            c("k") > l(10)).group_by("k").agg(F.sum("v").alias("x")),
        None),
    "a generator and its positional form": (
        lambda F, c, l, frm, t, o: frm(t).select(
            c("k"), F.explode(F.array(c("v"), c("v"))).alias("e")),
        lambda F, c, l, frm, t, o: frm(t).select(
            c("k"), F.posexplode(F.array(c("v"), c("v"))).alias("e")),
        None),
    "a lambda's literal": (
        lambda F, c, l, frm, t, o: frm(t).select(F.transform(
            F.array(c("v"), c("k")), lambda x: x + l(1)).alias("w")),
        lambda F, c, l, frm, t, o: frm(t).select(F.transform(
            F.array(c("v"), c("k")), lambda x: x + l(2)).alias("w")),
        None),
    "a union of the same": (
        lambda F, c, l, frm, t, o: frm(t).select("v").union(
            frm(t).select("v")),
        lambda F, c, l, frm, t, o: frm(t).select("v").union(
            frm(t).select("v")), None),
}


def _classes(pkg, case):
    b1, b2, conf2 = CASES[case]
    if pkg == "ref":
        t, o = _REF
        s = TpuSession()
        F, c, l = JF, jcol, jlit
        Conf = JConf
        fp = jfp
    else:
        t, o = _PORT
        s = TorchSession(device="cpu")
        F, c, l = TF, tcol, tlit
        Conf = TConf
        fp = tfp

    def frm(x):
        return (jfrom if pkg == "ref" else tfrom)(x, s)

    p1 = b1(F, c, l, frm, t, o).plan
    p2 = b2(F, c, l, frm, t, o).plan
    c1, c2 = Conf({}), Conf(conf2 or {})
    same = fp.fingerprint(p1, c1) == fp.fingerprint(p2, c2)
    full1 = fp.plan_fingerprints(p1, c1)
    full2 = fp.plan_fingerprints(p2, c2)
    assert None not in full1 and None not in full2
    return same, full1[0] == full2[0], full1[1] == full2[1]


_REF, _PORT = None, None


@pytest.mark.parametrize("case", list(CASES))
def test_fingerprint_classes_match_the_reference(case):
    """For every pair: same full fingerprint, same template, same
    executable variant, in both packages alike."""
    global _REF, _PORT
    if _REF is None:
        (jt, tt), (jo, to) = _pair_tables(0), _pair_tables(1)
        _REF, _PORT = (jt, jo), (tt, to)
    assert _classes("port", case) == _classes("ref", case)


def test_the_same_dataframe_keeps_its_fingerprint_after_a_run(tmp_path):
    """A file scan's lazily filled caches (footers, schemas) stay out of
    the fingerprint: the same DataFrame run twice shares one."""
    s = TorchSession(device="cpu")
    t = lineitem_table(1000, seed=2)
    tfrom(t, s).write_parquet(str(tmp_path / "p"))
    df = q1_dataframe(s, s.read_parquet(str(tmp_path / "p")))
    before = tfp.template_fingerprint(df.plan, s.conf)
    df.collect_table()
    assert before is not None
    assert tfp.template_fingerprint(df.plan, s.conf) == before
    other = q1_dataframe(s, s.read_parquet(str(tmp_path / "p")))
    assert tfp.template_fingerprint(other.plan, s.conf) == before


def test_a_write_plan_is_uncacheable_in_both(tmp_path):
    s, js = TorchSession(device="cpu"), TpuSession()
    jt, tt = _pair_tables(0)
    from spark_rapids_tpu.plan import nodes as JP
    from spark_rapids_tpu_torch.plan import nodes as TP
    tw = TP.WriteFiles(tfrom(tt, s).plan, "parquet", str(tmp_path), None, {})
    jw = JP.WriteFiles(jfrom(jt, js).plan, "parquet", str(tmp_path))
    assert tfp.fingerprint(tw, s.conf) is None
    assert jfp.fingerprint(jw, js.conf) is None


# -- the cache ----------------------------------------------------------------

def _counts(before):
    keys = ("executableCacheHits", "executableCacheMisses",
            "executableCacheTemplateHits", "executableCacheInvalidations",
            "executableCacheEvictions")
    return tuple(COMPILE_SCOPE.get(k, 0) - before.get(k, 0) for k in keys)


def _ref_agg(jt, cut=10):
    return _agg(JF, jcol, jlit, lambda x: jfrom(x, TpuSession()), jt, None,
                cut).collect_table()


def _port_agg(s, tt, cut=10):
    return _agg(TF, tcol, tlit, lambda x: tfrom(x, s), tt, None, cut)


def test_hit_template_hit_and_results():
    """A repeated plan checks its converted tree out (no conversion: the
    same root), a literal variant counts a template hit; every result
    equals the reference's bit for bit."""
    jt, tt = _pair_tables(0)
    s = TorchSession(device="cpu")
    before = dict(COMPILE_SCOPE)
    got1 = _port_agg(s, tt).collect_table()
    root1 = s._last_root
    assert not s.last_executable_cache_hit
    got2 = _port_agg(s, tt).collect_table()
    assert s.last_executable_cache_hit and s._last_root is root1
    got3 = _port_agg(s, tt, cut=11).collect_table()
    assert not s.last_executable_cache_hit
    assert _counts(before) == (1, 2, 1, 0, 0)
    want = _ref_agg(jt)
    assert _same(got1, want) and _same(got2, want)
    assert tables_differ(_as_reference(got1), _as_reference(got2)) is None
    assert _same(got3, _ref_agg(jt, 11))


def _same(got, want) -> bool:
    """A group-by's rows in any order, bitwise
    (``scale_test.tables_differ_unordered``)."""
    return tables_differ_unordered(_as_reference(got), want) is None


def _as_reference(t):
    return JHostTable(list(t.names), [
        JHostColumn(JT.parse_type(c.dtype.simple_string()), c.data,
                    c.validity) for c in t.columns])


def test_a_write_and_a_catalog_change_stale_the_entries(tmp_path):
    jt, tt = _pair_tables(0)
    s = TorchSession(device="cpu")
    before = dict(COMPILE_SCOPE)
    _port_agg(s, tt).collect_table()
    _port_agg(s, tt).collect_table()
    tfrom(tt, s).write_parquet(str(tmp_path / "w"))   # a WriteFiles run
    _port_agg(s, tt).collect_table()
    tfrom(tt, s).create_or_replace_temp_view("t")      # a catalog change
    got = _port_agg(s, tt).collect_table()
    # (the write itself checks nothing out: its child runs nested)
    assert _counts(before) == (1, 3, 2, 2, 0)
    assert _same(got, _ref_agg(jt))


def test_a_failed_write_stales_the_entries_too(tmp_path):
    _, tt = _pair_tables(0)
    s = TorchSession(device="cpu")
    _port_agg(s, tt).collect_table()
    bad = TorchSession({"spark.rapids.test.faults":
                        "io.write.file:crash:1"}, device="cpu")
    with pytest.raises(KernelCrashError):
        tfrom(tt, bad).write_parquet(str(tmp_path / "w"))
    tfaults.FAULTS.disarm()
    before = dict(COMPILE_SCOPE)
    _port_agg(s, tt).collect_table()
    assert _counts(before)[3] == 1


def test_eviction_by_the_template_bound():
    _, tt = _pair_tables(0)
    s = TorchSession({"spark.rapids.sql.executableCache.maxPlans": "1"},
                     device="cpu")
    before = dict(COMPILE_SCOPE)
    for key in ("k", "s", "k"):
        _agg(TF, tcol, tlit, lambda x: tfrom(x, s), tt, None,
             key=key).collect_table()
    assert _counts(before) == (0, 3, 0, 0, 2)


def test_a_failed_run_drops_its_entry():
    """The failing run's tree is never handed out again: after a crash
    that the breaker does not replay (runtimeFallback off), the next run
    converts afresh."""
    jt, tt = _pair_tables(0)
    s = TorchSession(device="cpu")
    _port_agg(s, tt).collect_table()
    root = s._last_root
    crash = TorchSession({"spark.rapids.test.faults":
                          "exec.execute:crash:1",
                          "spark.rapids.sql.runtimeFallback.enabled":
                          "false"}, device="cpu")
    with pytest.raises(KernelCrashError):
        _port_agg(crash, tt).collect_table()
    tfaults.FAULTS.disarm()
    before = dict(COMPILE_SCOPE)
    got = _port_agg(s, tt).collect_table()
    assert s.last_executable_cache_hit and s._last_root is root
    assert _counts(before)[:2] == (1, 0)
    assert _same(got, _ref_agg(jt))
    # the crashing session's entry (its conf is another key) was dropped
    assert EXEC_CACHE.stats()["idleTrees"] == 1


def test_concurrent_checkouts_take_separate_trees():
    jt, tt = _pair_tables(0)
    s = TorchSession(device="cpu")
    _port_agg(s, tt).collect_table()
    barrier = threading.Barrier(3)
    results, roots = [None] * 3, [None] * 3

    def run(i):
        barrier.wait()
        results[i] = _port_agg(s, tt).collect_table()
        roots[i] = s._last_root

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    want = _ref_agg(jt)
    for got in results:
        assert _same(got, want)
    stats = EXEC_CACHE.stats()
    assert stats["busyTrees"] == 0 and 1 <= stats["idleTrees"] <= 4


def test_a_breaker_trip_stales_the_entry():
    _, tt = _pair_tables(0)
    s = TorchSession(device="cpu")
    _port_agg(s, tt).collect_table()
    tfaults.CIRCUIT_BREAKER.record_failure("Join", RuntimeError("x"), 1)
    before = dict(COMPILE_SCOPE)
    _port_agg(s, tt).collect_table()
    assert _counts(before)[3] == 1 and not s.last_executable_cache_hit


def test_a_cached_tree_stacks_no_boundary_wrapper():
    """install_fault_boundaries and install_observation run on every
    attempt; on a checked-out tree each exec keeps the one wrapper it
    got when it was converted."""
    _, tt = _pair_tables(0)
    s = TorchSession(device="cpu")
    _port_agg(s, tt).collect_table()
    wrapped = {id(e): (e.__dict__["execute"], e.__dict__["execute_masked"])
               for e in _iter_tree(s._last_root)}
    _port_agg(s, tt).collect_table()
    assert s.last_executable_cache_hit
    for e in _iter_tree(s._last_root):
        assert (e.__dict__["execute"], e.__dict__["execute_masked"]) \
            == wrapped[id(e)]
    tfaults.install_fault_boundaries(s._last_root)
    for e in _iter_tree(s._last_root):
        assert e.__dict__["execute"] is wrapped[id(e)][0]


def test_metrics_start_clean_on_a_hit():
    _, tt = _pair_tables(0)
    s = TorchSession(device="cpu")
    _port_agg(s, tt).collect_table()
    first = dict(s.last_metrics())
    _port_agg(s, tt).collect_table()
    assert s.last_executable_cache_hit
    assert s.last_metrics() == first


def test_the_chunk_rung_strikes_the_template():
    """The memory ladder's ``chunk`` rung (past the plain retry) records
    a quarantine strike against q1's template; ``explain`` names it a
    poison suspect. (The squeeze of test_torch_recovery.py's chunk-rung
    test.)"""
    t = lineitem_table(40_000, 3)
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
        df = q1_dataframe(s, t)
        df.collect_table()
    finally:
        del ballast
    m = s.last_metrics()
    assert (m["memoryPressure"], m["memoryChunkedReexecutions"]) == (2, 1)
    fp = tfp.template_fingerprint(df.plan, s.conf)
    assert QUARANTINE.strike_count(fp) == 1
    assert "memory execution killed (chunk)" in QUARANTINE.history(fp)[0]
    assert m["quarantineStrikes"] == 1
    assert s.explain(df).startswith("! poison suspect: 1")
    assert QUARANTINE.is_quarantined(fp) is None
    for _ in range(2):
        QUARANTINE.strike(fp, "x", 3)
    assert s.explain(df).startswith("!! QUARANTINED template")


def test_an_idle_tree_holds_no_broadcast_batch():
    """A parked tree releases its broadcast's cached batch: the next hit
    builds it again, launch for launch as a fresh tree."""
    jt, tt = _pair_tables(0)
    _, to = _pair_tables(1)
    s = TorchSession(device="cpu")

    def q():
        return tfrom(tt, s).join(tfrom(to, s).select("k", "f"), on=["k"])

    want = q().collect_table()
    broadcasts = [e for e in _iter_tree(s._last_root)
                  if type(e).__name__ == "TpuBroadcastExchangeExec"]
    assert broadcasts and all(b._cached is None for b in broadcasts)
    got = q().collect_table()
    assert s.last_executable_cache_hit
    assert s.last_metrics().get("broadcastBatches") == 1
    assert tables_differ(_as_reference(got), _as_reference(want)) is None
