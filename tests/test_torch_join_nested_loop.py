"""The port's nested-loop join (execs/broadcast.py TpuNestedLoopJoinExec)
on the CPU against the JAX package's TpuSession on the same numpy inputs,
mirroring the reference's tests/test_broadcast_nlj.py: every join type
over a keyless condition (a band, a comparison, an equality with nulls),
with the default pair budget (one tile a probe batch) and with a budget of
1024 pairs (64 tiles: the outer rows, the semi/anti flags and the full
outer's build bitmap across many tiles); and the null-aware NOT IN (a
keyless anti join with a condition) over an empty subquery, over one
holding a NULL and over an ordinary one.

Comparator: ``scale_test.tables_differ_unordered`` (a bitwise row
multiset) for the joins' rows (tiles emit pairs in another order than the
reference's one tile); ``scale_test.tables_differ`` (bitwise, in order)
for the NOT IN queries."""

import numpy as np
import pytest
import torch

from scale_test import tables_differ, tables_differ_unordered
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.ops.expr import lit as jlit
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.execs import broadcast as tbroadcast
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.ops.expr import lit as tlit
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.session import TorchSession

JOIN_TYPES = ("inner", "cross", "left", "right", "full", "leftsemi",
              "leftanti")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread: the suite runs in several worker
    processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reference_table(names, type_names, arrays) -> JHostTable:
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(t), d, v)
        for t, (d, v) in zip(type_names, arrays)])


def _as_reference(t) -> JHostTable:
    return _reference_table(*t.to_arrays())


def _inputs(n_left=300, n_right=40, seed=53, null_prob=0.0):
    rng = np.random.default_rng(seed)

    def ints(n):
        return (rng.integers(0, 60, n).astype(np.int32),
                rng.random(n) >= null_prob)

    left = (["a", "lv"], ["int", "double"],
            [ints(n_left), (rng.standard_normal(n_left), np.ones(n_left,
                                                                 bool))])
    right = (["b", "rv"], ["int", "int"], [ints(n_right), ints(n_right)])
    return left, right


def _both(build, left, right, nb=3):
    """(port result as a reference HostTable, reference result, port
    metrics): ``build(df_left, df_right, col, lit)``, the left side in
    ``nb`` batches."""
    ts, js = TorchSession(device="cpu"), TpuSession()
    tdf = build(tfrom(host_table_from_arrays(*left), ts, nb),
                tfrom(host_table_from_arrays(*right), ts, 1), tcol, tlit)
    jdf = build(jfrom(_reference_table(*left), js, nb),
                jfrom(_reference_table(*right), js, 1), jcol, jlit)
    got = _as_reference(tdf.collect_table())
    return got, jdf.collect_table(), ts.last_metrics()


@pytest.mark.parametrize("budget", ["default", "1024"])
@pytest.mark.parametrize("how", JOIN_TYPES)
def test_nested_loop_join_types(how, budget, monkeypatch):
    """``a < rv`` (a comparison) for every join type, cross included."""
    if budget != "default":
        monkeypatch.setattr(tbroadcast, "PAIR_BUDGET", int(budget))
    left, right = _inputs()
    got, ref, m = _both(
        lambda l, r, col, lit: l.join(r, on=col("a") < col("rv"), how=how),
        left, right)
    assert got.num_rows > 0
    assert tables_differ_unordered(got, ref) is None
    # the probe side's batches coalesce into one batch: 512 rows against
    # 128 build slots in 8-row tiles, or for a right join 128 against the
    # left side's 512 slots in 2-row tiles
    assert m["nestedLoopTiles"] == (1 if budget == "default" else 64)


@pytest.mark.parametrize("budget", ["default", "1024"])
def test_nested_loop_band_condition(budget, monkeypatch):
    """Band join: a BETWEEN b - 5 AND b + 5."""
    if budget != "default":
        monkeypatch.setattr(tbroadcast, "PAIR_BUDGET", int(budget))
    left, right = _inputs()

    def build(l, r, col, lit):
        cond = (col("a") >= col("b") - lit(5)) & (col("a") <= col("b")
                                                   + lit(5))
        return l.join(r, on=cond, how="inner")

    got, ref, _ = _both(build, left, right)
    assert tables_differ_unordered(got, ref) is None


@pytest.mark.parametrize("how", ["full", "left", "leftanti"])
def test_nested_loop_condition_with_nulls(how, monkeypatch):
    """``a = b + 1`` with 30% nulls on both sides: a null never matches,
    so a full outer join keeps both sides' null rows apart."""
    monkeypatch.setattr(tbroadcast, "PAIR_BUDGET", 2048)
    left, right = _inputs(120, 30, seed=5, null_prob=0.3)
    got, ref, _ = _both(
        lambda l, r, col, lit: l.join(r, on=col("a") == col("b") + lit(1),
                                      how=how), left, right, nb=2)
    assert tables_differ_unordered(got, ref) is None


_T = (["id", "k"], ["bigint", "bigint"], [
    (np.arange(1, 9, dtype=np.int64), np.ones(8, bool)),
    (np.array([1, 2, 3, 4, 5, 6, 7, 8], dtype=np.int64),
     np.array([1, 1, 1, 0, 1, 1, 1, 1], bool))])
_U = (["k"], ["bigint"], [(np.array([2, 5, 9], dtype=np.int64),
                           np.ones(3, bool))])
_UN = (["k"], ["bigint"], [(np.array([2, 0, 9], dtype=np.int64),
                            np.array([1, 0, 1], bool))])

NOT_IN = {
    # NOT IN over the empty set is TRUE, a NULL key included
    "empty subquery": ("SELECT id FROM t WHERE k NOT IN "
                       "(SELECT k FROM u WHERE k > 100)", 8),
    # a NULL in the subquery makes every predicate UNKNOWN
    "subquery with a null": ("SELECT id FROM t WHERE k NOT IN "
                             "(SELECT k FROM un)", 0),
    # a NULL key is UNKNOWN against a non-empty set
    "ordinary subquery": ("SELECT id FROM t WHERE k NOT IN "
                          "(SELECT k FROM u)", 5),
}


@pytest.mark.parametrize("name", sorted(NOT_IN))
def test_not_in_is_null_aware(name):
    sql, nrows = NOT_IN[name]
    ts, js = TorchSession(device="cpu"), TpuSession()
    for view, arrays in (("t", _T), ("u", _U), ("un", _UN)):
        tfrom(host_table_from_arrays(*arrays), ts) \
            .create_or_replace_temp_view(view)
        jfrom(_reference_table(*arrays), js).create_or_replace_temp_view(view)
    got = _as_reference(ts.sql(sql).collect_table())
    assert got.num_rows == nrows
    assert tables_differ(got, js.sql(sql).collect_table()) is None
    assert ts.last_metrics()["nestedLoopTiles"] == 1
