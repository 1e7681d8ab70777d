"""TPC-H q1 through the port's session on the CPU against the JAX
package's TpuSession, on the same tables.

Comparison: column names, dtype classes, row order, keys, validity and
counts are exact (scale_test.tables_differ over the non-float columns,
after the port's result is rebuilt as a reference HostTable from plain
numpy arrays); f64 sums and averages agree within rtol 1e-9
(scale_test.tables_close), because the port adds 1024-row block partials
where the reference's CPU segment_sum adds rows in order."""

import numpy as np
import pytest

from scale_test import tables_close, tables_differ
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.models import tpch as jtpch
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.models import tpch as ttpch
from spark_rapids_tpu_torch.session import TorchSession


@pytest.fixture(scope="module")
def sessions():
    return TpuSession(), TorchSession(device="cpu")


def _reference_table(names, type_names, arrays) -> JHostTable:
    return JHostTable(names, [
        JHostColumn(JT.parse_type(t), d, v)
        for t, (d, v) in zip(type_names, arrays)])


def _arrays_of(jtable: JHostTable):
    return (list(jtable.names),
            [c.dtype.simple_string() for c in jtable.columns],
            [(c.data, c.validity) for c in jtable.columns])


def _run_both(sessions, names, type_names, arrays):
    jsess, tsess = sessions
    ref = jtpch.q1_dataframe(
        jsess, _reference_table(names, type_names, arrays)).collect_table()
    got_t = ttpch.q1_dataframe(
        tsess, host_table_from_arrays(names, type_names,
                                      arrays)).collect_table()
    got = _reference_table(*got_t.to_arrays())
    return ref, got


def _assert_q1_matches(ref: JHostTable, got: JHostTable):
    assert list(got.names) == list(ref.names)
    for c in got.columns:
        assert c.data.dtype == c.dtype.np_dtype
    exact = [i for i, c in enumerate(ref.columns)
             if not isinstance(c.dtype, JT.DoubleType)]
    assert [ref.names[i] for i in exact] == [
        "l_returnflag", "l_linestatus", "count_order"]

    def sub(t, idx):
        return JHostTable([t.names[i] for i in idx],
                          [t.columns[i] for i in idx])

    assert tables_differ(sub(got, exact), sub(ref, exact)) is None
    for cg, cr in zip(got.columns, ref.columns):
        assert np.array_equal(cg.validity, cr.validity)
    assert tables_close(got, ref, rtol=1e-9) is None


def test_lineitem_generator_matches_reference():
    a = jtpch.lineitem_table(1000, seed=7)
    b = ttpch.lineitem_table(1000, seed=7)
    assert a.names == b.names
    for ca, cb in zip(a.columns, b.columns):
        assert ca.dtype.simple_string() == cb.dtype.simple_string()
        assert ca.data.dtype == cb.data.dtype
        assert (ca.data == cb.data).all() and (ca.validity == cb.validity).all()
    assert ttpch.Q1_CUTOFF_DAYS == jtpch.Q1_CUTOFF_DAYS
    assert ttpch.NUM_Q1_GROUPS == jtpch.NUM_Q1_GROUPS


@pytest.mark.parametrize("rows", [65536, 50001])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_q1_matches_reference(sessions, rows, seed):
    ref, got = _run_both(sessions, *_arrays_of(jtpch.lineitem_table(rows,
                                                                   seed)))
    assert got.num_rows == 6
    _assert_q1_matches(ref, got)


def test_q1_with_an_absent_key_pair(sessions):
    """No (R, F) rows: that padded group slot must come out of the
    aggregate invalid and be compacted away."""
    t = jtpch.lineitem_table(20000, seed=3)
    rf = t.column("l_returnflag").data
    ls = t.column("l_linestatus").data
    keep = ~((rf == "R") & (ls == "F"))
    names, types, arrays = _arrays_of(t)
    arrays = [(d[keep], v[keep]) for d, v in arrays]
    ref, got = _run_both(sessions, names, types, arrays)
    assert got.num_rows == 5
    _assert_q1_matches(ref, got)


def test_q1_where_the_filter_drops_every_row(sessions):
    names, types, arrays = _arrays_of(jtpch.lineitem_table(3000, seed=4))
    i = names.index("l_shipdate")
    arrays[i] = (np.full(3000, jtpch.Q1_CUTOFF_DAYS + 1, np.int32),
                 arrays[i][1])
    ref, got = _run_both(sessions, names, types, arrays)
    assert got.num_rows == ref.num_rows == 0
    _assert_q1_matches(ref, got)


def test_q1_with_null_keys_and_values(sessions):
    """Null flags land in the null slot of the group id; null quantities
    drop out of SUM/AVG but not out of COUNT(*)."""
    rng = np.random.default_rng(5)
    names, types, arrays = _arrays_of(jtpch.lineitem_table(10000, seed=5))
    for col in ("l_returnflag", "l_quantity"):
        i = names.index(col)
        d, _ = arrays[i]
        v = rng.random(len(d)) > 0.05
        if d.dtype == object:
            d = np.where(v, d, None)
        else:
            d = np.where(v, d, 0.0)
        arrays[i] = (d, v)
    ref, got = _run_both(sessions, names, types, arrays)
    assert got.num_rows == 8
    _assert_q1_matches(ref, got)


def test_q1_conf_keys_carry_over(sessions):
    """spark.rapids.sql.shapeBuckets.minBucket pads both packages alike;
    spark.rapids.tpu.agg.maxDictGroups below q1's 12-slot key domain takes
    both packages to their sort-segment path, with the same answer."""
    names, types, arrays = _arrays_of(jtpch.lineitem_table(700, seed=6))
    for conf in ({"spark.rapids.sql.shapeBuckets.minBucket": "2048"},
                 {"spark.rapids.tpu.agg.maxDictGroups": "8"}):
        ref = jtpch.q1_dataframe(
            TpuSession(conf), _reference_table(names, types, arrays)
        ).collect_table()
        got = ttpch.q1_dataframe(
            TorchSession(conf, device="cpu"),
            host_table_from_arrays(names, types, arrays)).collect_table()
        _assert_q1_matches(ref, _reference_table(*got.to_arrays()))


@pytest.mark.parametrize("sort", [True, False])
def test_filter_project_plans_match_reference(sessions, sort):
    """The execs q1's fused plan bypasses: a masked filter, a projection
    with double + - * / (a zero divisor gives NULL), then either the
    device sort (dead rows park last, ties stay in row order) or the
    collect's compaction of the masked batch. Bitwise (tables_differ)."""
    from spark_rapids_tpu.ops.expr import col as jcol, lit as jlit
    from spark_rapids_tpu.plan import from_host_table as jfrom
    from spark_rapids_tpu_torch import types as TT
    from spark_rapids_tpu_torch.ops.expr import col as tcol, lit as tlit
    from spark_rapids_tpu_torch.plan import from_host_table as tfrom

    names, types, arrays = _arrays_of(jtpch.lineitem_table(3000, seed=8))
    i = names.index("l_discount")
    arrays[i] = (arrays[i][0], np.random.default_rng(8).random(3000) > 0.1)

    def plan(df, col, lit, date_type):
        out = (df.filter(col("l_shipdate") <= lit(jtpch.Q1_CUTOFF_DAYS - 400,
                                                  date_type))
               .select(col("l_returnflag"),
                       (col("l_extendedprice") / col("l_discount")).alias("q"),
                       (col("l_quantity") * col("l_tax")
                        - col("l_discount") + lit(1.5)).alias("e")))
        return out.sort("l_returnflag") if sort else out

    jsess, tsess = sessions
    ref = plan(jfrom(_reference_table(names, types, arrays), jsess), jcol,
               jlit, JT.DATE).collect_table()
    got = plan(tfrom(host_table_from_arrays(names, types, arrays), tsess),
               tcol, tlit, TT.DATE).collect_table()
    assert 0 < got.num_rows < 3000
    assert tables_differ(_reference_table(*got.to_arrays()), ref) is None
