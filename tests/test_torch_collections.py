"""The port's array expressions, generators and sort-only aggregates
(ops/collections.py, execs/generate.py, execs/aggregate.py's sort-only
route) on ``TorchSession(device="cpu")`` against the JAX package's
``TpuSession`` (its device route on the CPU) over the same rows: a
counterpart of each test in ``tests/test_collections.py`` and of the
collect_list / collect_set / percentile aggregates.

Comparator: ``tests/torch_nested.py::nested_differ``, exact (offsets,
validity and element bits, NaN payloads and -0.0 too): in order where
both packages emit one order (projections, generators over one batch, a
sorted flat aggregate), as a row multiset (each side sorted by its
values' bits) for a group-by with array results. Where the reference
runs on its CPU route, so does the port, equal to it and reported; where
the reference's route fails (an array grouping key, FIRST over an
array), the port's is held to Python and the reference's failure
pinned."""

import math

import numpy as np
import pytest

from scale_test import tables_differ, tables_differ_unordered
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as TT
from spark_rapids_tpu_torch.session import TorchSession
from tests.torch_nested import (
    as_reference,
    nested_differ,
    run_both,
    run_both_exact,
    tables,
)

ARRAYS = [[1, 2, 3], None, [], [4, None, 6], [7], [None], [8, 9],
          [10, 2, 10], [3], None, [5, 5, 5, 5], [11, -2]]


@pytest.fixture(scope="module")
def sessions():
    return TpuSession(), TorchSession(device="cpu")


@pytest.fixture(scope="module")
def arr_tables():
    return tables([("id", TT.INT, list(range(len(ARRAYS)))),
                   ("a", TT.ArrayType(TT.INT), ARRAYS)])


def _same(build, tabs, sessions, nb=1, ordered=True):
    return run_both_exact(build, *tabs, *sessions, nb=nb, ordered=ordered)


def test_array_scan_roundtrip(arr_tables, sessions):
    got = _same(lambda a, df: df, arr_tables, sessions)
    assert list(got.columns[1].data[[0, 3, 5]]) == [[1, 2, 3], [4, None, 6],
                                                    [None]]


GENERATORS = {
    "explode": lambda a, df: df.select("id", a.F.explode(a.col("a"))
                                       .alias("e")),
    "posexplode": lambda a, df: df.select("id", a.F.posexplode(a.col("a"))
                                          .alias("e")),
    "explode_outer": lambda a, df: df.select(
        "id", a.F.explode_outer(a.col("a")).alias("e")),
    "posexplode_outer": lambda a, df: df.select(
        "id", a.F.posexplode_outer(a.col("a")).alias("e")),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators(name, arr_tables, sessions):
    _same(GENERATORS[name], arr_tables, sessions)


def test_explode_runs_as_the_generate_exec(arr_tables, sessions):
    from spark_rapids_tpu_torch.execs.generate import TpuGenerateExec
    s = sessions[1]
    from spark_rapids_tpu_torch.plan import from_host_table
    df = from_host_table(arr_tables[1], s).select(
        "id", __import__("spark_rapids_tpu_torch.functions",
                         fromlist=["explode"]).explode("a").alias("e"))
    df.collect_table()
    root = s._last_root

    def walk(e):
        yield e
        for c in e.children:
            yield from walk(c)
    assert any(isinstance(e, TpuGenerateExec) for e in walk(root))


def test_explode_then_aggregate(arr_tables, sessions):
    _same(lambda a, df: df.select("id", a.F.explode(a.col("a")).alias("e"))
          .group_by("id").agg(a.F.count().alias("n"),
                              a.F.sum(a.col("e")).alias("se"))
          .sort("id"), arr_tables, sessions)


def test_size_and_minmax(arr_tables, sessions):
    _same(lambda a, df: df.select(
        "id", a.F.size(a.col("a")).alias("sz"),
        a.F.array_min(a.col("a")).alias("mn"),
        a.F.array_max(a.col("a")).alias("mx")), arr_tables, sessions)


def test_array_contains_and_get_item(arr_tables, sessions):
    _same(lambda a, df: df.select(
        "id", a.F.array_contains(a.col("a"), a.lit(2)).alias("has2"),
        a.F.get_item(a.col("a"), a.lit(0)).alias("first"),
        a.F.get_item(a.col("a"), a.lit(5)).alias("oob")),
        arr_tables, sessions)


def test_sort_array(arr_tables, sessions):
    _same(lambda a, df: df.select(
        "id", a.F.sort_array(a.col("a")).alias("asc"),
        a.F.sort_array(a.col("a"), asc=False).alias("desc")),
        arr_tables, sessions)


def test_sort_array_of_doubles_places_nan_as_spark(sessions):
    vals = [[1.5, float("nan"), -2.0, None, 0.0], [float("nan")], [],
            [3.0, -1.0]]
    tabs = tables([("id", TT.INT, list(range(4))),
                   ("d", TT.ArrayType(TT.DOUBLE), vals)])
    got = _same(lambda a, df: df.select(
        "id", a.F.sort_array(a.col("d")).alias("asc"),
        a.F.sort_array(a.col("d"), asc=False).alias("desc")),
        tabs, sessions, ordered=False)
    asc, desc = got.columns[1].data[0], got.columns[2].data[0]
    assert asc[0] is None and math.isnan(asc[-1]) and asc[1:4] == [
        -2.0, 0.0, 1.5]
    assert math.isnan(desc[0]) and desc[-1] is None


def test_array_min_max_nan_rule(sessions):
    """Spark's rule: array_min ignores NaN unless every element is NaN,
    array_max is NaN where any element is (both packages)."""
    vals = [[1.0, float("nan"), -3.0], [float("nan")], [None, 2.0], None]
    tabs = tables([("id", TT.INT, list(range(4))),
                   ("d", TT.ArrayType(TT.DOUBLE), vals)])
    got = _same(lambda a, df: df.select(
        "id", a.F.array_min(a.col("d")).alias("mn"),
        a.F.array_max(a.col("d")).alias("mx")), tabs, sessions,
        ordered=False)
    mn = got.columns[1].data
    mx = got.columns[2].data
    assert mn[0] == -3.0 and math.isnan(mn[1]) and mn[2] == 2.0
    assert math.isnan(mx[0]) and math.isnan(mx[1]) and mx[2] == 2.0


def test_create_array_and_explode(sessions):
    rng = np.random.default_rng(13)
    tabs = tables([("x", TT.INT, rng.integers(0, 50, 100).tolist()),
                   ("y", TT.INT, rng.integers(0, 50, 100).tolist())])
    _same(lambda a, df: df.select(
        "x", a.F.explode(a.F.array(a.col("x"), a.col("y"), a.lit(7)))
        .alias("e")), tabs, sessions)


def test_array_multi_batch(arr_tables, sessions):
    _same(lambda a, df: df.select("id", a.F.explode(a.col("a")).alias("e")),
          arr_tables, sessions, nb=3)


def _route(build, arr_tables, sessions, ordered=True):
    """``build`` over both packages: the reference runs it on its CPU
    route, and so does the port (tagged there, reported in the event
    record's fallbacks), equal by ``nested_differ``."""
    got = _same(build, arr_tables, sessions, ordered=ordered)
    fallbacks = sessions[1].last_meta
    from spark_rapids_tpu_torch.obs.events import collect_fallbacks
    assert collect_fallbacks(fallbacks), "nothing ran on the CPU route"
    return got


def test_array_through_generator_falls_back(arr_tables, sessions):
    """An array passing through a generator: the CPU route in both."""
    _route(lambda a, df: df.select("a", a.F.explode("a").alias("e")),
           arr_tables, sessions)


def test_array_grouping_key_falls_back(arr_tables, sessions):
    """An array grouping key runs on the port's CPU route; the
    reference's CPU route fails on it (numpy cannot order its null rows'
    0 against lists: TypeError), so the port is held to the groups
    counted in Python, null rows one group."""
    import collections as _collections

    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.obs.events import collect_fallbacks
    from spark_rapids_tpu_torch.plan import from_host_table
    with pytest.raises(TypeError):
        run_both(lambda a, df: df.group_by("a").agg(
            a.F.count().alias("c")), *arr_tables, *sessions)
    got = from_host_table(arr_tables[1], sessions[1]).group_by("a").agg(
        F.count().alias("c")).collect_table()
    assert collect_fallbacks(sessions[1].last_meta) == [
        {"op": "Aggregate", "reasons": [
            "array-typed grouping keys are not supported on GPU"]}]
    want = _collections.Counter(
        None if a is None else tuple(a) for a in ARRAYS)
    rows = np.asarray(got.columns[0].data)
    have = _collections.Counter()
    for i in range(got.num_rows):
        key = tuple(rows[i]) if got.columns[0].validity[i] else None
        have[key] += int(got.columns[1].data[i])
    assert have == want


def test_first_over_array_input_falls_back(arr_tables, sessions):
    """FIRST over an array input runs on the port's CPU route; the
    reference's CPU route fails on it (its host aggregate writes the
    lists into a numeric array: ValueError), so the port is held to each
    group's first array in Python."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.obs.events import collect_fallbacks
    from spark_rapids_tpu_torch.plan import from_host_table
    with pytest.raises(ValueError):
        run_both(lambda a, df: df.group_by("id").agg(
            a.F.first("a").alias("f")), *arr_tables, *sessions)
    got = from_host_table(arr_tables[1], sessions[1]).group_by("id").agg(
        F.first("a").alias("f")).collect_table()
    assert collect_fallbacks(sessions[1].last_meta) == [
        {"op": "Aggregate", "reasons": [
            "aggregate f over an array input is not supported on GPU"]}]
    rows = np.asarray(got.columns[1].data)
    have = {int(got.columns[0].data[i]):
            (list(rows[i]) if got.columns[1].validity[i] else None)
            for i in range(got.num_rows)}
    assert have == dict(enumerate(ARRAYS))


@pytest.mark.parametrize("op", ["filter", "sort", "join", "window",
                                "exchange"])
def test_nested_column_into_a_flat_only_operator_raises(op, arr_tables,
                                                        sessions):
    """Nested columns into a filter, sort, join, window or exchange: the
    CPU route in both packages, equal row for row."""
    builds = {
        "filter": lambda a, df: df.filter(a.col("id") > a.lit(2)),
        "sort": lambda a, df: df.sort("id"),
        "join": lambda a, df: df.join(df.select("id"), on="id"),
        "window": lambda a, df: df.with_windows(r=a.F.row_number().over(
            a.W.partition_by("id").order_by("id"))),
        "exchange": lambda a, df: df.repartition(4, "id"),
    }
    _route(builds[op], arr_tables, sessions, ordered=op != "join")


# -- the sort-only aggregates ----------------------------------------------

def _agg_tables(n=3000, seed=0, keys=40):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, keys, n)
    q = rng.integers(1, 50, n)
    qn = [int(x) if rng.random() > 0.1 else None for x in q]
    p = rng.random(n) * 1000.0
    d = rng.integers(9000, 9100, n)
    return tables([("k", TT.LONG, k.tolist()), ("q", TT.LONG, qn),
                   ("p", TT.DOUBLE, p.tolist()), ("d", TT.DATE, d.tolist())])


@pytest.fixture(scope="module")
def agg_tables():
    return _agg_tables()


def test_collect_list_set_and_percentile_group_by(agg_tables, sessions):
    _same(lambda a, df: df.group_by("k").agg(
        a.F.collect_list(a.col("q")).alias("ql"),
        a.F.collect_set(a.col("q")).alias("qs"),
        a.F.collect_list(a.col("d")).alias("dl"),
        a.F.percentile(a.col("p"), 0.5).alias("med"),
        a.F.percentile(a.col("q"), 0.25).alias("q25")),
        agg_tables, sessions, ordered=False)


def test_collect_unsorted_group_by_is_the_row_multiset(agg_tables,
                                                       sessions):
    _same(lambda a, df: df.group_by("k").agg(
        a.F.collect_list(a.col("q")).alias("ql"),
        a.F.count().alias("n")), agg_tables, sessions,
        ordered=False)


def test_global_collect_and_percentile(agg_tables, sessions):
    _same(lambda a, df: df.agg(
        a.F.collect_set(a.col("q")).alias("qs"),
        a.F.percentile(a.col("p"), 0.9).alias("p90"),
        a.F.approx_percentile(a.col("p"), 0.1).alias("p10")),
        agg_tables, sessions)


def test_collect_after_a_filter(agg_tables, sessions):
    """The fused filter's dead rows add nothing to a list or a set."""
    _same(lambda a, df: df.filter(a.col("p") > a.lit(500.0)).group_by("k")
          .agg(a.F.collect_list(a.col("q")).alias("ql"),
               a.F.percentile(a.col("p"), 1.0).alias("mx")),
          agg_tables, sessions, ordered=False)


def test_collect_set_of_nan_and_signed_zeros(sessions):
    """-0.0 and 0.0 are one set element, as are NaNs; the first occurrence
    is kept (both packages): pinned bit for bit."""
    nan = float("nan")
    keys = [0, 0, 0, 0, 0, 1, 1, 1, 2]
    vals = [-0.0, 0.0, nan, 1.0, nan, 0.0, -0.0, None, None]
    tabs = tables([("k", TT.INT, keys), ("v", TT.DOUBLE, vals)])
    got = _same(lambda a, df: df.group_by("k").agg(
        a.F.collect_set(a.col("v")).alias("s"),
        a.F.collect_list(a.col("v")).alias("l")), tabs, sessions,
        ordered=False)
    order = np.argsort(got.columns[0].data)
    s = got.columns[1].data[order]
    assert len(s[0]) == 3 and repr(s[0][0]) == "-0.0" and s[0][1] == 1.0 \
        and math.isnan(s[0][2])
    assert [repr(x) for x in s[1]] == ["0.0"] and s[2] == []


def test_sql_collect_and_builtins(agg_tables, sessions):
    js, ts = sessions
    from spark_rapids_tpu.plan import from_host_table as jfrom
    from spark_rapids_tpu_torch.plan import from_host_table as tfrom
    jfrom(agg_tables[0], js).create_or_replace_temp_view("agg_t")
    tfrom(agg_tables[1], ts).create_or_replace_temp_view("agg_t")
    text = ("SELECT k, size(l) AS n, array_contains(l, 25) AS c, "
            "sort_array(l, false) AS s, element_at(l, 0) AS f, "
            "array_min(l) AS mn, array_max(l) AS mx, m FROM ("
            "SELECT k, collect_list(q) AS l, percentile(p, 0.5) AS m "
            "FROM agg_t GROUP BY k) t")
    want = js.sql(text).collect_table()
    got = as_reference(ts.sql(text).collect_table())
    assert tables_differ_unordered(want, got) is None
