"""The port's struct and map expressions, lambdas and higher-order
functions (ops/nested.py) on ``TorchSession(device="cpu")`` against the
JAX package's ``TpuSession`` over the same rows: a counterpart of each
test in ``tests/test_nested_types.py``.

Comparator: ``scale_test.tables_differ`` (bitwise, in order: every case
is a projection over one batch), the reference's values as its object
arrays of lists, tuples and dicts, held exactly by
``tests/torch_nested.py::nested_differ``. ``map_entries`` and
``arrays_zip`` (arrays of structs) and a sort carrying a raw struct run
on the CPU route in both packages: held to the reference's the same way,
with the port's fallbacks reported."""

import numpy as np
import pytest

from scale_test import tables_differ
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as TT
from spark_rapids_tpu_torch.session import TorchSession
from tests.torch_nested import PORT, nested_differ, run_both, tables


@pytest.fixture(scope="module")
def sessions():
    return TpuSession(), TorchSession(device="cpu")


@pytest.fixture(scope="module")
def data_tables():
    rng = np.random.default_rng(0)
    n = 200
    return tables([("a", TT.LONG, rng.integers(-50, 50, n).tolist()),
                   ("b", TT.DOUBLE, rng.random(n).tolist()),
                   ("c", TT.INT, rng.integers(0, 5, n).tolist())])


def _check(build, tabs, sessions):
    want, got = run_both(build, *tabs, *sessions)
    assert nested_differ(want, got) is None, nested_differ(want, got)
    return got


def _one(name, dt, vals):
    return tables([(name, dt, vals)])


# -- struct ------------------------------------------------------------------

def test_struct_scan_roundtrip(sessions):
    st = TT.StructType([TT.StructField("x", TT.LONG),
                        TT.StructField("y", TT.DOUBLE)])
    vals = [(1, 2.5), None, (3, None), (-7, 0.0)]
    got = _check(lambda a, df: df, _one("s", st, vals), sessions)
    assert list(got.columns[0].data[[0, 2, 3]]) == [vals[0], vals[2],
                                                    vals[3]]


def test_create_struct_and_get_field(data_tables, sessions):
    _check(lambda a, df: df.select(a.F.struct(
        a.col("a"), a.col("b"), names=["x", "y"]).alias("s")),
        data_tables, sessions)
    _check(lambda a, df: df.select(a.F.get_field(a.F.struct(
        a.col("a"), a.col("b"), names=["x", "y"]), "x").alias("v")),
        data_tables, sessions)
    st = TT.StructType([TT.StructField("x", TT.LONG)])
    got = _check(lambda a, df: df.select(
        a.F.get_field(a.col("s"), "x").alias("v")),
        _one("s", st, [(5,), None, (None,)]), sessions)
    assert got.columns[0].validity.tolist() == [True, False, False]


def test_struct_field_in_filter_predicate(data_tables, sessions):
    _check(lambda a, df: df.select(
        a.F.struct(a.col("a"), a.col("c"), names=["x", "y"]).alias("s"),
        a.col("a")).filter(a.F.get_field(a.col("s"), "x") > a.lit(0))
        .select(a.col("a")) if a is not PORT else df.filter(
            a.F.get_field(a.F.struct(a.col("a"), a.col("c"),
                                     names=["x", "y"]), "x") > a.lit(0))
        .select(a.col("a")), data_tables, sessions)


def test_named_struct(data_tables, sessions):
    _check(lambda a, df: df.select(a.F.named_struct(
        "p", a.col("a"), "q", a.col("c")).alias("s")),
        data_tables, sessions)


# -- map ---------------------------------------------------------------------

def test_map_scan_roundtrip(sessions):
    mt = TT.MapType(key_type=TT.LONG, value_type=TT.DOUBLE)
    vals = [{1: 2.0, 3: None}, None, {}, {9: -1.5}]
    got = _check(lambda a, df: df, _one("m", mt, vals), sessions)
    assert got.columns[0].data[0] == vals[0] and got.columns[0].data[2] == {}


def test_create_map_keys_values(data_tables, sessions):
    _check(lambda a, df: df.select(
        a.F.create_map(a.col("a"), a.col("b")).alias("m")),
        data_tables, sessions)
    _check(lambda a, df: df.select(a.F.map_keys(a.F.create_map(
        a.col("a"), a.col("b"), a.col("a") + a.lit(100), a.col("b")))
        .alias("k")), data_tables, sessions)
    _check(lambda a, df: df.select(a.F.map_values(a.F.create_map(
        a.col("a"), a.col("b"))).alias("v")), data_tables, sessions)


def test_get_map_value(data_tables, sessions):
    _check(lambda a, df: df.select(a.F.get_map_value(a.F.create_map(
        a.col("a"), a.col("b"), a.col("a") + a.lit(1),
        a.col("b") + a.lit(1.0)), a.col("a") + a.lit(1)).alias("v")),
        data_tables, sessions)
    _check(lambda a, df: df.select(a.F.get_map_value(a.F.create_map(
        a.col("a"), a.col("b")), a.col("a") + a.lit(999)).alias("v")),
        data_tables, sessions)


def test_map_concat_last_win(data_tables, sessions):
    _check(lambda a, df: df.select(a.F.map_concat(
        a.F.create_map(a.col("a"), a.col("b")),
        a.F.create_map(a.col("a"), a.col("b") + a.lit(10.0)),
        a.F.create_map(a.col("a") + a.lit(1), a.col("b"))).alias("m")),
        data_tables, sessions)


def _raises_9c(build, tabs, sessions):
    """``build`` on the CPU route in both packages, equal by
    ``nested_differ``, with the port's fallback reported."""
    from spark_rapids_tpu_torch.obs.events import collect_fallbacks
    got = _check(build, tabs, sessions)
    assert collect_fallbacks(sessions[1].last_meta), \
        "nothing ran on the CPU route"
    return got


def test_map_entries_cpu_fallback(data_tables, sessions):
    _raises_9c(lambda a, df: df.select(a.F.map_entries(
        a.F.create_map(a.col("a"), a.col("b"))).alias("e")),
        data_tables, sessions)


# -- higher-order functions --------------------------------------------------

def test_transform_with_outer_ref(data_tables, sessions):
    _check(lambda a, df: df.select(a.F.transform(
        a.F.array(a.col("a"), a.col("a") + a.lit(1),
                  a.col("c").cast("bigint")),
        lambda x: x * a.lit(2) + a.col("a")).alias("t")),
        data_tables, sessions)


def test_transform_with_index(data_tables, sessions):
    _check(lambda a, df: df.select(a.F.transform(
        a.F.array(a.col("a"), a.col("a") * a.lit(3)),
        lambda x, i: x + i).alias("t")), data_tables, sessions)


def test_transform_null_elements(sessions):
    got = _check(lambda a, df: df.select(a.F.transform(
        a.col("arr"), lambda x: x + a.lit(10)).alias("t")),
        _one("arr", TT.ArrayType(TT.LONG), [[1, None, 3], None, [], [None]]),
        sessions)
    assert got.columns[0].data[0] == [11, None, 13]


def test_filter_array(data_tables, sessions):
    _check(lambda a, df: df.select(a.F.filter_array(
        a.F.array(a.col("a"), a.col("a") + a.lit(1), a.col("a") + a.lit(2)),
        lambda x: x % a.lit(2) == a.lit(0)).alias("t")),
        data_tables, sessions)


def test_exists_forall_three_valued(sessions):
    got = _check(lambda a, df: df.select(
        a.F.exists(a.col("arr"), lambda x: x == a.lit(2)).alias("e"),
        a.F.forall(a.col("arr"), lambda x: x > a.lit(0)).alias("f")),
        _one("arr", TT.ArrayType(TT.LONG),
             [[1, 2], [None, 2], [None, 5], [], None, [7]]), sessions)
    e, f = got.columns
    assert [bool(x) if v else None for x, v in zip(e.data, e.validity)] == \
        [True, True, None, False, None, False]
    assert [bool(x) if v else None for x, v in zip(f.data, f.validity)] == \
        [True, None, None, True, None, True]


def test_map_filter_and_transforms(data_tables, sessions):
    def mk(a):
        return a.F.create_map(a.col("a"), a.col("b"), a.col("a") + a.lit(7),
                              a.col("b") + a.lit(2.0))
    _check(lambda a, df: df.select(a.F.map_filter(
        mk(a), lambda k, v: k > a.lit(0)).alias("m")),
        data_tables, sessions)
    _check(lambda a, df: df.select(a.F.transform_values(
        mk(a), lambda k, v: v * a.lit(3.0) + k.cast("double")).alias("m")),
        data_tables, sessions)
    _check(lambda a, df: df.select(a.F.transform_keys(
        mk(a), lambda k, v: k * a.lit(2)).alias("m")),
        data_tables, sessions)


def test_arrays_zip_cpu(data_tables, sessions):
    _raises_9c(lambda a, df: df.select(a.F.arrays_zip(
        a.F.array(a.col("a")), a.F.array(a.col("c").cast("bigint"),
                                         a.col("a"))).alias("z")),
        data_tables, sessions)


def test_nested_fallback_tagging(sessions):
    """Sorting by a field of a raw struct scan column: both sort the
    projected field on the device, and run a sort that carries the struct
    itself on the CPU route."""
    st = TT.StructType([TT.StructField("x", TT.LONG)])
    tabs = _one("s", st, [(3,), (1,), (2,)])
    got = _check(lambda a, df: df.select(
        a.F.get_field(a.col("s"), "x").alias("x")).sort("x"), tabs, sessions)
    assert got.columns[0].data.tolist() == [1, 2, 3]
    _raises_9c(lambda a, df: df.sort(a.F.get_field(a.col("s"), "x")),
               tabs, sessions)


def test_hof_survives_masked_input(data_tables, sessions):
    """A higher-order function over a masked (filtered, uncompacted)
    batch: the project compacts first."""
    _check(lambda a, df: df.filter(a.col("a") > a.lit(0)).select(
        a.F.transform(a.F.array(a.col("a"), a.col("c").cast("bigint")),
                      lambda x: x + a.lit(1)).alias("t")),
        data_tables, sessions)


def test_hof_fused_into_an_aggregate_over_masked_input(data_tables,
                                                       sessions):
    """Arrays built inside an aggregate's fused input chain over a masked
    batch: the dead rows' elements are packed away (one compaction)."""
    _check(lambda a, df: df.filter(a.col("a") > a.lit(0)).group_by("c").agg(
        a.F.sum(a.F.size(a.F.filter_array(
            a.F.array(a.col("a"), a.col("a") + a.lit(1)),
            lambda x: x % a.lit(2) == a.lit(0)))).alias("n")).sort("c"),
        data_tables, sessions)
