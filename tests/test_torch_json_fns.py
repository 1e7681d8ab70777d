"""The port's JSON functions (ops/json_fns.py, ops/json_structs.py)
against the JAX package's over the same documents: a counterpart of each
JSON case of ``tests/test_expr_breadth.py`` (get_json_object, the
wildcard, json_tuple, a per-row path) and ``tests/test_expr_tail.py``
(from_json, a field of it, to_json). ``get_json_object``, ``json_tuple``
and ``from_json`` run on the device (dictionary transforms: each distinct
document parses once on the host); ``to_json``, a path that is not a
literal and a schema without a device layout run on the CPU route,
reported. Comparators: ``scale_test.tables_differ`` (bitwise, in order:
projections over one batch), and ``tests/torch_nested.py::
nested_differ`` for struct results. Each case also runs with
``spark.rapids.sql.enabled=false`` in both packages (their CPU routes)."""

import numpy as np
import pytest

from scale_test import tables_differ
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as TT
from spark_rapids_tpu_torch.obs.events import collect_fallbacks
from spark_rapids_tpu_torch.session import TorchSession
from tests.torch_nested import as_reference, nested_differ, tables

DOCS = [
    '{"a": 1, "b": {"c": "x"}, "arr": [10, 20, {"d": true}]}',
    '{"a": "str", "arr": []}',
    'not json',
    '{"a": null}',
    '{"b": {"c": "y"}, "arr": [1, 2, 3]}',
]

OFF = {"spark.rapids.sql.enabled": "false"}


def _docs(docs=DOCS, extra=()):
    return tables([("j", TT.STRING, list(docs))] + list(extra))


def _both(build, tabs, conf=None):
    """(reference result, port result as a reference table, port
    session) of ``build(api, df)``."""
    from tests.torch_nested import PORT, REF
    ts = TorchSession(conf, device="cpu")
    want = build(REF, REF.frm(tabs[0], TpuSession(conf))).collect_table()
    got = build(PORT, PORT.frm(tabs[1], ts)).collect_table()
    return want, as_reference(got), ts


def _json(api):
    if api.T.__name__.startswith("spark_rapids_tpu_torch"):
        from spark_rapids_tpu_torch.ops import json_fns
    else:
        from spark_rapids_tpu.ops import json_fns
    return json_fns


def _gjo(api, path):
    return _json(api).GetJsonObject(api.col("j"), api.lit(path))


@pytest.mark.parametrize("conf", [None, OFF], ids=["device", "cpu_route"])
def test_get_json_object(conf):
    def q(a, df):
        return df.select(_gjo(a, "$.a").alias("a"), _gjo(a, "$.b.c")
                         .alias("bc"), _gjo(a, "$.arr[1]").alias("i1"),
                         _gjo(a, "$.arr[2].d").alias("d"),
                         _gjo(a, "$.missing").alias("m"))
    want, got, ts = _both(q, _docs(), conf)
    assert tables_differ(want, got) is None
    rows = [tuple(c.data[i] if c.validity[i] else None for c in got.columns)
            for i in range(got.num_rows)]
    assert rows[0] == ("1", "x", "20", "true", None)
    assert rows[2] == (None,) * 5
    if conf is None:
        assert collect_fallbacks(ts.last_meta) == []


@pytest.mark.parametrize("conf", [None, OFF], ids=["device", "cpu_route"])
def test_get_json_object_objects_and_wildcard(conf):
    def q(a, df):
        return df.select(_gjo(a, "$.b").alias("obj"),
                         _gjo(a, "$.arr[*]").alias("w"))
    want, got, _ = _both(q, _docs(), conf)
    assert tables_differ(want, got) is None
    assert got.columns[0].data[0] == '{"c":"x"}'
    assert got.columns[1].data[4] == "[1,2,3]"


@pytest.mark.parametrize("conf", [None, OFF], ids=["device", "cpu_route"])
def test_json_tuple(conf):
    want, got, _ = _both(lambda a, df: df.select(
        *_json(a).json_tuple(a.col("j"), "a", "b")), _docs(), conf)
    assert tables_differ(want, got) is None
    assert got.columns[0].data[0] == "1" and got.columns[0].data[1] == "str"


def test_get_json_object_per_row_path():
    """A path that is not a literal evaluates per row on the CPU route,
    reported; the port's DSL form (``F.get_json_object``) equals the
    expression's."""
    tabs = _docs(['{"a":1,"b":2}', '{"a":3,"b":4}'],
                 [("p", TT.STRING, ["$.a", "$.b"])])
    want, got, ts = _both(lambda a, df: df.select(
        _json(a).GetJsonObject(a.col("j"), a.col("p")).alias("v")), tabs)
    assert tables_differ(want, got) is None
    assert [got.columns[0].data[i] for i in range(2)] == ["1", "4"]
    assert collect_fallbacks(ts.last_meta) == [{"op": "Project", "reasons": [
        "expression GetJsonObject configuration is not supported on GPU"]}]


@pytest.mark.parametrize("conf", [None, OFF], ids=["device", "cpu_route"])
def test_from_json_device_and_oracle(conf):
    def q(a, df):
        st = a.T.StructType([a.T.StructField("a", a.T.LONG),
                             a.T.StructField("b", a.T.DOUBLE)])
        return df.select(a.F.from_json(a.col("j"), st).alias("s"))
    docs = ['{"a": 1, "b": 2.5}', '{"a": 7}', "not json", None,
            '{"a": "wrongtype", "b": 3}', '[1,2]']
    want, got, ts = _both(q, _docs(docs), conf)
    assert nested_differ(want, got) is None, nested_differ(want, got)
    rows = [got.columns[0].data[i] if got.columns[0].validity[i] else None
            for i in range(got.num_rows)]
    # PERMISSIVE: a malformed or non-object document gives a row of null
    # fields; only a null input gives a null struct
    assert rows == [(1, 2.5), (7, None), (None, None), None, (None, 3.0),
                    (None, None)]
    if conf is None:
        assert collect_fallbacks(ts.last_meta) == []


@pytest.mark.parametrize("conf", [None, OFF], ids=["device", "cpu_route"])
def test_from_json_then_get_field(conf):
    docs = ['{"x": %d}' % i for i in range(50)] + [None, "oops"]

    def q(a, df):
        st = a.T.StructType([a.T.StructField("x", a.T.LONG)])
        return df.select(a.F.get_field(a.F.from_json(a.col("j"), st), "x")
                         .alias("v"))
    want, got, _ = _both(q, _docs(docs), conf)
    assert tables_differ(want, got) is None
    assert list(got.columns[0].validity) == [True] * 50 + [False, False]


def test_from_json_of_strings_runs_on_the_cpu_route():
    """A schema with a string field has no device layout: from_json runs
    on the CPU route in the port, equal to the reference's."""
    def q(a, df):
        st = a.T.StructType([a.T.StructField("a", a.T.STRING)])
        return df.select(a.F.from_json(a.col("j"), st).alias("s"))
    want, got, ts = _both(q, _docs())
    assert nested_differ(want, got) is None, nested_differ(want, got)
    assert collect_fallbacks(ts.last_meta)[0]["op"] == "Project"


@pytest.mark.parametrize("conf", [None, OFF], ids=["device", "cpu_route"])
def test_to_json_roundtrip(conf):
    tabs = tables([("a", TT.LONG, [0, 1, 2]),
                   ("b", TT.DOUBLE, [1.5, 2.0, -3.25])])
    want, got, ts = _both(lambda a, df: df.select(a.F.to_json(a.F.struct(
        a.col("a"), a.col("b"), names=["a", "b"])).alias("j")), tabs, conf)
    assert tables_differ(want, got) is None
    assert got.columns[0].data[0] == '{"a":0,"b":1.5}'
    if conf is None:
        assert collect_fallbacks(ts.last_meta) == [{
            "op": "Project", "reasons": [
                "expression StructsToJson configuration is not supported "
                "on GPU"]}]


def test_to_json_in_sql_resolves():
    """to_json is a builtin of both SQL registries (the port's list of
    unported builtins is empty)."""
    from spark_rapids_tpu_torch.sql import registry
    assert registry.UNPORTED == {}
    assert registry.lookup("to_json") is not None


def test_to_json_then_the_json_functions_round_trip():
    """to_json on the CPU route, then get_json_object and from_json on the
    device over its strings: the columns come back bit for bit."""
    rng = np.random.default_rng(5)
    k = rng.integers(-10**12, 10**12, 300)
    v = rng.standard_normal(300) * 1e3
    tabs = tables([("k", TT.LONG, k.tolist()), ("v", TT.DOUBLE,
                                                v.tolist())])

    def q(a, df):
        st = a.T.StructType([a.T.StructField("k", a.T.LONG),
                             a.T.StructField("v", a.T.DOUBLE)])
        js = df.select(a.F.to_json(a.F.struct(a.col("k"), a.col("v")))
                       .alias("j"))
        s = a.F.from_json(a.col("j"), st)
        return js.select(a.F.get_field(s, "k").alias("k"),
                         a.F.get_field(s, "v").alias("v"))
    want, got, ts = _both(q, tabs)
    assert tables_differ(want, got) is None
    assert got.columns[0].data.tobytes() == k.tobytes()
    assert got.columns[1].data.tobytes() == v.tobytes()
    assert [f["op"] for f in collect_fallbacks(ts.last_meta)] == ["Project"]
