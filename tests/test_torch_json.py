"""The port's JSON-lines scan and writer (spark_rapids_tpu_torch/io/json.py
over io/text_format.py and native/text_host.cpp) against the reference's
(pyarrow underneath): the JSON cases of tests/test_csv_json_options.py and
tests/test_io.py, Arrow's JSON inference (hazard 2), the three modes and
the whole-file read they fall back from, user-schema conversions, the
reader modes, nested columns (which raise in the port, naming ROADMAP item
[9]) and the writer's bytes.

Each case runs on both packages over the same files: the reference on
``TpuSession``, the port on ``TorchSession(device="cpu")``. Comparator:
``scale_test.tables_differ`` (bitwise, in order) unless a case names
another."""

import os

import numpy as np
import pytest

from scale_test import tables_differ
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.session import TorchSession
from tests.data_gen import table_gen


def _as_reference(t) -> JHostTable:
    names, types, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.NULL if ty == "void" else JT.parse_type(ty), d, v)
        for ty, (d, v) in zip(types, arrays)])


def _as_port(t) -> HostTable:
    return HostTable(list(t.names), [
        HostColumn(T.parse_type(c.dtype.simple_string()), c.data, c.validity)
        for c in t.columns])


@pytest.fixture(scope="module")
def ref():
    return TpuSession()


@pytest.fixture(scope="module")
def port():
    return TorchSession(device="cpu")


def _write(tmp_path, name, text):
    p = os.path.join(str(tmp_path), name)
    with open(p, "wb") as f:
        f.write(text if isinstance(text, bytes) else text.encode())
    return p


def _schema(pairs, types):
    return [(n, types.parse_type(t)) for n, t in pairs]


def _same(ref, port, build, cmp=tables_differ):
    want = build(ref, JT).collect_table()
    got = _as_reference(build(port, T).collect_table())
    assert list(got.names) == list(want.names)
    assert [str(c.dtype) for c in got.columns] == \
        [str(c.dtype) for c in want.columns]
    assert cmp(got, want) is None
    return got


def _both_raise(ref, port, build, match=None):
    with pytest.raises(Exception, match=match):
        build(ref, JT).collect_table()
    with pytest.raises(Exception, match=match):
        build(port, T).collect_table()


# -- tests/test_csv_json_options.py, JSON half ----------------------------------

def test_json_multiline_array(ref, port, tmp_path):
    p = _write(tmp_path, "m.json",
               '[{"a": 1, "b": "x"},\n {"a": 2, "b": "y"}]')
    got = _same(ref, port, lambda s, t: s.read_json(
        p, multi_line=True, schema=_schema([("a", "bigint"),
                                            ("b", "string")], t)))
    assert got.num_rows == 2


def test_json_multiline_single_object_inferred(ref, port, tmp_path):
    p = _write(tmp_path, "o.json", '{\n  "a": 1.5,\n  "c": "2020-01-02"'
               '\n}')
    got = _same(ref, port, lambda s, t: s.read_json(p, multi_line=True))
    assert [str(c.dtype) for c in got.columns] == ["double", "timestamp"]


@pytest.mark.parametrize("mode", ["PERMISSIVE", "DROPMALFORMED"])
def test_json_permissive_and_dropmalformed(ref, port, tmp_path, mode):
    p = _write(tmp_path, "p.json", '{"a": 1}\nnot json at all\n{"a": 3}\n')
    got = _same(ref, port, lambda s, t: s.read_json(
        p, mode=mode, schema=_schema([("a", "bigint")], t)))
    assert got.num_rows == (3 if mode == "PERMISSIVE" else 2)


def test_json_failfast(ref, port, tmp_path):
    p = _write(tmp_path, "p.json", '{"a": 1}\nnot json at all\n{"a": 3}\n')
    _both_raise(ref, port, lambda s, t: s.read_json(
        p, mode="FAILFAST", schema=_schema([("a", "bigint")], t)))


def test_json_primitives_as_string(ref, port, tmp_path):
    """Leaves become Arrow's cast text: a double's text is Arrow's (2.0 as
    "2", 1e-7 as "1e-7"), a timestamp's "YYYY-MM-DD HH:MM:SS"."""
    p = _write(tmp_path, "s.json", '{"a": 1, "b": 2.5, "c": true, "d": '
               '"2020-01-02", "e": null}\n{"a": 7, "b": 2, "c": false, '
               '"d": "2021-03-04 05:06:07"}\n{"b": 1e-7, "c": null}\n'
               '{"b": 1e21}\n')
    got = _same(ref, port, lambda s, t: s.read_json(
        p, primitives_as_string=True))
    assert all(str(c.dtype) == "string" for c in got.columns)


def test_primitives_as_string_with_a_schema_raises_on_numbers(ref, port,
                                                              tmp_path):
    """With a user schema the reference asks Arrow for string columns, so
    a number raises (a reference trait the port keeps)."""
    p = _write(tmp_path, "s.json", '{"a": 1}\n')
    _both_raise(ref, port, lambda s, t: s.read_json(
        p, primitives_as_string=True, schema=_schema([("a", "bigint")], t)))


def test_json_multiline_malformed_modes(ref, port, tmp_path):
    p = _write(tmp_path, "bad.json", '[{"a": 1}, {"a": ')
    for mode, rows in (("PERMISSIVE", 1), ("DROPMALFORMED", 0)):
        got = _same(ref, port, lambda s, t: s.read_json(
            p, multi_line=True, mode=mode,
            schema=_schema([("a", "bigint")], t)))
        assert got.num_rows == rows
    _both_raise(ref, port, lambda s, t: s.read_json(
        p, multi_line=True, mode="FAILFAST",
        schema=_schema([("a", "bigint")], t)))


def test_json_nan_constant_is_malformed(ref, port, tmp_path):
    """NaN fails the LONG conversion of the whole-file read, so the line
    normalisation runs and makes the NaN line an all-null row."""
    p = _write(tmp_path, "nan.json", '{"a": 1}\n{"a": NaN}\n{"a": 3}\n')
    got = _same(ref, port, lambda s, t: s.read_json(
        p, schema=_schema([("a", "bigint")], t)))
    assert got.columns[0].validity.tolist() == [True, False, True]


def test_json_nan_reads_as_a_double_when_the_whole_file_parses(
        ref, port, tmp_path):
    """Arrow's whole-file read takes NaN and Infinity as numbers: with an
    inferred DOUBLE column nothing fails, so they stay (hazard 6)."""
    p = _write(tmp_path, "nan.json", '{"a": 1.5}\n{"a": NaN}\n'
               '{"a": -Infinity}\n')
    got = _same(ref, port, lambda s, t: s.read_json(p))
    assert np.isnan(got.columns[0].data[1])


# -- tests/test_io.py, JSON cases -------------------------------------------------

def test_multifile_schema_divergence_raises(ref, port, tmp_path):
    a = _write(tmp_path, "a.json", '{"x": 1}\n{"x": 2}\n')
    b = _write(tmp_path, "b.json", '{"x": 1.5}\n')
    _both_raise(ref, port, lambda s, t: s.read_json(a, b,
                                                    reader_type="PERFILE"))


def test_multifile_widening_reads(ref, port, tmp_path):
    a = _write(tmp_path, "a.json", '{"x": 1.5, "s": "2020-01-02"}\n')
    b = _write(tmp_path, "b.json", '{"x": 2, "s": "2020-01-03 04:05:06"}\n'
               '{"x": null}\n')
    _same(ref, port, lambda s, t: s.read_json(a, b, reader_type="PERFILE"))


def test_json_roundtrip(ref, port, tmp_path):
    from spark_rapids_tpu_torch.io.json import write_json
    t = HostTable(["a", "s"], [
        HostColumn(T.LONG, np.array([1, 2, 0]), np.array([True, True,
                                                          False])),
        HostColumn(T.STRING, np.array(["x", None, "z"], dtype=object),
                   np.array([True, False, True]))])
    write_json(t, str(tmp_path / "j"))
    got = _same(ref, port, lambda s, tt: s.read_json(str(tmp_path / "j")))
    assert got.num_rows == 3


# -- inference (hazard 2) ---------------------------------------------------------

def test_inference_rows(ref, port, tmp_path):
    """int64, double, bool, timestamp[s] for a date string, timestamp[s],
    string, null; columns in order of first appearance; 1.5 then 2 widens
    to double; a missing key is null."""
    p = _write(tmp_path, "i.json",
               '{"a":1,"b":1.5,"c":true,"d":"2020-01-02","e":"2020-01-02 '
               '03:04:05","f":"x"}\n{"a":2,"b":2,"g":null}\n')
    got = _same(ref, port, lambda s, t: s.read_json(p))
    assert [str(c.dtype) for c in got.columns] == [
        "bigint", "double", "boolean", "timestamp", "timestamp", "string",
        "void"]


@pytest.mark.parametrize("values,kind", [
    (["9223372036854775807", "-9223372036854775808"], "bigint"),
    (["9223372036854775808"], "double"), (["-0", "1e2"], "double"),
    (['"2020-01-02T03:04:05Z"', '"2020-01-02T03"'], "timestamp"),
    (['"2020-01-02T03:04:05.123"'], "string"), (['"03:04:05"'], "string"),
    (['"\\u00e9\\ud83d\\ude00"', '"a\\"b\\\\c\\n"'], "string"),
    (["true", "false", "null"], "boolean"),
], ids=lambda v: "|".join(v) if isinstance(v, list) else v)
def test_json_inference_matches_arrow(ref, port, tmp_path, values, kind):
    p = _write(tmp_path, "v.json", "".join(
        f'{{"x": {v}, "i": {i}}}\n' for i, v in enumerate(values)))
    got = _same(ref, port, lambda s, t: s.read_json(p))
    assert str(got.columns[0].dtype) == kind


@pytest.mark.parametrize("text", [
    '{"a":1}\n{"a":"x"}\n', '{"a":"x"}\n{"a":1}\n', '{"a":1}\n{"a":true}\n',
    '{"a":1, "a":2}\n', '[1]\n',
], ids=["number then string", "string then number", "number then bool",
        "key twice", "not an object"])
@pytest.mark.parametrize("mode", ["PERMISSIVE", "DROPMALFORMED", "FAILFAST"])
def test_json_conflicts_raise_in_every_mode(ref, port, tmp_path, text, mode):
    """A column whose values change kind, a key given twice, a row that
    is not an object: Arrow raises, and the line normalisation keeps such
    lines (each is valid JSON), so every mode raises."""
    p = _write(tmp_path, "c.json", text)
    _both_raise(ref, port, lambda s, t: s.read_json(p, mode=mode))


def test_json_layouts(ref, port, tmp_path):
    """Arrow reads a stream of objects: two on a line, one across lines,
    blank lines and CRLF."""
    p = _write(tmp_path, "l.json", '{"a":1}{"a":2}\n\n  {"a":\n3,"b":"q"}'
               '\r\n{"a":4}\r\n')
    _same(ref, port, lambda s, t: s.read_json(p))


def test_nested_columns_raise_naming_item_9(ref, port, tmp_path):
    """An object or array column: the reference raises on its Arrow type,
    the port raises NotImplementedError naming ROADMAP item [9] (as
    Parquet's nested columns do)."""
    p = _write(tmp_path, "n.json", '{"a": 1, "s": {"x": 1}, "l": [1, 2]}\n')
    with pytest.raises(Exception, match="struct"):
        ref.read_json(p).collect()
    with pytest.raises(NotImplementedError, match=r"\[9\]"):
        port.read_json(p).collect()
    # a user schema of flat columns reads past the nested ones
    got = _same(ref, port, lambda s, t: s.read_json(
        p, schema=_schema([("a", "bigint")], t)))
    assert got.num_rows == 1


# -- user schemas -------------------------------------------------------------------

@pytest.mark.parametrize("ty,values", [
    ("tinyint", ["1", "-128"]), ("int", ["2147483647", "-1"]),
    ("bigint", ["9223372036854775807"]), ("float", ["0.1", "1", "1e-45"]),
    ("double", ["5e-324", "-0.0", "1", "NaN"]), ("boolean", ["true", "false"]),
    ("string", ['"x"', '"\\u00e9"']),
    ("timestamp", ['"2020-01-02"', '"2020-01-02T03:04:05.123"',
                   '"2020-01-02 03:04:05Z"']),
    ("decimal(5,2)", ['"1.5"', "1.5", "-3"]),
], ids=lambda v: v if isinstance(v, str) else "")
def test_user_schema_values(ref, port, tmp_path, ty, values):
    p = _write(tmp_path, "u.json", "".join(
        f'{{"x": {v}}}\n' for v in values) + '{"y": 1}\n')
    _same(ref, port, lambda s, t: s.read_json(
        p, schema=_schema([("x", ty)], t)))


@pytest.mark.parametrize("ty,value", [
    ("bigint", "1.5"), ("bigint", '"5"'), ("string", "5"),
    ("int", "3000000000"), ("boolean", "1"), ("date", '"2020-01-02"'),
    ("bigint", "1e2"), ("double", '"1.5"'),
])
def test_user_schema_mismatch_raises(ref, port, tmp_path, ty, value):
    p = _write(tmp_path, "u.json", f'{{"x": {value}}}\n')
    _both_raise(ref, port, lambda s, t: s.read_json(
        p, schema=_schema([("x", ty)], t)))


@pytest.mark.parametrize("mode", ["PERFILE", "COALESCING", "MULTITHREADED"])
def test_reader_modes(ref, port, tmp_path, mode):
    from spark_rapids_tpu_torch.io.json import write_json
    paths = []
    for k in range(3):
        jt = table_gen({"i": JT.INT, "l": JT.LONG, "s": JT.STRING,
                        "b": JT.BOOLEAN, "d": JT.DOUBLE}, 200, seed=k)
        paths += write_json(_as_port(jt), str(tmp_path / f"f{k}"))
    _same(ref, port, lambda s, t: s.read_json(
        *paths, reader_type=mode, schema=_schema(
            [("i", "int"), ("l", "bigint"), ("s", "string"),
             ("b", "boolean"), ("d", "double")], t)))


# -- the writer ----------------------------------------------------------------------

def test_writer_bytes_equal_the_reference(ref, port, tmp_path):
    """Every flat type written by both writers: byte-identical JSON lines
    (json.dumps of the reference's Python values), and each file reads
    back equal through both readers."""
    from spark_rapids_tpu.io.json import write_json as jwrite_json
    from spark_rapids_tpu_torch.io.json import write_json
    jt = table_gen({"y": JT.BYTE, "h": JT.SHORT, "i": JT.INT, "l": JT.LONG,
                    "f": JT.FLOAT, "d": JT.DOUBLE, "b": JT.BOOLEAN,
                    "s": JT.STRING, "dt": JT.DATE, "ts": JT.TIMESTAMP},
                   400, seed=11)
    rng = np.random.default_rng(11)
    jt = JHostTable(list(jt.names) + ["u", "m"], list(jt.columns) + [
        JHostColumn(JT.STRING, np.array(["é😀\"\\\n\t\x01\x7f", None] * 200,
                                        dtype=object),
                    np.array([True, False] * 200)),
        JHostColumn(JT.DecimalType(10, 2),
                    rng.integers(-10**9, 10**9, 400).astype(np.int64),
                    rng.random(400) > 0.2)])
    jp = jwrite_json(jt, str(tmp_path / "j"))
    tp = write_json(_as_port(jt), str(tmp_path / "t"))
    with open(jp[0], "rb") as a, open(tp[0], "rb") as b:
        assert a.read() == b.read()
    for paths in (jp, tp):
        _same(ref, port, lambda s, t: s.read_json(*paths, columns=[
            "y", "l", "d", "b", "s", "u"]))


def test_sql_using_json(port, tmp_path):
    p = _write(tmp_path, "s.json", '{"k": "a", "v": 1}\n{"k": "b", "v": 2}\n'
               '{"k": "a", "v": 3}\n')
    port.sql(f"CREATE OR REPLACE TEMP VIEW kv USING json OPTIONS (path "
             f"'{p}', multi_line 'false')")
    got = port.sql("SELECT k, sum(v) AS s FROM kv GROUP BY k ORDER BY k")
    assert got.collect() == [("a", 4), ("b", 2)]


def test_a_file_missing_a_column_reads_nulls_unlike_the_reference(
        ref, port, tmp_path):
    """A later file without one of the scan's columns: the reference's
    decode leaves the column out and its batch fails (IndexError); the
    port reads the column as nulls."""
    a = _write(tmp_path, "a.json", '{"x": 1, "y": "p"}\n')
    b = _write(tmp_path, "b.json", '{"x": 2}\n')
    with pytest.raises(IndexError):
        ref.read_json(a, b, reader_type="PERFILE").collect()
    assert port.read_json(a, b, reader_type="PERFILE").collect() == \
        [(1, "p"), (2, None)]


def test_keys_in_changing_order_and_spelling(ref, port, tmp_path):
    """Keys in another order from row to row, a key that is a prefix of
    another, and a key spelled with an escape: each member lands in its
    own column."""
    p = _write(tmp_path, "k.json", '{"ab": 1, "a": 2}\n{"a": 3, "ab": 4}\n'
               '{"a\\u0062": 5, "b": "x"}\n{"b": "y", "a": 6, "ab": null}\n')
    got = _same(ref, port, lambda s, t: s.read_json(p))
    assert list(got.names) == ["ab", "a", "b"]


from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402


@st.composite
def _rows(draw):
    n = draw(st.integers(1, 10))
    ints = draw(st.lists(st.one_of(st.none(), st.integers(-2**63, 2**63 - 1)),
                         min_size=n, max_size=n))
    dbls = draw(st.lists(st.one_of(st.none(), st.floats(allow_nan=False,
                                                         width=64)),
                         min_size=n, max_size=n))
    strs = draw(st.lists(st.one_of(st.none(), st.text(max_size=6)),
                         min_size=n, max_size=n))
    bools = draw(st.lists(st.one_of(st.none(), st.booleans()),
                          min_size=n, max_size=n))
    return ints, dbls, strs, bools


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(rows=_rows())
def test_written_json_reads_back_equal_by_both_readers(ref, port, tmp_path,
                                                       rows):
    """Random tables (any int64, any finite double, any text, booleans,
    nulls) through both writers: the same bytes, read back equal by both
    readers under the tables' schema."""
    from spark_rapids_tpu.io.json import write_json as jwrite_json
    from spark_rapids_tpu_torch.io.json import render_json
    ints, dbls, strs, bools = rows
    n = len(ints)
    cols = [
        JHostColumn(JT.LONG, np.array([v or 0 for v in ints], np.int64),
                    np.array([v is not None for v in ints])),
        JHostColumn(JT.DOUBLE, np.array([v or 0.0 for v in dbls]),
                    np.array([v is not None for v in dbls])),
        JHostColumn(JT.STRING, np.array(strs + [None], dtype=object)[:n],
                    np.array([v is not None for v in strs])),
        JHostColumn(JT.BOOLEAN, np.array([bool(v) for v in bools]),
                    np.array([v is not None for v in bools]))]
    jt = JHostTable(["l", "d", "s", "b"], cols)
    d = tmp_path / f"w{abs(hash(str(rows))) % 10**9}"
    paths = jwrite_json(jt, str(d))
    with open(paths[0], "rb") as f:
        assert f.read() == render_json(_as_port(jt))
    _same(ref, port, lambda s, t: s.read_json(*paths, schema=_schema(
        [("l", "bigint"), ("d", "double"), ("s", "string"),
         ("b", "boolean")], t)))
