"""The port's CSV scan and writer (spark_rapids_tpu_torch/io/csv.py over
io/text_format.py and native/text_host.cpp) against the reference's
(pyarrow underneath): every case of tests/test_csv_json_options.py's CSV
half and the CSV cases of tests/test_io.py, Arrow's type inference over
the whole file, multi-file reads with a drifting type, the three reader
modes, the three parse modes, the file cache's key, and the SQL options
the port reads differently (pinned as deviations).

Each case runs on both packages over the same files: the reference on
``TpuSession``, the port on ``TorchSession(device="cpu")``. Comparator:
``scale_test.tables_differ`` (bitwise, in order) unless a case names
another."""

import math
import os

import numpy as np
import pytest

from scale_test import tables_differ, tables_differ_unordered
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
    """A schema of type names in one package's types."""
    return [(n, types.parse_type(t)) for n, t in pairs]


def _both(ref, port, build):
    """(reference table, port table in the reference's classes) of one
    query, built per package by build(session, types module)."""
    want = build(ref, JT).collect_table()
    got = _as_reference(build(port, T).collect_table())
    return want, got


def _same(ref, port, build, cmp=tables_differ):
    want, got = _both(ref, port, build)
    assert [n for n in got.names] == [n for n in want.names]
    assert [str(c.dtype) for c in got.columns] == \
        [str(c.dtype) for c in want.columns]
    assert cmp(got, want) is None
    return got


def _both_raise(ref, port, build, match=None):
    with pytest.raises(Exception, match=match):
        build(ref, JT).collect_table()
    with pytest.raises(Exception, match=match):
        build(port, T).collect_table()


# -- tests/test_csv_json_options.py, CSV half -------------------------------------

def test_csv_sep_quote_comment_null(ref, port, tmp_path):
    p = _write(tmp_path, "t.csv",
               "# a comment line\n"
               "a;b;c\n"
               "1;'x;y';NA\n"
               "   # mid comment\n"
               "2;z;7\n")
    got = _same(ref, port, lambda s, t: s.read_csv(
        p, sep=";", quote="'", comment="#", null_value="NA",
        schema=_schema([("a", "int"), ("b", "string"), ("c", "int")], t)))
    assert got.num_rows == 2


def test_csv_custom_float_spellings(ref, port, tmp_path):
    p = _write(tmp_path, "f.csv", "x\nbad\n1.5\nP_INF\nN_INF\n 2_5 \n")
    got = _same(ref, port, lambda s, t: s.read_csv(
        p, nan_value="bad", positive_inf="P_INF", negative_inf="N_INF",
        schema=_schema([("x", "double")], t)))
    vals = got.columns[0].data
    assert math.isnan(vals[0]) and vals[1] == 1.5 and vals[4] == 25.0


def test_csv_headerless_and_whitespace(ref, port, tmp_path):
    p = _write(tmp_path, "h.csv", "1,  padded  \n2,x\n3,\t tab \n")
    _same(ref, port, lambda s, t: s.read_csv(
        p, header=False, ignore_leading_whitespace=True,
        ignore_trailing_whitespace=True,
        schema=_schema([("i", "int"), ("s", "string")], t)))


@pytest.mark.parametrize("lead,trail", [(True, False), (False, True)])
def test_csv_one_sided_whitespace(ref, port, tmp_path, lead, trail):
    p = _write(tmp_path, "w.csv", "s\n  a  \n b\nc \n")
    _same(ref, port, lambda s, t: s.read_csv(
        p, ignore_leading_whitespace=lead, ignore_trailing_whitespace=trail,
        schema=_schema([("s", "string")], t)))


def test_csv_dropmalformed(ref, port, tmp_path):
    p = _write(tmp_path, "m.csv", "a,b\n1,2\nonly_one_field\n3,4\n")
    got = _same(ref, port, lambda s, t: s.read_csv(
        p, mode="DROPMALFORMED",
        schema=_schema([("a", "int"), ("b", "int")], t)))
    assert got.num_rows == 2


def test_csv_timestamp_format(ref, port, tmp_path):
    p = _write(tmp_path, "d.csv", "t\n2024/01/15 10:30:00\n1999/12/31 "
               "23:59:59\n")
    _same(ref, port, lambda s, t: s.read_csv(
        p, timestamp_format="yyyy/MM/dd HH:mm:ss",
        schema=_schema([("t", "timestamp")], t)))


@pytest.mark.parametrize("pattern,text", [
    ("QQQ-weird", "x"), ("MMMM dd, yyyy", "July 04, 2026")],
    ids=["bad token", "repeated token"])
def test_csv_pattern_rejected(ref, port, tmp_path, pattern, text):
    p = _write(tmp_path, "bad.csv", f"t\n{text}\n")
    _both_raise(ref, port, lambda s, t: s.read_csv(
        p, timestamp_format=pattern, schema=_schema([("t", "timestamp")], t)),
        match="pattern|MMMM")


def test_csv_timestamp_format_mismatch_raises(ref, port, tmp_path):
    p = _write(tmp_path, "d.csv", "t\n2024-01-15 10:30:00\n")
    _both_raise(ref, port, lambda s, t: s.read_csv(
        p, timestamp_format="yyyy/MM/dd HH:mm:ss",
        schema=_schema([("t", "timestamp")], t)))


def test_csv_permissive_null_fills_ragged_rows(ref, port, tmp_path):
    """PERMISSIVE rebuilds a ragged row by a naive split and appends it
    after the file's other rows (the reference's order, compared in
    order)."""
    p = _write(tmp_path, "rag.csv", "a,b,s,d\n1,2,x,2020-01-01\n3\n"
               "5,6,y,2021-02-03\n7,,\"q,r\",2022-03-04,extra\n 8 ,9.9,,"
               "2020-1-2,z\n")
    got = _same(ref, port, lambda s, t: s.read_csv(
        p, schema=_schema([("a", "int"), ("b", "int"), ("s", "string"),
                           ("d", "date")], t)))
    assert got.num_rows == 5


def test_csv_dropmalformed_custom_float_drops_row(ref, port, tmp_path):
    p = _write(tmp_path, "cf.csv", "x,y\n1.5,a\nxyz,b\n2.5,c\n,d\n")
    got = _same(ref, port, lambda s, t: s.read_csv(
        p, mode="DROPMALFORMED", nan_value="strange",
        schema=_schema([("x", "double"), ("y", "string")], t)))
    assert got.num_rows == 3


@pytest.mark.parametrize("mode", ["PERMISSIVE", "FAILFAST"])
def test_csv_custom_float_malformed_other_modes(ref, port, tmp_path, mode):
    p = _write(tmp_path, "cf.csv", "x,y\n1.5,a\nxyz,b\n")
    build = (lambda s, t: s.read_csv(
        p, mode=mode, nan_value="strange",
        schema=_schema([("x", "float"), ("y", "string")], t)))
    if mode == "FAILFAST":
        _both_raise(ref, port, build, match="malformed float")
    else:
        _same(ref, port, build)


def test_csv_schema_inference_still_works(ref, port, tmp_path):
    p = _write(tmp_path, "inf.csv", "a,b\n1,x\n2,y\n")
    _same(ref, port, lambda s, t: s.read_csv(p))


def test_csv_permissive_ragged_with_pruning(ref, port, tmp_path):
    """Null-filled ragged fields map by the file's physical order when
    columns are pruned."""
    p = _write(tmp_path, "prune.csv", "a,b\n1,2\n3\n")
    _same(ref, port, lambda s, t: s.read_csv(
        p, schema=_schema([("a", "int"), ("b", "int")], t), columns=["b"]))


def test_filecache_distinguishes_options(tmp_path):
    from spark_rapids_tpu_torch.io.filecache import FILE_CACHE
    p = _write(str(tmp_path), "o.csv", "a\nNA\n5\n")
    s = TorchSession({"spark.rapids.filecache.enabled": "true"},
                     device="cpu")
    FILE_CACHE.clear()
    r1 = s.read_csv(p, null_value="NA",
                    schema=[("a", T.STRING)]).collect()
    r2 = s.read_csv(p, null_value="zz",
                    schema=[("a", T.STRING)]).collect()
    assert r1 == [(None,), ("5",)]
    assert r2 == [("NA",), ("5",)]
    hits = FILE_CACHE.hits
    s.read_csv(p, null_value="NA", schema=[("a", T.STRING)]).collect()
    assert FILE_CACHE.hits == hits + 1
    FILE_CACHE.clear()


# -- tests/test_io.py, CSV cases ---------------------------------------------------

def test_csv_roundtrip(ref, port, tmp_path):
    """The reference's table written by both writers: the same bytes, and
    each file reads back equal through both readers."""
    from spark_rapids_tpu.io.csv import write_csv as jwrite_csv
    from spark_rapids_tpu_torch.io.csv import write_csv
    jt = table_gen({"i": JT.INT, "d": JT.DOUBLE, "s": JT.STRING}, 500,
                   seed=3)
    jpaths = jwrite_csv(jt, str(tmp_path / "j"))
    tpaths = write_csv(_as_port(jt), str(tmp_path / "t"))
    with open(jpaths[0], "rb") as a, open(tpaths[0], "rb") as b:
        assert a.read() == b.read()
    for paths in (jpaths, tpaths):
        _same(ref, port, lambda s, t: s.read_csv(*paths, schema=_schema(
            [("i", "int"), ("d", "double"), ("s", "string")], t)))


def test_csv_headerless_with_schema(ref, port, tmp_path):
    p = _write(tmp_path, "raw.csv", "1,a\n2,b\n3,\n")
    got = _same(ref, port, lambda s, t: s.read_csv(
        p, schema=_schema([("n", "int"), ("s", "string")], t),
        header=False))
    assert got.columns[1].validity.tolist() == [True, True, False]


# -- Arrow's inference (hazard 1) ------------------------------------------------

def test_inference_row_of_every_kind(ref, port, tmp_path):
    """int64, double, bool, date32, timestamp[s], string, a timestamp with
    a fraction (timestamp[ns] in this pyarrow) and an all-empty column
    (null)."""
    p = _write(tmp_path, "k.csv", "a,b,c,d,e,f,g,h\n1,1.5,true,2020-01-02,"
               "2020-01-02 03:04:05,x,2020-01-02T03:04:05.123,\n")
    got = _same(ref, port, lambda s, t: s.read_csv(p))
    assert [str(c.dtype) for c in got.columns] == [
        "bigint", "double", "boolean", "date", "timestamp", "string",
        "timestamp", "void"]


def test_integral_doubles_read_back_as_long(ref, port, tmp_path):
    """Arrow's writer renders 17.0 as 17, so a DOUBLE column of integral
    values reads back as LONG when no schema is given."""
    from spark_rapids_tpu_torch.io.csv import write_csv
    t = HostTable(["q", "x"], [
        HostColumn(T.DOUBLE, np.array([17.0, 3.0, -0.0, 1e9])),
        HostColumn(T.DOUBLE, np.array([1.5, 2.0, 3.0, 4.0]))])
    paths = write_csv(t, str(tmp_path / "d"))
    got = _same(ref, port, lambda s, tt: s.read_csv(*paths))
    assert [str(c.dtype) for c in got.columns] == ["bigint", "double"]


@pytest.mark.parametrize("rows,kind", [
    (["1", "", "2"], "int"), (["0x1f", "12"], "int"),
    (["9223372036854775807", "-9223372036854775808"], "int"),
    (["9223372036854775808"], "float"), (["+5"], "float"),
    (["true", "False", "TRUE"], "bool"), (["1", "true"], "bool"),
    (["1e5", ".5", "1.", "-0.0"], "float"), (["nan", "inf", "-Inf"], "float"),
    (["1e400", "1e-400", "4.9e-324"], "float"),
    (["2020-01-02", " 2020-01-03"], "date"),
    (["2020-01-02", "2020-01-02 03:04:05"], "ts"),
    (["2020-01-02T03:04:05Z", "2020-01-02T03:04:05+01:00"], "ts"),
    (["2020-01-02 03:04:05.5", "2020-01-02 03:04:05"], "ts"),
    (["2020-01-02T03:04:05Z", "2020-01-02 03:04:05"], "string"),
    (["2020-02-30"], "string"), (["t", "yes"], "string"),
    (['"5"', '" 6"'], "int"), (['""', "x"], "string"),
], ids=lambda v: "|".join(v) if isinstance(v, list) else v)
def test_inference_matches_arrow(ref, port, tmp_path, rows, kind):
    p = _write(tmp_path, "i.csv", "x,y\n" + "".join(
        f"{r},{i}\n" for i, r in enumerate(rows)))
    got = _same(ref, port, lambda s, t: s.read_csv(p))
    assert str(got.columns[0].dtype) == {
        "int": "bigint", "float": "double", "bool": "boolean",
        "date": "date", "ts": "timestamp", "string": "string"}[kind]


def test_inference_spans_the_whole_file(ref, port, tmp_path):
    """Past Arrow's first 1 MiB block a string still makes the column a
    string column: inference reads the whole file."""
    p = _write(tmp_path, "big.csv", "x\n" + "1\n" * 700_000 + "abc\n")
    got = _same(ref, port, lambda s, t: s.read_csv(p))
    assert str(got.columns[0].dtype) == "string"


def test_time_column_raises(ref, port, tmp_path):
    p = _write(tmp_path, "t.csv", "x\n12:34:56\n")
    _both_raise(ref, port, lambda s, t: s.read_csv(p), match="time")


# -- the tokenizer on files ------------------------------------------------------

@pytest.mark.parametrize("text", [
    'a,b\r\n"x""y",1\r\n"p,q",2\r\n"n\nl",3',
    'a,b\n\n\n"z" ,4\n,5\n"",6\n',
    'a,b\nq"r,7\n x,8\n',
], ids=["crlf quotes doubled no final newline", "empty lines",
        "inner quote"])
def test_tokenizer_cases_on_files(ref, port, tmp_path, text):
    p = _write(tmp_path, "tok.csv", text)
    _same(ref, port, lambda s, t: s.read_csv(p))


def test_escape_char(ref, port, tmp_path):
    p = _write(tmp_path, "e.csv", 'a,b\nx\\,y,1\n"c\\"d",2\n')
    _same(ref, port, lambda s, t: s.read_csv(p, escape="\\"))


def test_null_and_empty_values(ref, port, tmp_path):
    p = _write(tmp_path, "n.csv", 'a,b\nNA,1\n,\n"",3\nEMPTY,4\n')
    for kw in ({}, {"null_value": "NA"},
               {"null_value": "NA", "empty_value": "EMPTY"}):
        _same(ref, port, lambda s, t: s.read_csv(
            p, schema=_schema([("a", "string"), ("b", "string")], t), **kw))


@pytest.mark.parametrize("ty,values", [
    ("tinyint", ["1", "-128", "127"]), ("smallint", ["-32768", "32767"]),
    ("int", ["0x7fffffff", "-2147483648", " 12 "]),
    ("bigint", ["9223372036854775807", "-9223372036854775808"]),
    ("float", ["0.1", "3.4028235e38", "1e-45", "-0.0", "nan"]),
    ("double", ["2.2250738585072014e-308", "5e-324", "-0.0", "+1.5",
                "1e400"]),
    ("boolean", ["1", "0", "True", "FALSE"]),
    ("date", ["2020-02-29", "1969-12-31", "0001-01-01", "9999-12-31"]),
    ("timestamp", ["2020-01-02", "2020-01-02 03:04:05.123456",
                   "1969-12-31T23:59:59.999999", "2020-01-02T03"]),
    ("decimal(10,2)", ["1.5", "-0.05", "12345678.9", "1e2"]),
    ("decimal(38,4)", ["123456789012345678901234567890.1234", "-1"]),
], ids=lambda v: v if isinstance(v, str) else "")
def test_user_schema_edge_values(ref, port, tmp_path, ty, values):
    p = _write(tmp_path, "v.csv", "x\n" + "\n".join(values) + "\n")
    _same(ref, port, lambda s, t: s.read_csv(
        p, schema=_schema([("x", ty)], t)))


@pytest.mark.parametrize("ty,bad", [
    ("int", "2147483648"), ("tinyint", "128"), ("bigint", "+1"),
    ("bigint", "1.0"), ("double", "1.5f"), ("boolean", "t"),
    ("date", "2020-1-2"), ("timestamp", "2020-01-02T03:04:05Z"),
    ("timestamp", "2020-01-02 03:04:05.1234567"), ("decimal(5,2)", "1.505"),
])
@pytest.mark.parametrize("mode", ["PERMISSIVE", "DROPMALFORMED",
                                  "FAILFAST"])
def test_conversion_error_raises_in_every_mode(ref, port, tmp_path, ty, bad,
                                               mode):
    """A value that does not convert to the schema's type raises (pyarrow's
    ArrowInvalid), whatever the mode (hazard 4)."""
    p = _write(tmp_path, "c.csv", f"x\n{bad}\n")
    _both_raise(ref, port, lambda s, t: s.read_csv(
        p, mode=mode, schema=_schema([("x", ty)], t)))


def test_failfast_raises_on_a_ragged_row(ref, port, tmp_path):
    p = _write(tmp_path, "f.csv", "a,b\n1,2\n3\n")
    _both_raise(ref, port, lambda s, t: s.read_csv(
        p, mode="FAILFAST", schema=_schema([("a", "int"), ("b", "int")],
                                           t)), match="columns")


def test_empty_file_raises_and_header_only_is_empty(ref, port, tmp_path):
    e = _write(tmp_path, "e.csv", "")
    _both_raise(ref, port, lambda s, t: s.read_csv(e), match="Empty")
    h = _write(tmp_path, "h.csv", "a,b\n")
    got = _same(ref, port, lambda s, t: s.read_csv(
        h, schema=_schema([("a", "int"), ("b", "string")], t)))
    assert got.num_rows == 0


# -- multi-file reads and reader modes ----------------------------------------------

@pytest.mark.parametrize("first,second,ok", [
    ("1\n2\n", "1.5\n", False), ("1.5\n", "2\n", True),
    ("1.5\n", "9007199254740993\n", False), ("2020-01-02\n", "x\n", False),
    ("x\n", "7\n", True), ("\n", "5\n", True),
    ("2020-01-02\n", "2020-01-02 00:00:00\n", True),
    ("2020-01-02\n", "2020-01-02 01:00:00\n", True),
], ids=["int then fraction", "double then int", "int past 2^53",
        "date then string", "string then int", "null then int",
        "date then midnight", "date then time of day"])
def test_multifile_drifting_type(ref, port, tmp_path, first, second, ok):
    """The first file sets the schema; a later file converts by Arrow's
    safe cast or the read raises."""
    a = _write(tmp_path, "a.csv", "x,y\n" + "".join(
        f"{v},{i}\n" for i, v in enumerate(first.split("\n")[:-1])))
    b = _write(tmp_path, "b.csv", "x,y\n" + "".join(
        f"{v},{i}\n" for i, v in enumerate(second.split("\n")[:-1])))

    def build(s, t):
        return s.read_csv(a, b, reader_type="PERFILE")
    if ok:
        _same(ref, port, build)
    else:
        _both_raise(ref, port, build)


@pytest.mark.parametrize("mode", ["PERFILE", "COALESCING", "MULTITHREADED",
                                  "AUTO"])
def test_reader_modes(ref, port, tmp_path, mode):
    from spark_rapids_tpu_torch.io.csv import write_csv
    paths = []
    for k in range(3):
        jt = table_gen({"i": JT.INT, "l": JT.LONG, "s": JT.STRING,
                        "b": JT.BOOLEAN}, 300, seed=k)
        paths += write_csv(_as_port(jt), str(tmp_path / f"f{k}"))
    got = _same(ref, port, lambda s, t: s.read_csv(
        *paths, reader_type=mode, schema=_schema(
            [("i", "int"), ("l", "bigint"), ("s", "string"),
             ("b", "boolean")], t)))
    assert got.num_rows == 900


def test_partitioned_csv_and_input_file(ref, port, tmp_path):
    """A partitioned write reads back with its partition column (the
    comparator: tables_differ_unordered, files in directory order)."""
    from spark_rapids_tpu_torch.io.csv import write_csv
    t = HostTable(["v", "p"], [
        HostColumn(T.LONG, np.arange(6, dtype=np.int64)),
        HostColumn(T.STRING, np.array(list("xyxyxy"), dtype=object))])
    write_csv(t, str(tmp_path / "pt"), partition_by=["p"])
    _same(ref, port, lambda s, tt: s.read_csv(str(tmp_path / "pt")),
          cmp=tables_differ_unordered)


# -- SQL OPTIONS (hazard 8): deviations, pinned ------------------------------------

def test_sql_option_strings_are_parsed_unlike_the_reference(tmp_path):
    """SQL OPTIONS arrive as strings. The reference passes them as they
    are, so ``header 'false'`` is a truthy string there and the first
    row is taken as names; the port parses 'true'/'false'."""
    p = _write(tmp_path, "h.csv", "1,x\n2,y\n")
    ref = TpuSession()
    ref.sql(f"CREATE TEMP VIEW v USING csv OPTIONS (path '{p}', header "
            "'false', schema 'a INT, b STRING')")
    with pytest.raises(Exception):
        ref.sql("SELECT a FROM v").collect()
    port = TorchSession(device="cpu")
    port.sql(f"CREATE TEMP VIEW v USING csv OPTIONS (path '{p}', header "
             "'false', schema 'a INT, b STRING')")
    assert port.sql("SELECT a, b FROM v ORDER BY a").collect() == \
        [(1, "x"), (2, "y")]


def test_unknown_option_raises_unlike_the_reference(tmp_path):
    """The reference keeps an option name it does not know (Spark's
    camelCase ``nullValue``) in ``FileScanNode.options`` and ignores it;
    the port raises."""
    p = _write(tmp_path, "n.csv", "a\nNA\n5\n")
    ref = TpuSession()
    ref.sql(f"CREATE TEMP VIEW v USING csv OPTIONS (path '{p}', nullValue "
            "'NA')")
    assert sorted(ref.sql("SELECT a FROM v").collect(), key=repr) == \
        [("5",), ("NA",)]
    port = TorchSession(device="cpu")
    with pytest.raises(ValueError, match="nullValue"):
        port.sql(f"CREATE TEMP VIEW v USING csv OPTIONS (path '{p}', "
                 "nullValue 'NA')")
    with pytest.raises(ValueError, match="nullValue"):
        port.read_csv(p, nullValue="NA")


def test_sql_using_csv_matches_the_dsl(port, tmp_path):
    p = _write(tmp_path, "s.csv", "k,v\na,1\nb,2\na,3\n")
    port.sql(f"CREATE OR REPLACE TEMP VIEW kv USING csv OPTIONS (path "
             f"'{p}', null_value 'NA', mode 'DROPMALFORMED')")
    got = port.sql("SELECT k, sum(v) AS s FROM kv GROUP BY k ORDER BY k")
    assert got.collect() == [("a", 4), ("b", 2)]


# -- deviations and traits pinned --------------------------------------------------

def test_unread_column_is_not_converted_unlike_the_reference(ref, port,
                                                             tmp_path):
    """The reference converts every column of the file, so a bad value in
    a column the query does not read raises there; the port converts the
    columns it reads."""
    p = _write(tmp_path, "c.csv", "a,b\n1,x\n")
    with pytest.raises(Exception, match="int32"):
        ref.read_csv(p, schema=[("a", JT.INT), ("b", JT.INT)],
                     columns=["a"]).collect()
    assert port.read_csv(p, schema=[("a", T.INT), ("b", T.INT)],
                         columns=["a"]).collect() == [(1,)]


def test_timestamp_format_needs_a_schema_in_the_port(ref, port, tmp_path):
    """With no schema the reference hands timestampFormat to Arrow's
    inference; the port infers ISO timestamps only, so it raises."""
    p = _write(tmp_path, "t.csv", "t\n2024/01/15 10:30:00\n")
    assert ref.read_csv(p, timestamp_format="yyyy/MM/dd HH:mm:ss").count() \
        == 1
    with pytest.raises(NotImplementedError, match="timestampFormat"):
        port.read_csv(p, timestamp_format="yyyy/MM/dd HH:mm:ss").collect()


def test_written_timestamps_read_back_only_inferred(ref, port, tmp_path):
    """Arrow's writer renders a TIMESTAMP as "... .ffffffZ": both readers
    infer it back (the zone makes it timestamp[ns, UTC]), and both raise
    on it under a TIMESTAMP schema, which parses naive (a reference trait
    the port keeps)."""
    from spark_rapids_tpu_torch.io.csv import write_csv
    t = HostTable(["ts", "i"], [
        HostColumn(T.TIMESTAMP, np.array([1, -1, 86_400_000_000 * 20000])),
        HostColumn(T.LONG, np.arange(3))])
    paths = write_csv(t, str(tmp_path / "ts"))
    got = _same(ref, port, lambda s, tt: s.read_csv(*paths))
    assert got.columns[0].data.tolist() == [1, -1, 86_400_000_000 * 20000]
    _both_raise(ref, port, lambda s, tt: s.read_csv(*paths, schema=_schema(
        [("ts", "timestamp"), ("i", "bigint")], tt)))


def test_csv_writer_bytes_over_every_flat_type(ref, port, tmp_path):
    """Every flat type through both writers: the port's bytes are
    pyarrow's (a TIMESTAMP as "... .ffffffZ", a decimal at its scale, a
    float in its shortest form), and the file reads back equal through
    both readers (TIMESTAMP inferred: under a TIMESTAMP schema both
    raise, see test_written_timestamps_read_back_only_inferred)."""
    from spark_rapids_tpu.io.csv import write_csv as jwrite_csv
    from spark_rapids_tpu_torch.io.csv import write_csv
    jt = table_gen({"y": JT.BYTE, "h": JT.SHORT, "i": JT.INT, "l": JT.LONG,
                    "f": JT.FLOAT, "d": JT.DOUBLE, "b": JT.BOOLEAN,
                    "s": JT.STRING, "dt": JT.DATE, "ts": JT.TIMESTAMP},
                   400, seed=13)
    rng = np.random.default_rng(13)
    jt = JHostTable(list(jt.names) + ["m"], list(jt.columns) + [
        JHostColumn(JT.DecimalType(12, 3),
                    rng.integers(-10**11, 10**11, 400).astype(np.int64),
                    rng.random(400) > 0.2)])
    jp = jwrite_csv(jt, str(tmp_path / "j"))
    tp = write_csv(_as_port(jt), str(tmp_path / "t"))
    with open(jp[0], "rb") as a, open(tp[0], "rb") as b:
        assert a.read() == b.read()
    pairs = [("y", "tinyint"), ("h", "smallint"), ("i", "int"),
             ("l", "bigint"), ("f", "float"), ("d", "double"),
             ("b", "boolean"), ("s", "string"), ("dt", "date"),
             ("ts", "string"), ("m", "decimal(12,3)")]
    _same(ref, port, lambda s, t: s.read_csv(*tp, schema=_schema(pairs, t)))


def test_reader_surface(port, tmp_path):
    """``session.read.csv`` / ``.json`` and ``read.format(...)``."""
    p = _write(tmp_path, "r.csv", "a,b\n1,x\n")
    j = _write(tmp_path, "r.json", '{"a": 1, "b": "x"}\n')
    assert port.read.csv(p).collect() == [(1, "x")]
    assert port.read.json(j).collect() == [(1, "x")]
    assert port.read.format("csv").option("header", "false").option(
        "schema", "a STRING, b STRING").load(p).collect() == \
        [("a", "b"), ("1", "x")]


def test_byte_order_mark_is_not_data(ref, port, tmp_path):
    p = _write(tmp_path, "bom.csv", b"\xef\xbb\xbfa,b\n1,x\n")
    got = _same(ref, port, lambda s, t: s.read_csv(p))
    assert list(got.names) == ["a", "b"]
    j = _write(tmp_path, "bom.json", b'\xef\xbb\xbf{"a": 1}\n{"a": 2}\n')
    _same(ref, port, lambda s, t: s.read_json(j))
