"""The port's text codec alone (spark_rapids_tpu_torch/io/text_format.py
over native/text_host.cpp) against pyarrow, which only tests may import:
the CSV tokenizer over quotes, escapes, doubled quotes, empty fields, CRLF,
a final line with no newline and ragged rows; Arrow's inference and each
typed parser's edge values; the formatters against Arrow's text and
Python's repr; the JSON scanner against ``json.loads``; the line filters
against the reference's; a hypothesis property over random tables written
by the port and read back by both readers; and a build with no compiler,
which raises with the compiler's message.

Comparators: exact equality of texts, kinds and bit patterns;
``scale_test.tables_differ`` (bitwise, in order) for tables."""

import io
import json
import math
import os
import struct

import numpy as np
import pyarrow as pa
import pyarrow.csv as pcsv
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from scale_test import tables_differ
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.io.arrow_convert import host_table_to_arrow
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import native as N
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.io import text_format as TF
from spark_rapids_tpu_torch.io.csv import render_csv
from spark_rapids_tpu_torch.session import TorchSession


def _u8(b: bytes) -> np.ndarray:
    return np.frombuffer(b, dtype=np.uint8)


def _as_reference(t) -> JHostTable:
    names, types, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, v)
        for ty, (d, v) in zip(types, arrays)])


# -- the tokenizer ------------------------------------------------------------------

def _arrow_rows(text: bytes, ncols: int, **parse):
    """pyarrow's records as (good rows' texts, bad rows' raw texts)."""
    bad = []

    def handler(row):
        bad.append(row.text)
        return "skip"
    names = [f"c{j}" for j in range(ncols)]
    t = pcsv.read_csv(
        io.BytesIO(text),
        read_options=pcsv.ReadOptions(column_names=names),
        parse_options=pcsv.ParseOptions(invalid_row_handler=handler, **parse),
        convert_options=pcsv.ConvertOptions(
            column_types={n: pa.string() for n in names}, null_values=[],
            strings_can_be_null=False))
    return [tuple(r.values()) for r in t.to_pylist()], bad


def _port_rows(text: bytes, ncols: int, delimiter=",", quote_char='"',
               escape_char=None, double_quote=True):
    rec = TF.tokenize(_u8(text), delimiter, quote_char or None,
                      escape_char or None, double_quote)
    good, bad = [], []
    for r in range(rec.num_rows):
        fields = rec.row_texts(r)
        if len(fields) == ncols:
            good.append(tuple(fields))
        else:
            bad.append(rec.raw_text(r))
    return good, bad


@pytest.mark.parametrize("text,ncols,parse", [
    (b'a,b\n"x""y",1\n"p,q",2\n', 2, {}),
    (b'"a\nb",1\r\n2,3\r4,5', 2, {}),
    (b'a,1\n\n\n,\n"",""\n', 2, {}),
    (b'"ab" ,1\n "ab",2\nq"r,3\n"unclosed,4\n', 2, {}),
    (b'a,1,2\nb\nc,3\n   \nlast,9', 2, {}),
    (b'a\\,b,1\n"c\\"d",2\nx\\\ny,3\n', 2,
     {"escape_char": "\\", "double_quote": False}),
    (b"a\x01b\nc\\\nd\x01e\n", 2,
     {"delimiter": "\x01", "quote_char": False, "escape_char": "\\"}),
    (b"x;'y;z'\n'q''r';s\n", 2, {"delimiter": ";", "quote_char": "'"}),
    (b"trailing,\n,lead\n", 2, {}),
], ids=["doubled quotes", "newline in quotes crlf cr", "empty fields",
        "quote positions", "ragged", "escapes", "hive layout",
        "custom quote", "edge delimiters"])
def test_tokenizer_matches_arrow(text, ncols, parse):
    assert _port_rows(text, ncols, **parse) == _arrow_rows(text, ncols,
                                                           **parse)


def test_comment_filter_matches_the_reference(tmp_path):
    from spark_rapids_tpu.conf import RapidsConf as JConf
    from spark_rapids_tpu.io.csv import CsvScanNode as JCsv
    text = b"#c\na,b\n  #x\n1,2\n\t# y\n#\n3,4\n#last"
    p = str(tmp_path / "c.csv")
    with open(p, "wb") as f:
        f.write(text)
    want = JCsv([p], JConf({}), comment="#")._load_bytes(p)
    assert TF.filter_comment_lines(_u8(text), "#").tobytes() == want


@pytest.mark.parametrize("lines", [
    b'{"a": 1}\nnot json\n{"a": NaN}\n\n  {"a": 3}  \r\n[1, 2]\r{"a": -Infinity}',
    b'{"a": "\\u00e9"}\n{"a": 01}\n{"a": 1.}\n"str"\n{"a": 1e400}\n{"a": tru}',
])
@pytest.mark.parametrize("mode", ["PERMISSIVE", "DROPMALFORMED"])
def test_json_normalisation_matches_the_reference(tmp_path, lines, mode):
    from spark_rapids_tpu.conf import RapidsConf as JConf
    from spark_rapids_tpu.io.json import JsonScanNode as JJson
    p = str(tmp_path / "n.json")
    with open(p, "wb") as f:
        f.write(lines)
    want = JJson([p], JConf({}), mode=mode)._normalized_lines(p)
    assert TF.json_normalize(_u8(lines), mode == "PERMISSIVE").tobytes() \
        == want


# -- inference and typed parsers ------------------------------------------------------

_KIND_OF_ARROW = {"int64": "int64", "double": "double", "bool": "bool",
                  "date32[day]": "date32", "time32[s]": "time",
                  "timestamp[s]": "ts_s", "timestamp[ns]": "ts_ns",
                  "timestamp[s, tz=UTC]": "ts_s_utc",
                  "timestamp[ns, tz=UTC]": "ts_ns_utc", "string": "string",
                  "null": "null"}


@pytest.mark.parametrize("values", [
    ["1", "-2", "0x1F"], ["1", "2.5"], ["true", "0"], ["2020-01-02"],
    ["12:34:56"], ["2020-01-02 03:04:05", "2020-01-02"],
    ["2020-01-02 03:04:05.5"], ["2020-01-02T03:04:05Z"],
    ["2020-01-02T03:04:05.123456789+05:30"], ["x", "1"], ["", ""],
    ["9223372036854775808"], ["-9223372036854775809"], ["1e-400", "inf"],
    ["2020-13-01"], ["1_000"], ["-0x10"],
], ids=lambda v: "|".join(v))
def test_inference_kind_matches_arrow(values):
    text = ("x,i\n" + "".join(f"{v},{k}\n" for k, v in enumerate(values))
            ).encode()
    want = pcsv.read_csv(io.BytesIO(text), convert_options=pcsv.ConvertOptions(
        null_values=[""], strings_can_be_null=True,
        quoted_strings_can_be_null=False)).schema.field("x").type
    rec = TF.tokenize(_u8(text), ",", '"', None, True)
    idx = rec.row_first[1:-1].astype(np.int64)
    got = TF.infer_csv_column(rec.spans, idx, [""])
    assert got.kind == _KIND_OF_ARROW[str(want)]


def _explicit(values, arrow_type):
    """pyarrow's conversion of each value alone: the value, or None when
    it raises."""
    out = []
    for v in values:
        try:
            t = pcsv.read_csv(io.BytesIO(b"x\n" + v.encode() + b"\n"),
                              convert_options=pcsv.ConvertOptions(
                                  column_types={"x": arrow_type},
                                  null_values=[],
                                  strings_can_be_null=False))
            # an empty value is an empty line, which Arrow skips
            out.append(t.column(0)[0].as_py() if t.num_rows else None)
        except pa.ArrowInvalid:
            out.append(None)
    return out


def _parsed(values, kind, arg=0):
    spans = TF.Spans(*TF.utf8_texts(np.array(values, dtype=object),
                                    np.ones(len(values), dtype=bool)))
    return TF.parse(spans, np.arange(len(values)), kind, arg)


def test_integer_parser_edges():
    values = ["9223372036854775807", "-9223372036854775808",
              "9223372036854775808", "-9223372036854775809", "0x7FFFFFFFFFFF"
              "FFFF", "0x8000000000000000", " 42\t", "+1", "-", "", "1 2",
              "00012", "0X1f", "-0x1"]
    vals, st = _parsed(values, TF.K_INT, 8)
    want = _explicit(values, pa.int64())
    assert [int(v) if s else None for v, s in zip(vals, st)] == want


@pytest.mark.parametrize("kind,arrow_type,fmt", [
    (TF.K_F64, pa.float64(), "<d"), (TF.K_F32, pa.float32(), "<f")])
def test_float_parser_edges_bit_for_bit(kind, arrow_type, fmt):
    values = ["4.9e-324", "2.2250738585072011e-308", "-0.0", "0.1",
              "1.7976931348623157e308", "1.7976931348623159e308", "1e400",
              "1e-400", "1.", ".5", "+.5e-3", "nan", "-Inf", "infinity",
              "1e", "1.5f", "0x10", " 7 ", "1.401298464324817e-45",
              "3.4028235677973366e+38", "0.30000000000000004",
              "123456789012345678901234567890"]
    vals, st = _parsed(values, kind)
    want = _explicit(values, arrow_type)
    for v, s, w, text in zip(vals, st, want, values):
        if w is None:
            assert not s, text
        elif math.isnan(w):
            assert s and math.isnan(v), text
        else:
            assert s and struct.pack(fmt, v) == struct.pack(fmt, w), text


def test_timestamp_parser_forms():
    values = ["2020-01-02", "2020-01-02T03", "2020-01-02 03:04",
              "2020-01-02T03:04:05", "2020-01-02 03:04:05.5",
              "2020-01-02T03:04:05.123456", "2020-01-02T03:04:05Z",
              "2020-01-02T03:04:05.25+01:00", "2020-01-02T03:04:05-0130",
              "1969-12-31T23:59:59.999999", "2020-02-30", "2020-01-02X03",
              "2020-01-02 24:00:00", " 2020-01-02"]
    vals, st = _parsed(values, TF.K_TS)
    naive = _explicit(values, pa.timestamp("us"))
    zoned = _explicit(values, pa.timestamp("us", tz="UTC"))
    for v, s, a, b, text in zip(vals, st, naive, zoned, values):
        w = a if a is not None else b
        if w is None:
            assert not s & TF.TS_OK, text
            continue
        assert s & TF.TS_OK, text
        assert bool(s & TF.TS_ZONE) == (a is None), text
        epoch = (w.replace(tzinfo=None) - __import__("datetime").datetime(
            1970, 1, 1))
        micros = (epoch.days * 86400 + epoch.seconds) * 10**6 + \
            epoch.microseconds
        assert v == micros, text


def test_date_and_bool_parsers():
    dates = ["2020-02-29", "2019-02-29", "0001-01-01", "9999-12-31",
             " 2020-01-02 ", "2020-1-02", "20200102"]
    vals, st = _parsed(dates, TF.K_DATE)
    want = _explicit(dates, pa.date32())
    import datetime
    assert [(datetime.date(1970, 1, 1) + datetime.timedelta(int(v)))
            if s else None for v, s in zip(vals, st)] == want
    bools = ["1", "0", "True", "TRUE", "true", "False", "FALSE", "false",
             "t", "tRue", " true", "yes"]
    vals, st = _parsed(bools, TF.K_BOOL)
    assert [bool(v) if s else None for v, s in zip(vals, st)] == \
        _explicit(bools, pa.bool_())


# -- formatters ----------------------------------------------------------------------

def _special_doubles(n, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**63, n, dtype=np.int64).view(np.float64)
    return np.concatenate([bits, rng.standard_normal(n) * 10.0 **
                           rng.integers(-12, 25, n),
                           np.round(rng.standard_normal(n) * 1e6),
                           [0.0, -0.0, 1.0, 17.0, 1e9, 1e10, 1e-6, 1e-7,
                            1e15, 1e16, 1e21, 5e-324, np.inf, -np.inf,
                            np.nan, 0.1, 1 / 3, 123456789.0]])


def test_double_text_matches_arrow_and_python():
    v = _special_doubles(3000, 0)
    buf, off = TF._fmt(TF._lib().srt_fmt_f64, v, 32, 0)
    got = [bytes(buf[off[i]:off[i + 1]]).decode() for i in range(len(v))]
    assert got == pa.array(v).cast(pa.string()).to_pylist()
    for style, want in ((1, [repr(float(x)) for x in v]),
                        (2, [json.dumps(float(x)) for x in v])):
        buf, off = TF._fmt(TF._lib().srt_fmt_f64, v, 32, style)
        assert [bytes(buf[off[i]:off[i + 1]]).decode()
                for i in range(len(v))] == want


def test_float_text_matches_arrow():
    with np.errstate(over="ignore"):
        v = _special_doubles(2000, 1).astype(np.float32)
    buf, off = TF._fmt(TF._lib().srt_fmt_f32, v, 32)
    got = [bytes(buf[off[i]:off[i + 1]]).decode() for i in range(len(v))]
    assert got == pa.array(v).cast(pa.string()).to_pylist()


def test_json_string_escapes_match_json_dumps():
    values = ["plain", "q\"b\\s/", "\n\r\t\b\f\x00\x1f\x7f", "é", "😀",
              "中文", "\u2028", ""]
    data, off = TF.utf8_texts(np.array(values, dtype=object),
                              np.ones(len(values), dtype=bool))
    buf, o = TF.escape(data, off, TF.ESC_JSON)
    assert [bytes(buf[o[i]:o[i + 1]]).decode() for i in range(len(values))] \
        == [json.dumps(v) for v in values]


def test_json_scanner_reads_strings_as_json_loads():
    values = ["a\"b", "\\", "é😀", "\ud7ff\ue000", "tab\there", "x" * 300]
    text = "".join(json.dumps({"s": v, "n": i}) + "\n"
                   for i, v in enumerate(values)).encode()
    rows = TF.json_scan(_u8(text))
    assert rows.keys == ["s", "n"] and rows.num_rows == len(values)
    kinds, vidx = rows.column(0)
    assert list(rows.spans.texts(vidx)) == values


# -- the property -----------------------------------------------------------------------

_TEXT = st.text(alphabet=st.sampled_from(list('ab,"\n\r é;\'x1 ')),
                max_size=8)


@st.composite
def _tables(draw):
    n = draw(st.integers(1, 12))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))

    def valid():
        return rng.random(n) > 0.25
    strs = [draw(_TEXT) for _ in range(n)]
    cols = {
        "k": HostColumn(T.INT, np.arange(n, dtype=np.int32)),
        "l": HostColumn(T.LONG, rng.integers(-2**62, 2**62, n), valid()),
        "d": HostColumn(T.DOUBLE, _special_doubles(n, draw(
            st.integers(0, 99)))[rng.integers(0, 3 * n + 18, n)], valid()),
        "f": HostColumn(T.FLOAT, rng.standard_normal(n).astype(np.float32)
                        * np.float32(10.0) ** rng.integers(-30, 30, n)
                        .astype(np.float32), valid()),
        "b": HostColumn(T.BOOLEAN, rng.random(n) < 0.5, valid()),
        "s": HostColumn(T.STRING, np.array(strs, dtype=object), valid()),
        "dt": HostColumn(T.DATE, rng.integers(-25000, 30000, n)
                         .astype(np.int32), valid()),
        "m": HostColumn(T.DecimalType(12, 3), rng.integers(
            -10**11, 10**11, n), valid()),
    }
    for c in cols.values():
        if isinstance(c.dtype, T.STRING.__class__):
            c.data = np.where(c.validity, c.data, None)
    return HostTable(list(cols), list(cols.values()))


_SCHEMA = [("k", "int"), ("l", "bigint"), ("d", "double"), ("f", "float"),
           ("b", "boolean"), ("s", "string"), ("dt", "date"),
           ("m", "decimal(12,3)")]


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture,
                                 HealthCheck.too_slow])
@given(table=_tables())
def test_written_tables_read_back_equal_by_both_readers(tmp_path, table):
    """The port's CSV bytes are pyarrow's writer's bytes, and both readers
    read the file back as the table (bitwise, NaN payloads aside: a NaN
    reads back as the parser's NaN)."""
    data = render_csv(table)
    buf = io.BytesIO()
    pcsv.write_csv(host_table_to_arrow(_as_reference(table)), buf)
    assert data == buf.getvalue()
    p = str(tmp_path / "prop.csv")
    with open(p, "wb") as f:
        f.write(data)
    want = _as_reference(table)
    for c in want.columns:
        if c.data.dtype.kind == "f":
            c.data = np.where(np.isnan(c.data), np.nan, c.data).astype(
                c.data.dtype)
    port = TorchSession(device="cpu").read_csv(
        p, schema=[(n, T.parse_type(t)) for n, t in _SCHEMA])
    ref = TpuSession().read_csv(
        p, schema=[(n, JT.parse_type(t)) for n, t in _SCHEMA])
    assert tables_differ(_as_reference(port.collect_table()), want) is None
    assert tables_differ(ref.collect_table(), want) is None


# -- the build --------------------------------------------------------------------------

def test_build_without_a_compiler_raises_with_its_message(tmp_path,
                                                          monkeypatch):
    """A failed build raises with the compiler's output; the codec never
    falls back to a Python parser."""
    fake = tmp_path / "cxx"
    fake.write_text("#!/bin/sh\necho 'no compiler on this host' >&2\n"
                    "exit 1\n")
    os.chmod(fake, 0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(N, "_LIBS", {})
    with pytest.raises(RuntimeError, match="no compiler on this host"):
        N.build(["text_host"])
    with pytest.raises(RuntimeError, match="no compiler on this host"):
        TF.tokenize(_u8(b"a,b\n"), ",", '"', None, True)
    monkeypatch.setenv("CXX", "")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        N.build(["text_host"])


@pytest.mark.parametrize("values", [
    ["b", "a", None, "b", "", "é", None, "a"], [None, None], ["x"],
    ["", "", None]], ids=["mixed", "all null", "one", "empty strings"])
def test_strings_land_as_the_encoders_sorted_dictionary(values):
    """A string column's seeded (codes, dictionary) equals what
    ``encode_sorted_dict`` gives for its rows (nulls read as "")."""
    from spark_rapids_tpu_torch.columnar.column import encode_sorted_dict
    valid = np.array([v is not None for v in values])
    data, off = TF.utf8_texts(np.array(values, dtype=object), valid)
    col = TF.string_column(TF.Spans(data, off), np.arange(len(values)),
                           valid)
    codes, dictionary = col._cache["encode"]
    want_codes, want_dict = encode_sorted_dict(
        np.asarray(np.where(valid, np.array(values, dtype=object), ""),
                   dtype=object))
    assert codes.tolist() == want_codes.tolist()
    assert list(dictionary) == list(want_dict)
    assert [v if ok else None for v, ok in zip(col.data, col.validity)] \
        == values
