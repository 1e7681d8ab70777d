"""The port's text codec: what the reference takes from ``pyarrow.csv`` and
``pyarrow.json``, plus its Arrow-to-Spark conversion
(``spark_rapids_tpu/io/arrow_convert.py``: ``arrow_type_to_spark``,
``decode_to_schema``), with no pyarrow and no pandas.

Records are tokenized, fields parsed and values formatted in C++
(``native/text_host.cpp``); this module drives it over numpy buffers:

- ``tokenize`` splits delimited text into records and fields as Arrow's
  CSV parser does (quotes, doubled quotes, escapes, CRLF, empty lines
  skipped, ragged rows kept with their field counts);
- ``infer_csv_column`` / ``infer_json_column`` give a column's Arrow kind
  by Arrow's rules (CSV: null, int64, bool, double, date32, time,
  timestamp[s], timestamp[ns] and their UTC forms, string, over the whole
  file; JSON: int64 widening to double, bool, timestamp[s] for ISO
  strings without a fraction, string, null);
- ``cast_to`` is the multi-file *safe* cast of a later file's column to
  the scan's type (Arrow's ``cast(safe=True)``: int64 to double raises
  past 2^53, double to int64 raises on a fraction);
- ``parse_typed`` / ``json_typed`` convert to a user schema's types as
  pyarrow's explicit column types do (a value that does not convert
  raises ``TextParseError``, pyarrow's ``ArrowInvalid``);
- ``format_column`` and ``assemble`` render the writers' text: Arrow's
  CSV writer, ``json.dumps`` and Hive's ``_hive_cell``.

String columns land as one sorted dictionary with ``encoded()`` seeded
(``io/parquet_format.py::_string_column``), from the distinct field
texts: no per-value Python loop over a column.
"""

from __future__ import annotations

import datetime
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch import native as N
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn
from spark_rapids_tpu_torch.columnar.column import dec128_limbs, dec128_unscaled
from spark_rapids_tpu_torch.io.parquet_format import _string_column

NESTED_TODO = ("nested types are not ported to spark_rapids_tpu_torch yet "
               "(ROADMAP Queue 1 item [9])")


class TextParseError(ValueError):
    """A record or value the codec cannot read where pyarrow raises
    ``ArrowInvalid`` (a ragged row in FAILFAST, a value that does not
    convert to its column's type, malformed JSON)."""


def _lib():
    return N.load("text_host")


def _p(a: np.ndarray) -> int:
    return a.ctypes.data


def one_byte(ch: Optional[str], what: str) -> int:
    """An option's single character as a byte (-1 for none)."""
    if ch is None or ch == "" or ch is False:
        return -1
    b = ch.encode("utf-8")
    if len(b) != 1:
        raise NotImplementedError(
            f"{what} {ch!r}: the port's text codec takes a one-byte "
            "(ASCII) character")
    return b[0]


def read_bytes(path: str) -> np.ndarray:
    """A text file's bytes; a leading UTF-8 byte-order mark is not data
    (Arrow's CSV and JSON readers skip it)."""
    data = np.fromfile(path, dtype=np.uint8)
    if data[:3].tobytes() == b"\xef\xbb\xbf":
        data = data[3:]
    return data


# -- spans ---------------------------------------------------------------------

class Spans:
    """Texts ``buf[off[k]:off[k + 1]]``, each maybe flagged as quoted."""

    __slots__ = ("buf", "off", "quoted")

    def __init__(self, buf: np.ndarray, off: np.ndarray,
                 quoted: Optional[np.ndarray] = None):
        self.buf = buf if len(buf) else np.zeros(1, dtype=np.uint8)
        self.off = off
        self.quoted = quoted

    def text(self, k: int) -> str:
        return bytes(self.buf[self.off[k]:self.off[k + 1]]).decode(
            "utf-8", "replace")

    def texts(self, idx: np.ndarray) -> np.ndarray:
        """The spans ``idx`` as an object array of str."""
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        data, off = gather(self, idx)
        return N.strings_from(data, off)


def gather(spans: Spans, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Spans ``idx`` copied contiguously: (data, offsets[len(idx) + 1])."""
    return N.gather_spans(spans.buf, spans.off, idx)


def null_mask(spans: Spans, idx: np.ndarray,
              nulls: Sequence[str]) -> np.ndarray:
    """Which spans ``idx`` are null: unquoted and spelled as one of
    ``nulls`` (Arrow's null_values, quoted_strings_can_be_null=False)."""
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    enc = [s.encode("utf-8") for s in nulls]
    packed = np.frombuffer(b"".join(enc) or b"\0", dtype=np.uint8)
    noff = np.concatenate([[0], np.cumsum([len(e) for e in enc])]).astype(
        np.int64)
    out = np.empty(len(idx), dtype=np.uint8)
    quoted = spans.quoted
    _lib().srt_null_mask(_p(spans.buf), _p(spans.off),
                         _p(quoted) if quoted is not None else 0, _p(idx),
                         len(idx), _p(packed), _p(noff), len(enc), _p(out))
    return out.view(np.bool_)


#: srt_parse kinds
K_INT, K_F64, K_F32, K_BOOL, K_DATE, K_TS, K_DECIMAL = range(1, 8)
#: srt_parse's timestamp status bits
TS_OK, TS_ZONE, TS_FRAC, TS_SUBMICRO = 1, 2, 4, 8
_PARSE_DTYPES = {K_INT: np.int64, K_F64: np.float64, K_F32: np.float32,
                 K_BOOL: np.uint8, K_DATE: np.int32, K_TS: np.int64}


def parse(spans: Spans, idx: np.ndarray, kind: int, arg: int = 0
          ) -> Tuple[np.ndarray, np.ndarray]:
    """(values, status) of spans ``idx`` parsed as ``kind`` (status 0:
    does not parse); decimals come as (n, 2) int64 (hi, lo) limbs."""
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    n = len(idx)
    if kind == K_DECIMAL:
        out = np.zeros((n, 2), dtype=np.int64)
    else:
        out = np.zeros(n, dtype=_PARSE_DTYPES[kind])
    status = np.zeros(n, dtype=np.uint8)
    _lib().srt_parse(_p(spans.buf), _p(spans.off), _p(idx), n, kind, arg,
                     _p(out), _p(status))
    return out, status


def parse_strptime(spans: Spans, idx: np.ndarray, fmt: str
                   ) -> Tuple[np.ndarray, np.ndarray]:
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    f = np.frombuffer(fmt.encode("utf-8") or b"\0", dtype=np.uint8)
    out = np.zeros(len(idx), dtype=np.int64)
    status = np.zeros(len(idx), dtype=np.uint8)
    _lib().srt_parse_strptime(_p(spans.buf), _p(spans.off), _p(idx),
                              len(idx), _p(f), len(fmt.encode("utf-8")),
                              _p(out), _p(status))
    return out, status


def string_column(spans: Spans, idx: np.ndarray, valid: np.ndarray,
                  strip: Optional[str] = None) -> HostColumn:
    """A STRING column from spans ``idx`` (one a row; invalid rows are
    null), as one sorted dictionary with ``encoded()`` seeded. The
    distinct texts are found in C++ and decoded once each; ``strip``
    ('l', 'r' or 'lr') strips whitespace off each value as Python's
    ``str.lstrip`` / ``rstrip`` do."""
    vidx = np.ascontiguousarray(np.asarray(idx)[valid], dtype=np.int64)
    codes, first = N.span_dedup(spans.buf, spans.off, vidx)
    k = len(first)
    table = spans.texts(vidx[first]) if k else np.empty(0, dtype=object)
    if strip and k:
        fn = {"l": str.lstrip, "r": str.rstrip, "lr": str.strip}[strip]
        table = np.array([fn(s) for s in table] + [None],
                         dtype=object)[:-1]
    return _string_column(np.ascontiguousarray(valid, dtype=np.bool_),
                          table, codes)


# -- CSV records ---------------------------------------------------------------

def filter_comment_lines(data: np.ndarray, comment: str) -> np.ndarray:
    """The reference's line-based comment pre-filter: lines (split on \\n)
    whose left-stripped bytes start with ``comment`` are dropped."""
    cm = np.frombuffer(comment.encode("utf-8"), dtype=np.uint8)
    out = np.empty(max(len(data), 1), dtype=np.uint8)
    n = _lib().srt_filter_comment_lines(_p(data) if len(data) else _p(out),
                                        len(data), _p(cm), len(cm), _p(out))
    return out[:n]


class Records:
    """Tokenized delimited text: row r's fields are spans
    ``row_first[r] .. row_first[r + 1] - 1`` of ``spans``; its raw text is
    ``data[row_raw[2r]:row_raw[2r + 1]]``."""

    __slots__ = ("spans", "row_first", "row_raw", "data")

    def __init__(self, spans, row_first, row_raw, data):
        self.spans = spans
        self.row_first = row_first
        self.row_raw = row_raw
        self.data = data

    @property
    def num_rows(self) -> int:
        return len(self.row_first) - 1

    def counts(self) -> np.ndarray:
        return np.diff(self.row_first)

    def raw_text(self, r: int) -> str:
        a, b = self.row_raw[2 * r], self.row_raw[2 * r + 1]
        return bytes(self.data[a:b]).decode("utf-8", "replace")

    def row_texts(self, r: int) -> List[str]:
        return [self.spans.text(k) for k in
                range(self.row_first[r], self.row_first[r + 1])]


def tokenize(data: np.ndarray, delimiter: str, quote: Optional[str],
             escape: Optional[str], double_quote: bool) -> Records:
    """Records and fields of delimited text (Arrow's CSV parser)."""
    d = one_byte(delimiter, "CSV sep")
    q = one_byte(quote, "CSV quote")
    e = one_byte(escape, "CSV escape")
    nl = int(np.count_nonzero(data == 10))
    cr = int(np.count_nonzero(data == 13))
    cap_r = nl + cr + 2
    cap_f = int(np.count_nonzero(data == d)) + nl + cr + 2
    out = np.empty(max(len(data), 1), dtype=np.uint8)
    field_off = np.empty(cap_f + 1, dtype=np.int64)
    quoted = np.empty(cap_f, dtype=np.uint8)
    row_first = np.empty(cap_r + 1, dtype=np.int64)
    row_raw = np.empty(2 * cap_r, dtype=np.int64)
    nf = np.zeros(1, dtype=np.int64)
    src = data if len(data) else out
    nr = _lib().srt_csv_tokenize(_p(src), len(data), d, q, e,
                                 int(bool(double_quote)), _p(out),
                                 _p(field_off), _p(quoted), cap_f,
                                 _p(row_first), _p(row_raw), cap_r, _p(nf))
    if nr < 0:
        raise RuntimeError("CSV tokenizer capacity exceeded")
    k = int(nf[0])
    return Records(Spans(out, field_off[:k + 1], quoted[:k]),
                   row_first[:nr + 1], row_raw[:2 * nr], data)


# -- columns as read (Arrow kinds) --------------------------------------------

_CSV_KINDS = ("null", "int64", "bool", "double", "date32", "time", "ts_s",
              "ts_ns", "ts_s_utc", "ts_ns_utc", "string")
_TS_KINDS = ("ts_s", "ts_ns", "ts_s_utc", "ts_ns_utc")
_ARROW_NAMES = {"null": "null", "int64": "int64", "bool": "bool",
                "double": "double", "date32": "date32[day]",
                "time": "time32[s]", "ts_s": "timestamp[s]",
                "ts_ns": "timestamp[ns]", "ts_s_utc": "timestamp[s, tz=UTC]",
                "ts_ns_utc": "timestamp[ns, tz=UTC]", "string": "string"}


class TextColumn:
    """One column of a file as read, before the scan's schema applies: its
    Arrow kind, its values (zero at nulls) and validity; a string column
    keeps its spans (``idx`` one a row) until it is converted."""

    __slots__ = ("kind", "values", "valid", "spans", "idx", "flags")

    def __init__(self, kind, values, valid, spans=None, idx=None,
                 flags=None):
        self.kind = kind
        self.values = values
        self.valid = valid
        self.spans = spans
        self.idx = idx
        self.flags = flags

    def __len__(self) -> int:
        return len(self.valid)


def kind_to_spark(kind: str) -> T.DataType:
    """The reference's ``arrow_type_to_spark`` of an inferred kind."""
    got = {"null": T.NULL, "int64": T.LONG, "bool": T.BOOLEAN,
           "double": T.DOUBLE, "date32": T.DATE,
           "string": T.STRING}.get(kind)
    if got is not None:
        return got
    if kind in _TS_KINDS:
        return T.TIMESTAMP
    from spark_rapids_tpu_torch.errors import ColumnarProcessingError
    raise ColumnarProcessingError(
        f"unsupported Arrow type {_ARROW_NAMES.get(kind, kind)}")


def _scatter(n: int, valid: np.ndarray, vals: np.ndarray) -> np.ndarray:
    out = np.zeros(n, dtype=vals.dtype)
    out[valid] = vals
    return out


def _parsed_kind(kind: str, spans: Spans, idx: np.ndarray,
                 valid: np.ndarray) -> TextColumn:
    """A column of a known kind whose valid spans all parse as it."""
    n = len(idx)
    vidx = idx[valid]
    if kind in ("null", "string", "time"):
        return TextColumn(kind, None, valid, spans, idx)
    pk = {"int64": (K_INT, 8), "bool": (K_BOOL, 0), "double": (K_F64, 0),
          "date32": (K_DATE, 0)}.get(kind, (K_TS, 0))
    vals, status = parse(spans, vidx, *pk)
    flags = None
    if kind in _TS_KINDS:
        flags = _scatter(n, valid, status)
    if kind == "bool":
        vals = vals.view(np.bool_)
    return TextColumn(kind, _scatter(n, valid, vals), valid, spans, idx,
                      flags)


def infer_csv_column(spans: Spans, idx: np.ndarray,
                     nulls: Sequence[str]) -> TextColumn:
    """A CSV column by Arrow's inference over every row of the file."""
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    valid = ~null_mask(spans, idx, nulls)
    vidx = np.ascontiguousarray(idx[valid])
    k = _lib().srt_csv_infer(_p(spans.buf), _p(spans.off), _p(vidx),
                             len(vidx))
    return _parsed_kind(_CSV_KINDS[k], spans, idx, valid)


# -- conversion to the scan's types ---------------------------------------------

def _arrow_name(dt: T.DataType) -> str:
    if isinstance(dt, T.DecimalType):
        return f"decimal128({dt.precision}, {dt.scale})"
    return {T.BooleanType: "bool", T.ByteType: "int8", T.ShortType: "int16",
            T.IntegerType: "int32", T.LongType: "int64",
            T.FloatType: "float", T.DoubleType: "double",
            T.StringType: "string", T.DateType: "date32[day]",
            T.TimestampType: "timestamp[us]",
            T.NullType: "null"}.get(type(dt), str(dt))


_INT_WIDTH = {T.ByteType: 1, T.ShortType: 2, T.IntegerType: 4, T.LongType: 8}


def null_column(dt: T.DataType, n: int) -> HostColumn:
    """An all-null column (the reference's ``arrow_array_to_host_column``
    of a null array)."""
    if isinstance(dt, T.NullType):
        return HostColumn(dt, np.zeros(n, dtype=np.int8),
                          np.zeros(n, dtype=np.bool_))
    valid = np.zeros(n, dtype=np.bool_)
    if isinstance(dt, T.StringType):
        col = HostColumn(dt, np.full(n, None, dtype=object), valid)
        col._cache["encode"] = (np.zeros(n, dtype=np.int32),
                                np.array([""] if n else [], dtype=object))
        return col
    if T.is_dec128(dt):
        data = np.empty(n, dtype=object)
        data[:] = 0
        return HostColumn(dt, data, valid)
    if T.is_nested(dt):
        raise NotImplementedError(f"a {dt} column: {NESTED_TODO}")
    return HostColumn(dt, np.zeros(n, dtype=dt.np_dtype), valid)


def _decimal_column(dt: T.DecimalType, limbs: np.ndarray,
                    valid: np.ndarray) -> HostColumn:
    if T.is_dec128(dt):
        return HostColumn(dt, dec128_unscaled(limbs, valid), valid)
    return HostColumn(dt, np.where(valid, limbs[:, 1], 0).astype(np.int64),
                      valid)


def _fail(what: str, dt, text: str):
    raise TextParseError(
        f"{what}: conversion error to {_arrow_name(dt)}: invalid value "
        f"{text!r}")


def parse_typed(spans: Spans, idx: np.ndarray, valid: np.ndarray,
                dt: T.DataType, what: str,
                ts_format: Optional[str] = None,
                ts_zone: str = "forbid") -> HostColumn:
    """Valid spans ``idx`` converted to ``dt`` as pyarrow's explicit column
    types convert them; a value that does not convert raises
    ``TextParseError``. ``ts_zone`` is the timestamp parser's zone rule:
    'forbid' (a naive type: CSV), 'optional' (JSON)."""
    n = len(idx)
    vidx = np.ascontiguousarray(np.asarray(idx)[valid], dtype=np.int64)

    def check(status, ok=None):
        bad = np.flatnonzero(status == 0 if ok is None else ~ok)
        if len(bad):
            _fail(what, dt, spans.text(vidx[bad[0]]))

    if isinstance(dt, T.NullType):
        if len(vidx):
            _fail(what, dt, spans.text(vidx[0]))
        return null_column(dt, n)
    if isinstance(dt, T.StringType):
        return string_column(spans, idx, valid)
    if T.is_nested(dt):
        raise NotImplementedError(f"a {dt} column: {NESTED_TODO}")
    if type(dt) in _INT_WIDTH:
        vals, st = parse(spans, vidx, K_INT, _INT_WIDTH[type(dt)])
        check(st)
        return HostColumn(dt, _scatter(n, valid, vals.astype(dt.np_dtype)),
                          valid)
    if isinstance(dt, (T.FloatType, T.DoubleType)):
        k = K_F32 if isinstance(dt, T.FloatType) else K_F64
        vals, st = parse(spans, vidx, k)
        check(st)
        return HostColumn(dt, _scatter(n, valid, vals), valid)
    if isinstance(dt, T.BooleanType):
        vals, st = parse(spans, vidx, K_BOOL)
        check(st)
        return HostColumn(dt, _scatter(n, valid, vals.view(np.bool_)), valid)
    if isinstance(dt, T.DateType):
        vals, st = parse(spans, vidx, K_DATE)
        check(st)
        return HostColumn(dt, _scatter(n, valid, vals), valid)
    if isinstance(dt, T.TimestampType):
        if ts_format is not None:
            vals, st = parse_strptime(spans, vidx, ts_format)
            check(st)
        else:
            vals, st = parse(spans, vidx, K_TS)
            ok = (st & TS_OK).astype(bool) & ~(st & TS_SUBMICRO).astype(bool)
            if ts_zone == "forbid":
                ok &= ~(st & TS_ZONE).astype(bool)
            check(st, ok)
        return HostColumn(dt, _scatter(n, valid, vals), valid)
    if isinstance(dt, T.DecimalType):
        limbs, st = parse(spans, vidx, K_DECIMAL,
                          dt.scale | (dt.precision << 8))
        check(st)
        full = np.zeros((n, 2), dtype=np.int64)
        full[valid] = limbs
        return _decimal_column(dt, full, valid)
    raise NotImplementedError(f"reading a {dt} column from text")


def _family(dt: T.DataType) -> Optional[str]:
    """The inferred kind a Spark type needs no cast from."""
    if isinstance(dt, T.LongType):
        return "int64"
    if isinstance(dt, T.DoubleType):
        return "double"
    if isinstance(dt, T.BooleanType):
        return "bool"
    if isinstance(dt, T.DateType):
        return "date32"
    if isinstance(dt, T.StringType):
        return "string"
    return None


_MICROS_PER_DAY = 86_400_000_000


def _cast_error(kind: str, dt: T.DataType, detail: str):
    raise TextParseError(
        f"cannot cast {_ARROW_NAMES.get(kind, kind)} to {_arrow_name(dt)} "
        f"safely: {detail}")


def cast_to(col: TextColumn, dt: T.DataType) -> HostColumn:
    """``col`` in the scan's type ``dt``: the reference's
    ``decode_to_schema``, an Arrow safe cast from the inferred kind
    (lossy values raise ``TextParseError``; a null target drops the
    values)."""
    n, valid, kind = len(col), col.valid, col.kind
    if isinstance(dt, T.NullType):
        return null_column(dt, n)
    if kind == "null":
        return null_column(dt, n)
    if kind == "string":
        if isinstance(dt, T.StringType):
            return string_column(col.spans, col.idx, valid)
        return parse_typed(col.spans, col.idx, valid, dt,
                           "cast from string", ts_zone="optional")
    if kind == "time":
        raise NotImplementedError(
            f"casting a time column to {dt}: Spark has no time type")
    vals = col.values
    if _family(dt) == kind:
        return HostColumn(dt, vals, valid)
    if isinstance(dt, T.StringType):
        return _to_string(col)
    if kind in _TS_KINDS:
        if col.flags is not None and np.any(
                (col.flags & TS_SUBMICRO).astype(bool) & valid):
            _cast_error(kind, dt, "a value would lose its nanoseconds")
        if isinstance(dt, T.TimestampType):
            return HostColumn(dt, vals, valid)
        if isinstance(dt, T.DateType):
            # Arrow's timestamp -> date32 cast drops the time of day
            return HostColumn(dt, (vals // _MICROS_PER_DAY).astype(np.int32),
                              valid)
        if isinstance(dt, T.LongType):
            return HostColumn(dt, vals, valid)
    if kind == "date32" and isinstance(dt, T.TimestampType):
        return HostColumn(dt, vals.astype(np.int64) * _MICROS_PER_DAY, valid)
    if kind == "int64":
        if isinstance(dt, (T.DoubleType, T.FloatType)):
            lim = 1 << (53 if isinstance(dt, T.DoubleType) else 24)
            bad = valid & ((vals > lim) | (vals < -lim))
            if bad.any():
                _cast_error(kind, dt, f"integer value {vals[bad][0]} not in "
                            f"range: {-lim} to {lim}")
            return HostColumn(dt, vals.astype(dt.np_dtype), valid)
        if type(dt) in _INT_WIDTH:
            info = np.iinfo(dt.np_dtype)
            bad = valid & ((vals > info.max) | (vals < info.min))
            if bad.any():
                _cast_error(kind, dt, f"integer value {vals[bad][0]} not in "
                            "range")
            return HostColumn(dt, vals.astype(dt.np_dtype), valid)
        if isinstance(dt, T.BooleanType):
            return HostColumn(dt, vals != 0, valid)
    if kind == "double":
        if type(dt) in _INT_WIDTH:
            info = np.iinfo(dt.np_dtype)
            with np.errstate(invalid="ignore"):
                bad = valid & ((vals != np.trunc(vals))
                               | (vals > info.max) | (vals < info.min)
                               | np.isnan(vals))
            if bad.any():
                _cast_error(kind, dt, f"float value {vals[bad][0]} was "
                            "truncated")
            return HostColumn(dt, np.where(valid, vals, 0).astype(
                dt.np_dtype), valid)
        if isinstance(dt, T.FloatType):
            return HostColumn(dt, vals.astype(np.float32), valid)
        if isinstance(dt, T.BooleanType):
            return HostColumn(dt, vals != 0, valid)
    if kind == "bool" and (type(dt) in _INT_WIDTH
                           or isinstance(dt, (T.DoubleType, T.FloatType))):
        return HostColumn(dt, vals.astype(dt.np_dtype), valid)
    raise NotImplementedError(
        f"the safe cast of a {_ARROW_NAMES.get(kind, kind)} column to {dt} "
        "across files")


def _to_string(col: TextColumn) -> HostColumn:
    """Arrow's cast of an inferred column to string (its text form)."""
    kind, valid = col.kind, col.valid
    if kind == "int64":
        buf, off = _fmt(_lib().srt_fmt_i64, col.values, 20)
    elif kind == "double":
        buf, off = _fmt(_lib().srt_fmt_f64, col.values, 32, 0)
    elif kind == "bool":
        buf, off = _fmt(_lib().srt_fmt_bool, col.values.view(np.uint8), 5)
    elif kind == "date32":
        buf, off = _fmt(_lib().srt_fmt_date, col.values, 16)
    elif kind == "ts_s":
        buf, off = _fmt(_lib().srt_fmt_ts, col.values, 40, 2)
    else:
        raise NotImplementedError(
            f"the cast of a {_ARROW_NAMES.get(kind, kind)} column to string")
    spans = Spans(buf, off)
    return string_column(spans, np.arange(len(valid), dtype=np.int64), valid)


# -- JSON ------------------------------------------------------------------------

J_NULL, J_TRUE, J_FALSE, J_INT, J_FLOAT, J_STRING, J_OBJECT, J_ARRAY, \
    J_NONSTD = range(9)
J_ABSENT = 255
_JERR = {-1: "JSON parse error: invalid JSON",
         -2: "JSON parse error: a row is not a JSON object",
         -3: "JSON parse error: a column was specified twice in a row",
         -4: "JSON parse error: Number too big to be stored in double",
         -5: "JSON parse error: nesting too deep",
         -6: "JSON scanner capacity exceeded"}
_GROUP = {J_TRUE: "boolean", J_FALSE: "boolean", J_INT: "number",
          J_FLOAT: "number", J_NONSTD: "number", J_STRING: "string",
          J_OBJECT: "object", J_ARRAY: "array"}


class JsonRows:
    """The scanned members of a stream of JSON objects: member v is key
    ``keys[key[v]]`` of row ``row[v]``, of kind ``kind[v]`` (J_*), its
    text ``spans`` span v."""

    __slots__ = ("keys", "num_rows", "kind", "row", "key", "spans")

    def __init__(self, keys, num_rows, kind, row, key, spans):
        self.keys = keys
        self.num_rows = num_rows
        self.kind = kind
        self.row = row
        self.key = key
        self.spans = spans

    def column(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Key ``k``'s (kind, member index) a row (J_ABSENT where the row
        lacks it)."""
        sel = np.flatnonzero(self.key == k)
        kinds = np.full(self.num_rows, J_ABSENT, dtype=np.uint8)
        vidx = np.zeros(self.num_rows, dtype=np.int64)
        kinds[self.row[sel]] = self.kind[sel]
        vidx[self.row[sel]] = sel
        return kinds, vidx


def json_scan(data: np.ndarray, allow_nonstd: bool = True) -> JsonRows:
    """Scan a stream of JSON objects (Arrow's JSON reader's input: one
    object a row, whitespace between them); malformed text raises
    ``TextParseError``."""
    n = len(data)
    src = data if n else np.zeros(1, dtype=np.uint8)
    cap_v = int(np.count_nonzero(data == ord(":"))) + 1
    out = np.empty(max(n, 1), dtype=np.uint8)
    val_off = np.empty(cap_v + 1, dtype=np.int64)
    kind = np.empty(cap_v, dtype=np.uint8)
    row = np.empty(cap_v, dtype=np.int64)
    key = np.empty(cap_v, dtype=np.int32)
    keys = np.empty(max(n, 1), dtype=np.uint8)
    key_off = np.empty(cap_v + 1, dtype=np.int64)
    info = np.zeros(4, dtype=np.int64)
    rc = _lib().srt_json_scan(_p(src), n, int(allow_nonstd), _p(out),
                              _p(val_off), _p(kind), _p(row), _p(key), cap_v,
                              _p(keys), _p(key_off), cap_v, _p(info))
    if rc < 0:
        raise TextParseError(f"{_JERR.get(rc, 'JSON parse error')} in row "
                             f"{int(info[1])}")
    nv, nr, nk = (int(x) for x in info[:3])
    names = [bytes(keys[key_off[j]:key_off[j + 1]]).decode("utf-8")
             for j in range(nk)]
    return JsonRows(names, nr, kind[:nv], row[:nv], key[:nv],
                    Spans(out, val_off[:nv + 1]))


def json_normalize(data: np.ndarray, permissive: bool) -> np.ndarray:
    """The reference's line normalisation (``io/json.py::
    _normalized_lines``): a malformed line (NaN and Infinity included)
    becomes ``{}`` when ``permissive``, else is dropped."""
    out = np.empty(2 * len(data) + 2, dtype=np.uint8)
    src = data if len(data) else out
    k = _lib().srt_json_normalize(_p(src), len(data), int(permissive),
                                  _p(out))
    return out[:k]


def json_groups(name: str, kinds: np.ndarray) -> Optional[str]:
    """The one value group of a column's non-null members (None: all
    null); two groups raise as Arrow's "changed from" error."""
    present = kinds[(kinds != J_NULL) & (kinds != J_ABSENT)]
    if not len(present):
        return None
    groups = np.unique(np.array([_GROUP[k] for k in np.unique(present)]))
    if len(groups) > 1:
        first = _GROUP[int(present[0])]
        other = next(g for g in groups if g != first)
        raise TextParseError(
            f"JSON parse error: Column(/{name}) changed from {first} to "
            f"{other}")
    return str(groups[0])


def infer_json_column(rows: JsonRows, k: int) -> TextColumn:
    """A JSON column by Arrow's inference: numbers are int64 unless one is
    not an integer (or past int64), then double; strings are timestamp[s]
    when every one is an ISO timestamp without a fraction; object and
    array columns raise (nested types, ROADMAP [9])."""
    name = rows.keys[k]
    kinds, vidx = rows.column(k)
    group = json_groups(name, kinds)
    valid = (kinds != J_NULL) & (kinds != J_ABSENT)
    spans = rows.spans
    if group is None:
        return TextColumn("null", None, valid, spans, vidx)
    if group in ("object", "array"):
        raise NotImplementedError(
            f"JSON column {name!r} holds {group}s: {NESTED_TODO}")
    if group == "boolean":
        return TextColumn("bool", kinds == J_TRUE, valid, spans, vidx)
    if group == "string":
        vals, st = parse(spans, vidx[valid], K_TS)
        if len(st) and np.all((st & TS_OK).astype(bool)
                              & ~(st & TS_FRAC).astype(bool)):
            return TextColumn("ts_s", _scatter(len(valid), valid, vals),
                              valid, spans, vidx)
        return TextColumn("string", None, valid, spans, vidx)
    if np.all(kinds[valid] == J_INT):
        vals, st = parse(spans, vidx[valid], K_INT, 8)
        if np.all(st):
            return TextColumn("int64", _scatter(len(valid), valid, vals),
                              valid, spans, vidx)
    return _parsed_kind("double", spans, vidx, valid)


def json_typed(rows: JsonRows, k: Optional[int], dt: T.DataType,
               name: str) -> HostColumn:
    """Key ``k`` (None: absent from the file) converted to a user schema's
    ``dt`` as pyarrow's explicit JSON schema converts (numbers to the
    numeric types, booleans, strings to STRING and TIMESTAMP, strings or
    numbers to DECIMAL; DATE takes no JSON value)."""
    if k is None:
        return null_column(dt, rows.num_rows)
    kinds, vidx = rows.column(k)
    if isinstance(dt, T.DecimalType):
        # a decimal takes strings and numbers alike
        kinds = np.where((kinds == J_INT) | (kinds == J_FLOAT),
                         np.uint8(J_STRING), kinds)
    group = json_groups(name, kinds)
    valid = (kinds != J_NULL) & (kinds != J_ABSENT)
    if T.is_nested(dt) or group in ("object", "array"):
        raise NotImplementedError(f"JSON column {name!r}: {NESTED_TODO}")
    if group is None:
        return null_column(dt, rows.num_rows)
    want = ("number" if type(dt) in _INT_WIDTH or isinstance(
        dt, (T.FloatType, T.DoubleType, T.DateType)) else
        "boolean" if isinstance(dt, T.BooleanType) else "string")
    if group != want:
        raise TextParseError(
            f"JSON parse error: Column(/{name}) changed from {want} to "
            f"{group}")
    what = f"Failed to convert JSON column {name!r}"
    if isinstance(dt, T.BooleanType):
        return HostColumn(dt, kinds == J_TRUE, valid)
    if type(dt) in _INT_WIDTH:
        bad = valid & (kinds != J_INT)
        if bad.any():
            _fail(what, dt, rows.spans.text(vidx[np.flatnonzero(bad)[0]]))
    if isinstance(dt, T.DateType):
        _fail(what, dt, rows.spans.text(vidx[np.flatnonzero(valid)[0]]))
    return parse_typed(rows.spans, vidx, valid, dt, what,
                       ts_zone="optional")


# -- the reference's host helpers, copied ----------------------------------------

#: Spark datetime pattern tokens -> strptime (the reference's subset; any
#: other letter run raises, matched whole so MMMM cannot half-translate)
_PATTERN_TOKENS = {
    "yyyy": "%Y", "yy": "%y", "MM": "%m", "dd": "%d",
    "HH": "%H", "mm": "%M", "ss": "%S", "SSSSSS": "%f",
    "SSS": "%f", "a": "%p",
}


def spark_pattern_to_strptime(pattern: str) -> str:
    out = []
    for piece in re.split(r"([A-Za-z]+)", pattern):
        if piece and piece[0].isalpha():
            rep = _PATTERN_TOKENS.get(piece)
            if rep is None:
                raise ValueError(
                    f"datetime pattern {pattern!r}: token {piece!r} is "
                    "outside the supported subset "
                    f"({' '.join(_PATTERN_TOKENS)})")
            out.append(rep)
        else:
            out.append(piece)
    return "".join(out)


#: Java's trimAll strips every char <= U+0020
_JAVA_WS = "".join(chr(i) for i in range(0x21))
_INT_RE = re.compile(r"([+-]?)(\d*)(?:\.(\d*))?")
_DATE_RE = re.compile(r"(\d{4,5})(?:-(\d{1,2})(?:-(\d{1,2})(?:[T ].*)?)?)?")
_TRUE_STRINGS = frozenset(("t", "true", "y", "yes", "1"))
_FALSE_STRINGS = frozenset(("f", "false", "n", "no", "0"))
_FLOAT_SPECIALS = {"inf": np.inf, "+inf": np.inf, "infinity": np.inf,
                   "+infinity": np.inf, "-inf": -np.inf,
                   "-infinity": -np.inf, "nan": np.nan}


def parse_string_cast(s: str, dst: T.DataType):
    """Spark's string -> value parse (the host half of the reference's
    ``ops/cast.py::parse_string_cast``); None = the cast yields null."""
    t = s.strip(_JAVA_WS)
    if isinstance(dst, T.IntegralType):
        m = _INT_RE.fullmatch(t)
        if not m or (not m.group(2) and not m.group(3)):
            return None
        v = int(m.group(2) or "0")
        if m.group(1) == "-":
            v = -v
        info = np.iinfo(dst.np_dtype)
        return v if info.min <= v <= info.max else None
    if isinstance(dst, (T.FloatType, T.DoubleType)):
        low = t.lower()
        if low in _FLOAT_SPECIALS:
            v = _FLOAT_SPECIALS[low]
        else:
            body = t
            if body and body[-1] in "fFdD" and any(
                    c.isdigit() for c in body[:-1]):
                body = body[:-1]
            if not body or "_" in body or body.lower() in ("", "+", "-"):
                return None
            try:
                v = float(body)
            except ValueError:
                return None
        if isinstance(dst, T.FloatType):
            v = float(np.float32(v))
        return v
    if isinstance(dst, T.BooleanType):
        low = t.lower()
        if low in _TRUE_STRINGS:
            return True
        if low in _FALSE_STRINGS:
            return False
        return None
    if isinstance(dst, T.DateType):
        m = _DATE_RE.fullmatch(t)
        if not m:
            return None
        y = int(m.group(1))
        mo = int(m.group(2)) if m.group(2) else 1
        d = int(m.group(3)) if m.group(3) else 1
        try:
            return (datetime.date(y, mo, d) - datetime.date(1970, 1, 1)).days
        except ValueError:
            return None
    return None


def column_from_values(values: list, dt: T.DataType) -> HostColumn:
    """A short host column from Python values in the column's host domain
    (days, micros, unscaled decimals; None is null): the PERMISSIVE
    salvage rows."""
    n = len(values)
    valid = np.array([v is not None for v in values], dtype=np.bool_)
    if isinstance(dt, T.StringType):
        data = np.empty(n, dtype=object)
        data[:] = values
        col = HostColumn(dt, data, valid)
        col.encoded()
        return col
    if isinstance(dt, T.NullType):
        return null_column(dt, n)
    if T.is_dec128(dt):
        data = np.empty(n, dtype=object)
        data[:] = [0 if v is None else int(v) for v in values]
        return HostColumn(dt, data, valid)
    data = np.array([0 if v is None else v for v in values],
                    dtype=dt.np_dtype) if n else np.zeros(0, dt.np_dtype)
    return HostColumn(dt, data, valid)


# -- writing -----------------------------------------------------------------------

def _fmt(fn, vals: np.ndarray, width: int, *style):
    """(buf, off) of one formatter over ``vals``."""
    vals = np.ascontiguousarray(vals)
    n = len(vals)
    out = np.empty(max(n * width, 1), dtype=np.uint8)
    off = np.empty(n + 1, dtype=np.int64)
    if n == 0:
        off[0] = 0
        return out[:0], off
    k = fn(_p(vals), n, *style, _p(out), _p(off))
    return out[:k], off


def utf8_texts(values: np.ndarray, valid: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The UTF-8 bytes of a string column's values ("" at nulls) as
    (data, offsets), by one join and one encode (no per-value loop unless
    a value holds a NUL character)."""
    n = len(values)
    if n == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros(1, dtype=np.int64)
    vals = np.where(valid, values, "").tolist()
    raw = np.frombuffer("\x00".join(vals).encode("utf-8"), dtype=np.uint8)
    seps = np.flatnonzero(raw == 0)
    if len(seps) == n - 1:
        data = np.delete(raw, seps)
        off = np.empty(n + 1, dtype=np.int64)
        off[0] = 0
        off[1:n] = seps - np.arange(n - 1)
        off[n] = len(data)
        return data, off
    enc = [v.encode("utf-8") for v in vals]
    off = np.concatenate([[0], np.cumsum([len(e) for e in enc])]).astype(
        np.int64)
    return np.frombuffer(b"".join(enc) or b"\0", dtype=np.uint8)[
        :off[-1]], off


#: srt_escape styles
ESC_CSV, ESC_JSON, ESC_HIVE = 0, 1, 2


def escape(data: np.ndarray, off: np.ndarray, style: int, delim: int = -1,
           esc: int = -1) -> Tuple[np.ndarray, np.ndarray]:
    n = len(off) - 1
    grow = {ESC_CSV: 2, ESC_JSON: 6, ESC_HIVE: 2}[style]
    out = np.empty(max(grow * len(data) + 2 * n, 1), dtype=np.uint8)
    out_off = np.empty(n + 1, dtype=np.int64)
    src = data if len(data) else out
    k = _lib().srt_escape(_p(src), _p(off), n, style, delim, esc, _p(out),
                          _p(out_off))
    return out[:k], out_off


def _limbs_of(col: HostColumn) -> np.ndarray:
    if T.is_dec128(col.dtype):
        return dec128_limbs(col.data, col.validity, len(col))
    v = col.data.astype(np.int64)
    return np.ascontiguousarray(np.stack([v >> 63, v], axis=1))


def format_column(col: HostColumn, style: str
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Every value's text (nulls' texts are ignored) as the writer of
    ``style`` renders it: 'csv' Arrow's CSV writer, 'json' ``json.dumps``
    of the reference's Python values, 'hive' ``str()`` of them."""
    dt, lib = col.dtype, _lib()
    if isinstance(dt, T.NullType):
        return np.zeros(0, dtype=np.uint8), np.zeros(len(col) + 1,
                                                     dtype=np.int64)
    if isinstance(dt, T.StringType):
        data, off = utf8_texts(col.data, col.validity)
        if style == "csv":
            return escape(data, off, ESC_CSV)
        if style == "json":
            return escape(data, off, ESC_JSON)
        return data, off
    if type(dt) in _INT_WIDTH:
        return _fmt(lib.srt_fmt_i64, col.data.astype(np.int64), 20)
    if isinstance(dt, T.BooleanType):
        return _fmt(lib.srt_fmt_bool, col.data.astype(np.uint8), 5)
    if isinstance(dt, T.DoubleType):
        return _fmt(lib.srt_fmt_f64, col.data.astype(np.float64), 32,
                    {"csv": 0, "hive": 1, "json": 2}[style])
    if isinstance(dt, T.FloatType):
        if style == "csv":
            return _fmt(lib.srt_fmt_f32, col.data.astype(np.float32), 32)
        return _fmt(lib.srt_fmt_f64, col.data.astype(np.float64), 32,
                    1 if style == "hive" else 2)
    if isinstance(dt, T.DateType):
        buf, off = _fmt(lib.srt_fmt_date, col.data.astype(np.int32), 16)
        return escape(buf, off, ESC_JSON) if style == "json" else (buf, off)
    if isinstance(dt, T.TimestampType):
        buf, off = _fmt(lib.srt_fmt_ts, col.data.astype(np.int64), 40,
                        0 if style == "csv" else 1)
        return escape(buf, off, ESC_JSON) if style == "json" else (buf, off)
    if isinstance(dt, T.DecimalType):
        return _fmt(lib.srt_fmt_decimal, _limbs_of(col), 48,
                    dt.scale if style == "csv" else -1)
    raise NotImplementedError(f"writing a {dt} column as text")


def assemble(texts: Sequence[Tuple[np.ndarray, np.ndarray]],
             valids: Sequence[Optional[np.ndarray]],
             null_texts: Sequence[bytes], prefixes: Sequence[bytes],
             nrows: int, open_: bytes, sep: bytes, close: bytes,
             skip_nulls: bool) -> bytes:
    """Rows laid out from their columns' texts: ``open_``, the columns
    (each after its prefix, separated by ``sep``; a null column is its null
    text, or left out with ``skip_nulls``), ``close``."""
    import ctypes
    ncols = len(texts)
    keep = []

    def arr(vals, ctype):
        a = (ctype * max(ncols, 1))(*vals)
        keep.append(a)
        return ctypes.addressof(a)

    def b(x: bytes):
        a = np.frombuffer(x or b"\0", dtype=np.uint8)
        keep.append(a)
        return _p(a)

    bufs = [t[0] if len(t[0]) else np.zeros(1, dtype=np.uint8)
            for t in texts]
    offs = [np.ascontiguousarray(t[1], dtype=np.int64) for t in texts]
    vals = [None if v is None or bool(np.all(v)) else
            np.ascontiguousarray(v, dtype=np.bool_) for v in valids]
    keep.extend(bufs + offs + [v for v in vals if v is not None])
    args = (ncols, arr([_p(x) for x in bufs], ctypes.c_void_p),
            arr([_p(x) for x in offs], ctypes.c_void_p),
            arr([0 if v is None else _p(v) for v in vals], ctypes.c_void_p),
            arr([b(x) for x in null_texts], ctypes.c_void_p),
            arr([len(x) for x in null_texts], ctypes.c_int64),
            arr([b(x) for x in prefixes], ctypes.c_void_p),
            arr([len(x) for x in prefixes], ctypes.c_int64),
            nrows, b(open_), len(open_), b(sep), len(sep), b(close),
            len(close), int(skip_nulls))
    size = _lib().srt_assemble(*args, 0)
    out = np.empty(max(size, 1), dtype=np.uint8)
    _lib().srt_assemble(*args, _p(out))
    return out[:size].tobytes()


# -- scan options ------------------------------------------------------------------

def option_bool(value, name: str) -> bool:
    """A boolean option: a bool, or the strings 'true' / 'false' in any
    case (SQL OPTIONS arrive as strings)."""
    if isinstance(value, (bool, np.bool_)):
        return bool(value)
    if isinstance(value, str) and value.strip().lower() in ("true", "false"):
        return value.strip().lower() == "true"
    raise ValueError(f"option {name}={value!r}: want true or false")


def reject_unknown_options(fmt: str, options: dict, known) -> None:
    """The port reads no option it does not know: an unknown name raises
    instead of being ignored."""
    if options:
        raise ValueError(
            f"unknown {fmt} option(s) {sorted(options)}; the {fmt} scan "
            f"takes {sorted(known)}")


def _split_top(text: str) -> List[str]:
    """``text`` split on commas outside parentheses."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


def user_schema(schema) -> Optional[List[Tuple[str, T.DataType]]]:
    """A scan's ``schema`` option: a list of (name, type), or a DDL string
    ``"a INT, b DECIMAL(10, 2)"`` (how SQL OPTIONS can give one)."""
    if schema is None:
        return None
    if isinstance(schema, str):
        out = []
        for part in _split_top(schema):
            name, _, ty = part.partition(" ")
            if not ty.strip():
                raise ValueError(f"schema field {part!r}: want 'name TYPE'")
            out.append((name.strip("`"), T.parse_type(ty.strip())))
        return out
    return [(n, dt) for n, dt in schema]
