"""CSV scan and writer (port of ``spark_rapids_tpu/io/csv.py``; reference:
GpuCSVScan over GpuTextBasedPartitionReader) over the port's own text codec
(``io/text_format.py``, ``native/text_host.cpp``), with no pyarrow.

Spark's options matrix, as the reference reads it:

  sep/delimiter, quote, escape, header, comment (a line pre-filter),
  nullValue/emptyValue, nanValue/positiveInf/negativeInf (custom float
  spellings, converted from the text on the host), timestampFormat (a
  Spark pattern translated to strptime), ignoreLeadingWhiteSpace /
  ignoreTrailingWhiteSpace, mode = PERMISSIVE | DROPMALFORMED | FAILFAST.

The modes are the reference's, not Spark's: only rows with the wrong
number of fields are malformed. FAILFAST raises on one; DROPMALFORMED
drops it; PERMISSIVE splits its raw text on the delimiter (quotes not
honored), parses the fields Spark's way and appends the row after the
file's other rows. A value that does not convert to a user schema's type
raises in every mode, except a custom float spelling, which DROPMALFORMED
drops and PERMISSIVE nulls. With no schema, the column types are Arrow's
inference over the whole file (an integral column reads as LONG, a
timestamp with a fraction or a zone as TIMESTAMP); a later file converts
to the first file's types by Arrow's safe cast.

Options the reference does not know raise (the reference ignores them),
and boolean options take 'true'/'false' strings (SQL OPTIONS).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.columnar.table import concat_host
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.io import text_format as TF
from spark_rapids_tpu_torch.io.common import FileScanNode, row_carrier_table
from spark_rapids_tpu_torch.io.writer import write_partitioned
from spark_rapids_tpu_torch.lockorder import ordered_lock
from spark_rapids_tpu_torch.plan.nodes import Schema

CSV_READER_TYPE = C.CSV_READER_TYPE
spark_pattern_to_strptime = TF.spark_pattern_to_strptime

_KNOWN = ("schema", "header", "delimiter", "sep", "quote", "escape",
          "comment", "null_value", "empty_value", "nan_value",
          "positive_inf", "negative_inf", "timestamp_format",
          "ignore_leading_whitespace", "ignore_trailing_whitespace", "mode",
          "columns", "reader_type")


class CsvScanNode(FileScanNode):
    format_name = "csv"

    def __init__(self, paths, conf: C.RapidsConf, columns=None,
                 reader_type=None, schema: Optional[Schema] = None,
                 header=True, delimiter: str = ",", sep: Optional[str] = None,
                 quote: str = '"', escape: Optional[str] = None,
                 comment: Optional[str] = None,
                 null_value: str = "", empty_value: Optional[str] = None,
                 nan_value: str = "NaN",
                 positive_inf: str = "Inf", negative_inf: str = "-Inf",
                 timestamp_format: Optional[str] = None,
                 ignore_leading_whitespace=False,
                 ignore_trailing_whitespace=False,
                 mode: str = "PERMISSIVE", **options):
        TF.reject_unknown_options(self.format_name, options, _KNOWN)
        self.user_schema = TF.user_schema(schema)
        self.header = TF.option_bool(header, "header")
        self.delimiter = sep if sep is not None else delimiter
        self.quote = quote
        self.escape = escape
        self.comment = comment
        self.null_value = null_value
        self.empty_value = empty_value
        self.nan_value = nan_value
        self.positive_inf = positive_inf
        self.negative_inf = negative_inf
        self.timestamp_format = timestamp_format
        self.ignore_leading_ws = TF.option_bool(
            ignore_leading_whitespace, "ignore_leading_whitespace")
        self.ignore_trailing_ws = TF.option_bool(
            ignore_trailing_whitespace, "ignore_trailing_whitespace")
        self.mode = str(mode).upper()
        if self.mode not in ("PERMISSIVE", "DROPMALFORMED", "FAILFAST"):
            raise ValueError(f"unknown CSV mode {mode!r}")
        if len(self.delimiter) != 1:
            raise ValueError("CSV sep must be a single character")
        self._strptime = (spark_pattern_to_strptime(timestamp_format)
                          if timestamp_format else None)
        #: the first file's tokens and inferred columns, kept from schema
        #: inference for its read
        self._inferred = {}
        self._lock = ordered_lock("io.scan.csv")
        super().__init__(paths, conf, columns=columns,
                         reader_type=reader_type)

    def _conf_reader_type(self) -> str:
        return self.conf.get_entry(CSV_READER_TYPE)

    def _cache_key_extra(self) -> tuple:
        return (tuple(self.user_schema or ()), self.header, self.delimiter,
                self.quote, self.escape, self.comment, self.null_value,
                self.empty_value, self.nan_value, self.positive_inf,
                self.negative_inf, self.timestamp_format,
                self.ignore_leading_ws, self.ignore_trailing_ws, self.mode)

    # -- option plumbing ----------------------------------------------------
    @property
    def _custom_floats(self) -> bool:
        return (self.nan_value != "NaN" or self.positive_inf != "Inf"
                or self.negative_inf != "-Inf")

    def _nulls(self) -> List[str]:
        out = [self.null_value]
        if self.empty_value is not None:
            out.append(self.empty_value)
        return out

    def _strip(self) -> Optional[str]:
        return ("l" if self.ignore_leading_ws else "") + (
            "r" if self.ignore_trailing_ws else "") or None

    # -- tokens -------------------------------------------------------------
    def _records(self, path: str):
        """(records, column names, first body row) of ``path``."""
        data = TF.read_bytes(path)
        if self.comment:
            data = TF.filter_comment_lines(data, self.comment)
        rec = TF.tokenize(data, self.delimiter, self.quote or None,
                          self.escape, self.escape is None)
        if self.header:
            if rec.num_rows == 0:
                raise TF.TextParseError("Empty CSV file")
            return rec, rec.row_texts(0), 1
        if not self.user_schema:
            raise ValueError("headerless CSV requires an explicit schema")
        return rec, [n for n, _ in self.user_schema], 0

    def _rows(self, rec, names, start):
        """(good body rows, PERMISSIVE salvage texts) under the mode."""
        counts = rec.counts()[start:]
        bad = np.flatnonzero(counts != len(names))
        if len(bad) and self.mode == "FAILFAST":
            r = int(bad[0]) + start
            raise TF.TextParseError(
                f"CSV parse error: Expected {len(names)} columns, got "
                f"{int(counts[bad[0]])}: {rec.raw_text(r)}")
        good = np.flatnonzero(counts == len(names)) + start
        salvage = ([rec.raw_text(int(r) + start) for r in bad]
                   if self.mode == "PERMISSIVE" else [])
        return good, salvage

    def _infer(self, path: str):
        """Tokens and every column's inferred kind (no user schema)."""
        rec, names, start = self._records(path)
        good, salvage = self._rows(rec, names, start)
        first = rec.row_first[good]
        kinds = [TF.infer_csv_column(rec.spans, first + j, self._nulls())
                 for j in range(len(names))]
        return rec, names, first, salvage, kinds

    def file_schema(self, path: str) -> Schema:
        if self.user_schema:
            return list(self.user_schema)
        if self._strptime is not None:
            raise NotImplementedError(
                "CSV timestampFormat without a schema: the port infers "
                "timestamps only in ISO form; give the schema")
        with self._lock:
            got = self._inferred.get(path)
        if got is None:
            got = self._infer(path)
            with self._lock:
                self._inferred[path] = got
        _, names, _, _, kinds = got
        return [(n, TF.kind_to_spark(k.kind)) for n, k in zip(names, kinds)]

    def _pre_float_schema(self) -> Schema:
        """The decode's schema: custom-float columns come as STRING and
        convert in ``_post_process``."""
        if not (self.user_schema and self._custom_floats):
            return self.data_schema
        fcols = {n for n, dt in self.user_schema
                 if isinstance(dt, (T.FloatType, T.DoubleType))}
        return [(n, T.STRING if n in fcols else dt)
                for n, dt in self.data_schema]

    # -- reading --------------------------------------------------------------
    def read_file(self, path: str) -> HostTable:
        # the schema first: inferring it tokenizes (and keeps) the first
        # file
        schema = self._pre_float_schema()
        with self._lock:
            got = self._inferred.pop(path, None)
        if self.user_schema is None:
            rec, names, first, salvage, kinds = got or self._infer(path)
        else:
            rec, names, start = self._records(path)
            good, salvage = self._rows(rec, names, start)
            first = rec.row_first[good]
            kinds = None
        pos = {n: j for j, n in enumerate(names)}
        out_names, cols = [], []
        for name, dt in schema:
            j = pos.get(name)
            if j is None:
                raise ColumnarProcessingError(
                    f"{path}: column {name!r} is not in the file's header "
                    f"{names}")
            idx = first + j
            if kinds is not None:
                col = TF.cast_to(kinds[j], dt)
                if isinstance(dt, T.StringType) and self._strip():
                    col = TF.string_column(rec.spans, idx, col.validity,
                                           self._strip())
            else:
                valid = ~TF.null_mask(rec.spans, idx, self._nulls())
                if isinstance(dt, T.StringType):
                    col = TF.string_column(rec.spans, idx, valid,
                                           self._strip())
                else:
                    strp = (self._strptime
                            if isinstance(dt, T.TimestampType) else None)
                    col = TF.parse_typed(rec.spans, idx, valid, dt,
                                         f"In CSV column #{j}: CSV",
                                         ts_format=strp)
            out_names.append(name)
            cols.append(col)
        if not out_names:
            host = row_carrier_table(len(first))
        else:
            host = self._post_process(HostTable(out_names, cols), rec, first,
                                      pos)
        if salvage:
            host = self._append_null_filled(host, salvage)
        return host

    def _post_process(self, host: HostTable, rec, first, pos) -> HostTable:
        """The custom float spellings (DROPMALFORMED drops a row whose
        float does not parse)."""
        if not (self.user_schema and self._custom_floats):
            return host
        target = dict(self.data_schema)
        cols = list(host.columns)
        drop = np.zeros(host.num_rows, dtype=np.bool_)
        for i, (n, c) in enumerate(zip(host.names, cols)):
            want = target.get(n)
            if isinstance(want, (T.FloatType, T.DoubleType)):
                cols[i], bad = self._convert_custom_floats(c, want)
                drop |= bad
        if self.mode == "DROPMALFORMED" and drop.any():
            keep = np.flatnonzero(~drop)
            cols = [c.take(keep) for c in cols]
        return HostTable(host.names, cols)

    def _convert_custom_floats(self, c: HostColumn, dt):
        """Each distinct text stripped, then a custom spelling or Python's
        float() (a value neither is malformed: FAILFAST raises)."""
        specials = {self.nan_value: np.nan, self.positive_inf: np.inf,
                    self.negative_inf: -np.inf}
        codes, dictionary = c.encoded()
        vals = np.zeros(len(dictionary), dtype=np.float64)
        ok = np.zeros(len(dictionary), dtype=np.bool_)
        for k, text in enumerate(dictionary):
            s = text.strip()
            if s in specials:
                vals[k], ok[k] = specials[s], True
                continue
            try:
                vals[k], ok[k] = float(s), True
            except ValueError:
                pass
        row_ok = ok[codes] if len(dictionary) else np.zeros(len(c), bool)
        malformed = c.validity & ~row_ok
        if malformed.any() and self.mode == "FAILFAST":
            s = c.data[np.flatnonzero(malformed)[0]].strip()
            raise ValueError(f"malformed float {s!r} (FAILFAST mode)")
        valid = c.validity & row_ok
        out = np.where(valid, vals[codes] if len(dictionary) else 0.0, 0.0)
        return HostColumn(dt, out.astype(dt.np_dtype), valid), malformed

    def _append_null_filled(self, host: HostTable, rows) -> HostTable:
        """PERMISSIVE ragged rows: fields by a naive split of the row's
        text (these rows already failed structured parsing), matched by
        the file's physical column order, parsed Spark's way, appended
        after the file's other rows."""
        file_schema = list(self.user_schema) if self.user_schema else \
            list(self.data_schema)
        file_pos = {n: j for j, (n, _) in enumerate(file_schema)}
        schema = [(n, c.dtype) for n, c in zip(host.names, host.columns)]
        extra = []
        for text in rows:
            parts = text.split(self.delimiter)
            row = []
            for n, dt in schema:
                j = file_pos.get(n)
                raw = (parts[j].strip()
                       if j is not None and j < len(parts) else None)
                if raw in (None, self.null_value):
                    row.append(None)
                    continue
                try:
                    v = (raw if isinstance(dt, T.StringType)
                         else TF.parse_string_cast(raw, dt))
                except Exception:
                    v = None
                row.append(v)
            extra.append(row)
        cols = [TF.column_from_values([r[j] for r in extra], dt)
                for j, (n, dt) in enumerate(schema)]
        return concat_host([host, HostTable(host.names, cols)])


def render_csv(table: HostTable, header: bool = True,
               sep: str = ",") -> bytes:
    """Arrow's CSV text of ``table``: a quoted header, strings always
    quoted (a quote doubled), nulls empty, floats in Arrow's shortest
    form, timestamps as ``YYYY-MM-DD HH:MM:SS.ffffffZ``; fields separated
    by ``sep`` (pyarrow's ``WriteOptions.delimiter``)."""
    d = bytes([TF.one_byte(sep, "CSV sep")])
    head = b""
    if header:
        data, off = TF.utf8_texts(np.array(table.names, dtype=object),
                                  np.ones(len(table.names), dtype=np.bool_))
        buf, off = TF.escape(data, off, TF.ESC_CSV)
        head = d.join(bytes(buf[off[i]:off[i + 1]])
                      for i in range(len(table.names))) + b"\n"
    texts = [TF.format_column(c, "csv") for c in table.columns]
    body = TF.assemble(texts, [c.validity for c in table.columns],
                       [b""] * len(texts), [b""] * len(texts),
                       table.num_rows, b"", d, b"\n", False)
    return head + body


def write_csv(table: HostTable, path: str,
              partition_by: Optional[Sequence[str]] = None,
              header=True, committer=None, sep: str = ",") -> List[str]:
    """Write ``table`` as CSV file(s) through the committer (the bytes of
    the reference's pyarrow writer; ``sep`` is an extension, the
    reference writes commas)."""
    header = TF.option_bool(header, "header")

    def _write_one(tbl: HostTable, file_path: str):
        with open(file_path, "wb") as f:
            f.write(render_csv(tbl, header, sep))

    return write_partitioned(table, path, _write_one, "csv", partition_by,
                             committer=committer)
