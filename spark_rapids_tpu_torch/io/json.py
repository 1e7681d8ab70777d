"""JSON scan and writer (port of ``spark_rapids_tpu/io/json.py``; reference:
GpuJsonScan over GpuTextBasedPartitionReader) over the port's own text
codec (``io/text_format.py``, ``native/text_host.cpp``), with no pyarrow.

Options, as the reference reads them: multiLine (one JSON array or object
a file), primitivesAsString, and mode = PERMISSIVE | DROPMALFORMED |
FAILFAST. A file is first read whole, as Arrow's JSON reader reads a
stream of objects (NaN and Infinity are numbers there). Only when that
fails (malformed text, or a value that does not convert to the schema's
type) does the line normalisation run: each line that is one standard
JSON value is kept, and a malformed one (NaN and Infinity included)
becomes ``{}``, an all-null row, in PERMISSIVE or is dropped in
DROPMALFORMED; FAILFAST raises instead. Inferred columns come in order of
first appearance: integers as LONG (DOUBLE once one is not), ISO
timestamp strings without a fraction as TIMESTAMP (a date string too),
other strings as STRING, all-null columns as NULL. Object and array
columns raise, naming ROADMAP item [9].

Options the reference does not know raise (the reference ignores them),
and boolean options take 'true'/'false' strings (SQL OPTIONS).
"""

from __future__ import annotations

import json as _json
from typing import List, Optional, Sequence

import numpy as np

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostTable
from spark_rapids_tpu_torch.io import text_format as TF
from spark_rapids_tpu_torch.io.common import FileScanNode, row_carrier_table
from spark_rapids_tpu_torch.io.writer import write_partitioned
from spark_rapids_tpu_torch.lockorder import ordered_lock
from spark_rapids_tpu_torch.plan.nodes import Schema

JSON_READER_TYPE = C.JSON_READER_TYPE

_KNOWN = ("schema", "multi_line", "primitives_as_string", "mode", "columns",
          "reader_type")


class JsonScanNode(FileScanNode):
    format_name = "json"

    def __init__(self, paths, conf: C.RapidsConf, columns=None,
                 reader_type=None, schema: Optional[Schema] = None,
                 multi_line=False, primitives_as_string=False,
                 mode: str = "PERMISSIVE", **options):
        TF.reject_unknown_options(self.format_name, options, _KNOWN)
        self.user_schema = TF.user_schema(schema)
        self.multi_line = TF.option_bool(multi_line, "multi_line")
        self.primitives_as_string = TF.option_bool(
            primitives_as_string, "primitives_as_string")
        self.mode = str(mode).upper()
        if self.mode not in ("PERMISSIVE", "DROPMALFORMED", "FAILFAST"):
            raise ValueError(f"unknown JSON mode {mode!r}")
        self._inferred = {}
        self._lock = ordered_lock("io.scan.json")
        super().__init__(paths, conf, columns=columns,
                         reader_type=reader_type)

    def _conf_reader_type(self) -> str:
        return self.conf.get_entry(JSON_READER_TYPE)

    def _cache_key_extra(self) -> tuple:
        return (tuple(self.user_schema or ()), self.multi_line,
                self.primitives_as_string, self.mode)

    # -- decoding -------------------------------------------------------------
    def _normalized(self, raw: np.ndarray) -> np.ndarray:
        """multiLine and the modes applied: clean JSON-lines bytes."""
        if self.multi_line:
            try:
                doc = _json.loads(raw.tobytes())
            except _json.JSONDecodeError:
                if self.mode == "FAILFAST":
                    raise
                # PERMISSIVE: one all-null row; DROPMALFORMED: none
                return np.frombuffer(
                    b"{}" if self.mode == "PERMISSIVE" else b"",
                    dtype=np.uint8)
            rows = doc if isinstance(doc, list) else [doc]
            return np.frombuffer(
                "\n".join(_json.dumps(r) for r in rows).encode(),
                dtype=np.uint8)
        return TF.json_normalize(raw, self.mode == "PERMISSIVE")

    def _typed(self, rows: TF.JsonRows, need) -> dict:
        """name -> converted column: a user schema's columns (every one is
        checked, as pyarrow converts them all; only ``need``'s strings are
        built), else every key's inferred column."""
        ids = {k: j for j, k in enumerate(rows.keys)}
        out = {}
        if self.user_schema:
            for name, dt in self.user_schema:
                if self.primitives_as_string and not T.is_nested(dt):
                    dt = T.STRING
                k = ids.get(name)
                if name not in need and isinstance(dt, T.StringType):
                    if k is not None:
                        kinds, _ = rows.column(k)
                        TF.json_groups(name, kinds)
                    continue
                out[name] = TF.json_typed(rows, k, dt, name)
            return out
        for name, k in ids.items():
            out[name] = TF.infer_json_column(rows, k)
        return out

    def _decode(self, path: str, need) -> tuple:
        """(row count, columns) of ``path``: the whole-file read, else the
        line normalisation's."""
        raw = TF.read_bytes(path)
        if not self.multi_line:
            try:
                rows = TF.json_scan(raw)
                return rows.num_rows, self._typed(rows, need)
            except TF.TextParseError:
                if self.mode == "FAILFAST":
                    raise
        data = self._normalized(raw)
        if not data.tobytes().strip():
            return 0, {}
        rows = TF.json_scan(data)
        return rows.num_rows, self._typed(rows, need)

    def file_schema(self, path: str) -> Schema:
        if self.user_schema:
            return list(self.user_schema)
        with self._lock:
            got = self._inferred.get(path)
        if got is None:
            got = self._decode(path, ())
            with self._lock:
                self._inferred[path] = got
        return [(n, T.STRING if self.primitives_as_string else
                 TF.kind_to_spark(c.kind)) for n, c in got[1].items()]

    def read_file(self, path: str) -> HostTable:
        # the schema first: inferring it decodes (and keeps) the first file
        need = {n for n, _ in self.data_schema}
        with self._lock:
            got = self._inferred.pop(path, None)
        n, cols = got or self._decode(path, need)
        names, out = [], []
        for name, dt in self.data_schema:
            c = cols.get(name)
            if c is None:
                c = TF.null_column(dt, n)
            elif isinstance(c, TF.TextColumn):
                c = TF.cast_to(c, dt)
            names.append(name)
            out.append(c)
        if not names:
            return row_carrier_table(n)
        return HostTable(names, out)


def render_json(table: HostTable) -> bytes:
    """The reference's JSON lines: ``json.dumps`` of each row's non-null
    values (``default=str``: dates and timestamps as their ``str()``),
    keys in column order, ``", "`` and ``": "`` separators, non-ASCII
    escaped, NaN and Infinity spelled as Python does."""
    texts, valids, prefixes = [], [], []
    for name, c in zip(table.names, table.columns):
        texts.append(TF.format_column(c, "json"))
        valids.append(np.zeros(len(c), dtype=np.bool_)
                      if isinstance(c.dtype, T.NullType) else c.validity)
        data, off = TF.utf8_texts(np.array([name], dtype=object),
                                  np.ones(1, dtype=np.bool_))
        key, _ = TF.escape(data, off, TF.ESC_JSON)
        prefixes.append(key.tobytes() + b": ")
    return TF.assemble(texts, valids, [b""] * len(texts), prefixes,
                       table.num_rows, b"{", b", ", b"}\n", True)


def write_json(table: HostTable, path: str,
               partition_by: Optional[Sequence[str]] = None,
               committer=None) -> List[str]:
    """Write ``table`` as JSON lines through the committer (the bytes of
    the reference's writer)."""
    def _write_one(tbl: HostTable, file_path: str):
        with open(file_path, "wb") as f:
            f.write(render_json(tbl))

    return write_partitioned(table, path, _write_one, "json", partition_by,
                             committer=committer)
