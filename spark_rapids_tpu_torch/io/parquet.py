"""Parquet scan and writer (port of ``spark_rapids_tpu/io/parquet.py``)
over the port's own codec (``io/parquet_format.py``), with no pyarrow.

``filters`` take pyarrow's forms: a list of ``(column, op, value)``
tuples that are ANDed, or a list of such lists that are ORed, with the ops
``=``, ``==``, ``!=``, ``<``, ``>``, ``<=``, ``>=``, ``in`` and ``not in``.
Rows are filtered with pyarrow's null semantics (a null never satisfies a
comparison or ``in``; ``not in`` keeps it), after row groups whose
statistics rule every disjunct out are skipped (``prunedRowGroups``).
COALESCING stitches at row-group granularity, as the reference's
MultiFileParquetPartitionReader does. The first file sets the scan's
schema; a later file's column of another type widens losslessly to it
(the reference's safe cast) or the read raises."""

from __future__ import annotations

import datetime
import decimal
import operator
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.nested import NestedData
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.io import parquet_format as PF
from spark_rapids_tpu_torch.io.common import FileScanNode, row_carrier_table
from spark_rapids_tpu_torch.io.writer import write_partitioned
from spark_rapids_tpu_torch.lockorder import ordered_lock
from spark_rapids_tpu_torch.plan.nodes import Schema

_OPS = {"=": operator.eq, "==": operator.eq, "!=": operator.ne,
        "<": operator.lt, ">": operator.gt, "<=": operator.le,
        ">=": operator.ge}
_EPOCH = datetime.date(1970, 1, 1)


def normalize_filters(filters) -> Optional[List[List[tuple]]]:
    """pyarrow's filter forms -> a list of ANDed conjunctions (ORed)."""
    if filters is None:
        return None
    filters = list(filters)
    if not filters:
        return None
    if all(isinstance(f, tuple) for f in filters):
        filters = [filters]
    out = []
    for conj in filters:
        terms = []
        for term in conj:
            if not (isinstance(term, (tuple, list)) and len(term) == 3):
                raise ColumnarProcessingError(
                    f"bad Parquet filter term {term!r}: want (column, op, "
                    "value)")
            name, op, value = term
            op = op.lower() if isinstance(op, str) else op
            if op not in _OPS and op not in ("in", "not in"):
                raise ColumnarProcessingError(
                    f"unsupported Parquet filter op {op!r}")
            terms.append((name, op, value))
        out.append(terms)
    return out


def _domain_value(v, dt: T.DataType):
    """A filter literal in the column's host domain (days, micros,
    unscaled decimals)."""
    if v is None:
        return None
    if isinstance(dt, T.DateType) and isinstance(v, datetime.date) \
            and not isinstance(v, datetime.datetime):
        return (v - _EPOCH).days
    if isinstance(dt, T.TimestampType) and isinstance(v, datetime.datetime):
        if v.tzinfo is None:
            v = v.replace(tzinfo=datetime.timezone.utc)
        delta = v - datetime.datetime(1970, 1, 1,
                                      tzinfo=datetime.timezone.utc)
        return (delta.days * 86_400 + delta.seconds) * 1_000_000 + \
            delta.microseconds
    if isinstance(dt, T.DecimalType):
        return decimal.Decimal(str(v)).scaleb(dt.scale)
    return v


def _term_mask(col: HostColumn, op: str, value) -> np.ndarray:
    """The rows of ``col`` that satisfy one term, nulls excluded (except
    under ``not in``, as pyarrow's is_in reads a null as not found)."""
    dt = col.dtype
    valid = col.validity
    if op in ("in", "not in"):
        vals = [_domain_value(v, dt) for v in value]
        if isinstance(dt, T.StringType):
            codes, dictionary = col.encoded()
            hit = np.isin(dictionary, np.array(vals, dtype=object))[codes] \
                if len(dictionary) else np.zeros(len(col), dtype=bool)
        elif isinstance(dt, T.DecimalType):
            # only an integral unscaled value can equal a stored one
            ints = [int(v) for v in vals
                    if v is not None and v == v.to_integral_value()]
            hit = np.isin(col.data, np.array(ints, dtype=col.data.dtype)) \
                if ints else np.zeros(len(col), dtype=bool)
        else:
            hit = np.isin(col.data, np.array(vals))
        hit &= valid
        return hit if op == "in" else ~hit
    fn = _OPS[op]
    v = _domain_value(value, dt)
    if v is None:
        return np.zeros(len(col), dtype=bool)
    if isinstance(dt, T.StringType):
        codes, dictionary = col.encoded()
        if not len(dictionary):
            return np.zeros(len(col), dtype=bool)
        hit = np.asarray(fn(dictionary, v), dtype=bool)[codes]
    elif isinstance(dt, T.DecimalType):
        hit = np.asarray(fn(col.data.astype(object), v), dtype=bool)
    else:
        hit = np.asarray(fn(col.data, v), dtype=bool)
    return hit & valid


def filter_mask(table: HostTable, filters) -> np.ndarray:
    keep = np.zeros(table.num_rows, dtype=bool)
    for conj in filters:
        m = np.ones(table.num_rows, dtype=bool)
        for name, op, value in conj:
            m &= _term_mask(table.columns[table.names.index(name)], op,
                            value)
        keep |= m
    return keep


def _term_prunes(cm: PF.ChunkMeta, leaf: PF.Leaf, nrows: int, op: str,
                 value) -> bool:
    """True when a row group's statistics show no row satisfies the
    term."""
    if cm.null_count is not None and cm.null_count >= nrows:
        return op != "not in"  # every row null
    lo = PF.stat_value(cm.min_raw, leaf)
    hi = PF.stat_value(cm.max_raw, leaf)
    if lo is None or hi is None or leaf.spark is None:
        return False
    if isinstance(leaf.spark, (T.FloatType, T.DoubleType)):
        return False  # NaN is outside min/max
    dt = leaf.spark
    try:
        if op in ("=", "=="):
            v = _domain_value(value, dt)
            return v is not None and (v < lo or v > hi)
        if op == "<":
            return lo >= _domain_value(value, dt)
        if op == "<=":
            return lo > _domain_value(value, dt)
        if op == ">":
            return hi <= _domain_value(value, dt)
        if op == ">=":
            return hi < _domain_value(value, dt)
        if op == "in":
            vals = [_domain_value(v, dt) for v in value]
            return all(v is None or v < lo or v > hi for v in vals)
    except TypeError:
        return False
    return False


class ParquetScanNode(FileScanNode):
    format_name = "parquet"

    def __init__(self, paths, conf: C.RapidsConf, columns=None,
                 reader_type=None, filters=None, **options):
        #: pyarrow-style pushdown filters, e.g. [("x", ">", 3)]
        self.filters = filters
        self._filters = normalize_filters(filters)
        self._footers = {}
        self._lock = ordered_lock("io.scan.parquet")
        #: row groups the statistics ruled out, over every read
        self.pruned_row_groups = 0
        super().__init__(paths, conf, columns=columns,
                         reader_type=reader_type, **options)

    def _conf_reader_type(self) -> str:
        return self.conf.get_entry(C.PARQUET_READER_TYPE)

    def _cache_key_extra(self) -> tuple:
        return (repr(self.filters),)

    def footer(self, path: str) -> PF.FileMeta:
        """``path``'s footer, read once per version of the file."""
        st = os.stat(path)
        key = (path, st.st_mtime_ns, st.st_size)
        got = self._footers.get(key)
        if got is None:
            got = self._footers[key] = PF.read_footer(path)
        return got

    def file_schema(self, path: str) -> Schema:
        return self.footer(path).schema()

    def _file_columns(self) -> Optional[List[str]]:
        if self.columns is None:
            return None
        data_names = {n for n, _ in self.data_schema}
        return [c for c in self.columns if c in data_names]

    def _kept_row_groups(self, meta: PF.FileMeta) -> List[int]:
        if self._filters is None:
            return list(range(len(meta.row_groups)))
        kept = []
        for i, rg in enumerate(meta.row_groups):
            gone = all(any(_term_prunes(rg.chunks[name], meta.leaf(name),
                                        rg.num_rows, op, value)
                           for name, op, value in conj
                           if name in rg.chunks
                           and isinstance(meta.leaf(name), PF.Leaf))
                       for conj in self._filters)
            if gone:
                with self._lock:
                    self.pruned_row_groups += 1
            else:
                kept.append(i)
        return kept

    def _read(self, path: str, row_groups: Optional[Sequence[int]]
              ) -> HostTable:
        """``path``'s data columns (of ``row_groups``, or of the row groups
        the filters keep), checked against the scan's schema and with the
        filters applied to the rows."""
        meta = self.footer(path)
        names = self._file_columns()
        if names is None:
            names = [n for n, _ in self.data_schema]
        want = dict(self.data_schema)
        for name, dt in self.data_schema:
            got = meta.leaf(name).require()
            if got != dt and not _widens(got, dt):
                raise ColumnarProcessingError(
                    f"{path}: column {name!r} is {got}, the scan's schema "
                    f"says {dt}")
        if row_groups is None:
            row_groups = self._kept_row_groups(meta)
        if self._filters is None:
            if not names:
                return row_carrier_table(
                    sum(meta.row_groups[i].num_rows for i in row_groups))
            t = PF.read_columns(path, meta, names, row_groups)
            return HostTable(names, [_widen(c, want[nm]) for nm, c in
                                     zip(names, t.columns)])
        need = list(dict.fromkeys(
            names + [nm for conj in self._filters for nm, _, _ in conj]))
        for nm in need:
            meta.leaf(nm)
        t = PF.read_columns(path, meta, need, row_groups)
        keep = filter_mask(t, self._filters)
        rows = np.flatnonzero(keep)
        if not names:
            return row_carrier_table(len(rows))
        cols = []
        for nm in names:
            c = t.columns[need.index(nm)]
            if isinstance(c.data, NestedData):
                cols.append(c.take(rows))
                continue
            cols.append(_widen(c.take(rows), want[nm]))
        return HostTable(names, cols)

    def read_file(self, path: str) -> HostTable:
        return self._read(path, None)

    def _coalescing_chunks(self, paths) -> Iterator[HostTable]:
        """Row-group chunks for the stitcher (one upload per stitched
        group)."""
        for path in paths:
            meta = self.footer(path)
            for rg in self._kept_row_groups(meta):
                yield self._with_partition_columns(
                    self._read(path, [rg]), path)


#: integral types by width: a narrower one widens losslessly
_INTEGRAL = (T.ByteType, T.ShortType, T.IntegerType, T.LongType)


def _widens(got: T.DataType, want: T.DataType) -> bool:
    """Whether a file's column type converts to the scan's without loss
    (the reference's safe cast across files): a narrower integer to a
    wider one, FLOAT to DOUBLE, a decimal to one of the same scale and
    more digits."""
    kinds = [next((i for i, k in enumerate(_INTEGRAL) if isinstance(d, k)),
                  None) for d in (got, want)]
    if None not in kinds:
        return kinds[0] < kinds[1]
    if isinstance(got, T.FloatType) and isinstance(want, T.DoubleType):
        return True
    return (isinstance(got, T.DecimalType)
            and isinstance(want, T.DecimalType)
            and got.scale == want.scale and got.precision < want.precision)


def _widen(col: HostColumn, want: T.DataType) -> HostColumn:
    """``col`` in the scan's type ``want`` (a widening ``_widens``
    allows)."""
    if col.dtype == want:
        return col
    if T.is_dec128(want) and not T.is_dec128(col.dtype):
        data = np.empty(len(col), dtype=object)
        data[:] = col.data.astype(object)
    elif T.is_dec128(want):
        data = col.data
    else:
        data = col.data.astype(want.np_dtype)
    return HostColumn(want, data, col.validity)


def write_parquet(table: HostTable, path: str,
                  partition_by: Optional[Sequence[str]] = None,
                  compression: str = "snappy", row_group_rows: int = 1 << 20,
                  committer=None) -> List[str]:
    """Write a HostTable as Parquet file(s) with the port's writer;
    returns the written paths.

    With ``partition_by``, writes Hive-style key=value directories
    through the dynamic-partitioning writer. All output stages through the
    transactional committer (io/committer.py); pass ``committer`` to run
    under a caller-owned WriteJob."""
    def _write_one(tbl: HostTable, file_path: str):
        PF.write_table(tbl, file_path, compression=compression,
                       row_group_rows=row_group_rows)

    return write_partitioned(table, path, _write_one, "parquet",
                             partition_by, committer=committer)
