"""Shared file-scan machinery: the reader modes (port of
``spark_rapids_tpu/io/common.py``).

  PERFILE        decode one file at a time, one batch per file.
  COALESCING     stitch files (Parquet: row groups) into batches of about
                 ``spark.rapids.sql.reader.coalescing.targetBytes``, so each
                 upload and each downstream kernel runs at full batch size.
  MULTITHREADED  a pool of ``spark.rapids.sql.multiThreadedRead.numThreads``
                 threads decodes a bounded window of files ahead of the
                 consumer, in order, so host decode overlaps device work.
  AUTO           MULTITHREADED for more than one file, else PERFILE.

Decoding runs on the host (the port's own codecs, no pyarrow), as in the
reference; the batches upload in ``execs/basic.py::TpuFileScanExec``.
Hive-style ``key=value`` directory components come back as partition
columns with their types inferred (long, then double, then string).

Dynamic partition pruning (``_effective_paths``) drops the files whose
partition value a broadcast join's build side cannot match. Not ported:
the reference's multi-host cluster route (ROADMAP item 11); the scan
takes the local modes.
"""

from __future__ import annotations

import concurrent.futures as cf
import glob as _glob
import os
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.columnar.table import concat_host
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.plan.nodes import PlanNode, Schema


class ReaderMode:
    PERFILE = "PERFILE"
    COALESCING = "COALESCING"
    MULTITHREADED = "MULTITHREADED"
    AUTO = "AUTO"


def expand_paths(paths: Sequence[str]) -> List[str]:
    """Expand globs and directories into a sorted file list.

    Hidden entries (``_``- or ``.``-prefixed files AND directories) are
    left out on every listing branch, as Spark's InMemoryFileIndex does:
    the transactional writer stages its output under
    ``_temporary/<job>/<attempt>/``, and a scan must never see it. A file
    named explicitly is read as given."""
    out: List[str] = []
    for p in paths:
        if any(ch in p for ch in "*?["):
            # hidden components are rejected wherever a wildcard could
            # have matched them, and kept where the caller spelled them
            comps = p.split(os.sep)
            first_wild = next(i for i, seg in enumerate(comps)
                              if any(ch in seg for ch in "*?["))
            for m in sorted(_glob.glob(p)):
                tail = m.rstrip(os.sep).split(os.sep)[first_wild:]
                if not any(c.startswith(("_", ".")) for c in tail if c):
                    out.append(m)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if not d.startswith(("_", ".")))
                for f in sorted(files):
                    if not f.startswith(("_", ".")):
                        out.append(os.path.join(root, f))
        else:
            out.append(p)
    if not out:
        raise ColumnarProcessingError(f"no input files for {list(paths)}")
    return out


HIVE_DEFAULT_PARTITION = "__HIVE_DEFAULT_PARTITION__"


def _unescape_partition_value(s: str) -> Optional[str]:
    if s == HIVE_DEFAULT_PARTITION:
        return None
    out, i = [], 0
    while i < len(s):
        if s[i] == "%" and i + 3 <= len(s):
            try:
                out.append(chr(int(s[i + 1:i + 3], 16)))
                i += 3
                continue
            except ValueError:
                pass
        out.append(s[i])
        i += 1
    return "".join(out)


def partition_spec_of(path: str) -> List[Tuple[str, Optional[str]]]:
    """Ordered (key, value) pairs of a path's Hive-style components."""
    spec = []
    for comp in os.path.dirname(path).split(os.sep):
        if "=" in comp and not comp.startswith("."):
            k, _, v = comp.partition("=")
            spec.append((k, _unescape_partition_value(v)))
    return spec


def _infer_partition_type(values: Iterable[Optional[str]]) -> T.DataType:
    """Spark's partition value type inference: long, then double, then
    string."""
    saw_any = False
    all_long = all_double = True
    for v in values:
        if v is None:
            continue
        saw_any = True
        try:
            int(v)
        except ValueError:
            all_long = False
            try:
                float(v)
            except ValueError:
                all_double = False
    if not saw_any:
        return T.STRING
    if all_long:
        return T.LONG
    if all_double:
        return T.DOUBLE
    return T.STRING


def coalesce_batches(batches: Iterable[HostTable], target_bytes: int
                     ) -> Iterator[HostTable]:
    """Accumulate host batches until the byte target, then concatenate:
    the one stitching loop behind every COALESCING reader."""
    pending: List[HostTable] = []
    pending_bytes = 0
    for t in batches:
        pending.append(t)
        pending_bytes += t.nbytes()
        if pending_bytes >= target_bytes:
            yield concat_host(pending)
            pending, pending_bytes = [], 0
    if pending:
        yield concat_host(pending)


def _const_string(n: int, value: str) -> HostColumn:
    """An n-row string column of one value, its codes seeded."""
    data = np.empty(n, dtype=object)
    data[:] = value
    col = HostColumn(T.STRING, data)
    col._cache["encode"] = (np.zeros(n, dtype=np.int32),
                            np.array([value] if n else [], dtype=object))
    return col


class FileScanNode(PlanNode):
    """Base scan node. Subclasses implement ``file_schema`` and
    ``read_file`` (one file's data columns); COALESCING may stitch at a
    finer grain (Parquet row groups)."""

    format_name = "file"

    #: lazily filled caches and counters of a scan node (footers, inferred
    #: schemas, locks): derived from the paths and options, so the plan
    #: fingerprint (plan/fingerprint.py) leaves them out, and a DataFrame
    #: keeps its fingerprint once it has run
    FINGERPRINT_SKIP = ("_lock", "_footers", "_tails", "_inferred",
                        "_strptime", "pruned_row_groups", "_schema",
                        "_data_schema", "_partition_schema")

    def __init__(self, paths: Sequence[str], conf: C.RapidsConf,
                 columns: Optional[Sequence[str]] = None,
                 reader_type: Optional[str] = None, **options):
        self.paths = expand_paths(paths)
        self.conf = conf
        self.columns = list(columns) if columns else None
        self.options = options
        self.reader_type = (reader_type or self._conf_reader_type()).upper()
        self._schema: Optional[Schema] = None
        self._data_schema: Optional[Schema] = None
        self._partition_schema: Optional[Schema] = None

    # -- subclass surface ---------------------------------------------------
    def _conf_reader_type(self) -> str:
        return ReaderMode.AUTO

    def file_schema(self, path: str) -> Schema:
        raise NotImplementedError

    def read_file(self, path: str) -> HostTable:
        """One file's data columns (the driver loop appends the partition
        columns)."""
        raise NotImplementedError

    def with_columns(self, columns: Sequence[str]) -> "FileScanNode":
        """A copy of this scan reading only ``columns`` (column pruning,
        overrides/pruning.py)."""
        import copy
        out = copy.copy(self)
        out.columns = list(columns)
        out._schema = out._data_schema = out._partition_schema = None
        return out

    # -- schema -------------------------------------------------------------
    def _resolve_schemas(self):
        if self._schema is not None:
            return
        data_schema = self.file_schema(self.paths[0])
        data_names = {n for n, _ in data_schema}
        # partition columns from Hive-style dirs, in first-seen key order
        part_values: dict = {}
        for p in self.paths:
            for k, v in partition_spec_of(p):
                if k not in data_names:
                    part_values.setdefault(k, []).append(v)
        part_schema = [(k, _infer_partition_type(vs))
                       for k, vs in part_values.items()]
        full = data_schema + part_schema
        if self.columns is not None:
            by_name = dict(full)
            for c in self.columns:
                if c not in by_name:
                    raise ColumnarProcessingError(
                        f"column {c!r} not in {[n for n, _ in full]}")
            full = [(c, by_name[c]) for c in self.columns]
            data_schema = [(n, dt) for n, dt in data_schema
                           if n in set(self.columns)]
            part_schema = [(n, dt) for n, dt in part_schema
                           if n in set(self.columns)]
        self._schema = full
        self._data_schema = data_schema
        self._partition_schema = part_schema

    #: set by overrides/input_file.py when the plan reads
    #: input_file_name()/input_file_block_*(): every batch gains the hidden
    #: per-row provenance columns
    provide_file_info: bool = False

    def enable_file_info(self) -> None:
        self.provide_file_info = True

    def _attach_file_info(self, table: HostTable, path: str) -> HostTable:
        if not self.provide_file_info:
            return table
        from spark_rapids_tpu_torch.ops.inputfile import (
            FILE_LENGTH_COL,
            FILE_NAME_COL,
            FILE_START_COL,
        )
        if FILE_NAME_COL in table.names:
            return table  # a chunk already stamped
        n = table.num_rows
        try:
            size = os.path.getsize(path)
            start = 0
        except OSError:
            # unreadable between decode and stamping: Spark's no-info pair
            size = start = -1
        cols = list(table.columns) + [
            _const_string(n, path),
            HostColumn(T.LONG, np.full(n, start, dtype=np.int64)),
            HostColumn(T.LONG, np.full(n, size, dtype=np.int64))]
        return HostTable(
            list(table.names) + [FILE_NAME_COL, FILE_START_COL,
                                 FILE_LENGTH_COL], cols)

    def output_schema(self) -> Schema:
        self._resolve_schemas()
        if self.provide_file_info:
            from spark_rapids_tpu_torch.ops.inputfile import (
                FILE_LENGTH_COL,
                FILE_NAME_COL,
                FILE_START_COL,
            )
            return list(self._schema) + [
                (FILE_NAME_COL, T.STRING), (FILE_START_COL, T.LONG),
                (FILE_LENGTH_COL, T.LONG)]
        return self._schema

    @property
    def data_schema(self) -> Schema:
        """The columns read from file contents (after pruning)."""
        self._resolve_schemas()
        return self._data_schema

    def _with_partition_columns(self, table: HostTable, path: str
                                ) -> HostTable:
        """Append the partition-value columns (and, when enabled, the
        input-file provenance columns) in the output schema's order."""
        self._resolve_schemas()
        if not self._partition_schema:
            return self._attach_file_info(table, path)
        spec = dict(partition_spec_of(path))
        n = table.num_rows
        names = list(table.names)
        cols = list(table.columns)
        for name, dt in self._partition_schema:
            raw = spec.get(name)
            if raw is None:
                validity = np.zeros(n, dtype=np.bool_)
                if isinstance(dt, T.StringType):
                    data = np.full(n, None, dtype=object)
                else:
                    data = np.zeros(n, dtype=dt.np_dtype)
                col = HostColumn(dt, data, validity)
            elif isinstance(dt, T.StringType):
                col = _const_string(n, raw)
            elif isinstance(dt, T.DoubleType):
                col = HostColumn(dt, np.full(n, float(raw), dtype=np.float64))
            else:
                col = HostColumn(dt, np.full(n, int(raw), dtype=np.int64))
            names.append(name)
            cols.append(col)
        by_name = dict(zip(names, cols))
        out_names = [nm for nm, _ in self._schema]
        out = HostTable(out_names, [by_name[nm] for nm in out_names])
        return self._attach_file_info(out, path)

    def _effective_paths(self, dynamic_prunes) -> List[str]:
        """The file list after dynamic partition pruning
        (GpuFileSourceScanExec partitionFilters with a
        DynamicPruningExpression). ``dynamic_prunes`` is a list of
        (partition column name, provider), where ``provider()`` gives the
        set of allowed values; it is execution-scoped state owned by the
        calling exec (``execs/basic.py::TpuFileScanExec``), never by this
        shared plan node, so a prune does not leak into another query
        over the same scan. A null partition is kept; a raw partition
        value converts by the column's inferred type before the
        membership test."""
        paths = list(self.paths)
        if not dynamic_prunes:
            return paths
        self._resolve_schemas()
        part_types = dict(self._partition_schema or [])
        for part_col, provider in dynamic_prunes:
            dt = part_types.get(part_col)
            if dt is None:
                continue
            allowed = provider()
            kept = []
            for p in paths:
                raw = dict(partition_spec_of(p)).get(part_col)
                if raw is None:
                    kept.append(p)  # a null partition: kept (null-safe)
                    continue
                if isinstance(dt, T.StringType):
                    val = raw
                elif isinstance(dt, T.DoubleType):
                    val = float(raw)
                else:
                    val = int(raw)
                if val in allowed:
                    kept.append(p)
            paths = kept
        return paths

    # -- reading --------------------------------------------------------------
    def execute_host(self, dynamic_prunes=None,
                     metrics: Optional[dict] = None) -> Iterator[HostTable]:
        """The decoded host batches in file order, in the reader mode,
        over the files ``dynamic_prunes`` keeps (``dppPrunedFiles`` and
        ``dppScannedFiles`` into ``metrics`` when it prunes); one empty
        batch of the output schema when it keeps none."""
        paths = self._effective_paths(dynamic_prunes)
        if metrics is not None and dynamic_prunes:
            metrics["dppPrunedFiles"] = len(self.paths) - len(paths)
            metrics["dppScannedFiles"] = len(paths)
        if not paths:
            from spark_rapids_tpu_torch.columnar.table import (
                empty_host_table,
            )
            return iter([empty_host_table(self.output_schema())])
        mode = self.reader_type
        if mode == ReaderMode.AUTO:
            mode = (ReaderMode.MULTITHREADED if len(paths) > 1
                    else ReaderMode.PERFILE)
        if mode == ReaderMode.PERFILE:
            return self._perfile(paths)
        if mode == ReaderMode.COALESCING:
            return coalesce_batches(
                self._coalescing_chunks(paths),
                self.conf.get_entry(C.READER_COALESCE_TARGET_BYTES))
        if mode == ReaderMode.MULTITHREADED:
            return self._multithreaded(paths)
        raise ColumnarProcessingError(f"unknown reader type {mode}")

    def collect_host(self) -> HostTable:
        """Every row of the scan in one host table."""
        return concat_host(list(self.execute_host()))

    def _cache_key_extra(self) -> tuple:
        """Subclasses add every decode-affecting option here."""
        return ()

    def _cache_key(self) -> tuple:
        return (type(self).__name__, tuple(self.columns or ()),
                tuple(sorted((k, str(v)) for k, v in self.options.items())),
                self._cache_key_extra())

    def _read_decoded(self, path: str) -> HostTable:
        from spark_rapids_tpu_torch.io.filecache import FILE_CACHE
        from spark_rapids_tpu_torch.runtime.faults import fault_point
        fault_point("io.read.file")
        if not self.conf.get_entry(C.FILECACHE_ENABLED):
            return self.read_file(path)
        return FILE_CACHE.get_or_decode(
            path, self._cache_key(), lambda: self.read_file(path),
            self.conf.get_entry(C.FILECACHE_MAX_BYTES))

    def _read_with_partitions(self, path: str) -> HostTable:
        return self._with_partition_columns(self._read_decoded(path), path)

    def _perfile(self, paths) -> Iterator[HostTable]:
        for p in paths:
            yield self._read_with_partitions(p)

    def _coalescing_chunks(self, paths) -> Iterator[HostTable]:
        """The chunk stream the COALESCING stitcher takes: whole files by
        default; formats with a finer grain override it."""
        return self._perfile(paths)

    def _multithreaded(self, paths) -> Iterator[HostTable]:
        """Ordered prefetch with a bounded in-flight window: at most about
        twice the pool's size of files decode ahead of the consumer, so
        host memory stays bounded and a consumer that stops early (a
        LIMIT) does not decode the whole dataset."""
        nthreads = max(1, self.conf.get_entry(
            C.MULTITHREADED_READ_NUM_THREADS))
        window = min(len(paths), nthreads * 2)
        with cf.ThreadPoolExecutor(
                max_workers=min(nthreads, len(paths))) as pool:
            futures = {}
            next_submit = 0
            try:
                for i in range(len(paths)):
                    while next_submit < len(paths) and \
                            next_submit < i + window:
                        futures[next_submit] = pool.submit(
                            self._read_with_partitions, paths[next_submit])
                        next_submit += 1
                    yield futures.pop(i).result()
            finally:
                for f in futures.values():
                    f.cancel()

    def describe(self):
        return (f"{type(self).__name__}[{len(self.paths)} files, "
                f"{self.reader_type}]")


def row_carrier_table(n: int) -> HostTable:
    """A one-column table carrying only a row count, for a read that needs
    no data column (only Hive partition columns): the count still comes
    from the file, and ``_with_partition_columns`` drops the carrier."""
    return HostTable(["__rows__"], [
        HostColumn(T.LONG, np.zeros(n, dtype=np.int64))])
