"""Micro-batch streaming sources (port of
``spark_rapids_tpu/streaming/source.py``).

A source exposes three things: a deterministic ``latest_offset`` (where
the stream COULD read up to right now, given where it is), and a
``read_batch`` that builds a plan over exactly the ``[start, end)`` range
recorded in the offset log. Determinism is the exactly-once contract's
other half: re-running a pending batch over the same recorded offsets
must produce the same rows.

Offsets are JSON-serializable values (ints for rate/CDF, sorted filename
lists for file-watch) so the OffsetLog can persist them verbatim.
"""

from __future__ import annotations

import os
from typing import List, Optional

from spark_rapids_tpu_torch.conf import STREAMING_MAX_FILES_PER_TRIGGER
from spark_rapids_tpu_torch.errors import ColumnarProcessingError

__all__ = ["StreamingSource", "RateSource", "FileWatchSource",
           "DeltaCDFSource"]


class StreamingSource:
    """Contract for micro-batch sources."""

    kind = "source"

    def initial_offset(self):
        """Offset a brand-new stream starts from (exclusive start)."""
        raise NotImplementedError

    def latest_offset(self, start):
        """Furthest offset available now, bounded by per-trigger limits.
        Returning ``start`` (==) means no new data this trigger."""
        raise NotImplementedError

    def read_batch(self, session, start, end):
        """Plan (PlanNode) producing exactly the rows in (start, end]."""
        raise NotImplementedError

    def describe(self) -> dict:
        return {"kind": self.kind}


class RateSource(StreamingSource):
    """Deterministic seeded row generator — the test/bench workhorse.

    Offset = total rows emitted so far. Row ``i`` is a pure function of
    (seed, i), so any replayed range regenerates bit-identical rows.
    Schema: id LONG, value LONG, key LONG.
    """

    kind = "rate"

    def __init__(self, rows_per_batch: int = 100, seed: int = 0,
                 total_rows: Optional[int] = None, num_keys: int = 17):
        if rows_per_batch < 1:
            raise ColumnarProcessingError("rate source: rows_per_batch < 1")
        self.rows_per_batch = int(rows_per_batch)
        self.seed = int(seed)
        self.total_rows = None if total_rows is None else int(total_rows)
        self.num_keys = int(num_keys)

    def initial_offset(self):
        return 0

    def latest_offset(self, start):
        end = int(start) + self.rows_per_batch
        if self.total_rows is not None:
            end = min(end, self.total_rows)
        return max(end, int(start))

    def read_batch(self, session, start, end):
        import numpy as np

        from spark_rapids_tpu_torch import types as T
        from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
        from spark_rapids_tpu_torch.plan import nodes as P
        ids = np.arange(int(start), int(end), dtype=np.int64)
        # Knuth multiplicative hash keyed by the seed: deterministic,
        # replay-stable, and uncorrelated with id for grouping tests
        value = (ids * np.int64(2654435761) + np.int64(self.seed)) % np.int64(1000)
        key = ids % np.int64(self.num_keys)
        table = HostTable(["id", "value", "key"],
                          [HostColumn(T.LONG, v) for v in (ids, value, key)])
        return P.LocalScan([table])

    def describe(self) -> dict:
        return {"kind": self.kind, "rowsPerBatch": self.rows_per_batch,
                "seed": self.seed}


class FileWatchSource(StreamingSource):
    """New files appearing under a directory become the next micro-batch.

    Offset = sorted list of file basenames already consumed. Each trigger
    picks up to ``spark.rapids.streaming.maxFilesPerTrigger`` unseen
    files in sorted order, so a replayed batch re-reads the same files.
    """

    kind = "file-watch"

    def __init__(self, directory: str, conf, fmt: str = "parquet",
                 max_files_per_trigger: Optional[int] = None):
        if fmt != "parquet":
            raise ColumnarProcessingError(
                f"file-watch source supports parquet, not {fmt!r}")
        self.directory = os.path.abspath(directory)
        self.fmt = fmt
        self.conf = conf
        self.max_files = (int(max_files_per_trigger)
                          if max_files_per_trigger is not None
                          else conf.get_entry(STREAMING_MAX_FILES_PER_TRIGGER))

    def initial_offset(self):
        return []

    def _listing(self) -> List[str]:
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(f for f in names if f.endswith("." + self.fmt))

    def latest_offset(self, start):
        seen = set(start)
        new = [f for f in self._listing() if f not in seen][:self.max_files]
        if not new:
            return list(start)
        return sorted(set(start) | set(new))

    def read_batch(self, session, start, end):
        from spark_rapids_tpu_torch.io.parquet import ParquetScanNode
        new = sorted(set(end) - set(start))
        if not new:
            raise ColumnarProcessingError(
                "file-watch read_batch over an empty range")
        paths = [os.path.join(self.directory, f) for f in new]
        return ParquetScanNode(paths, self.conf)

    def describe(self) -> dict:
        return {"kind": self.kind, "directory": self.directory,
                "maxFilesPerTrigger": self.max_files}


class DeltaCDFSource(StreamingSource):
    """Tail a Delta table's change-data feed.

    Offset = last CONSUMED commit version; each batch reads
    ``table_changes(start+1, end)``. ``starting_version`` lets a new
    stream resume from a historical commit epoch (rows of version
    ``starting_version`` itself are NOT re-delivered). The batch keeps
    the CDF metadata columns (``_change_type``, ``_commit_version``) so
    the transform decides what a change means.
    """

    kind = "delta-cdf"

    def __init__(self, table_path: str, starting_version: Optional[int] = None):
        self.table_path = os.path.abspath(table_path)
        self.starting_version = starting_version

    def _log(self):
        from spark_rapids_tpu_torch.delta.log import DeltaLog
        return DeltaLog(self.table_path)

    def initial_offset(self):
        if self.starting_version is not None:
            return int(self.starting_version)
        log = self._log()
        return log.latest_version() if log.exists() else -1

    def latest_offset(self, start):
        log = self._log()
        if not log.exists():
            return int(start)
        return max(int(start), log.latest_version())

    def read_batch(self, session, start, end):
        from spark_rapids_tpu_torch.delta.commands import DeltaTable
        dt = DeltaTable(session, self.table_path)
        return dt.table_changes(int(start) + 1, int(end)).plan

    def describe(self) -> dict:
        return {"kind": self.kind, "tablePath": self.table_path,
                "startingVersion": self.starting_version}
