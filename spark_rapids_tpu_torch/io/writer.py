"""Dynamic-partitioning writer (port of ``spark_rapids_tpu/io/writer.py``;
reference: GpuFileFormatDataWriter).

Rows route to files under Hive-style ``key=value/`` directories (a null
key is ``__HIVE_DEFAULT_PARTITION__``); an unpartitioned write makes one
``part-00000`` file. Every file is written to a
:mod:`~spark_rapids_tpu_torch.io.committer` staging path, never to its
final destination, so a failure mid-write leaves debris only under
``_temporary/`` (which scans skip). With an external ``committer``
(``WriteFiles`` owns the job) this function only stages; a standalone call
runs the whole task-commit and job-commit protocol itself and returns the
final paths."""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np

from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.errors import ColumnarProcessingError


def _escape_partition_value(v) -> str:
    if v is None:
        return "__HIVE_DEFAULT_PARTITION__"
    s = str(v)
    out = []
    for ch in s:
        if ch in '\\/:*?"<>|\x7f' or ord(ch) < 32 or ch in "%=":
            out.append("%{:02X}".format(ord(ch)))
        else:
            out.append(ch)
    return "".join(out)


def _partition_groups(key_cols: Sequence[HostColumn], n: int):
    """[(key tuple, row indices)] in first-seen order of the key tuples,
    found by numpy on each key column's codes (no loop over rows)."""
    if n == 0:
        return []
    parts = []
    for c in key_cols:
        data = np.where(c.validity, c.data, "" if c.data.dtype == object
                        else 0)
        if data.dtype == object:
            uniq, inv = np.unique(data.astype(str), return_inverse=True)
        else:
            uniq, inv = np.unique(data, return_inverse=True)
        inv = inv.reshape(-1).astype(np.int64)
        # null is a key of its own, after every value
        inv = np.where(c.validity, inv, len(uniq))
        parts.append((uniq, inv, len(uniq) + 1))
    combined = np.zeros(n, dtype=np.int64)
    for _, inv, card in parts:
        combined = combined * card + inv
    keys, first, group = np.unique(combined, return_index=True,
                                   return_inverse=True)
    group = group.reshape(-1)
    out = []
    for g in np.argsort(first, kind="stable"):
        rows = np.flatnonzero(group == g)
        r0 = rows[0]
        key = tuple(None if not c.validity[r0] else
                    (c.data[r0].item() if isinstance(c.data[r0], np.generic)
                     else c.data[r0])
                    for c in key_cols)
        out.append((key, rows))
    return out


def write_partitioned(table: HostTable, path: str,
                      write_one: Callable[[HostTable, str], None],
                      extension: str,
                      partition_by: Optional[Sequence[str]] = None,
                      committer=None,
                      ) -> List[str]:
    """Route rows to files through the transactional committer; returns
    the files written (final paths when this call owns the job, staged
    paths when the caller passed its own ``committer`` and commits the
    task and the job itself)."""
    from spark_rapids_tpu_torch.io.committer import WriteJob
    from spark_rapids_tpu_torch.runtime.faults import fault_point
    os.makedirs(path, exist_ok=True)
    job = committer if committer is not None else WriteJob(path)
    own_job = committer is None

    def _finish(staged: List[str]) -> List[str]:
        if not own_job:
            return staged
        final = job.commit_task()
        job.commit_job(num_rows=table.num_rows)
        return final

    try:
        if not partition_by:
            rel = f"part-00000.{extension}"
            fault_point("io.write.file")
            staged_path = job.stage_path(rel)
            write_one(table, staged_path)
            return _finish([staged_path])

        for k in partition_by:
            if k not in table.names:
                raise ColumnarProcessingError(
                    f"partition column {k!r} not in table")
        data_names = [n for n in table.names if n not in partition_by]
        key_cols = [table.columns[table.names.index(k)]
                    for k in partition_by]
        staged: List[str] = []
        for file_idx, (key_tuple, idx) in enumerate(
                _partition_groups(key_cols, table.num_rows)):
            sub_cols = []
            for name in data_names:
                c = table.columns[table.names.index(name)]
                sub_cols.append(HostColumn(c.dtype, c.data[idx],
                                           c.validity[idx]))
            sub = HostTable(data_names, sub_cols)
            rel = os.path.join(*[
                f"{k}={_escape_partition_value(v)}"
                for k, v in zip(partition_by, key_tuple)],
                f"part-{file_idx:05d}.{extension}")
            # the fault point fires on every file, partitioned writes
            # included
            fault_point("io.write.file")
            staged_path = job.stage_path(rel)
            write_one(sub, staged_path)
            staged.append(staged_path)
        return _finish(staged)
    except BaseException:
        if own_job:
            job.abort()
        raise
