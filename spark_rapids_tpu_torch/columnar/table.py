"""Host and device tables (port of ``spark_rapids_tpu/columnar/table.py``).

A DeviceTable is the unit that flows between execs: named device columns
padded to one capacity bucket, with the live row count as a 0-d int32
tensor on the device (``nrows_dev``, read on the host only when needed).
A MASKED table (``live`` set) keeps its live rows at their original slots;
``compacted()`` packs them into the prefix through the compaction kernel.
The masked views of one repartition share their buffers and carry the
split's token (``split_group``), so a consumer that re-groups every row
anyway merges them back into one batch (``merge_split_views``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import (
    DeviceColumn,
    HostColumn,
    bucket_for,
)
from spark_rapids_tpu_torch.errors import ColumnarProcessingError


class HostTable:
    """Named host columns with a shared row count. ``_cache`` holds derived
    artifacts, notably the uploaded device image (execs/basic.TpuScanExec)."""

    __slots__ = ("names", "columns", "_cache")

    def __init__(self, names: Sequence[str], columns: Sequence[HostColumn]):
        self.names: Tuple[str, ...] = tuple(names)
        self.columns: Tuple[HostColumn, ...] = tuple(columns)
        self._cache = {}
        if len(self.names) != len(self.columns):
            raise ColumnarProcessingError("names/columns mismatch")
        lens = {len(c) for c in self.columns}
        if len(lens) > 1:
            raise ColumnarProcessingError(f"ragged columns: {lens}")

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    def schema(self) -> List[Tuple[str, T.DataType]]:
        return [(n, c.dtype) for n, c in zip(self.names, self.columns)]

    def slice(self, start: int, length: int) -> "HostTable":
        return HostTable(self.names,
                         [c.slice(start, length) for c in self.columns])

    def nbytes(self) -> int:
        return sum(c.nbytes() for c in self.columns)

    def to_arrays(self):
        """(names, type names, [(data, validity)...]) as plain numpy — the
        form interop.host_table_from_arrays takes back."""
        return (list(self.names),
                [c.dtype.simple_string() for c in self.columns],
                [(c.data, c.validity) for c in self.columns])


class DeviceTable:
    """Named device columns padded to a common capacity bucket.

    ``nrows`` may be a host int or a 0-d int32 tensor on the device;
    ``num_rows`` reads it on the host (a sync for a device count)."""

    __slots__ = ("names", "columns", "nrows_dev", "_nrows_host", "capacity",
                 "live", "device", "split_group")

    def __init__(self, names: Sequence[str], columns: Sequence[DeviceColumn],
                 nrows, capacity: int, device: torch.device, live=None):
        self.names: Tuple[str, ...] = tuple(names)
        self.columns: Tuple[DeviceColumn, ...] = tuple(columns)
        self.live = live
        self.device = torch.device(device)
        #: the token of the split execution this masked view came from
        #: (None: not a split's view); views carrying one token have
        #: DISJOINT masks by construction and may merge
        self.split_group = None
        caps = {c.capacity for c in self.columns}
        if len(caps) > 1:
            raise ColumnarProcessingError(f"ragged capacities {caps}")
        self.capacity = caps.pop() if caps else int(capacity)
        if isinstance(nrows, (int, np.integer)):
            self._nrows_host: Optional[int] = int(nrows)
            self.nrows_dev = torch.tensor(int(nrows), dtype=torch.int32,
                                          device=self.device)
        else:
            self._nrows_host = None
            self.nrows_dev = nrows

    @property
    def num_rows(self) -> int:
        if self._nrows_host is None:
            self._nrows_host = int(self.nrows_dev.item())
        return self._nrows_host

    def row_mask(self) -> torch.Tensor:
        """Bool mask of live rows (no host sync)."""
        if self.live is not None:
            return self.live
        return torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.nrows_dev

    def compacted(self) -> "DeviceTable":
        """Prefix form: live rows moved to [0, nrows) in their order. A
        prefix table returns itself."""
        if self.live is None:
            return self
        from spark_rapids_tpu_torch.ops.scatter32 import compact_pairs
        outs, new_n = compact_pairs([c.data for c in self.columns],
                                    [c.validity for c in self.columns],
                                    self.live, self.capacity)
        cols = [c.with_arrays(d, v) for c, (d, v) in zip(self.columns, outs)]
        out = DeviceTable(self.names, cols, new_n, self.capacity, self.device)
        out._nrows_host = self._nrows_host
        return out

    def shrink(self) -> "DeviceTable":
        """Re-bucket to the smallest capacity holding the live rows (reads
        the row count on the host)."""
        if self.live is not None:
            return self.compacted().shrink()
        n = self.num_rows
        k = bucket_for(max(n, 1))
        if k >= self.capacity:
            return self
        return DeviceTable(self.names, [c.sliced_rows(k)
                                        for c in self.columns], n, k,
                           self.device)

    def to_host(self) -> HostTable:
        if self.live is not None:
            return self.compacted().to_host()
        n = self.num_rows
        return HostTable(self.names, [c.to_host(n) for c in self.columns])


def concat_host(tables: Sequence[HostTable]) -> HostTable:
    """Host tables of one schema, one after another. String columns whose
    parts all carry their codes (``HostColumn.encoded``'s cache) keep
    them, remapped into the union of the parts' sorted dictionaries."""
    if len(tables) == 1:
        return tables[0]
    cols = []
    for ci, c0 in enumerate(tables[0].columns):
        parts = [t.columns[ci] for t in tables]
        col = HostColumn(c0.dtype,
                         np.concatenate([p.data for p in parts]),
                         np.concatenate([p.validity for p in parts]))
        encs = [p._cache.get("encode") for p in parts]
        if isinstance(c0.dtype, T.StringType) and all(
                e is not None for e in encs):
            union = np.unique(np.concatenate(
                [e[1].astype(object) for e in encs]))
            col._cache["encode"] = (np.concatenate(
                [np.searchsorted(union, e[1]).astype(np.int32)[e[0]]
                 if len(e[1]) else e[0] for e in encs]), union)
        cols.append(col)
    return HostTable(tables[0].names, cols)


def upload_host_table(host: HostTable, device) -> DeviceTable:
    """``host`` on ``device`` at its rows' capacity bucket."""
    n = host.num_rows
    cap = bucket_for(max(n, 1))
    return DeviceTable(host.names, [DeviceColumn.from_host(c, cap, device)
                                    for c in host.columns], n, cap, device)


def empty_host_table(schema) -> HostTable:
    """A zero-row HostTable of ``schema`` ([(name, DataType)])."""
    cols = [HostColumn(dt, np.zeros(0, dtype=dt.np_dtype),
                       np.zeros(0, dtype=np.bool_)) for _, dt in schema]
    return HostTable([n for n, _ in schema], cols)


def mergeable_views(a: DeviceTable, b: DeviceTable) -> bool:
    """May two masked views merge by mask union? Requires the SAME device
    buffers AND the same split token: the same buffers alone are not
    enough (two filters of one scan share buffers with OVERLAPPING masks;
    OR-ing those would drop duplicates)."""
    return (a.split_group is not None and a.split_group is b.split_group
            and a.live is not None and b.live is not None
            and a.capacity == b.capacity
            and len(a.columns) == len(b.columns)
            and all(x.data is y.data and x.validity is y.validity
                    for x, y in zip(a.columns, b.columns)))


def union_views(a: DeviceTable, b: DeviceTable) -> DeviceTable:
    """Two views of one split as one: their masks OR-ed, no data moved.
    The masks are disjoint, so the row counts add."""
    out = DeviceTable(a.names, a.columns, a.nrows_dev + b.nrows_dev,
                      a.capacity, a.device, live=a.live | b.live)
    out.split_group = a.split_group
    return out


def merge_split_views(batches):
    """Generator: mask-union consecutive views of one split. For consumers
    that re-group every row anyway (the aggregate), a repartition's k
    per-partition views collapse back into ONE masked batch."""
    cur = None
    for b in batches:
        if cur is not None and mergeable_views(cur, b):
            cur = union_views(cur, b)
        else:
            if cur is not None:
                yield cur
            cur = b
    if cur is not None:
        yield cur


def _union_domain(cols: Sequence[DeviceColumn]):
    doms = [c.domain for c in cols]
    if any(d is None for d in doms):
        return None
    return (min(d[0] for d in doms), max(d[1] for d in doms))


def concat_device(tables: Sequence[DeviceTable]) -> DeviceTable:
    """Concatenate device tables on the device (no host round trip).

    Each table's live rows land at the running offset (the sum of the
    predecessors' live counts, a device scalar); a masked input's deferred
    compaction fuses into that scatter. String columns are remapped into
    the union dictionary first (host work O(dictionary size)). The output
    capacity is the bucket of the capacity sum, a static upper bound."""
    if not tables:
        raise ColumnarProcessingError("concat of zero tables")
    if len(tables) == 1:
        return tables[0]
    dev = tables[0].device
    out_cap = bucket_for(sum(t.capacity for t in tables))
    ncols = len(tables[0].columns)
    # each table's target slot per row (out_cap = dropped)
    tgts = []
    offset = torch.zeros((), dtype=torch.int64, device=dev)
    for t in tables:
        live = t.row_mask()
        pos = torch.cumsum(live.to(torch.int64), 0) - 1 + offset
        tgts.append(torch.where(live, pos, out_cap))
        offset = offset + live.sum(dtype=torch.int64)
    cols: List[DeviceColumn] = []
    for ci in range(ncols):
        parts = [t.columns[ci] for t in tables]
        c0 = parts[0]
        dictionary, dict_sorted = c0.dictionary, c0.dict_sorted
        datas = [c.data for c in parts]
        if isinstance(c0.dtype, T.StringType) and not all(
                c.dictionary is c0.dictionary for c in parts):
            dicts = [c.dictionary if c.dictionary is not None
                     else np.array([], dtype=object) for c in parts]
            dictionary = (np.unique(np.concatenate(
                [d.astype(object) for d in dicts]))
                if any(len(d) for d in dicts) else np.array([], dtype=object))
            dict_sorted = True
            remapped = []
            for c, d in zip(parts, dicts):
                m = (np.searchsorted(dictionary, d).astype(np.int32)
                     if len(d) else np.zeros(1, np.int32))
                m_d = torch.from_numpy(m).to(dev)
                remapped.append(m_d[c.data.clamp(0, len(m) - 1).long()])
            datas = remapped
        od = torch.zeros((out_cap + 1,) + tuple(c0.data.shape[1:]),
                         dtype=c0.data.dtype, device=dev)
        ov = torch.zeros(out_cap + 1, dtype=torch.bool, device=dev)
        for d, c, tgt in zip(datas, parts, tgts):
            od[tgt] = d
            ov[tgt] = c.validity
        cols.append(DeviceColumn(c0.dtype, od[:out_cap], ov[:out_cap],
                                 dictionary=dictionary,
                                 dict_sorted=dict_sorted,
                                 domain=_union_domain(parts)))
    return DeviceTable(tables[0].names, cols, offset.to(torch.int32),
                       out_cap, dev)
