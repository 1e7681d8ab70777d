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

import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import nested as N
from spark_rapids_tpu_torch.columnar.column import (
    DeviceColumn,
    HostColumn,
    bucket_for,
)
from spark_rapids_tpu_torch.errors import ColumnarProcessingError


class HostTable:
    """Named host columns with a shared row count. ``_cache`` holds derived
    artifacts, notably the uploaded device image (execs/basic.TpuScanExec)."""

    __slots__ = ("names", "columns", "_cache", "__weakref__")

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

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def column(self, name: str) -> HostColumn:
        return self.columns[self.names.index(name)]

    @staticmethod
    def from_pydict(data, dtypes=None) -> "HostTable":
        """``{name: values}`` (lists or numpy arrays) as a table, each
        column through ``HostColumn.from_pylist`` with its ``dtypes``
        entry."""
        return HostTable(list(data), [
            HostColumn.from_pylist(v, (dtypes or {}).get(n))
            for n, v in data.items()])

    def to_pydict(self) -> dict:
        return {n: c.to_pylist() for n, c in zip(self.names, self.columns)}

    @staticmethod
    def concat(tables: Sequence["HostTable"]) -> "HostTable":
        """Tables of one schema one after another (``concat_host``)."""
        if not tables:
            raise ColumnarProcessingError("concat of zero tables")
        return concat_host(list(tables))

    def slice(self, start: int, length: int) -> "HostTable":
        return HostTable(self.names,
                         [c.slice(start, length) for c in self.columns])

    def take(self, rows: np.ndarray) -> "HostTable":
        """The table at ``rows`` (an index array), as ``HostColumn.take``."""
        return HostTable(self.names, [c.take(rows) for c in self.columns])

    def nbytes(self) -> int:
        return sum(c.nbytes() for c in self.columns)

    def to_arrays(self):
        """(names, type names, [(data, validity)...]) as plain numpy — the
        form interop.host_table_from_arrays takes back."""
        return (list(self.names),
                [c.dtype.simple_string() for c in self.columns],
                [(np.asarray(c.data) if isinstance(c.data, N.NestedData)
                  else c.data, c.validity) for c in self.columns])


class DeviceTable:
    """Named device columns padded to a common capacity bucket.

    ``nrows`` may be a host int or a 0-d int32 tensor on the device;
    ``num_rows`` reads it on the host (a sync for a device count)."""

    __slots__ = ("names", "columns", "nrows_dev", "_nrows_host", "capacity",
                 "live", "device", "split_group", "__weakref__")

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

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def schema(self) -> List[Tuple[str, T.DataType]]:
        return [(n, c.dtype) for n, c in zip(self.names, self.columns)]

    def column(self, name: str) -> DeviceColumn:
        return self.columns[self.names.index(name)]

    def device_nbytes(self) -> int:
        """Bytes of the columns' data and validity tensors, from tensor
        metadata (no device work): the size the sort's out-of-core
        threshold, the join's sub-partitioning and the coalesce's target
        compare."""
        return sum(c.device_nbytes() for c in self.columns)

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
        for n, c in zip(self.names, self.columns):
            if c.is_nested:
                # nested columns live in prefix batches only: the plan's
                # tag sends a filter, sort, join, window or exchange over
                # one to the CPU route (overrides/rules.py)
                raise ColumnarProcessingError(
                    f"masked rows of nested column {n}: a masked batch "
                    "holds flat columns only")
        from spark_rapids_tpu_torch.ops.scatter32 import compact_pairs
        outs, new_n = compact_pairs([c.data for c in self.columns],
                                    [c.validity for c in self.columns],
                                    self.live, self.capacity)
        cols = [c.with_arrays(d, v) for c, (d, v) in zip(self.columns, outs)]
        out = DeviceTable(self.names, cols, new_n, self.capacity, self.device)
        out._nrows_host = self._nrows_host
        return out

    def shrink(self, copy: bool = False) -> "DeviceTable":
        """Re-bucket to the smallest capacity holding the live rows (reads
        the row count on the host); ``copy`` as in
        ``DeviceColumn.sliced_rows``."""
        if self.live is not None:
            return self.compacted().shrink(copy)
        n = self.num_rows
        k = bucket_for(max(n, 1))
        if k >= self.capacity:
            return self
        return DeviceTable(self.names, [c.sliced_rows(k, copy)
                                        for c in self.columns], n, k,
                           self.device)

    def to_host(self) -> HostTable:
        if self.live is not None:
            return self.compacted().to_host()
        n = self.num_rows
        return HostTable(self.names, [c.to_host(n) for c in self.columns])


#: byte alignment of each stream inside a pinned staging buffer
_STAGE_ALIGN = 16


class PendingHostTable:
    """An ENQUEUED download (port of the reference's PendingHostTable,
    ``columnar/table.py:531``): every column's data and validity are
    being copied with ``non_blocking`` into pinned staging buffers of the
    pinned pool (runtime/host_alloc.py), and a CUDA event marks the end of
    the copies on the stream that enqueued them. :meth:`resolve` waits on
    that event before any byte is read, decodes the HostTable and returns
    the buffers to the pool. Reading a buffer before the event completes
    would give stale bytes."""

    __slots__ = ("_table", "_n", "_parts", "_event", "_bufs", "_pool",
                 "_resolved")

    def __init__(self, table: "DeviceTable", n: int, parts, event, bufs,
                 pool):
        #: keeps the device buffers alive until the copies completed
        self._table = table
        self._n = n
        #: per column, its buffers' (stream, shape), the validity's last
        #: (``DeviceColumn.host_leaves``): a stream is (dtype, [(buffer
        #: index, byte offset, element count)])
        self._parts = parts
        self._event = event
        self._bufs = bufs
        self._pool = pool
        self._resolved = False

    def resolve(self) -> HostTable:
        if self._resolved:
            raise ColumnarProcessingError("PendingHostTable resolved twice")
        self._resolved = True
        try:
            if self._event is not None:
                self._event.synchronize()
            t = self._table
            cols = []
            for c, streams in zip(t.columns, self._parts):
                cols.append(c.decode_leaves(
                    [self._gather(st).reshape(shape)
                     for st, shape in streams]))
            return HostTable(t.names, cols)
        finally:
            for b in self._bufs:
                self._pool.release(b)
            self._bufs = []
            self._table = None

    def _gather(self, stream) -> np.ndarray:
        """One stream's elements out of the staging buffers, as a numpy
        array of its own (the buffers go back to the pool)."""
        dtype, parts = stream
        arrays = [self._bufs[bi][off:off + cnt * dtype.itemsize]
                  .view(dtype).numpy() for bi, off, cnt in parts]
        if not arrays:
            return torch.empty(0, dtype=dtype).numpy()
        return np.concatenate(arrays) if len(arrays) > 1 \
            else arrays[0].copy()


def enqueue_download(table: "DeviceTable", pool
                     ) -> Optional[PendingHostTable]:
    """Enqueue ``table``'s download into ``pool``'s pinned buffers (the
    reference's ``to_host_pending``), or None when the pool cannot hold
    it (the caller downloads synchronously). Reads the row count first,
    as the synchronous download does."""
    if table.live is not None:
        table = table.compacted()
    n = table.num_rows
    # the element counts of the nested columns, in one host read beside
    # the row count's
    tots = [N.element_total(c.data, n) if c.is_nested else None
            for c in table.columns]
    read = [t for t in tots if t is not None]
    got = iter(torch.stack(read).tolist() if read else [])
    totals = [None if t is None else next(got) for t in tots]
    streams, per_col = [], []
    for c, total in zip(table.columns, totals):
        leaves = [x.contiguous() for x in c.host_leaves(n, total)]
        per_col.append(len(leaves))
        streams.extend(leaves)
    # plan the parts first: nothing is copied unless every buffer is had
    size = pool.buffer_bytes
    plan, bi, off = [], 0, 0
    for t in streams:
        es, count, at, parts = t.element_size(), t.numel(), 0, []
        while at < count:
            room = (size - off) // es
            if room <= 0:
                bi, off = bi + 1, 0
                continue
            cnt = min(room, count - at)
            parts.append((bi, off, at, cnt))
            at += cnt
            off += -(-cnt * es // _STAGE_ALIGN) * _STAGE_ALIGN
        plan.append(parts)
    need = bi + 1 if any(plan) else 0
    bufs = []
    for _ in range(need):
        b = pool.acquire(size)
        if b is None:
            for x in bufs:
                pool.release(x)
            return None
        bufs.append(b)
    out = []
    for t, parts in zip(streams, plan):
        flat = t.reshape(-1)
        out.append((t.dtype, []))
        for b, o, at, cnt in parts:
            bufs[b][o:o + cnt * t.element_size()].view(t.dtype).copy_(
                flat[at:at + cnt], non_blocking=True)
            out[-1][1].append((b, o, cnt))
    event = None
    if table.device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(table.device))
    parts, at = [], 0
    for k in per_col:
        parts.append([(out[j], tuple(streams[j].shape))
                      for j in range(at, at + k)])
        at += k
    return PendingHostTable(table, n, parts, event, bufs, pool)


def concat_host(tables: Sequence[HostTable]) -> HostTable:
    """Host tables of one schema, one after another. String columns whose
    parts all carry their codes (``HostColumn.encoded``'s cache) keep
    them, remapped into the union of the parts' sorted dictionaries."""
    if len(tables) == 1:
        return tables[0]
    cols = []
    for ci, c0 in enumerate(tables[0].columns):
        parts = [t.columns[ci] for t in tables]
        if isinstance(c0.data, N.NestedData):
            cols.append(HostColumn(
                c0.dtype, N.concat_host([p.data for p in parts]),
                np.concatenate([p.validity for p in parts])))
            continue
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
    """``host`` on ``device`` at its rows' capacity bucket. Each column's
    landing reserves and accounts through the memory arbiter
    (``DeviceColumn.from_host``); the table is accounted over the same
    storages, so its bytes count once."""
    from spark_rapids_tpu_torch.runtime.memory import MEMORY
    n = host.num_rows
    cap = bucket_for(max(n, 1))
    return MEMORY.account(DeviceTable(
        host.names, [DeviceColumn.from_host(c, cap, device)
                     for c in host.columns], n, cap, device))


#: host columns that hold uploaded device images in their ``_cache``
#: (the scan's device cache, execs/basic.TpuScanExec), weakly
_DEVICE_CACHED: "weakref.WeakSet" = weakref.WeakSet()


def register_device_cache(host_column: HostColumn) -> None:
    """Note that ``host_column._cache`` holds a device image, so that
    :func:`evict_device_caches` can drop it under memory pressure."""
    _DEVICE_CACHED.add(host_column)


def evict_device_caches() -> int:
    """Drop every cached device image of the scan (the lowest spill
    priority: it re-uploads from its host column). Each image's bytes
    return to the memory arbiter when the last table using it dies.
    Returns the images dropped."""
    n = 0
    for hc in list(_DEVICE_CACHED):
        keys = [k for k in hc._cache
                if isinstance(k, tuple) and k and k[0] == "device"]
        for k in keys:
            hc._cache.pop(k, None)
        n += len(keys)
        _DEVICE_CACHED.discard(hc)
    return n


def empty_host_table(schema) -> HostTable:
    """A zero-row HostTable of ``schema`` ([(name, DataType)])."""
    cols = [HostColumn(dt, N.empty_host(dt) if N.is_nested_type(dt)
                       else np.zeros(0, dtype=dt.np_dtype),
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
    per-partition views collapse back into ONE masked batch. A batch of
    no split passes at once: holding it while the next one is made would
    keep two batches on the device."""
    cur = []  # the views being merged: at most one table, popped to yield
    for b in batches:
        if cur and mergeable_views(cur[0], b):
            cur[0] = union_views(cur[0], b)
            continue
        if cur:
            yield cur.pop()
        cur.append(b)
        del b
        if cur[0].split_group is None:
            yield cur.pop()
    if cur:
        yield cur.pop()


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
        if c0.is_nested:
            if any(t.live is not None for t in tables):
                raise ColumnarProcessingError(
                    f"masked batches of nested column "
                    f"{tables[0].names[ci]}: a masked batch holds flat "
                    "columns only")
            data, valid = N.concat_device([c.data for c in parts], tgts,
                                          out_cap,
                                          [c.validity for c in parts])
            cols.append(DeviceColumn(c0.dtype, data, valid))
            continue
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
