"""Array, struct and map columns (port of
``spark_rapids_tpu/columnar/nested.py`` and of the array layout of its
``columnar/column.py``).

One representation serves the device and the host: a nested column's
``data`` is a holder of flat buffers (torch tensors on the device, numpy
arrays on the host), never a Python object per row.

* ARRAY -- :class:`ArrayData`: ``offsets`` (rows + 1, int32), the element
  data and the element validity. Null and padding rows own zero elements,
  so the live elements are the prefix ``[0, offsets[-1])``. On the device
  the element buffers have a capacity of their own, ``bucket_for(total)``.
* STRUCT -- :class:`StructData`: one (data, validity) pair per field, at
  the parent's row capacity; the struct's own validity is the column's.
* MAP -- :class:`MapData`: the array layout with two element streams, the
  keys (never null in a built map) and the values with their validity.

Elements and fields are of the fixed-width types (``FIXED_ELEMENT_TYPES``).
A nested type of any other leaves (strings, decimals, arrays of structs
or of arrays) has no layout: its host column holds the reference's object
array of lists, tuples and dicts, and the plan's tag keeps every operator
that would take it to the device on the CPU route (overrides/rules.py).

Every holder lists its buffers (``leaves``) and rebuilds from a list of
the same length (``with_leaves``): the memory ledger, the spill tiers,
the downloads and the row slicers walk those lists, whatever the kind.
Python lists, tuples and dicts exist only in :meth:`NestedData.to_objects`
(``HostColumn.to_pylist``, ``collect()``, comparisons) and in
:func:`from_objects` (a user's rows)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.errors import ColumnarProcessingError

#: element and field types of the nested layouts (fixed width)
FIXED_ELEMENT_TYPES = (T.BooleanType, T.ByteType, T.ShortType,
                       T.IntegerType, T.LongType, T.FloatType, T.DoubleType,
                       T.DateType, T.TimestampType)

NESTED_TYPES = (T.ArrayType, T.StructType, T.MapType)


def is_nested_type(dt) -> bool:
    return isinstance(dt, NESTED_TYPES)


def fixed_np_dtype(dt) -> Optional[np.dtype]:
    """numpy storage of a fixed-width element or field type, else None."""
    if isinstance(dt, FIXED_ELEMENT_TYPES):
        return dt.np_dtype
    return None


def layout_supported(dt) -> bool:
    """Does ``dt`` have a device layout (fixed-width leaves)?"""
    if isinstance(dt, T.ArrayType):
        return fixed_np_dtype(dt.element_type) is not None
    if isinstance(dt, T.StructType):
        return bool(dt.fields) and all(
            fixed_np_dtype(f.data_type) is not None for f in dt.fields)
    if isinstance(dt, T.MapType):
        return (fixed_np_dtype(dt.key_type) is not None
                and fixed_np_dtype(dt.value_type) is not None)
    return False


def check_layout(dt, what: str) -> None:
    if not layout_supported(dt):
        raise ColumnarProcessingError(
            f"{what} of type {dt.simple_string()}: nested layouts hold "
            "fixed-width leaves only")


def _is_torch(x) -> bool:
    return isinstance(x, torch.Tensor)


class NestedData:
    """Base of the holders: a fixed list of flat buffers. On the host a
    holder also reads as the reference's object array: ``data[i]`` is
    row i's list, tuple or dict (the CPU route's per-row code indexes it
    so), and ``data[rows]`` for an index or mask array, or a slice, is
    the holder of those rows."""

    __slots__ = ("_objs",)

    def leaves(self) -> tuple:
        raise NotImplementedError

    def with_leaves(self, leaves: Sequence) -> "NestedData":
        raise NotImplementedError

    def map(self, fn) -> "NestedData":
        """The same holder over ``fn`` of every buffer."""
        return self.with_leaves([fn(x) for x in self.leaves()])

    @property
    def nbytes(self) -> int:
        return int(sum(x.nbytes for x in self.leaves()))

    def __array__(self, dtype=None, copy=None):
        return self.to_objects()

    def objects(self) -> np.ndarray:
        """``to_objects()``, made once per holder."""
        got = getattr(self, "_objs", None)
        if got is None:
            got = self._objs = self.to_objects()
        return got

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            return self.objects()[i]
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step == 1:
                return self.host_slice(start, max(stop - start, 0))
            i = np.arange(start, stop, step)
        rows = np.asarray(i)
        if rows.dtype == np.bool_:
            rows = np.nonzero(rows)[0]
        return self.take(rows)


class _OffsetsData(NestedData):
    """Rows as ranges of an element stream (arrays and maps)."""

    __slots__ = ()

    def __len__(self) -> int:
        return int(self.offsets.shape[0]) - 1

    @property
    def elem_capacity(self) -> int:
        return int(self.leaves()[1].shape[0])

    def elem_leaves(self) -> tuple:
        return self.leaves()[1:]

    def sliced_rows(self, k: int, copy: bool = False) -> "_OffsetsData":
        """The first ``k`` rows: the offsets only, the element buffers are
        shared (with ``copy``, the offsets are a buffer of their own)."""
        off = self.offsets[:k + 1]
        if copy:
            off = off.clone() if _is_torch(off) else off.copy()
        return self.with_leaves((off,) + self.elem_leaves())

    def head(self, n: int, total: int) -> "_OffsetsData":
        """The first ``n`` rows holding ``total`` elements, exactly sized
        (a download's buffers)."""
        return self.with_leaves((self.offsets[:n + 1],) + tuple(
            x[:total] for x in self.elem_leaves()))

    def take(self, rows: np.ndarray) -> "_OffsetsData":
        """The host rows ``rows``, in that order."""
        off = self.offsets.astype(np.int64)
        lens = (off[1:] - off[:-1])[rows]
        new_off = np.zeros(len(rows) + 1, dtype=np.int32)
        new_off[1:] = np.cumsum(lens)
        starts = np.repeat(off[:-1][rows] - new_off[:-1], lens)
        src = np.arange(int(new_off[-1])) + starts
        return self.with_leaves([new_off] + [x[src]
                                             for x in self.elem_leaves()])

    def host_slice(self, start: int, length: int) -> "_OffsetsData":
        off = self.offsets[start:start + length + 1]
        lo, hi = (int(off[0]), int(off[-1])) if len(off) else (0, 0)
        return self.with_leaves(
            ((off - lo).astype(np.int32) if len(off)
             else np.zeros(1, np.int32),)
            + tuple(x[lo:hi] for x in self.elem_leaves()))


class ArrayData(_OffsetsData):
    """An array column's buffers: offsets, element data, element
    validity."""

    __slots__ = ("offsets", "data", "validity")

    def __init__(self, offsets, data, validity):
        self.offsets = offsets
        self.data = data
        self.validity = validity

    def leaves(self) -> tuple:
        return (self.offsets, self.data, self.validity)

    def with_leaves(self, leaves) -> "ArrayData":
        return ArrayData(*leaves)

    def to_objects(self) -> np.ndarray:
        n = len(self)
        out = np.empty(n, dtype=object)
        vals = self.data.astype(object)
        vals[~np.asarray(self.validity, dtype=bool)] = None
        vals = vals.tolist()
        off = self.offsets.tolist()
        for i in range(n):
            out[i] = vals[off[i]:off[i + 1]]
        return out


class MapData(_OffsetsData):
    """A map column's buffers: offsets, keys and their validity, values
    and their validity."""

    __slots__ = ("offsets", "kdata", "kvalid", "vdata", "vvalid")

    def __init__(self, offsets, kdata, kvalid, vdata, vvalid):
        self.offsets = offsets
        self.kdata = kdata
        self.kvalid = kvalid
        self.vdata = vdata
        self.vvalid = vvalid

    def leaves(self) -> tuple:
        return (self.offsets, self.kdata, self.kvalid, self.vdata,
                self.vvalid)

    def with_leaves(self, leaves) -> "MapData":
        return MapData(*leaves)

    def to_objects(self) -> np.ndarray:
        n = len(self)
        out = np.empty(n, dtype=object)
        if not np.asarray(self.kvalid, dtype=bool).all():
            # a null key expression reached a map entry: Spark raises at
            # evaluation, the device cannot, so it raises here (the
            # reference's map_to_host)
            raise ColumnarProcessingError("Cannot use null as map key")
        keys = self.kdata.tolist()
        vals = self.vdata.astype(object)
        vals[~np.asarray(self.vvalid, dtype=bool)] = None
        vals = vals.tolist()
        off = self.offsets.tolist()
        for i in range(n):
            s, e = off[i], off[i + 1]
            out[i] = dict(zip(keys[s:e], vals[s:e]))
        return out


class StructData(NestedData):
    """A struct column's buffers: one (data, validity) pair per field, at
    the parent's row count."""

    __slots__ = ("fields",)

    def __init__(self, fields):
        self.fields = tuple((d, v) for d, v in fields)

    def leaves(self) -> tuple:
        return tuple(x for pair in self.fields for x in pair)

    def with_leaves(self, leaves) -> "StructData":
        it = list(leaves)
        return StructData([(it[i], it[i + 1])
                           for i in range(0, len(it), 2)])

    def __len__(self) -> int:
        return int(self.fields[0][0].shape[0])

    def sliced_rows(self, k: int, copy: bool = False) -> "StructData":
        if copy:
            return self.map(lambda x: x[:k].clone() if _is_torch(x)
                            else x[:k].copy())
        return self.map(lambda x: x[:k])

    def head(self, n: int, total: int = 0) -> "StructData":
        return self.map(lambda x: x[:n])

    def take(self, rows: np.ndarray) -> "StructData":
        return self.map(lambda x: x[rows])

    def host_slice(self, start: int, length: int) -> "StructData":
        return self.map(lambda x: x[start:start + length])

    def to_objects(self) -> np.ndarray:
        n = len(self)
        cols = []
        for d, v in self.fields:
            vals = d.astype(object)
            vals[~np.asarray(v, dtype=bool)] = None
            cols.append(vals.tolist())
        out = np.empty(n, dtype=object)
        for i, row in enumerate(zip(*cols)):
            out[i] = row
        return out


# ---------------------------------------------------------------------------
# host converters
# ---------------------------------------------------------------------------

def _item(v):
    return v.item() if isinstance(v, np.generic) else v


def _to_internal(dt, v):
    """A Python element value in its storage form (dates as days, times as
    microseconds, as the reference's host arrays hold them)."""
    import datetime as _dt
    if isinstance(v, _dt.datetime):
        return int((v - _dt.datetime(1970, 1, 1)).total_seconds() * 10**6)
    if isinstance(v, _dt.date):
        return (v - _dt.date(1970, 1, 1)).days
    return v


def _flat(dt, values: List, n: int):
    """(data, validity) numpy of ``values`` (None = null) of type ``dt``."""
    npdt = fixed_np_dtype(dt)
    valid = np.fromiter((v is not None for v in values), dtype=np.bool_,
                        count=n)
    data = np.zeros(n, dtype=npdt)
    if n:
        data[valid] = [_to_internal(dt, v) for v in values if v is not None]
    return data, valid


def from_objects(dtype, objs, validity) -> NestedData:
    """The host holder of a column given as one Python object per row
    (lists for arrays, tuples or dicts for structs, dicts or (key, value)
    lists for maps); null rows own nothing."""
    check_layout(dtype, "a host column")
    n = len(objs)
    ok = np.asarray(validity, dtype=bool)
    rows = [objs[i] if ok[i] and objs[i] is not None else None
            for i in range(n)]
    if isinstance(dtype, T.StructType):
        fields = []
        for fi, f in enumerate(dtype.fields):
            vals = [None if r is None else (
                r.get(f.name) if isinstance(r, dict) else r[fi])
                for r in rows]
            fields.append(_flat(f.data_type, vals, n))
        return StructData(fields)
    lengths = np.fromiter((0 if r is None else len(r) for r in rows),
                          dtype=np.int64, count=n)
    offsets = np.zeros(n + 1, dtype=np.int32)
    offsets[1:] = np.cumsum(lengths)
    total = int(offsets[-1])
    if isinstance(dtype, T.ArrayType):
        elems = [v for r in rows if r is not None for v in r]
        d, v = _flat(dtype.element_type, elems, total)
        return ArrayData(offsets, d, v)
    pairs = [kv for r in rows if r is not None
             for kv in (r.items() if isinstance(r, dict) else r)]
    kd, kv = _flat(dtype.key_type, [p[0] for p in pairs], total)
    vd, vv = _flat(dtype.value_type, [p[1] for p in pairs], total)
    if not kv.all():
        raise ColumnarProcessingError("Cannot use null as map key")
    return MapData(offsets, kd, kv, vd, vv)


def empty_host(dtype):
    """A zero-row host holder of ``dtype`` (an empty object array for a
    type without a layout)."""
    if not layout_supported(dtype):
        return np.empty(0, dtype=object)
    return from_objects(dtype, np.empty(0, dtype=object),
                        np.zeros(0, dtype=bool))


def concat_host(parts: Sequence[NestedData]) -> NestedData:
    """Host holders of one type, one after another."""
    p0 = parts[0]
    if isinstance(p0, StructData):
        return p0.with_leaves([np.concatenate([p.leaves()[i] for p in parts])
                               for i in range(len(p0.leaves()))])
    offs, base = [np.zeros(1, np.int32)], 0
    for p in parts:
        offs.append((p.offsets[1:] - p.offsets[0] + base).astype(np.int32))
        base += int(p.offsets[-1] - p.offsets[0])
    elems = [np.concatenate([x[int(p.offsets[0]):int(p.offsets[-1])]
                             for p, x in zip(parts, col)])
             for col in zip(*[p.elem_leaves() for p in parts])]
    return p0.with_leaves([np.concatenate(offs)] + elems)


# ---------------------------------------------------------------------------
# device landings and downloads
# ---------------------------------------------------------------------------

def _pad(a: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=a.dtype)
    out[:len(a)] = a
    return out


def upload(host: NestedData, validity: np.ndarray, capacity: int,
           device) -> NestedData:
    """A host holder of ``len(host)`` rows on ``device`` at ``capacity``
    rows; array and map elements at ``bucket_for(total)``. Null rows'
    elements are dropped first (the layout's invariant: only valid rows
    own elements)."""
    from spark_rapids_tpu_torch.columnar.column import bucket_for
    n = len(host)
    dev = torch.device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if isinstance(host, StructData):
        return StructData([(put(_pad(d, capacity)),
                            put(_pad(v & validity[:n], capacity)))
                           for d, v in host.fields])
    host = drop_null_rows(host, validity)
    off = host.offsets.astype(np.int32)
    total = int(off[-1])
    ecap = bucket_for(max(total, 1))
    offsets = np.full(capacity + 1, total, dtype=np.int32)
    offsets[:n + 1] = off
    return host.with_leaves([put(offsets)] + [
        put(_pad(x, ecap)) for x in host.elem_leaves()])


def drop_null_rows(host: _OffsetsData, validity) -> _OffsetsData:
    """``host`` with the elements of its null rows removed (their rows
    keep zero elements)."""
    ok = np.asarray(validity[:len(host)], dtype=bool)
    off = host.offsets
    lens = np.diff(off)
    if ok.all() or not lens[~ok].any():
        if int(off[0]) == 0:
            return host
    keep_rows = ok & (lens > 0)
    rid = np.repeat(np.arange(len(host)), lens)
    keep = keep_rows[rid]
    new_lens = np.where(ok, lens, 0)
    new_off = np.zeros(len(host) + 1, dtype=np.int32)
    new_off[1:] = np.cumsum(new_lens)
    lo = int(off[0])
    return host.with_leaves([new_off] + [
        x[lo:lo + len(keep)][keep] for x in host.elem_leaves()])


def element_total(data: NestedData, n: int):
    """The element count of the first ``n`` rows: a 0-d device tensor (no
    host read), or None for a struct."""
    if isinstance(data, _OffsetsData):
        return data.offsets[n]
    return None


def download(data: NestedData, n: int, total: int) -> NestedData:
    """The first ``n`` rows (holding ``total`` elements) as a host holder
    (one copy a buffer)."""
    return data.head(n, total).map(
        lambda x: np.ascontiguousarray(x.cpu().numpy()))


# ---------------------------------------------------------------------------
# device helpers shared by the expressions, the aggregate and generate
# ---------------------------------------------------------------------------

def offsets_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """(rows + 1,) int32 offsets from per-row element counts."""
    off = torch.zeros(counts.shape[0] + 1, dtype=torch.int32,
                      device=counts.device)
    off[1:] = torch.cumsum(counts.to(torch.int64), 0).to(torch.int32)
    return off


def concat_device(parts: Sequence[NestedData], tgts, out_cap: int,
                  valids) -> Tuple[NestedData, torch.Tensor]:
    """Prefix tables' nested columns concatenated at the row targets
    ``tgts`` (each table's rows land at the running row offset; ``out_cap``
    drops). Returns (holder, validity)."""
    from spark_rapids_tpu_torch.columnar.column import bucket_for
    dev = tgts[0].device
    ov = torch.zeros(out_cap + 1, dtype=torch.bool, device=dev)
    for v, tgt in zip(valids, tgts):
        ov[tgt] = v
    p0 = parts[0]
    if isinstance(p0, StructData):
        leaves = []
        for li, x0 in enumerate(p0.leaves()):
            o = torch.zeros(out_cap + 1, dtype=x0.dtype, device=dev)
            for p, tgt in zip(parts, tgts):
                o[tgt] = p.leaves()[li]
            leaves.append(o[:out_cap])
        return p0.with_leaves(leaves), ov[:out_cap]
    ecap = bucket_for(sum(p.elem_capacity for p in parts))
    counts = torch.zeros(out_cap + 1, dtype=torch.int64, device=dev)
    elems = [torch.zeros(ecap + 1, dtype=x.dtype, device=dev)
             for x in p0.elem_leaves()]
    ebase = torch.zeros((), dtype=torch.int64, device=dev)
    for p, tgt in zip(parts, tgts):
        off = p.offsets.to(torch.int64)
        counts[tgt] = off[1:] - off[:-1]
        total = off[-1]
        j = torch.arange(p.elem_capacity, dtype=torch.int64, device=dev)
        et = torch.where(j < total, ebase + j, torch.full_like(j, ecap))
        for o, x in zip(elems, p.elem_leaves()):
            o[et] = x
        ebase = ebase + total
    off = offsets_from_counts(counts[:out_cap])
    return (p0.with_leaves([off] + [o[:ecap] for o in elems]),
            ov[:out_cap])
