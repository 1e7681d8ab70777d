"""Array expressions and the generator markers (port of
``spark_rapids_tpu/ops/collections.py``).

A device array is an :class:`~spark_rapids_tpu_torch.columnar.nested.
ArrayData`: ``offsets`` (capacity + 1, int32), the element data and the
element validity; null and padding rows own zero elements. Every function
works in element space: each element slot's row id is one
``searchsorted`` over the offsets (:func:`_elem_rids`), per-row results
are segment reductions keyed by it (``index_add_``, and MIN/MAX through
the ``fused_minmax`` kernel, ops/segsum.py::segment_minmax_64), and
``sort_array`` sorts (row id, null flag, value) through the radix sort
kernel (ops/ordering.py::lex_sort). No per-row loop runs anywhere."""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.columnar.nested import (
    FIXED_ELEMENT_TYPES,
    ArrayData,
    MapData,
    offsets_from_counts,
)
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.ops.common import UnaryExpression
from spark_rapids_tpu_torch.ops.expr import DevVal, Expression, Literal


def is_fixed_array(dt) -> bool:
    return (isinstance(dt, T.ArrayType)
            and isinstance(dt.element_type, FIXED_ELEMENT_TYPES))


def check_array(e: Expression, what: str) -> None:
    """Raise unless ``e`` is an array (one of elements without a device
    layout is the plan tag's to route, overrides/rules.py)."""
    dt = e.data_type
    if not isinstance(dt, T.ArrayType):
        raise ColumnarProcessingError(
            f"{what} needs an array, got {dt.simple_string()}")


def _elem_rids(offsets: torch.Tensor, ecap: int, cap: int) -> torch.Tensor:
    """Row id of every element slot (int64); slots past the live prefix
    get ``cap``, an overflow segment callers ignore."""
    j = torch.arange(ecap, dtype=offsets.dtype, device=offsets.device)
    rid = torch.searchsorted(offsets, j, right=True).to(torch.int64) - 1
    return torch.where(j < offsets[-1], rid.clamp(0, cap - 1),
                       torch.full_like(rid, cap))


def seg_count(flag: torch.Tensor, rid: torch.Tensor, cap: int
              ) -> torch.Tensor:
    """Per-row count of the element slots where ``flag`` holds (int32);
    slots with row id ``cap`` count nowhere."""
    out = torch.zeros(cap + 1, dtype=torch.int32, device=flag.device)
    out.index_add_(0, rid, flag.to(torch.int32))
    return out[:cap]


def pack_elements(ctx, keep: torch.Tensor, rid: torch.Tensor,
                  leaves, ecap: int):
    """The element slots where ``keep`` holds, packed into the prefix in
    their order (one compaction kernel launch over every stream), and
    the row offsets of the packed layout. ``leaves``: (data, validity)
    pairs of the element streams. Returns (offsets, [(data, validity)])."""
    from spark_rapids_tpu_torch.ops.scatter32 import compact_pairs
    counts = seg_count(keep, torch.where(keep, rid, ctx.capacity),
                       ctx.capacity)
    pairs, _ = compact_pairs([d for d, _ in leaves], [v for _, v in leaves],
                             keep, ecap)
    return offsets_from_counts(counts), pairs


class Size(UnaryExpression):
    """size(array) -- Spark 3 default (legacy.sizeOfNull=false): null in,
    null out."""

    @property
    def data_type(self):
        return T.INT

    def resolve(self, bound):
        dt = bound[0].data_type
        if isinstance(dt, T.MapType):
            return Size(bound[0])
        check_array(bound[0], "size")
        return Size(bound[0])

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        (c,) = child_vals
        off = c.data.offsets
        return DevVal((off[1:] - off[:-1]).to(torch.int32), c.validity)

    def eval_cpu(self, table: HostTable) -> HostColumn:
        c = self.children[0].eval_cpu(table)
        if isinstance(c.data, (ArrayData, MapData)):
            # flat buffers: the lengths are the offsets' differences
            off = np.asarray(c.data.offsets, dtype=np.int64)
            out = (off[1:] - off[:-1]).astype(np.int32)
            return HostColumn(T.INT, np.where(c.validity, out, 0),
                              c.validity.copy())
        out = np.zeros(len(c), dtype=np.int32)
        for i in range(len(c)):
            if c.validity[i]:
                out[i] = len(c.data[i])
        return HostColumn(T.INT, out, c.validity.copy())


class GetArrayItem(Expression):
    """arr[i] -- 0-based (the reference's ``get_item``/``element_at``);
    out-of-bounds or negative index -> null (AnsiViolation under
    ``spark.sql.ansi.enabled``). Over a map it is the value
    lookup (:class:`~spark_rapids_tpu_torch.ops.nested.GetMapValue`)."""

    def __init__(self, child: Expression, index: Expression):
        self.children = (child, index)

    @property
    def data_type(self):
        return self.children[0].data_type.element_type

    def with_children(self, children):
        return GetArrayItem(children[0], children[1])

    def resolve(self, bound):
        if isinstance(bound[0].data_type, T.MapType):
            from spark_rapids_tpu_torch.ops.nested import GetMapValue
            return GetMapValue(bound[0], bound[1]).resolve(bound)
        check_array(bound[0], "get_item")
        if not isinstance(bound[1].data_type, T.IntegralType):
            raise ColumnarProcessingError("array index must be integral")
        return GetArrayItem(bound[0], bound[1])

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        c, ix = child_vals
        a: ArrayData = c.data
        k = ix.data.to(torch.int64)
        off = a.offsets.to(torch.int64)
        pos = off[:-1] + k
        inb = (k >= 0) & (pos < off[1:])
        if ctx.ansi:
            ctx.ansi_check("array index out of bounds",
                           c.validity & ix.validity & ~inb)
        safe = pos.clamp(0, a.data.shape[0] - 1)
        validity = c.validity & ix.validity & inb & a.validity[safe]
        data = a.data[safe]
        return DevVal(torch.where(validity, data, torch.zeros_like(data)),
                      validity)

    def eval_cpu(self, table):
        from spark_rapids_tpu_torch.dispatch import ANSI_MODE
        from spark_rapids_tpu_torch.errors import AnsiViolation
        c = self.children[0].eval_cpu(table)
        idx = self.children[1].eval_cpu(table)
        ansi = ANSI_MODE.get()
        np_dt = self.data_type.np_dtype
        out = np.zeros(len(c), dtype=np_dt)
        validity = np.zeros(len(c), dtype=np.bool_)
        for i in range(len(c)):
            if c.validity[i] and idx.validity[i]:
                k = int(idx.data[i])
                if 0 <= k < len(c.data[i]):
                    if c.data[i][k] is not None:
                        out[i] = c.data[i][k]
                        validity[i] = True
                elif ansi:
                    raise AnsiViolation(
                        f"array index {k} out of bounds "
                        "(spark.sql.ansi.enabled)")
        return HostColumn(self.data_type, out, validity)


class ArrayContains(Expression):
    """array_contains(arr, v): true on a match; null if arr or v is null,
    or on no match while the array holds a null; else false."""

    def __init__(self, child: Expression, value: Expression):
        self.children = (child, value)

    @property
    def data_type(self):
        return T.BOOLEAN

    def with_children(self, children):
        return ArrayContains(children[0], children[1])

    def resolve(self, bound):
        from spark_rapids_tpu_torch.ops.cast import make_cast
        check_array(bound[0], "array_contains")
        et = bound[0].data_type.element_type
        return ArrayContains(bound[0], make_cast(bound[1], et))

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        c, v = child_vals
        a: ArrayData = c.data
        cap = ctx.capacity
        rid = _elem_rids(a.offsets, a.data.shape[0], cap)
        safe = rid.clamp(max=cap - 1)
        hits = seg_count((a.data == v.data[safe]) & a.validity, rid, cap)
        nulls = seg_count(~a.validity, rid, cap)
        found = hits > 0
        validity = c.validity & v.validity & (found | (nulls == 0))
        return DevVal(found & validity, validity)

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        v = self.children[1].eval_cpu(table)
        out = np.zeros(len(c), dtype=np.bool_)
        validity = np.zeros(len(c), dtype=np.bool_)
        for i in range(len(c)):
            if not (c.validity[i] and v.validity[i]):
                continue
            arr = c.data[i]
            found = any(x is not None and x == v.data[i] for x in arr)
            has_null = any(x is None for x in arr)
            if found:
                out[i] = True
                validity[i] = True
            elif not has_null:
                validity[i] = True
        return HostColumn(T.BOOLEAN, out, validity)


class _ArrayMinMax(UnaryExpression):
    """array_min / array_max: one ``segment_minmax_64`` (the fused_minmax
    kernel) keyed by each element's row id; values widen to its int64 or
    f64 keys and narrow back (exact). Spark's NaN rule: NaN is the
    greatest value (array_min ignores NaN unless every element is NaN;
    array_max is NaN if any element is)."""

    is_min = True

    @property
    def data_type(self):
        return self.children[0].data_type.element_type

    def resolve(self, bound):
        check_array(bound[0], type(self).__name__)
        return type(self)(bound[0])

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        from spark_rapids_tpu_torch.ops.segsum import segment_minmax_64
        (c,) = child_vals
        a: ArrayData = c.data
        cap = ctx.capacity
        rid = _elem_rids(a.offsets, a.data.shape[0], cap)
        use = a.validity & (rid < cap)
        d = a.data
        wide = d if d.dtype in (torch.int64, torch.float64) else d.to(
            torch.float64 if d.dtype == torch.float32 else torch.int64)
        r = segment_minmax_64(self.is_min, wide, use, rid.to(torch.int32),
                              cap)
        validity = c.validity & (seg_count(use, rid, cap) > 0)
        r = torch.where(validity, r, torch.zeros_like(r)).to(d.dtype)
        return DevVal(r, validity)

    def eval_cpu(self, table):
        import math
        c = self.children[0].eval_cpu(table)
        np_dt = self.data_type.np_dtype
        out = np.zeros(len(c), dtype=np_dt)
        validity = np.zeros(len(c), dtype=np.bool_)

        def isnan(x):
            return isinstance(x, float) and math.isnan(x)

        for i in range(len(c)):
            if c.validity[i]:
                vals = [x for x in c.data[i] if x is not None]
                if vals:
                    # Spark total order: NaN is the GREATEST value
                    key = lambda x: (isnan(x), x if not isnan(x) else 0.0)  # noqa: E731
                    out[i] = (min if self.is_min else max)(vals, key=key)
                    validity[i] = True
        return HostColumn(self.data_type, out, validity)


class ArrayMin(_ArrayMinMax):
    is_min = True


class ArrayMax(_ArrayMinMax):
    is_min = False


class SortArray(Expression):
    """sort_array(arr, asc): each row's elements sorted; nulls FIRST
    ascending, LAST descending; NaN greatest, -0.0 == 0.0 (Spark's
    order). One stable sort of (row id, null flag, value words) over the
    element slots through the radix sort kernel."""

    def __init__(self, child: Expression, ascending: Expression = None):
        asc = ascending if ascending is not None else Literal(True, T.BOOLEAN)
        self.children = (child, asc)

    @property
    def data_type(self):
        return self.children[0].data_type

    def with_children(self, children):
        return SortArray(children[0],
                         children[1] if len(children) > 1 else None)

    def resolve(self, bound):
        check_array(bound[0], "sort_array")
        if not isinstance(bound[1], Literal):
            raise ColumnarProcessingError(
                "sort_array's ascending flag must be a literal")
        return SortArray(bound[0], bound[1])

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        from spark_rapids_tpu_torch.ops.ordering import (
            comparable_operands,
            descending_operands,
            lex_sort,
        )
        c = child_vals[0]
        a: ArrayData = c.data
        cap = ctx.capacity
        ecap = a.data.shape[0]
        asc = bool(self.children[1].value)
        rid = _elem_rids(a.offsets, ecap, cap)
        zeroed = torch.where(a.validity, a.data, torch.zeros_like(a.data))
        if zeroed.dtype == torch.bool:
            zeroed = zeroed.to(torch.int32)
        ops = comparable_operands(zeroed)
        if not asc:
            ops = descending_operands(ops)
        nf = (a.validity == asc).to(torch.int32)
        idx = torch.arange(ecap, dtype=torch.int32, device=a.data.device)
        res = lex_sort([rid.to(torch.int32), nf] + ops, idx)
        perm = res[-1].to(torch.int64)
        return DevVal(ArrayData(a.offsets, a.data[perm], a.validity[perm]),
                      c.validity)

    def eval_cpu(self, table):
        import math
        c = self.children[0].eval_cpu(table)
        asc = bool(self.children[1].value)
        out = np.empty(len(c), dtype=object)

        def key(x):
            # Spark total order: NaN greatest (and -0.0 == 0.0)
            if isinstance(x, float):
                if math.isnan(x):
                    return (1, 0.0)
                return (0, x + 0.0)
            return (0, x)

        for i in range(len(c)):
            if c.validity[i]:
                vals = sorted((x for x in c.data[i] if x is not None),
                              key=key, reverse=not asc)
                nulls = [None] * (len(c.data[i]) - len(vals))
                out[i] = (nulls + vals) if asc else (vals + nulls)
        return HostColumn(self.data_type, out, c.validity.copy())


class CreateArray(Expression):
    """array(e1, e2, ...) -- k elements a row, in the common promoted
    type."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    @property
    def data_type(self):
        return T.ArrayType(self.children[0].data_type)

    def with_children(self, children):
        return CreateArray(*children)

    def resolve(self, bound_children):
        from spark_rapids_tpu_torch.ops.cast import make_cast
        if not bound_children:
            raise ColumnarProcessingError("array() needs an element")
        target = bound_children[0].data_type
        for c in bound_children[1:]:
            if c.data_type != target:
                target = T.promote(target, c.data_type)
        return CreateArray(*[make_cast(c, target) for c in bound_children])

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        from spark_rapids_tpu_torch.columnar import bucket_for
        cap = ctx.capacity
        k = len(child_vals)
        ecap = bucket_for(max(cap * k, 1))
        dev = ctx.device
        live = ctx.row_mask()
        data = torch.stack([cv.data for cv in child_vals], 1).reshape(-1)
        valid = torch.stack([cv.validity for cv in child_vals],
                            1).reshape(-1)
        ed = torch.zeros(ecap, dtype=data.dtype, device=dev)
        ev = torch.zeros(ecap, dtype=torch.bool, device=dev)
        ed[:cap * k] = data
        ev[:cap * k] = valid
        if ctx.live is None:
            # a prefix batch: its rows' elements are already the prefix
            rows = torch.arange(cap + 1, dtype=torch.int32, device=dev)
            off = torch.minimum(rows, ctx.nrows.to(torch.int32)) * k
            return DevVal(ArrayData(off, ed, ev), live)
        rid = torch.arange(ecap, dtype=torch.int64, device=dev) // k
        keep = (rid < cap) & live[rid.clamp(max=cap - 1)]
        off, pairs = pack_elements(ctx, keep, rid, [(ed, ev)], ecap)
        return DevVal(ArrayData(off, *pairs[0]), live)

    def eval_cpu(self, table):
        kids = [c.eval_cpu(table) for c in self.children]
        n = table.num_rows
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = [
                (k.data[i].item() if hasattr(k.data[i], "item") else k.data[i])
                if k.validity[i] else None for k in kids]
        return HostColumn(self.data_type, out, np.ones(n, dtype=np.bool_))


class Explode(UnaryExpression):
    """Generator marker: planned as a Generate node, never evaluated as a
    row expression."""

    pos = False
    outer = False

    @property
    def data_type(self):
        return self.children[0].data_type.element_type

    def eval_dev(self, ctx, child_vals, prep):
        raise ColumnarProcessingError(
            "explode must be planned as a Generate node (a select with "
            "one generator)")

    def eval_cpu(self, table):
        raise ColumnarProcessingError(
            "Explode must be planned as a Generate node")


class PosExplode(Explode):
    pos = True


class ExplodeOuter(Explode):
    outer = True


class PosExplodeOuter(Explode):
    pos = True
    outer = True


class Sequence(Expression):
    """sequence(start, stop[, step]) -> array<bigint>. The step defaults
    to 1 or -1 by direction; a zero step, or one pointing away from stop,
    raises (as Spark does whatever the ANSI mode). The element buffer's
    capacity is the bucket of the lengths' total: one host read, counted
    as every host sync is."""

    #: the reference's per-sequence length bound
    MAX_LENGTH = 100_000_000

    def __init__(self, *children: Expression):
        if len(children) not in (2, 3):
            raise ColumnarProcessingError("sequence(start, stop[, step])")
        self.children = tuple(children)

    @property
    def data_type(self):
        return T.ArrayType(T.LONG)

    def with_children(self, children):
        return Sequence(*children)

    def resolve(self, bound):
        from spark_rapids_tpu_torch.ops.cast import make_cast
        for c in bound:
            if not isinstance(c.data_type, T.IntegralType):
                raise ColumnarProcessingError(
                    "sequence() boundaries must be integral, got "
                    f"{c.data_type.simple_string()} (temporal sequences "
                    "are not supported)")
        return Sequence(*[make_cast(c, T.LONG) for c in bound])

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        from spark_rapids_tpu_torch.columnar import bucket_for
        cap = ctx.capacity
        start, stop = child_vals[0], child_vals[1]
        validity = start.validity & stop.validity
        s64, e64 = start.data, stop.data
        if len(child_vals) > 2:
            validity = validity & child_vals[2].validity
            step = child_vals[2].data
        else:
            step = torch.where(e64 >= s64, 1, -1).to(torch.int64)
        live = validity & ctx.row_mask()
        safe_step = torch.where(step == 0, torch.ones_like(step), step)
        bad = live & ((step == 0) | (((e64 - s64) * safe_step < 0)
                                     & (s64 != e64)))
        lengths = torch.where(live & ~bad,
                              ((e64 - s64) // safe_step + 1).clamp(min=0),
                              torch.zeros_like(s64))
        # one counted host read: the bad-step flag, the longest and the
        # total (the element buffer's capacity)
        from spark_rapids_tpu_torch.dispatch import host_fetch
        flags = host_fetch([bad.any(), lengths.max(), lengths.sum()])
        if flags[0]:
            raise ColumnarProcessingError(
                "sequence step must move start toward stop")
        if flags[1] > self.MAX_LENGTH:
            raise ColumnarProcessingError(
                "sequence length exceeds the 1e8-element bound")
        ecap = bucket_for(max(int(flags[2]), 1))
        offsets = offsets_from_counts(lengths)
        rid = _elem_rids(offsets, ecap, cap)
        safe_rid = rid.clamp(max=cap - 1)
        pos = (torch.arange(ecap, dtype=torch.int64, device=ctx.device)
               - offsets[safe_rid].to(torch.int64))
        ev = rid < cap
        ed = torch.where(ev, s64[safe_rid] + pos * safe_step[safe_rid],
                         torch.zeros_like(pos))
        return DevVal(ArrayData(offsets, ed, ev), validity)

    def eval_cpu(self, table: HostTable) -> HostColumn:
        kids = [c.eval_cpu(table) for c in self.children]
        n = table.num_rows
        out = np.empty(n, dtype=object)
        validity = np.zeros(n, dtype=np.bool_)
        for i in range(n):
            if not all(k.validity[i] for k in kids):
                continue
            start, stop = int(kids[0].data[i]), int(kids[1].data[i])
            step = int(kids[2].data[i]) if len(kids) > 2 else (
                1 if stop >= start else -1)
            if step == 0 or (stop - start) * step < 0 and start != stop:
                raise ColumnarProcessingError(
                    "sequence step must move start toward stop")
            if abs(stop - start) // abs(step) + 1 > 100_000_000:
                raise ColumnarProcessingError(
                    "sequence length exceeds the 1e8-element bound")
            out[i] = list(range(start, stop + (1 if step > 0 else -1),
                                step))
            validity[i] = True
        return HostColumn(self.data_type, out, validity)
