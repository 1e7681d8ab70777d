"""Hash aggregate (port of ``spark_rapids_tpu/execs/aggregate.py``:
``_fast_layout``, ``_build_fast_kernel``, the sort-segment
``_build_kernel`` with ``_agg_one``'s Sum/Average/Count/Min/Max, the
global aggregate and the speculative output shrink).

NO-SORT PATH. When every grouping key has a small domain known on the
host (a dictionary-encoded string: its dictionary; an integer-family
column: its upload-time (min, max) statistic,
``DeviceColumn.domain``), each row's group id is a mixed-radix
combination of its key codes, ``gid = sum(code_i * stride_i)`` (an
integer key's code is ``value - min``), with one extra slot per key for
null. Aggregation is then a direct segment reduction over ``gpad`` (the
padded domain product) segments:

* the live count and every spec's non-null count ride one int32
  ``index_add_`` (a torch op, as the reference leaves it to XLA);
* every f64 SUM/AVG, and the mean pass of every variance and stddev,
  rides one batched pass (ops/segsum.py): the one-hot partials kernel up
  to 32 segments, one ``index_add_`` above; the centred squares of the
  variances ride a second one;
* every integer SUM (int64, wrapping on overflow as the reference's CPU
  route does) and every decimal SUM/AVG (four 32-bit words of the
  unscaled value, carried back to 128 bits: exact, null on overflow)
  rides one int64 ``index_add_``, never the f64 partials: integer sums
  are exact in any order, so they are the reference's bits on the card;
* every MIN/MAX is one ``segment_minmax_64`` (the ``fused_minmax``
  kernel): BYTE, SHORT, INT, BOOLEAN, DATE, TIMESTAMP, DECIMAL64 and a
  string's sorted-dictionary codes widen to its int64 keys, FLOAT to
  f64, and narrow back; a DECIMAL128 is two launches, the signed high
  limbs, then the low limbs (unsigned, through a top-bit flip) of the
  rows that tie on the winning high limb (the reference's
  ``_dec128_minmax_segments``). A string over an unsorted dictionary
  raises;
* every FIRST/LAST picks a row position per segment, the least or the
  greatest live (with ``ignore_nulls``, non-null) row's, through the
  same kernel over int64 positions, and gathers its value: the no-sort
  path keeps input order, the sort-segment path's stable sort keeps it
  within a group;
* the group slots that exist are packed through the compaction kernel
  (ops/scatter32.py).

GLOBAL AGGREGATE (no grouping keys): the no-sort layout with one segment
padded to 8, also with maxDictGroups 0 (where the reference takes its
sort-segment path); slot 0 exists whatever the input, so the output is
exactly one row, with count 0 and every SUM/AVG/MIN/MAX null on empty
input.

SORT-SEGMENT PATH, for keys whose domain is unknown or too wide: one
lexicographic sort of (dead-last, per key: null flag + sortable words)
through the sort kernel groups equal keys; group boundaries on the sorted
operands number the groups; keys scatter to their group slot and every
aggregate is a segment sum over the input capacity. Its output keeps the
input capacity, which the aggregate SPECULATES down to a quarter (a flag
validated at collect; a miss replays on the exact shrink).

MULTI-BATCH MERGE (the reference's streaming merge): each input batch
aggregates to a partial and shrinks to its groups' bucket (one host read
a batch), the partials concatenate, one merge aggregation re-groups them
and a finalize projection gives each result (``_merge_plan``: COUNT ->
SUM of counts, SUM -> SUM of sums, MIN/MAX and FIRST/LAST ->
themselves (the partials concatenate in batch order), AVG -> SUM and
COUNT then their quotient, variance and stddev -> COUNT, SUM and
VariancePop then the Chan combination ``MergeMoments``). Integer and
decimal sums stay exact; a decimal SUM's merged sum keeps the SUM's type
and is held to its precision, as one batch's is, and a partial that
overflowed nulls the result. A single batch takes the one-pass path. As
in the reference, the aggregate's input first coalesces to the batch-size
target (overrides/rules.py, ``execs/basic.py::BATCH_SIZE_BYTES``), so
only an input past it, or an exchange's views of several splits, reaches
the merge.

Filters fused from the input chain (execs/fuse.py) are the row weight
mask: a dropped row, or a padding row past ``nrows``, adds to no sum,
count, extreme or group. What the slice does not reach raises
NotImplementedError: MIN/MAX over an unsorted string dictionary, and an
aggregate over a nested input other than a count or a collect. The
moments of a DECIMAL128, a percentile of a decimal, a count, FIRST
or LAST over a nested input and a collect of elements without a device
layout
run on the CPU route (``agg_host_reason``, overrides/rules.py).
SORT-ONLY AGGREGATES (the reference's ``SORT_ONLY_AGGS``): collect_list,
collect_set and percentile take the sort-segment path only (a global one
too, as one group), over one coalesced batch (overrides/rules.py), never
the no-sort layout:
* collect_list packs each group's non-null values, in input order (the
  grouping sort is stable), through the compaction kernel; the element
  buffer is the input's capacity, so no host read sizes it;
* collect_set re-sorts (group, null flag, value words) through the sort
  kernel and packs each group's first occurrences (-0.0 and 0.0 are one
  value, as are NaNs: the sortable words are canonical);
* percentile re-sorts the same way and interpolates linearly between the
  two sorted values around (non-null count - 1) x p.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import (
    DeviceColumn,
    DeviceTable,
    bucket_for,
)
from spark_rapids_tpu_torch.execs.base import (
    TpuExec,
    first_two,
    prepend,
    take,
)
from spark_rapids_tpu_torch.ops import aggregates as agg
from spark_rapids_tpu_torch.ops import decimal as dec
from spark_rapids_tpu_torch.ops.expr import (
    Expression,
    PrepCtx,
    eval_expr,
    prep_expr,
    table_vals,
)
from spark_rapids_tpu_torch.ops.segsum import (
    batched_segment_sum_f64,
    segment_minmax_64,
    segment_sum,
)
from spark_rapids_tpu_torch.runtime import speculation as spec

#: the aggregate functions the device exec computes (the reference's
#: ``DEVICE_SUPPORTED_AGGS``; the plan verifier's PV-AGG and the registry
#: audit's RA-SQL-EXPOSURE read it)
DEVICE_SUPPORTED_AGGS = (agg.Sum, agg.Min, agg.Max, agg.Count, agg.Average,
                         agg.First, agg.Last, agg.StddevPop, agg.StddevSamp,
                         agg.VariancePop, agg.VarianceSamp,
                         agg.CollectList, agg.CollectSet, agg.Percentile)

#: sort-segment outputs up to this capacity keep their size (the
#: reference's DeviceTable.EMBED_NROWS_CAP, below which it does not
#: speculate a shrink)
EMBED_NROWS_CAP = 1 << 16

#: integer-family key types the no-sort layout codes by value - min
_INT_KEY_TYPES = (T.ByteType, T.ShortType, T.IntegerType, T.LongType,
                  T.DateType, T.TimestampType)

#: value types MIN/MAX and FIRST/LAST take (MIN/MAX widen each to the
#: kernel's int64 or f64)
_VALUE_TYPES = (T.LongType, T.DoubleType, T.IntegerType, T.DateType,
                T.ByteType, T.ShortType, T.BooleanType, T.FloatType,
                T.TimestampType, T.DecimalType, T.StringType)


def agg_host_reason(name: str, fn: agg.AggregateFunction):
    """The reference's reason text where its tag sends aggregate ``name``
    to the CPU route and that route computes it (a collect of elements
    without a device layout, a count, FIRST or LAST over an array, the
    moments of a DECIMAL128, a percentile of a decimal), else None."""
    from spark_rapids_tpu_torch.columnar.nested import (
        FIXED_ELEMENT_TYPES,
        is_nested_type,
    )
    child_dt = fn.child.data_type if fn.child is not None else None
    if child_dt is None:
        return None
    if isinstance(fn, (agg.CollectList, agg.CollectSet)):
        if not isinstance(child_dt, FIXED_ELEMENT_TYPES):
            return (f"output column {name} has unsupported type "
                    f"{fn.data_type.simple_string()}")
        return None
    if is_nested_type(child_dt) and isinstance(fn, (agg.Count, agg._Pick)):
        return (f"aggregate {name} over an array input is not supported "
                "on GPU")
    if T.is_dec128(child_dt) and isinstance(fn, agg._CentralMoment):
        return (f"aggregate {name} over a decimal(>18) input is not "
                "supported on GPU")
    if isinstance(fn, agg.Percentile) and isinstance(child_dt,
                                                     T.DecimalType):
        return (f"aggregate {name} over a decimal input is not supported "
                "on GPU")
    return None


def check_agg_supported(fn: agg.AggregateFunction) -> None:
    """Raise NotImplementedError for an aggregate neither the device nor
    the CPU route runs; an aggregate ``agg_host_reason`` names runs on
    the CPU route and never reaches the device exec."""
    from spark_rapids_tpu_torch.columnar.nested import is_nested_type
    if agg_host_reason(fn.name, fn) is not None:
        return
    if any(is_nested_type(c.data_type) for c in fn.children):
        raise NotImplementedError(
            f"aggregate {fn.name} over a nested input "
            f"{fn.child.data_type.simple_string()} is not ported")
    if isinstance(fn, (agg.Count, agg.MergeMoments, agg.CollectList,
                       agg.CollectSet)):
        return
    if isinstance(fn, agg.Percentile):
        return
    if isinstance(fn, (agg.Average, agg.Sum)):
        if isinstance(fn.child.data_type, T.NumericType):
            return
    elif isinstance(fn, agg._CentralMoment):
        if isinstance(fn.child.data_type, T.NumericType) and \
                not T.is_dec128(fn.child.data_type):
            return
    elif isinstance(fn, (agg.Min, agg.Max, agg._Pick)):
        if isinstance(fn.child.data_type, _VALUE_TYPES):
            return
    raise NotImplementedError(
        f"aggregate {fn.name} over "
        f"{fn.child.data_type.simple_string() if fn.child is not None else '*'}"
        " is not ported")


def _widen(data: torch.Tensor) -> torch.Tensor:
    """Values as the kernel's keys: f32 as f64 (exact), every other
    1-D type (bool, int8 .. int64, string codes) as int64."""
    if data.dtype in (torch.int64, torch.float64):
        return data
    return data.to(torch.float64 if data.dtype == torch.float32
                   else torch.int64)


def _minmax(fn: agg.AggregateFunction, data: torch.Tensor,
            valid: torch.Tensor, gid: torch.Tensor, nseg: int,
            has_any: torch.Tensor):
    """(data, validity) of one MIN/MAX over ``nseg`` segments: values
    widen to int64 or f64 for the kernel and narrow back (exact: the
    result is one of the inputs); a DECIMAL128 is the reference's two-limb
    reduction. Slots without a non-null value hold 0 and are null."""
    is_min = isinstance(fn, agg.Min)
    if data.ndim == 2:
        # the kernel reads contiguous (n,) columns
        hi, lo = data[:, 0].contiguous(), data[:, 1]
        hi_m = segment_minmax_64(is_min, hi, valid, gid, nseg)
        tie = valid & (hi == hi_m[gid.to(torch.int64)])
        lo_m = segment_minmax_64(is_min, lo ^ dec._TOP64, tie, gid,
                                 nseg) ^ dec._TOP64
        r = torch.stack([hi_m, lo_m], dim=1)
        return torch.where(has_any[:, None], r, torch.zeros_like(r)), has_any
    r = segment_minmax_64(is_min, _widen(data), valid, gid, nseg)
    r = torch.where(has_any, r, torch.zeros((), dtype=r.dtype,
                                            device=r.device))
    return r.to(data.dtype), has_any


def _pick(fn: agg.AggregateFunction, data: torch.Tensor, valid, live,
          gid: torch.Tensor, nseg: int, exists: torch.Tensor):
    """(data, validity) of one FIRST/LAST over ``nseg`` segments: the least
    (FIRST) or greatest (LAST) row position among the segment's live rows
    (with ``ignore_nulls``, its non-null ones), then that row's value;
    null where the segment has no such row or its value is null."""
    n = data.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=data.device)
    chosen = segment_minmax_64(isinstance(fn, agg.First), pos,
                               valid if fn.ignore_nulls else live, gid, nseg)
    got = (chosen >= 0) & (chosen < n) & exists
    safe = chosen.clamp(0, n - 1)
    validity = got & valid[safe]
    out = data[safe]
    mask = validity[:, None] if out.ndim == 2 else validity
    return torch.where(mask, out, torch.zeros_like(out)), validity


def _exact_sum(fn: agg.AggregateFunction) -> bool:
    """SUM of an integral type, or SUM/AVG of a decimal: an int64 segment
    sum (of the value, or of its four 32-bit words), exact in any order."""
    ct = fn.child.data_type
    return ((isinstance(fn, agg.Sum) and isinstance(ct, T.IntegralType))
            or (isinstance(fn, (agg.Sum, agg.Average))
                and isinstance(ct, T.DecimalType)))


def _as_f64(data: torch.Tensor, dt: T.DataType) -> torch.Tensor:
    """Values as doubles; a DECIMAL64 unscaled value in value units, as
    the reference's moments scale it."""
    x = data.to(torch.float64)
    if isinstance(dt, T.DecimalType):
        x = x / float(10 ** dt.scale)
    return x


class TpuHashAggregateExec(TpuExec):
    def __init__(self, child: TpuExec, grouping: Sequence[Expression],
                 agg_specs: Sequence[Tuple[str, agg.AggregateFunction]],
                 grouping_names: Sequence[str],
                 filters: Sequence[Expression] = (),
                 max_dict_groups: int = 1 << 16,
                 max_domain_groups: int = 1 << 21):
        self.children = (child,)
        self.grouping = list(grouping)
        self.agg_specs = list(agg_specs)
        self.grouping_names = list(grouping_names)
        self.filters = list(filters)
        self.max_dict_groups = max_dict_groups
        self.max_domain_groups = max_domain_groups
        for _, fn in self.agg_specs:
            check_agg_supported(fn)

    def output_schema(self):
        out = [(n, g.data_type) for n, g in zip(self.grouping_names,
                                                self.grouping)]
        out += [(n, fn.data_type) for n, fn in self.agg_specs]
        return out

    def execute(self):
        from spark_rapids_tpu_torch.columnar.table import (
            concat_device,
            merge_split_views,
        )
        from spark_rapids_tpu_torch.ops.expr import bind, compile_project
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        from spark_rapids_tpu_torch.runtime.spill import (
            BufferCatalog,
            SpillableBatch,
        )
        # the aggregate re-groups every row: a repartition's views of one
        # split mask-union back into one batch (no data moves)
        it = merge_split_views(self.children[0].execute_masked())
        items = first_two(it)
        if not items:
            return
        if len(items) == 1:
            first = take(items.pop())
            out = [retry_block(lambda: self._aggregate(first))]
            del first  # the input is not kept while the output is used
            yield out.pop()
            return
        plan = self._merge_plan()
        partial = self._stage(self.grouping, plan.partial_specs,
                              self.filters)
        catalog = BufferCatalog.get()
        partials = []
        batches = prepend(items, it)
        try:
            for batch in batches:
                batch = take(batch)
                # shrink each partial to its groups' bucket before it
                # buffers (one host read of its row count): unshrunk, N
                # partials would concatenate into an N-fold input-sized
                # table; the partials are spillable while they buffer,
                # each in buffers of its own
                pt = retry_block(
                    lambda b=batch: partial._aggregate(b).shrink(True))
                del batch
                partials.append(SpillableBatch(pt, catalog))
                del pt
                self.add_metric("partialAggBatches", 1)
            merge = self._stage(plan.merge_grouping, plan.merge_specs, [])
            mt = retry_block(lambda: merge._aggregate(
                concat_device([p.get() for p in partials])))
        finally:
            for p in partials:
                p.release()
        schema = [(n, c.dtype) for n, c in zip(mt.names, mt.columns)]
        cols = compile_project([bind(e, schema) for e in plan.final_exprs],
                               mt)
        names = self.grouping_names + [n for n, _ in self.agg_specs]
        yield DeviceTable(names, cols, mt.nrows_dev, mt.capacity, mt.device)

    def _stage(self, grouping, agg_specs, filters) -> "TpuHashAggregateExec":
        """The partial or merge aggregation of the multi-batch path: an
        aggregate of this one's layout limits and plan position."""
        stage = TpuHashAggregateExec(
            self.children[0], grouping, agg_specs, self.grouping_names,
            filters=filters, max_dict_groups=self.max_dict_groups,
            max_domain_groups=self.max_domain_groups)
        stage._lore_id = self._lore_id
        return stage

    def _merge_plan(self):
        if any(isinstance(fn, agg.SORT_ONLY_AGGS)
               for _, fn in self.agg_specs):
            # the reference has no merge decomposition for them either;
            # their input coalesces to one batch (overrides/rules.py)
            raise NotImplementedError(
                "collect_list, collect_set and percentile over several "
                "input batches (they take one coalesced batch)")
        return self._merge_plan_specs()

    def _merge_plan_specs(self):
        """(partial specs, merge grouping and specs, finalize expressions)
        of the multi-batch path (the reference's decomposition):

          Count   -> partial Count        ; merge Sum             ; identity
          Sum     -> partial Sum          ; merge Sum             ; identity
                     (a decimal SUM also counts its partials' overflows:
                     a null partial sum over rows nulls the result)
          Min/Max -> partial Min/Max      ; merge Min/Max         ; identity
          First/  -> partial First/Last   ; merge First/Last      ; identity
          Last       (the partials concatenate in batch order)
          Avg     -> partial Sum + Count  ; merge Sum each        ; s / n
          Var*/   -> partial Count + Sum + VariancePop ; merge Sum of the
          Stddev*    counts and MergeMoments (Chan) ; m2 / N or m2 / (N-1)
                     (+ sqrt)"""
        from types import SimpleNamespace

        from spark_rapids_tpu_torch.ops.cast import Cast
        from spark_rapids_tpu_torch.ops.conditional import If
        from spark_rapids_tpu_torch.ops.expr import (
            BoundReference,
            Literal,
            col,
            lit,
        )
        from spark_rapids_tpu_torch.ops.math import Sqrt
        from spark_rapids_tpu_torch.ops.predicates import IsNull

        pschema = [(n, g.data_type)
                   for n, g in zip(self.grouping_names, self.grouping)]
        partial_specs, merge_specs = [], []
        final_exprs = [col(n) for n in self.grouping_names]

        def add_partial(pname, pfn):
            partial_specs.append((pname, pfn))
            pschema.append((pname, pfn.data_type))
            return BoundReference(len(pschema) - 1, pfn.data_type,
                                  name_hint=pname)

        for j, (name, fn) in enumerate(self.agg_specs):
            if isinstance(fn, agg.Count):
                c = add_partial(f"__p{j}c", agg.Count(fn.child))
                merge_specs.append((name, agg.Sum(c)))
                final_exprs.append(col(name))
            elif isinstance(fn, agg.Sum) and isinstance(fn.data_type,
                                                        T.DecimalType):
                s = add_partial(f"__p{j}s", agg.Sum(fn.child))
                n = add_partial(f"__p{j}n", agg.Count(fn.child))
                merge_specs.append((f"__m{j}s", agg.Sum(s, fn.data_type)))
                merge_specs.append((f"__m{j}o", agg.Sum(
                    If(IsNull(s) & (n > lit(0)), lit(1), lit(0)))))
                final_exprs.append(If(col(f"__m{j}o") > lit(0),
                                      Literal(None, fn.data_type),
                                      col(f"__m{j}s")).alias(name))
            elif isinstance(fn, agg.Sum):
                s = add_partial(f"__p{j}s", agg.Sum(fn.child))
                merge_specs.append((name, agg.Sum(s)))
                final_exprs.append(col(name))
            elif isinstance(fn, (agg.Min, agg.Max)):
                m = add_partial(f"__p{j}m", type(fn)(fn.child))
                merge_specs.append((name, type(fn)(m)))
                final_exprs.append(col(name))
            elif isinstance(fn, agg._Pick):
                f = add_partial(f"__p{j}f", fn)
                merge_specs.append((name, type(fn)(f, fn.ignore_nulls)))
                final_exprs.append(col(name))
            elif isinstance(fn, agg.Average):
                s = add_partial(f"__p{j}s", agg.Sum(fn.child))
                n = add_partial(f"__p{j}n", agg.Count(fn.child))
                merge_specs.append((f"__m{j}s", agg.Sum(s)))
                merge_specs.append((f"__m{j}n", agg.Sum(n)))
                final_exprs.append(
                    (col(f"__m{j}s").cast(T.DOUBLE)
                     / col(f"__m{j}n").cast(T.DOUBLE)).alias(name))
            else:  # variance and stddev (check_agg_supported ran)
                n = add_partial(f"__p{j}n", agg.Count(fn.child))
                s = add_partial(f"__p{j}s", agg.Sum(Cast(fn.child,
                                                         T.DOUBLE)))
                v = add_partial(f"__p{j}v", agg.VariancePop(fn.child))
                merge_specs.append((f"__m{j}n", agg.Sum(n)))
                merge_specs.append((f"__m{j}m", agg.MergeMoments(
                    n, s, v * Cast(n, T.DOUBLE))))
                count = col(f"__m{j}n").cast(T.DOUBLE)
                if isinstance(fn, (agg.StddevPop, agg.VariancePop)):
                    var = col(f"__m{j}m") / count
                else:
                    var = col(f"__m{j}m") / (count - lit(1.0))
                out = Sqrt(var) if isinstance(
                    fn, (agg.StddevPop, agg.StddevSamp)) else var
                final_exprs.append(out.alias(name))
        merge_grouping = [
            BoundReference(i, g.data_type, name_hint=n)
            for i, (g, n) in enumerate(zip(self.grouping,
                                           self.grouping_names))]
        return SimpleNamespace(partial_specs=partial_specs,
                               merge_specs=merge_specs,
                               merge_grouping=merge_grouping,
                               final_exprs=final_exprs)

    def _prep_all(self, table: DeviceTable):
        pctx = PrepCtx(table)
        filter_preps = [prep_expr(f, pctx) for f in self.filters]
        key_preps = [prep_expr(g, pctx) for g in self.grouping]
        # one prep list per child expression (Count() has none)
        val_preps = [[prep_expr(c, pctx) for c in fn.children]
                     for _, fn in self.agg_specs]
        return filter_preps, key_preps, val_preps

    def _fast_layout(self, key_preps, capacity: int) -> Optional[tuple]:
        """(kinds, sizes, strides, gpad, bases) when every key has a small
        known domain, else None (the sort-segment path). The global
        aggregate is one segment padded to 8, whatever maxDictGroups is:
        it holds no dictionary groups."""
        if not self.grouping:
            return [], [], [], 8, []
        if self.max_dict_groups <= 0:
            return None
        kinds: List[str] = []
        sizes: List[int] = []
        bases: List[int] = []
        for g, preps in zip(self.grouping, key_preps):
            dt, root = g.data_type, preps[-1]
            if isinstance(dt, T.StringType) and root.out_dict is not None:
                kinds.append("str")
                sizes.append(len(root.out_dict) + 1)  # +1: null slot
                bases.append(0)
            elif (isinstance(dt, _INT_KEY_TYPES)
                  and root.out_domain is not None
                  and self.max_domain_groups > 0):
                lo, hi = root.out_domain
                kinds.append("int")
                sizes.append(hi - lo + 2)  # values + null slot
                bases.append(lo)
            else:
                return None
        total = 1
        for s in sizes:
            total *= max(s, 1)
        cap = self.max_dict_groups
        if "int" in kinds:
            # int domains are data-dependent: allow larger segment counts,
            # but never a domain so sparse it dwarfs the batch itself
            cap = max(cap, min(self.max_domain_groups, 16 * capacity))
        if total > cap:
            return None
        strides = [1] * len(sizes)
        for i in range(len(sizes) - 2, -1, -1):
            strides[i] = strides[i + 1] * sizes[i + 1]
        # tight power-of-two segment count: a q1-style 12-slot domain pads
        # to 16, not to a table bucket
        gpad = max(8, 1 << (max(total - 1, 1)).bit_length())
        return kinds, sizes, strides, gpad, bases

    def _aggregate(self, table: DeviceTable) -> DeviceTable:
        filter_preps, key_preps, val_preps = self._prep_all(table)
        # a string aggregate's result keeps its value's dictionary; MIN/MAX
        # compare codes, so that dictionary must be sorted
        value_dicts = [per_child[0][-1] if per_child else None
                       for per_child in val_preps]
        for (_, fn), root in zip(self.agg_specs, value_dicts):
            if isinstance(fn, (agg.Min, agg.Max)) and root is not None \
                    and root.out_dict is not None and not root.dict_sorted:
                raise NotImplementedError(
                    f"aggregate {fn.name} over a string with an unsorted "
                    "dictionary is not ported")
        sort_only = any(isinstance(fn, agg.SORT_ONLY_AGGS)
                        for _, fn in self.agg_specs)
        fast = None if sort_only else self._fast_layout(key_preps,
                                                         table.capacity)
        if fast is None:
            out_arrays, ngroups = self._sort_kernel(
                table, filter_preps, key_preps, val_preps)
            out_capacity = table.capacity
        else:
            out_arrays, ngroups = self._fast_kernel(
                table, fast, filter_preps, key_preps, val_preps)
            out_capacity = fast[3]
        out_cols: List[DeviceColumn] = []
        for i, g in enumerate(self.grouping):
            data, validity = out_arrays[i]
            root = key_preps[i][-1]
            out_cols.append(DeviceColumn(g.data_type, data, validity,
                                         dictionary=root.out_dict,
                                         dict_sorted=root.dict_sorted,
                                         domain=root.out_domain))
        for j, (_, fn) in enumerate(self.agg_specs):
            data, validity = out_arrays[len(self.grouping) + j]
            root = value_dicts[j]
            if isinstance(fn.data_type, T.StringType):
                out_cols.append(DeviceColumn(fn.data_type, data, validity,
                                             dictionary=root.out_dict,
                                             dict_sorted=root.dict_sorted))
            else:
                out_cols.append(DeviceColumn(fn.data_type, data, validity))
        names = self.grouping_names + [n for n, _ in self.agg_specs]
        out = DeviceTable(names, out_cols, ngroups, out_capacity,
                          table.device)
        if fast is not None:
            return out  # already domain-sized
        return self._shrink(out)

    def _shrink(self, out: DeviceTable) -> DeviceTable:
        """The sort-segment output keeps its input's capacity. Small ones
        stay as they are under speculation; larger ones SPECULATE that the
        groups fit a quarter-capacity bucket (a flag validated at collect;
        a miss replays this site, which then keeps the full capacity).
        Without speculation the output shrinks exactly (a host sync)."""
        cap = out.capacity
        site = self._spec_site_key() + ":shrink"
        ctx = spec.allowed(site) if cap > EMBED_NROWS_CAP else None
        if ctx is None:
            return out if spec.current() is not None else out.shrink()
        spec_cap = max(bucket_for(max(cap // 4, 1)), EMBED_NROWS_CAP)
        if spec_cap >= cap:
            return out
        ctx.add_flag(site, out.nrows_dev > spec_cap)
        return DeviceTable(out.names, [c.sliced_rows(spec_cap)
                                       for c in out.columns],
                           out.nrows_dev, spec_cap, out.device)

    def _spec_site_key(self) -> str:
        return "agg:{}:{}:op{}".format(
            tuple(repr(g) for g in self.grouping),
            tuple(repr(fn) for _, fn in self.agg_specs), self._lore_id)

    def _eval_live(self, table, filter_preps) -> torch.Tensor:
        """Row-liveness: in-bounds (or the input's mask) AND every fused
        predicate non-null true. In ANSI mode the predicates run from the
        lowest filter up, each checked only on the rows the filters below
        it kept, as the unfused plan evaluates them."""
        from spark_rapids_tpu_torch.dispatch import ANSI_MODE
        live = table.row_mask()
        cols = table_vals(table)
        ansi = ANSI_MODE.get()
        fs = list(zip(self.filters, filter_preps))
        if ansi:
            fs.reverse()
        for f, preps in fs:
            pred = eval_expr(f, preps, cols, table.nrows_dev,
                             table.capacity, table.device, live=table.live,
                             guard=live if ansi else None)
            live = live & pred.data & pred.validity
        return live

    def _eval_all(self, table, filter_preps, key_preps, val_preps):
        """(live, key DevVals, per-spec value DevVals); in ANSI mode the
        keys and values are checked only on the rows the fused filters
        kept."""
        from spark_rapids_tpu_torch.dispatch import ANSI_MODE
        cols = table_vals(table)
        live = self._eval_live(table, filter_preps)
        guard = live if ANSI_MODE.get() and self.filters else None

        def ev(e, preps):
            return eval_expr(e, preps, cols, table.nrows_dev, table.capacity,
                             table.device, live=table.live, guard=guard)

        kvs = [ev(g, p) for g, p in zip(self.grouping, key_preps)]
        vvs = [[ev(c, p) for c, p in zip(fn.children, per_child)]
               for (_, fn), per_child in zip(self.agg_specs, val_preps)]
        return live, kvs, vvs

    def _fast_kernel(self, table: DeviceTable, fast, filter_preps,
                     key_preps, val_preps):
        kinds, sizes, strides, gpad, bases = fast
        dev, capacity = table.device, table.capacity
        live, kvs, vvs = self._eval_all(table, filter_preps, key_preps,
                                        val_preps)

        gid = torch.zeros(capacity, dtype=torch.int32, device=dev)
        for i, (kv, kind) in enumerate(zip(kvs, kinds)):
            if kind == "int":
                # the where runs BEFORE the int32 narrowing: invalid and
                # padding slots hold arbitrary data, valid ones lie in the
                # upload-time domain
                code = torch.where(kv.validity,
                                   kv.data.to(torch.int64) - bases[i],
                                   torch.full((), sizes[i] - 1,
                                              dtype=torch.int64,
                                              device=dev)).to(torch.int32)
            else:
                code = torch.where(kv.validity, kv.data.to(torch.int32),
                                   torch.full((), sizes[i] - 1,
                                              dtype=torch.int32, device=dev))
            gid = gid + code * strides[i]

        svs = _spec_valids(vvs, live)

        # one int32 segment sum for the live count + every spec's nonnull
        # count (a torch op: the reference leaves it to XLA)
        masks = [live] + [sv for sv in svs if sv is not None]
        mix = {}
        for j, sv in enumerate(svs):
            if sv is not None:
                mix[j] = len(mix) + 1
        mcnt = torch.zeros((gpad, len(masks)), dtype=torch.int32, device=dev)
        stacked = torch.stack(masks, dim=1).to(torch.int32)
        if self.grouping:
            mcnt.index_add_(0, gid, stacked)
        else:
            # one segment: a column sum, not atomics all aimed at slot 0
            mcnt[0] = stacked.sum(dim=0, dtype=torch.int32)
        nonnulls = {j: mcnt[:, i] for j, i in mix.items()}
        exists = mcnt[:, 0] > 0
        if not self.grouping:
            # exactly one output row even on empty input (count 0, the
            # rest null: Spark's semantics)
            exists = torch.arange(gpad, device=dev) == 0
        ngroups = exists.sum(dtype=torch.int32)

        pairs = []
        slot_ix = torch.arange(gpad, dtype=torch.int32, device=dev)
        for i, kind in enumerate(kinds):
            slot = (slot_ix // strides[i]) % sizes[i]
            kvalid = slot != (sizes[i] - 1)
            if kind == "int":
                kdata = (slot.to(torch.int64) + bases[i]).to(
                    T.torch_dtype(self.grouping[i].data_type))
            else:
                kdata = slot
            pairs.append((kdata, kvalid))

        def fsum(cols):
            return batched_segment_sum_f64(cols, gid, gpad, capacity)

        def isum(cols):
            x = torch.stack(cols, dim=1)
            out = torch.zeros((gpad, len(cols)), dtype=torch.int64,
                              device=dev)
            if not self.grouping:
                out[0] = x.sum(dim=0)  # one segment: a column sum
                return out
            return out.index_add_(0, gid, x)

        pairs += self._reduce_specs(vvs, svs, live, gid, mcnt[:, 0],
                                    nonnulls, exists, fsum, isum, gpad)

        from spark_rapids_tpu_torch.ops.scatter32 import compact_pairs
        outs, _ = compact_pairs([d for d, _ in pairs], [v for _, v in pairs],
                                exists, gpad)
        return list(outs), ngroups

    def _sort_kernel(self, table: DeviceTable, filter_preps, key_preps,
                     val_preps):
        """The sort-segment path (the reference's ``_build_kernel``)."""
        from spark_rapids_tpu_torch.ops.ordering import (
            comparable_operands,
            lex_sort,
            zero_invalid,
        )
        dev, capacity = table.device, table.capacity
        live, kvs, vvs = self._eval_all(table, filter_preps, key_preps,
                                        val_preps)
        # normalize float keys so -0.0 and 0.0 group together
        kvs = [type(kv)(torch.where(kv.data == 0.0, torch.zeros_like(kv.data),
                                    kv.data), kv.validity)
               if kv.data.is_floating_point() else kv for kv in kvs]

        rows = torch.arange(capacity, dtype=torch.int64, device=dev)
        nseg = 2 * capacity
        if not kvs:
            # a global sort-only aggregate: one group, whatever the input
            # (the reference's sort path without keys)
            perm, s_live = rows, live
            gid = torch.where(live, torch.zeros_like(rows), capacity + rows)
            ngroups = torch.ones((), dtype=torch.int32, device=dev)
        else:
            operands = [(~live).to(torch.int32)]  # dead rows last
            for kv in kvs:
                operands.append((~kv.validity).to(torch.int32))
                operands.extend(comparable_operands(
                    zero_invalid(kv.data, kv.validity)))
            payload = torch.arange(capacity, dtype=torch.int32, device=dev)
            sorted_all = lex_sort(operands, payload)
            perm = sorted_all[-1].to(torch.int64)
            s_live = live[perm]

            # group boundaries on the sorted (canonical) operands
            changed = torch.arange(capacity, device=dev) == 0
            for so in sorted_all[1:-1]:
                s = so.view(torch.int32) if so.dtype == torch.uint32 else so
                changed = changed | (s != torch.roll(s, 1))
            new_group = changed & s_live
            gid = torch.cumsum(new_group.to(torch.int64), 0) - 1
            # dead rows add nothing; they park past the groups, each on
            # its own segment (the reference parks them all on the last
            # one, whose atomics would then serialize)
            gid = torch.where(s_live, gid, capacity + rows)
            ngroups = new_group.sum(dtype=torch.int32)
        group_live = torch.arange(capacity, dtype=torch.int32,
                                  device=dev) < ngroups

        outs = []
        # key columns: each group's rows share its key; scatter to the slot
        for kv in kvs:
            kd = torch.zeros((nseg,) + tuple(kv.data.shape[1:]),
                             dtype=kv.data.dtype, device=dev)
            kvv = torch.zeros(nseg, dtype=torch.bool, device=dev)
            kd[gid] = kv.data[perm]
            kvv[gid] = kv.validity[perm]
            outs.append((kd[:capacity], kvv[:capacity] & group_live))

        vvs = [[type(x)(x.data[perm], x.validity[perm]) for x in vv]
               for vv in vvs]
        outs += self._segment_aggs(vvs, s_live, gid, nseg, capacity,
                                   group_live)
        return outs, ngroups

    def _segment_aggs(self, vvs, live, gid, nseg, capacity, group_live):
        """Every spec over int64 segment ids ``gid`` (live rows in
        [0, capacity), dead rows past it): sums and counts by
        ``segment_sum`` over ``nseg`` segments, MIN/MAX by
        ``segment_minmax_64`` over the first ``capacity``."""
        def seg(x):
            return segment_sum(x, gid, nseg)[:capacity]

        def stacked(cols):
            return seg(torch.stack(cols, dim=1))

        svs = _spec_valids(vvs, live)
        nonnulls = {j: seg(sv.to(torch.int32))
                    for j, sv in enumerate(svs) if sv is not None}
        outs = self._reduce_specs(vvs, svs, live,
                                  gid.clamp(max=capacity - 1),
                                  seg(live.to(torch.int32)), nonnulls,
                                  group_live, stacked, stacked, capacity)
        for j, (_, fn) in enumerate(self.agg_specs):
            if isinstance(fn, agg.SORT_ONLY_AGGS):
                outs[j] = _sort_only(fn, vvs[j][0], svs[j], gid, capacity,
                                     nonnulls[j], group_live)
        return outs

    def _reduce_specs(self, vvs, svs, live, gid, live_cnt, nonnulls,
                      exists, fsum, isum, nseg):
        """(data, validity) of every spec over ``nseg`` segments.

        ``svs[j]``: spec j's valid live rows; ``live``: the live rows (in
        the order FIRST/LAST read); ``gid``: each row's segment
        in [0, nseg) (a dead row's is any slot: its values are masked);
        ``live_cnt``/``nonnulls[j]``: int32 counts of live rows and of
        spec j's non-null ones; ``exists``: the segments that are groups.
        ``fsum``/``isum`` sum a list of f64 / int64 (rows,) columns into
        (nseg, k). The f64 pass holds every float SUM/AVG and the mean of
        every moment, the int64 pass every exact sum (``_exact_sum``);
        the moments' centred squares take a second f64 pass."""
        dev = exists.device
        zero = torch.zeros((), dtype=torch.float64, device=dev)
        izero = torch.zeros((), dtype=torch.int64, device=dev)
        fcols, fix, icols, iix = [], {}, [], {}
        def moments(j):  # MergeMoments' (n, s, m2) partial columns
            return [torch.where(svs[j], v.data.to(torch.float64), zero)
                    for v in vvs[j]]

        for j, (_, fn) in enumerate(self.agg_specs):
            if isinstance(fn, (agg.Count, agg.Min, agg.Max, agg._Pick)
                          + agg.SORT_ONLY_AGGS):
                continue
            if isinstance(fn, agg.MergeMoments):
                fix[j] = len(fcols)
                fcols += moments(j)[:2]
                continue
            x, sv, ct = vvs[j][0].data, svs[j], fn.child.data_type
            if _exact_sum(fn):
                iix[j] = len(icols)
                words = dec.limb_words(x) if isinstance(
                    ct, T.DecimalType) else [x.to(torch.int64)]
                icols += [torch.where(sv, w, izero) for w in words]
            else:
                fix[j] = len(fcols)
                fcols.append(torch.where(sv, _as_f64(x, ct), zero))
        fs = fsum(fcols) if fcols else None
        isums = isum(icols) if icols else None

        # the moments' second pass: squares centred on the exact mean; the
        # merge's Chan terms m2_i + n_i (mean_i - mean)^2
        means, cols = {}, []
        for j, (_, fn) in enumerate(self.agg_specs):
            if isinstance(fn, agg.MergeMoments):
                means[j] = len(cols)
                n, sm, m2 = moments(j)
                mean = fs[:, fix[j] + 1] / fs[:, fix[j]].clamp(min=1.0)
                term = m2 + n * (sm / n.clamp(min=1.0) - mean[gid]) ** 2
                cols.append(torch.where(svs[j], term, zero))
            elif isinstance(fn, agg._CentralMoment):
                means[j] = len(cols)
                mean = fs[:, fix[j]] / nonnulls[j].clamp(min=1)
                x = _as_f64(vvs[j][0].data, fn.child.data_type)
                cols.append(torch.where(svs[j], (x - mean[gid]) ** 2, zero))
        m2s = fsum(cols) if cols else None

        outs = []
        for j, (_, fn) in enumerate(self.agg_specs):
            if isinstance(fn, agg.SORT_ONLY_AGGS):
                outs.append(None)  # the sort-segment path fills it
                continue
            if isinstance(fn, agg.Count):
                w = live_cnt if fn.child is None else nonnulls[j]
                outs.append((w.to(torch.int64), exists))
                continue
            nonnull = nonnulls[j]
            has_any = (nonnull > 0) & exists
            if isinstance(fn, agg.MergeMoments):
                outs.append((torch.where(has_any, m2s[:, means[j]], zero),
                             has_any))
                continue
            ct = fn.child.data_type
            if isinstance(fn, (agg.Min, agg.Max)):
                outs.append(_minmax(fn, vvs[j][0].data, svs[j], gid, nseg,
                                    has_any))
            elif isinstance(fn, agg._Pick):
                outs.append(_pick(fn, vvs[j][0].data, svs[j], live, gid,
                                  nseg, exists))
            elif isinstance(fn, agg._CentralMoment):
                samp = isinstance(fn, (agg.StddevSamp, agg.VarianceSamp))
                denom = (nonnull - 1 if samp else nonnull).clamp(min=1)
                valid = ((nonnull > 1) & exists) if samp else has_any
                var = m2s[:, means[j]] / denom
                if isinstance(fn, (agg.StddevPop, agg.StddevSamp)):
                    var = torch.sqrt(var)
                outs.append((torch.where(valid, var, zero), valid))
            elif not _exact_sum(fn):
                s = fs[:, fix[j]]
                if isinstance(fn, agg.Average):
                    s = s / nonnull.clamp(min=1).to(torch.float64)
                outs.append((torch.where(has_any, s, zero), has_any))
            elif not isinstance(ct, T.DecimalType):
                outs.append((torch.where(has_any, isums[:, iix[j]], izero),
                             has_any))
            else:
                outs.append(_decimal_result(fn, isums[:, iix[j]:iix[j] + 4],
                                            nonnull, has_any))
        return outs


def _resort(data: torch.Tensor, valid: torch.Tensor, gid: torch.Tensor):
    """(gid, null flag, value words) sorted through the sort kernel, the
    ties in their order: the sorted operands, the permutation."""
    from spark_rapids_tpu_torch.ops.ordering import (
        comparable_operands,
        lex_sort,
    )
    d = data.to(torch.int32) if data.dtype == torch.bool else data
    ops = comparable_operands(torch.where(valid, d, torch.zeros_like(d)))
    n = data.shape[0]
    res = lex_sort([gid.to(torch.int32), (~valid).to(torch.int32)] + ops,
                   torch.arange(n, dtype=torch.int32, device=data.device))
    return res, res[-1].to(torch.int64)


def _sort_only(fn: agg.AggregateFunction, vv, sv: torch.Tensor,
               gid: torch.Tensor, capacity: int, nonnull: torch.Tensor,
               group_live: torch.Tensor):
    """(data, validity) of collect_list, collect_set or percentile over
    rows sorted by group (stable; live groups in [0, ngroups), dead rows
    at ``capacity + row``): the reference's sort-only route."""
    from spark_rapids_tpu_torch.columnar.nested import (
        ArrayData,
        offsets_from_counts,
    )
    from spark_rapids_tpu_torch.ops.scatter32 import compact_pairs
    data = vv.data
    dev = data.device
    if isinstance(fn, agg.Percentile):
        res, perm = _resort(data, sv, gid)
        sd = data[perm].to(torch.float64)
        size = segment_sum(torch.ones_like(gid), gid, 2 * capacity)[:capacity]
        start = torch.cumsum(size, 0) - size
        nn = nonnull.to(torch.int64)
        k = (nn - 1).to(torch.float64) * fn.percentage
        klo = torch.floor(k).to(torch.int64)
        khi = torch.ceil(k).to(torch.int64)
        vlo = sd[(start + klo).clamp(0, capacity - 1)]
        vhi = sd[(start + khi).clamp(0, capacity - 1)]
        out = vlo + (vhi - vlo) * (k - klo.to(torch.float64))
        validity = (nn > 0) & group_live
        return torch.where(validity, out, torch.zeros_like(out)), validity
    keep, gidv, sdv = sv, gid, data
    if isinstance(fn, agg.CollectSet):
        res, perm = _resort(data, sv, gid)
        gidv = gid[perm]
        sdv = data[perm]
        same = torch.zeros(capacity, dtype=torch.bool, device=dev)
        same[1:] = res[0][1:] == res[0][:-1]
        for o in res[2:-1]:
            o = o.view(torch.int32) if o.dtype == torch.uint32 else o
            same[1:] &= o[1:] == o[:-1]
        keep = (res[1] == 0) & ~same
    counts = segment_sum(keep.to(torch.int64), gidv,
                         2 * capacity)[:capacity]
    pairs, _ = compact_pairs([sdv], [keep], keep, capacity)
    # an empty array (not null) for a group whose values were all null
    return ArrayData(offsets_from_counts(counts), *pairs[0]), group_live


def _spec_valids(vvs, live: torch.Tensor):
    """Per spec, its live rows whose every value is non-null (None for
    COUNT(*))."""
    out = []
    for vv in vvs:
        sv = None
        if vv:
            sv = live
            for v in vv:
                sv = sv & v.validity
        out.append(sv)
    return out


def _decimal_result(fn: agg.AggregateFunction, words: torch.Tensor,
                    nonnull: torch.Tensor, has_any: torch.Tensor):
    """SUM or AVG of a decimal from its four word sums (nseg, 4): the
    128-bit sum, null on a 128-bit overflow; a SUM is also null when it
    needs more than its type's precision; an AVG is the exact sum as a
    double over count x 10^scale (one rounding of the sum)."""
    hi, lo, t3 = dec.carry_words(*words.unbind(dim=1))
    ovf = (t3 > 0x7FFFFFFF) | (t3 < -0x80000000)
    if isinstance(fn, agg.Average):
        valid = has_any & ~ovf
        scale = float(10 ** fn.child.data_type.scale)
        avg = dec.i128_to_f64(hi, lo) / (
            nonnull.clamp(min=1).to(torch.float64) * scale)
        return torch.where(valid, avg, torch.zeros_like(avg)), valid
    out_t = fn.data_type
    valid = has_any & ~ovf & dec.i128_abs_fits_pow10(hi, lo, out_t.precision)
    zero = torch.zeros_like(lo)
    if T.is_dec128(out_t):
        return (torch.stack([torch.where(valid, hi, zero),
                             torch.where(valid, lo, zero)], dim=1), valid)
    return torch.where(valid, lo, zero), valid
