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
* every f64 SUM/AVG rides one batched pass (ops/segsum.py): the one-hot
  partials kernel up to 32 segments, one ``index_add_`` above;
* every MIN/MAX is one ``segment_minmax_64`` (the ``fused_minmax``
  kernel), INT and DATE values widened to int64 for it;
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

Filters fused from the input chain (execs/fuse.py) are the row weight
mask: a dropped row, or a padding row past ``nrows``, adds to no sum,
count, extreme or group. What the slice does not reach raises
NotImplementedError: variance, integer sums, MIN/MAX of other types than
LONG, DOUBLE, INT and DATE, and multi-batch merge.
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
from spark_rapids_tpu_torch.execs.base import TpuExec, single_batch
from spark_rapids_tpu_torch.ops import aggregates as agg
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

#: sort-segment outputs up to this capacity keep their size (the
#: reference's DeviceTable.EMBED_NROWS_CAP, below which it does not
#: speculate a shrink)
EMBED_NROWS_CAP = 1 << 16

#: integer-family key types the no-sort layout codes by value - min
_INT_KEY_TYPES = (T.ByteType, T.ShortType, T.IntegerType, T.LongType,
                  T.DateType, T.TimestampType)

#: value types MIN/MAX take (INT and DATE widen to int64 for the kernel)
_MINMAX_TYPES = (T.LongType, T.DoubleType, T.IntegerType, T.DateType)


def check_agg_supported(fn: agg.AggregateFunction) -> None:
    """Raise NotImplementedError for an aggregate the port does not run."""
    if isinstance(fn, agg.Count):
        return
    if isinstance(fn, agg.Average):
        if isinstance(fn.child.data_type, (T.NumericType,)) and not \
                isinstance(fn.child.data_type, T.DecimalType):
            return
    elif isinstance(fn, agg.Sum):
        if isinstance(fn.child.data_type, (T.FloatType, T.DoubleType)):
            return
    elif isinstance(fn, (agg.Min, agg.Max)):
        if isinstance(fn.child.data_type, _MINMAX_TYPES):
            return
    raise NotImplementedError(
        f"aggregate {fn.name} over "
        f"{fn.child.data_type.simple_string() if fn.child is not None else '*'}"
        " is not ported")


def _minmax(fn: agg.AggregateFunction, data: torch.Tensor,
            valid: torch.Tensor, gid: torch.Tensor, nseg: int,
            has_any: torch.Tensor):
    """(data, validity) of one MIN/MAX over ``nseg`` segments: INT and DATE
    values widen to int64 for the kernel and narrow back; slots without a
    non-null value hold 0 and are null."""
    wide = data if data.dtype in (torch.int64, torch.float64) else \
        data.to(torch.int64)
    r = segment_minmax_64(isinstance(fn, agg.Min), wide, valid, gid, nseg)
    r = torch.where(has_any, r, torch.zeros((), dtype=r.dtype,
                                            device=r.device))
    return r.to(data.dtype), has_any


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
        table = single_batch(self.children[0].execute_masked(), "aggregate")
        if table is not None:
            yield self._aggregate(table)

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
        fast = self._fast_layout(key_preps, table.capacity)
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
        predicate non-null true."""
        live = table.row_mask()
        cols = table_vals(table)
        for f, preps in zip(self.filters, filter_preps):
            pred = eval_expr(f, preps, cols, table.nrows_dev,
                             table.capacity, table.device, live=table.live)
            live = live & pred.data & pred.validity
        return live

    def _eval_all(self, table, filter_preps, key_preps, val_preps):
        """(live, key DevVals, per-spec value DevVals)."""
        cols = table_vals(table)

        def ev(e, preps):
            return eval_expr(e, preps, cols, table.nrows_dev, table.capacity,
                             table.device, live=table.live)

        live = self._eval_live(table, filter_preps)
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

        svs = [(vv[0].validity & live) if vv else None for vv in vvs]

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

        # every SUM/AVG rides one batched f64 pass
        splan = [j for j, (_, fn) in enumerate(self.agg_specs)
                 if isinstance(fn, (agg.Sum, agg.Average))]
        zero = torch.zeros((), dtype=torch.float64, device=dev)
        fcols = [torch.where(svs[j], vvs[j][0].data.to(torch.float64), zero)
                 for j in splan]
        fsums_s = batched_segment_sum_f64(fcols, gid, gpad, capacity)
        fsums = {j: fsums_s[:, i] for i, j in enumerate(splan)}

        for j, (_, fn) in enumerate(self.agg_specs):
            if isinstance(fn, agg.Count):
                w = mcnt[:, 0] if fn.child is None else nonnulls[j]
                pairs.append((w.to(torch.int64), exists))
                continue
            nonnull = nonnulls[j]
            has_any = (nonnull > 0) & exists
            if isinstance(fn, (agg.Min, agg.Max)):
                pairs.append(_minmax(fn, vvs[j][0].data, svs[j], gid, gpad,
                                     has_any))
                continue
            s = fsums[j]
            if isinstance(fn, agg.Average):
                s = s / nonnull.clamp(min=1).to(torch.float64)
            pairs.append((torch.where(has_any, s, zero), has_any))

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

        operands = [(~live).to(torch.int32)]  # dead rows last
        for kv in kvs:
            operands.append((~kv.validity).to(torch.int32))
            operands.extend(comparable_operands(zero_invalid(kv.data,
                                                             kv.validity)))
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
        # dead rows add nothing; they park past the groups, each on its
        # own segment (the reference parks them all on the last one, whose
        # atomics would then serialize)
        rows = torch.arange(capacity, dtype=torch.int64, device=dev)
        gid = torch.where(s_live, gid, capacity + rows)
        nseg = 2 * capacity
        ngroups = new_group.sum(dtype=torch.int32)
        group_live = torch.arange(capacity, dtype=torch.int32,
                                  device=dev) < ngroups

        outs = []
        # key columns: each group's rows share its key; scatter to the slot
        for kv in kvs:
            kd = torch.zeros(nseg, dtype=kv.data.dtype, device=dev)
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

        zero = torch.zeros((), dtype=torch.float64, device=gid.device)
        outs = []
        for (_, fn), vv in zip(self.agg_specs, vvs):
            if isinstance(fn, agg.Count):
                w = live if fn.child is None else vv[0].validity & live
                outs.append((seg(w.to(torch.int32)).to(torch.int64),
                             group_live))
                continue
            sv = vv[0].validity & live
            nonnull = seg(sv.to(torch.int32))
            has_any = (nonnull > 0) & group_live
            if isinstance(fn, (agg.Min, agg.Max)):
                # dead rows are not valid, so their gid past the segments
                # is never read
                outs.append(_minmax(fn, vv[0].data, sv, gid, capacity,
                                    has_any))
                continue
            v = torch.where(sv, vv[0].data.to(torch.float64), zero)
            s = seg(v)
            if isinstance(fn, agg.Average):
                s = s / nonnull.clamp(min=1).to(torch.float64)
            outs.append((torch.where(has_any, s, zero), has_any))
        return outs
