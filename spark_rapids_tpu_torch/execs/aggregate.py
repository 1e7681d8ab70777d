"""Hash aggregate, the no-sort fast path (port of
``spark_rapids_tpu/execs/aggregate.py``: ``_fast_layout`` and
``_build_fast_kernel``).

When every grouping key is a dictionary-encoded string, the key domain is
known on the host (dictionary sizes), so each row's group id is a
mixed-radix combination of its codes, ``gid = sum(code_i * stride_i)``,
with one extra slot per key for null. Aggregation is then a direct
segment reduction over ``gpad`` (the padded domain product) segments:

* the live count and every spec's non-null count ride one int32
  ``index_add_`` (a torch op, as the reference leaves it to XLA);
* every f64 SUM/AVG rides one batched pass through the one-hot partials
  kernel (ops/segsum.py);
* the group slots that exist are packed through the compaction kernel
  (ops/scatter32.py).

Filters fused from the input chain (execs/fuse.py) are the row weight
mask: a dropped row, or a padding row past ``nrows``, adds to no sum,
count or group. What the slice does not reach raises NotImplementedError:
the sort-segment general path (non-string or high-cardinality keys, the
global aggregate), MIN/MAX, variance, integer sums and multi-batch merge.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import DeviceColumn, DeviceTable
from spark_rapids_tpu_torch.execs.base import TpuExec, single_batch
from spark_rapids_tpu_torch.ops import aggregates as agg
from spark_rapids_tpu_torch.ops.expr import (
    Expression,
    PrepCtx,
    eval_expr,
    prep_expr,
    table_vals,
)
from spark_rapids_tpu_torch.ops.segsum import batched_segment_sum_f64


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
    raise NotImplementedError(
        f"aggregate {fn.name} over "
        f"{fn.child.data_type.simple_string() if fn.child is not None else '*'}"
        " is not ported")


class TpuHashAggregateExec(TpuExec):
    def __init__(self, child: TpuExec, grouping: Sequence[Expression],
                 agg_specs: Sequence[Tuple[str, agg.AggregateFunction]],
                 grouping_names: Sequence[str],
                 filters: Sequence[Expression] = (),
                 max_dict_groups: int = 1 << 16):
        self.children = (child,)
        self.grouping = list(grouping)
        self.agg_specs = list(agg_specs)
        self.grouping_names = list(grouping_names)
        self.filters = list(filters)
        self.max_dict_groups = max_dict_groups
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

    def _fast_layout(self, key_preps) -> Optional[tuple]:
        """(sizes, strides, gpad) when every key is a dictionary string
        whose padded domain fits ``max_dict_groups``, else None."""
        if self.max_dict_groups <= 0 or not self.grouping:
            return None
        sizes: List[int] = []
        for g, preps in zip(self.grouping, key_preps):
            root = preps[-1]
            if not (isinstance(g.data_type, T.StringType)
                    and root.out_dict is not None):
                return None
            sizes.append(len(root.out_dict) + 1)  # +1: null slot
        total = 1
        for s in sizes:
            total *= max(s, 1)
        if total > self.max_dict_groups:
            return None
        strides = [1] * len(sizes)
        for i in range(len(sizes) - 2, -1, -1):
            strides[i] = strides[i + 1] * sizes[i + 1]
        # tight power-of-two segment count: a q1-style 12-slot domain
        # pads to 16, not to a table bucket
        gpad = max(8, 1 << (max(total - 1, 1)).bit_length())
        return sizes, strides, gpad

    def _aggregate(self, table: DeviceTable) -> DeviceTable:
        filter_preps, key_preps, val_preps = self._prep_all(table)
        fast = self._fast_layout(key_preps)
        if fast is None:
            raise NotImplementedError(
                "aggregate on the sort-segment path (grouping keys that are "
                "not dictionary strings, a global aggregate, or a key domain "
                f"over {self.max_dict_groups} groups) is not ported")
        sizes, strides, gpad = fast
        out_arrays, ngroups = self._fast_kernel(
            table, sizes, strides, gpad, filter_preps, key_preps, val_preps)
        out_cols: List[DeviceColumn] = []
        for i, g in enumerate(self.grouping):
            data, validity = out_arrays[i]
            root = key_preps[i][-1]
            out_cols.append(DeviceColumn(g.data_type, data, validity,
                                         dictionary=root.out_dict,
                                         dict_sorted=root.dict_sorted))
        for j, (_, fn) in enumerate(self.agg_specs):
            data, validity = out_arrays[len(self.grouping) + j]
            out_cols.append(DeviceColumn(fn.data_type, data, validity))
        names = self.grouping_names + [n for n, _ in self.agg_specs]
        return DeviceTable(names, out_cols, ngroups, gpad, table.device)

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

    def _fast_kernel(self, table: DeviceTable, sizes, strides, gpad: int,
                     filter_preps, key_preps, val_preps):
        dev, capacity = table.device, table.capacity
        cols = table_vals(table)

        def ev(e, preps):
            return eval_expr(e, preps, cols, table.nrows_dev, capacity, dev,
                             live=table.live)

        live = self._eval_live(table, filter_preps)

        gid = torch.zeros(capacity, dtype=torch.int32, device=dev)
        for i, (g, preps) in enumerate(zip(self.grouping, key_preps)):
            kv = ev(g, preps)
            code = torch.where(kv.validity, kv.data,
                               torch.full_like(kv.data, sizes[i] - 1))
            gid = gid + code * strides[i]

        vvs = [[ev(c, preps) for c, preps in zip(fn.children, per_child)]
               for (_, fn), per_child in zip(self.agg_specs, val_preps)]
        svs = [(vv[0].validity & live) if vv else None for vv in vvs]

        # one int32 segment sum for the live count + every spec's nonnull
        # count (a torch op: the reference leaves it to XLA)
        masks = [live] + [sv for sv in svs if sv is not None]
        mix = {}
        for j, sv in enumerate(svs):
            if sv is not None:
                mix[j] = len(mix) + 1
        mcnt = torch.zeros((gpad, len(masks)), dtype=torch.int32, device=dev)
        mcnt.index_add_(0, gid, torch.stack(masks, dim=1).to(torch.int32))
        nonnulls = {j: mcnt[:, i] for j, i in mix.items()}
        exists = mcnt[:, 0] > 0
        ngroups = exists.sum(dtype=torch.int32)

        pairs = []
        slot_ix = torch.arange(gpad, dtype=torch.int32, device=dev)
        for i in range(len(self.grouping)):
            slot = (slot_ix // strides[i]) % sizes[i]
            pairs.append((slot, slot != (sizes[i] - 1)))

        # every SUM/AVG rides one batched f64 pass
        splan = [j for j, (_, fn) in enumerate(self.agg_specs)
                 if isinstance(fn, (agg.Sum, agg.Average))]
        fcols = [torch.where(svs[j], vvs[j][0].data.to(torch.float64),
                             torch.zeros((), dtype=torch.float64, device=dev))
                 for j in splan]
        fsums_s = batched_segment_sum_f64(fcols, gid, gpad, capacity)
        fsums = {j: fsums_s[:, i] for i, j in enumerate(splan)}

        zero = torch.zeros((), dtype=torch.float64, device=dev)
        for j, (_, fn) in enumerate(self.agg_specs):
            if isinstance(fn, agg.Count):
                w = mcnt[:, 0] if fn.child is None else nonnulls[j]
                pairs.append((w.to(torch.int64), exists))
                continue
            nonnull = nonnulls[j]
            has_any = (nonnull > 0) & exists
            s = fsums[j]
            if isinstance(fn, agg.Average):
                s = s / nonnull.clamp(min=1).to(torch.float64)
            pairs.append((torch.where(has_any, s, zero), has_any))

        from spark_rapids_tpu_torch.ops.scatter32 import compact_pairs
        outs, _ = compact_pairs([d for d, _ in pairs], [v for _, v in pairs],
                                exists, gpad)
        return list(outs), ngroups
