"""Device sort, top-k and the out-of-core sorted-run merge (port of
``spark_rapids_tpu/execs/sort.py``: ``_directional``, ``TpuSortExec`` with
``_topk``, ``_ooc_stream`` and ``for_orders``,
``TpuTakeOrderedAndProjectExec`` and ``sorted_run_stream``).

Each sort key becomes ascending 32-bit operands (ops/ordering.py): a
null-placement flag first, descending order by complement. Padding and
dead rows park last through a leading liveness operand, so the sort also
compacts a masked input. An int32 row-index payload gives the permutation
that gathers every output column.

The sort reads its input through a coalesce that stops at
``spark.rapids.sql.sort.outOfCoreThresholdBytes`` (overrides/rules.py),
as the reference's pre-sort coalesce does. Batches that reach the sort
concatenate on the device while their total stays under the threshold;
past it each batch sorts on the device and moves to the host as a sorted
run, and ``sorted_run_stream`` merges the runs range by range. The
reference also caps the threshold by its memory manager's scan chunk;
the port has no memory manager and uses the conf value alone."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import DeviceTable, bucket_for
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.ops.expr import (
    PrepCtx,
    eval_expr,
    prep_expr,
    table_vals,
)
from spark_rapids_tpu_torch.plan.nodes import SortOrder


def _directional(data: torch.Tensor, validity: torch.Tensor, ascending: bool,
                 nulls_first: bool) -> List[torch.Tensor]:
    """(null_flag, *key_operands) for an ascending lexicographic sort that
    realizes the requested direction and null placement."""
    from spark_rapids_tpu_torch.ops.ordering import (
        comparable_operands,
        descending_operands,
        zero_invalid,
    )
    ops = comparable_operands(zero_invalid(data, validity))
    if not ascending:
        ops = descending_operands(ops)
    # the flag sorts ahead of the key: 0 first, so invalid rows get 0 when
    # nulls_first else 1 (made on the device: a scalar tensor built from a
    # Python int would upload, a host sync)
    v = validity.to(torch.int32)
    return [v if nulls_first else 1 - v] + ops


class TpuSortExec(TpuExec):
    def __init__(self, child: TpuExec, orders: Sequence[SortOrder],
                 ooc_threshold_bytes: int = 1 << 30):
        self.children = (child,)
        self.orders = list(orders)
        #: spark.rapids.sql.sort.outOfCoreThresholdBytes
        self.ooc_threshold_bytes = ooc_threshold_bytes

    @classmethod
    def for_orders(cls, orders: Sequence[SortOrder]) -> "TpuSortExec":
        """A sorter over ``orders`` with no child (the range merge and the
        window streams call its ``_sort``)."""
        return cls(None, orders)

    def output_schema(self):
        return self.children[0].output_schema()

    def execute(self):
        from itertools import chain

        from spark_rapids_tpu_torch.columnar.table import concat_device
        from spark_rapids_tpu_torch.execs.basic import device_nbytes
        it = self.children[0].execute_masked()
        first = next(it, None)
        if first is None:
            return
        second = next(it, None)
        if second is None:
            yield self._sort(first)
            return
        pending, total = [], 0
        batches = chain([first, second], it)
        for batch in batches:
            pending.append(batch)
            total += device_nbytes(batch)
            if total > self.ooc_threshold_bytes:
                # out of core: every batch becomes a sorted host run
                self.add_metric("sortOutOfCore", 1)
                runs = sort_runs(self, chain(pending, batches))
                yield from sorted_run_stream(runs, self.orders,
                                             first.device)
                return
        yield self._sort(concat_device(pending))

    def _sort(self, table: DeviceTable) -> DeviceTable:
        perm = self._sorted_perm(table)
        new_cols = [c.with_arrays(c.data[perm], c.validity[perm])
                    for c in table.columns]
        return DeviceTable(table.names, new_cols, table.nrows_dev,
                           table.capacity, table.device)

    def _topk(self, table: DeviceTable, k: int) -> DeviceTable:
        """The first ``k`` rows in sort order at a k-sized capacity: the
        sort carries only the key operands and a row-index payload, then
        the k winning rows of every column are gathered."""
        capacity = table.capacity
        kcap = min(bucket_for(max(k, 1)), capacity)
        idx = self._sorted_perm(table)[:kcap]
        if table.live is not None:
            n_live = table.live.sum(dtype=torch.int32)
        else:
            n_live = table.nrows_dev
        n_out = torch.clamp(n_live, max=k).to(torch.int32)
        out_live = torch.arange(kcap, dtype=torch.int32,
                                device=table.device) < n_out
        cols = [c.with_arrays(c.data[idx], c.validity[idx] & out_live)
                for c in table.columns]
        return DeviceTable(table.names, cols, n_out, kcap, table.device)

    def _sorted_perm(self, table: DeviceTable) -> torch.Tensor:
        """int64 row permutation into sort order; dead rows last."""
        from spark_rapids_tpu_torch.ops.ordering import lex_sort
        pctx = PrepCtx(table)
        key_preps = [prep_expr(o.expr, pctx) for o in self.orders]
        if any(p[-1].out_dict is not None and not p[-1].dict_sorted
               for p in key_preps):
            raise NotImplementedError("sorting a string key over an "
                                      "unsorted dictionary is not ported")
        cols = table_vals(table)
        capacity, dev = table.capacity, table.device
        operands = [(~table.row_mask()).to(torch.int32)]  # dead rows last
        for o, preps in zip(self.orders, key_preps):
            kv = eval_expr(o.expr, preps, cols, table.nrows_dev, capacity,
                           dev, live=table.live)
            operands.extend(_directional(kv.data, kv.validity, o.ascending,
                                         o.resolved_nulls_first()))
        payload = torch.arange(capacity, dtype=torch.int32, device=dev)
        return lex_sort(operands, payload)[-1].to(torch.int64)


class TpuTakeOrderedAndProjectExec(TpuExec):
    """ORDER BY + LIMIT n: a device top-k per batch, then one sort of the
    concatenated top-k rows when there are several batches; the full
    sorted input never materializes."""

    def __init__(self, child: TpuExec, orders: Sequence[SortOrder],
                 limit: int):
        self.children = (child,)
        self.orders = list(orders)
        self.limit = int(limit)
        self._sorter = TpuSortExec(child, orders)

    def output_schema(self):
        return self.children[0].output_schema()

    def execute(self):
        from spark_rapids_tpu_torch.columnar.table import concat_device
        k = self.limit
        tops = [self._sorter._topk(b, k)
                for b in self.children[0].execute_masked()]
        if not tops:
            return
        # a single top-k batch is already sorted
        final = tops[0] if len(tops) == 1 else self._sorter._sort(
            concat_device(tops))
        nrows = torch.clamp(final.nrows_dev, max=k).to(torch.int32)
        yield DeviceTable(final.names, final.columns, nrows, final.capacity,
                          final.device)


#: the name of a run's hidden first-key column
RUN_KEY = "__run_key"


def sort_runs(sorter: TpuSortExec, batches) -> list:
    """Each batch sorted on the device and moved to the host: the sorted
    runs of ``sorted_run_stream``. A first sort key that is not a bound
    column is evaluated on the device before the move and rides as the
    run's last column (``RUN_KEY``); the merge drops it again. String
    columns keep their codes (``HostColumn.encoded``), so uploading a
    range encodes no string again."""
    from spark_rapids_tpu_torch.columnar import DeviceColumn, HostTable
    from spark_rapids_tpu_torch.ops.expr import BoundReference
    key = sorter.orders[0].expr
    runs = []
    for b in batches:
        t = sorter._sort(b)
        if not isinstance(key, BoundReference):
            preps = prep_expr(key, PrepCtx(t))
            kv = eval_expr(key, preps, table_vals(t), t.nrows_dev,
                           t.capacity, t.device)
            t = DeviceTable(
                t.names + (RUN_KEY,),
                t.columns + (DeviceColumn(
                    key.data_type, kv.data, kv.validity,
                    dictionary=preps[-1].out_dict,
                    dict_sorted=preps[-1].dict_sorted),), t.nrows_dev,
                t.capacity, t.device)
        n = t.num_rows
        cols = []
        for dc in t.columns:
            data = dc.data[:n].cpu().numpy()
            valid = np.ascontiguousarray(dc.validity[:n].cpu().numpy())
            hc = dc.decode_host(data, valid)
            if isinstance(dc.dtype, T.StringType) and dc.dict_sorted \
                    and dc.dictionary is not None and len(dc.dictionary):
                codes = np.clip(data, 0, len(dc.dictionary) - 1)
                hc._cache["encode"] = (
                    np.where(valid, codes, 0).astype(np.int32),
                    dc.dictionary)
            cols.append(hc)
        runs.append(HostTable(t.names, cols))
    return runs


def _first_keys(runs, ci: int):
    """Each run's column ``ci`` as comparable numpy values: strings as
    codes of the runs' union dictionary, everything else as stored."""
    cols = [r.columns[ci] for r in runs]
    if not isinstance(cols[0].dtype, T.StringType):
        return [c.data for c in cols]
    encs = [c.encoded() for c in cols]
    union = np.unique(np.concatenate([e[1].astype(object) for e in encs]))
    return [np.searchsorted(union, e[1]).astype(np.int32)[e[0]]
            if len(e[1]) else e[0] for e in encs]


def sorted_run_stream(runs, orders: Sequence[SortOrder], device,
                      target_rows: int = None):
    """Merge HOST sorted runs into a stream of globally ordered DEVICE
    batches without holding the whole table on the device (the
    reference's merge of spilled sorted runs): the FIRST sort key's value
    space splits into quantile ranges; each range gathers its slice of
    every run (a binary search per run, the runs being sorted), uploads
    it and sorts it on the device. Rows with EQUAL first keys always land
    in one output batch (the bounds are cut points), which keeps a
    RANGE-frame window's peers whole. ``runs``: HostTables from
    ``sort_runs``, each sorted by ``orders``; their hidden first-key
    column, if any, is dropped from the output."""
    from spark_rapids_tpu_torch.columnar.table import (
        concat_host,
        upload_host_table,
    )
    from spark_rapids_tpu_torch.ops.expr import BoundReference
    o0 = orders[0]
    asc = o0.ascending
    nulls_first = o0.resolved_nulls_first()
    hidden = not isinstance(o0.expr, BoundReference)
    ci = len(runs[0].names) - 1 if hidden else o0.expr.ordinal

    # first-key values and each run's null span (contiguous: it is sorted)
    keys, spans = [], []
    for run, kd in zip(runs, _first_keys(runs, ci)):
        n = run.num_rows
        nn = int(run.columns[ci].validity.sum())
        if nulls_first:
            null_lo, null_hi, lo, hi = 0, n - nn, n - nn, n
        else:
            null_lo, null_hi, lo, hi = nn, n, 0, nn
        vals = kd[lo:hi]
        keys.append(vals if asc else vals[::-1])  # an ascending view
        spans.append((null_lo, null_hi, lo, hi))

    total = sum(k.shape[0] for k in keys)
    if target_rows is None:
        target_rows = max((r.num_rows for r in runs), default=1)
    nparts = max(1, -(-total // max(target_rows, 1)))
    bounds = []
    if total:
        # the cut points are order statistics of every run's first keys:
        # a partition finds them without sorting all of them
        allvals = np.concatenate([np.asarray(k) for k in keys])
        kth = sorted({(total * i) // nparts for i in range(1, nparts)})
        if kth:
            picked = (np.sort(allvals) if allvals.dtype == object
                      else np.partition(allvals, kth))[kth]
            for b in picked:
                if not bounds or b != bounds[-1]:
                    bounds.append(b)

    def run_slices(lo_b, hi_b):
        """Each run's rows whose first key lies in [lo_b, hi_b)."""
        parts = []
        for run, k, (_, _, lo, hi) in zip(runs, keys, spans):
            a = 0 if lo_b is None else int(np.searchsorted(k, lo_b, "left"))
            b = k.shape[0] if hi_b is None else int(
                np.searchsorted(k, hi_b, "left"))
            if b <= a:
                continue
            # a descending run's ascending view counts from its end
            parts.append(run.slice(lo + a, b - a) if asc
                         else run.slice(hi - b, b - a))
        return parts

    def null_parts():
        return [run.slice(nlo, nhi - nlo)
                for run, (nlo, nhi, _, _) in zip(runs, spans) if nhi > nlo]

    sorter = TpuSortExec.for_orders(orders)

    def emit(parts):
        t = sorter._sort(upload_host_table(concat_host(parts), device))
        if hidden:
            t = DeviceTable(t.names[:-1], t.columns[:-1], t.nrows_dev,
                            t.capacity, t.device)
        return t

    ranges = [(bounds[i - 1] if i else None,
               bounds[i] if i < len(bounds) else None)
              for i in range(len(bounds) + 1)]
    if not asc:
        ranges = ranges[::-1]  # the larger keys first
    if nulls_first and null_parts():
        yield emit(null_parts())
    for lo_b, hi_b in ranges:
        parts = run_slices(lo_b, hi_b)
        if parts:
            yield emit(parts)
    if not nulls_first and null_parts():
        yield emit(null_parts())
