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
threshold is ``min(outOfCoreThresholdBytes, MEMORY.scan_chunk_bytes())``,
as the reference's: under a small device budget a multi-batch sort goes
out of core even below the conf threshold. Pending batches are
SpillableBatches, and every device sort runs in the OOM retry loop
(``retry_block``)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import DeviceTable, bucket_for
from spark_rapids_tpu_torch.execs.base import (
    TpuExec,
    first_two,
    prepend,
    take,
)
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
        from spark_rapids_tpu_torch.columnar.table import concat_device
        from spark_rapids_tpu_torch.runtime.memory import MEMORY
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        from spark_rapids_tpu_torch.runtime.spill import (
            BufferCatalog,
            SpillableBatch,
        )
        it = self.children[0].execute_masked()
        items = first_two(it)
        if not items:
            return
        if len(items) == 1:
            first = take(items.pop())
            out = [retry_block(lambda: self._sort(first))]
            del first  # the input is not kept while the output is used
            yield out.pop()
            return
        device = items[0].device
        catalog = BufferCatalog.get()
        threshold = min(self.ooc_threshold_bytes, MEMORY.scan_chunk_bytes())
        pending, total = [], 0
        batches = prepend(items, it)
        try:
            for batch in batches:
                batch = take(batch)
                total += batch.device_nbytes()
                pending.append(SpillableBatch(batch, catalog))
                del batch
                if total > threshold:
                    # out of core: every batch becomes a sorted host run
                    self.add_metric("sortOutOfCore", 1)
                    spills, pending = pending, []
                    runs = sort_runs(self, prepend(spills, batches))
                    yield from sorted_run_stream(runs, self.orders, device)
                    return

            def merge_and_sort():
                return self._sort(concat_device([sb.get() for sb in pending]))

            out = retry_block(merge_and_sort)
        finally:
            for sb in pending:
                sb.release()
        yield out

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
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        k = self.limit
        tops = [retry_block(lambda b=b: self._sorter._topk(b, k))
                for b in self.children[0].execute_masked()]
        if not tops:
            return
        # a single top-k batch is already sorted
        final = tops[0] if len(tops) == 1 else retry_block(
            lambda: self._sorter._sort(concat_device(tops)))
        nrows = torch.clamp(final.nrows_dev, max=k).to(torch.int32)
        yield DeviceTable(final.names, final.columns, nrows, final.capacity,
                          final.device)


#: the name of a run's hidden first-key column
RUN_KEY = "__run_key"


def sort_runs(sorter: TpuSortExec, batches) -> list:
    """Each batch sorted on the device and moved to the host: the sorted
    runs of ``sorted_run_stream``, in input order. ``batches`` yields
    DeviceTables or SpillableBatches (each pinned while it sorts, then
    released); every sort runs in the OOM retry loop. A first sort key
    that is not a bound column is evaluated on the device before the move
    and rides as the run's last column (``RUN_KEY``); the merge drops it
    again. String columns keep their codes (``HostColumn.encoded``), so
    uploading a range encodes no string again."""
    from spark_rapids_tpu_torch.runtime.retry import retry_block
    from spark_rapids_tpu_torch.runtime.spill import SpillableBatch
    runs = []
    spills = []
    try:
        for b in batches:
            if isinstance(b, SpillableBatch):
                spills.append(b)
                with b.pinned_batch() as dt:
                    runs.append(retry_block(
                        lambda d=dt: _host_run(sorter, d)))
                del dt
                b.release()
            else:
                runs.append(retry_block(lambda d=b: _host_run(sorter, d)))
            del b
    finally:
        for sb in spills:
            sb.release()
    return runs


def _host_run(sorter: TpuSortExec, b: DeviceTable):
    """One batch sorted on the device, with its hidden first key, as a
    HostTable."""
    from spark_rapids_tpu_torch.columnar import DeviceColumn, HostTable
    from spark_rapids_tpu_torch.ops.expr import BoundReference
    key = sorter.orders[0].expr
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
    return HostTable(t.names, cols)


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
    RANGE-frame window's peers whole. A range aims at ``target_rows``
    (the largest run's rows when None). A range is a landing, so under
    the device budget it holds at most the rows of the budget's scan
    chunk (runtime/memory.py): the target is capped to them, and a range
    of one first key that is still larger is cut on the following keys
    (``_tie_pieces``), each piece keeping its ties on every key (a
    RANGE frame's peers) whole. ``runs``: HostTables from ``sort_runs``,
    each sorted by ``orders``; their hidden first-key column, if any, is
    dropped from the output."""
    from spark_rapids_tpu_torch.columnar.table import (
        concat_host,
        upload_host_table,
    )
    from spark_rapids_tpu_torch.ops.expr import BoundReference
    from spark_rapids_tpu_torch.runtime.memory import (
        MEMORY,
        estimate_device_nbytes,
    )
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
    row_bytes = max(estimate_device_nbytes(runs[0], 1), 1)
    max_rows = max(MEMORY.scan_chunk_bytes() // row_bytes, 1)
    target_rows = min(target_rows, max_rows)
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

    def emit_one(host):
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        t = retry_block(
            lambda: sorter._sort(upload_host_table(host, device)))
        if hidden:
            t = DeviceTable(t.names[:-1], t.columns[:-1], t.nrows_dev,
                            t.capacity, t.device)
        return t

    def emit(parts):
        host = concat_host(parts)
        pieces = (_tie_pieces(host, orders, hidden, max_rows)
                  if host.num_rows > max_rows else None)
        for piece in pieces or [host]:
            yield emit_one(piece)

    ranges = [(bounds[i - 1] if i else None,
               bounds[i] if i < len(bounds) else None)
              for i in range(len(bounds) + 1)]
    if not asc:
        ranges = ranges[::-1]  # the larger keys first
    if nulls_first and null_parts():
        yield from emit(null_parts())
    for lo_b, hi_b in ranges:
        parts = run_slices(lo_b, hi_b)
        if parts:
            yield from emit(parts)
    if not nulls_first and null_parts():
        yield from emit(null_parts())


def _tie_pieces(host, orders: Sequence[SortOrder], hidden: bool,
                max_rows: int):
    """``host`` (rows of the sorted runs) cut into consecutive pieces of
    its sort order, each of about ``max_rows`` rows and each holding
    every row that ties with its rows on all the sort keys; a piece keeps
    its rows in ``host``'s order, so the device's stable sort of each
    gives the order a sort of the whole would. None when a key after the
    first is computed (it has no column here), and the range lands
    whole."""
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    from spark_rapids_tpu_torch.ops.expr import BoundReference
    keys = []
    for i, o in enumerate(orders):
        if i == 0 and hidden:
            c = host.columns[-1]
        elif isinstance(o.expr, BoundReference):
            c = host.columns[o.expr.ordinal]
        else:
            return None
        valid = np.asarray(c.validity, dtype=bool)
        nulls_first = o.resolved_nulls_first()
        keys.append(np.where(valid, 1, 0) if nulls_first
                    else np.where(valid, 0, 1))
        for k in _host_order_keys(c, valid):
            keys.append(k if o.ascending else ~k)  # ~: order-reversing
    # np.lexsort sorts by its last key first and is stable
    order = np.lexsort(keys[::-1])
    n = len(order)
    new_group = np.zeros(n, dtype=bool)
    new_group[0] = True
    for k in keys:
        ks = k[order]
        new_group[1:] |= ks[1:] != ks[:-1]
    starts = np.flatnonzero(new_group)
    pieces, a = [], 0
    while a < n:
        j = int(np.searchsorted(starts, a + max_rows, "left"))
        b = int(starts[j]) if j < len(starts) else n
        rows = np.sort(order[a:b])
        cols = []
        for c in host.columns:
            hc = HostColumn(c.dtype, c.data[rows], c.validity[rows])
            enc = c._cache.get("encode")
            if enc is not None:
                hc._cache["encode"] = (enc[0][rows], enc[1])
            cols.append(hc)
        pieces.append(HostTable(host.names, cols))
        a = b
    return pieces


def _host_order_keys(c, valid) -> list:
    """int64 arrays whose lexicographic order is Spark's order of the
    column's valid rows (0 at null rows): string codes of the sorted
    dictionary; integers as they are; floats by their bits made
    order-preserving, with -0.0 equal to 0.0 and every NaN one value
    above +inf; DECIMAL128 as its signed high and unsigned low limbs."""
    from spark_rapids_tpu_torch.columnar.column import dec128_limbs
    if isinstance(c.dtype, T.StringType):
        ks = [c.encoded()[0].astype(np.int64)]
    elif T.is_dec128(c.dtype):
        limbs = dec128_limbs(c.data, valid, len(valid))
        # the low limb compares unsigned: flip its sign bit
        ks = [limbs[:, 0], limbs[:, 1] ^ np.int64(-2 ** 63)]
    elif c.data.dtype.kind == "f":
        x = c.data.astype(np.float64) + 0.0  # -0.0 -> 0.0
        x = np.where(np.isnan(x), np.nan, x)  # one NaN
        bits = x.view(np.int64)
        ks = [np.where(bits < 0, bits ^ np.int64(2 ** 63 - 1), bits)]
    else:
        ks = [c.data.astype(np.int64)]
    return [np.where(valid, k, 0) for k in ks]
