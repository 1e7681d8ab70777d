"""Window execs (port of ``TpuWindowExec``'s per-batch window and of
``TpuWindowGroupLimitExec`` from ``spark_rapids_tpu/execs/window.py``),
for the ranking functions: row_number, rank and dense_rank.

Each batch is windowed by one sort per distinct spec, through the radix
sort (ops/ordering.py ``lex_sort``): the operands are the liveness, each
partition key as (null flag, order-isomorphic words) and each order key
as its directional operands, with an int32 row-index payload. Partition
and peer boundaries are read off the SORTED operands (a word that
differs from the row before), so -0.0 and 0.0 and every NaN fall in one
group, as the reference's peer test has them. Then, per row in sort
order:

  row_number = idx - seg_start + 1
  rank       = peer_start - seg_start + 1
  dense_rank = segmented count of peer-group starts

and the values are scattered back to input row order (the child's
columns stay where they are). The group limit ranks the same way and
yields a MASKED batch keeping the rows ranked at most ``limit``.

The reference's streaming, bounded-frame and two-pass windows and its
keyed batching (``TpuKeyedBatchExec``, a hash exchange of a multi-batch
input on the partition keys) are not ported: the window reads its input
as one batch and raises on a second."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar import DeviceColumn, DeviceTable
from spark_rapids_tpu_torch.execs.base import TpuExec, single_batch
from spark_rapids_tpu_torch.ops.expr import (
    PrepCtx,
    eval_expr,
    prep_expr,
    table_vals,
)
from spark_rapids_tpu_torch.ops.window import RANK_KINDS, WindowExpression


def _eval_keys(table: DeviceTable, exprs) -> list:
    """DevVals of ``exprs`` over ``table`` (a string key must have a
    sorted dictionary: its codes then order and group as the strings)."""
    pctx = PrepCtx(table)
    preps = [prep_expr(e, pctx) for e in exprs]
    if any(p[-1].out_dict is not None and not p[-1].dict_sorted
           for p in preps):
        raise NotImplementedError("a window key over an unsorted string "
                                  "dictionary is not ported")
    cols = table_vals(table)
    return [eval_expr(e, p, cols, table.nrows_dev, table.capacity,
                      table.device, live=table.live)
            for e, p in zip(exprs, preps)]


def _breaks(sorted_ops: Sequence[torch.Tensor]) -> torch.Tensor:
    """Rows whose operand tuple differs from the row before (row 0: the
    caller's ``first``)."""
    out = None
    for o in sorted_ops:
        w = o.view(torch.int32) if o.dtype == torch.uint32 else o
        d = w != torch.roll(w, 1)
        out = d if out is None else out | d
    return out


def _last_start(flags: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per row, the position of the last row at or before it whose flag is
    set (``flags[0]`` is set): the reference's max-scan of
    where(flags, idx, 0), as a running count of the flags and a lookup of
    each group's start. (torch.cummax would do it in one call, but its
    CUDA scan of one long row runs in a single block: 10.7 ms at 2^22
    rows on an H100.)"""
    n = flags.shape[0]
    group = torch.cumsum(flags, 0, dtype=torch.int32).to(torch.int64) - 1
    # each group's start writes slot `group`, every other row a slot of
    # its own past n: no two rows write one slot
    start = torch.empty(2 * n, dtype=idx.dtype, device=idx.device)
    start[torch.where(flags, group, idx.to(torch.int64) + n)] = idx
    return start[group]


def _segmented_cumsum(v: torch.Tensor, seg_start: torch.Tensor
                      ) -> torch.Tensor:
    """Inclusive prefix sum restarting at each segment: cumsum(v) minus the
    exclusive total at the segment's start."""
    c = torch.cumsum(v, 0, dtype=v.dtype)
    s = seg_start.to(torch.int64)
    return c - (c[s] - v[s])


def rank_sorted(table: DeviceTable, partition_exprs, orders
                ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Sort ``table``'s rows by (dead last, partition keys, orders) and
    rank them. Returns (perm, idx, {"live", "seg_start", "peer_start",
    "new_peer"}): ``perm`` the sorted rows' input positions (int64),
    ``idx`` the sorted positions (int32), each dict entry in sort order."""
    from spark_rapids_tpu_torch.execs.sort import _directional
    from spark_rapids_tpu_torch.ops.ordering import (
        comparable_operands,
        lex_sort,
        zero_invalid,
    )
    capacity, dev = table.capacity, table.device
    live = table.row_mask()
    operands = [(~live).to(torch.int32)]
    for kv in _eval_keys(table, partition_exprs):
        operands.append((~kv.validity).to(torch.int32))
        operands.extend(comparable_operands(zero_invalid(kv.data,
                                                         kv.validity)))
    n_part = len(operands) - 1
    for o, kv in zip(orders, _eval_keys(table, [o.expr for o in orders])):
        operands.extend(_directional(kv.data, kv.validity, o.ascending,
                                     o.resolved_nulls_first()))
    idx = torch.arange(capacity, dtype=torch.int32, device=dev)
    res = lex_sort(operands, idx)
    perm = res[-1].to(torch.int64)
    first = idx == 0
    new_seg = first
    if n_part:
        new_seg = new_seg | _breaks(res[1:1 + n_part])
    new_peer = new_seg
    if len(res) - 1 > 1 + n_part:
        new_peer = new_peer | _breaks(res[1 + n_part:-1])
    return perm, idx, {"live": live[perm],
                       "seg_start": _last_start(new_seg, idx),
                       "peer_start": _last_start(new_peer, idx),
                       "new_peer": new_peer}


def rank_values(kind: str, idx: torch.Tensor, ranks: dict) -> torch.Tensor:
    """int32 ranks in sort order: ``kind`` is rownumber, rank or
    denserank."""
    seg_start = ranks["seg_start"]
    if kind == "rownumber":
        return idx - seg_start + 1
    if kind == "rank":
        return ranks["peer_start"] - seg_start + 1
    return _segmented_cumsum(ranks["new_peer"].to(torch.int32), seg_start)


class TpuWindowExec(TpuExec):
    """Appends each window column to its one input batch, which holds
    every partition group whole (the reference's ``per_batch`` window)."""

    def __init__(self, child: TpuExec,
                 window_cols: Sequence[Tuple[str, WindowExpression]]):
        self.children = (child,)
        self.window_cols = list(window_cols)

    def output_schema(self):
        return (self.children[0].output_schema()
                + [(n, w.data_type) for n, w in self.window_cols])

    def execute(self):
        table = single_batch(self.children[0].execute(),
                             "keyed batching for a window")
        if table is not None:
            yield self._window(table)

    def _window(self, table: DeviceTable) -> DeviceTable:
        from spark_rapids_tpu_torch.ops.scatter32 import scatter_pair
        sorted_by_spec = {}  # one sort per distinct spec
        names, cols = list(table.names), list(table.columns)
        for name, w in self.window_cols:
            kind = RANK_KINDS[type(w.function)]
            key = w.spec.key()
            if key not in sorted_by_spec:
                sorted_by_spec[key] = rank_sorted(
                    table, w.spec.partition_exprs, w.spec.orders)
            perm, idx, ranks = sorted_by_spec[key]
            vals = rank_values(kind, idx, ranks)
            # back to INPUT row order: window columns of different specs
            # stay aligned with the child's columns
            d, v = scatter_pair(table.capacity, perm, vals, ranks["live"])
            names.append(name)
            cols.append(DeviceColumn(w.data_type, d, v))
        return DeviceTable(names, cols, table.nrows_dev, table.capacity,
                           table.device)


class TpuWindowGroupLimitExec(TpuExec):
    """Pre-window group limit: one sort ranks every row within its
    partition and the output is a MASKED batch keeping rank <= limit, at
    most limit (plus ties) rows per partition. Purely an optimization:
    the exact rank filter above still applies."""

    produces_masked = True

    def __init__(self, child: TpuExec, partition_exprs, orders,
                 rank_kind: str, limit: int):
        self.children = (child,)
        self.partition_exprs = list(partition_exprs)
        self.orders = list(orders)
        self.rank_kind = rank_kind
        self.limit = int(limit)

    def output_schema(self):
        return self.children[0].output_schema()

    def execute_masked(self):
        for batch in self.children[0].execute_masked():
            yield self._limit_batch(batch)

    def _limit_batch(self, table: DeviceTable) -> DeviceTable:
        perm, idx, ranks = rank_sorted(table, self.partition_exprs,
                                       self.orders)
        rank = rank_values(self.rank_kind, idx, ranks)
        keep_sorted = ranks["live"] & (rank <= self.limit)
        keep = torch.zeros(table.capacity, dtype=torch.bool,
                           device=table.device)
        keep[perm] = keep_sorted
        self.add_metric("groupLimitBatches", 1)
        return DeviceTable(table.names, table.columns,
                           keep.sum(dtype=torch.int32), table.capacity,
                           table.device, live=keep)


def unsupported_reasons(w: WindowExpression) -> List[str]:
    """Why a window column cannot run on the port (empty when it can):
    only the ranking functions with an ORDER BY and the default frame
    are ported."""
    from spark_rapids_tpu_torch.ops.aggregates import AggregateFunction
    fn = type(w.function).__name__
    if type(w.function) not in RANK_KINDS:
        what = ("an aggregate window" if isinstance(
            w.function, AggregateFunction) else "the window function")
        return [f"{what} {fn} is not ported (row_number, rank and "
                "dense_rank are; percent_rank, nth_value, lag, lead and "
                "aggregate windows are not)"]
    out = []
    if not w.spec.orders:
        out.append(f"{fn} requires an ORDER BY")
    if w.spec.frame is not None:
        out.append(f"an explicit window frame {w.spec.frame} is not ported")
    return out
