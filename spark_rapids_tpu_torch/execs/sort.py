"""Device sort and top-k (port of ``spark_rapids_tpu/execs/sort.py``:
``_directional``, ``TpuSortExec`` with ``_topk``, and
``TpuTakeOrderedAndProjectExec``).

Each sort key becomes ascending 32-bit operands (ops/ordering.py): a
null-placement flag first, descending order by complement. Padding and
dead rows park last through a leading liveness operand, so the sort also
compacts a masked input. An int32 row-index payload gives the permutation
that gathers every output column.

The sort reads its input through a coalesce that stops at
``OUT_OF_CORE_THRESHOLD_BYTES`` (overrides/rules.py), as the reference's
pre-sort coalesce stops at its out-of-core threshold. Batches that reach
the sort (an exchange's views pass the coalesce) concatenate on the
device while their total stays under the threshold; past it the
reference sorts batches into host runs and merges them, which the port
does not have, so the sort raises naming that merge."""

from __future__ import annotations

from typing import List, Sequence

import torch

from spark_rapids_tpu_torch.columnar import DeviceTable, bucket_for
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.ops.expr import (
    PrepCtx,
    eval_expr,
    prep_expr,
    table_vals,
)
from spark_rapids_tpu_torch.plan.nodes import SortOrder


#: the reference's default ``spark.rapids.sql.sort.outOfCoreThresholdBytes``
#: (and ``spark.rapids.sql.batchSizeBytes``): the pre-sort coalesce's
#: target, past which a sort would merge sorted runs out of core
OUT_OF_CORE_THRESHOLD_BYTES = 1 << 30


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
    # nulls_first else 1
    valid_flag, null_flag = (1, 0) if nulls_first else (0, 1)
    nf = torch.where(validity,
                     torch.tensor(valid_flag, dtype=torch.int32,
                                  device=data.device),
                     torch.tensor(null_flag, dtype=torch.int32,
                                  device=data.device))
    return [nf] + ops


class TpuSortExec(TpuExec):
    def __init__(self, child: TpuExec, orders: Sequence[SortOrder]):
        self.children = (child,)
        self.orders = list(orders)

    def output_schema(self):
        return self.children[0].output_schema()

    def execute(self):
        from spark_rapids_tpu_torch.columnar.table import concat_device
        from spark_rapids_tpu_torch.execs.basic import device_nbytes
        batches, total = [], 0
        for batch in self.children[0].execute_masked():
            batches.append(batch)
            total += device_nbytes(batch)
            if len(batches) > 1 and total > OUT_OF_CORE_THRESHOLD_BYTES:
                raise NotImplementedError(
                    "a sort over more than spark.rapids.sql.sort."
                    "outOfCoreThresholdBytes of input (the reference's "
                    "out-of-core sorted-run merge) is not ported")
        if batches:
            yield self._sort(concat_device(batches))

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
