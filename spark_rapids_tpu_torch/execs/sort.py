"""Device sort (port of ``spark_rapids_tpu/execs/sort.py``: ``_directional``
and ``TpuSortExec``).

Each sort key becomes ascending 32-bit operands (ops/ordering.py): a
null-placement flag first, descending order by complement. Padding and
dead rows park last through a leading liveness operand, so the sort also
compacts a masked input. An int32 row-index payload gives the permutation
that gathers every output column."""

from __future__ import annotations

from typing import List, Sequence

import torch

from spark_rapids_tpu_torch.columnar import DeviceTable
from spark_rapids_tpu_torch.execs.base import TpuExec, single_batch
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
        table = single_batch(self.children[0].execute_masked(), "sort")
        if table is not None:
            yield self._sort(table)

    def _sort(self, table: DeviceTable) -> DeviceTable:
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
        perm = lex_sort(operands, payload)[-1].to(torch.int64)
        new_cols = [c.with_arrays(c.data[perm], c.validity[perm])
                    for c in table.columns]
        return DeviceTable(table.names, new_cols, table.nrows_dev, capacity,
                           dev)
