"""Scan, project, filter and coalesce execs (port of the TpuScanExec,
TpuProjectExec, TpuFilterExec and TpuCoalesceExec parts of
``spark_rapids_tpu/execs/basic.py``)."""

from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch.columnar import (
    BucketPolicy,
    DeviceTable,
    HostTable,
)
from spark_rapids_tpu_torch.columnar.table import concat_device
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.ops.expr import (
    Expression,
    PrepCtx,
    compile_project,
    eval_expr,
    prep_expr,
    table_vals,
)


class TpuScanExec(TpuExec):
    """Uploads pre-built host batches. The uploaded DeviceTable is kept on
    the host table (per device and capacity), so repeated queries over one
    in-memory table skip the upload (the reference's default scan device
    cache)."""

    def __init__(self, batches: Sequence[HostTable], device: torch.device,
                 bucket_policy: BucketPolicy):
        self.batches = list(batches)
        self.device = device
        self.bucket_policy = bucket_policy

    def output_schema(self):
        return self.batches[0].schema()

    def execute(self):
        for b in self.batches:
            cap = self.bucket_policy.bucket_for(b.num_rows)
            key = ("device", str(self.device), cap)
            dt = b._cache.get(key)
            if dt is None:
                dt = DeviceTable.from_host(b, self.device, cap)
                b._cache[key] = dt
            yield dt


class TpuProjectExec(TpuExec):
    produces_masked = True

    def __init__(self, child: TpuExec, exprs: Sequence[Expression],
                 names: Sequence[str]):
        self.children = (child,)
        self.exprs = list(exprs)
        self.names = list(names)

    def output_schema(self):
        return [(n, e.data_type) for n, e in zip(self.names, self.exprs)]

    def execute_masked(self):
        for dt in self.children[0].execute_masked():
            cols = compile_project(self.exprs, dt)
            yield DeviceTable(self.names, cols, dt.nrows_dev, dt.capacity,
                              dt.device, live=dt.live)


class TpuFilterExec(TpuExec):
    """Predicate evaluation into a MASKED table: keep-mask + live count,
    no compaction (consumers compact only where they need the prefix)."""

    produces_masked = True

    def __init__(self, child: TpuExec, condition: Expression):
        self.children = (child,)
        self.condition = condition

    def output_schema(self):
        return self.children[0].output_schema()

    def execute_masked(self):
        for table in self.children[0].execute_masked():
            preps = prep_expr(self.condition, PrepCtx(table))
            pred = eval_expr(self.condition, preps, table_vals(table),
                             table.nrows_dev, table.capacity, table.device,
                             live=table.live)
            keep = pred.data & pred.validity & table.row_mask()
            new_n = keep.sum(dtype=torch.int32)
            yield DeviceTable(table.names, table.columns, new_n,
                              table.capacity, table.device, live=keep)


class TpuCoalesceExec(TpuExec):
    """Concatenate child batches into one (the RequireSingleBatch goal) or
    up to a target size. The port has no spill framework or memory budget
    yet, so batches are held as device tables; a lone batch passes
    through as it is (masked or not), and several concatenate on the
    device (columnar/table.concat_device)."""

    produces_masked = True

    def __init__(self, child: TpuExec, target_bytes: int = 1 << 30,
                 require_single: bool = False):
        self.children = (child,)
        self.target_bytes = target_bytes
        self.require_single = require_single

    def output_schema(self):
        return self.children[0].output_schema()

    def execute_masked(self):
        pending, pending_bytes = [], 0
        for batch in self.children[0].execute_masked():
            pending.append(batch)
            pending_bytes += device_nbytes(batch)
            if not self.require_single and pending_bytes >= self.target_bytes:
                yield self._flush(pending)
                pending, pending_bytes = [], 0
        if pending:
            yield self._flush(pending)

    def _flush(self, batches) -> DeviceTable:
        if len(batches) == 1:
            return batches[0]
        self.add_metric("concatBatches", len(batches))
        return concat_device(batches)


def device_nbytes(table: DeviceTable) -> int:
    return sum(c.data.numel() * c.data.element_size() + c.validity.numel()
               for c in table.columns)
