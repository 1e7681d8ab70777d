"""Scan, range, project, filter, union, expand, coalesce, limit and
sample execs (port of the TpuScanExec, TpuRangeExec, TpuProjectExec,
TpuFilterExec, TpuUnionExec, TpuExpandExec, TpuCoalesceExec, TpuLimitExec
and TpuSampleExec parts of ``spark_rapids_tpu/execs/basic.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import (
    BucketPolicy,
    DeviceColumn,
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
    """Uploads pre-built host batches, or only their ``columns`` (ordinals,
    after column pruning). Each uploaded column is kept on its host column
    (per device and capacity), so repeated queries over one in-memory
    table skip the upload of every column an earlier one uploaded (the
    reference's default scan device cache, by column)."""

    def __init__(self, batches: Sequence[HostTable], device: torch.device,
                 bucket_policy: BucketPolicy,
                 columns: Optional[Sequence[int]] = None):
        self.batches = list(batches)
        self.device = device
        self.bucket_policy = bucket_policy
        self.columns = (tuple(range(len(self.batches[0].names)))
                        if columns is None else tuple(columns))

    def output_schema(self):
        schema = self.batches[0].schema()
        return [schema[i] for i in self.columns]

    def execute(self):
        for b in self.batches:
            cap = self.bucket_policy.bucket_for(b.num_rows)
            key = ("device", str(self.device), cap)
            cols = []
            for i in self.columns:
                hc = b.columns[i]
                dc = hc._cache.get(key)
                if dc is None:
                    dc = DeviceColumn.from_host(hc, cap, self.device)
                    hc._cache[key] = dc
                cols.append(dc)
            yield DeviceTable([b.names[i] for i in self.columns], cols,
                              b.num_rows, cap, self.device)


class TpuRangeExec(TpuExec):
    """spark.range made on the device: batches of ``batch_rows`` rows (the
    last one shorter), each an arange in its capacity bucket; a range with
    no rows yields one empty batch, as the reference's."""

    def __init__(self, start: int, end: int, step: int, batch_rows: int,
                 name: str, device: torch.device,
                 bucket_policy: BucketPolicy):
        self.start, self.end, self.step = start, end, step
        self.batch_rows = batch_rows
        self.col_name = name
        self.device = device
        self.bucket_policy = bucket_policy

    def output_schema(self):
        return [(self.col_name, T.LONG)]

    def execute(self):
        total = max(0, -(-(self.end - self.start) // self.step))
        pos = 0
        while True:
            cnt = min(self.batch_rows, total - pos)
            cap = self.bucket_policy.bucket_for(max(cnt, 1))
            rows = torch.arange(cap, dtype=torch.int64, device=self.device)
            data = rows * self.step + (self.start + pos * self.step)
            validity = rows < cnt
            data = torch.where(validity, data, torch.zeros_like(data))
            col = DeviceColumn(T.LONG, data, validity)
            # the row count made on the device (a host int would upload)
            nrows = torch.full((), cnt, dtype=torch.int32, device=self.device)
            out = DeviceTable([self.col_name], [col], nrows, cap, self.device)
            out._nrows_host = cnt
            yield out
            pos += cnt
            if pos >= total:
                break


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
            yield filter_table(table, self.condition)


def filter_table(table: DeviceTable, condition: Expression) -> DeviceTable:
    """``table`` MASKED to the rows where ``condition`` is non-null true:
    the keep-mask and its live count, no compaction."""
    preps = prep_expr(condition, PrepCtx(table))
    pred = eval_expr(condition, preps, table_vals(table), table.nrows_dev,
                     table.capacity, table.device, live=table.live)
    keep = pred.data & pred.validity & table.row_mask()
    return DeviceTable(table.names, table.columns,
                       keep.sum(dtype=torch.int32), table.capacity,
                       table.device, live=keep)


class TpuUnionExec(TpuExec):
    """UNION ALL: each child's batches in turn (masked ones stay masked),
    under the first child's column names."""

    produces_masked = True

    def __init__(self, children: Sequence[TpuExec]):
        self.children = tuple(children)

    def output_schema(self):
        return self.children[0].output_schema()

    def execute_masked(self):
        names = [n for n, _ in self.output_schema()]
        for c in self.children:
            for b in c.execute_masked():
                out = DeviceTable(names, b.columns, b.nrows_dev, b.capacity,
                                  b.device, live=b.live)
                out._nrows_host = b._nrows_host
                yield out


class TpuExpandExec(TpuExec):
    """Each input batch yields one output batch per projection, masked as
    the input is (the reference's GpuExpandExec)."""

    produces_masked = True

    def __init__(self, child: TpuExec,
                 projections: Sequence[Sequence[Expression]],
                 names: Sequence[str]):
        self.children = (child,)
        self.projections = [list(p) for p in projections]
        self.names = list(names)

    def output_schema(self):
        return [(n, e.data_type)
                for n, e in zip(self.names, self.projections[0])]

    def execute_masked(self):
        for batch in self.children[0].execute_masked():
            for proj in self.projections:
                cols = compile_project(proj, batch)
                yield DeviceTable(self.names, cols, batch.nrows_dev,
                                  batch.capacity, batch.device,
                                  live=batch.live)


class TpuSampleExec(TpuExec):
    """Bernoulli sample: each prefix batch's keep-mask is drawn on the host
    from ``numpy.random.default_rng(seed)`` (one stream over the batches,
    ``rng.random(n) < fraction`` for its n rows, exactly as the
    reference's), uploaded, and the kept rows compact through the
    compaction kernel. The row count is read on the host once a batch."""

    def __init__(self, child: TpuExec, fraction: float, seed: int):
        self.children = (child,)
        self.fraction = float(fraction)
        self.seed = int(seed)

    def output_schema(self):
        return self.children[0].output_schema()

    def execute(self):
        from spark_rapids_tpu_torch.ops.scatter32 import compact_pairs
        rng = np.random.default_rng(self.seed)
        for batch in self.children[0].execute():
            n = batch.num_rows  # host sync: the draw needs the row count
            keep_host = np.zeros(batch.capacity, dtype=np.bool_)
            keep_host[:n] = rng.random(n) < self.fraction
            keep = torch.from_numpy(keep_host).to(batch.device)
            outs, new_n = compact_pairs([c.data for c in batch.columns],
                                        [c.validity for c in batch.columns],
                                        keep, batch.capacity)
            cols = [c.with_arrays(d, v)
                    for c, (d, v) in zip(batch.columns, outs)]
            yield DeviceTable(batch.names, cols, new_n, batch.capacity,
                              batch.device)


#: the reference's default ``spark.rapids.sql.batchSizeBytes``: the target
#: of the coalesce in front of an aggregate and of a sort
BATCH_SIZE_BYTES = 1 << 30


class TpuCoalesceExec(TpuExec):
    """Concatenate child batches into one (the RequireSingleBatch goal) or
    up to a target size. The port has no spill framework or memory budget
    yet, so batches are held as device tables; a lone batch passes
    through as it is (masked or not), and several concatenate on the
    device (columnar/table.concat_device). Under a target size, the
    masked views of one exchange split (``DeviceTable.split_group``)
    pass through one by one, as the reference's: concatenating views of
    one table would only multiply its capacity."""

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
            if batch.split_group is not None and not self.require_single:
                if pending:
                    yield self._flush(pending)
                    pending, pending_bytes = [], 0
                self.add_metric("maskedPassthrough", 1)
                yield batch
                continue
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


class TpuLimitExec(TpuExec):
    """LIMIT n without an ordering (the reference's CollectLimit): the
    first n rows of the child's compacted batches in order, one host read
    of each batch's row count until the limit is reached; later batches
    are not pulled."""

    def __init__(self, child: TpuExec, limit: int):
        self.children = (child,)
        self.limit = int(limit)

    def output_schema(self):
        return self.children[0].output_schema()

    def execute(self):
        remaining = self.limit
        if remaining <= 0:
            return
        for batch in self.children[0].execute():
            n = batch.num_rows  # host sync, per batch up to the limit
            take = min(n, remaining)
            if take == n:
                yield batch
            else:
                yield DeviceTable(batch.names, batch.columns, take,
                                  batch.capacity, batch.device)
            remaining -= take
            if remaining <= 0:
                return


def device_nbytes(table: DeviceTable) -> int:
    return sum(c.data.numel() * c.data.element_size() + c.validity.numel()
               for c in table.columns)
