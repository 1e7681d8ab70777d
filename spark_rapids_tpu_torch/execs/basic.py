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
    reference's default scan device cache, by column); the memory
    arbiter evicts that cache first under pressure
    (``columnar/table.evict_device_caches``).

    Out of core: a batch whose estimated device bytes exceed its share of
    the device budget lands as bounded chunks
    (``runtime/memory.scan_chunks``, metric ``scanChunks``), which bypass
    the cache: a multi-chunk image would pin the budget the chunking
    protects. Every landing runs in the OOM retry loop, so a budget
    squeeze spills and replays instead of failing at the scan."""

    def __init__(self, batches: Sequence[HostTable], device: torch.device,
                 bucket_policy: BucketPolicy,
                 columns: Optional[Sequence[int]] = None,
                 device_cache: bool = True):
        self.batches = list(batches)
        self.device = device
        self.bucket_policy = bucket_policy
        #: ``spark.rapids.tpu.scan.deviceCache``: false lands every batch
        #: afresh and keeps nothing on its host columns
        self.device_cache = bool(device_cache)
        self.columns = (tuple(range(len(self.batches[0].names)))
                        if columns is None else tuple(columns))

    def output_schema(self):
        schema = self.batches[0].schema()
        return [schema[i] for i in self.columns]

    def execute(self):
        from spark_rapids_tpu_torch.parallel.mesh import (
            land_shards,
            scan_mesh,
        )
        from spark_rapids_tpu_torch.runtime.memory import scan_chunks
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        mesh, gen = scan_mesh(self)
        for b in self.batches:
            view = HostTable([b.names[i] for i in self.columns],
                             [b.columns[i] for i in self.columns])
            chunks = scan_chunks(view)
            if mesh is not None:
                # mesh-native: each batch (or chunk) lands as row shards
                # over the mesh's logical devices
                for ch in chunks:
                    yield retry_block(lambda c=ch: land_shards(
                        self, c, mesh, gen, self.bucket_policy,
                        cached=len(chunks) == 1 and self.device_cache))
                continue
            if len(chunks) > 1:
                for ch in chunks:
                    yield retry_block(
                        lambda c=ch: self._land(c, c.num_rows, False))
                continue
            cap = self.bucket_policy.bucket_for(b.num_rows)
            key = ("device", str(self.device), cap)
            cached = self.device_cache
            if cached and all(key in hc._cache for hc in view.columns):
                # a cache hit lands nothing: no retry site, as the
                # reference's
                yield self._land(view, b.num_rows, True)
                continue
            yield retry_block(lambda: self._land(view, b.num_rows, cached))

    def _land(self, host: HostTable, nrows: int, cached: bool
              ) -> DeviceTable:
        """``host`` (``nrows`` rows) on the device at its bucket; with
        ``cached`` each column is taken from, or put into, its host
        column's device cache."""
        from spark_rapids_tpu_torch.columnar.table import (
            register_device_cache,
        )
        cap = self.bucket_policy.bucket_for(nrows)
        key = ("device", str(self.device), cap)
        cols = []
        for hc in host.columns:
            dc = hc._cache.get(key) if cached else None
            if dc is None:
                dc = DeviceColumn.from_host(hc, cap, self.device)
                if cached:
                    hc._cache[key] = dc
                    register_device_cache(hc)
            cols.append(dc)
        return DeviceTable(host.names, cols, nrows, cap, self.device)


class TpuFileScanExec(TpuExec):
    """File scan on the device: the scan node's reader (its PERFILE,
    COALESCING or MULTITHREADED prefetch) yields decoded host batches,
    which land on the device here (reference: GpuFileSourceScanExec with
    the MultiFile*PartitionReaders). As ``TpuScanExec``'s, a batch past
    its share of the device budget lands as bounded chunks
    (``scanChunks``), and every landing runs in the OOM retry loop.
    Metrics: ``scanDecodeTime`` (seconds waited for the reader's next
    decoded batch: the host decode, less what a MULTITHREADED prefetch
    overlapped), ``scanChunks``, ``scanUploadTime`` (seconds),
    ``scanBatches``, ``scanRows``, for Parquet ``prunedRowGroups``, and
    under dynamic partition pruning ``dppPrunedFiles`` and
    ``dppScannedFiles``."""

    def __init__(self, scan_node, device: torch.device,
                 bucket_policy: BucketPolicy):
        self.scan_node = scan_node
        self.device = device
        self.bucket_policy = bucket_policy
        #: execution-scoped dynamic partition pruning filters, owned by
        #: THIS converted exec and never by the shared scan node
        #: (overrides/rules.py::_maybe_install_dpp)
        self._dynamic_prunes: list = []

    def install_dynamic_pruning(self, part_col: str, provider) -> None:
        self._dynamic_prunes.append((part_col, provider))

    def output_schema(self):
        return self.scan_node.output_schema()

    def execute(self):
        import time

        from spark_rapids_tpu_torch.runtime.memory import scan_chunks
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        from spark_rapids_tpu_torch.parallel.mesh import (
            land_shards,
            scan_mesh,
        )
        mesh, gen = scan_mesh(self)
        pruned0 = getattr(self.scan_node, "pruned_row_groups", 0)
        batches = self.scan_node.execute_host(
            dynamic_prunes=self._dynamic_prunes or None,
            metrics=self.metrics)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            self.add_metric("scanDecodeTime", time.perf_counter() - t0)
            if batch is None:
                break
            chunks = scan_chunks(batch)
            del batch
            if len(chunks) > 1:
                self.add_metric("scanChunks", len(chunks))
            while chunks:
                ch = chunks.pop(0)
                t0 = time.perf_counter()
                if mesh is not None:
                    out = [retry_block(lambda c=ch: land_shards(
                        self, c, mesh, gen, self.bucket_policy, False))]
                else:
                    out = [retry_block(lambda c=ch: self._land(c))]
                self.add_metric("scanUploadTime", time.perf_counter() - t0)
                self.add_metric("scanBatches", 1)
                self.add_metric("scanRows", ch.num_rows)
                del ch
                yield out.pop()
        pruned = getattr(self.scan_node, "pruned_row_groups", 0) - pruned0
        if pruned:
            self.add_metric("prunedRowGroups", pruned)

    def _land(self, host: HostTable) -> DeviceTable:
        cap = self.bucket_policy.bucket_for(host.num_rows)
        cols = [DeviceColumn.from_host(hc, cap, self.device)
                for hc in host.columns]
        return DeviceTable(host.names, cols, host.num_rows, cap, self.device)


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
        from spark_rapids_tpu_torch.columnar.nested import is_nested_type
        from spark_rapids_tpu_torch.runtime.retry import with_retry
        # compact first when outputs are NESTED: array, struct and map
        # columns have no compaction of their own and only ever live in
        # prefix batches (the reference's rule)
        must_compact = any(is_nested_type(e.data_type) for e in self.exprs)

        def run(dt):
            if must_compact:
                dt = dt.compacted()
            cols = compile_project(self.exprs, dt)
            return DeviceTable(self.names, cols, dt.nrows_dev, dt.capacity,
                               dt.device, live=dt.live)

        for dt in self.children[0].execute_masked():
            if is_sharded(dt):
                yield map_shards(dt, run)
            else:
                yield from with_retry(dt, run)
            del dt


def is_sharded(batch) -> bool:
    """A mesh-native scan's batch (parallel/mesh.py ShardedTable)?"""
    return type(batch).__name__ == "ShardedTable"


def map_shards(batch, fn):
    """``fn`` over each shard of a ShardedTable, in the OOM retry loop:
    the narrow operators run shard by shard (each shard on its logical
    device), which leaves every row where it is."""
    from spark_rapids_tpu_torch.runtime.retry import retry_block
    return retry_block(lambda: batch.map(fn))


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
        from spark_rapids_tpu_torch.runtime.retry import with_retry
        for table in self.children[0].execute_masked():
            if is_sharded(table):
                yield map_shards(
                    table, lambda t: filter_table(t, self.condition))
            else:
                yield from with_retry(
                    table, lambda t: filter_table(t, self.condition))
            del table


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
        from spark_rapids_tpu_torch.runtime.retry import with_retry
        rng = np.random.default_rng(self.seed)

        def make_run(keep_host):
            def run(dt):
                # the draw lands like a column (reserved and accounted
                # with the memory arbiter) for as long as it is used
                keep_col = DeviceColumn.from_array(T.BOOLEAN, keep_host,
                                                   dt.device)
                outs, new_n = compact_pairs([c.data for c in dt.columns],
                                            [c.validity for c in dt.columns],
                                            keep_col.data, dt.capacity)
                cols = [c.with_arrays(d, v)
                        for c, (d, v) in zip(dt.columns, outs)]
                return DeviceTable(dt.names, cols, new_n, dt.capacity,
                                   dt.device)
            return run

        for batch in self.children[0].execute():
            n = batch.num_rows  # host sync: the draw needs the row count
            keep_host = np.zeros(batch.capacity, dtype=np.bool_)
            keep_host[:n] = rng.random(n) < self.fraction
            # the draw is made once, so a replay keeps it
            yield from with_retry(batch, make_run(keep_host),
                                  splittable=False)
            del batch


#: the reference's default ``spark.rapids.sql.batchSizeBytes``: the target
#: of the coalesce in front of an aggregate, a sort, a streamed window, a
#: join's probe side and of an exchange's output, where the conf does not
#: set the key (overrides/rules.py::batch_size_bytes)
BATCH_SIZE_BYTES = 1 << 30


class TpuCoalesceExec(TpuExec):
    """Concatenate child batches into one (the RequireSingleBatch goal) or
    up to a target size. Buffered batches are SpillableBatches, so they
    may move to the host while more input streams in; a lone batch passes
    through as it is (masked or not), and several concatenate on the
    device (columnar/table.concat_device). Under a target size, the
    target never exceeds the device budget's scan chunk
    (``MEMORY.scan_chunk_bytes()``), so a coalesce cannot concatenate
    chunked scans back into one over-budget batch; the masked views of
    one exchange split (``DeviceTable.split_group``) pass through one by
    one, as the reference's: concatenating views of one table would only
    multiply its capacity."""

    produces_masked = True

    def __init__(self, child: TpuExec, target_bytes: int = 1 << 30,
                 require_single: bool = False):
        self.children = (child,)
        self.target_bytes = target_bytes
        self.require_single = require_single

    def output_schema(self):
        return self.children[0].output_schema()

    def execute_masked(self):
        from spark_rapids_tpu_torch.runtime.memory import MEMORY
        from spark_rapids_tpu_torch.runtime.spill import (
            BufferCatalog,
            SpillableBatch,
        )
        catalog = BufferCatalog.get()
        target = self.target_bytes
        if not self.require_single:
            target = min(target, MEMORY.scan_chunk_bytes())
        pending, pending_bytes = [], 0
        try:
            for batch in self.children[0].execute_masked():
                if batch.split_group is not None and \
                        not self.require_single:
                    if pending:
                        yield self._flush(pending)
                        pending, pending_bytes = [], 0
                    self.add_metric("maskedPassthrough", 1)
                    yield batch
                    del batch
                    continue
                pending_bytes += batch.device_nbytes()
                pending.append(SpillableBatch(batch, catalog))
                del batch
                if not self.require_single and pending_bytes >= target:
                    yield self._flush(pending)
                    pending, pending_bytes = [], 0
            if pending:
                yield self._flush(pending)
                pending = []
        finally:
            # abandonment (a LIMIT above stopped pulling) or an error must
            # not leave registrations in the catalog
            for sb in pending:
                sb.release()

    def spillable_batches(self):
        """A single-batch coalesce hands over the batches it would
        concatenate, unconcatenated (``TpuExec.spillable_batches``)."""
        if not self.require_single:
            return super().spillable_batches()
        spills, nbytes = self.children[0].spillable_batches()
        if len(spills) > 1:
            self.add_metric("concatBatches", len(spills))
        return spills, nbytes

    def _flush(self, batches) -> DeviceTable:
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        try:
            if len(batches) == 1:
                return retry_block(batches[0].get)
            self.add_metric("concatBatches", len(batches))
            return retry_block(
                lambda: concat_device([b.get() for b in batches]))
        finally:
            for b in batches:
                b.release()


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
