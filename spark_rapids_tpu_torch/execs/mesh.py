"""The mesh re-land boundary (port of ``spark_rapids_tpu/execs/mesh.py``:
``TpuMeshRelandExec`` and ``insert_mesh_relands``).

Mesh-native execution lands a scan's rows as shards over the mesh's
logical devices (parallel/mesh.py ShardedTable); filters and projections
run shard by shard, and a hash exchange takes the shards as its sources.
Every other consumer takes its input through a :class:`TpuMeshRelandExec`
inserted at conversion: the shards' live rows, concatenated in shard order
onto the session's device, the single-device layout the consumer's
kernels were written for, so that its results are the single-device
results. Before serving, the row count and an order-independent u32 word
sum of every column's live data and validity are computed on both sides
and compared in one host read (``spark.rapids.mesh.gather.verify``); a
mismatch (the ``mesh.gather`` corrupt kind damages the landed copy)
re-lands from the intact shards up to ``spark.rapids.mesh.maxShardRetries``
times, then raises MeshGatherError. A batch that is not sharded (an
exchange's output partition already lives on one device) passes through.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar import DeviceTable
from spark_rapids_tpu_torch.columnar.column import bucket_for
from spark_rapids_tpu_torch.execs.base import (
    CpuRootExec,
    DeviceToHost,
    HostToDevice,
    InputAdapter,
    TpuExec,
)


def table_digest(table: DeviceTable) -> torch.Tensor:
    """Row count plus the u32 word sum of every column's data and validity
    over the live rows, as a 0-d int64 on the table's device (no host
    sync). Integer sums do not depend on the rows' order or slots, so the
    shards' digests add up to the landed table's."""
    from spark_rapids_tpu_torch.parallel.mesh import u32_words
    live = table.row_mask().to(torch.int64)[:, None]
    acc = live.sum()
    for c in table.columns:
        acc = acc + (u32_words(c.data) * live).sum() + \
            (u32_words(c.validity) * live).sum()
    return acc & 0xFFFFFFFF


def _taint_landed(table: DeviceTable) -> DeviceTable:
    """The landed copy damaged as an in-flight corruption would be: slot
    0's validity of the first column flips (a row silently turns null or
    non-null). The shards stay intact, so a re-gather converges."""
    c0 = table.columns[0]
    v = c0.validity.clone()
    if v.shape[0]:
        v[0] = ~v[0]
    out = DeviceTable(table.names, (c0.with_arrays(c0.data, v),)
                      + tuple(table.columns[1:]), table.nrows_dev,
                      table.capacity, table.device, live=table.live)
    out._nrows_host = table._nrows_host
    return out


def reland(sharded, device) -> DeviceTable:
    """The shards' live rows in shard order on ``device`` (a prefix
    table)."""
    from spark_rapids_tpu_torch.columnar.table import concat_device
    shards = [s if s.device == torch.device(device) else
              _moved(s, device) for s in sharded.shards]
    return concat_device(shards)


def _moved(t: DeviceTable, device) -> DeviceTable:
    from spark_rapids_tpu_torch.parallel.mesh import shard_put
    cols = [c.with_arrays(shard_put(c.data, device),
                          shard_put(c.validity, device)) for c in t.columns]
    live = None if t.live is None else t.live.to(device)
    out = DeviceTable(t.names, cols, t.nrows_dev.to(device), t.capacity,
                      device, live=live)
    out._nrows_host = t._nrows_host
    return out


def _shrunk(t: DeviceTable, n: int) -> DeviceTable:
    """``t`` (a prefix table of ``n`` rows) at the bucket of ``n``: views,
    no copy; the single-device layout's capacity."""
    t._nrows_host = n
    k = bucket_for(max(n, 1))
    if k >= t.capacity:
        return t
    return DeviceTable(t.names, [c.sliced_rows(k) for c in t.columns], n, k,
                       t.device)


class TpuMeshRelandExec(TpuExec):
    """Schema-preserving residency boundary: a sharded batch re-lands onto
    ``device`` in the single-device layout; masked protocol mirrors the
    child's."""

    def __init__(self, child: TpuExec, device):
        self.children = (child,)
        self.device = torch.device(device)
        self.produces_masked = bool(getattr(child, "produces_masked", False))

    def output_schema(self):
        return self.children[0].output_schema()

    def execute(self):
        for b in self.children[0].execute():
            yield self._reland(b)

    def execute_masked(self):
        for b in self.children[0].execute_masked():
            yield self._reland(b)

    def _reland(self, batch):
        from spark_rapids_tpu_torch.execs.basic import is_sharded
        if not is_sharded(batch):
            return batch
        from spark_rapids_tpu_torch.errors import MeshGatherError
        from spark_rapids_tpu_torch.parallel import mesh as PM
        from spark_rapids_tpu_torch.parallel.mesh import (
            MESH_SCOPE,
            mesh_gather,
        )
        from spark_rapids_tpu_torch.runtime.faults import fault_point
        slots = batch.capacity
        self.add_metric("meshRelandRows", slots)
        MESH_SCOPE.add("meshRelandRows", slots)
        # crash, device_lost and slow fire before the gather; corrupt is
        # taken by the sentinel inside the checked loop
        fault_point("mesh.gather")
        if not PM.GATHER_VERIFY:
            out = reland(batch, self.device)
            return _shrunk(out, out.num_rows)
        pre = torch.stack([table_digest(s).to(self.device)
                           for s in batch.shards]).sum() & 0xFFFFFFFF
        retries = 0
        while True:
            out = reland(batch, self.device)
            if fault_point("mesh.gather", data=b"\x00") != b"\x00":
                out = _taint_landed(out)
            post = table_digest(out)
            # one read: both digests and the landed row count (a digest
            # compare is check overhead, not gathered rows)
            pair = mesh_gather(torch.stack(
                [pre, post, out.nrows_dev.to(torch.int64)]), rows=0)
            if int(pair[0]) == int(pair[1]):
                return _shrunk(out, int(pair[2]))
            MESH_SCOPE.add("gatherChecksFailed", 1)
            self.add_metric("gatherChecksFailed", 1)
            if retries >= PM.MAX_SHARD_RETRIES:
                raise MeshGatherError(
                    f"mesh re-land failed its row-count/checksum check "
                    f"{retries + 1} times (shards' digest {int(pair[0])} vs "
                    f"landed {int(pair[1])})")
            retries += 1
            MESH_SCOPE.add("shardRetries", 1)
            self.add_metric("shardRetries", 1)

    def describe(self):
        return "MeshReland"


def _shard_safe_consumers() -> tuple:
    """Consumers that take sharded input: the narrow operators (they run
    shard by shard), the exchange (its shards are its sources) and the
    boundary itself. Everything else sees the single-device layout."""
    from spark_rapids_tpu_torch.execs.basic import (
        TpuFilterExec,
        TpuProjectExec,
    )
    from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
    return (TpuFilterExec, TpuProjectExec, TpuShuffleExchangeExec,
            TpuMeshRelandExec)


def insert_mesh_relands(executable, device):
    """Conversion-time pass (mesh execution on): wrap the TpuExec children
    of every consumer that is not shard-safe in a re-land boundary, and
    stamp every scan with the mesh generation the boundaries were planned
    against (``_mesh_scan_gen``, parallel/mesh.py scan_mesh). The boundary
    passes unsharded batches through, so inserting it liberally is
    correct; the list of safe consumers only decides where shards may
    flow."""
    from spark_rapids_tpu_torch.execs.basic import (
        TpuFileScanExec,
        TpuScanExec,
    )
    from spark_rapids_tpu_torch.parallel.mesh import MESH

    safe = _shard_safe_consumers()
    gen = MESH.generation()

    def rec(node):
        if isinstance(node, (TpuScanExec, TpuFileScanExec)):
            node._mesh_scan_gen = gen
        if isinstance(node, DeviceToHost):
            # the transition downloads anyway; it re-lands first below
            node.tpu_exec = _wrap(node.tpu_exec)
            rec(node.tpu_exec)
            return
        if isinstance(node, (HostToDevice, CpuRootExec)):
            rec(node.cpu_node)
            return
        if isinstance(node, InputAdapter):
            rec(node.source)
            return
        children = tuple(getattr(node, "children", ()) or ())
        if isinstance(node, TpuExec) and children and \
                not isinstance(node, safe):
            node.children = tuple(_wrap(c) for c in children)
            children = node.children
        for c in children:
            rec(c)

    def _wrap(c):
        if isinstance(c, TpuExec) and not isinstance(c, TpuMeshRelandExec):
            return TpuMeshRelandExec(c, device)
        return c

    executable = _wrap(executable) if isinstance(executable, safe) \
        and not isinstance(executable, TpuMeshRelandExec) else executable
    rec(executable)
    return executable
