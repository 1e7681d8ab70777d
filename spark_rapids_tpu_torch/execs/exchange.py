"""Shuffle exchange exec (port of ``TpuShuffleExchangeExec`` of
``spark_rapids_tpu/execs/exchange.py``, with its route choice: the mesh's
all-to-all exchange, the single-process device split, then the host
shuffle).

* **The mesh exchange** (``_ici_eligible``): when the session asks for it
  (``spark.rapids.shuffle.mode=ICI`` or ``spark.rapids.mesh.enabled``), the
  partitioning is hash and every partition maps onto one mesh member, the
  exchange runs parallel/exchange.py's all-to-all and yields one prefix
  batch per partition on its member's device. A request it cannot honour
  takes the host shuffle for a reason the plan states (``explain``'s note
  and ``hostShuffleFallbacks``, ``ici_demotion_reason``).
* **The device split** (``_local_split_eligible``): MULTITHREADED mode with
  ``spark.rapids.shuffle.localDeviceSplit.enabled`` and masked batches on,
  at most ``LOCAL_SPLIT_MAX_PARTITIONS`` partitions: one partition-id pass
  over the concatenated input, then one MASKED view per partition over the
  same buffers, all carrying one split token (``DeviceTable.split_group``)
  so that a consumer that re-groups every row merges them back into one
  batch (columnar/table.py ``merge_split_views``). A range exchange's
  bounds come from a sample over the whole concatenated input
  (shuffle/partitioning.py); the port keeps range on the device split,
  where the reference takes the host shuffle (ROADMAP, Queue 3).
* **The host shuffle** (``_execute_host_shuffle``): every other case,
  among them a repartition into more than 32 partitions. Each input batch
  is split on the device (shuffle/partitioning.py ``split_by_partition``:
  the hand-written sort, then ONE download, a host sync by design) and
  written as one map output through the shuffle manager, MULTITHREADED
  (shuffle/manager.py: data and index files, a thread pool serializing
  and compressing) or P2P (shuffle/p2p.py: cached blocks served through
  the client/server protocol). The reader's threads deserialize; each
  reduce partition is concatenated on the host and uploaded here, on the
  exec's own thread and stream. With AQE coalescing adjacent undersized
  partitions share an output batch. A lost map output is recomputed from
  the child plan (``_recompute_maps``)."""

from __future__ import annotations

from time import perf_counter
from typing import List, Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import DeviceTable, HostTable
from spark_rapids_tpu_torch.columnar.table import concat_device
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.errors import MapOutputLostError
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.ops.expr import Expression
from spark_rapids_tpu_torch.shuffle.partitioning import (
    HashPartitioner,
    Partitioner,
    RangePartitioner,
    RoundRobinPartitioner,
    SinglePartitioner,
    split_by_partition,
)


def make_partitioner(mode: str, keys: Sequence[Expression],
                     num_partitions: int) -> Partitioner:
    mode = mode.lower()
    if mode == "hash":
        if not keys:
            raise ValueError("hash partitioning requires keys")
        return HashPartitioner(keys, num_partitions)
    if mode == "range":
        return RangePartitioner(keys, num_partitions)
    if mode == "roundrobin":
        return RoundRobinPartitioner(num_partitions)
    if mode == "single":
        return SinglePartitioner()
    raise ValueError(f"unknown partitioning {mode}")


def ici_requested(conf: RapidsConf) -> bool:
    """Did the session ask for the mesh exchange (``spark.rapids.shuffle.
    mode=ICI`` or mesh-native execution)?"""
    from spark_rapids_tpu_torch.conf import MESH_ENABLED, SHUFFLE_MANAGER_MODE
    return (str(conf.get_entry(SHUFFLE_MANAGER_MODE)).upper() == "ICI"
            or bool(conf.get_entry(MESH_ENABLED)))


def collective_applicable(mode: str, num_partitions: int) -> bool:
    """Has an exchange of this shape an all-to-all form at all? One output
    partition is a gather: taking the host path there is no demotion."""
    return mode != "single" and num_partitions > 1


def ici_demotion_reason(conf: RapidsConf, mode: str, num_partitions: int,
                        schema) -> Optional[str]:
    """Why a mesh-requested exchange takes the host shuffle, or None when
    the all-to-all runs. Static facts only (mode, partition count, mesh
    size, column types), so the tag states in ``explain`` the reason the
    exec acts on; the reference's strings."""
    from spark_rapids_tpu_torch.parallel.mesh import (
        MESH,
        logical_devices,
        suppression_reason,
    )
    sup = suppression_reason()
    if sup is not None:
        return sup
    if mode != "hash":
        return (f"{mode} partitioning has no deterministic per-row "
                f"device target; host shuffle computes it row-by-row")
    ndev = MESH.effective_ndev()
    if ndev is None:
        ndev = len(logical_devices())
    if num_partitions > ndev:
        return (f"partition count {num_partitions} exceeds the "
                f"{ndev}-device mesh")
    nested = [n for n, dt in schema
              if isinstance(dt, (T.ArrayType, T.StructType, T.MapType))]
    if nested:
        return (f"nested-type columns ({', '.join(nested[:3])}) have no "
                f"collective-exchangeable device layout")
    return None


class TpuShuffleExchangeExec(TpuExec):
    produces_masked = True

    #: the device split's views share the input's buffers, but every
    #: consumer that does not merge them runs at the input's full capacity
    #: per partition: past this many partitions the host shuffle's
    #: compacted batches win
    LOCAL_SPLIT_MAX_PARTITIONS = 32

    def __init__(self, child: TpuExec, mode: str, num_partitions: int,
                 keys: Sequence[Expression],
                 conf: Optional[RapidsConf] = None,
                 target_batch_bytes: int = 1 << 30):
        self.children = (child,)
        self.mode = mode
        self.num_partitions = 1 if mode == "single" else num_partitions
        self.keys = list(keys)
        self.conf = conf if conf is not None else RapidsConf({})
        self.target_batch_bytes = target_batch_bytes
        #: why a mesh-requested exchange took the host shuffle (None on
        #: the all-to-all or when never requested)
        self.ici_fallback_reason: Optional[str] = None

    def output_schema(self):
        return self.children[0].output_schema()

    def describe(self):
        extra = (f", hostShuffleFallback={self.ici_fallback_reason!r}"
                 if self.ici_fallback_reason else "")
        return (f"TpuShuffleExchange[{self.mode}, "
                f"n={self.num_partitions}{extra}]")

    # -- the route ------------------------------------------------------------
    def _ici_eligible(self) -> bool:
        if not ici_requested(self.conf):
            return False
        if not collective_applicable(self.mode, self.num_partitions):
            return False
        reason = ici_demotion_reason(self.conf, self.mode,
                                     self.num_partitions,
                                     self.output_schema())
        if reason is not None:
            from spark_rapids_tpu_torch.parallel.mesh import MESH_SCOPE
            self.ici_fallback_reason = reason
            self.add_metric("hostShuffleFallbacks", 1)
            MESH_SCOPE.add("hostShuffleFallbacks", 1)
            return False
        return True

    def _local_split_eligible(self) -> bool:
        from spark_rapids_tpu_torch.conf import (
            MASKED_BATCHES_ENABLED,
            SHUFFLE_LOCAL_DEVICE_SPLIT,
            SHUFFLE_MANAGER_MODE,
        )
        mode = str(self.conf.get_entry(SHUFFLE_MANAGER_MODE)).upper()
        return (mode == "MULTITHREADED"
                and bool(self.conf.get_entry(SHUFFLE_LOCAL_DEVICE_SPLIT))
                and bool(self.conf.get_entry(MASKED_BATCHES_ENABLED))
                and self.num_partitions <= self.LOCAL_SPLIT_MAX_PARTITIONS)

    def execute(self):
        if self._ici_eligible():
            yield from self._execute_ici()
            return
        if self._local_split_eligible():
            for b in self._execute_local_device_split():
                yield b.compacted()
            return
        yield from self._execute_host_shuffle()

    def execute_masked(self):
        if self._ici_eligible():
            yield from self._execute_ici()
            return
        if self._local_split_eligible():
            yield from self._execute_local_device_split()
            return
        yield from self._execute_host_shuffle()

    # -- the device split ---------------------------------------------------
    def _concat_input(self, masked: bool) -> Optional[DeviceTable]:
        child = self.children[0]
        batches = list(child.execute_masked() if masked else child.execute())
        return _concat(batches) if batches else None

    def _execute_local_device_split(self):
        t0 = perf_counter()
        table = self._concat_input(masked=True)
        if table is None:
            return
        parter = make_partitioner(self.mode, self.keys, self.num_partitions)
        pids = parter.partition_ids(table)
        live = table.row_mask()
        self.add_metric("localSplitParts", self.num_partitions)
        self.add_metric("localSplitTime", perf_counter() - t0)
        split_group = object()  # one token per split: its masks are disjoint
        for p in range(self.num_partitions):
            mask = live & (pids == p)
            out = DeviceTable(table.names, table.columns,
                              mask.sum(dtype=torch.int32), table.capacity,
                              table.device, live=mask)
            out.split_group = split_group
            yield out

    # -- the mesh's all-to-all ----------------------------------------------
    def _execute_ici(self):
        """The all-to-all over the mesh (parallel/exchange.py). A single
        sharded input batch over the exchange's mesh is its own source
        shards; anything else is concatenated on the session's device and
        cut into contiguous row blocks, one a mesh member (on one card
        both are views, no copy). Either way each partition holds its rows
        by source shard, then by row: the input's row order. The per-
        (source, target) counts double as the AQE map-output statistic."""
        from spark_rapids_tpu_torch.parallel.exchange import MeshExchange
        from spark_rapids_tpu_torch.parallel.mesh import MESH, MESH_SCOPE
        t0 = perf_counter()
        ndev = self.num_partitions
        mesh = MESH.exchange_mesh(ndev)
        batches = list(self.children[0].execute_masked())
        if not batches:
            return
        if (len(batches) == 1 and _sharded(batches[0])
                and batches[0].ids == mesh.ids):
            sources = batches[0].shards
        else:
            sources = _row_blocks(_concat(batches), mesh)
        del batches
        outs, counts_at = MeshExchange(mesh).run(sources, self.keys)
        del sources
        self.add_metric("iciExchangeTime", perf_counter() - t0)
        self.add_metric("iciPartitions", ndev)
        ici_bytes = sum(c.data.nbytes + c.validity.nbytes
                        for t in outs for c in t.columns)
        self.add_metric("iciBytes", ici_bytes)
        MESH_SCOPE.add("iciExchanges", 1)
        MESH_SCOPE.add("iciBytes", ici_bytes)
        counts = (counts_at[:, 1:] - counts_at[:, :-1]).sum(axis=0)
        row_bytes = max(_packed_row_bytes(outs[0]), 1)
        live = sorted(int(c) * row_bytes for c in counts if int(c) > 0)
        self._skew_metrics(live)
        for p, out in enumerate(outs):
            if int(counts[p]) == 0:
                continue
            yield out

    def _skew_metrics(self, live: List[int]) -> None:
        if not live:
            return
        from spark_rapids_tpu_torch.conf import AQE_SKEW_FACTOR
        median = live[len(live) // 2]
        factor = float(self.conf.get_entry(AQE_SKEW_FACTOR))
        skewed = sum(1 for b in live if b > factor * max(median, 1))
        self.add_metric("mapOutputBytesMax", live[-1])
        self.add_metric("mapOutputBytesMedian", median)
        if skewed:
            self.add_metric("skewedPartitions", skewed)

    # -- the host shuffle ---------------------------------------------------
    def _shuffle_manager(self):
        """MULTITHREADED: the file-backed manager; P2P: cached blocks
        served through the client/server transport. Both expose the same
        write and read handles."""
        from spark_rapids_tpu_torch.conf import SHUFFLE_MANAGER_MODE
        mode = str(self.conf.get_entry(SHUFFLE_MANAGER_MODE)).upper()
        if mode == "P2P":
            from spark_rapids_tpu_torch.shuffle.p2p import get_p2p_env
            return get_p2p_env(self.conf)
        from spark_rapids_tpu_torch.shuffle.manager import (
            get_shuffle_manager,
        )
        return get_shuffle_manager(self.conf)

    def _map_batches(self, partitioner):
        """The map side's input: the child's prefix batches (sharded ones
        re-landed); a range exchange samples its bounds over the whole
        input, so its batches are concatenated into one map first."""
        from spark_rapids_tpu_torch.execs.mesh import reland
        if isinstance(partitioner, RangePartitioner):
            table = self._concat_input(masked=False)
            if table is not None:
                partitioner.compute_bounds(table)
                yield table
            return
        for b in self.children[0].execute():
            yield reland(b, b.device).compacted() if _sharded(b) else b

    def _split(self, batch, partitioner) -> List[HostTable]:
        t0 = perf_counter()
        parts = split_by_partition(batch, partitioner, metrics=self)
        self.add_metric("shuffleSplitTime", perf_counter() - t0)
        return parts

    def _execute_host_shuffle(self):
        from spark_rapids_tpu_torch.conf import AQE_COALESCE_PARTITIONS
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        manager = self._shuffle_manager()
        partitioner = make_partitioner(self.mode, self.keys,
                                       self.num_partitions)
        handle = manager.new_shuffle(self.num_partitions)
        dev = None  # the reduce side lands where the map side ran
        try:
            t0 = perf_counter()
            for batch in self._map_batches(partitioner):
                dev = batch.device
                parts = self._split(batch, partitioner)
                del batch
                # host-memory pressure (the arbiter's CpuRetryOOM) retries
                # like a device OOM
                retry_block(lambda p=parts: handle.write_partitions(p))
                del parts
            self.add_metric("shuffleWriteTime", perf_counter() - t0)
            self.add_metric("shuffleBytesWritten", handle.bytes_written)
            self.add_metric("shuffleMapOutputs", len(handle.map_outputs))
            reader = manager.reader(handle)

            def read_one_partition(p: int) -> List[HostTable]:
                """One reduce partition, whole (the recovery unit: nothing
                goes downstream before it read, so a recompute never
                double-counts rows). A lost map output re-runs from the
                retained plan."""
                for attempt in range(3):
                    bytes_before = reader.bytes_read
                    try:
                        return list(reader.read_partition(p))
                    except MapOutputLostError as e:
                        reader.bytes_read = bytes_before
                        if attempt == 2:
                            raise
                        self._recompute_maps(handle, partitioner, e.map_ids)

            t0 = perf_counter()
            coalesce_parts = bool(self.conf.get_entry(AQE_COALESCE_PARTITIONS))
            part_bytes = [0] * self.num_partitions
            pending: List[HostTable] = []
            pending_bytes = 0
            nonempty_parts = 0
            emitted = 0
            for p in range(self.num_partitions):
                saw_rows = False
                for t in read_one_partition(p):
                    saw_rows = True
                    pending.append(t)
                    nb = t.nbytes()
                    part_bytes[p] += nb
                    pending_bytes += nb
                    if pending_bytes >= self.target_batch_bytes:
                        yield self._upload(pending, dev)
                        emitted += 1
                        pending, pending_bytes = [], 0
                nonempty_parts += saw_rows
                if pending and not coalesce_parts:
                    yield self._upload(pending, dev)
                    emitted += 1
                    pending, pending_bytes = [], 0
            if pending:
                yield self._upload(pending, dev)
                emitted += 1
            if coalesce_parts and nonempty_parts > emitted:
                self.add_metric("aqeCoalescedPartitions",
                                nonempty_parts - emitted)
            self._skew_metrics(sorted(b for b in part_bytes if b > 0))
            self.add_metric("shuffleReadTime", perf_counter() - t0)
            self.add_metric("shuffleBytesRead", reader.bytes_read)
        finally:
            manager.remove_shuffle(handle)

    def _recompute_maps(self, handle, partitioner, map_ids) -> None:
        """Re-run the child plan and rewrite the lost map outputs (map i is
        input batch i; the partitioning is deterministic, so the rewrite
        is byte-identical). ``map_ids`` None: every map, once."""
        from spark_rapids_tpu_torch.runtime.faults import RECOVERY
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        wanted = None if map_ids is None else set(map_ids)
        already = getattr(handle, "_recomputed_maps", set())
        if wanted is None:
            if getattr(handle, "_recomputed_all", False):
                return
            handle._recomputed_all = True
        elif wanted <= already:
            return
        total_maps = len(handle.map_outputs)
        rewritten = 0
        for i, batch in enumerate(self._map_batches(partitioner)):
            if i >= total_maps:
                break
            if wanted is not None:
                if wanted <= already:
                    break
                if i not in wanted:
                    continue
            parts = self._split(batch, partitioner)
            retry_block(lambda i=i, p=parts: handle.rewrite_map(i, p))
            already = already | {i}
            rewritten += 1
        handle._recomputed_maps = already
        RECOVERY.bump("recomputed_maps", rewritten)
        self.add_metric("recomputedMapOutputs", rewritten)

    def _upload(self, tables: List[HostTable], device) -> DeviceTable:
        """One output batch on ``device`` (a landing: in the OOM retry
        loop), on the exec's own thread and stream."""
        from spark_rapids_tpu_torch.columnar.table import (
            concat_host,
            upload_host_table,
        )
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        host = tables[0] if len(tables) == 1 else concat_host(tables)
        t0 = perf_counter()
        out = retry_block(lambda: upload_host_table(host, device))
        self.add_metric("shuffleUploadTime", perf_counter() - t0)
        return out


def _sharded(batch) -> bool:
    from spark_rapids_tpu_torch.execs.basic import is_sharded
    return is_sharded(batch)


def _concat(batches) -> DeviceTable:
    """The batches (sharded ones re-landed) as one table on the first's
    device."""
    from spark_rapids_tpu_torch.execs.mesh import reland
    from spark_rapids_tpu_torch.runtime.retry import retry_block
    dev = batches[0].device
    batches = [reland(b, dev) if _sharded(b) else b for b in batches]
    return (retry_block(lambda: concat_device(batches))
            if len(batches) > 1 else batches[0])


def _row_blocks(table: DeviceTable, mesh) -> List[DeviceTable]:
    """``table`` cut into contiguous row blocks, one a mesh member, on its
    device (the capacity padded to a multiple of the mesh size)."""
    from spark_rapids_tpu_torch.parallel.mesh import shard_put
    ndev = mesh.size
    per = -(-table.capacity // ndev)
    live = table.row_mask()
    out = []
    for i, dev in enumerate(mesh.devices):
        lo, hi = min(i * per, table.capacity), min((i + 1) * per,
                                                   table.capacity)
        cols = [c.with_arrays(shard_put(c.data[lo:hi], dev),
                              shard_put(c.validity[lo:hi], dev))
                for c in table.columns]
        m = shard_put(live[lo:hi], dev)
        out.append(DeviceTable(table.names, cols,
                               m.sum(dtype=torch.int32), hi - lo, dev,
                               live=m))
    return out


def _packed_row_bytes(table: DeviceTable) -> int:
    """Approximate serialized bytes a row (column data words and a
    validity byte), for the AQE map-output statistic."""
    total = 0
    for c in table.columns:
        total += c.data.element_size() * (
            c.data.shape[1] if c.data.dim() == 2 else 1) + 1
    return total
