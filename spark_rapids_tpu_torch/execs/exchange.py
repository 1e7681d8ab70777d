"""Shuffle exchange exec (port of ``TpuShuffleExchangeExec`` of
``spark_rapids_tpu/execs/exchange.py``, its single-process device split
``_execute_local_device_split`` only).

A repartition on one device moves no rows: one partition-id pass over the
input, then one MASKED view per partition over the same buffers, all of
them carrying one split token (``DeviceTable.split_group``), so a
consumer that re-groups every row merges them back into one batch
(columnar/table.py ``merge_split_views``). ``execute_masked()`` yields
the views, ``execute()`` their compacted forms. A range exchange's
bounds come from a sample over the whole concatenated input
(shuffle/partitioning.py), as the reference samples every batch. The
reference's other
transports are not ported: the collective (ICI) and peer-to-peer (P2P)
shuffles and the file-backed host shuffle. The reference takes the host
shuffle past ``LOCAL_SPLIT_MAX_PARTITIONS`` partitions, so such a
repartition raises."""

from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch.columnar import DeviceTable
from spark_rapids_tpu_torch.columnar.table import concat_device
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.ops.expr import Expression
from spark_rapids_tpu_torch.shuffle.partitioning import (
    HashPartitioner,
    Partitioner,
    RangePartitioner,
    RoundRobinPartitioner,
    SinglePartitioner,
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


class TpuShuffleExchangeExec(TpuExec):
    produces_masked = True

    #: the views share the input's buffers, but every consumer that does
    #: not merge them runs at the input's full capacity per partition:
    #: past this many partitions the reference takes the host shuffle
    LOCAL_SPLIT_MAX_PARTITIONS = 32

    def __init__(self, child: TpuExec, mode: str, num_partitions: int,
                 keys: Sequence[Expression]):
        self.children = (child,)
        self.mode = mode
        self.num_partitions = 1 if mode == "single" else num_partitions
        self.keys = list(keys)

    def output_schema(self):
        return self.children[0].output_schema()

    def execute_masked(self):
        if self.num_partitions > self.LOCAL_SPLIT_MAX_PARTITIONS:
            raise NotImplementedError(
                f"a repartition into {self.num_partitions} partitions (more "
                f"than {self.LOCAL_SPLIT_MAX_PARTITIONS} take the host "
                "shuffle) is not ported")
        batches = list(self.children[0].execute_masked())
        if not batches:
            return
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        table = (retry_block(lambda: concat_device(batches))
                 if len(batches) > 1 else batches[0])
        del batches
        parter = make_partitioner(self.mode, self.keys, self.num_partitions)
        pids = parter.partition_ids(table)
        live = table.row_mask()
        self.add_metric("localSplitParts", self.num_partitions)
        split_group = object()  # one token per split: its masks are disjoint
        for p in range(self.num_partitions):
            mask = live & (pids == p)
            out = DeviceTable(table.names, table.columns,
                              mask.sum(dtype=torch.int32), table.capacity,
                              table.device, live=mask)
            out.split_group = split_group
            yield out
