"""Device partitioners (port of ``Partitioner``, ``HashPartitioner``,
``RoundRobinPartitioner`` and ``SinglePartitioner`` of
``spark_rapids_tpu/shuffle/partitioning.py``): each gives every row of a
batch its partition id on the device. Range partitioning (sampled bounds)
is not ported: the exchange's tag raises for it."""

from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import DeviceTable
from spark_rapids_tpu_torch.ops.expr import Expression, compile_project
from spark_rapids_tpu_torch.shuffle.hashing import (
    SPARK_SEED,
    device_string_bytes,
    murmur3_hash_device,
)


class Partitioner:
    num_partitions: int

    def partition_ids(self, table: DeviceTable) -> torch.Tensor:
        """int32 partition ids of rows [0, capacity) (padding rows get an
        id too; the split drops them)."""
        raise NotImplementedError


class HashPartitioner(Partitioner):
    """Spark's: pmod(murmur3(keys, seed 42), n)."""

    def __init__(self, keys: Sequence[Expression], num_partitions: int):
        self.keys = list(keys)
        self.num_partitions = num_partitions

    def partition_ids(self, table: DeviceTable) -> torch.Tensor:
        key_cols = compile_project(self.keys, table)
        cols = [(c.data, c.validity, c.dtype) for c in key_cols]
        string_bytes = {
            i: device_string_bytes(c.dictionary, table.device)
            for i, c in enumerate(key_cols)
            if isinstance(c.dtype, T.StringType)}
        h = murmur3_hash_device(cols, SPARK_SEED, string_bytes)
        # Spark's pmod: a non-negative remainder
        return torch.remainder(h, self.num_partitions)


class RoundRobinPartitioner(Partitioner):
    def __init__(self, num_partitions: int, start: int = 0):
        self.num_partitions = num_partitions
        self.start = start

    def partition_ids(self, table: DeviceTable) -> torch.Tensor:
        idx = torch.arange(table.capacity, dtype=torch.int32,
                           device=table.device)
        return (idx + self.start) % self.num_partitions


class SinglePartitioner(Partitioner):
    num_partitions = 1

    def partition_ids(self, table: DeviceTable) -> torch.Tensor:
        return torch.zeros(table.capacity, dtype=torch.int32,
                           device=table.device)
