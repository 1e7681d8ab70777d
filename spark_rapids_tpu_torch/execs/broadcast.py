"""Broadcast exchange (port of the TpuBroadcastExchangeExec part of
``spark_rapids_tpu/execs/broadcast.py``).

A join's build side whose size estimate is under the broadcast threshold
is materialized ONCE into a single prefix table and reused by every later
execution of the exec: a replayed attempt of the same query (runtime/
speculation.py) does not recompute it. The reference keeps the cached
table spillable; the port has no spill framework yet and keeps the
DeviceTable itself. The nested-loop join of that module is not ported."""

from __future__ import annotations

from spark_rapids_tpu_torch.columnar.table import concat_device
from spark_rapids_tpu_torch.execs.base import TpuExec


class TpuBroadcastExchangeExec(TpuExec):
    def __init__(self, child: TpuExec):
        self.children = (child,)
        self._cached = None

    def output_schema(self):
        return self.children[0].output_schema()

    def execute(self):
        if self._cached is None:
            batches = list(self.children[0].execute())
            if not batches:
                raise NotImplementedError(
                    "a broadcast of a child that yields no batch is not "
                    "ported")
            table = concat_device(batches).compacted()
            self.add_metric("broadcastBatches", len(batches))
            self._cached = table
        yield self._cached
