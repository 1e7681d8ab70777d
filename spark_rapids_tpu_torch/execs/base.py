"""Exec base (port of ``spark_rapids_tpu/execs/base.py``).

Two output protocols, as in the reference: ``execute()`` always yields
PREFIX tables (live rows at [0, nrows)); ``execute_masked()`` may yield
MASKED tables (liveness as a device bool mask), letting mask-aware
consumers skip the compaction. An exec implements one of the two; the
defaults tie them together."""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

from spark_rapids_tpu_torch.columnar import DeviceTable


class TpuExec:
    """Base of device operators. ``execute`` yields DeviceTable batches."""

    children: Tuple["TpuExec", ...] = ()

    #: set by mask-producing execs that implement execute_masked directly
    produces_masked = False

    #: plan-position id, assigned by overrides/rules.convert in plan order
    #: (the reference's lore id): speculation sites of two look-alike
    #: operators stay distinct, and a repeated query gets the same ids
    _lore_id = 0

    @property
    def metrics(self) -> Dict[str, int]:
        m = self.__dict__.get("_metrics")
        if m is None:
            m = self.__dict__["_metrics"] = {}
        return m

    def add_metric(self, name: str, value: int) -> None:
        self.metrics[name] = self.metrics.get(name, 0) + value

    def output_schema(self):
        raise NotImplementedError

    def execute(self) -> Iterator[DeviceTable]:
        if not self.produces_masked:
            raise NotImplementedError
        for b in self.execute_masked():
            yield b.compacted()

    def execute_masked(self) -> Iterator[DeviceTable]:
        return self.execute()

