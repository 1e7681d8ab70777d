"""Exec base (port of ``spark_rapids_tpu/execs/base.py``).

Two output protocols, as in the reference: ``execute()`` always yields
PREFIX tables (live rows at [0, nrows)); ``execute_masked()`` may yield
MASKED tables (liveness as a device bool mask), letting mask-aware
consumers skip the compaction. An exec implements one of the two; the
defaults tie them together."""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

from spark_rapids_tpu_torch.columnar import DeviceTable
from spark_rapids_tpu_torch.obs.metrics import (  # noqa: F401 (re-export)
    level_allows,
    set_metrics_level,
)


class TpuExec:
    """Base of device operators. ``execute`` yields DeviceTable batches."""

    children: Tuple["TpuExec", ...] = ()

    #: set by mask-producing execs that implement execute_masked directly
    produces_masked = False

    #: plan-position id, assigned by overrides/rules.convert in plan order
    #: (the reference's lore id): speculation sites of two look-alike
    #: operators stay distinct, and a repeated query gets the same ids
    _lore_id = 0

    #: the plan-node class this exec was converted from (set by
    #: overrides/rules.py; None on a helper exec such as a coalesce
    #: wrapper): the circuit breaker's unit (runtime/faults.py)
    _plan_origin = None

    @property
    def metrics(self) -> Dict[str, int]:
        m = self.__dict__.get("_metrics")
        if m is None:
            m = self.__dict__["_metrics"] = {}
        return m

    def add_metric(self, name: str, value: int) -> None:
        """Add ``value`` to metric ``name`` when the query's metrics level
        (``spark.rapids.sql.metrics.level``) collects it."""
        if level_allows(name):
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

    def spillable_batches(self) -> Tuple[list, int]:
        """The output batches for a consumer that needs them whole (a
        join's build), and the device bytes of the one table
        ``concat_device`` would make of them: one batch comes back as its
        DeviceTable, for the consumer to shrink or split before anything
        accounts it; of several, each is a SpillableBatch from the
        arrival of the second on, so they may move to the host while the
        rest are made. The caller releases them (``take``)."""
        from spark_rapids_tpu_torch.columnar import bucket_for
        from spark_rapids_tpu_torch.runtime.spill import (
            BufferCatalog,
            SpillableBatch,
        )
        catalog = BufferCatalog.get()
        items, caps, row_bytes = [], 0, 0
        try:
            for b in self.execute_masked():
                caps += b.capacity
                row_bytes = b.device_nbytes() // max(b.capacity, 1)
                if len(items) == 1:
                    items[0] = SpillableBatch(items[0], catalog)
                items.append(SpillableBatch(b, catalog) if items else b)
                del b
        except BaseException:
            for x in items:
                if isinstance(x, SpillableBatch):
                    x.release()
            raise
        if len(items) > 1:
            caps = bucket_for(caps)
        return items, caps * row_bytes


def prepend(items: list, it: Iterator) -> Iterator:
    """``items``, then ``it``, keeping no reference to an item once it is
    yielded: a batch the consumer spills or drops is then free
    (``itertools.chain`` over a list would hold the first batches for the
    whole stream). Takes ownership of ``items``."""
    while items:
        yield items.pop(0)
    yield from it


def first_two(it: Iterator) -> list:
    """The first two batches of ``it`` (fewer when it yields fewer), each a
    SpillableBatch from the moment it arrives: an exec that must see two
    batches to pick its route keeps the first where the memory arbiter
    can move it while the second is made. ``take`` gives back a table."""
    from spark_rapids_tpu_torch.runtime.spill import (
        BufferCatalog,
        SpillableBatch,
    )
    items = []
    for b in it:
        items.append(SpillableBatch(b, BufferCatalog.get()))
        del b
        if len(items) == 2:
            break
    return items


def take(x) -> DeviceTable:
    """A SpillableBatch's table, on the device and out of the catalog; a
    DeviceTable as it is."""
    from spark_rapids_tpu_torch.runtime.spill import SpillableBatch
    if not isinstance(x, SpillableBatch):
        return x
    try:
        return x.get()
    finally:
        x.release()
