"""Exec base and the transitions of the CPU route (port of
``spark_rapids_tpu/execs/base.py``).

Two output protocols, as in the reference: ``execute()`` always yields
PREFIX tables (live rows at [0, nrows)); ``execute_masked()`` may yield
MASKED tables (liveness as a device bool mask), letting mask-aware
consumers skip the compaction. An exec implements one of the two; the
defaults tie them together.

Where the plan's tag sends a node to the CPU route (overrides/rules.py),
transitions join it to the device execs around it: :class:`HostToDevice`
uploads a host node's batches for a device parent (``h2dTime``,
``h2dBatches``), :class:`DeviceToHost` downloads a device child's batches
for a host parent (``d2hTime``) through an :class:`InputAdapter`, and
:class:`CpuRootExec` is the root of a plan whose top runs on the host.
Each of the three lists the DeviceToHost transitions under its host node
as its ``children``, so every walk over the exec tree (the fault and
observation boundaries, LORE, the metrics, the event record) reaches the
device execs below the host nodes."""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Tuple

from spark_rapids_tpu_torch.columnar import DeviceTable, HostTable
from spark_rapids_tpu_torch.obs.metrics import (  # noqa: F401 (re-export)
    level_allows,
    register_metric,
    set_metrics_level,
)


class TpuExec:
    """Base of device operators. ``execute`` yields DeviceTable batches."""

    children: Tuple["TpuExec", ...] = ()

    #: set by mask-producing execs that implement execute_masked directly
    produces_masked = False

    #: does the exec run anything on the device (the placement layer
    #: takes the device semaphore for a tree that does)
    runs_on_device = True

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


# ---------------------------------------------------------------------------
# transitions of the CPU route
# ---------------------------------------------------------------------------

register_metric("h2dTime", "timing", "MODERATE",
                "seconds uploading a CPU-route node's batches")
register_metric("h2dBatches", "count", "MODERATE",
                "batches a CPU-route node uploaded")
register_metric("d2hTime", "timing", "MODERATE",
                "seconds downloading a device child's batches for a "
                "CPU-route node")


def device_transitions(node) -> List["DeviceToHost"]:
    """The DeviceToHost transitions under host plan node ``node`` (its
    device children's entries), in plan order."""
    out: List[DeviceToHost] = []

    def walk(n):
        if isinstance(n, InputAdapter):
            out.append(n.source)
            return
        for c in n.children:
            walk(c)

    walk(node)
    return out


class DeviceToHost(TpuExec):
    """Transition: a device exec's batches downloaded for a host parent
    (the reference's GpuColumnarToRowExec analog). Only the root's
    download is ever asynchronous (runtime/placement.py), so a mid-plan
    DeviceToHost downloads synchronously."""

    def __init__(self, tpu_exec: TpuExec):
        self.tpu_exec = tpu_exec
        self.children = (tpu_exec,)

    def output_schema(self):
        return self.tpu_exec.output_schema()

    def execute_cpu(self) -> Iterator[HostTable]:
        from spark_rapids_tpu_torch.runtime.profiler import op_range
        for dt in self.tpu_exec.execute():
            t0 = time.perf_counter()
            with op_range("DeviceToHost"):
                out = dt.to_host()
            del dt
            self.add_metric("d2hTime", time.perf_counter() - t0)
            yield out

    def describe(self):
        return "DeviceToHost"


class InputAdapter:
    """A host plan node whose batches come from a DeviceToHost transition
    (a CPU-route node's child that ran on the device)."""

    children = ()

    def __init__(self, source: DeviceToHost, schema):
        self.source = source
        self._schema = list(schema)

    @property
    def name(self) -> str:
        return "InputAdapter"

    def output_schema(self):
        return self._schema

    def estimate_bytes(self):
        return None

    def execute_cpu(self) -> Iterator[HostTable]:
        return self.source.execute_cpu()

    def collect_cpu(self) -> HostTable:
        from spark_rapids_tpu_torch.columnar.table import (
            concat_host,
            empty_host_table,
        )
        batches = list(self.execute_cpu())
        return (concat_host(batches) if batches
                else empty_host_table(self._schema))

    def describe(self):
        return "InputAdapter"


class HostToDevice(TpuExec):
    """Transition: a CPU-route node's host batches uploaded for a device
    parent (the reference's GpuRowToColumnarExec analog). Each upload is
    a device landing: it reserves with the memory arbiter and replays
    under ``retry_block`` when the budget squeezes it."""

    def __init__(self, cpu_node, device):
        self.cpu_node = cpu_node
        self.device = device
        self.children = tuple(device_transitions(cpu_node))

    def output_schema(self):
        return self.cpu_node.output_schema()

    def execute(self) -> Iterator[DeviceTable]:
        from spark_rapids_tpu_torch.columnar.table import upload_host_table
        from spark_rapids_tpu_torch.runtime.profiler import op_range
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        for batch in self.cpu_node.execute_cpu():
            t0 = time.perf_counter()
            with op_range("HostToDevice"):
                out = retry_block(
                    lambda b=batch: upload_host_table(b, self.device))
            del batch
            self.add_metric("h2dTime", time.perf_counter() - t0)
            self.add_metric("h2dBatches", 1)
            yield out

    def describe(self):
        return f"HostToDevice[{self.cpu_node.describe()}]"


class CpuRootExec(TpuExec):
    """The root of a plan whose top node runs on the CPU route: the
    placement layer collects its host table (``collect``) instead of
    draining device batches."""

    runs_on_device = False

    def __init__(self, cpu_node):
        self.cpu_node = cpu_node
        self.children = tuple(device_transitions(cpu_node))

    def output_schema(self):
        return self.cpu_node.output_schema()

    def collect(self) -> HostTable:
        return self.cpu_node.collect_cpu()

    def describe(self):
        return f"CpuRoot[{self.cpu_node.describe()}]"
