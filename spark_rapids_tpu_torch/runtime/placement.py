"""Placement layer: how a converted plan is drained on the device (port of
the drain part of ``spark_rapids_tpu/runtime/placement.py``).

The session keeps the planning half (conversion, metrics); this layer
drains the exec tree under speculative sizing and under the device
semaphore: a plan that holds a device exec takes one of the
``spark.rapids.sql.concurrentGpuTasks`` slots for each drain, download
included. The reference's mesh realization and its asynchronous result
fetch are not ported."""

from __future__ import annotations

from spark_rapids_tpu_torch.columnar import HostTable

#: attempts of one query under speculation; each failed attempt
#: blocklists its sites, so every replay makes strict progress
MAX_ATTEMPTS = 8


def uses_device(executable) -> bool:
    """Does a converted plan contain a device exec?"""
    from spark_rapids_tpu_torch.execs.base import TpuExec
    if isinstance(executable, TpuExec):
        return True
    return any(uses_device(c) for c in getattr(executable, "children", ()))


class PlacementLayer:
    """One session's placement half (stateless between queries: the conf
    is read per call)."""

    def __init__(self, session):
        self._session = session

    def drain(self, root) -> HostTable:
        """Drain ``root`` into a HostTable. Under speculative sizing (the
        default) every speculation flag of an attempt is read at once when
        it collects; a failed attempt blocklists its sites process-wide
        and the query replays, at most ``MAX_ATTEMPTS`` times, then once
        without speculation. Each drain holds the device semaphore."""
        from spark_rapids_tpu_torch.conf import (
            CONCURRENT_GPU_TASKS,
            SPECULATIVE_SIZING,
        )
        from spark_rapids_tpu_torch.ops.misc import (
            reset_nondeterministic_streams,
        )
        from spark_rapids_tpu_torch.runtime import speculation as spec
        from spark_rapids_tpu_torch.runtime.semaphore import (
            TpuSemaphore,
            acquired,
        )
        session = self._session
        conf = session.conf
        sem = None
        if uses_device(root):
            sem = TpuSemaphore.initialize(
                int(conf.get_entry(CONCURRENT_GPU_TASKS)))

        def drain_once():
            _reset_metrics(root)
            reset_nondeterministic_streams()
            with acquired(sem):
                return _drain(root)

        session._last_replays = 0
        if conf.get_entry(SPECULATIVE_SIZING):
            for attempt in range(MAX_ATTEMPTS):
                tok = spec.activate()
                try:
                    table = drain_once()
                    spec.current().validate_remaining()
                    session._last_replays = attempt
                    return table
                except spec.SpeculationFailed as sf:
                    spec.blocklist(sf.sites)
                finally:
                    spec.deactivate(tok)
            session._last_replays = MAX_ATTEMPTS
        return drain_once()


def _drain(root) -> HostTable:
    """The root's batches concatenated on the device and downloaded (an
    empty table of the root's schema when it yields none). Each batch is
    a SpillableBatch while the rest are drained, so a result larger than
    the device budget moves to the host instead of staying resident (the
    reference's drain downloads batch by batch); when any did, the
    result is assembled on the host."""
    from spark_rapids_tpu_torch.columnar.table import (
        concat_device,
        concat_host,
        empty_host_table,
    )
    from spark_rapids_tpu_torch.runtime.retry import retry_block
    from spark_rapids_tpu_torch.runtime.spill import (
        TIER_DEVICE,
        BufferCatalog,
        SpillableBatch,
    )
    catalog = BufferCatalog.get()
    spills = []
    try:
        for b in root.execute():
            spills.append(SpillableBatch(b, catalog))
            del b
        if not spills:
            return empty_host_table(root.output_schema())
        if all(sb.tier == TIER_DEVICE for sb in spills):
            return retry_block(lambda: concat_device(
                [sb.get() for sb in spills])).to_host()
        return concat_host([sb.get_host() for sb in spills])
    finally:
        for sb in spills:
            sb.release()


def _reset_metrics(root) -> None:
    root.metrics.clear()
    for c in root.children:
        _reset_metrics(c)
