"""Placement layer: how a converted plan is drained on the device (port of
the drain part of ``spark_rapids_tpu/runtime/placement.py``).

The session keeps the planning half (conversion, metrics); this layer
drains the exec tree under speculative sizing and under the device
semaphore: a plan that holds a device exec takes one of the
``spark.rapids.sql.concurrentGpuTasks`` slots for each drain, download
included, and completes the asynchronous result fetch
(``spark.rapids.sql.asyncResultFetch``): the root's download is enqueued
into pinned staging buffers under the semaphore, the semaphore
releases, and :meth:`PlacementLayer.resolve_pending` waits for the
copies. The port has no DeviceToHost exec: its root download is
:func:`_drain`, and only it is armed. The reference's mesh realization
is not ported (item 11)."""

from __future__ import annotations

from spark_rapids_tpu_torch.columnar import HostTable
from spark_rapids_tpu_torch.obs.metrics import register_metric

register_metric("resultFetchTime", "timing", "ESSENTIAL",
                "seconds the session waited for the root's enqueued "
                "result copies after the device semaphore released")
register_metric("asyncFetchBatches", "count", "MODERATE",
                "results downloaded through the asynchronous fetch")
register_metric("asyncFetchSynchronous", "count", "ESSENTIAL",
                "results downloaded synchronously although the "
                "asynchronous fetch was on: the pinned pool could not "
                "hold them (the memory scope)")

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

    def prepare(self) -> None:
        """Realize the placement config for the coming query, before its
        fingerprint and its plan: the device manager for the session's
        device and conf (a lost device raises here, inside the recovery)
        and the memory arbiter's budget. The reference configures its
        mesh and cluster here too (item 11)."""
        from spark_rapids_tpu_torch.runtime.memory import MEMORY
        self._session.runtime  # noqa: B018 (starts the device manager)
        MEMORY.configure(self._session.conf)

    def drain(self, root, async_fetch: bool = False) -> HostTable:
        """Drain ``root`` into a HostTable. Under speculative sizing (the
        default) every speculation flag of an attempt is read at once when
        it collects; a failed attempt blocklists its sites process-wide
        and the query replays, at most ``MAX_ATTEMPTS`` times, then once
        without speculation. Each drain holds the device semaphore; with
        ``async_fetch`` the result's copies are enqueued under it and
        waited for after it released, inside the speculation attempt."""
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
                out = _drain(root, async_fetch)
            return self.resolve_pending(root, out)

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


    def resolve_pending(self, root, out) -> HostTable:
        """Complete an enqueued download (the semaphore is already
        released; only the copies remain), recording ``resultFetchTime``;
        then the root's ``numOutputRows`` is the result's row count, read
        on the host for free (no deferred device count is fetched for
        the root). A HostTable passes through."""
        from spark_rapids_tpu_torch.columnar.table import PendingHostTable
        if isinstance(out, PendingHostTable):
            import time

            from spark_rapids_tpu_torch.dispatch import note_host_fetch
            note_host_fetch()
            t0 = time.perf_counter()
            out = out.resolve()
            root.add_metric("resultFetchTime", time.perf_counter() - t0)
            root.add_metric("asyncFetchBatches", 1)
        if root.__dict__.get("_obs_installed"):
            root._obs_pending_rows = []
            root.metrics["numOutputRows"] = out.num_rows
        return out


def _drain(root, async_fetch: bool = False):
    """The root's batches concatenated on the device and downloaded (an
    empty table of the root's schema when it yields none). Each batch is
    a SpillableBatch while the rest are drained, so a result larger than
    the device budget moves to the host instead of staying resident (the
    reference's drain downloads batch by batch); when any did, the
    result is assembled on the host. With ``async_fetch`` a result that
    stayed on the device is enqueued into the pinned pool and returned as
    a PendingHostTable; one the pool cannot hold downloads synchronously
    and counts ``asyncFetchSynchronous``."""
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
            table = retry_block(lambda: concat_device(
                [sb.get() for sb in spills]))
            if async_fetch:
                pending = _enqueue(table)
                if pending is not None:
                    return pending
            return table.to_host()
        return concat_host([sb.get_host() for sb in spills])
    finally:
        for sb in spills:
            sb.release()


def _enqueue(table):
    """``table``'s download enqueued into the pinned pool, or None
    (counted as ``asyncFetchSynchronous``) when the pool cannot hold it."""
    from spark_rapids_tpu_torch.columnar.table import enqueue_download
    from spark_rapids_tpu_torch.obs.metrics import metric_scope
    from spark_rapids_tpu_torch.runtime.host_alloc import PinnedMemoryPool
    pool = PinnedMemoryPool.get()
    pending = enqueue_download(table, pool) if pool is not None else None
    if pending is None:
        metric_scope("memory").add("asyncFetchSynchronous", 1)
    return pending


def _reset_metrics(root) -> None:
    """A fresh attempt's metrics: every exec's counters and deferred row
    counts cleared."""
    root.metrics.clear()
    if root.__dict__.get("_obs_pending_rows"):
        root._obs_pending_rows = []
    for c in root.children:
        _reset_metrics(c)
