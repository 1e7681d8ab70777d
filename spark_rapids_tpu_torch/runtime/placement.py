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
copies. The root's download is :func:`_drain`, and only it is armed: a
mid-plan DeviceToHost transition of the CPU route (execs/base.py)
downloads synchronously, and a root on the CPU route
(``CpuRootExec``) is collected on the host. ``prepare`` realizes the
mesh and the cluster for the query (parallel/mesh.py, runtime/cluster.py)
and pushes the mesh's gather tunables."""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def ansi_mode(conf):
    """``spark.sql.ansi.enabled`` as ``dispatch.ANSI_MODE`` for the query
    run inside, in the thread that runs it (a service worker's too),
    reset after."""
    from spark_rapids_tpu_torch.conf import ANSI_ENABLED
    from spark_rapids_tpu_torch.dispatch import ANSI_MODE
    tok = ANSI_MODE.set(bool(conf.get_entry(ANSI_ENABLED)))
    try:
        yield
    finally:
        ANSI_MODE.reset(tok)


def uses_device(executable) -> bool:
    """Does a converted plan contain a device exec?"""
    from spark_rapids_tpu_torch.execs.base import TpuExec
    if isinstance(executable, TpuExec) and executable.runs_on_device:
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
        and the memory arbiter's budget, then the cluster's host topology
        and the mesh (before the fingerprint, which folds both identities
        in) with the mesh's gather tunables
        (``spark.rapids.mesh.maxShardRetries``, ``.gather.verify``)."""
        from spark_rapids_tpu_torch.conf import (
            MESH_GATHER_VERIFY,
            MESH_MAX_SHARD_RETRIES,
        )
        from spark_rapids_tpu_torch.parallel import mesh as PM
        from spark_rapids_tpu_torch.runtime.cluster import CLUSTER
        from spark_rapids_tpu_torch.runtime.memory import MEMORY
        conf = self._session.conf
        self._session.runtime  # noqa: B018 (starts the device manager)
        MEMORY.configure(conf)
        CLUSTER.configure(conf)
        PM.MESH.configure(conf)
        PM.MAX_SHARD_RETRIES = int(conf.get_entry(MESH_MAX_SHARD_RETRIES))
        PM.GATHER_VERIFY = bool(conf.get_entry(MESH_GATHER_VERIFY))

    def drain(self, root, async_fetch: bool = False,
              keep_on_device: bool = False) -> HostTable:
        """Drain ``root`` into a HostTable. Under speculative sizing (the
        default) every speculation flag of an attempt is read at once when
        it collects; a failed attempt blocklists its sites process-wide
        and the query replays, at most ``MAX_ATTEMPTS`` times, then once
        without speculation. Each drain holds the device semaphore; with
        ``async_fetch`` the result's copies are enqueued under it and
        waited for after it released, inside the speculation attempt.
        With ``keep_on_device`` (the device export) a result on the device
        stays there as a prefix DeviceTable with its row count read.
        ``spark.sql.ansi.enabled`` holds for the drain (``ansi_mode``)."""
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
                out = _drain(root, async_fetch, keep_on_device)
            return self.resolve_pending(root, out)

        session._last_replays = 0
        with ansi_mode(conf):
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


def _drain(root, async_fetch: bool = False, keep_on_device: bool = False):
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
    from spark_rapids_tpu_torch.execs.base import CpuRootExec
    if isinstance(root, CpuRootExec):
        return root.collect()
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
            table = _read_count_with_ansi(table)
            if keep_on_device:
                table = table.compacted()
                table.num_rows  # noqa: B018 (the export's row count)
                return table
            if async_fetch:
                pending = _enqueue(table)
                if pending is not None:
                    return pending
            return table.to_host()
        return concat_host([sb.get_host() for sb in spills])
    finally:
        for sb in spills:
            sb.release()


def _read_count_with_ansi(table):
    """ANSI mode under speculative sizing: the result's row count, which
    its download reads anyway, is read in one copy with the query's
    pending ANSI flags (``SpecContext.read_with_ansi``), so the flags add
    no host sync. Returns the table to download (compacted when it was
    masked and read here). Without pending ANSI flags, or with the count
    already on the host, the table returns as it is."""
    from spark_rapids_tpu_torch.runtime import speculation as spec
    ctx = spec.current()
    if ctx is None or not ctx.has_pending_ansi():
        return table
    if table.live is not None:
        # the download compacts first: its count is the compaction's
        table = table.compacted()
    if table._nrows_host is None:
        table._nrows_host = ctx.read_with_ansi(table.nrows_dev)
    return table


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
