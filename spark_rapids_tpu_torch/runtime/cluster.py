"""The multi-process cluster: the driver/executor protocol and the HOST
fault domain (port of ``spark_rapids_tpu/runtime/cluster.py``:
``ClusterRuntime``, ``scan_route``, ``ClusterDriver``, ``_executor_scan``,
``spawn_executor`` and ``executor_main``).

* :class:`ClusterRuntime` (``CLUSTER``): the conf-driven host topology
  (``spark.rapids.cluster.*``), H executor hosts, host i owning the i-th
  contiguous group of the mesh's logical devices. Its identity folds into
  the plan fingerprint and its generation into the executable cache's.
* The protocol: :class:`ClusterDriver` listens on ``127.0.0.1`` (port 0),
  registers each executor's data and heartbeat connections, dispatches
  scan work by host and sweeps the heartbeats. :func:`executor_main` is
  the executor, a separate process (``python -m
  spark_rapids_tpu_torch.runtime.cluster_exec``) that scans the files
  assigned to its host ON THE HOST (``execute_cpu``: it makes no CUDA call
  and imports no JAX, pyarrow or pandas) and ships one TPAK frame per
  file back (shuffle/serializer.py). A file scan partitions its files BY
  HOST (io/common.py routes through :meth:`ClusterRuntime.scan_route`),
  in contiguous slices, so the batches land in path order: the same
  batches a local PERFILE scan decodes.
* The host fault domain: the ``host.*`` fault points; ``device_lost`` at
  any of them raises HostLostError, which walks the host ladder
  (runtime/health.py ``on_host_loss``: retry, re-land the lost host's
  files on the survivors, shrink, single process, then the device-loss
  ladder), bounded by ``spark.rapids.cluster.maxHostLosses``. A frame that
  fails its CRC at landing re-lands from the intact received copy
  (``hostShardRetries``).
* Health: executor heartbeats ride the shuffle's heartbeat ledger
  (shuffle/heartbeat.py); a host that misses
  ``spark.rapids.cluster.missedBeats`` beats, or whose beat connection
  closes (a killed process closes its sockets), is declared lost, and a
  respawned executor's registration restores the host.

The cluster is process state, like the mesh. One process and a cluster
give the same batches, in the same order."""

from __future__ import annotations

import os
import socket
import struct
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.conf import (  # noqa: F401 (re-export)
    CLUSTER_DISPATCH_TIMEOUT_MS,
    CLUSTER_ENABLED,
    CLUSTER_HEARTBEAT_MS,
    CLUSTER_MAX_HOST_LOSSES,
    CLUSTER_MISSED_BEATS,
    CLUSTER_NUM_HOSTS,
    RapidsConf,
)
from spark_rapids_tpu_torch.obs.metrics import metric_scope, register_metric
from spark_rapids_tpu_torch.lockorder import ordered_lock

# -- the `cluster` metric scope ---------------------------------------------

register_metric("hostsLost", "count", "ESSENTIAL",
                "executor hosts declared lost (missed-beat sweep, "
                "dead dispatch socket, or the host ladder's re-land "
                "rung) — each one re-routes its shards to survivors")
register_metric("hostRelands", "count", "ESSENTIAL",
                "host shard re-landings: scans that re-assigned a "
                "lost host's source files onto surviving executors "
                "(one count per lost host per routed scan)")
register_metric("hostShrinks", "count", "ESSENTIAL",
                "topology shrinks: hosts evicted from the cluster by "
                "the degradation ladder, their device group excluded "
                "from the dcn axis (bounded by "
                "spark.rapids.cluster.maxHostLosses)")
register_metric("hostRestores", "count", "ESSENTIAL",
                "hosts restored to the topology after a rejoin "
                "(heartbeat re-register / respawned executor)")
register_metric("dcnExchanges", "count", "ESSENTIAL",
                "shuffle collectives whose mesh spanned more than one "
                "cluster host group — the all-to-all crossed the DCN "
                "axis, not just intra-host ICI")
register_metric("hostShardsLanded", "count", "MODERATE",
                "host shard batches landed by the driver from "
                "executor scan responses (one per file batch)")
register_metric("hostShardRetries", "count", "MODERATE",
                "host shard landings retried after a corrupt frame "
                "(TPAK CRC mismatch at the host.shard.land boundary)")
register_metric("executorBeatsDropped", "count", "MODERATE",
                "executor heartbeats dropped at the driver (injected "
                "host.heartbeat faults or ledger errors) — enough of "
                "them and the sweep declares the host lost")
register_metric("clusterScanFallbacks", "count", "MODERATE",
                "scans that requested cluster routing but ran locally "
                "(unsupported format, hive-partitioned paths, no live "
                "executors, or the single-process latch)")

CLUSTER_SCOPE = metric_scope("cluster")

#: CRC-failed host shard landings retried against the intact received
#: frame before the landing is classified as a host loss
SHARD_LAND_RETRIES = 2

#: scan formats the executor side can reconstruct from a wire spec
#: (everything else falls back to a local scan, counted). Parquet only:
#: its named constructor kwargs (columns, filters) all round-trip
#: through _scan_spec. CSV does NOT qualify — CsvScanNode consumes
#: sep/header/schema/quote/... as named kwargs that never reach
#: self.options, so a wire rebuild would silently parse with defaults
#: and break the bit-identity contract.
_EXECUTOR_SCAN_FORMATS = ("parquet",)


# -- per-query per-host scan attribution -------------------------------------
# Thread-local like the dispatch counters: the drain pulls cluster-
# routed scans on the executing thread, so per-host stats accumulated
# here belong to exactly one in-flight query. The session resets at
# top-level execute and folds the result into the v9 event record's
# ``hostScans`` field.

_TL_SCAN_STATS = threading.local()


def reset_host_scan_stats() -> None:
    _TL_SCAN_STATS.stats = {}


def host_scan_stats() -> Dict[str, dict]:
    """This thread's accumulated per-host scan attribution:
    {host: {scans, files, bytes, wallS, execWallS, crcRetries}}."""
    return {h: dict(v)
            for h, v in getattr(_TL_SCAN_STATS, "stats", {}).items()}


def _bump_host_stat(host_id: str, **deltas) -> None:
    stats = getattr(_TL_SCAN_STATS, "stats", None)
    if stats is None:
        stats = _TL_SCAN_STATS.stats = {}
    e = stats.setdefault(host_id, {"scans": 0, "files": 0, "bytes": 0,
                                   "wallS": 0.0, "execWallS": 0.0,
                                   "crcRetries": 0})
    for k, v in deltas.items():
        cur = e.get(k, 0)
        e[k] = (round(cur + v, 6) if isinstance(cur, float)
                else cur + int(v))


#: per-ATTEMPT cluster suppression (the session's replay machinery sets
#: this when an attempt must not touch the cluster at all); distinct
#: from the single-process LATCH, which is process state until a host
#: rejoins
_SUPPRESS: "ContextVar[Optional[str]]" = ContextVar(
    "cluster_suppress", default=None)


def cluster_suppression_reason() -> Optional[str]:
    return _SUPPRESS.get()


@contextmanager
def suppressed_cluster(reason: str):
    """Scope one execution attempt's cluster demotion (scans land
    locally for THIS thread's attempt only)."""
    tok = _SUPPRESS.set(reason)
    try:
        yield
    finally:
        _SUPPRESS.reset(tok)


class ClusterRuntime:
    """Process-wide cluster topology state (owned like MESH/HEALTH,
    configured per query by the placement layer). The fault-domain
    half: ``_lost`` holds hosts the sweep or the ladder's re-land rung
    declared lost (they rejoin via restore_host), ``_excluded`` holds
    hosts the shrink rung evicted (their device group leaves the dcn
    axis until restore), and ``_single_process_reason`` is the
    bottom-rung latch — the driver scans everything locally until a
    host rejoins."""

    def __init__(self):
        self._lock = ordered_lock("cluster.runtime")
        self._enabled = False
        self._declared_hosts = 0
        self._config_key = None
        self._generation = 0
        self._driver: Optional["ClusterDriver"] = None
        self._lost: set = set()
        self._excluded: set = set()
        self._single_process_reason: Optional[str] = None
        self._degraded_reason: Optional[str] = None
        #: (generation, {device id -> host index}) — the collective
        #: hot path's cached view of the host groups (rebuilt only on
        #: topology change, never per exchange)
        self._dev_host_map: Optional[tuple] = None

    # -- configuration -------------------------------------------------------
    def configure(self, conf: RapidsConf) -> None:
        """Apply the session's cluster conf (cheap when unchanged; a
        real change bumps the generation so cached trees fence)."""
        enabled = bool(conf.get_entry(CLUSTER_ENABLED))
        hosts = int(conf.get_entry(CLUSTER_NUM_HOSTS))
        with self._lock:
            if hosts <= 0 and self._driver is not None:
                hosts = self._driver.expected_hosts
            key = (enabled, hosts)
            if key == self._config_key:
                return
            self._config_key = key
            self._enabled = enabled
            self._declared_hosts = hosts
            self._generation += 1

    def attach_driver(self, driver: Optional["ClusterDriver"]) -> None:
        """Bind (or clear) the process's cluster driver — the harness /
        deployment entry point. Detaching also clears the fault-domain
        state: a fresh driver starts at full strength."""
        with self._lock:
            self._driver = driver
            self._config_key = None  # re-derive host count next configure
            if driver is None:
                self._lost = set()
                self._excluded = set()
                self._single_process_reason = None
                self._degraded_reason = None
            self._generation += 1

    def driver(self) -> Optional["ClusterDriver"]:
        with self._lock:
            return self._driver

    # -- state ---------------------------------------------------------------
    def active(self) -> bool:
        """Is cluster routing live for THIS thread right now? (enabled,
        driver attached, at least one usable host, no single-process
        latch, no per-attempt suppression)."""
        if _SUPPRESS.get() is not None:
            return False
        with self._lock:
            return (self._enabled and self._driver is not None
                    and self._single_process_reason is None
                    and len(self._usable_hosts_locked()) > 0)

    def _declared_ids_locked(self) -> List[str]:
        return [f"h{i}" for i in range(self._declared_hosts)]

    def _usable_hosts_locked(self) -> List[str]:
        return [h for h in self._declared_ids_locked()
                if h not in self._lost and h not in self._excluded]

    def usable_hosts(self) -> List[str]:
        with self._lock:
            return self._usable_hosts_locked()

    def declared_hosts(self) -> int:
        with self._lock:
            return self._declared_hosts

    def generation(self) -> int:
        with self._lock:
            return self._generation

    def identity_token(self) -> str:
        """Stable token of the current HOST topology — folded into the
        plan fingerprint next to the mesh identity token, so cached
        plans never cross cluster topologies."""
        if _SUPPRESS.get() is not None:
            return "cluster:suppressed"
        with self._lock:
            if not self._enabled or self._driver is None:
                return "cluster:off"
            if self._single_process_reason is not None:
                return "cluster:single-process"
            return (f"cluster:{self._declared_hosts}/"
                    f"lost={','.join(sorted(self._lost))}/"
                    f"excl={','.join(sorted(self._excluded))}")

    def topology_str(self) -> Optional[str]:
        """Human/event-log host topology ('2' at full strength,
        '1/2' degraded); None when cluster execution is off."""
        with self._lock:
            if not self._enabled or self._driver is None:
                return None
            if self._single_process_reason is not None:
                return f"0/{self._declared_hosts}"
            live = len(self._usable_hosts_locked())
            if live == self._declared_hosts:
                return str(self._declared_hosts)
            return f"{live}/{self._declared_hosts}"

    def host_device_ids(self, host_id: str) -> Tuple[int, ...]:
        """Device ids of ``host_id``'s contiguous group (the dcn row
        the host owns when the hierarchical mesh is enabled)."""
        with self._lock:
            n = self._declared_hosts
        if n <= 0:
            return ()
        try:
            idx = int(host_id.lstrip("h"))
        except ValueError:
            return ()
        from spark_rapids_tpu_torch.parallel.mesh import logical_devices
        devices = list(range(len(logical_devices())))
        per = max(1, len(devices) // n)
        # the LAST host owns any remainder: every device belongs to
        # exactly one host even when the count is not divisible, so a
        # shrink can never strand unowned devices in the mesh
        end = len(devices) if idx == n - 1 else (idx + 1) * per
        return tuple(devices[idx * per:end])

    def device_host_map(self) -> Dict[int, int]:
        """device id -> owning host index for the declared topology,
        cached per generation — the mesh exchange consults this on
        EVERY exchange (dcn_exchange_point), so it must not re-walk the
        logical devices per host per call."""
        with self._lock:
            gen = self._generation
            n = self._declared_hosts
            if (self._dev_host_map is not None
                    and self._dev_host_map[0] == gen):
                return self._dev_host_map[1]
        mapping: Dict[int, int] = {}
        if n > 0:
            from spark_rapids_tpu_torch.parallel.mesh import logical_devices
            devices = list(range(len(logical_devices())))
            per = max(1, len(devices) // n)
            for i in range(n):
                # last host owns the remainder (host_device_ids's rule)
                end = len(devices) if i == n - 1 else (i + 1) * per
                for d in devices[i * per:end]:
                    mapping[d] = i
        with self._lock:
            if self._generation == gen:
                self._dev_host_map = (gen, mapping)
        return mapping

    # -- the host degradation ladder's cluster half --------------------------
    def mark_host_lost(self, host_id: Optional[str], reason: str) -> Optional[str]:
        """Declare one host lost (the sweep's missed-beat verdict, a
        dead dispatch socket, or the ladder's re-land rung). With no
        host named (injected losses), the LAST usable host is the
        deterministic choice. Subsequent scans re-land the host's
        shards onto survivors; the host rejoins via restore_host.
        Returns the host id marked, or None when nothing usable is
        left to mark."""
        with self._lock:
            if host_id is not None and host_id in self._declared_ids_locked():
                if host_id in self._lost or host_id in self._excluded:
                    return host_id  # already marked; never pick a second victim
            else:
                usable = self._usable_hosts_locked()
                if not usable:
                    return None
                host_id = usable[-1]
            self._lost.add(host_id)
            self._degraded_reason = reason
            self._generation += 1
        CLUSTER_SCOPE.add("hostsLost", 1)
        return host_id

    def shrink_excluding(self, host_id: Optional[str], reason: str) -> bool:
        """The ladder's shrink rung: evict one host from the topology
        — its device group leaves the mesh's dcn axis (the generation
        bump fences every cached tree, exactly like a mesh shrink).
        Returns False when no second host remains (the ladder then
        latches single-process)."""
        with self._lock:
            if not self._enabled or self._declared_hosts <= 0:
                return False
            candidates = [h for h in self._declared_ids_locked()
                          if h not in self._excluded]
            if len(candidates) <= 1:
                return False
            if host_id is None or host_id in self._excluded:
                lost_first = [h for h in candidates if h in self._lost]
                host_id = (lost_first or candidates)[-1]
            self._excluded.add(host_id)
            self._lost.discard(host_id)
            self._degraded_reason = reason
            self._generation += 1
        CLUSTER_SCOPE.add("hostShrinks", 1)
        # the host's device group leaves the mesh: the declared
        # hierarchical shape no longer fits the survivors, so the mesh
        # collapses to a flat surviving-device axis (correctness never
        # depended on the declared factorization)
        ids = self.host_device_ids(host_id)
        if ids:
            from spark_rapids_tpu_torch.parallel.mesh import MESH
            MESH.exclude_devices(ids, reason)
        return True

    def latch_single_process(self, reason: str) -> None:
        """Bottom cluster rung: stop routing to executors entirely —
        every scan lands locally (still serving, minus the cluster)
        until a host rejoins and restore clears the latch."""
        with self._lock:
            self._single_process_reason = reason
            self._degraded_reason = reason
            self._generation += 1

    def restore_host(self, host_id: str) -> bool:
        """A host rejoined (heartbeat re-register / respawned
        executor's fresh registration): clear its lost/excluded state,
        the single-process latch, and the mesh exclusions its eviction
        caused. Returns whether anything was restored."""
        restore_mesh = False
        with self._lock:
            had = (host_id in self._lost or host_id in self._excluded
                   or self._single_process_reason is not None)
            restore_mesh = host_id in self._excluded
            self._lost.discard(host_id)
            self._excluded.discard(host_id)
            self._single_process_reason = None
            if not self._lost and not self._excluded:
                self._degraded_reason = None
            if had:
                self._generation += 1
        if had:
            CLUSTER_SCOPE.add("hostRestores", 1)
        if restore_mesh:
            from spark_rapids_tpu_torch.parallel.mesh import MESH
            MESH.restore(f"cluster host {host_id} rejoined")
        return had

    def restore(self) -> bool:
        """Clear every host exclusion/latch (the end-of-chaos probe,
        or an operator-driven reset). A host that is genuinely still
        dead just re-walks the ladder."""
        with self._lock:
            had = bool(self._lost or self._excluded
                       or self._single_process_reason)
            lost_mesh = bool(self._excluded)
            self._lost = set()
            self._excluded = set()
            self._single_process_reason = None
            self._degraded_reason = None
            if had:
                self._generation += 1
        if lost_mesh:
            from spark_rapids_tpu_torch.parallel.mesh import MESH
            MESH.restore("cluster topology restored")
        return had

    def degraded_reason(self) -> Optional[str]:
        with self._lock:
            return self._degraded_reason

    def health_snapshot(self) -> dict:
        """The host-topology state QueryService.health()['hosts']
        reports (mirroring the mesh section)."""
        with self._lock:
            return self._health_snapshot_locked()

    def _health_snapshot_locked(self) -> dict:
        """Snapshot body for callers that already hold ``self._lock``
        — the shared-topology path (health.consistent_topology_snapshot)
        nests cluster→health→mesh→memory in declared rank order so one
        view can't tear across a mid-query shrink."""
        live = self._usable_hosts_locked() if self._enabled else []
        return {
            "enabled": self._enabled and self._driver is not None,
            "declaredHosts": self._declared_hosts,
            "liveHosts": live,
            "lostHosts": sorted(self._lost),
            "excludedHosts": sorted(self._excluded),
            "singleProcessReason": self._single_process_reason,
            "degradedReason": self._degraded_reason,
            "generation": self._generation,
        }

    # -- scan routing --------------------------------------------------------
    def scan_route(self, scan_node, paths: List[str]):
        """Route one file scan through the cluster, or return None for
        a local scan. Routing requires an active cluster, a format the
        executor side reconstructs, and no hive-partitioned path
        components (partition-value inference must see the FULL file
        list to be stable; a by-host subset could infer differently).
        Unroutable scans under an enabled cluster count
        clusterScanFallbacks."""
        if _SUPPRESS.get() is not None:
            return None
        with self._lock:
            driver = self._driver
            enabled = self._enabled
            routable = (enabled and driver is not None
                        and self._single_process_reason is None)
        if not routable:
            if enabled and driver is not None:
                CLUSTER_SCOPE.add("clusterScanFallbacks", 1)
            return None
        fmt = getattr(scan_node, "format_name", None)
        if fmt not in _EXECUTOR_SCAN_FORMATS or any(
                "=" in comp for p in paths
                for comp in os.path.dirname(p).split(os.sep)):
            CLUSTER_SCOPE.add("clusterScanFallbacks", 1)
            return None
        # the spec must survive the JSON wire: a date/np-typed filter
        # value pyarrow happily accepts locally would otherwise crash
        # the dispatch with an unclassified TypeError mid-query
        try:
            import json
            json.dumps(_scan_spec(scan_node, []))
        except TypeError:
            CLUSTER_SCOPE.add("clusterScanFallbacks", 1)
            return None
        return driver.scan(scan_node, paths)


#: THE process-wide cluster runtime (host topology is process state,
#: like the mesh and the device manager)
CLUSTER = ClusterRuntime()


def sweep_cluster_hosts() -> List[str]:
    """One heartbeat sweep over the attached driver's executor ledger
    (missed-beat threshold -> declare host lost). Called by the
    driver's own sweeper thread AND the query-service watchdog's
    sweep; a no-op without an attached driver."""
    driver = CLUSTER.driver()
    if driver is None:
        return []
    return driver.sweep_once()


def dcn_exchange_point(mesh) -> None:
    """THE cross-host exchange marker: called by the mesh exchange
    before its all-to-all; when the exchange's mesh spans more than
    one cluster host group the collective crosses the DCN axis — the
    ``host.dcn.exchange`` fault point fires (device_lost there raises
    HostLostError into the host ladder) and dcnExchanges counts."""
    if not CLUSTER.active():
        return
    id_to_host = CLUSTER.device_host_map()
    if not id_to_host:
        return
    groups = set()
    for d in mesh.ids:
        groups.add(id_to_host.get(d, -1))
        if len(groups) > 1:
            break
    if len(groups) <= 1:
        return
    from spark_rapids_tpu_torch.runtime.faults import fault_point
    fault_point("host.dcn.exchange")
    CLUSTER_SCOPE.add("dcnExchanges", 1)


# ---------------------------------------------------------------------------
# Wire protocol (framed JSON header + optional binary payload, the P2P
# shuffle transport's framing pattern)
# ---------------------------------------------------------------------------


def _send_msg(sock: socket.socket, obj: dict, payload: bytes = b"") -> None:
    import json
    head = json.dumps(obj).encode("utf-8")
    # one send for the header and a small payload: separate small sends
    # would wait on the peer's delayed ACK
    first = struct.pack("<II", len(head), len(payload)) + head
    if len(payload) <= 64 << 10:
        sock.sendall(first + bytes(payload))
        return
    sock.sendall(first)
    sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("cluster peer closed the connection")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> Tuple[dict, bytes]:
    import json
    head_len, payload_len = struct.unpack("<II", _recv_exact(sock, 8))
    obj = json.loads(_recv_exact(sock, head_len).decode("utf-8"))
    payload = _recv_exact(sock, payload_len) if payload_len else b""
    return obj, payload


def _scan_spec(scan_node, paths: List[str]) -> dict:
    """The wire form of one host's scan assignment: enough for the
    executor to reconstruct the SAME scan node over its path subset
    (PERFILE mode pins one batch per file, so driver-side reassembly
    in path order is byte-identical to a local scan)."""
    spec = {
        "type": "scan",
        "format": scan_node.format_name,
        "paths": paths,
        "columns": scan_node.columns,
        "options": dict(scan_node.options),
        "file_info": bool(getattr(scan_node, "provide_file_info", False)),
    }
    filters = getattr(scan_node, "filters", None)
    if filters is not None:
        spec["filters"] = [list(f) for f in filters]
    return spec


def _build_scan_node(spec: dict):
    """Executor side of _scan_spec."""
    fmt = spec["format"]
    kwargs = dict(spec.get("options") or {})
    if fmt == "parquet":
        from spark_rapids_tpu_torch.io.parquet import ParquetScanNode as cls
        filters = spec.get("filters")
        if filters is not None:
            kwargs["filters"] = [tuple(f) for f in filters]
    else:
        raise ValueError(f"unsupported cluster scan format {fmt!r}")
    node = cls(spec["paths"], RapidsConf({}), columns=spec.get("columns"),
               reader_type="PERFILE", **kwargs)
    if spec.get("file_info"):
        node.enable_file_info()
    return node


# ---------------------------------------------------------------------------
# Driver half
# ---------------------------------------------------------------------------


class _HostChannel:
    """One executor's data connection (driver->executor RPC). A lock
    serializes round trips; concurrent scans over one host queue."""

    __slots__ = ("host_id", "sock", "lock")

    def __init__(self, host_id: str, sock: socket.socket):
        self.host_id = host_id
        self.sock = sock
        self.lock = ordered_lock("cluster.channel")


class ClusterDriver:
    """The driver half of the cluster protocol: listens on a loopback
    socket, registers executor data/beat connections, dispatches scan
    work per host, sweeps heartbeats, and feeds host losses/rejoins
    into :data:`CLUSTER`. One instance per process (the harness or a
    real deployment attaches it via ``CLUSTER.attach_driver``)."""

    def __init__(self, expected_hosts: int,
                 conf: Optional[RapidsConf] = None):
        conf = conf or RapidsConf({})
        self.expected_hosts = int(expected_hosts)
        self.heartbeat_ms = int(conf.get_entry(CLUSTER_HEARTBEAT_MS))
        self.missed_beats = int(conf.get_entry(CLUSTER_MISSED_BEATS))
        self.dispatch_timeout_s = (
            int(conf.get_entry(CLUSTER_DISPATCH_TIMEOUT_MS)) / 1000.0)
        from spark_rapids_tpu_torch.shuffle.heartbeat import (
            ShuffleHeartbeatManager,
        )
        self._hb = ShuffleHeartbeatManager(
            heartbeat_timeout_s=self.missed_beats * self.heartbeat_ms
            / 1000.0)
        self._lock = ordered_lock("cluster.driver")
        self._channels: Dict[str, _HostChannel] = {}
        self._registered: set = set()
        #: hosts with an OPEN beat connection right now — beat-conn EOF
        #: is the prompt, unambiguous death signal (a SIGKILLed process
        #: closes its sockets); the missed-beat sweep is the slower
        #: path for wedged-but-connected executors
        self._beat_alive: set = set()
        self._shutdown = False
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(64)
        self.address = self._listener.getsockname()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="rapids-cluster-accept",
            daemon=True)
        self._accept_thread.start()
        self._sweep_thread = threading.Thread(
            target=self._sweep_loop, name="rapids-cluster-sweep",
            daemon=True)
        self._sweep_thread.start()

    # -- lifecycle -----------------------------------------------------------
    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            channels = list(self._channels.values())
            self._channels = {}
        for ch in channels:
            try:
                with ch.lock:
                    _send_msg(ch.sock, {"type": "shutdown"})
                    ch.sock.close()
            except OSError:
                pass
        try:
            self._listener.close()
        except OSError:
            pass

    # -- accept / registration ----------------------------------------------
    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                hello, _ = _recv_msg(conn)
            except (OSError, ValueError, ConnectionError):
                conn.close()
                continue
            host_id = str(hello.get("host", ""))
            role = hello.get("role")
            if role == "data":
                self._register_data(host_id, conn)
            elif role == "beat":
                threading.Thread(
                    target=self._beat_loop, args=(host_id, conn),
                    name=f"rapids-cluster-beat-{host_id}",
                    daemon=True).start()
            else:
                conn.close()

    def _register_data(self, host_id: str, conn: socket.socket) -> None:
        conn.settimeout(self.dispatch_timeout_s)
        rejoined = False
        with self._lock:
            if self._shutdown:
                conn.close()
                return
            old = self._channels.get(host_id)
            self._channels[host_id] = _HostChannel(host_id, conn)
            rejoined = host_id in self._registered
            self._registered.add(host_id)
        if old is not None:
            try:
                old.sock.close()
            except OSError:
                pass
        if rejoined:
            # a respawned executor's fresh registration: the host
            # rejoins the topology at full strength
            CLUSTER.restore_host(host_id)

    def _beat_loop(self, host_id: str, conn: socket.socket) -> None:
        """Driver side of one executor's heartbeat connection: the
        register/beat/evict/re-register protocol over the wire. An
        injected ``host.heartbeat`` fault DROPS the beat (counted) —
        enough dropped beats and the sweep declares the host lost, the
        exact missed-beat path a wedged executor takes."""
        from spark_rapids_tpu_torch.errors import ColumnarProcessingError
        from spark_rapids_tpu_torch.runtime.faults import fault_point
        from spark_rapids_tpu_torch.shuffle.transport import PeerInfo
        me = PeerInfo(executor_id=host_id)
        self._hb.register_executor(me)
        with self._lock:
            self._beat_alive.add(host_id)
        try:
            _send_msg(conn, {"type": "registered"})
            while True:
                msg, _ = _recv_msg(conn)
                kind = msg.get("type")
                if kind == "beat":
                    try:
                        fault_point("host.heartbeat")
                        self._hb.heartbeat(host_id)
                        _send_msg(conn, {"type": "ok"})
                    except ColumnarProcessingError:
                        # the ledger evicted us between beats: tell the
                        # executor so it re-registers (rejoin path)
                        _send_msg(conn, {"type": "evicted"})
                    except Exception:
                        # injected beat fault: drop the beat, keep the
                        # connection — missing enough of them IS the
                        # failure mode under test
                        CLUSTER_SCOPE.add("executorBeatsDropped", 1)
                        _send_msg(conn, {"type": "dropped"})
                elif kind == "register":
                    self._hb.register_executor(me)
                    CLUSTER.restore_host(host_id)
                    _send_msg(conn, {"type": "registered"})
                else:
                    return
        except (OSError, ValueError, ConnectionError):
            # beat-connection EOF: the executor PROCESS is gone (a
            # SIGKILL closes its sockets) — declare the host lost
            # immediately instead of waiting out the beat window
            with self._lock:
                down = not self._shutdown
            if down:
                CLUSTER.mark_host_lost(
                    host_id,
                    f"host {host_id} heartbeat connection lost "
                    f"(executor process down)")
            return
        finally:
            with self._lock:
                self._beat_alive.discard(host_id)
            try:
                conn.close()
            except OSError:
                pass

    # -- health --------------------------------------------------------------
    def sweep_once(self) -> List[str]:
        """Evict executors that missed the beat window and declare
        their hosts lost (the watchdog's executor-heartbeat sweep) —
        and RESTORE lost hosts that are provably alive again (beating
        on an open connection, data channel usable): a ladder-marked
        host whose process never actually died — an injected transient
        loss — rejoins on evidence of health, the same outcome as the
        evicted->re-register path without waiting for an eviction."""
        dead = self._hb.evict_dead()
        for host_id in dead:
            CLUSTER.mark_host_lost(
                host_id,
                f"host {host_id} missed {self.missed_beats} heartbeats "
                f"({self.heartbeat_ms}ms interval)")
        snap = CLUSTER.health_snapshot()
        if snap["lostHosts"]:
            alive = set(self._hb.live_executors())
            with self._lock:
                beating = set(self._beat_alive)
                have = set(self._channels)
            for host_id in snap["lostHosts"]:
                if (host_id in alive and host_id in beating
                        and host_id in have):
                    CLUSTER.restore_host(host_id)
        return dead

    def _sweep_loop(self) -> None:
        interval = max(0.02, self.heartbeat_ms / 1000.0 / 2)
        while True:
            with self._lock:
                if self._shutdown:
                    return
            self.sweep_once()
            time.sleep(interval)

    def live_hosts(self) -> List[str]:
        """Hosts with a usable data channel, in declared order."""
        with self._lock:
            return sorted(self._channels)

    def wait_ready(self, n: Optional[int] = None,
                   timeout_s: float = 30.0) -> None:
        """Block until ``n`` (default: expected) executors have
        registered both channels."""
        want = n if n is not None else self.expected_hosts
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                ready = len(self._channels)
            if ready >= want and len(self._hb.live_executors()) >= want:
                return
            time.sleep(0.02)
        raise TimeoutError(
            f"cluster driver: only "
            f"{len(self.live_hosts())}/{want} executors registered "
            f"within {timeout_s}s")

    # -- scan dispatch -------------------------------------------------------
    def _channel(self, host_id: str) -> _HostChannel:
        from spark_rapids_tpu_torch.errors import HostLostError
        with self._lock:
            ch = self._channels.get(host_id)
        if ch is None:
            raise HostLostError(
                f"no data channel to executor host {host_id}",
                host_id=host_id)
        return ch

    def _drop_channel(self, host_id: str, ch: _HostChannel) -> None:
        with self._lock:
            if self._channels.get(host_id) is ch:
                del self._channels[host_id]
        try:
            ch.sock.close()
        except OSError:
            pass

    def scan_host(self, host_id: str, scan_node,
                  paths: List[str]) -> List[bytes]:
        """One driver->executor scan round trip: dispatch the host's
        path subset (the ``host.dispatch`` fault point), receive one
        TPAK frame per file. A socket failure/timeout mid-round-trip
        is a HOST loss (the process, not one request, is presumed
        gone) — typed HostLostError, channel dropped, ladder recovers.

        Cross-host trace propagation: when the driver's span tracer is
        live, the dispatch frame carries a ``trace`` flag — the
        executor runs its own SpanTracer around the scan and ships the
        span summaries (plus per-scan wall/bytes) back in the reply
        header, which merge into this query's trace on an
        ``executor-<host>`` lane and into the per-host ``hostScans``
        event-record attribution."""
        from spark_rapids_tpu_torch.errors import HostLostError
        from spark_rapids_tpu_torch.obs.spans import TRACER
        from spark_rapids_tpu_torch.runtime.faults import fault_point
        ch = self._channel(host_id)
        fault_point("host.dispatch")
        spec = _scan_spec(scan_node, paths)
        if TRACER.enabled:
            spec["trace"] = True
        t0 = time.perf_counter()
        try:
            with ch.lock:
                _send_msg(ch.sock, spec)
                reply, _ = _recv_msg(ch.sock)
                if reply.get("type") == "error":
                    # a QUERY-scoped executor error (unreadable file,
                    # decode failure): the executor kept its loop and
                    # the channel stays usable — typed for the ladder,
                    # but never manufactured into a dead process
                    raise HostLostError(
                        f"executor host {host_id} failed its scan: "
                        f"{reply.get('error')}", host_id=host_id)
                frames = []
                for _ in range(int(reply.get("n", 0))):
                    _head, payload = _recv_msg(ch.sock)
                    frames.append(payload)
        except HostLostError:
            raise  # channel intact (error reply / injected fault)
        except (OSError, ValueError, ConnectionError) as exc:
            # the WIRE failed mid-round-trip: the process is presumed
            # gone — only here does the channel drop
            self._drop_channel(host_id, ch)
            raise HostLostError(
                f"executor host {host_id} lost mid-dispatch "
                f"({type(exc).__name__}: {exc})",
                host_id=host_id) from exc
        wall = time.perf_counter() - t0
        exec_scan = reply.get("scan") or {}
        _bump_host_stat(host_id, scans=1, files=len(frames),
                        bytes=sum(len(f) for f in frames), wallS=wall,
                        execWallS=float(exec_scan.get("wallS", 0.0)))
        spans = reply.get("spans")
        if spans:
            # anchor the executor's relative span clock at the dispatch
            # send: durations are exact, offsets shifted by the one-way
            # wire latency (different perf_counter domains)
            TRACER.add_remote_spans(host_id, spans, t0)
        return frames

    def scan(self, scan_node, paths: List[str]):
        """Partition ``paths`` BY HOST (contiguous slices over the
        usable hosts, so global path order — and therefore batch order
        and bit-identity — is preserved), dispatch each host's subset,
        and yield the landed batches in path order. A lost host's
        slice re-lands on survivors automatically: the assignment only
        ever covers usable hosts (hostRelands counts each lost host
        whose work was re-assigned)."""
        from spark_rapids_tpu_torch.errors import CorruptFrameError, HostLostError
        from spark_rapids_tpu_torch.obs.spans import TRACER
        from spark_rapids_tpu_torch.runtime.faults import fault_point
        from spark_rapids_tpu_torch.shuffle.serializer import unpack_table

        live = set(self.live_hosts())
        usable = [h for h in CLUSTER.usable_hosts() if h in live]
        if not usable:
            raise HostLostError(
                "no live executor hosts to scan against", host_id=None)
        # re-lands count LOST hosts only (their work is being routed
        # around, pending a rejoin); EXCLUDED hosts left the topology
        # deliberately via the shrink rung — steady-state scans on the
        # shrunk cluster are not degradation events
        relanded = len(CLUSTER.health_snapshot()["lostHosts"])
        if relanded > 0:
            CLUSTER_SCOPE.add("hostRelands", relanded)
        # contiguous slices in host order preserve global path order
        per = (len(paths) + len(usable) - 1) // len(usable)
        for i, host_id in enumerate(usable):
            sub = paths[i * per:(i + 1) * per]
            if not sub:
                continue
            # one driver-side span per dispatched host: the dispatch
            # round trip is attributed wall (executing thread), and the
            # executor's own spans nest under an executor-<host> lane
            sp = (TRACER.begin("cluster.scan", "cluster", host=host_id,
                               files=len(sub)) if TRACER.enabled else None)
            try:
                frames = self.scan_host(host_id, scan_node, sub)
            finally:
                TRACER.end(sp)
            for frame in frames:
                # THE host shard landing point: corrupt damages the
                # landed copy and the TPAK CRC catches it — the intact
                # received frame re-lands (hostShardRetries), modeling
                # a refetch from the executor's intact buffer; chronic
                # corruption classifies as a host loss
                for attempt in range(SHARD_LAND_RETRIES + 1):
                    data = fault_point("host.shard.land", data=frame)
                    try:
                        table, _ = unpack_table(data)
                        break
                    except CorruptFrameError as exc:
                        CLUSTER_SCOPE.add("hostShardRetries", 1)
                        _bump_host_stat(host_id, crcRetries=1)
                        if attempt >= SHARD_LAND_RETRIES:
                            raise HostLostError(
                                f"host {host_id} shard landing failed "
                                f"its CRC {attempt + 1} times "
                                f"({exc})", host_id=host_id) from exc
                CLUSTER_SCOPE.add("hostShardsLanded", 1)
                yield table


# ---------------------------------------------------------------------------
# Executor half
# ---------------------------------------------------------------------------


def _executor_scan(msg: dict, host_id: str):
    """Run one dispatched scan on the executor, optionally under the
    executor's OWN SpanTracer (the driver's dispatch frame carries a
    ``trace`` flag when its tracer is live): per-file decode + pack
    spans collect locally and ship back as compact summaries — t0
    relative to scan start, so the driver can merge them into ITS
    query trace on an executor lane. Returns (frames, scan_summary,
    span_payload)."""
    from spark_rapids_tpu_torch.obs.spans import TRACER
    from spark_rapids_tpu_torch.shuffle.serializer import pack_table
    want_trace = bool(msg.get("trace"))
    node = _build_scan_node(msg)
    t_q0 = time.perf_counter()
    frames: List[bytes] = []
    span_payload: List[dict] = []
    # the executor's scan is ALWAYS local: in thread mode (tests) this
    # process also hosts the driver, and an unsuppressed scan would
    # recurse through scan_route back to this very executor — deadlock
    # by construction
    with suppressed_cluster("executor-local scan"):
        if not want_trace:
            frames = [pack_table(t) for t in node.execute_cpu()]
        else:
            TRACER.begin_query(0)
            try:
                it = node.execute_cpu()
                i = 0
                while True:
                    t_f0 = time.perf_counter()
                    try:
                        table = next(it)
                    except StopIteration:
                        break
                    sp = TRACER.begin("executor.scan.file", "exec-scan",
                                      index=i)
                    if sp is not None:
                        sp.t0 = t_f0  # decode happened inside next()
                    TRACER.end(sp)
                    sp = TRACER.begin("executor.pack", "exec-scan",
                                      index=i)
                    frames.append(pack_table(table))
                    TRACER.end(sp)
                    i += 1
            finally:
                spans = TRACER.end_query()
            span_payload = [
                {"name": s.name, "cat": s.cat,
                 "t0": round(s.t0 - t_q0, 6), "dur": round(s.dur, 6),
                 "args": s.args}
                for s in spans][:256]
    scan_summary = {
        "wallS": round(time.perf_counter() - t_q0, 6),
        "files": len(frames),
        "bytes": sum(len(f) for f in frames),
        "host": host_id,
        "pid": os.getpid(),
    }
    return frames, scan_summary, span_payload


def _executor_serve_data(sock: socket.socket, host_id: str) -> None:
    """Executor data loop: serve driver scan requests until shutdown.
    One frame per file batch (PERFILE), TPAK-serialized — the same
    bytes the P2P shuffle moves."""
    while True:
        msg, _ = _recv_msg(sock)
        kind = msg.get("type")
        if kind == "scan":
            try:
                frames, scan_summary, span_payload = _executor_scan(
                    msg, host_id)
            except Exception as exc:  # noqa: BLE001 - report to driver
                _send_msg(sock, {"type": "error",
                                 "error": f"{type(exc).__name__}: {exc}"})
                continue
            reply = {"type": "scan_result", "n": len(frames),
                     "scan": scan_summary}
            if span_payload:
                reply["spans"] = span_payload
            _send_msg(sock, reply)
            for frame in frames:
                _send_msg(sock, {"type": "frame"}, payload=frame)
        elif kind == "ping":
            _send_msg(sock, {"type": "pong", "host": host_id,
                             "pid": os.getpid(), **_executor_hygiene()})
        elif kind == "shutdown":
            return
        else:
            return


#: top-level modules an executor process never imports
FORBIDDEN_MODULES = ("jax", "jaxlib", "spark_rapids_tpu", "pyarrow",
                     "pandas")


def _executor_hygiene() -> dict:
    """What the driver's ``ping`` checks of an executor: whether it made a
    CUDA context (it scans on the host and must not), and which forbidden
    modules it imported."""
    import torch
    return {"cudaInitialized": bool(torch.cuda.is_initialized()),
            "forbiddenModules": sorted(
                m for m in sys.modules
                if m.split(".")[0] in FORBIDDEN_MODULES
                and sys.modules[m] is not None)}


def _executor_beat_loop(host: str, port: int, host_id: str,
                        heartbeat_ms: int, stop: threading.Event) -> None:
    """Executor heartbeat loop: beat every interval; an ``evicted``
    reply re-registers (the beat_or_recover rejoin path over the
    wire)."""
    try:
        sock = socket.create_connection((host, port), timeout=10.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # block on replies: a driver wedged in a long GIL-holding
        # compile answers late, not never — timing out here would kill
        # the beat loop and read as a DEAD executor to the sweep
        sock.settimeout(None)
        _send_msg(sock, {"type": "hello", "role": "beat", "host": host_id})
        _recv_msg(sock)  # registered
        while not stop.wait(heartbeat_ms / 1000.0):
            _send_msg(sock, {"type": "beat"})
            reply, _ = _recv_msg(sock)
            if reply.get("type") == "evicted":
                _send_msg(sock, {"type": "register"})
                _recv_msg(sock)  # registered
    except (OSError, ValueError, ConnectionError):
        return  # driver gone; the data loop's failure ends the process


def _executor_run(host: str, port: int, host_id: str,
                  heartbeat_ms: int,
                  stop: Optional[threading.Event] = None) -> None:
    """One executor's lifetime: register both channels, beat on a
    background thread, serve scans until the driver closes."""
    stop = stop or threading.Event()
    beat = threading.Thread(
        target=_executor_beat_loop,
        args=(host, port, host_id, heartbeat_ms, stop),
        name=f"rapids-executor-beat-{host_id}", daemon=True)
    beat.start()
    try:
        sock = socket.create_connection((host, port), timeout=10.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # connect timeout only: the data loop BLOCKS between requests
        # (an idle executor waiting for work is healthy, not dead —
        # liveness is the beat channel's job)
        sock.settimeout(None)
        _send_msg(sock, {"type": "hello", "role": "data", "host": host_id})
        _executor_serve_data(sock, host_id)
    except (OSError, ValueError, ConnectionError):
        pass
    finally:
        stop.set()


class ExecutorHandle:
    """Harness handle over one spawned executor (subprocess or
    in-process thread — the latter for cheap protocol tests)."""

    def __init__(self, host_id: str, mode: str, proc=None, thread=None,
                 stop: Optional[threading.Event] = None):
        self.host_id = host_id
        self.mode = mode
        self.proc = proc
        self.thread = thread
        self._stop = stop

    def alive(self) -> bool:
        if self.mode == "process":
            return self.proc is not None and self.proc.poll() is None
        return self.thread is not None and self.thread.is_alive()

    def terminate(self) -> None:
        """Kill the executor (the chaos harness's host kill)."""
        if self.mode == "process" and self.proc is not None:
            self.proc.kill()
            self.proc.wait(timeout=10)
        elif self._stop is not None:
            self._stop.set()


def spawn_executor(address: Tuple[str, int], host_id: str,
                   heartbeat_ms: int = 250,
                   mode: str = "process") -> ExecutorHandle:
    """Start one executor against a driver ``address``. ``process``
    spawns ``python -m spark_rapids_tpu_torch.runtime.cluster_exec`` (the
    real multi-process harness; the shim module — running cluster.py
    itself under -m would double-import it); ``thread`` runs the same
    protocol loops in-process (fast protocol tests, no process
    isolation)."""
    host, port = address
    if mode == "thread":
        stop = threading.Event()
        t = threading.Thread(
            target=_executor_run,
            args=(host, port, host_id, heartbeat_ms, stop),
            name=f"rapids-executor-{host_id}", daemon=True)
        t.start()
        return ExecutorHandle(host_id, mode, thread=t, stop=stop)
    env = dict(os.environ)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_rapids_tpu_torch.runtime.cluster_exec",
         "--host-id", host_id, "--driver-host", host,
         "--driver-port", str(port), "--heartbeat-ms", str(heartbeat_ms)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return ExecutorHandle(host_id, mode, proc=proc)


def executor_main(argv: Optional[List[str]] = None) -> int:
    """The executor process entry point of the multi-process
    simulation harness — launched as ``python -m
    spark_rapids_tpu_torch.runtime.cluster_exec`` (a shim module: running
    THIS module under -m would import it twice and double-register
    its conf keys)."""
    import argparse
    ap = argparse.ArgumentParser(prog="spark_rapids_tpu_torch.runtime.cluster")
    ap.add_argument("--host-id", required=True)
    ap.add_argument("--driver-host", default="127.0.0.1")
    ap.add_argument("--driver-port", type=int, required=True)
    ap.add_argument("--heartbeat-ms", type=int, default=250)
    args = ap.parse_args(argv)
    _executor_run(args.driver_host, args.driver_port, args.host_id,
                  args.heartbeat_ms)
    return 0
