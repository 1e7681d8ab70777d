"""The device mesh as process state (port of
``spark_rapids_tpu/parallel/mesh.py``: ``MeshRuntime``, ``_parse_shape``,
the generation and identity token, ``shard_put``, ``mesh_gather``,
``wordsum_u32`` and the per-attempt suppression).

The mesh is ONE process over a list of torch devices, as the reference's
is one process over its JAX devices. Its members are LOGICAL devices
(:func:`declare_logical_devices`, the counterpart of the reference's
``ensure_host_devices``): N ids, each placed on a physical device round
robin. A box with N cards gives every logical device its own card; one
card holds a logical mesh of N shards, all on ``cuda:0``, and the tests
hold one on the CPU. A logical mesh runs every step of the distributed
path (the sharded landing, the exchange's bucketing and order, the
re-land and its checks, the ladder) but its copies between logical
devices stay on one physical device: it does not show copies between two
cards.

* ``spark.rapids.mesh.enabled`` turns mesh-native execution on; scans then
  land their rows as a :class:`ShardedTable` (contiguous row blocks, one a
  logical device), filters and projections run shard by shard, and every
  other consumer takes its input through the re-land (execs/mesh.py).
* ``spark.rapids.mesh.shape``: ``""`` (every logical device on one axis),
  ``"N"`` or ``"DxI"``; ``spark.rapids.mesh.axis`` names the row axis.

A reconfiguration bumps the **generation** (folded into the executable
cache's generation) and changes the **identity token** (folded into the
plan fingerprint), so cached plans never cross mesh configurations. The
only sanctioned device -> host read in mesh code is :func:`mesh_gather`.
The fault-domain half: the mesh ladder (runtime/health.py) shrinks the
mesh excluding a logical id and restores it, and suppresses the mesh for
one replay (:func:`suppressed_mesh`)."""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.conf import (  # noqa: F401 (re-export)
    MESH_AXIS,
    MESH_DEGRADE_MAX_SHRINKS,
    MESH_ENABLED,
    MESH_GATHER_VERIFY,
    MESH_MAX_SHARD_RETRIES,
    MESH_SHAPE,
    RapidsConf,
)
from spark_rapids_tpu_torch.lockorder import ordered_lock
from spark_rapids_tpu_torch.obs.metrics import metric_scope, register_metric

# -- the `mesh` metric scope (the reference's names) --------------------------

register_metric("shardsDispatched", "count", "ESSENTIAL",
                "table shards landed per logical device by mesh-native "
                "scans (one a logical device per sharded landing)")
register_metric("iciExchanges", "count", "ESSENTIAL",
                "shuffle exchanges run as the mesh's all-to-all exchange "
                "instead of the host shuffle")
register_metric("iciBytes", "bytes", "ESSENTIAL",
                "payload bytes the all-to-all exchanges moved (column data "
                "and validity of the exchanged rows)")
register_metric("meshGatherRows", "count", "MODERATE",
                "elements read to the host through mesh_gather (the "
                "exchange's per-target counts)")
register_metric("hostShuffleFallbacks", "count", "ESSENTIAL",
                "shuffle exchanges that asked for the mesh exchange but "
                "took the host shuffle (reason in explain)")
register_metric("meshHostUploads", "count", "MODERATE",
                "host -> device copies inside the mesh exchange's dispatch "
                "(0 on a warm mesh query)")
register_metric("meshRelandRows", "count", "MODERATE",
                "row slots re-landed from the sharded layout onto the "
                "session's device (execs/mesh.py)")
register_metric("meshDictInterns", "count", "MODERATE",
                "string dictionaries whose hash bytes were put on the mesh "
                "(once per dictionary and mesh)")
register_metric("shardRetries", "count", "ESSENTIAL",
                "re-gathers after a failed row-count/checksum check at a "
                "mesh gather boundary")
register_metric("gatherChecksFailed", "count", "ESSENTIAL",
                "row-count/checksum checks that tripped at a mesh gather "
                "boundary")

MESH_SCOPE = metric_scope("mesh")

#: per-query tunables pushed by the placement layer (runtime/placement.py)
MAX_SHARD_RETRIES = 2
GATHER_VERIFY = True

# -- the logical devices --------------------------------------------------------

_LOGICAL: Optional[Tuple[torch.device, ...]] = None
_LOGICAL_LOCK = ordered_lock("mesh.logical")


def _physical_devices() -> List[torch.device]:
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def declare_logical_devices(n: int, physical: Optional[Sequence] = None
                            ) -> int:
    """Declare ``n`` logical devices over ``physical`` (default: every
    card, else the CPU), round robin: with as many cards as logical
    devices each has its own card, with one card all of them share it.
    Returns the logical device count. The mesh built next (configure)
    spans them."""
    if n < 1:
        raise ValueError(f"a mesh needs at least 1 logical device, got {n}")
    phys = [torch.device(d) for d in (physical or _physical_devices())]
    global _LOGICAL
    with _LOGICAL_LOCK:
        _LOGICAL = tuple(phys[i % len(phys)] for i in range(n))
    return n


def reset_logical_devices() -> None:
    """Forget the declaration: the logical devices are the physical ones
    again."""
    global _LOGICAL
    with _LOGICAL_LOCK:
        _LOGICAL = None


def logical_devices() -> Tuple[torch.device, ...]:
    """The declared logical devices (logical id i is entry i), else the
    physical ones."""
    with _LOGICAL_LOCK:
        if _LOGICAL is not None:
            return _LOGICAL
    return tuple(_physical_devices())


def physical_count(devices: Sequence[torch.device]) -> int:
    """Distinct physical devices under ``devices``."""
    return len({str(d) for d in devices})


def _parse_shape(shape: str, avail: int) -> Tuple[int, ...]:
    """'', 'N' or 'DxI' -> dims. Raises on a malformed shape or one wider
    than the available devices."""
    from spark_rapids_tpu_torch.errors import ColumnarProcessingError
    s = shape.strip().lower()
    if not s:
        return (avail,)
    parts = s.replace("*", "x").split("x")
    try:
        dims = tuple(int(p) for p in parts)
    except ValueError:
        raise ColumnarProcessingError(
            f"spark.rapids.mesh.shape must be '', 'N' or 'DxI', got "
            f"{shape!r}")
    if len(dims) > 2 or any(d < 1 for d in dims):
        raise ColumnarProcessingError(
            f"spark.rapids.mesh.shape supports 1-D 'N' or 2-D 'DxI' "
            f"positive dims, got {shape!r}")
    total = int(np.prod(dims))
    if total > avail:
        raise ColumnarProcessingError(
            f"spark.rapids.mesh.shape={shape!r} needs {total} devices "
            f"but only {avail} are available")
    return dims


class Mesh:
    """A mesh's members: logical ids in row-block order and the torch
    device each is placed on."""

    __slots__ = ("ids", "devices", "dims", "axes")

    def __init__(self, ids: Sequence[int], devices: Sequence[torch.device],
                 dims: Tuple[int, ...], axes: Tuple[str, ...]):
        self.ids = tuple(int(i) for i in ids)
        self.devices = tuple(devices)
        self.dims = tuple(dims)
        self.axes = tuple(axes)

    @property
    def size(self) -> int:
        return len(self.ids)

    def sub(self, n: int) -> "Mesh":
        """The leading ``n`` members as a flat mesh."""
        return Mesh(self.ids[:n], self.devices[:n], (n,), ("data",))


#: per-ATTEMPT suppression (the mesh ladder's single-device rung): the
#: replay of THIS thread's query lands single-device; the process mesh and
#: other threads' queries are untouched
_SUPPRESS: "ContextVar[Optional[str]]" = ContextVar(
    "mesh_suppress", default=None)


def suppression_reason() -> Optional[str]:
    return _SUPPRESS.get()


@contextmanager
def suppressed_mesh(reason: str):
    tok = _SUPPRESS.set(reason)
    try:
        yield
    finally:
        _SUPPRESS.reset(tok)


class MeshRuntime:
    """Process-wide mesh state, configured per query by the session. The
    generation bumps whenever the effective (enabled, dims, axes, members)
    changes; ``_excluded_ids`` holds the logical ids the ladder evicted."""

    def __init__(self):
        self._lock = ordered_lock("mesh.runtime")
        self._mesh: Optional[Mesh] = None
        self._enabled = False
        self._config_key = None
        self._generation = 0
        self._excluded_ids: frozenset = frozenset()
        self._degraded_reason: Optional[str] = None
        self._declared_shape: Optional[str] = None

    # -- configuration -------------------------------------------------------
    def configure(self, conf: RapidsConf) -> None:
        """Apply the session's mesh conf: cheap when unchanged, a rebuild
        and a generation bump otherwise. The key folds the health
        monitor's device-loss generation and the logical devices."""
        from spark_rapids_tpu_torch.errors import ColumnarProcessingError
        from spark_rapids_tpu_torch.runtime.health import HEALTH
        enabled = bool(conf.get_entry(MESH_ENABLED))
        shape = str(conf.get_entry(MESH_SHAPE))
        axis = str(conf.get_entry(MESH_AXIS)).strip() or "data"
        logical = logical_devices()
        with self._lock:
            excluded = self._excluded_ids
            key = (enabled, shape.strip().lower(), axis, HEALTH.generation(),
                   excluded, tuple(str(d) for d in logical))
            if key == self._config_key:
                return
        mesh = None
        if enabled:
            members = [(i, d) for i, d in enumerate(logical)
                       if i not in excluded]
            try:
                dims = _parse_shape(shape, len(members))
            except ColumnarProcessingError:
                if not (excluded and members):
                    raise
                # the declared shape no longer fits the survivors: one
                # flat axis over all of them
                dims = (len(members),)
            axes = ("dcn", "ici") if len(dims) == 2 else (axis,)
            total = int(np.prod(dims))
            mesh = Mesh([i for i, _ in members[:total]],
                        [d for _, d in members[:total]], dims, axes)
        with self._lock:
            if key == self._config_key:
                return
            self._mesh = mesh
            self._enabled = enabled
            self._config_key = key
            self._declared_shape = shape.strip() or None
            self._generation += 1

    # -- the mesh ladder's half ---------------------------------------------
    def shrink_excluding(self, device_id: Optional[int], reason: str) -> bool:
        """Evict one logical device (``device_id``, else the mesh's last);
        the next configure rebuilds from the survivors. False when there
        is no mesh or one device is left."""
        with self._lock:
            if self._mesh is None or not self._enabled:
                return False
            ids = list(self._mesh.ids)
            if len(ids) <= 1:
                return False
            victim = device_id if device_id in ids else ids[-1]
            self._excluded_ids = self._excluded_ids | {victim}
            self._degraded_reason = reason
            self._config_key = None
            return True

    def exclude_devices(self, device_ids, reason: str) -> bool:
        """Evict a group of logical devices (a lost cluster host's); False
        when that would leave none."""
        ids = frozenset(int(i) for i in device_ids)
        if not ids:
            return False
        with self._lock:
            if self._mesh is None or not self._enabled:
                return False
            if not [i for i in self._mesh.ids if i not in ids]:
                return False
            self._excluded_ids = self._excluded_ids | ids
            self._degraded_reason = reason
            self._config_key = None
            return True

    def restore(self, reason: str = "") -> bool:
        """Clear every exclusion; whether anything was excluded."""
        with self._lock:
            had = bool(self._excluded_ids)
            self._excluded_ids = frozenset()
            self._degraded_reason = None
            if had:
                self._config_key = None
            return had

    def degraded_reason(self) -> Optional[str]:
        with self._lock:
            return self._degraded_reason

    def health_snapshot(self) -> dict:
        with self._lock:
            return self._health_snapshot_locked()

    def _health_snapshot_locked(self) -> dict:
        on = self._enabled and self._mesh is not None
        return {
            "enabled": on,
            "shape": "x".join(map(str, self._mesh.dims)) if on else None,
            "declaredShape": self._declared_shape,
            "excludedDeviceIds": sorted(self._excluded_ids),
            "degradedReason": self._degraded_reason,
            "generation": self._generation,
        }

    # -- state ---------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        if _SUPPRESS.get() is not None:
            return False
        with self._lock:
            return self._enabled and self._mesh is not None

    def mesh(self) -> Optional[Mesh]:
        with self._lock:
            return self._mesh

    def effective_ndev(self) -> Optional[int]:
        """The mesh's device count in one read, None when mesh execution
        is off (or suppressed for this attempt)."""
        if _SUPPRESS.get() is not None:
            return None
        with self._lock:
            if not self._enabled or self._mesh is None:
                return None
            return self._mesh.size

    def shape_str(self) -> Optional[str]:
        if _SUPPRESS.get() is not None:
            return None
        with self._lock:
            if not self._enabled or self._mesh is None:
                return None
            return "x".join(map(str, self._mesh.dims))

    def generation(self) -> int:
        with self._lock:
            return self._generation

    def identity_token(self) -> str:
        """Token of the current mesh identity (enabled, dims, axes, logical
        ids and their devices), folded into the plan fingerprint."""
        if _SUPPRESS.get() is not None:
            return "mesh:suppressed"
        with self._lock:
            if not self._enabled or self._mesh is None:
                return "mesh:off"
            m = self._mesh
            members = ",".join(f"{i}@{d}" for i, d in zip(m.ids, m.devices))
            return (f"mesh:{'x'.join(map(str, m.dims))}/"
                    f"{'+'.join(m.axes)}/{members}")

    def scan_placement(self) -> Tuple[Optional[Mesh], Optional[int]]:
        """(mesh, generation) read under one lock hold; (None, None) when
        mesh execution is off."""
        if _SUPPRESS.get() is not None:
            return None, None
        with self._lock:
            if not self._enabled or self._mesh is None:
                return None, None
            return self._mesh, self._generation

    def exchange_mesh(self, nparts: int) -> Mesh:
        """The mesh of an ``nparts``-way exchange: the runtime mesh when
        ``nparts`` covers it, its leading members when narrower, else the
        leading logical devices (``spark.rapids.shuffle.mode=ICI`` with
        the mesh off)."""
        with self._lock:
            mesh = self._mesh
        if mesh is not None:
            if nparts == mesh.size:
                return mesh
            if nparts < mesh.size:
                return mesh.sub(nparts)
        logical = logical_devices()
        return Mesh(range(nparts), logical[:nparts], (nparts,), ("data",))


#: THE process-wide mesh runtime
MESH = MeshRuntime()


def count_mesh_upload(n: int = 1) -> None:
    """Count ``n`` host -> device copies on the mesh dispatch path (0 on a
    warm query)."""
    if n > 0:
        MESH_SCOPE.add("meshHostUploads", n)


def shard_put(x, device: torch.device) -> torch.Tensor:
    """Put one array onto a mesh member's device: a host array is an
    upload (counted), a device tensor a device-to-device copy (none on one
    card). THE shard-landing fault point."""
    from spark_rapids_tpu_torch.runtime.faults import fault_point
    fault_point("mesh.shard.put")
    if isinstance(x, np.ndarray):
        count_mesh_upload(1)
        return torch.from_numpy(x).to(device)
    return x.to(device)


def mesh_gather(value: torch.Tensor, rows: Optional[int] = None
                ) -> np.ndarray:
    """THE sanctioned mesh -> host read: ``value`` on the host, its
    elements counted in ``meshGatherRows`` (``rows`` overrides the count
    for a read that carries a check word)."""
    from spark_rapids_tpu_torch.dispatch import note_host_fetch
    note_host_fetch()
    arr = value.cpu().numpy()
    if rows is None:
        rows = int(arr.shape[0]) if arr.ndim else 1
    if rows:
        MESH_SCOPE.add("meshGatherRows", rows)
    return arr


def u32_words(a: torch.Tensor) -> torch.Tensor:
    """``a``'s elements as their uint32 words (in int64), one row a row
    slot: bool and narrow integers widen, 64-bit values give two words."""
    rows = a.shape[0]
    if a.dtype in (torch.bool, torch.int8, torch.int16, torch.uint8):
        return a.to(torch.int64).reshape(rows, -1)
    if a.dtype == torch.float32:
        a = a.view(torch.int32)
    elif a.dtype == torch.float64:
        a = a.view(torch.int64)
    a = a.contiguous()
    if a.dtype == torch.int64:
        a = a.view(torch.int32)
    return (a.to(torch.int64) & 0xFFFFFFFF).reshape(rows, -1)


def wordsum_u32(a: torch.Tensor) -> torch.Tensor:
    """Order-independent uint32 word sum of one tensor (as int64 0-d on its
    device): every element's 32-bit words, wrapped. Integer addition is
    associative, so the sum over shards equals the sum over the gathered
    table bit for bit. The host recomputes it with numpy views."""
    return u32_words(a).sum() & 0xFFFFFFFF


class ShardedTable:
    """One logical table as row shards over a mesh: ``shards[i]`` is a
    DeviceTable on logical device ``ids[i]`` (its torch device) holding the
    i-th contiguous block of the rows; the concatenation of the shards'
    live rows in shard order is the table. Filters and projections map
    over the shards (``map``); everything else re-lands it
    (execs/mesh.py)."""

    __slots__ = ("shards", "ids", "generation", "__weakref__")

    def __init__(self, shards, ids: Sequence[int],
                 generation: Optional[int] = None):
        self.shards = list(shards)
        self.ids = tuple(ids)
        self.generation = generation

    def map(self, fn) -> "ShardedTable":
        return ShardedTable([fn(s) for s in self.shards], self.ids,
                            self.generation)

    @property
    def names(self):
        return self.shards[0].names

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def capacity(self) -> int:
        return sum(s.capacity for s in self.shards)

    @property
    def _nrows_host(self) -> Optional[int]:
        ns = [s._nrows_host for s in self.shards]
        return None if any(n is None for n in ns) else sum(ns)

    @property
    def nrows_dev(self) -> torch.Tensor:
        dev = self.device
        return torch.stack([s.nrows_dev.to(dev) for s in self.shards]).sum()

    @property
    def num_rows(self) -> int:
        return sum(s.num_rows for s in self.shards)

    def compacted(self) -> "ShardedTable":
        return self.map(lambda s: s.compacted())


def scan_mesh(exec_node) -> Tuple[Optional[Mesh], Optional[int]]:
    """(mesh, generation) a scan exec lands its batches over, or (None,
    None). Sharded placement is bound at conversion: the re-land pass
    (execs/mesh.py insert_mesh_relands) stamps every scan of a mesh-aware
    tree with the generation it planned against, and a scan lands sharded
    only under that generation, so a tree converted with the mesh off
    never meets a ShardedTable."""
    gen = getattr(exec_node, "_mesh_scan_gen", None)
    if gen is None:
        return None, None
    mesh, token = MESH.scan_placement()
    if mesh is None or token != gen:
        return None, None
    return mesh, token


def land_shards(exec_node, host, mesh: Mesh, generation: int,
                bucket_policy, cached: bool) -> ShardedTable:
    """``host`` landed as contiguous row blocks, one a mesh member (on its
    device, at its rows' bucket). A string column is encoded once for the
    whole batch first, so every shard shares one sorted dictionary. With
    ``cached`` each shard's columns are kept on the host column (the
    scan's device cache, keyed by generation and shard). THE scan's
    ``mesh.shard.put`` site; counts ``shardsDispatched``."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import DeviceColumn, DeviceTable
    from spark_rapids_tpu_torch.columnar.table import register_device_cache
    from spark_rapids_tpu_torch.runtime.faults import fault_point
    n = host.num_rows
    ndev = mesh.size
    per = -(-max(n, 1) // ndev)
    if not (cached and all(
            ("device", str(dev), "mesh", generation, i, per,
             bucket_policy.bucket_for(max(min(per, n - min(i * per, n)), 1)))
            in hc._cache
            for hc in host.columns for i, dev in enumerate(mesh.devices))):
        # a landing that uploads (a cache hit lands nothing)
        fault_point("mesh.shard.put")
    for hc in host.columns:
        if isinstance(hc.dtype, T.StringType):
            hc.encoded()
    shards = []
    for i, dev in enumerate(mesh.devices):
        lo = min(i * per, n)
        rows = min(per, n - lo)
        cap = bucket_policy.bucket_for(max(rows, 1))
        key = ("device", str(dev), "mesh", generation, i, per, cap)
        cols = []
        for hc in host.columns:
            dc = hc._cache.get(key) if cached else None
            if dc is None:
                dc = DeviceColumn.from_host(hc.slice(lo, rows), cap, dev)
                if cached:
                    hc._cache[key] = dc
                    register_device_cache(hc)
            cols.append(dc)
        shards.append(DeviceTable(host.names, cols, rows, cap, dev))
    MESH_SCOPE.add("shardsDispatched", ndev)
    exec_node.add_metric("shardsDispatched", ndev)
    return ShardedTable(shards, mesh.ids, generation)
