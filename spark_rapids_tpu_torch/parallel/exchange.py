"""The mesh's all-to-all hash exchange (port of
``spark_rapids_tpu/parallel/exchange.py``: ``MeshExchange``,
``_bucketize`` with the compaction of its ``shard_fn``,
``_verified_counts`` and the per-mesh string-dictionary intern).

Every source shard sends each of its live rows to the mesh member its
Spark murmur3 partition id names (pmod(hash, ndev)); each target holds its
rows by source shard, then by row within the source, which is the
reference's order. Per source shard the bucketing is one stable sort of
the partition ids carrying an int32 row iota (``kernels/sort.py::
sort_with_payload``, the hand-written sort), one gather of the columns by
the sorted rows, and the per-target row ranges of the sorted ids; the
counts of every (source, target) pair come to the host in ONE
checksummed read through ``mesh_gather`` (their word sum rides along and
a mismatch reads them again, ``spark.rapids.mesh.maxShardRetries``). The
targets then take their segments, source by source, onto their devices
and into one prefix batch each.

String keys hash by their dictionary's bytes, put on the mesh once per
(dictionary, mesh) (``interned_dict_bytes``: ``meshDictInterns``, two
counted uploads). A DECIMAL128 column travels as its two-limb rows."""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import DeviceColumn, DeviceTable
from spark_rapids_tpu_torch.columnar.column import bucket_for
from spark_rapids_tpu_torch.lockorder import ordered_lock
from spark_rapids_tpu_torch.parallel.mesh import (
    MESH_SCOPE,
    Mesh,
    count_mesh_upload,
    mesh_gather,
    shard_put,
)
from spark_rapids_tpu_torch.shuffle.hashing import (
    SPARK_SEED,
    murmur3_hash_device,
    string_dict_bytes,
)

#: dictionary byte matrices on the mesh, interned by DICTIONARY IDENTITY
#: and mesh members (the entry pins its dictionary, which makes the id key
#: sound); the cap bounds the pinned host memory
_DICT_INTERN: "OrderedDict[int, tuple]" = OrderedDict()
_DICT_INTERN_LOCK = ordered_lock("mesh.dict_intern")
_DICT_INTERN_CAP = 256
#: (id(dict), members) -> Event while one thread uploads that entry
_DICT_INFLIGHT: dict = {}
#: bumped by clear_mesh_caches: a builder that started before the clear
#: serves its entry to its own caller only
_MESH_CACHE_EPOCH = 0


def clear_mesh_caches() -> int:
    """Drop every interned dictionary (device state): the device-loss
    recovery and the OOM eviction call it. Returns the entries dropped."""
    global _MESH_CACHE_EPOCH
    with _DICT_INTERN_LOCK:
        n = len(_DICT_INTERN)
        _DICT_INTERN.clear()
        _MESH_CACHE_EPOCH += 1
    return n


def interned_dict_bytes(dictionary: np.ndarray, mesh: Mesh
                        ) -> Dict[str, tuple]:
    """{device: (byte matrix, lengths)} of ``dictionary`` on every physical
    device of ``mesh``, interned by dictionary identity. Concurrent first
    users of one dictionary wait for the one that uploads it."""
    members = tuple(str(d) for d in mesh.devices)
    key = id(dictionary)
    flight_key = (key, members)
    while True:
        with _DICT_INTERN_LOCK:
            entry = _DICT_INTERN.get(key)
            if entry is not None and entry[0] is dictionary:
                _DICT_INTERN.move_to_end(key)
                hit = entry[1].get(members)
                if hit is not None:
                    return hit
            ev = _DICT_INFLIGHT.get(flight_key)
            if ev is None:
                ev = threading.Event()
                _DICT_INFLIGHT[flight_key] = ev
                break  # this thread uploads
        ev.wait()
    try:
        with _DICT_INTERN_LOCK:
            epoch = _MESH_CACHE_EPOCH
        from spark_rapids_tpu_torch.runtime.faults import fault_point
        fault_point("mesh.dict.upload")
        mat, lens = string_dict_bytes(dictionary)
        out = {}
        for d in dict.fromkeys(mesh.devices):
            out[str(d)] = (torch.from_numpy(mat).to(d),
                           torch.from_numpy(lens).to(d))
        count_mesh_upload(2)
        MESH_SCOPE.add("meshDictInterns", 1)
        with _DICT_INTERN_LOCK:
            if epoch != _MESH_CACHE_EPOCH:
                return out
            entry = _DICT_INTERN.get(key)
            if entry is None or entry[0] is not dictionary:
                entry = (dictionary, {})
                _DICT_INTERN[key] = entry
                while len(_DICT_INTERN) > _DICT_INTERN_CAP:
                    _DICT_INTERN.popitem(last=False)
            entry[1][members] = out
        return out
    finally:
        with _DICT_INTERN_LOCK:
            _DICT_INFLIGHT.pop(flight_key, None)
        ev.set()


def partition_ids(key_cols: Sequence[DeviceColumn], ndev: int,
                  string_bytes: Dict[int, tuple]) -> torch.Tensor:
    """int32 pmod(murmur3(keys, 42), ndev) of every row slot."""
    cols = [(c.data, c.validity, c.dtype) for c in key_cols]
    h = murmur3_hash_device(cols, SPARK_SEED, string_bytes)
    return torch.remainder(h, ndev).to(torch.int32)


def bucketize(pid: torch.Tensor, live: torch.Tensor, ndev: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, bounds) of one source shard: ``rows`` its row slots stably
    sorted by target (dead rows last, as target ``ndev``), ``bounds`` the
    int32 start of every target's run in it, ``ndev + 1`` entries (the
    last is the live count). One launch of the hand-written sort."""
    from spark_rapids_tpu_torch.kernels.sort import sort_with_payload
    cap = pid.shape[0]
    spid = torch.where(live, pid, torch.full_like(pid, ndev))
    iota = torch.arange(cap, dtype=torch.int32, device=pid.device)
    sorted_pid, rows = sort_with_payload([spid], iota)
    targets = torch.arange(ndev + 1, dtype=torch.int32, device=pid.device)
    bounds = torch.searchsorted(sorted_pid, targets).to(torch.int32)
    return rows, bounds


def verified_counts(bounds: torch.Tensor) -> np.ndarray:
    """The ONE host read of an exchange: every source's run starts (an
    (nsrc, ndev + 1) int32 tensor) with their word sum appended, checked
    on the host; a mismatch (the ``mesh.ici.exchange`` corrupt kind
    damages the read bytes) reads the intact device value again, up to
    ``MAX_SHARD_RETRIES`` times, then raises MeshGatherError."""
    from spark_rapids_tpu_torch.errors import MeshGatherError
    from spark_rapids_tpu_torch.parallel import mesh as PM
    from spark_rapids_tpu_torch.parallel.mesh import wordsum_u32
    from spark_rapids_tpu_torch.runtime.faults import fault_point
    flat = bounds.reshape(-1).to(torch.int32)
    if not PM.GATHER_VERIFY:
        return mesh_gather(flat).reshape(bounds.shape)
    digest = wordsum_u32(flat).to(torch.int64)
    # the digest's low 32 bits as an int32 word
    digest = torch.where(digest >= 2 ** 31, digest - 2 ** 32, digest)
    packed = torch.cat([flat, digest.to(torch.int32).reshape(1)])
    retries = 0
    while True:
        arr = mesh_gather(packed, rows=int(packed.shape[0]) - 1)
        raw = fault_point("mesh.ici.exchange",
                          data=arr.astype(np.int32).tobytes())
        arr = np.frombuffer(raw, dtype=np.int32)
        got = arr[-1:].view(np.uint32)[0]
        want = np.uint32(arr[:-1].view(np.uint32).sum(dtype=np.uint64)
                         & 0xFFFFFFFF)
        if got == want:
            return arr[:-1].reshape(bounds.shape)
        MESH_SCOPE.add("gatherChecksFailed", 1)
        if retries >= PM.MAX_SHARD_RETRIES:
            raise MeshGatherError(
                f"mesh exchange count read failed its checksum "
                f"{retries + 1} times (device digest {int(got)} vs "
                f"recomputed {int(want)})")
        retries += 1
        MESH_SCOPE.add("shardRetries", 1)


def _take_rows(c: DeviceColumn, rows: torch.Tensor) -> DeviceColumn:
    return c.with_arrays(c.data[rows], c.validity[rows])


class MeshExchange:
    """An ``ndev``-way all-to-all over ``mesh``: ``run`` takes the source
    shards (DeviceTables, one per member, masked or prefix) and the key
    expressions, and returns one prefix DeviceTable per target on its
    member's device, with the per-(source, target) counts."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.ndev = mesh.size

    def run(self, sources: Sequence[DeviceTable], keys
            ) -> Tuple[List[DeviceTable], np.ndarray]:
        from spark_rapids_tpu_torch.ops.expr import compile_project
        from spark_rapids_tpu_torch.runtime.faults import fault_point
        ndev = self.ndev
        if len(sources) != ndev:
            raise ValueError(f"{len(sources)} source shards for a "
                             f"{ndev}-way exchange")
        # the exchange's fault site (crash, device_lost, slow); corrupt is
        # taken by the checked count read below
        fault_point("mesh.ici.exchange")
        from spark_rapids_tpu_torch.runtime.cluster import dcn_exchange_point
        dcn_exchange_point(self.mesh)
        buckets = []
        bounds = []
        for src in sources:
            key_cols = compile_project(keys, src)
            sbytes = {}
            for i, c in enumerate(key_cols):
                if isinstance(c.dtype, T.StringType):
                    sbytes[i] = interned_dict_bytes(
                        c.dictionary, self.mesh)[str(src.device)]
            pid = partition_ids(key_cols, ndev, sbytes)
            rows, b = bucketize(pid, src.row_mask(), ndev)
            buckets.append([_take_rows(c, rows.long())
                            for c in src.columns])
            bounds.append(b.to(sources[0].device))
        counts_at = verified_counts(torch.stack(bounds))
        names = sources[0].names
        outs = []
        for p in range(ndev):
            dev = self.mesh.devices[p]
            n = int(sum(counts_at[s, p + 1] - counts_at[s, p]
                        for s in range(ndev)))
            cap = bucket_for(max(n, 1))
            cols = []
            for ci, proto in enumerate(sources[0].columns):
                parts_d, parts_v = [], []
                for s in range(ndev):
                    lo, hi = int(counts_at[s, p]), int(counts_at[s, p + 1])
                    if hi > lo:
                        col = buckets[s][ci]
                        parts_d.append(shard_put(col.data[lo:hi], dev))
                        parts_v.append(shard_put(col.validity[lo:hi], dev))
                cols.append(_land_column(proto, parts_d, parts_v, n, cap,
                                         dev))
            outs.append(DeviceTable(names, cols, n, cap, dev))
        return outs, counts_at


def _land_column(proto: DeviceColumn, datas, valids, n: int, cap: int,
                 dev) -> DeviceColumn:
    """One target's column: its segments in source order, padded to
    ``cap`` (zero data, False validity)."""
    tail = tuple(proto.data.shape[1:])
    data = torch.zeros((cap,) + tail, dtype=proto.data.dtype, device=dev)
    valid = torch.zeros(cap, dtype=torch.bool, device=dev)
    if n:
        data[:n] = torch.cat(datas)
        valid[:n] = torch.cat(valids)
    return DeviceColumn(proto.dtype, data, valid, proto.dictionary,
                        proto.dict_sorted, proto.domain)
