"""Device partitioners and the host shuffle's map-side split (port of
``Partitioner``, ``HashPartitioner``, ``RoundRobinPartitioner``,
``SinglePartitioner``, ``RangePartitioner`` and ``split_by_partition`` of
``spark_rapids_tpu/shuffle/partitioning.py``): each partitioner gives
every row of a batch its partition id on the device.

``RangePartitioner`` takes its bounds from a host sample of the key
columns, drawn with the reference's generator (``default_rng(42)``,
``samples_per_partition`` rows per partition) over every live row of
its input in order, so the bounds are the reference's; only the sampled
rows leave the device (the sample's read-back is a host sync by design).
Rows map to partitions on the device by lexicographic comparison with
the bounds; a string key compares by its sorted dictionary's codes."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import DeviceTable
from spark_rapids_tpu_torch.ops.expr import Expression, compile_project
from spark_rapids_tpu_torch.shuffle.hashing import (
    SPARK_SEED,
    device_string_bytes,
    murmur3_hash_device,
)


class Partitioner:
    num_partitions: int

    def partition_ids(self, table: DeviceTable) -> torch.Tensor:
        """int32 partition ids of rows [0, capacity) (padding rows get an
        id too; the split drops them)."""
        raise NotImplementedError


class HashPartitioner(Partitioner):
    """Spark's: pmod(murmur3(keys, seed 42), n)."""

    def __init__(self, keys: Sequence[Expression], num_partitions: int):
        self.keys = list(keys)
        self.num_partitions = num_partitions

    def partition_ids(self, table: DeviceTable) -> torch.Tensor:
        key_cols = compile_project(self.keys, table)
        cols = [(c.data, c.validity, c.dtype) for c in key_cols]
        string_bytes = {
            i: device_string_bytes(c.dictionary, table.device)
            for i, c in enumerate(key_cols)
            if isinstance(c.dtype, T.StringType)}
        h = murmur3_hash_device(cols, SPARK_SEED, string_bytes)
        # Spark's pmod: a non-negative remainder
        return torch.remainder(h, self.num_partitions)


class RoundRobinPartitioner(Partitioner):
    def __init__(self, num_partitions: int, start: int = 0):
        self.num_partitions = num_partitions
        self.start = start

    def partition_ids(self, table: DeviceTable) -> torch.Tensor:
        idx = torch.arange(table.capacity, dtype=torch.int32,
                           device=table.device)
        return (idx + self.start) % self.num_partitions


class SinglePartitioner(Partitioner):
    num_partitions = 1

    def partition_ids(self, table: DeviceTable) -> torch.Tensor:
        return torch.zeros(table.capacity, dtype=torch.int32,
                           device=table.device)


class RangePartitioner(Partitioner):
    """Sampled-bounds range partitioning over ``keys`` (bound to the
    input's schema), ascending unless ``ascending`` says otherwise; nulls
    sort first ascending and last descending, as the sort's default."""

    def __init__(self, keys: Sequence[Expression], num_partitions: int,
                 ascending: Optional[Sequence[bool]] = None,
                 samples_per_partition: int = 100):
        self.keys = list(keys)
        self.num_partitions = num_partitions
        self.ascending = (list(ascending) if ascending
                          else [True] * len(self.keys))
        self.samples_per_partition = samples_per_partition
        #: num_partitions - 1 bound rows, one HostColumn per key
        self._bounds: Optional[List] = None

    def compute_bounds(self, table: DeviceTable) -> None:
        """Bounds from a sample of ``table``'s live rows (the whole input:
        the exchange concatenates its batches first, which is the
        reference's ``compute_bounds_multi`` over them)."""
        from spark_rapids_tpu_torch.plan.nodes import (
            SortOrder,
            _stable_sort_indices,
        )
        keys = compile_project(self.keys, table)
        n = table.num_rows  # host sync: the sample's size
        if n == 0 or self.num_partitions <= 1:
            self._bounds = []
            return
        rng = np.random.default_rng(42)
        k = min(n, self.samples_per_partition * self.num_partitions)
        idx = np.sort(rng.choice(n, size=k, replace=False))
        packed = DeviceTable([f"k{i}" for i in range(len(keys))], keys,
                             table.nrows_dev, table.capacity, table.device,
                             live=table.live).compacted()
        rows = torch.from_numpy(idx).to(table.device)
        # the sample's read-back: a host sync by design
        sampled = [c.with_arrays(c.data[rows], c.validity[rows]).to_host(k)
                   for c in packed.columns]
        orders = [SortOrder(e, asc)
                  for e, asc in zip(self.keys, self.ascending)]
        perm = _stable_sort_indices(sampled, orders, k)
        pos = [min(int(k * (i + 1) / self.num_partitions), k - 1)
               for i in range(self.num_partitions - 1)]
        sel = perm[pos]
        self._bounds = [c.take(sel) for c in sampled]

    def partition_ids(self, table: DeviceTable) -> torch.Tensor:
        if self._bounds is None:
            self.compute_bounds(table)
        if not self._bounds:
            return torch.zeros(table.capacity, dtype=torch.int32,
                               device=table.device)
        keys = compile_project(self.keys, table)
        # after[r, j]: row r sorts strictly after bound j, built from the
        # last key to the first (lexicographic)
        after = None
        for c, bcol, asc in zip(reversed(keys), reversed(self._bounds),
                                reversed(self.ascending)):
            d, v = _comparable(c)
            bd, bv, exact = _comparable_bounds(bcol, c, table.device)
            dd, vv = d[:, None], v[:, None]
            # a string bound absent from the column's dictionary takes the
            # next entry's code: rows with that code sort after it
            cmp_gt = torch.where(exact, dd > bd, dd >= bd)
            gt = torch.where(vv & bv, cmp_gt, vv & ~bv)
            lt = torch.where(vv & bv, dd < bd, ~vv & bv)
            if not asc:
                gt, lt = lt, gt
            after = gt if after is None else gt | (~gt & ~lt & after)
        return after.sum(dim=1, dtype=torch.int32)


def _comparable(c):
    """A key column's data in a space whose order is the sort's: -0.0 as
    0.0, booleans as integers, strings as sorted-dictionary codes."""
    d = c.data
    if d.dim() != 1:
        raise NotImplementedError(
            f"range partitioning over a {c.dtype.simple_string()} key is "
            "not supported")
    if isinstance(c.dtype, T.StringType) and not c.dict_sorted:
        raise NotImplementedError("range partitioning over a string key "
                                  "with an unsorted dictionary is not "
                                  "supported")
    if d.is_floating_point():
        d = torch.where(d == 0.0, torch.zeros_like(d), d)
    elif d.dtype == torch.bool:
        d = d.to(torch.int32)
    return d, c.validity


def _comparable_bounds(bcol, dev_col, device):
    """The bounds as (1, nb) device rows (values, validity, exact); string
    bounds map into the column's dictionary code space, a value absent
    from it to the code of the next larger entry with exact False (a
    value past every entry keeps the code one past the last, so no row
    sorts after it)."""
    nb = len(bcol.data)
    if isinstance(bcol.dtype, T.StringType):
        dictionary = dev_col.dictionary
        if dictionary is None or len(dictionary) == 0:
            codes = np.zeros(nb, dtype=np.int32)
            exact = np.zeros(nb, dtype=np.bool_)
        else:
            vals = np.where(bcol.validity, bcol.data, "").astype(object)
            codes = np.searchsorted(dictionary, vals,
                                    side="left").astype(np.int32)
            safe = np.minimum(codes, len(dictionary) - 1)
            exact = (codes < len(dictionary)) & (dictionary[safe] == vals)
        vals_t = torch.from_numpy(codes).to(dev_col.data.dtype)
    else:
        vals = np.asarray(bcol.data)
        if vals.dtype.kind == "f":
            vals = np.where(vals == 0.0, 0.0, vals).astype(vals.dtype)
        if vals.dtype == np.bool_:
            vals = vals.astype(np.int32)
        vals_t = torch.from_numpy(np.ascontiguousarray(vals))
        exact = np.ones(nb, dtype=np.bool_)
        if dev_col.data.dtype != torch.bool:
            vals_t = vals_t.to(dev_col.data.dtype)
    return (vals_t.to(device)[None, :],
            torch.from_numpy(np.asarray(bcol.validity, dtype=np.bool_))
            .to(device)[None, :],
            torch.from_numpy(exact).to(device)[None, :])


def _download_packed(tensors) -> List[np.ndarray]:
    """Every tensor of ``tensors`` (on one device) on the host in ONE copy:
    their bytes concatenated on the device, read back, cut and viewed
    with their dtypes and shapes again."""
    if not tensors:
        return []
    flat = [t.contiguous().view(-1).view(torch.uint8) if t.dtype != torch.bool
            else t.contiguous().view(-1).to(torch.uint8) for t in tensors]
    host = torch.cat(flat).cpu().numpy()
    out, pos = [], 0
    for t, f in zip(tensors, flat):
        n = f.shape[0]
        raw = host[pos:pos + n]
        pos += n
        if t.dtype == torch.bool:
            arr = raw.astype(np.bool_)
        else:
            arr = raw.view(T.numpy_dtype(t.dtype))
        out.append(arr.reshape(tuple(t.shape)))
    return out


def split_by_partition(table: DeviceTable, partitioner: Partitioner,
                       metrics=None) -> list:
    """The map side of the host shuffle for one batch (port of the
    reference's ``split_by_partition``): the partition ids, one stable
    sort of them carrying the row slots (the hand-written
    ``sort_with_payload``; dead rows sort last), each partition's run from
    the sorted ids, a read of the per-partition counts, then the live
    rows gathered in partition order and downloaded in ONE copy (a host
    sync by design, counted as ``shuffleMapDownloads`` on ``metrics``),
    cut into one HostTable per partition on the host."""
    from spark_rapids_tpu_torch.columnar import HostTable
    from spark_rapids_tpu_torch.columnar.column import bucket_for
    from spark_rapids_tpu_torch.dispatch import note_host_fetch
    from spark_rapids_tpu_torch.kernels.sort import sort_with_payload
    nparts = partitioner.num_partitions
    cap = table.capacity
    pids = partitioner.partition_ids(table).to(torch.int32)
    live = table.row_mask()
    spid = torch.where(live, pids, torch.full_like(pids, nparts))
    iota = torch.arange(cap, dtype=torch.int32, device=table.device)
    sorted_pid, rows = sort_with_payload([spid], iota)
    targets = torch.arange(nparts + 1, dtype=torch.int32,
                           device=table.device)
    starts = torch.searchsorted(sorted_pid, targets)
    note_host_fetch()
    starts = starts.cpu().numpy()
    n = int(starts[-1])
    k = min(bucket_for(max(n, 1)), cap)
    idx = rows[:k].long()
    leaves = []
    for c in table.columns:
        leaves.append(c.data[idx])
        leaves.append(c.validity[idx])
    note_host_fetch()
    host = _download_packed(leaves)
    if metrics is not None:
        metrics.add_metric("shuffleMapDownloads", 1)
        metrics.add_metric("shuffleDownloadBytes",
                           sum(int(a.nbytes) for a in host))
    cols = [c.decode_host(host[2 * i][:n], host[2 * i + 1][:n])
            for i, c in enumerate(table.columns)]
    whole = HostTable(table.names, cols)
    return [whole.slice(int(starts[p]), int(starts[p + 1] - starts[p]))
            for p in range(nparts)]
