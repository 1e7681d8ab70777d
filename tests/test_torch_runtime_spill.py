"""The port's spill framework (spark_rapids_tpu_torch/runtime/spill.py) on
the CPU: a SpillableBatch goes device -> host -> disk -> device
bit-identical for every type the port stores (ints, doubles with NaN,
-0.0 and subnormals, sorted-dictionary strings, DATE, TIMESTAMP,
DECIMAL64 and DECIMAL128 limbs), for a masked batch with its ``live``
mask and a row count on the device, with its capacity, dictionaries,
domains and split token; a flipped byte in a disk frame raises
SpillCorruptionError; the host tier's limit pushes spills to disk; the
host arbiter's limit bounds the host copies, and a copy that cannot get
its grant replays through the retry loop; and
the catalog's spill order and the batches a byte target spills equal the
JAX package's (spark_rapids_tpu/runtime/spill.py) on the same priorities.

Comparators: tensors bit for bit (``torch.equal`` over their bytes);
host tables with ``scale_test.tables_differ`` (bitwise, in order); spill
orders as lists of batch indices."""

import os

import numpy as np
import pytest
import torch

from scale_test import tables_differ
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import DeviceTable as JDeviceTable
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.runtime import spill as jspill
from spark_rapids_tpu_torch.columnar import DeviceTable
from spark_rapids_tpu_torch.columnar.table import upload_host_table
from spark_rapids_tpu_torch.errors import SpillCorruptionError
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.runtime import memory as tmem
from spark_rapids_tpu_torch.runtime import spill as tspill

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_catalogs(tmp_path):
    jspill.BufferCatalog.reset()
    tspill.BufferCatalog.reset(disk_dir=str(tmp_path))
    yield
    tspill.BufferCatalog.get().shutdown()
    jspill.BufferCatalog.reset()
    tspill.BufferCatalog.reset()
    tmem.MEMORY.reset()


def _edge_doubles(n, rng):
    v = rng.standard_normal(n)
    v[:6] = [np.nan, -0.0, 0.0, 5e-324, -2.2e-308, np.inf]
    v[6] = np.frombuffer(np.uint64(0xFFF8000000000001).tobytes(),
                         dtype=np.float64)[0]  # a NaN with payload bits
    return v


def _every_type(n: int = 700, seed: int = 11):
    rng = np.random.default_rng(seed)
    names = ["i", "l", "d", "s", "dt", "ts", "d64", "d128", "b", "f"]
    types = ["int", "bigint", "double", "string", "date", "timestamp",
             "decimal(12,2)", "decimal(30,4)", "boolean", "float"]
    valid = rng.random(n) > 0.15
    big = [int(x) * (10 ** 20) + int(y) for x, y in
           zip(rng.integers(-10**9, 10**9, n), rng.integers(0, 10**12, n))]
    arrays = [
        (rng.integers(-2**31, 2**31 - 1, n).astype(np.int32), valid),
        (rng.integers(-2**62, 2**62, n), np.ones(n, bool)),
        (_edge_doubles(n, rng), np.ones(n, bool)),
        (np.array([f"k{v:03d}" for v in rng.integers(0, 80, n)],
                  dtype=object), valid),
        (rng.integers(-5000, 30000, n).astype(np.int32), np.ones(n, bool)),
        (rng.integers(-10**15, 10**15, n), valid),
        (rng.integers(-10**15, 10**15, n), np.ones(n, bool)),
        (np.array(big, dtype=object), valid),
        (rng.random(n) > 0.5, np.ones(n, bool)),
        (rng.standard_normal(n).astype(np.float32), valid),
    ]
    return host_table_from_arrays(names, types, arrays)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _assert_same_table(a: DeviceTable, b: DeviceTable):
    assert a.names == b.names and a.capacity == b.capacity
    assert a.split_group is b.split_group
    assert (a.live is None) == (b.live is None)
    if a.live is not None:
        assert torch.equal(a.live, b.live)
    assert a._nrows_host == b._nrows_host
    assert torch.equal(a.nrows_dev, b.nrows_dev)
    assert a.nrows_dev.dtype == b.nrows_dev.dtype
    for x, y in zip(a.columns, b.columns):
        assert x.dtype == y.dtype and x.data.dtype == y.data.dtype
        assert x.data.shape == y.data.shape
        assert torch.equal(_bits(x.data), _bits(y.data))
        assert torch.equal(x.validity, y.validity)
        assert x.domain == y.domain and x.dict_sorted == y.dict_sorted
        if x.dictionary is None:
            assert y.dictionary is None
        else:
            assert list(x.dictionary) == list(y.dictionary)


def _masked_device_count(t: DeviceTable) -> DeviceTable:
    """``t`` masked to every third row, its count a device scalar, with a
    split token."""
    live = (torch.arange(t.capacity) % 3 == 0) & t.row_mask()
    out = DeviceTable(t.names, t.columns, live.sum(dtype=torch.int32),
                      t.capacity, t.device, live=live)
    out.split_group = object()
    return out


@pytest.mark.parametrize("form", ["prefix", "masked"])
def test_round_trip_through_every_tier(form):
    t = upload_host_table(_every_type(), CPU)
    if form == "masked":
        t = _masked_device_count(t)
    keep = DeviceTable(t.names, [c.with_arrays(c.data.clone(),
                                               c.validity.clone())
                                 for c in t.columns], t.nrows_dev.clone(),
                       t.capacity, CPU,
                       live=None if t.live is None else t.live.clone())
    keep._nrows_host = t._nrows_host
    keep.split_group = t.split_group
    catalog = tspill.BufferCatalog.get()
    sb = tspill.SpillableBatch(t, catalog)
    want_host = t.to_host()
    del t
    assert sb.spill_to_host() == keep.device_nbytes()
    assert sb.tier == "HOST"
    # the host tier decodes without the device
    assert tables_differ(_as_ref(sb.get_host()), _as_ref(want_host)) is None
    assert sb.spill_to_disk() > 0
    assert sb.tier == "DISK" and len(os.listdir(catalog.disk_dir)) == 1
    u0 = tmem.MEM_SCOPE.get("unspills", 0)
    back = sb.get()
    assert sb.tier == "DEVICE"
    assert tmem.MEM_SCOPE.get("unspills", 0) == u0 + 1
    assert os.listdir(catalog.disk_dir) == []
    _assert_same_table(back, keep)
    sb.release()


def _as_ref(t) -> JHostTable:
    names, types, arrays = t.to_arrays()
    return JHostTable(names, [JHostColumn(JT.parse_type(ty), np.asarray(d),
                                          np.asarray(v, dtype=bool))
                              for ty, (d, v) in zip(types, arrays)])


def test_flipped_byte_raises_spill_corruption():
    catalog = tspill.BufferCatalog.get()
    sb = tspill.SpillableBatch(upload_host_table(_every_type(200), CPU),
                               catalog)
    sb.spill_to_host()
    sb.spill_to_disk()
    path = sb._disk_path
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x10
    open(path, "wb").write(bytes(raw))
    c0 = tmem.MEM_SCOPE.get("spillCorruptions", 0)
    with pytest.raises(SpillCorruptionError, match="CRC"):
        sb.get()
    assert tmem.MEM_SCOPE.get("spillCorruptions", 0) == c0 + 1
    assert not os.path.exists(path)  # dropped, never served
    sb.release()


def test_host_limit_pushes_spills_to_disk():
    """A host tier of 10 KB holds none of three 36 KB batches: a full
    device spill ends with every batch on disk, and each comes back
    bit-identical."""
    catalog = tspill.BufferCatalog.get()
    catalog.host_limit_bytes = 10_000
    tables = [_long_table(4096, seed=i) for i in range(3)]
    sbs = [tspill.SpillableBatch(t, catalog) for t in tables]
    keep = [t.columns[0].data.clone() for t in tables]
    del tables
    assert catalog.spill_all_device() == 3 * 36864
    assert [sb.tier for sb in sbs] == ["DISK"] * 3
    assert catalog.disk_spilled_bytes > 0
    for sb, k in zip(sbs, keep):
        assert torch.equal(sb.get().columns[0].data, k)
        sb.release()


@pytest.fixture
def _host_arbiter(monkeypatch):
    """The port's host arbiter at a 50 KB limit, the spills' grants with a
    50 ms wait; the default (4 GiB) again afterwards."""
    from spark_rapids_tpu_torch.runtime.host_alloc import HostMemoryArbiter
    arb = HostMemoryArbiter.reset(50_000)
    monkeypatch.setattr(tspill, "_host_alloc",
                        lambda n: arb.alloc(n, timeout_s=0.05))
    yield arb
    HostMemoryArbiter.reset(4 << 30)


def test_host_memory_limit_bounds_the_spill_copies(_host_arbiter):
    """``spark.rapids.memory.host.limit`` bounds the host copies of
    spilled batches: under a 50 KB limit (and a host tier far larger),
    each 36 KB spill to the host first moves the host tier's batch to
    disk, so at most one copy is on the host; every batch comes back
    bit-identical and its grant returns."""
    arb = _host_arbiter
    catalog = tspill.BufferCatalog.get()
    catalog.host_limit_bytes = 1 << 30
    tables = [_long_table(4096, seed=i) for i in range(3)]
    sbs = [tspill.SpillableBatch(t, catalog) for t in tables]
    keep = [t.columns[0].data.clone() for t in tables]
    del tables
    assert catalog.spill_all_device() == 3 * 36864
    assert [sb.tier for sb in sbs] == ["DISK", "DISK", "HOST"]
    assert arb.used_bytes == 36864 <= arb.limit_bytes
    assert arb.spill_triggered_count == 2
    for sb, k in zip(sbs, keep):
        assert torch.equal(sb.get().columns[0].data, k)
        sb.release()
    assert arb.used_bytes == 0


def test_host_oom_replays_through_the_retry_loop(_host_arbiter):
    """A host copy that cannot get its grant (the host tier's one batch is
    pinned, so the arbiter cannot move it to disk) raises CpuRetryOOM
    after the arbiter's wait; ``retry_block`` counts a retry, moves the
    host tier to disk (now unpinned) and replays, and the spill then fits
    without another arbiter pass."""
    from spark_rapids_tpu_torch.errors import CpuRetryOOM
    from spark_rapids_tpu_torch.runtime.retry import retry_block
    arb = _host_arbiter
    catalog = tspill.BufferCatalog.get()
    catalog.host_limit_bytes = 1 << 30
    a = tspill.SpillableBatch(_long_table(4096, seed=1), catalog)
    b = tspill.SpillableBatch(_long_table(4096, seed=2), catalog)
    assert a.spill_to_host() == 36864
    a.pin()
    errors = []

    def spill_b():
        try:
            return b.spill_to_host()
        except CpuRetryOOM as e:
            errors.append(e)
            raise
        finally:
            if a.pinned:
                a.unpin()  # the first attempt ends: a is idle again

    r0 = tmem.MEM_SCOPE.get("oomRetries", 0)
    assert retry_block(spill_b) == 36864
    assert len(errors) == 1 and "host memory exhausted" in str(errors[0])
    assert tmem.MEM_SCOPE.get("oomRetries", 0) == r0 + 1
    assert arb.spill_triggered_count == 1
    assert (a.tier, b.tier) == ("DISK", "HOST")
    assert arb.used_bytes == 36864
    a.release()
    b.release()
    assert arb.used_bytes == 0


def _long_table(rows, seed=0) -> DeviceTable:
    host = host_table_from_arrays(
        ["a"], ["bigint"], [(np.arange(rows) * (seed + 1),
                             np.ones(rows, bool))])
    return upload_host_table(host, CPU)


def _ref_long_table(rows, seed=0):
    host = JHostTable(["a"], [JHostColumn(JT.LONG, np.arange(rows)
                                          * (seed + 1))])
    return JDeviceTable.from_host(host, capacity=rows)


#: (priority, rows) of the batches, in creation order
PRIORITIES = [(0, 4096), (100, 2048), (10, 4096), (0, 1024), (100, 4096),
              (10, 2048), (0, 2048)]


@pytest.mark.parametrize("target", [1, 40_000, 100_000, 1 << 62])
def test_spill_order_matches_reference(target):
    """Lowest priority first, then least recently used: the same order
    and, for a byte target, the same batches spilled as the reference's
    catalog."""
    jcat, tcat = jspill.BufferCatalog.get(), tspill.BufferCatalog.get()
    jsb, tsb = [], []
    for i, (prio, rows) in enumerate(PRIORITIES):
        jsb.append(jspill.SpillableBatch(_ref_long_table(rows, i), jcat,
                                         priority=prio))
        tsb.append(tspill.SpillableBatch(_long_table(rows, i), tcat,
                                         priority=prio))
    # touch one of each so recency matters within a priority
    jsb[0].get()
    tsb[0].get()
    j_order = [jsb.index(b) for b in jcat._spill_order()]
    t_order = [tsb.index(b) for b in tcat._spill_order()]
    assert t_order == j_order
    jfreed = jcat.synchronous_spill(target)
    tfreed = tcat.synchronous_spill(target)
    assert tfreed == jfreed
    assert [b.tier for b in tsb] == [b.tier for b in jsb]
    for b in jsb + tsb:
        b.release()
