"""The port's array, struct and map columns (columnar/nested.py and the
nested paths of columnar/column.py, columnar/table.py, runtime/memory.py
and runtime/spill.py): the upload/download round trip with nulls at every
level and empty arrays, against the JAX package's scan of the same rows
(``TpuSession``, comparator ``scale_test.tables_differ``: bitwise, in
order, the reference's object arrays of lists, tuples and dicts); and,
on the port alone, row slicing, host and device concatenation, the
asynchronous download, the memory ledger's count (every buffer once) and
a spill through the host and disk tiers back to the device, bit for
bit."""

import os

import numpy as np
import pytest
import torch

from scale_test import tables_differ
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as TT
from spark_rapids_tpu_torch.columnar import DeviceTable, HostTable
from spark_rapids_tpu_torch.columnar import nested as N
from spark_rapids_tpu_torch.columnar.table import (
    concat_device,
    concat_host,
    enqueue_download,
    upload_host_table,
)
from spark_rapids_tpu_torch.runtime import memory as tmem
from spark_rapids_tpu_torch.runtime import spill as tspill
from spark_rapids_tpu_torch.session import TorchSession
from tests.torch_nested import as_reference, nested_differ, run_both, tables

CPU = torch.device("cpu")

ARRAY_ROWS = [[1, None, 3], None, [], [None], [7, 8], None, [], [9] * 5]
STRUCT = TT.StructType([TT.StructField("x", TT.LONG),
                        TT.StructField("y", TT.DOUBLE),
                        TT.StructField("z", TT.DATE)])
STRUCT_ROWS = [(1, 2.5, 10), None, (None, None, None), (4, None, 12),
               (5, -0.0, None), None, (7, 8.0, 9), (None, 1.0, 1)]
MAP = TT.MapType(TT.INT, TT.DOUBLE)
MAP_ROWS = [{1: 2.0, 3: None}, None, {}, {9: -1.5}, {4: 4.0, 5: 5.0},
            None, {}, {6: None}]


def _table(n_rep=1):
    k = len(ARRAY_ROWS) * n_rep
    return tables([
        ("id", TT.INT, list(range(k))),
        ("a", TT.ArrayType(TT.LONG), ARRAY_ROWS * n_rep),
        ("f", TT.ArrayType(TT.DOUBLE),
         [[float(i), None] if i % 3 else None for i in range(k)]),
        ("b", TT.ArrayType(TT.BOOLEAN),
         [[True, None, False] if i % 2 else [] for i in range(k)]),
        ("s", STRUCT, STRUCT_ROWS * n_rep),
        ("m", MAP, MAP_ROWS * n_rep)])


@pytest.fixture(autouse=True)
def _fresh_catalogs(tmp_path):
    tspill.BufferCatalog.reset(disk_dir=str(tmp_path))
    yield
    tspill.BufferCatalog.get().shutdown()
    tspill.BufferCatalog.reset()
    tmem.MEMORY.reset()


@pytest.mark.parametrize("nb", [1, 3])
def test_round_trip_equals_the_reference_scan(nb):
    want, got = run_both(lambda a, df: df, *_table(3), TpuSession(),
                         TorchSession(device="cpu"), nb=nb)
    assert nested_differ(want, got) is None, nested_differ(want, got)


def test_host_form_is_flat_and_drops_null_rows_elements():
    t = _table()[1]
    a = t.columns[1].data
    assert isinstance(a, N.ArrayData)
    assert a.offsets.tolist() == [0, 3, 3, 3, 4, 6, 6, 6, 11]
    assert a.validity.tolist()[:4] == [True, False, True, False]
    # a holder given with elements under a null row: the upload drops them
    h = N.ArrayData(np.array([0, 2, 4], np.int32),
                    np.array([1, 2, 3, 4], np.int64), np.ones(4, bool))
    dev = N.upload(h, np.array([False, True]), 128, CPU)
    assert dev.offsets[:3].tolist() == [0, 0, 2]
    assert dev.data[:2].tolist() == [3, 4]


def _pylists(t: HostTable):
    return [c.to_pylist() for c in t.columns]


def test_device_round_trip_and_row_slicing():
    host = _table(2)[1]
    dt = upload_host_table(host, CPU)
    assert _pylists(dt.to_host()) == _pylists(host)
    for k in (1, 5, 16):
        part = DeviceTable(dt.names, [c.sliced_rows(128, copy=bool(k % 2))
                                      for c in dt.columns], k, 128, CPU)
        assert _pylists(part.to_host()) == _pylists(host.slice(0, k))
    # the offsets alone are sliced: the element buffers are shared
    c = dt.columns[1].sliced_rows(128)
    assert c.data.data is dt.columns[1].data.data


def test_host_slice_and_concat():
    host = _table(2)[1]
    parts = [host.slice(0, 5), host.slice(5, 6), host.slice(11, 5)]
    assert _pylists(concat_host(parts)) == _pylists(host)
    dev = concat_device([upload_host_table(p, CPU) for p in parts])
    assert _pylists(dev.to_host()) == _pylists(host)


def test_masked_nested_batch_raises_9c():
    """A filter over nested columns runs on the CPU route (the reference's
    too), equal to the reference's row for row (``nested_differ``), so
    no masked batch of the device ever holds a nested column: compacting
    one is an invariant's error."""
    from spark_rapids_tpu_torch.errors import ColumnarProcessingError
    want, got = run_both(lambda a, df: df.filter(a.col("id") > a.lit(3)),
                         *_table(2), TpuSession(), TorchSession(device="cpu"))
    assert nested_differ(want, got) is None, nested_differ(want, got)
    dt = upload_host_table(_table()[1], CPU)
    masked = DeviceTable(dt.names, dt.columns, 2, dt.capacity, CPU,
                         live=torch.arange(dt.capacity) < 2)
    with pytest.raises(ColumnarProcessingError, match="flat columns only"):
        masked.compacted()


def test_asynchronous_download_equals_the_synchronous_one():
    from spark_rapids_tpu_torch.runtime.host_alloc import PinnedMemoryPool
    pool = PinnedMemoryPool(1 << 20, buffer_bytes=4096)
    dt = upload_host_table(_table(4)[1], CPU)
    pending = enqueue_download(dt, pool)
    assert pending is not None
    assert _pylists(pending.resolve()) == _pylists(dt.to_host())


def test_ledger_counts_every_buffer_once():
    tmem.MEMORY.reset()
    host = _table(2)[1]
    dt = upload_host_table(host, CPU)
    bufs = [t for c in dt.columns for t in c.leaves() + (c.validity,)]
    want = sum(t.untyped_storage().nbytes() for t in bufs)
    assert len({t.untyped_storage().data_ptr() for t in bufs}) == len(bufs)
    assert tmem.MEMORY.snapshot()["ledgerBytes"] == want
    # a second table over the same buffers adds nothing
    again = DeviceTable(dt.names, dt.columns, dt.nrows_dev, dt.capacity, CPU)
    tmem.MEMORY.account(again)
    assert tmem.MEMORY.snapshot()["ledgerBytes"] == want
    assert dt.device_nbytes() == sum(t.nbytes for t in bufs)


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def test_spill_and_unspill_bit_for_bit():
    dt = upload_host_table(_table(3)[1], CPU)
    keep = [[x.clone() for x in c.leaves() + (c.validity,)]
            for c in dt.columns]
    want_rows = _pylists(dt.to_host())
    catalog = tspill.BufferCatalog.get()
    sb = tspill.SpillableBatch(dt, catalog)
    nbytes = dt.device_nbytes()
    del dt
    assert sb.spill_to_host() == nbytes
    assert _pylists(sb.get_host()) == want_rows
    assert sb.spill_to_disk() > 0 and sb.tier == "DISK"
    assert len(os.listdir(catalog.disk_dir)) == 1
    back = sb.get()
    assert sb.tier == "DEVICE"
    for c, bufs in zip(back.columns, keep):
        got = c.leaves() + (c.validity,)
        assert len(got) == len(bufs)
        for x, y in zip(got, bufs):
            assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
    assert _pylists(back.to_host()) == want_rows
    sb.release()


def test_a_null_map_key_raises_at_the_download():
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.errors import ColumnarProcessingError
    from spark_rapids_tpu_torch.ops.expr import col
    from spark_rapids_tpu_torch.plan import from_host_table
    t = tables([("k", TT.LONG, [1, None]), ("v", TT.DOUBLE, [1.0, 2.0])])[1]
    df = from_host_table(t, TorchSession(device="cpu")).select(
        F.create_map(col("k"), col("v")).alias("m"))
    with pytest.raises(ColumnarProcessingError, match="null as map key"):
        df.collect_table().columns[0].to_pylist()


def test_a_nested_layout_of_strings_raises_9c():
    """An array of strings has no device layout: its host column holds the
    reference's object array, and a projection over it runs on the CPU
    route, equal to the reference's (``nested_differ``) and reported."""
    from spark_rapids_tpu_torch.obs.events import collect_fallbacks
    rows = [["x", None, "yz"], None, [], ["a"]]
    jt, tt = tables([("id", TT.INT, [0, 1, 2, 3]),
                     ("a", TT.ArrayType(TT.STRING), rows)])
    assert not isinstance(tt.columns[1].data, N.NestedData)
    ts = TorchSession(device="cpu")
    want, got = run_both(lambda a, df: df.select(
        "id", "a", a.F.size("a").alias("n")), jt, tt, TpuSession(), ts)
    assert nested_differ(want, got) is None, nested_differ(want, got)
    assert [f["op"] for f in collect_fallbacks(ts.last_meta)] == [
        "Project", "LocalScan"]


def test_empty_results_keep_their_nested_types():
    from spark_rapids_tpu_torch.columnar.table import empty_host_table
    e = empty_host_table([("a", TT.ArrayType(TT.LONG)), ("s", STRUCT),
                          ("m", MAP)])
    assert e.num_rows == 0 and [c.to_pylist() for c in e.columns] == \
        [[], [], []]
    ref = as_reference(e)
    assert ref.num_rows == 0
