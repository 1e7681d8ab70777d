"""Range partitioning and the per-partition (local) sort of the PyTorch
port (``shuffle/partitioning.py::RangePartitioner``, the range exchange
of ``execs/exchange.py``, the local sort's conversion in
``overrides/rules.py``) against the reference on the same numpy inputs:
the ports of ``tests/test_shuffle.py:146`` (each partition's keys sort
before the next one's) and ``:301`` (a string bound absent from one
batch's dictionary splits no key across partitions) over integer, double
and string keys, with the partition ids and the bounds equal to the
reference's; and a range exchange followed by a local sort, through the
plan nodes (neither package has a DataFrame method for them), equal to
the reference's run of the same plan and to the global sort. Results
compare with ``scale_test.tables_differ`` (bit for bit, in order);
partition ids exactly."""

import numpy as np
import pytest
import torch

from scale_test import tables_differ
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.columnar.table import DeviceTable as JDeviceTable
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.plan import nodes as JP
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.shuffle.partitioning import (
    RangePartitioner as JRangePartitioner,
)
from spark_rapids_tpu_torch.columnar.table import (
    concat_device,
    upload_host_table,
)
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.ops.expr import col
from spark_rapids_tpu_torch.overrides.rules import collect_cpu_nodes
from spark_rapids_tpu_torch.plan import nodes as P
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.shuffle.partitioning import RangePartitioner

CPU = torch.device("cpu")
NO_CACHE = {"spark.rapids.sql.executableCache.enabled": "false"}
KINDS = {"int": "bigint", "double": "double", "string": "string"}


def _keys(kind: str, n: int, rng):
    """A key column of ``kind`` with repeats, nulls and (doubles) -0.0
    beside 0.0."""
    if kind == "int":
        data = rng.integers(-50, 50, n)
    elif kind == "double":
        data = rng.choice(np.array([-2.5, -0.0, 0.0, 1.25, 3.0, 7.5]), n)
        data = data + rng.integers(0, 4, n) * 10.0
    else:
        data = np.array([f"s{v:03d}" for v in rng.integers(0, 60, n)],
                        dtype=object)
    return data, rng.random(n) > 0.1


def _table(kind: str, n: int, seed: int):
    """(port table, reference table) of key ``k`` of ``kind``, a second
    key ``k2`` and a payload ``v``."""
    rng = np.random.default_rng(seed)
    names = ["k", "k2", "v"]
    types = [KINDS[kind], "bigint", "double"]
    arrays = [_keys(kind, n, rng),
              (rng.integers(0, 1000, n), np.ones(n, bool)),
              (rng.random(n), np.ones(n, bool))]
    t = host_table_from_arrays(names, types, arrays)
    return t, JHostTable(names, [
        JHostColumn(JT.parse_type(ty), c.data, c.validity)
        for ty, c in zip(types, t.columns)])


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("nparts", [4, 7])
def test_range_partition_orders_partitions(kind, nparts):
    """The reference's test at ``tests/test_shuffle.py:146``: every
    partition's keys sort at or before the next partition's; the port's
    sampled bounds and partition ids are the reference's."""
    host, jhost = _table(kind, 2000, 5)
    schema = host.schema()
    rp = RangePartitioner([col("k").bind(schema), col("k2").bind(schema)],
                          nparts)
    pids = rp.partition_ids(upload_host_table(host, CPU)).numpy()[:2000]
    jrp = JRangePartitioner([jcol("k").bind(jhost.schema()),
                             jcol("k2").bind(jhost.schema())], nparts)
    jpids = np.asarray(jrp.partition_ids(JDeviceTable.from_host(jhost)))
    assert np.array_equal(pids, jpids[:2000])
    for mine, ref in zip(rp._bounds, jrp._bounds):
        assert list(mine.validity) == list(ref.validity)
        assert [v for v, ok in zip(mine.data, mine.validity) if ok] == \
            [v for v, ok in zip(ref.data, ref.validity) if ok]
    k = host.columns[0]
    # nulls sort first: a partition holding a null key holds the smallest
    with_null = sorted(set(pids[~k.validity]))
    assert with_null == [] or with_null == [min(pids)]
    vals = np.where(k.validity, k.data, None)
    maxes, mins = [], []
    for p in range(nparts):
        mine = [v for v, q in zip(vals, pids) if q == p and v is not None]
        if mine:
            maxes.append(max(mine))
            mins.append(min(mine))
    for a, b in zip(maxes, mins[1:]):
        assert a <= b


def test_range_partition_string_bounds_consistent_across_batches():
    """The reference's test at ``tests/test_shuffle.py:301``: the first
    batch lacks "banana", a likely bound from the second; the bounds come
    from both batches (the exchange samples their concatenation), and
    each batch, with its own dictionary, maps every value to one
    partition, in order, as the reference's does."""
    vals1 = np.array(["apple", "cherry", "apple", "date"] * 30, dtype=object)
    vals2 = np.array(["banana", "cherry", "banana", "elder"] * 30,
                     dtype=object)
    batches = [upload_host_table(host_table_from_arrays(
        ["s"], ["string"], [(v, np.ones(len(v), bool))]), CPU)
        for v in (vals1, vals2)]
    key = col("s").bind([("s", batches[0].columns[0].dtype)])
    parter = RangePartitioner([key], 3, samples_per_partition=40)
    parter.compute_bounds(concat_device(batches))
    jbatches = [JDeviceTable.from_host(JHostTable(["s"], [JHostColumn(
        JT.STRING, v)])) for v in (vals1, vals2)]
    jparter = JRangePartitioner([jcol("s").bind([("s", JT.STRING)])], 3,
                                samples_per_partition=40)
    jparter.compute_bounds_multi(jbatches)
    assert list(parter._bounds[0].data) == list(jparter._bounds[0].data)
    mapping = {}
    for b, jb, vals in zip(batches, jbatches, (vals1, vals2)):
        pids = parter.partition_ids(b).numpy()[:len(vals)]
        jpids = np.asarray(jparter.partition_ids(jb))[:len(vals)]
        assert np.array_equal(pids, jpids)
        for v, p in zip(vals, pids):
            assert mapping.setdefault(v, int(p)) == int(p), v
    order = sorted(mapping)
    assert [mapping[v] for v in order] == sorted(mapping[v] for v in order)


def _ranged_local_sort(Pmod, api_col, table, nparts, batches):
    """Exchange(range, ``nparts``, (k, k2)) then Sort(global_sort=False) on
    (k, k2, v) over ``table`` cut into ``batches`` scan batches."""
    per = -(-table.num_rows // batches)
    scan = Pmod.LocalScan([table.slice(i * per, min(per, table.num_rows
                                                     - i * per))
                           for i in range(batches)])
    ex = Pmod.Exchange(scan, "range", nparts, [api_col("k"), api_col("k2")])
    orders = [Pmod.SortOrder(api_col(c)) for c in ("k", "k2", "v")]
    return Pmod.Sort(ex, orders, global_sort=False), Pmod.Sort(scan, orders)


@pytest.mark.parametrize("kind", list(KINDS))
def test_range_exchange_then_local_sort_matches_the_reference(kind):
    """A range exchange into 8 partitions over three scan batches, then a
    local sort: equal to the reference's run of the same plan and to the
    global sort, bit for bit, with no node on the CPU route."""
    host, jhost = _table(kind, 3000, 11)
    s = TorchSession(NO_CACHE, device="cpu")
    local, whole = _ranged_local_sort(P, col, host, 8, 3)
    got = s.execute(local)
    assert collect_cpu_nodes(s._last_root) == []
    assert s.last_metrics()["localSplitParts"] == 8
    rs = TpuSession(NO_CACHE)
    jlocal, _ = _ranged_local_sort(JP, jcol, jhost, 8, 3)
    want = rs.execute(jlocal)
    ref = _as_reference(got)
    assert tables_differ(ref, want) is None
    assert tables_differ(got, s.execute(whole)) is None


def test_descending_range_partitions_and_their_local_sorts():
    """Descending keys: the partitioner puts the largest keys first (nulls
    last), and the local sort's descending output equals the
    reference's."""
    host, jhost = _table("int", 1500, 13)
    schema = host.schema()
    rp = RangePartitioner([col("k").bind(schema)], 5, ascending=[False])
    pids = rp.partition_ids(upload_host_table(host, CPU)).numpy()[:1500]
    jrp = JRangePartitioner([jcol("k").bind(jhost.schema())], 5,
                            ascending=[False])
    jpids = np.asarray(jrp.partition_ids(JDeviceTable.from_host(jhost)))
    assert np.array_equal(pids, jpids[:1500])
    k = host.columns[0]
    assert set(pids[~k.validity]) <= {max(pids)}

    def plan(Pmod, api_col, t):
        ex = Pmod.Exchange(Pmod.LocalScan([t]), "range", 5, [api_col("k")])
        return Pmod.Sort(ex, [Pmod.SortOrder(api_col("k"), False),
                              Pmod.SortOrder(api_col("k2")),
                              Pmod.SortOrder(api_col("v"))],
                         global_sort=False)
    got = TorchSession(NO_CACHE, device="cpu").execute(plan(P, col, host))
    want = TpuSession(NO_CACHE).execute(plan(JP, jcol, jhost))
    assert tables_differ(_as_reference(got), want) is None


def _as_reference(t) -> JHostTable:
    names, types, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, v)
        for ty, (d, v) in zip(types, arrays)])
