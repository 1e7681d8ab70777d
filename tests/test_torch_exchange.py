"""The port's murmur3 hash, partitioners and single-device repartition
(spark_rapids_tpu_torch/shuffle/, ops/hashfns.py, execs/exchange.py)
against the JAX package on the same numpy inputs.

Comparators:
- murmur3 (``F.hash`` and ``HashPartitioner.partition_ids``): bit for
  bit, int32 arrays equal, over every row including nulls;
- repartition -> group-by: ``scale_test.tables_differ`` (bitwise, in
  order; both packages emit the groups in ascending key order)."""

import numpy as np
import pytest
import torch

from scale_test import tables_differ
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import DeviceTable as JDeviceTable
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.runtime import speculation as jspec
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.shuffle import hashing as jhashing
from spark_rapids_tpu.shuffle.partitioning import HashPartitioner as JHashP
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch import types as TT
from spark_rapids_tpu_torch.columnar import DeviceColumn, DeviceTable
from spark_rapids_tpu_torch.columnar.table import (
    merge_split_views,
    mergeable_views,
)
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.ops.expr import lit as tlit
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.runtime import speculation as tspec
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.shuffle import hashing as thashing
from spark_rapids_tpu_torch.shuffle.partitioning import HashPartitioner

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clear_blocklists():
    jspec._BLOCKLIST.clear()
    tspec.clear_blocklist()
    yield
    jspec._BLOCKLIST.clear()
    tspec.clear_blocklist()


def _reference_table(names, types, arrays) -> JHostTable:
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, np.asarray(v, dtype=bool))
        for ty, (d, v) in zip(types, arrays)])


def _as_reference(t) -> JHostTable:
    return _reference_table(*t.to_arrays())


#: a non-canonical NaN (payload 1) and a negative NaN
NAN_PAYLOAD = np.array([0x7FF0000000000001], dtype=np.int64).view(
    np.float64)[0]
NEG_NAN = np.array([-0x0008000000000000], dtype=np.int64).view(
    np.float64)[0]
STRINGS = ["", "a", "ab", "abc", "abcd", "abcde", "abcdef", "abcdefg",
           "é", "日本", "naïve🙂", "R00000001", "\x80x", "abcdefghijklmnopq"]


def _hash_table(n=96, seed=5):
    """Every type the hash takes, with nulls: int, long, double (+-0.0,
    NaNs), string (empty, 1-7 bytes, multi-byte UTF-8, 17 bytes),
    decimal(12,2), date, bool, byte and short."""
    rng = np.random.default_rng(seed)
    i = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    i[:3] = [0, -1, 2 ** 31 - 1]
    j = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
    j[:3] = [0, -1, -2 ** 63]
    d = rng.normal(size=n) * 1e6
    d[:8] = [0.0, -0.0, np.nan, NEG_NAN, NAN_PAYLOAD, np.inf, -np.inf, 1.5]
    s = np.array([STRINGS[k] for k in rng.integers(0, len(STRINGS), n)],
                 dtype=object)
    s[:len(STRINGS)] = STRINGS
    dec = rng.integers(-10 ** 11, 10 ** 11, n).astype(np.int64)
    date = rng.integers(-20000, 30000, n).astype(np.int32)
    b = rng.integers(0, 2, n).astype(bool)
    by = rng.integers(-128, 128, n).astype(np.int8)
    sh = rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16)
    names = ["i", "j", "d", "s", "dec", "date", "b", "by", "sh"]
    types = ["int", "bigint", "double", "string", "decimal(12,2)", "date",
             "boolean", "tinyint", "smallint"]
    arrays = []
    for k, a in enumerate([i, j, d, s, dec, date, b, by, sh]):
        v = rng.random(n) > 0.15
        v[:len(STRINGS)] = True
        v[len(STRINGS) + k] = False  # each column null somewhere alone
        arrays.append((a, v))
    return names, types, arrays


HASH_CASES = [("i",), ("j",), ("d",), ("s",), ("dec",), ("date",), ("b",),
              ("by",), ("sh",), ("s", "j"), ("j", "d", "s"),
              ("b", "date", "dec", "i")]


@pytest.mark.parametrize("cols", HASH_CASES, ids="+".join)
def test_hash_matches_reference_bit_for_bit(cols):
    """``F.hash`` over each type alone and over multi-column keys; a null
    passes the running hash through."""
    arrays = _hash_table()
    ref = jfrom(_reference_table(*arrays), TpuSession()).select(
        JF.hash(*[jcol(c) for c in cols]).alias("h")).collect_table()
    got = tfrom(host_table_from_arrays(*arrays),
                TorchSession(device="cpu")).select(
        TF.hash(*[tcol(c) for c in cols]).alias("h")).collect_table()
    assert tables_differ(_as_reference(got), ref) is None
    assert got.columns[0].validity.all()


def _tables(arrays, cap):
    jt = JDeviceTable.from_host(_reference_table(*arrays), cap)
    ht = host_table_from_arrays(*arrays)
    tt = DeviceTable(ht.names, [DeviceColumn.from_host(c, cap, CPU)
                                for c in ht.columns], ht.num_rows, cap, CPU)
    return jt, tt


@pytest.mark.parametrize("n", [8, 200])
@pytest.mark.parametrize("cols", [("i",), ("j",), ("d",), ("s",), ("dec",),
                                  ("date",), ("b",), ("s", "j"),
                                  ("j", "d", "s")], ids="+".join)
def test_partition_ids_match_reference(cols, n):
    """pmod(murmur3(keys, 42), n) over the batch's whole capacity."""
    arrays = _hash_table()
    jt, tt = _tables(arrays, 128)
    schema = [(nm, JT.parse_type(ty)) for nm, ty in zip(arrays[0],
                                                        arrays[1])]
    tschema = [(nm, TT.parse_type(ty)) for nm, ty in zip(arrays[0],
                                                         arrays[1])]
    ref = np.asarray(JHashP([jcol(c).bind(schema) for c in cols],
                            n).partition_ids(jt))
    got = HashPartitioner([tcol(c).bind(tschema) for c in cols],
                          n).partition_ids(tt)
    live = np.arange(128) < len(arrays[2][0][0])
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy()[live], ref[live])
    assert got.min() >= 0 and got.max() < n


def test_string_hash_of_each_length_matches_the_numpy_mirror():
    """The device's word rounds and sign-extended tail bytes against the
    port's numpy mirror and the reference's, one string at a time."""
    d = np.array(STRINGS, dtype=object)
    mat, lens = thashing.string_dict_bytes(d)
    rmat, rlens = jhashing.string_dict_bytes(d)
    assert np.array_equal(mat, rmat) and np.array_equal(lens, rlens)
    codes = torch.arange(len(d), dtype=torch.int32)
    got = thashing.murmur3_hash_device(
        [(codes, torch.ones(len(d), dtype=torch.bool), TT.STRING)],
        string_bytes={0: (torch.from_numpy(mat), torch.from_numpy(lens))})
    want = [thashing.murmur3_hash_host([(s, True, TT.STRING)]) for s in d]
    ref = [jhashing.murmur3_hash_host([(s, True, JT.STRING)]) for s in d]
    assert got.tolist() == want == ref


def test_nan_hash_keeps_raw_bits_as_the_reference():
    """Both of the reference's forms (device and host) hash a double's raw
    bits: a negative NaN and a NaN with a payload hash apart from the
    canonical NaN, where Spark's doubleToLongBits would give one value.
    The port follows the reference; -0.0 hashes as 0.0 in all three."""
    vals = np.array([np.nan, NEG_NAN, NAN_PAYLOAD, 0.0, -0.0])
    got = thashing.murmur3_hash_device(
        [(torch.from_numpy(vals), torch.ones(5, dtype=torch.bool),
          TT.DOUBLE)]).tolist()
    ref = [jhashing.murmur3_hash_host([(v, True, JT.DOUBLE)]) for v in vals]
    assert got == ref
    assert len({got[0], got[1], got[2]}) == 3
    assert got[3] == got[4]


def test_hash_over_decimal128_raises_naming_itself():
    """hash() over a DECIMAL128, which raised until the port hashed
    Spark's bytes of the unscaled value (BigInteger.toByteArray: minimal
    big-endian two's complement) on the device, equals the reference's
    host hash, values of every byte length and sign included."""
    vals = [0, 1, -1, 127, 128, -128, -129, 255, 256, 2 ** 63, -(2 ** 63),
            10 ** 29 - 1, -(10 ** 29 - 1), 123456789012345678901234567]
    arrays = (["x"], ["decimal(30,2)"],
              [(np.array(vals, dtype=object), np.ones(len(vals), bool))])
    df = tfrom(host_table_from_arrays(*arrays), TorchSession(device="cpu"))
    got = df.select(TF.hash(tcol("x")).alias("h")).collect()
    ref = jfrom(JHostTable(["x"], [JHostColumn(
        JT.parse_type("decimal(30,2)"), arrays[2][0][0],
        arrays[2][0][1])]), TpuSession()).select(
        JF.hash(jcol("x")).alias("h")).collect()
    assert got == ref
    assert [h for (h,) in got] == [jhashing.murmur3_hash_host(
        [(v, True, JT.parse_type("decimal(30,2)"))]) for v in vals]


# ---------------------------------------------------------------------------
# repartition
# ---------------------------------------------------------------------------

def _li(n=3000, seed=11):
    rng = np.random.default_rng(seed)
    flags = np.array(["A", "N", "R", "Ré"], dtype=object)[
        rng.integers(0, 4, n)]
    qty = rng.integers(1, 51, n).astype(np.int64)
    fv = rng.random(n) > 0.05
    k = rng.integers(0, 40, n).astype(np.int64)
    return (["flag", "qty", "k"], ["string", "bigint", "bigint"],
            [(flags, fv), (qty, np.ones(n, bool)), (k, rng.random(n) > 0.1)])


@pytest.mark.parametrize("how", ["hash_string", "hash_two_keys",
                                 "roundrobin", "hash_then_filter",
                                 "hash_one_part", "hash_at_the_limit",
                                 "roundrobin_at_the_limit"])
def test_repartition_then_group_by_matches_reference(how):
    """repartition -> group-by (COUNT, int64 SUM) through one merged batch:
    the aggregate sees the split's views as one masked batch."""
    arrays = _li()

    def q(frm, F, col, lit, session):
        df = frm(
            _reference_table(*arrays) if frm is jfrom
            else host_table_from_arrays(*arrays), session)
        if how == "hash_string":
            df = df.repartition(8, "flag")
        elif how == "hash_two_keys":
            df = df.repartition(16, "k", "flag")
        elif how == "roundrobin":
            df = df.repartition(5)
        elif how == "hash_one_part":
            df = df.repartition(1, "k")
        elif how == "hash_at_the_limit":  # the device split's 32 partitions
            df = df.repartition(32, "k")
        elif how == "roundrobin_at_the_limit":
            df = df.repartition(32)
        else:
            df = df.repartition(8, "k").filter(col("qty") > lit(10))
        return (df.group_by("flag")
                .agg(F.count("qty").alias("c"), F.sum("qty").alias("s")))

    from spark_rapids_tpu.ops.expr import lit as jlit
    ref = q(jfrom, JF, jcol, jlit, TpuSession()).collect_table()
    s = TorchSession(device="cpu")
    got = q(tfrom, TF, tcol, tlit, s).collect_table()
    assert tables_differ(_as_reference(got), ref) is None
    assert s.last_metrics()["localSplitParts"] == {
        "hash_string": 8, "hash_two_keys": 16, "roundrobin": 5,
        "hash_then_filter": 8, "hash_one_part": 1, "hash_at_the_limit": 32,
        "roundrobin_at_the_limit": 32}[how]


@pytest.mark.parametrize("how", ["hash", "roundrobin"])
def test_repartition_then_sort_matches_reference(how):
    """repartition -> sort: the split's views pass the pre-sort coalesce
    one by one and the sort concatenates them (rows in the reference's
    order, every column a sort key)."""
    arrays = _li()

    def q(frm, session):
        df = frm(
            _reference_table(*arrays) if frm is jfrom
            else host_table_from_arrays(*arrays), session)
        df = df.repartition(8, "k") if how == "hash" else df.repartition(5)
        return df.sort("flag", "qty", "k")

    ref = q(jfrom, TpuSession()).collect_table()
    s = TorchSession(device="cpu")
    got = q(tfrom, s).collect_table()
    assert tables_differ(_as_reference(got), ref) is None
    assert s.last_metrics()["maskedPassthrough"] == {"hash": 8,
                                                     "roundrobin": 5}[how]


def _split_views(table, nparts, token):
    pids = torch.arange(table.capacity) % nparts
    views = []
    for p in range(nparts):
        m = table.row_mask() & (pids == p)
        v = DeviceTable(table.names, table.columns, m.sum(dtype=torch.int32),
                        table.capacity, CPU, live=m)
        v.split_group = token
        views.append(v)
    return views


def test_views_merge_only_within_one_split():
    """Views of one split (same buffers, same token) merge into one masked
    batch; two filters of one scan share buffers with OVERLAPPING masks
    and carry no token, so they stay apart (OR-ing them would drop
    duplicates); views of two splits of one table do not merge."""
    _, tt = _tables(_li(100), 128)
    token = object()
    merged = list(merge_split_views(iter(_split_views(tt, 4, token))))
    assert len(merged) == 1
    assert merged[0].num_rows == 100
    assert torch.equal(merged[0].live, tt.row_mask())
    live = tt.row_mask()
    f1 = DeviceTable(tt.names, tt.columns, 0, 128, CPU,
                     live=live & (torch.arange(128) < 60))
    f2 = DeviceTable(tt.names, tt.columns, 0, 128, CPU,
                     live=live & (torch.arange(128) >= 40))
    assert not mergeable_views(f1, f2)
    assert len(list(merge_split_views(iter([f1, f2])))) == 2
    a = _split_views(tt, 2, object())
    b = _split_views(tt, 2, object())
    assert len(list(merge_split_views(iter([a[0], b[1]])))) == 2


def test_aggregate_over_two_filter_views_is_not_merged():
    """An aggregate whose input yields two unsplit views of one batch
    keeps them apart: it aggregates each as its own batch and merges the
    partials (rows 0-59 and 40-99: 120 rows counted, the 20 shared rows
    twice) instead of OR-ing the masks (which would count 100)."""
    from spark_rapids_tpu_torch.execs.aggregate import TpuHashAggregateExec
    from spark_rapids_tpu_torch.execs.base import TpuExec
    from spark_rapids_tpu_torch.ops import aggregates as A
    _, tt = _tables(_li(100), 128)
    live = tt.row_mask()

    class TwoFilters(TpuExec):
        def output_schema(self):
            return [(n, c.dtype) for n, c in zip(tt.names, tt.columns)]

        def execute_masked(self):
            for m in (live & (torch.arange(128) < 60),
                      live & (torch.arange(128) >= 40)):
                yield DeviceTable(tt.names, tt.columns,
                                  m.sum(dtype=torch.int32), 128, CPU, live=m)

    schema = TwoFilters().output_schema()
    agg = TpuHashAggregateExec(TwoFilters(), [], [
        ("c", A.Count(tcol("qty").bind(schema)))], [])
    (out,) = agg.execute()
    assert out.to_host().columns[0].data.tolist() == [120]
    assert agg.metrics["partialAggBatches"] == 2


def test_execute_yields_each_partition_compacted():
    """The exchange's execute() yields the views' prefix forms: together
    they hold every input row once, each row in its murmur3 partition."""
    from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
    arrays = _li(500)
    ht = host_table_from_arrays(*arrays)
    from spark_rapids_tpu_torch.columnar import BucketPolicy
    from spark_rapids_tpu_torch.execs.basic import TpuScanExec
    scan = TpuScanExec([ht], CPU, BucketPolicy(128))
    schema = scan.output_schema()
    ex = TpuShuffleExchangeExec(scan, "hash", 4, [tcol("k").bind(schema)])
    parts = list(ex.execute())
    assert len(parts) == 4 and all(p.live is None for p in parts)
    ks = [p.to_host().columns[2] for p in parts]
    assert sum(len(k) for k in ks) == 500
    for p, k in enumerate(ks):
        want = [thashing.murmur3_hash_host([(v, ok, TT.LONG)]) % 4
                for v, ok in zip(k.data, k.validity)]
        assert want == [p] * len(k)


def test_unported_shuffles_raise_naming_themselves():
    """Past 32 partitions the exchange takes the host shuffle, as the
    reference's does: a repartition into 33 partitions runs (it no longer
    raises) and its group-by equals the reference's
    (``tables_differ``)."""
    arrays = _li(50)
    s = TorchSession(device="cpu")
    got = tfrom(host_table_from_arrays(*arrays), s).repartition(
        33, "k").group_by("flag").agg(TF.count("qty")).collect_table()
    assert s.last_metrics().get("shuffleMapOutputs") == 1
    want = jfrom(_reference_table(*arrays), TpuSession()).repartition(
        33, "k").group_by("flag").agg(JF.count("qty")).collect_table()
    assert tables_differ(_as_reference(got), want) is None
