"""The port's window routes over an input of several batches
(execs/window.py: keyed batching, the two-pass window, the bounded-frame
stream, the running stream and the concat of every other window), the
out-of-core sorted-run merge they stream through (execs/sort.py
``sort_runs`` and ``sorted_run_stream``) and the out-of-core sort, each
held against the JAX package's one-batch answer on the same numpy inputs
(cheap), and one route against the reference's own bounded stream.

Comparators, each named by its test: ``scale_test.tables_differ``
(bitwise, in order) where the port keeps the reference's order;
``tables_differ_unordered`` (the bitwise row multiset) where the order is
the route's (exchange order, join order, sorted order);
``tables_close`` (rtol 1e-9, order-insensitive) where f64 sums add in
another order."""

import numpy as np
import pytest
import torch

from scale_test import tables_close, tables_differ, tables_differ_unordered
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.ops import window as JW
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.plan.nodes import SortOrder as JSortOrder
from spark_rapids_tpu.runtime import speculation as jspec
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.execs import basic as xbasic
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.ops import window as TW
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.plan.nodes import SortOrder as TSortOrder
from spark_rapids_tpu_torch.runtime import speculation as tspec
from spark_rapids_tpu_torch.session import TorchSession


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


def _cols(t, *names) -> JHostTable:
    return JHostTable(list(names), [t.columns[t.names.index(n)]
                                    for n in names])


class _Api:
    def __init__(self, frm, F, W, SO, col, session, as_table):
        self.frm, self.F, self.W, self.SO = frm, F, W, SO
        self.col, self.session, self.as_table = col, session, as_table


def _apis(conf=None):
    return (_Api(jfrom, JF, JW.Window, JSortOrder, jcol, TpuSession(conf),
                 lambda a: _reference_table(*a)),
            _Api(tfrom, TF, TW.Window, TSortOrder, tcol,
                 TorchSession(conf, device="cpu"),
                 lambda a: host_table_from_arrays(*a)))


def _table(n=500, seed=11):
    """Partition keys with nulls (int ``pi``, string ``ps`` with an empty
    string), an order key with ties (``oi``), values with nulls (``vi``,
    positive ``vd``, ``vs``) and the row number ``row``."""
    rng = np.random.default_rng(seed)

    def valid(share):
        return rng.random(n) > share

    pi = rng.integers(0, 7, n).astype(np.int32)
    ps = np.array(["a", "b", "", "c"], dtype=object)[rng.integers(0, 4, n)]
    oi = rng.integers(0, 40, n).astype(np.int32)
    vi = rng.integers(-500, 500, n).astype(np.int64)
    vd = np.round(rng.uniform(1.0, 50.0, n), 2)
    vs = np.array(["p", "q", "rr"], dtype=object)[rng.integers(0, 3, n)]
    row = np.arange(n, dtype=np.int64)
    return (["pi", "ps", "oi", "vi", "vd", "vs", "row"],
            ["int", "string", "int", "bigint", "double", "string", "bigint"],
            [(pi, valid(0.1)), (ps, valid(0.1)), (oi, valid(0.1)),
             (vi, valid(0.1)), (vd, valid(0.1)), (vs, valid(0.1)),
             (row, valid(0.0))])


def _spec(api, parts, orders):
    w = api.W.order_by(*[api.SO(api.col(c), asc, None)
                         for c, asc in orders])
    return w.partition_by(*parts) if parts else w


def _routes(query, nbatches=4, conf=None, ref_batches=1):
    """(port result over ``nbatches`` input batches, reference result over
    ``ref_batches``, the port's metrics)."""
    arrays = _table()
    japi, tapi = _apis(conf)
    ref = query(japi, japi.frm(japi.as_table(arrays), japi.session,
                               num_batches=ref_batches)).collect_table()
    got = query(tapi, tapi.frm(tapi.as_table(arrays), tapi.session,
                               num_batches=nbatches)).collect_table()
    return _as_reference(got), ref, tapi.session.last_metrics()


def test_keyed_batching_over_four_batches():
    """Every column over one PARTITION BY: the input is hash-exchanged
    into 8 on it and each partition windows alone
    (``keyBatchedPartitions``); lag, rank, nth_value, an integer running
    sum and a string MAX against the reference's one-batch answer
    (tables_differ_unordered: rows come in exchange order)."""
    def q(api, df):
        w = _spec(api, ["ps"], [("oi", True), ("row", True)])
        F = api.F
        return df.with_windows(lg=F.lag("vd").over(w), rk=F.rank().over(w),
                               nv=F.nth_value("vi", 3).over(w),
                               s=F.sum("vi").over(w), mx=F.max("vs").over(w))

    got, ref, m = _routes(q)
    assert tables_differ_unordered(got, ref) is None
    assert m["keyBatchedPartitions"] == 8


def test_two_pass_over_four_batches():
    """Whole-partition aggregates over one PARTITION BY with null keys:
    the aggregate over the batches, joined back on null-safe keys
    (``twoPassPartitions``); against the reference's one-batch answer
    (tables_close, rtol 1e-9: the f64 sums add in another order; keys,
    counts, integer sums and MIN/MAX exactly)."""
    def q(api, df):
        w = api.W.partition_by("ps")
        F = api.F
        return df.with_windows(s=F.sum("vd").over(w), c=F.count().over(w),
                               cv=F.count("vi").over(w), si=F.sum("vi").over(w),
                               mn=F.min("vs").over(w), a=F.avg("vi").over(w))

    got, ref, m = _routes(q)
    assert tables_close(got, ref, rtol=1e-9) is None
    assert m["twoPassPartitions"] == 1


def test_bounded_stream_over_four_batches():
    """Finite ROWS frames over one spec: sorted host runs merged range by
    range (ranges of 60 rows), each windowed after its context
    (``boundedWindowBatches``); integer sums, counts, MIN/MAX and the
    per-offset AVG against the reference's one-batch answer
    (tables_differ_unordered: the stream emits in sorted order; ties in
    the order key keep the input order in both)."""
    def q(api, df):
        w = _spec(api, ["pi"], [("oi", True)])
        F = api.F
        return df.with_windows(a=F.avg("vd").over(w.rows_between(-3, 2)),
                               s=F.sum("vi").over(w.rows_between(-1, 4)),
                               c=F.count("vi").over(w.rows_between(0, 3)),
                               mx=F.max("vs").over(w.rows_between(-5, -1)))

    got, ref, m = _routes(q, conf={
        "spark.rapids.sql.window.streamTargetRows": "60"})
    assert tables_differ_unordered(got, ref) is None
    assert m["boundedWindowBatches"] >= 8


def test_bounded_stream_against_the_reference_stream():
    """The same bounded stream through both packages over three batches
    (the reference's own streaming route): the rows in the same sorted
    order, bitwise (tables_differ)."""
    def q(api, df):
        w = _spec(api, ["ps"], [("oi", True), ("row", True)])
        return df.with_windows(s=api.F.sum("vi").over(w.rows_between(-2, 1)),
                               mn=api.F.min("vd").over(w.rows_between(-1, 3)))

    conf = {"spark.rapids.sql.window.streamTargetRows": "90"}
    got, ref, m = _routes(q, nbatches=3, conf=conf, ref_batches=3)
    assert tables_differ(got, ref) is None
    assert m["boundedWindowBatches"] >= 4


def test_running_stream_over_four_batches(monkeypatch):
    """Partition-less running windows over one ORDER BY: every batch a
    sorted run (the coalesce target at one byte, as the aggregate merge's
    tests set it), merged in ranges of 50 rows, each windowed with the
    carried state (``runningWindowBatches``). Ranks, counts, the integer
    sum and MIN/MAX bitwise (tables_differ_unordered: the stream emits in
    sorted order); the f64 sum and AVG within rtol 1e-9 (tables_close)."""
    monkeypatch.setattr(xbasic, "BATCH_SIZE_BYTES", 1)

    def q(api, df):
        r = _spec(api, [], [("oi", False)])
        w = r.rows_between(None, 0)
        F = api.F
        return df.with_windows(
            rn=F.row_number().over(r), rk=F.rank().over(r),
            dr=F.dense_rank().over(r), c=F.count("vi").over(r),
            si=F.sum("vi").over(w),
            mn=F.min("vd").over(r), mx=F.max("vi").over(w),
            s=F.sum("vd").over(r), a=F.avg("vi").over(w))

    got, ref, m = _routes(q, conf={
        "spark.rapids.sql.window.streamTargetRows": "50"})
    exact = ("row", "rk", "dr", "c", "si", "mn", "mx")
    assert tables_differ_unordered(_cols(got, *exact),
                                   _cols(ref, *exact)) is None
    assert tables_close(_cols(got, "row", "s", "a"),
                        _cols(ref, "row", "s", "a"), rtol=1e-9) is None
    assert m["runningWindowBatches"] == 4
    # row_number follows the stream's order: ties on oi keep input order
    rows = dict(zip(got.column("row").data.tolist(),
                    got.column("rn").data.tolist()))
    want = dict(zip(ref.column("row").data.tolist(),
                    ref.column("rn").data.tolist()))
    assert rows == want


def test_other_windows_concatenate_their_batches():
    """Columns over different partition keys, one without PARTITION BY:
    the batches concatenate on the device and window as one (bitwise, in
    input order: tables_differ)."""
    def q(api, df):
        a = _spec(api, [], [("oi", True), ("row", True)])
        b = _spec(api, ["ps"], [("row", True)])
        F = api.F
        return df.with_windows(lg=F.lead("vs").over(a),
                               pr=F.percent_rank().over(b),
                               mx=F.max("vi").over(api.W.partition_by("pi")))

    got, ref, m = _routes(q, nbatches=3)
    assert tables_differ(got, ref) is None
    assert m["concatBatches"] == 3


def _runs(sorter, arrays, nruns):
    """``arrays`` cut into ``nruns`` batches on the CPU, each sorted into a
    host run."""
    from spark_rapids_tpu_torch.columnar.table import upload_host_table
    from spark_rapids_tpu_torch.execs.sort import sort_runs
    t = host_table_from_arrays(*arrays)
    per = -(-t.num_rows // nruns)
    batches = [upload_host_table(t.slice(i * per, min(
        per, t.num_rows - i * per)), torch.device("cpu"))
        for i in range(nruns)]
    return sort_runs(sorter, batches)


@pytest.mark.parametrize("asc, nulls_first", [(True, True), (False, False),
                                              (True, False)])
def test_sorted_run_stream_keeps_equal_first_keys_in_one_batch(
        asc, nulls_first):
    """Five sorted runs of many tied first keys with nulls, merged in
    ranges of about 40 rows: the batches concatenate into the one-batch
    sort bit for bit (tables_differ, after the reference's sort), and no
    first key appears in two batches."""
    from spark_rapids_tpu_torch.execs.sort import (
        TpuSortExec,
        sorted_run_stream,
    )
    from spark_rapids_tpu_torch.ops.expr import BoundReference
    from spark_rapids_tpu_torch import types as TT
    rng = np.random.default_rng(3)
    n = 300
    arrays = (["k", "s", "row"], ["int", "string", "bigint"],
              [(rng.integers(0, 12, n).astype(np.int32), rng.random(n) > 0.1),
               (np.array(["x", "y", "z"], dtype=object)[
                   rng.integers(0, 3, n)], rng.random(n) > 0.1),
               (np.arange(n, dtype=np.int64), np.ones(n, bool))])
    orders = [TSortOrder(BoundReference(0, TT.INT), asc, nulls_first),
              TSortOrder(BoundReference(1, TT.STRING), True, None)]
    runs = _runs(TpuSortExec.for_orders(orders), arrays, 5)
    out = [b.to_host() for b in sorted_run_stream(
        runs, orders, torch.device("cpu"), target_rows=40)]
    assert len(out) >= 4
    seen = set()
    for b in out:
        keys = set(b.columns[0].to_pylist())
        assert not keys & seen
        seen |= keys
    japi = _apis()[0]
    ref = japi.frm(japi.as_table(arrays), japi.session).sort(
        JSortOrder(jcol("k"), asc, nulls_first),
        JSortOrder(jcol("s"), True, None)).collect_table()
    from spark_rapids_tpu_torch.columnar.table import concat_host
    assert tables_differ(_as_reference(concat_host(out)), ref) is None


def test_sorted_run_stream_over_a_computed_first_key():
    """A first key that is no column (``k % 5`` descending): it rides as
    each run's hidden last column, the merge cuts on it and drops it; the
    result is the one-batch sort (tables_differ against the reference's
    sort)."""
    from spark_rapids_tpu_torch.execs.sort import (
        TpuSortExec,
        sorted_run_stream,
    )
    from spark_rapids_tpu_torch.columnar.table import concat_host
    from spark_rapids_tpu_torch.ops.expr import BoundReference, lit
    from spark_rapids_tpu_torch import types as TT
    rng = np.random.default_rng(4)
    n = 200
    arrays = (["k", "row"], ["bigint", "bigint"],
              [(rng.integers(0, 1000, n).astype(np.int64), np.ones(n, bool)),
               (np.arange(n, dtype=np.int64), np.ones(n, bool))])
    key = BoundReference(0, TT.LONG) % lit(5)
    orders = [TSortOrder(key, False, None),
              TSortOrder(BoundReference(1, TT.LONG), True, None)]
    runs = _runs(TpuSortExec.for_orders(orders), arrays, 4)
    assert runs[0].names[-1] == "__run_key"
    out = [b.to_host() for b in sorted_run_stream(
        runs, orders, torch.device("cpu"), target_rows=30)]
    assert len(out) == 5 and all(b.names == ("k", "row") for b in out)
    japi = _apis()[0]
    ref = japi.frm(japi.as_table(arrays), japi.session).sort(
        JSortOrder(jcol("k") % 5, False, None),
        JSortOrder(jcol("row"), True, None)).collect_table()
    assert tables_differ(_as_reference(concat_host(out)), ref) is None


def test_out_of_core_sort_matches_the_one_batch_sort():
    """A sort past a low ``outOfCoreThresholdBytes`` over four batches:
    sorted host runs merged range by range (``sortOutOfCore``), bit for
    bit the reference's one-batch sort, string and float keys with nulls
    and ties (tables_differ)."""
    conf = {"spark.rapids.sql.sort.outOfCoreThresholdBytes": "4096"}

    def q(api, df):
        return df.sort(api.SO(api.col("ps"), False, None),
                       api.SO(api.col("vd"), True, False),
                       api.SO(api.col("row"), True, None))

    got, ref, m = _routes(q, conf=conf)
    assert tables_differ(got, ref) is None
    assert m["sortOutOfCore"] == 1


@pytest.mark.parametrize("route, metric", [
    ("keyed", "keyBatchedPartitions"), ("two_pass", "twoPassPartitions"),
    ("bounded", "boundedWindowBatches")])
def test_routes_keep_float_partitions_whole(route, metric):
    """A double partition key with nulls, -0.0 beside 0.0 and NaNs of
    several bit patterns over four batches: the window groups each of
    them as one partition on every route. Keyed batching hashes the
    normalized key (as Spark's planner does before a hash partitioning;
    the reference hashes the raw bits and splits such a partition across
    batches, ROADMAP Queue 3), the two-pass join matches it null-safely,
    the bounded stream cuts ranges on it. Against the reference's
    one-batch answer by row (``o`` is unique; tables_differ_unordered:
    the partition keys' bits may differ where two of them share a
    partition)."""
    neg_nan = np.array([-0x0008000000000000], dtype=np.int64).view(
        np.float64)[0]
    pay_nan = np.array([0x7FF8000000000001], dtype=np.int64).view(
        np.float64)[0]
    n = 400
    rng = np.random.default_rng(8)
    keys = np.array([0.0, -0.0, np.nan, neg_nan, pay_nan, 1.5])[
        rng.integers(0, 6, n)]
    arrays = (["k", "o", "v"], ["double", "int", "bigint"],
              [(keys, rng.random(n) > 0.1),
               (np.arange(n, dtype=np.int32), np.ones(n, bool)),
               (rng.integers(0, 100, n).astype(np.int64), np.ones(n, bool))])

    def q(api, df):
        w = _spec(api, ["k"], [("o", True)])
        if route == "two_pass":
            w = api.W.partition_by("k")
        elif route == "bounded":
            w = w.rows_between(-2, 1)
        cols = dict(c=api.F.count().over(w), s=api.F.sum("v").over(w))
        if route == "keyed":
            cols["rn"] = api.F.row_number().over(w)
        return df.with_windows(**cols)

    japi, tapi = _apis()
    ref = q(japi, japi.frm(japi.as_table(arrays),
                           japi.session)).collect_table()
    got = _as_reference(q(tapi, tapi.frm(tapi.as_table(arrays),
                                         tapi.session,
                                         num_batches=4)).collect_table())
    assert tapi.session.last_metrics()[metric] > 0
    names = [nm for nm in got.names if nm not in ("k", "v")]
    assert tables_differ_unordered(_cols(got, *names),
                                   _cols(ref, *names)) is None
