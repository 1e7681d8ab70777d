"""Queries under a squeezed device budget, through the JAX package's
TpuSession and the port's TorchSession(device="cpu"), both with
``spark.rapids.memory.device.budgetBytes`` at a quarter of the query's
unsqueezed peak accounted bytes (the reference's ``MEMORY.peak_bytes()``
of the same query unsqueezed): TPC-H q1, a multi-batch sort, a join and a
two-pass window. The answers equal the reference's and the port's own
unsqueezed answers; the routes equal the reference's (``sortOutOfCore``
and ``subPartitions`` in the port's ``last_metrics()`` against the
reference's exec metrics: the sort's out-of-core threshold and the join's
sub-partition target are capped by the budget's scan chunk in both); and
the port counts no budget violation and peaks within the budget. Then
injected OOMs through the session (``spark.rapids.sql.test.
injectRetryOOM``) and a budget no retry can meet (FatalDeviceOOM, no
fallback).

Comparators: ``scale_test.tables_differ`` (bitwise, in order) for the
sort; ``scale_test.tables_differ_unordered`` (the bitwise row multiset)
for the join; ``scale_test.tables_close`` (rtol
1e-9, keys and counts exact) where f64 sums add in another order (q1's
partial sums, the window's whole-partition sums)."""

import numpy as np
import pytest
import torch

from scale_test import tables_close, tables_differ, tables_differ_unordered
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.models import tpch as jtpch
from spark_rapids_tpu.ops import window as JW
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.runtime import memory as jmem
from spark_rapids_tpu.runtime import retry as jretry
from spark_rapids_tpu.runtime import speculation as jspec
from spark_rapids_tpu.runtime import spill as jspill
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.errors import FatalDeviceOOM
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.models import tpch as ttpch
from spark_rapids_tpu_torch.ops import window as TW
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.runtime import memory as tmem
from spark_rapids_tpu_torch.runtime import retry as tretry
from spark_rapids_tpu_torch.runtime import speculation as tspec
from spark_rapids_tpu_torch.runtime import spill as tspill
from spark_rapids_tpu_torch.session import TorchSession

BUDGET_KEY = "spark.rapids.memory.device.budgetBytes"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reset_runtime():
    """Both packages' process-wide runtime state: blocklists, catalogs,
    arbiters and this thread's armed injections (an injection a query
    did not consume stays armed for the next one, in both)."""
    jspec._BLOCKLIST.clear()
    tspec.clear_blocklist()
    jspill.BufferCatalog.reset()
    tspill.BufferCatalog.reset()
    jmem.MEMORY.reset()
    tmem.MEMORY.reset()
    jretry.RMM_TPU.clear()
    tretry.RMM_TPU.clear()


@pytest.fixture(autouse=True)
def _fresh_runtime():
    _reset_runtime()
    yield
    _reset_runtime()


def _reference_table(names, types, arrays) -> JHostTable:
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(t), np.asarray(d), np.asarray(v, bool))
        for t, (d, v) in zip(types, arrays)])


def _as_reference(t) -> JHostTable:
    return _reference_table(*t.to_arrays())


def _ref_metrics(session) -> dict:
    """The reference's exec metrics of its last query, summed by name."""
    out, seen = {}, set()

    def walk(e):
        if e is None or id(e) in seen:
            return
        seen.add(id(e))
        for k, v in (getattr(e, "metrics", None) or {}).items():
            if isinstance(v, (int, float)):
                out[k] = out.get(k, 0) + v
        for c in getattr(e, "children", ()) or ():
            walk(c)
        for a in ("source", "tpu_exec", "cpu_node", "child"):
            walk(getattr(e, a, None))

    walk(session._last_executable)
    return out


class _Api:
    def __init__(self, frm, F, W, col, session, table):
        self.frm, self.F, self.W, self.col = frm, F, W, col
        self.session, self.table = session, table


def _apis(conf=None, ref_conf=None):
    return (_Api(jfrom, JF, JW.Window, jcol,
                 TpuSession({**(conf or {}), **(ref_conf or {})}),
                 lambda a: _reference_table(*a)),
            _Api(tfrom, TF, TW.Window, tcol, TorchSession(conf, device="cpu"),
                 lambda a: host_table_from_arrays(*a)))


def _run(query, arrays, nbatches, conf):
    """(port result, reference result, port metrics, reference metrics,
    port peak bytes) of ``query`` under ``conf``."""
    japi, tapi = _apis(conf)
    jmem.MEMORY.reset()
    ref = query(japi, japi.frm(japi.table(arrays), japi.session,
                               num_batches=nbatches)).collect_table()
    jpeak = jmem.MEMORY.peak_bytes()
    tmem.MEMORY.reset()
    got = query(tapi, tapi.frm(tapi.table(arrays), tapi.session,
                               num_batches=nbatches)).collect_table()
    return (_as_reference(got), ref, tapi.session.last_metrics(),
            _ref_metrics(japi.session), tmem.MEMORY.peak_bytes(), jpeak)


def _squeezed(query, arrays, nbatches):
    """Unsqueezed, then at a quarter of the reference's unsqueezed
    peak."""
    plain = _run(query, arrays, nbatches, None)
    budget = plain[5] // 4
    squeezed = _run(query, arrays, nbatches, {BUDGET_KEY: str(budget)})
    return plain, squeezed, budget


def _check_budget(squeezed, budget):
    m = squeezed[2]
    assert m.get("budgetViolations", 0) == 0
    assert squeezed[4] <= budget


def _lineitem(n=12_000):
    t = ttpch.lineitem_table(n, seed=3)
    return t.to_arrays()


def test_q1_under_a_squeezed_budget():
    """TPC-H q1: the scan lands in chunks, the aggregate merges their
    partials; keys and counts exact, sums rtol 1e-9."""
    arrays = _lineitem()

    def run(conf):
        japi, tapi = _apis(conf)
        jmem.MEMORY.reset()
        ref = jtpch.q1_dataframe(japi.session,
                                 japi.table(arrays)).collect_table()
        jpeak = jmem.MEMORY.peak_bytes()
        tmem.MEMORY.reset()
        got = ttpch.q1_dataframe(tapi.session,
                                 tapi.table(arrays)).collect_table()
        return (_as_reference(got), ref, tapi.session.last_metrics(),
                tmem.MEMORY.peak_bytes(), jpeak)

    plain = run(None)
    budget = plain[4] // 4
    got, ref, m, peak, _ = run({BUDGET_KEY: str(budget)})
    assert m["scanChunks"] > 1 and m["partialAggBatches"] > 1
    assert m.get("budgetViolations", 0) == 0 and peak <= budget
    assert tables_close(got, ref, rtol=1e-9) is None
    assert tables_close(got, plain[0], rtol=1e-9) is None


def _keyed(n=6000, seed=9):
    rng = np.random.default_rng(seed)
    return (["id", "k", "v", "s"], ["bigint", "int", "double", "string"], [
        (rng.permutation(n).astype(np.int64), np.ones(n, bool)),
        (rng.integers(0, 60, n).astype(np.int32), rng.random(n) > 0.05),
        (rng.standard_normal(n), rng.random(n) > 0.1),
        (np.array([f"s{v:02d}" for v in rng.integers(0, 40, n)],
                  dtype=object), rng.random(n) > 0.1)])


def test_multi_batch_sort_goes_out_of_core_under_the_budget():
    """Unsqueezed, four batches concatenate and sort once; squeezed, the
    threshold is capped by the scan chunk and both packages merge sorted
    host runs; the rows equal bit for bit."""
    def q(api, df):
        return df.sort("k", "id")

    plain, sq, budget = _squeezed(q, _keyed(), 4)
    assert "sortOutOfCore" not in plain[2]
    assert "sortOutOfCore" not in plain[3]
    assert sq[2]["sortOutOfCore"] == sq[3]["sortOutOfCore"] == 1
    assert tables_differ(sq[0], sq[1]) is None
    assert tables_differ(sq[0], plain[0]) is None
    assert sq[2].get("spillBytes", 0) > 0
    _check_budget(sq, budget)


def test_join_sub_partitions_under_the_budget():
    """The default sub-partition target (1 GiB) is capped by the scan
    chunk: both packages split the build into the same number of
    partitions; the rows equal bit for bit as a multiset."""
    rng = np.random.default_rng(4)
    n, m = 12000, 4000
    left = (["id", "k", "lv"], ["bigint", "bigint", "double"], [
        (np.arange(n, dtype=np.int64), np.ones(n, bool)),
        (rng.integers(0, 3000, n), np.ones(n, bool)),
        (rng.standard_normal(n), np.ones(n, bool))])
    right = (["k", "rv"], ["bigint", "double"], [
        (rng.permutation(m).astype(np.int64), np.ones(m, bool)),
        (rng.standard_normal(m), np.ones(m, bool))])

    def run(conf):
        out = []
        # one attempt, no runtime broadcast decision: the reference's exec
        # metrics add up over replays and its adaptive build re-executes
        conf = {**(conf or {}),
                "spark.rapids.tpu.speculativeSizing.enabled": "false"}
        for api in _apis(conf, {"spark.rapids.sql.adaptive.enabled":
                                "false"}):
            jmem.MEMORY.reset()
            tmem.MEMORY.reset()
            lf = api.frm(api.table(left), api.session, num_batches=2)
            rf = api.frm(api.table(right), api.session, num_batches=2)
            res = lf.join(rf, on="k").collect_table()
            out.append((res, api.session, tmem.MEMORY.peak_bytes(),
                        jmem.MEMORY.peak_bytes()))
        (ref, jsess, _, jpeak), (got, tsess, tpeak, _) = out
        return (_as_reference(got), ref, tsess.last_metrics(),
                _ref_metrics(jsess), tpeak, jpeak)

    plain = run(None)
    budget = plain[5] // 4
    sq = run({BUDGET_KEY: str(budget),
              "spark.rapids.sql.broadcastSizeBytes": "0"})
    assert "subPartitions" not in plain[2]
    assert sq[2]["subPartitions"] > 1
    assert sq[2]["subPartitions"] == sq[3]["subPartitions"]
    assert tables_differ_unordered(sq[0], sq[1]) is None
    assert tables_differ_unordered(sq[0], plain[0]) is None
    _check_budget(sq, budget)


def test_two_pass_window_under_the_budget():
    """Whole-partition aggregates over four batches: the aggregate pass
    and the join pass replay the batches from the spill catalog; against
    the reference at the same budget (rtol 1e-9: f64 sums)."""
    def q(api, df):
        w = api.W.partition_by("k")
        F = api.F
        return df.with_windows(s=F.sum("v").over(w), c=F.count().over(w),
                               mx=F.max("s").over(w)).sort("id")

    plain, sq, budget = _squeezed(q, _keyed(), 4)
    assert sq[2]["twoPassPartitions"] >= 1
    assert tables_close(sq[0], sq[1], rtol=1e-9) is None
    assert tables_close(sq[0], plain[0], rtol=1e-9) is None
    _check_budget(sq, budget)


def _mem_counters(scope):
    return (scope.get("oomRetries", 0), scope.get("splitRetries", 0))


@pytest.mark.parametrize("inject", ["retry:1", "retry:2", "split:1",
                                    "split:2"])
@pytest.mark.parametrize("warm", [False, True])
def test_injected_ooms_through_the_session(inject, warm):
    """``injectRetryOOM`` arms OOMs at the query's first retry sites: the
    answer is the uninjected one, and ``oomRetries`` and
    ``splitRetries`` equal the reference's under the same conf (a split
    injected at a ``retry_block``, which cannot split, replays as a
    retry in both packages; warm, the scan's cache hit is no retry
    site and the filter's ``with_retry`` splits)."""
    arrays = _keyed(3000)

    def q(api, df):
        return df.filter(api.col("k") > 5).select(
            api.col("id"), api.col("v"))

    conf = {"spark.rapids.sql.test.injectRetryOOM": inject}
    # the reference's executable cache would serve the injected query the
    # uninjected one's converted tree; the port has none
    no_cache = {"spark.rapids.sql.executableCache.enabled": "false"}
    japi, tapi = _apis(None, no_cache)
    jinj, tinj = _apis(conf, no_cache)
    jt, tt = japi.table(arrays), tapi.table(arrays)
    want = q(japi, jfrom(jt, japi.session)).collect_table()
    plain = q(tapi, tfrom(tt, tapi.session)).collect_table()
    if not warm:
        jt, tt = jinj.table(arrays), tinj.table(arrays)
    j0, t0 = _mem_counters(jmem.MEM_SCOPE), _mem_counters(tmem.MEM_SCOPE)
    ref = q(jinj, jfrom(jt, jinj.session)).collect_table()
    j1 = _mem_counters(jmem.MEM_SCOPE)
    got = q(tinj, tfrom(tt, tinj.session)).collect_table()
    t1 = _mem_counters(tmem.MEM_SCOPE)
    assert tables_differ(_as_reference(got), _as_reference(plain)) is None
    assert tables_differ(_as_reference(got), ref) is None
    assert tables_differ(ref, want) is None
    m = tinj.session.last_metrics()
    assert (t1[0] - t0[0], t1[1] - t0[1]) == (j1[0] - j0[0], j1[1] - j0[1])
    assert (m.get("oomRetries", 0), m.get("splitRetries", 0)) == \
        (t1[0] - t0[0], t1[1] - t0[1])
    kind, n = inject.split(":")
    assert sum(t1) - sum(t0) >= min(int(n), 1)


def test_more_injections_than_retries_are_fatal():
    """Three injected RetryOOMs at the scan's first landing outlive its two
    replays (``oomMaxRetries``): FatalDeviceOOM. (The reference's memory
    ladder would replay the query instead; the port has none.)"""
    s = TorchSession({"spark.rapids.sql.test.injectRetryOOM": "retry:3"},
                     device="cpu")
    with pytest.raises(FatalDeviceOOM, match="2 spill-retries"):
        tfrom(host_table_from_arrays(*_keyed(300)), s).collect()


def test_a_budget_no_retry_meets_is_fatal():
    """A budget smaller than one chunk's landing raises FatalDeviceOOM:
    nothing reruns the query on the CPU."""
    arrays = _keyed(3000)
    s = TorchSession({BUDGET_KEY: "100"}, device="cpu")
    with pytest.raises(FatalDeviceOOM):
        tfrom(host_table_from_arrays(*arrays), s).sort("id").collect()


def _ties(kind: str, n=400, seed=5):
    """A first key ``k1`` of ``kind`` with three values, nulls and (for
    doubles) -0.0 beside 0.0 and NaNs; a second key ``k2`` of four
    values with nulls, so every (k1, k2) ties many rows; a partition key
    ``p`` of two values with nulls; values and the row number."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, 3, n)
    if kind == "double":
        k1 = np.array([-0.0, 1.5, np.nan])[pick]
        k1[rng.random(n) < 0.2] = 0.0  # ties -0.0
        ty = "double"
    elif kind == "string":
        k1 = np.array(["b", "", "a"], dtype=object)[pick]
        ty = "string"
    elif kind == "decimal128":
        k1 = np.array([-10 ** 20, 7, 10 ** 21], dtype=object)[pick]
        ty = "decimal(30,2)"
    else:
        k1 = np.array([-5, 0, 9], dtype=np.int64)[pick]
        ty = "bigint"
    return (["p", "k1", "k2", "v", "row"],
            ["int", ty, "int", "bigint", "bigint"], [
                (rng.integers(0, 2, n).astype(np.int32), rng.random(n) > 0.1),
                (k1, rng.random(n) > 0.1),
                (rng.integers(0, 4, n).astype(np.int32), rng.random(n) > 0.1),
                (rng.integers(-50, 50, n).astype(np.int64),
                 rng.random(n) > 0.1),
                (np.arange(n, dtype=np.int64), np.ones(n, bool))])


#: device bytes of about 40 rows of ``_ties``' table: every range of the
#: sorted-run merge is capped well below one first key's rows
TIE_CHUNK_BYTES = 40 * 50


@pytest.mark.parametrize("kind", ["bigint", "double", "string",
                                  "decimal128"])
@pytest.mark.parametrize("route", ["running", "bounded"])
def test_streams_cut_a_one_key_range_on_the_following_keys(
        kind, route, monkeypatch):
    """Under a scan chunk of about 40 rows (``forced_chunking``) every
    first-key range of the sorted-run merge is larger than its cap, so
    ``sorted_run_stream`` cuts it on the following keys (``_tie_pieces``,
    ties on every key kept whole, float keys with -0.0 equal to 0.0 and
    NaNs as one value, DECIMAL128 by its limbs). The running stream
    (partition-less, ORDER BY k1, k2) and the bounded stream (PARTITION
    BY p ORDER BY k1, k2, so one partition arrives across batches) give
    the reference's one-batch answer: every column bit for bit as a row
    multiset (``tables_differ_unordered``: the streams emit in sorted
    order), and row_number row by row."""
    from spark_rapids_tpu_torch.execs import sort as xsort
    cuts = []
    real = xsort._tie_pieces

    def spy(*a, **k):
        pieces = real(*a, **k)
        cuts.append(None if pieces is None else len(pieces))
        return pieces

    monkeypatch.setattr(xsort, "_tie_pieces", spy)
    arrays = _ties(kind)

    def q(api, df):
        F = api.F
        orders = [api.SO(api.col("k1"), True, None),
                  api.SO(api.col("k2"), False, None)]
        if route == "running":
            r = api.W.order_by(*orders)
            return df.with_windows(
                rn=F.row_number().over(r), rk=F.rank().over(r),
                dr=F.dense_rank().over(r), c=F.count("v").over(r),
                s=F.sum("v").over(r),
                mx=F.max("v").over(r.rows_between(None, 0)))
        w = api.W.order_by(*orders).partition_by("p")
        return df.with_windows(s=F.sum("v").over(w.rows_between(-2, 1)),
                               c=F.count("v").over(w.rows_between(0, 3)),
                               mn=F.min("v").over(w.rows_between(-1, 2)))

    from spark_rapids_tpu.plan.nodes import SortOrder as JSortOrder
    from spark_rapids_tpu_torch.plan.nodes import SortOrder as TSortOrder
    japi, tapi = _apis()
    japi.SO, tapi.SO = JSortOrder, TSortOrder
    ref = q(japi, japi.frm(japi.table(arrays), japi.session,
                           num_batches=1)).collect_table()
    with tmem.forced_chunking(TIE_CHUNK_BYTES):
        got = q(tapi, tapi.frm(tapi.table(arrays), tapi.session,
                               num_batches=4)).collect_table()
    m = tapi.session.last_metrics()
    metric = ("runningWindowBatches" if route == "running"
              else "boundedWindowBatches")
    assert m[metric] > 1
    assert cuts and None not in cuts and max(cuts) > 1
    got = _as_reference(got)
    assert tables_differ_unordered(got, ref) is None
    if route == "running":
        rn = dict(zip(got.column("row").data.tolist(),
                      got.column("rn").data.tolist()))
        assert rn == dict(zip(ref.column("row").data.tolist(),
                              ref.column("rn").data.tolist()))
