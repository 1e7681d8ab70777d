"""The port's ranking windows (row_number, rank, dense_rank: ops/window.py,
execs/window.py) and the pre-window group limit against the JAX
package's TpuSession on the same numpy inputs.

Comparator: ``scale_test.tables_differ`` (bitwise, in order) throughout:
both packages keep the input's row order and append the window columns."""

import numpy as np
import pytest
import torch

from scale_test import tables_differ
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.ops import window as JW
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.ops.expr import lit as jlit
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.plan.nodes import SortOrder as JSortOrder
from spark_rapids_tpu.runtime import speculation as jspec
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.ops import window as TW
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.ops.expr import lit as tlit
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


class _Api:
    """One package's DataFrame entry, functions, Window and SortOrder."""

    def __init__(self, frm, F, W, SO, col, lit, session, as_table):
        self.frm, self.F, self.W, self.SO = frm, F, W, SO
        self.col, self.lit, self.session = col, lit, session
        self.as_table = as_table


def _apis(conf=None):
    return (_Api(jfrom, JF, JW.Window, JSortOrder, jcol, jlit,
                 TpuSession(conf), lambda a: _reference_table(*a)),
            _Api(tfrom, TF, TW.Window, TSortOrder, tcol, tlit,
                 TorchSession(conf, device="cpu"),
                 lambda a: host_table_from_arrays(*a)))


def _run_both(arrays, query, conf=None):
    """(port result, reference result, port session) of ``query(api,
    df)`` over the same (names, types, arrays)."""
    japi, tapi = _apis(conf)
    ref = query(japi, japi.frm(japi.as_table(arrays),
                               japi.session)).collect_table()
    got = query(tapi, tapi.frm(tapi.as_table(arrays),
                               tapi.session)).collect_table()
    return _as_reference(got), ref, tapi.session


NEG_NAN = np.array([-0x0008000000000000], dtype=np.int64).view(
    np.float64)[0]


def _window_table(n=600, seed=3):
    """Keys of every kind the windows take, with ties and nulls: int,
    long, double (+-NaN, +-0.0, +-inf), string and decimal(30,2)
    partition keys; int, double and string order keys."""
    rng = np.random.default_rng(seed)

    def valid(share):
        return rng.random(n) > share

    pi = rng.integers(0, 7, n).astype(np.int32)
    pl = rng.integers(-3, 3, n).astype(np.int64) * (1 << 40)
    pd = np.array([np.nan, NEG_NAN, 0.0, -0.0, 1.5, np.inf, -np.inf])[
        rng.integers(0, 7, n)]
    ps = np.array(["a", "b", "", "é", "bb"], dtype=object)[
        rng.integers(0, 5, n)]
    pdec = np.array([int(v) * 10 ** 19 + 7 for v in
                     rng.integers(-2, 3, n)], dtype=object)
    oi = rng.integers(0, 9, n).astype(np.int32)  # many ties
    od = np.round(rng.normal(size=n), 1)
    od[rng.random(n) < 0.05] = np.nan
    od[rng.random(n) < 0.05] = -0.0
    os_ = np.array(["x", "y", "z", "xy"], dtype=object)[
        rng.integers(0, 4, n)]
    row = np.arange(n, dtype=np.int64)
    names = ["pi", "pl", "pd", "ps", "pdec", "oi", "od", "os", "row"]
    types = ["int", "bigint", "double", "string", "decimal(30,2)", "int",
             "double", "string", "bigint"]
    arrays = [(pi, valid(0.1)), (pl, valid(0.1)), (pd, valid(0.1)),
              (ps, valid(0.1)), (pdec, valid(0.1)), (oi, valid(0.1)),
              (od, valid(0.1)), (os_, valid(0.1)), (row, valid(0.0))]
    return names, types, arrays


#: (partition columns, [(order column, ascending, nulls_first or None)])
SPECS = {
    "int_by_int": (["pi"], [("oi", True, None)]),
    "int_by_int_desc": (["pi"], [("oi", False, None)]),
    "int_by_int_nulls_last": (["pi"], [("oi", True, False)]),
    "int_by_int_desc_nulls_first": (["pi"], [("oi", False, True)]),
    "two_keys": (["pi", "ps"], [("oi", True, None)]),
    "long_by_double": (["pl"], [("od", True, None)]),
    "double_nan_zero_keys": (["pd"], [("oi", True, None)]),
    "string_by_string_desc": (["ps"], [("os", False, None)]),
    "string_by_two_orders": (["ps"], [("os", True, None),
                                      ("od", False, True)]),
    "decimal128_by_int": (["pdec"], [("oi", True, None)]),
    "int_by_double_nulls_last": (["pi"], [("od", True, False)]),
}


def _spec(api, parts, orders):
    return api.W.partition_by(*parts).order_by(*[
        api.SO(api.col(c), asc, nf) for c, asc, nf in orders])


@pytest.mark.parametrize("name", sorted(SPECS))
def test_ranking_windows_match_reference(name):
    """row_number, rank and dense_rank over one spec (one sort in the
    port), with ties, nulls in the partition and order keys, both
    directions and both null placements."""
    parts, orders = SPECS[name]

    def q(api, df):
        w = _spec(api, parts, orders)
        return df.with_windows(rn=api.F.row_number().over(w),
                               rk=api.F.rank().over(w),
                               dr=api.F.dense_rank().over(w))

    got, ref, _ = _run_both(_window_table(), q)
    assert tables_differ(got, ref) is None


def test_two_specs_in_one_window_node():
    """Columns over two specs with the same partition keys: two sorts,
    each column back in input row order."""
    def q(api, df):
        a = _spec(api, ["pi"], [("oi", True, None)])
        b = _spec(api, ["pi"], [("od", False, None)])
        return df.with_windows(ra=api.F.rank().over(a),
                               rb=api.F.row_number().over(b))

    got, ref, _ = _run_both(_window_table(), q)
    assert tables_differ(got, ref) is None


#: (window function, filter, whether the group limit applies)
LIMITS = {
    "rn_le": ("row_number", "<=", 2, True),
    "rn_lt": ("row_number", "<", 3, True),
    "rn_eq": ("row_number", "=", 2, True),
    "rank_le": ("rank", "<=", 2, True),
    "dense_rank_le": ("dense_rank", "<=", 3, True),
    "rn_lt_one": ("row_number", "<", 1, False),
}


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_rank_filters_match_reference(name):
    """A ranking filter right above the window plans a group limit in
    both packages (``<= k``, ``< k`` as ``<= k - 1``, ``= k`` as ``<= k``);
    ``< 1`` leaves no row and no limit."""
    fn, op, k, limited = LIMITS[name]

    def q(api, df):
        w = _spec(api, ["pi", "ps"], [("od", False, None)])
        out = df.with_windows(r=getattr(api.F, fn)().over(w))
        c = api.col("r")
        cond = {"<=": c <= api.lit(k), "<": c < api.lit(k),
                "=": c == api.lit(k)}[op]
        return out.filter(cond)

    got, ref, s = _run_both(_window_table(), q)
    assert tables_differ(got, ref) is None
    assert ("groupLimitBatches" in s.last_metrics()) == limited


def test_filter_on_a_column_beside_another_spec_is_not_limited():
    """A sibling window column over another spec would see only the
    surviving rows: no group limit, and the answer stays the
    reference's."""
    def q(api, df):
        a = _spec(api, ["pi"], [("oi", True, None)])
        b = _spec(api, ["pi"], [("od", True, None)])
        out = df.with_windows(rn=api.F.row_number().over(a),
                              rb=api.F.rank().over(b))
        return out.filter(api.col("rn") <= api.lit(2))

    got, ref, s = _run_both(_window_table(), q)
    assert tables_differ(got, ref) is None
    assert "groupLimitBatches" not in s.last_metrics()


def test_non_ranking_sibling_blocks_the_group_limit():
    """An aggregate window beside the ranked column blocks the rewrite;
    the query then matches the reference (tables_differ: an integer
    sum)."""
    from spark_rapids_tpu_torch.overrides.rules import (
        _insert_window_group_limits,
    )
    from spark_rapids_tpu_torch.plan import nodes as P
    api = _apis()[1]
    df = api.frm(api.as_table(_window_table(50)), api.session)
    w = _spec(api, ["pi"], [("oi", True, None)])
    out = df.with_windows(rn=TF.row_number().over(w),
                          total=TF.sum("oi").over(w)).filter(
        tcol("rn") <= tlit(2))
    plan = _insert_window_group_limits(out.plan)
    assert not isinstance(plan.children[0].children[0], P.WindowGroupLimit)
    alone = df.with_windows(rn=TF.row_number().over(w)).filter(
        tcol("rn") <= tlit(2))
    assert isinstance(_insert_window_group_limits(alone.plan)
                      .children[0].children[0], P.WindowGroupLimit)
    got = _as_reference(out.collect_table())
    japi = _apis()[0]
    jdf = japi.frm(japi.as_table(_window_table(50)), japi.session)
    jw = _spec(japi, ["pi"], [("oi", True, None)])
    ref = jdf.with_windows(rn=JF.row_number().over(jw),
                           total=JF.sum("oi").over(jw)).filter(
        jcol("rn") <= jlit(2)).collect_table()
    assert tables_differ(got, ref) is None


def test_ties_across_the_limit_keep_the_stable_order():
    """row_number <= 3 where tied order keys cross the limit (4096 rows,
    16 partitions, 3 distinct order values): the port's sorts are stable,
    so the group limit keeps the tied rows that come first in input order
    and the window numbers them in that order. The reference's group-limit
    sort does not ask for stability, yet gives the same rows here."""
    n = 4096
    rng = np.random.default_rng(9)
    arrays = (["p", "o", "row"], ["int", "int", "bigint"],
              [(rng.integers(0, 16, n).astype(np.int32), np.ones(n, bool)),
               (rng.integers(0, 3, n).astype(np.int32), np.ones(n, bool)),
               (np.arange(n, dtype=np.int64), np.ones(n, bool))])

    def q(api, df):
        w = _spec(api, ["p"], [("o", True, None)])
        return df.with_windows(rn=api.F.row_number().over(w)).filter(
            api.col("rn") <= api.lit(3))

    got, ref, s = _run_both(arrays, q)
    assert tables_differ(got, ref) is None
    assert "groupLimitBatches" in s.last_metrics()
    # the stable oracle: per partition, rank by (o, input row)
    p, o = arrays[2][0][0], arrays[2][1][0]
    order = np.lexsort((np.arange(n), o, p))
    rn = np.empty(n, np.int64)
    start = 0
    for i in range(1, n + 1):
        if i == n or p[order[i]] != p[order[start]]:
            rn[order[start:i]] = np.arange(1, i - start + 1)
            start = i
    keep = np.flatnonzero(rn <= 3)
    assert got.columns[2].data.tolist() == keep.tolist()
    assert got.columns[3].data.tolist() == rn[keep].tolist()


@pytest.mark.parametrize("case, match", [
    ("no_order", "requires an ORDER BY"),
    ("not_a_window", "windowed pandas UDFs"),
    ("nth_value_ignore_nulls", "IGNORE NULLS"),
    ("string_default", "string default"),
    ("range_offsets", "range frames"),
])
def test_unported_windows_raise_naming_themselves(case, match):
    """A ranking window without ORDER BY and a lag with a string default
    run on the CPU route in both packages, equal (``tables_differ``: the
    route keeps the input order) and reported with the reference's
    reason; what neither route runs raises naming itself (the
    reference's CPU route ignores IGNORE NULLS and raises on a RANGE
    frame with offsets). (A window without PARTITION BY, columns over
    different partition keys, an explicit frame and a second input batch
    run on the device: ``test_torch_window_functions.py`` and
    ``test_torch_window_routes.py`` hold them against the reference.)"""
    arrays = _window_table(50)
    if case in ("no_order", "string_default"):
        def q(api, df):
            if case == "no_order":
                return df.with_windows(r=api.F.row_number().over(
                    api.W.partition_by("pi")))
            return df.with_windows(r=api.F.lag("os", 1, "none").over(
                _spec(api, ["pi"], [("oi", True, None)])))
        from spark_rapids_tpu_torch.obs.events import collect_fallbacks
        got, ref, ts = _run_both(arrays, q)
        assert tables_differ(got, ref) is None
        (fb,) = collect_fallbacks(ts.last_meta)
        assert fb["op"] == "WindowNode" and match in fb["reasons"][0]
        return
    api = _apis()[1]
    df = api.frm(api.as_table(arrays), api.session)
    w = _spec(api, ["pi"], [("oi", True, None)])
    fn = TF.row_number()
    with pytest.raises(NotImplementedError, match=match):
        if case == "not_a_window":
            df.with_windows(x=tcol("oi"))
        elif case == "nth_value_ignore_nulls":
            fn = TW.NthValue(tcol("oi"), 2, ignore_nulls=True)
        elif case == "range_offsets":
            fn = TF.sum("oi")
            w = w.range_between(-1, 0)
        df.with_windows(r=fn.over(w)).collect_table()


@pytest.mark.parametrize("query, table, columns", [
    ("q21", "customer", ("c_custkey", "c_name", "c_nationkey",
                         "c_acctbal")),
    ("q7", "lineitem", ("l_orderkey", "l_quantity", "l_extendedprice",
                        "l_discount", "l_returnflag", "l_linestatus",
                        "l_shipdate")),
])
def test_pruning_keeps_a_window_or_an_exchange_whole(query, table, columns):
    """Column pruning stops at a window and at an exchange (the
    reference's conservative default): the scan below uploads every
    column, and q21's pruning Project above the window keeps its filter
    from planning a group limit, as in the reference."""
    from spark_rapids_tpu_torch.execs.basic import TpuScanExec
    from spark_rapids_tpu_torch.execs.window import TpuWindowGroupLimitExec
    from spark_rapids_tpu_torch.models import corpus as tcorpus
    from spark_rapids_tpu_torch.overrides.rules import convert
    s = TorchSession(device="cpu")
    tabs = tcorpus.corpus_tables(0.001, 0)
    root = convert(tcorpus.build_queries(s, tabs)[query]().plan, s.conf,
                   s.device)
    stack, execs = [root], []
    while stack:
        e = stack.pop()
        execs.append(e)
        stack.extend(e.children)
    scans = [e for e in execs if isinstance(e, TpuScanExec)]
    assert len(scans) == 1
    assert tuple(n for n, _ in scans[0].output_schema()) == columns
    assert not any(isinstance(e, TpuWindowGroupLimitExec) for e in execs)
