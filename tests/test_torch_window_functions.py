"""Every window function and frame of the port over one batch
(execs/window.py ``_window``), against the JAX package's TpuSession on the
same numpy inputs: lag, lead, nth_value, percent_rank and the SUM, COUNT,
MIN, MAX and AVG windows over whole, running (ROWS and RANGE) and bounded
ROWS frames, with nulls in keys and values, NaN and +-0.0 keys, empty edge
frames, the 512-row split of the bounded float sums, and what raises.

Comparators, each named by its test: ``scale_test.tables_differ``
(bitwise, in order: both packages keep the input's row order) for ranks,
offsets, nth_value, percent_rank, counts, integer sums, MIN/MAX and the
per-offset float sums of frames of 512 rows or fewer;
``scale_test.tables_close`` (rtol 1e-9) for the f64 sums that add in
another order (running, whole-partition, one-sided and wide frames), over
values of one sign so the rtol holds against the frame's mass."""

import numpy as np
import pytest
import torch

from scale_test import tables_close, tables_differ
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


class _Api:
    """One package's DataFrame entry, functions, Window and SortOrder."""

    def __init__(self, frm, F, W, SO, col, session, as_table):
        self.frm, self.F, self.W, self.SO = frm, F, W, SO
        self.col, self.session, self.as_table = col, session, as_table


def _apis(conf=None):
    return (_Api(jfrom, JF, JW.Window, JSortOrder, jcol, TpuSession(conf),
                 lambda a: _reference_table(*a)),
            _Api(tfrom, TF, TW.Window, TSortOrder, tcol,
                 TorchSession(conf, device="cpu"),
                 lambda a: host_table_from_arrays(*a)))


def _run_both(arrays, query, conf=None):
    """(port result, reference result) of ``query(api, df)`` over the
    same (names, types, arrays)."""
    japi, tapi = _apis(conf)
    ref = query(japi, japi.frm(japi.as_table(arrays),
                               japi.session)).collect_table()
    got = query(tapi, tapi.frm(tapi.as_table(arrays),
                               tapi.session)).collect_table()
    return _as_reference(got), ref


NEG_NAN = np.array([-0x0008000000000000], dtype=np.int64).view(
    np.float64)[0]


def _table(n=400, seed=5):
    """Partition keys with nulls (int, double with +-NaN and +-0.0,
    string), order keys with ties and nulls (int, double with NaN and
    -0.0), values with nulls: int ``vi``, positive double ``vd`` (no NaN:
    the MIN/MAX NaN rule is the deviation pinned below), string ``vs``,
    DECIMAL64 ``vm``, and the row number ``row``."""
    rng = np.random.default_rng(seed)

    def valid(share):
        return rng.random(n) > share

    pi = rng.integers(0, 6, n).astype(np.int32)
    pd = np.array([np.nan, NEG_NAN, 0.0, -0.0, 1.5, -np.inf])[
        rng.integers(0, 6, n)]
    ps = np.array(["a", "b", "", "é"], dtype=object)[rng.integers(0, 4, n)]
    oi = rng.integers(0, 9, n).astype(np.int32)
    od = np.round(rng.normal(size=n), 1)
    od[rng.random(n) < 0.05] = np.nan
    od[rng.random(n) < 0.05] = -0.0
    vi = rng.integers(-1000, 1000, n).astype(np.int64)
    vd = np.round(rng.uniform(1.0, 100.0, n), 3)
    vs = np.array(["x", "y", "zz", "w"], dtype=object)[rng.integers(0, 4, n)]
    vm = rng.integers(-99999, 99999, n).astype(np.int64)
    row = np.arange(n, dtype=np.int64)
    names = ["pi", "pd", "ps", "oi", "od", "vi", "vd", "vs", "vm", "row"]
    types = ["int", "double", "string", "int", "double", "bigint", "double",
             "string", "decimal(12,2)", "bigint"]
    arrays = [(pi, valid(0.1)), (pd, valid(0.1)), (ps, valid(0.1)),
              (oi, valid(0.1)), (od, valid(0.1)), (vi, valid(0.1)),
              (vd, valid(0.1)), (vs, valid(0.1)), (vm, valid(0.1)),
              (row, valid(0.0))]
    return names, types, arrays


#: (partition columns, [(order column, ascending, nulls_first or None)])
SPECS = {
    "int_by_int": (["pi"], [("oi", True, None)]),
    "int_by_int_desc_nulls_last": (["pi"], [("oi", False, False)]),
    "nan_zero_keys_by_double": (["pd"], [("od", True, None)]),
    "string_by_two_orders": (["ps"], [("oi", True, None),
                                      ("od", False, True)]),
    "no_partition": ([], [("oi", True, None), ("row", True, None)]),
}


def _spec(api, parts, orders):
    w = api.W.order_by(*[api.SO(api.col(c), asc, nf)
                         for c, asc, nf in orders])
    return w.partition_by(*parts) if parts else w


@pytest.mark.parametrize("name", sorted(SPECS))
def test_functions_match_reference_bitwise(name):
    """percent_rank, lag, lead (a numeric default, a string value),
    nth_value, and the running (RANGE, the default) COUNT, integer SUM
    and MIN/MAX over one spec, with ties, nulls and NaN/+-0.0 keys
    (tables_differ)."""
    parts, orders = SPECS[name]

    def q(api, df):
        w = _spec(api, parts, orders)
        F = api.F
        return df.with_windows(
            pr=F.percent_rank().over(w), lg=F.lag("vd").over(w),
            ld=F.lead("vs", 2).over(w), lgd=F.lag("vi", 3, -7).over(w),
            ldm=F.lead("vm", 1).over(w), nv=F.nth_value("vs", 2).over(w),
            nv5=F.nth_value("row", 5).over(w), c=F.count("vd").over(w),
            cs=F.count().over(w),
            s=F.sum("vi").over(w), mn=F.min("vs").over(w),
            mx=F.max("vd").over(w), mm=F.min("vm").over(w))

    got, ref = _run_both(_table(), q)
    assert tables_differ(got, ref) is None


#: bounded and whole ROWS frames: (lo, hi); None = unbounded
FRAMES = {
    "around": (-2, 3),
    "preceding_only": (-3, -1),   # empty at each partition's first row
    "following_only": (1, 4),     # empty at each partition's last row
    "to_end": (2, None),
    "from_start": (None, 2),
    "whole": (None, None),
    "running_rows": (None, 0),
    "wide_513": (-256, 256),      # 513 rows: prefix difference
    "unrolled_512": (-255, 256),  # 512 rows: offset by offset
}


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_frames_match_reference(frame):
    """COUNT, integer SUM and MIN/MAX bitwise over each frame
    (tables_differ); the float AVG bitwise where the port adds offset by
    offset in the reference's order (a frame of 512 rows or fewer), else
    within rtol 1e-9 (tables_close), and a decimal AVG within rtol 1e-9
    (tables_close)."""
    lo, hi = FRAMES[frame]

    def q(api, df):
        w = _spec(api, ["pi"], [("oi", True, None), ("row", True, None)])
        w = w.rows_between(lo, hi)
        F = api.F
        return df.with_windows(c=F.count("vi").over(w), s=F.sum("vi").over(w),
                               mn=F.min("vi").over(w), mx=F.max("vd").over(w),
                               ms=F.max("vs").over(w), a=F.avg("vd").over(w),
                               ad=F.avg("vm").over(w))

    arrays = _table(1400 if frame.startswith(("wide", "unrolled")) else 400)
    got, ref = _run_both(arrays, q)
    assert tables_differ(_cols(got, "row", "c", "s", "mn", "mx", "ms"),
                         _cols(ref, "row", "c", "s", "mn", "mx", "ms")) is None
    if lo is not None and hi is not None and hi - lo + 1 <= 512:
        assert tables_differ(_cols(got, "row", "a"),
                             _cols(ref, "row", "a")) is None
    else:
        assert tables_close(_cols(got, "row", "a"), _cols(ref, "row", "a"),
                            rtol=1e-9) is None
    # AVG of a DECIMAL64 casts it to DOUBLE at bind; the reference's cast
    # multiplies by the reciprocal of 10^scale (an ulp off; the port's
    # divides), so those averages are held within rtol 1e-9
    assert tables_close(_cols(got, "row", "ad"), _cols(ref, "row", "ad"),
                        rtol=1e-9) is None


def _cols(t, *names) -> JHostTable:
    """The columns ``names`` of a reference-form table (tables_close
    compares no NaN, so the NaN keys stay out)."""
    return JHostTable(list(names), [t.columns[t.names.index(n)]
                                    for n in names])


def test_float_sums_over_running_and_whole_frames():
    """f64 SUM and AVG over the running RANGE frame (peers tied on the
    order key), the running ROWS frame and the whole partition, also with
    no PARTITION BY (tables_close, rtol 1e-9: the port's doubling scans
    add in another order)."""
    def q(api, df):
        w = _spec(api, ["ps"], [("oi", True, None)])
        g = _spec(api, [], [("oi", False, None)])
        F = api.F
        return df.with_windows(
            r=F.sum("vd").over(w), rr=F.sum("vd").over(w.rows_between(None, 0)),
            wh=F.avg("vd").over(api.W.partition_by("ps")),
            g=F.sum("vd").over(g), ga=F.avg("vi").over(g))

    got, ref = _run_both(_table(), q)
    names = ("row", "r", "rr", "wh", "g", "ga")
    assert tables_close(_cols(got, *names), _cols(ref, *names),
                        rtol=1e-9) is None


def test_columns_over_different_partition_keys():
    """Columns over three specs in one window node, one of them without
    PARTITION BY (the reference's coalesced one-batch window): one sort a
    spec, each column back in input row order (tables_differ)."""
    def q(api, df):
        a = _spec(api, ["pi"], [("oi", True, None)])
        b = _spec(api, ["ps"], [("od", False, True)])
        c = _spec(api, [], [("vi", True, None)])
        F = api.F
        return df.with_windows(ra=F.rank().over(a), lb=F.lag("vi").over(b),
                               dc=F.dense_rank().over(c),
                               nc=F.nth_value("vs", 3).over(c))

    got, ref = _run_both(_table(), q)
    assert tables_differ(got, ref) is None


def test_explicit_frame_on_a_ranking_function_is_ignored():
    """A ranking window ignores an explicit frame, as the reference does
    (tables_differ)."""
    def q(api, df):
        w = _spec(api, ["pi"], [("oi", True, None)]).rows_between(-1, 1)
        return df.with_windows(rn=api.F.row_number().over(w),
                               rk=api.F.rank().over(w))

    got, ref = _run_both(_table(), q)
    assert tables_differ(got, ref) is None


@pytest.mark.parametrize("case, conf, match", [
    ("rows_frame_max_bound",
     {"spark.rapids.sql.window.rowsFrameMaxBound": "4"}, "rowsFrameMaxBound"),
    ("variable_float_agg_off",
     {"spark.rapids.sql.variableFloatAgg.enabled": "false"},
     "variableFloatAgg"),
    ("decimal_sum", None, "SUM window over a decimal input"),
    ("decimal128_input", None, "decimal\\(>18\\) input"),
    ("first_window", None, "window function First"),
])
def test_gates_raise_naming_themselves(case, conf, match):
    """The reference's tag sends these to its CPU route. A frame bound past
    rowsFrameMaxBound and a float frame wider than 512 rows with
    variableFloatAgg off run on the port's CPU route too, equal to the
    reference's (``tables_differ``) and reported with the gate's reason;
    a SUM over a decimal (the reference raises IndexError on it:
    ``test_decimal_sum_window_raises_where_the_reference_fails``), a
    DECIMAL128 input and an aggregate the window has no route for raise
    NotImplementedError naming each."""
    def build(api, df):
        w = _spec(api, ["pi"], [("oi", True, None)])
        if case == "rows_frame_max_bound":
            return df.with_windows(x=api.F.sum("vi").over(
                w.rows_between(-5, 0)))
        if case == "variable_float_agg_off":
            return df.with_windows(x=api.F.avg("vd").over(
                w.rows_between(-300, 300)))
        if case == "decimal_sum":
            return df.with_windows(x=api.F.sum("vm").over(w))
        if case == "decimal128_input":
            return df.with_windows(x=api.F.max(api.col("vm").cast(
                "decimal(30,2)")).over(w))
        return df.with_windows(x=api.F.first("vi").over(w))

    if case in ("rows_frame_max_bound", "variable_float_agg_off"):
        from spark_rapids_tpu_torch.obs.events import collect_fallbacks
        japi, tapi = _apis(conf)
        arrays = _table(60)
        ref = build(japi, japi.frm(japi.as_table(arrays),
                                   japi.session)).collect_table()
        got = build(tapi, tapi.frm(tapi.as_table(arrays),
                                   tapi.session)).collect_table()
        assert tables_differ(_as_reference(got), ref) is None
        (fb,) = collect_fallbacks(tapi.session.last_meta)
        assert fb["op"] == "WindowNode" and any(
            match in r for r in fb["reasons"])
    else:
        api = _apis(conf)[1]
        df = api.frm(api.as_table(_table(60)), api.session)
        with pytest.raises(NotImplementedError, match=match):
            build(api, df).collect_table()
    if case == "variable_float_agg_off":
        # 512 rows sum offset by offset: no gate
        api = _apis(conf)[1]
        df = api.frm(api.as_table(_table(60)), api.session)
        w = _spec(api, ["pi"], [("oi", True, None)])
        df.with_windows(x=TF.avg("vd").over(
            w.rows_between(-255, 256))).collect_table()


def test_decimal_sum_window_raises_where_the_reference_fails():
    """Pins the decimal-window raise: the reference computes a SUM window
    over DECIMAL64 as a double and fails to download its decimal(22,2)
    column (IndexError); the port raises NotImplementedError naming it.
    MIN over the same column runs in both (tables_differ)."""
    def q(api, df, fn):
        w = _spec(api, ["pi"], [("oi", True, None)])
        return df.with_windows(x=getattr(api.F, fn)("vm").over(w))

    japi, tapi = _apis()
    arrays = _table(60)
    jdf = japi.frm(japi.as_table(arrays), japi.session)
    tdf = tapi.frm(tapi.as_table(arrays), tapi.session)
    with pytest.raises(IndexError):
        q(japi, jdf, "sum").collect_table()
    with pytest.raises(NotImplementedError, match="decimal input"):
        q(tapi, tdf, "sum").collect_table()
    assert tables_differ(_as_reference(q(tapi, tdf, "min").collect_table()),
                         q(japi, jdf, "min").collect_table()) is None


def _nan_table():
    """One partition's doubles with NaN and -0.0, another all NaN."""
    d = np.array([1.0, np.nan, 0.5, -0.0, 2.0, np.nan, np.nan])
    k = np.array([1, 1, 1, 1, 1, 2, 2], dtype=np.int32)
    o = np.arange(7, dtype=np.int32)
    ones = np.ones(7, bool)
    return (["k", "o", "d"], ["int", "int", "double"],
            [(k, ones), (o, ones), (d, ones)])


def test_window_min_max_nan_rule_deviation_from_the_reference():
    """Pins the deviation: the port's window MIN/MAX follow Spark's NaN
    rule (NaN above every double: MIN skips it unless the frame is all
    NaN, MAX is NaN once one is in the frame), as its GROUP BY MIN/MAX
    does, on every frame; the reference's ``jnp.minimum`` lets NaN
    propagate, so its running MIN over [1.0, NaN, 0.5] reads 1.0, NaN,
    NaN where Spark and the port read 1.0, 1.0, 0.5."""
    arrays = _nan_table()

    def q(api, df):
        w = _spec(api, ["k"], [("o", True, None)])
        F = api.F
        return df.with_windows(
            run=F.min("d").over(w), whole=F.min("d").over(
                api.W.partition_by("k")),
            bnd=F.min("d").over(w.rows_between(-1, 1)),
            mx=F.max("d").over(w.rows_between(None, 0)))

    got, ref = _run_both(arrays, q)
    nan = float("nan")
    want = {"run": [1.0, 1.0, 0.5, -0.0, -0.0, nan, nan],
            "whole": [-0.0] * 5 + [nan, nan],
            "bnd": [1.0, 0.5, -0.0, -0.0, -0.0, nan, nan],
            "mx": [1.0, nan, nan, nan, nan, nan, nan]}
    for name, values in want.items():
        col = got.columns[got.names.index(name)].data
        assert np.array_equal(col, np.array(values), equal_nan=True), name
        assert np.array_equal(np.signbit(col), np.signbit(values)), name
    # the reference's running MIN propagates the NaN
    assert np.isnan(ref.columns[ref.names.index("run")].data[1:3]).all()
    # the window MIN over the whole partition equals the GROUP BY MIN
    tapi = _apis()[1]
    grouped = tapi.frm(tapi.as_table(arrays), tapi.session).group_by(
        "k").agg(TF.min("d").alias("m")).sort("k").collect()
    assert str(grouped) == "[(1, -0.0), (2, nan)]"


def test_running_min_of_negative_zero_is_negative_zero_unlike_the_reference():
    """Pins the -0.0 deviation: a running MIN or MAX over the one-row
    frame {-0.0} is -0.0 in Spark and the port; the reference's device
    route gives 0.0, because ``jax.lax.associative_scan`` interleaves its
    partial results by adding zero padding (-0.0 + 0.0 is 0.0). Its
    whole-partition and bounded routes keep -0.0."""
    arrays = (["k", "o", "d"], ["int", "int", "double"],
              [(np.array([1], np.int32), np.ones(1, bool)),
               (np.array([1], np.int32), np.ones(1, bool)),
               (np.array([-0.0]), np.ones(1, bool))])

    def q(api, df):
        w = _spec(api, ["k"], [("o", True, None)])
        return df.with_windows(mn=api.F.min("d").over(w),
                               mx=api.F.max("d").over(w))

    got, ref = _run_both(arrays, q)
    for name in ("mn", "mx"):
        assert repr(got.columns[got.names.index(name)].to_pylist()) == \
            "[-0.0]"
        assert repr(ref.columns[ref.names.index(name)].to_pylist()) == "[0.0]"


def test_pruning_keeps_what_the_window_functions_read():
    """A projection above lag, lead, nth_value and aggregate windows over
    columns it drops: the scan still uploads every column a window reads
    (the window node is kept whole, as the reference's pruning keeps it),
    and the result is the reference's (tables_differ)."""
    from spark_rapids_tpu_torch.execs.basic import TpuScanExec
    from spark_rapids_tpu_torch.overrides.rules import convert

    def q(api, df):
        w = _spec(api, ["pi"], [("oi", True, None), ("row", True, None)])
        F = api.F
        return df.with_windows(
            lg=F.lag("vd").over(w), ld=F.lead("vs").over(w),
            nv=F.nth_value("vm", 2).over(w), s=F.sum("vi").over(w),
            c=F.count("od").over(w.rows_between(-1, 1))).select(
            "row", "lg", "ld", "nv", "s", "c")

    got, ref = _run_both(_table(), q)
    assert tables_differ(got, ref) is None
    tapi = _apis()[1]
    df = q(tapi, tapi.frm(tapi.as_table(_table()), tapi.session))
    root = convert(df.plan, tapi.session.conf, tapi.session.device)
    stack, scans = [root], []
    while stack:
        e = stack.pop()
        if isinstance(e, TpuScanExec):
            scans.append(e)
        stack.extend(e.children)
    read = {n for n, _ in scans[0].output_schema()}
    assert {"pi", "oi", "row", "vd", "vs", "vm", "vi", "od"} <= read
