"""Edge cases of the port's predicates, casts, coercion, sums, decimal
storage, moments and column pruning, each against the JAX package's
TpuSession on the same numpy inputs.

Comparators: ``scale_test.tables_differ`` (bitwise, in order) for
projections, sorts and exact aggregates; ``tables_differ_unordered`` (a
bitwise row multiset) for group-bys whose emission order the two packages
may choose differently; ``tables_close`` (rtol 1e-9) only where an f64
sum is involved (the moments)."""

import numpy as np
import pytest
import torch

from scale_test import tables_close, tables_differ, tables_differ_unordered
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.ops import predicates as JP
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.runtime import speculation as jspec
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch import types as TT
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.ops import predicates as TP
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.runtime import speculation as tspec
from spark_rapids_tpu_torch.session import TorchSession

I64_MAX, I64_MIN = 2 ** 63 - 1, -2 ** 63


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


class _Api:
    """One package's DataFrame entry, functions and predicate classes."""

    def __init__(self, frm, F, P, session):
        self.frm, self.F, self.P, self.session = frm, F, P, session

    def df(self, table):
        return self.frm(table, self.session)


def _as_reference(t) -> JHostTable:
    names, types, arrays = t.to_arrays()
    return _reference_table(names, types, arrays)


def _reference_table(names, types, arrays) -> JHostTable:
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, np.asarray(v, dtype=bool))
        for ty, (d, v) in zip(types, arrays)])


def _run_both(arrays_of_table, query, conf=None):
    """(port result, reference result) of ``query(api, table)`` over the
    same (names, types, arrays)."""
    ref = query(_Api(jfrom, JF, JP, TpuSession(conf)),
                _reference_table(*arrays_of_table)).collect_table()
    got = query(_Api(tfrom, TF, TP, TorchSession(conf, device="cpu")),
                host_table_from_arrays(*arrays_of_table)).collect_table()
    return _as_reference(got), ref


# ---------------------------------------------------------------------------
# predicates over null, NaN, +-0.0 and +-inf
# ---------------------------------------------------------------------------

def _special_doubles():
    f = np.array([1.5, np.nan, -0.0, 0.0, np.inf, -np.inf, -2.0, 0.0,
                  np.nan, 3.0, -np.inf, 7.0])
    g = np.array([1.5, np.nan, 0.0, -0.0, np.inf, np.inf, np.nan, 1.0,
                  0.0, -1.0, -np.inf, 7.0])
    fv = np.array([1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1], dtype=bool)
    gv = np.array([1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1], dtype=bool)
    k = np.arange(12, dtype=np.int64) - 3
    kv = np.array([1, 1, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1], dtype=bool)
    b = np.array([1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 0, 0], dtype=bool)
    bv = np.array([1, 1, 1, 1, 0, 0, 0, 1, 1, 1, 1, 0], dtype=bool)
    return (["f", "g", "k", "b"], ["double", "double", "bigint", "boolean"],
            [(f, fv), (g, gv), (k, kv), (b, bv)])


@pytest.mark.parametrize("case", [
    "ge", "ge_lit", "ne", "ne_lit", "eq_null_safe", "or", "not", "and_or",
    "isnull", "isnotnull", "isnan", "in", "in_null", "in_long",
    "le_lt_gt"])
def test_predicates_match_reference(case):
    def q(api, t):
        c, lit, F, P = api.F.col, api.F.lit, api.F, api.P
        e = {
            "ge": c("f") >= c("g"),
            "ge_lit": c("f") >= lit(0.0),
            "ne": c("f") != c("g"),
            "ne_lit": c("k") != lit(2),
            "eq_null_safe": P.EqualNullSafe(c("f"), c("g")),
            "or": c("b") | (c("k") > lit(3)),
            "not": ~c("b"),
            "and_or": (c("b") & (c("f") > lit(0.0))) | ~(c("k") >= lit(1)),
            "isnull": F.isnull(c("f")),
            "isnotnull": c("k").isnotnull(),
            "isnan": F.isnan(c("g")),
            "in": P.In(c("f"), [lit(0.0), lit(float("nan")), lit(7.0),
                                lit(float("-inf"))]),
            "in_null": P.In(c("k"), [lit(2), lit(None), lit(5)]),
            "in_long": P.In(c("k"), [lit(-3), lit(0), lit(8)]),
            "le_lt_gt": (c("f") <= c("g")) | ((c("f") < lit(1.0))
                                              & (c("g") > lit(-1.0))),
        }[case]
        return api.df(t).select(e.alias("p"), c("k"))

    got, ref = _run_both(_special_doubles(), q)
    assert tables_differ(got, ref) is None
    # the same predicate as a filter keeps the rows where it is true
    def filtered(api, t):
        out = q(api, t)
        return out.filter(api.F.col("p"))

    got, ref = _run_both(_special_doubles(), filtered)
    assert tables_differ(got, ref) is None


def test_string_equality_and_in_over_a_dictionary():
    names = np.array(["b", "a", None, "c", "a", "zz", "b"], dtype=object)
    valid = np.array([1, 1, 0, 1, 1, 1, 1], dtype=bool)
    arrays = (["s", "k"], ["string", "bigint"],
              [(names, valid), (np.arange(7, dtype=np.int64), np.ones(7))])

    def q(api, t):
        c, lit, P = api.F.col, api.F.lit, api.P
        return api.df(t).select(
            (c("s") == lit("a")).alias("eq"), (c("s") != lit("b")).alias("ne"),
            P.In(c("s"), [lit("c"), lit("zz"), lit("nope")]).alias("in"),
            P.EqualNullSafe(c("s"), lit("a")).alias("ns"), c("k"))

    got, ref = _run_both(arrays, q)
    assert tables_differ(got, ref) is None


# ---------------------------------------------------------------------------
# casts and coercion
# ---------------------------------------------------------------------------

def _cast_table():
    i32 = np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 1234567, -99, 42],
                   dtype=np.int32)
    i64 = np.array([0, 2 ** 40 + 7, -2 ** 40, I64_MAX, I64_MIN, 99999,
                    123456789012, -5], dtype=np.int64)
    f64 = np.array([0.5, -0.5, 1.999, -2.5, np.nan, np.inf, -np.inf, 1e19])
    d12 = np.array([0, 12345, -12345, 999999999999, -999999999999, 50, -51,
                    449], dtype=np.int64)
    d30 = np.array([0, 10 ** 29 - 1, -(10 ** 29) + 1, 2 ** 64 + 12345,
                    -(2 ** 70), 5, -15, 123456789], dtype=object)
    v = np.array([1, 1, 1, 1, 1, 1, 0, 1], dtype=bool)
    return (["i", "l", "f", "d", "w"],
            ["int", "bigint", "double", "decimal(12,2)", "decimal(30,4)"],
            [(i32, v), (i64, v), (f64, v), (d12, v), (d30, v)])


@pytest.mark.parametrize("src,dst", [
    ("i", "bigint"), ("l", "int"), ("l", "double"), ("i", "double"),
    ("f", "int"), ("f", "bigint"), ("f", "float"), ("i", "decimal(12,2)"),
    ("l", "decimal(12,2)"), ("i", "decimal(18,0)"), ("d", "double"),
    ("d", "bigint"), ("d", "int"), ("d", "decimal(12,4)"),
    ("d", "decimal(10,0)"), ("d", "decimal(18,6)"), ("d", "decimal(11,1)"),
    ("w", "double"), ("l", "boolean"), ("f", "boolean")])
def test_casts_match_reference(src, dst):
    """Integral narrowing wraps, doubles truncate and saturate (NaN to 0),
    decimals rescale HALF_UP and overflow to null, DECIMAL128 to double
    through its two limbs."""
    def q(api, t):
        c = api.F.col
        return api.df(t).select(c(src).cast(dst).alias("x"))

    got, ref = _run_both(_cast_table(), q)
    assert got.columns[0].dtype.simple_string() == \
        ref.columns[0].dtype.simple_string()
    assert tables_differ(got, ref) is None


def test_dec128_to_double_keeps_small_negatives():
    """A deliberate deviation: the reference casts DECIMAL128 to double as
    hi * 2^64 + lo, which cancels for small negatives (-5 at decimal(30,2)
    is hi = -1, lo = 2^64 - 5, and gives 0.0; -123.45 gives -122.88). The port casts by sign and
    magnitude, so every value below 2^53 is the correctly rounded
    quotient; values the reference gets right match it."""
    d = np.array([-5, -1, -12345, 5, 12345, -(2 ** 70), 10 ** 29 - 1],
                 dtype=object)
    arrays = (["w"], ["decimal(30,2)"], [(d, np.ones(len(d), dtype=bool))])

    def q(api, t):
        return api.df(t).select(api.F.col("w").cast("double").alias("x"))

    got, ref = _run_both(arrays, q)
    got, ref = got.columns[0].to_pylist(), ref.columns[0].to_pylist()
    assert got[:5] == [-0.05, -0.01, -123.45, 0.05, 123.45]
    assert got[:5] == [int(v) / 100 for v in d[:5]]
    assert ref[:3] == [0.0, 0.0, -122.88]  # the reference's cancellation
    assert got[3:] == ref[3:]


def test_decimal_rescale_overflow_gives_null():
    def q(api, t):
        return api.df(t).select(api.F.col("d").cast("decimal(12,4)")
                                .alias("x"))

    got, _ = _run_both(_cast_table(), q)
    # 8 integer digits fit; the 10-digit values overflow to null
    assert got.columns[0].to_pylist() == [0, 1234500, -1234500, None, None,
                                          5000, None, 44900]


@pytest.mark.parametrize("case", ["double_over_bigint", "bigint_over_zero",
                                  "double_over_zero", "int_plus_bigint",
                                  "bigint_times_double", "decimal_times_double",
                                  "int_minus_int_wraps"])
def test_arithmetic_coercion_matches_reference(case):
    def q(api, t):
        c, lit = api.F.col, api.F.lit
        e = {
            "double_over_bigint": c("f") / c("l"),
            "bigint_over_zero": c("l") / lit(0),
            "double_over_zero": c("f") / lit(0.0),
            "int_plus_bigint": c("i") + c("l"),
            "bigint_times_double": c("l") * lit(0.5),
            "decimal_times_double": lit(0.5) * c("d"),
            "int_minus_int_wraps": c("i") - lit(2 ** 31 - 1),
        }[case]
        return api.df(t).select(e.alias("x"))

    got, ref = _run_both(_cast_table(), q)
    assert tables_differ(got, ref) is None


@pytest.mark.parametrize("case", ["unscaled", "make", "make_overflow",
                                  "check_down", "check_up_overflow"])
def test_decimal_expressions_match_reference(case):
    """UnscaledValue, MakeDecimal (null past the precision) and
    CheckOverflow (HALF_UP, null on overflow). One deliberate deviation:
    the reference's MakeDecimal bounds ``abs(v)``, which wraps at
    INT64_MIN, so it keeps that value as a decimal(10,0); the port nulls
    it, as Spark does (any value of 11 or more digits overflows)."""
    from spark_rapids_tpu.ops import decimal as jdec
    from spark_rapids_tpu_torch.ops import decimal as tdec

    def q(api, t):
        dec = jdec if api.frm is jfrom else tdec
        c = api.F.col
        DT = (JT if api.frm is jfrom else TT).DecimalType
        e = {
            "unscaled": dec.UnscaledValue(c("d")),
            "make": dec.MakeDecimal(c("i"), 12, 2),
            "make_overflow": dec.MakeDecimal(c("l"), 10, 0),
            "check_down": dec.CheckOverflow(c("d"), DT(11, 1)),
            "check_up_overflow": dec.CheckOverflow(c("d"), DT(14, 4)),
        }[case]
        return api.df(t).select(e.alias("x"))

    got, ref = _run_both(_cast_table(), q)
    if case == "make_overflow":
        row = 4  # the INT64_MIN row
        assert ref.columns[0].to_pylist()[row] == I64_MIN
        assert got.columns[0].to_pylist()[row] is None
        keep = [i for i in range(got.num_rows) if i != row]
        got, ref = (JHostTable(["x"], [JHostColumn(
            t.columns[0].dtype, t.columns[0].data[keep],
            t.columns[0].validity[keep])]) for t in (got, ref))
    assert tables_differ(got, ref) is None


# ---------------------------------------------------------------------------
# integer and decimal sums at their edges
# ---------------------------------------------------------------------------

def _edge_sums(sparse):
    k = np.array([0, 0, 1, 1, 2, 2, 3, 4, 4, 5], dtype=np.int64)
    if sparse:
        k = (k * 0x9E3779B1) & ((1 << 40) - 1)
    kv = np.ones(10, dtype=bool)
    kv[9] = False
    l = np.array([I64_MAX, 1, I64_MIN, -1, I64_MAX, I64_MAX, 5, I64_MIN,
                  I64_MIN, 3], dtype=np.int64)
    big = 6 * 10 ** 37
    d38 = np.array([big, big, -big, -big, 10 ** 38 - 1, 10 ** 38 - 1, 7,
                    10 ** 38 - 1, -(10 ** 38) + 1, 1], dtype=object)
    d12 = np.array([999999999999] * 10, dtype=np.int64)
    v = np.ones(10, dtype=bool)
    v[6] = False
    return (["k", "l", "d38", "d12"],
            ["bigint", "bigint", "decimal(38,0)", "decimal(12,2)"],
            [(k, kv), (l, v), (d38, v), (d12, v)])


@pytest.mark.parametrize("layout", ["no-sort", "sort-segment", "global"])
def test_int64_and_decimal_sums_at_the_edges(layout):
    """An int64 SUM wraps (two's complement); a DECIMAL(38, 0) SUM that
    leaves 38 digits, or 128 bits, is null; decimal(12,2) sums to
    decimal(22,2) (DECIMAL128) exactly; AVG(decimal) is a double."""
    def q(api, t):
        F = api.F
        aggs = [F.sum("l").alias("sl"), F.sum("d38").alias("s38"),
                F.sum("d12").alias("s12"), F.avg("d12").alias("a12"),
                F.count("l").alias("n")]
        df = api.df(t)
        if layout == "global":
            return df.agg(*aggs)
        return df.group_by("k").agg(*aggs)

    got, ref = _run_both(_edge_sums(layout == "sort-segment"), q)
    assert tables_differ_unordered(got, ref) is None
    assert [c.dtype.simple_string() for c in got.columns][-4:-1] == \
        ["decimal(38,0)", "decimal(22,2)", "double"]
    if layout == "no-sort":
        rows = {r[0]: r for r in zip(*[c.to_pylist() for c in got.columns])}
        assert rows[0][1] == I64_MIN            # MAX + 1 wraps
        assert rows[1][1] == I64_MAX            # MIN - 1 wraps
        assert rows[0][2] is None               # 1.2e38 >= 10^38
        assert rows[1][2] is None               # -1.2e38
        assert rows[2][2] is None               # past 2^127
        assert rows[3][1:3] == (None, None)     # the only value is null
        assert rows[4][2] == 0                  # (10^38 - 1) - (10^38 - 1)
        assert rows[0][3] == 2 * 999999999999   # DECIMAL128 storage


def test_decimal128_upload_download_and_sort():
    vals = np.array([5, -(2 ** 70), 2 ** 64, -1, 0, 10 ** 29, 2 ** 64 - 1,
                     -(2 ** 64), 123, -(10 ** 29)], dtype=object)
    v = np.ones(10, dtype=bool)
    v[4] = False
    arrays = (["w", "i"], ["decimal(30,2)", "int"],
              [(vals, v), (np.arange(10, dtype=np.int32), np.ones(10))])

    for asc in (True, False):
        def q(api, t):
            return api.df(t).sort("w", ascending=asc)

        got, ref = _run_both(arrays, q)
        assert tables_differ(got, ref) is None

    def roundtrip(api, t):
        return api.df(t).select("w", "i")

    got, ref = _run_both(arrays, roundtrip)
    assert tables_differ(got, ref) is None
    assert got.columns[0].to_pylist() == [
        None if i == 4 else int(x) for i, x in enumerate(vals)]


@pytest.mark.parametrize("keys", ["dense", "sparse"])
def test_decimal_columns_through_joins_and_concat(keys):
    """DECIMAL64 and DECIMAL128 columns on both sides of a join (dense
    keys: the direct join; sparse: the hash probe after a replay), the
    build side in two batches (concatenated on the device)."""
    rng = np.random.default_rng(5)
    n = 600
    k = np.arange(n, dtype=np.int64)
    if keys == "sparse":
        k = (k * 0x9E3779B1) & ((1 << 40) - 1)
    wide = np.array([int(x) * (2 ** 66) - 7 for x in
                     rng.integers(-1000, 1000, n)], dtype=object)
    narrow = rng.integers(-10 ** 11, 10 ** 11, n).astype(np.int64)
    v = rng.random(n) > 0.1
    build = (["k", "w", "d"], ["bigint", "decimal(30,2)", "decimal(12,2)"],
             [(k, np.ones(n, dtype=bool)), (wide, v), (narrow, v)])
    probe_k = k[rng.integers(0, n, 2 * n)]
    probe = (["k", "pw"], ["bigint", "decimal(38,4)"],
             [(probe_k, np.ones(2 * n, dtype=bool)),
              (np.array([int(x) << 70 for x in rng.integers(-9, 9, 2 * n)],
                        dtype=object), np.ones(2 * n, dtype=bool))])
    ref_b, ref_p = _reference_table(*build), _reference_table(*probe)
    got_b, got_p = host_table_from_arrays(*build), host_table_from_arrays(
        *probe)

    def q(frm, sess, p, b):
        return frm(p, sess).join(frm(b, sess, num_batches=2), on=["k"])

    ref = q(jfrom, TpuSession(), ref_p, ref_b).collect_table()
    got = _as_reference(q(tfrom, TorchSession(device="cpu"), got_p,
                          got_b).collect_table())
    assert got.num_rows == 2 * n
    assert tables_differ_unordered(got, ref) is None


# ---------------------------------------------------------------------------
# variance and stddev
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["no-sort", "sort-segment"])
def test_moments_with_groups_of_zero_one_and_many_rows(layout):
    rng = np.random.default_rng(3)
    n = 400
    k = rng.integers(0, 6, n).astype(np.int64)
    f = rng.standard_normal(n) * 100 + 5
    fv = np.ones(n, dtype=bool)
    fv[k == 5] = False                       # group 5: no value
    one = np.flatnonzero(k == 4)
    fv[one[1:]] = False                      # group 4: one value
    d = rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int64)
    if layout == "sort-segment":
        k = (k * 0x9E3779B1) & ((1 << 40) - 1)
    arrays = (["k", "f", "d"], ["bigint", "double", "decimal(12,2)"],
              [(k, np.ones(n, dtype=bool)), (f, fv), (d, fv)])

    def q(api, t):
        F = api.F
        return api.df(t).group_by("k").agg(
            F.var_pop("f").alias("vp"), F.variance("f").alias("vs"),
            F.stddev_pop("f").alias("sp"), F.stddev("f").alias("ss"),
            F.variance("d").alias("vd"), F.count("f").alias("n"))

    got, ref = _run_both(arrays, q)
    assert tables_close(got, ref, rtol=1e-9) is None
    cols = {nm: c.to_pylist() for nm, c in zip(got.names, got.columns)}
    by_n = dict(zip(cols["n"], zip(cols["vp"], cols["vs"])))
    assert by_n[0] == (None, None)
    assert by_n[1] == (0.0, None)


# ---------------------------------------------------------------------------
# boolean group keys (the sort-segment path in the port)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keys", [("b",), ("b", "k")])
def test_boolean_group_keys_match_reference(keys):
    """The reference gives boolean keys a three-slot no-sort layout; the
    port groups them on its sort-segment path. Same rows."""
    rng = np.random.default_rng(11)
    n = 5000
    b = rng.random(n) > 0.5
    bv = rng.random(n) > 0.1
    k = rng.integers(0, 7, n).astype(np.int64)
    kv = rng.random(n) > 0.05
    x = rng.standard_normal(n)
    arrays = (["b", "k", "x"], ["boolean", "bigint", "double"],
              [(b, bv), (k, kv), (x, np.ones(n, dtype=bool))])

    def q(api, t):
        F = api.F
        return api.df(t).group_by(*keys).agg(
            F.count("x").alias("n"), F.min("x").alias("lo"),
            F.max("x").alias("hi"))

    got, ref = _run_both(arrays, q)
    assert tables_differ_unordered(got, ref) is None


# ---------------------------------------------------------------------------
# column pruning
# ---------------------------------------------------------------------------

_PRUNED_SCANS = {
    # query: {table prefix: the column lists of its scans, sorted}
    "q4": {"c": [["c_custkey", "c_nationkey"]],
           "o": [["o_orderkey", "o_custkey"]],
           "l": [["l_orderkey", "l_extendedprice"]]},
    "q16": {"o": [["o_custkey"]], "c": [["c_custkey", "c_nationkey"]]},
    "q20": {"o": [["o_custkey", "o_totalprice"]],
            "c": [["c_custkey", "c_name", "c_acctbal"]]},
    "q22": {"c": [["c_acctbal"], ["c_custkey", "c_nationkey", "c_acctbal"]]},
}


@pytest.mark.parametrize("qname", sorted(_PRUNED_SCANS))
def test_pruning_uploads_only_the_columns_q4_reads(qname):
    """Each query's pruned plan scans only the columns it reads (q4:
    c_custkey and c_nationkey of customer; q16, q20 and q22 carry c_name
    and c_acctbal), the root's schema is unchanged, and a run uploads
    exactly those columns of customer."""
    from spark_rapids_tpu_torch.execs.basic import TpuScanExec
    from spark_rapids_tpu_torch.models import corpus as tcorpus
    from spark_rapids_tpu_torch.overrides.pruning import prune_plan
    from spark_rapids_tpu_torch.plan import nodes as P

    tabs = tcorpus.corpus_tables(0.02, 0)
    sess = TorchSession(device="cpu")
    df = tcorpus.build_queries(sess, tabs)[qname]()
    pruned = prune_plan(df.plan)
    assert pruned.output_schema() == df.plan.output_schema()

    def scans(node):
        if isinstance(node, P.LocalScan):
            yield node
        for c in node.children:
            yield from scans(c)

    by_table = {}
    for s in scans(pruned):
        names = [n for n, _ in s.output_schema()]
        by_table.setdefault(s.batches[0].names[0].split("_")[0],
                            []).append(names)
    assert {t: sorted(v) for t, v in by_table.items()} == \
        _PRUNED_SCANS[qname]

    df.collect_table()
    execs, stack = [], [sess._last_root]
    while stack:
        e = stack.pop()
        execs.append(e)
        stack.extend(e.children)
    cust_scans = sorted([n for n, _ in e.output_schema()] for e in execs
                        if isinstance(e, TpuScanExec)
                        and e.batches[0] is tabs["customer"])
    assert cust_scans == _PRUNED_SCANS[qname]["c"]
    read = {n for cols in _PRUNED_SCANS[qname]["c"] for n in cols}
    uploaded = {n for n, c in zip(tabs["customer"].names,
                                  tabs["customer"].columns) if c._cache}
    assert uploaded == read
