"""The port's math functions (``ops/math.py``), hashes (``ops/hashfns.py``:
XxHash64, HiveHash, Spark's byte hash of a DECIMAL128), float32 sort keys
(``ops/ordering.py``) and the rest of ``ops/misc.py`` (rand, ids,
normalization, null guards) against the JAX package's ``TpuSession`` on
the same numpy inputs.

Comparators: ``scale_test.tables_differ`` (bitwise, in order) for ceil,
floor, round, bround, sqrt, rint, signum, the bitwise operators, shifts,
hashes, sorts and misc (the rounding group's NaNs compared as NaN, not
by sign and payload); the transcendental functions (``TRANSCENDENTAL``)
within 2 ulp per value, nulls equal. The rounding functions and the
transcendental ones hold against the reference's CPU route (numpy: IEEE
division and sqrt, libm), since its XLA route on the CPU is itself an
ulp off for a division by a constant and sqrt, and hundreds of ulp off
for sinh and cosh of large arguments."""

import numpy as np
import pytest
import torch

from scale_test import tables_differ
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.ops import hashfns as JH
from spark_rapids_tpu.ops import math as JM
from spark_rapids_tpu.ops import misc as JMI
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.ops.expr import lit as jlit
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.ops import hashfns as TH
from spark_rapids_tpu_torch.ops import math as TM
from spark_rapids_tpu_torch.ops import misc as TMI
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.ops.expr import lit as tlit
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.session import TorchSession

N = 200


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _table(seed=9):
    """x: doubles (edges, then seeded over many magnitudes, both signs); f:
    floats; i: ints; l: longs; c: shift counts; b: bools; s: strings (long
    ones too); d: dates; t: timestamps; p: DECIMAL64; q: DECIMAL128."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(N) * 10.0 ** rng.integers(-3, 7, N)
    x[:14] = [0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 2.5, -2.5, 1e300, -1e-300,
              np.nan, np.inf, -np.inf, 123.455]
    with np.errstate(over="ignore"):  # 1e300 -> inf
        f = x.astype(np.float32)
    i = rng.integers(-2 ** 31, 2 ** 31, N).astype(np.int32)
    i[:4] = [0, -1, 2 ** 31 - 1, -2 ** 31]
    lg = rng.integers(-2 ** 63, 2 ** 63 - 1, N, dtype=np.int64)
    lg[:4] = [0, -1, 2 ** 63 - 1, -2 ** 63]
    c = rng.integers(-70, 70, N).astype(np.int32)
    b = rng.random(N) < 0.5
    words = ["", "a", "abcd", "abcde", "x" * 31, "y" * 32, "z" * 33,
             "mixed Ünïcode ✓", "the quick brown fox jumps over it all"]
    s = np.array([words[k % len(words)] + str(k % 7) * (k % 3)
                  for k in range(N)], dtype=object)
    d = rng.integers(-30000, 40000, N).astype(np.int32)
    t = rng.integers(-2 ** 50, 2 ** 50, N).astype(np.int64)
    p = rng.integers(-10 ** 15, 10 ** 15, N).astype(np.int64)
    q = np.array([int(v) * 10 ** 18 + int(w) for v, w in zip(
        rng.integers(-10 ** 18, 10 ** 18, N),
        rng.integers(0, 10 ** 18, N))], dtype=object)
    q[:6] = [0, 1, -1, 10 ** 38 - 1, -(10 ** 38 - 1), -128]
    ones = np.ones(N, bool)
    valid = ones.copy()
    valid[11::13] = False
    cols = {"x": ("double", x), "f": ("float", f), "i": ("int", i),
            "l": ("bigint", lg), "c": ("int", c), "b": ("boolean", b),
            "s": ("string", s), "d": ("date", d), "t": ("timestamp", t),
            "p": ("decimal(15,2)", p), "q": ("decimal(38,4)", q)}
    return (list(cols), [ty for ty, _ in cols.values()],
            [(v, valid if k in ("x", "s", "q") else ones)
             for k, (_, v) in cols.items()])


def _as_reference(names, types, arrays) -> JHostTable:
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, np.asarray(v, dtype=bool))
        for ty, (d, v) in zip(types, arrays)])


class _Api:
    def __init__(self, F, M, H, MI, col, lit):
        self.F, self.M, self.H, self.MI = F, M, H, MI
        self.col, self.lit = col, lit


PORT = _Api(TF, TM, TH, TMI, tcol, tlit)
REF = _Api(JF, JM, JH, JMI, jcol, jlit)


def _run(build, table=None, reference_cpu=False):
    """(port result, reference result) of ``build(api, df)``; with
    ``reference_cpu`` the reference runs on its CPU route (numpy)."""
    table = table or _table()
    conf = {"spark.rapids.sql.enabled": "false"} if reference_cpu else None
    ref = build(REF, jfrom(_as_reference(*table), TpuSession(conf))
                ).collect_table()
    got = build(PORT, tfrom(host_table_from_arrays(*table),
                            TorchSession(device="cpu"))).collect_table()
    return _as_reference(*got.to_arrays()), ref


def _select_both(exprs, reference_cpu=False):
    return _run(lambda a, df: df.select(
        *[e.alias(n) for n, e in exprs(a)]), reference_cpu=reference_cpu)


EXACT = {
    "rounding": lambda a: [
        ("ceil", a.F.ceil("x")), ("floor", a.F.floor("x")),
        ("ceil_i", a.F.ceil("i")), ("r2", a.F.round("x", 2)),
        ("r0", a.F.round("x")), ("rm2", a.F.round("x", -2)),
        ("br1", a.F.bround("x", 1)), ("br_2", a.F.bround("x", -2)),
        ("ri", a.F.round("i", -2)), ("rf", a.F.round("f", 1)),
        ("sqrt", a.F.sqrt("x")), ("rint", a.M.Rint(a.col("x"))),
        ("deg", a.M.ToDegrees(a.col("x"))),
        ("rc", a.M.RoundCeil(a.col("x"), a.lit(1))),
        ("rfl", a.M.RoundFloor(a.col("l"), a.lit(-3))),
        ("rci", a.M.RoundCeil(a.col("i"), a.lit(-2)))],
    # Java's signum keeps -0.0 (the reference's device route; numpy's
    # sign, its CPU route, gives 0.0)
    "signum": lambda a: [("sign", a.F.signum("x"))],
    "bitwise": lambda a: [
        ("and", a.M.BitwiseAnd(a.col("l"), a.col("i"))),
        ("or", a.M.BitwiseOr(a.col("i"), a.col("c"))),
        ("xor", a.M.BitwiseXor(a.col("l"), a.col("l"))),
        ("not", a.M.BitwiseNot(a.col("i"))),
        ("shl", a.F.shiftleft("i", "c")), ("shr", a.F.shiftright("l", "c")),
        ("shl3", a.F.shiftleft(a.col("l"), a.lit(3))),
        ("ushr", a.M.ShiftRightUnsigned(a.col("i"), a.col("c"))),
        ("ushrl", a.M.ShiftRightUnsigned(a.col("l"), a.col("c")))],
    "xxhash64": lambda a: [
        ("xx", a.F.xxhash64("i", "l", "x", "f", "b", "d", "t", "p")),
        ("xxs", a.F.xxhash64("s")), ("xxq", a.F.xxhash64("q", "i"))],
    "murmur3 over decimal(38,4)": lambda a: [
        ("mm", a.F.hash("q")), ("mmq", a.F.hash("s", "q", "l"))],
    "hive hash": lambda a: [
        ("hive", a.H.HiveHash(a.col("i"), a.col("l"), a.col("x"),
                              a.col("f"), a.col("b"), a.col("d"),
                              a.col("t"), a.col("s")))],
    "misc": lambda a: [
        ("norm", a.MI.NormalizeNaNAndZero(a.col("x"))),
        ("known", a.MI.KnownFloatingPointNormalized(a.col("x"))),
        ("nn", a.MI.KnownNotNull(a.col("x"))),
        ("atl", a.MI.AtLeastNNonNulls(2, a.col("x"), a.col("s"),
                                      a.col("q"))),
        ("pid", a.F.spark_partition_id()),
        ("rand", a.F.rand(11)), ("rand0", a.F.rand())],
}

#: transcendental functions, within 2 ulp of the reference
TRANSCENDENTAL = {
    "exp": lambda a: a.F.exp("x"), "log": lambda a: a.F.log("x"),
    "log10": lambda a: a.F.log10("x"), "log2": lambda a: a.F.log2("x"),
    "log1p": lambda a: a.M.Log1p(a.col("x")),
    "expm1": lambda a: a.M.Expm1(a.col("x")),
    "sin": lambda a: a.M.Sin(a.col("x")), "cos": lambda a: a.M.Cos(a.col("x")),
    "tan": lambda a: a.M.Tan(a.col("x")), "cot": lambda a: a.M.Cot(a.col("x")),
    "asin": lambda a: a.M.Asin(a.col("x")),
    "acos": lambda a: a.M.Acos(a.col("x")),
    "atan": lambda a: a.M.Atan(a.col("x")),
    "sinh": lambda a: a.M.Sinh(a.col("x")),
    "cosh": lambda a: a.M.Cosh(a.col("x")),
    "tanh": lambda a: a.M.Tanh(a.col("x")),
    "asinh": lambda a: a.M.Asinh(a.col("x")),
    "acosh": lambda a: a.M.Acosh(a.col("x")),
    "atanh": lambda a: a.M.Atanh(a.col("x")),
    "cbrt": lambda a: a.M.Cbrt(a.col("x")),
    "pow": lambda a: a.F.pow("x", a.lit(0.25)),
    "hypot": lambda a: a.M.Hypot(a.col("x"), a.col("i")),
    "logb": lambda a: a.M.Logarithm(a.lit(3.0), a.col("x")),
    "rad": lambda a: a.M.ToRadians(a.col("x")),
}


@pytest.mark.parametrize("case", list(EXACT))
def test_exact_functions_match_the_reference_bitwise(case):
    # the rounding group against the reference's CPU route (numpy, IEEE
    # division and sqrt): XLA's CPU rewrites a division by a constant
    # into a product with its reciprocal and is an ulp off there
    got, ref = _select_both(EXACT[case], reference_cpu=case == "rounding")
    if case == "rounding":
        got, ref = _canonical_nans(got), _canonical_nans(ref)
    assert tables_differ(got, ref) is None, tables_differ(got, ref)


def _canonical_nans(t: JHostTable) -> JHostTable:
    """Every NaN as the canonical NaN: a NaN's sign and payload are not
    part of the value (numpy's sqrt of a negative sets the sign bit,
    Java's does not)."""
    cols = []
    for c in t.columns:
        d = c.data
        if d.dtype.kind == "f":
            d = np.where(np.isnan(d), np.array(np.nan, dtype=d.dtype), d)
        cols.append(JHostColumn(c.dtype, d, c.validity))
    return JHostTable(t.names, cols)


def test_transcendental_functions_within_two_ulp():
    """Against the reference's CPU route (numpy's libm): XLA's sinh and
    cosh are hundreds of ulp off for large arguments."""
    got, ref = _select_both(lambda a: [
        (name, fn(a)) for name, fn in TRANSCENDENTAL.items()],
        reference_cpu=True)
    for name, g, r in zip(got.names, got.columns, ref.columns):
        assert np.array_equal(g.validity, r.validity), name
        ok = g.validity
        gd, rd = g.data[ok], r.data[ok]
        both_nan = np.isnan(gd) & np.isnan(rd)
        ulps = np.abs(gd.view(np.int64) - rd.view(np.int64))
        assert (both_nan | (ulps <= 2)).all(), (name, ulps.max())


def test_float32_sort_keys_match_the_reference():
    """ORDER BY a FLOAT column (NaN last, -0.0 equal to 0.0: the tie keeps
    the row order) and by a float expression, both directions."""
    got, ref = _run(lambda a, df: df.select(
        "f", "i").sort(a.col("f"), a.col("i")))
    assert tables_differ(got, ref) is None, tables_differ(got, ref)
    got, ref = _run(lambda a, df: df.select(
        (a.col("x") * a.lit(2.0)).cast("float").alias("g"), "i").sort(
        "g", ascending=False).limit(40))
    assert tables_differ(got, ref) is None, tables_differ(got, ref)


def test_nondeterministic_ids_and_streams_reproduce():
    """monotonically_increasing_id counts rows across batches; rand(seed)
    draws the same numbers as numpy's seeded stream in row order, and
    again on a second collect."""
    table = _table()
    df = tfrom(host_table_from_arrays(*table), TorchSession(device="cpu"),
               num_batches=3)
    q = df.select(TF.monotonically_increasing_id().alias("id"),
                  TF.rand(5).alias("r"))
    first = q.collect_table()
    assert list(first.columns[0].data) == list(range(N))
    np.testing.assert_array_equal(first.columns[1].data,
                                  np.random.default_rng(5).random(N))
    again = q.collect_table()
    assert np.array_equal(again.columns[1].data, first.columns[1].data)


def test_what_still_raises_names_itself():
    df = tfrom(host_table_from_arrays(*_table()), TorchSession(device="cpu"))
    for expr, match in (
            (TM.Round(tcol("x"), tcol("i")), "non-literal scale"),
            (TF.round("p", 1), "Round of decimal"),
            (TM.BitwiseAnd(tcol("x"), tcol("i")), "integral operands"),
            (TH.HiveHash(tcol("p")), "hive hash of decimal"),
            (TF.sqrt("s"), "Sqrt of string")):
        with pytest.raises(NotImplementedError, match=match):
            df.select(expr.alias("y"))


#: rand and monotonically_increasing_id under a filter (the draw and the
#: ids follow the rows that pass it), in a projection, an aggregate's
#: input and a group-by, from SQL text
NONDETERMINISTIC_SQL = {
    "projection": "SELECT i, rand(3) AS r, monotonically_increasing_id() "
                  "AS m FROM x WHERE i > 0",
    "aggregate": "SELECT SUM(CASE WHEN rand(3) < 0.5 THEN 1 ELSE 0 END) "
                 "AS h, COUNT(*) AS n FROM x WHERE i > 0",
    "group-by": "SELECT b, SUM(rand(4)) AS s FROM x WHERE i > 0 GROUP BY b "
                "ORDER BY b",
}


@pytest.mark.parametrize("case", list(NONDETERMINISTIC_SQL))
def test_nondeterministic_functions_under_a_filter_match_the_reference(case):
    table = _table()
    js, ts = TpuSession(), TorchSession(device="cpu")
    jfrom(_as_reference(*table), js).create_or_replace_temp_view("x")
    tfrom(host_table_from_arrays(*table), ts).create_or_replace_temp_view("x")
    text = NONDETERMINISTIC_SQL[case]
    got = _as_reference(*ts.sql(text).collect_table().to_arrays())
    want = js.sql(text).collect_table()
    assert tables_differ(got, want) is None, tables_differ(got, want)
