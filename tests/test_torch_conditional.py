"""The conditional expressions of the port (``ops/conditional.py``: If,
CaseWhen, Coalesce, Least, Greatest, NaNvl) on the CPU against the JAX
package's, through both sessions on the same 3,000 seeded rows.

Every value column holds nulls, and the doubles hold NaN, a negative NaN
(another payload), +-0.0 and +-inf. Branch types: double, bigint, int,
date, DECIMAL64, DECIMAL128 and string (the branches' dictionaries merged,
with string literals and a NULL literal); CASE with and without ELSE; the
expressions in projections, in filters and as group keys.

Comparators: ``scale_test.tables_differ`` (bitwise over valid rows, in
order: raw bytes, so NaN payloads and signed zeros count) for projections
and filters; ``tables_differ_unordered`` (a bitwise row multiset) for
group-bys, whose groups the two packages may emit in another order. Named
tests pin the reference's order-dependent ``greatest``/``least`` on NaN
and +-0.0 (Spark orders NaN above every number), and what raises."""

import numpy as np
import pytest
import torch

from scale_test import tables_differ, tables_differ_unordered
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.ops import conditional as JC
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.ops.expr import lit as jlit
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.ops import conditional as TC
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.ops.expr import lit as tlit
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.session import TorchSession

N = 3000
NEG_NAN = np.array([0xFFF8_0000_0000_0001], dtype=np.uint64).view(
    np.float64)[0]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _doubles(rng):
    special = np.array([np.nan, NEG_NAN, 0.0, -0.0, np.inf, -np.inf, 1.5])
    v = np.round(rng.normal(0, 100, N), 2)
    pick = rng.random(N) < 0.35
    v[pick] = special[rng.integers(0, len(special), pick.sum())]
    return v


def _arrays():
    rng = np.random.default_rng(20261017)

    def valid():
        return rng.random(N) > 0.15

    fruit = np.array(["apple", "fig", "pear", "quince"], dtype=object)
    other = np.array(["", "fig", "kiwi", "plum", "zebra"], dtype=object)
    cols = {
        "g": ("int", rng.integers(0, 5, N).astype(np.int32), np.ones(N, bool)),
        "c": ("boolean", rng.random(N) < 0.5, valid()),
        "c2": ("boolean", rng.random(N) < 0.3, valid()),
        "da": ("double", _doubles(rng), valid()),
        "db": ("double", _doubles(rng), valid()),
        "la": ("bigint", rng.integers(-2**40, 2**40, N), valid()),
        "lb": ("bigint", rng.integers(-1000, 1000, N), valid()),
        "ia": ("int", rng.integers(-50, 50, N).astype(np.int32), valid()),
        "ib": ("int", rng.integers(-50, 50, N).astype(np.int32), valid()),
        "ta": ("date", rng.integers(0, 20000, N).astype(np.int32), valid()),
        "tb": ("date", rng.integers(0, 20000, N).astype(np.int32), valid()),
        "ma": ("decimal(12,2)", rng.integers(-10**8, 10**8, N), valid()),
        "mb": ("decimal(12,2)", rng.integers(-10**8, 10**8, N), valid()),
        "ha": ("decimal(30,2)", np.array(
            [int(x) * 10**15 + int(y) for x, y in zip(
                rng.integers(-10**10, 10**10, N),
                rng.integers(0, 10**15, N))], dtype=object), valid()),
        "hb": ("decimal(30,2)", np.array(
            [int(x) * 10**12 for x in rng.integers(-10**12, 10**12, N)],
            dtype=object), valid()),
        "sa": ("string", fruit[rng.integers(0, len(fruit), N)], valid()),
        "sb": ("string", other[rng.integers(0, len(other), N)], valid()),
    }
    names = list(cols)
    types = [cols[n][0] for n in names]
    arrays = []
    for n in names:
        _, d, v = cols[n]
        if d.dtype == object and types[names.index(n)] == "string":
            d = np.where(v, d, None)
        arrays.append((d, v))
    return names, types, arrays


@pytest.fixture(scope="module")
def sessions():
    names, types, arrays = _arrays()
    ts, js = TorchSession(device="cpu"), TpuSession()
    tdf = tfrom(host_table_from_arrays(names, types, arrays), ts)
    jdf = jfrom(JHostTable(names, [
        JHostColumn(JT.parse_type(t), d, v)
        for t, (d, v) in zip(types, arrays)]), js)
    return tdf, jdf


def _as_reference(t) -> JHostTable:
    names, types, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.NULL if ty == "void" else JT.parse_type(ty), d, v)
        for ty, (d, v) in zip(types, arrays)])


class _Pkg:
    """One package's function namespace, so one builder writes the same
    expression for both."""

    def __init__(self, F, C, col, lit):
        self.F, self.C, self.col, self.lit = F, C, col, lit


TPKG = _Pkg(TF, TC, tcol, tlit)
JPKG = _Pkg(JF, JC, jcol, jlit)


#: value column pairs by branch type, and a literal of each type
PAIRS = {
    "double": ("da", "db", 2.5),
    "bigint": ("la", "lb", 7),
    "int": ("ia", "ib", -3),
    "date": ("ta", "tb", None),
    "decimal64": ("ma", "mb", None),
    "decimal128": ("ha", "hb", None),
    "string": ("sa", "sb", "kiwi"),
}


def _exprs(p, a, b, literal):
    """{name: expression} of the six conditionals over columns a, b."""
    A, B, C = p.col(a), p.col(b), p.col("c")
    lit_or_b = p.lit(literal) if literal is not None else B
    out = {
        "if": p.F.if_(C, A, B),
        "if null else": p.C.If(C, A, p.lit(None)),
        "case with else": p.F.when(C, A).when(p.col("c2"), lit_or_b)
        .otherwise(B),
        "case without else": p.F.when(C, A).when(p.col("c2"), B).end(),
        "case else null": p.C.CaseWhen(C, A, p.lit(None)),
        "coalesce": p.F.coalesce(A, B),
        "coalesce literal": p.F.coalesce(A, lit_or_b),
        "coalesce null first arg": p.C.Coalesce(A, p.lit(None), B),
        "greatest": p.F.greatest(A, B),
        "least": p.F.least(A, B),
        "greatest three": p.F.greatest(B, A, lit_or_b),
        "least three": p.F.least(B, lit_or_b, A),
    }
    return out


_CASES = [(ty, kind) for ty in PAIRS for kind in _exprs(
    TPKG, *PAIRS[ty])]


@pytest.mark.parametrize("ty,kind", _CASES)
def test_projection_matches_reference(sessions, ty, kind):
    tdf, jdf = sessions
    a, b, literal = PAIRS[ty]
    te = _exprs(TPKG, a, b, literal)[kind]
    je = _exprs(JPKG, a, b, literal)[kind]
    got = _as_reference(tdf.select(tcol("g"), te.alias("r")).collect_table())
    ref = jdf.select(jcol("g"), je.alias("r")).collect_table()
    assert got.num_rows == N
    assert tables_differ(got, ref) is None


@pytest.mark.parametrize("second", ["db", "lit", "ia"])
def test_nanvl_matches_reference(sessions, second):
    tdf, jdf = sessions

    def build(p):
        b = p.lit(-1.0) if second == "lit" else p.col(second)
        return p.F.nanvl(p.col("da"), b).alias("r")

    got = _as_reference(tdf.select(build(TPKG)).collect_table())
    ref = jdf.select(build(JPKG)).collect_table()
    assert tables_differ(got, ref) is None


def test_predicates_on_nan_and_nulls(sessions):
    """CASE on a double comparison: NaN > 0 is true (Spark's rule, in both
    packages' ``>``), a null condition falls through."""
    tdf, jdf = sessions

    def build(p):
        return p.F.when(p.col("da") > p.lit(0.0), p.lit("pos")).when(
            p.col("da").isnull(), p.lit("null")).otherwise(
            p.lit("rest")).alias("r")

    got = _as_reference(tdf.select(build(TPKG)).collect_table())
    ref = jdf.select(build(JPKG)).collect_table()
    assert tables_differ(got, ref) is None


FILTERS = {
    "coalesce > 0": lambda p: p.F.coalesce(p.col("da"), p.col("db"))
    > p.lit(0.0),
    "case boolean": lambda p: p.F.when(p.col("c"), p.col("la") > p.lit(0))
    .otherwise(p.col("lb") < p.lit(0)),
    "if over strings": lambda p: p.F.if_(p.col("c"), p.col("sa"),
                                         p.col("sb")) == p.lit("fig"),
    "greatest ints": lambda p: p.F.greatest(p.col("ia"), p.col("ib"))
    >= p.lit(10),
    "least decimal": lambda p: p.F.least(p.col("ma"), p.col("mb")).isnull(),
    "nanvl": lambda p: p.F.nanvl(p.col("da"), p.lit(0.0)) == p.lit(0.0),
}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_matches_reference(sessions, name):
    tdf, jdf = sessions
    got = _as_reference(tdf.filter(FILTERS[name](TPKG))
                        .select(tcol("g"), tcol("la"), tcol("sa"))
                        .collect_table())
    ref = jdf.filter(FILTERS[name](JPKG)).select(
        jcol("g"), jcol("la"), jcol("sa")).collect_table()
    assert 0 < got.num_rows < N
    assert tables_differ(got, ref) is None


KEYS = {
    "string case": lambda p: p.F.when(p.col("c"), p.col("sa")).when(
        p.col("c2"), p.lit("both")).otherwise(p.col("sb")),
    "string coalesce with a null literal": lambda p: p.C.Coalesce(
        p.col("sa"), p.lit(None), p.lit("none")),
    "int coalesce": lambda p: p.F.coalesce(p.col("ia"), p.col("ib")),
    "greatest dates": lambda p: p.F.greatest(p.col("ta"), p.col("tb")),
    "if decimal": lambda p: p.F.if_(p.col("c"), p.col("ma"), p.col("mb")),
    "least strings": lambda p: p.F.least(p.col("sa"), p.col("sb")),
}


@pytest.mark.parametrize("name", sorted(KEYS))
def test_group_key_matches_reference(sessions, name):
    tdf, jdf = sessions
    got = _as_reference(tdf.group_by(KEYS[name](TPKG).alias("key")).agg(
        TF.count().alias("n"), TF.sum("lb").alias("s")).collect_table())
    ref = jdf.group_by(KEYS[name](JPKG).alias("key")).agg(
        JF.count().alias("n"), JF.sum("lb").alias("s")).collect_table()
    assert got.num_rows > 1
    assert tables_differ_unordered(got, ref) is None


def _pair_table(a, b, ty="double"):
    arrays = [(np.array(a), np.ones(len(a), bool)),
              (np.array(b), np.ones(len(b), bool))]
    return ["a", "b"], [ty, ty], arrays


def _pick(fn_name, a, b):
    """greatest/least(a, b) row by row through both sessions: (port rows,
    reference rows) as raw bits."""
    names, types, arrays = _pair_table(a, b)
    ts, js = TorchSession(device="cpu"), TpuSession()
    got = tfrom(host_table_from_arrays(names, types, arrays), ts).select(
        getattr(TF, fn_name)(tcol("a"), tcol("b")).alias("r"))
    ref = jfrom(JHostTable(names, [
        JHostColumn(JT.DOUBLE, d, v) for d, v in arrays]), js).select(
        getattr(JF, fn_name)(jcol("a"), jcol("b")).alias("r"))
    bits = lambda t: t.columns[0].data.view(np.uint64).tolist()  # noqa: E731
    return bits(got.collect_table()), bits(ref.collect_table())


def _bits(*vals):
    return np.array(vals, dtype=np.float64).view(np.uint64).tolist()


def test_greatest_keeps_the_first_of_nan_and_a_number():
    """The reference's plain ``>``: greatest(NaN, 1.0) = NaN, but
    greatest(1.0, NaN) = 1.0 (Spark: NaN both times)."""
    got, ref = _pick("greatest", [np.nan, 1.0], [1.0, np.nan])
    assert got == ref == _bits(np.nan, 1.0)


def test_least_keeps_the_first_of_nan_and_a_number():
    """least(NaN, 1.0) = NaN, least(1.0, NaN) = 1.0 (Spark: 1.0 both
    times)."""
    got, ref = _pick("least", [np.nan, 1.0], [1.0, np.nan])
    assert got == ref == _bits(np.nan, 1.0)


def test_greatest_and_least_keep_the_first_signed_zero():
    """greatest(-0.0, 0.0) = -0.0 and greatest(0.0, -0.0) = 0.0; least
    alike."""
    for fn in ("greatest", "least"):
        got, ref = _pick(fn, [-0.0, 0.0], [0.0, -0.0])
        assert got == ref == _bits(-0.0, 0.0)


def test_case_takes_the_first_value_type():
    """CaseWhen's type is its first value's; a value that widens into it
    (int into bigint, int into double) is cast, any other raises."""
    names, types, arrays = _arrays()
    tdf = tfrom(host_table_from_arrays(names, types, arrays),
                TorchSession(device="cpu"))
    ok = tdf.select(TF.when(tcol("c"), tcol("la")).otherwise(tcol("ia"))
                    .alias("r"), TF.coalesce(tcol("da"), tlit(0)).alias("d"))
    assert [t for _, t in ok.schema] == [T.LONG, T.DOUBLE]
    ok.collect_table()
    for bad in (TF.when(tcol("c"), tcol("ia")).otherwise(tcol("la")),
                TF.when(tcol("c"), tlit(1)).otherwise(tlit(2.5)),
                TF.when(tcol("c"), tcol("sa")).otherwise(tlit(1)),
                TF.when(tcol("c"), tcol("ta")).otherwise(tcol("ia")),
                TF.when(tcol("c"), tcol("ma")).otherwise(tcol("ha")),
                TF.when(tcol("c"), tlit(None)).otherwise(tcol("la")),
                TF.coalesce(tcol("ia"), tcol("da")),
                TF.greatest(tcol("ma"), tcol("la")),
                TF.if_(tcol("c"), tcol("ia"), tcol("la"))):
        with pytest.raises(NotImplementedError, match="first value's"):
            tdf.select(bad.alias("r"))
    with pytest.raises(NotImplementedError, match="nanvl over string"):
        tdf.select(TF.nanvl(tcol("sa"), tcol("sb")).alias("r"))
