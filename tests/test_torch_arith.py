"""The port's unary and modular arithmetic and its decimal operators,
each against the JAX package's TpuSession on the same numpy inputs:
UnaryMinus, UnaryPositive, Abs, Remainder, Pmod and IntegralDivide over
every integral and floating type (nulls, zero and -1 divisors, INT_MIN,
NaN, +-inf and -0.0), and DecimalAdd, DecimalSubtract, DecimalMultiply,
DecimalDivide, DecimalRemainder and DecimalPmod over edge vectors: every
pair of a value list holding 0, +-1, +-(10^p - 1), HALF_UP ties of either
sign (5 x 10^k beside 10^j), powers of ten and seeded values, for
DECIMAL64 and DECIMAL128 operands, mixed ones, integral operands coerced
through ``decimal_for``, results past 10^p (null) and scales cut by
``_adjust``. The reference runs what its device does not on its exact
host route; the port computes every supported pair on its own device
path.

Comparator: ``scale_test.tables_differ`` (bitwise, in order), plus the
result's decimal type. Divide, Remainder and Pmod over a DECIMAL128
operand or result run in the port's DECIMAL128 division kernel (its plain
version here); a Divide the reference computes on its host is held to it
on the rows with a divisor >= 0 (its host rounding of a negative divisor
is a pinned deviation) and to Python ints on every row."""

import numpy as np
import pytest
import torch

from scale_test import tables_differ
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.ops import arithmetic as JA
from spark_rapids_tpu.ops import decimal as JD
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.ops.expr import lit as jlit
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.ops import arithmetic as TA
from spark_rapids_tpu_torch.ops import decimal as TD
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.ops.expr import lit as tlit
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.session import TorchSession


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reference_table(names, types, arrays) -> JHostTable:
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, np.asarray(v, dtype=bool))
        for ty, (d, v) in zip(types, arrays)])


def _as_reference(t) -> JHostTable:
    return _reference_table(*t.to_arrays())


class _Api:
    """One package's column constructors and arithmetic classes."""

    def __init__(self, col, lit, A):
        self.col, self.lit, self.A = col, lit, A


PORT = _Api(tcol, tlit, TA)
REF = _Api(jcol, jlit, JA)


def _select_both(table, exprs):
    """(port result as a reference table, reference result) of
    ``exprs(api)`` ([(name, Expression)]) projected over ``table``
    ((names, type names, [(data, validity)]))."""
    ref = jfrom(_reference_table(*table), TpuSession()).select(
        *[e.alias(n) for n, e in exprs(REF)]).collect_table()
    got = tfrom(host_table_from_arrays(*table),
                TorchSession(device="cpu")).select(
        *[e.alias(n) for n, e in exprs(PORT)]).collect_table()
    return _as_reference(got), ref


# ---------------------------------------------------------------------------
# integral and floating operands
# ---------------------------------------------------------------------------

INT_TYPES = {"tinyint": np.int8, "smallint": np.int16, "int": np.int32,
             "bigint": np.int64}
FLOAT_TYPES = {"float": np.float32, "double": np.float64}
NUMERIC_TYPES = {**INT_TYPES, **FLOAT_TYPES}


def _values(type_name, n, rng, divisor=False):
    """(data, validity) of ``n`` seeded values with the type's edges: its
    MIN and MAX, 0, +-1 (and for floats NaN, +-inf, -0.0); a divisor
    column holds more zeros and -1s."""
    dt = NUMERIC_TYPES[type_name]
    if type_name in INT_TYPES:
        info = np.iinfo(dt)
        x = rng.integers(info.min, info.max, n, dtype=np.int64,
                         endpoint=True).astype(dt)
        small = rng.integers(-9, 10, n).astype(dt)
        x = np.where(rng.random(n) < 0.5, small, x)
        edges = [info.min, info.max, 0, -1, 1, info.min + 1, 7, -7]
    else:
        x = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 6, n)).astype(
            dt)
        edges = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, -1.0, 2.5, -2.5]
    x[:len(edges)] = np.asarray(edges).astype(dt)
    if divisor:
        x[rng.random(n) < 0.15] = 0
        x[rng.random(n) < 0.1] = -1
    valid = rng.random(n) > 0.1
    return x, valid


@pytest.mark.parametrize("type_name", list(NUMERIC_TYPES))
def test_unary_operators_match_the_reference(type_name):
    """-x, +x and abs(x): integers wrap at MIN (Java), floats keep NaN
    payload signs and -0.0 as numpy does."""
    rng = np.random.default_rng(11)
    table = (["a"], [type_name], [_values(type_name, 300, rng)])
    got, ref = _select_both(table, lambda api: [
        ("neg", api.A.UnaryMinus(api.col("a"))),
        ("pos", api.A.UnaryPositive(api.col("a"))),
        ("abs", api.A.Abs(api.col("a")))])
    assert tables_differ(got, ref) is None, tables_differ(got, ref)


#: (dividend type, divisor type): same types, and mixed ones that meet at
#: their promoted type
MOD_PAIRS = [(t, t) for t in NUMERIC_TYPES] + [
    ("int", "bigint"), ("tinyint", "int"), ("double", "int"),
    ("bigint", "float")]


@pytest.mark.parametrize("lt,rt", MOD_PAIRS)
def test_modular_operators_match_the_reference(lt, rt):
    """a % b, pmod(a, b) and a div b: NULL on a zero divisor, Java's sign
    of the dividend, INT_MIN % -1 == 0, INT_MIN div -1 == INT_MIN (as a
    LONG), div over floats through their LONG casts."""
    rng = np.random.default_rng(MOD_PAIRS.index((lt, rt)))
    n = 400
    table = (["a", "b"], [lt, rt], [_values(lt, n, rng),
                                    _values(rt, n, rng, divisor=True)])
    got, ref = _select_both(table, lambda api: [
        ("rem", api.col("a") % api.col("b")),
        ("pmod", api.A.Pmod(api.col("a"), api.col("b"))),
        ("div", api.A.IntegralDivide(api.col("a"), api.col("b")))])
    assert tables_differ(got, ref) is None, tables_differ(got, ref)


def test_operator_sugar_and_literals():
    """``-col``, ``col % lit`` and ``abs`` build the same expressions in
    both packages, literals coerced as Spark does."""
    rng = np.random.default_rng(2)
    table = (["a"], ["bigint"], [_values("bigint", 200, rng)])
    got, ref = _select_both(table, lambda api: [
        ("n", -api.col("a")),
        ("m", api.col("a") % api.lit(16)),
        ("p", api.A.Pmod(api.col("a") - api.lit(5000000), api.lit(7))),
        ("q", api.A.IntegralDivide(api.col("a"), api.lit(1000))),
        ("x", api.A.Abs(api.col("a") - api.lit(50000.0)))])
    assert tables_differ(got, ref) is None, tables_differ(got, ref)


# ---------------------------------------------------------------------------
# decimals
# ---------------------------------------------------------------------------

def _decimal_edges(p: int, s: int, rng, n_random: int = 6):
    """Unscaled values of decimal(p, s): 0, +-1, +-(10^p - 1), +-10^s (one),
    HALF_UP ties (5 x 10^k of either sign beside powers of ten, so that a
    product or a rescale lands on .5), and seeded values of every
    magnitude."""
    top = 10 ** p - 1
    vals = [0, 1, -1, top, -top, 10 ** s, -(10 ** s), top // 2]
    vals += [5 * 10 ** k for k in range(0, p, 2)]
    vals += [-5 * 10 ** k for k in range(1, p, 4)]
    vals += [10 ** k for k in range(1, p, 3)]
    vals += [-(10 ** k) for k in range(2, p, 5)]
    for _ in range(n_random):
        digits = int(rng.integers(1, p + 1))
        v = int(rng.integers(0, 10 ** min(digits, 18)))
        if digits > 18:
            v = v * 10 ** (digits - 18) + int(rng.integers(0, 10 ** 18)) \
                % 10 ** (digits - 18)
        vals.append(-v if rng.random() < 0.5 else v)
    return vals


def _int_edges(type_name):
    info = np.iinfo(INT_TYPES[type_name])
    return [0, 1, -1, int(info.min), int(info.max), 5, -5, 15, 100]


def _column(type_name, values):
    dt = JT.parse_type(type_name)
    if isinstance(dt, JT.DecimalType) and dt.precision > 18:
        return np.array(values, dtype=object)
    return np.array(values, dtype=dt.np_dtype)


def _edge_table(lt, rt, seed):
    """Every pair of the two operands' edge values (nulls on a few rows of
    each side)."""
    rng = np.random.default_rng(seed)

    def edges(t):
        dt = JT.parse_type(t)
        if isinstance(dt, JT.DecimalType):
            return _decimal_edges(dt.precision, dt.scale, rng)
        return _int_edges(t)

    a, b = edges(lt), edges(rt)
    left = [x for x in a for _ in b]
    right = [y for _ in a for y in b]
    n = len(left)
    va, vb = np.ones(n, bool), np.ones(n, bool)
    va[3::97] = False
    vb[5::89] = False
    return (["a", "b"], [lt, rt],
            [(_column(lt, left), va), (_column(rt, right), vb)])


#: operand type pairs: q1's DECIMAL(15,2) and its products (the 64 x 64
#: and 128 x 64 ones), a precision-19 sum, scale cuts by ``_adjust``,
#: DECIMAL128 against DECIMAL128 at precision 38, mixed DECIMAL64 and
#: DECIMAL128, small types whose quotients are DECIMAL64, and integral
#: operands coerced through ``decimal_for`` (bigint -> decimal(20,0))
DECIMAL_PAIRS = [
    ("decimal(15,2)", "decimal(15,2)"),
    ("decimal(10,0)", "decimal(15,2)"),
    ("decimal(32,4)", "decimal(16,2)"),
    ("decimal(18,0)", "decimal(18,0)"),
    ("decimal(17,0)", "decimal(18,1)"),
    ("decimal(38,10)", "decimal(38,30)"),
    ("decimal(38,0)", "decimal(38,0)"),
    ("decimal(20,2)", "decimal(7,3)"),
    ("decimal(5,2)", "decimal(3,1)"),
    ("decimal(9,2)", "decimal(5,3)"),
    ("decimal(12,2)", "decimal(6,4)"),
    ("bigint", "decimal(15,2)"),
    ("int", "decimal(10,4)"),
    ("decimal(12,2)", "smallint"),
    ("tinyint", "decimal(38,2)"),
]

OPS = {"add": lambda api, a, b: a + b,
       "subtract": lambda api, a, b: a - b,
       "multiply": lambda api, a, b: a * b,
       "divide": lambda api, a, b: a / b,
       "remainder": lambda api, a, b: a % b,
       "pmod": lambda api, a, b: api.A.Pmod(a, b)}


def _as_decimal(type_name):
    return JD.decimal_for(JT.parse_type(type_name))


def _on_the_reference_host(op, lt, rt):
    """Whether the reference computes this pair on its host route (a
    DECIMAL128 operand or quotient for Divide, a DECIMAL128 operand or an
    operand rescaled past 18 digits for Remainder and Pmod, read from its
    result types): the port's DECIMAL128 division kernel route."""
    a, b = _as_decimal(lt), _as_decimal(rt)
    if op == "divide":
        out = JD.div_result_type(a, b)
        return max(a.precision, b.precision, out.precision) > 18
    if op in ("remainder", "pmod"):
        s = max(a.scale, b.scale)
        return max(a.precision, b.precision, a.precision - a.scale + s,
                   b.precision - b.scale + s) > 18
    return False


def _half_up_quotients(table, lt, rt):
    """The Python-int quotients of the Divide of ``table``'s operands
    (HALF_UP on the magnitude, the sign of a / b; None for a null operand,
    a zero divisor or |q| >= 10^p)."""
    a_t, b_t = _as_decimal(lt), _as_decimal(rt)
    out_t = JD.div_result_type(a_t, b_t)
    up = out_t.scale + b_t.scale - a_t.scale
    (av, am), (bv, bm) = table[2]
    out = []
    for a, va, b, vb in zip(av, am, bv, bm):
        if not (va and vb) or int(b) == 0:
            out.append(None)
            continue
        q, r = divmod(abs(int(a)) * 10 ** up, abs(int(b)))
        q += 2 * r >= abs(int(b))
        q = -q if (int(a) < 0) != (int(b) < 0) else q
        out.append(q if abs(q) < 10 ** out_t.precision else None)
    return out


@pytest.mark.parametrize("op", list(OPS))
@pytest.mark.parametrize("lt,rt", DECIMAL_PAIRS)
def test_decimal_operators_match_the_reference_bitwise(lt, rt, op):
    """Every pair against the reference bit for bit. A Divide the
    reference computes on its host: the rows with a divisor >= 0 against
    it (its host ``_round_half_up_div`` mis-rounds a negative divisor),
    every row against Python ints."""
    table = _edge_table(lt, rt, seed=DECIMAL_PAIRS.index((lt, rt)))

    def exprs(api):
        return [("x", OPS[op](api, api.col("a"), api.col("b")))]

    got, ref = _select_both(table, exprs)
    assert got.columns[0].dtype == ref.columns[0].dtype
    if op == "divide" and _on_the_reference_host(op, lt, rt):
        want = _half_up_quotients(table, lt, rt)
        g = got.columns[0]
        assert [int(v) if ok else None for v, ok in
                zip(g.data, g.validity)] == want
        keep = np.array([int(b) >= 0 for b in table[2][1][0]])
        got, ref = (JHostTable(t.names, [JHostColumn(
            t.columns[0].dtype, t.columns[0].data[keep],
            t.columns[0].validity[keep])]) for t in (got, ref))
    assert tables_differ(got, ref) is None, tables_differ(got, ref)
    if op in ("add", "multiply") and lt == rt == "decimal(38,0)":
        # the edges reach past 10^38: those rows are null on both sides
        assert not ref.columns[0].validity.all()


@pytest.mark.parametrize("type_name", ["decimal(15,2)", "decimal(18,0)",
                                       "decimal(25,5)", "decimal(38,0)"])
def test_decimal_negation_and_abs_match_the_reference(type_name):
    """-x and abs(x) of decimals: a DECIMAL128 negates its 128-bit value
    (the reference tags both to its CPU route, whose answer the port
    gives; there is no deviation to pin)."""
    dt = JT.parse_type(type_name)
    rng = np.random.default_rng(dt.precision)
    vals = _decimal_edges(dt.precision, dt.scale, rng, n_random=40)
    valid = np.ones(len(vals), bool)
    valid[2::7] = False
    table = (["a"], [type_name], [(_column(type_name, vals), valid)])
    got, ref = _select_both(table, lambda api: [
        ("neg", -api.col("a")), ("abs", api.A.Abs(api.col("a"))),
        ("pos", api.A.UnaryPositive(api.col("a")))])
    assert tables_differ(got, ref) is None, tables_differ(got, ref)


def test_decimal_integral_divide_matches_the_reference():
    """``div`` over decimals: the exact DECIMAL64 quotient truncated to
    LONG (7.5 div 0.5 is 15); an int operand joins as decimal(10,0)."""
    a = np.array([750, -750, 101, 5, 0, 999, -1], dtype=np.int64)
    b = np.array([5, 50, -3, 0, 7, -10, 3], dtype=np.int64)
    k = np.array([2, -1, 3, 1, 0, 7, 9], dtype=np.int32)
    ones = np.ones(len(a), bool)
    table = (["a", "b", "k"], ["decimal(5,2)", "decimal(3,1)", "int"],
             [(a, ones), (b, ones), (k, ones)])
    got, ref = _select_both(table, lambda api: [
        ("q", api.A.IntegralDivide(api.col("a"), api.col("b"))),
        ("r", api.A.IntegralDivide(api.col("a"), api.col("k")))])
    assert tables_differ(got, ref) is None, tables_differ(got, ref)
    assert got.columns[0].data[0] == 15


def test_integral_to_decimal128_cast_matches_the_reference():
    """A bigint beside a decimal casts to decimal(20,0), DECIMAL128
    storage (INT64_MIN and MAX included), and casts up to decimal(38, s)
    and back to DECIMAL64 stay exact."""
    vals = np.array([0, 1, -1, 2 ** 63 - 1, -2 ** 63, 10 ** 15, -7],
                    dtype=np.int64)
    table = (["a"], ["bigint"], [(vals, np.ones(len(vals), bool))])
    got, ref = _select_both(table, lambda api: [
        ("d20", api.col("a").cast("decimal(20,0)")),
        ("d38", api.col("a").cast("decimal(38,10)")),
        ("back", api.col("a").cast("decimal(38,10)").cast("decimal(18,2)"))])
    assert tables_differ(got, ref) is None, tables_differ(got, ref)


def test_half_up_ties_of_both_signs():
    """decimal(38,10) x decimal(38,30) cuts the product's scale from 40 to
    6: 5 x 10^33 (unscaled) is exactly .5 at scale 6 and rounds away from
    zero on both signs; the sum's operand at scale 30 rescales to 9 the
    same way."""
    a = np.array([1, -1, 1, -1, 3], dtype=object)
    b = np.array([5 * 10 ** 33, 5 * 10 ** 33, 15 * 10 ** 33 - 1,
                  -(25 * 10 ** 33), 5 * 10 ** 20], dtype=object)
    ones = np.ones(len(a), bool)
    table = (["a", "b"], ["decimal(38,10)", "decimal(38,30)"],
             [(a, ones), (b, ones)])
    got, ref = _select_both(table, lambda api: [
        ("m", api.col("a") * api.col("b")),
        ("s", api.col("a") + api.col("b"))])
    assert tables_differ(got, ref) is None, tables_differ(got, ref)
    assert list(got.columns[0].data[:4]) == [1, -1, 1, 3]


def test_unported_decimal_operators_raise_naming_themselves():
    """DECIMAL128 Divide, Remainder and Pmod (and the functions built on
    them, such as ``div`` of a bigint by a decimal), which raised when they
    bound until the DECIMAL128 division kernel, now run and equal the
    reference (every divisor here positive); what still raises names
    itself (a ceil of a decimal)."""
    t = host_table_from_arrays(
        ["a", "b", "k"], ["decimal(38,2)", "decimal(15,2)", "bigint"],
        [(np.array([1, 2 * 10 ** 30], dtype=object), np.ones(2, bool)),
         (np.array([3, 4], dtype=np.int64), np.ones(2, bool)),
         (np.array([5, 6], dtype=np.int64), np.ones(2, bool))])
    table = t.to_arrays()
    got, ref = _select_both(table, lambda api: [
        ("q", api.col("a") / api.col("b")),
        ("qq", api.col("b") / api.col("b")),
        ("r", api.col("a") % api.col("b")),
        ("p", api.A.Pmod(api.col("b"), api.col("a"))),
        ("d", api.A.IntegralDivide(api.col("k"), api.col("b"))),
        ("dd", api.A.IntegralDivide(api.col("b"),
                                    api.col("b").cast("double")))])
    assert tables_differ(got, ref) is None, tables_differ(got, ref)
    df = tfrom(t, TorchSession(device="cpu"))
    with pytest.raises(NotImplementedError, match="Ceil of decimal"):
        df.select(TF.ceil(tcol("a")).alias("x"))
    # the operator functions of the registry: abs is ported
    assert TF.abs(tcol("a")).name == "Abs"
    assert isinstance(TD.DecimalAdd(tcol("a"), tcol("b")), TD.DecimalBinary)
