"""Host evaluation of every expression (each ops module's ``eval_cpu``,
the CPU route's projection) against the JAX package's over the same
seeded rows, then against the port's own device form of the expression
where one exists. The inputs are those of ``tests/test_expr_breadth.py``,
``test_expr_tail.py``, ``test_misc_exprs.py`` and ``test_nested_types.py``:
integers, doubles with NaN and -0.0, strings, dates, timestamps,
decimals, nulls everywhere, arrays, structs and maps.

Each case runs with ``spark.rapids.sql.enabled=false`` in both packages
(their CPU routes: every expression through ``eval_cpu``), compared by
``tests/torch_nested.py::nested_differ`` (exact: every bit, NaN payloads
and -0.0 too, in order). Against the port's device form
(``TorchSession(device="cpu")``, the same query with the route enabled)
the comparator is ``scale_test.tables_differ`` (bitwise) for every case
but the transcendental and rounding math, held with
``scale_test.tables_close`` (rtol 1e-12: the host's numpy and torch's
kernels may differ in the last ulp)."""

import datetime as dt

import numpy as np
import pytest

from scale_test import tables_close, tables_differ
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as TT
from spark_rapids_tpu_torch.session import TorchSession
from tests.torch_nested import PORT, REF, as_reference, nested_differ, tables

OFF = {"spark.rapids.sql.enabled": "false"}
N = 64


def _inputs():
    """One table with a column of each kind (seed 17), nulls in each."""
    rng = np.random.default_rng(17)

    def nulls(vals, p=0.15):
        return [None if rng.random() < p else v for v in vals]
    d = (rng.standard_normal(N) * 50).tolist()
    d[1], d[2], d[3] = float("nan"), -0.0, float("inf")
    words = ["Spark", "  pad me ", "hello world", "a_b%c", "", "ÄÖü",
             "word up", "x1y2z3"]
    return tables([
        ("i", TT.INT, nulls(rng.integers(-100, 100, N).tolist())),
        ("j", TT.INT, nulls(rng.integers(1, 20, N).tolist())),
        ("l", TT.LONG, nulls(rng.integers(-10**12, 10**12, N).tolist())),
        ("d", TT.DOUBLE, nulls(d)),
        ("p", TT.DOUBLE, nulls((rng.random(N) * 10).tolist())),
        ("s", TT.STRING, nulls([words[x] for x in rng.integers(0, 8, N)])),
        ("n", TT.STRING, nulls([str(x) for x in rng.integers(-500, 500, N)])),
        ("dt", TT.DATE, nulls([int(x) - 31 for x in
                               rng.integers(0, 20000, N)])),
        ("m", TT.DecimalType(10, 2), nulls(rng.integers(-10**7, 10**7,
                                                        N).tolist())),
        ("b", TT.BOOLEAN, nulls(rng.integers(0, 2, N).astype(bool)
                                .tolist())),
        ("arr", TT.ArrayType(TT.LONG), nulls([
            [None if rng.random() < 0.1 else int(v)
             for v in rng.integers(-9, 9, rng.integers(0, 5))]
            for _ in range(N)])),
    ])


TABLES = None


def _tables():
    global TABLES
    if TABLES is None:
        TABLES = _inputs()
    return TABLES


def _key(a):
    """A map key column without nulls."""
    return a.F.coalesce(a.col("j"), a.lit(0))


#: name -> (builder of the select list over an api, the comparator
#: against the device form: "exact", "close", "device only" (exact, and
#: no comparison with the reference), or None where no device form
#: exists)
CASES = {
    "arithmetic": (lambda a: [
        a.col("i") + a.col("j"), a.col("i") - a.col("l"),
        a.col("i") * a.col("j"), a.col("d") / a.col("p"),
        a.col("i") % a.col("j"), -a.col("l"), a.F.abs(a.col("d"))],
        "exact"),
    "predicates": (lambda a: [
        a.col("i") < a.col("j"), a.col("d") >= a.col("p"),
        a.col("s") == a.lit("Spark"), ~(a.col("b")),
        a.col("b") & (a.col("i") > a.lit(0)),
        a.col("b") | (a.col("i") > a.lit(0)),
        a.F.isnull("s"), a.F.isnan("d"),
        a.F.is_in(a.col("i"), 1, 2, 3, None)],
        "exact"),
    "conditional": (lambda a: [
        a.F.when(a.col("i") > a.lit(0), a.col("l")).otherwise(a.lit(7)),
        a.F.coalesce(a.col("i"), a.col("j")),
        a.F.least(a.col("i"), a.col("j")),
        a.F.greatest(a.col("l"), a.lit(5)),
        a.F.nanvl(a.col("d"), a.col("p"))],
        "exact"),
    "casts": (lambda a: [
        a.col("d").cast("int"), a.col("l").cast("double"),
        a.col("i").cast("decimal(12,2)"), a.col("m").cast("double"),
        a.col("dt").cast("timestamp"), a.col("b").cast("int")],
        "exact"),
    "string_casts": (lambda a: [
        a.col("l").cast("string"), a.col("d").cast("string"),
        a.col("dt").cast("string"), a.col("b").cast("string"),
        a.col("m").cast("string"), a.col("n").cast("int"),
        a.col("n").cast("double"), a.col("n").cast("decimal(8,2)")],
        "exact"),
    "decimal": (lambda a: [
        a.col("m") + a.col("m"), a.col("m") * a.col("m"),
        a.col("m") - a.col("i")],
        "exact"),
    # the reference's host division rounds a quotient with a negative
    # divisor toward the wrong side (its _round_half_up_div takes the
    # magnitude of the dividend only): held to exact arithmetic
    # (test_decimal_division_equals_exact_half_up) and the device form
    "decimal_division": (lambda a: [
        a.col("m") / a.col("m"), a.col("m") / a.col("i")],
        "device only"),
    "math": (lambda a: [
        a.F.sqrt("p"), a.F.exp("p"), a.F.log("p"), a.F.log10("p"),
        a.F.pow(a.col("p"), a.lit(1.5)), a.F.signum(a.col("p") - a.lit(5.0))],
        "close"),
    "rounding": (lambda a: [
        a.F.round(a.col("p") - a.lit(5.0), 1),
        a.F.bround(a.col("p") - a.lit(5.0), 0),
        a.F.ceil(a.col("p") - a.lit(5.0)), a.F.floor(a.col("p")),
        a.F.round(a.col("i"), -1)],
        "close"),
    "nan_and_signed_zero": (lambda a: [
        a.F.signum("d"), a.F.ceil("d"), a.F.floor("d")],
        "exact"),
    "bitwise": (lambda a: [
        a.F.shiftleft(a.col("i"), 3), a.F.shiftright(a.col("l"), 5)],
        "exact"),
    "strings": (lambda a: [
        a.F.upper("s"), a.F.lower("s"), a.F.trim("s"),
        a.F.substring("s", 2, 3), a.F.length("s"), a.F.reverse("s"),
        a.F.lpad("s", 8, "*"), a.F.instr("s", "o"), a.F.initcap("s"),
        a.F.replace("s", "o", "0"), a.F.like("s", "%o%"),
        a.F.translate("s", "lo", "01"), a.F.repeat("s", 2),
        a.F.substring_index("s", " ", 1), a.F.ascii("s"),
        a.F.contains("s", "or"), a.F.startswith("s", "w")],
        "exact"),
    "regex": (lambda a: [
        a.F.rlike("s", "o+"), a.F.regexp_replace("s", "[aeiou]", "_"),
        a.F.regexp_extract("s", "([a-z]+) ([a-z]+)", 2)],
        "exact"),
    "multi_column_strings": (lambda a: [
        a.F.concat("s", "n"), a.F.concat_ws("-", "s", "n"),
        a.F.concat_ws("|", a.lit("k"), "s")], "exact"),
    "datetime": (lambda a: [
        a.F.year("dt"), a.F.month("dt"), a.F.dayofmonth("dt"),
        a.F.dayofweek("dt"), a.F.quarter("dt"), a.F.dayofyear("dt"),
        a.F.date_add("dt", 40), a.F.date_sub("dt", 400),
        a.F.add_months("dt", 13), a.F.datediff("dt", a.lit(dt.date(
            2000, 1, 1))), a.F.last_day("dt"), a.F.weekday("dt")],
        "exact"),
    "timestamps": (lambda a: [
        a.F.hour(a.F.timestamp_seconds(a.col("l") / a.lit(1000))),
        a.F.minute(a.F.timestamp_millis("l")),
        a.F.second(a.F.timestamp_micros("l"))],
        "exact"),
    "hashes": (lambda a: [
        a.F.hash("i", "s"), a.F.xxhash64("l", "d"), a.F.md5("s")],
        "exact"),
    "collections": (lambda a: [
        a.F.size("arr"), a.F.get_item("arr", 1),
        a.F.array_contains("arr", 3), a.F.array_min("arr"),
        a.F.array_max("arr"), a.F.sort_array("arr"),
        a.F.array(a.col("i"), a.col("j"))],
        "exact"),
    "nested": (lambda a: [
        a.F.get_field(a.F.struct(a.col("i"), a.col("d")), "d"),
        a.F.map_keys(a.F.create_map(_key(a), a.col("p"))),
        a.F.map_values(a.F.create_map(_key(a), a.col("l"))),
        a.F.get_map_value(a.F.create_map(_key(a), a.col("l")),
                          a.col("j"))],
        "exact"),
    "higher_order": (lambda a: [
        a.F.transform("arr", lambda x: x * a.lit(2) + a.col("i")),
        a.F.exists("arr", lambda x: x > a.lit(3)),
        a.F.forall("arr", lambda x: x > a.lit(-5)),
        a.F.transform_values(a.F.create_map(_key(a), a.col("l")),
                             lambda k, v: v + k)],
        "exact"),
    "arrays_of_structs": (lambda a: [
        a.F.map_entries(a.F.create_map(_key(a), a.col("p"))),
        a.F.arrays_zip(a.col("arr"), a.F.array(a.col("i")))],
        None),
}


def _select(api, conf, case):
    jt, tt = _tables()
    t, sess = (jt, TpuSession(conf)) if api is REF else (
        tt, TorchSession(conf, device="cpu"))
    exprs = CASES[case][0](api)
    return api.frm(t, sess).select(
        *[e.alias(f"c{i}") for i, e in enumerate(exprs)]).collect_table()


@pytest.mark.parametrize("case", [c for c, (_, cmp) in CASES.items()
                                  if cmp != "device only"])
def test_eval_cpu_equals_the_reference(case):
    want = _select(REF, OFF, case)
    got = _select(PORT, OFF, case)
    assert nested_differ(want, got) is None, nested_differ(want, got)


@pytest.mark.parametrize("case", [c for c, (_, cmp) in CASES.items()
                                  if cmp is not None])
def test_eval_cpu_equals_the_device_form(case):
    host = as_reference(_select(PORT, OFF, case))
    dev = as_reference(_select(PORT, None, case))
    if CASES[case][1] in ("exact", "device only"):
        assert tables_differ(host, dev) is None, tables_differ(host, dev)
    else:
        assert tables_close(host, dev, rtol=1e-12) is None



def _half_up(q) -> int:
    """A Fraction rounded half away from zero (Spark's HALF_UP)."""
    whole, rest = divmod(abs(q.numerator), q.denominator)
    whole += 2 * rest >= q.denominator
    return -whole if q < 0 else whole


@pytest.mark.parametrize("c, rhs, rhs_scale", [(0, "m", 2), (1, "i", 0)])
def test_decimal_division_equals_exact_half_up(c, rhs, rhs_scale):
    """The route's decimal division against exact rational arithmetic
    (Python ints), HALF_UP at the result's scale, null on a zero divisor
    or past the result's precision: an independent witness where the
    reference's host form is wrong. On the rows with a positive divisor
    the reference's device path (``TpuSession(None)``) agrees too; its
    device path and host form alike round a negative divisor's quotient
    toward the wrong side."""
    from fractions import Fraction
    _, tt = _tables()
    got = as_reference(_select(PORT, OFF, "decimal_division")).columns[c]
    ref = _select(REF, None, "decimal_division").columns[c]
    lhs = tt.columns[tt.names.index("m")]
    div = tt.columns[tt.names.index(rhs)]
    prec, scale = got.dtype.precision, got.dtype.scale
    for r in range(N):
        ok = bool(lhs.validity[r] and div.validity[r] and div.data[r] != 0)
        want = None
        if ok:
            q = Fraction(int(lhs.data[r]) * 10 ** rhs_scale,
                         int(div.data[r]) * 10 ** 2) * 10 ** scale
            want = _half_up(q)
            ok = abs(want) < 10 ** prec
        assert bool(got.validity[r]) == ok, r
        if ok:
            assert int(got.data[r]) == want, (r, int(got.data[r]), want)
            if div.data[r] > 0:
                assert ref.validity[r] and int(ref.data[r]) == want, r
