"""ANSI mode (``spark.sql.ansi.enabled``) in the port, held against the JAX
package's on the same numpy inputs.

Every case of ``tests/test_ansi.py`` runs on both routes of both
packages: the device route (the port's device walks on the CPU, the
reference's XLA programs) and the CPU route (``spark.rapids.sql.enabled=
false``). A violation must raise the package's ``AnsiViolation`` with the
reference's message on the same route ("[ANSI] <label>" from a device
flag, "<what> (spark.sql.ansi.enabled)" from the CPU route); where
nothing is violated the results must be identical (``tables_differ``).

Pinned deviations:

* a string cast runs on the port's CPU route (its device casts no
  strings), so the port's device session raises the CPU route's message
  for it;
* ``pmod`` by zero raises in the port (Spark's ANSI rule); the
  reference's Pmod has no ANSI check and returns null;
* a raising predicate of a filter the aggregate fuses raises in the
  port, as the unfused plan does; the reference's fused aggregate
  checks nothing there and answers.

Beyond the reference's cases: guarded and nested-guarded branches, a
violation only rows an earlier filter removed would hit, the filter that
``agg.fuseInput`` folds into the aggregate (on and off), a violation
leaving the speculation blocklist, the circuit breaker, the health
monitor and the quarantine as they were, the flags' delivery (with the
result's row count under speculation, one immediate read per walk
without it), the executable cache keyed by the mode, and a query service
submission that ends FAILED while the next query answers bit for bit.
"""

import numpy as np
import pytest

from scale_test import tables_differ
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.errors import AnsiViolation as JAnsiViolation
from spark_rapids_tpu.ops import arithmetic as JA
from spark_rapids_tpu.ops.collections import GetArrayItem as JGetArrayItem
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.ops.expr import lit as jlit
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch import types as TT
from spark_rapids_tpu_torch.errors import AnsiViolation
from spark_rapids_tpu_torch.ops import arithmetic as TA
from spark_rapids_tpu_torch.ops.collections import GetArrayItem
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.ops.expr import lit as tlit
from spark_rapids_tpu_torch.session import TorchSession
from tests.torch_service_util import as_reference, reset_process_state

I64MAX = np.iinfo(np.int64).max
I64MIN = np.iinfo(np.int64).min

ANSI = {"spark.sql.ansi.enabled": "true"}
#: the two routes: the device walks, and the CPU route
ROUTES = {"device": {}, "cpu": {"spark.rapids.sql.enabled": "false"}}


class _Api:
    def __init__(self, col, lit, F, A, T, get_item, violation, session):
        self.col, self.lit, self.F, self.A, self.T = col, lit, F, A, T
        self.get_item = get_item
        self.violation = violation
        self.session = session


PORT = _Api(tcol, tlit, TF, TA, TT, GetArrayItem, AnsiViolation,
            lambda conf: TorchSession(conf, device="cpu"))
REF = _Api(jcol, jlit, JF, JA, JT, JGetArrayItem, JAnsiViolation,
           lambda conf: TpuSession(conf))


@pytest.fixture(autouse=True)
def _clean_state():
    reset_process_state()
    yield
    reset_process_state()


def _conf(route, ansi=True, **extra):
    return {**(ANSI if ansi else {}), **ROUTES[route], **extra}


def _outcome(api, conf, data, build, dtypes=None):
    """("raise", message) or ("ok", the result table)."""
    s = api.session(conf)
    df = s.create_dataframe(data, dtypes=dtypes)
    try:
        return "ok", build(api, df).collect_table()
    except api.violation as e:
        return "raise", str(e)


def _both_raise(route, data, build, dtypes=None, port_route=None):
    """Both packages raise their AnsiViolation on ``route``, with one
    message (the reference's on ``port_route`` when the port runs the
    case on another route)."""
    got = _outcome(PORT, _conf(route), data, build, dtypes)
    want = _outcome(REF, _conf(port_route or route), data, build, dtypes)
    assert want[0] == "raise", want
    assert got == want, (got, want)
    return got[1]


# --- the reference's cases, on both routes ----------------------------------

OVERFLOWS = {
    "add": (lambda a: a.col("x") + a.lit(1), [1, I64MAX], "+"),
    "subtract": (lambda a: a.col("x") - a.lit(1), [0, I64MIN], "-"),
    "multiply": (lambda a: a.col("x") * a.lit(3), [5, I64MAX // 2 + 1],
                 "*"),
    "negate": (lambda a: -a.col("x"), [1, I64MIN], "negate"),
    "abs": (lambda a: a.F.abs(a.col("x")), [1, I64MIN], "abs"),
}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("case", list(OVERFLOWS))
def test_integral_overflow_raises_both_paths(route, case):
    expr, vals, sym = OVERFLOWS[case]
    msg = _both_raise(route, {"x": np.asarray(vals, dtype=np.int64)},
                      lambda a, df: df.select(expr(a).alias("y")))
    assert f"integer overflow in {sym}" in msg


DIV_ZERO = {
    "divide": lambda a: a.col("x") / a.lit(0.0),
    "remainder": lambda a: a.col("x") % a.lit(0),
    "integral_divide": lambda a: a.A.IntegralDivide(a.col("x"), a.lit(0)),
}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("case", list(DIV_ZERO))
def test_divide_by_zero_raises_both_paths(route, case):
    msg = _both_raise(route, {"x": np.asarray([1, 2], dtype=np.int64)},
                      lambda a, df: df.select(DIV_ZERO[case](a).alias("y")))
    assert "divide by zero" in msg


CASTS = {
    "long_to_int": ({"x": np.asarray([1, 1 << 40], dtype=np.int64)},
                    "x", "int"),
    "double_to_int": ({"f": np.asarray([1.5, 3e18])}, "f", "int"),
    "nan_to_bigint": ({"f": np.asarray([np.nan, 1.0])}, "f", "bigint"),
}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("case", list(CASTS))
def test_cast_overflow_raises_both_paths(route, case):
    data, c, to = CASTS[case]
    msg = _both_raise(route, data, lambda a, df: df.select(
        a.col(c).cast(to).alias("y")))
    assert f"cast overflow to {to}" in msg


@pytest.mark.parametrize("route", list(ROUTES))
def test_string_cast_failure_raises_both_paths(route):
    # the port casts strings on its CPU route only: the reference's CPU
    # route's message on both of the port's routes
    msg = _both_raise(route, {"s": ["12", "oops"]}, lambda a, df: df.select(
        a.col("s").cast("int").alias("y")), dtypes={"s": None},
        port_route="cpu")
    assert msg == "invalid input for cast to int (spark.sql.ansi.enabled)"


@pytest.mark.parametrize("route", list(ROUTES))
def test_array_index_out_of_bounds(route):
    msg = _both_raise(route, {"a": np.asarray([1, 2], dtype=np.int64)},
                      lambda a, df: df.select(a.get_item(
                          a.F.array(a.col("a")), a.lit(3)).alias("y")))
    assert "out of bounds" in msg


@pytest.mark.parametrize("fuse", ["true", "false"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_ansi_error_in_filter_predicate(route, fuse):
    """A raising predicate, under a plain filter and under the filter an
    aggregate fuses (``spark.rapids.tpu.agg.fuseInput``)."""
    data = {"x": np.asarray([1, I64MAX], dtype=np.int64)}

    def plain(a, df):
        return df.filter((a.col("x") + a.lit(1)) > a.lit(0))

    def fused(a, df):
        return plain(a, df).group_by("x").agg(a.F.count().alias("n"))

    conf = _conf(route, **{"spark.rapids.tpu.agg.fuseInput": fuse})
    for build in (plain, fused):
        got = _outcome(PORT, conf, data, build)
        want = _outcome(REF, conf, data, build)
        assert got[0] == "raise", got
        if build is fused and route == "device" and fuse == "true":
            # the reference's fused aggregate evaluates the predicate as a
            # weight mask with no ANSI check and answers; the port raises
            # there as the unfused plan does
            assert want[0] == "ok", want
            want = _outcome(REF, _conf(route, **{
                "spark.rapids.tpu.agg.fuseInput": "false"}), data, build)
        assert got == want


@pytest.mark.parametrize("route", list(ROUTES))
def test_no_violation_matches_legacy_results(route):
    rng = np.random.default_rng(0)
    data = {"x": rng.integers(-1000, 1000, 5000).astype(np.int64),
            "y": rng.integers(1, 50, 5000).astype(np.int64)}

    def q(a, df):
        return df.select((a.col("x") * a.col("y")).alias("m"),
                         (a.col("x") % a.col("y")).alias("r"),
                         a.col("x").cast("int").alias("i"))
    ansi = _outcome(PORT, _conf(route), data, q)
    legacy = _outcome(PORT, _conf(route, ansi=False), data, q)
    ref = _outcome(REF, _conf(route), data, q)
    assert ansi[0] == legacy[0] == ref[0] == "ok"
    assert tables_differ(as_reference(ansi[1]),
                         as_reference(legacy[1])) is None
    assert tables_differ(ref[1], as_reference(ansi[1])) is None


@pytest.mark.parametrize("route", list(ROUTES))
def test_legacy_mode_still_wraps_and_nulls(route):
    data = {"x": np.asarray([I64MAX, 4], dtype=np.int64)}

    def q(a, df):
        return df.select((a.col("x") + a.lit(1)).alias("w"),
                         (a.col("x") % a.lit(0)).alias("z"))
    got = _outcome(PORT, _conf(route, ansi=False), data, q)
    want = _outcome(REF, _conf(route, ansi=False), data, q)
    assert tables_differ(want[1], as_reference(got[1])) is None
    rows = got[1].to_pydict()
    assert rows["w"][0] == I64MIN  # wrapped
    assert rows["z"][0] is None    # null on a zero divisor


def test_ansi_violation_not_blocklisted_as_speculation():
    """An ANSI error raises AnsiViolation: no replay, no blocklist entry,
    no breaker failure, no demotion, no latch, no quarantine strike; the
    next query of the session answers as an unviolated session does."""
    from spark_rapids_tpu_torch.runtime import speculation as spec
    from spark_rapids_tpu_torch.runtime.faults import (
        CIRCUIT_BREAKER,
        RECOVERY,
    )
    from spark_rapids_tpu_torch.runtime.health import HEALTH, QUARANTINE
    before = (set(spec._BLOCKLIST), RECOVERY.snapshot(), HEALTH.snapshot(),
              QUARANTINE.snapshot(), dict(CIRCUIT_BREAKER._failures))
    s = TorchSession(ANSI, device="cpu")
    df = s.create_dataframe({"x": np.asarray([I64MAX], dtype=np.int64)})
    with pytest.raises(AnsiViolation, match=r"^\[ANSI\] integer overflow"):
        df.select((tcol("x") + tlit(1)).alias("y")).collect()
    assert s.last_metrics().get("speculationReplays", 0) == 0
    after = (set(spec._BLOCKLIST), RECOVERY.snapshot(), HEALTH.snapshot(),
             QUARANTINE.snapshot(), dict(CIRCUIT_BREAKER._failures))
    assert after == before
    ok = s.create_dataframe({"x": np.asarray([1, 2], dtype=np.int64)})
    got = ok.select((tcol("x") + tlit(1)).alias("y")).collect_table()
    want = TorchSession(device="cpu").create_dataframe(
        {"x": np.asarray([1, 2], dtype=np.int64)}).select(
        (tcol("x") + tlit(1)).alias("y")).collect_table()
    assert tables_differ(as_reference(want), as_reference(got)) is None


@pytest.mark.parametrize("route", list(ROUTES))
def test_ansi_guarded_branches_do_not_raise(route):
    """CASE WHEN b != 0 THEN a / b ELSE 0 and its IF form do not raise for
    the rows the predicate excludes; an unguarded division still does."""
    data = {"a": np.asarray([10.0, 20.0]), "b": np.asarray([0.0, 2.0])}

    def case_when(a, df):
        return df.select(a.F.when(a.col("b") != a.lit(0.0),
                                  a.col("a") / a.col("b"))
                         .otherwise(a.lit(0.0)).alias("r"))

    def if_form(a, df):
        return df.select(a.F.expr_if(a.col("b") != a.lit(0.0),
                                     a.col("a") / a.col("b"),
                                     a.lit(-1.0)).alias("r"))

    def unguarded(a, df):
        return df.select((a.col("a") / a.col("b")).alias("r"))

    got = _outcome(PORT, _conf(route), data, case_when)
    want = _outcome(REF, _conf(route), data, case_when)
    assert got[1].to_pydict() == {"r": [0.0, 10.0]}
    assert tables_differ(want[1], as_reference(got[1])) is None
    # the reference's F has no expr_if: the port's IF against the value
    # the reference's CASE WHEN gives for it
    if hasattr(TF, "expr_if"):
        got_if = _outcome(PORT, _conf(route), data, if_form)
        assert got_if[1].to_pydict() == {"r": [-1.0, 10.0]}
    else:
        from spark_rapids_tpu_torch.ops.conditional import If
        got_if = _outcome(PORT, _conf(route), data, lambda a, df: df.select(
            If(a.col("b") != a.lit(0.0), a.col("a") / a.col("b"),
               a.lit(-1.0)).alias("r")))
        assert got_if[1].to_pydict() == {"r": [-1.0, 10.0]}
    one = {"a": np.asarray([10.0]), "b": np.asarray([0.0])}
    got = _outcome(PORT, _conf(route), one, unguarded)
    assert got == _outcome(REF, _conf(route), one, unguarded)
    assert got[0] == "raise"


@pytest.mark.parametrize("route", list(ROUTES))
def test_ansi_nested_guards(route):
    data = {"a": np.asarray([1.0, 4.0]), "b": np.asarray([0.0, 2.0]),
            "c": np.asarray([0.0, 1.0])}

    def q(a, df):
        return df.select(
            a.F.when(a.col("b") != a.lit(0.0),
                     a.F.when(a.col("c") != a.lit(0.0),
                              a.col("a") / a.col("c"))
                     .otherwise(a.col("a") / a.col("b")))
            .otherwise(a.lit(0.0)).alias("r"))
    got = _outcome(PORT, _conf(route), data, q)
    want = _outcome(REF, _conf(route), data, q)
    assert got[1].to_pydict() == {"r": [0.0, 4.0]}
    assert tables_differ(want[1], as_reference(got[1])) is None


# --- beyond the reference's cases -------------------------------------------

@pytest.mark.parametrize("fuse", ["true", "false"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_rows_an_earlier_filter_removed_do_not_raise(route, fuse):
    """x + 1 overflows only on the row the filter drops: with the filter
    fused into the aggregate (or not), nothing raises, and the sums are
    the reference's."""
    data = {"k": np.asarray([1, 1, 2], dtype=np.int64),
            "x": np.asarray([5, I64MAX, 7], dtype=np.int64)}

    def q(a, df):
        return df.filter(a.col("x") < a.lit(100)).select(
            "k", (a.col("x") + a.lit(1)).alias("y")).group_by("k").agg(
            a.F.sum("y").alias("s")).sort("k")
    conf = _conf(route, **{"spark.rapids.tpu.agg.fuseInput": fuse})
    got = _outcome(PORT, conf, data, q)
    want = _outcome(REF, conf, data, q)
    assert got[0] == want[0] == "ok", (got, want)
    assert tables_differ(want[1], as_reference(got[1])) is None
    assert got[1].to_pydict() == {"k": [1, 2], "s": [6, 8]}


@pytest.mark.parametrize("route", list(ROUTES))
def test_pmod_by_zero_raises_in_the_port(route):
    """Spark's ANSI pmod raises on a zero divisor; the reference's Pmod
    has no check and returns null (a pinned deviation)."""
    data = {"x": np.asarray([3, 4], dtype=np.int64)}
    got = _outcome(PORT, _conf(route), data, lambda a, df: df.select(
        a.A.Pmod(a.col("x"), a.lit(0)).alias("p")))
    assert got[0] == "raise" and "divide by zero" in got[1]
    want = _outcome(REF, _conf(route), data, lambda a, df: df.select(
        a.A.Pmod(a.col("x"), a.lit(0)).alias("p")))
    assert want[0] == "ok" and want[1].to_pydict() == {"p": [None, None]}


def test_flags_ride_the_row_count_read(monkeypatch):
    """Under speculation the walk's ANSI flags are read in one copy with
    the result's row count, and nothing is left for a read of its own."""
    from spark_rapids_tpu_torch.runtime import speculation as spec
    calls = {"with_count": 0, "validate_read": 0}
    real_read = spec.SpecContext.read_with_ansi
    real_check = spec.check_flag_values

    def read(self, count):
        calls["with_count"] += 1
        return real_read(self, count)

    def check(sites, values):
        if sites:
            calls["validate_read"] += 1
        return real_check(sites, values)
    monkeypatch.setattr(spec.SpecContext, "read_with_ansi", read)
    monkeypatch.setattr(spec, "check_flag_values", check)
    s = TorchSession(ANSI, device="cpu")
    df = s.create_dataframe({"x": np.arange(100, dtype=np.int64)})
    got = df.select((tcol("x") * tlit(3)).alias("y"),
                    (tcol("x") - tlit(1)).alias("z")).collect_table()
    assert calls["with_count"] == 1
    # the values read with the count are checked once, at validation
    assert calls["validate_read"] == 1
    assert got.to_pydict()["y"][:3] == [0, 3, 6]


def test_speculation_off_reads_once_per_walk(monkeypatch):
    """With speculative sizing off, each device walk that recorded flags
    reads them at once (one copy for the walk's flags)."""
    from spark_rapids_tpu_torch.runtime import speculation as spec
    reads = []
    real = spec.check_flag_values

    def check(sites, values):
        reads.append(list(sites))
        return real(sites, values)
    monkeypatch.setattr(spec, "check_flag_values", check)
    s = TorchSession({**ANSI, "spark.rapids.tpu.speculativeSizing.enabled":
                      "false"}, device="cpu")
    df = s.create_dataframe({"x": np.arange(10, dtype=np.int64)})
    df.select((tcol("x") * tlit(3)).alias("y")).collect()
    assert reads == [["ansi:integer overflow in *"]]
    reads.clear()
    with pytest.raises(AnsiViolation, match="overflow in \\+"):
        s.create_dataframe({"x": np.asarray([I64MAX])}).select(
            (tcol("x") + tlit(1)).alias("y")).collect()
    assert reads == [["ansi:integer overflow in +"]]


def test_ansi_off_records_nothing(monkeypatch):
    """With ANSI off no flag is recorded, so nothing is read for one."""
    from spark_rapids_tpu_torch.runtime import speculation as spec
    seen = []
    real = spec.SpecContext.add_flag

    def add(self, site, flag):
        seen.append(site)
        return real(self, site, flag)
    monkeypatch.setattr(spec.SpecContext, "add_flag", add)
    s = TorchSession(device="cpu")
    df = s.create_dataframe({"x": np.asarray([I64MAX, 1], dtype=np.int64)})
    got = df.select((tcol("x") + tlit(1)).alias("y")).collect()
    assert got == [(I64MIN,), (2,)]
    assert not [x for x in seen if x.startswith(spec.ANSI_PREFIX)]


def test_the_mode_keys_the_executable_cache():
    """One plan with ANSI off then on: the second run converts afresh (the
    key folds into the fingerprint) and raises."""
    from spark_rapids_tpu_torch.plan.fingerprint import fingerprint
    from spark_rapids_tpu_torch.conf import RapidsConf
    s = TorchSession(device="cpu")
    df = s.create_dataframe({"x": np.asarray([I64MAX], dtype=np.int64)})
    q = df.select((tcol("x") + tlit(1)).alias("y"))
    assert fingerprint(q.plan, RapidsConf()) != fingerprint(
        q.plan, RapidsConf(ANSI))
    assert q.collect() == [(I64MIN,)]
    s.set_conf("spark.sql.ansi.enabled", "true")
    with pytest.raises(AnsiViolation):
        q.collect()
    assert not s.last_executable_cache_hit


def test_a_service_submission_ends_failed():
    """Under the query service the violating query ends FAILED with the
    error; the next query on the same service answers bit for bit."""
    from spark_rapids_tpu_torch.service import QueryService, QueryState
    svc = QueryService(dict(ANSI), device="cpu")
    try:
        bad = svc.session.create_dataframe(
            {"x": np.asarray([1, I64MAX], dtype=np.int64)}).select(
            (tcol("x") + tlit(1)).alias("y"))
        h = svc.submit(bad)
        assert h.wait(60)
        assert h.state == QueryState.FAILED
        assert isinstance(h.error, AnsiViolation)
        with pytest.raises(AnsiViolation):
            h.result(1)
        good = svc.session.create_dataframe(
            {"x": np.asarray([1, 2], dtype=np.int64)}).select(
            (tcol("x") * tlit(2)).alias("y"))
        got = svc.submit(good).result(60)
    finally:
        svc.shutdown()
    want = TorchSession(device="cpu").create_dataframe(
        {"x": np.asarray([1, 2], dtype=np.int64)}).select(
        (tcol("x") * tlit(2)).alias("y")).collect_table()
    assert tables_differ(as_reference(want), as_reference(got)) is None
