"""The port's date and time expressions (``ops/datetime.py``, the
timezone shifts of ``ops/misc.py`` over the copied ``ops/tzdb.py``)
against the JAX package's ``TpuSession`` on the same numpy inputs: dates
across 1900-2100 (pre-1970 negatives, leap days, month ends, the epoch),
timestamps before and after 1970 at sub-second offsets, and strings to
parse; and ``DATE +/- INTERVAL`` lowered from SQL text by both analyzers.

Comparator: ``scale_test.tables_differ`` (bitwise, in order) for every
case. Fields before 1970 floor (Spark's semantics): hour, minute and
second of a negative timestamp, dayofweek of a negative day."""

import datetime as dt

import numpy as np
import pytest
import torch

from scale_test import tables_differ
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.ops import datetime as JD
from spark_rapids_tpu.ops import misc as JM
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.ops.expr import lit as jlit
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.ops import datetime as TD
from spark_rapids_tpu_torch.ops import misc as TM
from spark_rapids_tpu_torch.ops import tzdb
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.ops.expr import lit as tlit
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.session import TorchSession

EPOCH = dt.date(1970, 1, 1)
US = 1_000_000


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _days(*dates):
    return [(d - EPOCH).days for d in dates]


def _table(n=240, seed=3):
    """d: dates (edges, then seeded over 1900-2100); n: month and day
    counts; ts: timestamps (edges around 1970 and DST changes, then
    seeded); s: strings to parse."""
    rng = np.random.default_rng(seed)
    edges = _days(dt.date(1970, 1, 1), dt.date(1969, 12, 31),
                  dt.date(2000, 2, 29), dt.date(1900, 2, 28),
                  dt.date(2024, 1, 31), dt.date(2023, 1, 31),
                  dt.date(2024, 12, 31), dt.date(1999, 3, 31),
                  dt.date(1960, 5, 31), dt.date(2100, 12, 31))
    d = np.array(edges + list(rng.integers(-25567, 47482, n - len(edges))),
                 dtype=np.int32)
    k = rng.integers(-30, 31, n).astype(np.int32)
    k[:4] = [1, -1, 12, 13]
    ts_edges = [0, -1, -US, -US - 1, 3_600 * US - 1, -86_400 * US + 1,
                1710064800 * US, 1710064800 * US - 1,  # a US DST change
                1730624400 * US, 1730624400 * US + 1, 1699174800 * US]
    ts = np.array(ts_edges + list(rng.integers(-2_000_000_000, 4_000_000_000,
                                               n - len(ts_edges)) * US
                                  + rng.integers(0, US, n - len(ts_edges))),
                  dtype=np.int64)
    texts = ["2024-01-31 12:34:56", "1969-12-31 23:59:59", "bad",
             " 2000-02-29 00:00:00 ", "2023-02-29 10:00:00", ""]
    s = np.array([texts[i % len(texts)] for i in range(n)], dtype=object)
    ones = np.ones(n, bool)
    vd, vt = ones.copy(), ones.copy()
    vd[7::17] = False
    vt[9::13] = False
    return (["d", "k", "ts", "s"], ["date", "int", "timestamp", "string"],
            [(d, vd), (k, ones), (ts, vt), (s, ones)])


def _as_reference(names, types, arrays) -> JHostTable:
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, np.asarray(v, dtype=bool))
        for ty, (d, v) in zip(types, arrays)])


class _Api:
    def __init__(self, F, D, M, col, lit):
        self.F, self.D, self.M, self.col, self.lit = F, D, M, col, lit

    def from_utc(self, c, zone):
        return self.M.FromUTCTimestamp(self.col(c), self.lit(zone))


PORT = _Api(TF, TD, TM, tcol, tlit)
REF = _Api(JF, JD, JM, jcol, jlit)


def _select_both(exprs, table=None):
    table = table or _table()
    ref = jfrom(_as_reference(*table), TpuSession()).select(
        *[e.alias(n) for n, e in exprs(REF)]).collect_table()
    got = tfrom(host_table_from_arrays(*table),
                TorchSession(device="cpu")).select(
        *[e.alias(n) for n, e in exprs(PORT)]).collect_table()
    return _as_reference(*got.to_arrays()), ref


CASES = {
    "date fields": lambda a: [
        ("y", a.F.year("d")), ("m", a.F.month("d")),
        ("dom", a.F.dayofmonth("d")), ("dow", a.F.dayofweek("d")),
        ("wd", a.F.weekday("d")), ("doy", a.F.dayofyear("d")),
        ("q", a.F.quarter("d")), ("last", a.F.last_day("d"))],
    "date arithmetic": lambda a: [
        ("add", a.F.date_add("d", "k")), ("sub", a.F.date_sub("d", "k")),
        ("add7", a.F.date_add(a.col("d"), a.lit(7))),
        ("diff", a.F.datediff(a.F.date_add("d", "k"), a.col("d"))),
        ("am", a.F.add_months("d", "k")),
        ("am1", a.F.add_months(a.col("d"), a.lit(1))),
        ("last_next", a.F.last_day(a.F.add_months(a.col("d"), a.lit(1))))],
    "timestamp fields": lambda a: [
        ("h", a.F.hour("ts")), ("mi", a.F.minute("ts")),
        ("sec", a.F.second("ts")), ("unix", a.F.to_unix_timestamp("ts")),
        ("day", a.F.to_date("ts")),
        ("secs", a.F.timestamp_seconds("k")),
        ("millis", a.F.timestamp_millis("k")),
        ("micros", a.F.timestamp_micros("k"))],
    # the zone as a literal (the reference's F.from_utc_timestamp reads a
    # string argument as a column name)
    "timezones": lambda a: [
        ("la", a.from_utc("ts", "America/Los_Angeles")),
        ("la_back", a.M.ToUTCTimestamp(
            a.from_utc("ts", "America/Los_Angeles"),
            a.lit("America/Los_Angeles"))),
        ("ist", a.from_utc("ts", "+05:30")),
        ("utc", a.M.ToUTCTimestamp(a.col("ts"), a.lit("UTC"))),
        ("gmt", a.from_utc("ts", "GMT-08:00")),
        ("berlin", a.M.ToUTCTimestamp(a.col("ts"), a.lit("Europe/Berlin"))),
        ("h_ny", a.F.hour(a.from_utc("ts", "America/New_York")))],
    "parsing": lambda a: [
        ("u", a.D.UnixTimestamp(a.col("s"), a.lit("yyyy-MM-dd HH:mm:ss"))),
        ("ud", a.D.ToUnixTimestamp(a.col("s"), a.lit("yyyy-MM-dd HH:mm:ss"))),
        ("gt", a.D.GetTimestamp(a.col("s"), a.lit("yyyy-MM-dd HH:mm:ss"))),
        ("plus", a.D.TimeAdd(a.col("ts"), a.lit(90 * US))),
        ("precise", a.D.PreciseTimestampConversion(a.col("ts"), False))],
}


@pytest.mark.parametrize("case", list(CASES))
def test_datetime_functions_match_the_reference(case):
    got, ref = _select_both(CASES[case])
    assert tables_differ(got, ref) is None, tables_differ(got, ref)


def test_floor_semantics_before_1970_and_month_end_clamping():
    """Pinned values: -1 micro is 23:59:59 of 1969-12-31 (a Wednesday =
    4); 2024-01-31 plus one month is Feb 29, 2024 (a leap year), plus 13
    months Feb 28, 2025."""
    table = (["ts", "d"], ["timestamp", "date"],
             [(np.array([-1], dtype=np.int64), np.ones(1, bool)),
              (np.array(_days(dt.date(2024, 1, 31)), dtype=np.int32),
               np.ones(1, bool))])
    got = tfrom(host_table_from_arrays(*table), TorchSession(
        device="cpu")).select(
        TF.hour("ts").alias("h"), TF.minute("ts").alias("m"),
        TF.second("ts").alias("s"), TF.dayofweek(TF.to_date("ts")).alias(
            "dow"), TF.add_months("d", 1).alias("feb"),
        TF.add_months("d", 13).alias("feb23")).collect()
    assert got == [(23, 59, 59, 4, *_days(dt.date(2024, 2, 29),
                                          dt.date(2025, 2, 28)))]


def test_date_interval_arithmetic_from_sql_matches_the_reference():
    """DATE +/- INTERVAL folds onto AddMonths, then DateAdd/DateSub, as in
    the reference's analyzer (the cases that raised until this slice)."""
    table = _table()
    text = ("SELECT d + INTERVAL 3 DAYS AS d2, d - INTERVAL 1 WEEK AS d3, "
            "d + INTERVAL 1 YEAR AS d4, d - INTERVAL 2 MONTHS 5 DAYS AS d5, "
            "DATE '2024-01-31' + INTERVAL 1 MONTH AS d6 FROM x "
            "WHERE d < DATE '2000-01-01' + INTERVAL 10 YEARS")
    js, ts = TpuSession(), TorchSession(device="cpu")
    jfrom(_as_reference(*table), js).create_or_replace_temp_view("x")
    tfrom(host_table_from_arrays(*table), ts).create_or_replace_temp_view("x")
    got = ts.sql(text).collect_table()
    want = js.sql(text).collect_table()
    diff = tables_differ(_as_reference(*got.to_arrays()), want)
    assert diff is None, diff
    assert 0 < got.num_rows


def test_untranslatable_or_non_literal_parameters_raise():
    df = tfrom(host_table_from_arrays(*_table()), TorchSession(device="cpu"))
    with pytest.raises(NotImplementedError, match="format"):
        df.select(TD.UnixTimestamp(tcol("s"), tlit("yyyy-MM-dd a")).alias(
            "x"))
    with pytest.raises(NotImplementedError, match="non-literal"):
        df.select(TD.TimeAdd(tcol("ts"), tcol("k")).alias("x"))
    with pytest.raises(NotImplementedError, match="zoneinfo"):
        df.select(TF.from_utc_timestamp("ts", "Mars/Olympus").alias("x"))
    assert TD.translate_java_format("yyyy-MM-dd HH:mm:ss") == \
        "%Y-%m-%d %H:%M:%S"
    assert TD.translate_java_format("EEE") is None


def test_zone_tables_are_the_reference_tables():
    """The copied transition scan gives the reference's tables, and the
    device lookup its host lookup."""
    from spark_rapids_tpu.ops import tzdb as jtzdb
    for zone in ("America/Los_Angeles", "Australia/Lord_Howe"):
        for a, b in zip(tzdb.TimeZoneDB.tables(zone),
                        jtzdb.TimeZoneDB.tables(zone)):
            assert np.array_equal(a, b)
        ts = _table()[2][2][0]
        assert np.array_equal(
            tzdb.from_utc_micros_dev(torch.from_numpy(ts), zone).numpy(),
            tzdb.from_utc_micros_host(ts, zone))
        assert np.array_equal(
            tzdb.to_utc_micros_dev(torch.from_numpy(ts), zone).numpy(),
            tzdb.to_utc_micros_host(ts, zone))
