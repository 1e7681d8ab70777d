"""The TIMESTAMP literal (``ops/expr.py::Literal``) through the port's
session on the CPU against the JAX package's device path
(``TpuSession()``) on the same numpy table: a timestamp column compared
with literals in a filter and a projection, from the DSL
(``lit(datetime)``) and from SQL text (``TIMESTAMP '...'``, what a client
of the query service may submit), naive datetimes reading as UTC as in the
reference, and a literal before 1970.

Comparator: ``scale_test.tables_differ`` (bitwise, in order) for every
case."""

import datetime as dt

import numpy as np
import pytest
import torch

from scale_test import tables_differ
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.ops.expr import lit as jlit
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.ops.expr import lit as tlit
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.session import TorchSession

US = 1_000_000


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _table(n=300, seed=5):
    """ts: seeded timestamps over 1906-2096 at microsecond offsets, with
    the literals' own instants and their neighbours; k: a key; nulls in
    ts."""
    rng = np.random.default_rng(seed)
    edges = [0, -1, 1577836800 * US, 1577836800 * US - 1,
             1577836800 * US + 1, -86_400 * US * 365, 951782400 * US]
    ts = np.array(edges + list(
        rng.integers(-2_000_000_000, 4_000_000_000, n - len(edges)) * US
        + rng.integers(0, US, n - len(edges))), dtype=np.int64)
    k = (np.arange(n) % 7).astype(np.int64)
    vt = np.ones(n, bool)
    vt[11::17] = False
    return (["ts", "k"], ["timestamp", "bigint"],
            [(ts, vt), (k, np.ones(n, bool))])


def _as_reference(names, types, arrays) -> JHostTable:
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, np.asarray(v, dtype=bool))
        for ty, (d, v) in zip(types, arrays)])


LITERALS = (dt.datetime(2020, 1, 1), dt.datetime(1969, 1, 1, 0, 0, 0, 1),
            dt.datetime(2000, 2, 29, 12, 30, 15, 250000))


@pytest.mark.parametrize("when", LITERALS, ids=str)
def test_dsl_timestamp_literal_matches_the_reference(when):
    table = _table()

    def query(df, F, col, lit):
        return df.filter(col("ts") < lit(when)).select(
            col("k"), col("ts"), (col("ts") >= lit(when)).alias("ge"),
            F.coalesce(col("ts"), lit(when)).alias("filled"))

    ref = query(jfrom(_as_reference(*table), TpuSession()), JF, jcol,
                jlit).collect_table()
    got = query(tfrom(host_table_from_arrays(*table),
                      TorchSession(device="cpu")), TF, tcol,
                tlit).collect_table()
    assert got.num_rows > 0
    assert tables_differ(_as_reference(*got.to_arrays()), ref) is None


@pytest.mark.parametrize("text", ["2020-01-01 00:00:00",
                                  "1969-12-31 23:59:59.999999",
                                  "2000-02-29 12:30:15.25"])
def test_sql_timestamp_literal_matches_the_reference(text):
    table = _table()
    sql = (f"SELECT k, ts, ts = TIMESTAMP '{text}' AS eq FROM t "
           f"WHERE ts < TIMESTAMP '{text}' OR k = 3")
    js = TpuSession()
    jfrom(_as_reference(*table), js).create_or_replace_temp_view("t")
    ts = TorchSession(device="cpu")
    tfrom(host_table_from_arrays(*table), ts).create_or_replace_temp_view(
        "t")
    want = js.sql(sql).collect_table()
    got = ts.sql(sql).collect_table()
    assert got.num_rows > 0
    assert tables_differ(_as_reference(*got.to_arrays()), want) is None


def test_timestamp_literal_holds_utc_microseconds():
    """A naive datetime reads as UTC (the reference's), an aware one by
    its offset; the value is the internal int64."""
    for when in LITERALS + (dt.datetime(2020, 1, 1, 5, tzinfo=dt.timezone(
            dt.timedelta(hours=5))),):
        assert tlit(when).value == jlit(when).value
    assert tlit(dt.datetime(1970, 1, 1, 0, 0, 1)).value == US
