"""The operator query set of ``chip_smoke.py``'s phase 11 (O1-O8:
``OPS_QUERIES``) through the port's ``TorchSession`` on the CPU against
the JAX package's ``TpuSession`` (its ``sql()`` for the SQL texts, its
DataFrame API for the DSL forms, built by the same
``chip_smoke.ops_queries`` with each package's constructors) over the
corpus tables at ``datagen.scale_test_specs(0.02)``, seeds 0 and 1, and
``chip_smoke.lineitem_dec`` built from them; and each port result against
the script's own numpy oracle (``chip_smoke.ops_oracles``). O6a's range
is cut to 2^21 + 777 rows here: three batches of the 2^20-row range.

Comparators: ``scale_test.tables_differ`` (bitwise, in order) for O2,
O4b, O5, O6a and O6b; ``tables_differ_unordered`` (a bitwise row
multiset) for the unsorted group-bys O3 and O8a; ``tables_close`` (rtol
1e-9, every other value exact) where an f64 sum adds in another order
(O4a, O7, O8b) and for O1: its DECIMAL128 products send the reference's
whole aggregate to its CPU route, which averages a decimal as a
row-order f64 sum of value-unit doubles, while the port (as the
reference's device route) divides the exact decimal sum, so O1's AVGs
differ from the reference's in their last bits; its decimal sums and
counts are exact, and the oracle holds every O1 value, the AVGs
included, exactly."""

import types

import numpy as np
import pytest
import torch

import chip_smoke
from scale_test import tables_close, tables_differ, tables_differ_unordered
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.ops import arithmetic as JA
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.ops.expr import lit as jlit
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.runtime import speculation as jspec
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.models import corpus as tcorpus
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.runtime import speculation as tspec
from spark_rapids_tpu_torch.session import TorchSession

SF = 0.02
SEEDS = (0, 1)
RANGE_ROWS = (1 << 21) + 777
COMPARATORS = {"O3": tables_differ_unordered, "O8a": tables_differ_unordered,
               "O1": tables_close, "O4a": tables_close, "O7": tables_close,
               "O8b": tables_close}
REFERENCE_API = types.SimpleNamespace(F=JF, col=jcol, lit=jlit, Pmod=JA.Pmod,
                                      IntegralDivide=JA.IntegralDivide)


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


def _as_reference(t) -> JHostTable:
    names, type_names, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, np.asarray(v, dtype=bool))
        for ty, (d, v) in zip(type_names, arrays)])


_SEEDED = {}


def _seeded(seed):
    """(port queries, reference queries, oracles) of ``seed``: one session
    of each package with temp views lineitem, orders and lineitem_dec,
    made once per seed (O8a and O8b share their cached relation, as in
    phase 11)."""
    if seed not in _SEEDED:
        tables = tcorpus.corpus_tables(SF, seed)
        dec = chip_smoke.lineitem_dec(tables, seed)
        views = {"lineitem": tables["lineitem"], "orders": tables["orders"],
                 "lineitem_dec": dec}
        ts, js = TorchSession(device="cpu"), TpuSession()
        for name, t in views.items():
            tfrom(t, ts).create_or_replace_temp_view(name)
            jfrom(_as_reference(t), js).create_or_replace_temp_view(name)
        _SEEDED[seed] = (
            chip_smoke.ops_queries(ts, chip_smoke.port_api(), RANGE_ROWS),
            chip_smoke.ops_queries(js, REFERENCE_API, RANGE_ROWS),
            chip_smoke.ops_oracles(tables, dec, RANGE_ROWS))
    return _SEEDED[seed]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("query", chip_smoke.OPS_QUERIES)
def test_ops_query_matches_reference_and_oracle(query, seed):
    port, ref, oracles = _seeded(seed)
    got = port[query]().collect_table()
    oracles[query](got)
    want = ref[query]().collect_table()
    comparator = COMPARATORS.get(query, tables_differ)
    diff = comparator(_as_reference(got), want)
    assert diff is None, diff
    assert got.num_rows > 0


def test_lineitem_dec_is_the_corpus_rows_in_cents():
    """The view's decimals are the corpus doubles x 100, rounded: the
    discount within 0.00-0.10, the tax within 0.00-0.08; its timestamps
    fall on their ship dates; 2% of its comments are null."""
    tables = tcorpus.corpus_tables(SF, 0)
    dec = chip_smoke.lineitem_dec(tables, 0)
    D, L = chip_smoke.host_cols(dec), chip_smoke.host_cols(tables["lineitem"])
    assert (D["l_quantity"] == L["l_quantity"] * 100).all()
    assert (np.abs(D["l_extendedprice"] - L["l_extendedprice"] * 100)
            <= 0.5).all()
    assert D["l_discount"].min() >= 0 and D["l_discount"].max() <= 10
    assert D["l_tax"].min() >= 0 and D["l_tax"].max() <= 8
    assert ((D["l_shipts"] // 86_400_000_000) == L["l_shipdate"]).all()
    valid = dec.columns[dec.names.index("l_comment")].validity
    assert 0.01 < 1 - valid.mean() < 0.03
    assert [t.simple_string() for _, t in dec.schema()] == [
        "string", "string", "decimal(15,2)", "decimal(15,2)",
        "decimal(15,2)", "decimal(15,2)", "date", "timestamp", "string"]
