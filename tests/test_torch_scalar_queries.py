"""The scalar query set of ``chip_smoke.py``'s phase 12 (S1-S8:
``SCALAR_QUERIES``) through the port's ``TorchSession.sql`` on the CPU
against the JAX package's ``TpuSession.sql`` over the corpus tables at
``datagen.scale_test_specs(0.02)``, seeds 0 and 1, and
``chip_smoke.lineitem_dec`` built from them; and each port result against
the script's own oracle (``chip_smoke.scalar_oracles``: numpy and Python
ints). ``pmod`` and ``bitand`` are global SQL registrations in both
packages (``chip_smoke.register_scalar_functions``).

Comparators: ``scale_test.tables_differ`` (bitwise, in order) for every
query, except S6a's transcendental columns ``max_pow`` and ``min_exp``,
held within 2 ulp (XLA's CPU and torch's CPU libm may differ by an ulp),
with its other columns bitwise. The oracle holds decimals, integers,
dates, strings and hashes exactly, the same two columns within 2 ulp.
Every S-query's divisors are positive, so the reference's host
``_round_half_up_div`` (which mis-rounds a negative divisor) agrees. Each
S-query's pruned plan scans only the columns its functions read
(``PRUNED_SCANS``)."""

import types

import numpy as np
import pytest
import torch

import chip_smoke
from scale_test import tables_differ
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.ops import arithmetic as JA
from spark_rapids_tpu.ops import math as JM
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.runtime import speculation as jspec
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.models import corpus as tcorpus
from spark_rapids_tpu_torch.ops import arithmetic as TA
from spark_rapids_tpu_torch.ops import math as TM
from spark_rapids_tpu_torch.runtime import speculation as tspec
from spark_rapids_tpu_torch.session import TorchSession

SF = 0.02
SEEDS = (0, 1)


@pytest.fixture(scope="module", autouse=True)
def _setup():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    chip_smoke.register_scalar_functions(
        JF, types.SimpleNamespace(Pmod=JA.Pmod, BitwiseAnd=JM.BitwiseAnd))
    chip_smoke.register_scalar_functions(
        TF, types.SimpleNamespace(Pmod=TA.Pmod, BitwiseAnd=TM.BitwiseAnd))
    yield
    for F in (JF, TF):
        F.unregister_sql_function("pmod")
        F.unregister_sql_function("bitand")
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
    """(port session, reference session, oracles) of ``seed``, made once:
    temp views lineitem, orders, customer and lineitem_dec."""
    if seed not in _SEEDED:
        tables = tcorpus.corpus_tables(SF, seed)
        dec = chip_smoke.lineitem_dec(tables, seed)
        ts, js = TorchSession(device="cpu"), TpuSession()
        chip_smoke.scalar_session(tables, dec, ts)
        for name in ("lineitem", "orders", "customer"):
            jfrom(_as_reference(tables[name]),
                  js).create_or_replace_temp_view(name)
        jfrom(_as_reference(dec), js).create_or_replace_temp_view(
            "lineitem_dec")
        _SEEDED[seed] = (ts, js, chip_smoke.scalar_oracles(tables, dec))
    return _SEEDED[seed]


def _ulp_diff(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(np.float64).view(np.int64)
                      - b.astype(np.float64).view(np.int64)).max(initial=0))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("query", chip_smoke.SCALAR_QUERIES)
def test_scalar_query_matches_reference_and_oracle(query, seed):
    ts, js, oracles = _seeded(seed)
    text = chip_smoke.scalar_texts()[query]
    got = ts.sql(text).collect_table()
    oracles[query](got)
    want = js.sql(text).collect_table()
    mine = _as_reference(got)
    ulps = chip_smoke.SCALAR_ULP_COLUMNS.get(query, ())
    for name in ulps:
        i = mine.names.index(name)
        assert _ulp_diff(mine.columns[i].data, want.columns[i].data) <= 2
    keep = [i for i, n in enumerate(mine.names) if n not in ulps]
    diff = tables_differ(
        JHostTable([mine.names[i] for i in keep],
                   [mine.columns[i] for i in keep]),
        JHostTable([want.names[i] for i in keep],
                   [want.columns[i] for i in keep]))
    assert diff is None, diff
    assert got.num_rows > 0


#: the columns each S-query's pruned scans read, by table (scan order)
PRUNED_SCANS = {
    "S1": {"lineitem_dec": [["l_returnflag", "l_linestatus", "l_quantity",
                             "l_extendedprice", "l_discount"]]},
    "S2": {"lineitem_dec": [["l_extendedprice", "l_discount",
                             "l_shipdate", "l_comment"]]},
    "S3": {"orders": [["o_orderkey", "o_custkey", "o_orderdate",
                       "o_totalprice"]],
           "customer": [["c_custkey", "c_name"]]},
    "S4": {"lineitem": [["l_orderkey", "l_shipdate"]],
           "orders": [["o_orderkey", "o_orderdate"]]},
    "S5": {"lineitem_dec": [["l_shipts"]]},
    "S6a": {"orders": [["o_custkey", "o_totalprice"]]},
    "S6b": {"orders": [["o_orderkey", "o_totalprice"]]},
    "S7": {"lineitem_dec": [["l_comment"]]},
    "S8": {"lineitem_dec": [["l_returnflag", "l_linestatus", "l_quantity",
                             "l_extendedprice", "l_shipdate"]]},
}


@pytest.mark.parametrize("query", chip_smoke.SCALAR_QUERIES)
def test_column_pruning_sees_the_scalar_functions_children(query):
    """Column pruning walks the new expressions' children: each S-query's
    scans read only the columns its functions name."""
    from spark_rapids_tpu_torch.overrides.pruning import prune_plan
    from spark_rapids_tpu_torch.plan import nodes as P
    ts, _, _ = _seeded(0)
    views = {name: ts.table(name).plan for name in
             ("lineitem", "lineitem_dec", "orders", "customer")}
    pruned = prune_plan(ts.sql(chip_smoke.scalar_texts()[query]).plan)

    def scans(node):
        if isinstance(node, P.LocalScan):
            yield node
        for c in node.children:
            yield from scans(c)

    got = {}
    for s in scans(pruned):
        table = next(n for n, v in views.items()
                     if v.batches[0] is s.batches[0])
        got.setdefault(table, []).append([n for n, _ in s.output_schema()])
    assert got == PRUNED_SCANS[query]
