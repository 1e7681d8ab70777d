"""The golden corpus's queries other than q2 and q8 (which are in
tests/test_torch_corpus.py) through the port's session on the CPU against
the JAX package's TpuSession, on the same tables:
``datagen.scale_test_specs(0.02)``, seeds 0 and 1. With those two, this is
the port's corpus runner: all 22 queries.

Comparators, named per query:
- ``scale_test.tables_differ`` (bitwise, in order) for the queries whose
  every value is exact: keys, counts, int64 and decimal sums, strings,
  ordered top-k rows and window ranks (q5, q6, q7, q11, q13, q16, q18,
  q20, q21, q22);
- ``scale_test.tables_close`` (rtol 1e-9, only for f64 sums, which the
  port adds in another order: one-hot block partials or ``index_add_``
  against the reference's row-order sum) for q1, q3, q4, q9, q10, q12,
  q14, q15, q17 and q19. Their exact columns are still compared exactly:
  tables_close compares every non-float value with ``==``.

The reference tables and results are built once per module (a seed's
tables once, a query's reference result once)."""

import pytest
import torch

from scale_test import build_queries as jbuild_queries
from scale_test import tables_close, tables_differ
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.runtime import speculation as jspec
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.models import corpus as tcorpus
from spark_rapids_tpu_torch.runtime import speculation as tspec
from spark_rapids_tpu_torch.session import TorchSession

SF = 0.02
SEEDS = (0, 1)

EXACT = ("q5", "q6", "q7", "q11", "q13", "q16", "q18", "q20", "q21",
         "q22")
F64_SUMS = ("q1", "q3", "q4", "q9", "q10", "q12", "q14", "q15", "q17",
            "q19")
QUERIES = sorted(EXACT + F64_SUMS, key=lambda q: int(q[1:]))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread: the suite runs in several worker
    processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clear_blocklists():
    """Speculation blocklists are process-wide in both packages."""
    jspec._BLOCKLIST.clear()
    tspec.clear_blocklist()
    yield
    jspec._BLOCKLIST.clear()
    tspec.clear_blocklist()


def _as_reference(t) -> JHostTable:
    names, types, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, v)
        for ty, (d, v) in zip(types, arrays)])


_TABLES = {}
_REFERENCE = {}


def _tables(seed):
    """(port tables, reference tables) of every column the ported queries
    read, generated once per seed by the port's datagen."""
    if seed not in _TABLES:
        tabs = tcorpus.corpus_tables(SF, seed)
        _TABLES[seed] = (tabs, {n: _as_reference(t)
                                for n, t in tabs.items()})
    return _TABLES[seed]


def _reference(name, seed):
    key = (name, seed)
    if key not in _REFERENCE:
        _, jtabs = _tables(seed)
        jspec._BLOCKLIST.clear()
        _REFERENCE[key] = jbuild_queries(TpuSession(), jtabs)[name]() \
            .collect_table()
    return _REFERENCE[key]


def test_the_comparators_cover_the_ported_queries():
    assert sorted(QUERIES + ["q2", "q8"]) == sorted(tcorpus.PORTED) \
        == sorted(f"q{i}" for i in range(1, 23))
    assert not set(EXACT) & set(F64_SUMS)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", QUERIES)
def test_corpus_query_matches_reference(name, seed):
    ttabs, _ = _tables(seed)
    ref = _reference(name, seed)
    tq = tcorpus.build_queries(TorchSession(device="cpu"), ttabs)
    got = _as_reference(tq[name]().collect_table())
    assert got.num_rows > 0
    if name in EXACT:
        assert tables_differ(got, ref) is None
    else:
        assert tables_close(got, ref, rtol=1e-9) is None
