"""The join query set (``chip_smoke.JOIN_QUERIES``, J1-J12) through the
port's ``TorchSession.sql`` on the CPU against the JAX package's
``TpuSession.sql`` over the corpus tables at
``datagen.scale_test_specs(0.02)``, seeds 0 and 1: the dense texts, J3
and J12 over o_orderkey/l_orderkey mapped to sparse 40-bit keys (their
unique builds then take the hash probe in the port), and J1 and J8 with
their builds sub-partitioned (``subPartition.targetBytes`` 32768 for
J1's 147 KB build and 4096 for J8's 9 KB one: five and three
partitions), which must equal the unsplit results too. Also the comparisons with a bare
NULL literal, against the reference.

Comparators: ``scale_test.tables_differ`` (bitwise, in order) for every
query whose values are exact (keys, counts, int64 and decimal sums,
ordered rows); ``scale_test.tables_close`` (rtol 1e-9) for J7, whose f64
SUM may add in another order in the port than in the reference, per
nested-loop tile where each tile is its own partial (tables_close
compares its other values exactly)."""

import numpy as np
import pytest
import torch

import chip_smoke
from scale_test import tables_close, tables_differ
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.runtime import speculation as jspec
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.models import corpus as tcorpus
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.runtime import speculation as tspec
from spark_rapids_tpu_torch.session import TorchSession

SF = 0.02
SEEDS = (0, 1)
TEXTS = chip_smoke.join_texts(SF)
#: each sub-partitioned form's target bytes
SUBPARTITION = {"J1": 32768, "J8": 4096}
#: (query, form) cases: every dense text, the sparse and sub-partitioned
#: forms
CASES = ([(q, "dense") for q in TEXTS]
         + [(q, "sparse") for q in chip_smoke.SPARSE_JOIN_QUERIES]
         + [(q, "subpartitioned")
            for q in chip_smoke.SUBPARTITIONED_JOIN_QUERIES])


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
    """Speculation blocklists are process-wide in both packages, and the
    dense and sparse forms share their join sites."""
    jspec._BLOCKLIST.clear()
    tspec.clear_blocklist()
    yield
    jspec._BLOCKLIST.clear()
    tspec.clear_blocklist()


def _reference_table(names, type_names, arrays) -> JHostTable:
    # a NULL literal's column is 'void', which parse_type does not name
    return JHostTable(list(names), [
        JHostColumn(JT.NULL if t == "void" else JT.parse_type(t), d, v)
        for t, (d, v) in zip(type_names, arrays)])


def _as_reference(t) -> JHostTable:
    return _reference_table(*t.to_arrays())


def _sparse(k: np.ndarray) -> np.ndarray:
    return (k * 0x9E3779B1) & ((1 << 40) - 1)


_TABLES = {}


def _tables(seed, form):
    """The corpus tables of ``seed`` (port HostTables), sparse-mapped for
    the sparse form; generated once per seed."""
    if seed not in _TABLES:
        _TABLES[seed] = tcorpus.corpus_tables(SF, seed)
    tables = _TABLES[seed]
    if form == "sparse":
        return chip_smoke.sparse_join_tables(tables, _sparse)
    return tables


def _port(query, seed, form, conf=None):
    """(the port's result as a reference HostTable, its metrics)."""
    ts = TorchSession(conf, device="cpu")
    for name, t in _tables(seed, form).items():
        tfrom(t, ts).create_or_replace_temp_view(name)
    got = _as_reference(ts.sql(TEXTS[query]).collect_table())
    return got, ts.last_metrics()


def _reference(query, seed, form, conf=None):
    js = TpuSession(conf)
    for name, t in _tables(seed, form).items():
        jfrom(_as_reference(t), js).create_or_replace_temp_view(name)
    return js.sql(TEXTS[query]).collect_table()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("query,form", CASES)
def test_join_query_matches_reference(query, form, seed):
    conf = ({"spark.rapids.sql.join.subPartition.targetBytes":
             str(SUBPARTITION[query])} if form == "subpartitioned" else None)
    got, metrics = _port(query, seed, form, conf)
    ref = _reference(query, seed, form, conf)
    assert got.num_rows > 0
    if query == "J7":
        assert tables_close(got, ref, rtol=1e-9) is None
        assert metrics["nestedLoopTiles"] >= 1
    else:
        assert tables_differ(got, ref) is None
    if form == "sparse":
        assert metrics["hashProbeBatches"] >= 1
    if form == "subpartitioned":
        assert metrics["subPartitions"] > 1
        # and equal to the port's unsplit result
        unsplit, m = _port(query, seed, "dense")
        assert "subPartitions" not in m
        assert tables_differ(got, unsplit) is None


@pytest.mark.parametrize("seed", SEEDS)
def test_j7_with_a_partial_per_tile_matches_reference(seed, monkeypatch):
    """J7 as phase 10 runs it a second time: 2048-pair tiles and the
    aggregate's input coalesce at a 1-byte target, so each nested-loop
    tile is its own partial and the streaming merge adds them."""
    from spark_rapids_tpu_torch.execs import basic as xbasic
    from spark_rapids_tpu_torch.execs import broadcast as xbroadcast
    monkeypatch.setattr(xbroadcast, "PAIR_BUDGET", 2048)
    monkeypatch.setattr(xbasic, "BATCH_SIZE_BYTES", 1)
    got, metrics = _port("J7", seed, "dense")
    assert metrics["nestedLoopTiles"] > 1
    assert metrics["partialAggBatches"] == metrics["nestedLoopTiles"]
    assert tables_close(got, _reference("J7", seed, "dense"),
                        rtol=1e-9) is None


_NULLS = (["id", "k", "v"], ["bigint", "bigint", "double"], [
    (np.arange(1, 6, dtype=np.int64), np.ones(5, bool)),
    (np.array([10, 0, 30, 40, 50], dtype=np.int64),
     np.array([1, 0, 1, 1, 1], bool)),
    (np.array([1.5, 2.5, np.nan, 4.5, 5.5]), np.ones(5, bool))])

NULL_LITERAL = {
    "v = NULL": "SELECT id FROM t WHERE v = NULL",
    "k <=> NULL": "SELECT id FROM t WHERE k <=> NULL",
    "select both": "SELECT k <=> NULL AS a, v = NULL AS b FROM t",
    "NULL < k": "SELECT id, NULL < k AS c FROM t",
}


@pytest.mark.parametrize("name", sorted(NULL_LITERAL))
def test_comparisons_with_a_null_literal_match_reference(name):
    """A NULL operand is cast to the other operand's type: ``v = NULL``
    is null on every row (no row passes a WHERE), ``k <=> NULL`` is
    ``k IS NULL``."""
    ts, js = TorchSession(device="cpu"), TpuSession()
    tfrom(host_table_from_arrays(*_NULLS), ts) \
        .create_or_replace_temp_view("t")
    jfrom(_reference_table(*_NULLS), js).create_or_replace_temp_view("t")
    got = _as_reference(ts.sql(NULL_LITERAL[name]).collect_table())
    ref = js.sql(NULL_LITERAL[name]).collect_table()
    assert tables_differ(got, ref) is None
    if name == "k <=> NULL":
        assert got.columns[0].data.tolist() == [2]
    if name == "v = NULL":
        assert got.num_rows == 0
