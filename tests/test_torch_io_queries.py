"""Queries over files: the golden corpus's 22 queries at sf 0.02 read from
Parquet files the port writes (``models/corpus.py::write_corpus_files``,
two files per table in c000/c001 directories), in DSL form
(``build_queries(..., paths=)``) and SQL form (``build_sql_queries(...,
paths=)``, temp views over the scans), on both packages over the same
files; ``CREATE TEMP VIEW ... USING parquet`` and ``register_table``; and
the cases of tests/test_input_file_name.py.

Comparators, named per query as tests/test_torch_corpus_wide.py names
them: ``scale_test.tables_differ`` (bitwise, in order) where every value
is exact; ``scale_test.tables_close`` (rtol 1e-9) for the f64 sums (q1,
q2, q3, q4, q9, q10, q12, q14, q15, q17, q19); and
``scale_test.tables_differ_unordered`` for the windows without ORDER BY
(q6, q21), whose rows come out batch by batch: two files are two
batches. The reference runs on ``TpuSession`` (pyarrow reading the port's
files), the port on ``TorchSession(device="cpu")``."""

import numpy as np
import pytest
import torch

from scale_test import build_queries as jbuild_queries
from scale_test import build_sql_queries as jbuild_sql_queries
from scale_test import tables_close, tables_differ, tables_differ_unordered
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.runtime import speculation as jspec
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.io.parquet import write_parquet
from spark_rapids_tpu_torch.models import corpus as tcorpus
from spark_rapids_tpu_torch.ops.expr import col
from spark_rapids_tpu_torch.runtime import speculation as tspec
from spark_rapids_tpu_torch.session import TorchSession

SF = 0.02
F64_SUMS = ("q1", "q2", "q3", "q4", "q9", "q10", "q12", "q14", "q15",
            "q17", "q19")
UNORDERED = ("q6", "q21")
QUERIES = tuple(f"q{i}" for i in range(1, 23))


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
    names, types, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, v)
        for ty, (d, v) in zip(types, arrays)])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(port tables, their Parquet directories), written once."""
    tables = tcorpus.corpus_tables(SF, 0)
    base = str(tmp_path_factory.mktemp("corpus"))
    return tables, tcorpus.write_corpus_files(tables, base, 2)


def _compare(name, got, want):
    if name in F64_SUMS:
        return tables_close(got, want, rtol=1e-9)
    if name in UNORDERED:
        return tables_differ_unordered(got, want)
    return tables_differ(got, want)


@pytest.mark.parametrize("form", ["dsl", "sql"])
@pytest.mark.parametrize("name", QUERIES)
def test_corpus_from_files_matches_reference(corpus, name, form):
    tables, paths = corpus
    if form == "dsl":
        want = jbuild_queries(TpuSession(), None, paths=paths)[name]()
        got = tcorpus.build_queries(TorchSession(device="cpu"), tables,
                                    paths=paths)[name]()
    else:
        want = jbuild_sql_queries(TpuSession(), None, paths=paths)[name]()
        got = tcorpus.build_sql_queries(TorchSession(device="cpu"), tables,
                                        paths=paths)[name]()
    got = _as_reference(got.collect_table())
    assert got.num_rows > 0
    assert _compare(name, got, want.collect_table()) is None


def test_files_hold_the_tables_row_for_row(corpus):
    """Every table read back from its two files equals its source, in
    every reader mode."""
    tables, paths = corpus
    s = TorchSession(device="cpu")
    for name, t in tables.items():
        for mode in ("PERFILE", "COALESCING", "MULTITHREADED"):
            got = s.read_parquet(paths[name], reader_type=mode)
            assert tables_differ(_as_reference(got.collect_table()),
                                 _as_reference(t)) is None, (name, mode)


def test_temp_view_using_parquet_and_register_table(corpus, tmp_path):
    _, paths = corpus
    s = TorchSession(device="cpu")
    s.sql(f"CREATE TEMP VIEW li USING parquet OPTIONS (path "
          f"'{paths['lineitem']}')")
    s.catalog.register_table("ord", "parquet", paths["orders"])
    text = ("SELECT l_returnflag, count(*) AS c FROM li GROUP BY "
            "l_returnflag ORDER BY l_returnflag")
    got = s.sql(text).collect_table()
    ref = TpuSession()
    ref.sql(f"CREATE TEMP VIEW li USING parquet OPTIONS (path "
            f"'{paths['lineitem']}')")
    assert tables_differ(_as_reference(got), ref.sql(text).collect_table()) \
        is None
    n = s.sql("SELECT count(*) AS n FROM ord").collect()[0][0]
    assert n == tcorpus.corpus_tables(SF, 0)["orders"].num_rows
    assert set(s.catalog.list_tables()) >= {"li", "ord"}
    s.sql("DROP VIEW ord")
    assert "ord" not in s.catalog.list_tables()
    # USING delta resolves through the Delta provider now: a path with no
    # log raises the reference's error
    from spark_rapids_tpu_torch.errors import ColumnarProcessingError
    with pytest.raises(ColumnarProcessingError, match="no delta log"):
        s.sql("CREATE TEMP VIEW c USING delta OPTIONS (path '/nowhere')")
    # USING orc resolves through the ORC provider now
    from spark_rapids_tpu_torch.io.orc import write_orc
    odir = str(tmp_path / "ord_orc")
    write_orc(tcorpus.corpus_tables(SF, 0)["orders"], odir)
    s.sql(f"CREATE TEMP VIEW ordc USING orc OPTIONS (path '{odir}')")
    assert s.sql("SELECT count(*) AS n FROM ordc").collect()[0][0] == n


# -- input_file_name (tests/test_input_file_name.py) ---------------------------

@pytest.fixture
def three_files(tmp_path):
    for i in range(3):
        write_parquet(HostTable(["a"], [HostColumn(
            T.LONG, np.array([i * 10 + 1, i * 10 + 2], dtype=np.int64))]),
            str(tmp_path / f"f{i}"))
    return str(tmp_path / "*" / "*.parquet")


@pytest.fixture
def port():
    return TorchSession(device="cpu")


def test_select_name_start_length(port, three_files):
    from spark_rapids_tpu import functions as JF
    from spark_rapids_tpu.ops.expr import col as jcol

    def q(s, F_, c):
        return sorted(s.read_parquet(three_files).select(
            c("a"), F_.input_file_name().alias("f"),
            F_.input_file_block_start().alias("st"),
            F_.input_file_block_length().alias("ln")).collect())
    a, b = q(port, F, col), q(TpuSession(), JF, jcol)
    assert a == b
    assert len({r[1] for r in a}) == 3
    assert all(r[1].endswith(".parquet") for r in a)
    assert all(r[2] == 0 and r[3] > 0 for r in a)


def test_group_by_file(port, three_files):
    g = sorted(port.read_parquet(three_files).group_by(
        F.input_file_name().alias("f")).agg(F.count().alias("c")).collect())
    assert len(g) == 3 and all(r[1] == 2 for r in g)
    port.read_parquet(three_files).create_or_replace_temp_view("t")
    s = sorted(port.sql("SELECT input_file_name() AS f, count(*) AS c "
                        "FROM t GROUP BY input_file_name()").collect())
    assert s == g


def test_filter_hides_provenance_columns(port, three_files):
    got = sorted(port.read_parquet(three_files).filter(
        F.like(F.input_file_name(), "%f1%")).collect())
    assert got == [(11,), (12,)]


def test_no_info_above_join(port):
    from spark_rapids_tpu_torch.plan import from_host_table
    t = HostTable(["k"], [HostColumn(T.LONG, np.array([1, 2],
                                                      dtype=np.int64))])
    df1, df2 = from_host_table(t, port), from_host_table(t, port)
    r = df1.join(df2, on=["k"]).select(
        F.input_file_name().alias("f"),
        F.input_file_block_start().alias("st")).collect()
    assert r and all(x == ("", -1) for x in r)


def test_partitioned_scan_keeps_partition_and_provenance(port, tmp_path):
    t = HostTable(["a", "p"], [
        HostColumn(T.LONG, np.array([0, 10, 1, 11], dtype=np.int64)),
        HostColumn(T.LONG, np.array([0, 0, 1, 1], dtype=np.int64))])
    write_parquet(t, str(tmp_path / "d"), partition_by=["p"])
    got = sorted(port.read_parquet(str(tmp_path / "d" / "*" / "*.parquet"))
                 .select(col("a"), col("p"),
                         F.input_file_name().alias("f")).collect())
    assert len(got) == 4
    assert all(f"p={r[1]}" in r[2] for r in got)


def test_reader_modes_agree(port, three_files):
    want = None
    for mode in ("PERFILE", "MULTITHREADED", "COALESCING"):
        got = sorted(port.read_parquet(three_files, reader_type=mode).select(
            col("a"), F.input_file_name().alias("f")).collect())
        if want is None:
            want = got
        assert got == want, mode


def test_rewrite_is_idempotent_and_copy_on_write(port, three_files):
    from spark_rapids_tpu_torch.io.common import FileScanNode
    base = port.read_parquet(three_files)
    df = base.select(F.input_file_name().alias("f"))
    a, b = sorted(df.collect()), sorted(df.collect())
    assert a == b and len(a) == 6
    assert all(len(r) == 1 for r in base.collect())
    assert isinstance(base.plan, FileScanNode)
    assert base.plan.provide_file_info is False


def test_two_intermediate_projects(port, three_files):
    got = sorted(port.read_parquet(three_files)
                 .select(col("a")).select(col("a"))
                 .select(col("a"), F.input_file_name().alias("f"))
                 .collect())
    assert len(got) == 6 and len({r[1] for r in got}) == 3


def test_join_above_input_file_filter(port, three_files):
    from spark_rapids_tpu_torch.plan import from_host_table
    left = port.read_parquet(three_files).filter(
        F.like(F.input_file_name(), "%f1%")).with_column("k", col("a"))
    right = from_host_table(HostTable(["k", "w"], [
        HostColumn(T.LONG, np.array([11, 12], dtype=np.int64)),
        HostColumn(T.LONG, np.array([100, 200], dtype=np.int64))]), port)
    got = sorted(left.join(right, on=["k"], how="inner")
                 .select(col("k"), col("w")).collect())
    assert got == [(11, 100), (12, 200)]


def test_sort_by_input_file_name(port, three_files):
    got = [r[0] for r in port.read_parquet(three_files)
           .sort(F.input_file_name(), ascending=False).collect()]
    # descending by file path: f2's rows first, then f1's, then f0's
    assert got[:2] == [21, 22] and got[-2:] == [1, 2]
