"""The port's ORC scan and writer (spark_rapids_tpu_torch/io/orc.py over
io/orc_format.py) against the reference's (spark_rapids_tpu/io/orc.py,
pyarrow underneath): the three reader modes of tests/test_io.py's ORC case,
column pruning and partition columns, partitioned writes through the
committer, a faulted write that leaves no visible file, ``CREATE TEMP
VIEW ... USING orc``, and corpus queries over ORC files on both sessions.
The reference runs on ``TpuSession``, the port on
``TorchSession(device="cpu")``, over the same files.

Comparators: ``scale_test.tables_differ`` (bitwise, in order) by default;
``scale_test.tables_close`` (rtol 1e-9) for the corpus's f64 sums and
``scale_test.tables_differ_unordered`` where rows come out batch by
batch (partitioned reads, the windows without ORDER BY)."""

import os

import numpy as np
import pytest
import torch

from scale_test import build_queries as jbuild_queries
from scale_test import tables_close, tables_differ, tables_differ_unordered
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.io.orc import write_orc as jwrite_orc
from spark_rapids_tpu.runtime import speculation as jspec
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.errors import KernelCrashError
from spark_rapids_tpu_torch.io.committer import TEMP_DIR, read_manifest
from spark_rapids_tpu_torch.io.orc import OrcScanNode, write_orc
from spark_rapids_tpu_torch.models import corpus as tcorpus
from spark_rapids_tpu_torch.ops.expr import col
from spark_rapids_tpu_torch.plan import from_host_table
from spark_rapids_tpu_torch.plan import nodes as P
from spark_rapids_tpu_torch.runtime import speculation as tspec
from spark_rapids_tpu_torch.session import TorchSession


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


def _sample_table(n: int, seed: int) -> HostTable:
    """i INT, l LONG, d DOUBLE, f FLOAT, b BOOLEAN, s STRING, ~10% null
    (tests/test_io.py's sample types)."""
    rng = np.random.default_rng(seed)

    def valid():
        return rng.random(n) > 0.1
    words = np.array([f"w{k}" for k in range(37)] + ["", "é"], dtype=object)
    s_valid = valid()
    return HostTable(["i", "l", "d", "f", "b", "s"], [
        HostColumn(T.INT, rng.integers(-1000, 1000, n).astype(np.int32),
                   valid()),
        HostColumn(T.LONG, rng.integers(-10**12, 10**12, n), valid()),
        HostColumn(T.DOUBLE, rng.standard_normal(n), valid()),
        HostColumn(T.FLOAT, rng.standard_normal(n).astype(np.float32),
                   valid()),
        HostColumn(T.BOOLEAN, rng.random(n) < 0.5, valid()),
        HostColumn(T.STRING, np.where(s_valid, words[rng.integers(
            0, len(words), n)], None), s_valid)])


@pytest.fixture(scope="module")
def ref():
    return TpuSession()


@pytest.fixture(scope="module")
def port():
    return TorchSession(device="cpu")


@pytest.mark.parametrize("mode", ["PERFILE", "COALESCING", "MULTITHREADED",
                                  "AUTO"])
def test_orc_read_modes(tmp_path, ref, port, mode):
    """tests/test_io.py::test_orc_read_modes, the port held to the
    reference over the reference's files."""
    paths = []
    for k in range(2):
        paths.extend(jwrite_orc(_as_reference(_sample_table(300, k)),
                                str(tmp_path / f"o{k}")))
    want = ref.read_orc(*paths, reader_type=mode).collect_table()
    got = port.read_orc(*paths, reader_type=mode).collect_table()
    assert tables_differ(_as_reference(got), want) is None
    conf = TorchSession({"spark.rapids.sql.format.orc.reader.type": mode},
                        device="cpu")
    got = conf.read_orc(*paths).collect_table()
    assert tables_differ(_as_reference(got), want) is None
    scan = OrcScanNode(paths, conf.conf)
    assert scan.reader_type == mode


def test_pruning_and_a_pipeline(tmp_path, ref, port):
    paths = jwrite_orc(_as_reference(_sample_table(2000, 4)),
                       str(tmp_path / "p"), compression="zstd")
    want = ref.read_orc(*paths).select("s", "l").collect_table()
    got = port.read_orc(*paths).select("s", "l").collect_table()
    assert tables_differ(_as_reference(got), want) is None
    got = port.read_orc(*paths).filter(col("i") > 0).group_by("b").agg(
        F.count(col("l")).alias("c"), F.sum(col("l")).alias("t")
    ).collect_table()
    from spark_rapids_tpu import functions as JF
    from spark_rapids_tpu.ops.expr import col as jcol
    want = ref.read_orc(*paths).filter(jcol("i") > 0).group_by("b").agg(
        JF.count(jcol("l")).alias("c"), JF.sum(jcol("l")).alias("t")
    ).collect_table()
    assert tables_differ_unordered(_as_reference(got), want) is None


def test_partitioned_write_reads_back_on_both(tmp_path, ref, port):
    t = _sample_table(500, 6)
    t = HostTable(list(t.names) + ["k"], list(t.columns) + [HostColumn(
        T.LONG, np.arange(500, dtype=np.int64) % 3)])
    out = str(tmp_path / "part")
    files = write_orc(t, out, partition_by=["k"])
    assert sorted(os.listdir(out)) == ["_SUCCESS", "k=0", "k=1", "k=2"]
    assert read_manifest(out)["numFiles"] == len(files) == 3
    back = port.read_orc(out)
    assert dict(back.schema)["k"] == T.LONG
    want = ref.read_orc(out).collect_table()
    assert tables_differ_unordered(_as_reference(back.collect_table()),
                                   want) is None
    assert tables_differ_unordered(_as_reference(back.collect_table()),
                                   _as_reference(t)) is None
    # the DataFrame surface writes through the same committer
    out2 = str(tmp_path / "df")
    from_host_table(t, port).write.format("orc").partition_by("k").save(out2)
    assert tables_differ_unordered(
        _as_reference(port.read_orc(out2).collect_table()),
        ref.read_orc(out2).collect_table()) is None


def test_faulted_write_leaves_no_visible_file(tmp_path):
    s = TorchSession({"spark.rapids.test.faults": "io.write.file:crash:1"},
                     device="cpu")
    out = str(tmp_path / "k")
    node = P.WriteFiles(from_host_table(_sample_table(60, 1), s).plan,
                        "orc", out, None, {"compression": "zstd"})
    with pytest.raises(KernelCrashError):
        s.execute(node)
    visible = [f for _r, _d, fs in os.walk(out) for f in fs
               if not f.startswith(("_", "."))] if os.path.isdir(out) else []
    assert visible == [] and read_manifest(out) is None
    assert not os.path.exists(os.path.join(out, TEMP_DIR))
    s.execute(node)
    assert tables_differ(_as_reference(s.read_orc(out).collect_table()),
                         _as_reference(_sample_table(60, 1))) is None


def test_temp_view_using_orc(tmp_path, ref, port):
    paths = jwrite_orc(_as_reference(_sample_table(400, 8)),
                       str(tmp_path / "v"))
    text = "SELECT b, count(*) AS c, sum(l) AS t FROM v GROUP BY b ORDER BY b"
    port.sql(f"CREATE OR REPLACE TEMP VIEW v USING orc OPTIONS (path "
             f"'{tmp_path / 'v'}')")
    ref.sql(f"CREATE OR REPLACE TEMP VIEW v USING orc OPTIONS (path "
            f"'{tmp_path / 'v'}')")
    assert tables_differ(_as_reference(port.sql(text).collect_table()),
                         ref.sql(text).collect_table()) is None
    assert paths


SF = 0.02
F64_SUMS = ("q1", "q3", "q9", "q14")
UNORDERED = ("q6",)


@pytest.fixture(scope="module")
def orc_corpus(tmp_path_factory):
    """(port tables, their ORC directories: two ZSTD files a table)."""
    tables = tcorpus.corpus_tables(SF, 0)
    base = str(tmp_path_factory.mktemp("orc_corpus"))
    return tables, tcorpus.write_corpus_files(tables, base, 2, fmt="orc")


@pytest.mark.parametrize("form", ["dsl", "sql"])
@pytest.mark.parametrize("name", ["q1", "q3", "q6", "q9", "q14", "q20"])
def test_corpus_from_orc_on_both_sessions(orc_corpus, name, form):
    tables, paths = orc_corpus
    jref = TpuSession()
    jref.read_parquet = jref.read_orc  # the reference's corpus over ORC
    want = jbuild_queries(jref, None, paths=paths)[name]().collect_table()
    build = tcorpus.build_queries if form == "dsl" else \
        tcorpus.build_sql_queries
    got = build(TorchSession(device="cpu"), tables, paths=paths,
                fmt="orc")[name]()
    got = _as_reference(got.collect_table())
    assert got.num_rows > 0
    if name in F64_SUMS:
        assert tables_close(got, want, rtol=1e-9) is None
    elif name in UNORDERED:
        assert tables_differ_unordered(got, want) is None
    else:
        assert tables_differ(got, want) is None


def test_corpus_tables_read_back_bit_for_bit(orc_corpus):
    tables, paths = orc_corpus
    s = TorchSession(device="cpu")
    for name, t in tables.items():
        for mode in ("PERFILE", "COALESCING", "MULTITHREADED"):
            got = s.read_orc(paths[name], reader_type=mode).collect_table()
            assert tables_differ(_as_reference(got),
                                 _as_reference(t)) is None, (name, mode)
            # the strings' codes are the ones Parquet's scan seeds
            for c, src in zip(got.columns, t.columns):
                if isinstance(c.dtype, T.StringType):
                    codes, dictionary = c.encoded()
                    want_codes, want_dict = src.encoded()
                    assert list(dictionary) == list(want_dict)
                    assert np.array_equal(codes, want_codes)
