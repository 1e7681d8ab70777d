"""The port's file scan (spark_rapids_tpu_torch/io/common.py, io/parquet.py,
execs/basic.py::TpuFileScanExec) against the reference's, the Parquet
cases of tests/test_io.py: the reader modes and AUTO, column pruning,
predicate pushdown and row-group pruning, a pipeline over the scan, a
partitioned write, partition type inference, coalescing under filters, a
schema divergence that raises, the round trip of types, glob and directory
expansion, and the stable order of a multithreaded read. Each case runs on
both packages: the reference on ``TpuSession`` (pyarrow underneath), the
port on ``TorchSession(device="cpu")`` over the same files.

Comparators: ``scale_test.tables_differ`` (bitwise, in order) by default;
``scale_test.tables_differ_unordered`` for the unsorted group-by output of
the pipeline case."""

import datetime

import numpy as np
import pytest

from scale_test import tables_differ, tables_differ_unordered
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.io.parquet import write_parquet as jwrite_parquet
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.io.parquet import write_parquet
from spark_rapids_tpu_torch.session import TorchSession


def _as_reference(t) -> JHostTable:
    names, types, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, v)
        for ty, (d, v) in zip(types, arrays)])


def _sample_table(n=1000, seed=7) -> HostTable:
    """i INT, l LONG, d DOUBLE, f FLOAT, b BOOLEAN, s STRING, ~10% null."""
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


def _write_sample(tmp_path, num_files=3, rows=400):
    """The reference's writer (pyarrow), as tests/test_io.py writes."""
    paths = []
    for k in range(num_files):
        t = _as_reference(_sample_table(rows, seed=k))
        paths.extend(jwrite_parquet(t, str(tmp_path / f"f{k}"),
                                    row_group_rows=150))
    return paths


@pytest.fixture(scope="module")
def ref():
    return TpuSession()


@pytest.fixture(scope="module")
def port():
    return TorchSession(device="cpu")


def _both(ref, port, build):
    return (build(ref).collect_table(),
            _as_reference(build(port).collect_table()))


@pytest.mark.parametrize("mode", ["PERFILE", "COALESCING", "MULTITHREADED",
                                  "AUTO"])
def test_parquet_read_modes(tmp_path, ref, port, mode):
    paths = _write_sample(tmp_path)
    want, got = _both(ref, port,
                      lambda s: s.read_parquet(*paths, reader_type=mode))
    assert got.num_rows == 1200
    assert tables_differ(got, want) is None


def test_parquet_column_pruning(tmp_path, port):
    paths = _write_sample(tmp_path, num_files=1)
    df = port.read_parquet(*paths, columns=["l", "s"])
    assert df.columns == ["l", "s"]
    assert df.count() == 400


def test_unread_columns_are_not_decoded(tmp_path, port):
    """Column pruning narrows the file scan: a query reading two columns
    decodes only those."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.execs.basic import TpuFileScanExec
    from spark_rapids_tpu_torch.overrides.rules import convert
    paths = _write_sample(tmp_path, num_files=1)
    df = port.read_parquet(*paths).group_by("b").agg(
        F.sum("l").alias("sl"))
    root = convert(df.plan, port.conf, port.device)
    stack, scans = [root], []
    while stack:
        e = stack.pop()
        if isinstance(e, TpuFileScanExec):
            scans.append(e)
        stack.extend(e.children)
    assert [n for n, _ in scans[0].output_schema()] == ["l", "b"]


@pytest.mark.parametrize("filters", [
    [("b", "=", True)],
    [("i", "<", -500), ("s", "!=", "w3")],
    [[("l", ">=", 0)], [("s", "in", ["w1", "w2", ""])]],
    [("s", "not in", ["w1"]), ("d", ">", 0.5)],
], ids=["eq", "and", "or", "not in"])
def test_parquet_predicate_pushdown(tmp_path, ref, port, filters):
    paths = _write_sample(tmp_path, num_files=2)
    want, got = _both(ref, port,
                      lambda s: s.read_parquet(*paths, filters=filters))
    assert got.num_rows > 0
    assert tables_differ(got, want) is None


def test_row_groups_pruned_by_statistics(tmp_path, ref, port):
    """Sorted keys put each row group on its own key range: a filter on
    the key reads only the row groups it can match."""
    t = HostTable(["k", "v"], [
        HostColumn(T.LONG, np.arange(2000, dtype=np.int64)),
        HostColumn(T.DOUBLE, np.arange(2000) * 0.5)])
    write_parquet(t, str(tmp_path / "s"), row_group_rows=250)
    filters = [("k", ">=", 1200), ("k", "<", 1300)]
    df = port.read_parquet(str(tmp_path / "s"), filters=filters)
    got = df.collect_table()
    assert port.last_metrics()["prunedRowGroups"] == 6  # rows 1000-1499 kept
    want = ref.read_parquet(str(tmp_path / "s"),
                            filters=filters).collect_table()
    assert got.num_rows == 100
    assert tables_differ(_as_reference(got), want) is None


def test_parquet_pipeline_over_scan(tmp_path, ref, port):
    from spark_rapids_tpu import functions as JF
    from spark_rapids_tpu.ops.expr import col as jcol
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.ops.expr import col
    paths = _write_sample(tmp_path)
    want = (ref.read_parquet(*paths).filter(jcol("i").isnotnull())
            .group_by("b").agg(JF.sum("l").alias("sl"),
                               JF.count("i").alias("c")).collect_table())
    got = (port.read_parquet(*paths).filter(col("i").isnotnull())
           .group_by("b").agg(F.sum("l").alias("sl"),
                              F.count("i").alias("c")).collect_table())
    assert tables_differ_unordered(_as_reference(got), want) is None


def test_parquet_partitioned_write(tmp_path, ref, port):
    t = HostTable(["k", "v"], [
        HostColumn(T.STRING, np.array(["a", "b", "a", "c", None],
                                      dtype=object),
                   np.array([True, True, True, True, False])),
        HostColumn(T.LONG, np.arange(1, 6, dtype=np.int64))])
    files = write_parquet(t, str(tmp_path / "out"), partition_by=["k"])
    assert len(files) == 4  # a, b, c, null
    assert any("k=a" in f for f in files)
    assert any("__HIVE_DEFAULT_PARTITION__" in f for f in files)
    # the partition column comes back from the key=value directories
    back = port.read_parquet(str(tmp_path / "out"))
    assert dict(back.schema)["k"] == T.STRING
    rows = sorted(back.collect(), key=repr)
    assert rows == sorted([(1, "a"), (3, "a"), (2, "b"), (4, "c"),
                           (5, None)], key=repr)
    want = ref.read_parquet(str(tmp_path / "out")).collect_table()
    assert tables_differ(_as_reference(back.collect_table()), want) is None


def test_partition_column_type_inference(tmp_path, ref, port):
    t = HostTable(["year", "v"], [
        HostColumn(T.LONG, np.array([2023, 2023, 2024], dtype=np.int64)),
        HostColumn(T.DOUBLE, np.array([1.0, 2.0, 3.0]))])
    write_parquet(t, str(tmp_path / "y"), partition_by=["year"])
    back = port.read_parquet(str(tmp_path / "y"))
    assert dict(back.schema)["year"] == T.LONG
    assert sorted(back.collect()) == [(1.0, 2023), (2.0, 2023), (3.0, 2024)]
    want = ref.read_parquet(str(tmp_path / "y")).collect_table()
    assert tables_differ(_as_reference(back.collect_table()), want) is None


def test_coalescing_respects_filters(tmp_path, port):
    paths = _write_sample(tmp_path, num_files=2)
    a = port.read_parquet(*paths, filters=[("b", "=", True)],
                          reader_type="COALESCING").count()
    b = port.read_parquet(*paths, filters=[("b", "=", True)],
                          reader_type="PERFILE").count()
    assert a == b > 0


def test_multifile_schema_divergence_raises(tmp_path, ref, port):
    """File 2's double column must not silently truncate to the scan
    schema's long: both packages raise."""
    write_parquet(HostTable(["x"], [HostColumn(
        T.LONG, np.array([1, 2], dtype=np.int64))]), str(tmp_path / "a"))
    write_parquet(HostTable(["x"], [HostColumn(
        T.DOUBLE, np.array([1.5]))]), str(tmp_path / "b"))
    paths = [str(tmp_path / "a"), str(tmp_path / "b")]
    with pytest.raises(Exception):
        ref.read_parquet(*paths, reader_type="PERFILE").collect()
    with pytest.raises(ColumnarProcessingError, match="scan's schema"):
        port.read_parquet(*paths, reader_type="PERFILE").collect()


def test_multifile_schema_widens_losslessly(tmp_path, ref, port):
    """A later file's narrower integer, FLOAT and decimal columns widen to
    the scan schema the first file sets, as the reference's safe cast
    does."""
    def table(int_t, float_t, dec_t, n, seed):
        rng = np.random.default_rng(seed)
        return HostTable(["x", "f", "d"], [
            HostColumn(int_t, rng.integers(-100, 100, n).astype(
                int_t.np_dtype)),
            HostColumn(float_t, rng.random(n).astype(float_t.np_dtype)),
            HostColumn(dec_t, rng.integers(-10**6, 10**6, n)
                       if not T.is_dec128(dec_t) else np.array(
                           [int(v) for v in rng.integers(-10**6, 10**6, n)],
                           dtype=object), rng.random(n) > 0.2)])
    write_parquet(table(T.LONG, T.DOUBLE, T.DecimalType(30, 2), 50, 1),
                  str(tmp_path / "a"))
    write_parquet(table(T.SHORT, T.FLOAT, T.DecimalType(10, 2), 40, 2),
                  str(tmp_path / "b"))
    paths = [str(tmp_path / "a"), str(tmp_path / "b")]
    want, got = _both(ref, port, lambda s: s.read_parquet(
        *paths, reader_type="PERFILE"))
    assert dict(port.read_parquet(*paths).schema)["x"] == T.LONG
    assert got.num_rows == 90
    assert tables_differ(got, want) is None


def test_parquet_types_roundtrip(tmp_path, ref, port):
    epoch = datetime.date(1970, 1, 1)
    ts = [datetime.datetime(2024, 6, 1, 12, 30, 45, 123456),
          datetime.datetime(1969, 12, 31, 23, 59, 59)]
    micros = [int((x - datetime.datetime(1970, 1, 1))
                  / datetime.timedelta(microseconds=1)) for x in ts]
    t = HostTable(["dt", "ts", "x"], [
        HostColumn(T.DATE, np.array([(datetime.date(2024, 1, 1) - epoch).days,
                                     -1, 0], dtype=np.int32),
                   np.array([True, True, False])),
        HostColumn(T.TIMESTAMP, np.array(micros + [0], dtype=np.int64),
                   np.array([True, True, False])),
        HostColumn(T.INT, np.array([1, 2, 3], dtype=np.int32))])
    write_parquet(t, str(tmp_path / "t"))
    back = port.read_parquet(str(tmp_path / "t"))
    schema = dict(back.schema)
    assert schema["dt"] == T.DATE and schema["ts"] == T.TIMESTAMP
    got = back.collect_table()
    assert got.columns[0].data[0] == (datetime.date(2024, 1, 1) - epoch).days
    assert got.columns[1].data[0] == micros[0]
    assert not got.columns[0].validity[2] and not got.columns[1].validity[2]
    want = ref.read_parquet(str(tmp_path / "t")).collect_table()
    assert tables_differ(_as_reference(got), want) is None


def test_glob_and_dir_expansion(tmp_path, port):
    _write_sample(tmp_path, num_files=3, rows=100)
    assert port.read_parquet(str(tmp_path / "f*" / "*.parquet")).count() \
        == 300
    assert port.read_parquet(str(tmp_path)).count() == 300


def test_multithreaded_read_order_stable(tmp_path, ref, port):
    """MULTITHREADED keeps the file order (the reference's ordered
    results despite parallel decode)."""
    paths = []
    for k in range(6):
        t = HostTable(["k"], [HostColumn(
            T.LONG, np.full(50, k, dtype=np.int64))])
        paths.extend(write_parquet(t, str(tmp_path / f"m{k}")))
    conf = {"spark.rapids.sql.multiThreadedRead.numThreads": "3"}
    got = TorchSession(conf, device="cpu").read_parquet(
        *paths, reader_type="MULTITHREADED").collect_table()
    assert got.columns[0].data.tolist() == [
        k for k in range(6) for _ in range(50)]
    want = ref.read_parquet(*paths,
                            reader_type="MULTITHREADED").collect_table()
    assert tables_differ(_as_reference(got), want) is None


def test_expand_paths_prunes_hidden_dirs_and_files(tmp_path):
    from spark_rapids_tpu.io.common import expand_paths as jexpand
    from spark_rapids_tpu_torch.io.common import expand_paths
    d = tmp_path / "data"
    (d / "_temporary" / "job" / "0").mkdir(parents=True)
    (d / ".hidden").mkdir()
    (d / "k=1").mkdir()
    for f in ("part-0.parquet", "_SUCCESS", ".crc",
              "_temporary/job/0/part-9.parquet", ".hidden/x.parquet",
              "k=1/part-1.parquet"):
        (d / f).write_bytes(b"")
    want = [str(d / "k=1" / "part-1.parquet"), str(d / "part-0.parquet")]
    for fn in (expand_paths, jexpand):
        assert sorted(fn([str(d)])) == want
        assert sorted(fn([str(d / "*" / "*.parquet")])) == want[:1]


def test_file_cache_skips_the_decode(tmp_path):
    from spark_rapids_tpu_torch.io.filecache import FILE_CACHE
    paths = _write_sample(tmp_path, num_files=2, rows=100)
    s = TorchSession({"spark.rapids.filecache.enabled": "true"},
                     device="cpu")
    FILE_CACHE.clear()
    hits = FILE_CACHE.hits
    a = s.read_parquet(*paths).collect_table()
    b = s.read_parquet(*paths).collect_table()
    assert FILE_CACHE.hits - hits == 2
    assert tables_differ(_as_reference(a), _as_reference(b)) is None
    FILE_CACHE.clear()


def test_other_formats_raise_naming_themselves(tmp_path, port):
    for fmt in ("csv", "json", "orc", "hive-text", "delta", "iceberg"):
        with pytest.raises(NotImplementedError, match=fmt):
            port.read_format(fmt, str(tmp_path))
    with pytest.raises(NotImplementedError, match="csv"):
        port.read_csv(str(tmp_path))
    with pytest.raises(NotImplementedError, match="orc"):
        port.read.format("orc").load(str(tmp_path))
    with pytest.raises(NotImplementedError, match="ParquetScanNode"):
        paths = _write_sample(tmp_path, num_files=1, rows=10)
        TorchSession({"spark.rapids.sql.exec.ParquetScanNode": "false"},
                     device="cpu").read_parquet(*paths).collect()


def test_reader_surface(tmp_path, port):
    paths = _write_sample(tmp_path, num_files=2, rows=50)
    a = port.read.format("parquet").option("reader_type", "PERFILE") \
        .load(*paths).collect_table()
    b = port.read_format("parquet", *paths).collect_table()
    c = port.read.parquet(*paths).collect_table()
    assert a.num_rows == 100
    assert tables_differ(_as_reference(a), _as_reference(b)) is None
    assert tables_differ(_as_reference(a), _as_reference(c)) is None


def test_pushdown_over_decimals_and_dates(tmp_path, ref, port):
    """Filter literals in a column's own terms (a Decimal, a date)
    compare in its host domain (unscaled, days), as pyarrow's do."""
    import decimal
    rng = np.random.default_rng(3)
    n = 600
    big = np.empty(n, dtype=object)
    big[:] = [int(v) * 10**12 for v in rng.integers(-10**6, 10**6, n)]
    t = HostTable(["d", "big", "day"], [
        HostColumn(T.DecimalType(12, 2), rng.integers(-10**5, 10**5, n),
                   rng.random(n) > 0.1),
        HostColumn(T.DecimalType(30, 2), big, rng.random(n) > 0.1),
        HostColumn(T.DATE, rng.integers(0, 20000, n).astype(np.int32))])
    write_parquet(t, str(tmp_path / "f"), row_group_rows=100)
    cases = [
        [("d", ">", decimal.Decimal("12.50"))],
        [("d", "in", [decimal.Decimal(str(t.columns[0].data[i] / 100))
                      for i in range(5)])],
        [("big", "<=", decimal.Decimal(0)), ("day", ">=",
                                            datetime.date(1990, 1, 1))],
    ]
    for filters in cases:
        want, got = _both(ref, port, lambda s: s.read_parquet(
            str(tmp_path / "f"), filters=filters))
        assert got.num_rows > 0
        assert tables_differ(got, want) is None, filters


def test_multithreaded_read_under_thread_switching(tmp_path):
    """More reader threads than cores over many files, the interpreter
    switching threads as often as it can: every file's rows come back in
    order and every pruned row group is counted once (the shared counter
    and footer cache under the prefetch pool)."""
    import sys
    paths = []
    for k in range(24):
        t = HostTable(["k"], [HostColumn(
            T.LONG, np.arange(k * 400, (k + 1) * 400, dtype=np.int64))])
        paths.extend(write_parquet(t, str(tmp_path / f"t{k}"),
                                   row_group_rows=100))
    s = TorchSession({"spark.rapids.sql.multiThreadedRead.numThreads": "32"},
                     device="cpu")
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            got = s.read_parquet(
                *paths, reader_type="MULTITHREADED",
                filters=[[("k", "<", 50)], [("k", ">=", 9550)]]
            ).collect_table()
            assert got.columns[0].data.tolist() == \
                list(range(50)) + list(range(9550, 9600))
            # 96 row groups; the first's and the last's are read
            assert s.last_metrics()["prunedRowGroups"] == 94
    finally:
        sys.setswitchinterval(before)
