"""The port's Iceberg read path (spark_rapids_tpu_torch/iceberg) against the
reference's, the cases of tests/test_iceberg.py: tables built by
tests/iceberg_util.py (pyarrow data files, Avro manifests) and by
chip_smoke.py's own fixture (the port's Parquet writer and a minimal Avro
encoder), read by both packages over the same files. Reads compare as row
multisets with ``scale_test.tables_differ_unordered`` (a scan reads its
data files in path order); errors and counts with ``==``; the scan
converts with 0 CPU-route nodes."""

import numpy as np
import pyarrow as pa
import pytest

from tests.iceberg_util import IcebergTableBuilder
from tests.torch_lake import pair, same_rows


def _arrow(n, base=0, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table({
        "id": pa.array(np.arange(base, base + n), type=pa.int64()),
        "k": pa.array(rng.integers(0, 5, n), type=pa.int64()),
        "v": pa.array(rng.standard_normal(n), type=pa.float64()),
        "s": pa.array([f"s{i % 10}" for i in range(n)])})


def _read_both(path, **kw):
    j, t = pair()
    return (j.session.read_iceberg(path, **kw).collect_table(),
            t.session.read_iceberg(path, **kw).collect_table())


def test_basic_scan(tmp_path):
    b = IcebergTableBuilder(str(tmp_path / "t"), _arrow(1).schema)
    b.add_data_file(_arrow(300, 0, seed=1))
    b.add_data_file(_arrow(200, 300, seed=2))
    b.commit()
    jt, tt = _read_both(str(tmp_path / "t"))
    same_rows(jt, tt)
    assert tt.num_rows == 500


def test_positional_deletes(tmp_path):
    b = IcebergTableBuilder(str(tmp_path / "t"), _arrow(1).schema)
    f1 = b.add_data_file(_arrow(100, 0))
    f2 = b.add_data_file(_arrow(100, 100))
    b.add_position_deletes([(f1, 0), (f1, 1), (f2, 99)])
    b.commit()
    jt, tt = _read_both(str(tmp_path / "t"))
    same_rows(jt, tt)
    ids = sorted(tt.columns[0].data.tolist())
    assert len(ids) == 197 and 0 not in ids and 199 not in ids


def test_equality_deletes_respect_sequence_numbers(tmp_path):
    b = IcebergTableBuilder(str(tmp_path / "t"), _arrow(1).schema)
    b.add_data_file(_arrow(100, 0), sequence_number=1)
    b.add_data_file(_arrow(100, 100), sequence_number=3)
    b.add_equality_deletes(pa.table({"id": pa.array([5, 105],
                                                    type=pa.int64())}),
                           equality_ids=[1], sequence_number=2)
    b.commit()
    jt, tt = _read_both(str(tmp_path / "t"))
    same_rows(jt, tt)
    ids = set(tt.columns[0].data.tolist())
    assert 5 not in ids and 105 in ids and len(ids) == 199


def test_multi_column_equality_deletes_with_nulls(tmp_path):
    """An equality delete over two columns, one row of it with a null
    string: the port's vectorized key match (null equals null) against
    the reference's tuple set."""
    b = IcebergTableBuilder(str(tmp_path / "t"), _arrow(1).schema)
    data = _arrow(60, 0, seed=5)
    s = data.column("s").to_pylist()
    s[7] = None
    data = data.set_column(3, "s", pa.array(s))
    b.add_data_file(data, sequence_number=1)
    b.add_equality_deletes(pa.table({
        "k": pa.array([data.column("k")[3].as_py(),
                       data.column("k")[7].as_py()], type=pa.int64()),
        "s": pa.array(["s3", None])}), equality_ids=[2, 4],
        sequence_number=2)
    b.commit()
    jt, tt = _read_both(str(tmp_path / "t"))
    same_rows(jt, tt)
    assert tt.num_rows < 60


def test_column_pruning_and_engine_ops(tmp_path):
    b = IcebergTableBuilder(str(tmp_path / "t"), _arrow(1).schema)
    b.add_data_file(_arrow(400, 0, seed=3))
    b.commit()
    j, t = pair()
    out = []
    for a in (j, t):
        F = a.F
        df = (a.session.read_iceberg(str(tmp_path / "t"), columns=["k", "v"])
              .filter(a.col("v") > a.lit(0.0))
              .group_by("k").agg(F.count("v").alias("c"),
                                 F.max("v").alias("mx")))
        out.append(df.collect_table())
    same_rows(*out)
    from spark_rapids_tpu_torch.obs.events import collect_fallbacks
    assert collect_fallbacks(t.session.last_meta) == []


def test_equality_delete_columns_beyond_projection(tmp_path):
    b = IcebergTableBuilder(str(tmp_path / "t"), _arrow(1).schema)
    b.add_data_file(_arrow(100, 0), sequence_number=1)
    b.add_equality_deletes(pa.table({"s": pa.array(["s3"])}),
                           equality_ids=[4], sequence_number=2)
    b.commit()
    jt, tt = _read_both(str(tmp_path / "t"), columns=["id"])
    same_rows(jt, tt)
    assert tt.num_rows == 90 and list(tt.names) == ["id"]


def test_not_an_iceberg_table_and_unknown_snapshot(tmp_path):
    b = IcebergTableBuilder(str(tmp_path / "t"), _arrow(1).schema)
    b.add_data_file(_arrow(10, 0))
    b.commit()
    for a in pair():
        with pytest.raises(a.CPE, match="not an iceberg"):
            a.session.read_iceberg(str(tmp_path / "none"))
        with pytest.raises(a.CPE, match="no iceberg snapshot"):
            a.session.read_iceberg(str(tmp_path / "t"), snapshot_id=999)


def test_sql_using_iceberg_and_reader_format(tmp_path):
    b = IcebergTableBuilder(str(tmp_path / "t"), _arrow(1).schema)
    b.add_data_file(_arrow(80, 0, seed=4))
    b.commit()
    j, t = pair()
    s = t.session
    s.sql(f"CREATE TEMP VIEW ice USING iceberg OPTIONS (path "
          f"'{tmp_path / 't'}')")
    got = s.sql("SELECT k, COUNT(*) AS n FROM ice GROUP BY k") \
        .collect_table()
    want = (j.session.read_iceberg(str(tmp_path / "t")).group_by("k")
            .agg(j.F.count("id").alias("n")).collect_table())
    same_rows(want, got)
    same_rows(j.session.read_iceberg(str(tmp_path / "t")).collect_table(),
              s.read.format("iceberg").load(str(tmp_path / "t"))
              .collect_table())


def test_chip_smoke_fixture_snapshots(tmp_path):
    """chip_smoke.py's I1 fixture (the port's Parquet writer, the script's
    Avro encoder) over a small lineitem: both packages read each snapshot
    to the same rows, the rows the fixture's keep mask says (1% of each
    file's rows deleted by position, 'R' rows of the first file by
    equality)."""
    import chip_smoke
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    from spark_rapids_tpu_torch.models.tpch import lineitem_table
    li = chip_smoke.lake_lineitem(lineitem_table(4000, seed=0), 7)
    ice = chip_smoke.iceberg_lineitem(li, str(tmp_path), parts=4)
    for sid in (1, 2):
        jt, tt = _read_both(ice["path"], snapshot_id=sid)
        same_rows(jt, tt)
        keep = ice["keep"][sid]
        same_rows(tt, HostTable(li.names, [HostColumn(c.dtype, c.data[keep])
                                           for c in li.columns]))
    assert ice["keep"][2].sum() < 4000 - 40
