"""The port's change data feed and column mapping (spark_rapids_tpu_torch/
delta) against the reference's, the cases of
tests/test_delta_cdf_mapping.py: each scenario runs on both packages over
the same numpy inputs (tests/torch_lake.py); change tables compare as row
multisets (``scale_test.tables_differ_unordered``: a feed concatenates
its commits' files in path order), logs with their time, uuid and size
fields masked, the rest with ``==``.

Also what differs, or once differed, from the reference, pinned: the
port derives a plain commit's changes through the deletion vectors (the
reference reports every physical row of a DV'd file it removes, survivors
and already-deleted rows included); a field a mergeSchema append adds to a
column-mapped table gets its physicalName and id and bumps maxColumnId in
both packages."""

import json
import os

import numpy as np
import pytest

from tests.torch_lake import masked_log, pair, same_rows


def _mk(a, path, n=60):
    a.df({"id": np.arange(n, dtype=np.int64),
          "v": (np.arange(n) % 7).astype(np.float64)}).write_delta(path)
    return a.dt(path)


def _both(tmp_path, scenario, conf=None):
    j, t = pair(conf)
    return (scenario(j, str(tmp_path / "ref")),
            scenario(t, str(tmp_path / "port")))


def _check(jo, to):
    if hasattr(jo, "columns"):
        same_rows(jo, to)
    elif isinstance(jo, dict):
        assert sorted(jo) == sorted(to)
        for k in jo:
            _check(jo[k], to[k])
    elif isinstance(jo, (list, tuple)):
        assert len(jo) == len(to)
        for a, b in zip(jo, to):
            _check(a, b)
    else:
        assert jo == to


def _by_type(table):
    cols = [c.to_pylist() for c in table.columns]
    rows = list(zip(*cols))
    out = {}
    for r in rows:
        out.setdefault(r[-2], []).append(r)
    return out


# -- CDF -------------------------------------------------------------------------

def test_cdf_delete_and_update(tmp_path):
    def scn(a, path):
        dt = _mk(a, path)
        dt.set_properties({"delta.enableChangeDataFeed": "true"})
        res = dt.delete(a.col("id") < a.lit(5))
        dt.update(a.col("id") == a.lit(10), {"v": a.lit(99.0)})
        ver = dt.version()
        return {"res": res, "ver": ver,
                "changes": dt.table_changes(ver - 1).collect_table(),
                "log": masked_log(path)}
    jo, to = _both(tmp_path, scn)
    _check(jo, to)
    by = _by_type(to["changes"])
    assert sorted(r[0] for r in by["delete"]) == [0, 1, 2, 3, 4]
    assert by["update_postimage"][0][1] == 99.0
    assert {r[-1] for r in by["delete"]} == {to["ver"] - 1}


def test_cdf_derives_inserts_from_plain_writes(tmp_path):
    def scn(a, path):
        dt = _mk(a, path, n=10)
        dt.set_properties({"delta.enableChangeDataFeed": "true"})
        a.df({"id": np.arange(100, 110, dtype=np.int64),
              "v": np.full(10, 0.5)}).write_delta(path, mode="append")
        ver = dt.version()
        return dt.table_changes(ver, ver).collect_table()
    jo, to = _both(tmp_path, scn)
    _check(jo, to)
    assert set(_by_type(to)) == {"insert"} and to.num_rows == 10


def test_cdf_range_before_enablement_raises(tmp_path):
    def scn(a, path):
        dt = _mk(a, path)
        dt.delete(a.col("id") < a.lit(5))
        dt.set_properties({"delta.enableChangeDataFeed": "true"})
        for start, end in [(0, None), (1, 1), (0, 2), (1, None)]:
            with pytest.raises(a.CPE, match="enableChangeDataFeed"):
                dt.table_changes(start, end)
        dt.delete(a.col("id") < a.lit(10))
        return dt.table_changes(2).collect_table()
    jo, to = _both(tmp_path, scn)
    _check(jo, to)
    assert sorted(r[0] for r in _by_type(to)["delete"]) == [5, 6, 7, 8, 9]


def test_cdf_merge_emits_all_change_types(tmp_path):
    def scn(a, path):
        dt = _mk(a, path, n=20)
        dt.set_properties({"delta.enableChangeDataFeed": "true"})
        src = a.df({"id": np.array([5, 99], dtype=np.int64),
                    "v": np.array([50.0, 990.0])})
        dt.merge(src, on=["id"]).when_matched_update(
            set={"v": "v"}).when_not_matched_insert().execute()
        ver = dt.version()
        return dt.table_changes(ver, ver).collect_table()
    jo, to = _both(tmp_path, scn)
    _check(jo, to)
    assert sorted(_by_type(to)) == ["insert", "update_postimage",
                                    "update_preimage"]


def test_cdf_merge_delete_low_shuffle_and_full(tmp_path):
    for low in ("true", "false"):
        def scn(a, path):
            dt = _mk(a, path, n=30)
            dt.set_properties({"delta.enableChangeDataFeed": "true"})
            src = a.df({"id": np.array([3, 4, 40], dtype=np.int64)})
            dt.merge(src, on=["id"]).when_matched_delete().execute()
            ver = dt.version()
            return {"changes": dt.table_changes(ver, ver).collect_table(),
                    "rows": a.read(path).collect_table()}
        _check(*_both(tmp_path / low, scn, {
            "spark.rapids.sql.delta.lowShuffleMerge.enabled": low}))


def test_vacuum_keeps_cdc_files(tmp_path):
    def scn(a, path):
        dt = _mk(a, path)
        dt.set_properties({"delta.enableChangeDataFeed": "true"})
        dt.delete(a.col("id") < a.lit(3))
        v_delete = dt.version()
        dt.optimize()
        res = dt.vacuum()
        return {"deleted": res["files_deleted"],
                "cdc": len(os.listdir(os.path.join(path, "_change_data"))),
                "changes": dt.table_changes(v_delete, v_delete)
                .collect_table()}
    jo, to = _both(tmp_path, scn)
    _check(jo, to)
    assert to["cdc"] == 1 and to["changes"].num_rows == 3


def test_cdf_partitioned_mixed_commit_kinds(tmp_path):
    def scn(a, path):
        a.df({"p": (np.arange(12) % 2).astype(np.int64),
              "id": np.arange(12, dtype=np.int64),
              "v": np.arange(12, dtype=np.float64)}).write_delta(
            path, partition_by=["p"])
        dt = a.dt(path)
        dt.set_properties({"delta.enableChangeDataFeed": "true"})
        v_enabled = dt.version()
        dt.delete(a.col("id") == a.lit(3))
        a.df({"p": np.array([0], dtype=np.int64),
              "id": np.array([100], dtype=np.int64),
              "v": np.array([5.5])}).write_delta(
            path, mode="append", partition_by=["p"])
        return dt.table_changes(v_enabled).collect_table()
    jo, to = _both(tmp_path, scn)
    _check(jo, to)
    by = _by_type(to)
    assert len(by["insert"]) == 1 and len(by["delete"]) == 1


def test_cdf_derived_delete_goes_through_deletion_vectors(tmp_path):
    """The deviation pinned (ROADMAP Queue 3; the reference's
    delta/commands.py:425): an overwrite removes a file whose DV already
    deleted 5 of its 30 rows. The reference derives ``delete`` for all 30
    physical rows (the 5 twice: they were delete rows of the earlier
    commit's feed); the port for the 25 live rows only. Both feeds agree
    on everything else (the DELETE's cdc rows, the overwrite's inserts)."""
    def scn(a, path):
        dt = _mk(a, path, n=30)
        dt.set_properties({"delta.enableChangeDataFeed": "true"})
        v = dt.version()
        dt.delete(a.col("id") < a.lit(5))
        a.df({"id": np.arange(200, 204, dtype=np.int64),
              "v": np.zeros(4)}).write_delta(path, mode="overwrite")
        return dt.table_changes(v + 1).collect_table()
    jo, to = _both(tmp_path, scn)
    jby, tby = _by_type(jo), _by_type(to)
    assert len(jby["delete"]) == 5 + 30 and len(tby["delete"]) == 5 + 25
    assert sorted(r[0] for r in jby["delete"]) == \
        sorted(list(range(5)) + list(range(30)))
    assert sorted(r[0] for r in tby["delete"]) == list(range(30))
    assert sorted(jby["insert"]) == sorted(tby["insert"])
    assert len(tby["insert"]) == 4


# -- column mapping ----------------------------------------------------------------

def test_rename_column_without_rewrite(tmp_path):
    def scn(a, path):
        dt = _mk(a, path, n=40)
        before = sorted(f for f in os.listdir(path) if f.endswith(".parquet"))
        dt.rename_column("v", "value")
        after = sorted(f for f in os.listdir(path) if f.endswith(".parquet"))
        m = a.snap(path).metadata
        return {"same_files": before == after,
                "rows": a.read(path).collect_table(),
                "mode": m.column_mapping_mode(),
                "phys": m.physical_names(), "log": masked_log(path)}
    jo, to = _both(tmp_path, scn)
    _check(jo, to)
    assert to["same_files"] and to["phys"]["value"] == "v"
    assert list(to["rows"].names) == ["id", "value"]


def test_mapped_table_append_and_dml(tmp_path):
    import pyarrow.parquet as pq

    def scn(a, path):
        dt = _mk(a, path, n=20)
        dt.rename_column("v", "value")
        a.df({"id": np.arange(100, 110, dtype=np.int64),
              "value": np.full(10, 7.5)}).write_delta(path, mode="append")
        newest = max(a.snap(path).files, key=lambda f: f.modification_time)
        cols = pq.ParquetFile(os.path.join(path, newest.path)) \
            .schema_arrow.names
        dt.update(a.col("id") >= a.lit(100), {"value": a.lit(1.25)})
        mid = a.read(path).collect_table()
        dt.delete(a.col("id") >= a.lit(100))
        return {"cols": cols, "mid": mid,
                "rows": a.read(path).collect_table()}
    jo, to = _both(tmp_path, scn)
    _check(jo, to)
    assert "v" in to["cols"] and "value" not in to["cols"]


def test_mapped_table_cdf_roundtrip(tmp_path):
    def scn(a, path):
        dt = _mk(a, path, n=15)
        dt.rename_column("v", "value")
        dt.set_properties({"delta.enableChangeDataFeed": "true"})
        dt.delete(a.col("id") == a.lit(3))
        return dt.table_changes(dt.version(), dt.version()).collect_table()
    jo, to = _both(tmp_path, scn)
    _check(jo, to)
    assert to.num_rows == 1


def test_rename_errors(tmp_path):
    def scn(a, path):
        dt = _mk(a, path, n=5)
        out = []
        for old, new in (("nope", "x"), ("v", "id")):
            with pytest.raises(a.CPE) as e:
                dt.rename_column(old, new)
            out.append(str(e.value))
        return out
    _check(*_both(tmp_path, scn))


def test_rename_partition_column_rejected(tmp_path):
    def scn(a, path):
        a.df({"id": np.arange(20, dtype=np.int64),
              "p": (np.arange(20) % 3).astype(np.int64)}).write_delta(
            path, partition_by=["p"])
        with pytest.raises(a.CPE) as e:
            a.dt(path).rename_column("p", "q")
        return str(e.value)
    _check(*_both(tmp_path, scn))


def test_merge_schema_append_preserves_mapping_and_cdf(tmp_path):
    def scn(a, path):
        dt = _mk(a, path, n=10)
        dt.rename_column("v", "value")
        dt.set_properties({"delta.enableChangeDataFeed": "true"})
        a.df({"id": np.arange(100, 105, dtype=np.int64),
              "value": np.full(5, 1.0),
              "extra": np.arange(5, dtype=np.int64)}).write_delta(
            path, mode="append", merge_schema=True)
        m = a.snap(path).metadata
        return {"mode": m.column_mapping_mode(), "cdf": m.cdf_enabled(),
                "value": m.physical_names()["value"],
                "rows": a.read(path).collect_table()}
    jo, to = _both(tmp_path, scn)
    _check(jo, to)
    assert to["mode"] == "name" and to["cdf"] and to["value"] == "v"


def test_merge_schema_assigns_mapping_to_new_fields(tmp_path):
    """The reference's delta/table.py:337, held in both packages: a
    new field of a mapped table gets a ``col-<uuid>`` physicalName and the
    next id, maxColumnId moves to it, and its values read back."""
    def scn(a, path):
        dt = _mk(a, path, n=10)
        dt.rename_column("v", "value")
        a.df({"id": np.arange(100, 105, dtype=np.int64),
              "value": np.full(5, 1.0),
              "extra": np.arange(5, dtype=np.int64)}).write_delta(
            path, mode="append", merge_schema=True)
        m = a.snap(path).metadata
        fields = {f["name"]: f for f in
                  json.loads(m.schema_json)["fields"]}
        md = fields["extra"]["metadata"]
        return {"pn": md["delta.columnMapping.physicalName"][:4],
                "id": md["delta.columnMapping.id"],
                "max": m.configuration["delta.columnMapping.maxColumnId"],
                "rows": a.read(path).collect_table()}
    jo, to = _both(tmp_path, scn)
    _check(jo, to)
    assert to["pn"] == "col-" and to["id"] == 3 and to["max"] == "3"
