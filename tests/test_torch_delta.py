"""The port's Delta Lake connector (spark_rapids_tpu_torch/delta) against
the reference's (spark_rapids_tpu/delta), the cases of tests/test_delta.py:
each scenario runs on both packages over the same numpy inputs
(tests/torch_lake.py) and the tests hold what they return equal:
versions, counts, statistics and errors with ``==``, reads with
``scale_test.tables_differ_unordered`` (a scan reads its files in path
order, and the paths hold uuids) or ``scale_test.tables_differ`` where one
file fixes the order (after OPTIMIZE), logs and snapshots with their time,
uuid and size fields masked (``torch_lake.masked_log``).

Also: the interop both ways (the port reads tables and checkpoints the
reference wrote; the reference and pyarrow read the port's data files, DV
files and checkpoints), the reference's legacy flattened checkpoint, the
MERGE key match against pandas' inner merge, the ``race`` fault retried
with ``commitRetries`` in the event record, SQL ``USING delta``, and the
scan's conversion (0 CPU-route nodes)."""

import json
import os
import shutil

import numpy as np
import pytest

from tests.torch_lake import (
    Api,
    masked_log,
    masked_snapshot,
    pair,
    ref_form,
    same_rows,
    same_table,
)


def _data(n=300, seed=0):
    rng = np.random.default_rng(seed)
    return {"id": np.arange(n, dtype=np.int64),
            "k": rng.integers(0, 5, n).astype(np.int64),
            "v": rng.standard_normal(n),
            "s": np.array([f"s{int(x)}" for x in
                           rng.integers(0, 50, n)], dtype=object)}


def _both(tmp_path, scenario, conf=None):
    """Run ``scenario(api, path)`` on the reference and on the port;
    returns (reference's result, port's result)."""
    j, t = pair(conf)
    return (scenario(j, str(tmp_path / "ref")),
            scenario(t, str(tmp_path / "port")))


def _check(jo, to):
    """Hold two scenario results equal: tables as row multisets, the rest
    with ``==``."""
    assert type(jo) is type(to) or hasattr(jo, "columns")
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


def _raises(a: Api, fn, match):
    with pytest.raises(a.CPE, match=match):
        fn()
    return match


# -- roaring bitmap codec ------------------------------------------------------

@pytest.mark.parametrize("idxs", [[0, 5, 17, 100000], list(range(70000)),
                                  [2**32 + 7, 2**33, 5], []],
                         ids=["array", "bitmap", "high-words", "empty"])
def test_roaring_roundtrip_small_and_dense(idxs):
    from spark_rapids_tpu.delta import roaring as jr
    from spark_rapids_tpu_torch.delta import roaring as tr
    arr = np.array(sorted(set(idxs)), dtype=np.int64)
    blob = tr.serialize_dv(arr)
    assert blob == jr.serialize_dv(arr)
    assert tr.deserialize_dv(blob).tolist() == arr.tolist()


def test_roaring_run_container_read():
    import struct

    from spark_rapids_tpu_torch.delta.roaring import deserialize_bitmap32
    buf = struct.pack("<I", 12346) + bytes([0b1])
    buf += struct.pack("<HH", 0, 13) + struct.pack("<H", 2)
    buf += struct.pack("<HH", 10, 10) + struct.pack("<HH", 50, 2)
    vals, _ = deserialize_bitmap32(buf)
    assert vals.tolist() == list(range(10, 21)) + [50, 51, 52]


# -- write / read --------------------------------------------------------------

def test_create_append_read(tmp_path):
    def scn(a, path):
        v0 = a.df(_data(300, 1)).write_delta(path)
        v1 = a.df(_data(200, 2)).write_delta(path, mode="append")
        err = _raises(a, lambda: a.df(_data(3, 1)).write_delta(path),
                      "already exists")
        return {"v": (v0, v1), "rows": a.read(path).collect_table(),
                "count": a.read(path).count(), "err": err,
                "log": masked_log(path)}
    _check(*_both(tmp_path, scn))


def test_time_travel_and_overwrite(tmp_path):
    def scn(a, path):
        a.df(_data(100, 3)).write_delta(path)
        a.df(_data(50, 4)).write_delta(path, mode="append")
        a.df(_data(20, 5)).write_delta(path, mode="overwrite")
        return {f"v{v}": a.read(path, version_as_of=v).collect_table()
                for v in (0, 1, 2)} | {"log": masked_log(path)}
    _check(*_both(tmp_path, scn))


def test_partitioned_write_and_read(tmp_path):
    def scn(a, path):
        a.df(_data(400, 6)).write_delta(path, partition_by=["k"])
        t = a.read(path)
        return {"all": t.collect_table(),
                "k2": t.filter(a.col("k") == a.lit(2)).collect_table(),
                "dirs": sorted(d for d in os.listdir(path)
                               if not d.startswith("_")),
                "snap": masked_snapshot(a.snap(path))}
    _check(*_both(tmp_path, scn))


def test_stats_written(tmp_path):
    def scn(a, path):
        a.df(_data(100, 7)).write_delta(path)
        return json.loads(a.snap(path).files[0].stats)
    jo, to = _both(tmp_path, scn)
    assert jo == to and to["numRecords"] == 100
    assert to["minValues"]["id"] == 0 and to["maxValues"]["id"] == 99


# -- DELETE --------------------------------------------------------------------

def test_delete_with_deletion_vectors(tmp_path):
    def scn(a, path):
        a.df(_data(300, 8)).write_delta(path)
        dt = a.dt(path)
        out = {"r1": dt.delete(a.col("id") < a.lit(50)),
               "c1": a.read(path).collect_table(),
               "dv1": a.snap(path).files[0].deletion_vector["cardinality"],
               "r2": dt.delete(a.col("id") < a.lit(80)),
               "c2": a.read(path).collect_table(),
               "r3": dt.delete(a.col("id") < a.lit(80))}
        dt.delete()
        out["c4"] = a.read(path).count()
        out["log"] = masked_log(path)
        return out
    jo, to = _both(tmp_path, scn)
    _check(jo, to)
    assert to["r1"]["num_affected_rows"] == 50 and to["dv1"] == 50


def test_delete_time_travel_preserves_old_versions(tmp_path):
    def scn(a, path):
        a.df(_data(100, 9)).write_delta(path)
        a.dt(path).delete(a.col("id") >= a.lit(90))
        return (a.read(path).collect_table(),
                a.read(path, version_as_of=0).collect_table())
    _check(*_both(tmp_path, scn))


def test_delete_dv_roundtrip_with_new_framing(tmp_path):
    """The DV file's bytes after its uuid name are the reference's: the
    format byte, the big-endian size, the roaring blob and its CRC."""
    def scn(a, path):
        a.df(_data(200, 40)).write_delta(path)
        a.dt(path).delete(a.col("id") < a.lit(60))
        dv = a.snap(path).files[0].deletion_vector
        p = os.path.join(path, a.table._dv_relative_path(
            dv["pathOrInlineDv"]))
        return {"rows": a.read(path).collect_table(),
                "bytes": open(p, "rb").read()}
    _check(*_both(tmp_path, scn))


# -- UPDATE --------------------------------------------------------------------

def test_update(tmp_path):
    def scn(a, path):
        a.df(_data(200, 10)).write_delta(path)
        res = a.dt(path).update(a.col("id") < a.lit(10),
                                {"v": a.lit(99.5), "s": a.lit("updated")})
        return {"res": res, "rows": a.read(path).collect_table(),
                "log": masked_log(path)}
    _check(*_both(tmp_path, scn))


def test_update_expression_over_columns(tmp_path):
    def scn(a, path):
        a.df(_data(100, 11)).write_delta(path)
        a.dt(path).update(None, {"v": a.col("v") * a.lit(2.0)})
        return a.read(path).collect_table()
    _check(*_both(tmp_path, scn))


# -- MERGE ---------------------------------------------------------------------

def test_merge_update_insert(tmp_path):
    def scn(a, path):
        a.df({"id": np.arange(10, dtype=np.int64),
              "v": np.zeros(10)}).write_delta(path)
        src = a.df({"id": np.array([5, 6, 20, 21], dtype=np.int64),
                    "v": np.array([55.0, 66.0, 2.0, 2.1])})
        res = (a.dt(path).merge(src, on=["id"])
               .when_matched_update(set={"v": "v"})
               .when_not_matched_insert().execute())
        return {"res": res, "rows": a.read(path).collect_table()}
    jo, to = _both(tmp_path, scn)
    _check(jo, to)
    assert to["res"]["num_matched_rows"] == 2
    assert to["res"]["num_inserted_rows"] == 2


def test_merge_delete(tmp_path):
    def scn(a, path):
        a.df({"id": np.arange(10, dtype=np.int64),
              "v": np.ones(10)}).write_delta(path)
        src = a.df({"id": np.array([3, 4], dtype=np.int64),
                    "v": np.zeros(2)})
        res = a.dt(path).merge(src, on=["id"]).when_matched_delete() \
            .execute()
        return {"res": res, "rows": a.read(path).collect_table()}
    _check(*_both(tmp_path, scn))


def test_merge_duplicate_source_keys_rejected(tmp_path):
    def scn(a, path):
        a.df({"id": np.arange(5, dtype=np.int64),
              "v": np.zeros(5)}).write_delta(path)
        dup = a.df({"id": np.array([1, 1], dtype=np.int64),
                    "v": np.array([7.0, 8.0])})
        return _raises(a, lambda: a.dt(path).merge(dup, on=["id"])
                       .when_matched_update(set={"v": "v"}).execute(),
                       "multiple rows")
    _check(*_both(tmp_path, scn))


def test_merge_null_keys_never_match(tmp_path):
    def scn(a, path):
        a.df({"id": (np.array([0, 1, 0], dtype=np.int64),
                     np.array([True, True, False])),
              "v": np.array([1.0, 2.0, 3.0])}).write_delta(path)
        src = a.df({"id": (np.array([0, 0], dtype=np.int64),
                           np.array([True, False])),
                    "v": np.array([99.0, 98.0])})
        res = (a.dt(path).merge(src, on=["id"])
               .when_matched_update(set={"v": "v"})
               .when_not_matched_insert().execute())
        return {"res": res, "rows": a.read(path).collect_table()}
    jo, to = _both(tmp_path, scn)
    _check(jo, to)
    assert to["res"]["num_matched_rows"] == 1
    assert to["res"]["num_inserted_rows"] == 1  # the null-keyed source row


def test_merge_update_and_delete_combination_rejected(tmp_path):
    def scn(a, path):
        a.df(_data(5, 84)).write_delta(path)
        mb = a.dt(path).merge(a.df({"id": np.array([1], dtype=np.int64)}),
                              on=["id"])
        mb.when_matched_update(set={})
        return _raises(a, mb.when_matched_delete, "cannot combine")
    _check(*_both(tmp_path, scn))


def _two_files(a, path):
    a.df({"k": np.arange(0, 50, dtype=np.int64),
          "v": np.arange(0, 50, dtype=np.int64)}).write_delta(path)
    a.df({"k": np.arange(50, 100, dtype=np.int64),
          "v": np.arange(50, 100, dtype=np.int64)}).write_delta(
        path, mode="append")


@pytest.mark.parametrize("low_shuffle", ["true", "false"])
def test_low_shuffle_merge_only_touches_matched_rows(tmp_path, low_shuffle):
    def scn(a, path):
        _two_files(a, path)
        src = a.df({"k": np.array([60, 70], dtype=np.int64),
                    "nv": np.array([-1, -2], dtype=np.int64)})
        res = (a.dt(path).merge(src, on=["k"])
               .when_matched_update(set={"v": "nv"}).execute())
        return {"res": res, "rows": a.read(path).collect_table(),
                "log": masked_log(path)}
    jo, to = _both(tmp_path, scn, {
        "spark.rapids.sql.delta.lowShuffleMerge.enabled": low_shuffle})
    _check(jo, to)
    assert to["res"]["low_shuffle"] is (low_shuffle == "true")
    assert to["res"]["num_dv_files"] == (low_shuffle == "true")


def test_low_shuffle_merge_delete_writes_no_data_file(tmp_path):
    def scn(a, path):
        _two_files(a, path)
        before = {f.path for f in a.snap(path).files}
        src = a.df({"k": np.array([10, 99], dtype=np.int64)})
        res = a.dt(path).merge(src, on=["k"]).when_matched_delete() \
            .execute()
        return {"res": res, "same_files": before == {
            f.path for f in a.snap(path).files},
            "rows": a.read(path).collect_table()}
    jo, to = _both(tmp_path, scn)
    _check(jo, to)
    assert to["same_files"] and to["res"]["num_dv_files"] == 2


def test_low_shuffle_insert_only_keeps_matched_rows(tmp_path):
    def scn(a, path):
        a.df({"k": np.arange(5, dtype=np.int64),
              "v": np.arange(5, dtype=np.int64)}).write_delta(path)
        src = a.df({"k": np.array([3, 7], dtype=np.int64),
                    "v": np.array([30, 70], dtype=np.int64)})
        res = a.dt(path).merge(src, on=["k"]).when_not_matched_insert() \
            .execute()
        return {"res": res, "rows": a.read(path).collect_table()}
    _check(*_both(tmp_path, scn))


def test_low_shuffle_update_casts_source_dtype(tmp_path):
    def scn(a, path):
        a.df({"k": np.arange(4, dtype=np.int64),
              "v": np.arange(4, dtype=np.int64)}).write_delta(path)
        src = a.df({"k": np.array([2], dtype=np.int64),
                    "nv": np.array([7.5])})
        a.dt(path).merge(src, on=["k"]).when_matched_update(
            set={"v": "nv"}).execute()
        return a.read(path).collect_table()
    _check(*_both(tmp_path, scn))


def test_merge_key_match_equals_pandas_inner_merge():
    """The sort-merge that replaces the reference's pandas inner merge
    gives the same matched pairs (the last source row per target row, as
    the reference's assignment keeps) over two key columns with
    duplicates, strings and NaN."""
    import pandas as pd

    from spark_rapids_tpu_torch.delta.commands import _merge_match
    rng = np.random.default_rng(5)
    for trial in range(20):
        nt, ns = int(rng.integers(0, 60)), int(rng.integers(0, 40))
        tk = [rng.integers(0, 6, nt).astype(np.int64),
              np.array([f"s{x}" for x in rng.integers(0, 3, nt)],
                       dtype=object)]
        sk = [rng.integers(0, 6, ns).astype(np.int64),
              np.array([f"s{x}" for x in rng.integers(0, 3, ns)],
                       dtype=object)]
        if nt == 0 or ns == 0:
            continue
        got, src_hit = _merge_match(tk, sk)
        probe = pd.DataFrame({"a": tk[0], "b": tk[1],
                              "__t": np.arange(nt)})
        src = pd.DataFrame({"a": sk[0], "b": sk[1], "__s": np.arange(ns)})
        joined = probe.merge(src, on=["a", "b"], how="inner")
        want = np.full(nt, -1, dtype=np.int64)
        want[joined["__t"].to_numpy()] = joined["__s"].to_numpy()
        assert got.tolist() == want.tolist(), trial
        assert set(np.flatnonzero(src_hit)) == set(joined["__s"])
    f = [np.array([1.0, np.nan, 2.0])]
    got, _ = _merge_match(f, [np.array([np.nan, 2.0])])
    assert got.tolist() == [-1, 0, 1]


# -- schema evolution ----------------------------------------------------------

def test_append_with_added_column_merge_schema(tmp_path):
    def scn(a, path):
        a.df({"k": np.arange(5, dtype=np.int64)}).write_delta(path)
        df2 = a.df({"k": np.arange(5, 8, dtype=np.int64),
                    "extra": np.array([1.5, 2.5, 3.5])})
        err = _raises(a, lambda: df2.write_delta(path, mode="append"),
                      "merge_schema")
        v = df2.write_delta(path, mode="append", merge_schema=True)
        return {"err": err, "v": v, "rows": a.read(path).collect_table(),
                "snap": masked_snapshot(a.snap(path))}
    _check(*_both(tmp_path, scn))


def test_merge_schema_type_conflict_raises(tmp_path):
    def scn(a, path):
        a.df({"k": np.arange(3, dtype=np.int64)}).write_delta(path)
        bad = a.df({"k": np.array([1.0, 2.0])})
        return _raises(a, lambda: bad.write_delta(
            path, mode="append", merge_schema=True), "cannot change")
    _check(*_both(tmp_path, scn))


def test_merge_update_after_schema_evolution(tmp_path):
    def scn(a, path):
        a.df({"k": np.arange(3, dtype=np.int64)}).write_delta(path)
        a.df({"k": np.array([10], dtype=np.int64),
              "extra": np.array([5.0])}).write_delta(
            path, mode="append", merge_schema=True)
        src = a.df({"k": np.array([1], dtype=np.int64),
                    "ne": np.array([9.5])})
        a.dt(path).merge(src, on=["k"]).when_matched_update(
            set={"extra": "ne"}).execute()
        return a.read(path).collect_table()
    _check(*_both(tmp_path, scn))


def test_merge_schema_commit_does_not_blind_retry(tmp_path):
    def scn(a, path):
        a.df({"k": np.arange(3, dtype=np.int64)}).write_delta(path)
        log = a.log.DeltaLog(path)
        snap = log.snapshot()
        txn = a.table.OptimisticTransaction(log, a.session.conf,
                                            read_version=snap.version)
        long_t = type(snap.schema[0][1])()
        txn.stage(a.log.Metadata(a.log.schema_to_json(
            list(snap.schema) + [("x", long_t)]), [],
            table_id=snap.metadata.table_id))
        a.df({"k": np.array([9], dtype=np.int64)}).write_delta(
            path, mode="append")
        with pytest.raises(a.log.DeltaConcurrentModificationException):
            txn.commit("WRITE")
        return {"rows": a.read(path).collect_table(),
                "log": masked_log(path)}
    _check(*_both(tmp_path, scn))


def test_overwrite_schema_mismatch_rejected(tmp_path):
    def scn(a, path):
        a.df(_data(10, 70)).write_delta(path)
        other = a.df({"a": np.arange(3, dtype=np.int64)})
        err = _raises(a, lambda: other.write_delta(path, mode="overwrite"),
                      "schema mismatch")
        return {"err": err, "v": other.write_delta(path, mode="ignore"),
                "n": a.read(path).count()}
    _check(*_both(tmp_path, scn))


def test_partition_only_projection(tmp_path):
    def scn(a, path):
        a.df(_data(100, 80)).write_delta(path, partition_by=["k"])
        return a.read(path, columns=["k"]).collect_table()
    jo, to = _both(tmp_path, scn)
    _check(jo, to)
    assert to.num_rows == 100 and list(to.names) == ["k"]


def test_append_partitioning_mismatch_rejected(tmp_path):
    def scn(a, path):
        a.df(_data(20, 81)).write_delta(path, partition_by=["k"])
        err = _raises(a, lambda: a.df(_data(20, 82)).write_delta(
            path, mode="append"), "partitioning")
        a.df(_data(20, 83)).write_delta(path, mode="append",
                                        partition_by=["k"])
        return {"err": err, "rows": a.read(path).collect_table()}
    _check(*_both(tmp_path, scn))


# -- OPTIMIZE / ZORDER -----------------------------------------------------------

def test_optimize_compacts_small_files(tmp_path):
    def scn(a, path):
        for i in range(4):
            a.df(_data(50, 20 + i)).write_delta(
                path, mode="append" if i else "error")
        res = a.dt(path).optimize()
        return {"res": res, "files": len(a.snap(path).files),
                "rows": a.read(path).collect_table(),
                "log": masked_log(path)}
    _check(*_both(tmp_path, scn))


def test_zorder_clusters(tmp_path):
    """After OPTIMIZE ZORDER BY the table is one file in z-order: the
    port's read equals the reference's row for row."""
    rng = np.random.default_rng(0)
    data = {"x": rng.integers(0, 100, 1000).astype(np.int64),
            "y": rng.integers(0, 100, 1000).astype(np.int64)}

    def scn(a, path):
        a.df(data).write_delta(path)
        a.dt(path).optimize(zorder_by=["x", "y"])
        return a.read(path).collect_table()
    jo, to = _both(tmp_path, scn)
    same_table(jo, to)
    xs, ys = (np.asarray(c.data, dtype=float) for c in to.columns)
    assert (np.abs(np.diff(xs)) + np.abs(np.diff(ys))).mean() < 25


def test_zorder_key_interleaving_exact():
    from spark_rapids_tpu.delta.zorder import zorder_key_host as jz
    from spark_rapids_tpu_torch.delta.zorder import zorder_key_host as tz
    rng = np.random.default_rng(1)
    data = {"a": rng.integers(-50, 50, 200).astype(np.int64),
            "b": rng.standard_normal(200),
            "c": np.array([f"x{i % 7}" for i in range(200)], dtype=object)}
    j, t = Api(False), Api(True)
    assert tz(t.host(data), ["a", "b", "c"]).tolist() == \
        jz(j.host(data), ["a", "b", "c"]).tolist()


# -- VACUUM / history / checkpoints ----------------------------------------------

def test_vacuum_removes_orphans(tmp_path):
    def scn(a, path):
        a.df(_data(100, 30)).write_delta(path)
        a.df(_data(100, 31)).write_delta(path, mode="overwrite")
        dry = a.dt(path).vacuum(dry_run=True)
        res = a.dt(path).vacuum()
        with pytest.raises(Exception):
            a.read(path, version_as_of=0).collect()
        return {"dry": len(dry["orphans"]), "deleted": res["files_deleted"],
                "rows": a.read(path).collect_table()}
    jo, to = _both(tmp_path, scn)
    _check(jo, to)
    assert to["deleted"] == to["dry"] == 1


def test_history(tmp_path):
    def scn(a, path):
        a.df(_data(10, 32)).write_delta(path)
        a.dt(path).delete(a.col("id") < a.lit(5))
        return [(e["version"], e["operation"]) for e in a.dt(path).history()]
    jo, to = _both(tmp_path, scn)
    assert jo == to == [(1, "DELETE"), (0, "CREATE TABLE AS SELECT")]


def test_checkpoint_replay(tmp_path):
    """A checkpoint every 4 commits: the port's and the reference's
    snapshots (from the checkpoint) are equal, and each package reads the
    other's checkpoint to the same snapshot."""
    def scn(a, path):
        for i in range(6):
            a.df(_data(10, 40 + i)).write_delta(
                path, mode="append" if i else "error")
        log = a.log.DeltaLog(path)
        return {"cp": log._last_checkpoint(),
                "snap": masked_snapshot(log.snapshot()),
                "rows": a.read(path).collect_table()}
    jo, to = _both(tmp_path, scn, {"spark.rapids.delta.checkpointInterval":
                                   "4"})
    _check(jo, to)
    assert to["cp"]["version"] == 4
    from spark_rapids_tpu.delta.log import DeltaLog as JLog
    from spark_rapids_tpu_torch.delta.log import DeltaLog as TLog
    for reader, path, want in ((JLog, tmp_path / "port", to["snap"]),
                               (TLog, tmp_path / "ref", jo["snap"])):
        log = reader(str(path))
        meta, adds = log._read_checkpoint(4)
        assert len(adds) == 5 and meta is not None
        assert masked_snapshot(log.snapshot()) == want


def test_checkpoint_spec_schema_roundtrip(tmp_path):
    """pyarrow reads the port's checkpoint in the spec's nested schema and
    its rows equal the reference's checkpoint rows (masked)."""
    import pyarrow.parquet as pq

    from tests.torch_lake import _mask

    def scn(a, path):
        for i in range(5):
            a.df(_data(40, 20 + i)).write_delta(
                path, mode="append" if i else "error")
        v = a.log.DeltaLog(path)._last_checkpoint()["version"]
        t = pq.read_table(os.path.join(
            path, "_delta_log", f"{v:020d}.checkpoint.parquet"))
        return {"names": t.schema.names, "types": str(t.schema),
                "rows": _mask(t.to_pylist())}
    _check(*_both(tmp_path, scn, {"spark.rapids.delta.checkpointInterval":
                                  "3"}))


def test_legacy_and_unrecognized_checkpoints(tmp_path):
    """The port reads the reference's legacy flattened checkpoint form,
    and a checkpoint of a schema neither knows falls back to a full
    replay, as the reference's does."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    t = Api(True)
    path = str(tmp_path / "t")
    for i in range(4):
        t.df(_data(30, 30 + i)).write_delta(
            path, mode="append" if i else "error")
    full = masked_snapshot(t.snap(path))
    snap2 = t.snap(path, 2)
    m = snap2.metadata
    rows = [{"metaData_schemaString": m.schema_json,
             "metaData_partitionColumns": json.dumps(m.partition_columns),
             "metaData_id": m.table_id,
             "metaData_configuration": json.dumps(m.configuration),
             "add_path": None, "add_partitionValues": None,
             "add_size": None, "add_modificationTime": None,
             "add_stats": None, "add_deletionVector": None}]
    for a in snap2.files:
        rows.append({"metaData_schemaString": None,
                     "metaData_partitionColumns": None, "metaData_id": None,
                     "metaData_configuration": None, "add_path": a.path,
                     "add_partitionValues": json.dumps(a.partition_values),
                     "add_size": a.size,
                     "add_modificationTime": a.modification_time,
                     "add_stats": a.stats, "add_deletionVector": None})
    cp = os.path.join(path, "_delta_log", f"{2:020d}.checkpoint.parquet")
    pq.write_table(pa.Table.from_pylist(rows), cp)
    with open(os.path.join(path, "_delta_log", "_last_checkpoint"),
              "w") as f:
        json.dump({"version": 2, "size": len(rows)}, f)
    meta, adds = t.log.DeltaLog(path)._read_checkpoint(2)
    assert sorted(adds) == sorted(a.path for a in snap2.files)
    assert masked_snapshot(t.snap(path)) == full
    pq.write_table(pa.Table.from_pylist([{"txn": "x"}]), cp)
    with pytest.raises(ValueError, match="unrecognized checkpoint"):
        t.log.DeltaLog(path)._read_checkpoint(2)
    assert masked_snapshot(t.snap(path)) == full


def test_dv_file_spec_framing(tmp_path):
    import base64

    from spark_rapids_tpu.delta.table import read_dv as jread
    from spark_rapids_tpu_torch.delta import table as tt
    from spark_rapids_tpu_torch.delta.roaring import serialize_dv
    from spark_rapids_tpu_torch.errors import ColumnarProcessingError
    tp = str(tmp_path)
    idx = np.array([1, 5, 7, 100000], dtype=np.int64)
    desc = tt.write_dv_file(tp, idx)
    assert desc["storageType"] == "u" and desc["offset"] == 1
    p = os.path.join(tp, tt._dv_relative_path(desc["pathOrInlineDv"]))
    raw = open(p, "rb").read()
    assert jread(tp, desc).tolist() == tt.read_dv(tp, desc).tolist() == \
        idx.tolist()
    bad = bytearray(raw)
    bad[6] ^= 0xFF
    open(p, "wb").write(bytes(bad))
    with pytest.raises(ColumnarProcessingError, match="checksum"):
        tt.read_dv(tp, desc)
    open(p, "wb").write(raw)
    blob = serialize_dv(idx)
    inline = {"storageType": "i",
              "pathOrInlineDv": base64.b85encode(blob).decode(),
              "offset": 0, "sizeInBytes": len(blob), "cardinality": 4}
    assert tt.read_dv(tp, inline).tolist() == idx.tolist()
    pdesc = dict(desc, storageType="p", pathOrInlineDv=p)
    assert tt.read_dv(tp, pdesc).tolist() == idx.tolist()


def test_concurrent_commit_conflict_and_race_retry(tmp_path):
    """A second direct commit of one version raises; the transaction
    rebases a blind append past the lost race, as the reference's."""
    def scn(a, path):
        a.df(_data(10, 50)).write_delta(path)
        log = a.log.DeltaLog(path)
        log.commit([], 1, "TEST")
        with pytest.raises(a.log.DeltaConcurrentModificationException):
            log.commit([], 1, "TEST")
        v2 = a.df(_data(5, 51)).write_delta(path, mode="append")
        return {"v": v2, "rows": a.read(path).collect_table()}
    jo, to = _both(tmp_path, scn)
    _check(jo, to)
    assert to["v"] == 2


def test_race_retry_lands_in_the_event_record(tmp_path):
    """The deviation pinned (ROADMAP Queue 3): a commit runs after its
    write's query, so the reference's records never see its retry
    (``commitRetries`` 0 in the next record); the port stages the retry
    for the next record on the thread (1), beside the ``write`` scope's
    counter, which both packages move by 1."""
    from spark_rapids_tpu.io.committer import WRITE_METRICS as JW
    from spark_rapids_tpu.runtime.faults import FAULTS as JF
    from spark_rapids_tpu_torch.io.committer import WRITE_METRICS as TW
    from spark_rapids_tpu_torch.runtime.faults import FAULTS as TF
    conf = {"spark.rapids.sql.eventLog.enabled": "true",
            "spark.rapids.sql.eventLog.dir": str(tmp_path / "ev")}
    got = {}
    race = dict(conf, **{"spark.rapids.test.faults":
                         "delta.commit.race:race:1"})
    for port, faults, scope in ((False, JF, JW), (True, TF, TW)):
        a, b = Api(port, conf), Api(port, race)
        path = str(tmp_path / ("port" if port else "ref"))
        a.df(_data(10, 1)).write_delta(path)
        before = scope.get("commitRetries", 0)
        try:
            assert b.df(_data(5, 2)).write_delta(path, mode="append") == 1
            b.read(path).count()
        finally:
            faults.disarm()
        got[port] = (scope.get("commitRetries", 0) - before,
                     b.session.last_event_record["commitRetries"])
    assert got == {False: (1, 0), True: (1, 1)}


# -- the engine path, SQL and interop --------------------------------------------

def test_delta_scan_through_engine_ops(tmp_path):
    """A filter and group-by over the Delta scan: the port converts it
    with 0 CPU-route nodes (TpuFileScanExec) and equals the reference."""
    def scn(a, path):
        a.df(_data(500, 60)).write_delta(path)
        F = a.F
        df = (a.read(path).filter(a.col("v") > a.lit(0.0))
              .group_by("k").agg(F.count("id").alias("c"),
                                 F.sum("id").alias("si")))
        out = {"rows": df.collect_table()}
        if a.port:
            from spark_rapids_tpu_torch.obs.events import collect_fallbacks
            out["fallbacks"] = collect_fallbacks(a.session.last_meta)
            out["scan"] = "TpuFileScanExec" in repr(
                [type(e).__name__ for e in _walk(
                    a.session._last_executable)])
        return out
    jo, to = _both(tmp_path, scn)
    same_rows(jo["rows"], to["rows"])
    assert to["fallbacks"] == [] and to["scan"]


def _walk(root):
    out, stack = [], [root]
    while stack:
        e = stack.pop()
        out.append(e)
        stack.extend(getattr(e, "children", ()))
    return out


def test_sql_using_delta_and_reader_format(tmp_path):
    t = Api(True)
    path = str(tmp_path / "t")
    t.df(_data(50, 3)).write_delta(path)
    t.df(_data(20, 4)).write_delta(path, mode="append")
    s = t.session
    s.sql(f"CREATE TEMP VIEW dv USING delta OPTIONS (path '{path}')")
    got = s.sql("SELECT k, COUNT(*) AS n FROM dv GROUP BY k").collect_table()
    want = (t.read(path).group_by("k")
            .agg(t.F.count("id").alias("n")).collect_table())
    same_rows(want, got)
    same_rows(t.read(path).collect_table(),
              s.read.format("delta").load(path).collect_table())
    same_rows(t.read(path, version_as_of=0).collect_table(),
              s.read.format("delta").option("version_as_of", 0)
              .load(path).collect_table())


def test_interop_reference_tables_and_port_files(tmp_path):
    """The port reads a table the reference wrote (DELETE's DV, UPDATE's
    rewrite, a checkpoint) to the reference's rows; pyarrow reads the
    port's data files, and the reference reads the port's table, DVs and
    checkpoint to the port's rows."""
    import pyarrow.parquet as pq
    conf = {"spark.rapids.delta.checkpointInterval": "3"}
    j, t = pair(conf)
    for a, b, name in ((j, t, "ref"), (t, j, "port")):
        path = str(tmp_path / name)
        a.df(_data(120, 9)).write_delta(path)
        a.dt(path).delete(a.col("id") < a.lit(20))
        a.dt(path).update(a.col("k") == a.lit(1), {"v": a.lit(0.5)})
        a.df(_data(30, 10)).write_delta(path, mode="append")
        assert os.path.exists(os.path.join(
            path, "_delta_log", f"{3:020d}.checkpoint.parquet"))
        same_rows(a.read(path).collect_table(), b.read(path).collect_table())
        same_rows(a.read(path, version_as_of=1).collect_table(),
                  b.read(path, version_as_of=1).collect_table())
        assert masked_snapshot(b.snap(path)) == masked_snapshot(a.snap(path))
    for f in t.snap(str(tmp_path / "port")).files:
        got = pq.read_table(os.path.join(tmp_path, "port", f.path))
        assert got.num_rows == json.loads(f.stats)["numRecords"]


def test_read_only_latest_after_copy_of_reference_table(tmp_path):
    """A reference table copied elsewhere keeps reading: the log's paths
    are relative to the table."""
    j, t = pair()
    src = str(tmp_path / "a")
    j.df(_data(40, 1)).write_delta(src)
    j.dt(src).delete(j.col("id") < j.lit(10))
    dst = str(tmp_path / "b")
    shutil.copytree(src, dst)
    same_rows(j.read(src).collect_table(), t.read(dst).collect_table())
    assert ref_form(t.read(dst).collect_table()).num_rows == 30


@pytest.mark.parametrize("how", ["index", "mask", "table"])
def test_take_keeps_a_string_columns_codes(how):
    """``HostColumn.take`` (the deletion-vector mask, the Iceberg deletes,
    MERGE's permutation, the Parquet and CSV readers) carries a string
    column's codes: the narrowed dictionary is strictly increasing, holds
    the taken rows' distinct strings (``np.unique``) and decodes every
    valid row to its string."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
    rng = np.random.default_rng(3)
    n = 500
    vals = np.array([f"v{int(x):02d}" for x in rng.integers(0, 40, n)],
                    dtype=object)
    valid = rng.random(n) > 0.1
    vals[~valid] = None
    c = HostColumn(T.STRING, vals, valid)
    c.encoded()
    if how == "mask":
        rows = rng.random(n) < 0.3
    else:
        rows = rng.permutation(n)[:120]
        rows = np.concatenate([rows, rows[:10]])
    got = (HostTable(["s"], [c]).take(rows).columns[0] if how == "table"
           else c.take(rows))
    want, want_valid = vals[rows], valid[rows]
    assert list(got.data) == list(want)
    assert (got.validity == want_valid).all()
    codes, dictionary = got._cache["encode"]
    assert len(codes) == len(want)
    assert (dictionary[:-1] < dictionary[1:]).all()
    live = want[want_valid]
    assert set(dictionary) - {""} == set(np.unique(live.astype(str)))
    assert list(dictionary[codes[want_valid]]) == list(live)
