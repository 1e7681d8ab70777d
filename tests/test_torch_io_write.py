"""The port's transactional writer and its fault points
(spark_rapids_tpu_torch/io/writer.py, io/committer.py,
plan/nodes.py::WriteFiles, runtime/faults.py): the cases of
tests/test_write_txn.py that need neither Delta, the vacuum tool nor the
crash handler, and the fault registry's spec grammar and schedule, held
against the reference's registry (tests/test_faults_recovery.py).

Comparator: ``scale_test.tables_differ_unordered`` for rows read back
(a partitioned write's files list its rows partition by partition); the
schedules compare as lists."""

import os

import numpy as np
import pytest

from scale_test import tables_differ_unordered
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.runtime import faults as jfaults
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.errors import (
    ColumnarProcessingError,
    KernelCrashError,
    RetryOOM,
    ShuffleFetchError,
)
from spark_rapids_tpu_torch.io.committer import (
    TEMP_DIR,
    WRITE_METRICS,
    WriteJob,
    read_manifest,
)
from spark_rapids_tpu_torch.plan import from_host_table
from spark_rapids_tpu_torch.plan import nodes as P
from spark_rapids_tpu_torch.runtime.faults import (
    FAULTS,
    FaultRegistry,
    backoff_retry,
    parse_fault_spec,
)
from spark_rapids_tpu_torch.session import TorchSession


@pytest.fixture(autouse=True)
def _clean_fault_state():
    FAULTS.disarm()
    yield
    FAULTS.disarm()


def _as_reference(t) -> JHostTable:
    names, types, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, v)
        for ty, (d, v) in zip(types, arrays)])


def _table(n=40) -> HostTable:
    return HostTable(["k", "v"], [
        HostColumn(T.STRING, np.array([f"k{i % 3}" for i in range(n)],
                                      dtype=object)),
        HostColumn(T.LONG, np.arange(n, dtype=np.int64))])


def _df(s, n=40):
    return from_host_table(_table(n), s)


def _session(faults=None):
    conf = {"spark.rapids.test.faults": faults} if faults else None
    return TorchSession(conf, device="cpu")


def _visible_parts(path):
    """Files a scan would list (hidden files and directories skipped)."""
    out = []
    for _root, dirs, files in os.walk(path):
        dirs[:] = [d for d in dirs if not d.startswith(("_", "."))]
        out.extend(f for f in files if not f.startswith(("_", ".")))
    return sorted(out)


def _rows(s, path):
    return _as_reference(s.read_parquet(path).collect_table())


# -- the commit protocol -------------------------------------------------------

def test_write_commits_manifest(tmp_path):
    s = _session()
    out = str(tmp_path / "t")
    stats = _df(s).write_parquet(out)
    m = read_manifest(out)
    assert m is not None and m["numFiles"] == stats.columns[0].data[0] == 1
    assert m["numRows"] == stats.columns[1].data[0] == 40
    assert m["numBytes"] == stats.columns[2].data[0] > 0
    assert sorted(m["files"]) == _visible_parts(out)
    assert m["jobId"]
    assert not os.path.exists(os.path.join(out, TEMP_DIR))
    assert s.last_metrics()["filesWritten"] == 1
    assert s.last_metrics()["jobsCommitted"] == 1


def test_standalone_writer_commits(tmp_path):
    """A direct write_parquet (no session) runs the whole protocol."""
    from spark_rapids_tpu_torch.io.parquet import write_parquet
    out = str(tmp_path / "c")
    files = write_parquet(_table(3), out)
    assert files == [os.path.join(out, "part-00000.parquet")]
    assert os.path.exists(files[0])
    assert read_manifest(out)["files"] == ["part-00000.parquet"]
    assert not os.path.exists(os.path.join(out, TEMP_DIR))


def test_writer_surface_and_other_formats(tmp_path):
    s = _session()
    out = str(tmp_path / "w")
    _df(s).write.format("parquet").partition_by("k").save(out)
    assert sorted(os.listdir(out)) == ["_SUCCESS", "k=k0", "k=k1", "k=k2"]
    for fmt in ("csv", "json", "orc"):
        with pytest.raises(NotImplementedError, match=fmt):
            _df(s).write.format(fmt).save(str(tmp_path / fmt))
    with pytest.raises(NotImplementedError, match="hive-text"):
        _df(s).write_hive_text(str(tmp_path / "h"))


# -- exactly once under failures -------------------------------------------------

def test_kill_mid_file_write_aborts_clean(tmp_path):
    s = _session("io.write.file:crash:1")
    out = str(tmp_path / "k")
    node = P.WriteFiles(_df(s).plan, "parquet", out, ["k"], {})
    with pytest.raises(KernelCrashError):
        s.execute(node)
    # nothing reader-visible, no marker, staging swept
    assert _visible_parts(out) == []
    assert read_manifest(out) is None
    assert not os.path.exists(os.path.join(out, TEMP_DIR))
    assert s.last_metrics()["jobsAborted"] == 1
    # the armed count is spent: the SAME plan converges
    s.execute(node)
    clean = str(tmp_path / "clean")
    _df(s).write_parquet(clean, partition_by=["k"])
    assert tables_differ_unordered(_rows(s, out), _rows(s, clean)) is None


def test_kill_mid_task_commit_rolls_back_promoted(tmp_path):
    """A failure during promotion (some files renamed into place) rolls
    the promoted ones back: readers never see a partial job."""
    s = _session("io.write.commit:crash:2")
    out = str(tmp_path / "p")
    node = P.WriteFiles(_df(s).plan, "parquet", out, ["k"], {})
    with pytest.raises(KernelCrashError):
        s.execute(node)
    assert FAULTS.counters()["io.write.commit"] == 1
    assert _visible_parts(out) == []
    assert not os.path.exists(os.path.join(out, TEMP_DIR))


def test_killed_overwrite_keeps_old_data_visible(tmp_path):
    out = str(tmp_path / "o")
    clean = _session()
    _df(clean, 10).write_parquet(out)
    before = _rows(clean, out)
    s = _session("io.write.file:crash:1")
    with pytest.raises(KernelCrashError):
        s.execute(P.WriteFiles(_df(s).plan, "parquet", out, None, {}))
    assert tables_differ_unordered(_rows(clean, out), before) is None


def test_abort_fault_still_rolls_back(tmp_path):
    """An armed io.write.abort fault surfaces after the rollback ran."""
    out = str(tmp_path / "a")
    s = _session("io.write.file:crash:1;io.write.abort:oom:1")
    with pytest.raises(RetryOOM):
        s.execute(P.WriteFiles(_df(s).plan, "parquet", out, ["k"], {}))
    assert _visible_parts(out) == []
    assert not os.path.exists(os.path.join(out, TEMP_DIR))


def test_abort_mid_promotion_restores_clobbered_originals(tmp_path):
    out = str(tmp_path / "c")
    os.makedirs(out)
    for rel in ("part-00000.parquet", "part-00001.parquet"):
        with open(os.path.join(out, rel), "w") as f:
            f.write(f"OLD:{rel}")
    job = WriteJob(out)
    for rel in ("part-00000.parquet", "part-00001.parquet"):
        with open(job.stage_path(rel), "w") as f:
            f.write(f"NEW:{rel}")
    # the first file promoted over the original, then the job dies
    job._staged, rest = job._staged[:1], job._staged[1:]
    job.commit_task()
    assert open(os.path.join(out, "part-00000.parquet")).read() == \
        "NEW:part-00000.parquet"
    job._staged = rest
    job.abort()
    for rel in ("part-00000.parquet", "part-00001.parquet"):
        assert open(os.path.join(out, rel)).read() == f"OLD:{rel}"
    assert not os.path.exists(os.path.join(out, TEMP_DIR))


def test_requeued_write_idempotent_by_job_uuid(tmp_path):
    """Running the SAME WriteFiles node again after it committed serves
    the manifest's stats and writes nothing."""
    s = _session()
    out = str(tmp_path / "i")
    node = P.WriteFiles(_df(s).plan, "parquet", out, None, {})
    r1 = s.execute(node)
    f = os.path.join(out, "part-00000.parquet")
    mtime = os.path.getmtime(f)
    before = WRITE_METRICS["filesWritten"]
    r2 = s.execute(node)
    assert [c.data.tolist() for c in r1.columns] == \
        [c.data.tolist() for c in r2.columns]
    assert WRITE_METRICS["filesWritten"] == before
    assert os.path.getmtime(f) == mtime


def test_partitioned_write_fires_fault_point(tmp_path):
    s = _session("io.write.file:crash:1")
    with pytest.raises(KernelCrashError):
        _df(s).write_parquet(str(tmp_path / "f"), partition_by=["k"])
    assert FAULTS.counters().get("io.write.file") == 1


def test_read_fault_point(tmp_path):
    from spark_rapids_tpu_torch.io.parquet import write_parquet
    write_parquet(_table(), str(tmp_path / "r"))
    s = _session("io.read.file:fetch:1")
    with pytest.raises(ShuffleFetchError, match="io.read.file"):
        s.read_parquet(str(tmp_path / "r")).collect()
    assert s.read_parquet(str(tmp_path / "r")).count() == 40


# -- the fault registry, held against the reference's -------------------------

def test_fault_spec_parsing_and_validation():
    spec = ("io.read.file:fetch:0.5:7;io.write.file@x:crash:3;"
            "io.write.commit:oom:1.0:9")
    for parse in (parse_fault_spec, jfaults.parse_fault_spec):
        armed = parse(spec)
        assert [a.kind for a in armed] == ["fetch", "crash", "oom"]
        assert armed[0].prob == 0.5 and armed[0].remaining is None
        assert armed[1].op == "x" and armed[1].remaining == 3
        assert armed[2].prob == 1.0  # "1.0" is a probability, "1" a count
    with pytest.raises(ColumnarProcessingError, match="unknown fault point"):
        parse_fault_spec("no.such.point:fetch:1")
    with pytest.raises(ColumnarProcessingError, match="unknown fault kind"):
        parse_fault_spec("io.read.file:frobnicate:1")
    with pytest.raises(ColumnarProcessingError, match="bad fault spec"):
        parse_fault_spec("io.read.file")
    with pytest.raises(ColumnarProcessingError, match="outside"):
        parse_fault_spec("io.read.file:oom:1.5")
    with pytest.raises(NotImplementedError, match="Delta"):
        parse_fault_spec("io.write.commit:race:1")


def _schedule(registry, spec, point, n, data=None):
    """Which of ``n`` fires at ``point`` raised (1) or passed (0), or the
    bytes each returned."""
    registry.arm(spec)
    out = []
    for _ in range(n):
        try:
            got = registry.fire(point, data=data)
            out.append(got if data is not None else 0)
        except Exception:
            out.append(1)
    return out


@pytest.mark.parametrize("spec,data", [
    ("io.read.file:fetch:0.3:7", None),
    ("io.read.file:fetch:0.3:8", None),
    ("io.read.file:crash:3", None),
    ("io.read.file:corrupt:2:11", bytes(range(64))),
], ids=["p0.3 seed 7", "p0.3 seed 8", "count 3", "corrupt"])
def test_fault_schedule_matches_the_reference(spec, data):
    got = _schedule(FaultRegistry(), spec, "io.read.file", 50, data)
    want = _schedule(jfaults.FaultRegistry(), spec, "io.read.file", 50, data)
    assert got == want
    assert any(x != (data if data is not None else 0) for x in got)


def test_registry_counters_op_filter_and_suspension():
    reg = FaultRegistry()
    reg.arm("io.write.file@a:crash:5;io.read.file:oom:2")
    reg.fire("io.write.file", op="b")  # filtered out
    with pytest.raises(KernelCrashError):
        reg.fire("io.write.file", op="a")
    with pytest.raises(RetryOOM):
        reg.fire("io.read.file")
    with reg.suspended():
        assert not reg.armed
        reg.fire("io.read.file")
    with pytest.raises(RetryOOM):
        reg.fire("io.read.file")
    reg.fire("io.read.file")  # exhausted
    reg.arm("io.write.file@a:crash:5;io.read.file:oom:2")  # same: no reset
    assert reg.counters() == {"io.write.file@a": 1, "io.read.file": 2}


def test_backoff_retry_counts_and_gives_up():
    from spark_rapids_tpu_torch.runtime.faults import RECOVERY
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ShuffleFetchError("transient")
        return "ok"
    before = RECOVERY.snapshot()["fetch_retries"]
    assert backoff_retry(flaky, max_retries=3, wait_s=0.0,
                         backoff_mult=2.0,
                         retryable=ShuffleFetchError) == "ok"
    assert RECOVERY.snapshot()["fetch_retries"] - before == 2
    with pytest.raises(ShuffleFetchError):
        backoff_retry(lambda: (_ for _ in ()).throw(
            ShuffleFetchError("down")), max_retries=1, wait_s=0.0,
            backoff_mult=1.0, retryable=ShuffleFetchError)
