"""The port's offline tools over an event log the port wrote, against the
reference's: ``profile`` and ``compare`` are pure functions over the JSON
records, so both packages must give equal reports and equal rendered
text for the same JSONL (compared with ``==``). ``warmup`` replays the
log's plans: corpus tags and SQL text match, anything else is reported
unmatched; the CLI's subcommands, vacuum's report against the
reference's."""

import json
import os

import pytest

from spark_rapids_tpu.tools import compare as jcompare
from spark_rapids_tpu.tools import report as jreport
from spark_rapids_tpu_torch.models import corpus as tcorpus
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.plan.executable_cache import EXEC_CACHE
from spark_rapids_tpu_torch.session import TorchSession
from spark_rapids_tpu_torch.tools import __main__ as tmain
from spark_rapids_tpu_torch.tools import compare as tcompare
from spark_rapids_tpu_torch.tools import report as treport
from spark_rapids_tpu_torch.tools.warmup import render_warmup, run_warmup

SF, SEED = 0.01, 7
TAGGED = ("q1", "q3", "q6", "q13")


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """Two passes of the same queries, each its own event log: four tagged
    corpus queries (the first twice), one SQL query and one untagged DSL
    query."""
    tables = tcorpus.corpus_tables(SF, SEED)
    dirs = []
    for i in range(2):
        d = str(tmp_path_factory.mktemp(f"log{i}"))
        s = TorchSession({"spark.rapids.sql.eventLog.enabled": "true",
                          "spark.rapids.sql.eventLog.dir": d,
                          "spark.rapids.trace.enabled": "true",
                          "spark.rapids.trace.dir": d + "/trace"},
                         device="cpu")
        q = tcorpus.build_queries(s, tables)
        for name in TAGGED + ("q1",):
            s.next_query_tag = name
            q[name]().collect_table()
        tfrom(tables["orders"], s).create_or_replace_temp_view("orders")
        s.sql("SELECT o_custkey, COUNT(*) AS n FROM orders "
              "GROUP BY o_custkey").collect_table()
        tfrom(tables["orders"], s).select("o_orderkey").limit(3) \
            .collect_table()
        dirs.append(d)
    yield dirs
    EXEC_CACHE.clear()


def test_the_log_holds_one_record_a_query(logs):
    recs = treport.load_events(logs[0])
    assert len(recs) == len(TAGGED) + 3
    assert [r["queryTag"] for r in recs] == list(TAGGED) + ["q1", None, None]
    assert recs[-2]["sqlText"].startswith("SELECT o_custkey")
    assert treport.load_events(logs[0]) == jreport.load_events(logs[0])


@pytest.mark.parametrize("top", [3, 10])
def test_profile_equals_the_reference(logs, top):
    recs = treport.load_events(logs[0])
    got = treport.build_profile(recs, top_n=top)
    want = jreport.build_profile(jreport.load_events(logs[0]), top_n=top)
    assert got == want
    assert treport.render_profile(got) == jreport.render_profile(want)
    assert got["queryCount"] == len(recs) and got["queries"]


@pytest.mark.parametrize("top", [1, 5])
def test_compare_equals_the_reference(logs, top):
    got = tcompare.build_compare(logs[0], logs[1])
    want = jcompare.build_compare(logs[0], logs[1])
    assert got == want
    assert tcompare.render_compare(got, top_n=top) == \
        jcompare.render_compare(want, top_n=top)


def test_cli_profile_and_compare(logs, capsys):
    rc = tmain.main(["profile", logs[0], "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == (2 if out["queriesBelowCoverageFloor"] else 0)
    assert tmain.main(["compare", logs[0], logs[1], "--top", "2"]) == 0
    assert "q13" in capsys.readouterr().out


@pytest.mark.parametrize("cmd", ["loadtest", "vacuum", "top", "incident"])
def test_unported_subcommands_raise_naming_item_12(cmd, tmp_path, capsys):
    """Item 12's subcommands all run in the port (vacuum since [12b]
    Delta): vacuum's dry-run report over a write directory with a dead
    job's staging equals the reference's."""
    if cmd == "vacuum":
        from spark_rapids_tpu.tools.vacuum import run_vacuum as jrun
        stage = tmp_path / "_temporary" / "job" / "0"
        stage.mkdir(parents=True)
        (stage / "part-0.parquet").write_bytes(b"x")
        assert tmain.main([cmd, str(tmp_path), "--json"]) == 0
        got = json.loads(capsys.readouterr().out)
        assert got == jrun(str(tmp_path))
        assert got["mode"] == "staging-only" and got["orphans"] == [
            os.path.join("_temporary", "job", "0", "part-0.parquet")]
    elif cmd == "top":
        # no endpoint named: the usage error, not a raise
        assert tmain.main([cmd]) == 2
        assert "--url or --port" in capsys.readouterr().err
    elif cmd == "incident":
        assert tmain.main([cmd, str(tmp_path)]) == 1
        assert "no incident bundles" in capsys.readouterr().err
    else:
        assert tmain.main([cmd, "--device", "cpu", "--sf", "0.01",
                           "--queries", "q6", "--tenants", "1",
                           "--concurrency", "1"]) == 0
        assert "all held        True" in capsys.readouterr().out


def test_warmup_replays_the_log_and_reports_unmatched(logs):
    rep = run_warmup(logs[0], sf=SF, seed=SEED, device="cpu")
    assert rep["ok"] and rep["failures"] == 0
    assert rep["eventRecords"] == len(TAGGED) + 3
    # the four corpus queries (q1 once) and the SQL text
    assert rep["distinctUnits"] == len(TAGGED) + 1
    assert rep["unmatchedRecords"] == ["query_6"]
    statuses = {q["query"]: q["status"] for q in rep["queries"]}
    assert set(statuses) == set(TAGGED) | {"query_5"}
    # no nvcc here: nothing is built, every query replays warm
    assert set(statuses.values()) == {"warm"} and rep["newTraces"] == 0
    text = render_warmup(rep)
    assert "unmatched records: query_6" in text


def test_warmup_fills_the_cache_for_the_callers_tables(logs):
    tables = tcorpus.corpus_tables(SF, SEED)
    s = TorchSession(device="cpu")
    EXEC_CACHE.clear()
    run_warmup(logs[0], tables=tables, session=s)
    tcorpus.build_queries(s, tables)["q3"]().collect_table()
    assert s.last_executable_cache_hit


def test_cli_warmup(logs, tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = tmain.main(["warmup", "--eventlog-dir", logs[1], "--sf", str(SF),
                     "--seed", str(SEED), "--device", "cpu", "--json",
                     "--out", str(out)])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep == json.load(open(out))
    assert rep["programsSkipped"] == len(TAGGED) + 1
    with pytest.raises(SystemExit):
        tmain.main(["warmup", "--eventlog-dir", logs[1], "--require-cuda"])
    assert os.path.isdir(logs[1] + "/trace")
