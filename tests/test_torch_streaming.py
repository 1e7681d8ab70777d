"""The port's streaming and materialized views (spark_rapids_tpu_torch/
streaming, the query service's stream registry) against the reference's,
the cases of tests/test_streaming_pipeline.py: each scenario runs on both
packages over the same seeded sources through a ``QueryService`` (the
port's on the CPU), and the tests hold what they return equal: sink and
view tables as row multisets (``scale_test.tables_differ_unordered``),
counters, strategies, ``explain()`` texts and event-record fields with
``==``.

Covered: the offset log's protocol; exactly-once across a killed
micro-batch and across a sink commit whose marker was lost (the txn
watermark); the rate, file-watch and Delta CDF sources; the append and
reaggregate views bit for bit against ``recompute_at_epoch()`` at every
epoch, the full-recompute fallback and its reason; table-scoped epochs in
the service's result cache; the event record's streaming fields and
``mvEpoch`` for the same stream; ``/streams``, ``/top`` and ``tools
top``."""

import json
import os

import numpy as np
import pytest

from scale_test import tables_differ_unordered
from tests.torch_lake import ref_form, spec


class Svc:
    """One package's service, session and streaming surface."""

    def __init__(self, port: bool, tmp, conf=None):
        self.port = port
        self.tmp = str(tmp / ("port" if port else "ref"))
        os.makedirs(self.tmp, exist_ok=True)
        base = {"spark.rapids.service.maxConcurrentQueries": "2"}
        base.update(conf or {})
        if port:
            from spark_rapids_tpu_torch import functions as F
            from spark_rapids_tpu_torch import streaming as S
            from spark_rapids_tpu_torch.delta.commands import DeltaTable
            from spark_rapids_tpu_torch.delta.log import DeltaLog
            from spark_rapids_tpu_torch.ops.expr import col, lit
            from spark_rapids_tpu_torch.runtime.faults import FAULTS
            from spark_rapids_tpu_torch.service.scheduler import QueryService
            self.svc = QueryService(base, device="cpu")
        else:
            from spark_rapids_tpu import functions as F
            from spark_rapids_tpu import streaming as S
            from spark_rapids_tpu.delta.commands import DeltaTable
            from spark_rapids_tpu.delta.log import DeltaLog
            from spark_rapids_tpu.ops.expr import col, lit
            from spark_rapids_tpu.runtime.faults import FAULTS
            from spark_rapids_tpu.service.scheduler import QueryService
            self.svc = QueryService(base)
        self.F, self.S, self.col, self.lit = F, S, col, lit
        self.DeltaTable, self.DeltaLog, self.FAULTS = DeltaTable, DeltaLog, \
            FAULTS
        self.s = self.svc.session

    def path(self, name):
        return os.path.join(self.tmp, name)

    def host(self, data):
        if self.port:
            from spark_rapids_tpu_torch.interop import host_table_from_arrays
            return host_table_from_arrays(*spec(data))
        from tests.torch_service_util import reference_table
        return reference_table(spec(data))

    def df(self, data):
        if self.port:
            from spark_rapids_tpu_torch.plan import from_host_table
        else:
            from spark_rapids_tpu.plan.dataframe import from_host_table
        return from_host_table(self.host(data), self.s)

    def make_delta(self, path, data, cdf=True):
        self.df(data).write_delta(path)
        dt = self.DeltaTable(self.s, path)
        if cdf:
            dt.set_properties({"delta.enableChangeDataFeed": "true"})
        return dt

    def append(self, path, data):
        self.df(data).write_delta(path, mode="append")

    def table(self, path):
        return self.s.execute(self.DeltaTable(self.s, path).to_df().plan)

    def close(self):
        self.FAULTS.disarm()
        self.svc.shutdown()


def _on_both(tmp_path, scenario, conf=None):
    out = []
    for port in (False, True):
        a = Svc(port, tmp_path, conf)
        try:
            out.append(scenario(a))
        finally:
            a.close()
    return out


def _same(jt, tt):
    got = tables_differ_unordered(ref_form(jt), ref_form(tt))
    assert got is None, got


def _ints(data):
    return {k: np.asarray(v, dtype=np.int64) for k, v in data.items()}


# -- the offset log ----------------------------------------------------------------

def test_offset_log_pending_protocol(tmp_path):
    from spark_rapids_tpu.streaming import OffsetLog as JLog
    from spark_rapids_tpu_torch.errors import ColumnarProcessingError
    from spark_rapids_tpu_torch.streaming import OffsetLog
    seen = []
    for cls in (JLog, OffsetLog):
        log = cls(str(tmp_path / cls.__module__))
        got = [log.latest_batch_id(), log.pending_batch()]
        log.write_offsets(0, {"start": 0, "end": 10})
        got.append(log.pending_batch())
        log.write_commit(0, {"outcome": "committed"})
        got += [log.pending_batch(), log.last_end_offset()]
        seen.append(got)
    assert seen[0] == seen[1] == [-1, None, (0, {"start": 0, "end": 10}),
                                  None, 10]
    with pytest.raises(ColumnarProcessingError, match="offset log gap"):
        log.write_offsets(5, {"start": 10, "end": 20})


# -- exactly-once --------------------------------------------------------------------

def test_stream_exactly_once_after_kill(tmp_path):
    """A micro-batch dies after its offsets are logged (``stream.batch``);
    a fresh stream over the checkpoint re-runs it; then a lost commit
    marker replays as a no-op through the txn watermark. The sink equals
    a fault-free run's and the reference's."""
    def scn(a):
        S = a.S
        src = lambda: S.RateSource(rows_per_batch=20, seed=7,  # noqa: E731
                                   total_rows=60)
        q0 = S.StreamingQuery(a.svc, src(), S.DeltaStreamSink(
            a.path("base"), "base"), a.path("ck0"), name="base")
        assert q0.process_available() == 3
        expected = a.table(a.path("base"))

        def fresh():
            return S.StreamingQuery(a.svc, src(), S.DeltaStreamSink(
                a.path("sink"), "s1"), a.path("ck"), name="s1")

        assert fresh().run_one_batch()
        a.FAULTS.arm("stream.batch:crash:1")
        with pytest.raises(Exception, match="stream.batch"):
            fresh().run_one_batch()
        a.FAULTS.disarm()
        olog = S.OffsetLog(a.path("ck"))
        pending = olog.pending_batch()
        resumed = fresh().process_available()
        first = a.table(a.path("sink"))
        last = olog.latest_committed_id()
        os.remove(os.path.join(olog.commits_dir, f"{last}.json"))
        replayed = fresh().process_available()
        return {"expected": expected, "first": first,
                "again": a.table(a.path("sink")), "pending": pending,
                "resumed": resumed, "replayed": replayed,
                "txn": a.DeltaLog(a.path("sink")).last_txn_version("s1")}
    jo, to = _on_both(tmp_path, scn)
    for k in ("expected", "first", "again"):
        _same(jo[k], to[k])
    _same(to["expected"], to["again"])
    for k in ("pending", "resumed", "replayed", "txn"):
        assert jo[k] == to[k]
    assert (to["resumed"], to["replayed"], to["txn"]) == (2, 1, 2)


def test_file_watch_and_cdf_sources_into_a_sink(tmp_path):
    """Parquet files appear in a directory (the port's writer for both
    packages' runs); a FileWatchSource takes 2 a trigger into a Delta
    sink through a transform; a DeltaCDFSource tails the sink's feed."""
    from spark_rapids_tpu_torch.interop import host_table_from_arrays
    from spark_rapids_tpu_torch.io import parquet_format as PF
    src_dir = tmp_path / "in"
    src_dir.mkdir()
    rng = np.random.default_rng(4)
    for i in range(5):
        n = 40 + i
        PF.write_table(host_table_from_arrays(*spec({
            "id": np.arange(i * 100, i * 100 + n, dtype=np.int64),
            "k": rng.integers(0, 4, n).astype(np.int64),
            "x": rng.standard_normal(n)})), str(src_dir / f"f{i}.parquet"))

    def scn(a):
        S = a.S
        src = S.FileWatchSource(str(src_dir), a.s.conf,
                                max_files_per_trigger=2)
        sink = a.path("sink")
        a.make_delta(sink, {"id": np.array([-1], dtype=np.int64),
                            "k": np.array([0], dtype=np.int64),
                            "x": np.array([0.0])})
        # the feed from the version that enabled CDF on
        cdf = S.StreamingQuery(a.svc, S.DeltaCDFSource(sink,
                                                       starting_version=1),
                               S.DeltaStreamSink(a.path("cdf"), "c"),
                               a.path("ck2"), name="cdf")
        q = S.StreamingQuery(
            a.svc, src, S.DeltaStreamSink(sink, "fw"), a.path("ck"),
            name="fw",
            transform=lambda df: df.filter(a.col("x") > a.lit(0.0)))
        batches = q.process_available()
        n_cdf = cdf.process_available()
        return {"batches": batches, "cdf_batches": n_cdf,
                "sink": a.table(sink), "feed": a.table(a.path("cdf")),
                "desc": {k: v for k, v in q.describe().items()
                         if k not in ("source", "sink")}}
    jo, to = _on_both(tmp_path, scn)
    _same(jo["sink"], to["sink"])
    _same(jo["feed"], to["feed"])
    assert jo["desc"] == to["desc"] and to["batches"] == 3
    assert (jo["cdf_batches"], to["cdf_batches"]) == (1, 1)


# -- materialized views ---------------------------------------------------------------

def test_mv_incremental_bit_identity_every_epoch(tmp_path):
    commits = [{"k": [2, 4], "v": [5, 100]}, {"k": [4, 1], "v": [7, 3]},
               {"k": [3], "v": [1000]}]

    def scn(a):
        F, col, lit = a.F, a.col, a.lit
        base = a.path("base")
        dt = a.make_delta(base, _ints({"k": [1, 2, 3, 1],
                                       "v": [10, 20, 30, 40]}))
        reg = a.svc.mv_registry()
        df = dt.to_df()
        agg = reg.register("agg", df.group_by(col("k")).agg(
            F.sum(col("v")).alias("sv"), F.count(col("v")).alias("c"),
            F.max(col("v")).alias("mx")))
        proj = reg.register("proj", df.filter(col("v") > lit(12))
                            .select(col("k"), col("v")))
        served = []
        for data in commits:
            a.append(base, _ints(data))
            assert agg.stale and proj.stale
            for mv in (agg, proj):
                got = mv.read()
                _same(got, mv.recompute_at_epoch())
                served.append(got)
        return {"served": served,
                "modes": [(m.strategy, m.last_refresh_mode,
                           m.incremental_refreshes, m.explain())
                          for m in (agg, proj)]}
    jo, to = _on_both(tmp_path, scn)
    for jt, tt in zip(jo["served"], to["served"]):
        _same(jt, tt)
    assert jo["modes"] == to["modes"]
    assert to["modes"][0][:2] == ("reaggregate", "incremental-reaggregate")
    assert to["modes"][1][:2] == ("append", "incremental-append")


def test_mv_full_recompute_fallback_surfaced(tmp_path):
    def scn(a):
        col, lit = a.col, a.lit
        pa_, pb = a.path("a"), a.path("b")
        a.make_delta(pa_, _ints({"k": [1, 2], "x": [10, 20]}))
        a.make_delta(pb, _ints({"k": [1, 2], "y": [7, 8]}), cdf=False)
        reg = a.svc.mv_registry()
        joined = a.DeltaTable(a.s, pa_).to_df().join(
            a.DeltaTable(a.s, pb).to_df(), on=["k"])
        mv_join = reg.register("j", joined)
        a.append(pa_, _ints({"k": [2], "x": [100]}))
        served = mv_join.read()
        _same(served, mv_join.recompute_at_epoch())
        mv_p = reg.register("p", a.DeltaTable(a.s, pa_).to_df()
                            .select(col("k"), col("x")))
        a.DeltaTable(a.s, pa_).update(col("k") == lit(1), {"x": lit(0)})
        p = mv_p.read()
        return {"join": served, "p": p,
                "explain": [mv_join.explain(), mv_p.explain()],
                "modes": [mv_join.last_refresh_mode, mv_p.last_refresh_mode]}
    jo, to = _on_both(tmp_path, scn)
    _same(jo["join"], to["join"])
    _same(jo["p"], to["p"])
    assert jo["explain"] == to["explain"]
    assert "strategy=full" in to["explain"][0] and "non-insert" in \
        to["explain"][1]
    assert to["modes"] == ["full-recompute", "full-recompute"]


def test_per_table_epoch_scoping(tmp_path):
    """A commit to table B leaves a cached result over table A in the
    service's result cache; a commit to A and a global bump evict it."""
    def scn(a):
        if a.port:
            from spark_rapids_tpu_torch.plan.fingerprint import (
                bump_invalidation_epoch,
            )
        else:
            from spark_rapids_tpu.plan.fingerprint import (
                bump_invalidation_epoch,
            )
        pa_, pb = a.path("a"), a.path("b")
        a.make_delta(pa_, _ints({"x": [1, 2, 3]}), cdf=False)
        a.make_delta(pb, _ints({"y": [4, 5]}), cdf=False)
        hits = []

        def run_over_a():
            a.svc.submit(a.DeltaTable(a.s, pa_).to_df().select(
                a.col("x"))).result(timeout=60)
            hits.append(a.svc.result_cache.stats()["hits"])

        run_over_a()
        run_over_a()
        a.append(pb, _ints({"y": [6]}))
        run_over_a()
        a.append(pa_, _ints({"x": [9]}))
        run_over_a()
        run_over_a()
        bump_invalidation_epoch("catalog-wide test bump")
        run_over_a()
        return hits
    jo, to = _on_both(tmp_path, scn)
    assert jo == to == [0, 1, 2, 2, 3, 3]


# -- the event record and the introspection surfaces -------------------------------------

STREAM_FIELDS = ("microBatches", "mvRefreshes", "mvIncrementalRefreshes",
                 "mvFullRecomputes", "sinkCommits", "sinkReplays",
                 "mvEpoch", "commitRetries")


def test_schema_v11_streaming_fields(tmp_path):
    """The same MV serve and stream through both packages: every record's
    streaming fields, ``mvEpoch`` and tag equal the reference's, record
    for record; /streams, /top and ``tools top`` list the stream."""
    def scn(a):
        F, col = a.F, a.col
        if a.port:
            from spark_rapids_tpu_torch.service.introspect import _routes
            from spark_rapids_tpu_torch.tools.top import render_top
        else:
            from spark_rapids_tpu.service.introspect import _routes
            from spark_rapids_tpu.tools.top import render_top
        base = a.path("base")
        dt = a.make_delta(base, _ints({"k": [1, 2, 1], "v": [10, 20, 30]}))
        mv = a.svc.mv_registry().register("agg", dt.to_df().group_by(
            col("k")).agg(F.sum(col("v")).alias("sv")))
        a.append(base, _ints({"k": [2], "v": [5]}))
        mv.read()
        first = {f: a.s.last_event_record[f] for f in STREAM_FIELDS}
        first["tag"] = a.s.last_event_record["queryTag"]
        S = a.S
        q = S.StreamingQuery(
            a.svc, S.RateSource(rows_per_batch=25, seed=3, total_rows=50),
            S.DeltaStreamSink(a.path("sink"), "s1"), a.path("ck"), name="s1")
        a.svc.register_stream(q)
        assert q.process_available() == 2
        a.svc.submit(dt.to_df().select(col("k"))).result(timeout=60)
        records = [json.loads(line) for line in open(a.s.last_event_path)
                   if line.strip()]
        doc = _routes(a.svc, "/top", {})
        streams = _routes(a.svc, "/streams", {})["streams"]
        return {"first": first, "sink": a.table(a.path("sink")),
                "fields": [(r["queryTag"],) + tuple(r[f] for f in
                                                    STREAM_FIELDS)
                           for r in records],
                "streams": [(st["name"], st["batchesRun"], st["rowsSunk"])
                            for st in streams],
                "top": "Streams: 1 recurring" in render_top(doc)}
    jo, to = _on_both(tmp_path, scn, {
        "spark.rapids.sql.eventLog.enabled": "true",
        "spark.rapids.sql.eventLog.dir": str(tmp_path / "ev")})
    assert jo["first"] == to["first"]
    assert to["first"]["mvEpoch"] == 2 and to["first"]["tag"] == "mv:agg@v2"
    _same(jo["sink"], to["sink"])
    assert jo["fields"] == to["fields"]
    assert sum(f[1] for f in to["fields"]) == 2      # microBatches
    assert sum(f[5] for f in to["fields"]) == 2      # sinkCommits
    assert jo["streams"] == to["streams"] == [("s1", 2, 50)]
    assert to["top"] and jo["top"]
