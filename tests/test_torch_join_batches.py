"""What the joins' batches need, on the CPU against the JAX package's
TpuSession on the same numpy inputs: sub-partitioned builds (a tiny
``spark.rapids.sql.join.subPartition.targetBytes``) for inner, left,
right and full joins, and the cap on their count; a bare LIMIT over a scan, a filter and a join; and
the aggregate and the sort over a multi-batch input (the streaming merge:
COUNT, SUM of f64, int64 and decimal, AVG, MIN/MAX and variance/stddev
through the partials and their merge; the sort through its coalesce).

Both packages coalesce the aggregate's input to the batch-size target
(1 GiB) first, so at that target they aggregate these inputs in one
batch. The merge tests lower the port's target
(``execs/basic.py::BATCH_SIZE_BYTES``) to 1 byte, so every input batch is
a partial, and hold the merge against the reference's one-batch answer.
(The reference's own merge, at a batch size of 1 byte, fails on a
DECIMAL128 SUM: its finalize's If meets a 1-D null literal and a limb
pair.)

Comparators: ``scale_test.tables_differ_unordered`` (a bitwise row
multiset) for join rows; ``scale_test.tables_differ`` (bitwise, in order)
for LIMIT, sorts and exact aggregates; ``scale_test.tables_close`` (rtol
1e-9; every non-float value exact) for aggregates with f64 sums, whose
partials add in another order."""

import numpy as np
import pytest
import torch

from scale_test import tables_close, tables_differ, tables_differ_unordered
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.runtime import speculation as jspec
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.runtime import speculation as tspec
from spark_rapids_tpu_torch.session import TorchSession

SUBPARTITION = {"spark.rapids.sql.join.subPartition.targetBytes": "1024"}


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
    """Speculation blocklists are process-wide in both packages."""
    jspec._BLOCKLIST.clear()
    tspec.clear_blocklist()
    yield
    jspec._BLOCKLIST.clear()
    tspec.clear_blocklist()


def _reference_table(names, type_names, arrays) -> JHostTable:
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(t), d, v)
        for t, (d, v) in zip(type_names, arrays)])


def _as_reference(t) -> JHostTable:
    return _reference_table(*t.to_arrays())


def _both(build, inputs, conf=None):
    """(port result as a reference HostTable, reference result, port
    metrics): ``build(frames, col, F)`` over ``inputs`` [(arrays,
    num_batches)]."""
    ts, js = TorchSession(conf, device="cpu"), TpuSession(conf)
    tdf = build([tfrom(host_table_from_arrays(*a), ts, nb)
                 for a, nb in inputs], tcol, TF)
    jdf = build([jfrom(_reference_table(*a), js, nb) for a, nb in inputs],
                jcol, JF)
    got = _as_reference(tdf.collect_table())
    return got, jdf.collect_table(), ts.last_metrics()


def _sides(seed=31, n_left=400, n_right=300):
    rng = np.random.default_rng(seed)

    def side(n, vname):
        return (["k", vname], ["bigint", "double"], [
            (rng.integers(0, 150, n).astype(np.int64), rng.random(n) > 0.1),
            (rng.standard_normal(n), np.ones(n, bool))])

    return side(n_left, "lv"), side(n_right, "rv")


@pytest.mark.parametrize("how", ["inner", "left", "right", "full"])
def test_subpartitioned_build(how):
    """A build side past 1024 bytes splits by murmur3 key hash; each
    probe batch splits the same way; a full outer join emits each
    partition's unmatched build rows. Same rows as the reference and as
    the port unsplit."""
    left, right = _sides()

    def build(frames, col, F):
        return frames[0].join(frames[1], on="k", how=how)

    got, ref, m = _both(build, [(left, 2), (right, 1)], SUBPARTITION)
    assert m["subPartitions"] > 1
    assert tables_differ_unordered(got, ref) is None
    unsplit, _, m = _both(build, [(left, 2), (right, 1)])
    assert "subPartitions" not in m
    assert tables_differ_unordered(got, unsplit) is None


@pytest.mark.parametrize("how", ["inner", "full"])
def test_subpartition_count_is_capped(how):
    """``spark.rapids.sql.join.maxSubPartitions`` bounds the split: at a
    1024-byte target the build would split into more than two
    partitions, and under a cap of 2 it splits into exactly two. Same
    rows as the reference under the same settings."""
    left, right = _sides()

    def build(frames, col, F):
        return frames[0].join(frames[1], on="k", how=how)

    uncapped = _both(build, [(left, 2), (right, 1)], SUBPARTITION)[2]
    assert uncapped["subPartitions"] > 2
    got, ref, m = _both(build, [(left, 2), (right, 1)], {
        **SUBPARTITION, "spark.rapids.sql.join.maxSubPartitions": "2"})
    assert m["subPartitions"] == 2
    assert tables_differ_unordered(got, ref) is None


def _rows(seed=41, n=300):
    rng = np.random.default_rng(seed)
    return (["id", "g", "x", "q", "d"],
            ["bigint", "int", "double", "bigint", "decimal(12,2)"], [
                (np.arange(n, dtype=np.int64), np.ones(n, bool)),
                (rng.integers(0, 7, n).astype(np.int32), rng.random(n) > 0.05),
                (rng.standard_normal(n) * 100.0, rng.random(n) > 0.1),
                (rng.integers(-10**12, 10**12, n).astype(np.int64),
                 rng.random(n) > 0.1),
                (rng.integers(0, 10**9, n).astype(np.int64),
                 rng.random(n) > 0.1)])


LIMITS = {
    "scan, inside the first batch": (lambda f, col: f, 40),
    "scan, across batches": (lambda f, col: f, 250),
    "scan, past the end": (lambda f, col: f, 1000),
    "scan, zero": (lambda f, col: f, 0),
    "filter": (lambda f, col: f.filter(col("x") > 0.0), 70),
    "join": (lambda f, col: f.join(f.select(col("id"), col("q").alias(
        "q2")), on="id", how="inner"), 120),
}


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_limit(name):
    """The first n rows in batch order (three scan batches)."""
    shape, n = LIMITS[name]
    got, ref, _ = _both(lambda fr, col, F: shape(fr[0], col).limit(n),
                        [(_rows(), 3)])
    assert got.num_rows == min(n, ref.num_rows)
    assert tables_differ(got, ref) is None


def _aggs(F, col):
    return [F.count().alias("n"), F.count(col("x")).alias("nx"),
            F.sum(col("x")).alias("sx"), F.sum(col("q")).alias("sq"),
            F.sum(col("d")).alias("sd"), F.avg(col("x")).alias("ax"),
            F.avg(col("q")).alias("aq"), F.avg(col("d")).alias("ad"),
            F.min(col("x")).alias("mnx"), F.max(col("q")).alias("mxq"),
            F.min(col("id")).alias("mnid"),
            F.variance(col("x")).alias("vx"),
            F.var_pop(col("q")).alias("vq"),
            F.stddev(col("x")).alias("sdx"),
            F.stddev_pop(col("d")).alias("sdd")]


@pytest.fixture
def _one_byte_batches(monkeypatch):
    """The aggregate's input coalesce flushes every batch on its own."""
    from spark_rapids_tpu_torch.execs import basic as xbasic
    monkeypatch.setattr(xbasic, "BATCH_SIZE_BYTES", 1)


@pytest.mark.parametrize("grouped", [True, False],
                         ids=["group_by", "global"])
def test_aggregate_over_many_batches(grouped, _one_byte_batches):
    """Four input batches: four partials, one merge, the finalize."""
    def build(frames, col, F):
        df = frames[0]
        gd = df.group_by("g") if grouped else df
        out = gd.agg(*_aggs(F, col))
        return out.sort("g") if grouped else out

    got, ref, m = _both(build, [(_rows(), 4)])
    assert m["partialAggBatches"] == 4
    assert tables_close(got, ref, rtol=1e-9) is None


@pytest.mark.parametrize("grouped", [True, False],
                         ids=["group_by", "global"])
def test_aggregate_input_coalesces_to_the_batch_target(grouped):
    """At the default 1 GiB target, four input batches concatenate in
    front of the aggregate: one aggregation, no partials, and the
    reference's one-batch answer."""
    def build(frames, col, F):
        df = frames[0]
        gd = df.group_by("g") if grouped else df
        out = gd.agg(*_aggs(F, col))
        return out.sort("g") if grouped else out

    got, ref, m = _both(build, [(_rows(), 4)])
    assert m["concatBatches"] == 4
    assert "partialAggBatches" not in m
    assert tables_close(got, ref, rtol=1e-9) is None


def test_exact_aggregates_over_many_batches_are_bitwise(_one_byte_batches):
    """COUNT, int64 and decimal SUM, MIN/MAX through the merge: bit for
    bit, in order."""
    def build(frames, col, F):
        return frames[0].group_by("g").agg(
            F.count().alias("n"), F.sum(col("q")).alias("sq"),
            F.sum(col("d")).alias("sd"), F.min(col("q")).alias("mn"),
            F.max(col("id")).alias("mx")).sort("g")

    got, ref, m = _both(build, [(_rows(seed=43), 3)])
    assert m["partialAggBatches"] == 3
    assert tables_differ(got, ref) is None


@pytest.mark.parametrize("ascending", [True, False])
def test_sort_over_many_batches(ascending):
    """Three input batches coalesce into one sort (nulls placed as
    Spark's default for the direction)."""
    def build(frames, col, F):
        return frames[0].sort("x", "id", ascending=ascending)

    got, ref, _ = _both(build, [(_rows(seed=47), 3)])
    assert tables_differ(got, ref) is None


def test_aggregate_of_a_full_outer_join_merges_its_tail(_one_byte_batches):
    """A full outer join yields its matched batch and then the unmatched
    build rows: the aggregate above it merges the two partials."""
    left, right = _sides(seed=33)

    def build(frames, col, F):
        j = frames[0].join(frames[1].select(col("k").alias("k2"),
                                            col("rv")), on=col("k") ==
                           col("k2"), how="full")
        return j.agg(F.count().alias("n"), F.count(col("k")).alias("nk"),
                     F.count(col("k2")).alias("nk2"),
                     F.sum(col("rv")).alias("srv"))

    got, ref, m = _both(build, [(left, 1), (right, 1)])
    assert m["partialAggBatches"] >= 2
    assert tables_close(got, ref, rtol=1e-9) is None
