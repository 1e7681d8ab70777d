"""The port's host shuffle end to end (execs/exchange.py's route choice,
shuffle/partitioning.py ``split_by_partition``, shuffle/manager.py and
shuffle/p2p.py) against the JAX package's on the same tables: hash, range
and round-robin repartitions into 200 partitions under MULTITHREADED
(every codec) and P2P (in-process, TCP, and 3 executors over TCP).

Comparators:
- the repartitioned rows: ``scale_test.tables_differ`` (bitwise, in
  order: partition by partition, each in its input order);
- the downstream aggregate: ``scale_test.tables_differ_unordered`` (a
  bitwise row multiset; COUNT and int64 SUM only, exact in both);
- metrics: equal counts (map outputs, recomputed maps, coalesced
  partitions)."""

import numpy as np
import pytest
import torch

from scale_test import tables_differ, tables_differ_unordered
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.runtime import faults as jfaults
from spark_rapids_tpu.runtime import speculation as jspec
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.shuffle.hashing import murmur3_hash_host as jhash
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.runtime import faults as tfaults
from spark_rapids_tpu_torch.runtime import speculation as tspec
from spark_rapids_tpu_torch.session import TorchSession

NPARTS = 200


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clean_state():
    for f in (jfaults.FAULTS.disarm, tfaults.FAULTS.disarm,
              jspec._BLOCKLIST.clear, tspec.clear_blocklist):
        f()
    yield
    for f in (jfaults.FAULTS.disarm, tfaults.FAULTS.disarm,
              jspec._BLOCKLIST.clear, tspec.clear_blocklist):
        f()


def _arrays(n=4000, seed=17):
    rng = np.random.default_rng(seed)
    flags = np.array(["A", "N", "R", "Ré", "long flag value"],
                     dtype=object)[rng.integers(0, 5, n)]
    return (["k", "flag", "qty", "price", "d"],
            ["bigint", "string", "bigint", "double", "decimal(30,2)"],
            [(rng.integers(0, 5000, n).astype(np.int64), rng.random(n) > 0.05),
             (flags, rng.random(n) > 0.1),
             (rng.integers(1, 51, n).astype(np.int64), np.ones(n, bool)),
             (rng.standard_normal(n), rng.random(n) > 0.1),
             (np.array([int(x) * 10 ** 20 + 7 for x in
                        rng.integers(-1000, 1000, n)], dtype=object),
              rng.random(n) > 0.1)])


_ARR = _arrays()
_PORT_TABLE = host_table_from_arrays(*_ARR)


def _as_reference(t) -> JHostTable:
    names, types, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, v)
        for ty, (d, v) in zip(types, arrays)])


_REF_TABLE = _as_reference(_PORT_TABLE)


def _repartition(df, how):
    if how == "hash":
        return df.repartition(NPARTS, "k", "flag")
    if how == "range":
        if type(df).__module__.startswith("spark_rapids_tpu_torch."):
            from spark_rapids_tpu_torch.ops.expr import col
            from spark_rapids_tpu_torch.plan import nodes as P
        else:
            from spark_rapids_tpu.ops.expr import col
            from spark_rapids_tpu.plan import nodes as P
        return df._wrap(P.Exchange(df.plan, "range", NPARTS, [col("k")]))
    return df.repartition(NPARTS)


def _port(conf, how, batches=3):
    s = TorchSession(dict(conf), device="cpu")
    df = _repartition(tfrom(_PORT_TABLE, s, num_batches=batches), how)
    rows = df.collect_table()
    metrics = s.last_metrics()
    agg = df.group_by("flag").agg(TF.count("qty"), TF.sum("qty"))
    return rows, agg.collect_table(), metrics


def _reference(conf, how, batches=3):
    s = TpuSession(dict(conf))
    df = _repartition(jfrom(_REF_TABLE, s, batches), how)
    rows = df.collect_table()
    agg = df.group_by("flag").agg(JF.count("qty"), JF.sum("qty"))
    return rows, agg.collect_table()


_REF = {}


def _ref(how, mode="MULTITHREADED"):
    key = (how, mode)
    if key not in _REF:
        _REF[key] = _reference({"spark.rapids.shuffle.mode": mode}, how)
    return _REF[key]


def _hash_pids(t):
    """The reference's host murmur3 partition id of every row of ``t``
    (pmod(hash(k, flag), 200))."""
    k, f = t.columns[0], t.columns[1]
    return [jhash([(kv, kok, JT.LongType()), (fv, fok, JT.StringType())])
            % NPARTS for kv, kok, fv, fok in zip(
                k.data, k.validity, f.data, f.validity)]


@pytest.mark.parametrize("how", ["hash", "range", "roundrobin"])
@pytest.mark.parametrize("codec", ["none", "zlib", "lz4", "zstd"])
def test_multithreaded_repartition_into_200_matches_reference(how, codec):
    rows, agg, m = _port({"spark.rapids.shuffle.compression.codec": codec},
                         how)
    jrows, jagg = _ref(how)
    assert tables_differ(_as_reference(rows), jrows) is None
    assert tables_differ_unordered(_as_reference(agg), jagg) is None
    # three map outputs (one a batch; a range exchange samples its bounds
    # over the whole input, one map), one download each
    maps = 1 if how == "range" else 3
    assert m["shuffleMapOutputs"] == maps
    assert m["shuffleMapDownloads"] == maps
    assert "localSplitParts" not in m
    if how == "hash" and codec == "lz4":
        pids = _hash_pids(jrows)
        assert pids == sorted(pids)  # partition by partition


@pytest.mark.parametrize("how", ["hash", "roundrobin"])
@pytest.mark.parametrize("transport", ["inprocess", "tcp"])
def test_p2p_repartition_into_200_matches_reference(how, transport):
    conf = {"spark.rapids.shuffle.mode": "P2P",
            "spark.rapids.shuffle.p2p.transport": transport,
            "spark.rapids.shuffle.compression.codec": "lz4"}
    rows, agg, m = _port(conf, how)
    jrows, jagg = _ref(how, "P2P")
    assert tables_differ(_as_reference(rows), jrows) is None
    assert tables_differ_unordered(_as_reference(agg), jagg) is None
    assert m["shuffleBytesRead"] == m["shuffleBytesWritten"] > 0


def test_three_executors_over_tcp_serve_one_reduce_side():
    """Three P2P executors over TCP behind one heartbeat driver, each
    holding a third of the map outputs: executor 0 reads every reduce
    partition from all three, and the partitions, in order, are the
    reference's repartitioned rows."""
    from spark_rapids_tpu_torch.columnar.table import (
        concat_host,
        upload_host_table,
    )
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.ops.expr import col as tcol
    from spark_rapids_tpu_torch.shuffle.heartbeat import (
        ShuffleHeartbeatManager,
    )
    from spark_rapids_tpu_torch.shuffle.p2p import P2PShuffleEnv
    from spark_rapids_tpu_torch.shuffle.partitioning import (
        HashPartitioner,
        split_by_partition,
    )
    conf = RapidsConf({"spark.rapids.shuffle.p2p.transport": "tcp",
                       "spark.rapids.shuffle.p2p.bounceBufferSize": "4096",
                       "spark.rapids.shuffle.compression.codec": "zstd"})
    driver = ShuffleHeartbeatManager()
    envs = [P2PShuffleEnv(conf, f"exec-{i}", driver) for i in range(3)]
    try:
        for e in envs:
            e.heartbeat.beat_once()
        schema = _PORT_TABLE.schema()
        parter = HashPartitioner([tcol("k").bind(schema),
                                  tcol("flag").bind(schema)], NPARTS)
        handles = [e.new_shuffle(NPARTS) for e in envs]
        per = -(-_PORT_TABLE.num_rows // 3)
        for i, (e, h) in enumerate(zip(envs, handles)):
            part = _PORT_TABLE.slice(i * per, min(per, _PORT_TABLE.num_rows
                                                  - i * per))
            h.write_partitions(split_by_partition(
                upload_host_table(part, torch.device("cpu")), parter))
        reader = envs[0].reader(handles[0])
        got = []
        for p in range(NPARTS):
            got.extend(reader.read_partition(p))
        rows = concat_host(got)
        jrows, _ = _ref("hash")
        assert tables_differ(_as_reference(rows), jrows) is None
        assert reader.bytes_read == sum(h.bytes_written for h in handles)
        assert all(e.server.requests_served >= NPARTS for e in envs)
    finally:
        for e in envs:
            e.close()


def test_aqe_coalescing_and_its_kill_switch():
    """200 small partitions coalesce into one output batch (adjacent
    undersized partitions share it, aqeCoalescedPartitions); with
    coalescing off every non-empty partition is a batch of its own. The
    rows are the same either way, in the same order."""
    on_rows, _, on = _port({}, "hash")
    s = TorchSession({"spark.rapids.sql.adaptive.coalescePartitions."
                      "enabled": "false"}, device="cpu")
    df = _repartition(tfrom(_PORT_TABLE, s, num_batches=3), "hash")
    off_rows = df.collect_table()
    off = s.last_metrics()
    jrows, _ = _ref("hash")
    nonempty = len(set(_hash_pids(jrows)))
    assert on["aqeCoalescedPartitions"] == nonempty - 1
    assert "aqeCoalescedPartitions" not in off
    assert tables_differ(_as_reference(on_rows),
                         _as_reference(off_rows)) is None
    assert on["mapOutputBytesMax"] >= on["mapOutputBytesMedian"] > 0


def test_a_lost_map_output_is_recomputed():
    """Every retry of one map's read fails (an injected fetch fault past
    spark.rapids.shuffle.fetch.maxRetries): the map output is declared
    lost, the exchange re-runs its child and rewrites it, and the result
    is unchanged."""
    conf = {"spark.rapids.shuffle.fetch.retryWaitMs": "1",
            "spark.rapids.shuffle.fetch.maxRetries": "2",
            "spark.rapids.test.faults": "shuffle.read.partition:fetch:3"}
    rows, agg, m = _port(conf, "hash", batches=1)
    jrows, jagg = _ref("hash")
    assert tables_differ(_as_reference(rows), jrows) is None
    assert m["recomputedMapOutputs"] == 1
    assert m["fetch_retries"] >= 3


@pytest.mark.parametrize("switch", [
    "spark.rapids.shuffle.localDeviceSplit.enabled",
    "spark.rapids.tpu.maskedBatches.enabled"])
def test_the_kill_switches_take_the_host_shuffle(switch):
    """A repartition into 8 splits on the device by default; either kill
    switch sends it through the host shuffle, as the reference's, with
    the same rows."""
    def run(conf):
        s = TorchSession(conf, device="cpu")
        df = tfrom(_PORT_TABLE, s, num_batches=2).repartition(8, "k")
        return df.collect_table(), s.last_metrics()
    split_rows, split = run({})
    host_rows, host = run({switch: "false"})
    assert split["localSplitParts"] == 8 and "shuffleMapOutputs" not in split
    assert host["shuffleMapOutputs"] == 2 and "localSplitParts" not in host
    js = TpuSession({switch: "false"})
    want = jfrom(_REF_TABLE, js, 2).repartition(8, "k").collect_table()
    assert tables_differ(_as_reference(host_rows), want) is None
    assert tables_differ_unordered(_as_reference(split_rows), want) is None
