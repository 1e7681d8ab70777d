"""The port's mesh (parallel/mesh.py, parallel/exchange.py, execs/mesh.py):
8 logical devices on the CPU (``declare_logical_devices(8, ["cpu"])``, the
counterpart of the reference's 8 forced XLA host devices) against the JAX
package's 8-device mesh and its single-device results.

Comparators, named per query:
- the exchange's partitions: ``scale_test.tables_differ`` (bitwise, in
  order: partition by partition, each in its rows' input order), string
  and DECIMAL128 columns included;
- q1-q22 at sf 0.02 mesh-native against the reference's single-device
  ``TpuSession`` (its mesh matches it bit for bit by contract): the
  corpus runner's comparators (tests/test_torch_corpus_wide.py),
  ``tables_differ`` for the exact queries and ``tables_close`` (rtol
  1e-9, f64 sums only) for the others; q1, q3, q7 and q8 also against
  the reference's own 8-device mesh, and bit for bit against the port's
  own single-device run;
- the demotion reasons: string equality with the reference's."""

import numpy as np
import pytest
import torch

from scale_test import build_queries as jbuild_queries
from scale_test import tables_close, tables_differ
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.runtime import speculation as jspec
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.models import corpus as tcorpus
from spark_rapids_tpu_torch.parallel import mesh as tmesh
from spark_rapids_tpu_torch.plan.executable_cache import EXEC_CACHE
from spark_rapids_tpu_torch.runtime import speculation as tspec
from spark_rapids_tpu_torch.session import TorchSession

pytestmark = pytest.mark.multichip

SF = 0.02
SEED = 3
MESH = {"spark.rapids.mesh.enabled": "true"}
EXACT = ("q5", "q6", "q7", "q8", "q11", "q13", "q16", "q18", "q20", "q21",
         "q22")
F64_SUMS = ("q1", "q2", "q3", "q4", "q9", "q10", "q12", "q14", "q15",
            "q17", "q19")
QUERIES = sorted(EXACT + F64_SUMS, key=lambda q: int(q[1:]))
REFERENCE_MESH = ("q1", "q3", "q7", "q8")


@pytest.fixture(scope="module", autouse=True)
def _eight_logical_devices():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    tmesh.declare_logical_devices(8, ["cpu"])
    yield
    tmesh.reset_logical_devices()
    tmesh.MESH.restore()
    TorchSession(device="cpu").placement.prepare()  # the mesh off again
    TpuSession().placement.prepare()
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


_TABLES = {}


def _tables():
    if not _TABLES:
        tabs = tcorpus.corpus_tables(SF, SEED)
        _TABLES["port"] = tabs
        _TABLES["ref"] = {n: _as_reference(t) for n, t in tabs.items()}
    return _TABLES["port"], _TABLES["ref"]


_REFERENCE = {}


def _reference(name, conf=None):
    key = (name, tuple(sorted((conf or {}).items())))
    if key not in _REFERENCE:
        _, jtabs = _tables()
        jspec._BLOCKLIST.clear()
        _REFERENCE[key] = jbuild_queries(TpuSession(dict(conf or {})),
                                         jtabs)[name]().collect_table()
    return _REFERENCE[key]


def _exchange_arrays(n=3000, seed=9):
    rng = np.random.default_rng(seed)
    words = np.array(["AIR", "MAIL", "RAIL", "SHIP", "TRUCK", "Ré", ""],
                     dtype=object)
    return (["k", "s", "d128", "v", "d64"],
            ["bigint", "string", "decimal(38,3)", "double", "decimal(9,2)"],
            [(rng.integers(0, 300, n).astype(np.int64), rng.random(n) > 0.1),
             (words[rng.integers(0, len(words), n)], rng.random(n) > 0.1),
             (np.array([int(a) * 10 ** 25 + int(b) for a, b in zip(
                 rng.integers(-10 ** 6, 10 ** 6, n),
                 rng.integers(0, 10 ** 6, n))], dtype=object),
              rng.random(n) > 0.1),
             (rng.standard_normal(n), rng.random(n) > 0.1),
             (rng.integers(-10 ** 8, 10 ** 8, n).astype(np.int64),
              rng.random(n) > 0.1)])


@pytest.mark.parametrize("keys", [("k",), ("s",), ("d128",), ("s", "k")])
@pytest.mark.parametrize("nparts", [8, 5])
def test_exchange_partitions_match_the_reference_mesh(keys, nparts):
    """A filtered scan (sharded over the 8 logical devices) hash
    repartitioned by the all-to-all: the rows, partition by partition in
    order, equal the reference's 8-device mesh exchange bit for bit."""
    from spark_rapids_tpu.ops.expr import col as jcol
    from spark_rapids_tpu.ops.expr import lit as jlit
    from spark_rapids_tpu.plan import from_host_table as jfrom
    from spark_rapids_tpu_torch.ops.expr import col, lit
    from spark_rapids_tpu_torch.plan import from_host_table
    arrays = _exchange_arrays()
    t = host_table_from_arrays(*arrays)
    s = TorchSession(dict(MESH), device="cpu")
    got = from_host_table(t, s).filter(col("k") > lit(10)).repartition(
        nparts, *keys).collect_table()
    m = s.last_metrics()
    assert m["iciExchanges"] == 1 and m["iciPartitions"] == nparts
    assert m["shardsDispatched"] == 8
    js = TpuSession(dict(MESH))
    want = jfrom(_as_reference(t), js).filter(jcol("k") > jlit(10)) \
        .repartition(nparts, *keys).collect_table()
    assert tables_differ(_as_reference(got), want) is None


def test_warm_mesh_query_uploads_nothing_and_counts_its_scope():
    """q7 (a repartition into 8 over a string key, then a group-by) runs
    the all-to-all; its warm run makes no host upload in the mesh's
    dispatch (meshHostUploads 0: the shards stay cached on their devices,
    the dictionary's bytes interned)."""
    tabs, _ = _tables()
    EXEC_CACHE.clear()
    s = TorchSession(dict(MESH), device="cpu")
    q = tcorpus.build_queries(s, tabs)["q7"]
    cold = q().collect_table()
    mc = s.last_metrics()
    warm = q().collect_table()
    mw = s.last_metrics()
    assert mc["meshHostUploads"] == 2 and mc["meshDictInterns"] == 1
    assert "meshHostUploads" not in mw
    assert mw["iciExchanges"] == 1 and mw["meshGatherRows"] == 8 * 9
    assert mw["iciBytes"] > 0 and mw.get("hostShuffleFallbacks", 0) == 0
    assert tables_differ(_as_reference(warm), _as_reference(cold)) is None


@pytest.mark.parametrize("name", QUERIES)
def test_corpus_query_on_the_mesh_matches_reference(name):
    ttabs, _ = _tables()
    got = tcorpus.build_queries(TorchSession(dict(MESH), device="cpu"),
                                ttabs)[name]().collect_table()
    assert got.num_rows > 0
    ref = _reference(name)
    g = _as_reference(got)
    if name in EXACT:
        assert tables_differ(g, ref) is None
    else:
        assert tables_close(g, ref, rtol=1e-9) is None
    if name in REFERENCE_MESH:
        jmesh = _reference(name, MESH)
        if name in EXACT:
            assert tables_differ(g, jmesh) is None
        else:
            assert tables_close(g, jmesh, rtol=1e-9) is None
        # and bit for bit the port's own single-device result
        one = tcorpus.build_queries(TorchSession(device="cpu"),
                                    ttabs)[name]().collect_table()
        assert tables_differ(g, _as_reference(one)) is None


@pytest.mark.parametrize("form", ["range", "too_many", "roundrobin"])
def test_demotion_reasons_match_the_reference(form):
    """An exchange the mesh cannot take states the reference's reason in
    explain and counts hostShuffleFallbacks; its rows are the host
    shuffle's."""
    from spark_rapids_tpu.ops.expr import col as jcol
    from spark_rapids_tpu.plan import from_host_table as jfrom
    from spark_rapids_tpu.plan import nodes as JP
    from spark_rapids_tpu_torch.ops.expr import col
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.plan import nodes as P
    t = host_table_from_arrays(*_exchange_arrays(400))

    def shape(df, nodes, c):
        if form == "range":
            return df._wrap(nodes.Exchange(df.plan, "range", 4, [c("k")]))
        if form == "too_many":
            return df.repartition(12, "k")
        return df.repartition(4)
    s = TorchSession(dict(MESH), device="cpu")
    df = shape(from_host_table(t, s), P, col)
    got_explain = s.explain(df)
    got = df.collect_table()
    js = TpuSession(dict(MESH))
    jdf = shape(jfrom(_as_reference(t), js), JP, jcol)
    want_explain = js.explain(jdf.plan)

    def reason(text):
        return [line.split("(host-shuffle fallback: ")[1].rstrip(")")
                for line in text.splitlines() if "host-shuffle" in line]
    assert reason(got_explain) == reason(want_explain) != []
    assert s.last_metrics()["hostShuffleFallbacks"] == 1
    assert tables_differ(_as_reference(got), jdf.collect_table()) is None


def test_mesh_identity_folds_into_fingerprint_and_generation():
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.plan.fingerprint import fingerprint
    from spark_rapids_tpu_torch.plan import from_host_table
    t = host_table_from_arrays(*_exchange_arrays(50))
    s = TorchSession(dict(MESH), device="cpu")
    plan = from_host_table(t, s).repartition(8, "k").plan
    tmesh.MESH.configure(RapidsConf(dict(MESH)))
    gen = tmesh.MESH.generation()
    on = fingerprint(plan, RapidsConf({}))
    assert tmesh.MESH.identity_token().startswith("mesh:8/data/0@cpu")
    assert tmesh.MESH.shrink_excluding(None, "test shrink")
    tmesh.MESH.configure(RapidsConf(dict(MESH)))
    assert tmesh.MESH.generation() == gen + 1
    assert tmesh.MESH.health_snapshot()["shape"] == "7"
    assert fingerprint(plan, RapidsConf({})) != on
    tmesh.MESH.restore()
    tmesh.MESH.configure(RapidsConf(dict(MESH)))
    assert tmesh.MESH.health_snapshot()["excludedDeviceIds"] == []
    with pytest.raises(Exception, match="needs 16 devices"):
        tmesh.MESH.configure(RapidsConf({**MESH,
                                         "spark.rapids.mesh.shape": "4x4"}))
    tmesh.MESH.configure(RapidsConf({**MESH,
                                     "spark.rapids.mesh.shape": "2x4"}))
    assert tmesh.MESH.shape_str() == "2x4"
    assert tmesh.MESH.mesh().axes == ("dcn", "ici")
