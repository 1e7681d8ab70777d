"""TPC-H q3 and inner joins through the port's session on the CPU against
the JAX package's TpuSession, on the same tables.

Two data forms of q3: DENSE, the tables exactly as models/tpch.py builds
them (every join takes the direct-address route; the group-by on
l_orderkey the no-sort int-domain layout), and SPARSE, the four key
columns mapped through the bijection k -> (k * 0x9E3779B1) mod 2^40 (the
direct join fails its speculation and the query replays onto the hash
probe; the group-by takes the sort-segment path). The sparse form runs the
reference with its hash probe enabled, which it leaves off on the CPU by
default.

Comparators: l_orderkey and n with scale_test.tables_differ (bitwise, in
order); revenue with scale_test.tables_close (rtol 1e-9), since f64 sums
may add in another order. Joins without an aggregate compare their rows
with scale_test.tables_differ_unordered (a bitwise row multiset)."""

from collections import Counter

import numpy as np
import pytest
import torch

from scale_test import tables_close, tables_differ, tables_differ_unordered
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.models import tpch as jtpch
from spark_rapids_tpu.runtime import speculation as jspec
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.models import tpch as ttpch
from spark_rapids_tpu_torch.runtime import speculation as tspec
from spark_rapids_tpu_torch.session import TorchSession

SPARSE_KEYS = {"c_custkey", "o_orderkey", "o_custkey", "l_orderkey"}
HASHPROBE_ON = {"spark.rapids.tpu.kernels.hashprobe.enabled": "true"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread: the suite runs in several worker
    processes at once, and torch's default of one thread per core would
    crowd the other workers' timed tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clear_blocklists():
    """Speculation blocklists are process-wide in both packages and key on
    the join's shape and plan position, which the dense and sparse forms
    share."""
    jspec._BLOCKLIST.clear()
    tspec.clear_blocklist()
    yield
    jspec._BLOCKLIST.clear()
    tspec.clear_blocklist()


def _reference_table(names, type_names, arrays) -> JHostTable:
    return JHostTable(names, [
        JHostColumn(JT.parse_type(t), d, v)
        for t, (d, v) in zip(type_names, arrays)])


def _arrays_of(t):
    return (list(t.names), [c.dtype.simple_string() for c in t.columns],
            [(c.data, c.validity) for c in t.columns])


def sparse_form(arrays_of_table):
    """The sparse key form: every key column through
    k -> (k * 0x9E3779B1) mod 2^40, a bijection on [0, 2^40)."""
    names, types, arrays = arrays_of_table
    out = []
    for n, (d, v) in zip(names, arrays):
        if n in SPARSE_KEYS:
            d = (d.astype(np.int64) * 0x9E3779B1) & ((1 << 40) - 1)
        out.append((d, v))
    return names, types, out


def _q3_inputs(rows, seed, form):
    tabs = [_arrays_of(t) for t in jtpch.q3_tables(rows, seed)]
    if form == "sparse":
        tabs = [sparse_form(t) for t in tabs]
    return ([_reference_table(*t) for t in tabs],
            [host_table_from_arrays(*t) for t in tabs])


def _ref_replays(jsess) -> int:
    import re
    m = re.search(r"speculationReplays=(\d+)", jsess.last_metrics())
    return int(m.group(1)) if m else 0


def _site_kinds(blocklist):
    """Multiset of the blocklisted sites' kinds (':direct',
    ':hashprobe', ...): the site strings themselves name plan positions,
    which differ between the two packages' plans."""
    return Counter(s.rsplit(":", 1)[-1] for s in blocklist)


def _assert_q3_matches(ref: JHostTable, got_t):
    got = _reference_table(*got_t.to_arrays())
    assert list(got.names) == ["l_orderkey", "revenue", "n"]

    def sub(t, names):
        return JHostTable(names, [t.column(n) for n in names])

    assert tables_differ(sub(got, ["l_orderkey", "n"]),
                         sub(ref, ["l_orderkey", "n"])) is None
    assert tables_close(got, ref, rtol=1e-9) is None
    return got


@pytest.mark.parametrize("form", ["dense", "sparse"])
@pytest.mark.parametrize("rows", [40000, 50001])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_q3_matches_reference(form, rows, seed):
    jtabs, ttabs = _q3_inputs(rows, seed, form)
    jsess = TpuSession(HASHPROBE_ON if form == "sparse" else None)
    ref = jtpch.q3_dataframe(jsess, *jtabs).collect_table()
    assert ref.num_rows == 10

    tsess = TorchSession(device="cpu")
    cold = ttpch.q3_dataframe(tsess, *ttabs).collect_table()
    m = tsess.last_metrics()
    got = _assert_q3_matches(ref, cold)
    # the same speculations fail in both packages, so both replay alike
    assert m["speculationReplays"] == _ref_replays(jsess)
    assert _site_kinds(tspec._BLOCKLIST) == _site_kinds(jspec._BLOCKLIST)
    if form == "dense":
        assert m["speculationReplays"] == 0
        assert m["directJoinBatches"] == 2
    else:
        # the direct joins fail, then at least one join hash-probes (a
        # build row left homeless by the default 4 attempts sends that
        # join on to the sort-based probe in a second replay)
        assert m["speculationReplays"] >= 1
        assert m.get("directJoinBatches", 0) == 0
        assert m["hashProbeBatches"] >= 1
        assert _site_kinds(tspec._BLOCKLIST)["direct"] == 2

    warm = ttpch.q3_dataframe(tsess, *ttabs).collect_table()
    assert tsess.last_metrics()["speculationReplays"] == 0
    assert tables_differ(_reference_table(*warm.to_arrays()), got) is None


def test_sparse_q3_with_eight_attempts_hash_probes_both_joins():
    """With 8 attempts every orders row finds a slot, so the cold run
    replays once (the direct joins) and both joins hash-probe, in both
    packages."""
    conf = {"spark.rapids.tpu.kernels.hashprobe.attempts": "8"}
    jtabs, ttabs = _q3_inputs(40000, 0, "sparse")
    jsess = TpuSession({**HASHPROBE_ON, **conf})
    ref = jtpch.q3_dataframe(jsess, *jtabs).collect_table()
    tsess = TorchSession(conf, device="cpu")
    got = ttpch.q3_dataframe(tsess, *ttabs).collect_table()
    _assert_q3_matches(ref, got)
    m = tsess.last_metrics()
    assert m["speculationReplays"] == 1 == _ref_replays(jsess)
    assert m["hashProbeBatches"] == 2
    assert _site_kinds(tspec._BLOCKLIST) == Counter({"direct": 2})


def test_top_k_over_two_batches():
    """ORDER BY ... LIMIT over a two-batch filtered scan: a top-k per
    batch, then one sort of their concatenation (tables_differ: bitwise,
    in order, ties in row order)."""
    from spark_rapids_tpu.ops.expr import col as jcol, lit as jlit
    from spark_rapids_tpu.plan import from_host_table as jfrom
    from spark_rapids_tpu.plan.nodes import SortOrder as JSortOrder
    from spark_rapids_tpu_torch.ops.expr import col as tcol, lit as tlit
    from spark_rapids_tpu_torch.plan import from_host_table as tfrom
    from spark_rapids_tpu_torch.plan.nodes import SortOrder as TSortOrder

    rng = np.random.default_rng(11)
    n = 5000
    t = (["k", "x"], ["int", "double"],
         [(rng.integers(0, 100, n).astype(np.int32), _ones(n)),
          (rng.integers(0, 50, n) / 4.0, rng.random(n) > 0.1)])

    def q(frm, col, lit, SortOrder, sess, table):
        return (frm(table, sess, num_batches=2).filter(col("k") > lit(20))
                .sort(SortOrder(col("x"), ascending=False), "k").limit(25))

    ref = q(jfrom, jcol, jlit, JSortOrder, TpuSession(),
            _reference_table(*t)).collect_table()
    got = q(tfrom, tcol, tlit, TSortOrder, TorchSession(device="cpu"),
            host_table_from_arrays(*t)).collect_table()
    assert got.num_rows == 25
    assert tables_differ(_reference_table(*got.to_arrays()), ref) is None


def test_q3_generator_matches_reference():
    for a, b in zip(jtpch.q3_tables(5000, seed=3),
                    ttpch.q3_tables(5000, seed=3)):
        assert a.names == b.names
        for ca, cb in zip(a.columns, b.columns):
            assert ca.dtype.simple_string() == cb.dtype.simple_string()
            assert ca.data.dtype == cb.data.dtype
            assert (ca.data == cb.data).all()
    assert ttpch.Q3_DATE == jtpch.Q3_DATE
    assert list(ttpch.SEGMENTS) == list(jtpch.SEGMENTS)


# ---------------------------------------------------------------------------
# inner joins on their own
# ---------------------------------------------------------------------------

def _join_both(left, right, on, conf=None, left_filter=None,
               right_filter=None, left_batches=1):
    """The same inner join through both packages; ``*_filter(col, lit)``
    builds a filter on that side."""
    from spark_rapids_tpu.ops.expr import col as jcol, lit as jlit
    from spark_rapids_tpu.plan import from_host_table as jfrom
    from spark_rapids_tpu_torch import types as TT
    from spark_rapids_tpu_torch.ops.expr import col as tcol, lit as tlit
    from spark_rapids_tpu_torch.plan import from_host_table as tfrom

    def plan(frm, col, lit, types, sess, lt, rt):
        ldf = frm(lt, sess, num_batches=left_batches)
        rdf = frm(rt, sess)
        if left_filter is not None:
            ldf = ldf.filter(left_filter(col, lit, types))
        if right_filter is not None:
            rdf = rdf.filter(right_filter(col, lit, types))
        return ldf.join(rdf, on=on, how="inner")

    jsess, tsess = TpuSession(conf), TorchSession(conf, device="cpu")
    ref = plan(jfrom, jcol, jlit, JT, jsess, _reference_table(*left),
               _reference_table(*right)).collect_table()
    got = plan(tfrom, tcol, tlit, TT, tsess, host_table_from_arrays(*left),
               host_table_from_arrays(*right)).collect_table()
    return ref, _reference_table(*got.to_arrays()), tsess


def _ones(n):
    return np.ones(n, dtype=bool)


def test_duplicated_build_key_replays_onto_the_sort_join():
    """A repeated build key fails the direct join and then the hash probe
    (its self-probe finds the other row); the join replays onto the
    sort-based probe and expands every match."""
    rng = np.random.default_rng(7)
    n = 3000
    fact = (["k", "v"], ["bigint", "bigint"],
            [(rng.integers(0, 50, n).astype(np.int64), _ones(n)),
             (np.arange(n, dtype=np.int64), _ones(n))])
    dupk = np.concatenate([np.arange(50), np.arange(0, 50, 2)])
    dim = (["k", "w"], ["bigint", "bigint"],
           [(dupk.astype(np.int64), _ones(len(dupk))),
            (np.arange(len(dupk), dtype=np.int64), _ones(len(dupk)))])
    ref, got, tsess = _join_both(fact, dim, "k")
    assert got.num_rows > n
    assert tables_differ_unordered(got, ref) is None
    m = tsess.last_metrics()
    assert m["speculationReplays"] >= 2
    assert "directJoinBatches" not in m and "hashProbeBatches" not in m
    kinds = _site_kinds(tspec._BLOCKLIST)
    assert kinds["direct"] == 1 and kinds["hashprobe"] == 1


def test_join_with_an_empty_build_side_and_null_probe_keys():
    """A build filter that drops every row, and probe keys that are all
    null: both joins are empty. Also an int key probing a bigint key
    (the planner casts the int side up) over a two-batch probe side that
    the coalesce concatenates."""
    rng = np.random.default_rng(8)
    n = 2000
    keys = rng.integers(0, 300, n).astype(np.int64)
    fact = (["k", "x"], ["bigint", "double"],
            [(keys, _ones(n)), (rng.random(n), _ones(n))])
    dim = (["k", "d"], ["bigint", "date"],
           [(np.arange(300, dtype=np.int64), _ones(300)),
            (rng.integers(8766, 9855, 300).astype(np.int32), _ones(300))])
    ref, got, _ = _join_both(
        fact, dim, "k", right_filter=lambda col, lit, T: col("d") < lit(
            0, T.DATE))
    assert got.num_rows == ref.num_rows == 0
    assert tables_differ_unordered(got, ref) is None

    nulls = (["k", "x"], ["bigint", "double"],
             [(keys, np.zeros(n, dtype=bool)), (rng.random(n), _ones(n))])
    ref, got, _ = _join_both(nulls, dim, "k")
    assert got.num_rows == ref.num_rows == 0
    assert tables_differ_unordered(got, ref) is None

    names = np.array(["ash", "elm", "fir", "oak", "yew"], dtype=object)
    ikeys = (["k", "x", "s"], ["int", "double", "string"],
             [(keys.astype(np.int32), rng.random(n) > 0.1),
              (rng.random(n), _ones(n)),
              (names[rng.integers(0, 5, n)], _ones(n))])
    ref, got, _ = _join_both(ikeys, dim, "k", left_batches=2)
    assert 0 < got.num_rows < n
    assert tables_differ_unordered(got, ref) is None


def test_joins_on_a_string_key_and_on_two_keys():
    """A string key joins on codes remapped into the two sides' union
    dictionary (one integer key: the direct route); two keys take the
    sort-based probe, which dense-ranks the (k, s) pairs."""
    rng = np.random.default_rng(10)
    n = 3000
    names = np.array(["ash", "birch", "elm", "fir", "oak", "yew"],
                     dtype=object)
    fact = (["k", "s", "x"], ["bigint", "string", "double"],
            [(rng.integers(0, 40, n).astype(np.int64), _ones(n)),
             (names[rng.integers(0, 6, n)], rng.random(n) > 0.05),
             (rng.random(n), _ones(n))])
    pairs = [(k, s) for k in range(0, 40, 3) for s in names[1:5]]
    dim = (["k", "s", "w"], ["bigint", "string", "bigint"],
           [(np.array([p[0] for p in pairs], np.int64), _ones(len(pairs))),
            (np.array([p[1] for p in pairs], object), _ones(len(pairs))),
            (np.arange(len(pairs), dtype=np.int64), _ones(len(pairs)))])
    ref, got, tsess = _join_both(fact, dim, ["k", "s"])
    assert 0 < got.num_rows < n
    assert tables_differ_unordered(got, ref) is None
    assert "directJoinBatches" not in tsess.last_metrics()

    tspec.clear_blocklist()
    jspec._BLOCKLIST.clear()
    sdim = (["s", "w"], ["string", "bigint"],
            [(names[1:5].copy(), _ones(4)),
             (np.arange(4, dtype=np.int64), _ones(4))])
    ref, got, tsess = _join_both(fact, sdim, "s")
    assert 0 < got.num_rows < n
    assert tables_differ_unordered(got, ref) is None
    assert tsess.last_metrics()["directJoinBatches"] == 1


def test_sort_segment_aggregate_speculative_shrink(monkeypatch):
    """The sort-segment group-by keeps its input capacity and speculates
    its groups into a quarter of it. Below the shrink's threshold it
    does not speculate; with the threshold lowered the speculation holds
    for few groups and fails (one replay, then the full capacity) for
    many. Results equal the reference's (tables_differ_unordered on the
    keys and counts, tables_close on the sums)."""
    from spark_rapids_tpu_torch import functions as TF
    from spark_rapids_tpu_torch.execs import aggregate as tagg
    from spark_rapids_tpu import functions as JF
    from spark_rapids_tpu.plan import from_host_table as jfrom
    from spark_rapids_tpu_torch.plan import from_host_table as tfrom

    monkeypatch.setattr(tagg, "EMBED_NROWS_CAP", 128)
    rng = np.random.default_rng(9)
    n = 4000
    for ngroups, replays in ((100, 0), (3000, 1)):
        tspec.clear_blocklist()
        k = (rng.choice(ngroups, n) * 0x9E3779B1 % (1 << 40)).astype(np.int64)
        t = (["k", "x"], ["bigint", "double"],
             [(k, _ones(n)), (rng.random(n), rng.random(n) > 0.1)])

        def q(frm, F, sess, table):
            return frm(table, sess).group_by("k").agg(
                F.sum(F.col("x")).alias("s"), F.count().alias("c"))

        ref = q(jfrom, JF, TpuSession(), _reference_table(*t)).collect_table()
        tsess = TorchSession(device="cpu")
        got = _reference_table(*q(tfrom, TF, tsess,
                                  host_table_from_arrays(*t)).collect_table()
                               .to_arrays())
        keys = ["k", "c"]
        assert tables_differ_unordered(
            JHostTable(keys, [got.column(c) for c in keys]),
            JHostTable(keys, [ref.column(c) for c in keys])) is None
        assert tables_close(got, ref, rtol=1e-9) is None
        assert tsess.last_metrics()["speculationReplays"] == replays


def test_conf_keys_and_unported_shapes(monkeypatch):
    """The slice's conf keys are accepted with the reference's names; an
    attempts value outside [1, 8] raises when read; an outer join with
    equi keys plus a residual condition, a sort past the out-of-core
    threshold and an unported operator refuse by name."""
    from spark_rapids_tpu_torch import conf as C
    from spark_rapids_tpu_torch.execs import sort as xsort
    from spark_rapids_tpu_torch.ops.expr import col
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.plan import nodes as P

    conf = C.RapidsConf({
        "spark.rapids.tpu.join.directTableMultiplier": "2",
        "spark.rapids.tpu.speculativeSizing.enabled": "false",
        "spark.rapids.sql.broadcastSizeBytes": "0",
        "spark.rapids.tpu.agg.maxKeyDomainGroups": "0",
        "spark.rapids.tpu.kernels.hashprobe.attempts": "8",
        "spark.rapids.sql.join.subPartition.targetBytes": "4096",
        "spark.rapids.sql.join.maxSubPartitions": "8"})
    assert conf.get_entry(C.JOIN_DIRECT_TABLE_MULT) == 2
    assert conf.get_entry(C.SPECULATIVE_SIZING) is False
    assert conf.get_entry(C.KERNELS_HASHPROBE_ATTEMPTS) == 8
    assert conf.get_entry(C.JOIN_SUBPARTITION_BYTES) == 4096
    assert conf.get_entry(C.JOIN_MAX_SUBPARTITIONS) == 8
    assert C.RapidsConf().get_entry(C.JOIN_SUBPARTITION_BYTES) == 1 << 30
    assert C.RapidsConf().get_entry(C.JOIN_MAX_SUBPARTITIONS) == 64
    for bad in ("0", "9"):
        with pytest.raises(ValueError, match="attempts"):
            C.RapidsConf({"spark.rapids.tpu.kernels.hashprobe.attempts":
                          bad}).get_entry(C.KERNELS_HASHPROBE_ATTEMPTS)

    sess = TorchSession(device="cpu")
    t = host_table_from_arrays(["k", "v"], ["bigint", "bigint"],
                               [(np.arange(10, dtype=np.int64), _ones(10)),
                                (np.arange(10, dtype=np.int64), _ones(10))])
    df = from_host_table(t, sess)
    outer = df._wrap(P.Join(df.plan, df.plan, "left", [col("k")],
                            [col("k")], condition=col("v") > col("k")))
    with pytest.raises(NotImplementedError,
                       match="non-equi condition on equi left join"):
        outer.collect_table()
    # three batches of 2,304 device bytes (128-row buckets), each past a
    # 256-byte threshold: the pre-sort coalesce passes them on one by one,
    # and the sort refuses the second
    monkeypatch.setattr(xsort, "OUT_OF_CORE_THRESHOLD_BYTES", 256)
    with pytest.raises(NotImplementedError, match="outOfCoreThresholdBytes"):
        from_host_table(t, sess, num_batches=3).sort("v").collect_table()
    with pytest.raises(NotImplementedError, match="Remainder"):
        col("k") % 3  # noqa: B018


def test_q3_without_speculation_and_with_coalesced_builds():
    """Speculative sizing off: no direct join, no hash probe, exact join
    sizes read on the host. Broadcast threshold 0: every build side is a
    coalesce instead of a cached broadcast. Same answer as the
    reference."""
    conf = {"spark.rapids.tpu.speculativeSizing.enabled": "false",
            "spark.rapids.sql.broadcastSizeBytes": "0"}
    jtabs, ttabs = _q3_inputs(20000, 4, "sparse")
    ref = jtpch.q3_dataframe(TpuSession(conf), *jtabs).collect_table()
    tsess = TorchSession(conf, device="cpu")
    got = ttpch.q3_dataframe(tsess, *ttabs).collect_table()
    _assert_q3_matches(ref, got)
    m = tsess.last_metrics()
    assert m["speculationReplays"] == 0 and "hashProbeBatches" not in m
    assert "broadcastBatches" not in m
