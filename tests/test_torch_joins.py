"""Every join type of the port's TpuJoinExec (execs/join.py) on the CPU
against the JAX package's TpuSession on the same numpy inputs, mirroring
the reference's tests/test_joins.py: join types {inner, left, right,
full, leftsemi, leftanti} x keys {dense int, sparse long, string, date},
with null keys on both sides, each case on each route it can take:

- DIRECT (dense int and date keys; inner, left, semi and anti joins): the
  build keys are unique and dense, so the direct-address join takes the
  batch with no replay;
- HASH PROBE (integer keys): unique build keys at a load of 0.23 with 8
  attempts (no homeless row), the site's direct route blocklisted in the
  port's speculation (a sparse long key fails it on its own after one
  replay);
- SORT-BASED (every key): repeated build keys, both speculative routes
  blocklisted.

Each case checks the route by the port's metrics. Also multi-key joins,
type promotion of the keys, an inner join with a residual condition, the
cross join, an outer join with DECIMAL128 and string columns on its null
side, and the equi-plus-residual outer join, which still refuses with the
reference's reason.

Comparator: ``scale_test.tables_differ_unordered`` (a bitwise row
multiset) for every join's rows: the routes of the two packages may emit
matches in another order."""

import numpy as np
import pytest
import torch

from scale_test import tables_differ_unordered
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.runtime import speculation as jspec
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch.execs.join import TpuJoinExec
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.overrides.rules import convert
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.runtime import speculation as tspec
from spark_rapids_tpu_torch.session import TorchSession

JOIN_TYPES = ("inner", "left", "right", "full", "leftsemi", "leftanti")
DIRECT_TYPES = ("inner", "left", "leftsemi", "leftanti")
N_LEFT, N_RIGHT = 300, 60
DOMAIN = 400


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


def _key_values(kind: str, codes: np.ndarray):
    """(type name, values) of key ``codes`` in [0, DOMAIN) for a key
    kind: dense int, sparse long (k -> k * 0x9E3779B1 mod 2^40), string,
    date (days from 9000)."""
    if kind == "dense_int":
        return "int", codes.astype(np.int32)
    if kind == "sparse_long":
        return "bigint", (codes.astype(np.int64) * 0x9E3779B1) & ((1 << 40)
                                                                   - 1)
    if kind == "string":
        return "string", np.array([f"k{c:04d}" for c in codes], dtype=object)
    return "date", (9000 + codes).astype(np.int32)


def _join_inputs(kind: str, unique_build: bool, seed: int = 11,
                 build_left: bool = False):
    """(left arrays, right arrays): keys with about 10% nulls on both
    sides; the build side (the right one, or the left one for a right
    outer join) has N_RIGHT rows, with unique keys when asked, else keys
    that repeat."""
    rng = np.random.default_rng(seed)
    pcodes = rng.integers(0, DOMAIN, N_LEFT)
    bcodes = (rng.permutation(DOMAIN)[:N_RIGHT] if unique_build
              else rng.integers(0, DOMAIN // 4, N_RIGHT))
    lcodes, rcodes = (bcodes, pcodes) if build_left else (pcodes, bcodes)
    out = []
    for codes, vname in ((lcodes, "lv"), (rcodes, "rv")):
        n = len(codes)
        ktype, kvals = _key_values(kind, codes)
        kvalid = rng.random(n) > 0.1
        if ktype == "string":
            kvals = np.where(kvalid, kvals, None)
        out.append((["k", vname], [ktype, "bigint"], [
            (kvals, kvalid),
            (rng.integers(-1000, 1000, n).astype(np.int64),
             rng.random(n) > 0.05)]))
    return out


def _sessions(conf=None):
    return TorchSession(conf, device="cpu"), TpuSession(conf)


def _frames(sess, from_table, arrays, port: bool, num_batches=1):
    table = (host_table_from_arrays(*arrays) if port
             else _reference_table(*arrays))
    return from_table(table, sess, num_batches)


def _run_both(build, inputs, conf=None, before=None):
    """(port result as a reference HostTable, reference result, port
    session): ``build(session, *frames)`` -> DataFrame over frames of
    ``inputs`` (arrays, num_batches); ``before(port_df)`` runs ahead of
    the port's collect."""
    ts, js = _sessions(conf)
    tdf = build(ts, *[_frames(ts, tfrom, a, True, nb) for a, nb in inputs])
    jdf = build(js, *[_frames(js, jfrom, a, False, nb) for a, nb in inputs])
    if before is not None:
        before(tdf)
    got = _as_reference(tdf.collect_table())
    return got, jdf.collect_table(), ts


def _join_site(df) -> str:
    """The speculation site of the plan's (one) equi-join, as the session
    converts it."""
    root = convert(df.plan, df.session.conf, df.session.device)
    stack = [root]
    while stack:
        e = stack.pop()
        if isinstance(e, TpuJoinExec):
            return e._site_key
        stack.extend(e.children)
    raise AssertionError("no TpuJoinExec in the plan")


ROUTE_CASES = [
    (kind, how, route)
    for kind, routes in (("dense_int", ("direct", "hashprobe", "sort")),
                         ("sparse_long", ("hashprobe", "sort")),
                         ("string", ("sort",)),
                         ("date", ("direct", "hashprobe", "sort")))
    for how in JOIN_TYPES
    for route in routes
    if route != "direct" or how in DIRECT_TYPES]


@pytest.mark.parametrize("kind,how,route", ROUTE_CASES)
def test_join_types_keys_and_routes(kind, how, route):
    left, right = _join_inputs(kind, unique_build=route != "sort",
                               build_left=how == "right")

    def build(s, ldf, rdf):
        return ldf.join(rdf, on="k", how=how)

    def force(df):
        site = _join_site(df)
        if route in ("hashprobe", "sort") and kind != "sparse_long":
            tspec.blocklist([site + ":direct"])
        if route == "sort":
            tspec.blocklist([site + ":direct", site + ":hashprobe"])

    conf = ({"spark.rapids.tpu.kernels.hashprobe.attempts": "8"}
            if route == "hashprobe" else None)
    got, ref, ts = _run_both(build, [(left, 2), (right, 1)], conf=conf,
                             before=force)
    assert tables_differ_unordered(got, ref) is None
    m = ts.last_metrics()
    # the probe side's two scan batches coalesce into one
    assert m["probeBatches"] == 1
    if route == "direct":
        assert m["directJoinBatches"] == 1 and m["speculationReplays"] == 0
    elif route == "hashprobe":
        assert m["hashProbeBatches"] == 1 and "directJoinBatches" not in m
    else:
        assert "hashProbeBatches" not in m and "directJoinBatches" not in m


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_join_multi_key(how):
    rng = np.random.default_rng(3)

    def side(n, vname):
        return (["a", "b", vname], ["int", "string", "double"], [
            (rng.integers(0, 10, n).astype(np.int32), rng.random(n) > 0.1),
            (np.array([f"s{i}" for i in rng.integers(0, 5, n)],
                      dtype=object), np.ones(n, bool)),
            (rng.standard_normal(n), np.ones(n, bool))])

    left, right = side(250, "lv"), side(150, "rv")
    got, ref, _ = _run_both(
        lambda s, l, r: l.join(r, on=["a", "b"], how=how),
        [(left, 1), (right, 1)])
    assert tables_differ_unordered(got, ref) is None


def test_join_key_type_promotion():
    """An int key against a bigint key casts to bigint on both sides."""
    rng = np.random.default_rng(5)
    left = (["k", "lv"], ["int", "bigint"], [
        (rng.integers(0, 50, 120).astype(np.int32), np.ones(120, bool)),
        (np.arange(120, dtype=np.int64), np.ones(120, bool))])
    right = (["k2", "rv"], ["bigint", "bigint"], [
        (rng.permutation(60).astype(np.int64), np.ones(60, bool)),
        (np.arange(60, dtype=np.int64), np.ones(60, bool))])

    def build(s, ldf, rdf):
        from spark_rapids_tpu.ops.expr import col as jcol
        from spark_rapids_tpu_torch.ops.expr import col as tcol
        col = tcol if isinstance(s, TorchSession) else jcol
        return ldf.join(rdf.select(col("k2").alias("k"), col("rv")),
                        on="k", how="left")

    got, ref, _ = _run_both(build, [(left, 1), (right, 1)])
    assert tables_differ_unordered(got, ref) is None


def _sql_both(tables, sql, conf=None):
    ts, js = _sessions(conf)
    for name, arrays in tables.items():
        tfrom(host_table_from_arrays(*arrays), ts) \
            .create_or_replace_temp_view(name)
        jfrom(_reference_table(*arrays), js) \
            .create_or_replace_temp_view(name)
    got = _as_reference(ts.sql(sql).collect_table())
    return got, js.sql(sql).collect_table(), ts


def test_inner_join_with_a_residual_condition():
    """Equi key plus a non-equi conjunct: the join filters its output."""
    left, right = _join_inputs("dense_int", unique_build=False, seed=21)
    got, ref, _ = _sql_both(
        {"a": left, "b": right},
        "SELECT a.k, lv, rv FROM a JOIN b ON a.k = b.k AND lv > rv")
    assert got.num_rows > 0
    assert tables_differ_unordered(got, ref) is None


def test_cross_join():
    """df.join(other) with no keys: every pair, the left columns first."""
    left, right = _join_inputs("string", unique_build=True, seed=4)
    left = (left[0], left[1], [(d[:40], v[:40]) for d, v in left[2]])
    right = (["k2", "rv"], right[1], [(d[:7], v[:7]) for d, v in right[2]])
    got, ref, _ = _run_both(lambda s, l, r: l.join(r),
                            [(left, 2), (right, 1)])
    assert got.num_rows == 280
    assert tables_differ_unordered(got, ref) is None


@pytest.mark.parametrize("how", ["left", "full", "right"])
def test_outer_join_null_side_decimal128_and_string(how):
    """The null side of an outer join keeps each storage: (cap, 2) limbs
    for a DECIMAL128 column, int32 codes over the build's dictionary for a
    string column (the reference's test_outer_join_null_side_p38)."""
    big = (1 << 100) + 7
    left = (["k", "v"], ["bigint", "bigint"], [
        (np.array([0, 1, 2, 3], dtype=np.int64), np.ones(4, bool)),
        (np.arange(4, dtype=np.int64), np.ones(4, bool))])
    right = (["k2", "d", "s"], ["bigint", "decimal(38,2)", "string"], [
        (np.array([2, 3, 4, 5], dtype=np.int64), np.ones(4, bool)),
        (np.array([big, -(1 << 64) - 3, 7, 0], dtype=object),
         np.array([1, 1, 1, 0], bool)),
        (np.array(["x", None, "zz", "y"], dtype=object),
         np.array([1, 0, 1, 1], bool))])
    got, ref, _ = _sql_both(
        {"a": left, "b": right},
        f"SELECT k, v, d, s FROM a {how.upper()} JOIN b ON k = k2")
    assert tables_differ_unordered(got, ref) is None


def test_equi_join_with_residual_on_outer_refuses_with_the_reason():
    """The reference falls back to its CPU for an outer, semi or anti join
    with equi keys plus a residual condition; the port raises with the
    reference's reason."""
    left, right = _join_inputs("dense_int", unique_build=True)
    for how in ("LEFT", "LEFT SEMI", "FULL"):
        ts, _ = _sessions()
        for name, arrays in (("a", left), ("b", right)):
            tfrom(host_table_from_arrays(*arrays), ts) \
                .create_or_replace_temp_view(name)
        df = ts.sql(f"SELECT a.k FROM a {how} JOIN b ON a.k = b.k "
                    "AND lv > rv")
        jt = how.lower().replace(" ", "")
        with pytest.raises(NotImplementedError,
                           match=f"non-equi condition on equi {jt} join"):
            df.collect_table()
