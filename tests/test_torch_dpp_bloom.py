"""Dynamic partition pruning and the bloom runtime filter of the PyTorch
port (spark_rapids_tpu_torch: ``overrides/rules.py::_maybe_install_dpp``,
``io/common.py::FileScanNode._effective_paths``,
``execs/basic.py::TpuFileScanExec.install_dynamic_pruning``,
``ops/bloom.py``) against the reference on the same files and keys: the
cases of ``tests/test_dpp_bloom.py`` (pruning, through a projection, none
for an outer join, the conf switch, pruning to zero files, no leak across
queries, the bloom bits bit for bit, nulls, the pre-filtered join), plus
string, double and null partitions, the key casts, SQL text and the other
file formats. Results compare with ``scale_test.tables_differ_unordered``
(rows as a multiset, bit for bit), the pruned file counts exactly."""

import numpy as np
import pytest

from scale_test import tables_differ_unordered
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.io.parquet import write_parquet
from spark_rapids_tpu_torch.ops.expr import col
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.session import TorchSession


@pytest.fixture(scope="module")
def ref():
    return TpuSession()


@pytest.fixture(scope="module")
def port():
    return TorchSession(device="cpu")


def _tables(names, types, arrays):
    """The same columns as a port HostTable and a reference HostTable."""
    t = host_table_from_arrays(names, types, arrays)
    return t, JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), c.data, c.validity)
        for ty, c in zip(types, t.columns)])


def _valid(n):
    return np.ones(n, dtype=np.bool_)


def _write_fact(tmp_path, part_values, rows=300, part_type="bigint",
                seed=0, fmt="parquet"):
    """A fact table Hive-partitioned by ``region`` (one directory per
    value of ``part_values``, None for the null partition), written by
    the port's writer of ``fmt``."""
    rng = np.random.default_rng(seed)
    n = rows * len(part_values)
    region = np.repeat(np.array(part_values, dtype=object), rows)
    valid = np.array([v is not None for v in region])
    if part_type != "string":
        region = np.where(valid, region, 0)
    t, _ = _tables(["v", "k", "region"], ["double", "bigint", part_type], [
        (rng.random(n), _valid(n)),
        (rng.integers(0, 50, n), _valid(n)),
        (region, valid)])
    root = str(tmp_path / f"fact_{fmt}")
    df = tfrom(t, TorchSession(device="cpu"))
    getattr(df, f"write_{fmt}")(root, partition_by=["region"])
    return root


def _dim(values, part_type="bigint"):
    n = len(values)
    return _tables(["region", "name"], [part_type, "string"], [
        (np.array(values, dtype=object if part_type == "string" else None),
         _valid(n)),
        (np.array([f"n{i}" for i in range(n)], dtype=object), _valid(n))])


def _port_dpp(session):
    """(dppPrunedFiles, dppScannedFiles) of each pruning-armed scan exec of
    the port's last plan."""
    out, stack = [], [session._last_root]
    while stack:
        e = stack.pop()
        if getattr(e, "_dynamic_prunes", None):
            out.append((e.metrics.get("dppPrunedFiles"),
                        e.metrics.get("dppScannedFiles")))
        stack.extend(e.children)
    return out


def _ref_dpp(session):
    """The same of the reference's last plan (its test's walk)."""
    out = []

    def walk(e):
        if getattr(e, "_dynamic_prunes", None):
            out.append((e.metrics.get("dppPrunedFiles"),
                        e.metrics.get("dppScannedFiles")))
        for c in getattr(e, "children", ()):
            walk(c)
        for attr in ("scan_node", "cpu_node", "tpu_exec", "source"):
            n = getattr(e, attr, None)
            if n is not None:
                walk(n)
    walk(session._last_executable)
    return out


def _both(ref, port, root, dim, how="inner", fmt="parquet", project=False,
          **conf):
    """The count-per-name join query over the fact files and ``dim`` on
    both engines: (port table, reference table, port dpp, reference
    dpp)."""
    pdim, rdim = dim
    sessions = (TorchSession(conf, device="cpu") if conf else port,
                TpuSession(conf) if conf else ref)
    out = []
    for s, frm, Fn, c in ((sessions[0], tfrom, F, col),
                          (sessions[1], jfrom, JF, jcol)):
        fact = getattr(s, f"read_{fmt}")(root)
        if project:
            fact = fact.select(c("region"), (c("v") * 2.0).alias("v2"))
        q = fact.join(frm(pdim if frm is tfrom else rdim, s), on="region",
                      how=how)
        if how in ("leftsemi", "leftanti"):
            q = q.agg(Fn.count().alias("c"))
        else:
            q = q.group_by("name").agg(Fn.count().alias("c"))
        out.append(q.collect_table())
    return (out[0], out[1], _port_dpp(sessions[0]), _ref_dpp(sessions[1]))


def _same(got, want):
    assert tables_differ_unordered(got, want) is None


def test_dpp_prunes_files_inner_join(tmp_path, ref, port):
    root = _write_fact(tmp_path, list(range(8)))
    got, want, pd, rd = _both(ref, port, root, _dim([1, 6]))
    _same(got, want)
    assert pd == rd == [(6, 2)]


def test_dpp_through_projection(tmp_path, ref, port):
    root = _write_fact(tmp_path, list(range(5)))
    got, want, pd, rd = _both(ref, port, root, _dim([0]), how="leftsemi",
                              project=True)
    _same(got, want)
    assert pd == rd == [(4, 1)]


@pytest.mark.parametrize("how", ["left", "leftanti", "full"])
def test_dpp_not_installed_for_outer_or_anti_joins(tmp_path, ref, port, how):
    root = _write_fact(tmp_path, list(range(4)))
    got, want, pd, rd = _both(ref, port, root, _dim([2]), how=how)
    _same(got, want)
    assert pd == rd == []


def test_dpp_disabled_by_conf(tmp_path, ref, port):
    root = _write_fact(tmp_path, list(range(4)))
    on = _both(ref, port, root, _dim([2]))
    off = _both(ref, port, root, _dim([2]),
                **{"spark.rapids.sql.dpp.enabled": "false"})
    _same(off[0], off[1])
    _same(off[0], on[0])
    assert off[2] == off[3] == [] and on[2] == [(3, 1)]


def test_dpp_prune_to_zero_files(tmp_path, ref, port):
    root = _write_fact(tmp_path, list(range(3)))
    got, want, pd, rd = _both(ref, port, root, _dim([99]))
    _same(got, want)
    assert got.num_rows == 0
    assert pd == rd == [(3, 0)]


def test_dpp_does_not_leak_across_queries(tmp_path, port):
    root = _write_fact(tmp_path, list(range(6)))
    base = port.read_parquet(root)
    pdim, _ = _dim([1])
    join = base.join(tfrom(pdim, port), on="region", how="inner")
    assert join.count() == 300
    assert _port_dpp(port) == [(5, 1)]
    assert base.agg(F.count().alias("c")).collect() == [(6 * 300,)]
    assert _port_dpp(port) == []
    join.collect_table()  # a rerun does not stack providers
    assert _port_dpp(port) == [(5, 1)]


@pytest.mark.parametrize("part_type,values,keep", [
    ("string", ["a", "b", "c", None], ["b", "x"]),
    ("double", [0.5, 1.5, 2.5], [1.5]),
    ("bigint", [0, 1, None], [1]),
], ids=["string", "double", "null partition kept"])
def test_dpp_partition_types(tmp_path, ref, port, part_type, values, keep):
    """A string key reads back from the broadcast's dictionary codes as
    values; a raw partition value converts by the column's inferred type;
    a null partition is kept (null-safe), as in the reference."""
    root = _write_fact(tmp_path, values, rows=200, part_type=part_type)
    got, want, pd, rd = _both(ref, port, root, _dim(keep, part_type))
    _same(got, want)
    assert pd == rd
    kept = sum(v in keep for v in values) + (None in values)
    assert pd == [(len(values) - kept, kept)]


@pytest.mark.parametrize("dim_type,prunes", [("int", True),
                                             ("double", False)])
def test_dpp_key_casts_follow_the_reference(tmp_path, ref, port, dim_type,
                                            prunes):
    """The join casts a key pair of different types to their common type:
    an INT build key casts up to the LONG partition column and the scan
    prunes; a DOUBLE build key casts the PROBE key, which is then no
    column reference, and neither engine installs a prune."""
    root = _write_fact(tmp_path, list(range(4)))
    got, want, pd, rd = _both(ref, port, root, _dim([1, 3], dim_type))
    _same(got, want)
    assert pd == rd == ([(2, 2)] if prunes else [])


def test_dpp_from_sql_text(tmp_path, ref, port):
    root = _write_fact(tmp_path, list(range(6)))
    pdim, rdim = _dim([2, 4])
    text = ("SELECT name, count(*) AS c FROM fact JOIN dim "
            "ON fact.region = dim.region GROUP BY name")
    out = []
    for s, frm, dim in ((port, tfrom, pdim), (ref, jfrom, rdim)):
        s.sql(f"CREATE OR REPLACE TEMP VIEW fact USING parquet "
              f"OPTIONS (path '{root}')")
        frm(dim, s).create_or_replace_temp_view("dim")
        out.append(s.sql(text).collect_table())
    _same(out[0], out[1])
    assert _port_dpp(port) == _ref_dpp(ref) == [(4, 2)]


@pytest.mark.parametrize("fmt", ["orc", "csv", "json"])
def test_dpp_other_formats(tmp_path, port, fmt):
    """Every format through FileScanNode prunes the same files, to the
    result of the unpruned scan."""
    root = _write_fact(tmp_path, list(range(5)), rows=100, fmt=fmt)
    pdim, _ = _dim([0, 3])
    off = TorchSession({"spark.rapids.sql.dpp.enabled": "false"},
                       device="cpu")
    out = []
    for s in (port, off):
        q = (getattr(s, f"read_{fmt}")(root)
             .join(tfrom(pdim, s), on="region", how="inner")
             .group_by("name").agg(F.count().alias("c"),
                                   F.sum("k").alias("sk")))
        out.append(q.collect_table())
    assert _port_dpp(port) != []
    assert tables_differ_unordered(out[0], out[1]) is None
    assert sorted(out[0].columns[1].data.tolist()) == [100, 100]


# -- bloom ---------------------------------------------------------------------

def test_bloom_bits_equal_the_reference(ref, port):
    rng = np.random.default_rng(3)
    keys = rng.choice(50000, 300, replace=False).astype(np.int64)
    pt, rt = _tables(["k"], ["bigint"], [(keys, _valid(300))])
    want = JF.build_bloom_filter(jfrom(rt, ref), "k")
    for bits, hashes in ((None, None), (1 << 12, 5)):
        got = F.build_bloom_filter(tfrom(pt, port), "k", num_bits=bits,
                                   num_hashes=hashes)
        if bits is not None:
            want = JF.build_bloom_filter(jfrom(rt, ref), "k",
                                         num_bits=bits, num_hashes=hashes)
        assert got.bits.dtype.is_floating_point is False
        assert got.num_bits == want.num_bits
        np.testing.assert_array_equal(got.bits.numpy(),
                                      np.asarray(want.bits))


def test_bloom_no_false_negatives_and_reference_match(ref, port):
    rng = np.random.default_rng(3)
    fact = rng.integers(0, 50000, 20000).astype(np.int64)
    keys = rng.choice(50000, 300, replace=False).astype(np.int64)
    pk, rk = _tables(["k"], ["bigint"], [(keys, _valid(300))])
    pf, rf = _tables(["k"], ["bigint"], [(fact, _valid(20000))])
    got = tfrom(pf, port).filter(F.might_contain(
        F.build_bloom_filter(tfrom(pk, port), "k"), col("k")))
    want = jfrom(rf, ref).filter(JF.might_contain(
        JF.build_bloom_filter(jfrom(rk, ref), "k"), jcol("k")))
    got, want = got.collect_table(), want.collect_table()
    _same(got, want)
    truth = set(fact[np.isin(fact, keys)].tolist())
    assert truth <= set(got.columns[0].data.tolist())


def test_bloom_prefilter_preserves_join_result(ref, port):
    """Pre-filtering the probe with might_contain does not change the
    join's result (the InjectRuntimeFilter invariant)."""
    rng = np.random.default_rng(4)
    k = rng.integers(0, 10000, 30000).astype(np.int64)
    keys = np.sort(rng.choice(10000, 200, replace=False).astype(np.int64))
    pf, rf = _tables(["k", "v"], ["bigint", "double"],
                     [(k, _valid(30000)), (rng.random(30000), _valid(30000))])
    pd_, rd_ = _tables(["k", "w"], ["bigint", "bigint"],
                       [(keys, _valid(200)),
                        (np.arange(200, dtype=np.int64), _valid(200))])
    out = []
    for s, frm, Fn, c, fact, dim in ((port, tfrom, F, col, pf, pd_),
                                     (ref, jfrom, JF, jcol, rf, rd_)):
        bloom = Fn.build_bloom_filter(frm(dim, s), "k")
        for pre in (True, False):
            df = frm(fact, s)
            if pre:
                df = df.filter(Fn.might_contain(bloom, c("k")))
            out.append(df.join(frm(dim, s), on="k", how="inner")
                       .group_by("w").agg(Fn.count().alias("c"))
                       .collect_table())
    for t in out[1:]:
        _same(out[0], t)


def test_bloom_null_propagation(ref, port):
    keys = np.array([1, 7], dtype=np.int64)
    vals = (np.array([1, 0, 7, 99999], dtype=np.int64),
            np.array([True, False, True, True]))
    pk, rk = _tables(["k"], ["bigint"], [(keys, _valid(2))])
    pv, rv = _tables(["k"], ["bigint"], [vals])
    got = tfrom(pv, port).select(F.might_contain(
        F.build_bloom_filter(tfrom(pk, port), "k"), col("k")).alias("m"))
    want = jfrom(rv, ref).select(JF.might_contain(
        JF.build_bloom_filter(jfrom(rk, ref), "k"), jcol("k")).alias("m"))
    rows = got.collect()
    assert rows[0][0] is True and rows[1][0] is None and rows[2][0] is True
    assert rows == want.collect()


def test_bloom_build_ignores_null_keys(ref, port):
    keys = (np.array([5, 0, 9], dtype=np.int64),
            np.array([True, False, True]))
    pk, rk = _tables(["k"], ["bigint"], [keys])
    got = F.build_bloom_filter(tfrom(pk, port), "k", num_bits=256)
    want = JF.build_bloom_filter(jfrom(rk, ref), "k", num_bits=256)
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))


def test_bloom_of_a_non_integral_column_raises(ref, port):
    pt, rt = _tables(["d"], ["double"], [(np.array([1.5]), _valid(1))])
    with pytest.raises(ColumnarProcessingError, match="integral"):
        F.build_bloom_filter(tfrom(pt, port), "d")
    # might_contain over a double binds to an error too (the reference's
    # device path rejects it; its CPU route truncates to a long)
    bloom = F.build_bloom_filter(tfrom(_tables(
        ["k"], ["bigint"], [(np.arange(3), _valid(3))])[0], port), "k")
    with pytest.raises(ColumnarProcessingError, match="integral"):
        tfrom(pt, port).filter(F.might_contain(bloom, col("d")))
    from spark_rapids_tpu.errors import ColumnarProcessingError as JCPE
    with pytest.raises(JCPE, match="integral"):
        JF.build_bloom_filter(jfrom(rt, ref), "d")


def test_dpp_star_join_prunes_only_what_the_build_side_filters(tmp_path,
                                                                ref, port):
    """The dimension's filter written in the WHERE clause stays above the
    join in both packages (neither pushes a predicate through a join), so
    the broadcast holds every dimension row and prunes only the
    partitions no dimension row names; written on the dimension's side,
    it prunes to the kept months. Both packages prune the same files."""
    root = _write_fact(tmp_path, list(range(8)), rows=100)
    region = np.arange(6, dtype=np.int64)
    pdim, rdim = _tables(["region", "yr"], ["bigint", "int"], [
        (region, _valid(6)),
        (np.array([0, 0, 1, 1, 1, 2], dtype=np.int32), _valid(6))])
    texts = {
        "where": "SELECT count(*) AS c, sum(k) AS sk FROM fact JOIN dim "
                 "ON fact.region = dim.region WHERE yr = 1",
        "build side": "SELECT count(*) AS c, sum(k) AS sk FROM fact JOIN "
                      "(SELECT region FROM dim WHERE yr = 1) d "
                      "ON fact.region = d.region"}
    want_dpp = {"where": [(2, 6)], "build side": [(5, 3)]}
    for form, text in texts.items():
        out = []
        for s, frm, dim in ((port, tfrom, pdim), (ref, jfrom, rdim)):
            s.sql(f"CREATE OR REPLACE TEMP VIEW fact USING parquet "
                  f"OPTIONS (path '{root}')")
            frm(dim, s).create_or_replace_temp_view("dim")
            out.append(s.sql(text).collect_table())
        _same(out[0], out[1])
        assert out[0].columns[0].data.tolist() == [300]
        assert _port_dpp(port) == _ref_dpp(ref) == want_dpp[form], form
