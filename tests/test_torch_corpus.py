"""The golden corpus's q2 and q8, MIN/MAX group-bys and the global
aggregate through the port's session on the CPU against the JAX package's
TpuSession, on the same tables.

Tables: ``datagen.scale_test_specs`` at scale factors 0.02 and 0.2, three
seeds; the port's copy of the generators gives the reference's arrays bit
for bit (checked first). q8's printed result is one count, which a wrong
maximum would not change, so its inner group-by table is compared too, in
the dense key form (the int-domain no-sort layout) and with o_custkey
mapped through k -> (k * 0x9E3779B1) mod 2^40 (the sort-segment path).

Comparators: counts and MIN/MAX with scale_test.tables_differ (bitwise, in
order) or tables_differ_unordered (a bitwise row multiset) where the two
packages may emit groups in another order; q2's f64 sum with
scale_test.tables_close (rtol 1e-9: block partials against the
reference's row-order sum). Data holding NaN compares with the reference's
splitF64 route, whose segment_minmax_64 follows Spark's NaN rule as the
port does (tests/test_torch_minmax.py pins the default route's
difference); those aggregate lists hold only MIN/MAX/COUNT, so the split
touches no sum."""

import numpy as np
import pytest
import torch

from scale_test import build_queries as jbuild_queries
from scale_test import tables_close, tables_differ, tables_differ_unordered
from spark_rapids_tpu import datagen as jdatagen
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.runtime import speculation as jspec
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import datagen as tdatagen
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.models import corpus as tcorpus
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.runtime import speculation as tspec
from spark_rapids_tpu_torch.session import TorchSession

SPLIT = {"spark.rapids.tpu.sum.splitF64": "true"}
SEEDS = (0, 7, 11)
SCALES = (0.02, 0.2)


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


def _arrays_of(t):
    return (list(t.names), [c.dtype.simple_string() for c in t.columns],
            [(c.data, c.validity) for c in t.columns])


def _reference_table(names, type_names, arrays) -> JHostTable:
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(t), d, v)
        for t, (d, v) in zip(type_names, arrays)])


def _both(arrays_of_table):
    return (_reference_table(*arrays_of_table),
            host_table_from_arrays(*arrays_of_table))


_TABLES = {}


def _tables(sf, seed):
    """({name: reference table}, {name: port table}) of q2's and q8's
    columns, generated once per (sf, seed) by the port's datagen."""
    key = (sf, seed)
    if key not in _TABLES:
        tabs = tcorpus.corpus_tables(sf, seed)
        pairs = {n: _both(_arrays_of(t)) for n, t in tabs.items()}
        _TABLES[key] = ({n: p[0] for n, p in pairs.items()},
                        {n: p[1] for n, p in pairs.items()})
    return _TABLES[key]


def _as_reference(t) -> JHostTable:
    return _reference_table(*t.to_arrays())


def _col(t, name):
    return t.columns[list(t.names).index(name)]


# ---------------------------------------------------------------------------
# datagen
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_datagen_arrays_identical_to_reference(seed):
    sf = 0.02
    ref = jdatagen.scale_test_specs(sf)
    got = tdatagen.scale_test_specs(sf)
    assert list(ref) == list(got)
    for name in ref:
        a = ref[name].generate_table(sf, seed)
        b = got[name].generate_table(sf, seed)
        assert list(a.names) == list(b.names)
        for cname, ca, cb in zip(a.names, a.columns, b.columns):
            assert type(ca.dtype).__name__ == type(cb.dtype).__name__
            assert ca.dtype.simple_string() == cb.dtype.simple_string()
            assert np.array_equal(ca.validity, cb.validity), cname
            if ca.data.dtype == object:
                assert list(ca.data) == list(cb.data), cname
            else:
                assert ca.data.dtype == cb.data.dtype, cname
                assert ca.data.tobytes() == cb.data.tobytes(), cname
    # the column subsets the ported queries read are the full tables'
    # columns (strings by value: an object array's bytes are pointers)
    sub = tcorpus.corpus_tables(sf, seed)
    for name, t in sub.items():
        full = got[name].generate_table(sf, seed)
        for cname, c in zip(t.names, t.columns):
            want = _col(full, cname).data
            if want.dtype == object:
                assert list(c.data) == list(want), cname
            else:
                assert c.data.tobytes() == want.tobytes(), cname


# ---------------------------------------------------------------------------
# q2 and q8 as the corpus writes them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sf", SCALES)
def test_q2_and_q8_match_reference(sf, seed):
    jtabs, ttabs = _tables(sf, seed)
    jq = jbuild_queries(TpuSession(), jtabs)
    tq = tcorpus.build_queries(TorchSession(device="cpu"), ttabs)
    got8 = _as_reference(tq["q8"]().collect_table())
    ref8 = jq["q8"]().collect_table()
    assert tables_differ(got8, ref8) is None
    assert got8.num_rows == 1 and got8.columns[0].data[0] > 0
    got2 = _as_reference(tq["q2"]().collect_table())
    ref2 = jq["q2"]().collect_table()
    assert tables_close(got2, ref2, rtol=1e-9) is None
    assert got2.num_rows == 1 and got2.columns[0].validity.all()


def test_other_corpus_queries_raise_naming_them():
    """Every corpus query is ported, the window queries (q6, q21) and the
    exchange query (q7) last; a name outside the corpus is a KeyError."""
    tq = tcorpus.build_queries(TorchSession(device="cpu"), {})
    assert sorted(tq) == sorted(f"q{i}" for i in range(1, 23))
    assert sorted(tcorpus.PORTED) == sorted(tq)
    for name in ("q23", "q0"):
        with pytest.raises(KeyError, match=name):
            tq[name]


def _sparse_custkey(tabs):
    names, types, arrays = _arrays_of(tabs["orders"])
    out = []
    for n, (d, v) in zip(names, arrays):
        if n == "o_custkey":
            d = (d.astype(np.int64) * 0x9E3779B1) & ((1 << 40) - 1)
        out.append((d, v))
    return names, types, out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sf", SCALES)
@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_q8_inner_matches_reference(form, sf, seed):
    """q8's group-by before the count: max(o_totalprice) per o_custkey."""
    jtabs, ttabs = _tables(sf, seed)
    if form == "dense":
        jo, to = jtabs["orders"], ttabs["orders"]
    else:
        jo, to = _both(_sparse_custkey(ttabs))
    ref = jfrom(jo, TpuSession()).group_by("o_custkey").agg(
        JF.max("o_totalprice").alias("m")).collect_table()
    got = tfrom(to, TorchSession(device="cpu")).group_by("o_custkey").agg(
        TF.max("o_totalprice").alias("m")).collect_table()
    assert tables_differ_unordered(_as_reference(got), ref) is None
    assert got.num_rows == len(np.unique(_col(to, "o_custkey").data))


# ---------------------------------------------------------------------------
# MIN/MAX group-bys over INT, DATE, LONG and DOUBLE
# ---------------------------------------------------------------------------

def _minmax_table(seed, n, nan):
    """A key (LONG, a small domain, some null), and INT, DATE, LONG and
    DOUBLE values with nulls and edges: INT and LONG extremes, -0.0 and
    0.0 in one group, +-inf, and with ``nan`` NaN beside numbers and an
    all-NaN group. The last key value's rows are all null."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 40, n).astype(np.int64)
    kv = rng.random(n) > 0.05
    i32 = rng.integers(-(2 ** 31), 2 ** 31, n).astype(np.int32)
    i32[:2] = [2 ** 31 - 1, -(2 ** 31)]
    date = rng.integers(0, 20000, n).astype(np.int32)
    i64 = rng.integers(-(2 ** 62), 2 ** 62, n).astype(np.int64)
    i64[2:4] = [2 ** 63 - 1, -(2 ** 63)]
    f64 = rng.standard_normal(n) * 1e6
    k[10:14], kv[10:14] = 37, True
    f64[10:14] = [-0.0, 0.0, 0.0, -0.0]
    f64[20:22] = [np.inf, -np.inf]
    if nan:
        f64[30:33] = np.nan
        k[40:44], kv[40:44] = 38, True
        f64[40:44] = [np.nan, -np.nan, np.nan, np.nan]
    valids = [rng.random(n) > 0.1 for _ in range(4)]
    for v in valids:
        v[k == 39] = False
        v[10:14] = v[40:44] = True
    return (["k", "i", "d", "l", "f"],
            ["bigint", "int", "date", "bigint", "double"],
            [(k, kv), (i32, valids[0]), (date, valids[1]), (i64, valids[2]),
             (f64, valids[3])])


def _minmax_aggs(F):
    out = []
    for c in ("i", "d", "l", "f"):
        out += [F.min(c).alias(f"min_{c}"), F.max(c).alias(f"max_{c}")]
    return out + [F.count("f").alias("n_f"), F.count().alias("n")]


def _sparse_k(arrays_of_table):
    names, types, arrays = arrays_of_table
    k, kv = arrays[0]
    return (names, types,
            [((k * 0x9E3779B1) & ((1 << 40) - 1), kv)] + arrays[1:])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("form", ["dense", "sparse"])
@pytest.mark.parametrize("nan", [False, True], ids=["numbers", "nan"])
def test_minmax_groupby_matches_reference(nan, form, seed):
    """dense: the int-domain no-sort layout; sparse: the sort-segment
    path with nseg = capacity."""
    arrays = _minmax_table(seed, 5000, nan)
    if form == "sparse":
        arrays = _sparse_k(arrays)
    jt, tt = _both(arrays)
    ref = jfrom(jt, TpuSession(SPLIT if nan else None)).group_by("k").agg(
        *_minmax_aggs(JF)).collect_table()
    got = tfrom(tt, TorchSession(device="cpu")).group_by("k").agg(
        *_minmax_aggs(TF)).collect_table()
    assert tables_differ_unordered(_as_reference(got), ref) is None
    assert [c.dtype.simple_string() for c in got.columns][1:9] == \
        ["int", "int", "date", "date", "bigint", "bigint", "double",
         "double"]


# ---------------------------------------------------------------------------
# the global aggregate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "conf", [None, {"spark.rapids.tpu.agg.maxDictGroups": "0"}],
    ids=["no-sort", "sort-segment"])
@pytest.mark.parametrize("keep", ["all-dropping", "some"])
def test_global_aggregate_matches_reference(keep, conf):
    """One output row whatever the filter keeps: count 0 and every
    SUM/AVG/MIN/MAX null when it keeps nothing. With maxDictGroups 0 the
    reference takes its sort-segment path, and the port keeps its
    one-segment layout (a difference of route, not of result)."""
    names, types, arrays = _minmax_table(3, 3000, False)
    jt, tt = _both((names, types, arrays))
    cut = -1 if keep == "all-dropping" else 20

    def q(F, frm, sess, t):
        return (frm(t, sess).filter(F.col("k") < F.lit(cut))
                .agg(F.sum("f").alias("s"), F.avg("f").alias("a"),
                     *_minmax_aggs(F)))

    ref = q(JF, jfrom, TpuSession(conf), jt).collect_table()
    got = _as_reference(q(TF, tfrom, TorchSession(conf, device="cpu"),
                          tt).collect_table())
    assert got.num_rows == 1
    exact = [n for n in got.names if n not in ("s", "a")]

    def sub(t):
        return JHostTable(exact, [t.column(n) for n in exact])

    assert tables_differ(sub(got), sub(ref)) is None
    assert tables_close(got, ref, rtol=1e-9) is None
    if keep == "all-dropping":
        assert [c.to_pylist()[0] for c in got.columns] == \
            [None] * 10 + [0, 0]


@pytest.mark.parametrize("max_dict_groups", ["0", "65536"])
def test_global_aggregate_never_sorts(monkeypatch, max_dict_groups):
    """The global aggregate is the one-segment no-sort layout whatever
    maxDictGroups is: it has no groups to sort."""
    from spark_rapids_tpu_torch.execs.aggregate import TpuHashAggregateExec

    def no_sort(*args, **kwargs):
        raise AssertionError("the global aggregate took the sort path")

    monkeypatch.setattr(TpuHashAggregateExec, "_sort_kernel", no_sort)
    names, types, arrays = _minmax_table(5, 1000, False)
    _, tt = _both((names, types, arrays))
    sess = TorchSession({"spark.rapids.tpu.agg.maxDictGroups":
                         max_dict_groups}, device="cpu")
    got = tfrom(tt, sess).agg(TF.count("k").alias("n"),
                              TF.max("k").alias("m")).collect_table()
    k, kv = arrays[0]
    assert [c.to_pylist() for c in got.columns] == \
        [[int(kv.sum())], [int(k[kv].max())]]
