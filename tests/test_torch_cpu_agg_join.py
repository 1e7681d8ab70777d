"""The CPU route's aggregate and join (plan/cpu_agg.py, plan/cpu_join.py)
against the JAX package's ``aggregate_cpu`` and ``join_cpu`` on the same
seeded rows and the same plan (each package's DataFrame binds the
expressions): every aggregate function over integer, string and null
keys and a global aggregate, and every join type on integer and string
keys with nulls, a residual condition and a keyless condition.
Comparators: ``tests/torch_nested.py::nested_differ`` (exact: the same
first-occurrence group order and gather order, every bit; collect
results too), and against the port's device path
``scale_test.tables_close`` (f64 sums rtol 1e-9) over the rows as a
multiset (``tables_differ_unordered`` where nothing is a float)."""

import numpy as np
import pytest

from scale_test import tables_close
from spark_rapids_tpu.plan.cpu_agg import aggregate_cpu as ref_aggregate
from spark_rapids_tpu.plan.cpu_join import join_cpu as ref_join
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as TT
from spark_rapids_tpu_torch.plan.cpu_agg import aggregate_cpu
from spark_rapids_tpu_torch.plan.cpu_join import join_cpu
from spark_rapids_tpu_torch.session import TorchSession
from tests.torch_nested import PORT, REF, as_reference, nested_differ, tables

N = 300


def _data(seed=4, n=N):
    rng = np.random.default_rng(seed)

    def nulls(vals, p=0.1):
        return [None if rng.random() < p else v for v in vals]
    return tables([
        ("ki", TT.INT, nulls(rng.integers(0, 12, n).tolist())),
        ("ks", TT.STRING, nulls([f"k{x}" for x in rng.integers(0, 7, n)])),
        ("vl", TT.LONG, nulls(rng.integers(-10**9, 10**9, n).tolist())),
        ("vd", TT.DOUBLE, nulls((rng.standard_normal(n) * 100).tolist())),
        ("vs", TT.STRING, nulls([f"s{x:03d}" for x in
                                 rng.integers(0, 500, n)])),
        ("vm", TT.DecimalType(12, 2), nulls(rng.integers(-10**6, 10**6,
                                                         n).tolist())),
    ])


AGGS = {
    "count_star": lambda a: a.F.count(),
    "count": lambda a: a.F.count(a.col("vl")),
    "sum_long": lambda a: a.F.sum("vl"),
    "sum_double": lambda a: a.F.sum("vd"),
    "sum_decimal": lambda a: a.F.sum("vm"),
    "avg": lambda a: a.F.avg("vd"),
    "avg_decimal": lambda a: a.F.avg("vm"),
    "min_long": lambda a: a.F.min("vl"),
    "max_double": lambda a: a.F.max("vd"),
    "min_string": lambda a: a.F.min("vs"),
    "max_decimal": lambda a: a.F.max("vm"),
    "first": lambda a: a.F.first("vl"),
    "last": lambda a: a.F.last("vs"),
    "variance": lambda a: a.F.variance("vd"),
    "stddev_pop": lambda a: a.F.stddev_pop("vd"),
    "collect_list": lambda a: a.F.collect_list("vl"),
    "collect_set": lambda a: a.F.collect_set("vl"),
    "percentile": lambda a: a.F.percentile("vd", 0.25),
}


def _agg_plan(a, df, keys, fn):
    return df.group_by(*keys).agg(AGGS[fn](a).alias("x")).plan


@pytest.mark.parametrize("keys", [("ki",), ("ks",), ("ki", "ks"), ()],
                         ids=["int", "string", "both", "global"])
@pytest.mark.parametrize("fn", list(AGGS))
def test_aggregate_cpu_equals_the_reference(fn, keys):
    jt, tt = _data()
    jplan = _agg_plan(REF, REF.frm(jt, TpuSession()), keys, fn)
    tplan = _agg_plan(PORT, PORT.frm(tt, TorchSession(device="cpu")),
                      keys, fn)
    want = ref_aggregate(jt, jplan.grouping, jplan.agg_specs)
    got = aggregate_cpu(tt, tplan.grouping, tplan.agg_specs)
    assert nested_differ(want, got) is None, nested_differ(want, got)


@pytest.mark.parametrize("fn", ["count", "sum_long", "sum_double", "avg",
                                "min_string", "max_decimal", "variance"])
def test_aggregate_cpu_equals_the_device(fn):
    """The CPU route's Aggregate (``spark.rapids.sql.exec.Aggregate`` off)
    against the port's device aggregate: the same groups."""
    jt, tt = _data(seed=9)
    out = []
    for conf in (None, {"spark.rapids.sql.exec.Aggregate": "false"}):
        s = TorchSession(conf, device="cpu")
        out.append(as_reference(PORT.frm(tt, s).group_by("ki").agg(
            AGGS[fn](PORT).alias("x")).sort("ki").collect_table()))
    assert tables_close(out[0], out[1], rtol=1e-9) is None


JOIN_TYPES = ["inner", "cross", "left", "right", "full", "leftsemi",
              "leftanti"]


def _join_nodes(nodes_mod, a, ldf, rdf, how, key, cond):
    """A Join plan node of each package: equi keys ``key`` (none for a
    cross join), and a residual ``vl < vl2`` when ``cond``."""
    r = rdf.select(*[a.col(n).alias(n + "2") for n in
                     ("ki", "ks", "vl", "vd")])
    lkeys = [] if how == "cross" else [a.col(key)]
    rkeys = [] if how == "cross" else [a.col(key + "2")]
    condition = (a.col("vl") < a.col("vl2")) if cond else None
    return nodes_mod.Join(ldf.select("ki", "ks", "vl", "vd").plan, r.plan,
                          how, lkeys, rkeys, condition)


@pytest.mark.parametrize("cond", [False, True], ids=["keys", "residual"])
@pytest.mark.parametrize("key", ["ki", "ks"])
@pytest.mark.parametrize("how", JOIN_TYPES)
def test_join_cpu_equals_the_reference(how, key, cond):
    from spark_rapids_tpu.plan import nodes as JP
    from spark_rapids_tpu_torch.plan import nodes as TP
    jl, tl = _data(seed=1, n=120)
    jr, tr = _data(seed=2, n=90)
    js, ts = TpuSession(), TorchSession(device="cpu")
    jn = _join_nodes(JP, REF, REF.frm(jl, js), REF.frm(jr, js), how, key,
                     cond)
    tn = _join_nodes(TP, PORT, PORT.frm(tl, ts), PORT.frm(tr, ts), how, key,
                     cond)
    want = ref_join(jn.children[0].collect_cpu(),
                    jn.children[1].collect_cpu(), how, jn.left_keys,
                    jn.right_keys, jn.condition)
    got = join_cpu(tn.children[0].collect_cpu(),
                   tn.children[1].collect_cpu(), tn.join_type, tn.left_keys,
                   tn.right_keys, tn.condition)
    assert nested_differ(want, got) is None, nested_differ(want, got)


@pytest.mark.parametrize("how", ["inner", "left", "full", "leftsemi",
                                 "leftanti"])
def test_join_cpu_equals_the_device(how):
    """The CPU route's Join (``spark.rapids.sql.exec.Join`` off) against
    the port's device join, the rows as a multiset."""
    from scale_test import tables_differ_unordered
    _, tl = _data(seed=1, n=120)
    _, tr = _data(seed=2, n=90)
    out = []
    for conf in (None, {"spark.rapids.sql.exec.Join": "false"}):
        s = TorchSession(conf, device="cpu")
        r = PORT.frm(tr, s).select(*[PORT.col(n).alias(n + "2")
                                     for n in ("ki", "ks", "vl")])
        df = PORT.frm(tl, s).select("ki", "ks", "vl").join(
            r.with_column("ki", PORT.col("ki2")), on="ki", how=how)
        out.append(as_reference(df.collect_table()))
    assert tables_differ_unordered(out[0], out[1]) is None
