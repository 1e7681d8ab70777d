"""The golden ScaleTest corpus through the port (port of
``scale_test.py::build_queries``): all 22 of its queries, each written
exactly as the reference writes it, over the tables of
``datagen.scale_test_specs``. Looking up a name outside the corpus raises
KeyError."""

from __future__ import annotations

from typing import Dict

from spark_rapids_tpu_torch.columnar import HostTable
from spark_rapids_tpu_torch.datagen import scale_test_specs

#: the corpus's query names (scale_test.py: q1-q22)
CORPUS = tuple(f"q{i}" for i in range(1, 23))
#: the queries the port runs: all of them
PORTED = CORPUS
#: the columns the ported queries read, by table
COLUMNS = {
    "customer": ("c_custkey", "c_name", "c_nationkey", "c_acctbal"),
    "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"),
    "lineitem": ("l_orderkey", "l_quantity", "l_extendedprice",
                 "l_discount", "l_returnflag", "l_linestatus",
                 "l_shipdate"),
}


class Queries(dict):
    """{name: () -> DataFrame} of the corpus queries; any other name
    raises KeyError."""

    def __missing__(self, name):
        raise KeyError(name)


def build_queries(s, tables: Dict[str, HostTable]) -> Queries:
    """The corpus queries the port runs, over ``tables`` ({name:
    HostTable}) through session ``s``."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.ops.expr import col, lit
    from spark_rapids_tpu_torch.plan import from_host_table

    cust = lambda: from_host_table(tables["customer"], s)  # noqa: E731
    orders = lambda: from_host_table(tables["orders"], s)  # noqa: E731
    li = lambda: from_host_table(tables["lineitem"], s)    # noqa: E731

    def q1():  # pricing summary (TPC-H q1 shape)
        import datetime as _dt
        cutoff = _dt.date(1970, 1, 1) + _dt.timedelta(days=10500)
        return (li().filter(col("l_shipdate") <= lit(cutoff))
                .group_by("l_returnflag", "l_linestatus")
                .agg(F.sum("l_quantity").alias("sum_qty"),
                     F.sum("l_extendedprice").alias("sum_base"),
                     F.avg("l_discount").alias("avg_disc"),
                     F.count("l_quantity").alias("cnt")))

    def q2():  # filter + project arithmetic
        return (li().filter((col("l_discount") > lit(0.05))
                            & (col("l_quantity") < lit(25)))
                .select((col("l_extendedprice") * col("l_discount"))
                        .alias("revenue"))
                .agg(F.sum("revenue").alias("total")))

    def q3():  # join orders->lineitem + agg
        oj = orders().select("o_orderkey", "o_custkey", "o_orderdate")
        j = li().join(oj.with_column("l_orderkey", col("o_orderkey")),
                      on=["l_orderkey"], how="inner")
        return (j.group_by("o_custkey")
                .agg(F.sum("l_extendedprice").alias("spend"),
                     F.count("l_quantity").alias("items")))

    def q4():  # two-level join: customer -> orders -> lineitem
        oj = orders().select("o_orderkey", "o_custkey")
        cj = cust().select("c_custkey", "c_nationkey")
        j1 = (li().select("l_orderkey", "l_extendedprice")
              .join(oj.with_column("l_orderkey", col("o_orderkey")),
                    on=["l_orderkey"], how="inner"))
        j2 = j1.with_column("c_custkey", col("o_custkey")).join(
            cj, on=["c_custkey"], how="inner")
        return (j2.group_by("c_nationkey")
                .agg(F.sum("l_extendedprice").alias("rev")))

    def q5():  # sort + limit (TakeOrderedAndProject)
        return (orders().sort("o_totalprice", ascending=False).limit(100))

    def q6():  # window: rank orders per customer by price
        from spark_rapids_tpu_torch.functions import row_number
        from spark_rapids_tpu_torch.ops.window import Window as W
        return orders().with_windows(
            rn=row_number().over(
                W.partition_by("o_custkey").order_by("o_totalprice")))\
            .filter(col("rn") <= lit(3))

    def q7():  # repartition + agg (shuffle exercise)
        return (li().repartition(8, "l_returnflag")
                .group_by("l_returnflag")
                .agg(F.count("l_quantity").alias("c"),
                     F.sum("l_quantity").alias("s")))

    def q8():  # distinct-ish: group by high-cardinality key
        return (orders().group_by("o_custkey")
                .agg(F.max("o_totalprice").alias("m"))
                .agg(F.count("m").alias("n_custs")))

    def q9():  # TPC-H q5-like: 2-level join + filters + group + topk
        import datetime as _dt
        cut = _dt.date(1970, 1, 1) + _dt.timedelta(days=9000)
        cj = cust().select("c_custkey", "c_nationkey")
        oj = (orders().filter(col("o_orderdate") >= lit(cut))
              .select("o_orderkey", "o_custkey"))
        j1 = (li().select("l_orderkey", "l_extendedprice", "l_discount")
              .join(oj.with_column("l_orderkey", col("o_orderkey")),
                    on=["l_orderkey"], how="inner"))
        j2 = j1.with_column("c_custkey", col("o_custkey")).join(
            cj, on=["c_custkey"], how="inner")
        return (j2.select(col("c_nationkey"),
                          (col("l_extendedprice")
                           * (lit(1.0) - col("l_discount"))).alias("rev"))
                .group_by("c_nationkey")
                .agg(F.sum("rev").alias("revenue"))
                .sort("revenue", ascending=False).limit(10))

    def q10():  # TPC-H q17-like: join against an aggregated subquery
        avg_q = (li().group_by("l_orderkey")
                 .agg(F.avg("l_quantity").alias("avg_qty")))
        j = li().select("l_orderkey", "l_quantity", "l_extendedprice")\
            .join(avg_q, on=["l_orderkey"], how="inner")
        return (j.filter(col("l_quantity").cast("double")
                         < lit(0.6) * col("avg_qty"))
                .agg(F.sum("l_extendedprice").alias("total")))

    def q11():  # TPC-H q11-like: per-nation balance totals over a floor
        agged = (cust().group_by("c_nationkey")
                 .agg(F.sum("c_acctbal").alias("total_bal"),
                      F.count("c_custkey").alias("n")))
        return (agged.filter(col("n") > lit(5))
                .sort("total_bal", ascending=False))

    def q12():  # TPC-H q12-like: date-window join + per-flag counts
        import datetime as _dt
        lo = _dt.date(1970, 1, 1) + _dt.timedelta(days=9000)
        hi = _dt.date(1970, 1, 1) + _dt.timedelta(days=10000)
        lj = (li().filter((col("l_shipdate") >= lit(lo))
                          & (col("l_shipdate") < lit(hi)))
              .select("l_orderkey", "l_returnflag"))
        oj = orders().select("o_orderkey", "o_totalprice")
        j = lj.join(oj.with_column("l_orderkey", col("o_orderkey")),
                    on=["l_orderkey"], how="inner")
        return (j.group_by("l_returnflag")
                .agg(F.count("l_orderkey").alias("n"),
                     F.avg("o_totalprice").alias("avg_price")))

    def q13():  # TPC-H q13-like: customer order-count distribution
        per_cust = (orders().group_by("o_custkey")
                    .agg(F.count("o_orderkey").alias("c_orders")))
        return (per_cust.group_by("c_orders")
                .agg(F.count("o_custkey").alias("n_custs"))
                .sort("c_orders"))

    def q14():  # TPC-H q14-like: windowed revenue ratio
        import datetime as _dt
        lo = _dt.date(1970, 1, 1) + _dt.timedelta(days=9500)
        hi = _dt.date(1970, 1, 1) + _dt.timedelta(days=9700)
        f = (li().filter((col("l_shipdate") >= lit(lo))
                         & (col("l_shipdate") < lit(hi)))
             .select((col("l_extendedprice")
                      * (lit(1.0) - col("l_discount"))).alias("rev")))
        agged = f.agg(F.sum("rev").alias("total_rev"),
                      F.count("rev").alias("n"))
        return agged.select((col("total_rev") / col("n")).alias("avg_rev"),
                            col("total_rev"))

    def q15():  # TPC-H q15-like: top revenue customers
        oj = orders().select("o_orderkey", "o_custkey")
        j = (li().select("l_orderkey", "l_extendedprice", "l_discount")
             .join(oj.with_column("l_orderkey", col("o_orderkey")),
                   on=["l_orderkey"], how="inner"))
        return (j.select(col("o_custkey"),
                         (col("l_extendedprice")
                          * (lit(1.0) - col("l_discount"))).alias("rev"))
                .group_by("o_custkey").agg(F.sum("rev").alias("revenue"))
                .sort("revenue", ascending=False).limit(5))

    def q16():  # TPC-H q16-like: active customers per nation
        oc = (orders().select("o_custkey").group_by("o_custkey")
              .agg(F.count("o_custkey").alias("x")))
        j = oc.with_column("c_custkey", col("o_custkey")).join(
            cust().select("c_custkey", "c_nationkey"),
            on=["c_custkey"], how="inner")
        return (j.group_by("c_nationkey")
                .agg(F.count("c_custkey").alias("active_custs"))
                .sort("c_nationkey"))

    def q17():  # TPC-H q17-like: below-average-quantity revenue
        avg_q = (li().group_by("l_orderkey")
                 .agg(F.avg("l_quantity").alias("aq")))
        j = (li().select("l_orderkey", "l_quantity", "l_extendedprice")
             .join(avg_q, on=["l_orderkey"], how="inner"))
        return (j.filter(col("l_quantity").cast("double")
                         < lit(0.5) * col("aq"))
                .agg(F.sum("l_extendedprice").alias("s"))
                .select((col("s") / lit(7.0)).alias("avg_yearly")))

    def q18():  # TPC-H q18-like: large-volume orders
        big = (li().group_by("l_orderkey")
               .agg(F.sum("l_quantity").alias("sum_qty"))
               .filter(col("sum_qty") > lit(150)))
        j = big.with_column("o_orderkey", col("l_orderkey")).join(
            orders().select("o_orderkey", "o_custkey", "o_totalprice"),
            on=["o_orderkey"], how="inner")
        return (j.select("l_orderkey", "sum_qty", "o_custkey",
                         "o_totalprice")
                .sort("o_totalprice", ascending=False).limit(20))

    def q19():  # TPC-H q19-like: disjunctive predicate revenue
        f = li().filter(
            ((col("l_quantity") >= lit(1)) & (col("l_quantity") <= lit(11))
             & (col("l_discount") > lit(0.02)))
            | ((col("l_quantity") >= lit(10))
               & (col("l_quantity") <= lit(20))
               & (col("l_discount") < lit(0.06)))
            | (col("l_returnflag") == lit("R00000001")))
        return (f.select((col("l_extendedprice")
                          * (lit(1.0) - col("l_discount"))).alias("rev"))
                .agg(F.sum("rev").alias("revenue")))

    def q20():  # TPC-H q20-like: customers with big orders
        per = (orders().filter(col("o_totalprice") > lit(400000.0))
               .select("o_custkey").group_by("o_custkey")
               .agg(F.count("o_custkey").alias("nbig")))
        j = per.with_column("c_custkey", col("o_custkey")).join(
            cust().select("c_custkey", "c_name", "c_acctbal"),
            on=["c_custkey"], how="inner")
        return (j.select("c_custkey", "nbig", "c_name", "c_acctbal")
                .sort("nbig", ascending=False).limit(10))

    def q21():  # TPC-H q21-like: per-nation top accounts via window rank
        from spark_rapids_tpu_torch.functions import row_number
        from spark_rapids_tpu_torch.ops.window import Window as W
        return (cust().with_windows(
            rn=row_number().over(
                W.partition_by("c_nationkey").order_by("c_custkey")))
            .filter(col("rn") <= lit(2))
            .select("c_nationkey", "c_custkey", "rn"))

    def q22():  # TPC-H q22-like: accounts above the global average
        avg_t = (cust().select(col("c_acctbal"))
                 .agg(F.avg("c_acctbal").alias("ab"))
                 .with_column("k", lit(1)))
        c = (cust().select("c_custkey", "c_nationkey", "c_acctbal")
             .with_column("k", lit(1)))
        j = c.join(avg_t, on=["k"], how="inner")
        return (j.filter(col("c_acctbal").cast("double") > col("ab"))
                .group_by("c_nationkey")
                .agg(F.count("c_custkey").alias("numcust"),
                     F.sum("c_acctbal").alias("totacctbal"))
                .sort("c_nationkey"))

    return Queries({name: fn for name, fn in locals().items()
                    if name in PORTED})


def corpus_tables(scale_factor: float, seed: int) -> Dict[str, HostTable]:
    """The ScaleTest tables the ported queries read at ``scale_factor`` and
    ``seed``, each with only the ``COLUMNS`` named for it. Every column is
    generated from its own seed stream, so a column's values do not depend
    on which other columns are generated."""
    specs = scale_test_specs(scale_factor)
    out = {}
    for name, want in COLUMNS.items():
        spec = specs[name]
        n = spec.rows_at(scale_factor)
        gens = [(c, g) for c, g in spec.columns if c in want]
        out[name] = HostTable([c for c, _ in gens],
                              [g.generate(n, seed, spec.name, c)
                               for c, g in gens])
    return out
