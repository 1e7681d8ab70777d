"""TPC-H q1 and q3 through the port's engine, as DataFrames and as SQL
text (port of the lineitem/q1 and q3 parts of
``spark_rapids_tpu/models/tpch.py``). The generators are the
reference's, draw for draw, so one seed gives the same tables in both
packages."""

from __future__ import annotations

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable

RETURNFLAGS = np.array(["A", "N", "R"], dtype=object)
LINESTATUS = np.array(["F", "O"], dtype=object)
Q1_CUTOFF_DAYS = 10471  # 1998-09-02 as days since epoch
NUM_Q1_GROUPS = 8  # 3 flags x 2 statuses padded to a static bound


def lineitem_table(num_rows: int, seed: int = 0) -> HostTable:
    """Deterministic lineitem-ish generator (datagen analog)."""
    rng = np.random.default_rng(seed)
    qty = rng.integers(1, 51, size=num_rows).astype(np.float64)
    price = (rng.random(num_rows) * 100000.0).round(2)
    disc = (rng.integers(0, 11, size=num_rows) / 100.0)
    tax = (rng.integers(0, 9, size=num_rows) / 100.0)
    rf = RETURNFLAGS[rng.integers(0, 3, size=num_rows)]
    ls = LINESTATUS[rng.integers(0, 2, size=num_rows)]
    ship = rng.integers(8766, 10957, size=num_rows).astype(np.int32)  # 1994..1999
    cols = {
        "l_quantity": HostColumn(T.DOUBLE, qty),
        "l_extendedprice": HostColumn(T.DOUBLE, price),
        "l_discount": HostColumn(T.DOUBLE, disc),
        "l_tax": HostColumn(T.DOUBLE, tax),
        "l_returnflag": HostColumn(T.STRING, rf),
        "l_linestatus": HostColumn(T.STRING, ls),
        "l_shipdate": HostColumn(T.DATE, ship),
    }
    return HostTable(list(cols.keys()), list(cols.values()))


def q1_dataframe(session, table: HostTable, num_batches: int = 1):
    """TPC-H q1: filter -> project -> group-by aggregate -> sort."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.ops.expr import col, lit
    from spark_rapids_tpu_torch.plan import from_host_table

    df = from_host_table(table, session, num_batches)
    return (
        df.filter(col("l_shipdate") <= lit(Q1_CUTOFF_DAYS, T.DATE))
        .select(
            col("l_returnflag"), col("l_linestatus"), col("l_quantity"),
            col("l_extendedprice"), col("l_discount"),
            (col("l_extendedprice") * (lit(1.0) - col("l_discount"))).alias("disc_price"),
            (col("l_extendedprice") * (lit(1.0) - col("l_discount"))
             * (lit(1.0) + col("l_tax"))).alias("charge"),
        )
        .group_by("l_returnflag", "l_linestatus")
        .agg(
            F.sum(F.col("l_quantity")).alias("sum_qty"),
            F.sum(F.col("l_extendedprice")).alias("sum_base_price"),
            F.sum(F.col("disc_price")).alias("sum_disc_price"),
            F.sum(F.col("charge")).alias("sum_charge"),
            F.avg(F.col("l_quantity")).alias("avg_qty"),
            F.avg(F.col("l_extendedprice")).alias("avg_price"),
            F.avg(F.col("l_discount")).alias("avg_disc"),
            F.count().alias("count_order"),
        )
        .sort("l_returnflag", "l_linestatus")
    )


#: q1 as SQL text (the reference's ``Q1_SQL``, text for text): lowers onto
#: the same plan shape as q1_dataframe (Sort over Aggregate over Project
#: over Filter)
Q1_SQL = """
SELECT l_returnflag, l_linestatus,
       SUM(l_quantity) AS sum_qty,
       SUM(l_extendedprice) AS sum_base_price,
       SUM(disc_price) AS sum_disc_price,
       SUM(charge) AS sum_charge,
       AVG(l_quantity) AS avg_qty,
       AVG(l_extendedprice) AS avg_price,
       AVG(l_discount) AS avg_disc,
       COUNT(*) AS count_order
FROM (SELECT l_returnflag, l_linestatus, l_quantity, l_extendedprice,
             l_discount,
             l_extendedprice * (1.0 - l_discount) AS disc_price,
             l_extendedprice * (1.0 - l_discount) * (1.0 + l_tax) AS charge
      FROM lineitem
      WHERE l_shipdate <= DATE '1998-09-02')
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
"""


def q1_sql(session, table: HostTable, num_batches: int = 1):
    """q1 from SQL text through ``session.sql()`` over a ``lineitem`` temp
    view; plans as q1_dataframe does."""
    from spark_rapids_tpu_torch.plan import from_host_table
    from_host_table(table, session, num_batches)\
        .create_or_replace_temp_view("lineitem")
    return session.sql(Q1_SQL)


# ---------------------------------------------------------------------------
# q3: customer JOIN orders JOIN lineitem with filters, a group-by and a
# top-10 by revenue
# ---------------------------------------------------------------------------

SEGMENTS = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD",
                     "MACHINERY"], dtype=object)
Q3_DATE = 9204  # 1995-03-15


def q3_tables(num_rows: int, seed: int = 0):
    """lineitem (num_rows), orders (num_rows // 4), customer
    (num_rows // 40). Keys are dense: ``np.arange`` for the primary keys,
    uniform draws over them for the foreign keys."""
    rng = np.random.default_rng(seed)
    n_ord = max(num_rows // 4, 1)
    n_cust = max(num_rows // 40, 1)

    cust = HostTable(["c_custkey", "c_mktsegment"], [
        HostColumn(T.LONG, np.arange(n_cust, dtype=np.int64)),
        HostColumn(T.STRING, SEGMENTS[rng.integers(0, len(SEGMENTS), n_cust)]),
    ])
    orders = HostTable(["o_orderkey", "o_custkey", "o_orderdate"], [
        HostColumn(T.LONG, np.arange(n_ord, dtype=np.int64)),
        HostColumn(T.LONG, rng.integers(0, n_cust, n_ord)),
        HostColumn(T.DATE, rng.integers(8766, 9855, n_ord).astype(np.int32)),
    ])
    lineitem = HostTable(
        ["l_orderkey", "l_extendedprice", "l_discount", "l_shipdate"], [
            HostColumn(T.LONG, rng.integers(0, n_ord, num_rows)),
            HostColumn(T.DOUBLE, (rng.random(num_rows) * 100000.0).round(2)),
            HostColumn(T.DOUBLE, rng.integers(0, 11, num_rows) / 100.0),
            HostColumn(T.DATE,
                       rng.integers(8766, 9855, num_rows).astype(np.int32)),
        ])
    return cust, orders, lineitem


def P_REV_DESC():
    from spark_rapids_tpu_torch.ops.expr import col
    from spark_rapids_tpu_torch.plan.nodes import SortOrder
    return SortOrder(col("revenue"), ascending=False)


def q3_dataframe(session, cust, orders, lineitem, segment: str = "BUILDING"):
    """TPC-H q3: two inner joins, a group-by on l_orderkey, the top 10 by
    revenue."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.ops.expr import col, lit
    from spark_rapids_tpu_torch.plan import from_host_table

    c = from_host_table(cust, session).filter(
        col("c_mktsegment") == lit(segment))
    o = from_host_table(orders, session).filter(
        col("o_orderdate") < lit(Q3_DATE, T.DATE))
    li = from_host_table(lineitem, session).filter(
        col("l_shipdate") > lit(Q3_DATE, T.DATE))
    joined = (li.join(o.with_column("l_orderkey", col("o_orderkey")),
                      on="l_orderkey", how="inner")
              .join(c.with_column("o_custkey", col("c_custkey")),
                    on="o_custkey", how="inner"))
    return (joined
            .select(col("l_orderkey"), col("o_orderdate"),
                    (col("l_extendedprice") * (lit(1.0) - col("l_discount")))
                    .alias("volume"))
            .group_by("l_orderkey")
            .agg(F.sum(col("volume")).alias("revenue"),
                 F.count().alias("n"))
            .sort(P_REV_DESC())
            .limit(10))


#: q3 as SQL text (the reference's ``Q3_SQL``, text for text); nested
#: selects mirror the filter/with_column/join chain of q3_dataframe
Q3_SQL = """
SELECT l_orderkey, SUM(volume) AS revenue, COUNT(*) AS n FROM (
    SELECT l_orderkey, o_orderdate,
           l_extendedprice * (1.0 - l_discount) AS volume
    FROM (SELECT * FROM lineitem WHERE l_shipdate > DATE '1995-03-15')
    JOIN (SELECT *, o_orderkey AS l_orderkey
          FROM orders WHERE o_orderdate < DATE '1995-03-15')
      USING (l_orderkey)
    JOIN (SELECT *, c_custkey AS o_custkey
          FROM customer WHERE c_mktsegment = '{segment}')
      USING (o_custkey))
GROUP BY l_orderkey
ORDER BY revenue DESC LIMIT 10
"""


def q3_sql(session, cust, orders, lineitem, segment: str = "BUILDING"):
    """q3 from SQL text through ``session.sql()`` over ``customer``,
    ``orders`` and ``lineitem`` temp views; plans as q3_dataframe does."""
    from spark_rapids_tpu_torch.plan import from_host_table
    from_host_table(cust, session).create_or_replace_temp_view("customer")
    from_host_table(orders, session).create_or_replace_temp_view("orders")
    from_host_table(lineitem, session)\
        .create_or_replace_temp_view("lineitem")
    return session.sql(Q3_SQL.format(segment=segment))
