"""TPC-H q1 through the port's engine (port of the lineitem/q1 part of
``spark_rapids_tpu/models/tpch.py``). The generator is the reference's,
draw for draw, so one seed gives the same table in both packages."""

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
