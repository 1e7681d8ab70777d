"""The golden ScaleTest corpus through the port (port of
``scale_test.py::build_queries``, as far as the port runs it): q2 and q8,
written exactly as the reference writes them, over the tables of
``datagen.scale_test_specs``. Any other corpus query raises
NotImplementedError naming it."""

from __future__ import annotations

from typing import Dict

from spark_rapids_tpu_torch.columnar import HostTable
from spark_rapids_tpu_torch.datagen import scale_test_specs

#: the corpus's query names (scale_test.py: q1-q22)
CORPUS = tuple(f"q{i}" for i in range(1, 23))
#: the queries the port runs
PORTED = ("q2", "q8")
#: the columns q2 and q8 read, by table
COLUMNS = {
    "orders": ("o_orderkey", "o_custkey", "o_totalprice"),
    "lineitem": ("l_orderkey", "l_quantity", "l_extendedprice",
                 "l_discount"),
}


class Queries(dict):
    """{name: () -> DataFrame} of the ported queries; looking up another
    corpus query raises NotImplementedError naming it."""

    def __missing__(self, name):
        if name in CORPUS:
            raise NotImplementedError(
                f"corpus query {name} is not ported (the port runs "
                f"{', '.join(PORTED)})")
        raise KeyError(name)


def build_queries(s, tables: Dict[str, HostTable]) -> Queries:
    """The corpus queries the port runs, over ``tables`` ({name:
    HostTable}) through session ``s``."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.ops.expr import col, lit
    from spark_rapids_tpu_torch.plan import from_host_table

    orders = lambda: from_host_table(tables["orders"], s)  # noqa: E731
    li = lambda: from_host_table(tables["lineitem"], s)    # noqa: E731

    def q2():  # filter + project arithmetic
        return (li().filter((col("l_discount") > lit(0.05))
                            & (col("l_quantity") < lit(25)))
                .select((col("l_extendedprice") * col("l_discount"))
                        .alias("revenue"))
                .agg(F.sum("revenue").alias("total")))

    def q8():  # distinct-ish: group by high-cardinality key
        return (orders().group_by("o_custkey")
                .agg(F.max("o_totalprice").alias("m"))
                .agg(F.count("m").alias("n_custs")))

    return Queries(q2=q2, q8=q8)


def corpus_tables(scale_factor: float, seed: int) -> Dict[str, HostTable]:
    """The ScaleTest tables q2 and q8 read at ``scale_factor`` and ``seed``,
    each with only the ``COLUMNS`` named for it. Every column is generated
    from its own seed stream, so a column's values do not depend on which
    other columns are generated."""
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
