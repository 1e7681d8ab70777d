"""The port's Generate (plan/nodes.py::Generate, execs/generate.py, the
generator select of plan/dataframe.py) on ``TorchSession(device="cpu")``
against the JAX package's ``TpuSession`` over the same rows: the four
explodes over arrays of every element kind, requiredChildOutput pruning,
``stack``, ``sequence`` and ``replicate_rows``, and the SQL forms of the
generators and of the collection builtins.

Comparators: ``scale_test.tables_differ`` (bitwise, in order: one input
batch, the reference's order of the element rows, then the outer rows);
``tables_differ_unordered`` (the row multiset) for ``stack``, whose
order across the generated rows is unspecified. The reference sizes a
sequence's elements speculatively (rows x 4, raising past it); the port
sizes them exactly (one counted host read), so the sequences here stay
within the reference's bound."""

import numpy as np
import pytest

from scale_test import tables_differ, tables_differ_unordered
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import types as TT
from spark_rapids_tpu_torch.session import TorchSession
from tests.torch_nested import (
    PORT,
    as_reference,
    nested_differ,
    run_both,
    run_both_exact,
    tables,
)

ELEMENTS = {
    "bigint": (TT.LONG, lambda r: int(r.integers(-10**12, 10**12))),
    "int": (TT.INT, lambda r: int(r.integers(-1000, 1000))),
    "double": (TT.DOUBLE, lambda r: float(r.normal())),
    "date": (TT.DATE, lambda r: int(r.integers(8000, 12000))),
    "boolean": (TT.BOOLEAN, lambda r: bool(r.random() > 0.5)),
    "smallint": (TT.SHORT, lambda r: int(r.integers(-300, 300))),
}


@pytest.fixture(scope="module")
def sessions():
    return TpuSession(), TorchSession(device="cpu")


def _arrays(kind, n=300, seed=0):
    dt, draw = ELEMENTS[kind]
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        u = rng.random()
        if u < 0.1:
            rows.append(None)
        elif u < 0.2:
            rows.append([])
        else:
            rows.append([None if rng.random() < 0.1 else draw(rng)
                         for _ in range(int(rng.integers(1, 6)))])
    return tables([("id", TT.INT, list(range(n))),
                   ("g", TT.INT, rng.integers(0, 7, n).tolist()),
                   ("a", TT.ArrayType(dt), rows)])


def _check(build, tabs, sessions, ordered=True, nb=1):
    return run_both_exact(build, *tabs, *sessions, nb=nb, ordered=ordered)


GENS = ("explode", "posexplode", "explode_outer", "posexplode_outer")


@pytest.mark.parametrize("kind", list(ELEMENTS))
@pytest.mark.parametrize("gen", GENS)
def test_generator_over_every_element_kind(gen, kind, sessions):
    _check(lambda a, df: df.select(
        "id", getattr(a.F, gen)(a.col("a")).alias("e")),
        _arrays(kind), sessions)


@pytest.mark.parametrize("gen", GENS)
def test_generator_over_several_batches(gen, sessions):
    _check(lambda a, df: df.select(
        "g", getattr(a.F, gen)(a.col("a")).alias("e")),
        _arrays("bigint", seed=1), sessions, nb=3)


def test_required_child_output_pruning(sessions):
    """Only the columns the other select items read pass through the
    Generate (the array itself would raise)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.plan import from_host_table
    from spark_rapids_tpu_torch.plan import nodes as P
    tabs = _arrays("int")
    got = _check(lambda a, df: df.select(
        (a.col("g") + a.lit(1)).alias("g1"),
        a.F.explode(a.col("a")).alias("e")), tabs, sessions)
    assert list(got.names) == ["g1", "e"]
    df = from_host_table(tabs[1], sessions[1]).select(
        "g", F.explode("a").alias("e"))
    gen = df.plan.children[0]
    assert isinstance(gen, P.Generate) and gen.required == ["g"]


def test_explode_of_a_computed_array_then_aggregate(sessions):
    _check(lambda a, df: df.select(
        "g", a.F.posexplode(a.F.array(a.col("id"), a.col("g"),
                                      a.col("id") * a.lit(2))).alias("e"))
        .group_by("pos").agg(a.F.sum(a.col("e")).alias("s"),
                             a.F.count().alias("n")).sort("pos"),
        _arrays("int"), sessions)


def test_sequence(sessions):
    rng = np.random.default_rng(3)
    n = 100
    start = rng.integers(-5, 5, n)
    tabs = tables([("s", TT.LONG, start.tolist()),
                   ("e", TT.INT, (start + rng.integers(-2, 3, n)).tolist()),
                   ("st", TT.LONG, rng.choice([1, 2, 3], n).tolist())])
    _check(lambda a, df: df.select(
        a.F.sequence(a.col("s"), a.col("e")).alias("q")), tabs, sessions)
    _check(lambda a, df: df.select(a.F.explode(a.F.sequence(
        a.col("s"), a.col("s") + a.col("st") * a.lit(2), a.col("st")))
        .alias("x")), tabs, sessions)


def test_sequence_with_a_wrong_step_raises(sessions):
    from spark_rapids_tpu_torch.errors import ColumnarProcessingError
    tabs = tables([("s", TT.LONG, [1, 2]), ("e", TT.LONG, [5, 9])])
    df = PORT.frm(tabs[1], sessions[1])
    with pytest.raises(ColumnarProcessingError, match="step"):
        df.select(PORT.F.sequence(PORT.col("s"), PORT.col("e"),
                                  PORT.lit(-1)).alias("q")).collect_table()


def test_stack(sessions):
    tabs = _arrays("int")
    _check(lambda a, df: df.stack(2, a.col("id"), a.col("g"), a.col("g"),
                                  a.col("id"), names=["x", "y"]),
           tabs, sessions, ordered=False)


def test_replicate_rows(sessions):
    rng = np.random.default_rng(5)
    tabs = tables([("k", TT.INT, list(range(50))),
                   ("n", TT.LONG, rng.integers(-1, 4, 50).tolist())])
    _check(lambda a, df: df.replicate_rows("n"), tabs, sessions)


def _views(tabs, sessions, name):
    from spark_rapids_tpu.plan import from_host_table as jfrom
    from spark_rapids_tpu_torch.plan import from_host_table as tfrom
    jfrom(tabs[0], sessions[0]).create_or_replace_temp_view(name)
    tfrom(tabs[1], sessions[1]).create_or_replace_temp_view(name)


SQL = {
    "explode": "SELECT id, explode(a) AS e FROM gen_t",
    "posexplode": "SELECT g, posexplode(a) FROM gen_t",
    "explode_outer": "SELECT id, explode_outer(a) AS e FROM gen_t",
    "posexplode_outer": "SELECT id, posexplode_outer(a) FROM gen_t",
    "builtins": ("SELECT id, size(a) AS n, cardinality(a) AS c2, "
                 "array_contains(a, 3) AS c, sort_array(a) AS s, "
                 "get_item(a, 1) AS i1, array_min(a) AS mn, "
                 "array_max(a) AS mx FROM gen_t"),
    "array and sequence": ("SELECT id, array(id, g, 7) AS arr, "
                           "sequence(g, g + 2) AS sq FROM gen_t"),
    "struct and map": ("SELECT named_struct('x', id, 'y', g) AS st, "
                       "struct(id, g) AS s2, "
                       "map_keys(map_values_src) AS k FROM (SELECT id, g, "
                       "id AS map_values_src FROM gen_t) t"),
}


@pytest.mark.parametrize("name", list(SQL))
def test_sql_forms(name, sessions):
    tabs = _arrays("int", n=120, seed=4)
    _views(tabs, sessions, "gen_t")
    text = SQL[name]
    if name == "struct and map":
        text = ("SELECT named_struct('x', id, 'y', g) AS st, "
                "struct(id, g) AS s2 FROM gen_t")
    want = sessions[0].sql(text).collect_table()
    got = as_reference(sessions[1].sql(text).collect_table())
    assert nested_differ(want, got) is None, nested_differ(want, got)
