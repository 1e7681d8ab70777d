"""PySpark-style function namespace: the expression constructors the
ported slices have, ``expr`` (one SQL expression) and the process-wide
SQL function registrations."""

from __future__ import annotations

from spark_rapids_tpu_torch.ops import aggregates as _agg
from spark_rapids_tpu_torch.ops import conditional as _cond
from spark_rapids_tpu_torch.ops.expr import Expression, col, lit  # noqa: F401


def _e(x) -> Expression:
    return x if isinstance(x, Expression) else col(x) if isinstance(x, str) else lit(x)


def sum(e):  # noqa: A001
    return _agg.Sum(_e(e))


def min(e):  # noqa: A001
    return _agg.Min(_e(e))


def max(e):  # noqa: A001
    return _agg.Max(_e(e))


def count(e="*"):
    # type-guarded star check: col("x") == "*" would build an expression
    if (isinstance(e, str) and e == "*") or (isinstance(e, int) and e == 1):
        return _agg.Count()
    return _agg.Count(_e(e))


def avg(e):
    return _agg.Average(_e(e))


def stddev(e):
    return _agg.StddevSamp(_e(e))


def stddev_pop(e):
    return _agg.StddevPop(_e(e))


def variance(e):
    return _agg.VarianceSamp(_e(e))


def var_pop(e):
    return _agg.VariancePop(_e(e))


def first(e, ignore_nulls=False):
    return _agg.First(_e(e), ignore_nulls)


def last(e, ignore_nulls=False):
    return _agg.Last(_e(e), ignore_nulls)


def abs(e):  # noqa: A001
    from spark_rapids_tpu_torch.ops.arithmetic import Abs
    return Abs(_e(e))


def isnull(e):
    from spark_rapids_tpu_torch.ops.predicates import IsNull
    return IsNull(_e(e))


def isnan(e):
    from spark_rapids_tpu_torch.ops.predicates import IsNaN
    return IsNaN(_e(e))


def is_in(e, *items):
    from spark_rapids_tpu_torch.ops.predicates import In
    return In(_e(e), [_e(i) for i in items])


# ranking window functions (ops/window.py): row_number().over(spec)
def row_number():
    from spark_rapids_tpu_torch.ops.window import RowNumber
    return RowNumber()


def rank():
    from spark_rapids_tpu_torch.ops.window import Rank
    return Rank()


def dense_rank():
    from spark_rapids_tpu_torch.ops.window import DenseRank
    return DenseRank()


# hash functions (ops/hashfns.py)
def hash(*exprs):  # noqa: A001
    from spark_rapids_tpu_torch.ops.hashfns import Murmur3Hash
    return Murmur3Hash(*[_e(x) for x in exprs])


# conditionals (ops/conditional.py)
def when(cond, value):
    return WhenBuilder().when(cond, value)


class WhenBuilder:
    """``when(c0, v0).when(c1, v1).otherwise(v)`` -> CaseWhen;
    ``.end()`` leaves the ELSE null."""

    def __init__(self):
        self._branches = []

    def when(self, cond, value):
        self._branches.extend([_e(cond), _e(value)])
        return self

    def otherwise(self, value):
        return _cond.CaseWhen(*self._branches, _e(value))

    def end(self):
        return _cond.CaseWhen(*self._branches)


def coalesce(*exprs):
    return _cond.Coalesce(*[_e(e) for e in exprs])


def greatest(*exprs):
    return _cond.Greatest(*[_e(e) for e in exprs])


def least(*exprs):
    return _cond.Least(*[_e(e) for e in exprs])


def nanvl(a, b):
    return _cond.NaNvl(_e(a), _e(b))


def if_(cond, a, b):
    return _cond.If(_e(cond), _e(a), _e(b))


# -- SQL front end hooks ------------------------------------------------------

def expr(sql_text: str) -> Expression:
    """Parse one SQL expression into an engine Expression (PySpark's
    F.expr): ``expr("l_extendedprice * (1.0 - l_discount)")``. Column
    references resolve when the expression lands in a plan node, as
    ``col()``'s do."""
    from spark_rapids_tpu_torch.sql.analyzer import Analyzer, Scope
    from spark_rapids_tpu_torch.sql.parser import parse_expression

    node = parse_expression(sql_text)
    analyzer = Analyzer(None, sql_text)

    class _AnyContains(list):
        def __contains__(self, item):
            return True

    class _OpenScope(Scope):
        """Unbound scope: any identifier resolves to an
        AttributeReference."""

        def __init__(self):
            pass

        @property
        def columns(self):
            return _AnyContains()

        aliases: dict = {}
        visible: list = []

    return analyzer.lower_expr(node, _OpenScope())


#: process-wide SQL-callable function registrations
_SQL_FUNCTIONS = {}


def register_sql_function(name: str, builder) -> None:
    """Make ``builder(*arg_exprs) -> Expression`` callable from SQL text
    under ``name`` in every session, e.g.
    ``register_sql_function("twice", lambda e: e * lit(2))``."""
    _SQL_FUNCTIONS[name.lower()] = builder


def unregister_sql_function(name: str) -> None:
    _SQL_FUNCTIONS.pop(name.lower(), None)


def registered_sql_function(name: str):
    return _SQL_FUNCTIONS.get(name.lower())
