"""PySpark-style function namespace: the expression constructors the
ported slice has."""

from __future__ import annotations

from spark_rapids_tpu_torch.ops import aggregates as _agg
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
