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

