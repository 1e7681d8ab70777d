"""Aggregate function declarations (port of the Sum, Min, Max, Count,
Average, StddevPop, StddevSamp, VariancePop and VarianceSamp part of
``spark_rapids_tpu/ops/aggregates.py``). The aggregate exec interprets
them; Spark's result types: sum(float/double) -> DOUBLE, sum(integral) ->
LONG, sum(decimal(p, s)) -> decimal(min(38, p + 10), s), min/max -> the
child's type, avg, variance and stddev -> DOUBLE (also over a decimal),
count -> LONG (never null)."""

from __future__ import annotations

from typing import Optional

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops.expr import Expression


class AggregateFunction(Expression):
    """Base; child is the aggregated value expression (row-wise)."""

    def __init__(self, child: Optional[Expression] = None):
        self.children = (child,) if child is not None else ()

    @property
    def child(self):
        return self.children[0] if self.children else None

    def with_children(self, children):
        return type(self)(children[0]) if children else type(self)()

    def over(self, spec):
        """agg OVER window-spec -> WindowExpression (ops/window.py); the
        port's overrides raise for aggregate windows."""
        from spark_rapids_tpu_torch.ops.window import WindowExpression
        return WindowExpression(self, spec)


class Sum(AggregateFunction):
    @property
    def data_type(self):
        ct = self.child.data_type
        if isinstance(ct, T.IntegralType):
            return T.LONG
        if isinstance(ct, (T.FloatType, T.DoubleType)):
            return T.DOUBLE
        if isinstance(ct, T.DecimalType):
            from spark_rapids_tpu_torch.ops.decimal import sum_result_type
            return sum_result_type(ct)
        raise NotImplementedError(f"sum of {ct.simple_string()} is not "
                                  "ported")


class Min(AggregateFunction):
    @property
    def data_type(self):
        return self.child.data_type


class Max(AggregateFunction):
    @property
    def data_type(self):
        return self.child.data_type


class Count(AggregateFunction):
    """count(expr); Count() with no child is COUNT(*)."""

    @property
    def data_type(self):
        return T.LONG


class Average(AggregateFunction):
    @property
    def data_type(self):
        return T.DOUBLE


class _CentralMoment(AggregateFunction):
    """Variance and standard deviation: DOUBLE, computed in two passes
    (the mean, then the centred squares)."""

    @property
    def data_type(self):
        return T.DOUBLE


class StddevPop(_CentralMoment):
    pass


class StddevSamp(_CentralMoment):
    pass


class VariancePop(_CentralMoment):
    pass


class VarianceSamp(_CentralMoment):
    pass
