"""Aggregate function declarations (port of the Sum, Min, Max, Count,
Average, StddevPop, StddevSamp, VariancePop, VarianceSamp and MergeMoments
part of ``spark_rapids_tpu/ops/aggregates.py``). The aggregate exec
interprets them; Spark's result types: sum(float/double) -> DOUBLE,
sum(integral) -> LONG, sum(decimal(p, s)) -> decimal(min(38, p + 10), s),
min/max -> the child's type, avg, variance and stddev -> DOUBLE (also
over a decimal), count -> LONG (never null). MergeMoments is internal to
the multi-batch merge (execs/aggregate.py ``_merge_plan``)."""

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
    """``result_type`` (internal, the multi-batch merge's sum of decimal
    partial sums): the type of the original SUM, so the merged sum is
    held to its precision as one batch's would be."""

    def __init__(self, child: Optional[Expression] = None,
                 result_type: Optional[T.DataType] = None):
        super().__init__(child)
        self.result_type = result_type

    def with_children(self, children):
        return Sum(children[0], self.result_type)

    @property
    def data_type(self):
        if self.result_type is not None:
            return self.result_type
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


class MergeMoments(AggregateFunction):
    """INTERNAL (the multi-batch merge only): combines per-batch moment
    partials. Children are (count, sum, m2) over the concatenated partial
    table; the result is Chan's combination
    ``m2_total = sum(m2_i) + sum(n_i * (mean_i - mean_total)^2)``."""

    def __init__(self, count_expr: Expression, sum_expr: Expression,
                 m2_expr: Expression):
        self.children = (count_expr, sum_expr, m2_expr)

    @property
    def data_type(self):
        return T.DOUBLE

    @property
    def child(self):
        return None

    def with_children(self, children):
        return MergeMoments(children[0], children[1], children[2])
