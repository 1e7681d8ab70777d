"""Aggregate function declarations (port of the Sum, Min, Max, Count,
Average, First, Last, StddevPop, StddevSamp, VariancePop, VarianceSamp and
MergeMoments part of ``spark_rapids_tpu/ops/aggregates.py``). The
aggregate exec interprets them; Spark's result types: sum(float/double)
-> DOUBLE, sum(integral) -> LONG, sum(decimal(p, s)) ->
decimal(min(38, p + 10), s), min/max/first/last -> the child's type, avg,
variance and stddev -> DOUBLE (also over a decimal), count -> LONG (never
null), collect_list/collect_set -> an array of the child's type (never
null), percentile -> DOUBLE. MergeMoments is internal to
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


class _Pick(AggregateFunction):
    """First and Last: one row's value per group, picked by position."""

    def __init__(self, child=None, ignore_nulls: bool = False):
        super().__init__(child)
        self.ignore_nulls = ignore_nulls

    def with_children(self, children):
        return type(self)(children[0], self.ignore_nulls)

    @property
    def data_type(self):
        return self.child.data_type

    def __repr__(self):
        return f"{self.name}({self.child!r}, ignore_nulls={self.ignore_nulls})"


class First(_Pick):
    """The value of each group's first row (in input order); with
    ``ignore_nulls``, its first non-null value."""


class Last(_Pick):
    """The value of each group's last row; with ``ignore_nulls``, its last
    non-null value."""


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


class CollectList(AggregateFunction):
    """collect_list(e) -> the group's non-null values in input order (an
    empty array, never null)."""

    @property
    def data_type(self):
        return T.ArrayType(self.child.data_type)


class CollectSet(AggregateFunction):
    """collect_set(e) -> the group's distinct non-null values, in value
    order (Spark leaves the order unspecified; the reference emits
    value-sorted). -0.0 and 0.0 are one value, as are all NaNs; the
    first occurrence in input order is the one kept."""

    @property
    def data_type(self):
        return T.ArrayType(self.child.data_type)


class Percentile(AggregateFunction):
    """percentile(e, p): exact, linear interpolation between the sorted
    values (``approx_percentile`` is served by it exactly)."""

    def __init__(self, child: Expression, percentage: float):
        super().__init__(child)
        self.percentage = float(percentage)
        if not 0.0 <= self.percentage <= 1.0:
            raise ValueError(
                f"percentile percentage must be in [0, 1], got {percentage}")

    def with_children(self, children):
        return Percentile(children[0], self.percentage)

    @property
    def data_type(self):
        return T.DOUBLE


#: aggregates that need their groups' rows contiguous and sorted: the
#: sort-segment route only, over one coalesced batch
SORT_ONLY_AGGS = (CollectList, CollectSet, Percentile)
