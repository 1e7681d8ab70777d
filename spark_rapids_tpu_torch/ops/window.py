"""Window specs and the ranking window functions (port of the WindowSpec,
Window, WindowFunction, RowNumber, Rank, DenseRank and WindowExpression
parts of ``spark_rapids_tpu/ops/window.py``).

Frames: ("rows" | "range", lo, hi) with None = unbounded, 0 = current row,
negative = preceding, positive = following. Spark defaults: with an ORDER BY
the frame is RANGE UNBOUNDED PRECEDING..CURRENT ROW; without it the frame is
the whole partition. The port evaluates row_number, rank and dense_rank
(execs/window.py); percent_rank, nth_value, lag, lead, aggregate windows
and explicit frames are not ported, and the overrides raise for them.
The reference's numpy evaluation (``eval_window_cpu``) is not ported: the
port has no CPU plan path."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops.expr import Expression
from spark_rapids_tpu_torch.plan.nodes import SortOrder


class WindowSpec:
    """A window spec, built up as Window.partition_by(...).order_by(...)."""

    def __init__(self, partition_by: Sequence[Expression] = (),
                 order_by: Sequence[SortOrder] = (),
                 frame: Optional[Tuple[str, Optional[int],
                                       Optional[int]]] = None):
        self.partition_exprs = list(partition_by)
        self.orders = list(order_by)
        self.frame = frame

    def partition_by(self, *cols) -> "WindowSpec":
        from spark_rapids_tpu_torch.ops.expr import col
        exprs = [col(c) if isinstance(c, str) else c for c in cols]
        return WindowSpec(exprs, self.orders, self.frame)

    def order_by(self, *cols, ascending: bool = True) -> "WindowSpec":
        from spark_rapids_tpu_torch.ops.expr import col
        orders = []
        for c in cols:
            if isinstance(c, SortOrder):
                orders.append(c)
            else:
                e = col(c) if isinstance(c, str) else c
                orders.append(SortOrder(e, ascending))
        return WindowSpec(self.partition_exprs, orders, self.frame)

    def rows_between(self, lo: Optional[int], hi: Optional[int]
                     ) -> "WindowSpec":
        return WindowSpec(self.partition_exprs, self.orders, ("rows", lo, hi))

    def range_between(self, lo: Optional[int], hi: Optional[int]
                      ) -> "WindowSpec":
        return WindowSpec(self.partition_exprs, self.orders,
                          ("range", lo, hi))

    def resolved_frame(self) -> Tuple[str, Optional[int], Optional[int]]:
        if self.frame is not None:
            return self.frame
        if self.orders:
            return ("range", None, 0)  # Spark default with ORDER BY
        return ("rows", None, None)

    def key(self) -> tuple:
        """(partition keys, orders): two specs with equal keys rank rows
        alike."""
        return (tuple(e.key() for e in self.partition_exprs),
                tuple((o.expr.key(), o.ascending,
                       o.resolved_nulls_first()) for o in self.orders))


#: Spark-style entry: Window.partition_by(...)
class Window:
    @staticmethod
    def partition_by(*cols) -> WindowSpec:
        return WindowSpec().partition_by(*cols)

    @staticmethod
    def order_by(*cols, **kw) -> WindowSpec:
        return WindowSpec().order_by(*cols, **kw)


class WindowFunction(Expression):
    """Base of the ranking window functions (not evaluable standalone)."""

    children = ()

    def over(self, spec: WindowSpec) -> "WindowExpression":
        return WindowExpression(self, spec)

    @property
    def data_type(self):
        return T.INT

    def with_children(self, children):
        return self


class RowNumber(WindowFunction):
    pass


class Rank(WindowFunction):
    pass


class DenseRank(WindowFunction):
    pass


#: the group limit's name of each ranking function
RANK_KINDS = {RowNumber: "rownumber", Rank: "rank", DenseRank: "denserank"}


class WindowExpression(Expression):
    """function OVER spec. Binding descends into the function's children,
    the partition expressions and the order expressions."""

    def __init__(self, function: Expression, spec: WindowSpec):
        self.function = function
        self.spec = spec
        self.children = tuple(function.children)

    @property
    def data_type(self):
        return self.function.data_type

    def bind(self, schema):
        bound = [c.bind(schema) for c in self.function.children]
        fn = self.function.with_children(bound) if bound else self.function
        spec = WindowSpec(
            [p.bind(schema) for p in self.spec.partition_exprs],
            [SortOrder(o.expr.bind(schema), o.ascending, o.nulls_first)
             for o in self.spec.orders],
            self.spec.frame)
        return WindowExpression(fn, spec)


def row_number() -> RowNumber:
    return RowNumber()


def rank() -> Rank:
    return Rank()


def dense_rank() -> DenseRank:
    return DenseRank()
