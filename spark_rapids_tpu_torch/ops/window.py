"""Window specs and window functions (port of
``spark_rapids_tpu/ops/window.py``: WindowSpec, Window, RowNumber, Rank,
DenseRank, PercentRank, NthValue, Lag, Lead and WindowExpression).

Frames: ("rows" | "range", lo, hi) with None = unbounded, 0 = current row,
negative = preceding, positive = following. Spark defaults: with an ORDER BY
the frame is RANGE UNBOUNDED PRECEDING..CURRENT ROW; without it the frame is
the whole partition. execs/window.py evaluates every function here and the
aggregates SUM, COUNT, MIN, MAX and AVG over whole, running and bounded
frames; ``execs/window.py::device_window_supported`` names what raises.
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
    """Base of the window functions (not evaluable standalone)."""

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


class PercentRank(WindowFunction):
    """percent_rank() = (rank - 1) / (partition rows - 1); 0 for a
    one-row partition."""

    @property
    def data_type(self):
        return T.DOUBLE


class NthValue(WindowFunction):
    """nth_value(e, n) over the default running frame: the partition's
    n-th row's value, visible once the frame reaches it."""

    def __init__(self, child: Expression, n: int, ignore_nulls: bool = False):
        self.children = (child,)
        self.n = int(n)
        self.ignore_nulls = bool(ignore_nulls)
        if self.n < 1:
            raise ValueError("nth_value n must be >= 1")

    @property
    def data_type(self):
        return self.children[0].data_type

    def with_children(self, children):
        return NthValue(children[0], self.n, self.ignore_nulls)


class _Offset(WindowFunction):
    """Base of Lag and Lead: the value ``offset`` rows away in the
    partition (``default`` where there is none)."""

    def __init__(self, child: Expression, offset: int = 1, default=None):
        self.children = (child,)
        self.offset = offset
        self.default = default

    @property
    def data_type(self):
        return self.children[0].data_type

    def with_children(self, children):
        return type(self)(children[0], self.offset, self.default)


class Lag(_Offset):
    """The value ``offset`` rows before."""


class Lead(_Offset):
    """The value ``offset`` rows after."""


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

    def key(self):
        """The function, the partition keys, the orders and the resolved
        frame: two window columns with equal keys compute the same
        values."""
        return ("winexpr", self.function.key(),
                tuple(p.key() for p in self.spec.partition_exprs),
                tuple((o.expr.key(), o.ascending, o.resolved_nulls_first())
                      for o in self.spec.orders),
                self.spec.resolved_frame())

    def bind(self, schema):
        from spark_rapids_tpu_torch.ops import aggregates as agg
        bound = [c.bind(schema) for c in self.function.children]
        fn = self.function.with_children(bound) if bound else self.function
        if isinstance(fn, (agg.Average, agg.StddevPop, agg.StddevSamp,
                           agg.VariancePop, agg.VarianceSamp)) and \
                fn.child is not None and \
                isinstance(fn.child.data_type, T.DecimalType):
            # a DOUBLE moment over unscaled decimal values would come out
            # in unscaled units: the child is cast to DOUBLE here, once,
            # for every frame and route
            from spark_rapids_tpu_torch.ops.cast import Cast
            fn = type(fn)(Cast(fn.child, T.DOUBLE))
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


def lag(e, offset: int = 1, default=None) -> Lag:
    from spark_rapids_tpu_torch.ops.expr import col
    return Lag(col(e) if isinstance(e, str) else e, offset, default)


def lead(e, offset: int = 1, default=None) -> Lead:
    from spark_rapids_tpu_torch.ops.expr import col
    return Lead(col(e) if isinstance(e, str) else e, offset, default)
