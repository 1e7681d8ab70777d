"""Window specs and window functions (port of
``spark_rapids_tpu/ops/window.py``: WindowSpec, Window, RowNumber, Rank,
DenseRank, PercentRank, NthValue, Lag, Lead and WindowExpression).

Frames: ("rows" | "range", lo, hi) with None = unbounded, 0 = current row,
negative = preceding, positive = following. Spark defaults: with an ORDER BY
the frame is RANGE UNBOUNDED PRECEDING..CURRENT ROW; without it the frame is
the whole partition. execs/window.py evaluates every function here and the
aggregates SUM, COUNT, MIN, MAX and AVG over whole, running and bounded
frames; ``execs/window.py::device_window_supported`` names what raises.
The CPU route evaluates a window column with the reference's numpy
(``eval_window_cpu``)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.ops import aggregates as agg
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


# -- the CPU route ------------------------------------------------------------

def eval_window_cpu(table: HostTable, wexpr: WindowExpression) -> HostColumn:
    """The reference's numpy evaluation of a window column (the CPU
    route's WindowNode). Rows are processed in (partition, order) sorted
    position, and results return in the INPUT row order, as Spark's
    WindowExec."""
    n = table.num_rows
    spec = wexpr.spec
    fn = wexpr.function

    # partition codes
    if spec.partition_exprs:
        pcols = [p.eval_cpu(table) for p in spec.partition_exprs]
        pkeys = []
        for c in pcols:
            vals = np.where(c.validity, c.data, None if c.data.dtype == object else 0)
            pkeys.append([(bool(c.validity[i]), vals[i]) for i in range(n)])
        part_of = {}
        pid = np.zeros(n, dtype=np.int64)
        for i in range(n):
            key = tuple(pk[i] for pk in pkeys)
            pid[i] = part_of.setdefault(key, len(part_of))
    else:
        pid = np.zeros(n, dtype=np.int64)

    # sorted order within partitions
    from spark_rapids_tpu_torch.plan.nodes import _stable_sort_indices
    if spec.orders:
        ocols = [o.expr.eval_cpu(table) for o in spec.orders]
        order_idx = _stable_sort_indices(
            [HostColumn(T.LONG, pid, np.ones(n, dtype=np.bool_))] + ocols,
            [SortOrder(None, True)] + list(spec.orders), n)
    else:
        ocols = []
        order_idx = np.argsort(pid, kind="stable")

    frame = spec.resolved_frame()

    # peer flags (for rank/range frames): equal order-key values
    def order_tuple(i):
        return tuple(
            (bool(c.validity[i]), None if not c.validity[i] else c.data[i])
            for c in ocols) if spec.orders else ()

    result = np.empty(n, dtype=object)
    valid = np.ones(n, dtype=np.bool_)

    pos = 0
    while pos < n:
        # find partition run in sorted order
        p = pid[order_idx[pos]]
        end = pos
        while end < n and pid[order_idx[end]] == p:
            end += 1
        rows = order_idx[pos:end]
        m = len(rows)

        if isinstance(fn, RowNumber):
            for j, r in enumerate(rows):
                result[r] = j + 1
        elif isinstance(fn, (Rank, DenseRank)):
            rank = 0
            dense = 0
            prev = object()
            for j, r in enumerate(rows):
                cur = order_tuple(r)
                if cur != prev:
                    rank = j + 1
                    dense += 1
                    prev = cur
                result[r] = rank if isinstance(fn, Rank) else dense
        elif isinstance(fn, PercentRank):
            rank = 0
            prev = object()
            for j, r in enumerate(rows):
                cur = order_tuple(r)
                if cur != prev:
                    rank = j + 1
                    prev = cur
                result[r] = 0.0 if m == 1 else (rank - 1) / (m - 1)
        elif isinstance(fn, NthValue):
            if frame != ("range", None, 0):
                raise ColumnarProcessingError(
                    "nth_value supports only the default running frame")
            src = fn.children[0].eval_cpu(table)
            # default running frame (range unbounded preceding..current):
            # the nth partition row becomes visible at its peer group
            pos = fn.n - 1
            for j, r in enumerate(rows):
                # frame end = last peer of r
                e = j
                while e + 1 < m and order_tuple(rows[e + 1]) == order_tuple(r):
                    e += 1
                if pos <= e:
                    rr = rows[pos]
                    result[r] = src.data[rr] if src.validity[rr] else None
                    valid[r] = bool(src.validity[rr])
                else:
                    result[r] = None
                    valid[r] = False
        elif isinstance(fn, (Lag, Lead)):
            src = fn.children[0].eval_cpu(table)
            off = fn.offset if isinstance(fn, Lead) else -fn.offset
            for j, r in enumerate(rows):
                k = j + off
                if 0 <= k < m:
                    rr = rows[k]
                    result[r] = src.data[rr] if src.validity[rr] else None
                    valid[r] = bool(src.validity[rr])
                else:
                    result[r] = fn.default
                    valid[r] = fn.default is not None
        elif isinstance(fn, agg.AggregateFunction):
            src = fn.child.eval_cpu(table) if fn.child is not None else None
            kind, lo, hi = frame
            # per-row frame bounds in sorted positions
            if kind == "range":
                if not ((lo is None and (hi == 0 or hi is None))):
                    raise ColumnarProcessingError(
                        "only UNBOUNDED..CURRENT/UNBOUNDED range frames supported")
            for j, r in enumerate(rows):
                if kind == "rows":
                    a = 0 if lo is None else max(0, j + lo)
                    b = m - 1 if hi is None else min(m - 1, j + hi)
                else:  # range: unbounded preceding .. current-row peers / unbounded
                    a = 0
                    if hi is None:
                        b = m - 1
                    else:  # current row incl peers
                        b = j
                        while b + 1 < m and order_tuple(rows[b + 1]) == order_tuple(r):
                            b += 1
                window_rows = rows[a:b + 1] if b >= a else rows[0:0]
                result[r], valid[r] = _agg_window_cpu(fn, src, window_rows)
        else:
            raise ColumnarProcessingError(
                f"window function {type(fn).__name__} unsupported")
        pos = end

    dt = wexpr.data_type
    if isinstance(dt, T.StringType):
        data = np.array([result[i] if valid[i] else None for i in range(n)],
                        dtype=object)
        return HostColumn(dt, data, valid)
    np_dt = dt.np_dtype
    data = np.array([result[i] if valid[i] and result[i] is not None else 0
                     for i in range(n)], dtype=np_dt)
    valid = valid & np.array([result[i] is not None for i in range(n)])
    return HostColumn(dt, data, valid)


def _agg_window_cpu(fn, src, rows):
    if isinstance(fn, agg.Count):
        if fn.child is None:
            return len(rows), True
        return int(np.sum(src.validity[rows])), True
    vals = [src.data[r] for r in rows if src.validity[r]]
    if not vals:
        return None, False
    if isinstance(fn, agg.Sum):
        if isinstance(fn.data_type, T.LongType):
            # exact python sum, wrapped to int64 like Spark non-ANSI overflow
            total = sum(int(v) for v in vals)
            return ((total + (1 << 63)) % (1 << 64)) - (1 << 63), True
        return float(sum(float(v) for v in vals)), True
    if isinstance(fn, agg.Min):
        return min(vals), True
    if isinstance(fn, agg.Max):
        return max(vals), True
    if isinstance(fn, agg.Average):
        return float(sum(float(v) for v in vals)) / len(vals), True
    raise ColumnarProcessingError(f"window agg {type(fn).__name__}")


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
