"""Plan nodes (port of the LocalScan, Project, Filter, Aggregate, Sort,
SortOrder, Limit, Join and TakeOrderedAndProject parts of
``spark_rapids_tpu/plan/nodes.py``). Nodes bind their
expressions against the child's schema at construction; the overrides
layer (overrides/rules.py) turns them into device execs. The reference's
CPU execution of these nodes is not ported: the port has no CPU
fallback."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostTable
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.ops import aggregates as agg
from spark_rapids_tpu_torch.ops.expr import Alias, Expression, bind, output_name

Schema = List[Tuple[str, T.DataType]]


class PlanNode:
    children: Tuple["PlanNode", ...] = ()

    def output_schema(self) -> Schema:
        raise NotImplementedError

    def estimate_bytes(self) -> Optional[int]:
        """Rough output-size upper bound for physical planning (broadcast
        or not). None = unknown. Row-preserving or shrinking unary nodes
        propagate their child's estimate."""
        return None

    @property
    def name(self) -> str:
        return type(self).__name__


class LocalScan(PlanNode):
    """In-memory scan over pre-built host batches."""

    def __init__(self, batches: Sequence[HostTable]):
        if not batches:
            raise ColumnarProcessingError("LocalScan needs at least one batch")
        self.batches = list(batches)

    def output_schema(self):
        return self.batches[0].schema()

    def estimate_bytes(self):
        return sum(b.nbytes() for b in self.batches)


class Project(PlanNode):
    def __init__(self, child: PlanNode, exprs: Sequence[Expression]):
        self.children = (child,)
        schema = child.output_schema()
        self.exprs = [bind(e, schema) for e in exprs]
        self.names = [output_name(e, f"col{i}") for i, e in enumerate(exprs)]

    @property
    def child(self):
        return self.children[0]

    def output_schema(self):
        return [(n, e.data_type) for n, e in zip(self.names, self.exprs)]

    def estimate_bytes(self):
        # projections can WIDEN rows: scale the child's estimate by the
        # column-count ratio
        est = self.children[0].estimate_bytes()
        if est is None:
            return None
        n_in = max(len(self.children[0].output_schema()), 1)
        return int(est * max(len(self.names), 1) / n_in) \
            if len(self.names) > n_in else est


class Filter(PlanNode):
    def __init__(self, child: PlanNode, condition: Expression):
        self.children = (child,)
        self.condition = bind(condition, child.output_schema())
        if self.condition.data_type != T.BOOLEAN:
            raise ColumnarProcessingError(
                f"filter condition is {self.condition.data_type}, not boolean")

    @property
    def child(self):
        return self.children[0]

    def output_schema(self):
        return self.children[0].output_schema()

    def estimate_bytes(self):
        return self.children[0].estimate_bytes()


class Aggregate(PlanNode):
    """Hash aggregate (group-by)."""

    def __init__(self, child: PlanNode, grouping: Sequence[Expression],
                 aggregates: Sequence[Expression]):
        self.children = (child,)
        schema = child.output_schema()
        self.grouping = [bind(g, schema) for g in grouping]
        self.agg_specs: List[Tuple[str, agg.AggregateFunction]] = []
        for i, a in enumerate(aggregates):
            name = output_name(a, f"agg{i}")
            fn = a.children[0] if isinstance(a, Alias) else a
            if not isinstance(fn, agg.AggregateFunction):
                raise ColumnarProcessingError(f"not an aggregate: {a!r}")
            self.agg_specs.append((name, bind(fn, schema)))
        self.grouping_names = [output_name(g, f"k{i}")
                               for i, g in enumerate(self.grouping)]

    @property
    def child(self):
        return self.children[0]

    def output_schema(self):
        out = [(n, g.data_type) for n, g in zip(self.grouping_names,
                                                self.grouping)]
        out += [(n, fn.data_type) for n, fn in self.agg_specs]
        return out


@dataclass(eq=False)
class SortOrder:
    expr: Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None  # Spark default: asc->first, desc->last

    def resolved_nulls_first(self) -> bool:
        return self.ascending if self.nulls_first is None else self.nulls_first


class Sort(PlanNode):
    def __init__(self, child: PlanNode, orders: Sequence[SortOrder],
                 global_sort: bool = True):
        self.children = (child,)
        schema = child.output_schema()
        self.orders = [SortOrder(bind(o.expr, schema), o.ascending,
                                 o.nulls_first) for o in orders]
        self.global_sort = global_sort

    @property
    def child(self):
        return self.children[0]

    def output_schema(self):
        return self.children[0].output_schema()


class Limit(PlanNode):
    """LIMIT n without an ordering (the port plans ORDER BY + LIMIT as
    TakeOrderedAndProject and has no exec for a bare limit yet)."""

    def __init__(self, child: PlanNode, limit: int):
        self.children = (child,)
        self.limit = int(limit)

    def output_schema(self):
        return self.children[0].output_schema()

    def estimate_bytes(self):
        return self.children[0].estimate_bytes()


class Join(PlanNode):
    """Equi-join. The output schema is the left schema then the right one
    (a join on a column name keeps both key columns, as the reference)."""

    def __init__(self, left: PlanNode, right: PlanNode, join_type: str,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 condition: Optional[Expression] = None):
        self.children = (left, right)
        self.join_type = join_type
        ls, rs = left.output_schema(), right.output_schema()
        self.left_keys = [bind(k, ls) for k in left_keys]
        self.right_keys = [bind(k, rs) for k in right_keys]
        self.condition = (bind(condition, ls + rs)
                          if condition is not None else None)

    def output_schema(self):
        ls = self.children[0].output_schema()
        rs = self.children[1].output_schema()
        if self.join_type in ("leftsemi", "leftanti"):
            return ls
        return ls + rs


class TakeOrderedAndProject(PlanNode):
    """ORDER BY ... LIMIT n: per-batch top-k (the reference's optional
    projection on top is not ported; no DataFrame call builds one)."""

    def __init__(self, child: PlanNode, orders: Sequence[SortOrder],
                 limit: int):
        self.children = (child,)
        schema = child.output_schema()
        self.orders = [SortOrder(bind(o.expr, schema), o.ascending,
                                 o.nulls_first) for o in orders]
        self.limit = int(limit)

    def output_schema(self):
        return self.children[0].output_schema()
