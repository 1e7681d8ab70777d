"""DataFrame API (port of the DataFrame/GroupedData/from_host_table part
of ``spark_rapids_tpu/plan/dataframe.py``: select, with_column, filter,
group_by, agg, sort, limit, join on column names): builds plan nodes; a
session executes them."""

from __future__ import annotations

from typing import Sequence

from spark_rapids_tpu_torch.columnar import HostTable
from spark_rapids_tpu_torch.ops.expr import Expression, col
from spark_rapids_tpu_torch.plan import nodes as P


class DataFrame:
    def __init__(self, plan: P.PlanNode, session=None):
        self.plan = plan
        self.session = session

    def _wrap(self, plan: P.PlanNode) -> "DataFrame":
        return DataFrame(plan, self.session)

    def select(self, *exprs) -> "DataFrame":
        exprs = [col(e) if isinstance(e, str) else e for e in exprs]
        return self._wrap(P.Project(self.plan, exprs))

    def with_column(self, name: str, expr: Expression) -> "DataFrame":
        existing = [col(n) for n, _ in self.plan.output_schema() if n != name]
        return self.select(*existing, expr.alias(name))

    def filter(self, condition: Expression) -> "DataFrame":
        return self._wrap(P.Filter(self.plan, condition))

    def group_by(self, *keys) -> "GroupedData":
        keys = [col(k) if isinstance(k, str) else k for k in keys]
        return GroupedData(self, keys)

    def agg(self, *aggs) -> "DataFrame":
        """The global (ungrouped) aggregate: one output row."""
        return GroupedData(self, []).agg(*aggs)

    def sort(self, *orders, ascending: bool = True) -> "DataFrame":
        sos = []
        for o in orders:
            if isinstance(o, str):
                o = col(o)
            sos.append(o if isinstance(o, P.SortOrder)
                       else P.SortOrder(o, ascending))
        return self._wrap(P.Sort(self.plan, sos))

    def limit(self, n: int) -> "DataFrame":
        if isinstance(self.plan, P.Sort):
            # ORDER BY + LIMIT plans as TakeOrderedAndProject (per-batch
            # top-k, no full sorted materialization: Spark's planner rule)
            return self._wrap(P.TakeOrderedAndProject(
                self.plan.children[0], self.plan.orders, n))
        return self._wrap(P.Limit(self.plan, n))

    def join(self, other: "DataFrame", on=None,
             how: str = "inner") -> "DataFrame":
        """Equi-join on one or more column names present on both sides."""
        if isinstance(on, str):
            on = [on]
        if not (isinstance(on, (list, tuple)) and on
                and all(isinstance(k, str) for k in on)):
            raise NotImplementedError(
                "join without column-name keys (a cross join or a join "
                "condition) is not ported")
        return self._wrap(P.Join(self.plan, other.plan, how,
                                 [col(k) for k in on], [col(k) for k in on]))

    def collect_table(self) -> HostTable:
        if self.session is None:
            raise ValueError("a DataFrame runs through a session: the port "
                             "has no CPU execution of plans")
        return self.session.execute(self.plan)

    def collect(self):
        t = self.collect_table()
        cols = [c.to_pylist() for c in t.columns]
        return [tuple(c[i] for c in cols) for i in range(t.num_rows)]


class GroupedData:
    def __init__(self, df: DataFrame, keys: Sequence[Expression]):
        self.df = df
        self.keys = list(keys)

    def agg(self, *aggs) -> DataFrame:
        return self.df._wrap(P.Aggregate(self.df.plan, self.keys, list(aggs)))


def from_host_table(table: HostTable, session=None,
                    num_batches: int = 1) -> DataFrame:
    if num_batches <= 1 or table.num_rows == 0:
        batches = [table]
    else:
        per = -(-table.num_rows // num_batches)
        batches = [table.slice(i * per, min(per, table.num_rows - i * per))
                   for i in range(num_batches) if i * per < table.num_rows]
    return DataFrame(P.LocalScan(batches), session)
