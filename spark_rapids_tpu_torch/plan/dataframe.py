"""DataFrame API (port of the DataFrame/GroupedData/from_host_table/
range_df part of ``spark_rapids_tpu/plan/dataframe.py``: select,
with_column, filter, group_by, agg, sort, limit, union, sample, cache,
join (on column names, on a condition, or a cross join), with_windows,
repartition, columns, schema, count, temp views and the writers,
``write_parquet`` and ``write.format(...)``): builds plan nodes; a
session executes them."""

from __future__ import annotations

from typing import Optional, Sequence

from spark_rapids_tpu_torch.columnar import HostTable
from spark_rapids_tpu_torch.ops.expr import Expression, col
from spark_rapids_tpu_torch.plan import nodes as P


class DataFrame:
    def __init__(self, plan: P.PlanNode, session=None):
        self.plan = plan
        self.session = session

    def _wrap(self, plan: P.PlanNode) -> "DataFrame":
        return DataFrame(plan, self.session)

    @property
    def schema(self):
        """[(name, DataType)] of the output."""
        return self.plan.output_schema()

    @property
    def columns(self):
        return [n for n, _ in self.plan.output_schema()]

    def create_or_replace_temp_view(self, name: str) -> None:
        """Register this DataFrame's plan as temp view ``name`` in its
        session's catalog (``session.sql`` reads it)."""
        if self.session is None:
            raise ValueError("a temp view needs a DataFrame bound to a "
                             "session")
        self.session.catalog.create_or_replace_temp_view(name, self)

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL (by position; the column types must match)."""
        return self._wrap(P.Union([self.plan, other.plan]))

    def sample(self, fraction: float, seed: int = 0) -> "DataFrame":
        """Bernoulli sample, the same rows as the reference's for the same
        batches and seed."""
        return self._wrap(P.Sample(self.plan, fraction, seed))

    def cache(self) -> "DataFrame":
        """Run this DataFrame once, when a query first reads it, and serve
        later queries from the kept result."""
        return self._wrap(P.CachedRelation(self.plan, self.session))

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
        # LIMIT without ordering: the reference's CollectLimit
        return self._wrap(P.Limit(self.plan, n))

    def join(self, other: "DataFrame", on=None,
             how: str = "inner") -> "DataFrame":
        """``on=None``: a cross join; ``on=<Expression>``: a keyless join
        of type ``how`` on that condition over both sides (the nested-loop
        join); ``on=<name or names>``: an equi-join on columns present on
        both sides."""
        if on is None:
            return self._wrap(P.Join(self.plan, other.plan, "cross", [], []))
        if isinstance(on, Expression):
            return self._wrap(P.Join(self.plan, other.plan, how, [], [],
                                     condition=on))
        if isinstance(on, str):
            on = [on]
        if not (isinstance(on, (list, tuple)) and on
                and all(isinstance(k, str) for k in on)):
            raise ValueError("join `on` must be a column name, a list of "
                             "names, or a condition Expression")
        return self._wrap(P.Join(self.plan, other.plan, how,
                                 [col(k) for k in on], [col(k) for k in on]))

    def with_windows(self, **named_exprs) -> "DataFrame":
        """Append window-function columns:
        ``df.with_windows(rn=F.row_number().over(W.partition_by("k")
        .order_by("v")))``. Built-in window functions only: the
        reference's windowed pandas UDFs (WindowInPandas) are not
        ported."""
        from spark_rapids_tpu_torch.ops.window import WindowExpression
        for n, e in named_exprs.items():
            if not isinstance(e, WindowExpression):
                raise NotImplementedError(
                    f"window column {n}: {type(e).__name__} is not a "
                    "built-in window expression (windowed pandas UDFs are "
                    "not ported)")
        return self._wrap(P.WindowNode(self.plan, list(named_exprs.items())))

    def repartition(self, num_partitions: int, *keys) -> "DataFrame":
        keys = [col(k) if isinstance(k, str) else k for k in keys]
        mode = "hash" if keys else "roundrobin"
        return self._wrap(P.Exchange(self.plan, mode, num_partitions, keys))

    # -- writers (reference: GpuDataWritingCommandExec) ----------------------
    def _write(self, fmt: str, path: str, partition_by, options) -> HostTable:
        """Run a WriteFiles command: the child runs through the overrides
        on the device, the write commits atomically (staging, rename,
        ``_SUCCESS``), and the stats row returns."""
        if self.session is None:
            raise ValueError("a write runs through a session")
        return self.session.execute(
            P.WriteFiles(self.plan, fmt, path, partition_by, options))

    def write_parquet(self, path: str, partition_by=None, **options):
        return self._write("parquet", path, partition_by, options)

    def write_orc(self, path: str, partition_by=None, **options):
        return self._write("orc", path, partition_by, options)

    def write_csv(self, path: str, partition_by=None, **options):
        return self._write("csv", path, partition_by, options)

    def write_json(self, path: str, partition_by=None, **options):
        return self._write("json", path, partition_by, options)

    def write_hive_text(self, path: str, partition_by=None, **options):
        return self._write("hive_text", path, partition_by, options)

    @property
    def write(self) -> "DataFrameWriter":
        """``df.write.format("parquet").option(...).partition_by(...)
        .save(path)``."""
        return DataFrameWriter(self)

    def collect_table(self) -> HostTable:
        if self.session is None:
            raise ValueError("a DataFrame runs through a session: the port "
                             "has no CPU execution of plans")
        sql_text = getattr(self, "sql_text", None)
        if sql_text is not None:
            # the event record's sqlText (TorchSession.sql sets it)
            self.session.next_query_sql = sql_text
        return self.session.execute(self.plan)

    def count(self) -> int:
        return self.collect_table().num_rows

    def collect(self):
        t = self.collect_table()
        cols = [c.to_pylist() for c in t.columns]
        return [tuple(c[i] for c in cols) for i in range(t.num_rows)]


class DataFrameWriter:
    """The pyspark writer surface over ``DataFrame._write``: Parquet, ORC,
    CSV, JSON and Hive text write; another format raises naming its
    ROADMAP item."""

    def __init__(self, df: DataFrame):
        self._df = df
        self._format = "parquet"
        self._options: dict = {}
        self._partition_by = None

    def format(self, fmt: str) -> "DataFrameWriter":
        self._format = fmt.lower()
        return self

    def option(self, key: str, value) -> "DataFrameWriter":
        self._options[key] = value
        return self

    def options(self, **opts) -> "DataFrameWriter":
        self._options.update(opts)
        return self

    def partition_by(self, *cols) -> "DataFrameWriter":
        self._partition_by = list(cols)
        return self

    def save(self, path: str) -> HostTable:
        return self._df._write(self._format, path, self._partition_by,
                               self._options)

    def parquet(self, path: str) -> HostTable:
        return self.format("parquet").save(path)


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


def range_df(start: int, end: Optional[int] = None, step: int = 1,
             session=None) -> DataFrame:
    """spark.range: ``range_df(n)`` is 0 .. n - 1 in a LONG column ``id``."""
    if end is None:
        start, end = 0, start
    return DataFrame(P.RangeNode(start, end, step), session)
