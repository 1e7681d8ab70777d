"""DataFrame API (port of the DataFrame/GroupedData/PivotedData/
from_host_table/from_pydict/range_df part of
``spark_rapids_tpu/plan/dataframe.py``: select, with_column, filter,
group_by, agg, pivot, sort, limit, union, sample, cache, join (on column
names, on a condition, or a cross join), a select with one generator
(Generate + Project), stack, replicate_rows, with_windows, repartition,
columns, schema, count, explain, collect, to_pydict, the device export
``to_device_arrays``, temp views and the writers, ``write_parquet`` and
``write.format(...)``): builds plan nodes; a session executes them. The
pandas surface (to_pandas, from_pandas, the pandas UDF frames) is not
ported: pandas is not a dependency of the port."""

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
        """A projection; a select with one generator (explode, posexplode
        [outer]) plans as Generate + Project (Spark's rule), with only
        the columns the other select items read passing through the
        Generate (requiredChildOutput)."""
        from spark_rapids_tpu_torch.ops.collections import Explode
        from spark_rapids_tpu_torch.ops.expr import (
            Alias,
            AttributeReference,
            output_name,
        )
        exprs = [col(e) if isinstance(e, str) else e for e in exprs]
        gens = [(i, e) for i, e in enumerate(exprs)
                if isinstance(e, Explode) or (
                    isinstance(e, Alias)
                    and isinstance(e.children[0], Explode))]
        if not gens:
            return self._wrap(P.Project(self.plan, exprs))
        if len(gens) > 1:
            raise ValueError("only one generator per select (Spark rule)")
        i, e = gens[0]
        gen = e.children[0] if isinstance(e, Alias) else e
        names = (["pos", output_name(e, "col")] if gen.pos
                 else [output_name(e, "col")])
        refs = set()

        def walk(x):
            if isinstance(x, AttributeReference):
                refs.add(x.col_name)
            for ch in x.children:
                walk(ch)

        for j, other in enumerate(exprs):
            if j != i:
                walk(other)
        g = P.Generate(self.plan, gen.children[0], gen.pos, gen.outer,
                       names, required=sorted(refs))
        out = exprs[:i] + [col(n) for n in names] + exprs[i + 1:]
        return self._wrap(P.Project(g, out))

    def stack(self, n: int, *exprs, names=None) -> "DataFrame":
        """stack(n, e1..ek): n output rows a row with k/n columns (the
        reference's rewrite of GpuGenerateExec's Stack: a UNION of n
        projections; the order across the generated rows is unspecified,
        as in Spark)."""
        exprs = [col(e) if isinstance(e, str) else e for e in exprs]
        if n <= 0 or len(exprs) % n != 0:
            raise ValueError("stack(n, ...) needs a multiple of n exprs")
        width = len(exprs) // n
        if names is None:
            names = [f"col{i}" for i in range(width)]
        parts = [self.select(*[exprs[r * width + j].alias(names[j])
                               for j in range(width)]).plan
                 for r in range(n)]
        return self._wrap(parts[0] if len(parts) == 1 else P.Union(parts))

    def replicate_rows(self, n_expr) -> "DataFrame":
        """Each row repeated n times (the reference's GpuReplicateRows
        rewrite): explode(sequence(1, n)) with the sequence dropped; rows
        with n <= 0 are dropped."""
        from spark_rapids_tpu_torch import functions as F
        from spark_rapids_tpu_torch.ops.expr import lit
        n_expr = col(n_expr) if isinstance(n_expr, str) else n_expr
        keep = [c for c, _ in self.plan.output_schema()]
        exploded = self.filter(n_expr > lit(0)).select(
            *[col(c) for c in keep],
            F.explode(F.sequence(lit(1), n_expr)).alias("__rep"))
        return exploded.select(*[col(c) for c in keep])

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
        return self._wrap(P.CollectLimit(self.plan, n))

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

    def write_delta(self, path: str, mode: str = "error",
                    partition_by=None, merge_schema: bool = False) -> int:
        """Write as a Delta table; returns the committed version
        (delta/table.py::write_delta). ``merge_schema`` allows adding
        columns (Spark's mergeSchema)."""
        from spark_rapids_tpu_torch.delta import write_delta
        return write_delta(self.plan, self.session, path, mode=mode,
                           partition_by=partition_by,
                           merge_schema=merge_schema)

    @property
    def write(self) -> "DataFrameWriter":
        """``df.write.format("parquet").option(...).partition_by(...)
        .save(path)``."""
        return DataFrameWriter(self)

    def collect_table(self) -> HostTable:
        if self.session is None:
            raise ValueError("a DataFrame runs through a session")
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

    def to_pydict(self) -> dict:
        return self.collect_table().to_pydict()

    def explain(self) -> str:
        """The session's tagged plan (``TorchSession.explain``), or the
        plan's tree without a session; a SQL-made frame is headed by its
        text on one line (``-- SQL: ...``)."""
        out = (self.session.explain(self.plan) if self.session is not None
               else self.plan.tree_string())
        sql_text = getattr(self, "sql_text", None)
        if sql_text:
            return f"-- SQL: {' '.join(sql_text.split())}\n{out}"
        return out

    def to_device_arrays(self, device=None):
        """The ColumnarRdd analog (the reference's export for ML): run the
        plan and hand back its result ON THE DEVICE, ``({name: (data,
        validity)}, live row count)``, a string column as ``(codes,
        validity, dictionary)``; the tensors are padded to a capacity
        bucket past the row count. The result's batches concatenate on
        the device and nothing downloads. A frame without a session runs
        on the CPU route and its result uploads once to ``device``
        (default: the current CUDA device)."""
        if self.session is not None:
            table = self.session.execute_to_device(self.plan)
        else:
            from spark_rapids_tpu_torch import resolve_device
            from spark_rapids_tpu_torch.columnar.table import (
                upload_host_table,
            )
            table = upload_host_table(self.plan.collect_cpu(),
                                      resolve_device(device))
        out = {}
        for name, c in zip(table.names, table.columns):
            out[name] = ((c.data, c.validity, c.dictionary)
                         if c.dictionary is not None
                         else (c.data, c.validity))
        return out, table.num_rows


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

    def pivot(self, pivot_col: str, values) -> "PivotedData":
        """``group_by(k).pivot(c, [v1, v2]).agg(...)``: each (pivot value,
        aggregate) pair becomes one aggregate over the rows where ``c``
        equals the value (the rewrite Spark applies before PivotFirst);
        no kernel of its own."""
        return PivotedData(self, pivot_col, list(values))


class PivotedData:
    """``group_by(...).pivot(col, values)``, awaiting its aggregates."""

    def __init__(self, grouped: GroupedData, pivot_col: str, values):
        self.grouped = grouped
        self.pivot_col = pivot_col
        self.values = values

    def agg(self, *aggs) -> DataFrame:
        """One column per (value, aggregate): ``agg(when(c == v, x))``,
        ``count(*)`` counting the matching rows; named ``v`` for one
        aggregate, else ``v_name``."""
        from spark_rapids_tpu_torch.ops import aggregates as A
        from spark_rapids_tpu_torch.ops.conditional import CaseWhen
        from spark_rapids_tpu_torch.ops.expr import Alias, lit, output_name
        out = []
        for pv in self.values:
            match = col(self.pivot_col) == lit(pv)
            for i, a in enumerate(aggs):
                name = output_name(a, f"agg{i}")
                fn = a.children[0] if isinstance(a, Alias) else a
                if not isinstance(fn, A.AggregateFunction):
                    raise ValueError(f"pivot agg must be an aggregate: {a!r}")
                if fn.child is None:
                    masked = A.Count(CaseWhen(match, lit(1)))
                else:
                    masked = fn.with_children([CaseWhen(match, fn.child)])
                label = f"{pv}" if len(aggs) == 1 else f"{pv}_{name}"
                out.append(Alias(masked, label))
        return self.grouped.agg(*out)


def from_pydict(data, dtypes=None, session=None,
                num_batches: int = 1) -> DataFrame:
    """A DataFrame over ``{name: values}`` (``HostTable.from_pydict``)."""
    return from_host_table(HostTable.from_pydict(data, dtypes), session,
                           num_batches)


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
