"""Plan nodes (port of ``spark_rapids_tpu/plan/nodes.py``: LocalScan,
RangeNode, Project, Filter, Aggregate, Sort, SortOrder, Limit, Union,
Expand, Join, Sample, TakeOrderedAndProject, CachedRelation, WindowNode,
WindowGroupLimit, Exchange, Generate and WriteFiles). Nodes bind their
expressions against the child's schema at construction; the overrides
layer (overrides/rules.py) turns them into device execs, or leaves a node
its tag sends to the CPU route as it is: ``execute_cpu`` runs it over
host batches with the reference's Spark-exact numpy semantics
(``collect_cpu``: all of it as one HostTable)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.ops import aggregates as agg
from spark_rapids_tpu_torch.ops.expr import (
    Alias,
    Expression,
    bind,
    evaluate_cpu,
    output_name,
)

Schema = List[Tuple[str, T.DataType]]


class PlanNode:
    children: Tuple["PlanNode", ...] = ()

    def output_schema(self) -> Schema:
        raise NotImplementedError

    def execute_cpu(self) -> Iterator[HostTable]:
        """The node's output batches on the CPU route."""
        raise NotImplementedError(f"{self.name}.execute_cpu")

    def collect_cpu(self) -> HostTable:
        batches = list(self.execute_cpu())
        if not batches:
            from spark_rapids_tpu_torch.columnar.table import (
                empty_host_table,
            )
            return empty_host_table(self.output_schema())
        from spark_rapids_tpu_torch.columnar.table import concat_host
        return concat_host(batches)

    def describe(self) -> str:
        return self.name

    def tree_string(self, indent: int = 0) -> str:
        """The plan one node a line, children indented (a session-less
        ``DataFrame.explain``)."""
        s = "  " * indent + self.describe() + "\n"
        for c in self.children:
            s += c.tree_string(indent + 1)
        return s

    def estimate_bytes(self) -> Optional[int]:
        """Rough output-size upper bound for physical planning (broadcast
        or not). None = unknown. Row-preserving or shrinking unary nodes
        propagate their child's estimate."""
        return None

    @property
    def name(self) -> str:
        return type(self).__name__


class LocalScan(PlanNode):
    """In-memory scan over pre-built host batches. ``columns`` (ordinals of
    the batches' columns, set by column pruning) narrows the scan to those
    columns: no other column is uploaded."""

    def __init__(self, batches: Sequence[HostTable],
                 columns: Optional[Sequence[int]] = None):
        if not batches:
            raise ColumnarProcessingError("LocalScan needs at least one batch")
        self.batches = list(batches)
        self.columns = None if columns is None else tuple(columns)

    def with_columns(self, columns: Sequence[int]) -> "LocalScan":
        base = self.columns or tuple(range(len(self.batches[0].names)))
        return LocalScan(self.batches, [base[i] for i in columns])

    def output_schema(self):
        schema = self.batches[0].schema()
        if self.columns is None:
            return schema
        return [schema[i] for i in self.columns]

    def execute_cpu(self):
        for b in self.batches:
            if self.columns is None:
                yield b
            else:
                yield HostTable([b.names[i] for i in self.columns],
                                [b.columns[i] for i in self.columns])

    def describe(self):
        return f"LocalScan[{len(self.batches)} batches]"

    def estimate_bytes(self):
        if self.columns is None:
            return sum(b.nbytes() for b in self.batches)
        return sum(b.columns[i].nbytes() for b in self.batches
                   for i in self.columns)


class RangeNode(PlanNode):
    """spark.range: one LONG column ``name`` of start, start + step, ...
    below ``end`` (above it for a negative step), in batches of
    ``batch_rows`` rows (the reference's GpuRangeExec)."""

    def __init__(self, start: int, end: int, step: int = 1,
                 batch_rows: int = 1 << 20, name: str = "id"):
        if step == 0:
            raise ColumnarProcessingError("range step must not be 0")
        self.start, self.end, self.step = int(start), int(end), int(step)
        self.batch_rows = int(batch_rows)
        self.col_name = name

    def num_rows(self) -> int:
        return max(0, -(-(self.end - self.start) // self.step))

    def output_schema(self):
        return [(self.col_name, T.LONG)]

    def estimate_bytes(self):
        return 9 * self.num_rows()

    def execute_cpu(self):
        total = self.num_rows()
        pos = 0
        while pos < total:
            cnt = min(self.batch_rows, total - pos)
            vals = self.start + (pos + np.arange(cnt, dtype=np.int64)) \
                * self.step
            yield HostTable([self.col_name], [HostColumn(T.LONG, vals)])
            pos += cnt

    def describe(self):
        return f"Range({self.start}, {self.end}, {self.step})"


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

    def execute_cpu(self):
        for batch in self.child.execute_cpu():
            yield evaluate_cpu(self.exprs, batch, self.names)

    def describe(self):
        return f"Project{self.names}"

    def estimate_bytes(self):
        # projections can WIDEN rows: scale the child's estimate by the
        # column-count ratio
        est = self.children[0].estimate_bytes()
        if est is None:
            return None
        n_in = max(len(self.children[0].output_schema()), 1)
        return int(est * max(len(self.names), 1) / n_in) \
            if len(self.names) > n_in else est


class Generate(PlanNode):
    """explode / posexplode [outer] of an array (reference: Generate,
    GpuGenerateExec.scala). Output: the required child columns, then
    [pos], then the element column. Without outer, rows with a null or
    empty array produce nothing; with outer, one row of nulls each."""

    def __init__(self, child: PlanNode, gen_child: Expression,
                 pos: bool, outer: bool, out_names: Sequence[str],
                 required: Optional[Sequence[str]] = None):
        self.children = (child,)
        schema = child.output_schema()
        self.gen_child = bind(gen_child, schema)
        if not isinstance(self.gen_child.data_type, T.ArrayType):
            raise ColumnarProcessingError(
                f"explode input must be an array, got "
                f"{self.gen_child.data_type.simple_string()}")
        self.pos = pos
        self.outer = outer
        self.out_names = list(out_names)
        # requiredChildOutput pruning (Spark's Generate): only the child
        # columns a consumer reads pass through
        names = [n for n, _ in schema]
        self.required = [n for n in names
                         if required is None or n in set(required)]

    def output_schema(self):
        child_schema = dict(self.children[0].output_schema())
        out = [(n, child_schema[n]) for n in self.required]
        i = 0
        if self.pos:
            out.append((self.out_names[i], T.INT))
            i += 1
        out.append((self.out_names[i], self.gen_child.data_type.element_type))
        return out

    def execute_cpu(self):
        from spark_rapids_tpu_torch.columnar.nested import fixed_np_dtype
        e_dt = self.gen_child.data_type.element_type
        e_np = fixed_np_dtype(e_dt) or object
        for full in self.children[0].execute_cpu():
            arr = self.gen_child.eval_cpu(full)
            rows = arr.data
            rows_idx, poss, vals, vvalid, pvalid = [], [], [], [], []
            # iterate the FULL batch: the pruned pass-through table may
            # have no columns (explode with nothing else selected)
            for i in range(full.num_rows):
                if arr.validity[i] and len(rows[i]):
                    for k, v in enumerate(rows[i]):
                        rows_idx.append(i)
                        poss.append(k)
                        vals.append(v if v is not None or e_np is object
                                    else 0)
                        vvalid.append(v is not None)
                        pvalid.append(True)
                elif self.outer:
                    rows_idx.append(i)
                    poss.append(0)
                    vals.append(None if e_np is object else 0)
                    vvalid.append(False)
                    pvalid.append(False)  # pos is null on outer null rows
            idx = np.asarray(rows_idx, dtype=np.int64)
            names = list(self.required)
            cols = [full.columns[full.names.index(n)].take(idx)
                    for n in self.required]
            i = 0
            if self.pos:
                cols.append(HostColumn(T.INT, np.asarray(poss, np.int32),
                                       np.asarray(pvalid, dtype=np.bool_)))
                names.append(self.out_names[i])
                i += 1
            data = np.empty(len(vals), dtype=object) if e_np is object \
                else np.asarray(vals, dtype=e_np)
            if e_np is object:
                for j, v in enumerate(vals):
                    data[j] = v
            cols.append(HostColumn(e_dt, data,
                                   np.asarray(vvalid, dtype=np.bool_)))
            names.append(self.out_names[i])
            yield HostTable(names, cols)

    def describe(self):
        kind = ("posexplode" if self.pos else "explode") + \
            ("_outer" if self.outer else "")
        return f"Generate[{kind}({self.gen_child!r})]"


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

    def execute_cpu(self):
        for batch in self.children[0].execute_cpu():
            pred = self.condition.eval_cpu(batch)
            idx = np.nonzero(pred.validity & pred.data.astype(np.bool_))[0]
            yield HostTable(batch.names, [c.take(idx) for c in batch.columns])

    def describe(self):
        return f"Filter[{self.condition!r}]"


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

    def execute_cpu(self):
        from spark_rapids_tpu_torch.plan.cpu_agg import aggregate_cpu
        table = self.children[0].collect_cpu()
        yield aggregate_cpu(table, self.grouping, self.agg_specs)

    def describe(self):
        return (f"Aggregate[keys={self.grouping_names}, "
                f"aggs={[n for n, _ in self.agg_specs]}]")


@dataclass(eq=False)
class SortOrder:
    expr: Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None  # Spark default: asc->first, desc->last

    def resolved_nulls_first(self) -> bool:
        return self.ascending if self.nulls_first is None else self.nulls_first


def _stable_sort_indices(cols: List[HostColumn], orders: List[SortOrder],
                         n: int) -> np.ndarray:
    """Multi-key stable sort: keys least-significant first, each reduced
    to a dense integer rank (strings too, and a descending order stays
    stable), with nulls ranked before or after every value per the
    order's nulls_first."""
    idx = np.arange(n)
    for col, order in reversed(list(zip(cols, orders))):
        if isinstance(col.dtype, T.StringType):
            vals = np.where(col.validity, col.data, "")
        else:
            vals = col.data
        sub_vals = vals[idx]
        sub_valid = col.validity[idx]
        uniq = np.unique(sub_vals)
        rank = np.searchsorted(uniq, sub_vals).astype(np.int64)
        if not order.ascending:
            rank = len(uniq) - 1 - rank
        null_rank = -1 if order.resolved_nulls_first() else len(uniq)
        rank = np.where(sub_valid, rank, null_rank)
        idx = idx[np.argsort(rank, kind="stable")]
    return idx


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

    def execute_cpu(self):
        table = self.children[0].collect_cpu()
        keys = [o.expr.eval_cpu(table) for o in self.orders]
        idx = _stable_sort_indices(keys, self.orders, table.num_rows)
        yield HostTable(table.names, [c.take(idx) for c in table.columns])

    def describe(self):
        return f"Sort[{len(self.orders)} keys]"


class Limit(PlanNode):
    """LIMIT n without an ordering: the reference's CollectLimit (the
    first n rows in batch order; ORDER BY + LIMIT plans as
    TakeOrderedAndProject)."""

    def __init__(self, child: PlanNode, limit: int):
        self.children = (child,)
        self.limit = int(limit)

    def output_schema(self):
        return self.children[0].output_schema()

    def estimate_bytes(self):
        return self.children[0].estimate_bytes()

    def execute_cpu(self):
        remaining = self.limit
        for batch in self.children[0].execute_cpu():
            if remaining <= 0:
                return
            take = min(batch.num_rows, remaining)
            yield batch if take == batch.num_rows else batch.slice(0, take)
            remaining -= take

    def describe(self):
        return f"Limit[{self.limit}]"


class CollectLimit(Limit):
    """``DataFrame.limit`` without an ordering (the reference's
    CollectLimit, GpuCollectLimitExec): the first n rows in batch order,
    converted as Limit is; its kill switch is
    ``spark.rapids.sql.exec.CollectLimit``."""

    def describe(self):
        return f"CollectLimit[{self.limit}]"


class Union(PlanNode):
    """UNION ALL: the children's batches one after another; every child
    has the first child's column types (its names are the output's)."""

    def __init__(self, children: Sequence[PlanNode]):
        self.children = tuple(children)
        s0 = self.children[0].output_schema()
        for c in self.children[1:]:
            if [dt for _, dt in c.output_schema()] != [dt for _, dt in s0]:
                raise ColumnarProcessingError("UNION schema mismatch")

    def output_schema(self):
        return self.children[0].output_schema()

    def estimate_bytes(self):
        ests = [c.estimate_bytes() for c in self.children]
        return None if any(e is None for e in ests) else sum(ests)

    def execute_cpu(self):
        names = [n for n, _ in self.output_schema()]
        for c in self.children:
            for b in c.execute_cpu():
                yield HostTable(names, b.columns)


class Expand(PlanNode):
    """Each input row through N projections, one output row each (the
    reference's GpuExpandExec; Spark plans ROLLUP, CUBE and GROUPING SETS
    with it, though no DataFrame or SQL entry point of either package
    builds one)."""

    def __init__(self, child: PlanNode,
                 projections: Sequence[Sequence[Expression]],
                 names: Sequence[str]):
        self.children = (child,)
        schema = child.output_schema()
        self.projections = [[bind(e, schema) for e in proj]
                            for proj in projections]
        self.names = list(names)

    def output_schema(self):
        return [(n, e.data_type)
                for n, e in zip(self.names, self.projections[0])]

    def execute_cpu(self):
        for batch in self.children[0].execute_cpu():
            for proj in self.projections:
                yield evaluate_cpu(proj, batch, self.names)


class Sample(PlanNode):
    """Bernoulli sample without replacement: each batch's rows kept where
    a draw of ``numpy.random.default_rng(seed)`` (one stream over the
    batches, in order) falls below ``fraction``, as the reference's."""

    def __init__(self, child: PlanNode, fraction: float, seed: int = 0):
        self.children = (child,)
        self.fraction = float(fraction)
        self.seed = int(seed)

    def output_schema(self):
        return self.children[0].output_schema()

    def estimate_bytes(self):
        return self.children[0].estimate_bytes()

    def execute_cpu(self):
        rng = np.random.default_rng(self.seed)
        for batch in self.children[0].execute_cpu():
            idx = np.nonzero(rng.random(batch.num_rows) < self.fraction)[0]
            yield HostTable(batch.names, [c.take(idx) for c in batch.columns])

    def describe(self):
        return f"Sample[fraction={self.fraction}, seed={self.seed}]"


class CachedRelation(PlanNode):
    """``df.cache()``: the child runs once, through the session, when a
    query first reads it; later queries scan the kept host table, whose
    uploads stay cached on the device by column (the reference's
    InMemoryTableScan). A planning leaf: its child is planned and run by
    ``materialize``."""

    def __init__(self, child: PlanNode, session=None):
        self.children = (child,)
        self._session = session
        self._table: Optional[HostTable] = None

    def materialize(self) -> HostTable:
        if self._table is None:
            if self._session is not None:
                self._table = self._session.execute(self.children[0])
            else:
                self._table = self.children[0].collect_cpu()
        return self._table

    def execute_cpu(self):
        yield self.materialize()

    def describe(self):
        state = "materialized" if self._table is not None else "lazy"
        return f"CachedRelation[{state}]"

    def output_schema(self):
        return self.children[0].output_schema()

    def estimate_bytes(self):
        if self._table is not None:
            return self._table.nbytes()
        return self.children[0].estimate_bytes()


#: Spark's spellings of each join type (lower case, "_" removed) -> the
#: one name the plan and the execs use
_JOIN_TYPE_NAMES = {
    "inner": "inner", "cross": "cross",
    "left": "left", "leftouter": "left",
    "right": "right", "rightouter": "right",
    "full": "full", "fullouter": "full", "outer": "full",
    "leftsemi": "leftsemi", "leftanti": "leftanti"}


def normalize_join_type(join_type: str) -> str:
    """The one name (inner, cross, left, right, full, leftsemi, leftanti)
    of a join type in any of Spark's spellings."""
    jt = _JOIN_TYPE_NAMES.get(join_type.lower().replace("_", ""))
    if jt is None:
        raise NotImplementedError(f"join type {join_type} is not supported")
    return jt


class Join(PlanNode):
    """Join of any type (inner, cross, left, right, full, leftsemi,
    leftanti; ``join_type`` in any of Spark's spellings, kept as its one
    name) on equi keys and/or a condition over both sides. The output
    schema is the left schema then the right one (a join on a column name
    keeps both key columns, as the reference); semi and anti joins output
    the left side only."""

    def __init__(self, left: PlanNode, right: PlanNode, join_type: str,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 condition: Optional[Expression] = None):
        self.children = (left, right)
        self.join_type = normalize_join_type(join_type)
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

    def execute_cpu(self):
        from spark_rapids_tpu_torch.plan.cpu_join import join_cpu
        left = self.children[0].collect_cpu()
        right = self.children[1].collect_cpu()
        out = join_cpu(left, right, self.join_type, self.left_keys,
                       self.right_keys, self.condition)
        # the output names are the plan's (a join on a column name keeps
        # both key columns)
        yield HostTable([n for n, _ in self.output_schema()], out.columns)

    def describe(self):
        return f"Join[{self.join_type}]"


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

    def execute_cpu(self):
        table = self.children[0].collect_cpu()
        keys = [o.expr.eval_cpu(table) for o in self.orders]
        take = _stable_sort_indices(keys, self.orders,
                                    table.num_rows)[:self.limit]
        yield HostTable(table.names, [c.take(take) for c in table.columns])

    def describe(self):
        return f"TakeOrderedAndProject[limit={self.limit}]"


class WindowNode(PlanNode):
    """Appends window-function columns (``[(name, WindowExpression)]``,
    bound against the child's schema) to the child's output."""

    def __init__(self, child: PlanNode, window_cols):
        self.children = (child,)
        schema = child.output_schema()
        self.window_cols = [(name, w.bind(schema)) for name, w in window_cols]

    def output_schema(self):
        return (self.children[0].output_schema()
                + [(n, w.data_type) for n, w in self.window_cols])

    def execute_cpu(self):
        from spark_rapids_tpu_torch.ops.window import eval_window_cpu
        table = self.children[0].collect_cpu()
        names, cols = list(table.names), list(table.columns)
        for name, w in self.window_cols:
            cols.append(eval_window_cpu(table, w))
            names.append(name)
        yield HostTable(names, cols)

    def describe(self):
        return f"Window[{[n for n, _ in self.window_cols]}]"


class WindowGroupLimit(PlanNode):
    """Pre-window group limit (Spark 3.5's WindowGroupLimit): under a
    ``rank_col <= k`` filter right above a window, at most k (plus ties)
    rows per partition need to enter it. The overrides insert it (bound
    partition expressions and orders of the window's spec); the exact
    filter above stays."""

    def __init__(self, child: PlanNode, partition_exprs, orders,
                 rank_kind: str, limit: int):
        self.children = (child,)
        self.partition_exprs = list(partition_exprs)
        self.orders = list(orders)
        self.rank_kind = rank_kind  # rownumber | rank | denserank
        self.limit = int(limit)

    def output_schema(self):
        return self.children[0].output_schema()

    def estimate_bytes(self):
        return self.children[0].estimate_bytes()

    def execute_cpu(self):
        # a pure optimization: the exact filter above stays
        yield from self.children[0].execute_cpu()

    def describe(self):
        return f"WindowGroupLimit[{self.rank_kind} <= {self.limit}]"


class Exchange(PlanNode):
    """Repartition (``hash`` on keys, ``roundrobin``, ``range`` or
    ``single``) into ``num_partitions`` partitions; rows are unchanged."""

    def __init__(self, child: PlanNode, partitioning: str,
                 num_partitions: int, keys: Sequence[Expression] = ()):
        self.children = (child,)
        self.partitioning = partitioning
        self.num_partitions = num_partitions
        schema = child.output_schema()
        self.keys = [bind(k, schema) for k in keys]

    def output_schema(self):
        return self.children[0].output_schema()

    def estimate_bytes(self):
        return self.children[0].estimate_bytes()

    def execute_cpu(self):
        # one process: rows pass through (the device splits them)
        yield from self.children[0].execute_cpu()

    def describe(self):
        return f"Exchange[{self.partitioning}, n={self.num_partitions}]"


class WriteFiles(PlanNode):
    """A data-writing command (reference: GpuDataWritingCommandExec with
    GpuFileFormatDataWriter): the session runs the child (through the
    overrides, on the device), writes its rows under the transactional
    commit protocol (io/committer.py: staging under
    ``_temporary/<job>/<attempt>/``, atomic per-file promotion at task
    commit, a ``_SUCCESS`` manifest at job commit, full rollback on
    abort), and returns one stats row (numFiles, numRows, numBytes).

    The job id is fixed when the node is made, so running the SAME node
    again is idempotent: a run that finds its own job id in the
    destination's manifest returns the recorded stats and writes
    nothing; a run after a failed one re-stages the same file names."""

    def __init__(self, child: PlanNode, fmt: str, path: str,
                 partition_by: Optional[Sequence[str]] = None,
                 options: Optional[dict] = None):
        import uuid
        self.children = (child,)
        self.fmt = fmt
        self.path = path
        self.partition_by = list(partition_by) if partition_by else None
        self.options = dict(options or {})
        #: idempotency key: stable across runs of this plan node
        self.job_id = uuid.uuid4().hex[:16]
        self._attempt = 0

    def output_schema(self):
        return [("numFiles", T.LONG), ("numRows", T.LONG),
                ("numBytes", T.LONG)]

    def _writer(self):
        if self.fmt == "parquet":
            from spark_rapids_tpu_torch.io.parquet import write_parquet
            return write_parquet
        if self.fmt == "orc":
            from spark_rapids_tpu_torch.io.orc import write_orc
            return write_orc
        if self.fmt == "csv":
            from spark_rapids_tpu_torch.io.csv import write_csv
            return write_csv
        if self.fmt == "json":
            from spark_rapids_tpu_torch.io.json import write_json
            return write_json
        if self.fmt in ("hive_text", "hive", "hive-text", "hivetext"):
            from spark_rapids_tpu_torch.io.hive_text import write_hive_text
            return write_hive_text
        raise NotImplementedError(
            f"WriteFiles has no {self.fmt!r} writer (nor has the "
            "reference's); a Delta table is written with "
            "DataFrame.write_delta")

    @staticmethod
    def _stats_row(num_files: int, num_rows: int, num_bytes: int
                   ) -> HostTable:
        import numpy as np

        from spark_rapids_tpu_torch.columnar import HostColumn
        return HostTable(
            ["numFiles", "numRows", "numBytes"],
            [HostColumn(T.LONG, np.asarray([v], dtype=np.int64))
             for v in (num_files, num_rows, num_bytes)])

    def run(self, session) -> HostTable:
        """Run the child through ``session``, then the committed write;
        returns the stats row."""
        return self._write(lambda: session.execute(self.children[0]))

    def execute_cpu(self):
        yield self._write(self.children[0].collect_cpu)

    def _write(self, produce) -> HostTable:
        """The committed write of ``produce()``'s table, or the recorded
        stats when this node's job already committed."""
        from spark_rapids_tpu_torch.io.committer import (
            WriteJob,
            read_manifest,
        )
        writer = self._writer()
        manifest = read_manifest(self.path)
        if manifest is not None and manifest.get("jobId") == self.job_id:
            return self._stats_row(manifest["numFiles"],
                                   manifest["numRows"],
                                   manifest["numBytes"])
        table = produce()
        job = WriteJob(self.path, job_id=self.job_id, attempt=self._attempt)
        self._attempt += 1
        try:
            writer(table, self.path, partition_by=self.partition_by,
                   committer=job, **self.options)
            final_files = job.commit_task()
            manifest = job.commit_job(num_rows=table.num_rows)
        except BaseException:
            # any failure (an injected fault, a full disk) rolls the job
            # back: promoted files deleted, staging swept
            job.abort()
            raise
        return self._stats_row(len(final_files), table.num_rows,
                               manifest["numBytes"])

    def describe(self):
        part = (f", partitionBy={self.partition_by}"
                if self.partition_by else "")
        return f"WriteFiles[{self.fmt} -> {self.path}{part}]"
