"""Plan nodes (port of the LocalScan, RangeNode, Project, Filter,
Aggregate, Sort, SortOrder, Limit, Union, Expand, Join, Sample,
TakeOrderedAndProject, CachedRelation, WindowNode, WindowGroupLimit and
Exchange parts of ``spark_rapids_tpu/plan/nodes.py``). Nodes bind their
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
            if self._session is None:
                raise ValueError("a cached DataFrame runs through a "
                                 "session: the port has no CPU execution "
                                 "of plans")
            self._table = self._session.execute(self.children[0])
        return self._table

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
        from spark_rapids_tpu_torch.sources import not_ported
        raise not_ported("hive-text" if self.fmt == "hive_text"
                         else self.fmt)

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
        table = session.execute(self.children[0])
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
