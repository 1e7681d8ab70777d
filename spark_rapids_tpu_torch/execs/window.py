"""Window execs (port of ``spark_rapids_tpu/execs/window.py``): every
window function and frame of the reference, its routes for an input of
several batches, ``TpuKeyedBatchExec`` and ``TpuWindowGroupLimitExec``.

One batch (``TpuWindowExec._window``) is windowed by one sort per
distinct (partition, order) spec through the radix sort (ops/ordering.py
``lex_sort``): the operands are the liveness, each partition key as (null
flag, order-isomorphic words) and each order key as its directional
operands, with an int32 row-index payload. Segment (partition) and peer
boundaries are read off the SORTED operands (a word that differs from the
row before), so -0.0 and 0.0 and every NaN fall in one group, as the
reference's peer test has them; dead rows form segments of their own, so
each live segment ends at its last live row. Group starts are a running
count and a lookup (``_last_start``), group ends the next group's start
(``_group_end``). Then, per row in sort order:

  row_number, rank, dense_rank, percent_rank  from the segment and peer
                starts and the segment's end
  lag / lead    a shifted gather masked to the segment
  nth_value     a gather at seg_start + n - 1, visible up to the last peer
  whole         a segmented prefix read at the segment's end (MIN/MAX:
                the aggregate's ``segment_minmax_64``)
  running       a segmented prefix; a RANGE frame reads it at the last peer
  bounded ROWS  prefix differences (integer sums, every count, float
                sums wider than 512 rows), a prefix read (lo unbounded),
                the reverse prefix (hi unbounded), the per-offset sum in
                offset order (512 rows or fewer); MIN/MAX by the reverse
                scan or a doubling sparse table (``_rmq``)

and the values are scattered back to input row order (the child's columns
stay where they are). Integer prefixes are one cumsum minus its value at
the segment's start (exact in int64); float and MIN/MAX prefixes are
log-step doubling scans restricted to the segment (torch.cummax's CUDA
scan of one long row runs in one block, and a float difference would
cancel across partitions). MIN/MAX reduce order-preserving int64 keys, so
doubles follow Spark's NaN rule (NaN above +inf, -0.0 below 0.0) as the
port's GROUP BY MIN/MAX does; the reference's ``jnp.minimum`` lets NaN
propagate (ROADMAP deviation).

Several input batches take one of the reference's routes
(overrides/rules.py picks it):
- keyed batching (``TpuKeyedBatchExec``): a hash exchange into 8 on the
  shared partition keys; each partition is compacted and shrunk to its
  rows' bucket, then windowed alone (``keyBatchedPartitions``);
- the two-pass window (whole-partition aggregates over one PARTITION BY):
  the aggregate exec over the batches, then a join back on null-safe keys
  (``twoPassPartitions``), both passes replaying the batches from
  SpillableBatches (``_ReplayExec``), as the reference's do;
- the bounded-frame stream (finite ROWS frames over one spec): the input
  sorted once into host runs (execs/sort.py ``sorted_run_stream``), each
  range windowed with ``lookback`` rows of context before it while the
  last ``lookahead`` rows wait for the next range
  (``boundedWindowBatches``);
- the running stream (partition-less running windows over one ORDER BY):
  the same sorted ranges, each windowed with the scalar state (counts,
  sums, MIN/MAX) carried across batches as device tensors, never read
  back per batch (``runningWindowBatches``);
- every other window concatenates its batches on the device, each held
  as a SpillableBatch until the concatenation.

The streams' input batches are SpillableBatches while they wait for their
sort, the bounded stream's carried context is one, and every device step
runs in the OOM retry loop (``retry_block``), as in the reference.

The group limit ranks the same way as the window and yields a MASKED
batch keeping the rows ranked at most ``limit``."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import DeviceColumn, DeviceTable
from spark_rapids_tpu_torch.execs.base import (
    TpuExec,
    first_two,
    prepend,
    take,
)
from spark_rapids_tpu_torch.ops import aggregates as agg
from spark_rapids_tpu_torch.ops.expr import (
    PrepCtx,
    eval_expr,
    prep_expr,
    table_vals,
)
from spark_rapids_tpu_torch.ops.window import (
    DenseRank,
    Lag,
    Lead,
    NthValue,
    PercentRank,
    Rank,
    RowNumber,
    WindowExpression,
)

#: the aggregates a window evaluates
DEVICE_WINDOW_AGGS = (agg.Sum, agg.Count, agg.Min, agg.Max, agg.Average)

#: a bounded float frame of at most this many rows is summed offset by
#: offset; a wider one by prefix difference
UNROLL_MAX_ROWS = 512

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def device_window_supported(w: WindowExpression,
                            variable_float_agg: bool = True,
                            rows_frame_max_bound: int = 1 << 16
                            ) -> Tuple[bool, str, bool]:
    """(whether the window column runs on the device, why not, whether
    the CPU route computes it instead): the reference's test, and a SUM
    over a decimal input, which the reference computes as a double and
    cannot download (IndexError). A column neither computes raises."""
    fn = w.function
    frame = w.spec.resolved_frame()
    if isinstance(fn, (RowNumber, Rank, DenseRank, PercentRank)):
        if not w.spec.orders:
            return False, "ranking window function requires an ORDER BY", True
        return True, "", False
    if isinstance(fn, NthValue):
        if fn.ignore_nulls:
            return False, "nth_value IGNORE NULLS is not supported", False
        if frame != ("range", None, 0):
            return False, ("nth_value supports only the default running "
                           "frame"), False
        return True, "", False
    if isinstance(fn, (Lag, Lead)):
        if fn.default is not None and isinstance(fn.data_type, T.StringType):
            return (False, "lag/lead string default value is not supported",
                    True)
        return True, "", False
    if isinstance(fn, DEVICE_WINDOW_AGGS):
        if isinstance(fn, agg.Sum) and fn.child is not None and \
                isinstance(fn.child.data_type, T.DecimalType):
            return False, ("a SUM window over a decimal input is not "
                           "supported (the reference sums it as a double "
                           "and fails to download it)"), False
        kind, lo, hi = frame
        if kind == "range" and not (lo is None and (hi in (0, None))):
            return (False, "only UNBOUNDED..CURRENT/UNBOUNDED range frames",
                    False)
        if kind == "rows":
            # the sparse table's levels and the unrolled offsets grow with
            # the frame's FINITE endpoints
            for bound in (lo, hi):
                if bound is not None and abs(bound) > rows_frame_max_bound:
                    return False, (
                        f"rows frame bound beyond {rows_frame_max_bound} "
                        "is not supported (spark.rapids.sql.window."
                        "rowsFrameMaxBound)"), True
            if (lo is not None and hi is not None
                    and (hi - lo + 1) > UNROLL_MAX_ROWS
                    and isinstance(fn, (agg.Sum, agg.Average))
                    and isinstance(fn.data_type, (T.FloatType, T.DoubleType))
                    and not variable_float_agg):
                return False, ("wide float rows frame uses prefix-difference "
                               "sums (reduction-order variance); enable "
                               "spark.rapids.sql.variableFloatAgg.enabled"
                               ), True
        return True, "", False
    return (False, f"window function {type(fn).__name__} is not supported",
            False)


# ---------------------------------------------------------------------------
# sorted structure

def _eval_keys(table: DeviceTable, exprs) -> list:
    """DevVals of ``exprs`` over ``table`` (a string key must have a
    sorted dictionary: its codes then order and group as the strings)."""
    pctx = PrepCtx(table)
    preps = [prep_expr(e, pctx) for e in exprs]
    if any(p[-1].out_dict is not None and not p[-1].dict_sorted
           for p in preps):
        raise NotImplementedError("a window key over an unsorted string "
                                  "dictionary is not ported")
    cols = table_vals(table)
    return [eval_expr(e, p, cols, table.nrows_dev, table.capacity,
                      table.device, live=table.live)
            for e, p in zip(exprs, preps)]


def _eval_value(table: DeviceTable, expr):
    """(DevVal, the root's prep) of a window function's input."""
    preps = prep_expr(expr, PrepCtx(table))
    return (eval_expr(expr, preps, table_vals(table), table.nrows_dev,
                      table.capacity, table.device, live=table.live),
            preps[-1])


def _breaks(sorted_ops: Sequence[torch.Tensor]) -> torch.Tensor:
    """Rows whose operand tuple differs from the row before (row 0: the
    caller's ``first``)."""
    out = None
    for o in sorted_ops:
        w = o.view(torch.int32) if o.dtype == torch.uint32 else o
        d = w != torch.roll(w, 1)
        out = d if out is None else out | d
    return out


def _last_start(flags: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per row, the position of the last row at or before it whose flag is
    set (``flags[0]`` is set): the reference's max-scan of
    where(flags, idx, 0), as a running count of the flags and a lookup of
    each group's start. (torch.cummax would do it in one call, but its
    CUDA scan of one long row runs in a single block: 10.7 ms at 2^22
    rows on an H100.)"""
    n = flags.shape[0]
    group = torch.cumsum(flags, 0, dtype=torch.int32).to(torch.int64) - 1
    # each group's start writes slot `group`, every other row a slot of
    # its own past n: no two rows write one slot
    start = torch.empty(2 * n, dtype=idx.dtype, device=idx.device)
    start[torch.where(flags, group, idx.to(torch.int64) + n)] = idx
    return start[group]


def _group_end(flags: torch.Tensor) -> torch.Tensor:
    """Per row, the last position of its group (groups start where
    ``flags`` is set, ``flags[0]`` set): the next group's start minus
    one, by the same running count and lookup, with no contended
    scatter."""
    n = flags.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=flags.device)
    group = torch.cumsum(flags, 0, dtype=torch.int32).to(torch.int64) - 1
    # slot g holds group g's start; slot ngroups (never written) holds n
    start = torch.full((2 * n + 1,), n, dtype=torch.int64,
                       device=flags.device)
    start[torch.where(flags, group, pos + n + 1)] = pos
    return start[group + 1] - 1


def _segmented_cumsum(v: torch.Tensor, seg_start: torch.Tensor
                      ) -> torch.Tensor:
    """Inclusive prefix sum restarting at each segment: cumsum(v) minus the
    exclusive total at the segment's start (exact for integers, which
    wrap as the reference's do)."""
    c = torch.cumsum(v, 0, dtype=v.dtype)
    s = seg_start.to(torch.int64)
    return c - (c[s] - v[s])


def _seg_scan(v: torch.Tensor, start: torch.Tensor, op, steps: int
              ) -> torch.Tensor:
    """Inclusive scan of ``op`` over each row's segment [start[i], i]:
    ``steps`` log-step doubling passes (2^steps must reach the longest
    segment), each combining a row with the one ``span`` before it when
    that row lies in its segment, the earlier operand first."""
    n = v.shape[0]
    acc = v
    span = 1
    pos = torch.arange(n, dtype=torch.int64, device=v.device)
    for _ in range(steps):
        if span >= n:
            break
        ok = (pos[span:] - span) >= start[span:]
        nxt = acc.clone()
        nxt[span:] = torch.where(ok, op(acc[:-span], acc[span:]),
                                 acc[span:])
        acc = nxt
        span *= 2
    return acc


def _steps(length: int) -> int:
    """Doubling passes that cover a segment of ``length`` rows."""
    return max(int(length) - 1, 0).bit_length()


def _minmax_keys(v: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 keys of MIN/MAX values: integers (booleans,
    dates, dictionary codes, DECIMAL64) widen; floats map as Spark orders
    them (every NaN one value above +inf, -0.0 below 0.0)."""
    if v.dtype in (torch.float32, torch.float64):
        d = v.to(torch.float64)
        d = torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d)
        raw = d.view(torch.int64)
        return torch.where(raw < 0, raw ^ _I64_MAX, raw)
    return v.to(torch.int64)


def _from_keys(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The values of ``_minmax_keys`` keys (the map is its own inverse)."""
    if dtype in (torch.float32, torch.float64):
        raw = torch.where(k < 0, k ^ _I64_MAX, k)
        return raw.view(torch.float64).to(dtype)
    return k.to(dtype)


def rank_sorted(table: DeviceTable, partition_exprs, orders
                ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Sort ``table``'s rows by (dead last, partition keys, orders) and
    rank them. Returns (perm, idx, {"live", "new_seg", "seg_start",
    "peer_start", "new_peer"}): ``perm`` the sorted rows' input positions
    (int64), ``idx`` the sorted positions (int32), each dict entry in sort
    order. Dead rows (sorted last) start a segment of their own."""
    from spark_rapids_tpu_torch.execs.sort import _directional
    from spark_rapids_tpu_torch.ops.ordering import (
        comparable_operands,
        lex_sort,
        zero_invalid,
    )
    capacity, dev = table.capacity, table.device
    live = table.row_mask()
    operands = [(~live).to(torch.int32)]
    for kv in _eval_keys(table, partition_exprs):
        operands.append((~kv.validity).to(torch.int32))
        operands.extend(comparable_operands(zero_invalid(kv.data,
                                                         kv.validity)))
    n_seg = len(operands)
    for o, kv in zip(orders, _eval_keys(table, [o.expr for o in orders])):
        operands.extend(_directional(kv.data, kv.validity, o.ascending,
                                     o.resolved_nulls_first()))
    idx = torch.arange(capacity, dtype=torch.int32, device=dev)
    res = lex_sort(operands, idx)
    perm = res[-1].to(torch.int64)
    new_seg = (idx == 0) | _breaks(res[:n_seg])
    new_peer = new_seg
    if len(res) - 1 > n_seg:
        new_peer = new_peer | _breaks(res[n_seg:-1])
    return perm, idx, {"live": live[perm], "new_seg": new_seg,
                       "seg_start": _last_start(new_seg, idx),
                       "peer_start": _last_start(new_peer, idx),
                       "new_peer": new_peer}


def rank_values(kind: str, idx: torch.Tensor, ranks: dict) -> torch.Tensor:
    """int32 ranks in sort order: ``kind`` is rownumber, rank or
    denserank."""
    seg_start = ranks["seg_start"]
    if kind == "rownumber":
        return idx - seg_start + 1
    if kind == "rank":
        return ranks["peer_start"] - seg_start + 1
    return _segmented_cumsum(ranks["new_peer"].to(torch.int32), seg_start)


class _Sorted:
    """One spec's sort of a batch and the structure read off it, each in
    sort order; the segment ends, the last peers, the segment ids and the
    doubling passes a segment needs are computed when first asked for."""

    def __init__(self, table: DeviceTable, partition_exprs, orders):
        self.perm, self.idx, self.ranks = rank_sorted(
            table, partition_exprs, orders)
        self.live = self.ranks["live"]
        self.seg_start = self.ranks["seg_start"].to(torch.int64)
        self.pos = self.idx.to(torch.int64)
        self.capacity = table.capacity
        self._memo = {}

    def _get(self, name, make):
        got = self._memo.get(name)
        if got is None:
            got = self._memo[name] = make()
        return got

    @property
    def seg_end(self) -> torch.Tensor:
        return self._get("seg_end", lambda: _group_end(self.ranks["new_seg"]))

    @property
    def peer_last(self) -> torch.Tensor:
        return self._get("peer_last",
                         lambda: _group_end(self.ranks["new_peer"]))

    @property
    def gid(self) -> torch.Tensor:
        return self._get("gid", lambda: torch.cumsum(
            self.ranks["new_seg"], 0, dtype=torch.int64) - 1)

    @property
    def steps(self) -> int:
        """Doubling passes for the longest live segment (one host read)."""
        return self._get("steps", lambda: _steps(int(torch.where(
            self.live, self.seg_end - self.seg_start + 1,
            torch.ones_like(self.seg_start)).max())))

    def prefix(self, v: torch.Tensor) -> torch.Tensor:
        """The segmented inclusive sum of ``v`` (integers exactly by
        difference, floats by the doubling scan)."""
        if v.dtype.is_floating_point:
            return _seg_scan(v, self.seg_start, torch.add, self.steps)
        return _segmented_cumsum(v, self.seg_start)

    def scan(self, v: torch.Tensor, op) -> torch.Tensor:
        return _seg_scan(v, self.seg_start, op, self.steps)

    def rscan(self, v: torch.Tensor, op) -> torch.Tensor:
        """The segmented scan from each row to its segment's end."""
        last = self.capacity - 1
        start = last - torch.flip(self.seg_end, (0,))
        return torch.flip(_seg_scan(torch.flip(v, (0,)), start, op,
                                    self.steps), (0,))


def _rmq(op, ident: int, vv: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
         width: int) -> torch.Tensor:
    """op over [a, b] per row through a doubling sparse table of
    ceil(log2(width)) + 1 levels. Queries have b - a + 1 <= width and stay
    inside one segment, so no query reads an entry that crosses into
    another."""
    levels = [vv]
    span = 1
    while span < width:
        prev = levels[-1]
        shifted = torch.cat([prev[span:], torch.full(
            (span,), ident, dtype=prev.dtype, device=prev.device)])
        levels.append(op(prev, shifted))
        span <<= 1
    table = torch.stack(levels)  # (levels, capacity)
    length = torch.clamp(b - a + 1, min=1)
    k = torch.floor(torch.log2(length.to(torch.float64))).to(torch.int64)
    k = torch.clamp(k, 0, len(levels) - 1)
    right = torch.clamp(b - (torch.ones_like(k) << k) + 1, 0,
                        vv.shape[0] - 1)
    return op(table[k, a], table[k, right])


# ---------------------------------------------------------------------------
# the window exec

class TpuWindowExec(TpuExec):
    """Appends each window column to its input. ``per_batch``: every
    input batch holds whole partitions (``TpuKeyedBatchExec``) and
    windows alone; otherwise the route follows the window columns (the
    module docstring)."""

    def __init__(self, child: TpuExec,
                 window_cols: Sequence[Tuple[str, WindowExpression]],
                 per_batch: bool = False, stream_target_rows: int = 0):
        self.children = (child,)
        self.window_cols = list(window_cols)
        self.per_batch = per_batch
        self.stream_target_rows = stream_target_rows

    def output_schema(self):
        return (self.children[0].output_schema()
                + [(n, w.data_type) for n, w in self.window_cols])

    def execute(self):
        from spark_rapids_tpu_torch.columnar.table import concat_device
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        it = self.children[0].execute()
        if self.per_batch:
            for batch in it:
                yield retry_block(lambda b=batch: self._window(b))
            return
        if self._streamable():
            yield from self._stream_running(it)
            return
        bctx = self._bounded_ctx()
        two_pass = bctx is None and self._two_pass_able()
        items = first_two(it)
        if not items:
            return
        if len(items) == 1:
            first = take(items.pop())
            out = [retry_block(lambda: self._window(first))]
            del first  # the input is not kept while the output is used
            yield out.pop()
            return
        rest = prepend(items, it)
        if two_pass:
            yield from self._stream_two_pass(rest)
        elif bctx is not None:
            yield from self._stream_bounded(rest, *bctx)
        else:
            # whole-partition frames beside ranks, RANGE frames, lag/lead
            # over no shared partition: one batch on the device
            spills = _spillables(rest)
            try:
                merged = retry_block(
                    lambda: concat_device([sb.get() for sb in spills]))
            finally:
                _release(spills)
            yield retry_block(lambda: self._window(merged))

    # -- route tests -------------------------------------------------------
    _RUNNING_FRAMES = (("range", None, 0), ("rows", None, 0))

    def _streamable(self) -> bool:
        """Every column a partition-less running window (ranks or a
        running aggregate) over ONE shared ORDER BY."""
        first_orders = None
        for _, w in self.window_cols:
            if w.spec.partition_exprs or not w.spec.orders:
                return False
            okey = w.spec.key()[1]
            if first_orders is None:
                first_orders = okey
            elif okey != first_orders:
                return False
            fn = w.function
            if isinstance(fn, (RowNumber, Rank, DenseRank)):
                continue
            if isinstance(fn, DEVICE_WINDOW_AGGS) and \
                    w.spec.resolved_frame() in self._RUNNING_FRAMES:
                continue
            return False
        return True

    def _bounded_ctx(self) -> Optional[Tuple[int, int]]:
        """(lookback, lookahead) when every column is an aggregate over a
        FINITE rows frame of one shared (partition, order) spec; None
        otherwise."""
        shared = None
        lookback = lookahead = 0
        for _, w in self.window_cols:
            if not isinstance(w.function, DEVICE_WINDOW_AGGS):
                return None
            kind, lo, hi = w.spec.resolved_frame()
            if kind != "rows" or lo is None or hi is None:
                return None
            if not w.spec.partition_exprs and not w.spec.orders:
                return None  # nothing to sort runs by: the concat
            skey = w.spec.key()
            if shared is None:
                shared = skey
            elif skey != shared:
                return None
            lookback = max(lookback, -min(lo, 0))
            lookahead = max(lookahead, max(hi, 0))
        if shared is None:
            return None
        return lookback, lookahead

    def _two_pass_able(self) -> bool:
        """Every column an aggregate over the whole partition
        (UNBOUNDED..UNBOUNDED) of one non-empty PARTITION BY."""
        shared = None
        for _, w in self.window_cols:
            if not isinstance(w.function, DEVICE_WINDOW_AGGS):
                return False
            _, lo, hi = w.spec.resolved_frame()
            if not (lo is None and hi is None) or not w.spec.partition_exprs:
                return False
            skey = w.spec.key()[0]
            if shared is None:
                shared = skey
            elif skey != shared:
                return False
        return shared is not None

    # -- the two-pass window -----------------------------------------------
    @staticmethod
    def _null_sentinel(dt):
        from spark_rapids_tpu_torch.ops.expr import Literal
        if isinstance(dt, T.StringType):
            return Literal("", dt)
        if isinstance(dt, T.BooleanType):
            return Literal(False, dt)
        if isinstance(dt, (T.FloatType, T.DoubleType)):
            return Literal(0.0, dt)
        return Literal(0, dt)

    @classmethod
    def _null_safe_keys(cls, exprs):
        """(coalesce(k, sentinel), isnull(k)) pairs: the join matches no
        null key, a window partition groups them; the flag key restores
        null-safe matching."""
        from spark_rapids_tpu_torch.ops.conditional import Coalesce
        from spark_rapids_tpu_torch.ops.predicates import IsNull
        keys = []
        for k in exprs:
            keys.append(Coalesce(k, cls._null_sentinel(k.data_type)))
            keys.append(IsNull(k))
        return keys

    def _stream_two_pass(self, batches):
        """Pass 1: the aggregate exec over the batches, one group per
        partition; pass 2: one join of the batches back to their
        partition's results on null-safe keys, the key copies dropped."""
        from spark_rapids_tpu_torch.columnar.table import concat_device
        from spark_rapids_tpu_torch.execs.aggregate import (
            TpuHashAggregateExec,
        )
        from spark_rapids_tpu_torch.execs.join import TpuJoinExec
        from spark_rapids_tpu_torch.ops.expr import BoundReference
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        spills = _spillables(batches)
        try:
            child_schema = self.children[0].output_schema()
            grouping = list(self.window_cols[0][1].spec.partition_exprs)
            agg_specs = [(f"__wa{i}", w.function)
                         for i, (_, w) in enumerate(self.window_cols)]
            agg_exec = TpuHashAggregateExec(
                _ReplayExec(spills, child_schema), grouping, agg_specs,
                [f"__wp{i}" for i in range(len(grouping))])
            agg_batches = list(agg_exec.execute())
            self.add_metric("twoPassPartitions", len(agg_batches))
            agg_table = retry_block(lambda: concat_device(agg_batches))
            del agg_batches
            agg_schema = agg_exec.output_schema()
            right_refs = [BoundReference(i, dt, name_hint=n)
                          for i, (n, dt) in enumerate(agg_schema)]
            join = TpuJoinExec(
                _ReplayExec(spills, child_schema),
                _TableExec([agg_table], agg_schema), "inner",
                self._null_safe_keys(grouping),
                self._null_safe_keys(right_refs[:len(grouping)]), None,
                child_schema, agg_schema)
            del agg_table
            keep = len(child_schema)
            names = [n for n, _ in child_schema] + [n for n, _ in
                                                    self.window_cols]
            for out in join.execute_masked():
                cols = (list(out.columns[:keep])
                        + list(out.columns[keep + len(grouping):]))
                yield DeviceTable(names, cols, out.nrows_dev, out.capacity,
                                  out.device, live=out.live)
        finally:
            _release(spills)

    # -- the bounded-frame stream ------------------------------------------
    def _stream_bounded(self, batches, lookback: int, lookahead: int):
        """Sort once into host runs, stream globally ordered ranges, and
        window each range after the kept context, emitting only the rows
        whose frame is complete: a row emits once ``lookahead`` rows
        follow it; ``lookback`` emitted rows stay as context."""
        from spark_rapids_tpu_torch.columnar.table import concat_device
        from spark_rapids_tpu_torch.execs.sort import (
            TpuSortExec,
            sort_runs,
            sorted_run_stream,
        )
        from spark_rapids_tpu_torch.plan.nodes import SortOrder
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        from spark_rapids_tpu_torch.runtime.spill import (
            BufferCatalog,
            SpillableBatch,
        )
        spec = self.window_cols[0][1].spec
        all_orders = ([SortOrder(e, True) for e in spec.partition_exprs]
                      + list(spec.orders))
        spills = _spillables(batches)
        device = spills[0].device
        runs = sort_runs(TpuSortExec.for_orders(all_orders), spills)
        del spills
        catalog = BufferCatalog.get()
        keep = lookback + lookahead
        carry_sb, c_n = None, 0  # the kept context, spillable
        unemitted = 0  # trailing carry rows still waiting for lookahead
        try:
            for dt in sorted_run_stream(runs, all_orders, device,
                                        self.stream_target_rows or None):
                self.add_metric("boundedWindowBatches", 1)
                b_n = dt.num_rows
                if carry_sb is not None:
                    ext = retry_block(lambda d=dt: concat_device(
                        [carry_sb.get(), d]))
                    ext = DeviceTable(ext.names, ext.columns, c_n + b_n,
                                      ext.capacity, ext.device)
                else:
                    ext = dt
                del dt
                ext_n = c_n + b_n
                emit_start = c_n - unemitted
                emit_end = max(ext_n - lookahead, emit_start)
                if emit_end > emit_start:
                    out = retry_block(lambda e=ext: self._window(e))
                    # the whole window output is dropped before the yield
                    out = [_slice_rows(out, emit_start, emit_end)]
                    yield out.pop()
                unemitted = ext_n - emit_end
                cstart = max(0, ext_n - max(keep, unemitted))
                new_carry = retry_block(
                    lambda e=ext, a=cstart, b=ext_n: _slice_rows(e, a, b))
                del ext
                if carry_sb is not None:
                    carry_sb.release()
                carry_sb = SpillableBatch(new_carry, catalog)
                del new_carry
                c_n = ext_n - cstart
            if unemitted:
                # the last rows: no more input, their frames end at the end
                out = retry_block(lambda: self._window(carry_sb.get()))
                yield _slice_rows(out, c_n - unemitted, c_n)
        finally:
            if carry_sb is not None:
                carry_sb.release()

    # -- the running stream ------------------------------------------------
    def _stream_running(self, batches):
        """Sort the input once into globally ordered range batches
        (``sorted_run_stream``: equal first keys share a batch, which
        keeps RANGE-frame peers whole), then window each batch with the
        running state carried from the batches before it."""
        from spark_rapids_tpu_torch.execs.sort import (
            TpuSortExec,
            sort_runs,
            sorted_run_stream,
        )
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        orders = self.window_cols[0][1].spec.orders
        spills = _spillables(batches)
        if not spills:
            return
        device = spills[0].device
        runs = sort_runs(TpuSortExec.for_orders(orders), spills)
        del spills
        self.add_metric("runningWindowBatches", len(runs))
        state = None
        for dt in sorted_run_stream(runs, orders, device,
                                    self.stream_target_rows or None):
            out, state = retry_block(
                lambda d=dt, st=state: self._stream_batch(d, st))
            del dt
            out = [out]
            yield out.pop()

    def _initial_state(self, device):
        zero = torch.zeros((), dtype=torch.int64, device=device)
        parts = []
        for _, w in self.window_cols:
            fn = w.function
            if isinstance(fn, (agg.Sum, agg.Average)):
                exact = isinstance(fn, agg.Sum) and \
                    isinstance(fn.data_type, T.LongType)
                parts.append((zero if exact else zero.to(torch.float64),
                              zero))
            elif isinstance(fn, (agg.Min, agg.Max)):
                ident = _I64_MAX if isinstance(fn, agg.Min) else _I64_MIN
                parts.append((torch.full((), ident, dtype=torch.int64,
                                         device=device), zero))
            else:  # ranks, counts
                parts.append((zero,))
        return parts

    def _stream_batch(self, table: DeviceTable, state):
        """One sorted batch of the running stream: (the batch with its
        window columns, the state after it). The state is device
        tensors."""
        from spark_rapids_tpu_torch.ops.ordering import (
            comparable_operands,
            zero_invalid,
        )
        cap, dev = table.capacity, table.device
        live = table.row_mask()
        idx = torch.arange(cap, dtype=torch.int64, device=dev)
        ops = [(~live).to(torch.int32)]
        orders = self.window_cols[0][1].spec.orders
        for kv in _eval_keys(table, [o.expr for o in orders]):
            # canonical operands: NaNs are peers, -0.0 == 0.0
            ops.append((~kv.validity).to(torch.int32))
            ops.extend(comparable_operands(zero_invalid(kv.data,
                                                        kv.validity)))
        flags = (idx == 0) | _breaks(ops)
        peer_start = _last_start(flags, idx)
        peer_last = _group_end(flags)
        new_peer = flags & live
        if state is None:
            state = self._initial_state(dev)
        steps = _steps(cap)
        zeros = torch.zeros(cap, dtype=torch.int64, device=dev)
        names, cols = list(table.names), list(table.columns)
        new_state = []
        for (name, w), st in zip(self.window_cols, state):
            fn = w.function
            if isinstance(fn, (RowNumber, Rank)):
                (prev,) = st
                d = prev + (idx if isinstance(fn, RowNumber)
                            else peer_start) + 1
                out = (torch.where(live, d, 0).to(torch.int32), live)
                new_state.append((prev + live.sum(dtype=torch.int64),))
            elif isinstance(fn, DenseRank):
                (prev,) = st
                local = torch.cumsum(new_peer, 0, dtype=torch.int64)
                out = (torch.where(live, prev + local, 0).to(torch.int32),
                       live)
                new_state.append((prev + local[cap - 1],))
            else:
                out, nst = self._stream_agg(w, table, st, live, peer_last,
                                            steps, zeros)
                new_state.append(nst)
            names.append(name)
            cols.append(DeviceColumn(w.data_type, *out))
        return (DeviceTable(names, cols, table.nrows_dev, cap, dev),
                new_state)

    def _stream_agg(self, w, table, st, live, peer_last, steps, zeros):
        """A running aggregate over one sorted batch with the carried
        state: ROWS frames read the batch's prefix at the row, RANGE
        frames at the row's last peer."""
        fn = w.function
        rows_frame = w.spec.resolved_frame()[0] == "rows"

        def run(prefix):
            return prefix if rows_frame else prefix[peer_last]

        if isinstance(fn, agg.Count):
            (prev,) = st
            ok = live if fn.child is None else \
                live & _eval_value(table, fn.child)[0].validity
            ones = ok.to(torch.int64)
            d = prev + run(torch.cumsum(ones, 0))
            return ((torch.where(live, d, 0), live), (prev + ones.sum(),))
        v, prep = _eval_value(table, fn.child)
        sv = live & v.validity
        cnt1 = sv.to(torch.int64)
        if isinstance(fn, (agg.Sum, agg.Average)):
            prev_sum, prev_cnt = st
            if prev_sum.dtype == torch.int64:
                vv = torch.where(sv, v.data.to(torch.int64), 0)
            else:
                vv = torch.where(sv, v.data.to(torch.float64), 0.0)
            tsum = prev_sum + run(torch.cumsum(vv, 0))
            tcnt = prev_cnt + run(torch.cumsum(cnt1, 0))
            has = (tcnt > 0) & live
            d = tsum / torch.clamp(tcnt, min=1).to(torch.float64) \
                if isinstance(fn, agg.Average) else tsum
            return ((torch.where(has, d, torch.zeros_like(d)), has),
                    (prev_sum + vv.sum(), prev_cnt + cnt1.sum()))
        # MIN / MAX over order-preserving keys
        prev_m, prev_cnt = st
        is_min = isinstance(fn, agg.Min)
        op = torch.minimum if is_min else torch.maximum
        ident = _I64_MAX if is_min else _I64_MIN
        if prep.out_dict is not None:
            # each range batch uploads with its own dictionary: a carried
            # code would compare across two (the reference's stream drops
            # the dictionary and cannot download the column)
            raise NotImplementedError(
                f"a partition-less running {type(fn).__name__} of a string "
                "is not ported")
        kk = torch.where(sv, _minmax_keys(v.data), ident)
        scanned = _seg_scan(kk, zeros, op, steps)
        total = op(run(scanned), prev_m)
        tcnt = prev_cnt + run(torch.cumsum(cnt1, 0))
        has = (tcnt > 0) & live
        d = _from_keys(total, v.data.dtype)
        return ((torch.where(has, d, torch.zeros_like(d)), has),
                (op(prev_m, scanned[-1]), prev_cnt + cnt1.sum()))

    # -- one batch ---------------------------------------------------------
    def _window(self, table: DeviceTable) -> DeviceTable:
        from spark_rapids_tpu_torch.ops.scatter32 import scatter_pair
        sorts = {}  # one sort per distinct spec
        names, cols = list(table.names), list(table.columns)
        for name, w in self.window_cols:
            key = w.spec.key()
            s = sorts.get(key)
            if s is None:
                s = sorts[key] = _Sorted(table, w.spec.partition_exprs,
                                         w.spec.orders)
            d, v, prep = _eval_window_fn(w, s, table)
            # back to INPUT row order: window columns of different specs
            # stay aligned with the child's columns
            d, v = scatter_pair(table.capacity, s.perm, d, v)
            names.append(name)
            cols.append(DeviceColumn(
                w.data_type, d, v,
                dictionary=None if prep is None else prep.out_dict,
                dict_sorted=True if prep is None else prep.dict_sorted))
        out = DeviceTable(names, cols, table.nrows_dev, table.capacity,
                          table.device, live=table.live)
        out._nrows_host = table._nrows_host
        return out


def _check_sorted_dict(prep, fn) -> None:
    if prep.out_dict is not None and not prep.dict_sorted:
        raise NotImplementedError(
            f"a window {type(fn).__name__} over a string with an unsorted "
            "dictionary is not ported")


def _eval_window_fn(w: WindowExpression, s: _Sorted, table: DeviceTable):
    """(data, validity, the input's root prep or None) of one window
    column, in sort order."""
    fn = w.function
    kind, lo, hi = w.spec.resolved_frame()
    live, cap = s.live, s.capacity
    if isinstance(fn, (RowNumber, Rank, DenseRank)):
        kinds = {RowNumber: "rownumber", Rank: "rank",
                 DenseRank: "denserank"}
        return rank_values(kinds[type(fn)], s.idx, s.ranks), live, None
    if isinstance(fn, PercentRank):
        m = (s.seg_end - s.seg_start + 1).to(torch.float64)
        rank = (s.ranks["peer_start"].to(torch.int64) - s.seg_start
                + 1).to(torch.float64)
        pr = torch.where(m > 1, (rank - 1.0) / torch.clamp(m - 1.0, min=1.0),
                         torch.zeros_like(m))
        return pr, live, None
    if isinstance(fn, (NthValue, Lag, Lead)):
        src, prep = _eval_value(table, fn.children[0])
        sd, sv = src.data[s.perm], src.validity[s.perm]
        if isinstance(fn, NthValue):
            pos = s.seg_start + (fn.n - 1)
            safe = torch.clamp(pos, max=cap - 1)
            ok = (pos <= s.peer_last) & (pos <= s.seg_end) & live
            return (torch.where(ok, sd[safe], torch.zeros_like(sd)),
                    ok & sv[safe], prep)
        off = fn.offset if isinstance(fn, Lead) else -fn.offset
        j = s.pos + off
        safe = torch.clamp(j, 0, cap - 1)
        gid = s.gid
        ok = (j >= 0) & (j < cap) & (gid[safe] == gid) & live
        data = torch.where(ok, sd[safe], torch.zeros_like(sd))
        valid = ok & sv[safe]
        if fn.default is not None:
            outside = ~ok & live
            data = torch.where(outside, torch.full_like(sd, fn.default),
                               data)
            valid = valid | outside
        return data, valid, prep

    # aggregates
    prep = None
    if isinstance(fn, agg.Count) and fn.child is None:
        sv = live
    else:
        src, prep = _eval_value(table, fn.child)
        sd, sv = src.data[s.perm], src.validity[s.perm] & live
    whole = lo is None and hi is None
    running = lo is None and hi == 0
    seg_start, seg_end, pos = s.seg_start, s.seg_end, s.pos
    if not (whole or running):
        # a bounded rows frame, clipped to the segment; emptiness is
        # judged before clipping into the index range
        a = seg_start if lo is None else torch.maximum(seg_start, pos + lo)
        b = seg_end if hi is None else torch.minimum(seg_end, pos + hi)
        nonempty = (b >= a) & live
        a = torch.clamp(a, 0, cap - 1)
        b = torch.clamp(b, 0, cap - 1)

    if isinstance(fn, (agg.Min, agg.Max)):
        _check_sorted_dict(prep, fn)
        is_min = isinstance(fn, agg.Min)
        op = torch.minimum if is_min else torch.maximum
        ident = _I64_MAX if is_min else _I64_MIN
        cnt = s.prefix(sv.to(torch.int64))
        if whole:
            # the aggregate's GROUP BY MIN/MAX over the segments
            from spark_rapids_tpu_torch.ops.segsum import segment_minmax_64
            wide = sd.to(torch.float64) if sd.dtype.is_floating_point \
                else sd.to(torch.int64)
            r = segment_minmax_64(is_min, wide, sv, s.gid, cap)[s.gid]
            valid = (cnt[seg_end] > 0) & live
            r = r.to(sd.dtype)
        else:
            kk = torch.where(sv, _minmax_keys(sd), ident)
            if running:
                r, n = s.scan(kk, op), cnt
                if kind == "range":
                    r, n = r[s.peer_last], n[s.peer_last]
                valid = (n > 0) & live
            else:
                lo_excl = torch.where(a > seg_start, cnt[torch.clamp(
                    a - 1, min=0)], 0)
                n = torch.where(nonempty, cnt[b] - lo_excl, 0)
                if hi is None:
                    r = s.rscan(kk, op)[a]
                else:
                    width = max(int(hi - (lo if lo is not None else 0)) + 1,
                                1)
                    qa = a if lo is not None else torch.minimum(pos + 1, b)
                    r = _rmq(op, ident, kk, qa, b, width)
                    if lo is None:
                        head = s.scan(kk, op)[torch.minimum(pos, b)]
                        r = op(head, torch.where(b > pos, r, ident))
                valid = (n > 0) & nonempty
            r = _from_keys(r, sd.dtype)
        return torch.where(valid, r, torch.zeros_like(r)), valid, prep

    # sum / count / average by prefix sums
    cnt_all = sv.to(torch.int64)
    if isinstance(fn, agg.Count):
        v = cnt_all
    elif isinstance(fn, agg.Sum) and isinstance(fn.data_type, T.LongType):
        v = torch.where(sv, sd.to(torch.int64), 0)
    else:
        v = torch.where(sv, sd.to(torch.float64), 0.0)
    prefc = s.prefix(cnt_all)
    if whole:
        total = s.prefix(v)[seg_end]
        nn = prefc[seg_end]
    elif running:
        total, nn = s.prefix(v), prefc
        if kind == "range":
            total, nn = total[s.peer_last], nn[s.peer_last]
    else:
        past = a > seg_start
        before = torch.clamp(a - 1, min=0)
        nn = torch.where(nonempty, prefc[b] - torch.where(
            past, prefc[before], 0), 0)
        zero = torch.zeros_like(v)
        if not v.dtype.is_floating_point:
            pref = s.prefix(v)
            total = torch.where(nonempty, pref[b] - torch.where(
                past, pref[before], zero), zero)
        elif lo is None:
            # from the segment's start: a prefix read, no subtraction
            total = torch.where(nonempty, s.prefix(v)[b], zero)
        elif hi is None:
            # to the segment's end: the reverse segmented prefix
            total = torch.where(nonempty, s.rscan(v, torch.add)[a], zero)
        elif hi - lo + 1 <= UNROLL_MAX_ROWS:
            # each offset in turn, in the reference's order
            total = zero
            for k in range(lo, hi + 1):
                j = pos + k
                inside = (j >= seg_start) & (j <= seg_end) & live
                total = total + torch.where(
                    inside, v[torch.clamp(j, 0, cap - 1)], zero)
        else:
            # a wide float frame: the prefix difference, within the
            # segment (the reduction-order variance variableFloatAgg
            # admits)
            pref = s.prefix(v)
            total = torch.where(nonempty, pref[b] - torch.where(
                past, pref[before], zero), zero)
    if isinstance(fn, agg.Count):
        return nn, live, None
    valid = (nn > 0) & live
    r = total / torch.clamp(nn, min=1).to(torch.float64) \
        if isinstance(fn, agg.Average) else total
    return torch.where(valid, r, torch.zeros_like(r)), valid, prep


def _slice_rows(table: DeviceTable, a: int, b: int) -> DeviceTable:
    """Rows [a, b) of a prefix table as a fresh table at their bucket (the
    bounded stream's emit and carry cuts)."""
    from spark_rapids_tpu_torch.columnar import bucket_for
    n = b - a
    cap = bucket_for(max(n, 1))

    def cut(x):
        out = torch.zeros((cap,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        out[:n] = x[a:b]
        return out

    cols = [c.with_arrays(cut(c.data), cut(c.validity))
            for c in table.columns]
    return DeviceTable(table.names, cols, n, cap, table.device)


class _TableExec(TpuExec):
    """Fixed device tables as an exec, run once (the two-pass window's
    aggregate side and the keyed batching's exchange input): each table
    is handed over, not kept, so the consumer can free it."""

    def __init__(self, tables, schema):
        self.children = ()
        self._tables = list(tables)
        self._schema = list(schema)

    def output_schema(self):
        return self._schema

    def execute(self):
        while self._tables:
            yield self._tables.pop(0)


class _ReplayExec(TpuExec):
    """Replays SpillableBatches, pinning each while the consumer holds it
    (the cached-batch source of the two-pass window)."""

    def __init__(self, spills, schema):
        self.children = ()
        self._spills = list(spills)
        self._schema = list(schema)

    def output_schema(self):
        return self._schema

    def execute(self):
        for sb in self._spills:
            with sb.pinned_batch() as dt:
                yield dt
            del dt


def _spillables(batches) -> list:
    """Each batch as a SpillableBatch in the process's catalog (one that
    already is one as it is)."""
    from spark_rapids_tpu_torch.runtime.spill import (
        BufferCatalog,
        SpillableBatch,
    )
    catalog = BufferCatalog.get()
    out = []
    for b in batches:
        out.append(b if isinstance(b, SpillableBatch)
                   else SpillableBatch(b, catalog))
        del b
    return out


def _release(spills) -> None:
    for sb in spills:
        sb.release()


class TpuKeyedBatchExec(TpuExec):
    """Partition-complete batches for a window: a one-batch input passes
    through; several batches are hash-exchanged on the window's PARTITION
    keys into ``num_partitions`` (the port's exchange splits on one
    device), so every partition lands whole in one batch, and each
    exchange partition is compacted and shrunk to its rows' bucket (one
    host read each), so the windows over them sort one input's worth of
    rows in all."""

    def __init__(self, child: TpuExec, keys, num_partitions: int = 8):
        from spark_rapids_tpu_torch.ops.misc import NormalizeNaNAndZero
        self.children = (child,)
        # the window groups -0.0 with 0.0 and every NaN together: the
        # exchange hashes the normalized value, as Spark's planner has it,
        # so each such partition lands whole in one batch (the reference
        # hashes the raw bits and splits them)
        self.keys = [NormalizeNaNAndZero(k) if isinstance(
            k.data_type, (T.FloatType, T.DoubleType)) else k for k in keys]
        self.num_partitions = num_partitions

    def output_schema(self):
        return self.children[0].output_schema()

    def execute(self):
        from spark_rapids_tpu_torch.execs.exchange import (
            TpuShuffleExchangeExec,
        )
        it = self.children[0].execute()
        items = first_two(it)
        if not items:
            return
        if len(items) == 1:
            yield take(items.pop())  # one batch: no exchange
            return
        ex = TpuShuffleExchangeExec(
            _TableExec((take(b) for b in prepend(items, it)),
                       self.output_schema()),
            "hash", self.num_partitions, self.keys)
        self.add_metric("keyBatchedPartitions", self.num_partitions)
        for part in ex.execute():
            yield part.shrink()
        for k, v in ex.metrics.items():
            self.add_metric(k, v)


class TpuWindowGroupLimitExec(TpuExec):
    """Pre-window group limit: one sort ranks every row within its
    partition and the output is a MASKED batch keeping rank <= limit, at
    most limit (plus ties) rows per partition. Purely an optimization:
    the exact rank filter above still applies."""

    produces_masked = True

    def __init__(self, child: TpuExec, partition_exprs, orders,
                 rank_kind: str, limit: int):
        self.children = (child,)
        self.partition_exprs = list(partition_exprs)
        self.orders = list(orders)
        self.rank_kind = rank_kind
        self.limit = int(limit)

    def output_schema(self):
        return self.children[0].output_schema()

    def execute_masked(self):
        from spark_rapids_tpu_torch.runtime.retry import with_retry
        for batch in self.children[0].execute_masked():
            yield from with_retry(batch, self._limit_batch)

    def _limit_batch(self, table: DeviceTable) -> DeviceTable:
        perm, idx, ranks = rank_sorted(table, self.partition_exprs,
                                       self.orders)
        rank = rank_values(self.rank_kind, idx, ranks)
        keep_sorted = ranks["live"] & (rank <= self.limit)
        keep = torch.zeros(table.capacity, dtype=torch.bool,
                           device=table.device)
        keep[perm] = keep_sorted
        self.add_metric("groupLimitBatches", 1)
        return DeviceTable(table.names, table.columns,
                           keep.sum(dtype=torch.int32), table.capacity,
                           table.device, live=keep)
