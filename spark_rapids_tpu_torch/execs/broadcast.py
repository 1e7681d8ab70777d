"""Broadcast exchange and nested-loop join (port of the
TpuBroadcastExchangeExec and TpuNestedLoopJoinExec parts of
``spark_rapids_tpu/execs/broadcast.py``, with its pair views).

A join's build side whose size estimate is under the broadcast threshold
is materialized ONCE into a single prefix table and reused by every later
execution of the exec: a replayed attempt of the same query (runtime/
speculation.py) does not recompute it. The cached table is a
SpillableBatch, as the reference's: between executions it may move to
the host and comes back on the next one; the batches it is built from are
spillable while they buffer, and their concatenation runs in the OOM
retry loop. It leaves the spill catalog when the exec is dropped.

The nested-loop join runs joins without equi keys (a condition over both
sides, or none): the build table shrinks to its live rows' bucket, and
each probe batch is cut into tiles of at most ``PAIR_BUDGET`` (probe row,
build row) pairs; each tile gathers its pair
columns, evaluates the condition over them and compacts the matched pairs
to the front (the compaction kernel). Every join type: inner and cross
emit the pairs; left (and right, with the sides swapped) outer also each
tile's unmatched probe rows beside a null build side; full outer also
the build rows no tile matched, after the last tile; left semi and left
anti compact the probe rows with (without) a match. The reference's
runtime broadcast decision (``TpuAdaptiveBuildExec``, AQE) is not
ported."""

from __future__ import annotations

import weakref
from typing import List, Optional, Tuple

import torch

from spark_rapids_tpu_torch.columnar import DeviceTable, bucket_for
from spark_rapids_tpu_torch.columnar.table import concat_device
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.execs.join import (
    SEMI_ANTI,
    compact_table,
    null_columns,
    unmatched_build_batch,
)
from spark_rapids_tpu_torch.ops.expr import (
    BoundReference,
    DevVal,
    Expression,
    PrepCtx,
    eval_expr,
    prep_expr,
)

#: max probe_tile * build_rows pairs materialized per nested-loop tile
PAIR_BUDGET = 1 << 20


def _materialize_single(child: TpuExec) -> Tuple[DeviceTable, int]:
    """The child's batches as ONE prefix table, each batch spillable
    while the rest buffer and the concatenation in the OOM retry loop.
    Returns (table, the number of input batches)."""
    from spark_rapids_tpu_torch.runtime.retry import retry_block
    from spark_rapids_tpu_torch.runtime.spill import (
        BufferCatalog,
        SpillableBatch,
    )
    catalog = BufferCatalog.get()
    spills = []
    try:
        for b in child.execute():
            spills.append(SpillableBatch(b, catalog))
            del b
        if not spills:
            raise NotImplementedError(
                "a broadcast of a child that yields no batch is not "
                "ported")
        table = retry_block(lambda: concat_device(
            [sb.get() for sb in spills]).compacted())
        return table, len(spills)
    finally:
        for sb in spills:
            sb.release()


class TpuBroadcastExchangeExec(TpuExec):
    def __init__(self, child: TpuExec):
        self.children = (child,)
        self._cached = None

    def output_schema(self):
        return self.children[0].output_schema()

    def execute(self):
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        from spark_rapids_tpu_torch.runtime.spill import (
            BufferCatalog,
            SpillableBatch,
        )
        if self._cached is None:
            table, n = _materialize_single(self.children[0])
            self.add_metric("broadcastBatches", n)
            self._cached = SpillableBatch(table, BufferCatalog.get())
            weakref.finalize(self, self._cached.release)
        yield retry_block(self._cached.get)


class TpuNestedLoopJoinExec(TpuExec):
    """Conditioned nested-loop join (no equi keys) of any join type. The
    probe side streams in tiles; the build side is one table. A full outer
    join tracks build-row matches across every tile and batch and emits
    the unmatched build rows last. ``join_type`` is the plan's one name
    for it (plan/nodes.py::normalize_join_type)."""

    def __init__(self, left: TpuExec, right: TpuExec, join_type: str,
                 condition: Optional[Expression], left_schema,
                 right_schema):
        self.children = (left, right)
        self.join_type = join_type
        self.condition = condition
        self._left_schema = list(left_schema)
        self._right_schema = list(right_schema)
        self.left_names = [n for n, _ in left_schema]
        self.right_names = [n for n, _ in right_schema]

    def output_schema(self):
        if self.join_type in SEMI_ANTI:
            return list(self._left_schema)
        return self._left_schema + self._right_schema

    def execute(self):
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        jt = self.join_type
        swapped = jt == "right"
        build_child = self.children[0] if swapped else self.children[1]
        probe_child = self.children[1] if swapped else self.children[0]
        batches = list(build_child.execute())
        if not batches:
            raise NotImplementedError("a nested-loop join over a build side "
                                      "that yields no batch is not ported")
        # re-bucketed to its live rows (one host read): the reference keeps
        # the child's capacity, so a selective filter under a large scan
        # (a NOT IN list of 113 customers out of 250,000) would cut the
        # probe into tiles of a few rows
        build = retry_block(lambda: concat_device(batches).shrink())
        del batches
        full_outer = jt == "full"
        b_matched = None
        for pb in probe_child.execute():
            tile = self._tile_rows(pb.capacity, build.capacity)
            for start in range(0, pb.capacity, tile):
                pt = self._slice(pb, start, tile)
                outs, bm = retry_block(
                    lambda p=pt: self._join_tile(p, build, swapped))
                if full_outer:
                    b_matched = bm if b_matched is None else b_matched | bm
                yield from outs
                self.add_metric("nestedLoopTiles", 1)
            self.add_metric("probeBatches", 1)
        if full_outer:
            if b_matched is None:
                b_matched = torch.zeros(build.capacity, dtype=torch.bool,
                                        device=build.device)
            yield self._unmatched_build(build, b_matched, swapped)

    @staticmethod
    def _tile_rows(cap_p: int, cap_b: int) -> int:
        """Probe rows per tile: a power of two rounded DOWN so that
        tile * cap_b never exceeds the pair budget (a huge build side gets
        1-row tiles: slow, but bounded)."""
        t = max(PAIR_BUDGET // max(cap_b, 1), 1)
        return min(1 << (t.bit_length() - 1), cap_p)

    @staticmethod
    def _slice(table: DeviceTable, start: int, tile: int) -> DeviceTable:
        """Rows [start, start + tile) of a prefix table (views, no copy);
        its live count stays on the device."""
        cols = [c.with_arrays(c.data[start:start + tile],
                              c.validity[start:start + tile])
                for c in table.columns]
        nrows = (table.nrows_dev - start).clamp(0, tile).to(torch.int32)
        return DeviceTable(table.names, cols, nrows, tile, table.device)

    def _join_tile(self, pt: DeviceTable, bt: DeviceTable, swapped: bool):
        """Join one probe tile against the whole build table. Returns
        (output tables, the build-match bitmap)."""
        jt = self.join_type
        dev = pt.device
        cap_p, cap_b = pt.capacity, bt.capacity
        npairs = cap_p * cap_b
        out_cap = bucket_for(npairs)
        j = torch.arange(out_cap, dtype=torch.int64, device=dev)
        p_idx = (j // cap_b).clamp(0, cap_p - 1)
        b_idx = (j % cap_b).clamp(0, cap_b - 1)
        live_pair = ((j < npairs) & (p_idx < pt.nrows_dev)
                     & (b_idx < bt.nrows_dev))
        # the left and right tables in plan order (condition and output)
        lt, rt = (bt, pt) if swapped else (pt, bt)
        l_idx, r_idx = (b_idx, p_idx) if swapped else (p_idx, b_idx)
        view = _PairTableView(lt, rt, l_idx, r_idx)
        if self.condition is not None:
            pred = eval_expr(self.condition,
                             prep_expr(self.condition, PrepCtx(view)),
                             view.vals(_refs(self.condition)), npairs,
                             out_cap, dev)
            match = live_pair & pred.data & pred.validity
        else:
            match = live_pair
        # per probe row: any match (one slot more takes the non-matches)
        row_any = _any_at(p_idx, match, cap_p)
        p_live = torch.arange(cap_p, device=dev) < pt.nrows_dev
        if jt in SEMI_ANTI:
            keep = (row_any if jt == "leftsemi" else ~row_any) & p_live
            return [compact_table(pt, keep)], None
        names = self.left_names + self.right_names
        pairs = compact_table(DeviceTable(names, view.pair_columns(), npairs,
                                          out_cap, dev), match)
        outs = [pairs]
        if jt not in ("inner", "cross"):
            # outer: each unmatched live probe row once, the build side null
            un = compact_table(pt, p_live & ~row_any)
            build_schema = self._left_schema if swapped else \
                self._right_schema
            nulls = null_columns(build_schema, cap_p, dev)
            cols = (nulls + list(un.columns) if swapped
                    else list(un.columns) + nulls)
            outs.append(DeviceTable(names, cols, un.nrows_dev, cap_p, dev))
        b_match = _any_at(b_idx, match, cap_b) if jt == "full" else None
        return outs, b_match

    def _unmatched_build(self, bt: DeviceTable, b_matched,
                         swapped: bool) -> DeviceTable:
        probe_schema = self._right_schema if swapped else self._left_schema
        return unmatched_build_batch(bt, b_matched, probe_schema, swapped,
                                     self.left_names + self.right_names)


def _any_at(idx: torch.Tensor, flag: torch.Tensor, n: int) -> torch.Tensor:
    """out[i] = any(flag[idx == i]) for i in [0, n): flagged entries set
    their slot, the rest land on one extra slot that is cut off (the
    reference's ``mode="drop"`` scatter). ``index_fill_`` takes its value
    as a kernel argument: an indexed assignment of ``True`` would copy a
    host scalar to the card, a host sync per tile."""
    out = torch.zeros(n + 1, dtype=torch.bool, device=idx.device)
    out.index_fill_(0, torch.where(flag, idx, torch.full_like(idx, n)), True)
    return out[:n]


def _refs(e: Expression) -> set:
    """Ordinals of the columns ``e`` reads."""
    out = set()
    stack = [e]
    while stack:
        x = stack.pop()
        if isinstance(x, BoundReference):
            out.add(x.ordinal)
        stack.extend(x.children)
    return out


class _PairTableView:
    """The (left, right) pair schema of one tile: column i of the
    concatenated left + right schema, gathered at the tile's pair maps.
    ``columns`` are the source columns, whose dictionaries and domains
    the prep walk reads by ordinal."""

    def __init__(self, lt: DeviceTable, rt: DeviceTable, l_idx, r_idx):
        self.columns = list(lt.columns) + list(rt.columns)
        self._idx = [l_idx] * len(lt.columns) + [r_idx] * len(rt.columns)
        self.device = lt.device

    def vals(self, wanted) -> List[Optional[DevVal]]:
        """Each wanted column's gathered (data, validity); None for the
        others (the condition reads only its own)."""
        return [DevVal(c.data[idx], c.validity[idx]) if i in wanted else None
                for i, (c, idx) in enumerate(zip(self.columns, self._idx))]

    def pair_columns(self):
        """Every column gathered at the pair maps."""
        return [c.with_arrays(c.data[idx], c.validity[idx])
                for c, idx in zip(self.columns, self._idx)]
