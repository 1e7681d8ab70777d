"""Equi-joins and cross joins (port of ``spark_rapids_tpu/execs/join.py``:
``_dense_rank_ops``, ``JoinKernel``'s probe and its inner and left-outer
expansions, ``_DirectJoinKernel``, ``_ColumnGather`` and ``TpuJoinExec``
with every join type, the residual condition, the sub-partitioned build
and the cross join).

The build side is one prefix table; probe batches stream through, each
joined by the first route that applies, as in the reference:

1. DIRECT (torch ops; inner, left outer, left semi and left anti): a
   single integer key whose build values span less than
   ``directTableMultiplier`` x the build capacity scatters build rowids
   into a table indexed by ``key - min(key)``; each probe row gathers its
   match. The output stays MASKED at the probe's capacity (no
   compaction). Device flags for "keys too sparse" and "a build key
   repeats" (semi and anti joins too, as the reference) are validated at
   collect (runtime/speculation.py); a failure blocklists the site and
   the query replays.
2. HASH PROBE (kernels/hashprobe.py, the CUDA probe): a single integer
   key, any spread, any join type. Its ``fail`` flag (a homeless build
   row or a duplicated build key) is validated the same way.
3. SORT-BASED: both sides' keys are dense-ranked into one code space
   through the sort kernel; per-code build counts and their exclusive
   prefix give each probe row its match range, and ranges expand into
   (left, right) gather maps at a speculative output capacity (the probe
   side's bucket; a miss replays on the exact size read on the host).

Join types: inner; left outer (an unmatched probe row emits one row with
a null build side); right outer as a left outer with the sides swapped
(the left child builds) and the output columns put back in order; full
outer as a left outer per probe batch, a build-match bitmap accumulated
across batches and one batch of the unmatched build rows at the end
(never a speculated size); left semi and left anti from the probe's
``matched`` flags (masked output); cross (``_cross``). A residual
condition post-filters inner and cross joins; the overrides refuse it on
the other types, as the reference does.

A build side larger than ``spark.rapids.sql.join.subPartition.targetBytes``
splits by Spark's murmur3 key hash into ceil(size / target) partitions
(at most ``maxSubPartitions``); each probe batch splits the same way and
partition pairs join independently. The target is capped by the memory
arbiter's scan chunk (``min(conf, MEMORY.scan_chunk_bytes())``), as the
reference's, so a build past the device budget's chunk share splits even
below the conf value.

The build table (each build partition when sub-partitioned) is a
SpillableBatch, pinned only while a probe batch joins it, so between
probe batches it may move to the host; each probe batch joins inside the
OOM retry loop (``retry_block``).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import (
    DeviceColumn,
    DeviceTable,
    bucket_for,
)
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.columnar.table import concat_device
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.ops.expr import Expression, compile_project
from spark_rapids_tpu_torch.runtime import speculation as spec

INT32_MAX = int(np.iinfo(np.int32).max)
I64_MAX = int(np.iinfo(np.int64).max)

#: (data, validity) of one key column
KeyVal = Tuple[torch.Tensor, torch.Tensor]

_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64)


def _i32(o: torch.Tensor) -> torch.Tensor:
    """uint32 operands as int32 views of the same bits (torch has few
    uint32 operations); anything else unchanged."""
    return o.view(torch.int32) if o.dtype == torch.uint32 else o


def _as(like: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.uint32) if like.dtype == torch.uint32 else x


def _dense_rank_ops(ops: Sequence[torch.Tensor],
                    valid: torch.Tensor) -> torch.Tensor:
    """Dense ranks [0, nvalid) of the operand tuples over valid rows, -1
    for invalid ones: one lexicographic sort (ops/ordering.lex_sort), an
    adjacent-change cumsum and a scatter back. Invalid rows sort after
    every valid one."""
    from spark_rapids_tpu_torch.ops.ordering import lex_sort
    n = int(ops[0].shape[0])
    zops = []
    for o in ops:
        z = torch.where(valid, _i32(o), torch.zeros((), dtype=_i32(o).dtype,
                                                     device=o.device))
        zops.append(_as(o, z))
    res = lex_sort([(~valid).to(torch.int32)] + zops,
                   torch.arange(n, dtype=torch.int32, device=valid.device))
    perm = res[-1].to(torch.int64)
    s_valid = res[0] == 0
    changed = torch.arange(n, device=valid.device) == 0
    for so in res[1:-1]:
        s = _i32(so)
        changed = changed | (s != torch.roll(s, 1))
    rank_sorted = torch.cumsum((changed & s_valid).to(torch.int32), 0,
                               dtype=torch.int32) - 1
    rank_sorted = torch.where(s_valid, rank_sorted,
                              torch.full_like(rank_sorted, -1))
    out = torch.empty(n, dtype=torch.int32, device=valid.device)
    out[perm] = rank_sorted
    return out


def sort_probe(lkeys: Sequence[KeyVal], rkeys: Sequence[KeyVal],
               live_l: torch.Tensor, live_r: torch.Tensor):
    """The sort-based probe (the reference's ``JoinKernel.probe``): shared
    dense codes for both sides, the build codes sorted, and per probe row
    its range [lo, lo + count) in that order. Returns (lo, counts, total
    int64, matched_l, rs_perm)."""
    from spark_rapids_tpu_torch.ops.ordering import (
        comparable_operands,
        lex_sort,
    )
    cap_l, cap_r = int(live_l.shape[0]), int(live_r.shape[0])
    dev = live_l.device
    valid_l, valid_r = live_l, live_r
    for (_, lv), (_, rv) in zip(lkeys, rkeys):
        valid_l = valid_l & lv
        valid_r = valid_r & rv
    allvalid = torch.cat([valid_l, valid_r])
    combined = None
    for (ld, _), (rd, _) in zip(lkeys, rkeys):
        allops = [_as(a, torch.cat([_i32(a), _i32(b)]))
                  for a, b in zip(comparable_operands(ld),
                                  comparable_operands(rd))]
        rank = _dense_rank_ops(allops, allvalid)
        # re-densify the (combined, rank) pair: two i32 keys, no
        # overflow-prone combined * n arithmetic
        combined = rank if combined is None else _dense_rank_ops(
            [combined, rank], allvalid & (rank >= 0))
    l_codes = torch.where(valid_l, combined[:cap_l],
                          torch.full_like(combined[:cap_l], -1))
    r_codes = combined[cap_l:]
    # sort the build side's codes; invalid and dead rows park last
    r_sortable = torch.where(valid_r, r_codes,
                             torch.full_like(r_codes, INT32_MAX))
    rs_perm = lex_sort([r_sortable], torch.arange(cap_r, dtype=torch.int32,
                                                  device=dev))[-1]
    # codes are dense ranks below cap_l + cap_r: per-code build counts and
    # their exclusive prefix give each probe code its sorted range
    n_codes = cap_l + cap_r
    # invalid build rows park past the codes, each on its own slot
    park = torch.where(valid_r, r_codes.to(torch.int64),
                       n_codes + torch.arange(cap_r, device=dev))
    bc = torch.zeros(n_codes + cap_r, dtype=torch.int32, device=dev)
    bc.index_add_(0, park, torch.ones(cap_r, dtype=torch.int32, device=dev))
    bc = bc[:n_codes]
    starts = torch.cumsum(bc, 0, dtype=torch.int32) - bc
    safe_l = l_codes.clamp(0, n_codes - 1).to(torch.int64)
    lo = starts[safe_l]
    counts = torch.where(valid_l & (l_codes >= 0), bc[safe_l],
                         torch.zeros((), dtype=torch.int32, device=dev))
    total = counts.sum(dtype=torch.int64)
    return lo, counts, total, counts > 0, rs_perm


def expand_inner(lo, counts, rs_perm, out_cap: int):
    """(li, ri, out_live, nout) gather maps of an inner join at a static
    output capacity: output slot j belongs to the first probe row whose
    inclusive count prefix exceeds j (a right-sided binary search of the
    prefix; the reference scatters row indices at their start offsets and
    takes a running max, the same rows), and its offset within that row's
    range picks the build row through ``rs_perm``. Output slots at and
    past the total are dead (index 0)."""
    dev = lo.device
    cap_l, cap_r = int(lo.shape[0]), int(rs_perm.shape[0])
    csum = torch.cumsum(counts.to(torch.int64), 0)
    total = csum[-1] if cap_l else torch.zeros((), dtype=torch.int64,
                                               device=dev)
    off = csum - counts
    j = torch.arange(out_cap, dtype=torch.int64, device=dev)
    i = torch.searchsorted(csum, j, right=True).clamp(0, max(cap_l - 1, 0))
    rpos = (lo.to(torch.int64)[i] + (j - off[i])).clamp(0, cap_r - 1)
    ri = rs_perm.to(torch.int64)[rpos]
    out_live = j < total
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return (torch.where(out_live, i, zero), torch.where(out_live, ri, zero),
            out_live, total.to(torch.int32))


def expand_left_outer(lo, counts, rs_perm, live_l, out_cap: int):
    """(li, ri, out_live, null_r, nout) of a left outer join: every live
    probe row without a match counts one output row, whose build side is
    null (``null_r``)."""
    one = torch.ones((), dtype=counts.dtype, device=counts.device)
    counts2 = torch.where(live_l & (counts == 0), one, counts)
    li, ri, out_live, nout = expand_inner(lo, counts2, rs_perm, out_cap)
    null_r = (counts[li] == 0) & out_live
    ri = torch.where(null_r, torch.zeros_like(ri), ri)
    return li, ri, out_live, null_r, nout


def gather_columns(table: DeviceTable, idx: torch.Tensor,
                   out_live: torch.Tensor,
                   null_mask: Optional[torch.Tensor] = None
                   ) -> List[DeviceColumn]:
    """Every column of ``table`` gathered at ``idx`` (the reference's
    ``_ColumnGather``); dead output slots, and slots under ``null_mask``
    (an outer join's null side), are invalid in every storage."""
    valid = out_live if null_mask is None else out_live & ~null_mask
    return [c.with_arrays(c.data[idx], c.validity[idx] & valid)
            for c in table.columns]


def direct_join(jt: str, lt: DeviceTable, rt: DeviceTable, lkey: KeyVal,
                rkey: KeyVal, H: int):
    """The direct-address join (the reference's ``_DirectJoinKernel`` with
    a masked output) for ``jt`` in inner, left outer, left semi and left
    anti. Returns ([(data, validity)...] of the output columns at the
    probe's capacity: the left then right ones, the left ones alone for
    semi and anti; the live mask (None: the probe's own prefix); nout;
    fail)."""
    dev = lt.device
    (ld, lv), (rd, rv) = lkey, rkey
    live_l, live_r = lt.row_mask(), rt.row_mask()
    vl, vr = lv & live_l, rv & live_r
    rd64, ld64 = rd.to(torch.int64), ld.to(torch.int64)
    any_r = vr.any()
    keymin = torch.where(vr, rd64, torch.full_like(rd64, I64_MAX)).min()
    keymin = torch.where(any_r, keymin, torch.zeros_like(keymin))
    pos = rd64 - keymin
    fits = (~any_r) | (torch.where(vr, pos, torch.zeros_like(pos)).max() < H)
    # invalid build rows land past the table, each on its own slot: one
    # shared drop slot would serialize their atomics
    rows_r = torch.arange(rt.capacity, dtype=torch.int64, device=dev)
    tgt_r = torch.where(vr, pos.clamp(0, H - 1), H + rows_r)
    cnt = torch.zeros(H + rt.capacity, dtype=torch.int32, device=dev)
    cnt.index_add_(0, tgt_r, torch.ones_like(tgt_r, dtype=torch.int32))
    unique = cnt[:H].max() <= 1
    rowid = torch.full((H + rt.capacity,), -1, dtype=torch.int32,
                       device=dev)
    rowid.scatter_reduce_(0, tgt_r, rows_r.to(torch.int32), "amax")
    p = ld64 - keymin
    inb = (p >= 0) & (p < H) & vl
    ri = rowid[p.clamp(0, H - 1)]
    matched = inb & (ri >= 0)
    fail = ~(fits & unique)
    outs = [(c.data, c.validity) for c in lt.columns]
    if jt in ("leftsemi", "leftanti"):
        keep = matched if jt == "leftsemi" else live_l & ~matched
        return outs, keep, keep.sum(dtype=torch.int32), fail
    safe_ri = torch.where(matched, ri, torch.zeros_like(ri)).to(torch.int64)
    outs += [(c.data[safe_ri], c.validity[safe_ri] & matched)
             for c in rt.columns]
    if jt == "inner":
        return outs, matched, matched.sum(dtype=torch.int32), fail
    # left outer: every live probe row emits exactly one row, in place
    return outs, lt.live, lt.nrows_dev, fail


def _unify_string_keys(lcol: DeviceColumn, rcol: DeviceColumn):
    """Remap two dictionary-coded string columns into their union
    dictionary so codes compare across tables (host work O(dict size))."""
    empty = np.array([], dtype=object)
    ldict = lcol.dictionary if lcol.dictionary is not None else empty
    rdict = rcol.dictionary if rcol.dictionary is not None else empty
    union = np.unique(np.concatenate([ldict.astype(object),
                                      rdict.astype(object)]))
    out = []
    for c, d in ((lcol, ldict), (rcol, rdict)):
        m = np.searchsorted(union, d).astype(np.int32) if len(d) else \
            np.zeros(1, np.int32)
        m_d = torch.from_numpy(m).to(c.data.device)
        out.append((m_d[c.data.clamp(0, len(m) - 1).long()], c.validity))
    return out[0], out[1]


def _integer_key(k: KeyVal) -> bool:
    return k[0].ndim == 1 and k[0].dtype in _INT_DTYPES


#: join types by their one name (the plan's Join node normalizes them)
OUTER_TYPES = ("left", "right", "full")
SEMI_ANTI = ("leftsemi", "leftanti")
#: the types the direct route takes (``_DirectJoinKernel.SUPPORTED``)
DIRECT_TYPES = ("inner", "left", "leftsemi", "leftanti")


def compact_table(table: DeviceTable, keep: torch.Tensor) -> DeviceTable:
    """The rows under ``keep`` moved to the prefix at the table's capacity
    (the compaction kernel through ops/scatter32.py)."""
    from spark_rapids_tpu_torch.ops.scatter32 import compact_pairs
    outs, new_n = compact_pairs([c.data for c in table.columns],
                                [c.validity for c in table.columns], keep,
                                table.capacity)
    cols = [c.with_arrays(d, v) for c, (d, v) in zip(table.columns, outs)]
    return DeviceTable(table.names, cols, new_n, table.capacity,
                       table.device)


def null_columns(schema, capacity: int, device) -> List[DeviceColumn]:
    """All-null columns of ``schema`` (an outer join's missing side)."""
    from spark_rapids_tpu_torch.columnar.column import null_column
    return [null_column(dt, capacity, device) for _, dt in schema]


def unmatched_build_batch(bt: DeviceTable, matched: torch.Tensor,
                          probe_schema, swapped: bool,
                          names) -> DeviceTable:
    """A full outer join's tail: the build rows no probe row matched,
    beside an all-null probe side (the build's columns first when the
    sides are swapped)."""
    part = compact_table(bt, bt.row_mask() & ~matched)
    nulls = null_columns(probe_schema, part.capacity, part.device)
    cols = (list(part.columns) + nulls if swapped
            else nulls + list(part.columns))
    return DeviceTable(names, cols, part.nrows_dev, part.capacity,
                       part.device)


class TpuJoinExec(TpuExec):
    """Equi-join of any type, or a cross join: the build child is one
    table (the LEFT child for a right outer join, else the right one),
    probe batches stream through ``_join_batch``. The output is the left
    columns then the right ones (the left ones alone for semi and anti
    joins). ``join_type`` is the plan's one name for it
    (plan/nodes.py::normalize_join_type)."""

    produces_masked = True

    def __init__(self, left: TpuExec, right: TpuExec, join_type: str,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 condition: Optional[Expression], left_schema,
                 right_schema, direct_table_mult: int = 4,
                 hashprobe_attempts: int = 4,
                 subpartition_bytes: int = 1 << 30,
                 max_subpartitions: int = 64):
        self.children = (left, right)
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.condition = condition
        self._left_schema = list(left_schema)
        self._right_schema = list(right_schema)
        self.left_names = [n for n, _ in left_schema]
        self.right_names = [n for n, _ in right_schema]
        self.direct_table_mult = direct_table_mult
        self.hashprobe_attempts = hashprobe_attempts
        self.subpartition_bytes = subpartition_bytes
        self.max_subpartitions = max_subpartitions
        self._site_base = "join:{}:{}:{}:{}:{}".format(
            self.join_type, tuple(repr(k) for k in self.left_keys),
            tuple(repr(k) for k in self.right_keys), tuple(self.left_names),
            tuple(self.right_names))

    @property
    def _site_key(self) -> str:
        """Speculation site: join shape + plan position, so two
        same-shaped joins do not share a blocklist entry while a repeated
        query keeps its own."""
        return f"{self._site_base}:op{self._lore_id}"

    def output_schema(self):
        if self.join_type in SEMI_ANTI:
            return list(self._left_schema)
        return self._left_schema + self._right_schema

    def _names(self):
        if self.join_type in SEMI_ANTI:
            return self.left_names
        return self.left_names + self.right_names

    def execute_masked(self):
        from spark_rapids_tpu_torch.runtime.memory import MEMORY
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        from spark_rapids_tpu_torch.runtime.spill import (
            PRIORITY_ACTIVE,
            BufferCatalog,
            SpillableDeviceTable,
        )
        jt = self.join_type
        swapped = jt == "right"
        build_child = self.children[0] if swapped else self.children[1]
        probe_child = self.children[1] if swapped else self.children[0]
        sub = self.subpartition_bytes
        if sub > 0:
            sub = min(sub, MEMORY.scan_chunk_bytes())
        if jt == "cross":
            sub = 0
        build, parts = self._build_side(build_child, sub)
        if parts is not None:
            yield from self._execute_subpartitioned(parts, probe_child,
                                                    swapped)
            return
        build_sb = SpillableDeviceTable(build, BufferCatalog.get(),
                                        priority=PRIORITY_ACTIVE)
        build_cap, build_dev = build.capacity, build.device
        del build
        full_outer = jt == "full"
        r_matched_accum = None
        try:
            for pb in probe_child.execute_masked():
                with build_sb.pinned_batch() as bt:
                    out, r_matched = retry_block(
                        lambda p=pb, b=bt: self._join_batch(p, b, swapped))
                # this frame lives on while the consumer runs: it keeps
                # neither the build nor a batch alive
                del pb, bt
                if full_outer:
                    r_matched_accum = (r_matched if r_matched_accum is None
                                       else r_matched_accum | r_matched)
                out = [self._apply_condition(out)]
                yield out.pop()
                self.add_metric("probeBatches", 1)
            if full_outer:
                if r_matched_accum is None:
                    r_matched_accum = torch.zeros(build_cap,
                                                  dtype=torch.bool,
                                                  device=build_dev)
                with build_sb.pinned_batch() as bt:
                    last = self._unmatched_build_batch(bt, r_matched_accum,
                                                       swapped)
                del bt
                yield last
        finally:
            build_sb.release()

    def _build_side(self, build_child: TpuExec, sub: int):
        """(the build table, None), or (None, one SpillableBatch per hash
        partition) when the build side is larger than ``sub`` bytes (0:
        never split): ``ceil(size / sub)`` partitions, at most
        ``max_subpartitions``. The build child hands over its batches
        (``TpuExec.spillable_batches``): an unsplit build concatenates as
        the single-batch coalesce would; a split one is partitioned batch
        by batch, each partition then concatenated from its pieces, so the
        whole build is never on the device at once (the reference's
        GpuSubPartitionHashJoin partitions its build batches the same
        way)."""
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        from spark_rapids_tpu_torch.runtime.spill import SpillableBatch
        build_keys = (self.left_keys if self.join_type == "right"
                      else self.right_keys)
        items, nbytes = build_child.spillable_batches()
        try:
            if not items:
                raise ColumnarProcessingError("join requires a coalesced "
                                              "build side")
            nparts = self._num_parts(nbytes, sub)
            if nparts > 1:
                parts, items = self._partition(items, build_keys,
                                               nparts), []
                return None, parts
            build = retry_block(lambda: concat_device(
                [x.get() if isinstance(x, SpillableBatch) else x
                 for x in items]).compacted())
            return build, None
        finally:
            for x in items:
                if isinstance(x, SpillableBatch):
                    x.release()

    def _num_parts(self, nbytes: int, sub: int) -> int:
        if sub <= 0 or nbytes <= sub:
            return 1
        return int(min(-(-nbytes // sub), self.max_subpartitions))

    def _partition(self, items, keys, nparts: int) -> list:
        """Each build batch (a DeviceTable, or a SpillableBatch pinned
        while it splits; each dropped once split) split by the key hash
        into ``nparts`` pieces, each piece spillable in buffers of its own;
        then each partition's pieces concatenated into one
        SpillableBatch."""
        import contextlib

        from spark_rapids_tpu_torch.runtime.retry import retry_block
        from spark_rapids_tpu_torch.runtime.spill import (
            BufferCatalog,
            SpillableBatch,
        )
        from spark_rapids_tpu_torch.shuffle.partitioning import (
            HashPartitioner,
        )
        catalog = BufferCatalog.get()
        parter = HashPartitioner(keys, nparts)
        pieces = [[] for _ in range(nparts)]
        parts = []
        try:
            while items:
                x = items.pop(0)
                with (x.pinned_batch() if isinstance(x, SpillableBatch)
                      else contextlib.nullcontext(x)) as dt:
                    for p, t in enumerate(self._split(dt, parter, True)):
                        pieces[p].append(SpillableBatch(t, catalog))
                        del t
                del dt
                if isinstance(x, SpillableBatch):
                    x.release()
                del x
            for p in range(nparts):
                mine, pieces[p] = pieces[p], []
                if len(mine) == 1:
                    parts.append(mine[0])
                    continue
                try:
                    t = retry_block(lambda m=mine: concat_device(
                        [x.get() for x in m]))
                finally:
                    for x in mine:
                        x.release()
                parts.append(SpillableBatch(t, catalog))
                del t
            out, parts = parts, []
            return out
        finally:
            for sb in parts + [x for ps in pieces for x in ps] + [
                    x for x in items if isinstance(x, SpillableBatch)]:
                sb.release()

    def _execute_subpartitioned(self, build_parts: list, probe_child,
                                swapped: bool):
        """The build's hash partitions (``_build_side``, SpillableBatches);
        each probe batch splits the same way, and partition pairs join
        independently (a full outer join keeps one match bitmap per
        partition and ends with each partition's unmatched build
        rows)."""
        from spark_rapids_tpu_torch.runtime.retry import retry_block
        from spark_rapids_tpu_torch.shuffle.partitioning import (
            HashPartitioner,
        )
        full_outer = self.join_type == "full"
        probe_keys = self.right_keys if swapped else self.left_keys
        nparts = len(build_parts)
        pparter = HashPartitioner(probe_keys, nparts)
        self.add_metric("subPartitions", nparts)
        r_matched = [None] * nparts
        try:
            for pb in probe_child.execute_masked():
                for p, pp in enumerate(self._split(pb, pparter)):
                    with build_parts[p].pinned_batch() as bt:
                        out, rm = retry_block(
                            lambda a=pp, b=bt: self._join_batch(a, b,
                                                                swapped))
                    del pp, bt
                    if full_outer:
                        r_matched[p] = (rm if r_matched[p] is None
                                        else r_matched[p] | rm)
                    out = [self._apply_condition(out)]
                    yield out.pop()
                del pb
                self.add_metric("probeBatches", 1)
            if full_outer:
                for p, sb in enumerate(build_parts):
                    with sb.pinned_batch() as bt:
                        rm = r_matched[p]
                        if rm is None:
                            rm = torch.zeros(bt.capacity, dtype=torch.bool,
                                             device=bt.device)
                        last = self._unmatched_build_batch(bt, rm, swapped)
                    del bt
                    yield last
        finally:
            for sb in build_parts:
                sb.release()

    @staticmethod
    def _split(table: DeviceTable, parter,
               copy: bool = False) -> Iterator[DeviceTable]:
        """Per-partition compacted tables, each re-bucketed to its live
        size (one host read of the count vector), made one at a time;
        ``copy`` as in ``DeviceColumn.sliced_rows`` (a build partition is
        kept, a probe partition is not)."""
        pids = parter.partition_ids(table).to(torch.int64)
        live = table.row_mask()
        n = parter.num_partitions
        cnt = torch.zeros(n, dtype=torch.int32, device=table.device)
        cnt.index_add_(0, pids.clamp(0, n - 1), live.to(torch.int32))
        counts = cnt.tolist()  # host sync
        for p in range(n):
            part = compact_table(table, (pids == p) & live)
            k = bucket_for(max(counts[p], 1))
            if k < part.capacity:
                part = DeviceTable(part.names, [c.sliced_rows(k, copy)
                                                for c in part.columns],
                                   counts[p], k, part.device)
            yield part

    def _apply_condition(self, out: DeviceTable) -> DeviceTable:
        """The residual condition of an inner or cross join as a filter
        over the joined batch (a masked output)."""
        if self.condition is None or self.join_type not in ("inner",
                                                            "cross"):
            return out
        from spark_rapids_tpu_torch.execs.basic import filter_table
        return filter_table(out, self.condition)

    def _keys(self, lt: DeviceTable, rt: DeviceTable, swapped: bool):
        """(probe key (data, validity)s, build key ones): string keys in
        their union dictionary's codes."""
        lkeys_e, rkeys_e = ((self.right_keys, self.left_keys) if swapped
                            else (self.left_keys, self.right_keys))
        lkeys, rkeys = [], []
        for lc, rc in zip(compile_project(lkeys_e, lt),
                          compile_project(rkeys_e, rt)):
            if isinstance(lc.dtype, T.StringType):
                lk, rk = _unify_string_keys(lc, rc)
            else:
                lk, rk = (lc.data, lc.validity), (rc.data, rc.validity)
            lkeys.append(lk)
            rkeys.append(rk)
        return lkeys, rkeys

    def _join_batch(self, lt: DeviceTable, rt: DeviceTable, swapped: bool):
        """Join ONE probe batch (lt) against the build table (rt). Returns
        (the output table, the build-match bitmap of a full outer join or
        None)."""
        jt = self.join_type
        if jt == "cross":
            return self._cross(lt, rt), None
        lkeys, rkeys = self._keys(lt, rt, swapped)
        full_outer = jt == "full"
        direct = self._try_direct(jt, lt, rt, lkeys, rkeys)
        if direct is not None:
            return direct, None
        live_l, live_r = lt.row_mask(), rt.row_mask()
        probe = self._try_hashprobe(lt, rt, lkeys, rkeys, live_l, live_r)
        if probe is None:
            probe = sort_probe(lkeys, rkeys, live_l, live_r)
        lo, counts, total, matched_l, rs_perm = probe

        r_matched = (self._right_matched(lo, counts, rs_perm, rt.capacity)
                     if full_outer else None)
        if jt in SEMI_ANTI:
            keep = (matched_l if jt == "leftsemi" else ~matched_l) & live_l
            return DeviceTable(lt.names, lt.columns,
                               keep.sum(dtype=torch.int32), lt.capacity,
                               lt.device, live=keep), None

        size_site = self._site_key + ":size"
        # a full outer join never speculates its size
        ctx = None if full_outer else spec.allowed(size_site)
        if ctx is not None:
            # speculative static bound, the foreign-key join's shape: the
            # output fits the probe side's bucket; the exact total stays
            # on the device and a miss replays on the exact path below
            out_cap = bucket_for(max(lt.capacity, 1))
            ctx.add_flag(size_site, self._size_flag(total, counts, live_l,
                                                    out_cap))
        else:
            upper = int(total.item())  # host sync
            if jt in OUTER_TYPES:
                # each unmatched probe row adds at most one output row:
                # the probe capacity bounds them without a second read
                upper += lt.capacity
            out_cap = bucket_for(max(upper, 1))
        null_r = None
        if jt == "inner":
            li, ri, out_live, nout = expand_inner(lo, counts, rs_perm,
                                                  out_cap)
        else:  # left and right outer per batch; a full outer join's
            # unmatched build rows come in the last batch
            li, ri, out_live, null_r, nout = expand_left_outer(
                lo, counts, rs_perm, live_l, out_cap)
        lcols = gather_columns(lt, li, out_live)
        rcols = gather_columns(rt, ri, out_live, null_r)
        cols = rcols + lcols if swapped else lcols + rcols
        return DeviceTable(self._names(), cols, nout, out_cap,
                           lt.device), r_matched

    def _size_flag(self, total, counts, live_l, out_cap: int):
        """Device bool: the speculative ``out_cap`` was too small (int64
        throughout, so a many-to-many total cannot wrap)."""
        tot = total.to(torch.int64)
        if self.join_type in OUTER_TYPES:
            tot = tot + (live_l & (counts == 0)).sum(dtype=torch.int64)
        return tot > out_cap

    def _try_direct(self, jt, lt, rt, lkeys, rkeys) -> Optional[DeviceTable]:
        """The direct-address route, or None when the shape does not
        qualify (several keys, a non-integer key, a right or full outer
        join, a blocklisted site)."""
        if (jt not in DIRECT_TYPES or len(lkeys) != 1
                or not (_integer_key(lkeys[0]) and _integer_key(rkeys[0]))):
            return None
        site = self._site_key + ":direct"
        ctx = spec.allowed(site)
        if ctx is None:
            return None
        H = bucket_for(max(self.direct_table_mult * rt.capacity, 1))
        outs, keep, nout, fail = direct_join(jt, lt, rt, lkeys[0], rkeys[0],
                                             H)
        ctx.add_flag(site, fail)
        self.add_metric("directJoinBatches", 1)
        cols = [c.with_arrays(d, v) for c, (d, v) in
                zip(list(lt.columns) + list(rt.columns), outs)]
        return DeviceTable(self._names(), cols, nout, lt.capacity,
                           lt.device, live=keep)

    def _try_hashprobe(self, lt, rt, lkeys, rkeys, live_l, live_r):
        """The hash-probe route's range-form probe, or None when the shape
        does not qualify (several keys, a non-integer key, a blocklisted
        site). The table has 2 x the build capacity slots."""
        if len(lkeys) != 1 or not (_integer_key(lkeys[0])
                                   and _integer_key(rkeys[0])):
            return None
        site = self._site_key + ":hashprobe"
        ctx = spec.allowed(site)
        if ctx is None:
            return None
        from spark_rapids_tpu_torch.kernels import hashprobe as khash
        H = 1 << max(2 * rt.capacity - 1, 1).bit_length()
        lo, counts, total, matched, rs_perm, fail = khash.probe_ranges(
            lkeys[0], rkeys[0], live_l, live_r, H, self.hashprobe_attempts)
        ctx.add_flag(site, fail)
        self.add_metric("hashProbeBatches", 1)
        return lo, counts, total, matched, rs_perm

    @staticmethod
    def _right_matched(lo, counts, rs_perm, cap_r: int) -> torch.Tensor:
        """Which build rows matched at least one probe row: +1 at each
        range's start and -1 at its end in sorted order (a buffer one slot
        longer takes the ends at ``cap_r``), a running sum over 0 marks
        the covered sorted slots, scattered back through ``rs_perm``."""
        dev = lo.device
        hit = (counts > 0).to(torch.int32)
        lo64 = lo.to(torch.int64)
        marks = torch.zeros(cap_r + 1, dtype=torch.int32, device=dev)
        marks.index_add_(0, lo64.clamp(0, cap_r), hit)
        marks.index_add_(0, (lo64 + counts).clamp(0, cap_r), -hit)
        covered = torch.cumsum(marks[:-1], 0) > 0
        out = torch.zeros(cap_r, dtype=torch.bool, device=dev)
        out[rs_perm.to(torch.int64)] = covered
        return out

    def _unmatched_build_batch(self, rt: DeviceTable, r_matched,
                               swapped: bool) -> DeviceTable:
        probe_schema = self._right_schema if swapped else self._left_schema
        return unmatched_build_batch(rt, r_matched, probe_schema, swapped,
                                     self._names())

    def _cross(self, lt: DeviceTable, rt: DeviceTable) -> DeviceTable:
        """Every (left, right) pair: output slot j holds left row
        j // nr and right row j % nr (int64 maps), at the bucket of
        nl * nr (both counts read on the host)."""
        lt = lt.compacted()  # the pair maps need the prefix form
        nl, nr = lt.num_rows, rt.num_rows
        n = nl * nr
        out_cap = bucket_for(max(n, 1))
        j = torch.arange(out_cap, dtype=torch.int64, device=lt.device)
        out_live = j < n
        zero = torch.zeros((), dtype=torch.int64, device=lt.device)
        li = torch.where(out_live, j // max(nr, 1), zero)
        ri = torch.where(out_live, j % max(nr, 1), zero)
        cols = gather_columns(lt, li, out_live) + gather_columns(
            rt, ri, out_live)
        return DeviceTable(self._names(), cols, n, out_cap, lt.device)
