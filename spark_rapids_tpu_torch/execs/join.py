"""Inner equi-join (port of the inner-join parts of
``spark_rapids_tpu/execs/join.py``: ``_dense_rank_ops``, ``JoinKernel``'s
probe and inner expand, ``_DirectJoinKernel``, ``_ColumnGather`` and
``TpuJoinExec``'s ``_join_batch``, ``_try_direct``, ``_try_hashprobe`` and
``_size_flag``).

The build side is one prefix table; probe batches stream through, each
joined by the first route that applies, as in the reference:

1. DIRECT (torch ops): a single integer key whose build values span less
   than ``directTableMultiplier`` x the build capacity scatters build
   rowids into a table indexed by ``key - min(key)``; each probe row
   gathers its match. The output stays MASKED at the probe's capacity (no
   compaction). Device flags for "keys too sparse" and "a build key
   repeats" are validated at collect (runtime/speculation.py); a failure
   blocklists the site and the query replays.
2. HASH PROBE (kernels/hashprobe.py, the CUDA probe): a single integer
   key, any spread. Its ``fail`` flag (a homeless build row or a
   duplicated build key) is validated the same way.
3. SORT-BASED: both sides' keys are dense-ranked into one code space
   through the sort kernel; per-code build counts and their exclusive
   prefix give each probe row its match range, and ranges expand into
   (left, right) gather maps at a speculative output capacity (the probe
   side's bucket; a miss replays on the exact size read on the host).

Only INNER joins with equi keys are ported: other join types, join
conditions, cross joins and the build side's sub-partitioning raise
NotImplementedError.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import (
    DeviceColumn,
    DeviceTable,
    bucket_for,
)
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
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
    """(li, ri, nout) gather maps of an inner join at a static output
    capacity: output slot j belongs to the first probe row whose inclusive
    count prefix exceeds j (a binary search of the prefix; the reference
    scatters row indices at their start offsets and takes a running max,
    the same rows), and its offset within that row's range picks the
    build row through ``rs_perm``. Output slots at and past the total are
    dead (index 0)."""
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
            total.to(torch.int32))


def gather_columns(table: DeviceTable, idx: torch.Tensor,
                   out_live: torch.Tensor) -> List[DeviceColumn]:
    """Every column of ``table`` gathered at ``idx`` (the reference's
    ``_ColumnGather``); dead output slots are invalid."""
    return [c.with_arrays(c.data[idx], c.validity[idx] & out_live)
            for c in table.columns]


def direct_join(lt: DeviceTable, rt: DeviceTable, lkey: KeyVal,
                rkey: KeyVal, H: int):
    """The direct-address inner join (the reference's
    ``_DirectJoinKernel`` for 'inner' with a masked output). Returns
    ([(data, validity)...] of the left then right columns at the probe's
    capacity, keep mask, nout, fail)."""
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
    safe_ri = torch.where(matched, ri, torch.zeros_like(ri)).to(torch.int64)
    outs = [(c.data, c.validity) for c in lt.columns]
    outs += [(c.data[safe_ri], c.validity[safe_ri] & matched)
             for c in rt.columns]
    return outs, matched, matched.sum(dtype=torch.int32), fail


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


class TpuJoinExec(TpuExec):
    """Inner equi-join: the build (right) child is one table, probe (left)
    batches stream through ``_join_batch``. The output is the left columns
    then the right ones."""

    produces_masked = True

    def __init__(self, left: TpuExec, right: TpuExec, join_type: str,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], left_schema,
                 right_schema, direct_table_mult: int = 4,
                 hashprobe_attempts: int = 4):
        self.children = (left, right)
        self.join_type = join_type.lower().replace("_", "")
        if self.join_type != "inner":
            raise NotImplementedError(
                f"{join_type} join is not ported (inner joins only)")
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self._left_schema = list(left_schema)
        self._right_schema = list(right_schema)
        self.left_names = [n for n, _ in left_schema]
        self.right_names = [n for n, _ in right_schema]
        self.direct_table_mult = direct_table_mult
        self.hashprobe_attempts = hashprobe_attempts
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
        return self._left_schema + self._right_schema

    def execute_masked(self):
        builds = list(self.children[1].execute())
        if len(builds) != 1:
            raise ColumnarProcessingError("join requires a coalesced build "
                                          "side")
        build = builds[0]
        for pb in self.children[0].execute_masked():
            yield self._join_batch(pb, build)
            self.add_metric("probeBatches", 1)

    def _join_batch(self, lt: DeviceTable, rt: DeviceTable) -> DeviceTable:
        """Join ONE probe batch (lt) against the build table (rt)."""
        lkeys, rkeys = [], []
        for lc, rc in zip(compile_project(self.left_keys, lt),
                          compile_project(self.right_keys, rt)):
            if isinstance(lc.dtype, T.StringType):
                lk, rk = _unify_string_keys(lc, rc)
            else:
                lk, rk = (lc.data, lc.validity), (rc.data, rc.validity)
            lkeys.append(lk)
            rkeys.append(rk)

        direct = self._try_direct(lt, rt, lkeys, rkeys)
        if direct is not None:
            return direct
        live_l, live_r = lt.row_mask(), rt.row_mask()
        probe = self._try_hashprobe(lt, rt, lkeys, rkeys, live_l, live_r)
        if probe is None:
            probe = sort_probe(lkeys, rkeys, live_l, live_r)
        lo, counts, total, _, rs_perm = probe

        size_site = self._site_key + ":size"
        ctx = spec.allowed(size_site)
        if ctx is not None:
            # speculative static bound, the foreign-key join's shape: the
            # output fits the probe side's bucket; the exact total stays
            # on the device and a miss replays on the exact path below
            out_cap = bucket_for(max(lt.capacity, 1))
            ctx.add_flag(size_site, total > out_cap)
        else:
            out_cap = bucket_for(max(int(total.item()), 1))  # host sync
        li, ri, nout = expand_inner(lo, counts, rs_perm, out_cap)
        out_live = torch.arange(out_cap, dtype=torch.int32,
                                device=lt.device) < nout
        cols = gather_columns(lt, li, out_live) + gather_columns(rt, ri,
                                                                 out_live)
        return DeviceTable(self.left_names + self.right_names, cols, nout,
                           out_cap, lt.device)

    def _try_direct(self, lt, rt, lkeys, rkeys) -> Optional[DeviceTable]:
        """The direct-address route, or None when the shape does not
        qualify (several keys, a non-integer key, a blocklisted site)."""
        if len(lkeys) != 1 or not (_integer_key(lkeys[0])
                                   and _integer_key(rkeys[0])):
            return None
        site = self._site_key + ":direct"
        ctx = spec.allowed(site)
        if ctx is None:
            return None
        H = bucket_for(max(self.direct_table_mult * rt.capacity, 1))
        outs, keep, nout, fail = direct_join(lt, rt, lkeys[0], rkeys[0], H)
        ctx.add_flag(site, fail)
        self.add_metric("directJoinBatches", 1)
        cols = [c.with_arrays(d, v) for c, (d, v) in
                zip(list(lt.columns) + list(rt.columns), outs)]
        return DeviceTable(self.left_names + self.right_names, cols, nout,
                           lt.capacity, lt.device, live=keep)

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
