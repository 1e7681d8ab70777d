"""The CPU route's join with Spark-exact semantics (port of
``spark_rapids_tpu/plan/cpu_join.py``).

Gather-map design mirrors the reference's GpuHashJoin (SURVEY.md §2.3:
join -> GatherMap -> chunked gather): we compute left/right row-index arrays
then gather. Spark corners: NULL keys never match (but leftanti keeps
null-keyed left rows); semi/anti return only left columns; condition is
applied to candidate pairs before match bookkeeping for outer joins."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.columnar.nested import NestedData
from spark_rapids_tpu_torch.ops.expr import Expression


def _key_codes(left_cols: List[HostColumn], right_cols: List[HostColumn],
               nl: int, nr: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Densify join keys into a shared integer code space.

    Returns (left_codes, right_codes, left_has_null, right_has_null)."""
    l_null = np.zeros(nl, dtype=np.bool_)
    r_null = np.zeros(nr, dtype=np.bool_)
    combined_l = None
    combined_r = None
    for lc, rc in zip(left_cols, right_cols):
        l_null |= ~lc.validity
        r_null |= ~rc.validity
        if isinstance(lc.dtype, T.StringType):
            lv = np.where(lc.validity, lc.data, "")
            rv = np.where(rc.validity, rc.data, "")
            allv = np.concatenate([lv.astype(object), rv.astype(object)])
        else:
            lv, rv = lc.data, rc.data
            allv = np.concatenate([lv, rv])
        uniq, codes = np.unique(allv, return_inverse=True)
        codes = codes.astype(np.int64)
        lcode, rcode = codes[:nl], codes[nl:]
        if combined_l is None:
            combined_l, combined_r = lcode, rcode
        else:
            card = len(uniq)
            combined_l = combined_l * card + lcode
            combined_r = combined_r * card + rcode
            both = np.concatenate([combined_l, combined_r])
            _, dense = np.unique(both, return_inverse=True)
            dense = dense.astype(np.int64)
            combined_l, combined_r = dense[:nl], dense[nl:]
    return combined_l, combined_r, l_null, r_null


def _gather_map(l_codes, r_codes, l_null, r_null) -> Tuple[np.ndarray, np.ndarray]:
    """All matching (left_idx, right_idx) candidate pairs; null keys excluded."""
    nl = len(l_codes)
    valid_r = np.nonzero(~r_null)[0]
    rs = valid_r[np.argsort(r_codes[valid_r], kind="stable")]
    rs_codes = r_codes[rs]
    lo = np.searchsorted(rs_codes, l_codes, side="left")
    hi = np.searchsorted(rs_codes, l_codes, side="right")
    counts = np.where(l_null, 0, hi - lo)
    total = int(counts.sum())
    if total == 0:
        return np.array([], dtype=np.int64), np.array([], dtype=np.int64)
    left_idx = np.repeat(np.arange(nl, dtype=np.int64), counts)
    # positions within each row's [lo, hi) range
    csum = np.zeros(nl + 1, dtype=np.int64)
    np.cumsum(counts, out=csum[1:])
    offset_in_row = np.arange(total, dtype=np.int64) - csum[:-1][left_idx]
    right_pos = lo[left_idx] + offset_in_row
    right_idx = rs[right_pos]
    return left_idx, right_idx


def _gather_cols(table: HostTable, idx: np.ndarray, null_mask: Optional[np.ndarray] = None
                 ) -> List[HostColumn]:
    """Gather rows; where null_mask is True (or idx < 0) the output row is
    all-null (outer-join padding)."""
    n = len(idx)
    safe = np.clip(idx, 0, max(table.num_rows - 1, 0))
    cols = []
    for c in table.columns:
        if table.num_rows == 0:
            data = (np.full(n, None, dtype=object) if isinstance(c.dtype, T.StringType)
                    else np.zeros(n, dtype=c.dtype.np_dtype))
            validity = np.zeros(n, dtype=np.bool_)
            cols.append(HostColumn(c.dtype, data, validity))
            continue
        data = c.data[safe]
        validity = c.validity[safe]
        if null_mask is not None:
            validity = validity & ~null_mask
            if isinstance(c.dtype, T.StringType):
                data = data.copy()
                data[null_mask] = None
        cols.append(HostColumn(c.dtype, data if isinstance(data, NestedData)
                               else np.array(data), np.array(validity)))
    return cols


def join_cpu(left: HostTable, right: HostTable, join_type: str,
             left_keys: Sequence[Expression], right_keys: Sequence[Expression],
             condition: Optional[Expression]) -> HostTable:
    nl, nr = left.num_rows, right.num_rows
    jt = join_type.lower().replace("_", "")

    if jt == "cross" or not left_keys:
        # keyless non-cross join = nested loop: all pairs are candidates and
        # the condition decides matches (BroadcastNestedLoopJoin analog)
        li = np.repeat(np.arange(nl, dtype=np.int64), nr)
        ri = np.tile(np.arange(nr, dtype=np.int64), nl)
    else:
        lk = [k.eval_cpu(left) for k in left_keys]
        rk = [k.eval_cpu(right) for k in right_keys]
        l_codes, r_codes, l_null, r_null = _key_codes(lk, rk, nl, nr)
        li, ri = _gather_map(l_codes, r_codes, l_null, r_null)

    # apply the residual (non-equi) condition to candidate pairs
    if condition is not None and len(li):
        pair_cols = _gather_cols(left, li) + _gather_cols(right, ri)
        pair = HostTable(list(left.names) + list(right.names), pair_cols)
        pred = condition.eval_cpu(pair)
        keep = pred.validity & pred.data.astype(np.bool_)
        li, ri = li[keep], ri[keep]

    names_both = list(left.names) + list(right.names)

    if jt == "inner" or jt == "cross":
        cols = _gather_cols(left, li) + _gather_cols(right, ri)
        return HostTable(names_both, cols)

    l_matched = np.zeros(nl, dtype=np.bool_)
    l_matched[li] = True
    r_matched = np.zeros(nr, dtype=np.bool_)
    r_matched[ri] = True

    if jt == "leftsemi":
        idx = np.nonzero(l_matched)[0]
        return HostTable(left.names, _gather_cols(left, idx))
    if jt == "leftanti":
        idx = np.nonzero(~l_matched)[0]
        return HostTable(left.names, _gather_cols(left, idx))

    if jt in ("left", "leftouter"):
        extra_l = np.nonzero(~l_matched)[0]
        li2 = np.concatenate([li, extra_l])
        ri2 = np.concatenate([ri, np.full(len(extra_l), -1, dtype=np.int64)])
        null_r = ri2 < 0
        cols = _gather_cols(left, li2) + _gather_cols(right, ri2, null_r)
        return HostTable(names_both, cols)
    if jt in ("right", "rightouter"):
        extra_r = np.nonzero(~r_matched)[0]
        li2 = np.concatenate([li, np.full(len(extra_r), -1, dtype=np.int64)])
        ri2 = np.concatenate([ri, extra_r])
        null_l = li2 < 0
        cols = _gather_cols(left, li2, null_l) + _gather_cols(right, ri2)
        return HostTable(names_both, cols)
    if jt in ("full", "fullouter", "outer"):
        extra_l = np.nonzero(~l_matched)[0]
        extra_r = np.nonzero(~r_matched)[0]
        li2 = np.concatenate([li, extra_l, np.full(len(extra_r), -1, dtype=np.int64)])
        ri2 = np.concatenate([ri, np.full(len(extra_l), -1, dtype=np.int64), extra_r])
        cols = _gather_cols(left, li2, li2 < 0) + _gather_cols(right, ri2, ri2 < 0)
        return HostTable(names_both, cols)

    raise ValueError(f"unsupported join type {join_type}")
