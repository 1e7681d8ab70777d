"""The CPU route's group-by aggregation with Spark-exact semantics (port
of ``spark_rapids_tpu/plan/cpu_agg.py``).

Used by the Aggregate plan node's CPU path (plan/nodes.py). Vectorized numpy implementation:
keys are factorized per column, combined into dense group ids, and
aggregations run via np.*.at segment updates — integer sums stay in int64
(wrapping, like Java), nulls are ignored by sum/min/max/avg, and an all-null
group yields NULL (count yields 0)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.columnar.nested import NestedData
from spark_rapids_tpu_torch.ops import aggregates as agg
from spark_rapids_tpu_torch.ops.expr import Expression, output_name


def _factorize_column(col: HostColumn) -> Tuple[np.ndarray, int]:
    """Dense codes for one key column; nulls get code 0 (their own group)."""
    if isinstance(col.dtype, T.ArrayType):
        # an array key: equal element lists group together (a null
        # element orders before every value)
        rows = col.data
        vals = np.empty(len(col), dtype=object)
        for i in range(len(col)):
            vals[i] = tuple((x is not None, x if x is not None else 0)
                            for x in rows[i]) if col.validity[i] else ()
    elif isinstance(col.dtype, T.StringType):
        # the sorted dictionary encode (nulls as ""): np.unique's
        # (uniques, inverse), without its sort of every row's object
        codes, uniq = col.encoded()
        codes = codes.astype(np.int64) + 1
        codes[~col.validity] = 0
        return codes, len(uniq) + 1
    else:
        vals = np.where(col.validity, col.data, np.zeros((), dtype=col.data.dtype))
    uniq, codes = np.unique(vals, return_inverse=True)
    codes = codes.astype(np.int64) + 1
    codes[~col.validity] = 0
    return codes, len(uniq) + 1


def group_ids(key_cols: Sequence[HostColumn], n: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Returns (gid per row, representative row index per group in
    first-occurrence order, number of groups)."""
    if not key_cols:
        return np.zeros(n, dtype=np.int64), np.zeros(1 if n else 1, dtype=np.int64), 1
    combined = None
    for col in key_cols:
        codes, card = _factorize_column(col)
        if combined is None:
            combined = codes
        else:
            combined = combined * card + codes
            # re-densify to keep the mixed-radix product bounded
            _, combined = np.unique(combined, return_inverse=True)
            combined = combined.astype(np.int64)
    uniq, first_idx, inverse = np.unique(combined, return_index=True, return_inverse=True)
    # re-number groups by first occurrence so output order is deterministic
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    gid = rank[inverse].astype(np.int64)
    reps = first_idx[order]
    return gid, reps, len(uniq)


def _agg_one(fn: agg.AggregateFunction, value: HostColumn, gid: np.ndarray,
             ngroups: int, n: int) -> HostColumn:
    out_type = fn.data_type
    if isinstance(fn, agg.Count):
        if fn.child is None:
            cnt = np.bincount(gid, minlength=ngroups).astype(np.int64)
        else:
            cnt = np.bincount(gid[value.validity], minlength=ngroups).astype(np.int64)
        return HostColumn(T.LONG, cnt, np.ones(ngroups, dtype=np.bool_))

    valid = value.validity
    vgid = gid[valid]
    nonnull = np.bincount(vgid, minlength=ngroups).astype(np.int64)
    has_any = nonnull > 0

    if isinstance(fn, (agg.Sum, agg.Average)) or isinstance(fn, agg._CentralMoment):
        if isinstance(value.dtype, T.IntegralType) and isinstance(fn, agg.Sum):
            acc = np.zeros(ngroups, dtype=np.int64)
            with np.errstate(over="ignore"):
                np.add.at(acc, vgid, value.data[valid].astype(np.int64))
            return HostColumn(T.LONG, acc, has_any)
        if isinstance(value.dtype, T.DecimalType) and isinstance(fn, agg.Sum):
            # EXACT decimal sum (Spark semantics); overflow beyond the
            # p+10 result precision -> NULL (non-ANSI CheckOverflow)
            acc = np.zeros(ngroups, dtype=object)
            np.add.at(acc, vgid, value.data[valid].astype(object))
            bound = 10 ** out_type.precision
            fits = np.array([abs(int(x)) < bound for x in acc], dtype=bool)
            validity = has_any & fits
            if out_type.precision <= T.DecimalType.MAX_LONG_DIGITS:
                data = np.array([int(x) if ok else 0
                                 for x, ok in zip(acc, validity)],
                                dtype=np.int64)
            else:
                data = np.array([int(x) if ok else 0
                                 for x, ok in zip(acc, validity)],
                                dtype=object)
            return HostColumn(out_type, data, validity)
        data = value.data[valid].astype(np.float64)
        if isinstance(value.dtype, T.DecimalType):
            # decimal buffers hold UNSCALED ints; Average/stddev/variance
            # results are doubles in VALUE units (Spark semantics)
            data = data / float(10 ** value.dtype.scale)
        s = np.zeros(ngroups, dtype=np.float64)
        np.add.at(s, vgid, data)
        if isinstance(fn, agg.Sum):
            return HostColumn(T.DOUBLE, np.where(has_any, s, 0.0), has_any)
        if isinstance(fn, agg.Average):
            cnt = np.maximum(nonnull, 1)
            return HostColumn(T.DOUBLE, np.where(has_any, s / cnt, 0.0), has_any)
        # central moments
        mean = s / np.maximum(nonnull, 1)
        sq = np.zeros(ngroups, dtype=np.float64)
        np.add.at(sq, vgid, (data - mean[vgid]) ** 2)
        if isinstance(fn, (agg.VariancePop, agg.StddevPop)):
            denom = np.maximum(nonnull, 1)
            validity = has_any
        else:
            denom = np.maximum(nonnull - 1, 1)
            validity = nonnull > 1
        var = sq / denom
        out = np.sqrt(var) if isinstance(fn, (agg.StddevPop, agg.StddevSamp)) else var
        return HostColumn(T.DOUBLE, np.where(validity, out, 0.0), validity)

    if isinstance(fn, (agg.Min, agg.Max)):
        if isinstance(value.dtype, T.StringType):
            vals = np.where(valid, value.data, "")
            uniq, codes = np.unique(vals.astype(object), return_inverse=True)
            codes = codes.astype(np.int64)
            sentinel = len(uniq) if isinstance(fn, agg.Min) else -1
            acc = np.full(ngroups, sentinel, dtype=np.int64)
            if isinstance(fn, agg.Min):
                np.minimum.at(acc, vgid, codes[valid])
            else:
                np.maximum.at(acc, vgid, codes[valid])
            out = np.empty(ngroups, dtype=object)
            safe = np.clip(acc, 0, max(len(uniq) - 1, 0))
            if len(uniq):
                out[:] = uniq[safe]
            out[~has_any] = None
            return HostColumn(T.STRING, out, has_any)
        if T.is_dec128(value.dtype):
            # python-int object storage: bound sentinels beyond any p<=38
            sentinel = 10 ** 39 if isinstance(fn, agg.Min) else -(10 ** 39)
            acc = np.full(ngroups, sentinel, dtype=object)
            red = np.minimum if isinstance(fn, agg.Min) else np.maximum
            red.at(acc, vgid, value.data[valid].astype(object))
            data = np.array([int(x) if ok else 0
                             for x, ok in zip(acc, has_any)], dtype=object)
            return HostColumn(value.dtype, data, has_any)
        dt = value.dtype.np_dtype
        if np.issubdtype(dt, np.floating):
            sentinel = np.inf if isinstance(fn, agg.Min) else -np.inf
        elif dt == np.bool_:
            sentinel = True if isinstance(fn, agg.Min) else False
        else:
            info = np.iinfo(dt)
            sentinel = info.max if isinstance(fn, agg.Min) else info.min
        acc = np.full(ngroups, sentinel, dtype=dt)
        if isinstance(fn, agg.Min):
            np.minimum.at(acc, vgid, value.data[valid])
        else:
            np.maximum.at(acc, vgid, value.data[valid])
        zero = np.zeros((), dtype=dt).item()
        return HostColumn(value.dtype, np.where(has_any, acc, zero).astype(dt), has_any)

    if isinstance(fn, (agg.First, agg.Last)):
        idx = np.arange(n)
        if fn.ignore_nulls:
            pick_idx = idx[valid]
            pick_gid = vgid
        else:
            pick_idx = idx
            pick_gid = gid
        acc = np.full(ngroups, n if isinstance(fn, agg.First) else -1, dtype=np.int64)
        if isinstance(fn, agg.First):
            np.minimum.at(acc, pick_gid, pick_idx)
        else:
            np.maximum.at(acc, pick_gid, pick_idx)
        got = (acc >= 0) & (acc < n)
        safe = np.clip(acc, 0, max(n - 1, 0))
        if isinstance(value.data, NestedData) or (
                value.data.dtype == object and
                not isinstance(value.dtype, T.StringType)):
            picked = value.take(safe)
            return HostColumn(value.dtype, picked.data,
                              got & picked.validity if n else got)
        data = value.data[safe] if n else value.data
        validity = got & value.validity[safe] if n else got
        if isinstance(value.dtype, T.StringType):
            out = np.empty(ngroups, dtype=object)
            out[:] = data
            out[~validity] = None
            return HostColumn(value.dtype, out, validity)
        zero = np.zeros((), dtype=value.dtype.np_dtype).item()
        return HostColumn(value.dtype, np.where(validity, data, zero).astype(value.dtype.np_dtype), validity)

    if isinstance(fn, (agg.CollectList, agg.CollectSet)):
        out = np.empty(ngroups, dtype=object)
        for g in range(ngroups):
            out[g] = []
        valid = value.validity
        for i in range(n):
            if valid[i]:
                v = value.data[i]
                out[gid[i]].append(v.item() if hasattr(v, "item") else v)
        if isinstance(fn, agg.CollectSet):
            for g in range(ngroups):
                out[g] = sorted(set(out[g]))
        return HostColumn(fn.data_type, out, np.ones(ngroups, dtype=np.bool_))

    if isinstance(fn, agg.Percentile):
        outv = np.zeros(ngroups)
        validity = np.zeros(ngroups, dtype=np.bool_)
        for g in range(ngroups):
            vals = np.sort(value.data[(gid == g) & value.validity].astype(np.float64))
            if len(vals):
                k = (len(vals) - 1) * fn.percentage
                lo, hi = int(np.floor(k)), int(np.ceil(k))
                outv[g] = vals[lo] + (vals[hi] - vals[lo]) * (k - lo)
                validity[g] = True
        return HostColumn(T.DOUBLE, outv, validity)

    raise NotImplementedError(f"cpu aggregate {type(fn).__name__}")


def aggregate_cpu(table: HostTable, grouping: Sequence[Expression],
                  aggs: Sequence[Tuple[str, agg.AggregateFunction]]) -> HostTable:
    """Group ``table`` by the (bound) grouping expressions, compute the named
    aggregate functions. Returns one row per group (first-occurrence order);
    with no grouping, exactly one row (global aggregate)."""
    n = table.num_rows
    key_cols = [g.eval_cpu(table) for g in grouping]
    gid, reps, ngroups = group_ids(key_cols, n)
    if not grouping:
        reps = np.zeros(1, dtype=np.int64) if n else np.array([], dtype=np.int64)

    names: List[str] = []
    cols: List[HostColumn] = []
    for i, g in enumerate(grouping):
        kc = key_cols[i]
        if n:
            cols.append(kc.take(reps))
        else:
            cols.append(HostColumn(kc.dtype, kc.data[:0], kc.validity[:0]))
        names.append(output_name(g, f"k{i}"))

    for out_name, fn in aggs:
        if fn.child is not None:
            value = fn.child.eval_cpu(table)
        else:
            value = HostColumn(T.LONG, np.zeros(n, dtype=np.int64), np.ones(n, dtype=np.bool_))
        if not grouping and n == 0:
            # global aggregate over empty input: one row, null (count: 0)
            if isinstance(fn, agg.Count):
                cols.append(HostColumn(T.LONG, np.zeros(1, dtype=np.int64), np.ones(1, dtype=np.bool_)))
            else:
                dt = fn.data_type
                if isinstance(dt, T.StringType):
                    cols.append(HostColumn(dt, np.array([None], dtype=object), np.zeros(1, dtype=np.bool_)))
                else:
                    cols.append(HostColumn(dt, np.zeros(1, dtype=dt.np_dtype), np.zeros(1, dtype=np.bool_)))
            names.append(out_name)
            continue
        ng = ngroups if (grouping or n) else 1
        res = _agg_one(fn, value, gid, ng, n)
        if not grouping and n == 0:
            res = res.slice(0, 1)
        cols.append(res)
        names.append(out_name)

    return HostTable(names, cols)
