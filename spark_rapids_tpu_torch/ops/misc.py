"""Misc expressions (port of ``spark_rapids_tpu/ops/misc.py``): float
normalization markers, null guards, nondeterministic ids and random
numbers, timezone shifts, md5 and concat_ws.

``Rand`` draws on the host from numpy's seeded stream, batch by batch in
row order, as the reference does, so the device values are the same bits.
``FromUTCTimestamp`` and ``ToUTCTimestamp`` add a fixed offset, or look
up a DST zone's transition table (ops/tzdb.py) with ``torch.searchsorted``.

``ConcatWs`` is a dictionary transform over its one column. The reference
keeps its output dictionary in source order with the null-child entry
last (``dict_sorted=False``), so its sort, window, literal lookup and
MIN/MAX order by code, not as strings: ``concat_ws('|', s, 'x')`` over
'a' and 'ab' gives 'a|x' the smaller code, though 'ab|x' < 'a|x', and a
null s's 'x' sorts last. Its group-by also splits an entry that repeats
another (``concat_ws('|', s)``: '' for s = '' and for a null s). The
port ranks the output on the host (sorted, unique) and remaps the codes
with one gather, so every consumer sees Spark's string order: a
deliberate deviation from the reference."""

from __future__ import annotations

import hashlib
import weakref
from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import DeviceColumn, HostColumn
from spark_rapids_tpu_torch.ops.common import UnaryExpression, dev_remap_codes
from spark_rapids_tpu_torch.ops.expr import (
    DevVal,
    Expression,
    Literal,
    NodePrep,
    PrepCtx,
)
from spark_rapids_tpu_torch.ops.strings import (
    DictStringToString,
    cached_prep,
)

# ---------------------------------------------------------------------------
# float normalization / null guards
# ---------------------------------------------------------------------------


class _Identity(UnaryExpression):
    @property
    def data_type(self):
        return self.children[0].data_type

    def prep(self, pctx, child_preps):
        return child_preps[0]

    def eval_dev(self, ctx, child_vals, prep):
        return child_vals[0]


class NormalizeNaNAndZero(_Identity):
    """-0.0 -> 0.0 and every NaN -> one canonical NaN (Spark inserts it
    before grouping or joining on floats)."""

    def prep(self, pctx, child_preps):
        return NodePrep()

    def eval_dev(self, ctx, child_vals, prep):
        (c,) = child_vals
        d = torch.where(c.data == 0.0, torch.zeros_like(c.data), c.data)
        d = torch.where(torch.isnan(c.data), torch.full_like(d, np.nan), d)
        return DevVal(d, c.validity)

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        d = np.where(c.data == 0.0, 0.0, c.data)
        d = np.where(np.isnan(c.data), np.nan, d)
        return HostColumn(c.dtype, d.astype(c.data.dtype), c.validity.copy())


class KnownFloatingPointNormalized(_Identity):
    """Planner marker: the input is already normalized (identity)."""

    def eval_cpu(self, table):
        return self.children[0].eval_cpu(table)


class KnownNotNull(_Identity):
    """Planner marker: the input is known non-null (identity)."""

    def eval_cpu(self, table):
        return self.children[0].eval_cpu(table)


class AtLeastNNonNulls(Expression):
    """True when at least n of the children are non-null (DataFrame
    dropna)."""

    def __init__(self, n: int, *children: Expression):
        self.n = int(n)
        self.children = tuple(children)

    @property
    def data_type(self):
        return T.BOOLEAN

    def with_children(self, children):
        return AtLeastNNonNulls(self.n, *children)

    def eval_dev(self, ctx, child_vals, prep):
        cnt = torch.zeros(ctx.capacity, dtype=torch.int32, device=ctx.device)
        for cv in child_vals:
            cnt = cnt + cv.validity.to(torch.int32)
        return DevVal(cnt >= self.n, torch.ones(ctx.capacity,
                                                dtype=torch.bool,
                                                device=ctx.device))

    def eval_cpu(self, table):
        kids = [c.eval_cpu(table) for c in self.children]
        cnt = np.zeros(table.num_rows, dtype=np.int32)
        for k in kids:
            cnt += k.validity
        return HostColumn(T.BOOLEAN, cnt >= self.n,
                          np.ones(table.num_rows, dtype=np.bool_))


# ---------------------------------------------------------------------------
# nondeterministic
# ---------------------------------------------------------------------------

#: live nondeterministic expressions by id (an Expression's == builds an
#: EqualTo, so it is not hashable); each query's execution resets them, so
#: collecting a DataFrame again reproduces its stream (Spark's rand(seed)
#: is deterministic per query)
_NONDETERMINISTIC: "weakref.WeakValueDictionary" = \
    weakref.WeakValueDictionary()


def reset_nondeterministic_streams() -> None:
    for e in list(_NONDETERMINISTIC.values()):
        e.reset_stream()


def _row_positions(ctx) -> torch.Tensor:
    """Each slot's row number in the batch: its index, or over a masked
    batch (``ctx.live``) its rank among the live slots, so that the live
    rows take the values a compacted batch's would."""
    if ctx.live is None:
        return torch.arange(ctx.capacity, dtype=torch.int64,
                            device=ctx.device)
    return (torch.cumsum(ctx.live.to(torch.int64), 0) - 1).clamp_min(0)


class MonotonicallyIncreasingID(Expression):
    """Ids that increase by one a row and continue across batches (the
    engine runs one partition a stream)."""

    children = ()

    def __init__(self):
        self._offset = {"n": 0}
        _NONDETERMINISTIC[id(self)] = self

    def reset_stream(self):
        self._offset["n"] = 0

    @property
    def data_type(self):
        return T.LONG

    def key(self):
        return ("monotonicid", id(self._offset))

    def with_children(self, children):
        return self

    def prep(self, pctx: PrepCtx, child_preps):
        base = self._offset["n"]
        self._offset["n"] += pctx.table.num_rows
        return NodePrep(aux={"base": base})

    def eval_dev(self, ctx, child_vals, prep):
        data = prep.aux["base"] + _row_positions(ctx)
        return DevVal(data, torch.ones(ctx.capacity, dtype=torch.bool,
                                       device=ctx.device))

    def eval_cpu(self, table):
        n = table.num_rows
        base = self._offset["n"]
        self._offset["n"] += n
        return HostColumn(T.LONG, base + np.arange(n, dtype=np.int64))


class SparkPartitionID(Expression):
    """The partition id of the executing task (0: one stream)."""

    children = ()

    def __init__(self, pid: int = 0):
        self.pid = pid

    @property
    def data_type(self):
        return T.INT

    def with_children(self, children):
        return self

    def eval_dev(self, ctx, child_vals, prep):
        return DevVal(torch.full((ctx.capacity,), self.pid, dtype=torch.int32,
                                 device=ctx.device),
                      torch.ones(ctx.capacity, dtype=torch.bool,
                                 device=ctx.device))

    def eval_cpu(self, table):
        return HostColumn(
            T.INT, np.full(table.num_rows, self.pid, dtype=np.int32))


class Rand(Expression):
    """rand([seed]): uniform [0, 1). The stream draws on the host from
    numpy's seeded generator, each batch's live rows in order (the
    reference's draw), and uploads the batch's values."""

    children = ()

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        _NONDETERMINISTIC[id(self)] = self

    def reset_stream(self):
        self._rng = np.random.default_rng(self.seed)

    @property
    def data_type(self):
        return T.DOUBLE

    def key(self):
        # unique per instance, stable across reset_stream()
        return ("rand", self.seed, id(self))

    def with_children(self, children):
        return self

    def prep(self, pctx: PrepCtx, child_preps):
        table = pctx.table
        vals = np.zeros(table.capacity)
        vals[:table.num_rows] = self._rng.random(table.num_rows)
        # a row-sized landing: reserved and accounted with the memory
        # arbiter like a column, for as long as the prep holds it
        col = DeviceColumn.from_array(T.DOUBLE, vals, table.device)
        return NodePrep(aux={"vals": col.data, "column": col})

    def eval_dev(self, ctx, child_vals, prep):
        vals = prep.aux["vals"]
        if ctx.live is not None:
            vals = vals.index_select(0, _row_positions(ctx))
        return DevVal(vals, torch.ones(ctx.capacity, dtype=torch.bool,
                                       device=ctx.device))

    def eval_cpu(self, table):
        return HostColumn(T.DOUBLE, self._rng.random(table.num_rows))


# ---------------------------------------------------------------------------
# timezone shifts
# ---------------------------------------------------------------------------


def fixed_offset_micros(tz: str) -> Optional[int]:
    """The offset in micros of a fixed-offset zone spelling (UTC, GMT, Z,
    +hh:mm, UTC+h, GMT-hh:mm); None for a named or DST zone."""
    t = tz.strip()
    up = t.upper()
    if up in ("UTC", "GMT", "Z"):
        return 0
    for prefix in ("UTC", "GMT"):
        if up.startswith(prefix):
            t = t[len(prefix):]
            break
    if not t:
        return 0
    sign = 1
    if t[0] == "+":
        t = t[1:]
    elif t[0] == "-":
        sign = -1
        t = t[1:]
    else:
        return None
    parts = t.split(":")
    try:
        hh = int(parts[0])
        mm = int(parts[1]) if len(parts) > 1 else 0
        ss = int(parts[2]) if len(parts) > 2 else 0
    except ValueError:
        return None
    if hh > 18 or mm > 59 or ss > 59:
        return None
    return sign * ((hh * 3600 + mm * 60 + ss) * 1_000_000)


class _TzShift(Expression):
    """A timestamp shifted between UTC and a literal zone: a fixed offset,
    or a DST zone's transition table. A non-literal or unknown zone
    raises (the reference's CPU route reads a literal's value there)."""

    to_utc = False

    def __init__(self, child: Expression, tz: Expression):
        self.children = (child, tz)

    @property
    def data_type(self):
        return T.TIMESTAMP

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def resolve(self, bound):
        from spark_rapids_tpu_torch.ops.tzdb import TimeZoneDB
        out = self.with_children(bound)
        tz = out.children[1]
        if not isinstance(tz, Literal) or tz.value is None:
            raise NotImplementedError(
                f"{out.name} with a non-literal or null zone is not ported")
        if fixed_offset_micros(str(tz.value)) is None and \
                not TimeZoneDB.supported(str(tz.value)):
            raise NotImplementedError(
                f"{out.name} zone {tz.value!r}: not a fixed offset and not "
                "in the zoneinfo database")
        return out

    def eval_dev(self, ctx, child_vals, prep):
        from spark_rapids_tpu_torch.ops import tzdb
        c = child_vals[0]
        name = str(self.children[1].value)
        off = fixed_offset_micros(name)
        if off is None:
            out = (tzdb.to_utc_micros_dev(c.data, name) if self.to_utc
                   else tzdb.from_utc_micros_dev(c.data, name))
        else:
            out = c.data + (-off if self.to_utc else off)
        return DevVal(torch.where(c.validity, out, torch.zeros_like(out)),
                      c.validity)

    def eval_cpu(self, table):
        from spark_rapids_tpu_torch.ops import tzdb
        c = self.children[0].eval_cpu(table)
        off = fixed_offset_micros(str(self.children[1].value))
        if off is None:
            name = str(self.children[1].value)
            data = np.asarray(c.data, dtype=np.int64)
            out = (tzdb.to_utc_micros_host(data, name) if self.to_utc
                   else tzdb.from_utc_micros_host(data, name))
            return HostColumn(T.TIMESTAMP, out, c.validity.copy())
        delta = -off if self.to_utc else off
        return HostColumn(T.TIMESTAMP, c.data + delta, c.validity.copy())

class FromUTCTimestamp(_TzShift):
    to_utc = False


class ToUTCTimestamp(_TzShift):
    to_utc = True


# ---------------------------------------------------------------------------
# md5 / concat_ws
# ---------------------------------------------------------------------------


class Md5(DictStringToString, UnaryExpression):
    """md5(string) -> the lowercase hex digest (a dictionary transform)."""

    def transform(self, s):
        return hashlib.md5(s.encode("utf-8")).hexdigest()


class ConcatWs(Expression):
    """concat_ws(sep, e1, e2, ...): null children are SKIPPED (unlike
    concat); null only where the separator is. A dictionary transform when
    at most one child is a non-literal string column and the separator is
    a literal; otherwise the CPU route (the reference's) joins the values
    row by row. The output dictionary is sorted (see the module's
    docstring)."""

    def __init__(self, sep: Expression, *children: Expression):
        self.children = (sep,) + tuple(children)

    @property
    def data_type(self):
        return T.STRING

    def with_children(self, children):
        return ConcatWs(children[0], *children[1:])

    def _column(self) -> Optional[int]:
        for j, c in enumerate(self.children[1:]):
            if not isinstance(c, Literal):
                return j + 1
        return None

    def resolve(self, bound):
        out = self.with_children(bound)
        cols = [c for c in out.children[1:] if not isinstance(c, Literal)]
        if any(not isinstance(c.data_type, T.StringType) for c in cols):
            raise NotImplementedError(
                "ConcatWs over a non-string column is not ported")
        return out

    @property
    def device_supported(self):
        # more than one column or a non-literal separator: the CPU route
        cols = [c for c in self.children[1:] if not isinstance(c, Literal)]
        return len(cols) <= 1 and isinstance(self.children[0], Literal)

    def _joined(self, value) -> str:
        """The output with the column's value (None: the column null)."""
        sep = str(self.children[0].value)
        col = self._column()
        parts = []
        for j, c in enumerate(self.children[1:], start=1):
            v = value if j == col else c.value
            if v is not None:
                parts.append(str(v))
        return sep.join(parts)

    def prep(self, pctx: PrepCtx, child_preps):
        dev = pctx.table.device
        if self.children[0].value is None:
            return NodePrep(out_dict=np.array([], dtype=object),
                            aux={"null": True})
        col = self._column()
        if col is None:
            return NodePrep(out_dict=np.array([self._joined(None)],
                                              dtype=object))
        d = child_preps[col].out_dict
        d = np.array([], dtype=object) if d is None else d

        def build():
            outs = [self._joined(s) for s in d] + [self._joined(None)]
            out_dict, remap = np.unique(np.array(outs, dtype=object),
                                        return_inverse=True)
            return NodePrep(out_dict=out_dict, aux={
                "remap": torch.from_numpy(
                    remap.astype(np.int32)).to(dev)})
        return cached_prep(self, d, dev, build)

    def eval_dev(self, ctx, child_vals, prep):
        cap, dev = ctx.capacity, ctx.device
        if "remap" not in (prep.aux or {}):
            # a constant (or, with a null separator, all null)
            valid = not (prep.aux or {}).get("null", False)
            return DevVal(torch.zeros(cap, dtype=torch.int32, device=dev),
                          torch.full((cap,), valid, dtype=torch.bool,
                                     device=dev))
        remap = prep.aux["remap"]
        cv = child_vals[self._column()]
        codes = torch.where(cv.validity, cv.data.clamp(0, remap.shape[0] - 2),
                            remap.shape[0] - 1)
        return DevVal(dev_remap_codes(remap, codes),
                      torch.ones(cap, dtype=torch.bool, device=dev))

    def eval_cpu(self, table):
        kids = [c.eval_cpu(table) for c in self.children]
        sep, vals = kids[0], kids[1:]
        n = table.num_rows
        out = np.empty(n, dtype=object)
        validity = sep.validity.copy()
        for i in range(n):
            if validity[i]:
                parts = [str(k.data[i]) for k in vals if k.validity[i]]
                out[i] = str(sep.data[i]).join(parts)
        return HostColumn(T.STRING, out, validity)

