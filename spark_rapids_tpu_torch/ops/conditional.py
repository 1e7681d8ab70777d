"""Conditional expressions: If, CaseWhen, Coalesce, Least, Greatest and
NaNvl (port of ``spark_rapids_tpu/ops/conditional.py``, Spark's
conditionalExpressions.scala).

Each evaluates on the device as a chain of ``torch.where`` over its
children's values, exactly as the reference's non-ANSI device path does:

- ``CaseWhen``: the first branch whose condition is true (not null) wins;
  with no ELSE the other rows are null.
- ``Coalesce``: the first non-null child.
- ``Least``/``Greatest``: null children are skipped (null only when every
  child is null); the pick is a plain ``<``/``>``, as in the reference,
  so a NaN against a number keeps whichever came first, and -0.0 against
  0.0 keeps the first (Spark orders NaN above every number and gives NaN
  for both ``greatest`` orders).
- ``NaNvl(a, b)``: b where a is NaN.

The result's type is the first value's (If's ``if_true``, CaseWhen's first
THEN). String results merge the branches' dictionaries on the host and
remap each branch's codes on the device (``ops/common.py``). Every branch
is kept in the result's storage: int32 codes, dates as int32, DECIMAL64 as
int64, DECIMAL128 as a ``(capacity, 2)`` limb pair (the condition
broadcast over both limbs); a NULL literal branch is zeros.

A branch whose type differs from the result's is taken only where its
values keep their meaning in the result's type: a NULL literal, or a
numeric type whose values widen into the result's (an INT into a BIGINT
or a DOUBLE). Anywhere else the reference keeps the first value's type
and converts the other branches' values to it when the result downloads
(``CASE WHEN .. THEN 1 ELSE 2.5 END`` gives 2), where Spark coerces the
branches to a common type: binding raises NotImplementedError naming the
case.

In ANSI mode (``spark.sql.ansi.enabled``) If and CaseWhen walk their own
children (``eval_walk``): each branch value evaluates under
``EvalCtx.guarded`` of the rows that select it, so a row the branch does
not select cannot raise; the CPU route evaluates each branch over its
selected rows only (the reference's ``_eval_cpu_ansi``). With ANSI off
every route is the plain one."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.ops.common import (
    align_string_dicts_many,
    dev_remap_codes,
)
from spark_rapids_tpu_torch.ops.expr import DevVal, EvalCtx, Expression, NodePrep

_SIMPLE_NUMERIC = (T.ByteType, T.ShortType, T.IntegerType, T.LongType,
                   T.FloatType, T.DoubleType)


def _agrees(result: T.DataType, branch: T.DataType) -> bool:
    """True when ``branch``'s values keep their meaning in ``result``."""
    if isinstance(branch, T.NullType) or branch == result:
        return True
    if isinstance(result, _SIMPLE_NUMERIC) and isinstance(
            branch, _SIMPLE_NUMERIC):
        return np.promote_types(result.np_dtype,
                                branch.np_dtype) == result.np_dtype
    return False


def _check_branches(expr: Expression, values: Sequence[Expression]) -> None:
    rt = expr.data_type
    bad = [v.data_type for v in values if not _agrees(rt, v.data_type)]
    if bad:
        types = ", ".join(v.data_type.simple_string() for v in values)
        raise NotImplementedError(
            f"{expr.name} over values of types ({types}): its type is the "
            f"first value's ({rt.simple_string()}), which "
            f"{bad[0].simple_string()} values do not keep (Spark coerces "
            "the values to a common type; the reference converts them to "
            "the first value's type on download); not ported")


class _Storage:
    """The result's device storage: dtype and row shape."""

    def __init__(self, dtype: T.DataType, ctx: EvalCtx):
        self.device = ctx.device
        self.capacity = ctx.capacity
        self.limbs = T.is_dec128(dtype)
        self.torch_dtype = (torch.int32 if isinstance(dtype, T.StringType)
                            else torch.int64 if self.limbs
                            else T.torch_dtype(dtype))

    def zeros(self) -> torch.Tensor:
        shape = (self.capacity, 2) if self.limbs else (self.capacity,)
        return torch.zeros(shape, dtype=self.torch_dtype, device=self.device)

    def value(self, child: Expression, val: DevVal) -> torch.Tensor:
        """A branch's data in the result's storage."""
        if isinstance(child.data_type, T.NullType):
            return self.zeros()
        d = val.data
        return d if d.dtype == self.torch_dtype else d.to(self.torch_dtype)

    def rows(self, mask: torch.Tensor) -> torch.Tensor:
        """``mask`` broadcast over a DECIMAL128's two limbs."""
        return mask[:, None] if self.limbs else mask


def _string_prep(pctx, expr: Expression, child_preps, value_idx):
    if isinstance(expr.data_type, T.StringType):
        return align_string_dicts_many(pctx, [child_preps[i]
                                              for i in value_idx])
    return NodePrep()


def _branch_data(st: _Storage, prep: NodePrep, children, child_vals,
                 value_idx) -> dict:
    """{child index: its data in the result's storage}, string codes
    remapped into the merged dictionary."""
    out = {}
    for slot, i in enumerate(value_idx):
        d = st.value(children[i], child_vals[i])
        if prep.aux is not None:
            d = dev_remap_codes(prep.aux[slot], d)
        out[i] = d
    return out


class If(Expression):
    def __init__(self, pred: Expression, if_true: Expression,
                 if_false: Expression):
        self.children = (pred, if_true, if_false)

    @property
    def data_type(self):
        return self.children[1].data_type

    def with_children(self, children):
        return If(*children)

    def resolve(self, bound):
        out = self.with_children(bound)
        _check_branches(out, out.children[1:])
        return out

    def prep(self, pctx, child_preps):
        return _string_prep(pctx, self, child_preps, (1, 2))

    def eval_walk(self, ctx):
        """The device walk: under ANSI each branch is checked only on the
        rows that take it."""
        from spark_rapids_tpu_torch.ops.expr import _walk_eval
        p = _walk_eval(self.children[0], ctx)
        if ctx.ansi:
            take_a = p.validity & p.data
            with ctx.guarded(take_a):
                a = _walk_eval(self.children[1], ctx)
            with ctx.guarded(~take_a):
                b = _walk_eval(self.children[2], ctx)
        else:
            a = _walk_eval(self.children[1], ctx)
            b = _walk_eval(self.children[2], ctx)
        return self.eval_dev(ctx, (p, a, b), ctx.next_prep())

    def eval_dev(self, ctx, child_vals, prep):
        p, a, b = child_vals
        st = _Storage(self.data_type, ctx)
        d = _branch_data(st, prep, self.children, child_vals, (1, 2))
        take_a = p.validity & p.data
        return DevVal(torch.where(st.rows(take_a), d[1], d[2]),
                      torch.where(take_a, a.validity, b.validity))

    def eval_cpu(self, table: HostTable) -> HostColumn:
        from spark_rapids_tpu_torch.dispatch import ANSI_MODE
        p = self.children[0].eval_cpu(table)
        take_a = p.validity & p.data.astype(np.bool_)
        if ANSI_MODE.get():
            # Spark evaluates the branches lazily: each over its rows
            a = _eval_branch_cpu(self.children[1], table, take_a)
            b = _eval_branch_cpu(self.children[2], table, ~take_a)
        else:
            a = self.children[1].eval_cpu(table)
            b = self.children[2].eval_cpu(table)
        data = np.where(take_a, a.data, b.data)
        validity = np.where(take_a, a.validity, b.validity)
        return HostColumn(self.data_type, data, validity)


class CaseWhen(Expression):
    """children = [cond0, val0, cond1, val1, ..., (else)]. An odd child
    count means the last child is the ELSE branch; otherwise ELSE is
    NULL."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    @property
    def has_else(self) -> bool:
        return len(self.children) % 2 == 1

    @property
    def data_type(self):
        return self.children[1].data_type

    def with_children(self, children):
        return CaseWhen(*children)

    def _value_child_indices(self) -> List[int]:
        n = len(self.children) - (1 if self.has_else else 0)
        idx = list(range(1, n, 2))
        if self.has_else:
            idx.append(len(self.children) - 1)
        return idx

    def resolve(self, bound):
        out = self.with_children(bound)
        _check_branches(out, [out.children[i]
                              for i in out._value_child_indices()])
        return out

    def prep(self, pctx, child_preps):
        return _string_prep(pctx, self, child_preps,
                            self._value_child_indices())

    def eval_walk(self, ctx):
        """The device walk: under ANSI each value (and the ELSE) is
        checked only on the rows its condition selects first."""
        from spark_rapids_tpu_torch.ops.expr import _walk_eval
        if not ctx.ansi:
            vals = [_walk_eval(c, ctx) for c in self.children]
            return self.eval_dev(ctx, vals, ctx.next_prep())
        vals = []
        decided = None
        n_branch = len(self.children) - (1 if self.has_else else 0)
        for i in range(0, n_branch, 2):
            c = _walk_eval(self.children[i], ctx)
            vals.append(c)
            take = c.validity & c.data
            if decided is not None:
                take = take & ~decided
            with ctx.guarded(take):
                vals.append(_walk_eval(self.children[i + 1], ctx))
            decided = take if decided is None else decided | take
        if self.has_else:
            # a CaseWhen has at least one branch: ``decided`` is set
            with ctx.guarded(~decided):
                vals.append(_walk_eval(self.children[-1], ctx))
        return self.eval_dev(ctx, vals, ctx.next_prep())

    def eval_dev(self, ctx, child_vals, prep):
        st = _Storage(self.data_type, ctx)
        vals = _branch_data(st, prep, self.children, child_vals,
                            self._value_child_indices())
        data = st.zeros()
        validity = torch.zeros(ctx.capacity, dtype=torch.bool,
                               device=ctx.device)
        decided = torch.zeros_like(validity)
        n_branch = len(self.children) - (1 if self.has_else else 0)
        for i in range(0, n_branch, 2):
            c, v = child_vals[i], child_vals[i + 1]
            take = ~decided & c.validity & c.data
            data = torch.where(st.rows(take), vals[i + 1], data)
            validity = torch.where(take, v.validity, validity)
            decided = decided | take
        if self.has_else:
            i = len(self.children) - 1
            data = torch.where(st.rows(decided), data, vals[i])
            validity = torch.where(decided, validity,
                                   child_vals[i].validity)
        return DevVal(data, validity)

    def _branches(self):
        n = len(self.children) - (1 if self.has_else else 0)
        return [(self.children[i], self.children[i + 1]) for i in range(0, n, 2)]

    def eval_cpu(self, table):
        from spark_rapids_tpu_torch.dispatch import ANSI_MODE
        n = table.num_rows
        dtype = self.data_type
        if isinstance(dtype, T.StringType):
            data = np.full(n, "", dtype=object)
        else:
            data = np.zeros(n, dtype=dtype.np_dtype)
        validity = np.zeros(n, dtype=np.bool_)
        decided = np.zeros(n, dtype=np.bool_)
        ansi = ANSI_MODE.get()
        for cond, val in self._branches():
            c = cond.eval_cpu(table)
            if ansi:
                # Spark evaluates the branches lazily: each value over
                # the rows its condition selects first
                take = ~decided & c.validity & c.data.astype(np.bool_)
                v = _eval_branch_cpu(val, table, take)
            else:
                v = val.eval_cpu(table)
            take = ~decided & c.validity & c.data.astype(np.bool_)
            data = np.where(take, v.data, data)
            validity = np.where(take, v.validity, validity)
            decided |= take
        if self.has_else:
            v = _eval_branch_cpu(self.children[-1], table, ~decided) \
                if ansi else self.children[-1].eval_cpu(table)
            data = np.where(~decided, v.data, data)
            validity = np.where(~decided, v.validity, validity)
        return HostColumn(dtype, data, validity)


def _eval_branch_cpu(expr: Expression, table: HostTable,
                     mask: np.ndarray) -> HostColumn:
    """``expr`` evaluated over the rows of ``mask`` only (ANSI's lazy
    branches), scattered back to the table's length; the other rows are
    null."""
    idx = np.nonzero(mask)[0]
    part = expr.eval_cpu(table.take(idx))
    n = table.num_rows
    data = np.full(n, None, dtype=object) if part.data.dtype == object \
        else np.zeros((n,) + part.data.shape[1:], dtype=part.data.dtype)
    validity = np.zeros(n, dtype=np.bool_)
    data[idx] = part.data
    validity[idx] = part.validity
    return HostColumn(part.dtype, data, validity)


class Coalesce(Expression):
    def __init__(self, *children: Expression):
        self.children = tuple(children)

    @property
    def data_type(self):
        return self.children[0].data_type

    def with_children(self, children):
        return Coalesce(*children)

    def resolve(self, bound):
        out = self.with_children(bound)
        _check_branches(out, out.children)
        return out

    def prep(self, pctx, child_preps):
        return _string_prep(pctx, self, child_preps,
                            range(len(self.children)))

    def eval_dev(self, ctx, child_vals, prep):
        st = _Storage(self.data_type, ctx)
        datas = _branch_data(st, prep, self.children, child_vals,
                             range(len(self.children)))
        data = datas[0]
        validity = child_vals[0].validity
        for i in range(1, len(self.children)):
            v = child_vals[i]
            take = ~validity & v.validity
            data = torch.where(st.rows(take), datas[i], data)
            validity = validity | v.validity
        return DevVal(data, validity)

    def eval_cpu(self, table):
        cols = [c.eval_cpu(table) for c in self.children]
        data = cols[0].data.copy()
        validity = cols[0].validity.copy()
        for c in cols[1:]:
            take = ~validity & c.validity
            data = np.where(take, c.data, data)
            validity |= c.validity
        return HostColumn(self.data_type, data, validity)


def _dec128_pick(new: torch.Tensor, cur: torch.Tensor, greater: bool):
    from spark_rapids_tpu_torch.ops.predicates import _dec128_sign
    sign = _dec128_sign(new, cur)
    return sign > 0 if greater else sign < 0


class _MinMaxN(Expression):
    """Least/Greatest: skip nulls; null only when every input is null."""

    _greater = False

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    @property
    def data_type(self):
        return self.children[0].data_type

    def with_children(self, children):
        return type(self)(*children)

    def resolve(self, bound):
        out = self.with_children(bound)
        _check_branches(out, out.children)
        return out

    def prep(self, pctx, child_preps):
        return _string_prep(pctx, self, child_preps,
                            range(len(self.children)))

    def eval_dev(self, ctx, child_vals, prep):
        st = _Storage(self.data_type, ctx)
        datas = _branch_data(st, prep, self.children, child_vals,
                             range(len(self.children)))
        data = datas[0]
        validity = child_vals[0].validity
        for i in range(1, len(self.children)):
            d, v = datas[i], child_vals[i]
            if st.limbs:
                pick = _dec128_pick(d, data, self._greater)
            else:
                pick = d > data if self._greater else d < data
            better = v.validity & (~validity | pick)
            data = torch.where(st.rows(better), d, data)
            validity = validity | v.validity
        return DevVal(torch.where(st.rows(validity), data,
                                  torch.zeros_like(data)), validity)

    def eval_cpu(self, table):
        cols = [c.eval_cpu(table) for c in self.children]
        string = isinstance(self.data_type, T.StringType)
        data = cols[0].data.copy()
        if string:
            data = np.where(cols[0].validity, data, "")
        validity = cols[0].validity.copy()
        for c in cols[1:]:
            cd = np.where(c.validity, c.data, "") if string else c.data
            better = c.validity & (~validity | type(self)._pick_cpu(cd, data))
            data = np.where(better, cd, data)
            validity |= c.validity
        if string:
            data = data.astype(object)
            out = np.empty(len(data), dtype=object)
            out[:] = data
            out[~validity] = None
            data = out
        return HostColumn(self.data_type, data, validity)


class Least(_MinMaxN):
    _greater = False
    _pick_cpu = staticmethod(lambda new, cur: new < cur)


class Greatest(_MinMaxN):
    _greater = True
    _pick_cpu = staticmethod(lambda new, cur: new > cur)


class NaNvl(Expression):
    """NaNvl(a, b): a if a is not NaN, else b."""

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    @property
    def data_type(self):
        return self.children[0].data_type

    def with_children(self, children):
        return NaNvl(*children)

    def resolve(self, bound):
        out = self.with_children(bound)
        if not isinstance(out.data_type, _SIMPLE_NUMERIC):
            raise NotImplementedError(
                f"nanvl over {out.data_type.simple_string()} (Spark takes "
                "float or double) is not ported")
        _check_branches(out, out.children)
        return out

    def eval_dev(self, ctx, child_vals, prep):
        a, b = child_vals
        st = _Storage(self.data_type, ctx)
        ad, bd = st.value(self.children[0], a), st.value(self.children[1], b)
        take_b = a.validity & torch.isnan(ad)
        return DevVal(torch.where(take_b, bd, ad),
                      torch.where(take_b, b.validity, a.validity))

    def eval_cpu(self, table):
        a = self.children[0].eval_cpu(table)
        b = self.children[1].eval_cpu(table)
        take_b = a.validity & np.isnan(a.data)
        data = np.where(take_b, b.data, a.data)
        validity = np.where(take_b, b.validity, a.validity)
        return HostColumn(self.data_type, data, validity)

