"""Predicates and boolean logic (port of ``spark_rapids_tpu/ops/
predicates.py``: EqualTo, EqualNullSafe, LessThan, LessThanOrEqual,
GreaterThan, GreaterThanOrEqual, And, Or, Not, IsNull, IsNotNull, IsNaN
and In; the reference's InSet, which no API of the port builds, is not
ported).

Comparison operands of different numeric types meet at their promoted
type through Casts (``coerce_numeric_pair``); a NULL literal operand
(``void``) is cast to the other operand's type, as ``T.promote`` coerces
it, so ``x = NULL`` is null on every row and ``x <=> NULL`` is
``x IS NULL``. Floats compare in Spark's
total order: NaN equals NaN and is greater than every other value, and
-0.0 equals 0.0. DECIMAL128 limb pairs compare by a three-way sign (the
high limbs signed, then the low limbs unsigned). ``==``/``<=>`` between a
dictionary-encoded string column and a string literal becomes a code
lookup in the column's sorted dictionary (the reference aligns the
column's dictionary with the literal's; the lookup gives the same answer
without a device remap), and so does ``IN`` of string literals. Two
string columns need the reference's dictionary alignment and raise
NotImplementedError.

And/Or follow Kleene's three-valued logic (false AND null = false, true
OR null = true); IS NULL, IS NOT NULL, IS NAN and ``<=>`` are never null;
``IN`` is null when nothing matches and the value or a listed item is
null. ``IN`` compares raw IEEE values as the reference does."""

from __future__ import annotations

import operator
from typing import Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.ops.common import (
    BinaryExpression,
    UnaryExpression,
    coerce_numeric_pair,
    null_and,
)
from spark_rapids_tpu_torch.ops.expr import (
    DevVal,
    Expression,
    Literal,
    NodePrep,
)

_TOP64 = -0x8000000000000000


def _spark_float_cmp(op, ld: torch.Tensor, rd: torch.Tensor) -> torch.Tensor:
    """Spark's total-order float comparison: NaN == NaN is true and NaN is
    greater than every other value (raw IEEE compares are false for every
    NaN operand)."""
    nl, nr = torch.isnan(ld), torch.isnan(rd)
    if op is operator.eq:
        return (ld == rd) | (nl & nr)
    if op is operator.lt:
        return (~nl & nr) | (ld < rd)
    if op is operator.le:
        return nr | (ld <= rd)
    if op is operator.gt:
        return (nl & ~nr) | (ld > rd)
    return nl | (ld >= rd)  # operator.ge


def _dec128_sign(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Three-way compare (-1/0/+1 int32) of (n, 2) int64 limb pairs: high
    limbs signed, low limbs unsigned through a top-bit flip."""
    def cmp(a, b):
        return (a > b).to(torch.int32) - (a < b).to(torch.int32)
    hi = cmp(left[:, 0], right[:, 0])
    lo = cmp(left[:, 1] ^ _TOP64, right[:, 1] ^ _TOP64)
    return torch.where(hi != 0, hi, lo)


def _compare(op, ld: torch.Tensor, rd: torch.Tensor) -> torch.Tensor:
    if ld.is_floating_point():
        return _spark_float_cmp(op, ld, rd)
    if ld.ndim == 2:
        return op(_dec128_sign(ld, rd), 0)
    return op(ld, rd)


def _string_literal_side(left, right):
    """(string column side, literal value) when one side is a string
    literal (or a NULL one) and the other a string expression, else
    None."""
    for c, other in ((left, right), (right, left)):
        if (isinstance(c.data_type, T.StringType)
                and isinstance(other, Literal)
                and isinstance(other.data_type, (T.StringType,
                                                 T.NullType))):
            return c, other.value
    return None


def _dict_code(d, sorted_: bool, value) -> int:
    """The code of ``value`` in a sorted dictionary, -1 when absent."""
    if not sorted_:
        raise NotImplementedError("a string literal lookup over an unsorted "
                                  "dictionary is not ported")
    if d is None or value is None:
        return -1
    i = int(np.searchsorted(d, value))
    return i if i < len(d) and d[i] == value else -1


class BinaryComparison(BinaryExpression):
    op = None  # the Python operator

    @property
    def data_type(self):
        return T.BOOLEAN

    def resolve(self, bound):
        left, right = bound
        lt, rt = left.data_type, right.data_type
        if isinstance(lt, T.StringType) or isinstance(rt, T.StringType):
            raise NotImplementedError(
                f"{self.name} on {lt.simple_string()} and "
                f"{rt.simple_string()}: strings compare only as a string "
                "column == (or <=>) a string literal in the port")
        if lt != rt:
            left, right, _ = coerce_numeric_pair(left, right)
        return type(self)(left, right)

    def eval_dev(self, ctx, child_vals, prep):
        lval, rval = child_vals
        validity = null_and(lval.validity, rval.validity)
        data = _compare(type(self).op, lval.data, rval.data)
        return DevVal(data & validity, validity)

    def eval_cpu(self, table: HostTable) -> HostColumn:
        l = self.left.eval_cpu(table)
        r = self.right.eval_cpu(table)
        data = _cpu_cmp_data(l, r, type(self).op).astype(np.bool_)
        validity = l.validity & r.validity
        return HostColumn(T.BOOLEAN, np.where(validity, data, False), validity)


class EqualTo(BinaryComparison):
    op = staticmethod(operator.eq)

    def resolve(self, bound):
        side = _string_literal_side(*bound)
        if side is not None:
            return StringEqualsLiteral(*side)
        return super().resolve(bound)


class LessThan(BinaryComparison):
    op = staticmethod(operator.lt)


class LessThanOrEqual(BinaryComparison):
    op = staticmethod(operator.le)


class GreaterThan(BinaryComparison):
    op = staticmethod(operator.gt)


class GreaterThanOrEqual(BinaryComparison):
    op = staticmethod(operator.ge)


class EqualNullSafe(BinaryComparison):
    """``<=>``: never null; null <=> null is true."""

    op = staticmethod(operator.eq)

    def resolve(self, bound):
        side = _string_literal_side(*bound)
        if side is not None:
            return StringEqualsLiteral(*side, null_safe=True)
        return super().resolve(bound)

    def eval_dev(self, ctx, child_vals, prep):
        lval, rval = child_vals
        eq = _compare(operator.eq, lval.data, rval.data)
        both_valid = lval.validity & rval.validity
        both_null = ~lval.validity & ~rval.validity
        data = torch.where(both_valid, eq, both_null)
        return DevVal(data, torch.ones_like(data))

    def eval_cpu(self, table):
        l = self.left.eval_cpu(table)
        r = self.right.eval_cpu(table)
        both_valid = l.validity & r.validity
        both_null = ~l.validity & ~r.validity
        eq = _cpu_cmp_data(l, r, operator.eq).astype(np.bool_)
        data = np.where(both_valid, eq, both_null)
        return HostColumn(T.BOOLEAN, data, np.ones(len(l), dtype=np.bool_))


def _check_boolean(name: str, bound) -> None:
    for b in bound:
        if not isinstance(b.data_type, T.BooleanType):
            raise NotImplementedError(
                f"{name} of {b.data_type.simple_string()} is not ported")


class And(BinaryExpression):
    """Kleene logic: false AND null = false."""

    @property
    def data_type(self):
        return T.BOOLEAN

    def resolve(self, bound):
        _check_boolean("And", bound)
        return And(bound[0], bound[1])

    def eval_dev(self, ctx, child_vals, prep):
        lval, rval = child_vals
        ld = lval.data & lval.validity
        rd = rval.data & rval.validity
        # valid iff both sides are, or either side is a definite false
        validity = (lval.validity & rval.validity) | \
            (lval.validity & ~lval.data) | (rval.validity & ~rval.data)
        return DevVal(ld & rd & validity, validity)

    def eval_cpu(self, table):
        l = self.left.eval_cpu(table)
        r = self.right.eval_cpu(table)
        lv, rv = l.validity, r.validity
        ld = l.data.astype(np.bool_) & lv
        rd = r.data.astype(np.bool_) & rv
        data = ld & rd
        # valid iff: both valid, or either side is a definite false
        validity = (lv & rv) | (lv & ~l.data.astype(np.bool_)) | (rv & ~r.data.astype(np.bool_))
        return HostColumn(T.BOOLEAN, np.where(validity, data, False), validity)


class Or(BinaryExpression):
    """Kleene logic: true OR null = true."""

    @property
    def data_type(self):
        return T.BOOLEAN

    def resolve(self, bound):
        _check_boolean("Or", bound)
        return Or(bound[0], bound[1])

    def eval_dev(self, ctx, child_vals, prep):
        lval, rval = child_vals
        ld = lval.data & lval.validity
        rd = rval.data & rval.validity
        data = ld | rd
        validity = (lval.validity & rval.validity) | ld | rd
        return DevVal(data & validity, validity)

    def eval_cpu(self, table):
        l = self.left.eval_cpu(table)
        r = self.right.eval_cpu(table)
        lv, rv = l.validity, r.validity
        ld = l.data.astype(np.bool_) & lv
        rd = r.data.astype(np.bool_) & rv
        data = ld | rd
        validity = (lv & rv) | ld | rd
        return HostColumn(T.BOOLEAN, np.where(validity, data, False), validity)


class Not(UnaryExpression):
    @property
    def data_type(self):
        return T.BOOLEAN

    def resolve(self, bound):
        _check_boolean("Not", bound)
        return Not(bound[0])

    def eval_dev(self, ctx, child_vals, prep):
        (c,) = child_vals
        return DevVal(~c.data & c.validity, c.validity)

    def eval_cpu(self, table):
        c = self.child.eval_cpu(table)
        data = ~c.data.astype(np.bool_)
        return HostColumn(T.BOOLEAN, np.where(c.validity, data, False), c.validity.copy())


class IsNull(UnaryExpression):
    @property
    def data_type(self):
        return T.BOOLEAN

    def eval_dev(self, ctx, child_vals, prep):
        (c,) = child_vals
        return DevVal(~c.validity, torch.ones_like(c.validity))

    def eval_cpu(self, table):
        c = self.child.eval_cpu(table)
        return HostColumn(T.BOOLEAN, ~c.validity, np.ones(len(c), dtype=np.bool_))


class IsNotNull(UnaryExpression):
    @property
    def data_type(self):
        return T.BOOLEAN

    def eval_dev(self, ctx, child_vals, prep):
        (c,) = child_vals
        return DevVal(c.validity, torch.ones_like(c.validity))

    def eval_cpu(self, table):
        c = self.child.eval_cpu(table)
        return HostColumn(T.BOOLEAN, c.validity.copy(), np.ones(len(c), dtype=np.bool_))


class IsNaN(UnaryExpression):
    @property
    def data_type(self):
        return T.BOOLEAN

    def resolve(self, bound):
        if not isinstance(bound[0].data_type, (T.FloatType, T.DoubleType)):
            raise NotImplementedError(
                f"IsNaN of {bound[0].data_type.simple_string()} is not "
                "ported (float and double only)")
        return IsNaN(bound[0])

    def eval_dev(self, ctx, child_vals, prep):
        (c,) = child_vals
        return DevVal(torch.isnan(c.data) & c.validity,
                      torch.ones_like(c.validity))

    def eval_cpu(self, table):
        c = self.child.eval_cpu(table)
        data = np.isnan(c.data) & c.validity
        return HostColumn(T.BOOLEAN, data, np.ones(len(c), dtype=np.bool_))


class In(Expression):
    """value IN (literals...). Spark: true on a match; null when nothing
    matches and the value or any listed item is null; else false. A
    string value's items must be string literals (their codes are looked
    up in the value's dictionary)."""

    def __init__(self, value: Expression, items: Sequence[Expression]):
        self.children = (value,) + tuple(items)

    @property
    def value(self):
        return self.children[0]

    @property
    def items(self):
        return self.children[1:]

    @property
    def data_type(self):
        return T.BOOLEAN

    def with_children(self, children):
        return type(self)(children[0], children[1:])

    def resolve(self, bound):
        vt = bound[0].data_type
        for item in bound[1:]:
            it = item.data_type
            if isinstance(vt, T.StringType) or isinstance(it, T.StringType):
                if not (isinstance(vt, T.StringType)
                        and isinstance(item, Literal)
                        and isinstance(it, (T.StringType, T.NullType))):
                    raise NotImplementedError(
                        f"{self.name} of {vt.simple_string()} over "
                        f"{it.simple_string()}: a string value takes string "
                        "literals only in the port")
            elif (isinstance(vt, T.DecimalType)
                  or isinstance(it, T.DecimalType)) and (
                    T.is_dec128(vt)
                    or (vt != it and not isinstance(it, T.NullType))):
                # unscaled values compare only at one DECIMAL64 type
                raise NotImplementedError(
                    f"{self.name} of {vt.simple_string()} over "
                    f"{it.simple_string()} is not ported")
        return self.with_children(bound)

    def prep(self, pctx, child_preps):
        vp = child_preps[0]
        if vp.out_dict is None and not isinstance(self.value.data_type,
                                                  T.StringType):
            return NodePrep()
        codes = [_dict_code(vp.out_dict, vp.dict_sorted, i.value)
                 for i in self.items]
        return NodePrep(lookup_codes=tuple(codes))

    def eval_dev(self, ctx, child_vals, prep):
        v = child_vals[0]
        has_null_item = any(isinstance(i, Literal) and i.value is None
                            for i in self.items)
        match = torch.zeros_like(v.validity)
        for idx, iv in enumerate(child_vals[1:]):
            if prep.lookup_codes is not None:
                eq = v.data == prep.lookup_codes[idx]
            else:
                eq = v.data == iv.data
            match = match | (eq & iv.validity)
        validity = v.validity & (match | (not has_null_item))
        return DevVal(match & validity, validity)

    def eval_cpu(self, table):
        from spark_rapids_tpu_torch.ops.expr import Literal
        v = self.value.eval_cpu(table)
        n = len(v)
        has_null_item = any(isinstance(i, Literal) and i.value is None for i in self.items)
        match = np.zeros(n, dtype=np.bool_)
        vd = v.data
        if isinstance(v.dtype, T.StringType):
            vd = np.where(v.validity, vd, "")
        for item in self.items:
            i = item.eval_cpu(table)
            idata = i.data
            if isinstance(v.dtype, T.StringType):
                idata = np.where(i.validity, idata, "")
            match |= (vd == idata) & i.validity
        validity = v.validity & (match | ~np.full(n, has_null_item))
        return HostColumn(T.BOOLEAN, np.where(validity, match, False), validity)


class StringEqualsLiteral(Expression):
    """``string_column == 'literal'`` (or ``<=>`` with ``null_safe``): the
    prep walk finds the literal's code in the column's sorted dictionary
    (-1 when absent, so no row matches) and the device compares codes."""

    #: the folded literal: a template fingerprint keeps only its type and
    #: null-ness, as for a Literal (plan/fingerprint.py)
    FINGERPRINT_LITERALS = ("value",)

    def __init__(self, child: Expression, value, null_safe: bool = False):
        self.children = (child,)
        self.value = value
        self.null_safe = null_safe

    @property
    def data_type(self):
        return T.BOOLEAN

    @property
    def name(self):
        return "EqualNullSafe" if self.null_safe else "EqualTo"

    def with_children(self, children):
        return StringEqualsLiteral(children[0], self.value, self.null_safe)

    def prep(self, pctx, child_preps):
        p = child_preps[0]
        return NodePrep(lookup_code=_dict_code(p.out_dict, p.dict_sorted,
                                               self.value))

    def eval_dev(self, ctx, child_vals, prep):
        v = child_vals[0]
        eq = (v.data == prep.lookup_code) & v.validity
        if not self.null_safe:
            if self.value is None:  # = NULL is null on every row
                return DevVal(eq, torch.zeros_like(v.validity))
            return DevVal(eq, v.validity)
        if self.value is None:
            eq = ~v.validity  # null <=> null
        return DevVal(eq, torch.ones_like(v.validity))

    def eval_cpu(self, table):
        v = self.children[0].eval_cpu(table)
        eq = v.validity & (np.where(v.validity, v.data, None) == self.value)
        if not self.null_safe:
            valid = v.validity if self.value is not None else \
                np.zeros(len(v), dtype=np.bool_)
            return HostColumn(T.BOOLEAN, eq & valid, valid)
        if self.value is None:
            eq = ~v.validity  # null <=> null
        return HostColumn(T.BOOLEAN, eq, np.ones(len(v), dtype=np.bool_))

    def __repr__(self):
        op = "<=>" if self.null_safe else "="
        return f"({self.children[0]!r} {op} {self.value!r})"


# ---------------------------------------------------------------------------
# host evaluation helpers (the CPU route)
# ---------------------------------------------------------------------------


def _spark_float_cmp_np(op, ld, rd):
    """Spark total-order float comparison: NaN == NaN is TRUE and NaN is
    greater than every other value (SQL ref 'NaN semantics'); raw IEEE
    compares would return false for all NaN comparisons."""
    nl, nr = np.isnan(ld), np.isnan(rd)
    if op is operator.eq:
        return (ld == rd) | (nl & nr)
    if op is operator.lt:
        return (~nl & nr) | (ld < rd)
    if op is operator.le:
        return (~nl & nr) | (nl & nr) | (ld <= rd)
    if op is operator.gt:
        return (nl & ~nr) | (ld > rd)
    if op is operator.ge:
        return (nl & ~nr) | (nl & nr) | (ld >= rd)
    return op(ld, rd)


def _cpu_cmp_data(left: HostColumn, right: HostColumn, op):
    ld, rd = left.data, right.data
    if isinstance(left.dtype, T.StringType):
        # Invalid slots may hold None; substitute "" so object comparison
        # (Python str, code-point order == Spark UTF-8 byte order) is safe.
        ld = np.where(left.validity, ld, "")
        rd = np.where(right.validity, rd, "")
    elif np.issubdtype(np.asarray(ld).dtype, np.floating):
        return _spark_float_cmp_np(op, ld, rd)
    return op(ld, rd)
