"""Comparison predicates and AND (port of the EqualTo, LessThan,
LessThanOrEqual, GreaterThan and And parts of
``spark_rapids_tpu/ops/predicates.py``).

Ported operands: DATE, integer, FLOAT and DOUBLE operands; integer
operands of different widths meet at the wider type through a widening
Cast (the reference's ``coerce_numeric_pair``), and every other pair of
types raises NotImplementedError. Floats compare in Spark's total order:
NaN equals NaN and is greater than every other value. ``==`` between a
dictionary-encoded string column and a string literal becomes a code
lookup in the column's dictionary (the reference aligns the column's
dictionary with the literal's one-entry dictionary; the lookup gives the
same answer without a device remap). Two string columns need the
reference's dictionary alignment and raise NotImplementedError."""

from __future__ import annotations

import operator

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops.common import BinaryExpression, null_and
from spark_rapids_tpu_torch.ops.expr import (
    DevVal,
    Expression,
    Literal,
    NodePrep,
)

_PORTED_TYPES = (T.DateType, T.ByteType, T.ShortType, T.IntegerType,
                 T.LongType, T.FloatType, T.DoubleType)
_INTEGRAL = (T.ByteType, T.ShortType, T.IntegerType, T.LongType)


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
    return (nl & ~nr) | (ld > rd)  # operator.gt


class BinaryComparison(BinaryExpression):
    op = None  # the Python operator

    @property
    def data_type(self):
        return T.BOOLEAN

    def resolve(self, bound):
        left, right = bound
        lt, rt = left.data_type, right.data_type
        if lt != rt and isinstance(lt, _INTEGRAL) and \
                isinstance(rt, _INTEGRAL):
            from spark_rapids_tpu_torch.ops.cast import Cast
            out = T.promote(lt, rt)
            left = left if lt == out else Cast(left, out)
            right = right if rt == out else Cast(right, out)
        elif lt != rt or not isinstance(lt, _PORTED_TYPES):
            raise NotImplementedError(
                f"{self.name} on {lt.simple_string()} and "
                f"{rt.simple_string()}: the port compares DATE, integer "
                "and float operands, and a string column == a string "
                "literal")
        return type(self)(left, right)

    def eval_dev(self, ctx, child_vals, prep):
        lval, rval = child_vals
        validity = null_and(lval.validity, rval.validity)
        if lval.data.is_floating_point():
            data = _spark_float_cmp(type(self).op, lval.data, rval.data)
        else:
            data = type(self).op(lval.data, rval.data)
        return DevVal(data & validity, validity)


class EqualTo(BinaryComparison):
    def resolve(self, bound):
        left, right = bound
        for col, other in ((left, right), (right, left)):
            if (isinstance(col.data_type, T.StringType)
                    and isinstance(other, Literal)
                    and isinstance(other.data_type, T.StringType)):
                return StringEqualsLiteral(col, other.value)
        return super().resolve(bound)

    op = staticmethod(operator.eq)


class LessThan(BinaryComparison):
    op = staticmethod(operator.lt)


class LessThanOrEqual(BinaryComparison):
    op = staticmethod(operator.le)


class GreaterThan(BinaryComparison):
    op = staticmethod(operator.gt)


class And(BinaryExpression):
    """Kleene logic: false AND null = false."""

    @property
    def data_type(self):
        return T.BOOLEAN

    def resolve(self, bound):
        for b in bound:
            if not isinstance(b.data_type, T.BooleanType):
                raise NotImplementedError(
                    f"And of {b.data_type.simple_string()} is not ported")
        return And(bound[0], bound[1])

    def eval_dev(self, ctx, child_vals, prep):
        lval, rval = child_vals
        ld = lval.data & lval.validity
        rd = rval.data & rval.validity
        # valid iff both sides are, or either side is a definite false
        validity = (lval.validity & rval.validity) | \
            (lval.validity & ~lval.data) | (rval.validity & ~rval.data)
        return DevVal(ld & rd & validity, validity)


class StringEqualsLiteral(Expression):
    """``string_column == 'literal'``: the prep walk finds the literal's
    code in the column's sorted dictionary (-1 when absent, so no row
    matches) and the device compares codes."""

    def __init__(self, child: Expression, value):
        self.children = (child,)
        self.value = value

    @property
    def data_type(self):
        return T.BOOLEAN

    @property
    def name(self):
        return "EqualTo"

    def with_children(self, children):
        return StringEqualsLiteral(children[0], self.value)

    def prep(self, pctx, child_preps):
        d = child_preps[0].out_dict
        if not child_preps[0].dict_sorted:
            raise NotImplementedError("string == literal over an unsorted "
                                      "dictionary is not ported")
        i = int(np.searchsorted(d, self.value))
        code = i if i < len(d) and d[i] == self.value else -1
        return NodePrep(lookup_code=code)

    def eval_dev(self, ctx, child_vals, prep):
        v = child_vals[0]
        return DevVal((v.data == prep.lookup_code) & v.validity, v.validity)

    def __repr__(self):
        return f"({self.children[0]!r} = {self.value!r})"
