"""Comparison predicates (port of the EqualTo, LessThan, LessThanOrEqual
and GreaterThan parts of ``spark_rapids_tpu/ops/predicates.py``).

Ported operands: DATE and integer operands of one type, and ``==``
between a dictionary-encoded string column and a string literal, which
becomes a code lookup in the column's dictionary (the reference aligns the
column's dictionary with the literal's one-entry dictionary; the lookup
gives the same answer without a device remap). Floats need the
reference's NaN ordering and two string columns its dictionary alignment:
both raise NotImplementedError."""

from __future__ import annotations

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops.common import BinaryExpression, null_and
from spark_rapids_tpu_torch.ops.expr import (
    DevVal,
    Expression,
    Literal,
    NodePrep,
)

_PORTED_TYPES = (T.DateType, T.ByteType, T.ShortType, T.IntegerType,
                 T.LongType)


class BinaryComparison(BinaryExpression):
    @property
    def data_type(self):
        return T.BOOLEAN

    def resolve(self, bound):
        lt, rt = bound[0].data_type, bound[1].data_type
        if lt != rt or not isinstance(lt, _PORTED_TYPES):
            raise NotImplementedError(
                f"{self.name} on {lt.simple_string()} and "
                f"{rt.simple_string()}: the port compares DATE and integer "
                "operands of one type, and a string column == a string "
                "literal")
        return type(self)(bound[0], bound[1])

    def _dev_op(self, ld, rd):
        raise NotImplementedError

    def eval_dev(self, ctx, child_vals, prep):
        lval, rval = child_vals
        validity = null_and(lval.validity, rval.validity)
        data = self._dev_op(lval.data, rval.data)
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

    def _dev_op(self, ld, rd):
        return ld == rd


class LessThan(BinaryComparison):
    def _dev_op(self, ld, rd):
        return ld < rd


class LessThanOrEqual(BinaryComparison):
    def _dev_op(self, ld, rd):
        return ld <= rd


class GreaterThan(BinaryComparison):
    def _dev_op(self, ld, rd):
        return ld > rd


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
