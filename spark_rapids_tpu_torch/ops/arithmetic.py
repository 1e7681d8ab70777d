"""Arithmetic with Spark's (non-ANSI, Java) semantics (port of the Add,
Subtract, Multiply and Divide part of ``spark_rapids_tpu/ops/
arithmetic.py``).

Operands of different numeric types meet at their promoted type through
Casts (``coerce_numeric_pair``); integer results wrap on overflow (two's
complement, like Java). Divide casts both sides to DOUBLE and returns
NULL on a zero divisor. A decimal operand beside a float or double casts
to DOUBLE (Spark's coercion); arithmetic between decimals, or between a
decimal and an integral type, needs the reference's decimal operators
(``DecimalAdd``, ...), which are not ported and raise naming themselves.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops.common import (
    BinaryExpression,
    coerce_numeric_pair,
    null_and,
)
from spark_rapids_tpu_torch.ops.expr import DevVal

_FLOATS = (T.FloatType, T.DoubleType)


def _check_numeric(name: str, lt: T.DataType, rt: T.DataType) -> None:
    for t in (lt, rt):
        if not isinstance(t, T.NumericType):
            raise NotImplementedError(
                f"{name} on {lt.simple_string()} and {rt.simple_string()} "
                "is not ported (numeric operands only)")


def _decimal_to_double(name: str, bound):
    """Spark's coercion of a decimal operand: with a float or double
    beside it, both sides become DOUBLE; otherwise the reference's decimal
    operator, which raises."""
    from spark_rapids_tpu_torch.ops import decimal as dec
    from spark_rapids_tpu_torch.ops.cast import make_cast
    lt, rt = bound[0].data_type, bound[1].data_type
    if isinstance(lt, _FLOATS) or isinstance(rt, _FLOATS):
        return [make_cast(e, T.DOUBLE) for e in bound]
    dec.decimal_binary(name, lt, rt)


class BinaryArithmetic(BinaryExpression):
    @property
    def data_type(self):
        return self.left.data_type

    def resolve(self, bound):
        lt, rt = bound[0].data_type, bound[1].data_type
        _check_numeric(self.name, lt, rt)
        if isinstance(lt, T.DecimalType) or isinstance(rt, T.DecimalType):
            left, right = _decimal_to_double(self.name, bound)
        else:
            left, right, _ = coerce_numeric_pair(*bound)
        return type(self)(left, right)

    def _dev_op(self, ld, rd):
        raise NotImplementedError

    def eval_dev(self, ctx, child_vals, prep):
        lval, rval = child_vals
        validity = null_and(lval.validity, rval.validity)
        data = self._dev_op(lval.data, rval.data)
        return DevVal(torch.where(validity, data, torch.zeros_like(data)),
                      validity)


class Add(BinaryArithmetic):
    def _dev_op(self, ld, rd):
        return ld + rd


class Subtract(BinaryArithmetic):
    def _dev_op(self, ld, rd):
        return ld - rd


class Multiply(BinaryArithmetic):
    def _dev_op(self, ld, rd):
        return ld * rd


class Divide(BinaryArithmetic):
    """Double division; NULL on a zero divisor (Spark non-ANSI)."""

    @property
    def data_type(self):
        return T.DOUBLE

    def resolve(self, bound):
        from spark_rapids_tpu_torch.ops.cast import make_cast
        lt, rt = bound[0].data_type, bound[1].data_type
        _check_numeric(self.name, lt, rt)
        if isinstance(lt, T.DecimalType) or isinstance(rt, T.DecimalType):
            left, right = _decimal_to_double(self.name, bound)
        else:
            left, right = (make_cast(e, T.DOUBLE) for e in bound)
        return Divide(left, right)

    def eval_dev(self, ctx, child_vals, prep):
        lval, rval = child_vals
        nonzero = rval.data != 0.0
        validity = lval.validity & rval.validity & nonzero
        safe = torch.where(nonzero, rval.data, torch.ones_like(rval.data))
        return DevVal(torch.where(validity, lval.data / safe,
                                  torch.zeros_like(lval.data)), validity)
