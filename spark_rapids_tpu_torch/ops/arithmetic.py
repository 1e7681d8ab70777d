"""Arithmetic on doubles (port of the Add/Subtract/Multiply/Divide part of
``spark_rapids_tpu/ops/arithmetic.py``).

Only DOUBLE operands are ported: other operand types need the reference's
coercion casts and integer overflow rules, which raise NotImplementedError
at bind time. Divide returns NULL on a zero divisor (Spark non-ANSI)."""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops.common import BinaryExpression, null_and
from spark_rapids_tpu_torch.ops.expr import DevVal


class BinaryArithmetic(BinaryExpression):
    @property
    def data_type(self):
        return self.left.data_type

    def resolve(self, bound):
        lt, rt = bound[0].data_type, bound[1].data_type
        if lt != T.DOUBLE or rt != T.DOUBLE:
            raise NotImplementedError(
                f"{self.name} on {lt.simple_string()} and "
                f"{rt.simple_string()}: the port has double arithmetic only")
        return type(self)(bound[0], bound[1])

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

    def eval_dev(self, ctx, child_vals, prep):
        lval, rval = child_vals
        nonzero = rval.data != 0.0
        validity = lval.validity & rval.validity & nonzero
        safe = torch.where(nonzero, rval.data, torch.ones_like(rval.data))
        return DevVal(torch.where(validity, lval.data / safe,
                                  torch.zeros_like(lval.data)), validity)
