"""Comparison predicates (port of the LessThanOrEqual part of
``spark_rapids_tpu/ops/predicates.py``).

Only DATE and integer operands of one type are ported: floats need the
reference's NaN ordering and strings its dictionary alignment."""

from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops.common import BinaryExpression, null_and
from spark_rapids_tpu_torch.ops.expr import DevVal

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
                "operands of one type only")
        return type(self)(bound[0], bound[1])

    def _dev_op(self, ld, rd):
        raise NotImplementedError

    def eval_dev(self, ctx, child_vals, prep):
        lval, rval = child_vals
        validity = null_and(lval.validity, rval.validity)
        data = self._dev_op(lval.data, rval.data)
        return DevVal(data & validity, validity)


class LessThanOrEqual(BinaryComparison):
    def _dev_op(self, ld, rd):
        return ld <= rd
