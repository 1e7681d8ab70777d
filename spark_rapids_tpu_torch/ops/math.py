"""Math functions (port of the Sqrt part of ``spark_rapids_tpu/ops/
math.py``, which the multi-batch merge's stddev finalize reads; the
others are not ported)."""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops.cast import make_cast
from spark_rapids_tpu_torch.ops.common import UnaryExpression
from spark_rapids_tpu_torch.ops.expr import DevVal


class Sqrt(UnaryExpression):
    """sqrt(x) as a double; NaN for a negative x (Java's Math.sqrt)."""

    @property
    def data_type(self):
        return T.DOUBLE

    def resolve(self, bound):
        if not isinstance(bound[0].data_type, T.NumericType):
            raise NotImplementedError(
                f"Sqrt of {bound[0].data_type.simple_string()} is not "
                "ported")
        return Sqrt(make_cast(bound[0], T.DOUBLE))

    def eval_dev(self, ctx, child_vals, prep):
        (c,) = child_vals
        return DevVal(torch.where(c.validity, torch.sqrt(c.data),
                                  torch.zeros_like(c.data)), c.validity)
