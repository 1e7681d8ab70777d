"""Shared expression machinery: the unary and binary bases, numeric
coercion and null propagation (port of the parts of
``spark_rapids_tpu/ops/common.py`` the ported operators use)."""

from __future__ import annotations

from typing import Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops.expr import Expression


class UnaryExpression(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def child(self) -> Expression:
        return self.children[0]

    def with_children(self, children):
        return type(self)(children[0])


class BinaryExpression(Expression):
    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    def with_children(self, children):
        return type(self)(children[0], children[1])


def coerce_numeric_pair(left: Expression, right: Expression
                        ) -> Tuple[Expression, Expression, T.DataType]:
    """Insert casts so both sides share the promoted numeric type (Spark
    TypeCoercion's tightest common type, ``T.promote``)."""
    from spark_rapids_tpu_torch.ops.cast import make_cast
    out = T.promote(left.data_type, right.data_type)
    return make_cast(left, out), make_cast(right, out), out


def null_and(*validities):
    """Combined validity: all inputs valid (default null propagation)."""
    out = validities[0]
    for v in validities[1:]:
        out = out & v
    return out
