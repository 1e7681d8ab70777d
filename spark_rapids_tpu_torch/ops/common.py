"""Shared expression machinery: the binary base and null propagation
(port of the parts of ``spark_rapids_tpu/ops/common.py`` the slice uses)."""

from __future__ import annotations

from spark_rapids_tpu_torch.ops.expr import Expression


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


def null_and(*validities):
    """Combined validity: all inputs valid (default null propagation)."""
    out = validities[0]
    for v in validities[1:]:
        out = out & v
    return out
