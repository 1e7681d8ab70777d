"""Cast (port of the integral-widening part of
``spark_rapids_tpu/ops/cast.py``): the planner casts a join's two key
columns to their common type when they differ (``T.promote``). Only
widening between integral types is ported; any other cast raises
NotImplementedError when it binds."""

from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops.expr import DevVal, Expression


class Cast(Expression):
    def __init__(self, child: Expression, dtype: T.DataType):
        self.children = (child,)
        self._dtype = dtype

    @property
    def data_type(self):
        return self._dtype

    def with_children(self, children):
        return Cast(children[0], self._dtype)

    def resolve(self, bound):
        check_cast(bound[0].data_type, self._dtype)
        return Cast(bound[0], self._dtype)

    def prep(self, pctx, child_preps):
        from spark_rapids_tpu_torch.ops.expr import NodePrep
        # widening keeps every value, so the (min, max) domain carries over
        return NodePrep(out_domain=child_preps[0].out_domain)

    def eval_dev(self, ctx, child_vals, prep):
        v = child_vals[0]
        return DevVal(v.data.to(T.torch_dtype(self._dtype)), v.validity)

    def __repr__(self):
        return f"cast({self.children[0]!r} as {self._dtype.simple_string()})"


_WIDTH = {T.ByteType: 1, T.ShortType: 2, T.IntegerType: 4, T.LongType: 8}


def check_cast(src: T.DataType, dst: T.DataType) -> None:
    ws, wd = _WIDTH.get(type(src)), _WIDTH.get(type(dst))
    if ws is None or wd is None or wd < ws:
        raise NotImplementedError(
            f"cast from {src.simple_string()} to {dst.simple_string()} is "
            "not ported (the port widens integral types only)")
