"""Numeric casts (port of the numeric, boolean and decimal parts of
``spark_rapids_tpu/ops/cast.py``), with Java's rules as the reference
implements them:

* integral -> narrower integral wraps (keeps the low bits);
* float/double -> integral truncates toward zero, saturates at the
  type's MIN/MAX, and NaN becomes 0;
* numeric -> boolean is ``v != 0``; boolean -> numeric is 1/0;
* integral -> decimal multiplies by 10^scale, null when it overflows the
  precision; decimal -> decimal rescales with HALF_UP rounding, null on
  overflow; decimal -> integral truncates toward zero, null when out of
  range; decimal -> float/double divides the unscaled value by 10^scale
  (a DECIMAL128 value combines its limbs in f64 first, as the reference
  does).

The pairs are those the reference's ``cast_supported`` admits: DECIMAL128
only to float/double, a decimal -> decimal rescale by at most 18 digits,
and no float/double -> decimal. A NULL literal (``void``) casts to any
type as an all-null column in that type's storage (``T.promote`` coerces
a NULL operand to the other operand's type). Casts to or from strings,
dates and timestamps are not ported; every unported pair raises
NotImplementedError when it binds.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops.expr import DevVal, Expression, NodePrep

_INT_BOUNDS = {
    np.dtype(np.int8): (-(1 << 7), (1 << 7) - 1),
    np.dtype(np.int16): (-(1 << 15), (1 << 15) - 1),
    np.dtype(np.int32): (-(1 << 31), (1 << 31) - 1),
    np.dtype(np.int64): (-(1 << 63), (1 << 63) - 1),
}

_WIDTH = {T.ByteType: 1, T.ShortType: 2, T.IntegerType: 4, T.LongType: 8}

_SIMPLE = (T.BooleanType, T.ByteType, T.ShortType, T.IntegerType,
           T.LongType, T.FloatType, T.DoubleType)


def cast_supported(src: T.DataType, dst: T.DataType) -> bool:
    """The numeric pairs of the reference's ``cast_supported``."""
    if src == dst or isinstance(src, T.NullType):
        return True
    dec_max = T.DecimalType.MAX_LONG_DIGITS
    if isinstance(src, T.DecimalType) or isinstance(dst, T.DecimalType):
        if isinstance(src, T.DecimalType) and isinstance(dst, T.DecimalType):
            return (src.precision <= dec_max and dst.precision <= dec_max
                    and abs(src.scale - dst.scale) <= 18)
        if isinstance(dst, T.DecimalType):
            return (dst.precision <= dec_max
                    and isinstance(src, T.IntegralType))
        if isinstance(dst, (T.DoubleType, T.FloatType)):
            return True
        return (src.precision <= dec_max
                and isinstance(dst, T.IntegralType))
    return isinstance(src, _SIMPLE) and isinstance(dst, _SIMPLE)


def check_cast(src: T.DataType, dst: T.DataType) -> None:
    if not cast_supported(src, dst):
        raise NotImplementedError(
            f"cast from {src.simple_string()} to {dst.simple_string()} is "
            "not ported (the port casts among the numeric types and "
            "boolean)")


def make_cast(child: Expression, dtype: T.DataType) -> Expression:
    """``child`` itself when it already has ``dtype``, else a checked
    Cast."""
    if child.data_type == dtype:
        return child
    check_cast(child.data_type, dtype)
    return Cast(child, dtype)


def _is_widening(src: T.DataType, dst: T.DataType) -> bool:
    ws, wd = _WIDTH.get(type(src)), _WIDTH.get(type(dst))
    return ws is not None and wd is not None and wd >= ws


def _cast_simple(data: torch.Tensor, src: T.DataType,
                 dst: T.DataType) -> torch.Tensor:
    """The reference's ``_cast_data_jnp`` for the numeric and boolean
    types."""
    dd = T.torch_dtype(dst)
    if isinstance(dst, T.BooleanType):
        return data != 0
    if isinstance(src, (T.FloatType, T.DoubleType)) and \
            isinstance(dst, T.IntegralType):
        lo, hi = _INT_BOUNDS[np.dtype(dst.np_dtype)]
        t = torch.trunc(data.to(torch.float64))
        t = torch.where(torch.isnan(t), torch.zeros_like(t), t)
        t = t.clamp(float(lo), float(hi))
        # the conversion of the clamped ends is replaced below: 2^63 as an
        # int64 conversion is out of range
        out = torch.where((t > float(lo)) & (t < float(hi)), t,
                          torch.zeros_like(t)).to(dd)
        out = torch.where(t >= float(hi), torch.full_like(out, hi), out)
        return torch.where(t <= float(lo), torch.full_like(out, lo), out)
    return data.to(dd)


def _cast_decimal(c: DevVal, src: T.DataType, dst: T.DataType) -> DevVal:
    """The reference's ``_dev_decimal_cast``."""
    from spark_rapids_tpu_torch.ops.decimal import (
        _POW10,
        dev_rescale_checked,
        i128_to_f64,
    )
    if isinstance(src, T.DecimalType) and isinstance(dst, T.DecimalType):
        return dev_rescale_checked(c.data, c.validity, src.scale, dst.scale,
                                   dst.precision)
    if isinstance(dst, T.DecimalType):
        # integral -> decimal: a rescale from scale 0
        return dev_rescale_checked(c.data.to(torch.int64), c.validity, 0,
                                   dst.scale, dst.precision)
    scale = _POW10[src.scale]
    if isinstance(dst, (T.DoubleType, T.FloatType)):
        if T.is_dec128(src):
            # by sign and magnitude: the reference's hi * 2^64 + lo cancels
            # for small negatives (-0.05 at scale 2 becomes 0.0)
            data = i128_to_f64(c.data[:, 0], c.data[:, 1]) / float(scale)
        else:
            data = c.data.to(torch.float64) / float(scale)
        data = data.to(T.torch_dtype(dst))
        return DevVal(torch.where(c.validity, data, torch.zeros_like(data)),
                      c.validity)
    # integral: truncate toward zero, null when out of range
    q = torch.div(c.data, scale, rounding_mode="trunc")
    lo, hi = _INT_BOUNDS[np.dtype(dst.np_dtype)]
    validity = c.validity & (q >= lo) & (q <= hi)
    out = q.to(T.torch_dtype(dst))
    return DevVal(torch.where(validity, out, torch.zeros_like(out)),
                  validity)


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
        if isinstance(self.children[0].data_type, T.NullType) and \
                isinstance(self._dtype, T.StringType):
            # all-null codes over an empty dictionary
            return NodePrep(out_dict=np.array([], dtype=object))
        # an integral widening keeps every value, so the (min, max) domain
        # carries over
        if _is_widening(self.children[0].data_type, self._dtype):
            return NodePrep(out_domain=child_preps[0].out_domain)
        return NodePrep()

    def eval_dev(self, ctx, child_vals, prep):
        (c,) = child_vals
        src, dst = self.children[0].data_type, self._dtype
        if src == dst:
            return c
        if isinstance(src, T.NullType):
            from spark_rapids_tpu_torch.columnar.column import (
                null_data_array,
            )
            return DevVal(null_data_array(dst, ctx.capacity, ctx.device),
                          torch.zeros_like(c.validity))
        if isinstance(src, T.DecimalType) or isinstance(dst, T.DecimalType):
            return _cast_decimal(c, src, dst)
        data = _cast_simple(c.data, src, dst)
        return DevVal(torch.where(c.validity, data, torch.zeros_like(data)),
                      c.validity)

    def __repr__(self):
        return f"cast({self.children[0]!r} as {self._dtype.simple_string()})"
