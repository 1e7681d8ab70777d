"""Math expressions (port of ``spark_rapids_tpu/ops/math.py``): the
elementwise double functions (trigonometric, hyperbolic, exp and the log
family, rint, signum, degrees and radians), ceil/floor to LONG,
round/bround at a literal scale, ceil/floor at a scale, pow, hypot,
log(base, x), the bitwise operators and the shifts.

Spark-exact corners: the log family gives NULL for a non-positive input;
ceil/floor of a double give LONG, saturating at its bounds like Java;
round is HALF_UP, bround HALF_EVEN; a shift masks its count like Java
(& 31 for int, & 63 for long). Ceil, floor, round, bround, sqrt, the
bitwise operators and the shifts are IEEE-exact or integer operations and
match the reference bit for bit; a transcendental function may differ
from the reference (XLA on the CPU), from torch on the CPU and from CUDA's
libm by an ulp or two."""

from __future__ import annotations

import math

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops.cast import make_cast
from spark_rapids_tpu_torch.ops.common import (
    BinaryExpression,
    UnaryExpression,
    coerce_numeric_pair,
)
from spark_rapids_tpu_torch.ops.expr import DevVal, Expression, Literal


def _numeric(expr: Expression, child: Expression) -> None:
    if not isinstance(child.data_type, T.NumericType):
        raise NotImplementedError(
            f"{expr.name} of {child.data_type.simple_string()} is not "
            "ported")


def _floating(x: torch.Tensor) -> torch.Tensor:
    """An integral tensor as float64 (numpy's promotion of an integer
    array times a Python float; torch's would give float32)."""
    return x if x.is_floating_point() else x.to(torch.float64)


def _true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded once, as IEEE division: a tensor divided by a Python
    scalar runs on CUDA as a product with the scalar's reciprocal, which
    can differ in the last bit."""
    return x / torch.full_like(x, c)


def _zero_invalid(data: torch.Tensor, validity: torch.Tensor) -> DevVal:
    return DevVal(torch.where(validity, data, torch.zeros_like(data)),
                  validity)


class UnaryMath(UnaryExpression):
    """double -> double elementwise; ``null_when`` makes the result NULL on
    a domain violation (Spark's log family)."""

    fn = None
    null_when = None

    @property
    def data_type(self):
        return T.DOUBLE

    def resolve(self, bound):
        _numeric(self, bound[0])
        return type(self)(make_cast(bound[0], T.DOUBLE))

    def eval_dev(self, ctx, child_vals, prep):
        (c,) = child_vals
        validity = c.validity
        if type(self).null_when is not None:
            validity = validity & ~type(self).null_when(c.data)
        data = type(self).fn(torch.where(validity, c.data,
                                         torch.ones_like(c.data)))
        return _zero_invalid(data, validity)


def _mk_unary(name, fn, null_when=None):
    cls = type(name, (UnaryMath,), {"fn": staticmethod(fn)})
    if null_when is not None:
        cls.null_when = staticmethod(null_when)
    return cls


def _square_residual(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x - y * y with y * y exact (Dekker's product by Veltkamp's split)
    and x - y * y exact where y * y is within a factor 2 of x."""
    p = y * y
    c = y * 134217729.0  # 2^27 + 1
    hi = c - (c - y)
    lo = y - hi
    return (x - p) - (((hi * hi - p) + 2.0 * hi * lo) + lo * lo)


def sqrt_rounded(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, on any backend: torch.sqrt (IEEE
    on CUDA; a 1-ulp approximation in some CPU builds), then of it and its
    two neighbours the one whose square is nearest x. A tiny x is scaled
    by 2^1000 first, so the residual does not underflow."""
    tiny = x < 2.0 ** -900
    xs = torch.where(tiny, x * 2.0 ** 1000, x)
    y = torch.sqrt(xs)
    best, res = y, _square_residual(xs, y).abs()
    for cand in (torch.nextafter(y, torch.zeros_like(y)),
                 torch.nextafter(y, torch.full_like(y, float("inf")))):
        r = _square_residual(xs, cand).abs()
        best = torch.where(r < res, cand, best)
        res = torch.minimum(r, res)
    best = torch.where(torch.isfinite(y) & (xs > 0), best, y)
    return torch.where(tiny, best * 2.0 ** -500, best)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """|x|^(1/3) with x's sign, then one Newton step (1/3 is not exact);
    zeros, infinities and NaN pass through."""
    y = torch.sign(x) * torch.abs(x).pow(1 / 3)
    y = y - (y * y * y - x) / (3.0 * y * y)
    return torch.where((x == 0) | ~torch.isfinite(x), x, y)


Sqrt = _mk_unary("Sqrt", sqrt_rounded)
Cbrt = _mk_unary("Cbrt", _cbrt)
Exp = _mk_unary("Exp", torch.exp)
Expm1 = _mk_unary("Expm1", torch.expm1)
Sin = _mk_unary("Sin", torch.sin)
Cos = _mk_unary("Cos", torch.cos)
Tan = _mk_unary("Tan", torch.tan)
Cot = _mk_unary("Cot", lambda x: 1.0 / torch.tan(x))
Asin = _mk_unary("Asin", torch.asin)
Acos = _mk_unary("Acos", torch.acos)
Atan = _mk_unary("Atan", torch.atan)
Sinh = _mk_unary("Sinh", torch.sinh)
Cosh = _mk_unary("Cosh", torch.cosh)
Tanh = _mk_unary("Tanh", torch.tanh)
Asinh = _mk_unary("Asinh", torch.asinh)
Acosh = _mk_unary("Acosh", torch.acosh)
Atanh = _mk_unary("Atanh", torch.atanh)
Rint = _mk_unary("Rint", torch.round)
# Java's signum keeps NaN and the sign of zero (torch.sign gives 0.0)
Signum = _mk_unary("Signum", lambda x: torch.where(
    torch.isnan(x) | (x == 0), x, torch.sign(x)))
ToDegrees = _mk_unary("ToDegrees", lambda x: x * (180.0 / math.pi))
ToRadians = _mk_unary("ToRadians", lambda x: x * (math.pi / 180.0))

# Spark's log family gives NULL for a non-positive input (non-ANSI)
Log = _mk_unary("Log", torch.log, lambda x: x <= 0.0)
Log10 = _mk_unary("Log10", torch.log10, lambda x: x <= 0.0)
Log2 = _mk_unary("Log2", torch.log2, lambda x: x <= 0.0)
Log1p = _mk_unary("Log1p", torch.log1p, lambda x: x <= -1.0)


_LONG_MIN, _LONG_MAX = -(1 << 63), (1 << 63) - 1


class _CeilFloorBase(UnaryExpression):
    """ceil/floor of a double -> LONG with Java's saturation; an integral
    input is returned as it is."""

    fn = None

    @property
    def data_type(self):
        return T.LONG

    def resolve(self, bound):
        (c,) = bound
        _numeric(self, c)
        if isinstance(c.data_type, T.IntegralType):
            return c  # a no-op on integers (Spark keeps the value)
        if isinstance(c.data_type, T.DecimalType):
            raise NotImplementedError(
                f"{self.name} of {c.data_type.simple_string()} is not "
                "ported")
        return type(self)(make_cast(c, T.DOUBLE))

    def eval_dev(self, ctx, child_vals, prep):
        (c,) = child_vals
        r = type(self).fn(c.data)
        r = torch.where(torch.isnan(c.data), torch.zeros_like(r), r)
        r = r.clamp(float(_LONG_MIN), float(_LONG_MAX))
        big, small = r >= float(_LONG_MAX), r <= float(_LONG_MIN)
        out = torch.where(big | small, torch.zeros_like(r), r).to(torch.int64)
        out = torch.where(big, torch.full_like(out, _LONG_MAX), out)
        out = torch.where(small, torch.full_like(out, _LONG_MIN), out)
        return _zero_invalid(out, c.validity)


class Ceil(_CeilFloorBase):
    fn = staticmethod(torch.ceil)


class Floor(_CeilFloorBase):
    fn = staticmethod(torch.floor)


class _RoundBase(Expression):
    """round(child, scale): HALF_UP (Round) or HALF_EVEN (BRound) at
    decimal scale d, computed as the reference does (x * 10^d rounded,
    over 10^d, in doubles). The scale must be a literal."""

    half_even = False

    def __init__(self, child: Expression, scale: Expression = None):
        scale = scale if scale is not None else Literal(0)
        self.children = (child, scale)

    @property
    def data_type(self):
        return self.children[0].data_type

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def resolve(self, bound):
        out = self.with_children(bound)
        if not isinstance(out.children[1], Literal):
            raise NotImplementedError(
                f"{out.name} with a non-literal scale is not ported")
        _numeric(out, out.children[0])
        if isinstance(out.data_type, T.DecimalType):
            raise NotImplementedError(
                f"{out.name} of {out.data_type.simple_string()} is not "
                "ported")
        return out

    def _scale(self) -> int:
        return int(self.children[1].value)

    def eval_dev(self, ctx, child_vals, prep):
        c = child_vals[0]
        factor = 10.0 ** self._scale()
        x = _floating(c.data) * factor
        if self.half_even:
            r = torch.round(x)
        else:
            r = torch.where(x >= 0, torch.floor(x + 0.5),
                            torch.ceil(x - 0.5))
        data = _true_div(r, factor).to(c.data.dtype)
        return _zero_invalid(data, c.validity)


class Round(_RoundBase):
    half_even = False


class BRound(_RoundBase):
    half_even = True


class _RoundDirBase(_RoundBase):
    """ceil/floor at a decimal scale (RoundCeil/RoundFloor). An integral
    input at scale <= 0 is exact integer arithmetic where 10^-scale fits
    its type; otherwise doubles, as the reference."""

    fn = None
    _adjust_up = 0

    def eval_dev(self, ctx, child_vals, prep):
        c = child_vals[0]
        dt = self.children[0].data_type
        scale = self._scale()
        if isinstance(dt, T.IntegralType) and scale <= 0 and \
                10 ** (-scale) <= torch.iinfo(c.data.dtype).max:
            p = 10 ** (-scale)
            q = c.data // p
            if self._adjust_up:
                q = q + (c.data % p != 0).to(q.dtype)
            return DevVal(q * p, c.validity)
        factor = 10.0 ** scale
        data = _true_div(type(self).fn(_floating(c.data) * factor), factor)
        return DevVal(data.to(c.data.dtype), c.validity)


class RoundCeil(_RoundDirBase):
    fn = staticmethod(torch.ceil)
    _adjust_up = 1


class RoundFloor(_RoundDirBase):
    fn = staticmethod(torch.floor)


class _DoubleBinary(BinaryExpression):
    @property
    def data_type(self):
        return T.DOUBLE

    def resolve(self, bound):
        for c in bound:
            _numeric(self, c)
        return type(self)(*(make_cast(c, T.DOUBLE) for c in bound))


class Pow(_DoubleBinary):
    def eval_dev(self, ctx, child_vals, prep):
        lv, rv = child_vals
        validity = lv.validity & rv.validity
        one = torch.ones_like(lv.data)
        data = torch.pow(torch.where(validity, lv.data, one),
                         torch.where(validity, rv.data, one))
        return _zero_invalid(data, validity)


class Hypot(_DoubleBinary):
    def eval_dev(self, ctx, child_vals, prep):
        lv, rv = child_vals
        validity = lv.validity & rv.validity
        return _zero_invalid(torch.hypot(lv.data, rv.data), validity)


class Logarithm(_DoubleBinary):
    """log(base, x): NULL where x <= 0 or base <= 0."""

    def eval_dev(self, ctx, child_vals, prep):
        base, x = child_vals
        validity = base.validity & x.validity & (x.data > 0) & \
            (base.data > 0)
        data = torch.log(torch.where(validity, x.data,
                                     torch.ones_like(x.data))) / \
            torch.log(torch.where(validity, base.data,
                                  torch.full_like(base.data, 2.0)))
        return _zero_invalid(data, validity)


# ---------------------------------------------------------------------------
# bitwise / shifts
# ---------------------------------------------------------------------------

def _integral(expr: Expression, *children: Expression) -> None:
    for c in children:
        if not isinstance(c.data_type, T.IntegralType):
            raise NotImplementedError(
                f"{expr.name} of {c.data_type.simple_string()} is not "
                "ported (integral operands only)")


class _BitwiseBinary(BinaryExpression):
    op = None

    @property
    def data_type(self):
        return self.left.data_type

    def resolve(self, bound):
        _integral(self, *bound)
        left, right, _ = coerce_numeric_pair(*bound)
        return type(self)(left, right)

    def eval_dev(self, ctx, child_vals, prep):
        lv, rv = child_vals
        return _zero_invalid(type(self).op(lv.data, rv.data),
                             lv.validity & rv.validity)


class BitwiseAnd(_BitwiseBinary):
    op = staticmethod(torch.bitwise_and)


class BitwiseOr(_BitwiseBinary):
    op = staticmethod(torch.bitwise_or)


class BitwiseXor(_BitwiseBinary):
    op = staticmethod(torch.bitwise_xor)


class BitwiseNot(UnaryExpression):
    @property
    def data_type(self):
        return self.child.data_type

    def resolve(self, bound):
        _integral(self, bound[0])
        return BitwiseNot(bound[0])

    def eval_dev(self, ctx, child_vals, prep):
        (c,) = child_vals
        return _zero_invalid(~c.data, c.validity)


class _ShiftBase(BinaryExpression):
    """Java shifts: the count is masked (& 31 for int, & 63 for long); a
    byte or short value shifts as an int."""

    @property
    def data_type(self):
        return self.left.data_type

    def resolve(self, bound):
        _integral(self, *bound)
        left = bound[0]
        if not isinstance(left.data_type, (T.IntegerType, T.LongType)):
            left = make_cast(left, T.INT)
        return type(self)(left, make_cast(bound[1], T.INT))

    def _shift(self, a: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eval_dev(self, ctx, child_vals, prep):
        lv, rv = child_vals
        bits = 64 if lv.data.dtype == torch.int64 else 32
        cnt = (rv.data & (bits - 1)).to(lv.data.dtype)
        return _zero_invalid(self._shift(lv.data, cnt, bits),
                             lv.validity & rv.validity)


class ShiftLeft(_ShiftBase):
    def _shift(self, a, cnt, bits):
        return torch.bitwise_left_shift(a, cnt)


class ShiftRight(_ShiftBase):
    def _shift(self, a, cnt, bits):
        return torch.bitwise_right_shift(a, cnt)


class ShiftRightUnsigned(_ShiftBase):
    def _shift(self, a, cnt, bits):
        # the arithmetic shift with its copied sign bits cleared
        keep = ~torch.bitwise_left_shift(torch.full_like(a, -1),
                                         (bits - cnt) % bits)
        keep = torch.where(cnt == 0, torch.full_like(a, -1), keep)
        return torch.bitwise_right_shift(a, cnt) & keep
