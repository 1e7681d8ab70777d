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

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
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

    def eval_cpu(self, table: HostTable) -> HostColumn:
        c = self.child.eval_cpu(table)
        validity = c.validity.copy()
        with np.errstate(all="ignore"):
            if type(self).null_when is not None:
                validity &= ~type(self).null_when(c.data)
            data = type(self).np_fn(np.where(validity, c.data, 1.0))
        return HostColumn(T.DOUBLE, np.where(validity, data, 0.0), validity)


def _mk_unary(name, fn, np_fn, null_when=None):
    """A UnaryMath: ``fn`` on the device, ``np_fn`` (the reference's
    numpy function) on the CPU route."""
    cls = type(name, (UnaryMath,), {"fn": staticmethod(fn),
                                    "np_fn": staticmethod(np_fn)})
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


Sqrt = _mk_unary("Sqrt", sqrt_rounded, np.sqrt)
Cbrt = _mk_unary("Cbrt", _cbrt, np.cbrt)
Exp = _mk_unary("Exp", torch.exp, np.exp)
Expm1 = _mk_unary("Expm1", torch.expm1, np.expm1)
Sin = _mk_unary("Sin", torch.sin, np.sin)
Cos = _mk_unary("Cos", torch.cos, np.cos)
Tan = _mk_unary("Tan", torch.tan, np.tan)
Cot = _mk_unary("Cot", lambda x: 1.0 / torch.tan(x), lambda x: 1.0 / np.tan(x))
Asin = _mk_unary("Asin", torch.asin, np.arcsin)
Acos = _mk_unary("Acos", torch.acos, np.arccos)
Atan = _mk_unary("Atan", torch.atan, np.arctan)
Sinh = _mk_unary("Sinh", torch.sinh, np.sinh)
Cosh = _mk_unary("Cosh", torch.cosh, np.cosh)
Tanh = _mk_unary("Tanh", torch.tanh, np.tanh)
Asinh = _mk_unary("Asinh", torch.asinh, np.arcsinh)
Acosh = _mk_unary("Acosh", torch.acosh, np.arccosh)
Atanh = _mk_unary("Atanh", torch.atanh, np.arctanh)
Rint = _mk_unary("Rint", torch.round, np.rint)
# Java's signum keeps NaN and the sign of zero (torch.sign gives 0.0)
Signum = _mk_unary("Signum", lambda x: torch.where(
    torch.isnan(x) | (x == 0), x, torch.sign(x)), np.sign)
ToDegrees = _mk_unary("ToDegrees", lambda x: x * (180.0 / math.pi), np.degrees)
ToRadians = _mk_unary("ToRadians", lambda x: x * (math.pi / 180.0), np.radians)

# Spark's log family gives NULL for a non-positive input (non-ANSI)
Log = _mk_unary("Log", torch.log, np.log, lambda x: x <= 0.0)
Log10 = _mk_unary("Log10", torch.log10, np.log10, lambda x: x <= 0.0)
Log2 = _mk_unary("Log2", torch.log2, np.log2, lambda x: x <= 0.0)
Log1p = _mk_unary("Log1p", torch.log1p, np.log1p, lambda x: x <= -1.0)


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

    def eval_cpu(self, table):
        c = self.child.eval_cpu(table)
        with np.errstate(invalid="ignore"):
            r = type(self).np_fn(c.data)
            r = np.where(np.isnan(c.data), 0.0, r)
            r = np.clip(r, float(_LONG_MIN), float(_LONG_MAX))
        out = np.empty(len(c), dtype=np.int64)
        big = r >= float(_LONG_MAX)
        small = r <= float(_LONG_MIN)
        mid = ~(big | small)
        out[big] = _LONG_MAX
        out[small] = _LONG_MIN
        out[mid] = r[mid].astype(np.int64)
        return HostColumn(T.LONG, np.where(c.validity, out, 0), c.validity.copy())


class Ceil(_CeilFloorBase):
    fn = staticmethod(torch.ceil)
    np_fn = staticmethod(np.ceil)


class Floor(_CeilFloorBase):
    fn = staticmethod(torch.floor)
    np_fn = staticmethod(np.floor)


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

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        d = self._scale()
        factor = 10.0 ** d
        with np.errstate(all="ignore"):
            x = c.data * factor
            if self.half_even:
                r = np.rint(x)
            else:
                r = np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))
            data = r / factor
        if isinstance(c.dtype, T.IntegralType):
            data = data.astype(c.dtype.np_dtype)
        data = np.where(c.validity, data, np.zeros((), dtype=data.dtype))
        return HostColumn(self.data_type, data.astype(c.data.dtype), c.validity.copy())


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

    def _int_exact_applicable(self, np_dtype) -> bool:
        """Exact path only when 10^-scale is representable in the column
        dtype — otherwise wider powers wrap (int16 at scale -5) and the
        float path's semantics apply."""
        return 10 ** (-self._scale()) <= int(np.iinfo(np_dtype).max)

    def _int_exact(self, data):
        """floor/ceil of integral ``data`` at 10^scale, scale <= 0, exact."""
        p = np.asarray(10 ** (-self._scale()), dtype=data.dtype)
        q = data // p  # floor division (toward -inf): the floor directly
        if self._adjust_up:
            q = q + ((data % p) != 0).astype(data.dtype)
        return q * p

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        if (isinstance(c.dtype, T.IntegralType) and self._scale() <= 0
                and self._int_exact_applicable(c.dtype.np_dtype)):
            return HostColumn(c.dtype, self._int_exact(c.data),
                              c.validity.copy())
        factor = 10.0 ** self._scale()
        with np.errstate(all="ignore"):
            data = type(self).np_fn(c.data * factor) / factor
        if isinstance(c.dtype, T.IntegralType):
            data = data.astype(c.dtype.np_dtype)
        return HostColumn(c.dtype, data, c.validity.copy())


class RoundCeil(_RoundDirBase):
    fn = staticmethod(torch.ceil)
    np_fn = staticmethod(np.ceil)
    _adjust_up = 1


class RoundFloor(_RoundDirBase):
    fn = staticmethod(torch.floor)
    np_fn = staticmethod(np.floor)


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

    def eval_cpu(self, table):
        l = self.left.eval_cpu(table)
        r = self.right.eval_cpu(table)
        validity = l.validity & r.validity
        with np.errstate(all="ignore"):
            data = np.power(np.where(validity, l.data, 1.0), np.where(validity, r.data, 1.0))
        return HostColumn(T.DOUBLE, np.where(validity, data, 0.0), validity)


class Hypot(_DoubleBinary):
    def eval_dev(self, ctx, child_vals, prep):
        lv, rv = child_vals
        validity = lv.validity & rv.validity
        return _zero_invalid(torch.hypot(lv.data, rv.data), validity)

    def eval_cpu(self, table):
        l = self.left.eval_cpu(table)
        r = self.right.eval_cpu(table)
        validity = l.validity & r.validity
        with np.errstate(all="ignore"):
            data = np.hypot(l.data, r.data)
        return HostColumn(T.DOUBLE, np.where(validity, data, 0.0), validity)


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

    def eval_cpu(self, table):
        base = self.left.eval_cpu(table)
        x = self.right.eval_cpu(table)
        validity = base.validity & x.validity & (x.data > 0) & (base.data > 0)
        with np.errstate(all="ignore"):
            data = np.log(np.where(validity, x.data, 1.0)) / np.log(np.where(validity, base.data, 2.0))
        return HostColumn(T.DOUBLE, np.where(validity, data, 0.0), validity)


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

    def eval_cpu(self, table):
        l = self.left.eval_cpu(table)
        r = self.right.eval_cpu(table)
        validity = l.validity & r.validity
        data = type(self).op(torch.from_numpy(l.data),
                             torch.from_numpy(r.data)).numpy()
        return HostColumn(self.data_type, np.where(validity, data, 0).astype(l.data.dtype), validity)


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

    def eval_cpu(self, table):
        c = self.child.eval_cpu(table)
        return HostColumn(self.data_type, np.where(c.validity, ~c.data, 0).astype(c.data.dtype),
                          c.validity.copy())


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

    def eval_cpu(self, table):
        l = self.left.eval_cpu(table)
        r = self.right.eval_cpu(table)
        validity = l.validity & r.validity
        bits = 64 if l.data.dtype == np.int64 else 32
        a = torch.from_numpy(l.data)
        cnt = torch.from_numpy(r.data & (bits - 1)).to(a.dtype)
        data = self._shift(a, cnt, bits).numpy()
        return HostColumn(self.data_type, np.where(validity, data, 0).astype(l.data.dtype), validity)


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
