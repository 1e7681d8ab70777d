"""Arithmetic with Spark's (Java) semantics and its ANSI mode (port of
``spark_rapids_tpu/ops/arithmetic.py``: Add, Subtract, Multiply, Divide,
IntegralDivide, Remainder, Pmod, UnaryMinus, UnaryPositive and Abs).

Operands of different numeric types meet at their promoted type through
Casts (``coerce_numeric_pair``); integer results wrap on overflow (two's
complement, like Java). Divide casts both sides to DOUBLE and returns
NULL on a zero divisor; IntegralDivide casts both sides to LONG and
truncates toward zero; Remainder and Pmod take Java's % (the sign of the
dividend) and return NULL on a zero divisor. A decimal operand beside a
float or double casts to DOUBLE (Spark's coercion); between decimals, or a
decimal and an integral type (cast through ``decimal_for``), the
arithmetic becomes the reference's decimal operator (ops/decimal.py).

Integer division and fmod by zero, and INT_MIN by -1, trap on the CPU:
every divisor is made safe first (a zero divisor's row is null, and x % -1
is 0 and x div -1 is -x, wrapped, without dividing). Negation and abs
wrap at INT_MIN as Java's do.

Under ``spark.sql.ansi.enabled`` (``dispatch.ANSI_MODE``) an integral
+, -, *, negation or abs that overflows, and a zero divisor of /, div, %
or pmod, raise AnsiViolation instead: the device walk records a flag
(``EvalCtx.ansi_check``), the CPU route raises at once. Pmod's check is
Spark's; the reference has none (it returns null), a deviation the tests
pin.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.ops.common import (
    BinaryExpression,
    UnaryExpression,
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


def _as_decimals(name: str, bound):
    """Both operands as decimals: an integral one cast to its
    ``decimal_for`` type (Spark's coercion)."""
    from spark_rapids_tpu_torch.errors import ColumnarProcessingError
    from spark_rapids_tpu_torch.ops import decimal as dec
    from spark_rapids_tpu_torch.ops.cast import make_cast
    out = []
    for e in bound:
        d = dec.decimal_for(e.data_type)
        if d is None:
            raise ColumnarProcessingError(
                f"cannot mix {e.data_type.simple_string()} with decimal "
                f"{name} (cast explicitly)")
        out.append(make_cast(e, d))
    return out


def _unary(expr, child):
    if not isinstance(child.data_type, T.NumericType):
        raise NotImplementedError(
            f"{expr.name} of {child.data_type.simple_string()} is not "
            "ported (numeric operands only)")
    return type(expr)(child)


def _decimal_operands(bound):
    """None when no operand is a decimal; the operands cast to DOUBLE when
    a float or double meets a decimal; else ``()``: decimal arithmetic."""
    from spark_rapids_tpu_torch.ops.cast import make_cast
    lt, rt = bound[0].data_type, bound[1].data_type
    if not (isinstance(lt, T.DecimalType) or isinstance(rt, T.DecimalType)):
        return None
    if isinstance(lt, _FLOATS) or isinstance(rt, _FLOATS):
        return [make_cast(e, T.DOUBLE) for e in bound]
    return ()


def _not_zero(x: torch.Tensor) -> torch.Tensor:
    return x != 0


def _safe_divisor(d: torch.Tensor, integral: bool) -> torch.Tensor:
    """``d`` with every zero (and, for integers, every -1) replaced by 1:
    division by those traps on the CPU; callers handle their rows."""
    bad = d == 0
    if integral:
        bad = bad | (d == -1)
    return torch.where(bad, torch.ones_like(d), d)


def _wrap_neg(x: torch.Tensor) -> torch.Tensor:
    """-x with two's-complement wrap for integers (-INT_MIN == INT_MIN)."""
    if x.is_floating_point():
        return -x
    return ~x + 1


#: (bits dtype, quiet bit, default NaN bits: the sign set) of a float
_NAN_BITS = {torch.float64: (torch.int64, 1 << 51, -(1 << 51)),
             torch.float32: (torch.int32, 1 << 22, -(1 << 22))}


def _c_fmod_nan(r: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """fmod's NaN results with the bits of the C library's fmod on x86
    (numpy's and XLA's on the CPU, the reference's): the dividend's NaN,
    else the divisor's, quieted, else the default NaN (its sign set).
    torch's own NaN bits differ by backend and from these."""
    bits, quiet, default = _NAN_BITS[r.dtype]
    dflt = torch.full((), default, dtype=bits, device=r.device).view(
        r.dtype)
    pick = torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b,
                                                        dflt))
    pick = (pick.view(bits) | quiet).view(r.dtype)
    return torch.where(torch.isnan(r), pick, r)


def _java_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Java's % (fmod: the sign of the dividend); rows with b == 0 are the
    caller's to null; x % -1 is 0."""
    if a.is_floating_point():
        b = _safe_divisor(b, False)
        return _c_fmod_nan(torch.fmod(a, b), a, b)
    r = torch.fmod(a, _safe_divisor(b, True))
    return torch.where(b == -1, torch.zeros_like(r), r)


def _ansi() -> bool:
    from spark_rapids_tpu_torch.dispatch import ANSI_MODE
    return ANSI_MODE.get()


def _ansi_raise(what: str) -> None:
    """The CPU route's ANSI error (the reference's message)."""
    from spark_rapids_tpu_torch.errors import AnsiViolation
    raise AnsiViolation(f"{what} (spark.sql.ansi.enabled)")


def _ansi_div_zero_dev(ctx, lval, rval) -> None:
    if ctx.ansi:
        ctx.ansi_check("divide by zero",
                       lval.validity & rval.validity & (rval.data == 0))


def _ansi_div_zero_cpu(l, r) -> None:
    if _ansi() and (l.validity & r.validity & (r.data == 0)).any():
        _ansi_raise("divide by zero")


class BinaryArithmetic(BinaryExpression):
    #: the reference's decimal operator this one becomes over decimals
    decimal_impl = None
    #: ANSI overflow check of integral operands: the label's symbol
    ansi_symbol = None

    @property
    def data_type(self):
        return self.left.data_type

    def resolve(self, bound):
        lt, rt = bound[0].data_type, bound[1].data_type
        _check_numeric(self.name, lt, rt)
        dec_ops = _decimal_operands(bound)
        if dec_ops == ():
            left, right = _as_decimals(self.name, bound)
            return self._decimal_impl()(left, right).resolve([left, right])
        if dec_ops is not None:
            left, right = dec_ops
        else:
            left, right, _ = coerce_numeric_pair(*bound)
        return type(self)(left, right)

    def _decimal_impl(self):
        from spark_rapids_tpu_torch.ops import decimal as dec
        return getattr(dec, self.decimal_impl)

    def _dev_op(self, ld, rd):
        raise NotImplementedError

    def _dev_overflow(self, ld, rd, res):
        raise NotImplementedError

    def _cpu_overflow(self, ld, rd, res):
        """The rows whose exact result leaves the type's range: the device
        form's sign test over numpy, exact for a wrapped sum or
        difference; a product is recomputed in Python integers (the
        reference's form)."""
        return self._dev_overflow(ld, rd, res)

    def eval_dev(self, ctx, child_vals, prep):
        lval, rval = child_vals
        validity = null_and(lval.validity, rval.validity)
        data = self._dev_op(lval.data, rval.data)
        if ctx.ansi and self.ansi_symbol and \
                isinstance(self.data_type, T.IntegralType):
            bad = self._dev_overflow(lval.data, rval.data, data) & validity
            ctx.ansi_check(f"integer overflow in {self.ansi_symbol}", bad)
        return DevVal(torch.where(validity, data, torch.zeros_like(data)),
                      validity)

    def _cpu_op(self, ld, rd):
        raise NotImplementedError

    def eval_cpu(self, table: HostTable) -> HostColumn:
        l = self.left.eval_cpu(table)
        r = self.right.eval_cpu(table)
        with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
            data = self._cpu_op(l.data, r.data)
        validity = l.validity & r.validity
        if _ansi() and self.ansi_symbol and \
                isinstance(self.data_type, T.IntegralType) and \
                (validity & self._cpu_overflow(l.data, r.data, data)).any():
            _ansi_raise(f"integer overflow in {self.ansi_symbol}")
        zero = np.zeros((), dtype=data.dtype).item()
        return HostColumn(self.data_type, np.where(validity, data, zero).astype(data.dtype), validity)


class Add(BinaryArithmetic):
    decimal_impl = "DecimalAdd"
    ansi_symbol = "+"

    def _dev_op(self, ld, rd):
        return ld + rd

    def _dev_overflow(self, ld, rd, res):
        # operands of one sign whose wrapped sum has the other
        return ((ld >= 0) == (rd >= 0)) & ((res >= 0) != (ld >= 0))

    def _cpu_op(self, ld, rd):
        return ld + rd


class Subtract(BinaryArithmetic):
    decimal_impl = "DecimalSubtract"
    ansi_symbol = "-"

    def _dev_op(self, ld, rd):
        return ld - rd

    def _dev_overflow(self, ld, rd, res):
        return ((ld >= 0) != (rd >= 0)) & ((res >= 0) != (ld >= 0))

    def _cpu_op(self, ld, rd):
        return ld - rd


class Multiply(BinaryArithmetic):
    decimal_impl = "DecimalMultiply"
    ansi_symbol = "*"

    def _dev_op(self, ld, rd):
        return ld * rd

    def _cpu_overflow(self, ld, rd, res):
        wide = ld.astype(object) * rd.astype(object)
        info = np.iinfo(res.dtype)
        return np.fromiter((not (info.min <= w <= info.max) for w in wide),
                           dtype=np.bool_, count=len(wide))

    def _dev_overflow(self, ld, rd, res):
        # divide back (exact for floor division too: a wrapped product
        # differs from the true one by a multiple of 2^bits); a divisor
        # of 0 or -1 is never divided by (INT_MIN / -1 traps on the CPU)
        info = torch.iinfo(res.dtype)
        odd = (rd == 0) | (rd == -1)
        safe = torch.where(odd, torch.ones_like(rd), rd)
        back = ~odd & (torch.div(res, safe, rounding_mode="floor") != ld)
        min_neg = ((ld == info.min) & (rd == -1)) | \
            ((rd == info.min) & (ld == -1))
        return back | min_neg

    def _cpu_op(self, ld, rd):
        return ld * rd


class Divide(BinaryArithmetic):
    """Double division; NULL on a zero divisor (Spark non-ANSI)."""

    decimal_impl = "DecimalDivide"

    @property
    def data_type(self):
        return T.DOUBLE

    def resolve(self, bound):
        from spark_rapids_tpu_torch.ops.cast import make_cast
        lt, rt = bound[0].data_type, bound[1].data_type
        _check_numeric(self.name, lt, rt)
        dec_ops = _decimal_operands(bound)
        if dec_ops == ():
            return super().resolve(bound)
        left, right = (make_cast(e, T.DOUBLE) for e in bound)
        return Divide(left, right)

    def eval_dev(self, ctx, child_vals, prep):
        lval, rval = child_vals
        _ansi_div_zero_dev(ctx, lval, rval)
        nonzero = rval.data != 0.0
        validity = lval.validity & rval.validity & nonzero
        safe = torch.where(nonzero, rval.data, torch.ones_like(rval.data))
        return DevVal(torch.where(validity, lval.data / safe,
                                  torch.zeros_like(lval.data)), validity)

    def eval_cpu(self, table):
        l = self.left.eval_cpu(table)
        r = self.right.eval_cpu(table)
        _ansi_div_zero_cpu(l, r)
        validity = l.validity & r.validity & (r.data != 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            data = np.where(validity, l.data / np.where(r.data != 0.0, r.data, 1.0), 0.0)
        return HostColumn(T.DOUBLE, data, validity)


class IntegralDivide(BinaryArithmetic):
    """``div``: both operands cast to LONG, truncating division, NULL on a
    zero divisor; over decimals the exact decimal quotient (DecimalDivide)
    truncated to LONG (7.5 div 0.5 is 15)."""

    @property
    def data_type(self):
        return T.LONG

    def resolve(self, bound):
        from spark_rapids_tpu_torch.ops import decimal as dec
        from spark_rapids_tpu_torch.ops.cast import make_cast
        _check_numeric(self.name, bound[0].data_type, bound[1].data_type)
        if any(isinstance(e.data_type, T.DecimalType) for e in bound):
            out = []
            for e in bound:
                if dec.decimal_for(e.data_type) is None:
                    e = make_cast(e, T.LONG)
                out.append(make_cast(e, dec.decimal_for(e.data_type)))
            quotient = dec.DecimalDivide(out[0], out[1]).resolve(out)
            return make_cast(quotient, T.LONG)
        return IntegralDivide(*(make_cast(e, T.LONG) for e in bound))

    def eval_dev(self, ctx, child_vals, prep):
        lval, rval = child_vals
        _ansi_div_zero_dev(ctx, lval, rval)
        a, b = lval.data, rval.data
        validity = lval.validity & rval.validity & _not_zero(b)
        q = torch.div(a, _safe_divisor(b, True), rounding_mode="trunc")
        q = torch.where(b == -1, _wrap_neg(a), q)
        return DevVal(torch.where(validity, q, torch.zeros_like(q)),
                      validity)

    def eval_cpu(self, table):
        l = self.left.eval_cpu(table)
        r = self.right.eval_cpu(table)
        _ansi_div_zero_cpu(l, r)
        validity = l.validity & r.validity & (r.data != 0)
        with np.errstate(over="ignore"):
            data = _trunc_div_int(l.data, r.data)
        return HostColumn(T.LONG, np.where(validity, data, 0), validity)


class Remainder(BinaryArithmetic):
    """% with Java semantics (the sign of the dividend), NULL on a zero
    divisor."""

    decimal_impl = "DecimalRemainder"

    def eval_dev(self, ctx, child_vals, prep):
        lval, rval = child_vals
        _ansi_div_zero_dev(ctx, lval, rval)
        validity = lval.validity & rval.validity & _not_zero(rval.data)
        data = _java_mod(lval.data, rval.data)
        return DevVal(torch.where(validity, data, torch.zeros_like(data)),
                      validity)

    def eval_cpu(self, table):
        l = self.left.eval_cpu(table)
        r = self.right.eval_cpu(table)
        _ansi_div_zero_cpu(l, r)
        validity = l.validity & r.validity & (r.data != 0)
        data = _java_mod_np(l.data, r.data)
        zero = np.zeros((), dtype=l.data.dtype).item()
        return HostColumn(self.data_type, np.where(validity, data, zero).astype(l.data.dtype), validity)


class Pmod(BinaryArithmetic):
    """Positive modulus: ((a % b) + b) % b with Java %, NULL on zero."""

    decimal_impl = "DecimalPmod"

    def eval_dev(self, ctx, child_vals, prep):
        lval, rval = child_vals
        _ansi_div_zero_dev(ctx, lval, rval)
        b = rval.data
        validity = lval.validity & rval.validity & _not_zero(b)
        safe = torch.where(b == 0, torch.ones_like(b), b)
        data = _java_mod(_java_mod(lval.data, safe) + safe, safe)
        return DevVal(torch.where(validity, data, torch.zeros_like(data)),
                      validity)

    def eval_cpu(self, table):
        l = self.left.eval_cpu(table)
        r = self.right.eval_cpu(table)
        _ansi_div_zero_cpu(l, r)
        validity = l.validity & r.validity & (r.data != 0)
        safe = np.where(r.data != 0, r.data, 1)
        with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
            m = np.fmod(l.data, safe)
            data = np.fmod(m + safe, safe)
        zero = np.zeros((), dtype=l.data.dtype).item()
        return HostColumn(self.data_type, np.where(validity, data, zero).astype(l.data.dtype), validity)


class UnaryMinus(UnaryExpression):
    """-x; an integer wraps at its MIN (Java); a DECIMAL128 negates its
    128-bit value (the reference's CPU route)."""

    @property
    def data_type(self):
        return self.child.data_type

    def resolve(self, bound):
        return _unary(self, bound[0])

    def eval_dev(self, ctx, child_vals, prep):
        (c,) = child_vals
        if c.data.ndim == 2:
            from spark_rapids_tpu_torch.ops.decimal import i128_neg
            hi, lo = i128_neg(c.data[:, 0], c.data[:, 1])
            data = torch.stack([hi, lo], dim=1)
            return DevVal(torch.where(c.validity[:, None], data,
                                      torch.zeros_like(data)), c.validity)
        if ctx.ansi and isinstance(self.data_type, T.IntegralType):
            ctx.ansi_check("integer overflow in negate", c.validity & (
                c.data == torch.iinfo(c.data.dtype).min))
        return DevVal(torch.where(c.validity, _wrap_neg(c.data),
                                  torch.zeros_like(c.data)), c.validity)

    def eval_cpu(self, table):
        c = self.child.eval_cpu(table)
        if _ansi() and isinstance(self.data_type, T.IntegralType) and (
                c.validity & (c.data == np.iinfo(c.data.dtype).min)).any():
            _ansi_raise("integer overflow in negate")
        with np.errstate(over="ignore"):
            data = -c.data
        zero = np.zeros((), dtype=c.data.dtype).item()
        return HostColumn(self.data_type, np.where(c.validity, data, zero).astype(c.data.dtype), c.validity.copy())


class UnaryPositive(UnaryExpression):
    @property
    def data_type(self):
        return self.child.data_type

    def resolve(self, bound):
        return _unary(self, bound[0])

    def eval_dev(self, ctx, child_vals, prep):
        return child_vals[0]

    def eval_cpu(self, table):
        return self.child.eval_cpu(table)

class Abs(UnaryExpression):
    """Java Math.abs: wraps at integer MIN_VALUE (non-ANSI); a DECIMAL128
    takes its 128-bit magnitude."""

    @property
    def data_type(self):
        return self.child.data_type

    def resolve(self, bound):
        return _unary(self, bound[0])

    def eval_dev(self, ctx, child_vals, prep):
        (c,) = child_vals
        if c.data.ndim == 2:
            from spark_rapids_tpu_torch.ops.decimal import i128_abs
            hi, lo, _ = i128_abs(c.data[:, 0], c.data[:, 1])
            data = torch.stack([hi, lo], dim=1)
            return DevVal(torch.where(c.validity[:, None], data,
                                      torch.zeros_like(data)), c.validity)
        x = c.data
        if ctx.ansi and not x.is_floating_point():
            ctx.ansi_check("integer overflow in abs", c.validity & (
                x == torch.iinfo(x.dtype).min))
        data = x.abs() if x.is_floating_point() else \
            torch.where(x < 0, _wrap_neg(x), x)
        return DevVal(torch.where(c.validity, data, torch.zeros_like(data)),
                      c.validity)

    def eval_cpu(self, table):
        c = self.child.eval_cpu(table)
        if _ansi() and np.issubdtype(c.data.dtype, np.integer) and (
                c.validity & (c.data == np.iinfo(c.data.dtype).min)).any():
            _ansi_raise("integer overflow in abs")
        with np.errstate(over="ignore"):
            data = np.abs(c.data)
        zero = np.zeros((), dtype=c.data.dtype).item()
        return HostColumn(self.data_type, np.where(c.validity, data, zero).astype(c.data.dtype), c.validity.copy())


# ---------------------------------------------------------------------------
# host evaluation helpers (the CPU route)
# ---------------------------------------------------------------------------


def _trunc_div_int(a, b):
    """C/Java truncation division of integer arrays (numpy floors)."""
    q = np.floor_divide(a, np.where(b != 0, b, 1))
    r = a - q * np.where(b != 0, b, 1)
    adjust = (r != 0) & ((a < 0) != (b < 0))
    return q + adjust.astype(q.dtype)


def _java_mod_np(a, b):
    """Java % -- sign of the dividend. fmod matches for both ints and
    floats."""
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.fmod(a, np.where(b != 0, b, 1))
