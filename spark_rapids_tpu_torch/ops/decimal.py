"""Decimal helpers with Spark semantics (port of the parts of
``spark_rapids_tpu/ops/decimal.py`` that the port's sums, casts and
overflow checks need: sum's result type, the 128-bit helpers and the
DECIMAL64 rescale, and the UnscaledValue, MakeDecimal and CheckOverflow
expressions). The other result-type rules and the exact host (Python-int)
helpers serve the decimal binary operators and the reference's CPU
evaluation, neither of which is ported.

Storage (columnar/column.py): precision <= 18 is an int64 unscaled value
(DECIMAL64); 19..38 is a ``(capacity, 2)`` int64 limb pair (DECIMAL128:
the signed high 64 bits, then the unsigned low 64 bits reinterpreted as
int64). A 128-bit value in the helpers below is such a pair of int64
tensors ``(hi, lo)``; the unsigned low limb compares through a top-bit
flip, since torch has no unsigned 64-bit arithmetic.

A DECIMAL64 rescale needs no 128-bit product: a scale-up by 10^d fits
precision p <= 18 exactly when |v| < 10^(p - d), and a scale-down is one
int64 division with its remainder (HALF_UP), so both give the reference's
two-limb results bit for bit. Overflow gives null (non-ANSI).

The decimal binary operators (DecimalAdd, DecimalSubtract,
DecimalMultiply, DecimalDivide, DecimalRemainder, DecimalPmod) are not
ported: arithmetic with a decimal operand raises naming them.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops.expr import DevVal, Expression

MAX_PRECISION = 38
_POW10 = [10 ** i for i in range(MAX_PRECISION + 1)]

_M32 = 0xFFFFFFFF
_TOP64 = -0x8000000000000000


def sum_result_type(a: T.DecimalType) -> T.DecimalType:
    """Spark's sum(decimal(p, s)): decimal(min(38, p + 10), s)."""
    return T.DecimalType(min(a.precision + 10, MAX_PRECISION), a.scale)


# ---------------------------------------------------------------------------
# 128-bit (hi int64, lo uint64 bits in int64) helpers
# ---------------------------------------------------------------------------

def _ult(a: torch.Tensor, b) -> torch.Tensor:
    """a < b with both read as unsigned 64-bit."""
    return (a ^ _TOP64) < (b ^ _TOP64)


def i128_neg(hi: torch.Tensor, lo: torch.Tensor):
    nlo = ~lo + 1
    nhi = ~hi + (nlo == 0).to(torch.int64)
    return nhi, nlo


def i128_abs(hi: torch.Tensor, lo: torch.Tensor):
    """(|hi|, |lo|, negative): the magnitude's limbs, both unsigned."""
    neg = hi < 0
    nhi, nlo = i128_neg(hi, lo)
    return torch.where(neg, nhi, hi), torch.where(neg, nlo, lo), neg


def i128_abs_fits_pow10(hi: torch.Tensor, lo: torch.Tensor,
                        p: int) -> torch.Tensor:
    """|value| < 10^p, the CheckOverflow bound (p <= 38)."""
    bound = _POW10[p]
    bhi = bound >> 64
    blo = bound & ((1 << 64) - 1)
    blo = blo - (1 << 64) if blo >= (1 << 63) else blo
    ahi, alo, _ = i128_abs(hi, lo)
    return _ult(ahi, bhi) | ((ahi == bhi) & _ult(alo, blo))


def u64_to_f64(x: torch.Tensor) -> torch.Tensor:
    """An unsigned 64-bit value (int64 bits) as the nearest double: its
    high word times 2^32 is exact, so the one addition rounds once."""
    hi = ((x >> 32) & _M32).to(torch.float64)
    return hi * float(2 ** 32) + (x & _M32).to(torch.float64)


def i128_to_f64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """A 128-bit value as a double, by sign and magnitude (hi * 2^64 + lo
    directly would cancel for small negatives): the reference's
    ``_dec_wide_to_f64``."""
    ahi, alo, neg = i128_abs(hi, lo)
    mag = ahi.to(torch.float64) * float(2.0 ** 64) + u64_to_f64(alo)
    return torch.where(neg, -mag, mag)


def limb_words(data: torch.Tensor):
    """Four 32-bit words of decimal storage, value = w0 + w1 2^32 +
    w2 2^64 + w3 2^96 with w0..w2 in [0, 2^32) and w3 signed; DECIMAL64
    storage sign-extends into the high limb."""
    if data.ndim == 2:
        hi, lo = data[:, 0], data[:, 1]
    else:
        lo = data.to(torch.int64)
        hi = lo >> 63
    return [lo & _M32, (lo >> 32) & _M32, hi & _M32, hi >> 32]


def carry_words(s0, s1, s2, s3):
    """Word sums (int64, exact below 2^31 rows) carried back to 128-bit
    limbs. Returns (hi, lo, t3); t3 is the true sum's bits from 96 up, so
    a t3 outside int32 is a 128-bit overflow."""
    r0, c = s0 & _M32, s0 >> 32
    t1 = s1 + c
    r1, c = t1 & _M32, t1 >> 32
    t2 = s2 + c
    r2, c = t2 & _M32, t2 >> 32
    t3 = s3 + c
    return (t3 << 32) | r2, (r1 << 32) | r0, t3


# ---------------------------------------------------------------------------
# DECIMAL64 rescale (backs CheckOverflow and the decimal -> decimal Cast)
# ---------------------------------------------------------------------------

def _in_bound(v: torch.Tensor, bound: int) -> torch.Tensor:
    """|v| < bound for int64 ``v`` and 0 < bound <= 10^18 (no abs, which
    would wrap at INT64_MIN)."""
    return (v < bound) & (v > -bound)


def dev_rescale_checked(data: torch.Tensor, validity: torch.Tensor,
                        from_scale: int, to_scale: int,
                        precision: int) -> DevVal:
    """DECIMAL64 -> DECIMAL64 rescale with HALF_UP on a scale-down; null
    where the result needs more than ``precision`` digits. |to_scale -
    from_scale| <= 18 and precision <= 18."""
    d = to_scale - from_scale
    v = data.to(torch.int64)
    if d >= 0:
        ok = _in_bound(v, _POW10[precision - d]) if d <= precision else \
            v == 0
        out = v * _POW10[d]
    else:
        m = _POW10[-d]
        q = torch.div(v, m, rounding_mode="trunc")
        r = v - q * m
        up = 2 * r.abs() >= m
        out = q + torch.where(up, torch.where(v < 0, -1, 1), 0)
        ok = _in_bound(out, _POW10[precision])
    valid = validity & ok
    return DevVal(torch.where(valid, out, torch.zeros_like(out)), valid)


def _dec64(dt: T.DataType, what: str) -> None:
    if T.is_dec128(dt):
        raise NotImplementedError(f"{what} of {dt.simple_string()} "
                                  "(DECIMAL128) is not ported")


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

class UnscaledValue(Expression):
    """decimal -> its raw unscaled long (GpuUnscaledValue)."""

    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def data_type(self):
        return T.LONG

    def with_children(self, children):
        return UnscaledValue(children[0])

    def resolve(self, bound):
        _dec64(bound[0].data_type, "UnscaledValue")
        return UnscaledValue(bound[0])

    def eval_dev(self, ctx, child_vals, prep):
        (c,) = child_vals
        return DevVal(c.data, c.validity)


class MakeDecimal(Expression):
    """long unscaled -> decimal(p, s) (GpuMakeDecimal); null where the
    value needs more than p digits."""

    def __init__(self, child: Expression, precision: int, scale: int):
        self.children = (child,)
        self._dtype = T.DecimalType(precision, scale)

    @property
    def data_type(self):
        return self._dtype

    def with_children(self, children):
        return MakeDecimal(children[0], self._dtype.precision,
                           self._dtype.scale)

    def resolve(self, bound):
        _dec64(self._dtype, "MakeDecimal")
        return self.with_children(bound)

    def eval_dev(self, ctx, child_vals, prep):
        (c,) = child_vals
        v = c.data.to(torch.int64)
        validity = c.validity & _in_bound(v, _POW10[self._dtype.precision])
        return DevVal(torch.where(validity, v, torch.zeros_like(v)),
                      validity)


class CheckOverflow(Expression):
    """Narrow a decimal to a target type, null on overflow (non-ANSI)."""

    def __init__(self, child: Expression, dtype: T.DecimalType):
        self.children = (child,)
        self._dtype = dtype

    @property
    def data_type(self):
        return self._dtype

    def with_children(self, children):
        return CheckOverflow(children[0], self._dtype)

    def resolve(self, bound):
        src = bound[0].data_type
        _dec64(src, "CheckOverflow")
        _dec64(self._dtype, "CheckOverflow")
        if abs(src.scale - self._dtype.scale) > 18:
            raise NotImplementedError(
                f"CheckOverflow from {src.simple_string()} to "
                f"{self._dtype.simple_string()} (a rescale by more than 18 "
                "digits) is not ported")
        return CheckOverflow(bound[0], self._dtype)

    def eval_dev(self, ctx, child_vals, prep):
        (c,) = child_vals
        src = self.children[0].data_type
        return dev_rescale_checked(c.data, c.validity, src.scale,
                                   self._dtype.scale, self._dtype.precision)


#: the reference's decimal binary operators, none of them ported
UNPORTED_BINARY = {"Add": "DecimalAdd", "Subtract": "DecimalSubtract",
                   "Multiply": "DecimalMultiply", "Divide": "DecimalDivide",
                   "Remainder": "DecimalRemainder", "Pmod": "DecimalPmod"}


def decimal_binary(op_name: str, left: T.DataType, right: T.DataType):
    """Raise for arithmetic between decimals (or a decimal and an
    integral type), naming the reference's operator."""
    name = UNPORTED_BINARY.get(op_name, f"Decimal{op_name}")
    raise NotImplementedError(
        f"{name} ({left.simple_string()}, {right.simple_string()}) is not "
        "ported to spark_rapids_tpu_torch yet")
