"""Decimal arithmetic with Spark semantics (port of
``spark_rapids_tpu/ops/decimal.py``: the result-type rules, the 128-bit
helpers, the UnscaledValue, MakeDecimal and CheckOverflow expressions and
the decimal binary operators DecimalAdd, DecimalSubtract,
DecimalMultiply, DecimalDivide, DecimalRemainder and DecimalPmod).

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

Every binary operator computes the reference's exact result: its
``_host_op`` (Python ints) plus the overflow check (null where |v| >=
10^p), which its device forms (``eval_dev``) equal wherever they run.
Where every intermediate fits int64 (DECIMAL64 operands whose rescaled
values and result stay below 10^18), one int64 form does it; otherwise
the value runs as a sign and a magnitude in base-2^16 digits (a
``(k, n)`` int64 tensor, digit-major): products of two digits stay below
2^32, so no torch int64 product overflows, and the magnitude is exact at
any width a decimal(38) product needs (up to 256 bits) before the
HALF_UP division by 10^down that Spark's ``_adjust`` asks for and the
check against 10^p.
DecimalDivide, DecimalRemainder and DecimalPmod over a DECIMAL128
operand or result (or, for the last two, an operand rescaled past 18
digits) run in one launch of the DECIMAL128 division kernel
(``kernels/decimal.py``, ``csrc/dec128div.cu``): a Divide's numerator
|l| x 10^up reaches 10^82 < 2^273 over a divisor below 10^38; a
Remainder's rescaled operands reach 10^76 < 2^253.

DecimalDivide follows the reference's device form, which rounds the
magnitude (HALF_UP away from zero); the reference's host form
``_round_half_up_div`` mis-rounds a quotient with a negative divisor
(7 / -2 gives -3 there; -4 here and on its device), and it computes every
DECIMAL128 quotient.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.ops.expr import DevVal, Expression

MAX_PRECISION = 38
_POW10 = [10 ** i for i in range(MAX_PRECISION + 1)]

_M32 = 0xFFFFFFFF
_TOP64 = -0x8000000000000000


def sum_result_type(a: T.DecimalType) -> T.DecimalType:
    """Spark's sum(decimal(p, s)): decimal(min(38, p + 10), s)."""
    return T.DecimalType(min(a.precision + 10, MAX_PRECISION), a.scale)


# ---------------------------------------------------------------------------
# result-type rules (Spark DecimalPrecision + adjustPrecisionScale)
# ---------------------------------------------------------------------------

def _adjust(p: int, s: int) -> Tuple[int, int]:
    """Spark adjustPrecisionScale (allowPrecisionLoss=true default)."""
    if p <= MAX_PRECISION:
        return p, s
    int_digits = p - s
    min_scale = min(s, 6)
    adjusted_scale = max(MAX_PRECISION - int_digits, min_scale)
    return MAX_PRECISION, adjusted_scale


def add_result_type(a: T.DecimalType, b: T.DecimalType) -> T.DecimalType:
    s = max(a.scale, b.scale)
    p = max(a.precision - a.scale, b.precision - b.scale) + s + 1
    return T.DecimalType(*_adjust(p, s))


def mul_result_type(a: T.DecimalType, b: T.DecimalType) -> T.DecimalType:
    return T.DecimalType(*_adjust(a.precision + b.precision + 1,
                                  a.scale + b.scale))


def div_result_type(a: T.DecimalType, b: T.DecimalType) -> T.DecimalType:
    s = max(6, a.scale + b.precision + 1)
    p = a.precision - a.scale + b.scale + s
    return T.DecimalType(*_adjust(p, s))


def rem_result_type(a: T.DecimalType, b: T.DecimalType) -> T.DecimalType:
    """Remainder and pmod: s = max(s1, s2), p = min(p1 - s1, p2 - s2) + s."""
    s = max(a.scale, b.scale)
    p = min(a.precision - a.scale, b.precision - b.scale) + s
    return T.DecimalType(*_adjust(max(p, 1), s))


def decimal_for(dt: T.DataType) -> Optional[T.DecimalType]:
    """Implicit integral -> decimal promotion used by Spark's coercion."""
    if isinstance(dt, T.DecimalType):
        return dt
    if isinstance(dt, T.ByteType):
        return T.DecimalType(3, 0)
    if isinstance(dt, T.ShortType):
        return T.DecimalType(5, 0)
    if isinstance(dt, T.IntegerType):
        return T.DecimalType(10, 0)
    if isinstance(dt, T.LongType):
        return T.DecimalType(20, 0)
    return None


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

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        data = np.asarray([int(v) for v in host_unscaled(c)],
                          dtype=np.int64)
        return HostColumn(T.LONG, data, c.validity.copy())


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

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        bound = _POW10[self._dtype.precision]
        validity = c.validity & (np.abs(c.data) < bound)
        return HostColumn(self._dtype,
                          np.where(validity, c.data, 0).astype(np.int64),
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

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        src: T.DecimalType = self.children[0].data_type
        validity = c.validity.copy()
        bound = _POW10[self._dtype.precision]
        out = [0] * len(c.data)
        vals = host_unscaled(c)
        for i in range(len(out)):
            if validity[i]:
                v = rescale_int(int(vals[i]), src.scale, self._dtype.scale)
                if abs(v) >= bound:
                    validity[i] = False
                else:
                    out[i] = v
        return host_store(out, validity, self._dtype)


# ---------------------------------------------------------------------------
# sign and magnitude in base-2^16 digits: exact at any width
# ---------------------------------------------------------------------------

_DBITS = 16
_DMASK = (1 << _DBITS) - 1


def _const_digits(v: int) -> List[int]:
    """A non-negative Python int's base-2^16 digits, least significant
    first (at least one)."""
    out = []
    while True:
        out.append(v & _DMASK)
        v >>= _DBITS
        if not v:
            return out


def sign_magnitude(data: torch.Tensor):
    """(negative, digits) of decimal storage: DECIMAL64 (|v| < 10^18) as 4
    digits, a DECIMAL128 limb pair as 8; ``digits`` is a (k, n) int64
    tensor of base-2^16 digits, least significant first (digit-major, so
    each digit's row is contiguous)."""
    if data.ndim == 2:
        ahi, alo, neg = i128_abs(data[:, 0], data[:, 1])
        words = torch.stack([alo, ahi])
    else:
        v = data.to(torch.int64)
        neg = v < 0
        words = torch.where(neg, -v, v)[None]
    shifts = torch.arange(0, 64, _DBITS, dtype=torch.int64,
                          device=data.device)
    digits = (words[:, None, :] >> shifts[None, :, None]) & _DMASK
    return neg, digits.reshape(-1, data.shape[0])


def _carry(cols: torch.Tensor) -> torch.Tensor:
    """Non-negative digit sums (k, n), each below 2^62, carried into
    digits in place; the top row's carry must be 0 (callers size the
    rows)."""
    carry = torch.zeros_like(cols[0])
    for j in range(cols.shape[0]):
        t = cols[j] + carry
        carry = t >> _DBITS
        torch.bitwise_and(t, _DMASK, out=cols[j])
    return cols


def _pad(a: torch.Tensor, k: int) -> torch.Tensor:
    if a.shape[0] >= k:
        return a
    return torch.cat([a, a.new_zeros((k - a.shape[0], a.shape[1]))])


def digits_mul(a: torch.Tensor, b) -> torch.Tensor:
    """Product of magnitudes ``a`` (ka, n) and ``b`` ((kb, n) digits, or a
    non-negative Python int, whose digits stay on the host): (ka + kb, n)
    digits. Each digit product is below 2^32 and each row sums at most 16
    of them."""
    if isinstance(b, int):
        cd = _const_digits(b)
        cols = a.new_zeros((a.shape[0] + len(cd), a.shape[1]))
        for i, d in enumerate(cd):
            if d:
                cols[i:i + a.shape[0]] += a * d
        return _carry(cols)
    if a.shape[0] < b.shape[0]:
        a, b = b, a
    ka, kb = a.shape[0], b.shape[0]
    cols = a.new_zeros((ka + kb, a.shape[1]))
    for i in range(kb):
        cols[i:i + ka] += a * b[i]
    return _carry(cols)


def _digits_add_const(a: torch.Tensor, c: int) -> torch.Tensor:
    cd = _const_digits(c)
    cols = _pad(a, max(a.shape[0], len(cd)) + 1).clone()
    for j, d in enumerate(cd):
        if d:
            cols[j] += d
    return _carry(cols)


def _digits_div_small(a: torch.Tensor, d: int) -> torch.Tensor:
    """floor(a / d) for 0 < d < 2^31, by long division from the top digit
    (each step's dividend stays below 2^47)."""
    rem = torch.zeros_like(a[0])
    q = torch.empty_like(a)
    for j in range(a.shape[0] - 1, -1, -1):
        acc = (rem << _DBITS) | a[j]
        torch.div(acc, d, rounding_mode="floor", out=q[j])
        rem = acc - q[j] * d
    return q


def digits_div_pow10_half_up(a: torch.Tensor, down: int) -> torch.Tensor:
    """HALF_UP(a / 10^down) of a magnitude: floor((a + 10^down / 2) /
    10^down), the floor division in steps of at most 10^9."""
    if down <= 0:
        return a
    a = _digits_add_const(a, 5 * _POW10[down - 1])
    while down > 0:
        step = min(down, 9)
        a = _digits_div_small(a, _POW10[step])
        down -= step
    return a


def digits_rescale(a: torch.Tensor, d: int) -> torch.Tensor:
    """A magnitude moved by ``d`` decimal places: times 10^d, or HALF_UP
    over 10^-d (the reference's ``rescale_int`` on |v|)."""
    if d > 0:
        return digits_mul(a, _POW10[d])
    return digits_div_pow10_half_up(a, -d)


def _digits_cmp(a: torch.Tensor, b):
    """(a < b, a == b) of two magnitudes with as many digits; ``b`` may be
    a list of Python ints (a constant's digits)."""
    lt = torch.zeros_like(a[0], dtype=torch.bool)
    eq = torch.ones_like(lt)
    for j in range(a.shape[0] - 1, -1, -1):
        lt = lt | (eq & (a[j] < b[j]))
        eq = eq & (a[j] == b[j])
    return lt, eq


def digits_lt_pow10(a: torch.Tensor, p: int) -> torch.Tensor:
    """magnitude < 10^p."""
    cd = _const_digits(_POW10[p])
    if len(cd) > a.shape[0]:
        return torch.ones_like(a[0], dtype=torch.bool)
    return _digits_cmp(a, cd + [0] * (a.shape[0] - len(cd)))[0]


def signed_add(na, a, nb, b):
    """(negative, magnitude) of (-1)^na a + (-1)^nb b: one sum where the
    signs agree, else the larger magnitude less the smaller, with its
    sign (a zero result is positive)."""
    k = max(a.shape[0], b.shape[0]) + 1
    a, b = _pad(a, k), _pad(b, k)
    total = _carry(a + b)
    a_lt, _ = _digits_cmp(a, b)
    big = torch.where(a_lt, b, a)
    diff = torch.where(a_lt, a, b)
    borrow = torch.zeros_like(a[0])
    for j in range(k):
        t = big[j] - diff[j] - borrow
        borrow = (t < 0).to(torch.int64)
        torch.add(t, borrow << _DBITS, out=diff[j])
    same = na == nb
    mag = torch.where(same, total, diff)
    neg = torch.where(same, na, torch.where(a_lt, nb, na))
    return neg & (mag != 0).any(dim=0), mag


def digits_to_i128(neg: torch.Tensor, a: torch.Tensor):
    """The signed (hi, lo) limbs of a magnitude below 2^127 (its low 8
    digits)."""
    a = _pad(a, 8)
    lo = a[0] | (a[1] << 16) | (a[2] << 32) | (a[3] << 48)
    hi = a[4] | (a[5] << 16) | (a[6] << 32) | (a[7] << 48)
    nhi, nlo = i128_neg(hi, lo)
    return torch.where(neg, nhi, hi), torch.where(neg, nlo, lo)


def store_decimal(neg: torch.Tensor, mag: torch.Tensor,
                  validity: torch.Tensor, dtype: T.DecimalType) -> DevVal:
    """A sign and magnitude as ``dtype``'s storage, null where |v| >= 10^p
    (the reference's CheckOverflow, non-ANSI)."""
    valid = validity & digits_lt_pow10(mag, dtype.precision)
    hi, lo = digits_to_i128(neg, mag)
    zero = torch.zeros_like(lo)
    lo = torch.where(valid, lo, zero)
    if T.is_dec128(dtype):
        return DevVal(torch.stack([torch.where(valid, hi, zero), lo], dim=1),
                      valid)
    return DevVal(lo, valid)


def as_storage(v: torch.Tensor, validity: torch.Tensor,
               dtype: T.DecimalType) -> DevVal:
    """int64 values known to fit ``dtype`` as its storage."""
    v = torch.where(validity, v, torch.zeros_like(v))
    if T.is_dec128(dtype):
        return DevVal(torch.stack([v >> 63, v], dim=1), validity)
    return DevVal(v, validity)


# ---------------------------------------------------------------------------
# the decimal binary operators
# ---------------------------------------------------------------------------

class DecimalBinary(Expression):
    """Base: both operands are decimals (the arithmetic's coercion casts
    an integral operand through ``decimal_for`` first)."""

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    @property
    def data_type(self) -> T.DecimalType:
        return self._result_type(self.left.data_type,
                                 self.right.data_type)

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def _result_type(self, a, b) -> T.DecimalType:
        raise NotImplementedError

    def _host_op(self, lv: int, rv: int):
        """Exact unscaled result at the RESULT scale, or None (null)."""
        raise NotImplementedError

    def eval_cpu(self, table: HostTable) -> HostColumn:
        l = self.left.eval_cpu(table)
        r = self.right.eval_cpu(table)
        validity = (l.validity & r.validity).copy()
        ld = host_unscaled(l)
        rd = host_unscaled(r)
        bound = _POW10[self.data_type.precision]
        out = [0] * len(ld)
        for i in range(len(ld)):
            if not validity[i]:
                continue
            v = self._host_op(int(ld[i]), int(rd[i]))
            if v is None or abs(v) >= bound:
                validity[i] = False  # CheckOverflow: null (non-ANSI)
            else:
                out[i] = v
        return host_store(out, validity, self.data_type)


def _fits_i64_digits(*ps: int) -> bool:
    return all(p <= T.DecimalType.MAX_LONG_DIGITS for p in ps)


class DecimalAdd(DecimalBinary):
    """Both operands rescaled (HALF_UP where ``_adjust`` cut the scale)
    to the result scale, then added; null where |v| >= 10^p."""

    _sign = 1

    def _host_op(self, lv, rv):
        s = self.data_type.scale
        return rescale_int(lv, self.left.data_type.scale, s) + \
            self._sign * rescale_int(rv, self.right.data_type.scale, s)

    def _result_type(self, a, b):
        return add_result_type(a, b)

    def eval_dev(self, ctx, child_vals, prep):
        lt, rt, out = self.left.data_type, self.right.data_type, \
            self.data_type
        s = out.scale
        validity = child_vals[0].validity & child_vals[1].validity
        dl, dr = s - lt.scale, s - rt.scale
        if dl >= 0 and dr >= 0 and _fits_i64_digits(
                lt.precision - lt.scale + s, rt.precision - rt.scale + s):
            # each rescaled operand stays below 10^18: one int64 sum
            a = child_vals[0].data * _POW10[dl]
            b = child_vals[1].data * _POW10[dr]
            v = a + b if self._sign > 0 else a - b
            if out.precision <= T.DecimalType.MAX_LONG_DIGITS:
                validity = validity & _in_bound(v, _POW10[out.precision])
            return as_storage(v, validity, out)
        na, a = sign_magnitude(child_vals[0].data)
        nb, b = sign_magnitude(child_vals[1].data)
        if self._sign < 0:
            nb = ~nb
        neg, mag = signed_add(na, digits_rescale(a, dl),
                              nb, digits_rescale(b, dr))
        return store_decimal(neg, mag, validity, out)


class DecimalSubtract(DecimalAdd):
    _sign = -1


class DecimalMultiply(DecimalBinary):
    """The exact product at scale s1 + s2, HALF_UP down to the result
    scale; null where |v| >= 10^p."""

    def _host_op(self, lv, rv):
        return rescale_int(lv * rv, self.left.data_type.scale
                           + self.right.data_type.scale,
                           self.data_type.scale)

    def _result_type(self, a, b):
        return mul_result_type(a, b)

    def eval_dev(self, ctx, child_vals, prep):
        lt, rt, out = self.left.data_type, self.right.data_type, \
            self.data_type
        validity = child_vals[0].validity & child_vals[1].validity
        raw_scale = lt.scale + rt.scale
        if _fits_i64_digits(lt.precision + rt.precision, out.precision):
            # the raw product stays below 10^18: int64, then one rescale
            raw = child_vals[0].data * child_vals[1].data
            return dev_rescale_checked(raw, validity, raw_scale, out.scale,
                                       out.precision)
        na, a = sign_magnitude(child_vals[0].data)
        nb, b = sign_magnitude(child_vals[1].data)
        mag = digits_div_pow10_half_up(digits_mul(a, b),
                                       raw_scale - out.scale)
        return store_decimal(na ^ nb, mag, validity, out)


def _hi_lo(data: torch.Tensor):
    """Contiguous (hi, lo) int64 streams of decimal storage: a
    DECIMAL128's limbs, or a DECIMAL64 value with its sign as hi."""
    if data.ndim == 2:
        return data[:, 0].contiguous(), data[:, 1].contiguous()
    v = data.to(torch.int64).contiguous()
    return v >> 63, v


def _wide_divide(mode: str, child_vals, pow_a: int, pow_b: int,
                 out: T.DecimalType) -> DevVal:
    """One launch of the DECIMAL128 division kernel over both operands,
    stored as ``out``."""
    from spark_rapids_tpu_torch.kernels.decimal import dec128_divide
    valid = (child_vals[0].validity & child_vals[1].validity).contiguous()
    hi, lo, ok = dec128_divide(mode, *_hi_lo(child_vals[0].data),
                               *_hi_lo(child_vals[1].data), valid, pow_a,
                               pow_b, out.precision)
    if T.is_dec128(out):
        return DevVal(torch.stack([hi, lo], dim=1), ok)
    return DevVal(lo, ok)


class DecimalDivide(DecimalBinary):
    """The reference's device form: the numerator |l| x 10^up over |r|,
    HALF_UP, with the sign of l / r; null on a zero divisor and where
    |q| >= 10^p. Where the operands and the result are DECIMAL64 and
    p = p1 + up <= 18, the numerator fits int64 and one int64 form does
    it; otherwise the DECIMAL128 division kernel. Spark's result type
    keeps up >= 0."""

    def _host_op(self, lv, rv):
        if rv == 0:
            return None  # Spark: null on division by zero (non-ANSI)
        up = (self.data_type.scale + self.right.data_type.scale
              - self.left.data_type.scale)
        if up < 0:
            return _round_half_up_div(lv, rv * _POW10[-up])
        return _round_half_up_div(lv * _POW10[up], rv)

    def _result_type(self, a, b):
        return div_result_type(a, b)

    def _up(self) -> int:
        return self.data_type.scale + self.right.data_type.scale - \
            self.left.data_type.scale

    def _narrow(self) -> bool:
        return not (T.is_dec128(self.left.data_type) or T.is_dec128(
            self.right.data_type) or T.is_dec128(self.data_type)) and \
            self.left.data_type.precision + self._up() <= \
            T.DecimalType.MAX_LONG_DIGITS

    def eval_dev(self, ctx, child_vals, prep):
        if not self._narrow():
            return _wide_divide("divide", child_vals, 10 ** self._up(), 1,
                                self.data_type)
        lv, rv = child_vals[0].data, child_vals[1].data
        zero_div = rv == 0
        divisor = torch.where(zero_div, torch.ones_like(rv), rv)
        num = lv * _POW10[self._up()]
        nmag, dmag = num.abs(), divisor.abs()
        q = torch.div(nmag, dmag, rounding_mode="floor")
        r = nmag - q * dmag
        q = q + (2 * r >= dmag).to(torch.int64)
        data = torch.where((num < 0) ^ (divisor < 0), -q, q)
        validity = child_vals[0].validity & child_vals[1].validity & \
            ~zero_div & _in_bound(data, _POW10[self.data_type.precision])
        return DevVal(torch.where(validity, data, torch.zeros_like(data)),
                      validity)


class DecimalRemainder(DecimalBinary):
    """Java % over decimals at the common scale s = max(s1, s2): the sign
    of the dividend; null on a zero divisor. Where both operands rescaled
    to s stay within 18 digits, int64 (the reference's device form);
    otherwise the DECIMAL128 division kernel."""

    _java_sign = True
    _mode = "remainder"

    def _result_type(self, a, b):
        return rem_result_type(a, b)

    def eval_dev(self, ctx, child_vals, prep):
        lt, rt = self.left.data_type, self.right.data_type
        s = self.data_type.scale
        if T.is_dec128(lt) or T.is_dec128(rt) or not _fits_i64_digits(
                lt.precision - lt.scale + s, rt.precision - rt.scale + s):
            return _wide_divide(self._mode, child_vals,
                                _POW10[s - lt.scale], _POW10[s - rt.scale],
                                self.data_type)
        a = child_vals[0].data * _POW10[s - lt.scale]
        b = child_vals[1].data * _POW10[s - rt.scale]
        zero = b == 0
        safe = torch.where(zero, torch.ones_like(b), b)

        def jmod(x, y):
            r = torch.remainder(x.abs(), y.abs())
            return torch.where(x < 0, -r, r)

        data = jmod(a, safe)
        if not self._java_sign:
            # Spark pmod: ((a % b) + b) % b with Java %
            data = jmod(data + safe, safe)
        validity = child_vals[0].validity & child_vals[1].validity & ~zero
        return DevVal(torch.where(validity, data, torch.zeros_like(data)),
                      validity)

    def _host_op(self, lv, rv):
        s = self.data_type.scale
        a = rescale_int(lv, self.left.data_type.scale, s)
        b = rescale_int(rv, self.right.data_type.scale, s)
        if b == 0:
            return None
        r = abs(a) % abs(b)
        r = -r if a < 0 else r
        if not self._java_sign:
            r += b
            r = (abs(r) % abs(b)) * (-1 if r < 0 else 1)
        return r


class DecimalPmod(DecimalRemainder):
    """pmod: ((a % b) + b) % b with Java %."""

    _java_sign = False
    _mode = "pmod"


# ---------------------------------------------------------------------------
# host evaluation helpers (the CPU route)
# ---------------------------------------------------------------------------


def host_unscaled(col: HostColumn):
    """Column unscaled values as a Python-int object array."""
    if col.data.dtype == object:
        return col.data
    return col.data.astype(object)


def host_store(values, validity, dtype: T.DecimalType) -> HostColumn:
    """Pack python-int unscaled values into the storage layout for
    ``dtype`` (int64 when p<=18, object otherwise); overflowed slots must
    already be nulled."""
    n = len(values)
    if dtype.precision <= T.DecimalType.MAX_LONG_DIGITS:
        out = np.zeros(n, dtype=np.int64)
        for i in range(n):
            if validity[i]:
                out[i] = values[i]
        return HostColumn(dtype, out, validity)
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = int(values[i]) if validity[i] else 0
    return HostColumn(dtype, out, validity)


def _round_half_up_div(v: int, d: int) -> int:
    """v / d with HALF_UP rounding (Java BigDecimal's default in Spark):
    the magnitude rounds half away from zero, the sign is the
    quotient's."""
    q, r = divmod(abs(v), abs(d))
    if 2 * r >= abs(d):
        q += 1
    return -q if (v < 0) != (d < 0) else q


def rescale_int(v: int, from_scale: int, to_scale: int) -> int:
    if to_scale >= from_scale:
        return v * _POW10[to_scale - from_scale]
    return _round_half_up_div(v, _POW10[from_scale - to_scale])
