"""DECIMAL128 division (``csrc/dec128div.cu``): the quotient, remainder and
positive modulus of two decimal columns, one CUDA thread a row. This is
CUDA work beyond the five TPU kernels: the reference computes these
results on its host with Python ints (``spark_rapids_tpu/ops/decimal.py``
``DecimalDivide._host_op`` and ``DecimalRemainder._host_op``), and the
port has no host route.

``dec128_divide(mode, a_hi, a_lo, b_hi, b_lo, valid, pow_a, pow_b, p)``:
with A = |a| x pow_a and B = |b| x pow_b (the operands' signed 128-bit
values as contiguous hi and lo int64 streams; a DECIMAL64 passes its sign
as hi), ``divide`` gives floor(A / B) rounded HALF_UP on the magnitude,
with the sign of a / b; ``remainder`` A mod B with a's sign (Java's %);
``pmod`` ((a % b) + b) % b. A zero divisor, or a result whose magnitude is
at least 10^p, is invalid. The powers are Python ints, passed to the
kernel as words of its arguments (an upload would be a host sync).

The plain version computes the same function over the digit-major
base-2^16 digit tensors of ``ops/decimal.py``: a bit-serial restoring
division, exact, written for clarity and for CPU test sizes. No PyTorch
call computes this function (torch has no 128-bit integer).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from spark_rapids_tpu_torch.kernels import (
    check_launch,
    kernel_launch,
    record,
    require_contiguous,
    require_cuda,
    stream_handle,
)

MODES = {"divide": 0, "remainder": 1, "pmod": 2}
#: the largest power of ten each operand may be scaled by: a Divide's
#: numerator by 10^44 (decimal(38,0) / decimal(38,38)), a Remainder's
#: operands by 10^38
MAX_POW = {"divide": (10 ** 44, 1), "remainder": (10 ** 38, 10 ** 38),
           "pmod": (10 ** 38, 10 ** 38)}

_M64 = (1 << 64) - 1
_P, _I64, _I, _U64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_uint64)
_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from spark_rapids_tpu_torch.kernels.build import load_library
        lib = load_library("dec128div")
        fn = lib.srt_dec128_divide
        fn.restype = ctypes.c_int
        fn.argtypes = [_P] * 8 + [_I64, _I] + [_U64] * 8 + [_P]
        _LIB = lib
    return _LIB


def _words(v: int, n: int):
    return [(v >> (64 * i)) & _M64 for i in range(n)]


def _check_args(mode, streams, pow_a, pow_b, precision):
    if mode not in MODES:
        raise ValueError(f"dec128_divide: mode {mode!r}")
    n = streams[0].shape[0]
    for t in streams[:4]:
        if t.dtype != torch.int64 or t.ndim != 1 or t.shape[0] != n:
            raise TypeError("dec128_divide: operands must be (n,) int64")
    if streams[4].dtype != torch.bool or streams[4].shape != (n,):
        raise TypeError("dec128_divide: valid must be (n,) bool")
    top_a, top_b = MAX_POW[mode]
    if not (1 <= pow_a <= top_a and 1 <= pow_b <= top_b):
        raise ValueError(f"dec128_divide: powers {pow_a}, {pow_b} outside "
                         f"1..{top_a}, 1..{top_b}")
    if not 1 <= precision <= 38:
        raise ValueError(f"dec128_divide: precision {precision}")


def dec128_divide(mode: str, a_hi: torch.Tensor, a_lo: torch.Tensor,
                  b_hi: torch.Tensor, b_lo: torch.Tensor,
                  valid: torch.Tensor, pow_a: int, pow_b: int,
                  precision: int) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """(hi, lo, valid) of the result: see the module's docstring."""
    streams = (a_hi, a_lo, b_hi, b_lo, valid)
    _check_args(mode, streams, pow_a, pow_b, precision)
    if a_hi.device.type == "cpu":
        with kernel_launch("dec128_divide"):
            return dec128_divide_plain(mode, *streams, pow_a, pow_b,
                                       precision)
    require_cuda(a_hi, "dec128_divide")
    for t in streams:
        if t.device != a_hi.device:
            raise ValueError("dec128_divide: inputs on different devices")
        require_contiguous(t, "dec128_divide input")
    n = int(a_hi.shape[0])
    o_hi = torch.empty(n, dtype=torch.int64, device=a_hi.device)
    o_lo = torch.empty_like(o_hi)
    o_valid = torch.empty(n, dtype=torch.bool, device=a_hi.device)
    bound = 10 ** precision
    with kernel_launch("dec128_divide"):
        lib = _library()
        rc = lib.srt_dec128_divide(
            a_hi.data_ptr(), a_lo.data_ptr(), b_hi.data_ptr(), b_lo.data_ptr(),
            valid.data_ptr(), o_hi.data_ptr(), o_lo.data_ptr(),
            o_valid.data_ptr(), n, MODES[mode], *_words(pow_a, 3),
            *_words(pow_b, 3), bound >> 64, bound & _M64, stream_handle(a_hi))
        check_launch(lib, rc, "dec128_divide")
    dec128_divide.launches += 1
    record("dec128_divide", (mode, *streams, pow_a, pow_b, precision),
           (o_hi, o_lo, o_valid))
    return o_hi, o_lo, o_valid


dec128_divide.launches = 0


# ---------------------------------------------------------------------------
# the plain version: restoring division over base-2^16 digit tensors
# ---------------------------------------------------------------------------

def _shift_in(r: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    """2r + bit of a magnitude (k, n) whose top digit has room."""
    from spark_rapids_tpu_torch.ops.decimal import _DMASK
    out = (r << 1) & _DMASK
    out[1:] |= r[:-1] >> 15
    out[0] |= bit
    return out


def _geq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    from spark_rapids_tpu_torch.ops.decimal import _digits_cmp
    return ~_digits_cmp(a, b)[0]


def _sub_where(a: torch.Tensor, b: torch.Tensor,
               cond: torch.Tensor) -> torch.Tensor:
    """a - b (a >= b) where ``cond``, else a; digit by digit with a
    borrow."""
    out = a.clone()
    borrow = torch.zeros_like(a[0])
    for j in range(a.shape[0]):
        t = a[j] - b[j] - borrow
        borrow = (t < 0).to(torch.int64)
        out[j] = torch.where(cond, t + (borrow << 16), a[j])
    return out


def _add_one_where(a: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    from spark_rapids_tpu_torch.ops.decimal import _carry
    out = a.clone()
    out[0] += cond.to(torch.int64)
    return _carry(out)


def dec128_divide_plain(mode: str, a_hi, a_lo, b_hi, b_lo, valid,
                        pow_a: int, pow_b: int, precision: int):
    """The plain version of ``dec128_divide``: restoring division, one
    bit of the scaled dividend at a time from the top, over base-2^16
    digit tensors (digit-major)."""
    from spark_rapids_tpu_torch.ops.decimal import (
        _pad,
        digits_lt_pow10,
        digits_mul,
        digits_to_i128,
        sign_magnitude,
    )
    an, a = sign_magnitude(torch.stack([a_hi, a_lo], dim=1))
    bn, b = sign_magnitude(torch.stack([b_hi, b_lo], dim=1))
    num, den = digits_mul(a, pow_a), digits_mul(b, pow_b)
    k = den.shape[0] + 1  # the remainder stays below 2 x den
    den = _pad(den, k)
    rem = torch.zeros_like(den)
    quo = torch.zeros_like(num)
    for bit in range(16 * num.shape[0] - 1, -1, -1):
        rem = _shift_in(rem, (num[bit // 16] >> (bit % 16)) & 1)
        ge = _geq(rem, den)
        rem = _sub_where(rem, den, ge)
        quo[bit // 16] |= ge.to(torch.int64) << (bit % 16)
    ok = valid & (den != 0).any(dim=0)
    if mode == "divide":
        half_up = _geq(_shift_in(rem, torch.zeros_like(rem[0])), den)
        mag, neg = _add_one_where(quo, half_up), an ^ bn
    else:
        mag, neg = rem, an
        if mode == "pmod":
            flip = (rem != 0).any(dim=0) & (an != bn)
            mag = _sub_where(den, rem, flip)
            mag = torch.where(flip, mag, rem)
            neg = torch.where(flip, bn, an)
    ok = ok & digits_lt_pow10(mag, precision)
    neg = neg & (mag != 0).any(dim=0)
    hi, lo = digits_to_i128(neg, mag)
    zero = torch.zeros_like(lo)
    return torch.where(ok, hi, zero), torch.where(ok, lo, zero), ok
