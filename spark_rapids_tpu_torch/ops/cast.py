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

The pairs are those the reference's ``cast_supported`` admits, plus the
integral -> decimal and decimal -> decimal casts with a DECIMAL128 side or
a rescale past 18 digits, where the reference takes its exact host route
(the port computes them exactly in base-2^16 digits, ops/decimal.py),
and DECIMAL128 -> integral (the reference's host route; the same digits):
float/double -> decimal stays unported. A NULL
literal (``void``) casts to any type as an all-null column in that type's
storage (``T.promote`` coerces a NULL operand to the other operand's
type). A cast the device does not run but the reference's host does
(``host_cast_supported``: a string to or from a number, boolean, date or
decimal, a decimal to or from any number at any precision) runs on the
CPU route; any other pair raises NotImplementedError when it binds.

Under ``spark.sql.ansi.enabled`` a float or double that is NaN or out of
an integral target's range, a narrowing integral cast out of range and a
string that does not parse raise AnsiViolation instead (the device walk
records a flag; a string cast runs on the CPU route, which raises).
"""

from __future__ import annotations

import datetime
import math
import re

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.ops.expr import (
    DevVal,
    Expression,
    NodePrep,
)

_INT_BOUNDS = {
    np.dtype(np.int8): (-(1 << 7), (1 << 7) - 1),
    np.dtype(np.int16): (-(1 << 15), (1 << 15) - 1),
    np.dtype(np.int32): (-(1 << 31), (1 << 31) - 1),
    np.dtype(np.int64): (-(1 << 63), (1 << 63) - 1),
}

_MICROS_PER_DAY = 86_400_000_000

_WIDTH = {T.ByteType: 1, T.ShortType: 2, T.IntegerType: 4, T.LongType: 8}

_SIMPLE = (T.BooleanType, T.ByteType, T.ShortType, T.IntegerType,
           T.LongType, T.FloatType, T.DoubleType)


def cast_supported(src: T.DataType, dst: T.DataType) -> bool:
    """The numeric pairs of the reference's ``cast_supported``."""
    if src == dst or isinstance(src, T.NullType):
        return True
    if isinstance(src, T.DecimalType) or isinstance(dst, T.DecimalType):
        if isinstance(src, T.DecimalType) and isinstance(dst, T.DecimalType):
            return True
        if isinstance(dst, T.DecimalType):
            return isinstance(src, T.IntegralType)
        if isinstance(dst, (T.DoubleType, T.FloatType)):
            return True
        return isinstance(dst, T.IntegralType)
    if {type(src), type(dst)} == {T.DateType, T.TimestampType}:
        return True
    return isinstance(src, _SIMPLE) and isinstance(dst, _SIMPLE)


def host_cast_supported(src: T.DataType, dst: T.DataType) -> bool:
    """The pairs the CPU route casts (the reference's ``eval_cpu``): the
    device pairs, a string to or from a number, boolean, date or
    decimal, and a decimal to or from any number at any precision."""
    if cast_supported(src, dst):
        return True
    plain = _SIMPLE + (T.DateType, T.DecimalType)
    if isinstance(src, T.StringType):
        return isinstance(dst, plain)
    if isinstance(dst, T.StringType):
        return isinstance(src, plain)
    numbers = _SIMPLE[1:] + (T.DecimalType,)
    return (isinstance(src, T.DecimalType) or isinstance(dst, T.DecimalType)
            ) and isinstance(src, numbers) and isinstance(dst, numbers)


def check_cast(src: T.DataType, dst: T.DataType) -> None:
    if not host_cast_supported(src, dst):
        raise NotImplementedError(
            f"cast from {src.simple_string()} to {dst.simple_string()} is "
            "not ported (the port casts among the numeric types, boolean, "
            "strings and decimals, and between date and timestamp)")


def make_cast(child: Expression, dtype: T.DataType) -> Expression:
    """``child`` itself when it already has ``dtype``, else a checked
    Cast."""
    if child.data_type == dtype:
        return child
    return Cast(child, dtype).resolve([child])


def _is_widening(src: T.DataType, dst: T.DataType) -> bool:
    ws, wd = _WIDTH.get(type(src)), _WIDTH.get(type(dst))
    return ws is not None and wd is not None and wd >= ws


def _cast_simple(data: torch.Tensor, src: T.DataType,
                 dst: T.DataType) -> torch.Tensor:
    """The reference's ``_cast_data_jnp`` for the numeric and boolean
    types, and between DATE (days) and TIMESTAMP (micros: a timestamp's
    date is its floored day)."""
    dd = T.torch_dtype(dst)
    if isinstance(src, T.DateType) and isinstance(dst, T.TimestampType):
        return data.to(torch.int64) * _MICROS_PER_DAY
    if isinstance(src, T.TimestampType) and isinstance(dst, T.DateType):
        return torch.div(data, _MICROS_PER_DAY,
                         rounding_mode="floor").to(dd)
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
        digits_rescale,
        i128_to_f64,
        sign_magnitude,
        store_decimal,
    )
    if isinstance(dst, T.DecimalType):
        # integral -> decimal: a rescale from scale 0
        from_scale = src.scale if isinstance(src, T.DecimalType) else 0
        data = c.data if c.data.ndim == 2 else c.data.to(torch.int64)
        if T.is_dec128(src) or T.is_dec128(dst) or \
                abs(dst.scale - from_scale) > 18:
            # exact in base-2^16 digits (the reference's host route)
            neg, mag = sign_magnitude(data)
            return store_decimal(neg, digits_rescale(mag, dst.scale -
                                                     from_scale),
                                 c.validity, dst)
        return dev_rescale_checked(data, c.validity, from_scale, dst.scale,
                                   dst.precision)
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
    lo, hi = _INT_BOUNDS[np.dtype(dst.np_dtype)]
    if T.is_dec128(src):
        from spark_rapids_tpu_torch.ops.decimal import (
            _digits_div_small,
            digits_to_i128,
        )
        neg, mag = sign_magnitude(c.data)
        down = src.scale
        while down > 0:  # floor of the magnitude: truncation toward zero
            step = min(down, 9)
            mag = _digits_div_small(mag, _POW10[step])
            down -= step
        top, q = digits_to_i128(neg, mag)
        validity = c.validity & (top == q >> 63)
    else:
        q = torch.div(c.data, scale, rounding_mode="trunc")
        validity = c.validity
    validity = validity & (q >= lo) & (q <= hi)
    out = q.to(T.torch_dtype(dst))
    return DevVal(torch.where(validity, out, torch.zeros_like(out)),
                  validity)


def _ansi_bad(data, validity, src: T.DataType, dst: T.DataType, isnan):
    """The valid rows whose ANSI cast to the integral ``dst`` errors (a
    NaN or out-of-range float, a narrowing integral out of range), or
    None when no row of ``src`` can (the reference's bounds: a float is
    compared with the bounds as floats). Over torch or numpy arrays
    (``isnan`` of the library)."""
    info = np.iinfo(np.dtype(dst.np_dtype))
    if isinstance(src, (T.FloatType, T.DoubleType)):
        return validity & (isnan(data) | (data < float(info.min))
                           | (data > float(info.max)))
    if isinstance(src, T.IntegralType) and \
            np.dtype(dst.np_dtype).itemsize < np.dtype(src.np_dtype).itemsize:
        return validity & ((data < info.min) | (data > info.max))
    return None


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
        src = bound[0].data_type
        check_cast(src, self._dtype)
        return Cast(bound[0], self._dtype)

    @property
    def device_supported(self):
        # string casts run on the CPU route
        return cast_supported(self.children[0].data_type, self._dtype)

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
        if ctx.ansi and isinstance(dst, T.IntegralType):
            bad = _ansi_bad(c.data, c.validity, src, dst, torch.isnan)
            if bad is not None:
                ctx.ansi_check(f"cast overflow to {dst.simple_string()}",
                               bad)
        data = _cast_simple(c.data, src, dst)
        return DevVal(torch.where(c.validity, data, torch.zeros_like(data)),
                      c.validity)

    def __repr__(self):
        return f"cast({self.children[0]!r} as {self._dtype.simple_string()})"

    def eval_cpu(self, table: HostTable) -> HostColumn:
        c = self.children[0].eval_cpu(table)
        if c.dtype == self._dtype:
            return c
        if isinstance(c.dtype, T.DecimalType) or \
                isinstance(self._dtype, T.DecimalType):
            return _cpu_decimal_cast(c, self._dtype)
        from spark_rapids_tpu_torch.dispatch import ANSI_MODE
        from spark_rapids_tpu_torch.errors import AnsiViolation
        if isinstance(c.dtype, T.StringType):
            out = self._cpu_from_string(c)
            if ANSI_MODE.get() and (c.validity & ~out.validity).any():
                raise AnsiViolation(
                    f"invalid input for cast to "
                    f"{self._dtype.simple_string()} "
                    "(spark.sql.ansi.enabled)")
            return out
        if isinstance(self._dtype, T.StringType):
            return self._cpu_to_string(c)
        if ANSI_MODE.get() and isinstance(self._dtype, T.IntegralType):
            with np.errstate(invalid="ignore"):
                bad = _ansi_bad(c.data, c.validity, c.dtype, self._dtype,
                                np.isnan)
            if bad is not None and bad.any():
                raise AnsiViolation(
                    f"cast overflow to {self._dtype.simple_string()} "
                    "(spark.sql.ansi.enabled)")
        data = _cast_data_np(c.data, c.dtype, self._dtype)
        zero = np.zeros((), dtype=self._dtype.np_dtype).item()
        return HostColumn(self._dtype, np.where(c.validity, data, zero).astype(self._dtype.np_dtype),
                          c.validity.copy())

    def _cpu_from_string(self, c: HostColumn) -> HostColumn:
        n = len(c)
        out = np.zeros(n, dtype=self._dtype.np_dtype)
        validity = c.validity.copy()
        for i in range(n):
            if validity[i]:
                v = parse_string_cast(c.data[i], self._dtype)
                if v is None:
                    validity[i] = False
                else:
                    out[i] = v
        return HostColumn(self._dtype, out, validity)

    def _cpu_to_string(self, c: HostColumn) -> HostColumn:
        n = len(c)
        fast = _strings_at_once(c)
        if fast is not None:
            return HostColumn(T.STRING, fast, c.validity.copy())
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = (format_value_as_string(c.data[i], c.dtype)
                      if c.validity[i] else None)
        return HostColumn(T.STRING, out, c.validity.copy())


# ---------------------------------------------------------------------------
# host evaluation helpers (the CPU route)
# ---------------------------------------------------------------------------


def _cast_data_np(data: np.ndarray, src: T.DataType, dst: T.DataType) -> np.ndarray:
    sd, dd = src.np_dtype, dst.np_dtype
    if isinstance(dst, T.BooleanType):
        return data != 0
    if isinstance(src, T.BooleanType):
        return data.astype(dd)
    if isinstance(src, (T.FloatType, T.DoubleType)) and isinstance(dst, T.IntegralType):
        lo, hi = _INT_BOUNDS[np.dtype(dd)]
        with np.errstate(invalid="ignore"):
            t = np.trunc(data)
            t = np.where(np.isnan(data), 0.0, t)
            t = np.clip(t, float(lo), float(hi))
        # float64 cannot represent 2^63-1 exactly; rely on clip + cast with
        # saturation applied before conversion.
        out = np.empty(data.shape, dtype=dd)
        big = t >= float(hi)
        small = t <= float(lo)
        mid = ~(big | small)
        out[big] = hi
        out[small] = lo
        out[mid] = t[mid].astype(dd)
        return out
    if isinstance(src, T.DateType) and isinstance(dst, T.TimestampType):
        return data.astype(np.int64) * _MICROS_PER_DAY
    if isinstance(src, T.TimestampType) and isinstance(dst, T.DateType):
        return np.floor_divide(data, _MICROS_PER_DAY).astype(np.int32)
    with np.errstate(over="ignore", invalid="ignore"):
        return data.astype(dd)


_JAVA_WS = "".join(chr(i) for i in range(0x21))


_INT_RE = re.compile(r"([+-]?)(\d*)(?:\.(\d*))?")


_DATE_RE = re.compile(r"(\d{4,5})(?:-(\d{1,2})(?:-(\d{1,2})(?:[T ].*)?)?)?")


_TRUE_STRINGS = frozenset(("t", "true", "y", "yes", "1"))


_FALSE_STRINGS = frozenset(("f", "false", "n", "no", "0"))


_FLOAT_SPECIALS = {"inf": np.inf, "+inf": np.inf, "infinity": np.inf,
                   "+infinity": np.inf, "-inf": -np.inf,
                   "-infinity": -np.inf, "nan": np.nan}


def parse_string_cast(s: str, dst: T.DataType):
    """Spark-exact string -> value parse; None = cast yields null."""
    t = s.strip(_JAVA_WS)
    if isinstance(dst, T.IntegralType):
        m = _INT_RE.fullmatch(t)
        if not m or (not m.group(2) and not m.group(3)):
            return None  # needs at least one digit somewhere
        v = int(m.group(2) or "0")
        if m.group(1) == "-":
            v = -v
        lo, hi = _INT_BOUNDS[np.dtype(dst.np_dtype)]
        return v if lo <= v <= hi else None  # overflow -> null (toInt fails)
    if isinstance(dst, (T.FloatType, T.DoubleType)):
        low = t.lower()
        if low in _FLOAT_SPECIALS:
            v = _FLOAT_SPECIALS[low]
        else:
            body = t
            # Java parseDouble accepts a trailing f/F/d/D suffix
            if body and body[-1] in "fFdD" and any(c.isdigit() for c in body[:-1]):
                body = body[:-1]
            if not body or "_" in body or body.lower() in ("", "+", "-"):
                return None
            try:
                v = float(body)
            except ValueError:
                return None
        if isinstance(dst, T.FloatType):
            v = float(np.float32(v))
        return v
    if isinstance(dst, T.BooleanType):
        low = t.lower()
        if low in _TRUE_STRINGS:
            return True
        if low in _FALSE_STRINGS:
            return False
        return None
    if isinstance(dst, T.DateType):
        m = _DATE_RE.fullmatch(t)
        if not m:
            return None
        y = int(m.group(1))
        mo = int(m.group(2)) if m.group(2) else 1
        d = int(m.group(3)) if m.group(3) else 1
        try:
            return (datetime.date(y, mo, d) - datetime.date(1970, 1, 1)).days
        except ValueError:
            return None
    return None


def _java_float_str(x: float, is_float: bool) -> str:
    """Java Float/Double.toString formatting (what Spark emits for
    float -> string casts): positional for 1e-3 <= |x| < 1e7, otherwise
    'd.dddE[-]e' scientific; NaN/Infinity spelled out; >=1 fractional
    digit always present."""
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "Infinity" if x > 0 else "-Infinity"
    if x == 0.0:
        return "-0.0" if math.copysign(1.0, x) < 0 else "0.0"
    ax = abs(x)
    if 1e-3 <= ax < 1e7:
        if is_float:
            s = np.format_float_positional(np.float32(x), unique=True,
                                           trim="0")
        else:
            s = np.format_float_positional(x, unique=True, trim="0")
        if "." not in s:
            s += ".0"
        if s.endswith("."):
            s += "0"
        return s
    if is_float:
        s = np.format_float_scientific(np.float32(x), unique=True, trim="0")
    else:
        s = np.format_float_scientific(x, unique=True, trim="0")
    mant, _, exp = s.partition("e")
    if "." not in mant:
        mant += ".0"
    if mant.endswith("."):
        mant += "0"
    e = int(exp)
    return f"{mant}E{e}"


def _strings_at_once(c: HostColumn):
    """``format_value_as_string`` of a whole integral, boolean or date
    column by numpy (None for other types, or dates outside years
    1-9999, which take the per-row form); invalid rows are None."""
    src, data = c.dtype, c.data
    if isinstance(src, T.BooleanType):
        out = np.where(data, "true", "false").astype(object)
    elif isinstance(src, T.IntegralType):
        out = data.astype(np.int64).astype(str).astype(object)
    elif isinstance(src, T.DateType):
        days = np.where(c.validity, data, 0).astype(np.int64)
        if len(days) and (days.min() < -719162 or days.max() > 2932896):
            return None
        out = np.datetime_as_string(days.astype("datetime64[D]")) \
            .astype(object)
    else:
        return None
    out[~c.validity] = None
    return out


def format_value_as_string(v, src: T.DataType):
    """Spark-exact X -> string rendering."""
    if isinstance(src, T.BooleanType):
        return "true" if v else "false"
    if isinstance(src, (T.FloatType, T.DoubleType)):
        return _java_float_str(float(v), isinstance(src, T.FloatType))
    if isinstance(src, T.DateType):
        return (datetime.date(1970, 1, 1)
                + datetime.timedelta(days=int(v))).isoformat()
    return str(int(v))


def _cpu_decimal_cast(c: HostColumn, dst: T.DataType) -> HostColumn:
    from decimal import Decimal, InvalidOperation

    from spark_rapids_tpu_torch.ops.decimal import (
        _POW10,
        host_store,
        host_unscaled,
        rescale_int,
    )
    src = c.dtype
    n = len(c.data)
    validity = c.validity.copy()
    if isinstance(src, T.DecimalType) and isinstance(dst, T.DecimalType):
        vals = host_unscaled(c)
        out = [0] * n
        bound = _POW10[dst.precision]
        for i in range(n):
            if validity[i]:
                v = rescale_int(int(vals[i]), src.scale, dst.scale)
                if abs(v) >= bound:
                    validity[i] = False
                else:
                    out[i] = v
        return host_store(out, validity, dst)
    if isinstance(dst, T.DecimalType):
        if isinstance(src, T.StringType):
            out = [0] * n
            bound = _POW10[dst.precision]
            for i in range(n):
                if validity[i]:
                    try:
                        d = Decimal(str(c.data[i]).strip())
                        v = int(d.scaleb(dst.scale).to_integral_value(
                            rounding="ROUND_HALF_UP"))
                    except (InvalidOperation, ValueError):
                        validity[i] = False
                        continue
                    if abs(v) >= bound:
                        validity[i] = False
                    else:
                        out[i] = v
            return host_store(out, validity, dst)
        if isinstance(src, (T.FloatType, T.DoubleType)):
            # Spark: BigDecimal.valueOf(double) then HALF_UP to scale
            out = [0] * n
            bound = _POW10[dst.precision]
            for i in range(n):
                if validity[i]:
                    f = float(c.data[i])
                    if not np.isfinite(f):
                        validity[i] = False
                        continue
                    d = Decimal(repr(f))
                    v = int(d.scaleb(dst.scale).to_integral_value(
                        rounding="ROUND_HALF_UP"))
                    if abs(v) >= bound:
                        validity[i] = False
                    else:
                        out[i] = v
            return host_store(out, validity, dst)
        # integral -> decimal
        out = [0] * n
        bound = _POW10[dst.precision]
        scale = _POW10[dst.scale]
        for i in range(n):
            if validity[i]:
                v = int(c.data[i]) * scale
                if abs(v) >= bound:
                    validity[i] = False
                else:
                    out[i] = v
        return host_store(out, validity, dst)
    # decimal -> other
    vals = host_unscaled(c)
    scale = _POW10[src.scale]
    if isinstance(dst, (T.DoubleType, T.FloatType)):
        data = np.zeros(n, dtype=dst.np_dtype)
        for i in range(n):
            if validity[i]:
                data[i] = int(vals[i]) / scale
        return HostColumn(dst, data, validity)
    if isinstance(dst, T.StringType):
        out = np.empty(n, dtype=object)
        for i in range(n):
            if not validity[i]:
                out[i] = None
                continue
            v = int(vals[i])
            if src.scale == 0:
                out[i] = str(v)
            else:
                sign = "-" if v < 0 else ""
                a = abs(v)
                out[i] = f"{sign}{a // scale}." \
                         f"{a % scale:0{src.scale}d}"
        return HostColumn(T.STRING, out, validity)
    if isinstance(dst, T.IntegralType):
        data = np.zeros(n, dtype=dst.np_dtype)
        info = np.iinfo(dst.np_dtype)
        for i in range(n):
            if validity[i]:
                v = int(vals[i])
                q = abs(v) // scale  # truncate toward zero
                q = -q if v < 0 else q
                if not (info.min <= q <= info.max):
                    validity[i] = False  # overflow -> null (non-ANSI)
                else:
                    data[i] = q
        return HostColumn(dst, data, validity)
    raise ColumnarProcessingError(
        f"cast {src.simple_string()} -> {dst.simple_string()} not supported")
