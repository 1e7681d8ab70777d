"""Date and time expressions (port of ``spark_rapids_tpu/ops/datetime.py``).

DATE is int32 days since 1970-01-01 and TIMESTAMP int64 UTC microseconds,
so the calendar functions are integer arithmetic on the device, with the
days-from-civil / civil-from-days algorithms (Howard Hinnant's public
algorithms, branch-free) for the fields and month arithmetic. torch's
``//`` and ``%`` on integer tensors floor, as Spark's fields need before
1970 (``torch.fmod`` would truncate): hour, minute and second of a
pre-1970 timestamp, ``dayofweek`` of a negative day.

The string parsers (``unix_timestamp(string, fmt)``, ``to_timestamp``)
are dictionary transforms (ops/strings.py) with a Java SimpleDateFormat
pattern translated by ``translate_java_format``; a pattern outside the
translatable subset raises NotImplementedError naming itself (the
reference's CPU route reads no format outside it either). The CPU route
evaluates every function here on the host (``eval_cpu``)."""

from __future__ import annotations

import datetime as _dt

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.ops.common import (
    BinaryExpression,
    UnaryExpression,
    null_and,
)
from spark_rapids_tpu_torch.ops.expr import DevVal, Expression, Literal
from spark_rapids_tpu_torch.ops.strings import DictStringToValue

MICROS_PER_DAY = 86_400_000_000
MICROS_PER_SECOND = 1_000_000


def civil_from_days(days: torch.Tensor):
    """(year, month, day) int64 of days since the epoch; integer-only,
    valid over the whole int32 day range."""
    z = days.to(torch.int64) + 719468
    era = z // 146097
    doe = z - era * 146097                                   # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)          # [0, 365]
    mp = (5 * doy + 2) // 153                                # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1                        # [1, 31]
    m = mp + 3 - 12 * (mp >= 10).long()                      # [1, 12]
    y = y + (m <= 2).long()
    return y, m, d


def days_from_civil(y, m, d):
    """Days since the epoch (int64) of int64 (year, month, day); the
    inverse of ``civil_from_days``."""
    y = y - (m <= 2).long()
    era = y // 400
    yoe = y - era * 400
    mp = m - 3 + 12 * (m <= 2).long()
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _first_of_next_month(y, m):
    """Days since the epoch of the first day of the month after (y, m)."""
    return days_from_civil(y + (m == 12).long(), m % 12 + 1,
                           torch.ones_like(y))


class _DateField(UnaryExpression):
    """DATE -> INT field extraction."""

    @property
    def data_type(self):
        return T.INT

    def resolve(self, bound):
        c = bound[0]
        if not isinstance(c.data_type, T.DateType):
            raise ColumnarProcessingError(
                f"{self.name} requires a date input, got {c.data_type}")
        return self.with_children(bound)

    def _field(self, days: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        cv = child_vals[0]
        out = self._field(cv.data).to(T.torch_dtype(self.data_type))
        return DevVal(torch.where(cv.validity, out, torch.zeros_like(out)),
                      cv.validity)

    def eval_cpu(self, table: HostTable) -> HostColumn:
        # the field's integer arithmetic, on host tensors over the numpy
        # days (the reference's numpy computes the same integers)
        c = self.children[0].eval_cpu(table)
        days = torch.from_numpy(np.asarray(c.data, dtype=np.int32))
        out = self._field(days).numpy().astype(np.int32)
        return HostColumn(self.data_type, np.where(c.validity, out, 0),
                          c.validity.copy())


class Year(_DateField):
    def _field(self, days):
        return civil_from_days(days)[0]


class Month(_DateField):
    def _field(self, days):
        return civil_from_days(days)[1]


class DayOfMonth(_DateField):
    def _field(self, days):
        return civil_from_days(days)[2]


class Quarter(_DateField):
    def _field(self, days):
        return (civil_from_days(days)[1] - 1) // 3 + 1


class DayOfWeek(_DateField):
    """Sunday = 1 .. Saturday = 7 (1970-01-01 was a Thursday = 5)."""

    def _field(self, days):
        return (days.to(torch.int64) + 4) % 7 + 1


class WeekDay(_DateField):
    """Monday = 0 .. Sunday = 6."""

    def _field(self, days):
        return (days.to(torch.int64) + 3) % 7


class DayOfYear(_DateField):
    def _field(self, days):
        y = civil_from_days(days)[0]
        one = torch.ones_like(y)
        return days.to(torch.int64) - days_from_civil(y, one, one) + 1


class LastDay(_DateField):
    """The last day of the date's month (a DATE)."""

    @property
    def data_type(self):
        return T.DATE

    def _field(self, days):
        y, m, _ = civil_from_days(days)
        return _first_of_next_month(y, m) - 1


def _int_operand(name: str, e: Expression) -> None:
    if not isinstance(e.data_type, (T.ByteType, T.ShortType, T.IntegerType,
                                    T.LongType)):
        raise ColumnarProcessingError(
            f"{name} takes an integral count, got "
            f"{e.data_type.simple_string()}")


class _DateArith(BinaryExpression):
    """date (+/-) n: DATE out; null where either side is null."""

    def resolve(self, bound):
        if not isinstance(bound[0].data_type, T.DateType):
            raise ColumnarProcessingError(
                f"{self.name} requires a date input, got "
                f"{bound[0].data_type}")
        _int_operand(self.name, bound[1])
        return self.with_children(bound)

    @property
    def data_type(self):
        return T.DATE

    def _op(self, d, n):
        raise NotImplementedError

    def eval_dev(self, ctx, child_vals, prep):
        d, n = child_vals
        validity = null_and(d.validity, n.validity)
        out = self._op(d.data.to(torch.int64), n.data.to(torch.int64)
                       ).to(torch.int32)
        return DevVal(torch.where(validity, out, torch.zeros_like(out)),
                      validity)


class DateAdd(_DateArith):
    """date + n days (int32 wrap, as the reference's)."""

    def _op(self, d, n):
        return d + n

    def eval_cpu(self, table):
        d = self.children[0].eval_cpu(table)
        n = self.children[1].eval_cpu(table)
        validity = d.validity & n.validity
        return HostColumn(T.DATE,
                          (d.data.astype(np.int64) + n.data.astype(np.int64)
                           ).astype(np.int32),
                          validity)


class DateSub(_DateArith):
    def _op(self, d, n):
        return d - n

    def eval_cpu(self, table):
        d = self.children[0].eval_cpu(table)
        n = self.children[1].eval_cpu(table)
        return HostColumn(T.DATE,
                          (d.data.astype(np.int64) - n.data.astype(np.int64)
                           ).astype(np.int32),
                          d.validity & n.validity)


class AddMonths(_DateArith):
    """add_months(date, n): the day clamps to the target month's last
    day."""

    def _op(self, d, n):
        y, m, day = civil_from_days(d)
        total = (m - 1) + n
        ny = y + total // 12
        nm = total % 12 + 1
        last = civil_from_days(_first_of_next_month(ny, nm) - 1)[2]
        return days_from_civil(ny, nm, torch.minimum(day, last))

    def eval_cpu(self, table):
        dcol = self.children[0].eval_cpu(table)
        ncol = self.children[1].eval_cpu(table)
        out = self._op(torch.from_numpy(dcol.data.astype(np.int32)),
                       torch.from_numpy(ncol.data.astype(np.int32)))
        validity = dcol.validity & ncol.validity
        return HostColumn(T.DATE, np.where(validity, out.numpy(), 0)
                          .astype(np.int32), validity)


class DateDiff(BinaryExpression):
    """datediff(end, start) = end - start in days."""

    @property
    def data_type(self):
        return T.INT

    def resolve(self, bound):
        for c in bound:
            if not isinstance(c.data_type, T.DateType):
                raise ColumnarProcessingError(
                    f"DateDiff requires date inputs, got {c.data_type}")
        return self.with_children(bound)

    def eval_dev(self, ctx, child_vals, prep):
        e, s = child_vals
        validity = null_and(e.validity, s.validity)
        out = (e.data - s.data).to(torch.int32)
        return DevVal(torch.where(validity, out, torch.zeros_like(out)),
                      validity)

    def eval_cpu(self, table):
        e = self.children[0].eval_cpu(table)
        s = self.children[1].eval_cpu(table)
        return HostColumn(T.INT, (e.data - s.data).astype(np.int32),
                          e.validity & s.validity)


class _TimestampField(UnaryExpression):
    """TIMESTAMP (UTC micros) -> INT field: floor(ts / divisor) mod
    modulus, both flooring."""

    divisor = 1
    modulus = 0

    @property
    def data_type(self):
        return T.INT

    def resolve(self, bound):
        if not isinstance(bound[0].data_type, T.TimestampType):
            raise ColumnarProcessingError(
                f"{self.name} requires a timestamp input, got "
                f"{bound[0].data_type}")
        return self.with_children(bound)

    def eval_dev(self, ctx, child_vals, prep):
        cv = child_vals[0]
        v = cv.data // self.divisor
        if self.modulus:
            v = v % self.modulus
        v = v.to(torch.int32)
        return DevVal(torch.where(cv.validity, v, torch.zeros_like(v)),
                      cv.validity)

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        v = np.floor_divide(c.data, self.divisor)
        if self.modulus:
            v = np.mod(v, self.modulus)
        return HostColumn(T.INT, v.astype(np.int32), c.validity.copy())


class Hour(_TimestampField):
    divisor = 3_600_000_000
    modulus = 24


class Minute(_TimestampField):
    divisor = 60_000_000
    modulus = 60


class Second(_TimestampField):
    divisor = MICROS_PER_SECOND
    modulus = 60


class _TsUnary(UnaryExpression):
    """An elementwise timestamp conversion: ``_op`` on int64 data."""

    out_type: T.DataType = T.TIMESTAMP

    @property
    def data_type(self):
        return self.out_type

    def _op(self, x):
        raise NotImplementedError

    def eval_dev(self, ctx, child_vals, prep):
        cv = child_vals[0]
        out = self._op(cv.data.to(torch.int64)).to(
            T.torch_dtype(self.out_type))
        return DevVal(torch.where(cv.validity, out, torch.zeros_like(out)),
                      cv.validity)


class UnixTimestampFromTs(_TsUnary):
    """to_unix_timestamp(ts): floor seconds since the epoch (LONG)."""

    out_type = T.LONG

    def _op(self, x):
        return x // MICROS_PER_SECOND

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        return HostColumn(T.LONG, np.floor_divide(c.data, MICROS_PER_SECOND),
                          c.validity.copy())


class SecondsToTimestamp(_TsUnary):
    def _op(self, x):
        return x * MICROS_PER_SECOND

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        return HostColumn(T.TIMESTAMP,
                          c.data.astype(np.int64) * MICROS_PER_SECOND,
                          c.validity.copy())


class MillisToTimestamp(_TsUnary):
    def _op(self, x):
        return x * 1000

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        return HostColumn(T.TIMESTAMP, c.data.astype(np.int64) * 1000,
                          c.validity.copy())


class MicrosToTimestamp(_TsUnary):
    def _op(self, x):
        return x

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        return HostColumn(T.TIMESTAMP, c.data.astype(np.int64), c.validity.copy())


class TsToDate(_TsUnary):
    """timestamp -> date (the UTC day, floored)."""

    out_type = T.DATE

    def _op(self, x):
        return x // MICROS_PER_DAY

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        return HostColumn(T.DATE,
                          np.floor_divide(c.data, MICROS_PER_DAY).astype(np.int32),
                          c.validity.copy())


class PreciseTimestampConversion(_TsUnary):
    """Exact long <-> timestamp reinterpretation at micros precision."""

    def __init__(self, child: Expression, to_timestamp: bool = True):
        super().__init__(child)
        self.to_ts = to_timestamp

    @property
    def data_type(self):
        return T.TIMESTAMP if self.to_ts else T.LONG

    @property
    def out_type(self):
        return self.data_type

    def with_children(self, children):
        return PreciseTimestampConversion(children[0], self.to_ts)

    def _op(self, x):
        return x

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        return HostColumn(self.data_type, c.data.astype(np.int64),
                          c.validity.copy())


# -- string timestamp parsing (the UnixTimestamp family) ---------------------

#: Java SimpleDateFormat token -> strptime directive (longest first). A
#: pattern with a token outside this table is untranslatable and raises.
_JAVA_TOKENS = [
    ("yyyy", "%Y"), ("yyy", "%Y"), ("yy", "%y"),
    ("MM", "%m"), ("dd", "%d"), ("HH", "%H"), ("hh", "%I"),
    ("mm", "%M"), ("ss", "%S"),
    ("M", "%m"), ("d", "%d"), ("H", "%H"), ("m", "%M"), ("s", "%S"),
]


def translate_java_format(fmt: str):
    """Java SimpleDateFormat -> strptime; None when a token has no faithful
    mapping (fractions, zones, am/pm, day names, quoted text)."""
    out = []
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch.isalpha():
            for tok, rep in _JAVA_TOKENS:
                if fmt.startswith(tok, i):
                    out.append(rep)
                    i += len(tok)
                    break
            else:
                return None
        else:
            out.append("%%" if ch == "%" else ch)
            i += 1
    return "".join(out)


_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


class UnixTimestamp(DictStringToValue, BinaryExpression):
    """unix_timestamp(string, fmt): seconds since the epoch (LONG), null
    where the string does not parse (Spark non-ANSI). ``fmt`` must be a
    literal in the translatable subset."""

    out_type = T.LONG

    def __init__(self, child: Expression, fmt: Expression = None):
        fmt = fmt if fmt is not None else Literal("yyyy-MM-dd HH:mm:ss")
        self.children = (child, fmt)

    def with_children(self, children):
        return type(self)(children[0], children[1])

    def _fmt(self):
        f = self.children[1]
        if isinstance(f, Literal) and f.value is not None:
            return translate_java_format(str(f.value))
        return None

    def resolve(self, bound):
        out = super().resolve(bound)
        if out._fmt() is None:
            f = out.children[1]
            raise NotImplementedError(
                f"{out.name} format "
                f"{f.value if isinstance(f, Literal) else f!r} (not a "
                "literal in the translatable SimpleDateFormat subset: the "
                "reference's CPU route) is not ported")
        return out

    def value_of(self, s: str):
        try:
            d = _dt.datetime.strptime(s.strip(), self._fmt())
        except ValueError:
            return None
        return (d.replace(tzinfo=_dt.timezone.utc) - _EPOCH) // \
            _dt.timedelta(seconds=1)


class ToUnixTimestamp(UnixTimestamp):
    """to_unix_timestamp(string, fmt): the same semantics."""


class GetTimestamp(UnixTimestamp):
    """to_timestamp(string, fmt): a TIMESTAMP (micros)."""

    out_type = T.TIMESTAMP

    def value_of(self, s: str):
        v = super().value_of(s)
        return None if v is None else v * MICROS_PER_SECOND


class TimeAdd(BinaryExpression):
    """timestamp + a literal interval in micros (a null interval gives a
    null column); a non-literal interval raises (the reference's CPU
    route)."""

    @property
    def data_type(self):
        return T.TIMESTAMP

    def resolve(self, bound):
        if not isinstance(bound[1], Literal):
            raise NotImplementedError(
                "TimeAdd with a non-literal interval is not ported")
        return self.with_children(bound)

    def eval_dev(self, ctx, child_vals, prep):
        c = child_vals[0]
        m = self.children[1].value
        if m is None:
            return DevVal(torch.zeros_like(c.data),
                          torch.zeros_like(c.validity))
        out = c.data + int(m)
        return DevVal(torch.where(c.validity, out, torch.zeros_like(out)),
                      c.validity)

    def _micros(self):
        """Interval micros, or None for a null literal (null interval ->
        null column, Spark semantics)."""
        from spark_rapids_tpu_torch.ops.expr import Literal
        i = self.children[1]
        if not isinstance(i, Literal):
            raise ColumnarProcessingError(
                "TimeAdd interval must be a literal")
        return None if i.value is None else int(i.value)

    def eval_cpu(self, table):
        c = self.children[0].eval_cpu(table)
        m = self._micros()
        if m is None:
            return HostColumn(T.TIMESTAMP, np.zeros_like(c.data),
                              np.zeros(len(c.data), dtype=np.bool_))
        return HostColumn(T.TIMESTAMP, c.data + m, c.validity.copy())

