"""Spark SQL type system for the PyTorch port (a copy of the reference
package's ``types.py``, plus the numpy <-> torch dtype map at the end).

Device mapping (how each Spark type lives in device memory as a torch tensor):
  BooleanType            -> torch.bool
  ByteType               -> torch.int8
  ShortType              -> torch.int16
  IntegerType            -> torch.int32
  LongType               -> torch.int64
  FloatType              -> torch.float32
  DoubleType             -> torch.float64
  DateType               -> torch.int32   (days since epoch, Spark-compatible)
  TimestampType          -> torch.int64   (microseconds since epoch, UTC)
  StringType             -> torch.int32 dictionary codes (order-preserving,
                            per batch) + host-side dictionary; see columnar/
  DecimalType(p<=18, s)  -> torch.int64 unscaled value
  NullType               -> torch.int8 (all-null)
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass

import numpy as np
import torch


class DataType:
    """Base of the Spark SQL type hierarchy."""

    #: numpy dtype used for the device representation of this type.
    np_dtype: np.dtype = None  # type: ignore[assignment]

    def simple_string(self) -> str:
        return type(self).__name__.replace("Type", "").lower()

    def __repr__(self) -> str:
        return self.simple_string()

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self).__name__)


class NumericType(DataType):
    pass


class IntegralType(NumericType):
    pass


class FractionalType(NumericType):
    pass


class BooleanType(DataType):
    np_dtype = np.dtype(np.bool_)


class ByteType(IntegralType):
    np_dtype = np.dtype(np.int8)

    def simple_string(self):
        return "tinyint"


class ShortType(IntegralType):
    np_dtype = np.dtype(np.int16)

    def simple_string(self):
        return "smallint"


class IntegerType(IntegralType):
    np_dtype = np.dtype(np.int32)

    def simple_string(self):
        return "int"


class LongType(IntegralType):
    np_dtype = np.dtype(np.int64)

    def simple_string(self):
        return "bigint"


class FloatType(FractionalType):
    np_dtype = np.dtype(np.float32)


class DoubleType(FractionalType):
    np_dtype = np.dtype(np.float64)


class StringType(DataType):
    # device representation is int32 dictionary codes; the logical type has
    # no fixed-width numpy dtype of its own.
    np_dtype = np.dtype(object)


class DateType(DataType):
    """Days since 1970-01-01 as int32 (Spark internal representation)."""

    np_dtype = np.dtype(np.int32)


class TimestampType(DataType):
    """Microseconds since epoch (UTC) as int64 (Spark internal repr)."""

    np_dtype = np.dtype(np.int64)


class NullType(DataType):
    np_dtype = np.dtype(np.int8)

    def simple_string(self):
        return "void"


@dataclass(frozen=True)
class DecimalType(FractionalType):
    """Decimal with precision/scale. p<=18 fits an int64 unscaled value.

    The reference uses 128-bit decimals via JNI DecimalUtils for p>18
    (SURVEY.md §2.9); we represent p<=18 natively and 19..38 as a
    (hi int64, lo uint64-as-int64) pair on device (phase: later).
    """

    precision: int = 10
    scale: int = 0

    MAX_PRECISION = 38
    MAX_LONG_DIGITS = 18

    def __post_init__(self):
        if not (0 < self.precision <= self.MAX_PRECISION):
            raise ValueError(f"bad decimal precision {self.precision}")
        if not (0 <= self.scale <= self.precision):
            raise ValueError(f"bad decimal scale {self.scale}")

    @property
    def np_dtype(self):  # type: ignore[override]
        return np.dtype(np.int64)

    def simple_string(self):
        return f"decimal({self.precision},{self.scale})"

    def __eq__(self, other):
        return (
            isinstance(other, DecimalType)
            and other.precision == self.precision
            and other.scale == self.scale
        )

    def __hash__(self):
        return hash(("decimal", self.precision, self.scale))


@dataclass(frozen=True)
class ArrayType(DataType):
    element_type: DataType = None  # type: ignore[assignment]
    contains_null: bool = True

    def simple_string(self):
        return f"array<{self.element_type.simple_string()}>"

    def __eq__(self, other):
        return (
            isinstance(other, ArrayType)
            and other.element_type == self.element_type
        )

    def __hash__(self):
        return hash(("array", self.element_type))


@dataclass(frozen=True)
class StructField:
    name: str
    data_type: DataType
    nullable: bool = True


class StructType(DataType):
    def __init__(self, fields):
        # accept (name, dtype) pairs as a convenience — pyspark users write
        # StructType([("a", LongType()), ...]) shapes constantly
        self.fields = tuple(
            f if isinstance(f, StructField) else StructField(*f)
            for f in fields)

    def simple_string(self):
        inner = ",".join(
            f"{f.name}:{f.data_type.simple_string()}" for f in self.fields
        )
        return f"struct<{inner}>"

    def __eq__(self, other):
        return isinstance(other, StructType) and other.fields == self.fields

    def __hash__(self):
        return hash(("struct", self.fields))


@dataclass(frozen=True)
class MapType(DataType):
    key_type: DataType = None  # type: ignore[assignment]
    value_type: DataType = None  # type: ignore[assignment]
    value_contains_null: bool = True

    def simple_string(self):
        return (
            f"map<{self.key_type.simple_string()},"
            f"{self.value_type.simple_string()}>"
        )

    def __eq__(self, other):
        return (
            isinstance(other, MapType)
            and other.key_type == self.key_type
            and other.value_type == self.value_type
        )

    def __hash__(self):
        return hash(("map", self.key_type, self.value_type))


# Singletons, Spark-style.
BOOLEAN = BooleanType()
BYTE = ByteType()
SHORT = ShortType()
INT = IntegerType()
LONG = LongType()
FLOAT = FloatType()
DOUBLE = DoubleType()
STRING = StringType()
DATE = DateType()
TIMESTAMP = TimestampType()
NULL = NullType()

ALL_INTEGRAL = (BYTE, SHORT, INT, LONG)
ALL_NUMERIC = ALL_INTEGRAL + (FLOAT, DOUBLE)
ALL_ORDERABLE = ALL_NUMERIC + (BOOLEAN, STRING, DATE, TIMESTAMP)

_NUMPY_TO_SPARK = {
    np.dtype(np.bool_): BOOLEAN,
    np.dtype(np.int8): BYTE,
    np.dtype(np.int16): SHORT,
    np.dtype(np.int32): INT,
    np.dtype(np.int64): LONG,
    np.dtype(np.float32): FLOAT,
    np.dtype(np.float64): DOUBLE,
}


def from_numpy(dtype) -> DataType:
    dt = _NUMPY_TO_SPARK.get(np.dtype(dtype))
    if dt is None:
        raise TypeError(f"no Spark type for numpy dtype {dtype}")
    return dt


def is_dec128(dt: DataType) -> bool:
    """p>18 decimals: two-limb (hi i64, lo u64-bits-in-i64) device storage
    as a (capacity, 2) int64 array (the reference's DECIMAL128 tier —
    TypeChecks.scala:613)."""
    return (isinstance(dt, DecimalType)
            and dt.precision > DecimalType.MAX_LONG_DIGITS)


def is_string(dt: DataType) -> bool:
    return isinstance(dt, StringType)


def is_integral(dt: DataType) -> bool:
    return isinstance(dt, IntegralType)


def is_numeric(dt: DataType) -> bool:
    return isinstance(dt, NumericType)


def is_floating(dt: DataType) -> bool:
    return isinstance(dt, (FloatType, DoubleType))


def is_nested(dt: DataType) -> bool:
    return isinstance(dt, (ArrayType, StructType, MapType))


_NAME_TO_TYPE = None


def parse_type(name: str) -> DataType:
    """Spark simple-string type names -> DataType (cast('bigint') etc.)."""
    global _NAME_TO_TYPE
    if _NAME_TO_TYPE is None:
        _NAME_TO_TYPE = {
            "boolean": BOOLEAN, "bool": BOOLEAN,
            "tinyint": BYTE, "byte": BYTE,
            "smallint": SHORT, "short": SHORT,
            "int": INT, "integer": INT,
            "bigint": LONG, "long": LONG,
            "float": FLOAT, "real": FLOAT,
            "double": DOUBLE,
            "string": STRING,
            "date": DATE,
            "timestamp": TIMESTAMP,
        }
    key = name.strip().lower()
    if key in _NAME_TO_TYPE:
        return _NAME_TO_TYPE[key]
    if key.startswith("decimal"):
        import re
        m = re.match(r"decimal\((\d+),\s*(\d+)\)", key)
        if m:
            return DecimalType(int(m.group(1)), int(m.group(2)))
        return DecimalType(10, 0)
    raise TypeError(f"cannot parse type name {name!r}")


def python_to_spark_type(value) -> DataType:
    """Infer the Spark type of a Python literal (Spark Literal.apply analog)."""
    if value is None:
        return NULL
    if isinstance(value, bool):
        return BOOLEAN
    if isinstance(value, int):
        return INT if np.iinfo(np.int32).min <= value <= np.iinfo(np.int32).max else LONG
    if isinstance(value, float):
        return DOUBLE
    if isinstance(value, str):
        return STRING
    if isinstance(value, _dt.datetime):
        return TIMESTAMP
    if isinstance(value, _dt.date):
        return DATE
    if isinstance(value, np.generic):
        return from_numpy(value.dtype)
    raise TypeError(f"cannot infer Spark type for {value!r}")


# Numeric widening lattice for implicit binary-op promotion (Spark
# TypeCoercion findTightestCommonType subset).
_PROMOTE_ORDER = {BYTE: 0, SHORT: 1, INT: 2, LONG: 3, FLOAT: 4, DOUBLE: 5}


def promote(a: DataType, b: DataType) -> DataType:
    if a == b:
        return a
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        return _promote_decimal(a, b)
    if a in _PROMOTE_ORDER and b in _PROMOTE_ORDER:
        return a if _PROMOTE_ORDER[a] >= _PROMOTE_ORDER[b] else b
    if isinstance(a, NullType):
        return b
    if isinstance(b, NullType):
        return a
    raise TypeError(f"cannot promote {a} with {b}")


_INT_DECIMAL = {ByteType: (3, 0), ShortType: (5, 0), IntegerType: (10, 0),
                LongType: (20, 0)}


def _promote_decimal(a: DataType, b: DataType) -> DataType:
    """Spark decimal coercion: decimal+decimal widens to cover both;
    decimal+integral widens over the integral's decimal form;
    decimal+float/double promotes to double."""
    if isinstance(a, (FloatType, DoubleType)) or \
            isinstance(b, (FloatType, DoubleType)):
        return DOUBLE
    def as_dec(t):
        if isinstance(t, DecimalType):
            return t
        ps = _INT_DECIMAL.get(type(t))
        return DecimalType(*ps) if ps else None
    da, db = as_dec(a), as_dec(b)
    if da is None or db is None:
        raise TypeError(f"cannot promote {a} with {b}")
    scale = max(da.scale, db.scale)
    int_digits = max(da.precision - da.scale, db.precision - db.scale)
    p = min(int_digits + scale, DecimalType.MAX_PRECISION)
    return DecimalType(p, scale)


# ---------------------------------------------------------------------------
# numpy <-> torch dtype map (torch defaults to int64/float32; every tensor
# the port makes names its dtype explicitly through this map)
# ---------------------------------------------------------------------------

_NUMPY_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}

_TORCH_TO_NUMPY = {v: k for k, v in _NUMPY_TO_TORCH.items()}


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype (or a Spark DataType, by its np_dtype) -> torch dtype."""
    if isinstance(dtype, DataType):
        dtype = dtype.np_dtype
    got = _NUMPY_TO_TORCH.get(np.dtype(dtype))
    if got is None:
        raise TypeError(f"no torch dtype for numpy dtype {dtype}")
    return got


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    got = _TORCH_TO_NUMPY.get(dtype)
    if got is None:
        raise TypeError(f"no numpy dtype for torch dtype {dtype}")
    return got
