"""Type support matrix (port of ``spark_rapids_tpu/overrides/typesig.py``,
the reference's TypeChecks.scala / TypeSig): the Spark types an operator
or an expression parameter runs on the device for. Anything else tags
the node onto the CPU route with a reason (overrides/rules.py), and the
generated matrix (overrides/docs.py) reads the same objects.

The port's device surface differs from the reference's in two places,
so the signatures are the port's own: every scalar type, DECIMAL128 and
NULL included, has a device form, and a nested type has one when its
leaves are fixed-width (``columnar/nested.py::layout_supported``)."""

from __future__ import annotations

from typing import Iterable

from spark_rapids_tpu_torch import types as T


class TypeSig:
    def __init__(self, *type_classes,
                 max_decimal_precision: int = T.DecimalType.MAX_LONG_DIGITS):
        self.type_classes = tuple(type_classes)
        self.max_decimal_precision = max_decimal_precision

    def supports(self, dt: T.DataType) -> bool:
        if isinstance(dt, T.DecimalType):
            return (T.DecimalType in self.type_classes
                    and dt.precision <= self.max_decimal_precision)
        return any(type(dt) is tc for tc in self.type_classes)

    def reason_if_unsupported(self, dt: T.DataType, what: str) -> str:
        if self.supports(dt):
            return ""
        return f"{what} has unsupported type {dt.simple_string()}"

    def __add__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(*(set(self.type_classes) | set(other.type_classes)),
                       max_decimal_precision=max(self.max_decimal_precision,
                                                 other.max_decimal_precision))


_COMMON = (T.BooleanType, T.ByteType, T.ShortType, T.IntegerType, T.LongType,
           T.FloatType, T.DoubleType, T.DateType, T.TimestampType,
           T.StringType, T.DecimalType, T.NullType)

#: the scalar types, decimals to 18 digits (int64 unscaled storage)
COMMON = TypeSig(*_COMMON)
NUMERIC = TypeSig(T.ByteType, T.ShortType, T.IntegerType, T.LongType,
                  T.FloatType, T.DoubleType)
INTEGRAL = TypeSig(T.ByteType, T.ShortType, T.IntegerType, T.LongType)
ORDERABLE = COMMON
ALL = COMMON


class AnyOfSig(TypeSig):
    """Union of signatures."""

    def __init__(self, *sigs):
        super().__init__()
        self.sigs = sigs

    def supports(self, dt: T.DataType) -> bool:
        return any(s.supports(dt) for s in self.sigs)


class _NestedLayoutSig(TypeSig):
    """One nested type with a device layout (fixed-width leaves)."""

    def __init__(self, type_class):
        super().__init__()
        self.nested_class = type_class

    def supports(self, dt: T.DataType) -> bool:
        from spark_rapids_tpu_torch.columnar.nested import layout_supported
        return isinstance(dt, self.nested_class) and layout_supported(dt)


#: arrays of fixed-width elements, structs of fixed-width fields, maps of
#: fixed-width keys and values (columnar/nested.py's layouts)
ARRAY_FIXED = _NestedLayoutSig(T.ArrayType)
STRUCT_FIXED = _NestedLayoutSig(T.StructType)
MAP_FIXED = _NestedLayoutSig(T.MapType)


class ExprChecks:
    """Per-PARAMETER input signatures of one expression rule (the
    reference's ExprChecks: the OUTPUT of Acos is always DOUBLE, so only
    an input-position check can reject a string argument).
    ``param_sigs``: leading per-child signatures; children beyond them
    check against ``rest`` (None: no check)."""

    def __init__(self, param_sigs: Iterable[TypeSig] = (),
                 rest: TypeSig = None):
        self.param_sigs = tuple(param_sigs)
        self.rest = rest

    def param_sig(self, i: int):
        if i < len(self.param_sigs):
            return self.param_sigs[i]
        return self.rest

    def doc_param_rows(self):
        """(label, sig) rows for the generated matrix."""
        rows = [(f"param {i}", s) for i, s in enumerate(self.param_sigs)]
        if self.rest is not None:
            rows.append(("param *", self.rest))
        return rows


def lookup_mro(registry: dict, cls: type):
    """First MRO hit in a class-keyed registry (shared by the tagging and
    the doc generation, so their lookups cannot diverge)."""
    for klass in cls.__mro__:
        if klass in registry:
            return registry[klass]
    return None


#: full-precision decimals (p <= 38): a (capacity, 2) int64 limb pair
DEC128 = TypeSig(T.DecimalType,
                 max_decimal_precision=T.DecimalType.MAX_PRECISION)

#: every scalar type at full decimal precision: what storage, compare,
#: sort, join, group and exchange carry
COMMON_128 = AnyOfSig(COMMON, DEC128)

#: scalars plus fixed-element arrays (a generate's or an aggregate's
#: output)
COMMON_PLUS_ARRAYS = AnyOfSig(COMMON_128, ARRAY_FIXED)

#: scalars plus every nested layout (a scan's, a cached relation's or a
#: project's output)
COMMON_PLUS_NESTED = AnyOfSig(COMMON, ARRAY_FIXED, STRUCT_FIXED, MAP_FIXED)

#: the nested surface at full decimal precision: every type the device
#: holds in some form
NESTED_128 = AnyOfSig(COMMON_PLUS_NESTED, DEC128)
