"""PySpark-style function namespace: the expression constructors the
ported slices have, ``expr`` (one SQL expression) and the process-wide
SQL function registrations. A higher-order function takes its lambda as
a Python callable, run once at plan time with symbolic variables
(``F.transform(c, lambda x: x * 2)``), or as a LambdaFunction."""

from __future__ import annotations

from spark_rapids_tpu_torch.ops import aggregates as _agg
from spark_rapids_tpu_torch.ops import conditional as _cond
from spark_rapids_tpu_torch.ops import datetime as _dt
from spark_rapids_tpu_torch.ops import math as _math
from spark_rapids_tpu_torch.ops import misc as _misc
from spark_rapids_tpu_torch.ops import strings as _str
from spark_rapids_tpu_torch.ops.expr import Expression, col, lit  # noqa: F401


def _e(x) -> Expression:
    return x if isinstance(x, Expression) else col(x) if isinstance(x, str) else lit(x)


def _lit(x) -> Expression:
    """A value as a literal (a string is a value here, not a column)."""
    return x if isinstance(x, Expression) else lit(x)


def sum(e):  # noqa: A001
    return _agg.Sum(_e(e))


def min(e):  # noqa: A001
    return _agg.Min(_e(e))


def max(e):  # noqa: A001
    return _agg.Max(_e(e))


def count(e="*"):
    # type-guarded star check: col("x") == "*" would build an expression
    if (isinstance(e, str) and e == "*") or (isinstance(e, int) and e == 1):
        return _agg.Count()
    return _agg.Count(_e(e))


def avg(e):
    return _agg.Average(_e(e))


def collect_list(e):
    return _agg.CollectList(_e(e))


def collect_set(e):
    return _agg.CollectSet(_e(e))


def percentile(e, p: float):
    return _agg.Percentile(_e(e), p)


def approx_percentile(e, percentage, accuracy: int = 10000):
    """approx_percentile, served EXACTLY by the sort-based percentile
    (exact satisfies every accuracy, as in the reference)."""
    return _agg.Percentile(_e(e), percentage)


approxPercentile = approx_percentile


def stddev(e):
    return _agg.StddevSamp(_e(e))


def stddev_pop(e):
    return _agg.StddevPop(_e(e))


def variance(e):
    return _agg.VarianceSamp(_e(e))


def var_pop(e):
    return _agg.VariancePop(_e(e))


def first(e, ignore_nulls=False):
    return _agg.First(_e(e), ignore_nulls)


def last(e, ignore_nulls=False):
    return _agg.Last(_e(e), ignore_nulls)


def abs(e):  # noqa: A001
    from spark_rapids_tpu_torch.ops.arithmetic import Abs
    return Abs(_e(e))


def isnull(e):
    from spark_rapids_tpu_torch.ops.predicates import IsNull
    return IsNull(_e(e))


def isnan(e):
    from spark_rapids_tpu_torch.ops.predicates import IsNaN
    return IsNaN(_e(e))


def is_in(e, *items):
    from spark_rapids_tpu_torch.ops.predicates import In
    return In(_e(e), [_e(i) for i in items])


# input-file provenance (ops/inputfile.py)
def input_file_name():
    """Name of the file feeding the current row ('' when no file scan is
    in scope, Spark's semantics)."""
    from spark_rapids_tpu_torch.ops.inputfile import InputFileName
    return InputFileName()


def input_file_block_start():
    from spark_rapids_tpu_torch.ops.inputfile import InputFileBlockStart
    return InputFileBlockStart()


def input_file_block_length():
    from spark_rapids_tpu_torch.ops.inputfile import InputFileBlockLength
    return InputFileBlockLength()


# window functions (ops/window.py): row_number().over(spec)
def row_number():
    from spark_rapids_tpu_torch.ops.window import RowNumber
    return RowNumber()


def rank():
    from spark_rapids_tpu_torch.ops.window import Rank
    return Rank()


def dense_rank():
    from spark_rapids_tpu_torch.ops.window import DenseRank
    return DenseRank()


def percent_rank():
    from spark_rapids_tpu_torch.ops.window import PercentRank
    return PercentRank()


def nth_value(e, n: int):
    from spark_rapids_tpu_torch.ops.window import NthValue
    return NthValue(_e(e), n)


def lag(e, offset: int = 1, default=None):
    from spark_rapids_tpu_torch.ops.window import lag as _lag
    return _lag(_e(e), offset, default)


def lead(e, offset: int = 1, default=None):
    from spark_rapids_tpu_torch.ops.window import lead as _lead
    return _lead(_e(e), offset, default)


# hash functions (ops/hashfns.py)
def hash(*exprs):  # noqa: A001
    from spark_rapids_tpu_torch.ops.hashfns import Murmur3Hash
    return Murmur3Hash(*[_e(x) for x in exprs])


def xxhash64(*exprs):
    from spark_rapids_tpu_torch.ops.hashfns import XxHash64
    return XxHash64(*[_e(x) for x in exprs])


# the bloom runtime filter (ops/bloom.py)
def build_bloom_filter(df, column, num_bits=None, num_hashes=None):
    """bloom_filter_agg: aggregate a DataFrame's integral column into a
    BloomFilter on the session's device."""
    from spark_rapids_tpu_torch.ops.bloom import build_bloom_filter as _b
    return _b(df, column, num_bits=num_bits, num_hashes=num_hashes)


def might_contain(bloom, e):
    from spark_rapids_tpu_torch.ops.bloom import BloomFilterMightContain
    return BloomFilterMightContain(bloom, _e(e))


# conditionals (ops/conditional.py)
def when(cond, value):
    return WhenBuilder().when(cond, value)


class WhenBuilder:
    """``when(c0, v0).when(c1, v1).otherwise(v)`` -> CaseWhen;
    ``.end()`` leaves the ELSE null."""

    def __init__(self):
        self._branches = []

    def when(self, cond, value):
        self._branches.extend([_e(cond), _e(value)])
        return self

    def otherwise(self, value):
        return _cond.CaseWhen(*self._branches, _e(value))

    def end(self):
        return _cond.CaseWhen(*self._branches)


def coalesce(*exprs):
    return _cond.Coalesce(*[_e(e) for e in exprs])


def greatest(*exprs):
    return _cond.Greatest(*[_e(e) for e in exprs])


def least(*exprs):
    return _cond.Least(*[_e(e) for e in exprs])


def nanvl(a, b):
    return _cond.NaNvl(_e(a), _e(b))


def if_(cond, a, b):
    return _cond.If(_e(cond), _e(a), _e(b))


# math functions (ops/math.py)
def sqrt(e):
    return _math.Sqrt(_e(e))


def exp(e):
    return _math.Exp(_e(e))


def log(e):
    return _math.Log(_e(e))


def log10(e):
    return _math.Log10(_e(e))


def log2(e):
    return _math.Log2(_e(e))


def pow(a, b):  # noqa: A001
    return _math.Pow(_e(a), _e(b))


def ceil(e):
    return _math.Ceil(_e(e))


def floor(e):
    return _math.Floor(_e(e))


def round(e, scale=0):  # noqa: A001
    return _math.Round(_e(e), lit(scale))


def bround(e, scale=0):
    return _math.BRound(_e(e), lit(scale))


def signum(e):
    return _math.Signum(_e(e))


def shiftleft(e, n):
    return _math.ShiftLeft(_e(e), _e(n))


def shiftright(e, n):
    return _math.ShiftRight(_e(e), _e(n))


# string functions (ops/strings.py)
def upper(e):
    return _str.Upper(_e(e))


def lower(e):
    return _str.Lower(_e(e))


def length(e):
    return _str.Length(_e(e))


def bit_length(e):
    return _str.BitLength(_e(e))


def octet_length(e):
    return _str.OctetLength(_e(e))


def ascii(e):  # noqa: A001
    return _str.Ascii(_e(e))


def reverse(e):
    return _str.Reverse(_e(e))


def initcap(e):
    return _str.InitCap(_e(e))


def trim(e):
    return _str.StringTrim(_e(e))


def ltrim(e):
    return _str.StringTrimLeft(_e(e))


def rtrim(e):
    return _str.StringTrimRight(_e(e))


def substring(e, pos, length):  # noqa: A002
    return _str.Substring(_e(e), lit(pos), lit(length))


def repeat(e, n):
    return _str.StringRepeat(_e(e), lit(n))


def replace(e, search, replacement=""):
    return _str.StringReplace(_e(e), lit(search), lit(replacement))


def lpad(e, length, pad=" "):  # noqa: A002
    return _str.StringLPad(_e(e), lit(length), lit(pad))


def rpad(e, length, pad=" "):  # noqa: A002
    return _str.StringRPad(_e(e), lit(length), lit(pad))


def substring_index(e, delim, count):
    return _str.SubstringIndex(_e(e), lit(delim), lit(count))


def translate(e, matching, replace):  # noqa: A002
    return _str.StringTranslate(_e(e), lit(matching), lit(replace))


def concat(*exprs):
    return _str.Concat(*[_e(x) for x in exprs])


def contains(e, sub):
    return _str.Contains(_e(e), lit(sub))


def startswith(e, prefix):
    return _str.StartsWith(_e(e), lit(prefix))


def endswith(e, suffix):
    return _str.EndsWith(_e(e), lit(suffix))


def like(e, pattern):
    return _str.Like(_e(e), lit(pattern))


def rlike(e, pattern):
    return _str.RLike(_e(e), lit(pattern))


def instr(e, sub):
    return _str.StringInstr(_e(e), lit(sub))


def locate(sub, e, pos=1):
    return _str.StringLocate(lit(sub), _e(e), lit(pos))


def regexp_replace(e, pattern, replacement):
    return _str.RegExpReplace(_e(e), lit(pattern), lit(replacement))


def regexp_extract(e, pattern, idx=1):
    return _str.RegExpExtract(_e(e), lit(pattern), lit(idx))


# datetime functions (ops/datetime.py)
def year(e):
    return _dt.Year(_e(e))


def month(e):
    return _dt.Month(_e(e))


def dayofmonth(e):
    return _dt.DayOfMonth(_e(e))


def dayofweek(e):
    return _dt.DayOfWeek(_e(e))


def weekday(e):
    return _dt.WeekDay(_e(e))


def dayofyear(e):
    return _dt.DayOfYear(_e(e))


def quarter(e):
    return _dt.Quarter(_e(e))


def last_day(e):
    return _dt.LastDay(_e(e))


def date_add(e, n):
    return _dt.DateAdd(_e(e), _e(n))


def date_sub(e, n):
    return _dt.DateSub(_e(e), _e(n))


def datediff(end, start):
    return _dt.DateDiff(_e(end), _e(start))


def add_months(e, n):
    return _dt.AddMonths(_e(e), _e(n))


def hour(e):
    return _dt.Hour(_e(e))


def minute(e):
    return _dt.Minute(_e(e))


def second(e):
    return _dt.Second(_e(e))


def to_unix_timestamp(e):
    return _dt.UnixTimestampFromTs(_e(e))


def timestamp_seconds(e):
    return _dt.SecondsToTimestamp(_e(e))


def timestamp_millis(e):
    return _dt.MillisToTimestamp(_e(e))


def timestamp_micros(e):
    return _dt.MicrosToTimestamp(_e(e))


def to_date(e):
    return _dt.TsToDate(_e(e))


# nondeterministic, timezone, md5 and concat_ws (ops/misc.py)
def monotonically_increasing_id():
    return _misc.MonotonicallyIncreasingID()


def spark_partition_id():
    return _misc.SparkPartitionID()


def rand(seed: int = 0):
    return _misc.Rand(seed)


def md5(e):
    return _misc.Md5(_e(e))


def concat_ws(sep, *exprs):
    # the separator is a VALUE (PySpark signature), not a column name
    sep_expr = sep if isinstance(sep, Expression) else lit(sep)
    return _misc.ConcatWs(sep_expr, *[_e(x) for x in exprs])


def from_utc_timestamp(e, tz):
    return _misc.FromUTCTimestamp(_e(e), _lit(tz))


def to_utc_timestamp(e, tz):
    return _misc.ToUTCTimestamp(_e(e), _lit(tz))


# -- SQL front end hooks ------------------------------------------------------

def expr(sql_text: str) -> Expression:
    """Parse one SQL expression into an engine Expression (PySpark's
    F.expr): ``expr("l_extendedprice * (1.0 - l_discount)")``. Column
    references resolve when the expression lands in a plan node, as
    ``col()``'s do."""
    from spark_rapids_tpu_torch.sql.analyzer import Analyzer, Scope
    from spark_rapids_tpu_torch.sql.parser import parse_expression

    node = parse_expression(sql_text)
    analyzer = Analyzer(None, sql_text)

    class _AnyContains(list):
        def __contains__(self, item):
            return True

    class _OpenScope(Scope):
        """Unbound scope: any identifier resolves to an
        AttributeReference."""

        def __init__(self):
            pass

        @property
        def columns(self):
            return _AnyContains()

        aliases: dict = {}
        visible: list = []

    return analyzer.lower_expr(node, _OpenScope())


#: process-wide SQL-callable function registrations
_SQL_FUNCTIONS = {}


def register_sql_function(name: str, builder) -> None:
    """Make ``builder(*arg_exprs) -> Expression`` callable from SQL text
    under ``name`` in every session, e.g.
    ``register_sql_function("twice", lambda e: e * lit(2))``."""
    _SQL_FUNCTIONS[name.lower()] = builder


def unregister_sql_function(name: str) -> None:
    _SQL_FUNCTIONS.pop(name.lower(), None)


def registered_sql_function(name: str):
    return _SQL_FUNCTIONS.get(name.lower())


# -- collections, structs, maps and the higher-order functions -------------

def size(e):
    from spark_rapids_tpu_torch.ops.collections import Size
    return Size(_e(e))


def array(*exprs):
    from spark_rapids_tpu_torch.ops.collections import CreateArray
    return CreateArray(*[_e(x) for x in exprs])


def array_contains(e, value):
    from spark_rapids_tpu_torch.ops.collections import ArrayContains
    return ArrayContains(_e(e), _lit(value))


def array_min(e):
    from spark_rapids_tpu_torch.ops.collections import ArrayMin
    return ArrayMin(_e(e))


def array_max(e):
    from spark_rapids_tpu_torch.ops.collections import ArrayMax
    return ArrayMax(_e(e))


def sort_array(e, asc: bool = True):
    from spark_rapids_tpu_torch.ops.collections import SortArray
    return SortArray(_e(e), lit(asc))


def get_item(e, index):
    """arr[index], 0-based (null out of bounds); over a map, the value
    at key ``index``."""
    from spark_rapids_tpu_torch.ops.collections import GetArrayItem
    return GetArrayItem(_e(e), _lit(index))


#: the reference's ``element_at`` is its 0-based ``get_item``
element_at = get_item


def sequence(start, stop, step=None):
    from spark_rapids_tpu_torch.ops.collections import Sequence
    args = [_e(start), _e(stop)]
    if step is not None:
        args.append(_e(step))
    return Sequence(*args)


def explode(e):
    from spark_rapids_tpu_torch.ops.collections import Explode
    return Explode(_e(e))


def explode_outer(e):
    from spark_rapids_tpu_torch.ops.collections import ExplodeOuter
    return ExplodeOuter(_e(e))


def posexplode(e):
    from spark_rapids_tpu_torch.ops.collections import PosExplode
    return PosExplode(_e(e))


def posexplode_outer(e):
    from spark_rapids_tpu_torch.ops.collections import PosExplodeOuter
    return PosExplodeOuter(_e(e))


def struct(*exprs, names=None):
    from spark_rapids_tpu_torch.ops.expr import output_name
    from spark_rapids_tpu_torch.ops.nested import CreateNamedStruct
    es = [_e(x) for x in exprs]
    if names is None:
        names = [output_name(e, f"col{i}") for i, e in enumerate(es)]
    return CreateNamedStruct(names, es)


def named_struct(*name_expr_pairs):
    from spark_rapids_tpu_torch.ops.nested import CreateNamedStruct
    names = [name_expr_pairs[i] for i in range(0, len(name_expr_pairs), 2)]
    es = [_e(name_expr_pairs[i])
          for i in range(1, len(name_expr_pairs), 2)]
    return CreateNamedStruct(names, es)


def get_field(e, name: str):
    from spark_rapids_tpu_torch.ops.nested import GetStructField
    return GetStructField(_e(e), name)


def create_map(*exprs):
    from spark_rapids_tpu_torch.ops.nested import CreateMap
    return CreateMap(*[_e(x) for x in exprs])


def map_keys(e):
    from spark_rapids_tpu_torch.ops.nested import MapKeys
    return MapKeys(_e(e))


def map_values(e):
    from spark_rapids_tpu_torch.ops.nested import MapValues
    return MapValues(_e(e))


def map_entries(e):
    from spark_rapids_tpu_torch.ops.nested import MapEntries
    return MapEntries(_e(e))


def map_concat(*exprs):
    from spark_rapids_tpu_torch.ops.nested import MapConcat
    return MapConcat(*[_e(x) for x in exprs])


def get_map_value(m, key):
    from spark_rapids_tpu_torch.ops.nested import GetMapValue
    return GetMapValue(_e(m), _lit(key))


def _lambda_arity(fn) -> int:
    import builtins
    import inspect

    from spark_rapids_tpu_torch.ops.nested import LambdaFunction
    if isinstance(fn, LambdaFunction):
        return len(fn.var_names)
    return builtins.max(len(inspect.signature(fn).parameters), 1)


def _lambda(fn, n_vars: int):
    """A LambdaFunction from a Python callable, run once with symbolic
    variables named after its parameters."""
    import inspect

    from spark_rapids_tpu_torch.ops.nested import (
        LambdaFunction,
        NamedLambdaVariable,
    )
    if isinstance(fn, LambdaFunction):
        return fn
    names = list(inspect.signature(fn).parameters)[:n_vars] or \
        [f"x{i}" for i in range(n_vars)]
    body = fn(*[NamedLambdaVariable(n) for n in names])
    return LambdaFunction(_lit(body), names)


def transform(arr, fn):
    from spark_rapids_tpu_torch.ops.nested import ArrayTransform
    return ArrayTransform(_e(arr), _lambda(fn, 2 if _lambda_arity(fn) >= 2
                                           else 1))


def filter(arr, fn):  # noqa: A001
    from spark_rapids_tpu_torch.ops.nested import ArrayFilter
    return ArrayFilter(_e(arr), _lambda(fn, _lambda_arity(fn)))


#: the reference's name for ``filter``
filter_array = filter


def exists(arr, fn):
    from spark_rapids_tpu_torch.ops.nested import ArrayExists
    return ArrayExists(_e(arr), _lambda(fn, 1))


def forall(arr, fn):
    from spark_rapids_tpu_torch.ops.nested import ArrayForAll
    return ArrayForAll(_e(arr), _lambda(fn, 1))


def map_filter(m, fn):
    from spark_rapids_tpu_torch.ops.nested import MapFilter
    return MapFilter(_e(m), _lambda(fn, 2))


def transform_keys(m, fn):
    from spark_rapids_tpu_torch.ops.nested import TransformKeys
    return TransformKeys(_e(m), _lambda(fn, 2))


def transform_values(m, fn):
    from spark_rapids_tpu_torch.ops.nested import TransformValues
    return TransformValues(_e(m), _lambda(fn, 2))


def arrays_zip(*exprs):
    from spark_rapids_tpu_torch.ops.nested import ArraysZip
    return ArraysZip(*[_e(x) for x in exprs])


# -- JSON and UDFs -----------------------------------------------------------

def get_json_object(e, path):
    """get_json_object(json, path): the value at a '$'-rooted path
    (ops/json_fns.py)."""
    from spark_rapids_tpu_torch.ops.json_fns import GetJsonObject
    return GetJsonObject(_e(e), path if isinstance(path, Expression)
                         else lit(path))


def json_tuple(e, *fields):
    """json_tuple(json, 'f1', 'f2', ...): one top-level field extraction
    per name, aliased c0..cN."""
    from spark_rapids_tpu_torch.ops.json_fns import json_tuple as _jt
    return _jt(_e(e), *fields)


def from_json(e, schema):
    """from_json(col, schema) -> struct (PERMISSIVE mode)."""
    from spark_rapids_tpu_torch.ops.json_structs import JsonToStructs
    return JsonToStructs(_e(e), schema)


def to_json(e):
    """to_json(struct) -> string (the CPU route)."""
    from spark_rapids_tpu_torch.ops.json_structs import StructsToJson
    return StructsToJson(_e(e))


def udf(fn, return_type=None):
    """Compile a Python lambda or function into an expression builder; one
    that does not compile runs row by row on the CPU route (udf.py)."""
    from spark_rapids_tpu_torch.udf import udf as _udf
    return _udf(fn, return_type)


def columnar_udf(fn, return_type, *args):
    """A columnar UDF over the argument tensors, run on the device."""
    from spark_rapids_tpu_torch.udf import columnar_udf as _cu
    return _cu(fn, return_type, *args)


def pandas_udf(return_type, function_type: str = "scalar"):
    """The reference's pandas UDFs take pandas Series in and out over
    pyarrow, and neither package is on the card's machine: not ported."""
    raise NotImplementedError(
        "pandas UDFs (spark_rapids_tpu/plan/pandas_udf.py) need pandas and "
        "pyarrow, which the port does not use")
