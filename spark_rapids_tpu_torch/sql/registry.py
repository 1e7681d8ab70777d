"""SQL function-name resolution (port of
``spark_rapids_tpu/sql/registry.py``).

Maps SQL call syntax onto the same expression classes the DataFrame API
builds (``spark_rapids_tpu_torch.functions``), so a SQL query and its DSL
form build identical expression trees. Lookup order in the analyzer:
the session's functions (``SessionCatalog.register_function``: a
compiled Python UDF, or a row-wise one the CPU route runs) -> global
registrations (``functions.register_sql_function``) -> this builtin
table. Hive UDFs are not ported: the reference's ``HiveSimpleUDF`` calls
pandas for each batch (``hive_udf.py``), and pandas is not on the card's
machine, so ``register_hive_udf`` raises naming pandas.

Every builtin of the reference's table resolves (``UNPORTED`` is empty);
``to_json`` and ``map_entries`` run on the CPU route. SQL has no lambda
syntax in either package, so the higher-order functions are DSL-only. A
name in no table is an undefined function (SqlAnalysisError)."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from spark_rapids_tpu_torch.ops.expr import Expression, Literal, lit
from spark_rapids_tpu_torch.sql.errors import SqlAnalysisError

Builder = Callable[[List[Expression]], Expression]

_UNPORTED_BY_MODULE: Dict[str, tuple] = {}

#: builtin function names of the reference whose expressions the port
#: lacks -> the reference module that defines them
UNPORTED: Dict[str, str] = {
    name: module for module, names in _UNPORTED_BY_MODULE.items()
    for name in names}


def _need(args: Sequence, lo: int, hi: Optional[int], name: str) -> None:
    hi_txt = "+" if hi is None else (f"-{hi}" if hi != lo else "")
    if len(args) < lo or (hi is not None and len(args) > hi):
        raise SqlAnalysisError(
            f"function {name} expects {lo}{hi_txt} argument(s), "
            f"got {len(args)}")


def _lit_value(e: Expression, name: str, what: str):
    """Unwrap a literal argument (a seed: a parameter its builder takes as
    a plain Python value)."""
    if not isinstance(e, Literal):
        raise SqlAnalysisError(f"function {name}: {what} must be a literal")
    return e.value


def _build_table() -> Dict[str, Builder]:
    from spark_rapids_tpu_torch.ops import aggregates as _agg
    from spark_rapids_tpu_torch.ops import conditional as _cond
    from spark_rapids_tpu_torch.ops import predicates as _pred
    from spark_rapids_tpu_torch.ops import datetime as _dt
    from spark_rapids_tpu_torch.ops import math as _math
    from spark_rapids_tpu_torch.ops import misc as _misc
    from spark_rapids_tpu_torch.ops import strings as _str
    from spark_rapids_tpu_torch.ops import window as _win
    from spark_rapids_tpu_torch.ops.arithmetic import Abs
    from spark_rapids_tpu_torch.ops.hashfns import Murmur3Hash, XxHash64

    table: Dict[str, Builder] = {}

    def reg(names, fn, lo, hi=-1):
        """hi: -1 = exactly lo, None = unbounded."""
        high = lo if hi == -1 else hi
        if isinstance(names, str):
            names = (names,)

        def build(args, _name=names[0], _fn=fn, _lo=lo, _hi=high):
            _need(args, _lo, _hi, _name)
            return _fn(*args)
        for n in names:
            table[n] = build

    # aggregates (the execs' tagging raises per instance as for the DSL)
    reg("sum", _agg.Sum, 1)
    reg("min", _agg.Min, 1)
    reg("max", _agg.Max, 1)
    reg(("avg", "mean"), _agg.Average, 1)
    reg("count", lambda e: _agg.Count(e), 1)
    reg(("stddev", "stddev_samp", "std"), _agg.StddevSamp, 1)
    reg("stddev_pop", _agg.StddevPop, 1)
    reg(("variance", "var_samp"), _agg.VarianceSamp, 1)
    reg("var_pop", _agg.VariancePop, 1)
    reg("first", lambda e: _agg.First(e, False), 1)
    reg("last", lambda e: _agg.Last(e, False), 1)
    reg("collect_list", _agg.CollectList, 1)
    reg("collect_set", _agg.CollectSet, 1)
    table["percentile"] = lambda args: (
        _need(args, 2, 2, "percentile") or
        _agg.Percentile(args[0],
                        _lit_value(args[1], "percentile", "percentage")))
    table["approx_percentile"] = lambda args: (
        _need(args, 2, 3, "approx_percentile") or
        _agg.Percentile(args[0], _lit_value(args[1], "approx_percentile",
                                            "percentage")))

    # collections, structs and maps
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.ops import collections as _coll
    from spark_rapids_tpu_torch.ops import nested as _nested
    reg(("size", "cardinality"), _coll.Size, 1)
    reg("array", _coll.CreateArray, 1, None)
    reg("array_contains", _coll.ArrayContains, 2)
    reg("array_min", _coll.ArrayMin, 1)
    reg("array_max", _coll.ArrayMax, 1)
    reg("sort_array", lambda e, a=None:
        _coll.SortArray(e, a or lit(True)), 1, 2)
    reg(("get_item", "element_at"), _coll.GetArrayItem, 2)
    reg("sequence", _coll.Sequence, 2, 3)
    reg("explode", _coll.Explode, 1)
    reg("explode_outer", _coll.ExplodeOuter, 1)
    reg("posexplode", _coll.PosExplode, 1)
    reg("posexplode_outer", _coll.PosExplodeOuter, 1)
    table["struct"] = lambda args: F.struct(*args)
    reg("named_struct", lambda *a: F.named_struct(
        *[x.value if isinstance(x, Literal) and i % 2 == 0 else x
          for i, x in enumerate(a)]), 2, None)
    reg("map_keys", _nested.MapKeys, 1)
    reg("map_values", _nested.MapValues, 1)
    reg("map_entries", _nested.MapEntries, 1)
    from spark_rapids_tpu_torch.ops.json_structs import StructsToJson
    reg("to_json", StructsToJson, 1)

    # math
    reg("sqrt", _math.Sqrt, 1)
    reg("exp", _math.Exp, 1)
    reg(("log", "ln"), _math.Log, 1)
    reg("log10", _math.Log10, 1)
    reg("log2", _math.Log2, 1)
    reg(("pow", "power"), _math.Pow, 2)
    reg("abs", Abs, 1)
    reg(("ceil", "ceiling"), _math.Ceil, 1)
    reg("floor", _math.Floor, 1)
    reg("round", lambda e, s=None: _math.Round(e, s or lit(0)), 1, 2)
    reg("bround", lambda e, s=None: _math.BRound(e, s or lit(0)), 1, 2)
    reg(("signum", "sign"), _math.Signum, 1)
    reg("shiftleft", _math.ShiftLeft, 2)
    reg("shiftright", _math.ShiftRight, 2)

    # strings
    reg(("upper", "ucase"), _str.Upper, 1)
    reg(("lower", "lcase"), _str.Lower, 1)
    reg(("length", "char_length", "character_length"), _str.Length, 1)
    reg("bit_length", _str.BitLength, 1)
    reg("octet_length", _str.OctetLength, 1)
    reg("ascii", _str.Ascii, 1)
    reg("reverse", _str.Reverse, 1)
    reg("initcap", _str.InitCap, 1)
    reg("trim", _str.StringTrim, 1)
    reg("ltrim", _str.StringTrimLeft, 1)
    reg("rtrim", _str.StringTrimRight, 1)
    reg(("substring", "substr"), _str.Substring, 3)
    reg("repeat", _str.StringRepeat, 2)
    reg("replace", lambda e, s, r=None:
        _str.StringReplace(e, s, r or lit("")), 2, 3)
    reg("lpad", lambda e, n, p=None:
        _str.StringLPad(e, n, p or lit(" ")), 2, 3)
    reg("rpad", lambda e, n, p=None:
        _str.StringRPad(e, n, p or lit(" ")), 2, 3)
    reg("substring_index", _str.SubstringIndex, 3)
    reg("translate", _str.StringTranslate, 3)
    reg("concat", _str.Concat, 1, None)
    reg("contains", _str.Contains, 2)
    reg("startswith", _str.StartsWith, 2)
    reg("endswith", _str.EndsWith, 2)
    reg("instr", _str.StringInstr, 2)
    reg("locate", lambda s, e, p=None:
        _str.StringLocate(s, e, p or lit(1)), 2, 3)
    reg("regexp_replace", _str.RegExpReplace, 3)
    reg("regexp_extract", lambda e, p, i=None:
        _str.RegExpExtract(e, p, i or lit(1)), 2, 3)
    reg("concat_ws", _misc.ConcatWs, 1, None)

    # datetime
    reg("year", _dt.Year, 1)
    reg("month", _dt.Month, 1)
    reg(("day", "dayofmonth"), _dt.DayOfMonth, 1)
    reg("dayofweek", _dt.DayOfWeek, 1)
    reg("weekday", _dt.WeekDay, 1)
    reg("dayofyear", _dt.DayOfYear, 1)
    reg("quarter", _dt.Quarter, 1)
    reg("last_day", _dt.LastDay, 1)
    reg("date_add", _dt.DateAdd, 2)
    reg("date_sub", _dt.DateSub, 2)
    reg("datediff", _dt.DateDiff, 2)
    reg("add_months", _dt.AddMonths, 2)
    reg("hour", _dt.Hour, 1)
    reg("minute", _dt.Minute, 1)
    reg("second", _dt.Second, 1)
    reg(("to_unix_timestamp", "unix_timestamp"),
        _dt.UnixTimestampFromTs, 1)
    reg("timestamp_seconds", _dt.SecondsToTimestamp, 1)
    reg("timestamp_millis", _dt.MillisToTimestamp, 1)
    reg("timestamp_micros", _dt.MicrosToTimestamp, 1)
    reg("to_date", _dt.TsToDate, 1)
    reg("from_utc_timestamp", _misc.FromUTCTimestamp, 2)
    reg("to_utc_timestamp", _misc.ToUTCTimestamp, 2)

    # conditionals / null handling
    reg("coalesce", _cond.Coalesce, 1, None)
    reg(("nvl", "ifnull"), _cond.Coalesce, 2)
    reg("greatest", _cond.Greatest, 2, None)
    reg("least", _cond.Least, 2, None)
    reg("nanvl", _cond.NaNvl, 2)
    reg("if", _cond.If, 3)
    reg("isnull", _pred.IsNull, 1)
    reg("isnotnull", _pred.IsNotNull, 1)
    reg("isnan", _pred.IsNaN, 1)

    # hash / misc
    reg("hash", Murmur3Hash, 1, None)
    reg("xxhash64", XxHash64, 1, None)
    reg("md5", _misc.Md5, 1)
    reg("monotonically_increasing_id", _misc.MonotonicallyIncreasingID, 0)
    reg("spark_partition_id", _misc.SparkPartitionID, 0)
    reg("rand", lambda seed=None: _misc.Rand(
        0 if seed is None else _lit_value(seed, "rand", "seed")), 0, 1)

    # window functions (the rank family, offsets); aggregates used with
    # OVER come from the aggregate entries above
    reg("row_number", _win.RowNumber, 0)
    reg("rank", _win.Rank, 0)
    reg("dense_rank", _win.DenseRank, 0)
    # input-file provenance (ops/inputfile.py; the reference has them in
    # functions.py only)
    from spark_rapids_tpu_torch.ops import inputfile as _inf
    reg("input_file_name", _inf.InputFileName, 0)
    reg("input_file_block_start", _inf.InputFileBlockStart, 0)
    reg("input_file_block_length", _inf.InputFileBlockLength, 0)

    reg("percent_rank", _win.PercentRank, 0)
    table["nth_value"] = lambda args: (
        _need(args, 2, 2, "nth_value") or
        _win.NthValue(args[0], _lit_value(args[1], "nth_value", "n")))

    def _offset_fn(cls, name):
        def build(args):
            _need(args, 1, 3, name)
            off = (_lit_value(args[1], name, "offset")
                   if len(args) > 1 else 1)
            default = (_lit_value(args[2], name, "default")
                       if len(args) > 2 else None)
            return cls(args[0], off, default)
        return build

    table["lag"] = _offset_fn(_win.Lag, "lag")
    table["lead"] = _offset_fn(_win.Lead, "lead")
    return table


_BUILTINS: Optional[Dict[str, Builder]] = None


def builtin(name: str) -> Optional[Builder]:
    global _BUILTINS
    if _BUILTINS is None:
        _BUILTINS = _build_table()
    return _BUILTINS.get(name.lower())


def lookup(name: str, session=None) -> Optional[Callable]:
    """Resolve a SQL function name. Returns a callable taking a list of
    lowered Expression args, or None when nothing matches. A builtin of
    the reference that the port lacks raises NotImplementedError."""
    key = name.lower()
    # 1. the session's functions (registered Python UDFs)
    cat = getattr(session, "_catalog", None) if session is not None \
        else None
    if cat is not None:
        fn = cat.lookup_function(key)
        if fn is not None:
            return lambda args: fn(*args)
    # 2. global registrations (functions.register_sql_function)
    from spark_rapids_tpu_torch import functions as F
    fn = F.registered_sql_function(key)
    if fn is not None:
        return lambda args: fn(*args)
    # 3. builtins
    b = builtin(key)
    if b is not None:
        return b
    if key in UNPORTED:
        raise NotImplementedError(
            f"SQL function {key} (spark_rapids_tpu/{UNPORTED[key]}) is not "
            "ported to spark_rapids_tpu_torch yet")
    return None


def register_hive_udf(name: str, fn, return_type, generic: bool = False):
    """The reference's Hive UDF registration (``hive_udf.py``), which its
    lookup consults after the builtins: not ported, so no Hive UDF can
    resolve and registering one raises. Its ``HiveSimpleUDF`` is a pandas
    UDF (``HiveUDFExpr(PandasUDFExpr)``, pandas imported for each batch),
    and pandas is not on the card's machine."""
    raise NotImplementedError(
        f"Hive UDF {name!r}: Hive UDFs (spark_rapids_tpu/hive_udf.py) call "
        "pandas for each batch, and pandas UDFs are not ported to "
        "spark_rapids_tpu_torch")
