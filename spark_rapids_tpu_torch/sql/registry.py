"""SQL function-name resolution (port of
``spark_rapids_tpu/sql/registry.py``).

Maps SQL call syntax onto the same expression classes the DataFrame API
builds (``spark_rapids_tpu_torch.functions``), so a SQL query and its DSL
form build identical expression trees. Lookup order in the analyzer:
global registrations (``functions.register_sql_function``) -> this
builtin table. Session-scoped functions (registered Python UDFs) and Hive
UDFs are not ported: registering either raises NotImplementedError
(``SessionCatalog.register_function``, ``register_hive_udf``).

The reference's builtin table holds more names than the port has
expressions for: each of those (``UNPORTED``) raises NotImplementedError
naming the function and the reference module its expression comes from.
A name in neither table is an undefined function (SqlAnalysisError)."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from spark_rapids_tpu_torch.ops.expr import Expression
from spark_rapids_tpu_torch.sql.errors import SqlAnalysisError

Builder = Callable[[List[Expression]], Expression]

_UNPORTED_BY_MODULE = {
    "ops/aggregates.py": (
        "collect_list", "collect_set", "percentile", "approx_percentile"),
    "ops/math.py": (
        "sqrt", "exp", "log", "ln", "log10", "log2", "pow", "power", "ceil",
        "ceiling", "floor", "round", "bround", "signum", "sign",
        "shiftleft", "shiftright"),
    "ops/strings.py": (
        "upper", "ucase", "lower", "lcase", "length", "char_length",
        "character_length", "bit_length", "octet_length", "ascii",
        "reverse", "initcap", "trim", "ltrim", "rtrim", "substring",
        "substr", "repeat", "replace", "lpad", "rpad", "substring_index",
        "translate", "concat", "contains", "startswith", "endswith",
        "instr", "locate", "regexp_replace", "regexp_extract"),
    "ops/misc.py": (
        "concat_ws", "from_utc_timestamp", "to_utc_timestamp", "md5",
        "monotonically_increasing_id", "spark_partition_id", "rand"),
    "ops/datetime.py": (
        "year", "month", "day", "dayofmonth", "dayofweek", "weekday",
        "dayofyear", "quarter", "last_day", "date_add", "date_sub",
        "datediff", "add_months", "hour", "minute", "second",
        "to_unix_timestamp", "unix_timestamp", "timestamp_seconds",
        "timestamp_millis", "timestamp_micros", "to_date"),
    "ops/hashfns.py": ("xxhash64",),
    "ops/collections.py": (
        "size", "cardinality", "array", "array_contains", "array_min",
        "array_max", "sort_array", "get_item", "element_at", "sequence",
        "explode", "explode_outer", "posexplode", "posexplode_outer"),
    "ops/nested.py": (
        "struct", "named_struct", "map_keys", "map_values", "map_entries"),
    "ops/json_structs.py": ("to_json",),
    "ops/window.py": ("percent_rank", "nth_value", "lag", "lead"),
}

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


def _build_table() -> Dict[str, Builder]:
    from spark_rapids_tpu_torch.ops import aggregates as _agg
    from spark_rapids_tpu_torch.ops import conditional as _cond
    from spark_rapids_tpu_torch.ops import predicates as _pred
    from spark_rapids_tpu_torch.ops import window as _win
    from spark_rapids_tpu_torch.ops.arithmetic import Abs
    from spark_rapids_tpu_torch.ops.hashfns import Murmur3Hash

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

    # arithmetic
    reg("abs", Abs, 1)

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

    # hash
    reg("hash", Murmur3Hash, 1, None)

    # ranking window functions; aggregates used with OVER come from the
    # aggregate entries above
    reg("row_number", _win.RowNumber, 0)
    reg("rank", _win.Rank, 0)
    reg("dense_rank", _win.DenseRank, 0)
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
    # 1. global registrations (functions.register_sql_function)
    from spark_rapids_tpu_torch import functions as F
    fn = F.registered_sql_function(key)
    if fn is not None:
        return lambda args: fn(*args)
    # 2. builtins
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
    resolve and registering one raises."""
    raise NotImplementedError(
        f"Hive UDF {name!r}: Hive UDFs (spark_rapids_tpu/hive_udf.py) are "
        "not ported to spark_rapids_tpu_torch yet")
