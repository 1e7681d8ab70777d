"""UDF compiler: Python lambdas and functions -> expression trees (port of
``spark_rapids_tpu/udf.py``).

The reference's udf-compiler decompiles JVM bytecode of simple Scala/Java
UDFs into Catalyst expressions so they run on the GPU instead of row at a
time. The Python analog reads the function's SOURCE AST and translates
the supported subset into this package's expressions, so a compiled UDF
runs on the device like the built-ins:

  arithmetic  + - * / % **        (% maps to Pmod: Python's sign rule)
  comparisons == != < <= > >=     (chained comparisons fold with AND)
  boolean     and or not
  conditional x if c else y
  builtins    abs len round
  str methods .upper .lower .strip .startswith .endswith

Anything else (loops, closures over mutable state, unsupported calls)
becomes a row-wise ``PythonUDF`` with a RuntimeWarning, which only the CPU
route evaluates (``device_supported`` False: the plan's tag sends its
operator there and reports it): compiled when possible, never silently
wrong. ``ColumnarDeviceUDF`` is a user function over the argument
tensors, evaluated on the device inside the projection.

Null semantics note (documented divergence from running the Python row by
row): compiled UDFs follow the SQL three-valued semantics of the
translated expressions — arithmetic/comparisons null-propagate, a null
``if`` condition selects the else branch — instead of passing None into
Python code; constructs whose SQL translation would silently diverge
(min/max vs null-skipping Least/Greatest) are rejected to the fallback.
"""

from __future__ import annotations

import ast
import inspect
import textwrap
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.ops.expr import DevVal, Expression, Literal, lit


class UdfCompileError(Exception):
    pass


class PythonUDF(Expression):
    """The row-wise Python call of a UDF that does not compile: the CPU
    route evaluates it (the reference's un-compiled UDF path)."""

    def __init__(self, fn: Callable, return_type: T.DataType,
                 children: Sequence[Expression], name: str = ""):
        self.fn = fn
        self._return_type = return_type
        self.children = tuple(children)
        self._name = name or getattr(fn, "__name__", "udf")

    @property
    def data_type(self):
        return self._return_type

    def key(self):
        return ("pythonudf", id(self.fn), str(self._return_type),
                tuple(c.key() for c in self.children))

    @property
    def name(self):
        return "PythonUDF"

    def with_children(self, children):
        return PythonUDF(self.fn, self._return_type, children, self._name)

    device_supported = False

    def eval_cpu(self, table: HostTable) -> HostColumn:
        kids = [c.eval_cpu(table) for c in self.children]
        n = table.num_rows
        is_str = isinstance(self._return_type, T.StringType)
        out = (np.empty(n, dtype=object) if is_str
               else np.zeros(n, dtype=self._return_type.np_dtype))
        validity = np.zeros(n, dtype=np.bool_)
        for i in range(n):
            if all(k.validity[i] for k in kids):
                v = self.fn(*[
                    k.data[i].item() if hasattr(k.data[i], "item")
                    else k.data[i] for k in kids])
                if v is not None:
                    out[i] = v
                    validity[i] = True
        return HostColumn(self._return_type, out, validity)

    def __repr__(self):
        return f"{self._name}({', '.join(map(repr, self.children))})"


def _extract_body(fn: Callable):
    """(param names, body AST) of a lambda or single-return function."""
    try:
        source = textwrap.dedent(inspect.getsource(fn)).strip()
    except (OSError, TypeError) as e:
        raise UdfCompileError(f"source unavailable: {e}")
    try:
        tree = ast.parse(source)
    except SyntaxError:
        # a lambda embedded in a larger expression (e.g. a call argument)
        # may not parse standalone; find it inside a wrapping parse
        try:
            tree = ast.parse(f"_x_ = {source}")
        except SyntaxError as e:
            raise UdfCompileError(f"unparseable source: {e}")

    lambdas = [n for n in ast.walk(tree) if isinstance(n, ast.Lambda)]
    funcs = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]
    if fn.__name__ == "<lambda>":
        if len(lambdas) != 1:
            raise UdfCompileError(
                "could not uniquely locate the lambda in its source line")
        node = lambdas[0]
        params = [a.arg for a in node.args.args]
        return params, node.body
    if not funcs:
        raise UdfCompileError("no function definition found in source")
    node = funcs[0]
    body = [s for s in node.body
            if not isinstance(s, (ast.Expr,))]  # skip docstrings
    if len(body) != 1 or not isinstance(body[0], ast.Return) \
            or body[0].value is None:
        raise UdfCompileError(
            "only single-expression functions (one return statement) "
            "compile; everything else falls back to the row-wise path")
    params = [a.arg for a in node.args.args]
    return params, body[0].value


_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.Div: lambda a, b: a / b,
}

_CMPOPS = {
    ast.Eq: lambda a, b: a == b,
    ast.NotEq: lambda a, b: a != b,
    ast.Lt: lambda a, b: a < b,
    ast.LtE: lambda a, b: a <= b,
    ast.Gt: lambda a, b: a > b,
    ast.GtE: lambda a, b: a >= b,
}


def _translate(node: ast.AST, env: dict) -> Expression:
    from spark_rapids_tpu_torch.ops.arithmetic import Abs, Pmod
    from spark_rapids_tpu_torch.ops.conditional import If
    from spark_rapids_tpu_torch.ops.math import BRound, Pow
    from spark_rapids_tpu_torch.ops.predicates import Not
    from spark_rapids_tpu_torch.ops.strings import (
        EndsWith,
        Length,
        Lower,
        StartsWith,
        StringTrim,
        Upper,
    )

    def rec(n):
        return _translate(n, env)

    if isinstance(node, ast.Constant):
        if node.value is None or isinstance(node.value, (bool, int, float,
                                                         str)):
            return lit(node.value)
        raise UdfCompileError(f"unsupported constant {node.value!r}")
    if isinstance(node, ast.Name):
        if node.id in env:
            return env[node.id]
        raise UdfCompileError(f"free variable {node.id!r} "
                              "(closures don't compile)")
    if isinstance(node, ast.BinOp):
        op = type(node.op)
        if op in _BINOPS:
            return _BINOPS[op](rec(node.left), rec(node.right))
        if op is ast.Mod:
            # Python % sign rule == Spark pmod
            return Pmod(rec(node.left), rec(node.right))
        if op is ast.Pow:
            return Pow(rec(node.left), rec(node.right))
        raise UdfCompileError(f"operator {op.__name__} does not compile")
    if isinstance(node, ast.UnaryOp):
        if isinstance(node.op, ast.USub):
            return -rec(node.operand)
        if isinstance(node.op, ast.Not):
            return Not(rec(node.operand))
        raise UdfCompileError("unsupported unary operator")
    if isinstance(node, ast.Compare):
        left = node.left
        parts = []
        for op, comp in zip(node.ops, node.comparators):
            if type(op) not in _CMPOPS:
                raise UdfCompileError(
                    f"comparison {type(op).__name__} does not compile")
            parts.append(_CMPOPS[type(op)](rec(left), rec(comp)))
            left = comp
        out = parts[0]
        for p in parts[1:]:
            out = out & p
        return out
    if isinstance(node, ast.BoolOp):
        vals = [rec(v) for v in node.values]
        out = vals[0]
        for v in vals[1:]:
            out = (out & v) if isinstance(node.op, ast.And) else (out | v)
        return out
    if isinstance(node, ast.IfExp):
        return If(rec(node.test), rec(node.body), rec(node.orelse))
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name):
            fname = node.func.id
            args = [rec(a) for a in node.args]
            if fname == "abs" and len(args) == 1:
                return Abs(args[0])
            if fname == "len" and len(args) == 1:
                return Length(args[0])
            if fname in ("min", "max"):
                # SQL Least/Greatest SKIP nulls while Python min/max (and
                # the row-wise fallback) would not — reject rather than
                # compile to divergent semantics (the reference's rule:
                # compile only when exactly equivalent)
                raise UdfCompileError(
                    f"{fname}() null semantics differ from SQL "
                    "Least/Greatest; use F.least/F.greatest explicitly")
            if fname == "round" and len(args) in (1, 2):
                scale = args[1] if len(args) == 2 else lit(0)
                if not isinstance(scale, Literal):
                    raise UdfCompileError("round scale must be constant")
                # Python round is banker's; Spark round is HALF_UP --
                # BRound matches Python
                return BRound(args[0], scale)
            raise UdfCompileError(f"call to {fname}() does not compile")
        if isinstance(node.func, ast.Attribute):
            target = rec(node.func.value)
            m = node.func.attr
            args = [rec(a) for a in node.args]
            if m == "upper" and not args:
                return Upper(target)
            if m == "lower" and not args:
                return Lower(target)
            if m == "strip" and not args:
                return StringTrim(target)
            if m == "startswith" and len(args) == 1:
                return StartsWith(target, args[0])
            if m == "endswith" and len(args) == 1:
                return EndsWith(target, args[0])
            raise UdfCompileError(f".{m}() does not compile")
    raise UdfCompileError(f"AST node {type(node).__name__} does not compile")


class udf:
    """Decorator/factory: ``F.udf(lambda x: x * 2 + 1)`` returns a callable
    producing an ENGINE EXPRESSION when the body compiles, else a row-wise
    PythonUDF fallback (return_type then required)."""

    def __init__(self, fn: Callable, return_type: Optional[T.DataType] = None):
        self.fn = fn
        self.return_type = return_type
        self._params = None
        self._body = None
        self._reason = None
        try:
            self._params, self._body = _extract_body(fn)
        except UdfCompileError as e:
            self._reason = str(e)

    @property
    def compiled(self) -> bool:
        return self._body is not None

    def __call__(self, *cols) -> Expression:
        args = [c if isinstance(c, Expression) else lit(c) for c in cols]
        if self._body is not None:
            if len(args) != len(self._params):
                raise TypeError(
                    f"udf takes {len(self._params)} args, got {len(args)}")
            try:
                return _translate(self._body, dict(zip(self._params, args)))
            except UdfCompileError as e:
                self._reason = str(e)
        if self.return_type is None:
            raise UdfCompileError(
                f"UDF does not compile ({self._reason}) and no return_type "
                "was given for the row-wise fallback")
        warnings.warn(
            f"UDF {getattr(self.fn, '__name__', '<lambda>')} does not "
            f"compile to engine expressions ({self._reason}); falling back "
            "to row-wise CPU execution", RuntimeWarning, stacklevel=2)
        return PythonUDF(self.fn, self.return_type, args)


# ---------------------------------------------------------------------------
# Columnar device UDF (RapidsUDF analog)
# ---------------------------------------------------------------------------

class ColumnarDeviceUDF(Expression):
    """A user-implemented COLUMNAR UDF run on the device inside the
    projection (the reference's RapidsUDF ``evaluateColumnar``).

    The user function receives one tensor per argument (and a bool
    validity tensor per argument) and returns (data, validity) tensors of
    the same length. On the CPU route it gets host tensors over the
    numpy columns. Example::

        def clamp(args, valids):
            (x,), (xv,) = args, valids
            return torch.clamp(x, 0.0, 1.0), xv

        df.select(columnar_udf(clamp, T.DOUBLE, col("v")).alias("c"))
    """

    def __init__(self, fn: Callable, return_type: T.DataType,
                 children: Sequence[Expression], name: str = ""):
        self.fn = fn
        self._return_type = return_type
        self.children = tuple(children)
        self._name = name or getattr(fn, "__name__", "columnar_udf")

    @property
    def data_type(self):
        return self._return_type

    @property
    def name(self):
        return self._name

    def with_children(self, children):
        return ColumnarDeviceUDF(self.fn, self._return_type, children,
                                 self._name)

    def resolve(self, bound_children):
        for c in bound_children:
            if isinstance(c.data_type, T.StringType):
                raise UdfCompileError(
                    "columnar device UDFs cannot take string arguments "
                    "(strings are dictionary codes on device; use the "
                    "row-wise udf() fallback or built-in string functions)")
        return self.with_children(bound_children)

    def key(self):
        # the user function's CODE identifies it: logically identical
        # lambdas recreated per query key alike (the plan fingerprint
        # and the executable cache read the key). Closure VALUES are not
        # in the key: a UDF whose behavior depends on captured mutable
        # state would alias; capture constants only.
        code = getattr(self.fn, "__code__", None)
        fid = (code.co_filename, code.co_firstlineno,
               hash(code.co_code)) if code is not None else id(self.fn)
        return ("columnar_udf", fid, str(self._return_type),
                tuple(c.key() for c in self.children))

    def eval_cpu(self, table):
        cols = [c.eval_cpu(table) for c in self.children]
        data, validity = self.fn(
            tuple(torch.from_numpy(np.asarray(c.data)) for c in cols),
            tuple(torch.from_numpy(np.asarray(c.validity)) for c in cols))
        return HostColumn(self._return_type,
                          data.numpy().astype(self._return_type.np_dtype),
                          validity.numpy().astype(np.bool_))

    def eval_dev(self, ctx, child_vals, prep):
        data, validity = self.fn(
            tuple(v.data for v in child_vals),
            tuple(v.validity for v in child_vals))
        return DevVal(data, validity)


def columnar_udf(fn: Callable, return_type: T.DataType, *args):
    """Factory for ColumnarDeviceUDF (fixed-width return types only —
    string outputs would need an unbounded dictionary)."""
    from spark_rapids_tpu_torch.ops.expr import col as _col
    if isinstance(return_type, T.StringType):
        raise UdfCompileError(
            "columnar device UDFs must return fixed-width types")
    exprs = [_col(a) if isinstance(a, str) else a for a in args]
    return ColumnarDeviceUDF(fn, return_type, exprs)
