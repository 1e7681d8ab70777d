"""Expression base classes and the device evaluation walk (port of
``spark_rapids_tpu/ops/expr.py``).

Evaluation is two walks over a bound expression tree, as in the reference:
a host-side prep walk (``_walk_prep``, one :class:`NodePrep` per node in
post-order: string dictionaries) and a device walk (``_walk_eval``)
that consumes the preps in the same order. PyTorch runs eagerly, so there
is no trace cache: the device walk runs the tensor ops directly.

Every expression also evaluates on the host (``eval_cpu``, the
reference's Spark-exact CPU path over numpy); the CPU route
(overrides/rules.py, plan/nodes.py) runs it for operators tagged off the
device. Operators the port has not ported raise NotImplementedError
naming the operator, never a wrong answer.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import (
    DeviceColumn,
    DeviceTable,
    HostColumn,
    HostTable,
)
from spark_rapids_tpu_torch.errors import ColumnarProcessingError


class DevVal(NamedTuple):
    """An intermediate on the device: data tensor + validity (bool)."""

    data: torch.Tensor
    validity: torch.Tensor


@dataclass
class NodePrep:
    """Host-side per-batch preparation result for one expression node,
    with the device inputs its evaluation reads beside its children
    (``aux``: the reference's aux arrays, here tensors on the batch's
    device)."""

    out_dict: Optional[np.ndarray] = None  # dictionary if output is STRING
    dict_sorted: bool = True
    #: (min, max) of an integer column (DeviceColumn.domain) carried
    #: through the prep walk
    out_domain: Optional[Tuple[int, int]] = None
    #: a dictionary code found on the host (string == literal)
    lookup_code: Optional[int] = None
    #: the codes of IN's string literals in the value's dictionary
    lookup_codes: Optional[Tuple[int, ...]] = None
    #: device tensors the node reads (the hash's string bytes, by child)
    aux: Optional[dict] = None


class PrepCtx:
    """Context of the host prep walk over one table."""

    def __init__(self, table: DeviceTable):
        self.table = table


class EvalCtx:
    """Device-side context handed to eval_dev. ``live`` carries a masked
    batch's liveness (DeviceTable.live). With ``ansi`` (ANSI mode) the
    checks append ``(label, 0-d device bool)`` pairs to ``ansi_errors``
    for violations in live rows; ``eval_expr`` delivers them."""

    def __init__(self, cols: Sequence[DevVal], nrows: torch.Tensor,
                 capacity: int, device: torch.device, live=None,
                 ansi: bool = False):
        self.cols = tuple(cols)
        self.nrows = nrows
        self.capacity = capacity
        self.device = device
        self.live = live
        self.ansi = ansi
        self.ansi_errors: List[Tuple[str, torch.Tensor]] = []
        #: the branch-selection mask: inside a CASE WHEN or IF branch only
        #: the rows the branch selects may raise (Spark evaluates branches
        #: lazily; the walk evaluates every branch and guards the check)
        self.ansi_guard: Optional[torch.Tensor] = None
        self._prep_iter: Optional[Iterator[NodePrep]] = None

    def row_mask(self) -> torch.Tensor:
        """The live slots: ``live``, else the prefix ``[0, nrows)``."""
        if self.live is not None:
            return self.live
        return torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.nrows

    def ansi_check(self, label: str, bad: torch.Tensor) -> None:
        """Record an ANSI violation flag (True anywhere is an error) over
        ``bad``, which the caller masks to valid rows; this masks it to
        the live rows and the current branch guard."""
        if self.ansi_guard is not None:
            bad = bad & self.ansi_guard
        self.ansi_errors.append((label, (bad & self.row_mask()).any()))

    @contextlib.contextmanager
    def guarded(self, mask: torch.Tensor):
        """Scope ``ansi_check`` to the rows of ``mask`` (ANDed with an
        enclosing guard: nested conditionals)."""
        prev = self.ansi_guard
        self.ansi_guard = mask if prev is None else (prev & mask)
        try:
            yield
        finally:
            self.ansi_guard = prev

    def next_prep(self) -> NodePrep:
        return next(self._prep_iter)  # type: ignore[arg-type]


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to "
                              "spark_rapids_tpu_torch yet")


class Expression:
    """Base expression. Subclasses set ``children`` and implement
    ``data_type``, ``with_children`` and ``eval_dev``. Expressions are
    immutable; ``with_children`` rebuilds."""

    children: Tuple["Expression", ...] = ()

    @property
    def data_type(self) -> T.DataType:
        raise NotImplementedError(type(self).__name__)

    @property
    def name(self) -> str:
        return type(self).__name__

    @property
    def nullable(self) -> bool:
        """May the expression produce a null (the reference's derived
        contract: nullable when any child is, a leaf nullable unless it
        says otherwise)? A null-suppressing operator overrides the
        property; the plan verifier's PV-NULLABLE flags a plain class
        attribute that shadows it."""
        return any(c.nullable for c in self.children) \
            if self.children else True

    def with_children(self, children: Sequence["Expression"]) -> "Expression":
        raise NotImplementedError(type(self).__name__)

    def key(self) -> tuple:
        """A structural key: equal keys compute the same column (the SQL
        analyzer matches GROUP BY expressions to select items by it; the
        window rules compare specs by it). Every attribute beside the
        children is part of it."""
        attrs = tuple(sorted((k, repr(v)) for k, v in vars(self).items()
                             if k != "children"))
        return (type(self).__name__, attrs,
                tuple(c.key() for c in self.children))

    def __repr__(self):
        args = ", ".join(repr(c) for c in self.children)
        return f"{self.name}({args})"

    # --- binding -----------------------------------------------------------
    def bind(self, schema: Sequence[Tuple[str, T.DataType]]) -> "Expression":
        bound = [c.bind(schema) for c in self.children]
        return self.resolve(bound)

    def resolve(self, bound_children: Sequence["Expression"]) -> "Expression":
        """Hook for type checks and coercion; default rebuilds."""
        return self.with_children(bound_children)

    # --- CPU route (Spark-exact host evaluation) ----------------------------
    def eval_cpu(self, table: HostTable) -> HostColumn:
        raise NotImplementedError(f"{self.name}.eval_cpu")

    @property
    def device_supported(self) -> bool:
        """False for a form only the CPU route evaluates (the reference's
        ``device_supported``): overrides/rules.py tags its operator onto
        the route with the reason "configuration is not supported".
        Computed from the bound expression's own structure, so a rebuild
        by ``with_children`` keeps it."""
        return True

    # --- device path -------------------------------------------------------
    def prep(self, pctx: PrepCtx, child_preps: Sequence[NodePrep]) -> NodePrep:
        return NodePrep()

    def eval_dev(self, ctx: EvalCtx, child_vals: Sequence[DevVal],
                 prep: NodePrep) -> DevVal:
        _not_ported(f"{self.name} on the device")

    # --- operator sugar for the DataFrame API ------------------------------
    def _bin(self, opcls, other, reflect=False):
        other = other if isinstance(other, Expression) else Literal(other)
        return opcls(other, self) if reflect else opcls(self, other)

    def __add__(self, o):
        from spark_rapids_tpu_torch.ops.arithmetic import Add
        return self._bin(Add, o)

    def __radd__(self, o):
        from spark_rapids_tpu_torch.ops.arithmetic import Add
        return self._bin(Add, o, True)

    def __sub__(self, o):
        from spark_rapids_tpu_torch.ops.arithmetic import Subtract
        return self._bin(Subtract, o)

    def __rsub__(self, o):
        from spark_rapids_tpu_torch.ops.arithmetic import Subtract
        return self._bin(Subtract, o, True)

    def __mul__(self, o):
        from spark_rapids_tpu_torch.ops.arithmetic import Multiply
        return self._bin(Multiply, o)

    def __rmul__(self, o):
        from spark_rapids_tpu_torch.ops.arithmetic import Multiply
        return self._bin(Multiply, o, True)

    def __truediv__(self, o):
        from spark_rapids_tpu_torch.ops.arithmetic import Divide
        return self._bin(Divide, o)

    def __le__(self, o):
        from spark_rapids_tpu_torch.ops.predicates import LessThanOrEqual
        return self._bin(LessThanOrEqual, o)

    def __lt__(self, o):
        from spark_rapids_tpu_torch.ops.predicates import LessThan
        return self._bin(LessThan, o)

    def __gt__(self, o):
        from spark_rapids_tpu_torch.ops.predicates import GreaterThan
        return self._bin(GreaterThan, o)

    def __eq__(self, o):  # type: ignore[override]
        from spark_rapids_tpu_torch.ops.predicates import EqualTo
        return self._bin(EqualTo, o)

    def __ge__(self, o):
        from spark_rapids_tpu_torch.ops.predicates import GreaterThanOrEqual
        return self._bin(GreaterThanOrEqual, o)

    def __ne__(self, o):  # type: ignore[override]
        from spark_rapids_tpu_torch.ops.predicates import EqualTo, Not
        return Not(self._bin(EqualTo, o))

    def __and__(self, o):
        from spark_rapids_tpu_torch.ops.predicates import And
        return self._bin(And, o)

    def __or__(self, o):
        from spark_rapids_tpu_torch.ops.predicates import Or
        return self._bin(Or, o)

    def __invert__(self):
        from spark_rapids_tpu_torch.ops.predicates import Not
        return Not(self)

    def __mod__(self, o):
        from spark_rapids_tpu_torch.ops.arithmetic import Remainder
        return self._bin(Remainder, o)

    def __neg__(self):
        from spark_rapids_tpu_torch.ops.arithmetic import UnaryMinus
        return UnaryMinus(self)

    def alias(self, name: str) -> "Alias":
        return Alias(self, name)

    def cast(self, dtype) -> "Expression":
        from spark_rapids_tpu_torch.ops.cast import Cast
        if isinstance(dtype, str):
            dtype = T.parse_type(dtype)
        return Cast(self, dtype)

    def getField(self, name: str) -> "Expression":
        from spark_rapids_tpu_torch.ops.nested import GetStructField
        return GetStructField(self, name)

    def isnull(self):
        from spark_rapids_tpu_torch.ops.predicates import IsNull
        return IsNull(self)

    def isnotnull(self):
        from spark_rapids_tpu_torch.ops.predicates import IsNotNull
        return IsNotNull(self)


class AttributeReference(Expression):
    """Unresolved column-by-name (pre-binding)."""

    def __init__(self, col_name: str):
        self.col_name = col_name

    @property
    def name(self):
        return f"'{self.col_name}"

    @property
    def data_type(self):
        raise ColumnarProcessingError(f"unresolved attribute {self.col_name}")

    def bind(self, schema):
        for i, (n, dt) in enumerate(schema):
            if n == self.col_name:
                return BoundReference(i, dt, name_hint=self.col_name)
        raise ColumnarProcessingError(
            f"column {self.col_name!r} not in {[n for n, _ in schema]}")

    def __repr__(self):
        return f"col({self.col_name!r})"


class BoundReference(Expression):
    """Input column by ordinal (post-binding)."""

    def __init__(self, ordinal: int, dtype: T.DataType, name_hint: str = ""):
        self.ordinal = ordinal
        self._dtype = dtype
        self.name_hint = name_hint

    @property
    def data_type(self):
        return self._dtype

    def with_children(self, children):
        return self

    def prep(self, pctx: PrepCtx, child_preps) -> NodePrep:
        c = pctx.table.columns[self.ordinal]
        return NodePrep(out_dict=c.dictionary, dict_sorted=c.dict_sorted,
                        out_domain=c.domain)

    def eval_dev(self, ctx: EvalCtx, child_vals, prep) -> DevVal:
        return ctx.cols[self.ordinal]

    def __repr__(self):
        return f"#{self.ordinal}:{self._dtype}"

    def eval_cpu(self, table: HostTable) -> HostColumn:
        return table.columns[self.ordinal]


class Literal(Expression):
    def __init__(self, value, dtype: Optional[T.DataType] = None):
        self._dtype = dtype if dtype is not None else T.python_to_spark_type(value)
        # temporal literals hold the internal value (days, or UTC
        # microseconds; a naive datetime reads as UTC, as the reference's)
        import datetime as _dt
        if isinstance(value, _dt.datetime):
            epoch = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
            v = value if value.tzinfo is not None else \
                value.replace(tzinfo=_dt.timezone.utc)
            value = (v - epoch) // _dt.timedelta(microseconds=1)
        elif isinstance(value, _dt.date):
            value = (value - _dt.date(1970, 1, 1)).days
        self.value = value

    @property
    def data_type(self):
        return self._dtype

    @property
    def nullable(self):
        return self.value is None

    def with_children(self, children):
        return self

    def prep(self, pctx, child_preps) -> NodePrep:
        if isinstance(self._dtype, T.StringType):
            # a one-entry dictionary (empty for a null literal): code 0
            vals = [] if self.value is None else [self.value]
            return NodePrep(out_dict=np.array(vals, dtype=object))
        return NodePrep()

    def eval_dev(self, ctx: EvalCtx, child_vals, prep) -> DevVal:
        if not isinstance(self._dtype, (T.NumericType, T.DateType,
                                        T.TimestampType, T.BooleanType,
                                        T.StringType, T.NullType)) or (
                T.is_dec128(self._dtype) and self.value is not None):
            _not_ported(f"{self._dtype.simple_string()} literal")
        if self.value is None:
            from spark_rapids_tpu_torch.columnar.column import (
                null_data_array,
            )
            return DevVal(null_data_array(self._dtype, ctx.capacity,
                                          ctx.device),
                          torch.zeros(ctx.capacity, dtype=torch.bool,
                                      device=ctx.device))
        fill = self.value if self.value is not None else 0
        dtype = torch.int32
        if isinstance(self._dtype, T.StringType):
            fill = 0
        else:
            dtype = T.torch_dtype(self._dtype)
        data = torch.full((ctx.capacity,), fill, dtype=dtype,
                          device=ctx.device)
        validity = torch.full((ctx.capacity,), self.value is not None,
                              dtype=torch.bool, device=ctx.device)
        return DevVal(data, validity)

    def __repr__(self):
        return f"lit({self.value!r})"

    def eval_cpu(self, table: HostTable) -> HostColumn:
        n = table.num_rows
        validity = np.full(n, self.value is not None, dtype=np.bool_)
        if isinstance(self._dtype, T.StringType):
            data = np.full(n, self.value, dtype=object)
        else:
            fill = self.value if self.value is not None else 0
            data = np.full(n, fill, dtype=self._dtype.np_dtype)
        return HostColumn(self._dtype, data, validity)


class Alias(Expression):
    def __init__(self, child: Expression, out_name: str):
        self.children = (child,)
        self.out_name = out_name

    @property
    def data_type(self):
        return self.children[0].data_type

    @property
    def nullable(self):
        return self.children[0].nullable

    def with_children(self, children):
        return Alias(children[0], self.out_name)

    def prep(self, pctx, child_preps):
        return child_preps[0]

    def eval_dev(self, ctx, child_vals, prep):
        return child_vals[0]

    def __repr__(self):
        return f"{self.children[0]!r} AS {self.out_name}"

    def eval_cpu(self, table):
        return self.children[0].eval_cpu(table)


def col(name: str) -> AttributeReference:
    return AttributeReference(name)


def lit(value, dtype: Optional[T.DataType] = None) -> Literal:
    return Literal(value, dtype)


def output_name(expr: Expression, default: str) -> str:
    if isinstance(expr, Alias):
        return expr.out_name
    if isinstance(expr, AttributeReference):
        return expr.col_name
    if isinstance(expr, BoundReference) and expr.name_hint:
        return expr.name_hint
    return default


def bind(expr: Expression, schema: Sequence[Tuple[str, T.DataType]]) -> Expression:
    return expr.bind(schema)


# ---------------------------------------------------------------------------
# Evaluation walks
# ---------------------------------------------------------------------------

def _walk_prep(expr: Expression, pctx: PrepCtx, out: List[NodePrep]) -> NodePrep:
    child_preps = [_walk_prep(c, pctx, out) for c in expr.children]
    p = expr.prep(pctx, child_preps)
    out.append(p)
    return p


def _walk_eval(expr: Expression, ctx: EvalCtx) -> DevVal:
    walk = getattr(expr, "eval_walk", None)
    if walk is not None:
        # a conditional evaluates its own children (its branches under
        # ANSI guards), consuming the preps in the same post-order
        return walk(ctx)
    child_vals = [_walk_eval(c, ctx) for c in expr.children]
    p = ctx.next_prep()
    return expr.eval_dev(ctx, child_vals, p)


def table_vals(table: DeviceTable) -> Tuple[DevVal, ...]:
    return tuple(DevVal(c.data, c.validity) for c in table.columns)


def prep_expr(expr: Expression, pctx: PrepCtx) -> List[NodePrep]:
    """The host prep walk of ``expr``: one NodePrep per node, post-order."""
    preps: List[NodePrep] = []
    _walk_prep(expr, pctx, preps)
    return preps


def eval_expr(expr: Expression, preps: List[NodePrep], cols, nrows,
              capacity: int, device, live=None, guard=None) -> DevVal:
    """One device walk of ``expr`` over prepared ``preps``; in ANSI mode
    the walk's violation flags are delivered (``deliver_ansi_flags``),
    checked only on the rows of ``guard`` when one is given (a fused
    filter's survivors). Every device walk of the port runs through
    here."""
    from spark_rapids_tpu_torch.dispatch import ANSI_MODE
    ctx = EvalCtx(cols, nrows, capacity, device, live=live,
                  ansi=ANSI_MODE.get())
    ctx.ansi_guard = guard
    ctx._prep_iter = iter(preps)
    out = _walk_eval(expr, ctx)
    deliver_ansi_flags(ctx.ansi_errors)
    return out


def deliver_ansi_flags(errors: Sequence[Tuple[str, torch.Tensor]]) -> None:
    """Route a walk's ANSI flags: into the active speculation context,
    whose read of the result's row count carries them (no host sync of
    their own), or, with speculative sizing off, one immediate read of
    the walk's flags. With ANSI off there are none: nothing is read."""
    if not errors:
        return
    from spark_rapids_tpu_torch.runtime import speculation as spec
    ctx = spec.current()
    if ctx is not None:
        for label, flag in errors:
            ctx.add_flag(spec.ANSI_PREFIX + label, flag)
        return
    from spark_rapids_tpu_torch.dispatch import note_host_fetch
    note_host_fetch()
    vals = torch.stack([f for _, f in errors]).cpu().tolist()
    spec.check_flag_values([spec.ANSI_PREFIX + label for label, _ in errors],
                           vals)


def compile_project(exprs: Sequence[Expression],
                    table: DeviceTable) -> List[DeviceColumn]:
    """Evaluate bound expressions over a device table into device columns
    (the reference jits and caches this; eager torch just runs it)."""
    pctx = PrepCtx(table)
    all_preps = [prep_expr(e, pctx) for e in exprs]
    cols = table_vals(table)
    out = []
    for e, preps in zip(exprs, all_preps):
        dv = eval_expr(e, preps, cols, table.nrows_dev, table.capacity,
                       table.device, live=table.live)
        out.append(DeviceColumn(e.data_type, dv.data, dv.validity,
                                dictionary=preps[-1].out_dict,
                                dict_sorted=preps[-1].dict_sorted,
                                domain=preps[-1].out_domain))
    return out


def evaluate_cpu(exprs: Sequence[Expression], table: HostTable,
                 names: Optional[Sequence[str]] = None) -> HostTable:
    """A projection on the CPU route."""
    out_names = list(names) if names else [
        output_name(e, f"col{i}") for i, e in enumerate(exprs)]
    return HostTable(out_names, [e.eval_cpu(table) for e in exprs])
