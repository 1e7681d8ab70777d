"""Untyped SQL AST (parser output, analyzer input) (a copy of
``spark_rapids_tpu/sql/ast.py``).

Plain dataclasses: no engine types appear here — the analyzer owns the
mapping onto ops/ expressions and plan/ nodes. Every node carries the
1-based (line, col) of its first token so analysis errors can point into
the query text."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


@dataclass
class Node:
    line: int = 0
    col: int = 0


# -- expressions -------------------------------------------------------------

@dataclass
class Ident(Node):
    """Possibly-qualified column reference: parts = [col] or [tbl, col]."""
    parts: Tuple[str, ...] = ()


@dataclass
class Star(Node):
    """`*` or `tbl.*` (select list / count(*))."""
    qualifier: Optional[str] = None


@dataclass
class Literal(Node):
    value: object = None           # int/float/Decimal/str/bool/None


@dataclass
class TypedLiteral(Node):
    """DATE '...' / TIMESTAMP '...'."""
    kind: str = ""                 # "date" | "timestamp"
    text: str = ""


@dataclass
class IntervalLiteral(Node):
    """INTERVAL <n> <unit> [<n> <unit>...] folded to (months, days).
    Only consumed by date +/- interval (the engine has no standalone
    interval columns)."""
    months: int = 0
    days: int = 0


@dataclass
class BinOp(Node):
    op: str = ""                   # +,-,*,/,%,=,<>,<,<=,>,>=,AND,OR,||
    left: "Node" = None
    right: "Node" = None


@dataclass
class UnOp(Node):
    op: str = ""                   # -, NOT
    operand: "Node" = None


@dataclass
class IsNull(Node):
    operand: "Node" = None
    negated: bool = False


@dataclass
class InList(Node):
    operand: "Node" = None
    items: Sequence["Node"] = ()
    negated: bool = False


@dataclass
class InSubquery(Node):
    operand: "Node" = None
    query: "Query" = None
    negated: bool = False


@dataclass
class Between(Node):
    operand: "Node" = None
    low: "Node" = None
    high: "Node" = None
    negated: bool = False


@dataclass
class LikeOp(Node):
    kind: str = "like"             # like | rlike
    operand: "Node" = None
    pattern: "Node" = None
    negated: bool = False


@dataclass
class Cast(Node):
    operand: "Node" = None
    type_name: str = ""


@dataclass
class Case(Node):
    """CASE [operand] WHEN c THEN v ... [ELSE e] END."""
    operand: Optional["Node"] = None
    branches: Sequence[Tuple["Node", "Node"]] = ()
    else_value: Optional["Node"] = None


@dataclass
class FrameBound:
    """None = UNBOUNDED, 0 = CURRENT ROW, +/-n = FOLLOWING/PRECEDING."""
    value: Optional[int] = None


@dataclass
class WindowDef(Node):
    partition_by: Sequence["Node"] = ()
    order_by: Sequence["SortItem"] = ()
    frame: Optional[Tuple[str, Optional[int], Optional[int]]] = None


@dataclass
class FuncCall(Node):
    name: str = ""
    args: Sequence["Node"] = ()
    distinct: bool = False
    window: Optional[WindowDef] = None


@dataclass
class ScalarSubquery(Node):
    query: "Query" = None


# -- relations ---------------------------------------------------------------

@dataclass
class TableRef(Node):
    name: str = ""
    alias: Optional[str] = None


@dataclass
class SubqueryRef(Node):
    query: "Query" = None
    alias: Optional[str] = None


@dataclass
class JoinRel(Node):
    left: "Node" = None
    right: "Node" = None
    how: str = "inner"             # inner|left|right|full|cross
    on: Optional["Node"] = None
    using: Sequence[str] = ()


# -- query structure ---------------------------------------------------------

@dataclass
class SelectItem(Node):
    expr: "Node" = None
    alias: Optional[str] = None


@dataclass
class SortItem(Node):
    expr: "Node" = None
    ascending: bool = True
    nulls_first: Optional[int] = None   # None = Spark default


@dataclass
class Select(Node):
    distinct: bool = False
    hints: Sequence[Tuple[str, Sequence[str]]] = ()
    items: Sequence["Node"] = ()        # SelectItem | Star
    from_: Optional["Node"] = None      # TableRef | SubqueryRef | JoinRel
    where: Optional["Node"] = None
    group_by: Sequence["Node"] = ()
    having: Optional["Node"] = None


@dataclass
class SetOp(Node):
    op: str = "unionall"                # unionall | union
    left: "Node" = None
    right: "Node" = None


@dataclass
class Query(Node):
    ctes: Sequence[Tuple[str, "Query"]] = ()
    body: "Node" = None                 # Select | SetOp
    order_by: Sequence[SortItem] = ()
    limit: Optional[int] = None


@dataclass
class CreateView(Node):
    name: str = ""
    replace: bool = False
    query: Optional[Query] = None
    using: Optional[str] = None         # file format for USING variant
    options: dict = field(default_factory=dict)


@dataclass
class DropView(Node):
    name: str = ""
    if_exists: bool = False
