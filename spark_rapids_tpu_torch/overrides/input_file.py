"""Plan rewrite for the input_file_name() expression family (port of
``spark_rapids_tpu/overrides/input_file.py``; reference:
InputFileBlockRule.scala).

The reference plugin keeps each chain from the first input_file_xxx
expression down to its file scan on one side, so the expressions see the
scan's per-batch file context. This engine owns its logical plans, so the
scan ATTACHES per-row provenance columns and the expressions become bound
references to them; any plan shape above keeps working, since the
provenance is ordinary column data from then on.

- Copy-on-write: plan nodes are shared across DataFrames, so the rewrite
  never mutates an input node; every node it changes is a shallow copy
  with its own expression and children containers.
- A chain qualifies when the expression's node reaches a FileScanNode
  through Project, Filter, Limit and Sample nodes only (no exchange,
  aggregate or join between: Spark defines the expressions only within
  the scan's stage).
- Intermediate Projects gain pass-through references bottom-up, so each
  sees its child's widened schema.
- The hidden columns never escape the rewritten region: a
  schema-transparent holder (Filter, Limit, Sort) is wrapped in a dropping
  Project restoring its schema, so expressions bound above it keep their
  ordinals.
- An expression that does not qualify stays in place and evaluates to
  Spark's "no file information" constants (ops/inputfile.py).
"""

from __future__ import annotations

import copy

from spark_rapids_tpu_torch.ops.expr import BoundReference
from spark_rapids_tpu_torch.ops.inputfile import (
    FILE_INFO_COLS,
    contains_input_file_expr,
    substitute,
)
from spark_rapids_tpu_torch.plan import nodes as P

#: single-child, provenance-transparent nodes the chain may cross
_PASSTHROUGH = ("Filter", "Limit", "Sample", "Project")

#: plain expression-list attrs
_LIST_ATTRS = ("exprs", "grouping")


def _node_exprs(node):
    """Every expression a node holds, flat (for detection)."""
    out = []
    for attr in _LIST_ATTRS:
        out.extend(getattr(node, attr, ()) or ())
    cond = getattr(node, "condition", None)
    if cond is not None:
        out.append(cond)
    for _, fn in getattr(node, "agg_specs", ()) or ():
        out.append(fn)
    for o in getattr(node, "orders", ()) or ():
        out.append(o.expr)
    for _, w in getattr(node, "window_cols", ()) or ():
        out.append(w)
    return out


def _node_has_input_file(node) -> bool:
    return any(contains_input_file_expr(e) for e in _node_exprs(node))


def _shallow(node):
    """Copy a node so its expression/children containers are private."""
    n2 = copy.copy(node)
    for attr in ("exprs", "names", "grouping", "agg_specs", "orders",
                 "window_cols"):
        v = getattr(n2, attr, None)
        if isinstance(v, list):
            setattr(n2, attr, list(v))
    return n2


def _substitute_all(node, schema):
    """Substitute input_file_* in every expression container of a COPY."""
    for attr in _LIST_ATTRS:
        v = getattr(node, attr, None)
        if v:
            setattr(node, attr, [substitute(e, schema) for e in v])
    cond = getattr(node, "condition", None)
    if cond is not None:
        node.condition = substitute(cond, schema)
    specs = getattr(node, "agg_specs", None)
    if specs:
        node.agg_specs = [(n, substitute(f, schema)) for n, f in specs]
    orders = getattr(node, "orders", None)
    if orders:
        node.orders = [P.SortOrder(substitute(o.expr, schema), o.ascending,
                                   o.nulls_first) for o in orders]
    wcols = getattr(node, "window_cols", None)
    if wcols:
        node.window_cols = [(n, substitute(w, schema)) for n, w in wcols]


def _find_scan_chain(node):
    """[mid..., scan] when ``node`` reaches a FileScanNode through
    passthrough nodes only, else None."""
    from spark_rapids_tpu_torch.io.common import FileScanNode
    chain = []
    cur = node
    while True:
        kids = list(getattr(cur, "children", ()))
        if len(kids) != 1:
            return None
        nxt = kids[0]
        if isinstance(nxt, FileScanNode):
            return chain + [nxt]
        if type(nxt).__name__ not in _PASSTHROUGH:
            return None
        chain.append(nxt)
        cur = nxt


def _drop_project(child, schema_keep):
    proj = P.Project.__new__(P.Project)
    proj.children = (child,)
    proj.names = [n for n, _ in schema_keep]
    child_schema = child.output_schema()
    idx = {n: i for i, (n, _) in enumerate(child_schema)}
    proj.exprs = [BoundReference(idx[n], dt, name_hint=n)
                  for n, dt in schema_keep]
    return proj


def rewrite_input_file_exprs(plan):
    """Copy-on-write rewrite; returns the plan to execute (the input plan
    and every node it shares with other queries stay untouched)."""

    def walk(node):
        kids = tuple(getattr(node, "children", ()))
        new_kids = tuple(walk(k) for k in kids)
        if any(nk is not k for nk, k in zip(new_kids, kids)):
            node = _shallow(node)
            node.children = new_kids
        if not _node_has_input_file(node):
            return node
        chain = _find_scan_chain(node)
        if chain is None:
            return node  # stays as the no-info constant
        before = node.output_schema()
        # clone the chain so the flag/passthroughs never touch shared nodes
        new_chain = [_shallow(c) for c in chain]
        for i in range(len(new_chain) - 1):
            new_chain[i].children = (new_chain[i + 1],)
        new_chain[-1].enable_file_info()
        # passthroughs BOTTOM-UP so each Project sees its child widened
        for mid in reversed(new_chain[:-1]):
            if type(mid).__name__ == "Project" and \
                    FILE_INFO_COLS[0] not in mid.names:
                cs = mid.children[0].output_schema()
                names = [n for n, _ in cs]
                for col in FILE_INFO_COLS:
                    i = names.index(col)
                    mid.exprs.append(BoundReference(i, cs[i][1],
                                                    name_hint=col))
                    mid.names.append(col)
        node = _shallow(node)
        node.children = (new_chain[0],)
        _substitute_all(node, node.children[0].output_schema())
        after = node.output_schema()
        if any(n in FILE_INFO_COLS for n, _ in after):
            # transparent holder (Filter/Limit/Sort): restore the
            # pre-rewrite schema so ordinals bound above stay valid
            return _drop_project(node, before)
        return node

    return walk(plan)
