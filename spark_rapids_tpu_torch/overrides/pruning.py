"""Column pruning (port of ``spark_rapids_tpu/overrides/pruning.py``:
Spark's ColumnPruning logical rule, which this engine applies itself
because it builds its own logical plans).

``prune_plan(root)`` returns an equivalent plan in which each node's input
carries only the columns referenced above it (plus its own keys,
predicates and sort orders). The pass rewrites BOUND expressions
(BoundReference ordinals) and keeps output names exactly: the root's
schema is unchanged. Where the reference wraps a LocalScan in a Project,
the port narrows the scan itself (``LocalScan.columns``, a file scan's
``columns=``), so a column no query node reads is never uploaded (nor,
from a file, decoded): a DECIMAL column, a wide string
column, anything beside the keys and measures.
"""

from __future__ import annotations

from typing import FrozenSet, List

from spark_rapids_tpu_torch.ops.expr import Alias, BoundReference, Expression
from spark_rapids_tpu_torch.plan import nodes as P


def _collect_refs(e: Expression, acc: set) -> None:
    if isinstance(e, BoundReference):
        acc.add(e.ordinal)
    for c in e.children:
        _collect_refs(c, acc)


def _remap(e: Expression, mapping: dict) -> Expression:
    if isinstance(e, BoundReference):
        return BoundReference(mapping[e.ordinal], e.data_type,
                              name_hint=e.name_hint)
    if not e.children:
        return e
    return e.with_children([_remap(c, mapping) for c in e.children])


def _remap_strip(e: Expression, cmap: dict) -> Expression:
    """Remap refs; an outer Alias is rebuilt with its output name."""
    if isinstance(e, Alias):
        return Alias(_remap(e.children[0], cmap), e.out_name)
    return _remap(e, cmap)


def _keep_project(node: P.PlanNode, keep: List[int]) -> P.PlanNode:
    """Wrap ``node`` in a Project keeping columns ``keep`` (ordinal order),
    preserving names."""
    schema = node.output_schema()
    exprs = [Alias(BoundReference(i, schema[i][1], name_hint=schema[i][0]),
                   schema[i][0]) for i in keep]
    return P.Project(node, exprs)


def _narrow_file_scan(node, names: List[str]) -> P.PlanNode:
    """The file scan reading only ``names``: its ``columns=`` narrowed, so
    an unread column is never decoded. The input-file columns, which the
    scan appends as a block, stay when any is read; a Project drops what
    the narrowed scan still carries beyond ``names``."""
    from spark_rapids_tpu_torch.ops.inputfile import FILE_INFO_COLS
    data = [n for n in names if n not in FILE_INFO_COLS]
    if not data:
        data = [n for n, _ in node.output_schema()
                if n not in FILE_INFO_COLS][:1]
    new = node.with_columns(data)
    new.provide_file_info = any(n in FILE_INFO_COLS for n in names)
    got = [n for n, _ in new.output_schema()]
    if got == names:
        return new
    return _keep_project(new, [got.index(n) for n in names])


def _kept_of(creq: set, node: P.PlanNode) -> List[int]:
    n = len(node.output_schema())
    return sorted(frozenset(o for o in creq if o < n) or {0})


def _visit(node: P.PlanNode, required: FrozenSet[int]) -> P.PlanNode:
    """Rewrite ``node`` so its output is exactly
    ``[schema[i] for i in sorted(required)]``."""
    schema = node.output_schema()
    nall = len(schema)
    required = frozenset(i for i in required if i < nall)
    if not required and nall:
        required = frozenset([0])  # keep one column (row counts need one)
    kept = sorted(required)

    if isinstance(node, P.LocalScan):
        if kept == list(range(nall)):
            return node
        return node.with_columns(kept)

    from spark_rapids_tpu_torch.io.common import FileScanNode
    if isinstance(node, FileScanNode):
        if kept == list(range(nall)):
            return node
        return _narrow_file_scan(node, [schema[i][0] for i in kept])

    if isinstance(node, P.Project):
        exprs = [node.exprs[i] for i in kept]
        names = [node.names[i] for i in kept]
        creq: set = set()
        for e in exprs:
            _collect_refs(e, creq)
        child = _visit(node.children[0], frozenset(creq))
        cmap = {o: i for i, o in enumerate(sorted(
            o for o in creq if o < len(node.children[0].output_schema())))}
        return P.Project(child, [Alias(_remap_strip(e, cmap), n)
                                 for e, n in zip(exprs, names)])

    if isinstance(node, P.Filter):
        creq = set(kept)
        _collect_refs(node.condition, creq)
        child = _visit(node.children[0], frozenset(creq))
        ckept = sorted(frozenset(i for i in creq if i < nall) or {0})
        cmap = {o: i for i, o in enumerate(ckept)}
        new = P.Filter(child, _remap(node.condition, cmap))
        if ckept != kept:
            new = _keep_project(new, [cmap[o] for o in kept])
        return new

    if isinstance(node, P.Join):
        nl = len(node.children[0].output_schema())
        semi = node.join_type in ("leftsemi", "leftanti")
        lreq = set(o for o in kept if o < nl)
        rreq = set(o - nl for o in kept if o >= nl)
        for k in node.left_keys:
            _collect_refs(k, lreq)
        for k in node.right_keys:
            _collect_refs(k, rreq)
        if node.condition is not None:
            cond_refs: set = set()
            _collect_refs(node.condition, cond_refs)
            lreq |= {o for o in cond_refs if o < nl}
            rreq |= {o - nl for o in cond_refs if o >= nl}
        left = _visit(node.children[0], frozenset(lreq))
        right = _visit(node.children[1], frozenset(rreq))
        lkept = _kept_of(lreq, node.children[0])
        rkept = _kept_of(rreq, node.children[1])
        lmap = {o: i for i, o in enumerate(lkept)}
        rmap = {o: i for i, o in enumerate(rkept)}
        jmap = dict(lmap)
        for o, i in rmap.items():
            jmap[o + nl] = len(lkept) + i
        cond = (_remap(node.condition, jmap)
                if node.condition is not None else None)
        new = P.Join(left, right, node.join_type,
                     [_remap(k, lmap) for k in node.left_keys],
                     [_remap(k, rmap) for k in node.right_keys], cond)
        out_idx = [jmap[o] for o in kept]
        out_all = list(range(len(lkept) + (0 if semi else len(rkept))))
        if out_idx != out_all:
            new = _keep_project(new, out_idx)
        return new

    if isinstance(node, P.Aggregate):
        creq = set()
        for g in node.grouping:
            _collect_refs(g, creq)
        for _, fn in node.agg_specs:
            _collect_refs(fn, creq)
        child = _visit(node.children[0], frozenset(creq))
        cmap = {o: i for i, o in enumerate(_kept_of(creq,
                                                    node.children[0]))}
        new = P.Aggregate.__new__(P.Aggregate)
        new.children = (child,)
        new.grouping = [_remap(g, cmap) for g in node.grouping]
        new.agg_specs = [(n, _remap(fn, cmap)) for n, fn in node.agg_specs]
        new.grouping_names = list(node.grouping_names)
        if kept != list(range(nall)):
            new = _keep_project(new, kept)
        return new

    if isinstance(node, (P.Sort, P.TakeOrderedAndProject)):
        creq = set(kept)
        for o in node.orders:
            _collect_refs(o.expr, creq)
        child = _visit(node.children[0], frozenset(creq))
        ckept = _kept_of(creq, node.children[0])
        cmap = {o: i for i, o in enumerate(ckept)}
        orders = [P.SortOrder(_remap(o.expr, cmap), o.ascending,
                              o.nulls_first) for o in node.orders]
        new = type(node).__new__(type(node))
        new.children = (child,)
        new.orders = orders
        if isinstance(node, P.TakeOrderedAndProject):
            new.limit = node.limit
        else:
            new.global_sort = node.global_sort
        if ckept != kept:
            new = _keep_project(new, [cmap[o] for o in kept])
        return new

    if isinstance(node, P.Limit):
        return type(node)(_visit(node.children[0], required), node.limit)

    if isinstance(node, P.Sample):
        return P.Sample(_visit(node.children[0], required), node.fraction,
                        node.seed)

    if isinstance(node, P.Union):
        # each child now outputs exactly sorted(required): schemas align
        return P.Union([_visit(c, required) for c in node.children])

    if isinstance(node, P.Expand):
        creq = set()
        for proj in node.projections:
            for i in kept:
                _collect_refs(proj[i], creq)
        child = _visit(node.children[0], frozenset(creq))
        cmap = {o: i for i, o in enumerate(_kept_of(creq,
                                                    node.children[0]))}
        new = P.Expand.__new__(P.Expand)
        new.children = (child,)
        new.projections = [[_remap(proj[i], cmap) for i in kept]
                           for proj in node.projections]
        new.names = [node.names[i] for i in kept]
        return new

    if isinstance(node, P.Generate):
        cschema = node.children[0].output_schema()
        cnames = [n for n, _ in cschema]
        creq = {cnames.index(n) for n in node.required}
        _collect_refs(node.gen_child, creq)
        child = _visit(node.children[0], frozenset(creq))
        cmap = {o: i for i, o in enumerate(_kept_of(creq,
                                                    node.children[0]))}
        new = P.Generate.__new__(P.Generate)
        new.children = (child,)
        new.gen_child = _remap(node.gen_child, cmap)
        new.pos, new.outer = node.pos, node.outer
        new.out_names = list(node.out_names)
        new.required = list(node.required)
        if kept != list(range(nall)):
            new = _keep_project(new, kept)
        return new

    # conservative default (a RangeNode, a CachedRelation, whose child
    # is pruned when it runs): keep the node whole, prune nothing below it
    if kept == list(range(nall)):
        return node
    return _keep_project(node, kept)


def prune_plan(root: P.PlanNode) -> P.PlanNode:
    """Apply column pruning below the root; the root's schema is unchanged
    (names, order, types). A node type the pass does not know is kept
    whole; a fault in the rewrite raises (the reference runs the unpruned
    plan instead)."""
    return _visit(root, frozenset(range(len(root.output_schema()))))
