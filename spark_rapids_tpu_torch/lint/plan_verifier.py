"""Physical-plan verifier (port of ``spark_rapids_tpu/lint/plan_verifier.py``;
reference: Catalyst plan integrity validation and the spark-rapids
assert-on-fallback test hook).

Walks a CONVERTED plan — the mixed device-exec / transition / host
plan-node tree ``overrides/rules.py::convert_meta`` makes, AQE's deferred
build nodes and the CPU route's nodes (``CpuRootExec``, ``HostToDevice``,
``DeviceToHost``, ``InputAdapter``) included — and asserts the
cross-layer invariants the tagging layer promises. Every violation is a
structured ``Diagnostic`` with a plan path (``Join.left.Project``) and a
stable rule id (diagnostics.RULES, PV-*).

The walk is structure only: it reads schemas, expressions and the tags,
and makes no CUDA call and no host sync, so the session can run it
before every fresh execution (``spark.rapids.sql.planVerify.mode``)."""

from __future__ import annotations

import inspect
from typing import Iterable, List, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.lint.diagnostics import Diagnostic, make

# ---------------------------------------------------------------------------
# tree walking over the heterogeneous converted plan
# ---------------------------------------------------------------------------


def _label(node) -> str:
    name = type(node).__name__
    if name.startswith("Tpu"):
        name = name[3:]
    for suffix in ("Exec", "Node"):
        if name.endswith(suffix) and len(name) > len(suffix):
            name = name[: -len(suffix)]
    return name


def _edges(node) -> List[Tuple[str, object]]:
    """(edge_label, child) pairs; edge_label '' means a plain descent. The
    transitions descend into what they wrap (a HostToDevice's and a
    CpuRootExec's ``children`` list only the device execs under their
    host node, for the exec-tree walks)."""
    from spark_rapids_tpu_torch.execs.base import (
        CpuRootExec,
        DeviceToHost,
        HostToDevice,
        InputAdapter,
    )
    if isinstance(node, DeviceToHost):
        return [("", node.tpu_exec)]
    if isinstance(node, (HostToDevice, CpuRootExec)):
        return [("", node.cpu_node)]
    if isinstance(node, InputAdapter):
        return [("", node.source)]
    scan_node = getattr(node, "scan_node", None)
    if scan_node is not None:
        return [("scan", scan_node)]
    children = list(getattr(node, "children", ()) or ())
    if len(children) == 2:
        return [("left", children[0]), ("right", children[1])]
    if len(children) <= 1:
        return [("", c) for c in children]
    return [(f"child{i}", c) for i, c in enumerate(children)]


def iter_nodes(root) -> Iterable[Tuple[str, object]]:
    """Yield (plan_path, node) in pre-order; shared subtrees visit once."""
    seen = set()

    def rec(node, path):
        if id(node) in seen:
            return
        seen.add(id(node))
        yield path, node
        for edge, child in _edges(node):
            sub = f"{path}.{edge}.{_label(child)}" if edge \
                else f"{path}.{_label(child)}"
            yield from rec(child, sub)

    yield from rec(root, _label(root))


def _schema_of(node):
    try:
        return node.output_schema()
    except Exception as exc:  # malformed schema IS the finding
        return exc


# ---------------------------------------------------------------------------
# expression extraction (per node: what binds against which child schema)
# ---------------------------------------------------------------------------


def _window_exprs(window_cols):
    out = []
    for name, w in window_cols:
        fn = getattr(w, "function", None)
        spec = getattr(w, "spec", None)
        if fn is not None:
            for c in getattr(fn, "children", ()):
                out.append((f"window {name} input", c))
        if spec is not None:
            for p in getattr(spec, "partition_exprs", ()):
                out.append((f"window {name} partition key", p))
            for o in getattr(spec, "orders", ()):
                out.append((f"window {name} order key", o.expr))
    return out


def node_expr_bindings(node):
    """[(context, expression, binding_schema_or_None)] for every
    expression a node evaluates. ``binding_schema`` is what its
    BoundReferences must resolve against (None = not checkable)."""
    from spark_rapids_tpu_torch.execs import basic as XB
    from spark_rapids_tpu_torch.execs import exchange as XX
    from spark_rapids_tpu_torch.execs import sort as XS
    from spark_rapids_tpu_torch.execs import window as XW
    from spark_rapids_tpu_torch.execs.aggregate import TpuHashAggregateExec
    from spark_rapids_tpu_torch.execs.broadcast import TpuNestedLoopJoinExec
    from spark_rapids_tpu_torch.execs.generate import TpuGenerateExec
    from spark_rapids_tpu_torch.execs.join import TpuJoinExec
    from spark_rapids_tpu_torch.plan import nodes as P

    def child_schema(i=0):
        s = _schema_of(node.children[i])
        return s if isinstance(s, list) else None

    out = []
    if isinstance(node, (XB.TpuProjectExec, P.Project)):
        cs = child_schema()
        for e in node.exprs:
            out.append(("project expression", e, cs))
    elif isinstance(node, (XB.TpuFilterExec, P.Filter)):
        out.append(("filter condition", node.condition, child_schema()))
    elif isinstance(node, (XB.TpuExpandExec, P.Expand)):
        cs = child_schema()
        for proj in node.projections:
            for e in proj:
                out.append(("expand projection", e, cs))
    elif isinstance(node, (XS.TpuSortExec, P.Sort,
                           XS.TpuTakeOrderedAndProjectExec,
                           P.TakeOrderedAndProject)):
        cs = child_schema()
        for o in node.orders:
            out.append(("sort key", o.expr, cs))
    elif isinstance(node, (TpuHashAggregateExec, P.Aggregate)):
        cs = child_schema()
        for g in node.grouping:
            out.append(("grouping key", g, cs))
        for name, fn in node.agg_specs:
            child = getattr(fn, "child", None)
            if child is not None:
                out.append((f"aggregate {name} input", child, cs))
        for f in getattr(node, "filters", ()):
            out.append(("fused filter", f, cs))
    elif isinstance(node, TpuJoinExec):
        ls, rs = node._left_schema, node._right_schema
        for k in node.left_keys:
            out.append(("left join key", k, ls))
        for k in node.right_keys:
            out.append(("right join key", k, rs))
        if node.condition is not None:
            out.append(("join condition", node.condition, ls + rs))
    elif isinstance(node, P.Join):
        ls = child_schema(0)
        rs = child_schema(1)
        for k in node.left_keys:
            out.append(("left join key", k, ls))
        for k in node.right_keys:
            out.append(("right join key", k, rs))
        if node.condition is not None:
            both = (ls + rs) if (ls is not None and rs is not None) else None
            out.append(("join condition", node.condition, both))
    elif isinstance(node, TpuNestedLoopJoinExec):
        if node.condition is not None:
            both = list(node._left_schema) + list(node._right_schema)
            out.append(("join condition", node.condition, both or None))
    elif isinstance(node, (XX.TpuShuffleExchangeExec, P.Exchange)):
        cs = child_schema()
        for k in node.keys:
            out.append(("partition key", k, cs))
    elif isinstance(node, XW.TpuKeyedBatchExec):
        cs = child_schema()
        for k in node.keys:
            out.append(("keyed-batch partition key", k, cs))
    elif isinstance(node, (TpuGenerateExec, P.Generate)):
        out.append(("generator input", node.gen_child, child_schema()))
    elif isinstance(node, (XW.TpuWindowExec, P.WindowNode)):
        cs = child_schema()
        for ctx, e in _window_exprs(node.window_cols):
            out.append((ctx, e, cs))
    elif isinstance(node, (XW.TpuWindowGroupLimitExec, P.WindowGroupLimit)):
        cs = child_schema()
        for e in node.partition_exprs:
            out.append(("group-limit partition key", e, cs))
        for o in node.orders:
            out.append(("group-limit order key", o.expr, cs))
    return out


def _walk_expr(e):
    yield e
    for c in getattr(e, "children", ()):
        yield from _walk_expr(c)
    body = getattr(e, "_rebound", None)
    if body is not None:
        yield from _walk_expr(body)


# ---------------------------------------------------------------------------
# per-rule checks
# ---------------------------------------------------------------------------

#: exec/plan classes whose output schema must equal their (first) edge
#: child's exactly; the transitions and the keyed batching included
_PASS_THROUGH = {
    "TpuFilterExec", "TpuLimitExec", "TpuCoalesceExec", "TpuSortExec",
    "TpuShuffleExchangeExec", "TpuBroadcastExchangeExec",
    "TpuAdaptiveBuildExec", "TpuWindowGroupLimitExec", "TpuSampleExec",
    "TpuMeshRelandExec", "TpuKeyedBatchExec",
    "TpuTakeOrderedAndProjectExec", "DeviceToHost", "HostToDevice",
    "CpuRootExec", "InputAdapter",
    "Filter", "Sort", "Limit", "Exchange", "Sample", "WindowGroupLimit",
    "TakeOrderedAndProject",
}


def _check_schema(path, node, diags):
    schema = _schema_of(node)
    if not isinstance(schema, list):
        diags.append(make("PV-SCHEMA", path,
                          f"output_schema() failed: {schema!r}"))
        return None
    for entry in schema:
        if (not isinstance(entry, tuple) or len(entry) != 2
                or not isinstance(entry[0], str) or not entry[0]
                or not isinstance(entry[1], T.DataType)):
            diags.append(make("PV-SCHEMA", path,
                              f"malformed schema entry {entry!r}"))
            return schema
    children = [c for _, c in _edges(node)]
    if type(node).__name__ in _PASS_THROUGH and children:
        cs = _schema_of(children[0])
        if isinstance(cs, list) and schema != cs:
            diags.append(make(
                "PV-SCHEMA", path,
                f"pass-through node output schema {_fmt_schema(schema)} "
                f"!= child schema {_fmt_schema(cs)}"))
    if type(node).__name__ in ("TpuUnionExec", "Union") and children:
        want = [dt for _, dt in schema]
        for i, c in enumerate(children):
            cs = _schema_of(c)
            if isinstance(cs, list) and [dt for _, dt in cs] != want:
                diags.append(make(
                    "PV-SCHEMA", path,
                    f"union child {i} types {_fmt_schema(cs)} != "
                    f"{_fmt_schema(schema)}"))
    return schema


def _fmt_schema(schema) -> str:
    return "[" + ", ".join(
        f"{n}:{dt.simple_string() if isinstance(dt, T.DataType) else dt}"
        for n, dt in schema) + "]"


def _check_transitions(path, node, diags):
    """The port's transitions: a device exec reads device execs only (a
    host child through HostToDevice), a host plan node reads host nodes
    only (a device child through InputAdapter over DeviceToHost), and a
    CpuRootExec roots a host plan."""
    from spark_rapids_tpu_torch.execs.base import (
        CpuRootExec,
        DeviceToHost,
        HostToDevice,
        InputAdapter,
        TpuExec,
    )
    from spark_rapids_tpu_torch.plan.nodes import PlanNode
    if isinstance(node, DeviceToHost):
        if not isinstance(node.tpu_exec, TpuExec) or \
                isinstance(node.tpu_exec, (DeviceToHost, CpuRootExec)):
            diags.append(make(
                "PV-TRANSITION", path,
                f"DeviceToHost wraps {_label(node.tpu_exec)}, which is "
                "not a device exec"))
        return
    if isinstance(node, (HostToDevice, CpuRootExec)):
        if not isinstance(node.cpu_node, PlanNode):
            diags.append(make(
                "PV-TRANSITION", path,
                f"{type(node).__name__} wraps {_label(node.cpu_node)}, "
                "which is not a host plan node"))
        return
    if isinstance(node, InputAdapter):
        if not isinstance(node.source, DeviceToHost):
            diags.append(make(
                "PV-TRANSITION", path,
                f"InputAdapter sources {_label(node.source)} instead of "
                "a DeviceToHost transition"))
        return
    if isinstance(node, TpuExec):
        for edge, child in _edges(node):
            if edge == "scan":
                continue  # file scans upload internally (sanctioned)
            if not isinstance(child, TpuExec) or \
                    isinstance(child, (DeviceToHost, CpuRootExec)):
                diags.append(make(
                    "PV-TRANSITION", path,
                    f"device exec consumes host node {_label(child)} "
                    "without a HostToDevice transition"))
    elif isinstance(node, PlanNode):
        for _, child in _edges(node):
            if isinstance(child, TpuExec):
                diags.append(make(
                    "PV-TRANSITION", path,
                    f"host node consumes device exec {_label(child)} "
                    "without an InputAdapter(DeviceToHost) transition"))


_VALID_PARTITIONING = ("hash", "range", "roundrobin", "single")


def _check_exchange(path, node, diags):
    from spark_rapids_tpu_torch.execs.exchange import TpuShuffleExchangeExec
    from spark_rapids_tpu_torch.ops.expr import BoundReference
    from spark_rapids_tpu_torch.plan.nodes import Exchange
    if not isinstance(node, (TpuShuffleExchangeExec, Exchange)):
        return
    mode = getattr(node, "mode", None) or getattr(node, "partitioning", None)
    mode = str(mode).lower()
    n = node.num_partitions
    if mode not in _VALID_PARTITIONING:
        diags.append(make("PV-EXCHANGE", path,
                          f"unknown partitioning mode {mode!r}"))
        return
    if not isinstance(n, int) or n < 1:
        diags.append(make("PV-EXCHANGE", path,
                          f"invalid partition count {n!r}"))
    if mode == "single" and isinstance(node, TpuShuffleExchangeExec) \
            and n != 1:
        diags.append(make("PV-EXCHANGE", path,
                          f"single partitioning with {n} partitions"))
    if mode in ("hash", "range") and not node.keys:
        diags.append(make("PV-EXCHANGE", path,
                          f"{mode} partitioning requires keys"))
    cs = _schema_of(node.children[0]) if getattr(node, "children", ()) \
        else None
    if isinstance(cs, list):
        for k in node.keys:
            for e in _walk_expr(k):
                if isinstance(e, BoundReference) and \
                        not (0 <= e.ordinal < len(cs)):
                    diags.append(make(
                        "PV-EXCHANGE", path,
                        f"partition key references ordinal {e.ordinal} "
                        f"outside the child's {len(cs)}-column output"))


def _iter_outer_refs(e):
    """BoundReferences that bind against the node's CHILD schema — stop
    at lambda boundaries: a higher-order function's LambdaFunction child
    (and its _rebound body) lives in element space with its own
    synthetic ordinals."""
    from spark_rapids_tpu_torch.ops.nested import (
        LambdaFunction,
        NamedLambdaVariable,
    )
    if isinstance(e, (LambdaFunction, NamedLambdaVariable)):
        return
    yield e
    for c in getattr(e, "children", ()):
        yield from _iter_outer_refs(c)


def _check_boundrefs(path, node, diags):
    from spark_rapids_tpu_torch.ops.expr import BoundReference
    for ctx, expr, schema in node_expr_bindings(node):
        if schema is None:
            continue
        for e in _iter_outer_refs(expr):
            if not isinstance(e, BoundReference):
                continue
            if not (0 <= e.ordinal < len(schema)):
                diags.append(make(
                    "PV-BOUNDREF", path,
                    f"{ctx}: ordinal {e.ordinal} outside the child's "
                    f"{len(schema)}-column schema"))
            elif e.data_type != schema[e.ordinal][1]:
                diags.append(make(
                    "PV-BOUNDREF", path,
                    f"{ctx}: ordinal {e.ordinal} typed "
                    f"{e.data_type.simple_string()} but child column "
                    f"{schema[e.ordinal][0]} is "
                    f"{schema[e.ordinal][1].simple_string()}"))


def _check_typesig(path, node, on_device, conf, diags):
    if not on_device:
        return
    from spark_rapids_tpu_torch.overrides.rules import check_expr
    for ctx, expr, _ in node_expr_bindings(node):
        reasons: List[str] = []
        try:
            check_expr(expr, conf, reasons)
        except Exception as exc:
            reasons = [f"check_expr failed: {exc!r}"]
        for r in reasons:
            diags.append(make(
                "PV-TYPESIG", path,
                f"{ctx}: {r} (expression ran on device anyway)"))


def _iter_types(dt):
    yield dt
    if isinstance(dt, T.ArrayType):
        yield from _iter_types(dt.element_type)
    elif isinstance(dt, T.StructType):
        for f in dt.fields:
            yield from _iter_types(f.data_type)
    elif isinstance(dt, T.MapType):
        yield from _iter_types(dt.key_type)
        yield from _iter_types(dt.value_type)


def _bad_decimal(t) -> bool:
    return isinstance(t, T.DecimalType) and not (
        0 < t.precision <= T.DecimalType.MAX_PRECISION
        and 0 <= t.scale <= t.precision)


def _check_decimals(path, node, diags):
    from spark_rapids_tpu_torch.ops.decimal import DecimalBinary
    schema = _schema_of(node)
    if isinstance(schema, list):
        for entry in schema:
            if not (isinstance(entry, tuple) and len(entry) == 2):
                continue  # PV-SCHEMA's finding
            name, dt = entry
            for t in _iter_types(dt):
                if _bad_decimal(t):
                    diags.append(make(
                        "PV-DECIMAL", path,
                        f"column {name} has invalid decimal "
                        f"({t.precision},{t.scale})"))
    for ctx, expr, _ in node_expr_bindings(node):
        for e in _walk_expr(expr):
            try:
                dt = e.data_type
            except Exception:
                continue
            for t in _iter_types(dt):
                if _bad_decimal(t):
                    diags.append(make(
                        "PV-DECIMAL", path,
                        f"{ctx}: {type(e).__name__} produces invalid "
                        f"decimal ({t.precision},{t.scale})"))
            if isinstance(e, DecimalBinary):
                try:
                    want = e._result_type(e.left.data_type,
                                          e.right.data_type)
                except Exception:
                    continue
                if isinstance(dt, T.DecimalType) and (
                        dt.precision != want.precision
                        or dt.scale != want.scale):
                    diags.append(make(
                        "PV-DECIMAL", path,
                        f"{ctx}: {type(e).__name__} declares "
                        f"decimal({dt.precision},{dt.scale}) but the "
                        f"Spark promotion rule gives "
                        f"decimal({want.precision},{want.scale})"))


def _check_nullability(path, node, diags):
    from spark_rapids_tpu_torch.ops.expr import Alias
    for ctx, expr, _ in node_expr_bindings(node):
        for e in _walk_expr(expr):
            try:
                e_nullable = e.nullable
                kids_nullable = any(c.nullable for c in
                                    getattr(e, "children", ()))
            except Exception:
                continue
            if isinstance(e, Alias):
                child = e.children[0]
                try:
                    if e_nullable != child.nullable:
                        diags.append(make(
                            "PV-NULLABLE", path,
                            f"{ctx}: Alias nullability {e_nullable} != "
                            f"child nullability {child.nullable}"))
                except Exception:
                    pass
                continue
            if not e_nullable and kids_nullable:
                cls_attr = inspect.getattr_static(type(e), "nullable", None)
                if not isinstance(cls_attr, property):
                    # a plain `nullable = False` class attribute shadows
                    # the derived property — the footgun this rule exists
                    # for; a property override is a deliberate
                    # null-suppressing op (IsNull, Count, Coalesce...)
                    diags.append(make(
                        "PV-NULLABLE", path,
                        f"{ctx}: {type(e).__name__} claims non-nullable "
                        "over nullable inputs without overriding the "
                        "nullable property"))


def _check_aggregate(path, node, diags):
    from spark_rapids_tpu_torch.execs.aggregate import (
        DEVICE_SUPPORTED_AGGS,
        TpuHashAggregateExec,
        agg_host_reason,
    )
    from spark_rapids_tpu_torch.ops import aggregates as agg
    from spark_rapids_tpu_torch.plan.nodes import Aggregate
    if not isinstance(node, (TpuHashAggregateExec, Aggregate)):
        return
    names = getattr(node, "grouping_names", None)
    if names is not None and len(names) != len(node.grouping):
        diags.append(make(
            "PV-AGG", path,
            f"{len(names)} grouping names for {len(node.grouping)} "
            "grouping keys"))
    for name, fn in node.agg_specs:
        if not isinstance(fn, agg.AggregateFunction):
            diags.append(make(
                "PV-AGG", path,
                f"aggregate spec {name} is {type(fn).__name__}, not an "
                "AggregateFunction"))
        elif isinstance(node, TpuHashAggregateExec):
            if not isinstance(fn, DEVICE_SUPPORTED_AGGS):
                diags.append(make(
                    "PV-AGG", path,
                    f"aggregate {name} ({type(fn).__name__}) is not "
                    "device-supported but sits in a device aggregate "
                    "exec"))
                continue
            try:
                reason = agg_host_reason(name, fn)
            except Exception as exc:
                reason = f"its tag failed: {exc!r}"
            if reason is not None:
                diags.append(make(
                    "PV-AGG", path,
                    f"aggregate {name} ({type(fn).__name__}) belongs on "
                    f"the CPU route ({reason}) but sits in a device "
                    "aggregate exec"))


_SUPPORTED_JOIN_TYPES = {"inner", "cross", "left", "leftouter", "right",
                         "rightouter", "full", "fullouter", "outer",
                         "leftsemi", "leftanti"}


def _check_join(path, node, diags):
    from spark_rapids_tpu_torch.execs.join import TpuJoinExec
    from spark_rapids_tpu_torch.plan.nodes import Join
    if not isinstance(node, (TpuJoinExec, Join)):
        return
    jt = node.join_type.lower().replace("_", "")
    if jt not in _SUPPORTED_JOIN_TYPES:
        diags.append(make("PV-JOIN", path,
                          f"unsupported join type {node.join_type!r}"))
    if len(node.left_keys) != len(node.right_keys):
        diags.append(make(
            "PV-JOIN", path,
            f"key arity mismatch: {len(node.left_keys)} left vs "
            f"{len(node.right_keys)} right"))
        return
    if isinstance(node, TpuJoinExec):
        # the converter promotes mismatched key types with Casts; a
        # surviving mismatch means the kernels compare raw buffers of
        # different types
        for i, (lk, rk) in enumerate(zip(node.left_keys, node.right_keys)):
            try:
                lt, rt = lk.data_type, rk.data_type
            except Exception:
                continue
            if lt != rt:
                diags.append(make(
                    "PV-JOIN", path,
                    f"device join key {i} types diverge: "
                    f"{lt.simple_string()} vs {rt.simple_string()}"))


# ---------------------------------------------------------------------------
# fallback bookkeeping (PlanMeta side)
# ---------------------------------------------------------------------------


def _has_rule(node) -> bool:
    from spark_rapids_tpu_torch.overrides.rules import (
        _DEVICE_NODES,
        _FILE_SCANS,
    )
    return isinstance(node, _DEVICE_NODES) or type(node) in _FILE_SCANS


def verify_meta(meta, diags: List[Diagnostic]) -> None:
    explain_txt = meta.explain(only_fallback=False)

    def rec(m, path):
        if m.reasons:
            for r in m.reasons:
                if not str(r).strip():
                    diags.append(make(
                        "PV-FALLBACK", path,
                        "fallback carries an empty reason"))
                elif str(r) not in explain_txt:
                    diags.append(make(
                        "PV-FALLBACK", path,
                        f"fallback reason {r!r} does not surface in "
                        "explain()"))
        elif not _has_rule(m.node):
            diags.append(make(
                "PV-FALLBACK", path,
                f"{_label(m.node)} has no exec rule yet carries no "
                "fallback reason (tagging skipped?)"))
        kids = m.children
        for i, c in enumerate(kids):
            if len(kids) == 2:
                edge = "left" if i == 0 else "right"
                rec(c, f"{path}.{edge}.{_label(c.node)}")
            else:
                rec(c, f"{path}.{_label(c.node)}")

    rec(meta, _label(meta.node))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def verify_converted(executable, meta=None, conf=None) -> List[Diagnostic]:
    """Verify a converted plan (and, when given, its tagged PlanMeta)."""
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.execs.base import (
        CpuRootExec,
        DeviceToHost,
        HostToDevice,
        TpuExec,
    )
    conf = conf if conf is not None else RapidsConf()
    diags: List[Diagnostic] = []
    for path, node in iter_nodes(executable):
        on_device = isinstance(node, TpuExec) and not isinstance(
            node, (HostToDevice, DeviceToHost, CpuRootExec))
        if isinstance(node, CpuRootExec) and node is not executable:
            diags.append(make(
                "PV-TRANSITION", path,
                "CpuRootExec below the root: a host plan under a device "
                "parent needs a HostToDevice transition"))
        _check_schema(path, node, diags)
        _check_transitions(path, node, diags)
        _check_exchange(path, node, diags)
        _check_boundrefs(path, node, diags)
        _check_typesig(path, node, on_device, conf, diags)
        _check_decimals(path, node, diags)
        _check_nullability(path, node, diags)
        _check_aggregate(path, node, diags)
        _check_join(path, node, diags)
    if meta is not None:
        verify_meta(meta, diags)
    return diags


def convert_plan(plan, conf, device):
    """Tag, optimize and convert a logical plan as a session's execute
    does (input-file rewrite, ``wrap_plan``, the cost-based optimizer,
    ``convert_meta``), running nothing: (executable, meta)."""
    from spark_rapids_tpu_torch.overrides.input_file import (
        rewrite_input_file_exprs,
    )
    from spark_rapids_tpu_torch.overrides.optimizer import apply_cbo
    from spark_rapids_tpu_torch.overrides.rules import (
        convert_meta,
        wrap_plan,
    )
    meta = wrap_plan(rewrite_input_file_exprs(plan), conf)
    apply_cbo(meta, conf)
    return convert_meta(meta, device), meta


def verify_plan(plan, conf=None, device=None) -> List[Diagnostic]:
    """Tag + convert a logical plan for ``device`` (default: the card;
    ``"cpu"`` for the tests), then verify the converted tree."""
    from spark_rapids_tpu_torch import resolve_device
    from spark_rapids_tpu_torch.conf import RapidsConf
    conf = conf if conf is not None else RapidsConf()
    executable, meta = convert_plan(plan, conf, resolve_device(device))
    return verify_converted(executable, meta, conf)
