"""Tag and convert plan nodes into device execs, with the per-operator
CPU route (port of the rules, ``PlanMeta``, ``check_expr``, ``convert``
and ``explain`` of ``spark_rapids_tpu/overrides/rules.py``, the column
pruning and the window group-limit rewrite its ``apply_overrides`` runs
first, and ``lore.assign_lore_ids``: every exec gets its plan position,
pre-order from 1).

``PlanMeta.tag`` collects, for every node, the reference's reasons to run
it on the CPU route: an expression whose form the device does not
evaluate (``Expression.device_supported``), a type the device holds in
no form (nested columns of strings or decimals, arrays of structs or
arrays; array, struct and map columns may leave only a scan, a cached
relation or a project, and arrays a generate or an aggregate), a kill
switch (``spark.rapids.sql.exec.<Node>``,
``spark.rapids.sql.expression.<Expr>``), and the reference's per-rule
gates (joins, windows, aggregates). The tags alone choose the route:
a device failure moves work to the CPU only through the rungs' tags
below, on the replay the recovery plans afresh. ``convert`` turns
a node without reasons into its device exec and leaves a node with
reasons as a host plan node (``execute_cpu``), with transitions where a
device parent meets a host child and the reverse (execs/base.py).
``explain`` renders the tagged tree (``*`` on the device, ``!`` on the
CPU route with its reasons). What neither the device nor the CPU route
runs raises NotImplementedError naming it, before anything runs. At run
time two rungs move work onto the route through the same tags: a plan
node the circuit breaker demoted (runtime/faults.py) and, once a device
loss latched CPU-only mode, every node (runtime/health.py). Each
converted exec carries the plan-node class it came from
(``_plan_origin``, the breaker's unit), and a broadcast inner or
left-semi join installs dynamic partition pruning on its probe side's
file scan (``_maybe_install_dpp``)."""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.columnar import BucketPolicy
from spark_rapids_tpu_torch.execs.aggregate import (
    TpuHashAggregateExec,
    agg_host_reason,
    check_agg_supported,
)
from spark_rapids_tpu_torch.execs import basic as xbasic
from spark_rapids_tpu_torch.execs.base import (
    CpuRootExec,
    DeviceToHost,
    HostToDevice,
    InputAdapter,
    TpuExec,
)
from spark_rapids_tpu_torch.execs.basic import (
    TpuCoalesceExec,
    TpuFilterExec,
    TpuLimitExec,
    TpuProjectExec,
    TpuScanExec,
)
from spark_rapids_tpu_torch.execs.broadcast import (
    TpuAdaptiveBuildExec,
    TpuBroadcastExchangeExec,
    TpuNestedLoopJoinExec,
)
from spark_rapids_tpu_torch.execs.fuse import peel_input_chain
from spark_rapids_tpu_torch.execs.join import TpuJoinExec
from spark_rapids_tpu_torch.execs.sort import (
    TpuSortExec,
    TpuTakeOrderedAndProjectExec,
)
from spark_rapids_tpu_torch.overrides.docs import register_exec_sig
from spark_rapids_tpu_torch.overrides.pruning import prune_plan
from spark_rapids_tpu_torch.overrides.typesig import (
    COMMON_128,
    COMMON_PLUS_ARRAYS,
    INTEGRAL,
    NESTED_128,
    ExprChecks,
    TypeSig,
    lookup_mro,
)
from spark_rapids_tpu_torch.plan import nodes as P


#: FileScanNode subclasses with a device rule (io/__init__.py registers
#: them when the io package imports)
_FILE_SCANS: set = set()


def register_file_scan(cls) -> None:
    """Register a FileScanNode subclass with a device rule; its kill
    switch is ``spark.rapids.sql.exec.<ClassName>``."""
    _FILE_SCANS.add(cls)
    register_exec_sig(cls, NESTED_128)


#: plan nodes with a device rule
_DEVICE_NODES = (P.LocalScan, P.RangeNode, P.Project, P.Filter,
                 P.Aggregate, P.Sort, P.Limit, P.CollectLimit, P.Union,
                 P.Expand, P.Join, P.Generate, P.Sample,
                 P.TakeOrderedAndProject,
                 P.CachedRelation, P.WindowGroupLimit, P.WindowNode,
                 P.Exchange)


def _host_only_type(dt, nested_ok: str) -> bool:
    """Does the device hold no form of ``dt`` here? ``nested_ok``: which
    nested columns the node's device exec carries ("nested": every
    nested type with a layout, "arrays": arrays with one, "" none)."""
    return not _OUTPUT_SIGS[nested_ok].supports(dt)


#: the output signature of each ``nested_ok`` class of exec (docs.py's
#: exec rows read them through ``register_exec_sig``)
_OUTPUT_SIGS = {"nested": NESTED_128, "arrays": COMMON_PLUS_ARRAYS,
                "": COMMON_128}


#: every expression class, with the TypeSig of its OUTPUT; built once
#: from the ops modules
_EXPR_SIGS: Dict[type, TypeSig] = {}

#: the modules whose expressions may produce (or pass through) nested
#: columns; every other expression produces scalars
_NESTED_OUTPUT_MODULES = frozenset(
    f"spark_rapids_tpu_torch.{m}" for m in (
        "ops.expr", "ops.collections", "ops.nested", "ops.json_structs",
        "ops.conditional", "ops.cast", "ops.misc", "udf"))

#: per-parameter input signatures (the reference's ExprChecks); a class
#: absent here checks its output only
_EXPR_CHECKS: Dict[type, ExprChecks] = {}


def _build_expr_sigs() -> None:
    """Register every expression class of the port's modules (one whose
    form only the CPU route evaluates says so through its
    ``device_supported``), then the reference's per-parameter checks."""
    if _EXPR_SIGS:
        return
    from spark_rapids_tpu_torch.conf import _import_op_modules
    from spark_rapids_tpu_torch.ops.expr import Expression
    _import_op_modules()
    todo = [Expression]
    while todo:
        cls = todo.pop()
        todo.extend(cls.__subclasses__())
        if cls.__name__.startswith("_") or cls is Expression:
            continue
        _EXPR_SIGS[cls] = (NESTED_128
                           if cls.__module__ in _NESTED_OUTPUT_MODULES
                           else COMMON_128)
    _register_param_checks()


def _register_param_checks() -> None:
    """The reference's per-parameter input signatures
    (``_register_param_checks``): family bases cover their subclasses
    through the MRO walk; irregular operators get entries of their own."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.ops import (
        arithmetic,
        datetime as datetime_ops,
        hashfns,
        math,
        predicates,
        strings,
    )
    STR = TypeSig(T.StringType)
    BOOL = TypeSig(T.BooleanType)
    NUM_DEC = TypeSig(T.ByteType, T.ShortType, T.IntegerType, T.LongType,
                      T.FloatType, T.DoubleType, T.DecimalType)
    NUMERIC = TypeSig(T.ByteType, T.ShortType, T.IntegerType, T.LongType,
                      T.FloatType, T.DoubleType)
    DT_IN = TypeSig(T.DateType, T.TimestampType)
    # the port negates and takes the absolute value of a decimal(>18) on
    # the device (ops/decimal.py's digit tensors); the reference does not
    NUM_DEC128 = TypeSig(T.ByteType, T.ShortType, T.IntegerType,
                         T.LongType, T.FloatType, T.DoubleType,
                         T.DecimalType,
                         max_decimal_precision=T.DecimalType.MAX_PRECISION)

    def chk(cls, *params, rest=None):
        _EXPR_CHECKS[cls] = ExprChecks(params, rest=rest)

    chk(arithmetic.BinaryArithmetic, NUM_DEC, NUM_DEC)
    chk(math.UnaryMath, NUMERIC)
    chk(predicates.BinaryComparison, COMMON_128, COMMON_128)
    for cls in (arithmetic.Abs, arithmetic.UnaryMinus,
                arithmetic.UnaryPositive):
        chk(cls, NUM_DEC128)
    for cls in (math.Ceil, math.Floor):
        chk(cls, NUM_DEC)
    for cls in (math.Pow, math.Hypot, math.Logarithm):
        chk(cls, NUMERIC, NUMERIC)
    for cls in (math.BitwiseAnd, math.BitwiseOr, math.BitwiseXor,
                math.ShiftLeft, math.ShiftRight, math.ShiftRightUnsigned):
        chk(cls, INTEGRAL, INTEGRAL)
    chk(math.BitwiseNot, INTEGRAL)
    for cls in (math.Round, math.BRound, math.RoundCeil, math.RoundFloor):
        chk(cls, NUM_DEC, INTEGRAL)
    chk(predicates.And, BOOL, BOOL)
    chk(predicates.Or, BOOL, BOOL)
    chk(predicates.Not, BOOL)
    chk(predicates.IsNaN, NUMERIC)
    chk(predicates.IsNull, NESTED_128)
    chk(predicates.IsNotNull, NESTED_128)
    for name in ("Upper", "Lower", "Length", "InitCap", "Reverse",
                 "Ascii", "BitLength", "OctetLength", "StringTrim",
                 "StringTrimLeft", "StringTrimRight"):
        chk(getattr(strings, name), STR)
    for name in ("Contains", "StartsWith", "EndsWith", "Like", "RLike",
                 "StringInstr"):
        chk(getattr(strings, name), STR, STR)
    chk(strings.Substring, STR, INTEGRAL, INTEGRAL)
    chk(strings.SubstringIndex, STR, STR, INTEGRAL)
    chk(strings.StringRepeat, STR, INTEGRAL)
    chk(strings.StringReplace, STR, STR, STR)
    chk(strings.StringTranslate, STR, STR, STR)
    chk(strings.StringLocate, STR, STR, INTEGRAL)
    chk(strings.StringLPad, STR, INTEGRAL, STR)
    chk(strings.StringRPad, STR, INTEGRAL, STR)
    chk(strings.Concat, rest=STR)
    chk(strings.RegExpExtract, STR, STR, INTEGRAL)
    chk(strings.RegExpReplace, STR, STR, STR)
    chk(strings.Conv, STR, INTEGRAL, INTEGRAL)
    for name in ("Year", "Month", "DayOfMonth", "DayOfWeek", "DayOfYear",
                 "Quarter", "WeekDay", "LastDay", "Hour", "Minute",
                 "Second", "TsToDate"):
        chk(getattr(datetime_ops, name), DT_IN)
    # the port's hash() of a decimal(>18) is Spark's byte hash of the
    # unscaled value on the device (shuffle/hashing.py's dec128_bytes);
    # the reference sends it to its CPU path
    chk(hashfns.Murmur3Hash, rest=COMMON_128)
    chk(hashfns.XxHash64, rest=COMMON_128)
    chk(datetime_ops.DateAdd, TypeSig(T.DateType), INTEGRAL)
    chk(datetime_ops.DateSub, TypeSig(T.DateType), INTEGRAL)
    chk(datetime_ops.AddMonths, TypeSig(T.DateType), INTEGRAL)
    chk(datetime_ops.DateDiff, TypeSig(T.DateType), TypeSig(T.DateType))


# the exec rows of the generated matrix: the output signature each rule's
# tag checks (every other exec checks COMMON_128, docs.py's default)
for _cls in (P.LocalScan, P.Project, P.CachedRelation):
    register_exec_sig(_cls, NESTED_128)
for _cls in (P.Generate, P.Aggregate):
    register_exec_sig(_cls, COMMON_PLUS_ARRAYS)


def has_rule(kind: str, cls: type) -> bool:
    """Does the tag consult the kill switch
    ``spark.rapids.sql.<kind>.<cls name>``? An exec: a device plan node (or
    a subclass) or a registered file scan (``PlanMeta.tag``); an
    expression: a class with a signature of its own or of a base
    (``check_expr``)."""
    if kind == "exec":
        return issubclass(cls, _DEVICE_NODES) or cls in _FILE_SCANS
    _build_expr_sigs()
    return lookup_mro(_EXPR_SIGS, cls) is not None


def check_expr(e, conf: C.RapidsConf, reasons: List[str],
               context: str = "") -> None:
    """The reference's ``check_expr``: append why a bound expression tree
    cannot run on the device (a class without a device form, its kill
    switch, an output or an input type outside its signatures, a form
    only the CPU route evaluates), recursing into the children and a
    higher-order function's rebound lambda body."""
    _build_expr_sigs()
    cls = type(e)
    where = f"{context}{cls.__name__}"
    sig = lookup_mro(_EXPR_SIGS, cls)
    if sig is None:
        reasons.append(f"expression {where} is not supported on GPU")
        return
    if not conf.is_op_enabled("expression", cls.__name__):
        reasons.append(f"expression {where} is disabled by conf")
        return
    try:
        dt = e.data_type
    except Exception:
        dt = None
    if dt is not None and not sig.supports(dt):
        reasons.append(f"expression {where} produces unsupported type "
                       f"{dt.simple_string()}")
    if not e.device_supported:
        reasons.append(f"expression {where} configuration is not "
                       "supported on GPU")
    checks = lookup_mro(_EXPR_CHECKS, cls)
    for i, c in enumerate(e.children):
        psig = checks.param_sig(i) if checks is not None else None
        try:
            cdt = c.data_type
        except Exception:
            cdt = None
        if cdt is not None and not (psig or NESTED_128).supports(cdt):
            reasons.append(f"expression {where} input {i} has unsupported "
                           f"type {cdt.simple_string()}")
    for c in e.children:
        check_expr(c, conf, reasons, context)
    body = getattr(e, "_rebound", None)
    if body is not None:
        check_expr(body, conf, reasons, context + "lambda body ")


def _check_output_schema(meta: "PlanMeta", nested_ok: str = "") -> None:
    for name, dt in meta.node.output_schema():
        if _host_only_type(dt, nested_ok):
            meta.reasons.append(f"output column {name} has unsupported "
                                f"type {dt.simple_string()}")


def _tag_rule(meta: "PlanMeta") -> None:
    """The rule's own checks of ``meta.node`` (the reference's
    ``_tag_*``)."""
    from spark_rapids_tpu_torch.io.common import FileScanNode
    node, conf, reasons = meta.node, meta.conf, meta.reasons
    if isinstance(node, (P.LocalScan, P.CachedRelation, FileScanNode)):
        _check_output_schema(meta, "nested")
    elif isinstance(node, P.Project):
        _check_output_schema(meta, "nested")
        for e in node.exprs:
            check_expr(e, conf, reasons)
    elif isinstance(node, P.Generate):
        _tag_generate(meta)
    elif isinstance(node, P.Aggregate):
        _tag_aggregate(meta)
    elif isinstance(node, P.Join):
        _tag_join(meta)
    elif isinstance(node, P.WindowNode):
        _tag_window(meta)
    elif isinstance(node, P.Exchange):
        _tag_exchange(meta)
    else:
        _check_output_schema(meta)
        if isinstance(node, P.Filter):
            check_expr(node.condition, conf, reasons)
        elif isinstance(node, (P.Sort, P.TakeOrderedAndProject)):
            for o in node.orders:
                check_expr(o.expr, conf, reasons, "sort key ")
                dt = o.expr.data_type
                if _host_only_type(dt, ""):
                    reasons.append(f"sort key type {dt.simple_string()} "
                                   "not orderable on GPU")
        elif isinstance(node, P.Expand):
            for proj in node.projections:
                for e in proj:
                    check_expr(e, conf, reasons)
        elif isinstance(node, P.WindowGroupLimit):
            for e in node.partition_exprs:
                check_expr(e, conf, reasons, "group-limit partition key ")
            for o in node.orders:
                check_expr(o.expr, conf, reasons, "group-limit order key ")


def _tag_generate(meta: "PlanMeta") -> None:
    from spark_rapids_tpu_torch.columnar.nested import is_nested_type
    from spark_rapids_tpu_torch.ops.collections import (
        check_array,
        is_fixed_array,
    )
    node = meta.node
    check_array(node.gen_child, "a generator")
    _check_output_schema(meta, "arrays")
    check_expr(node.gen_child, meta.conf, meta.reasons, "generator input ")
    if not is_fixed_array(node.gen_child.data_type):
        meta.reasons.append(
            f"generator over {node.gen_child.data_type.simple_string()} "
            "requires fixed-width array elements on GPU")
    child_schema = dict(node.children[0].output_schema())
    for n in node.required:
        if is_nested_type(child_schema[n]):
            meta.reasons.append(
                f"array column {n} passing THROUGH a generator is not "
                "supported on GPU (prune it or explode it)")


def _tag_aggregate(meta: "PlanMeta") -> None:
    from spark_rapids_tpu_torch import types as T
    node = meta.node
    _check_output_schema(meta, "arrays")
    for g in node.grouping:
        check_expr(g, meta.conf, meta.reasons, "grouping key ")
        if isinstance(g.data_type, T.ArrayType):
            meta.reasons.append("array-typed grouping keys are not "
                                "supported on GPU")
        elif _host_only_type(g.data_type, ""):
            raise NotImplementedError(
                f"a grouping key of type {g.data_type.simple_string()} "
                "is not ported")
    for name, fn in node.agg_specs:
        if fn.child is not None:
            check_expr(fn.child, meta.conf, meta.reasons,
                       f"aggregate {name} input ")
        reason = agg_host_reason(name, fn)
        if reason is not None:
            meta.reasons.append(reason)
        else:
            check_agg_supported(fn)


def _tag_join(meta: "PlanMeta") -> None:
    """The reference's join tag; its reasons send the join to the CPU
    route."""
    from spark_rapids_tpu_torch import types as T
    node, reasons = meta.node, meta.reasons
    _check_output_schema(meta)
    jt = node.join_type
    if len(node.left_keys) != len(node.right_keys):
        raise NotImplementedError(
            f"join key count mismatch: {len(node.left_keys)} vs "
            f"{len(node.right_keys)}")
    for k in list(node.left_keys) + list(node.right_keys):
        check_expr(k, meta.conf, reasons, "join key ")
        if _host_only_type(k.data_type, ""):
            reasons.append(f"join key type {k.data_type.simple_string()} "
                           "not supported on GPU")
    for lk, rk in zip(node.left_keys, node.right_keys):
        if lk.data_type != rk.data_type:
            try:
                T.promote(lk.data_type, rk.data_type)
            except TypeError:
                raise NotImplementedError(
                    f"join key types {lk.data_type} vs {rk.data_type} "
                    "incompatible") from None
    if node.condition is not None and not node.left_keys:
        # keyless nested-loop join: the build side is broadcast whole; a
        # KNOWN oversized build must not exhaust the device
        build = node.children[0 if jt == "right" else 1]
        est = build.estimate_bytes()
        limit = 8 * meta.conf.get_entry(C.BROADCAST_SIZE_BYTES)
        if est is not None and est > limit:
            reasons.append(f"nested-loop build side estimate {est}B "
                           f"exceeds 8x broadcastSizeBytes ({limit}B)")
    if node.condition is not None:
        if node.left_keys and jt not in ("inner", "cross"):
            # equi keys + a residual condition on an outer, semi or anti
            # join: a post-filter would change which rows match
            reasons.append(f"non-equi condition on equi {jt} join is not "
                           "supported on GPU")
        else:
            check_expr(node.condition, meta.conf, reasons,
                       "join condition ")


def _tag_window(meta: "PlanMeta") -> None:
    """The reference's window tag: the frame bound from the conf, the
    wide-float gate and a DECIMAL128 input. A column the CPU route
    computes tags the node there; the others raise with the reason (the
    reference's ``eval_window_cpu`` does not run them right)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.execs.window import device_window_supported
    node = meta.node
    _check_output_schema(meta)
    vfa = meta.conf.get_entry(C.VARIABLE_FLOAT_AGG)
    bound = meta.conf.get_entry(C.WINDOW_ROWS_FRAME_MAX_BOUND)
    unported = []
    for name, w in node.window_cols:
        ok, reason, on_host = device_window_supported(
            w, variable_float_agg=vfa, rows_frame_max_bound=bound)
        if not ok:
            if on_host:
                meta.reasons.append(f"window {name}: {reason}")
            else:
                unported.append(f"window {name}: {reason}")
            continue
        if any(T.is_dec128(c.data_type) for c in w.function.children):
            unported.append(f"window {name} over a decimal(>18) input is "
                            "not supported")
        for p in w.spec.partition_exprs:
            check_expr(p, meta.conf, meta.reasons,
                       f"window {name} partition key ")
        for o in w.spec.orders:
            check_expr(o.expr, meta.conf, meta.reasons,
                       f"window {name} order key ")
        for c in w.function.children:
            check_expr(c, meta.conf, meta.reasons, f"window {name} input ")
    if unported:
        raise NotImplementedError("; ".join(unported))


def batch_size_bytes(conf: C.RapidsConf) -> int:
    """``spark.rapids.sql.batchSizeBytes`` where the conf sets it, else
    ``execs/basic.py::BATCH_SIZE_BYTES`` (the reference's default): the
    coalesce target of the aggregate, the sort, the streamed window, a
    join's probe side and the exchange."""
    if C.BATCH_SIZE_BYTES.key in conf.to_dict():
        return conf.batch_size_bytes
    return xbasic.BATCH_SIZE_BYTES


def _convert_window(node: P.WindowNode, child: TpuExec,
                    conf: C.RapidsConf) -> TpuExec:
    """The reference's five routes (execs/window.py's docstring): the
    bounded-frame stream, the two-pass window, keyed batching when every
    column shares its partition keys, the running stream of a
    partition-less running window, and the one-batch window for the
    rest."""
    from spark_rapids_tpu_torch.execs.window import (
        TpuKeyedBatchExec,
        TpuWindowExec,
    )
    target = conf.get_entry(C.WINDOW_STREAM_TARGET_ROWS)
    probe = TpuWindowExec(child, node.window_cols, stream_target_rows=target)
    if probe._bounded_ctx() is not None or probe._two_pass_able():
        # each input batch becomes a sorted host run, or the aggregate
        # and the join read the batches: no coalesce
        return probe
    specs = [w.spec for _, w in node.window_cols]
    keys0 = [p.key() for p in specs[0].partition_exprs]
    if keys0 and all([p.key() for p in s.partition_exprs] == keys0
                     for s in specs):
        return TpuWindowExec(
            TpuKeyedBatchExec(child, specs[0].partition_exprs),
            node.window_cols, per_batch=True)
    if probe._streamable():
        coalesced = TpuCoalesceExec(child,
                                    target_bytes=batch_size_bytes(conf))
    else:
        coalesced = TpuCoalesceExec(child, require_single=True)
    return TpuWindowExec(coalesced, node.window_cols,
                         stream_target_rows=target)


def _tag_exchange(meta: "PlanMeta") -> None:
    node = meta.node
    _check_output_schema(meta)
    if node.partitioning not in ("hash", "range", "roundrobin", "single"):
        raise NotImplementedError(
            f"partitioning {node.partitioning} is not supported")
    if node.partitioning == "hash" and not node.keys:
        raise NotImplementedError("hash partitioning requires keys")
    for k in node.keys:
        check_expr(k, meta.conf, meta.reasons, "partition key ")
    if not meta.reasons:
        # the exchange still runs on the device, but a mesh-requested
        # exchange that takes the host shuffle states why here; the exec
        # acts on the same static reason (hostShuffleFallbacks)
        from spark_rapids_tpu_torch.execs.exchange import (
            collective_applicable,
            ici_demotion_reason,
            ici_requested,
        )
        if ici_requested(meta.conf) and collective_applicable(
                node.partitioning, node.num_partitions):
            reason = ici_demotion_reason(
                meta.conf, node.partitioning, node.num_partitions,
                node.children[0].output_schema())
            if reason is not None:
                meta.notes.append(f"host-shuffle fallback: {reason}")


def _mesh_root_notes(meta: "PlanMeta") -> None:
    """The root's advisory mesh notes (the query still runs on the
    device): an attempt the mesh ladder suppressed to single-device
    landing, or a mesh running below its declared strength."""
    from spark_rapids_tpu_torch.parallel.mesh import (
        MESH,
        suppression_reason,
    )
    if not bool(meta.conf.get_entry(C.MESH_ENABLED)):
        return
    sup = suppression_reason()
    degraded = MESH.degraded_reason()
    if sup is not None:
        meta.notes.append(f"mesh demoted: {sup}")
    elif degraded is not None:
        snap = MESH.health_snapshot()
        meta.notes.append(
            f"mesh degraded: running on the {snap['shape']}-device "
            f"surviving mesh (excluded device ids "
            f"{snap['excludedDeviceIds']}): {degraded}")


def _insert_window_group_limits(node: P.PlanNode) -> P.PlanNode:
    """The WindowGroupLimit rewrite (Spark 3.5's InsertWindowGroupLimit):
    Filter(rank_col <= k, < k or = k) directly above a WindowNode whose
    rank_col is row_number, rank or dense_rank admits a pre-window group
    limit, as long as EVERY window column of the node is a ranking
    function over the same spec (a sibling over another spec, or a
    non-ranking function, would see only the surviving rows). Builds a
    new tree: plan nodes are shared across collects."""
    import copy

    from spark_rapids_tpu_torch.ops.expr import BoundReference, Literal
    from spark_rapids_tpu_torch.ops.predicates import (
        EqualTo,
        LessThan,
        LessThanOrEqual,
    )
    from spark_rapids_tpu_torch.ops.window import RANK_KINDS

    if isinstance(node, P.CachedRelation):
        return node  # its child is planned when it materializes
    new_children = [_insert_window_group_limits(c) for c in node.children]
    if any(a is not b for a, b in zip(new_children, node.children)):
        node = copy.copy(node)
        node.children = tuple(new_children)
    if not isinstance(node, P.Filter) or not isinstance(
            node.children[0], P.WindowNode):
        return node
    cond = node.condition
    if not isinstance(cond, (LessThan, LessThanOrEqual, EqualTo)):
        return node
    lhs, rhs = cond.children
    if not (isinstance(lhs, BoundReference) and isinstance(rhs, Literal)):
        return node
    win = node.children[0]
    wi = lhs.ordinal - len(win.children[0].output_schema())
    if not 0 <= wi < len(win.window_cols):
        return node
    w = win.window_cols[wi][1]
    kind = RANK_KINDS.get(type(w.function))
    if kind is None or not w.spec.orders:
        return node
    for _, other in win.window_cols:
        if type(other.function) not in RANK_KINDS or \
                other.spec.key() != w.spec.key():
            return node
    try:
        k = int(rhs.value)
    except (TypeError, ValueError):
        return node
    if isinstance(cond, LessThan):
        k -= 1  # (rank = k admits keeping rank <= k as it is)
    if k < 1:
        return node
    wgl = P.WindowGroupLimit(win.children[0], w.spec.partition_exprs,
                             w.spec.orders, kind, k)
    new_win = copy.copy(win)
    new_win.children = (wgl,)
    new_filter = copy.copy(node)
    new_filter.children = (new_win,)
    return new_filter


def _convert_aggregate(node: P.Aggregate, child: TpuExec,
                       conf: C.RapidsConf) -> TpuExec:
    # under spark.rapids.tpu.agg.fuseInput (the default) the Project/
    # Filter chain below fuses into the aggregate; its input then
    # coalesces to the batch-size target, so only inputs past it stream
    # through the partial-per-batch merge
    ngroup = len(node.grouping)
    grouping, agg_specs, filters = (list(node.grouping),
                                    list(node.agg_specs), [])
    if conf.get_entry(C.AGG_FUSE_INPUT):
        exprs = grouping + [fn for _, fn in agg_specs]
        child, exprs, filters = peel_input_chain(child, exprs)
        grouping = exprs[:ngroup]
        agg_specs = [(n, fn) for (n, _), fn in
                     zip(node.agg_specs, exprs[ngroup:])]
    from spark_rapids_tpu_torch.ops.aggregates import SORT_ONLY_AGGS
    if any(isinstance(fn, SORT_ONLY_AGGS) for _, fn in agg_specs):
        # collect and percentile have no merge decomposition: one
        # coalesced batch (the reference's rules.py)
        coalesced = TpuCoalesceExec(child, require_single=True)
    else:
        coalesced = TpuCoalesceExec(child,
                                    target_bytes=batch_size_bytes(conf))
    return TpuHashAggregateExec(
        coalesced,
        grouping, agg_specs, node.grouping_names, filters=filters,
        max_dict_groups=conf.get_entry(C.AGG_MAX_DICT_GROUPS),
        max_domain_groups=conf.get_entry(C.AGG_MAX_KEY_DOMAIN_GROUPS))


def _convert_generate(node: P.Generate, children) -> TpuExec:
    from spark_rapids_tpu_torch.execs.generate import TpuGenerateExec
    return TpuGenerateExec(children[0], node.gen_child, node.pos,
                           node.outer, node.out_names, node.required)


def _convert_join(node: P.Join, children, conf: C.RapidsConf) -> TpuExec:
    """A keyless join with a condition, or a keyless join of any type but
    cross, runs as a broadcast nested-loop join. Otherwise the build side
    (the left one for a right outer join, else the right one) is broadcast
    when its size estimate is under the threshold; else, under
    ``spark.rapids.sql.adaptive.enabled``, AQE's build decides at run
    time from its measured bytes (``TpuAdaptiveBuildExec``), and without
    AQE it is coalesced into one batch. The probe side streams through a
    coalesce. Key pairs of different types cast to their common type."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.ops.cast import Cast, check_cast
    lkeys, rkeys = list(node.left_keys), list(node.right_keys)
    for i, (lk, rk) in enumerate(zip(lkeys, rkeys)):
        if lk.data_type != rk.data_type:
            target = T.promote(lk.data_type, rk.data_type)
            for keys, k in ((lkeys, lk), (rkeys, rk)):
                if k.data_type != target:
                    check_cast(k.data_type, target)
                    keys[i] = Cast(k, target)
    jt = node.join_type
    swapped = jt == "right"
    lschema = node.children[0].output_schema()
    rschema = node.children[1].output_schema()
    target = batch_size_bytes(conf)
    if not lkeys and (node.condition is not None or jt != "cross"):
        if swapped:
            left = TpuBroadcastExchangeExec(children[0])
            right = TpuCoalesceExec(children[1], target_bytes=target)
        else:
            left = TpuCoalesceExec(children[0], target_bytes=target)
            right = TpuBroadcastExchangeExec(children[1])
        budget = (conf.get_entry(C.NLJ_PAIR_BUDGET)
                  if C.NLJ_PAIR_BUDGET.key in conf.to_dict() else None)
        return TpuNestedLoopJoinExec(left, right, node.join_type,
                                     node.condition, lschema, rschema,
                                     pair_budget=budget)
    build_node = node.children[0] if swapped else node.children[1]
    est = build_node.estimate_bytes()
    threshold = conf.get_entry(C.BROADCAST_SIZE_BYTES)

    def wrap_build(child):
        if est is not None and est <= threshold:
            return TpuBroadcastExchangeExec(child)
        if conf.get_entry(C.ADAPTIVE_ENABLED):
            return TpuAdaptiveBuildExec(child, threshold)
        return TpuCoalesceExec(child, require_single=True)

    if swapped:
        left = wrap_build(children[0])
        right = TpuCoalesceExec(children[1], target_bytes=target)
    else:
        left = TpuCoalesceExec(children[0], target_bytes=target)
        right = wrap_build(children[1])
    join = TpuJoinExec(
        left, right, node.join_type, lkeys, rkeys, node.condition, lschema,
        rschema, direct_table_mult=conf.get_entry(C.JOIN_DIRECT_TABLE_MULT),
        hashprobe_attempts=conf.get_entry(C.KERNELS_HASHPROBE_ATTEMPTS),
        subpartition_bytes=conf.get_entry(C.JOIN_SUBPARTITION_BYTES),
        max_subpartitions=conf.get_entry(C.JOIN_MAX_SUBPARTITIONS))
    if isinstance(right, TpuBroadcastExchangeExec) and not swapped and \
            conf.get_entry(C.DPP_ENABLED):
        # only inner and leftsemi qualify (checked inside), so the probe
        # is always the left side here
        _maybe_install_dpp(jt, left, right, lkeys, rkeys)
    return join


def _maybe_install_dpp(jt: str, probe_exec, build_exec, probe_keys,
                       build_keys) -> None:
    """Dynamic partition pruning (reference: DynamicPruningExpression and
    SubqueryBroadcast planned into GpuFileSourceScanExec's
    partitionFilters; dpp_test.py): when the probe side of a BROADCAST
    join scans a Hive-partitioned source and a join key resolves to a
    partition column, install a pruning filter on the scan exec that
    reads the build side's distinct non-null key values from the
    broadcast's cached batch, so the probe skips the partitions that
    cannot match. Only join types that drop unmatched probe rows
    qualify. The walk goes through coalesce, filter and project execs to
    the file scan, as the reference's does: a probe key under a Cast (a
    key pair of different types) is no BoundReference and installs
    nothing."""
    from spark_rapids_tpu_torch.ops.expr import Alias, BoundReference

    if jt not in ("inner", "leftsemi"):
        return
    for pk, bk in zip(probe_keys, build_keys):
        e = pk
        while isinstance(e, Alias):
            e = e.children[0]
        if not isinstance(e, BoundReference):
            continue
        ordinal = e.ordinal
        cur = probe_exec
        scan_exec = None
        while True:
            if isinstance(cur, (TpuCoalesceExec, TpuFilterExec)):
                cur = cur.children[0]
            elif isinstance(cur, TpuProjectExec):
                pe = cur.exprs[ordinal]
                while isinstance(pe, Alias):
                    pe = pe.children[0]
                if not isinstance(pe, BoundReference):
                    break
                ordinal = pe.ordinal
                cur = cur.children[0]
            elif isinstance(cur, xbasic.TpuFileScanExec):
                scan_exec = cur
                break
            else:
                break
        if scan_exec is None:
            continue
        scan_node = scan_exec.scan_node
        schema = scan_node.output_schema()
        if ordinal >= len(schema):
            continue
        col_name = schema[ordinal][0]
        scan_node._resolve_schemas()
        if col_name not in {n for n, _ in scan_node._partition_schema or []}:
            continue
        scan_exec.install_dynamic_pruning(
            col_name, _broadcast_key_values(build_exec, bk))


def _broadcast_key_values(build_exec, key):
    """The provider of a pruning filter: the build key's distinct non-null
    values, read back from the broadcast's cached batch (a host sync by
    design). A string key decodes through its dictionary to values."""
    def provider():
        from spark_rapids_tpu_torch.ops.expr import compile_project
        allowed = set()
        for bt in build_exec.execute():
            host = compile_project([key], bt)[0].to_host(bt.num_rows)
            for v, ok in zip(host.data, host.validity):
                if ok:
                    allowed.add(v.item() if hasattr(v, "item") else v)
            del bt
        return allowed
    return provider


class PlanMeta:
    """The reference's RapidsMeta for plan nodes: the node, its reasons
    to run on the CPU route and its advisory notes, and its children's
    metas (a cached relation is a planning leaf: its child runs through
    the session when it materializes)."""

    def __init__(self, node: P.PlanNode, conf: C.RapidsConf,
                 parent: Optional["PlanMeta"] = None):
        self.node = node
        self.conf = conf
        self.parent = parent
        self.reasons: List[str] = []
        self.notes: List[str] = []
        self.children = [] if isinstance(node, P.CachedRelation) else [
            PlanMeta(c, conf, self) for c in node.children]

    def tag(self) -> None:
        """The reference's order: a node without a device rule; the
        CPU-only latch's reason (runtime/health.py: not gated, a latched
        device cannot be dispatched to); the circuit breaker's demotion
        (runtime/faults.py, gated by ``runtimeFallback.enabled``); the
        kill switch; then the rule's own checks."""
        from spark_rapids_tpu_torch.runtime.faults import CIRCUIT_BREAKER
        from spark_rapids_tpu_torch.runtime.health import HEALTH
        name = type(self.node).__name__
        cpu_only = HEALTH.cpu_only_reason()
        if self.parent is None:
            _mesh_root_notes(self)
        demoted = CIRCUIT_BREAKER.demotion_reason(name)
        if not isinstance(self.node, _DEVICE_NODES) and \
                type(self.node) not in _FILE_SCANS:
            self.reasons.append(f"exec {self.node.name} is not supported "
                                "on GPU")
        elif cpu_only is not None:
            self.reasons.append(cpu_only)
        elif demoted is not None and \
                self.conf.get_entry(C.RUNTIME_FALLBACK_ENABLED):
            self.reasons.append(demoted)
        elif not self.conf.is_op_enabled("exec", name):
            self.reasons.append(f"exec {self.node.name} is disabled by conf")
        else:
            _tag_rule(self)
        for c in self.children:
            c.tag()

    @property
    def can_run_on_gpu(self) -> bool:
        return not self.reasons

    def explain(self, indent: int = 0, only_fallback: bool = True) -> str:
        """The reference's rendering: ``*`` on the device, ``!`` on the
        CPU route with its reasons."""
        mark = "*" if self.can_run_on_gpu else "!"
        line = "  " * indent + f"{mark} {self.node.describe()}"
        if self.reasons:
            line += "  <-- " + "; ".join(self.reasons)
        if self.notes:
            line += "  (" + "; ".join(self.notes) + ")"
        out = [line] if (not only_fallback or self.reasons or self.notes
                         or indent == 0) else [
            "  " * indent + f"{mark} {self.node.describe()}"]
        for c in self.children:
            out.append(c.explain(indent + 1, only_fallback))
        return "\n".join(out)


def wrap_plan(plan: P.PlanNode, conf: C.RapidsConf) -> PlanMeta:
    """The tagged meta tree of ``plan`` after column pruning and the
    window group-limit rewrite (where and in the order the reference's
    ``apply_overrides`` runs them)."""
    # the mesh must reflect THIS conf before tagging: the exchange's
    # demotion reasons read its size
    from spark_rapids_tpu_torch.parallel.mesh import MESH
    MESH.configure(conf)
    meta = PlanMeta(_insert_window_group_limits(prune_plan(plan)), conf)
    meta.tag()
    return meta


def _convert_meta(meta: PlanMeta, device):
    """A device exec for a meta without reasons, else the host plan node;
    transitions join the two sides."""
    children = [_convert_meta(c, device) for c in meta.children]
    if meta.can_run_on_gpu:
        dev_children = [c if isinstance(c, TpuExec)
                        else HostToDevice(c, device) for c in children]
        out = _convert_node(meta.node, dev_children, meta.conf, device)
        # the runtime-failure attribution unit (runtime/faults.py): the
        # plan node class this exec was converted from, which the circuit
        # breaker counts; helper execs a rule builds (coalesce wrappers)
        # carry none
        out._plan_origin = type(meta.node).__name__
        return out
    host_children = [
        InputAdapter(DeviceToHost(c), cm.node.output_schema())
        if isinstance(c, TpuExec) else c
        for c, cm in zip(children, meta.children)]
    if not host_children:
        return meta.node
    node = copy.copy(meta.node)
    node.children = tuple(host_children)
    return node


def _convert_node(node: P.PlanNode, children, conf: C.RapidsConf,
                  device) -> TpuExec:
    policy = BucketPolicy(conf.get_entry(C.SHAPE_BUCKETS_MIN))
    cache = bool(conf.get_entry(C.SCAN_DEVICE_CACHE))
    if isinstance(node, P.CachedRelation):
        # a planning leaf: its child ran (once) through the session
        return TpuScanExec([node.materialize()], device, policy,
                           device_cache=cache)
    if isinstance(node, P.LocalScan):
        return TpuScanExec(node.batches, device, policy, node.columns,
                           device_cache=cache)
    if type(node) in _FILE_SCANS:
        return xbasic.TpuFileScanExec(node, device, policy)
    if isinstance(node, P.RangeNode):
        return xbasic.TpuRangeExec(node.start, node.end, node.step,
                                   node.batch_rows, node.col_name, device,
                                   policy)
    if isinstance(node, P.Union):
        return xbasic.TpuUnionExec(children)
    if isinstance(node, P.Expand):
        return xbasic.TpuExpandExec(children[0], node.projections,
                                    node.names)
    if isinstance(node, P.Sample):
        return xbasic.TpuSampleExec(children[0], node.fraction, node.seed)
    if isinstance(node, P.Project):
        return TpuProjectExec(children[0], node.exprs, node.names)
    if isinstance(node, P.Generate):
        return _convert_generate(node, children)
    if isinstance(node, P.Filter):
        return TpuFilterExec(children[0], node.condition)
    if isinstance(node, P.Aggregate):
        return _convert_aggregate(node, children[0], conf)
    if isinstance(node, P.Join):
        return _convert_join(node, children, conf)
    if isinstance(node, P.Limit):
        return TpuLimitExec(children[0], node.limit)
    if isinstance(node, P.TakeOrderedAndProject):
        return TpuTakeOrderedAndProjectExec(children[0], node.orders,
                                            node.limit)
    if isinstance(node, P.WindowNode):
        return _convert_window(node, children[0], conf)
    if isinstance(node, P.WindowGroupLimit):
        from spark_rapids_tpu_torch.execs.window import (
            TpuWindowGroupLimitExec,
        )
        return TpuWindowGroupLimitExec(children[0], node.partition_exprs,
                                       node.orders, node.rank_kind,
                                       node.limit)
    if isinstance(node, P.Exchange):
        from spark_rapids_tpu_torch.execs.exchange import (
            TpuShuffleExchangeExec,
        )
        return TpuShuffleExchangeExec(children[0], node.partitioning,
                                      node.num_partitions, node.keys, conf,
                                      target_batch_bytes=batch_size_bytes(
                                          conf))
    # a global and a per-partition (local) sort convert alike, as the
    # reference's: one process sorts the partitions' views together. The
    # pre-sort coalesce stops at the out-of-core threshold (past it, the
    # sort merges sorted host runs)
    threshold = conf.get_entry(C.SORT_OOC_THRESHOLD)
    return TpuSortExec(TpuCoalesceExec(
        children[0], target_bytes=min(batch_size_bytes(conf), threshold)),
        node.orders, ooc_threshold_bytes=threshold)


def convert_meta(meta: PlanMeta, device) -> TpuExec:
    """The executable of a tagged plan, every exec numbered by its plan
    position (pre-order from 1); a root on the CPU route is collected on
    the host (``CpuRootExec``)."""
    from spark_rapids_tpu_torch.lore import assign_lore_ids
    from spark_rapids_tpu_torch.parallel.mesh import MESH
    root = _convert_meta(meta, device)
    if not isinstance(root, TpuExec):
        root = CpuRootExec(root)
    assign_lore_ids(root)
    if MESH.enabled:
        # mesh-native execution: sharded batches flow only into the narrow
        # operators and the exchange; every other consumer re-lands them
        # (execs/mesh.py). Part of the converted tree, so the executable
        # cache keeps it with the mesh generation it was planned under
        from spark_rapids_tpu_torch.execs.mesh import insert_mesh_relands
        root = insert_mesh_relands(root, device)
    return root


def convert(node: P.PlanNode, conf: C.RapidsConf, device) -> TpuExec:
    """Tag ``node`` (``wrap_plan``), let the cost-based optimizer revert
    it (overrides/optimizer.py) and convert it (``convert_meta``)."""
    from spark_rapids_tpu_torch.overrides.optimizer import apply_cbo
    meta = wrap_plan(node, conf)
    apply_cbo(meta, conf)
    return convert_meta(meta, device)


def collect_cpu_nodes(root) -> List[str]:
    """The plan-node classes an executable runs on the CPU route, in plan
    order (0 of them on a plan that runs wholly on the device)."""
    out: List[str] = []

    def host(node):
        if isinstance(node, InputAdapter):
            dev(node.source)
            return
        out.append(type(node).__name__)
        for c in node.children:
            host(c)

    def dev(e):
        if isinstance(e, (HostToDevice, CpuRootExec)):
            host(e.cpu_node)
            return
        for c in e.children:
            dev(c)

    dev(root)
    return out


def explain_plan(plan: P.PlanNode, conf: C.RapidsConf) -> str:
    """The tagged tree of ``plan`` as given (as the reference's
    ``explain_plan``: before column pruning and the window rewrite, which
    an execute applies first): every node in ALL mode, else the nodes
    with reasons or notes named in full."""
    from spark_rapids_tpu_torch.parallel.mesh import MESH
    MESH.configure(conf)
    meta = PlanMeta(plan, conf)
    meta.tag()
    return meta.explain(only_fallback=conf.explain_mode != "ALL")
