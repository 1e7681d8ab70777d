"""Tag and convert plan nodes into device execs (port of the LocalScan,
file scan (``register_file_scan``, ``_convert_file_scan``), RangeNode,
Project, Filter, Aggregate, Sort, Join, Limit, Union, Expand, Sample,
CachedRelation, TakeOrderedAndProject, WindowNode, WindowGroupLimit and
Exchange rules of
``spark_rapids_tpu/overrides/rules.py``, the column pruning and the
window group-limit rewrite its ``apply_overrides`` runs first, and
``lore.assign_lore_ids``: every exec gets its plan position, pre-order
from 1).

The reference tags each node and falls back to the CPU where a node or
expression is unsupported; the port has no fallback, so tagging raises
NotImplementedError naming what is missing, before anything runs, and a
plan node the circuit breaker tripped raises KernelCrashError there
(runtime/faults.py). Each converted exec carries the plan-node class it
came from (``_plan_origin``, the breaker's unit), and a broadcast inner or
left-semi join installs dynamic partition pruning on its probe side's
file scan (``_maybe_install_dpp``)."""

from __future__ import annotations

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.columnar import BucketPolicy
from spark_rapids_tpu_torch.execs.aggregate import (
    TpuHashAggregateExec,
    check_agg_supported,
)
from spark_rapids_tpu_torch.execs import basic as xbasic
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.execs.basic import (
    TpuCoalesceExec,
    TpuFilterExec,
    TpuLimitExec,
    TpuProjectExec,
    TpuScanExec,
)
from spark_rapids_tpu_torch.execs.broadcast import (
    TpuBroadcastExchangeExec,
    TpuNestedLoopJoinExec,
)
from spark_rapids_tpu_torch.execs.fuse import peel_input_chain
from spark_rapids_tpu_torch.execs.join import TpuJoinExec
from spark_rapids_tpu_torch.execs.sort import (
    TpuSortExec,
    TpuTakeOrderedAndProjectExec,
)
from spark_rapids_tpu_torch.overrides.pruning import prune_plan
from spark_rapids_tpu_torch.plan import nodes as P


#: FileScanNode subclasses with a device rule (io/__init__.py registers
#: them when the io package imports)
_FILE_SCANS: dict = {}


def register_file_scan(cls) -> None:
    """Register a FileScanNode subclass; its kill switch is
    ``spark.rapids.sql.exec.<ClassName>`` (conf.FILE_SCAN_ENABLED)."""
    _FILE_SCANS[cls] = C.FILE_SCAN_ENABLED[cls.format_name]


def _tag_file_scan(node, conf: C.RapidsConf) -> None:
    entry = _FILE_SCANS.get(type(node))
    if entry is None:
        raise NotImplementedError(
            f"{type(node).__name__} scans are not ported to "
            "spark_rapids_tpu_torch")
    if not conf.get_entry(entry):
        raise NotImplementedError(
            f"exec {type(node).__name__} is disabled by conf ({entry.key}="
            "false) and the port has no CPU route for it")


def _convert_file_scan(node, device, policy) -> TpuExec:
    return xbasic.TpuFileScanExec(node, device, policy)


def _tag(node: P.PlanNode, conf: C.RapidsConf) -> None:
    from spark_rapids_tpu_torch.io.common import FileScanNode
    from spark_rapids_tpu_torch.runtime.faults import CIRCUIT_BREAKER
    CIRCUIT_BREAKER.check(type(node).__name__)
    if isinstance(node, FileScanNode):
        _tag_file_scan(node, conf)
    elif isinstance(node, P.Aggregate):
        for _, fn in node.agg_specs:
            check_agg_supported(fn)
    elif isinstance(node, P.Sort) and not node.global_sort:
        raise NotImplementedError("a per-partition (local) sort is not ported")
    elif isinstance(node, P.Join):
        _tag_join(node, conf)
    elif isinstance(node, P.WindowNode):
        _tag_window(node, conf)
    elif isinstance(node, P.Exchange):
        _tag_exchange(node)
    elif not isinstance(node, (P.LocalScan, P.Project, P.Filter, P.Sort,
                               P.Limit, P.TakeOrderedAndProject,
                               P.WindowGroupLimit, P.RangeNode, P.Union,
                               P.Expand, P.Sample, P.CachedRelation)):
        raise NotImplementedError(
            f"plan node {node.name} is not ported to spark_rapids_tpu_torch")


def _tag_join(node: P.Join, conf: C.RapidsConf) -> None:
    """The reference's join tag: where it falls back to the CPU, the port
    raises with its reason."""
    from spark_rapids_tpu_torch import types as T
    jt = node.join_type
    if len(node.left_keys) != len(node.right_keys):
        raise NotImplementedError(
            f"join key count mismatch: {len(node.left_keys)} vs "
            f"{len(node.right_keys)}")
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
        limit = 8 * conf.get_entry(C.BROADCAST_SIZE_BYTES)
        if est is not None and est > limit:
            raise NotImplementedError(
                f"nested-loop build side estimate {est}B exceeds "
                f"8x broadcastSizeBytes ({limit}B)")
    if node.condition is not None and node.left_keys and \
            jt not in ("inner", "cross"):
        # equi keys + a residual condition on an outer, semi or anti join:
        # a post-filter would change which rows match
        raise NotImplementedError(
            f"non-equi condition on equi {jt} join is not supported")


def _tag_window(node: P.WindowNode, conf: C.RapidsConf) -> None:
    """The reference's window tag: the frame bound from the conf, the
    wide-float gate and a DECIMAL128 input; where it falls back to the
    CPU, the port raises with its reason."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.execs.window import device_window_supported
    vfa = conf.get_entry(C.VARIABLE_FLOAT_AGG)
    bound = conf.get_entry(C.WINDOW_ROWS_FRAME_MAX_BOUND)
    reasons = []
    for name, w in node.window_cols:
        ok, reason = device_window_supported(
            w, variable_float_agg=vfa, rows_frame_max_bound=bound)
        if not ok:
            reasons.append(f"window {name}: {reason}")
            continue
        if any(T.is_dec128(c.data_type) for c in w.function.children):
            reasons.append(f"window {name} over a decimal(>18) input is "
                           "not supported")
    if reasons:
        raise NotImplementedError("; ".join(reasons))


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
                                    target_bytes=xbasic.BATCH_SIZE_BYTES)
    else:
        coalesced = TpuCoalesceExec(child, require_single=True)
    return TpuWindowExec(coalesced, node.window_cols,
                         stream_target_rows=target)


def _tag_exchange(node: P.Exchange) -> None:
    if node.partitioning not in ("hash", "range", "roundrobin", "single"):
        raise NotImplementedError(
            f"partitioning {node.partitioning} is not supported")
    if node.partitioning == "hash" and not node.keys:
        raise NotImplementedError("hash partitioning requires keys")
    if node.partitioning == "range":
        raise NotImplementedError(
            "range partitioning (RangePartitioner's sampled bounds) is not "
            "ported")


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
    # the Project/Filter chain below fuses into the aggregate (the
    # reference's spark.rapids.tpu.agg.fuseInput default); its input then
    # coalesces to the batch-size target, so only inputs past it stream
    # through the partial-per-batch merge
    ngroup = len(node.grouping)
    exprs = list(node.grouping) + [fn for _, fn in node.agg_specs]
    child, exprs, filters = peel_input_chain(child, exprs)
    grouping = exprs[:ngroup]
    agg_specs = [(n, fn) for (n, _), fn in zip(node.agg_specs, exprs[ngroup:])]
    return TpuHashAggregateExec(
        TpuCoalesceExec(child, target_bytes=xbasic.BATCH_SIZE_BYTES),
        grouping, agg_specs, node.grouping_names, filters=filters,
        max_dict_groups=conf.get_entry(C.AGG_MAX_DICT_GROUPS),
        max_domain_groups=conf.get_entry(C.AGG_MAX_KEY_DOMAIN_GROUPS))


def _convert_join(node: P.Join, children, conf: C.RapidsConf) -> TpuExec:
    """A keyless join with a condition, or a keyless join of any type but
    cross, runs as a broadcast nested-loop join. Otherwise the build side
    (the left one for a right outer join, else the right one) is broadcast
    when its size estimate is under the threshold, else coalesced into one
    batch, and the probe side streams through a coalesce. Key pairs of
    different types cast to their common type."""
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
    if not lkeys and (node.condition is not None or jt != "cross"):
        if swapped:
            left = TpuBroadcastExchangeExec(children[0])
            right = TpuCoalesceExec(children[1])
        else:
            left = TpuCoalesceExec(children[0])
            right = TpuBroadcastExchangeExec(children[1])
        return TpuNestedLoopJoinExec(left, right, node.join_type,
                                     node.condition, lschema, rschema)
    build_node = node.children[0] if swapped else node.children[1]
    est = build_node.estimate_bytes()

    def wrap_build(child):
        if est is not None and est <= conf.get_entry(C.BROADCAST_SIZE_BYTES):
            return TpuBroadcastExchangeExec(child)
        return TpuCoalesceExec(child, require_single=True)

    if swapped:
        left, right = wrap_build(children[0]), TpuCoalesceExec(children[1])
    else:
        left, right = TpuCoalesceExec(children[0]), wrap_build(children[1])
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


def _convert(node: P.PlanNode, conf: C.RapidsConf, device) -> TpuExec:
    out = _convert_node(node, conf, device)
    # the runtime-failure attribution unit (runtime/faults.py): the plan
    # node class this exec was converted from, which the circuit breaker
    # counts; helper execs a rule builds (coalesce wrappers) carry none
    out._plan_origin = type(node).__name__
    return out


def _convert_node(node: P.PlanNode, conf: C.RapidsConf, device) -> TpuExec:
    _tag(node, conf)
    policy = BucketPolicy(conf.get_entry(C.SHAPE_BUCKETS_MIN))
    if isinstance(node, P.CachedRelation):
        # a planning leaf: its child ran (once) through the session
        return TpuScanExec([node.materialize()], device, policy)
    children = [_convert(c, conf, device) for c in node.children]
    if isinstance(node, P.LocalScan):
        return TpuScanExec(node.batches, device, policy, node.columns)
    if type(node) in _FILE_SCANS:
        return _convert_file_scan(node, device, policy)
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
                                      node.num_partitions, node.keys)
    # the pre-sort coalesce stops at the out-of-core threshold, as the
    # reference's (past it, the sort merges sorted host runs)
    threshold = conf.get_entry(C.SORT_OOC_THRESHOLD)
    return TpuSortExec(TpuCoalesceExec(
        children[0], target_bytes=min(xbasic.BATCH_SIZE_BYTES, threshold)),
        node.orders, ooc_threshold_bytes=threshold)


def convert(node: P.PlanNode, conf: C.RapidsConf, device) -> TpuExec:
    """The device exec tree for ``node`` after column pruning and the
    window group-limit rewrite (where and in the order the reference's
    ``apply_overrides`` runs them), every exec numbered by its plan
    position (pre-order from 1)."""
    from spark_rapids_tpu_torch.lore import assign_lore_ids
    root = _convert(_insert_window_group_limits(prune_plan(node)), conf,
                    device)
    assign_lore_ids(root)
    return root
