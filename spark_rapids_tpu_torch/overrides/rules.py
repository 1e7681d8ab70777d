"""Tag and convert plan nodes into device execs (port of the LocalScan,
Project, Filter, Aggregate, Sort, Join and TakeOrderedAndProject rules of
``spark_rapids_tpu/overrides/rules.py``, and of ``lore.assign_lore_ids``:
every exec gets its plan position, pre-order from 1).

The reference tags each node and falls back to the CPU where a node or
expression is unsupported; the port has no fallback, so tagging raises
NotImplementedError naming what is missing, before anything runs."""

from __future__ import annotations

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch.columnar import BucketPolicy
from spark_rapids_tpu_torch.execs.aggregate import (
    TpuHashAggregateExec,
    check_agg_supported,
)
from spark_rapids_tpu_torch.execs.base import TpuExec
from spark_rapids_tpu_torch.execs.basic import (
    TpuCoalesceExec,
    TpuFilterExec,
    TpuProjectExec,
    TpuScanExec,
)
from spark_rapids_tpu_torch.execs.broadcast import TpuBroadcastExchangeExec
from spark_rapids_tpu_torch.execs.fuse import peel_input_chain
from spark_rapids_tpu_torch.execs.join import TpuJoinExec
from spark_rapids_tpu_torch.execs.sort import (
    TpuSortExec,
    TpuTakeOrderedAndProjectExec,
)
from spark_rapids_tpu_torch.plan import nodes as P


def _tag(node: P.PlanNode) -> None:
    if isinstance(node, P.Aggregate):
        for _, fn in node.agg_specs:
            check_agg_supported(fn)
    elif isinstance(node, P.Sort) and not node.global_sort:
        raise NotImplementedError("a per-partition (local) sort is not ported")
    elif isinstance(node, P.Join):
        jt = node.join_type.lower().replace("_", "")
        if jt != "inner" or not node.left_keys or node.condition is not None:
            raise NotImplementedError(
                f"{node.join_type} join"
                f"{' with a condition' if node.condition is not None else ''}"
                " is not ported (inner equi-joins only)")
    elif isinstance(node, P.Limit):
        raise NotImplementedError("a LIMIT without an ORDER BY (CollectLimit) "
                                  "is not ported")
    elif not isinstance(node, (P.LocalScan, P.Project, P.Filter, P.Sort,
                               P.TakeOrderedAndProject)):
        raise NotImplementedError(
            f"plan node {node.name} is not ported to spark_rapids_tpu_torch")


def _convert_aggregate(node: P.Aggregate, child: TpuExec,
                       conf: C.RapidsConf) -> TpuExec:
    # the Project/Filter chain below fuses into the aggregate (the
    # reference's spark.rapids.tpu.agg.fuseInput default)
    ngroup = len(node.grouping)
    exprs = list(node.grouping) + [fn for _, fn in node.agg_specs]
    child, exprs, filters = peel_input_chain(child, exprs)
    grouping = exprs[:ngroup]
    agg_specs = [(n, fn) for (n, _), fn in zip(node.agg_specs, exprs[ngroup:])]
    return TpuHashAggregateExec(
        child, grouping, agg_specs, node.grouping_names, filters=filters,
        max_dict_groups=conf.get_entry(C.AGG_MAX_DICT_GROUPS),
        max_domain_groups=conf.get_entry(C.AGG_MAX_KEY_DOMAIN_GROUPS))


def _convert_join(node: P.Join, children, conf: C.RapidsConf) -> TpuExec:
    """The build (right) side is broadcast when its size estimate is under
    the threshold, else coalesced into one batch; the probe (left) side
    streams through a coalesce. Key pairs of different types cast to
    their common type."""
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
    est = node.children[1].estimate_bytes()
    if est is not None and est <= conf.get_entry(C.BROADCAST_SIZE_BYTES):
        right = TpuBroadcastExchangeExec(children[1])
    else:
        right = TpuCoalesceExec(children[1], require_single=True)
    left = TpuCoalesceExec(children[0])
    return TpuJoinExec(
        left, right, node.join_type, lkeys, rkeys,
        node.children[0].output_schema(), node.children[1].output_schema(),
        direct_table_mult=conf.get_entry(C.JOIN_DIRECT_TABLE_MULT),
        hashprobe_attempts=conf.get_entry(C.KERNELS_HASHPROBE_ATTEMPTS))


def _convert(node: P.PlanNode, conf: C.RapidsConf, device) -> TpuExec:
    _tag(node)
    children = [_convert(c, conf, device) for c in node.children]
    if isinstance(node, P.LocalScan):
        policy = BucketPolicy(conf.get_entry(C.SHAPE_BUCKETS_MIN))
        return TpuScanExec(node.batches, device, policy)
    if isinstance(node, P.Project):
        return TpuProjectExec(children[0], node.exprs, node.names)
    if isinstance(node, P.Filter):
        return TpuFilterExec(children[0], node.condition)
    if isinstance(node, P.Aggregate):
        return _convert_aggregate(node, children[0], conf)
    if isinstance(node, P.Join):
        return _convert_join(node, children, conf)
    if isinstance(node, P.TakeOrderedAndProject):
        return TpuTakeOrderedAndProjectExec(children[0], node.orders,
                                            node.limit)
    return TpuSortExec(children[0], node.orders)


def convert(node: P.PlanNode, conf: C.RapidsConf, device) -> TpuExec:
    """The device exec tree for ``node``, every exec numbered by its plan
    position (pre-order from 1)."""
    root = _convert(node, conf, device)
    counter = [0]

    def number(e: TpuExec) -> None:
        counter[0] += 1
        e._lore_id = counter[0]
        for c in e.children:
            number(c)

    number(root)
    return root
