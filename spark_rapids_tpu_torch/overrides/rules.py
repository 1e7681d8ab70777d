"""Tag and convert plan nodes into device execs (port of the LocalScan,
Project, Filter, Aggregate and Sort rules of
``spark_rapids_tpu/overrides/rules.py``).

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
    TpuFilterExec,
    TpuProjectExec,
    TpuScanExec,
)
from spark_rapids_tpu_torch.execs.fuse import peel_input_chain
from spark_rapids_tpu_torch.execs.sort import TpuSortExec
from spark_rapids_tpu_torch.plan import nodes as P


def _tag(node: P.PlanNode) -> None:
    if isinstance(node, P.Aggregate):
        for _, fn in node.agg_specs:
            check_agg_supported(fn)
    elif isinstance(node, P.Sort) and not node.global_sort:
        raise NotImplementedError("a per-partition (local) sort is not ported")
    elif not isinstance(node, (P.LocalScan, P.Project, P.Filter, P.Sort)):
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
        max_dict_groups=conf.get_entry(C.AGG_MAX_DICT_GROUPS))


def convert(node: P.PlanNode, conf: C.RapidsConf, device) -> TpuExec:
    """The device exec tree for ``node`` (children first)."""
    _tag(node)
    children = [convert(c, conf, device) for c in node.children]
    if isinstance(node, P.LocalScan):
        policy = BucketPolicy(conf.get_entry(C.SHAPE_BUCKETS_MIN))
        return TpuScanExec(node.batches, device, policy)
    if isinstance(node, P.Project):
        return TpuProjectExec(children[0], node.exprs, node.names)
    if isinstance(node, P.Filter):
        return TpuFilterExec(children[0], node.condition)
    if isinstance(node, P.Aggregate):
        return _convert_aggregate(node, children[0], conf)
    return TpuSortExec(children[0], node.orders)
