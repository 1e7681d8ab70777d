"""Cost-based optimizer (port of ``spark_rapids_tpu/overrides/optimizer.py``,
the reference's CostBasedOptimizer.scala): estimate each plan's device
cost against its CPU cost from row counts and conf-tunable factors, and
put a whole eligible plan on the CPU route when the device does not pay
for its per-operator overhead (small inputs are the classic case).

Model (every factor a conf key of conf.py, the reference's defaults):
  device_cost(plan) = execOverhead * n_execs + gpuRowCost * sum(rows)
  cpu_cost(plan)    = cpuRowCost * sum(rows)
When ``cpu_cost < device_cost`` every node gets a reason naming CBO. A
node without a row estimate (an aggregate, a join) leaves the plan
alone, as the reference treats unknown statistics."""

from __future__ import annotations

from typing import Optional

from spark_rapids_tpu_torch.conf import (
    OPTIMIZER_CPU_ROW_COST,
    OPTIMIZER_ENABLED,
    OPTIMIZER_EXEC_OVERHEAD,
    OPTIMIZER_GPU_ROW_COST,
)


def estimate_rows(node) -> Optional[int]:
    """A plan node's row-count estimate: scans know theirs, row-preserving
    unaries pass their child's on, a limit caps it; None when unknown."""
    from spark_rapids_tpu_torch.plan import nodes as P
    if isinstance(node, P.LocalScan):
        return sum(b.num_rows for b in node.batches)
    if isinstance(node, P.CachedRelation):
        if node._table is not None:
            return node._table.num_rows
        return estimate_rows(node.children[0])
    if isinstance(node, (P.Project, P.Filter, P.Sort, P.Sample,
                         P.WindowNode, P.Exchange)):
        return estimate_rows(node.children[0])
    if isinstance(node, P.Limit):
        child = estimate_rows(node.children[0])
        return min(child, node.limit) if child is not None else node.limit
    if isinstance(node, P.TakeOrderedAndProject):
        return node.limit
    return None


def apply_cbo(meta, conf) -> None:
    """Tag the whole plan onto the CPU route when its device estimate
    loses (a plan already partly there is left as it is)."""
    if not conf.get_entry(OPTIMIZER_ENABLED) or not meta.can_run_on_gpu:
        return
    total_rows = n_execs = 0
    stack = [meta]
    while stack:
        m = stack.pop()
        n_execs += 1
        r = estimate_rows(m.node)
        if r is None:
            return
        total_rows += r
        stack.extend(m.children)
    device_cost = (conf.get_entry(OPTIMIZER_EXEC_OVERHEAD) * n_execs
                   + conf.get_entry(OPTIMIZER_GPU_ROW_COST) * total_rows)
    cpu_cost = conf.get_entry(OPTIMIZER_CPU_ROW_COST) * total_rows
    if cpu_cost < device_cost:
        reason = (f"CBO: est. CPU cost {cpu_cost:.4g} < device cost "
                  f"{device_cost:.4g} ({total_rows} rows, {n_execs} ops)")
        stack = [meta]
        while stack:
            m = stack.pop()
            m.reasons.append(reason)
            stack.extend(m.children)
