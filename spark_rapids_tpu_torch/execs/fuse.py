"""Input-chain fusion: inline Project/Filter chains into a consuming exec
(port of ``spark_rapids_tpu/execs/fuse.py``). Projection expressions are
substituted into the consumer's trees and filter predicates become its
weight mask, so the chain never materializes or compacts."""

from __future__ import annotations

from typing import List, Sequence

from spark_rapids_tpu_torch.ops.expr import Alias, BoundReference, Expression


def strip_alias(e: Expression) -> Expression:
    while isinstance(e, Alias):
        e = e.children[0]
    return e


def substitute(expr: Expression, mapping: Sequence[Expression]) -> Expression:
    """Replace every BoundReference(i) in ``expr`` with ``mapping[i]``."""
    if isinstance(expr, BoundReference):
        return mapping[expr.ordinal]
    if not expr.children:
        return expr
    return expr.with_children([substitute(c, mapping) for c in expr.children])


def peel_input_chain(child, exprs: List[Expression]):
    """Walk Project/Filter execs below ``child``, rewriting ``exprs`` to be
    bound against the base exec's schema and collecting filter predicates.
    Returns (base_exec, rewritten_exprs, predicates); a row is kept iff
    every predicate is non-null true."""
    from spark_rapids_tpu_torch.execs.basic import TpuFilterExec, TpuProjectExec

    exprs = list(exprs)
    preds: List[Expression] = []
    cur = child
    while True:
        if isinstance(cur, TpuProjectExec):
            mapping = [strip_alias(e) for e in cur.exprs]
            exprs = [substitute(e, mapping) for e in exprs]
            preds = [substitute(p, mapping) for p in preds]
            cur = cur.children[0]
        elif isinstance(cur, TpuFilterExec):
            preds.append(cur.condition)
            cur = cur.children[0]
        else:
            return cur, exprs, preds
