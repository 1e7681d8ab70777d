"""Shared expression machinery: the unary and binary bases, numeric
coercion, null propagation and the string-dictionary merge of
string-valued branches (port of the parts of
``spark_rapids_tpu/ops/common.py`` the ported operators use)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops.expr import Expression, NodePrep, PrepCtx


class UnaryExpression(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    @property
    def child(self) -> Expression:
        return self.children[0]

    def with_children(self, children):
        return type(self)(children[0])


class BinaryExpression(Expression):
    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    def with_children(self, children):
        return type(self)(children[0], children[1])


def coerce_numeric_pair(left: Expression, right: Expression
                        ) -> Tuple[Expression, Expression, T.DataType]:
    """Insert casts so both sides share the promoted numeric type (Spark
    TypeCoercion's tightest common type, ``T.promote``)."""
    from spark_rapids_tpu_torch.ops.cast import make_cast
    out = T.promote(left.data_type, right.data_type)
    return make_cast(left, out), make_cast(right, out), out


def null_and(*validities):
    """Combined validity: all inputs valid (default null propagation)."""
    out = validities[0]
    for v in validities[1:]:
        out = out & v
    return out


# ---------------------------------------------------------------------------
# String dictionary merge (string-valued If/CaseWhen/Coalesce/Least/Greatest)
# ---------------------------------------------------------------------------

_EMPTY_DICT = np.array([], dtype=object)


def align_string_dicts_many(pctx: PrepCtx,
                            preps: Sequence[NodePrep]) -> NodePrep:
    """Host side: merge the children's dictionaries into one sorted-unique
    dictionary (``np.unique``) and upload one int32 remap per child (in
    order, ``aux[i]``): on the device ``remap[code]`` is the child's code
    in the merged dictionary, so merged codes compare in string order. A
    child with no dictionary (a NULL literal) merges as an empty one."""
    dicts = [_EMPTY_DICT if p.out_dict is None else p.out_dict
             for p in preps]
    merged = np.unique(np.concatenate([d.astype(object) for d in dicts]))
    aux = {}
    for i, d in enumerate(dicts):
        remap = np.searchsorted(merged, d).astype(np.int32)
        if not len(remap):
            # an all-null child: its codes gather a single 0
            remap = np.zeros(1, dtype=np.int32)
        aux[i] = torch.from_numpy(remap).to(pctx.table.device)
    return NodePrep(out_dict=merged, dict_sorted=True, aux=aux)


def dev_remap_codes(remap: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``remap[codes]``: a table by dictionary entry gathered by code (the
    device side of ``align_string_dicts_many`` and of the string
    functions' dictionary transforms). Codes are clamped into the table's
    range, so the garbage codes of invalid rows cannot fault the gather."""
    return remap.index_select(0, codes.clamp(0, remap.shape[0] - 1))
