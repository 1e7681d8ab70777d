"""input_file_name, input_file_block_start and input_file_block_length
(port of ``spark_rapids_tpu/ops/inputfile.py``; reference:
GpuInputFileName and GpuInputFileBlock*).

The plan rewrite (overrides/input_file.py) makes the file scan attach
per-row provenance columns (the file's name, a one-entry dictionary per
batch; block start and length, constants per batch) and turns these
expressions into bound references to them. The readers split at file or
row-group level and report per-FILE blocks (start 0, length the file's
size). An expression the rewrite leaves in place (no file scan below it,
or an aggregate, join or exchange between) evaluates to Spark's "no file
information" values: the empty string and -1.
"""

from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops.expr import DevVal, Expression, NodePrep

#: hidden provenance column names the scan attaches
FILE_NAME_COL = "__input_file_name__"
FILE_START_COL = "__input_file_block_start__"
FILE_LENGTH_COL = "__input_file_block_length__"
FILE_INFO_COLS = (FILE_NAME_COL, FILE_START_COL, FILE_LENGTH_COL)


class _InputFileExpr(Expression):
    """Binds to itself; evaluates to the no-information constant unless
    the plan rewrite substituted a provenance column reference."""

    children = ()

    def bind(self, schema):
        return self

    def with_children(self, children):
        return self

    def key(self):
        return (self.name.lower(),)

    @property
    def nullable(self):
        return False

    def eval_dev(self, ctx, child_vals, prep) -> DevVal:
        data = torch.full((ctx.capacity,), self._fill,
                          dtype=T.torch_dtype(self.data_type)
                          if not isinstance(self.data_type, T.StringType)
                          else torch.int32, device=ctx.device)
        valid = torch.ones(ctx.capacity, dtype=torch.bool,
                           device=ctx.device)
        return DevVal(data, valid)


class InputFileName(_InputFileExpr):
    name = "InputFileName"
    _fill = 0  # dictionary code 0 -> ""

    @property
    def data_type(self):
        return T.STRING

    def prep(self, pctx, child_preps) -> NodePrep:
        return NodePrep(out_dict=np.array([""], dtype=object))


class InputFileBlockStart(_InputFileExpr):
    name = "InputFileBlockStart"
    _fill = -1

    @property
    def data_type(self):
        return T.LONG


class InputFileBlockLength(InputFileBlockStart):
    name = "InputFileBlockLength"


def contains_input_file_expr(expr: Expression) -> bool:
    if isinstance(expr, _InputFileExpr):
        return True
    return any(contains_input_file_expr(c) for c in expr.children)


def substitute(expr: Expression, schema) -> Expression:
    """Replace the input_file_* nodes with bound references to the hidden
    provenance columns present in ``schema``."""
    from spark_rapids_tpu_torch.ops.expr import BoundReference
    names = [n for n, _ in schema]
    if isinstance(expr, _InputFileExpr):
        col = {InputFileName: FILE_NAME_COL,
               InputFileBlockStart: FILE_START_COL,
               InputFileBlockLength: FILE_LENGTH_COL}[type(expr)]
        i = names.index(col)
        return BoundReference(i, schema[i][1], name_hint=col)
    if not expr.children:
        return expr
    kids = [substitute(c, schema) for c in expr.children]
    return expr.with_children(kids)
