"""Hash expressions (port of ``Murmur3Hash`` of
``spark_rapids_tpu/ops/hashfns.py``): Spark's ``hash()``, murmur3 with
seed 42 over its children in order, each hash seeding the next, through
the shuffle layer's device hash (shuffle/hashing.py). A string child's
dictionary bytes are a device input that the prep walk uploads, as the
reference's prep registers them as aux arrays.

Over a decimal(p > 18) child the reference falls back to the host's
Spark-exact byte hash of the unscaled BigInteger; the port has no such
fallback, so binding ``hash()`` over one raises. ``xxhash64`` is not
ported."""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops.expr import DevVal, EvalCtx, Expression, \
    NodePrep, PrepCtx
from spark_rapids_tpu_torch.shuffle.hashing import (
    device_string_bytes,
    murmur3_hash_device,
)


class Murmur3Hash(Expression):
    """n-ary row hash: INT, never null (a null child passes the running
    hash through)."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    def with_children(self, children):
        return Murmur3Hash(*children)

    @property
    def data_type(self):
        return T.INT

    def resolve(self, bound):
        for c in bound:
            if T.is_dec128(c.data_type):
                raise NotImplementedError(
                    f"hash() over {c.data_type.simple_string()} (Spark's "
                    "byte hash of a decimal with precision > 18, the "
                    "reference's host fallback) is not ported")
        return self.with_children(bound)

    def prep(self, pctx: PrepCtx, child_preps) -> NodePrep:
        aux = {i: device_string_bytes(p.out_dict, pctx.table.device)
               for i, (c, p) in enumerate(zip(self.children, child_preps))
               if isinstance(c.data_type, T.StringType)}
        return NodePrep(aux=aux)

    def eval_dev(self, ctx: EvalCtx, child_vals, prep: NodePrep) -> DevVal:
        cols = [(v.data, v.validity, c.data_type)
                for c, v in zip(self.children, child_vals)]
        h = murmur3_hash_device(cols, string_bytes=prep.aux)
        return DevVal(h, torch.ones(ctx.capacity, dtype=torch.bool,
                                    device=ctx.device))
