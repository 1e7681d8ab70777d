"""Bloom-filter runtime join filtering (port of
``spark_rapids_tpu/ops/bloom.py``; reference: SURVEY.md §2.9 JNI
BloomFilter; Spark's InjectRuntimeFilter plans BloomFilterAggregate on the
build side and BloomFilterMightContain on the probe side of selective
joins).

The filter is a bool tensor of ``num_bits`` slots on the session's
device. The k bit indexes of a value come from one xxhash64 of it as a
LONG with Spark's seed (``ops/hashfns.py::_xx_long``), by double hashing
``h1 + i * h2`` over the hash's low and high 32-bit halves, in 32-bit
arithmetic, mod ``num_bits`` (the reference's ``_bit_indexes_dev``).
Building is one scatter per hash over the valid keys; membership is k
gathers ANDed, null for a null input.

Surface: ``build_bloom_filter(df, column)`` aggregates a DataFrame's
integral column into a :class:`BloomFilter` (the BloomFilterAggregate
analog), and ``F.might_contain(bloom, expr)`` is the probe-side
expression. As in the reference, it is an explicit tool, not a rewrite
the planner injects."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.ops.expr import DevVal, EvalCtx, Expression

_M32 = 0xFFFFFFFF


def bit_indexes(values: torch.Tensor, num_bits: int,
                k: int) -> List[torch.Tensor]:
    """The k bit indexes (int64) of each value, hashed as a LONG."""
    from spark_rapids_tpu_torch.ops.hashfns import XX_SEED, _xx_long
    v = values.to(torch.int64)
    h = _xx_long(v, torch.full_like(v, XX_SEED))
    h1 = h & _M32
    h2 = (h >> 32) & _M32
    return [((h1 + i * h2) & _M32) % num_bits for i in range(k)]


class BloomFilter:
    """The materialized filter: ``bits``, a bool tensor of ``num_bits``
    slots on the device it was built on."""

    def __init__(self, bits: torch.Tensor, num_hashes: int):
        self.bits = bits
        self.num_bits = int(bits.shape[0])
        self.num_hashes = int(num_hashes)

    def host_bits(self) -> np.ndarray:
        """The bits on the host (the CPU route's probe), read once."""
        got = self.__dict__.get("_host_bits")
        if got is None:
            got = self._host_bits = self.bits.cpu().numpy().astype(bool)
        return got

    def approx_set_bits(self) -> int:
        return int(self.bits.sum().item())


def build_bits(values: torch.Tensor, valid: torch.Tensor, num_bits: int,
               num_hashes: int) -> torch.Tensor:
    """The bit array of the valid ``values``: one scatter per hash, a
    null's index sent to a spare slot past the end (no host sync)."""
    bits = torch.zeros(num_bits + 1, dtype=torch.bool, device=values.device)
    for idx in bit_indexes(values, num_bits, num_hashes):
        bits[torch.where(valid, idx, num_bits)] = True
    return bits[:num_bits]


def build_bloom_filter(df, column: str, num_bits: int = None,
                       num_hashes: int = None) -> BloomFilter:
    """Aggregate ``df[column]`` (an integral column) into a BloomFilter on
    the session's device, the engine's bloom_filter_agg: the column runs
    through the session, its keys land on the device and fold into one
    bit array. Sizes default to ``spark.rapids.tpu.bloomFilter.numBits``
    and ``numHashes``."""
    from spark_rapids_tpu_torch.conf import (
        BLOOM_DEFAULT_NUM_BITS,
        BLOOM_DEFAULT_NUM_HASHES,
    )
    session = df.session
    if num_bits is None:
        num_bits = session.conf.get_entry(BLOOM_DEFAULT_NUM_BITS)
    if num_hashes is None:
        num_hashes = session.conf.get_entry(BLOOM_DEFAULT_NUM_HASHES)
    sel = df.select(column)
    dt = dict(sel.plan.output_schema())[column]
    if not isinstance(dt, T.IntegralType):
        raise ColumnarProcessingError(
            f"bloom filter column {column} must be integral, got "
            f"{dt.simple_string()}")
    # the column stays on the device (the device export): no download
    # and no upload between the query and the bits
    cols, n = sel.to_device_arrays()
    data, valid = cols[column][0], cols[column][1]
    live = torch.arange(valid.shape[0], device=valid.device) < n
    return BloomFilter(build_bits(data.to(torch.int64), valid & live,
                                  int(num_bits), int(num_hashes)),
                       num_hashes)


class BloomFilterMightContain(Expression):
    """might_contain(bloom, e): true when e MAY be in the build set (no
    false negatives), null for a null input."""

    def __init__(self, bloom: BloomFilter, child: Expression):
        self.bloom = bloom
        self.children = (child,)

    @property
    def data_type(self):
        return T.BOOLEAN

    def key(self):
        return ("mightcontain", id(self.bloom), self.children[0].key())

    def with_children(self, children):
        return BloomFilterMightContain(self.bloom, children[0])

    def resolve(self, bound_children):
        child = bound_children[0]
        if not isinstance(child.data_type, T.IntegralType):
            raise ColumnarProcessingError(
                f"might_contain needs an integral value, got "
                f"{child.data_type.simple_string()}")
        return self.with_children(bound_children)

    def eval_dev(self, ctx: EvalCtx, child_vals, prep) -> DevVal:
        (c,) = child_vals
        bits = self.bloom.bits.to(ctx.device)
        hit = torch.ones(c.data.shape[0], dtype=torch.bool,
                         device=c.data.device)
        for idx in bit_indexes(c.data, self.bloom.num_bits,
                               self.bloom.num_hashes):
            hit &= bits[idx]
        return DevVal(hit, c.validity)

    def eval_cpu(self, table: HostTable) -> HostColumn:
        c = self.children[0].eval_cpu(table)
        bits = self.bloom.host_bits()
        from spark_rapids_tpu_torch.ops.hashfns import xxhash64_host
        n = len(c)
        out = np.zeros(n, dtype=np.bool_)
        for i in range(n):
            if not c.validity[i]:
                continue
            h = xxhash64_host(
                [(int(c.data[i]), True, T.LONG)]) & 0xFFFFFFFFFFFFFFFF
            h1 = h & 0xFFFFFFFF
            h2 = h >> 32
            hit = True
            for j in range(self.bloom.num_hashes):
                ix = ((h1 + j * h2) & 0xFFFFFFFF) % self.bloom.num_bits
                if not bits[ix]:
                    hit = False
                    break
            out[i] = hit
        return HostColumn(T.BOOLEAN, out, c.validity.copy())
