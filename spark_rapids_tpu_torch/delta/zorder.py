"""Z-ORDER: multi-column interleaved-bits clustering key (a copy of
``spark_rapids_tpu/delta/zorder.py``).

Reference (SURVEY.md §2.8/§2.9): Delta OPTIMIZE ZORDER BY runs the JNI
``ZOrder`` kernel (interleaved bits) on the GPU. The JAX package, and the
port with it, interleave on the host in numpy: columns normalize to
unsigned 32-bit ranks, bits interleave with vectorized shift/mask ops, and
OPTIMIZE sorts by the key with a stable ``np.argsort``."""

from __future__ import annotations

from typing import List

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostTable
from spark_rapids_tpu_torch.errors import ColumnarProcessingError


def _to_u32(col) -> np.ndarray:
    """Order-preserving map of a column to uint32 (nulls first)."""
    v = col.data
    dt = col.dtype
    if isinstance(dt, T.StringType):
        # rank strings (order-preserving); nulls -> 0
        uniq, inv = np.unique(
            np.where(col.validity, v.astype(str), ""), return_inverse=True)
        u = inv.astype(np.uint64)
        u = (u * (0xFFFFFFFF // max(len(uniq) - 1, 1))).astype(np.uint32)
    elif isinstance(dt, (T.FloatType, T.DoubleType)):
        f = v.astype(np.float64)
        bits = f.view(np.uint64)
        # IEEE total order: flip sign bit for positives, all bits for negs
        flipped = np.where(bits >> 63 == 0, bits | (1 << 63), ~bits)
        u = (flipped >> 32).astype(np.uint32)
    elif isinstance(dt, T.BooleanType):
        u = v.astype(np.uint32) * 0x80000000
    else:
        i = v.astype(np.int64)
        lo, hi = int(i.min()), int(i.max())
        span = max(hi - lo, 1)
        u = ((i - lo).astype(np.uint64) * 0xFFFFFFFF // span).astype(
            np.uint32)
    return np.where(col.validity, u, np.uint32(0))


def _spread_bits(x: np.ndarray, stride: int) -> np.ndarray:
    """Spread each of the 32 bits of x to positions i*stride (uint64 out,
    keeping the top 64//stride bits)."""
    keep = min(64 // stride, 32)
    out = np.zeros(len(x), dtype=np.uint64)
    xs = x.astype(np.uint64) >> np.uint64(32 - keep)  # top `keep` bits
    for b in range(keep):
        bit = (xs >> np.uint64(b)) & np.uint64(1)
        out |= bit << np.uint64(b * stride)
    return out


def zorder_key_host(table: HostTable, by: List[str]) -> np.ndarray:
    """uint64 z-value per row: interleave the top bits of each column."""
    if not by:
        raise ColumnarProcessingError("zorder requires at least one column")
    idx = {n: i for i, n in enumerate(table.names)}
    for c in by:
        if c not in idx:
            raise ColumnarProcessingError(
                f"zorder column {c!r} not in {list(table.names)}")
    stride = len(by)
    z = np.zeros(table.num_rows, dtype=np.uint64)
    for j, c in enumerate(by):
        u = _to_u32(table.columns[idx[c]])
        z |= _spread_bits(u, stride) << np.uint64(stride - 1 - j)
    return z


def zorder_sort_indexes(table: HostTable, by: List[str]) -> np.ndarray:
    return np.argsort(zorder_key_host(table, by), kind="stable")
