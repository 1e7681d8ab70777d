"""Batched f64 segmented sums and 64-bit segment MIN/MAX (port of
``spark_rapids_tpu/ops/segsum.py``: ``batched_segment_sum_f64`` and
``segment_minmax_64``).

The H100 adds f64 natively, so the port reproduces the reference's CPU
branch (``resolve_split_mode`` false there): no hi/lo f32 split and no
error guard. The small-segment path runs the one-hot partials kernel on
the native f64 column stack and sums the block partials over the block
axis (the reference's ``p64.sum(axis=0)``). Addition order differs from
the reference's row-order ``segment_sum``, so the last bits of a sum may
differ; the kernel itself repeats its bits from run to run.

Over more than ``MATMUL_MAX_SEGMENTS`` segments (an int-domain group-by,
the sort-segment aggregate) the sums are one ``index_add_`` (the
reference's CPU branch, ``jax.ops.segment_sum``). On the CPU it adds rows
in order; on CUDA its f64 atomics add in an order that may change from
run to run, so those sums are compared within rtol 1e-9, not bitwise.

``segment_minmax_64`` is the reference's split route (its ``splitF64``
on): Spark's NaN rule on every device. It needs no hi/lo limbs: the
``fused_minmax`` kernel reduces native 64-bit values, with no segment cap.
"""

from __future__ import annotations

from typing import Sequence

import torch

#: rows per partial-sum block
BLOCK = 1024

#: the one-hot partials kernel's segment bound
MATMUL_MAX_SEGMENTS = 32


def batched_segment_sum_f64(cols: Sequence[torch.Tensor], gid: torch.Tensor,
                            num_segments: int,
                            capacity: int) -> torch.Tensor:
    """Segmented sums of several f64 (capacity,) columns (invalid slots
    zeroed) by ``gid`` int32 in [0, num_segments), in one kernel pass.
    Returns (num_segments, len(cols)) f64."""
    m = len(cols)
    if m == 0:
        return torch.zeros((num_segments, 0), dtype=torch.float64,
                           device=gid.device)
    if num_segments > MATMUL_MAX_SEGMENTS:
        return segment_sum(torch.stack([c.to(torch.float64) for c in cols],
                                       dim=1), gid, num_segments)
    block = min(BLOCK, capacity)
    nb = max(capacity // block, 1)
    if nb * block != capacity:
        raise NotImplementedError(
            f"segment sums at capacity {capacity}, not a multiple of the "
            f"{block}-row block")
    from spark_rapids_tpu_torch.kernels import segreduce as kseg
    # column-major (capacity, m) view: one contiguous copy per column, and
    # the kernel's warps read each column's rows coalesced
    x = torch.stack([c.to(torch.float64) for c in cols], dim=0).t()
    parts = kseg.onehot_partials(x, gid, num_segments, nb, block)
    return parts.sum(dim=0)


def segment_sum(x: torch.Tensor, gid: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sums of the rows of ``x`` ((n,) or (n, m)) by segment id ``gid`` in
    [0, num_segments): one ``index_add_`` (a torch op, as the reference
    leaves ``jax.ops.segment_sum`` to XLA)."""
    out = torch.zeros((num_segments,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, gid.to(torch.int64), x)


def segment_minmax_64(is_min: bool, values: torch.Tensor, valid: torch.Tensor,
                      gid: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Exact per-segment min (``is_min``) or max of int64 or float64
    ``values`` over the rows with ``valid`` and ``gid`` in
    [0, num_segments). Doubles order as Spark does: NaN is greater than
    every other value (max is NaN if any; min ignores NaN unless the
    segment is all-NaN; a NaN result is the canonical NaN) and -0.0 < 0.0.
    Empty segments hold the identity (INT64_MAX/MIN, +inf/-inf); callers
    mask them by their own ``has_any``."""
    if values.dtype not in (torch.int64, torch.float64):
        raise TypeError(f"segment_minmax_64 of {values.dtype}: int64 or "
                        "float64 values only")
    from spark_rapids_tpu_torch.kernels import segreduce as kseg
    return kseg.fused_minmax(is_min, values, valid, gid.to(torch.int32),
                             num_segments)
