"""Batched f64 segmented sums (port of
``spark_rapids_tpu/ops/segsum.py::batched_segment_sum_f64``).

The H100 adds f64 natively, so the port reproduces the reference's CPU
branch (``resolve_split_mode`` false there): no hi/lo f32 split and no
error guard. The small-segment path runs the one-hot partials kernel on
the native f64 column stack and sums the block partials over the block
axis (the reference's ``p64.sum(axis=0)``). Addition order differs from
the reference's row-order ``segment_sum``, so the last bits of a sum may
differ; the kernel itself repeats its bits from run to run.
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
        raise NotImplementedError(
            f"segment sums over {num_segments} segments (> "
            f"{MATMUL_MAX_SEGMENTS}): the blocked scatter path is not ported")
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
