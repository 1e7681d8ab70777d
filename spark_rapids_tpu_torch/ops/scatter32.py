"""Row compaction dispatch point (port of
``spark_rapids_tpu/ops/scatter32.py::compact_pairs``).

The reference splits 64-bit payloads into 32-bit scatters on the TPU; its
CPU backend scatters natively, which is what the port reproduces: every
compaction goes through the gather-compact kernel at native widths."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def compact_pairs(datas: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                  keep: torch.Tensor, capacity: int
                  ) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]],
                             torch.Tensor]:
    """Compact every column's (data, validity) to the kept-row prefix.
    Returns ([(data, validity)...], new_n) with new_n a 0-d int32 tensor
    that stays on the device."""
    from spark_rapids_tpu_torch.kernels import compact as kcompact
    keep_i = keep.to(torch.int32)
    new_n = keep_i.sum(dtype=torch.int32)
    pos = torch.cumsum(keep_i, 0, dtype=torch.int32) - 1
    outs = kcompact.gather_compact(list(datas), list(valids), keep, pos,
                                   new_n, capacity)
    return outs, new_n
