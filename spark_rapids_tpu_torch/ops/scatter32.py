"""Row compaction dispatch point (port of
``spark_rapids_tpu/ops/scatter32.py::compact_pairs``).

The reference splits 64-bit payloads into 32-bit scatters on the TPU; its
CPU backend scatters natively, which is what the port reproduces: every
compaction goes through the gather-compact kernel at native widths, which
on the card also scans ``keep`` (no torch op runs before it)."""

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
    return kcompact.gather_compact(list(datas), list(valids), keep, capacity)
