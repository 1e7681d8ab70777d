"""Row compaction dispatch point (port of
``spark_rapids_tpu/ops/scatter32.py::compact_pairs``).

The reference splits 64-bit payloads into 32-bit scatters on the TPU; its
CPU backend scatters natively, which is what the port reproduces: every
compaction goes through the gather-compact kernel at native widths, which
on the card also scans ``keep`` (no torch op runs before it). The kernel's
streams are 1-D: a DECIMAL128 ``(capacity, 2)`` limb column rides as its
two limbs, two streams with the column's validity, and is restacked."""

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
    flat_d, flat_v, wide = [], [], []
    for d, v in zip(datas, valids):
        wide.append(d.ndim == 2)
        if d.ndim == 2:
            flat_d += [d[:, 0].contiguous(), d[:, 1].contiguous()]
            flat_v += [v, v]
        else:
            flat_d.append(d)
            flat_v.append(v)
    pairs, new_n = kcompact.gather_compact(flat_d, flat_v, keep, capacity)
    out, i = [], 0
    for w in wide:
        if w:
            out.append((torch.stack([pairs[i][0], pairs[i + 1][0]], dim=1),
                        pairs[i][1]))
            i += 2
        else:
            out.append(pairs[i])
            i += 1
    return out, new_n
