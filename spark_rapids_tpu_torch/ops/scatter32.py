"""Row compaction dispatch point and the window's scatter back to input
row order (port of ``compact_pairs`` and ``scatter_pair`` of
``spark_rapids_tpu/ops/scatter32.py``).

The reference splits 64-bit payloads into 32-bit scatters on the TPU; its
CPU backend scatters natively, which is what the port reproduces: every
compaction goes through the gather-compact kernel at native widths, which
on the card also scans ``keep`` (no torch op runs before it). The kernel's
streams are 1-D: a DECIMAL128 ``(capacity, 2)`` limb column rides as its
two limbs, two streams with the column's validity, and is restacked."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def scatter_pair(out_len: int, tgt: torch.Tensor, data: torch.Tensor,
                 validity: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter one column's (data, validity) to slots ``tgt`` of zeroed
    outputs of ``out_len`` rows; targets outside [0, out_len) are dropped
    (the reference's ``mode="drop"``)."""
    dev = data.device
    tgt = tgt.to(torch.int64)
    tgt = torch.where((tgt >= 0) & (tgt < out_len), tgt, out_len)
    od = torch.zeros((out_len + 1,) + tuple(data.shape[1:]),
                     dtype=data.dtype, device=dev)
    ov = torch.zeros(out_len + 1, dtype=torch.bool, device=dev)
    od[tgt] = data
    ov[tgt] = validity
    return od[:out_len], ov[:out_len]


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
