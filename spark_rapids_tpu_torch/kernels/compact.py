"""Row compaction through one gather map (port of
``spark_rapids_tpu/kernels/compact.py::gather_compact``).

One i32 scatter inverts the kept rows' positions into a gather map, then
one launch gathers every column's data and validity through it and zeroes
the slots past the new row count (``csrc/compact.cu``). 64-bit columns
move at their native width: the reference's limb split (``_split_streams``)
exists for the TPU's 32-bit gathers and is taken only off its CPU backend.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.kernels import (
    check_launch,
    require_contiguous,
    require_cuda,
    stream_handle,
)


def _check_args(datas, valids, keep, pos, capacity):
    if len(datas) != len(valids):
        raise ValueError("gather_compact: one validity per column")
    for t in list(datas) + list(valids) + [keep, pos]:
        if t.ndim != 1 or t.shape[0] != capacity:
            raise ValueError(f"gather_compact: every stream must be "
                             f"({capacity},), got {tuple(t.shape)}")
    if keep.dtype != torch.bool or pos.dtype != torch.int32:
        raise TypeError("gather_compact: keep must be bool and pos int32")
    for v in valids:
        if v.dtype != torch.bool:
            raise TypeError(f"gather_compact: validity dtype {v.dtype}")


def gather_compact_plain(datas: Sequence[torch.Tensor],
                         valids: Sequence[torch.Tensor], keep: torch.Tensor,
                         pos: torch.Tensor, new_n: torch.Tensor,
                         capacity: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The plain version: the reference's scatter of row indices into a
    zeroed gather map (dropped rows aim one past the end), then a gather
    of every stream masked to the new row prefix."""
    dev = keep.device
    tgt = torch.where(keep, pos, capacity).to(torch.int64)
    sel = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
    sel[tgt] = torch.arange(capacity, dtype=torch.int32, device=dev)
    sel = sel[:capacity].to(torch.int64)
    out_live = torch.arange(capacity, dtype=torch.int64, device=dev) < new_n
    out = []
    for d, v in zip(datas, valids):
        g = d[sel]
        out.append((torch.where(out_live, g, torch.zeros((), dtype=g.dtype,
                                                         device=dev)),
                    v[sel] & out_live))
    return out


def gather_compact(datas: Sequence[torch.Tensor],
                   valids: Sequence[torch.Tensor], keep: torch.Tensor,
                   pos: torch.Tensor, new_n: torch.Tensor,
                   capacity: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """[(data, validity)...] compacted to the kept-row prefix. ``pos`` is
    cumsum(keep) - 1 (int32) and ``new_n`` the kept-row count, a 0-d int32
    tensor that stays on the device."""
    _check_args(datas, valids, keep, pos, capacity)
    if keep.device.type == "cpu":
        return gather_compact_plain(datas, valids, keep, pos, new_n, capacity)
    require_cuda(keep, "gather_compact")
    streams = list(datas) + list(valids)
    for t in streams + [keep, pos, new_n]:
        if t.device != keep.device:
            raise ValueError("gather_compact: all tensors must share a device")
        require_contiguous(t, "gather_compact")
    if new_n.dtype != torch.int32 or new_n.numel() != 1:
        raise TypeError("gather_compact: new_n must be one int32")
    for t in streams:
        if t.element_size() not in (1, 2, 4, 8):
            raise TypeError(f"gather_compact: element size of {t.dtype}")
    outs = [torch.empty_like(t) for t in streams]
    sel = torch.empty(capacity, dtype=torch.int32, device=keep.device)
    desc = torch.tensor([[s.data_ptr(), o.data_ptr(), s.element_size()]
                         for s, o in zip(streams, outs)] or [[0, 0, 0]],
                        dtype=torch.int64).to(keep.device)
    from spark_rapids_tpu_torch.kernels.build import load_library
    lib = load_library("compact")
    fn = lib.srt_gather_compact
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int64, ctypes.c_void_p]
    rc = fn(keep.data_ptr(), pos.data_ptr(), sel.data_ptr(), new_n.data_ptr(),
            desc.data_ptr(), len(streams), capacity, stream_handle(keep))
    check_launch(lib, rc, "gather_compact")
    gather_compact.launches += 1
    n = len(datas)
    return list(zip(outs[:n], outs[n:]))


gather_compact.launches = 0
