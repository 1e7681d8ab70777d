"""Row compaction (port of
``spark_rapids_tpu/kernels/compact.py::gather_compact``, with the scan of
``keep`` that its caller ``ops/scatter32.py::compact_pairs`` runs first).

On the card one launch takes ``keep`` and the column streams and writes
the compacted streams and the kept-row count (``csrc/compact.cu``: tiles
ranked by ballot, tile offsets by decoupled look-back, kept rows to the
head and zeros to the tail). No torch op runs between ``keep`` and the
result, nothing is copied to the device per call (the stream descriptors
ride in the launch's parameters) and nothing waits on the host. 64-bit
columns move at their native width: the reference's limb split
(``_split_streams``) exists for the TPU's 32-bit gathers and is taken only
off its CPU backend.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.kernels import (
    check_launch,
    record,
    require_contiguous,
    require_cuda,
    stream_handle,
)

#: rows one CTA of the kernel compacts (``kTile`` in ``csrc/compact.cu``)
TILE_ROWS = 2048
#: streams one launch takes by value; a call with more also writes a
#: gather map, and each further group is one gather launch through it
MAX_STREAMS = 64
#: look-back words for the largest capacity the kernel takes (< 2^31)
_MAX_TILES = (2 ** 31) // TILE_ROWS

Pairs = List[Tuple[torch.Tensor, torch.Tensor]]


def _check_args(datas, valids, keep, capacity):
    if len(datas) != len(valids):
        raise ValueError("gather_compact: one validity per column")
    shape = (capacity,)
    for t in (*datas, *valids, keep):
        if t.shape != shape:
            raise ValueError(f"gather_compact: every stream must be "
                             f"({capacity},), got {tuple(t.shape)}")
    if keep.dtype != torch.bool:
        raise TypeError("gather_compact: keep must be bool")
    for v in valids:
        if v.dtype != torch.bool:
            raise TypeError(f"gather_compact: validity dtype {v.dtype}")


def gather_compact_plain(datas: Sequence[torch.Tensor],
                         valids: Sequence[torch.Tensor], keep: torch.Tensor,
                         capacity: int) -> Tuple[Pairs, torch.Tensor]:
    """The plain version: the reference's positions (cumsum(keep) - 1)
    and count, its scatter of row indices into a zeroed gather map
    (dropped rows aim one past the end), then a gather of every stream
    masked to the new row prefix."""
    dev = keep.device
    keep_i = keep.to(torch.int32)
    new_n = keep_i.sum(dtype=torch.int32)
    pos = torch.cumsum(keep_i, 0, dtype=torch.int32) - 1
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
    return out, new_n


_LIB = None


def _library():
    """The loaded ``csrc/compact.cu`` with its argument types set, built at
    first use."""
    global _LIB
    if _LIB is None:
        from spark_rapids_tpu_torch.kernels.build import load_library
        lib = load_library("compact")
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.srt_compact.restype = ctypes.c_int
        lib.srt_compact.argtypes = [p, i64, p, ctypes.c_int, p, p, p, p,
                                    ctypes.c_uint32, p]
        limits = (lib.srt_compact_tile_rows(), lib.srt_compact_max_streams())
        if limits != (TILE_ROWS, MAX_STREAMS):
            raise RuntimeError(f"csrc/compact.cu tiles {limits}, expected "
                               f"{(TILE_ROWS, MAX_STREAMS)}")
        _LIB = lib
    return _LIB


class _Workspace:
    """The look-back words and the ticket counter of one CUDA stream (8 MiB,
    zeroed once); each launch takes the next epoch, so the words an earlier
    launch left read as unpublished."""

    def __init__(self, device: torch.device):
        # _MAX_TILES words, then the counter's word
        self.words = torch.zeros(_MAX_TILES + 1, dtype=torch.int64,
                                 device=device)
        self.epoch = 0

    def next_epoch(self) -> int:
        self.epoch += 1
        if self.epoch >= 2 ** 32:  # the epochs come round: clear old words
            self.words.zero_()
            self.epoch = 1
        return self.epoch


_WORKSPACES: Dict[Tuple[int, int], _Workspace] = {}


def _workspace(device: torch.device, stream: int) -> _Workspace:
    key = (device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None:
        ws = _WORKSPACES[key] = _Workspace(device)
    return ws


def gather_compact(datas: Sequence[torch.Tensor],
                   valids: Sequence[torch.Tensor], keep: torch.Tensor,
                   capacity: int) -> Tuple[Pairs, torch.Tensor]:
    """([(data, validity)...] compacted to the kept-row prefix, new_n):
    kept rows in row order, zeros past them, and the kept-row count as a
    0-d int32 tensor that stays on the device."""
    _check_args(datas, valids, keep, capacity)
    if keep.device.type == "cpu":
        return gather_compact_plain(datas, valids, keep, capacity)
    require_cuda(keep, "gather_compact")
    require_contiguous(keep, "gather_compact")
    dev, n = keep.device, len(datas)
    streams = [*datas, *valids]
    for t in streams:
        if t.device != dev:
            raise ValueError("gather_compact: all tensors must share a device")
        require_contiguous(t, "gather_compact")
        if t.element_size() not in (1, 2, 4, 8):
            raise TypeError(f"gather_compact: element size of {t.dtype}")
    if capacity >= 2 ** 31:
        raise ValueError(f"gather_compact: capacity {capacity} >= 2^31")
    outs = [torch.empty_like(t) for t in streams]
    if capacity == 0:
        return (list(zip(outs[:n], outs[n:])),
                torch.zeros((), dtype=torch.int32, device=dev))
    new_n = torch.empty((), dtype=torch.int32, device=dev)
    sel = torch.empty(capacity, dtype=torch.int32, device=dev) \
        if len(streams) > MAX_STREAMS else None
    lib = _library()
    stream = stream_handle(keep)
    ws = _workspace(dev, stream)
    # (src, dst, element size) of every stream, as one host array
    descs = (ctypes.c_int64 * max(1, 3 * len(streams)))(
        *[t.data_ptr() for t in streams], *[t.data_ptr() for t in outs],
        *[t.element_size() for t in streams])
    words = ws.words.data_ptr()
    rc = lib.srt_compact(keep.data_ptr(), capacity, descs, len(streams),
                         new_n.data_ptr(),
                         None if sel is None else sel.data_ptr(), words,
                         words + 8 * _MAX_TILES, ws.next_epoch(), stream)
    check_launch(lib, rc, "gather_compact")
    gather_compact.launches += 1
    pairs = list(zip(outs[:n], outs[n:]))
    record("gather_compact", (list(datas), list(valids), keep, capacity),
           (pairs, new_n))
    return pairs, new_n


gather_compact.launches = 0
