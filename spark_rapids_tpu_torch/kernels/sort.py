"""Multi-operand sort with a row-index payload (port of
``spark_rapids_tpu/kernels/sort.py::sort_with_payload``).

A bitonic network over the 32-bit key operands with the payload as the
final key (``csrc/sort.cu``). Callers pass a unique int32 iota payload
(the ``ops/ordering.lex_sort`` contract), which makes every row tuple
unique, so the network's one ascending order is exactly the stable sort of
the keys. Capacities are powers of two (the port's buckets); any other
length raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from spark_rapids_tpu_torch.kernels import (
    check_launch,
    require_contiguous,
    require_cuda,
    stream_handle,
)

#: arrays (keys + payload) the CUDA kernel takes at most
MAX_ARRAYS = 32

_FLIP = {torch.int32: 0x80000000, torch.uint32: 0}


def _sort_key(a: torch.Tensor) -> torch.Tensor:
    """int64 with the order of ``a`` (uint32 read through an int32 view:
    torch has few uint32 ops)."""
    if a.dtype == torch.uint32:
        return a.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return a.to(torch.int64)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.uint32:
        return a.view(torch.int32)[idx].view(torch.uint32)
    return a[idx]


def _check_args(arrs):
    n = int(arrs[-1].shape[0])
    if n < 2 or n & (n - 1):
        raise ValueError(f"sort_with_payload: length {n} is not a power of "
                         "two >= 2")
    for a in arrs:
        if a.ndim != 1 or a.shape[0] != n:
            raise ValueError("sort_with_payload: operands must be 1-D of the "
                             "payload's length")
        if a.dtype not in _FLIP:
            raise TypeError(f"sort_with_payload: operand dtype {a.dtype} "
                            "(takes int32 and uint32)")
    if arrs[-1].dtype != torch.int32:
        raise TypeError("sort_with_payload: payload must be int32")
    if len(arrs) > MAX_ARRAYS:
        raise ValueError(f"sort_with_payload: {len(arrs)} arrays (kernel "
                         f"takes at most {MAX_ARRAYS})")
    return n


def sort_with_payload_plain(operands: Sequence[torch.Tensor],
                            payload: torch.Tensor) -> List[torch.Tensor]:
    """The plain version: ``torch.sort(stable=True)`` key by key, last key
    first, carrying every array along (= ``lax.sort(operands + [payload],
    num_keys=len(operands))``)."""
    arrs = list(operands) + [payload]
    idx = torch.arange(payload.shape[0], dtype=torch.int64,
                       device=payload.device)
    for a in reversed(list(operands)):
        order = torch.sort(_sort_key(a)[idx], stable=True).indices
        idx = idx[order]
    return [_take(a, idx) for a in arrs]


def sort_with_payload(operands: Sequence[torch.Tensor],
                      payload: torch.Tensor) -> List[torch.Tensor]:
    """The operands and the payload reordered by the operands' ascending
    lexicographic order (stable by the payload iota)."""
    arrs = list(operands) + [payload]
    n = _check_args(arrs)
    if payload.device.type == "cpu":
        return sort_with_payload_plain(operands, payload)
    require_cuda(payload, "sort_with_payload")
    for a in arrs:
        if a.device != payload.device:
            raise ValueError("sort_with_payload: all arrays must share a "
                             "device")
        require_contiguous(a, "sort_with_payload")
    outs = [torch.empty_like(a) for a in arrs]
    k = len(arrs)
    in_ptrs = (ctypes.c_void_p * k)(*[a.data_ptr() for a in arrs])
    out_ptrs = (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs])
    flips = (ctypes.c_uint32 * k)(*[_FLIP[a.dtype] for a in arrs])
    from spark_rapids_tpu_torch.kernels.build import load_library
    lib = load_library("sort")
    fn = lib.srt_sort_with_payload
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
    rc = fn(in_ptrs, out_ptrs, flips, k, n, stream_handle(payload))
    check_launch(lib, rc, "sort_with_payload")
    sort_with_payload.launches += 1
    return outs


sort_with_payload.launches = 0
