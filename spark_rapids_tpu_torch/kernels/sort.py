"""Multi-operand sort with a row-index payload (port of
``spark_rapids_tpu/kernels/sort.py::sort_with_payload``).

A stable LSD radix sort over the bits of the 32-bit key operands that
vary (``csrc/sort.cu``). The payload rides the permutation and is never
compared, so the result is the stable sort of the operand tuples for any
payload, and bit for bit ``lax.sort(operands + [payload],
num_keys=len(operands))`` for the iota every caller passes. Any length
n >= 1 sorts.

The host side of the kernel is :func:`radix_plan`: from each operand's
OR and AND over the rows it lays the varying bits out in a packed key
(first operand most significant, in 64-bit words) and lists the 8-bit
digit passes. Above one tile of rows the wrapper reads the survey back
from the card to plan: one host sync per sort (``host_syncs``); a sort of
at most one tile plans on the card in its single launch.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.kernels import (
    check_launch,
    record,
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
    if n < 1:
        raise ValueError("sort_with_payload: length 0")
    for a in arrs:
        if a.ndim != 1 or a.shape[0] != n:
            raise ValueError("sort_with_payload: operands must be 1-D of the "
                             "payload's length")
    for a in arrs[:-1]:
        if a.dtype not in _FLIP:
            raise TypeError(f"sort_with_payload: operand dtype {a.dtype} "
                            "(takes int32 and uint32)")
    if arrs[-1].dtype != torch.int32:
        raise TypeError("sort_with_payload: payload must be int32")
    if len(arrs) > MAX_ARRAYS:
        raise ValueError(f"sort_with_payload: {len(arrs)} arrays (kernel "
                         f"takes at most {MAX_ARRAYS})")
    return n


# ---------------------------------------------------------------------------
# the radix plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RadixPlan:
    """Where the varying bits go and which digit passes sort them.

    ``segments``: runs of varying bits as (operand, source shift, length,
    word, destination shift); the packed key is their concatenation, the
    last operand's lowest varying bit at bit 0 of word 0 and the first
    operand's highest at bit B - 1. ``passes``: (word, shift, width) of
    every digit, least significant first; sorting stably by each in turn,
    a later word's digits on that word of the rows in the order so far,
    is the sort of the tuples."""

    bits: int
    words: int
    segments: Tuple[Tuple[int, int, int, int, int], ...]
    passes: Tuple[Tuple[int, int, int], ...]


def radix_plan(or_words: Sequence[int],
               and_words: Sequence[int]) -> RadixPlan:
    """The plan for operands whose flipped words OR to ``or_words`` and
    AND to ``and_words`` over the rows (``csrc/sort.cu`` plan_segments is
    the same walk)."""
    segs = []
    p = 0
    for k in reversed(range(len(or_words))):
        v = (or_words[k] ^ and_words[k]) & 0xFFFFFFFF
        while v:
            lo = (v & -v).bit_length() - 1
            sh = v >> lo
            length = ((~sh) & (sh + 1)).bit_length() - 1  # trailing ones
            v &= ~(((1 << length) - 1) << lo)
            src, rem = lo, length
            while rem:
                word, dst = divmod(p, 64)
                take = min(rem, 64 - dst)
                segs.append((k, src, take, word, dst))
                p, src, rem = p + take, src + take, rem - take
    words = (p + 63) // 64
    passes = []
    for w in range(words):
        wbits = min(64, p - 64 * w)
        passes.extend((w, s, min(8, wbits - s)) for s in range(0, wbits, 8))
    return RadixPlan(p, words, tuple(segs), tuple(passes))


def encode_segments(plan: RadixPlan) -> List[int]:
    """The segments as ``csrc/sort.cu`` reads them: operand | source << 5
    | (length - 1) << 10 | word << 15 | destination << 19."""
    return [k | src << 5 | (ln - 1) << 10 | w << 15 | dst << 19
            for k, src, ln, w, dst in plan.segments]


def survey_words(words: Sequence[int], n_ops: int):
    """(OR words, AND words) as unsigned ints from the kernel's survey
    words (int32: OR of each operand, then AND)."""
    vals = [v & 0xFFFFFFFF for v in words[:2 * n_ops]]
    return vals[:n_ops], vals[n_ops:]


# ---------------------------------------------------------------------------
# plain version and the CUDA wrapper
# ---------------------------------------------------------------------------

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


_LIB = None
_SMALL_ROWS = 0
_MAX_ROWS = 0


def _library():
    """The loaded ``csrc/sort.cu`` with its argument types set, built at
    first use."""
    global _LIB, _SMALL_ROWS, _MAX_ROWS
    if _LIB is None:
        from spark_rapids_tpu_torch.kernels.build import load_library
        lib = load_library("sort")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for name, args in (
                ("srt_sort_small", [p, p, p, i, i64, p, p]),
                ("srt_survey", [p, p, i, i64, p, p]),
                ("srt_sort_planned", [p, p, p, i, i64, p, i, p, p, p, i, p,
                                      i, p, p, p, i64, p])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = ctypes.c_int, args
        lib.srt_small_rows.restype = ctypes.c_int
        lib.srt_max_rows.restype = ctypes.c_int64
        lib.srt_scratch_words.restype = ctypes.c_int64
        lib.srt_scratch_words.argtypes = [i64, i]
        _SMALL_ROWS, _MAX_ROWS = lib.srt_small_rows(), lib.srt_max_rows()
        _LIB = lib
    return _LIB


def _c_array(ctype, values):
    return (ctype * max(1, len(values)))(*values)


def sort_with_payload(operands: Sequence[torch.Tensor],
                      payload: torch.Tensor) -> List[torch.Tensor]:
    """The operands and the payload reordered by the operands' ascending
    lexicographic order, stable."""
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
    lib = _library()
    if n > _MAX_ROWS:
        raise ValueError(f"sort_with_payload: {n} rows (kernel takes at most "
                         f"{_MAX_ROWS})")
    dev, k, m = payload.device, len(arrs), len(arrs) - 1
    # the outputs are the rows of one buffer (one allocation, not k)
    outs = [o.view(a.dtype) for a, o in zip(
        arrs, torch.empty((k, n), dtype=torch.int32, device=dev).unbind(0))]
    in_ptrs = _c_array(ctypes.c_void_p, [a.data_ptr() for a in arrs])
    out_ptrs = _c_array(ctypes.c_void_p, [o.data_ptr() for o in outs])
    flips = _c_array(ctypes.c_uint32, [_FLIP[a.dtype] for a in arrs])
    stream = stream_handle(payload)
    tracing = sort_with_payload.trace is not None
    if n <= _SMALL_ROWS:
        # the one-CTA sort writes its survey only for a trace
        survey = torch.empty(2 * m, dtype=torch.int32, device=dev) \
            if tracing else None
        rc = lib.srt_sort_small(in_ptrs, out_ptrs, flips, k, n,
                                survey.data_ptr() if tracing else None,
                                stream)
    else:
        # one workspace, taken before the sync: keys (2n uint64), row
        # indices (2n), scratch for the most passes the survey can ask for
        # (ceil(32 m / 8)) and the survey words
        nwords = lib.srt_scratch_words(n, 4 * m)
        ws = torch.empty(6 * n + nwords + 2 * m + 1, dtype=torch.int32,
                         device=dev)
        at = ws.data_ptr()
        survey = ws[6 * n + nwords:]
        plan, ands, iota = RadixPlan(0, 0, (), ()), [], False
        if m:
            rc = lib.srt_survey(in_ptrs, flips, k, n, survey.data_ptr(),
                                stream)
            check_launch(lib, rc, "sort_with_payload")
            # the sort's one host sync: the plan needs the varying bits
            words = survey.tolist()
            sort_with_payload.host_syncs += 1
            ors, ands = survey_words(words, m)
            plan, iota = radix_plan(ors, ands), words[2 * m] != 0
        segs = encode_segments(plan)
        npass = len(plan.passes)
        pw, ps, pwd = zip(*plan.passes) if npass else ((), (), ())
        rc = lib.srt_sort_planned(
            in_ptrs, out_ptrs, flips, k, n, _c_array(ctypes.c_uint32, segs),
            len(segs), _c_array(ctypes.c_int, pw), _c_array(ctypes.c_int, ps),
            _c_array(ctypes.c_int, pwd), npass,
            _c_array(ctypes.c_uint32, ands), int(iota), at, at + 16 * n,
            at + 24 * n, nwords, stream)
    check_launch(lib, rc, "sort_with_payload")
    sort_with_payload.launches += 1
    record("sort_with_payload", (list(operands), payload), outs)
    if tracing:
        sort_with_payload.trace.append((n, m, survey[:2 * m].clone()))
    return outs


sort_with_payload.launches = 0
#: survey read-backs (one per sort of more than one tile of rows)
sort_with_payload.host_syncs = 0
#: None, or a list that gets (rows, operands, survey words on the card)
#: per sort; ``radix_plan(*survey_words(survey.tolist(), operands))``
#: gives its B and passes once the sort has run
sort_with_payload.trace = None
