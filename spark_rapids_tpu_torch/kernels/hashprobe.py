"""Hash-table build and probe for the equi-join (port of
``spark_rapids_tpu/kernels/hashprobe.py``: ``_slot``, ``build_table``,
``probe_rowids`` and ``probe_ranges``).

For the dominant join shape, a fact table probing a build side with
UNIQUE integer keys, a bounded-attempt open-addressing table delivers each
probe row's build match in one pass, with no sort:

* BUILD (torch ops, as the reference leaves it to XLA): each valid build
  row tries ``attempts`` salted slots in rounds. In a round, every row
  still homeless whose slot was empty at the START of the round
  scatter-maxes its rowid into that slot, and the row whose rowid is read
  back there has won it. Rows homeless after the last round, or a
  duplicated key (found by a self-probe: a placed row whose probe finds a
  DIFFERENT row), raise the device ``fail`` flag; the join then replays on
  the sort-based probe (execs/join.py).
* PROBE (the CUDA kernel ``csrc/hashprobe.cu``): each probe row walks its
  salted slots, keeps the first rowid whose build key equals its own, and
  stops at the first empty slot, which the build's rounds make exact (the
  kernel's source note gives the argument).

``build_table`` returns the reference's table, (rowid int32, key int64) per
slot; the reference keeps the key as (hi int32, lo uint32) limbs, which are
the key's two words, so the slots, the table and the flag are the
reference's bit for bit. The probe reads only the rowid table and the
build keys (``build_keys[rowid]`` is the key of an occupied slot), so
``probe_ranges`` never materializes the key table. The reference's route
to the sorted probe for an ineligible call (``KernelIneligible``: more
attempts than salts, a table over the VMEM budget) is not ported: an
attempts value outside [1, 8] raises, and the table has no size envelope.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from spark_rapids_tpu_torch.kernels import (
    check_launch,
    record,
    require_contiguous,
    require_cuda,
    stream_handle,
)

#: per-attempt hash salts (odd multiplicative constants; 8 attempts max)
_SALTS = ((0x9E3779B1, 0x85EBCA77), (0xC2B2AE3D, 0x27D4EB2F),
          (0x165667B1, 0x9E3779B9), (0xD6E8FEB9, 0xCA9B0A93),
          (0x2545F491, 0x8F4C2D17), (0xB5297A4D, 0x68E31DA5),
          (0x1B56C4E9, 0x7FEB352D), (0x846CA68B, 0xC2B2AE35))

MAX_ATTEMPTS = len(_SALTS)

_M32 = 0xFFFFFFFF


def check_attempts(attempts: int) -> int:
    if not 1 <= attempts <= MAX_ATTEMPTS:
        raise ValueError(f"spark.rapids.tpu.kernels.hashprobe.attempts="
                         f"{attempts} outside [1, {MAX_ATTEMPTS}]")
    return attempts


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32) and a constant
    ``c`` < 2^32, without int64 overflow: ``c`` splits into 16-bit halves,
    so each partial product stays below 2^48."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _slot(keys: torch.Tensor, attempt: int, mask: int) -> torch.Tensor:
    """Slot (int64) of each int64 key for one attempt: the reference's u32
    mix of the key's high and low words (``split_i64_hi_lo`` read as
    unsigned), computed in int64 with every step masked to 32 bits."""
    c1, c2 = _SALTS[attempt]
    hi = (keys >> 32) & _M32
    lo = keys & _M32
    h = _mul32(hi, c1) ^ _mul32(lo, c2)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    return h & mask


def _place_rows(keys: torch.Tensor, valid: torch.Tensor, H: int,
                attempts: int):
    """The build's rounds. Returns (table_row over H slots and one drop
    slot per row past them, placed, myslot, drop)."""
    check_attempts(attempts)
    dev = keys.device
    cap = int(keys.shape[0])
    mask = H - 1
    rowid = torch.arange(cap, dtype=torch.int32, device=dev)
    # rows that do not compete write past the table, each to its own slot
    # (one shared drop slot would serialize their atomics)
    drop = H + rowid.to(torch.int64)
    table_row = torch.full((H + cap,), -1, dtype=torch.int32, device=dev)
    placed = torch.zeros(cap, dtype=torch.bool, device=dev)
    myslot = torch.zeros(cap, dtype=torch.int64, device=dev)
    for a in range(attempts):
        slots = _slot(keys, a, mask)
        occupied = table_row[slots] >= 0
        want = valid & ~placed & ~occupied
        tgt = torch.where(want, slots, drop)
        table_row.scatter_reduce_(0, tgt, rowid, "amax")
        won = want & (table_row[slots] == rowid)
        placed = placed | won
        myslot = torch.where(won, slots, myslot)
    return table_row, placed, myslot, drop


def build_table(keys: torch.Tensor, valid: torch.Tensor, H: int,
                attempts: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Open-addressing build over int64 ``keys`` (rows where ``valid``).
    Returns (table_row int32 with -1 empties, table_key int64 with 0
    empties, fail_build 0-d bool)."""
    table_row, placed, myslot, drop = _place_rows(keys, valid, H, attempts)
    fail_build = (valid & ~placed).any()
    table_key = torch.zeros(table_row.shape, dtype=torch.int64,
                            device=keys.device)
    table_key[torch.where(placed, myslot, drop)] = keys
    return table_row[:H], table_key[:H], fail_build


def _check_probe_args(keys, valid, table_row, build_keys, attempts):
    check_attempts(attempts)
    if keys.dtype != torch.int64 or valid.dtype != torch.bool:
        raise TypeError("probe_rowids: keys must be int64 and valid bool")
    if table_row.dtype != torch.int32 or build_keys.dtype != torch.int64:
        raise TypeError("probe_rowids: table_row must be int32 and "
                        "build_keys int64")
    if keys.ndim != 1 or valid.shape != keys.shape or build_keys.ndim != 1:
        raise ValueError("probe_rowids: keys and valid must be (n,), "
                         "build_keys one-dimensional")
    H = int(table_row.shape[0])
    if table_row.ndim != 1 or H < 1 or H & (H - 1):
        raise ValueError(f"probe_rowids: table of {H} slots (a power of "
                         "two)")
    return H


def probe_rowids_plain(keys: torch.Tensor, valid: torch.Tensor,
                       table_row: torch.Tensor, build_keys: torch.Tensor,
                       attempts: int) -> torch.Tensor:
    """The plain version: the reference kernel's body over the whole
    array (every attempt for every row; the first hit wins). An occupied
    slot's key is ``build_keys[rowid]``, the key ``build_table`` stores
    there."""
    mask = int(table_row.shape[0]) - 1
    ri = torch.full(keys.shape, -1, dtype=torch.int32, device=keys.device)
    if build_keys.numel() == 0:
        return ri  # no build row: every slot is empty
    found = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    for a in range(attempts):
        slots = _slot(keys, a, mask)
        r = table_row[slots]
        occupied = r >= 0
        slot_key = build_keys[torch.where(occupied, r, 0)]
        hit = valid & ~found & occupied & (slot_key == keys)
        ri = torch.where(hit, r, ri)
        found = found | hit
    return ri


_LIB = None


def _library():
    """The loaded ``csrc/hashprobe.cu`` with its argument types set, built
    at first use."""
    global _LIB
    if _LIB is None:
        from spark_rapids_tpu_torch.kernels.build import load_library
        lib = load_library("hashprobe")
        p = ctypes.c_void_p
        lib.srt_probe_rowids.restype = ctypes.c_int
        lib.srt_probe_rowids.argtypes = [p, p, p, p, p, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int, p]
        _LIB = lib
    return _LIB


def probe_rowids(keys: torch.Tensor, valid: torch.Tensor,
                 table_row: torch.Tensor, build_keys: torch.Tensor,
                 attempts: int) -> torch.Tensor:
    """Per probe row the matching build rowid (int32), -1 when unmatched
    or invalid. ``table_row`` is ``build_table``'s over ``build_keys``."""
    H = _check_probe_args(keys, valid, table_row, build_keys, attempts)
    if keys.device.type == "cpu":
        return probe_rowids_plain(keys, valid, table_row, build_keys,
                                  attempts)
    require_cuda(keys, "probe_rowids")
    for t in (keys, valid, table_row, build_keys):
        if t.device != keys.device:
            raise ValueError("probe_rowids: all tensors must share a device")
        require_contiguous(t, "probe_rowids")
    out = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    lib = _library()
    rc = lib.srt_probe_rowids(keys.data_ptr(), valid.data_ptr(),
                              table_row.data_ptr(), build_keys.data_ptr(),
                              out.data_ptr(), int(keys.shape[0]), H, attempts,
                              stream_handle(keys))
    check_launch(lib, rc, "probe_rowids")
    probe_rowids.launches += 1
    record("probe_rowids", (keys, valid, table_row, build_keys, attempts),
           out)
    return out


probe_rowids.launches = 0


def probe_ranges(lkey, rkey, live_l: torch.Tensor, live_r: torch.Tensor,
                 H: int, attempts: int):
    """Build + self-probe + probe, packaged as the sort-based probe's range
    form. ``lkey``/``rkey`` are (data, validity) of the probe and build
    keys. Returns (lo, counts in {0,1} int32, total int64, matched_l,
    rs_perm = iota, fail)."""
    check_attempts(attempts)
    (ld, lv), (rd, rv) = lkey, rkey
    ld = ld.to(torch.int64).contiguous()
    rd = rd.to(torch.int64).contiguous()
    valid_r = (rv & live_r).contiguous()
    valid_l = (lv & live_l).contiguous()
    # build_table's rowid table and flag; the probe reads keys from rd
    table_row, placed, _, _ = _place_rows(rd, valid_r, H, attempts)
    fail_build = (valid_r & ~placed).any()
    trow = table_row[:H]
    # duplicate-key detection: a placed row whose own probe resolves to a
    # DIFFERENT row shares its key with that row
    self_ri = probe_rowids(rd, valid_r, trow, rd, attempts)
    rowid_r = torch.arange(rd.shape[0], dtype=torch.int32, device=rd.device)
    dup = (valid_r & (self_ri >= 0) & (self_ri != rowid_r)).any()
    ri = probe_rowids(ld, valid_l, trow, rd, attempts)
    matched = ri >= 0
    counts = matched.to(torch.int32)
    lo = torch.where(matched, ri, torch.zeros_like(ri))
    total = counts.sum(dtype=torch.int64)
    return lo, counts, total, matched, rowid_r, fail_build | dup
