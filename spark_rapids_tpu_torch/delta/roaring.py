"""64-bit roaring bitmap array: the deletion-vector bitmap codec (a copy
of ``spark_rapids_tpu/delta/roaring.py``).

Reference (SURVEY.md §2.8): Delta Lake deletion vectors store deleted row
indexes as a ``RoaringBitmapArray`` (an array of 32-bit roaring bitmaps,
one per 2^32 range) in the portable serialization; the reference's scan
applies them on the GPU (deletion-vector scan support in the delta-lake
module). This module implements the portable 32-bit roaring container
format (array / bitmap / run containers) plus the 64-bit array wrapper,
both directions, in numpy on the host, as in the reference.

Format written (standard roaring portable, no-run flavor):
  [u32 cookie=12347][u32 n_containers]
  per container: [u16 key][u16 cardinality-1]
  offset header: [u32 byte-offset] per container
  containers: array (u16 values, card<=4096) or bitmap (8KiB bitset)
Read side additionally accepts run containers (cookie 12346 + run bitset).
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from spark_rapids_tpu_torch.errors import ColumnarProcessingError

SERIAL_COOKIE_NO_RUN = 12347
SERIAL_COOKIE_RUN = 12346
NO_OFFSET_THRESHOLD = 4
ARRAY_MAX_CARD = 4096
#: 64-bit wrapper magic for the DV blob (engine-native framing; one u64
#: bitmap count follows, then each 32-bit bitmap keyed by its high word)
MAGIC_64 = 1681511377


# -- 32-bit portable bitmap --------------------------------------------------

def serialize_bitmap32(values: np.ndarray) -> bytes:
    """values: sorted unique uint32 array -> portable roaring bytes."""
    values = np.asarray(values, dtype=np.uint32)
    keys = (values >> 16).astype(np.uint16)
    lows = (values & 0xFFFF).astype(np.uint16)
    uniq_keys, starts = np.unique(keys, return_index=True)
    n = len(uniq_keys)
    bounds = list(starts) + [len(values)]

    header = struct.pack("<II", SERIAL_COOKIE_NO_RUN, n)
    desc = bytearray()
    bodies: List[bytes] = []
    for i, k in enumerate(uniq_keys):
        chunk = lows[bounds[i]:bounds[i + 1]]
        card = len(chunk)
        desc += struct.pack("<HH", int(k), card - 1)
        if card <= ARRAY_MAX_CARD:
            bodies.append(chunk.astype("<u2").tobytes())
        else:
            bits = np.zeros(8192, dtype=np.uint8)
            idx = chunk.astype(np.uint32)
            np.bitwise_or.at(bits, idx >> 3,
                             (1 << (idx & 7)).astype(np.uint8))
            bodies.append(bits.tobytes())
    # offset header (always written in the no-run flavor)
    base = len(header) + len(desc) + 4 * n
    offsets = bytearray()
    pos = base
    for b in bodies:
        offsets += struct.pack("<I", pos)
        pos += len(b)
    return bytes(header) + bytes(desc) + bytes(offsets) + b"".join(bodies)


def deserialize_bitmap32(buf: bytes, pos: int = 0):
    """-> (sorted uint32 values, bytes consumed)."""
    start = pos
    (cookie,) = struct.unpack_from("<I", buf, pos)
    has_run = (cookie & 0xFFFF) == SERIAL_COOKIE_RUN
    if has_run:
        n = (cookie >> 16) + 1
        pos += 4
        run_flags = buf[pos:pos + (n + 7) // 8]
        pos += (n + 7) // 8
    elif cookie == SERIAL_COOKIE_NO_RUN:
        (n,) = struct.unpack_from("<I", buf, pos + 4)
        pos += 8
        run_flags = b"\x00" * ((n + 7) // 8)
    else:
        raise ColumnarProcessingError(
            f"bad roaring cookie {cookie}")
    keys = np.empty(n, dtype=np.uint32)
    cards = np.empty(n, dtype=np.int64)
    for i in range(n):
        k, c = struct.unpack_from("<HH", buf, pos)
        keys[i], cards[i] = k, c + 1
        pos += 4
    if not has_run or n >= NO_OFFSET_THRESHOLD:
        pos += 4 * n  # skip offset header (containers are sequential)
    out = []
    for i in range(n):
        is_run = bool(run_flags[i >> 3] & (1 << (i & 7)))
        if is_run:
            (n_runs,) = struct.unpack_from("<H", buf, pos)
            pos += 2
            vals = []
            for _ in range(n_runs):
                s, ln = struct.unpack_from("<HH", buf, pos)
                pos += 4
                vals.append(np.arange(s, s + ln + 1, dtype=np.uint32))
            chunk = np.concatenate(vals) if vals else \
                np.empty(0, dtype=np.uint32)
        elif cards[i] <= ARRAY_MAX_CARD:
            chunk = np.frombuffer(buf, dtype="<u2", count=cards[i],
                                  offset=pos).astype(np.uint32)
            pos += 2 * cards[i]
        else:
            bits = np.frombuffer(buf, dtype=np.uint8, count=8192,
                                 offset=pos)
            pos += 8192
            chunk = np.flatnonzero(
                np.unpackbits(bits, bitorder="little")).astype(np.uint32)
        out.append(chunk + (keys[i] << 16))
    values = (np.concatenate(out) if out else np.empty(0, dtype=np.uint32))
    return values, pos - start


# -- 64-bit array wrapper ----------------------------------------------------

def serialize_dv(row_indexes: np.ndarray) -> bytes:
    """Sorted unique int64 deleted-row indexes -> DV blob."""
    v = np.unique(np.asarray(row_indexes, dtype=np.uint64))
    highs = (v >> np.uint64(32)).astype(np.uint32)
    uniq, starts = np.unique(highs, return_index=True)
    bounds = list(starts) + [len(v)]
    out = bytearray(struct.pack("<IQ", MAGIC_64, len(uniq)))
    for i, h in enumerate(uniq):
        lows = (v[bounds[i]:bounds[i + 1]] & np.uint64(0xFFFFFFFF)).astype(
            np.uint32)
        out += struct.pack("<I", int(h))
        out += serialize_bitmap32(lows)
    return bytes(out)


def deserialize_dv(buf: bytes) -> np.ndarray:
    magic, n = struct.unpack_from("<IQ", buf, 0)
    if magic != MAGIC_64:
        raise ColumnarProcessingError(f"bad deletion-vector magic {magic}")
    pos = 12
    parts = []
    for _ in range(n):
        (high,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        lows, used = deserialize_bitmap32(buf, pos)
        pos += used
        parts.append(lows.astype(np.uint64) | (np.uint64(high) << np.uint64(32)))
    return (np.concatenate(parts) if parts
            else np.empty(0, dtype=np.uint64)).astype(np.int64)
