"""Packed host-table wire format "TPAK" (port of
``spark_rapids_tpu/shuffle/serializer.py``: ``pack_table`` and
``unpack_table``, version 2 with its CRC32 footer). A frame the port
writes is byte for byte the reference's frame of the same table, and each
package reads the other's.

Layout (little-endian):

  magic  b"TPAK"  | version u32 | ncols u32 | nrows u64
  per column header: name_len u16 + name utf8, dtype tag u8,
                     precision u8, scale u8 (zero but for decimals)
  per column body:   validity bitmask ceil(n/8) bytes, then
     fixed-width: raw array bytes (n * itemsize)
     DECIMAL128:  two little-endian int64 limbs a row
     string:      offsets int64[n+1] + utf8 blob (null rows: empty)
  footer:            crc32 u32 over everything above

A string column is written from its sorted dictionary (``HostColumn.
encoded``: each distinct value is encoded to UTF-8 once and the blob is one
numpy gather); the reader decodes the blob in C (``native.strings_from``)
and the reduce side's upload rebuilds the sorted dictionary of what it
concatenated (``DeviceColumn.from_host``). A corrupt frame raises the
retryable CorruptFrameError."""

from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.columnar.column import (
    dec128_limbs,
    dec128_unscaled,
)
from spark_rapids_tpu_torch.errors import CorruptFrameError

MAGIC = b"TPAK"
VERSION = 2

_TAGS = [
    (T.BooleanType, 1), (T.ByteType, 2), (T.ShortType, 3), (T.IntegerType, 4),
    (T.LongType, 5), (T.FloatType, 6), (T.DoubleType, 7), (T.StringType, 8),
    (T.DateType, 9), (T.TimestampType, 10), (T.NullType, 11),
    (T.DecimalType, 12),
]
_TAG_OF = {cls: tag for cls, tag in _TAGS}
_CLS_OF = {tag: cls for cls, tag in _TAGS}


def _dtype_of_tag(tag: int, extra: Tuple[int, int]) -> T.DataType:
    cls = _CLS_OF[tag]
    if cls is T.DecimalType:
        return T.DecimalType(extra[0], extra[1])
    return cls()


def _string_body(col: HostColumn, n: int) -> Tuple[bytes, bytes]:
    """(offsets, blob) of a string column: the sorted dictionary's values
    encoded once, then one gather of their bytes by row."""
    offsets = np.zeros(n + 1, dtype=np.int64)
    if n == 0:
        return offsets.tobytes(), b""
    codes, dictionary = col.encoded()
    enc = [s.encode("utf-8") for s in dictionary]
    dlen = np.fromiter((len(b) for b in enc), dtype=np.int64,
                       count=len(enc))
    valid = np.asarray(col.validity, dtype=bool)
    lens = np.where(valid, dlen[codes] if len(enc) else 0, 0)
    np.cumsum(lens, out=offsets[1:])
    total = int(offsets[-1])
    if total == 0:
        return offsets.tobytes(), b""
    dblob = np.frombuffer(b"".join(enc), dtype=np.uint8)
    dstart = np.zeros(len(enc), dtype=np.int64)
    np.cumsum(dlen[:-1], out=dstart[1:])
    # byte j of row i lives at dstart[code_i] + (j - offsets[i])
    shift = np.repeat(dstart[codes] - offsets[:-1], lens)
    idx = shift + np.arange(total, dtype=np.int64)
    return offsets.tobytes(), dblob[idx].tobytes()


def pack_table(table: HostTable) -> bytes:
    out: List[bytes] = [MAGIC, struct.pack(
        "<IIQ", VERSION, len(table.columns), table.num_rows)]
    n = table.num_rows
    for name, col in zip(table.names, table.columns):
        nb = name.encode("utf-8")
        tag = _TAG_OF.get(type(col.dtype))
        if tag is None:
            raise NotImplementedError(
                f"TPAK frames hold flat columns; {name!r} is "
                f"{col.dtype.simple_string()}")
        out.append(struct.pack("<H", len(nb)))
        out.append(nb)
        if isinstance(col.dtype, T.DecimalType):
            out.append(struct.pack("<BBB", tag, col.dtype.precision,
                                   col.dtype.scale))
        else:
            out.append(struct.pack("<BBB", tag, 0, 0))
    for col in table.columns:
        out.append(np.packbits(np.asarray(col.validity, dtype=np.uint8),
                               bitorder="little").tobytes())
        if isinstance(col.dtype, T.StringType):
            out.extend(_string_body(col, n))
        elif isinstance(col.dtype, T.NullType):
            pass  # validity only
        elif T.is_dec128(col.dtype):
            out.append(np.ascontiguousarray(
                dec128_limbs(col.data, col.validity, n)).tobytes())
        else:
            arr = np.ascontiguousarray(col.data, dtype=col.dtype.np_dtype)
            out.append(arr.tobytes())
    body = b"".join(out)
    return body + struct.pack("<I", zlib.crc32(body))


def unpack_table(buf, offset: int = 0) -> Tuple[HostTable, int]:
    """(table, bytes consumed from ``offset``). A bad magic or version, a
    truncation or a CRC mismatch raises the retryable CorruptFrameError."""
    view = memoryview(buf)
    pos = offset
    try:
        if bytes(view[pos:pos + 4]) != MAGIC:
            raise CorruptFrameError("bad TPAK magic")
        pos += 4
        version, ncols, nrows = struct.unpack_from("<IIQ", view, pos)
        pos += 16
        if version != VERSION:
            raise CorruptFrameError(f"TPAK version {version}")
    except struct.error as e:
        raise CorruptFrameError(f"truncated TPAK header: {e}") from e
    try:
        names, cols, pos = _unpack_body(view, pos, ncols, nrows)
    except (struct.error, ValueError, KeyError, UnicodeDecodeError,
            IndexError, OverflowError) as e:
        raise CorruptFrameError(f"corrupt TPAK frame: {e}") from e
    try:
        (stored_crc,) = struct.unpack_from("<I", view, pos)
    except struct.error as e:
        raise CorruptFrameError("TPAK frame missing CRC footer") from e
    if zlib.crc32(view[offset:pos]) != stored_crc:
        raise CorruptFrameError("TPAK CRC mismatch (corrupt frame)")
    pos += 4
    return HostTable(names, cols), pos - offset


def _unpack_body(view: memoryview, pos: int, ncols: int, nrows: int):
    from spark_rapids_tpu_torch import native
    names: List[str] = []
    dtypes: List[T.DataType] = []
    for _ in range(ncols):
        (nlen,) = struct.unpack_from("<H", view, pos)
        pos += 2
        names.append(bytes(view[pos:pos + nlen]).decode("utf-8"))
        pos += nlen
        tag, p, s = struct.unpack_from("<BBB", view, pos)
        pos += 3
        dtypes.append(_dtype_of_tag(tag, (p, s)))
    cols: List[HostColumn] = []
    vbytes = (nrows + 7) // 8
    for dt in dtypes:
        validity = np.unpackbits(
            np.frombuffer(view, dtype=np.uint8, count=vbytes, offset=pos),
            bitorder="little")[:nrows].astype(np.bool_)
        pos += vbytes
        if isinstance(dt, T.StringType):
            offsets = np.frombuffer(view, dtype=np.int64, count=nrows + 1,
                                    offset=pos)
            pos += offsets.nbytes
            blob_len = int(offsets[-1]) if nrows else 0
            if blob_len < 0 or pos + blob_len > len(view) or (
                    nrows and (np.any(np.diff(offsets) < 0)
                               or offsets[0] != 0)):
                raise ValueError("bad string offsets")
            blob = np.frombuffer(view, dtype=np.uint8, count=blob_len,
                                 offset=pos)
            pos += blob_len
            data = native.strings_from(blob, offsets)
            data[~validity] = None
            cols.append(HostColumn(dt, data, validity))
        elif isinstance(dt, T.NullType):
            cols.append(HostColumn(dt, np.zeros(nrows, dtype=np.int8),
                                   validity))
        elif T.is_dec128(dt):
            limbs = np.frombuffer(view, dtype=np.int64, count=2 * nrows,
                                  offset=pos).reshape(nrows, 2)
            pos += int(nrows) * 16
            cols.append(HostColumn(dt, dec128_unscaled(limbs, validity),
                                   validity))
        else:
            np_dt = dt.np_dtype
            data = np.frombuffer(view, dtype=np_dt, count=nrows,
                                 offset=pos).copy()
            pos += int(nrows) * np_dt.itemsize
            cols.append(HostColumn(dt, data, validity))
    return names, cols, pos
