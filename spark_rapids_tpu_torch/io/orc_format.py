"""The port's own ORC codec, in place of ``pyarrow.orc`` (which the
reference's ``io/orc.py`` reads and writes through): the protobuf messages
of the file tail and the stripe footers, the compression-chunk framing,
the stripe reader and the file writer.

Reading covers flat schemas of BOOLEAN, BYTE, SHORT, INT, LONG, FLOAT,
DOUBLE, STRING, VARCHAR, CHAR, DATE, TIMESTAMP, TIMESTAMP_INSTANT and
DECIMAL columns, each mapped to the Spark type ``io/arrow_convert.py:21-47``
maps pyarrow's type to, in the encodings DIRECT, DIRECT_V2 (integer RLE v1
and v2), DICTIONARY and DICTIONARY_V2, with or without PRESENT streams;
the codecs NONE, ZLIB, SNAPPY, LZ4 and ZSTD. The index area of a stripe
(row indexes, bloom filters) is skipped and only the projected columns'
streams are read. BINARY, the nested types (LIST, MAP, STRUCT, UNION:
ROADMAP item 9), LZO and a TIMESTAMP written in another zone than UTC
raise NotImplementedError naming themselves.

Values come out in the host layout of ``io/parquet_format.py``: dates as
int32 days, timestamps as int64 micros (a value with a sub-microsecond
remainder raises, as the reference's safe cast from pyarrow's nanoseconds
does), DECIMAL64 as int64 unscaled, DECIMAL128 as Python ints, and a
string column as one sorted dictionary whose codes seed ``encoded()``
(each stripe's dictionary, or its DIRECT values, ranked once). The
run-length streams decode in C++ (``native/orc_host.cpp``).

Writing makes what pyarrow makes of the reference's tables: BYTE as
tinyint, SHORT as smallint, TIMESTAMP as TIMESTAMP_INSTANT, DECIMAL(p, s);
integer RLE v2, strings DIRECT_V2, a PRESENT stream only where a column
has nulls, stripes of ``stripe_rows`` rows, no row index; ZSTD (the
default, as the reference's ``write_orc``), ZLIB, SNAPPY, LZ4 or no
compression, in chunks of ``BLOCK_SIZE`` bytes; each column's value count
and null flag as its statistics.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch import native as N
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.io import parquet_format as PF

MAGIC = b"ORC"
#: compression kinds
NONE, ZLIB, SNAPPY, LZO, LZ4, ZSTD, BROTLI = range(7)
COMPRESSION_NAMES = ("NONE", "ZLIB", "SNAPPY", "LZO", "LZ4", "ZSTD",
                     "BROTLI")
#: type kinds
(BOOLEAN, BYTE, SHORT, INT, LONG, FLOAT, DOUBLE, STRING, BINARY, TIMESTAMP,
 LIST, MAP, STRUCT, UNION, DECIMAL, DATE, VARCHAR, CHAR,
 TIMESTAMP_INSTANT) = range(19)
KIND_NAMES = ("BOOLEAN", "BYTE", "SHORT", "INT", "LONG", "FLOAT", "DOUBLE",
              "STRING", "BINARY", "TIMESTAMP", "LIST", "MAP", "STRUCT",
              "UNION", "DECIMAL", "DATE", "VARCHAR", "CHAR",
              "TIMESTAMP_INSTANT")
#: stream kinds
(PRESENT, DATA, LENGTH, DICTIONARY_DATA, DICTIONARY_COUNT, SECONDARY,
 ROW_INDEX, BLOOM_FILTER, BLOOM_FILTER_UTF8) = range(9)
#: column encodings
DIRECT, DICTIONARY, DIRECT_V2, DICTIONARY_V2 = range(4)

#: seconds from the Unix epoch to ORC's, 2015-01-01 00:00:00 UTC
ORC_EPOCH = 1420070400
#: zone names a TIMESTAMP column may be written in to read as UTC
_UTC_ZONES = {"", "GMT", "UTC", "Etc/UTC", "Etc/GMT", "Z", "Etc/UCT", "UCT",
              "Etc/Universal", "Universal", "Zulu", "Etc/Zulu", "GMT0",
              "Etc/GMT0", "Etc/GMT+0", "Etc/GMT-0", "Greenwich"}
BLOCK_SIZE = 256 * 1024

# -- protobuf (proto2 wire format) --------------------------------------------


def pb_parse(buf) -> Dict[int, list]:
    """One message: {field number: [values]}; varints as int, 64- and
    32-bit fields as int (their raw bits), length-delimited as bytes."""
    out: Dict[int, list] = {}
    buf = bytes(buf)
    pos, n = 0, len(buf)
    try:
        while pos < n:
            key, pos = _varint(buf, pos)
            field, wire = key >> 3, key & 7
            if wire == 0:
                v, pos = _varint(buf, pos)
            elif wire == 1:
                v = int.from_bytes(buf[pos:pos + 8], "little")
                pos += 8
            elif wire == 2:
                ln, pos = _varint(buf, pos)
                v = buf[pos:pos + ln]
                if len(v) != ln:
                    raise ColumnarProcessingError("truncated protobuf field")
                pos += ln
            elif wire == 5:
                v = int.from_bytes(buf[pos:pos + 4], "little")
                pos += 4
            else:
                raise ColumnarProcessingError(f"protobuf wire type {wire}")
            out.setdefault(field, []).append(v)
    except IndexError:
        raise ColumnarProcessingError("truncated protobuf message") from None
    if pos != n:
        raise ColumnarProcessingError("truncated protobuf message")
    return out


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    acc = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            return acc, pos
        shift += 7
        if shift > 70:
            raise ColumnarProcessingError("protobuf varint too long")


def _one(msg: Dict[int, list], field: int, default=None):
    vals = msg.get(field)
    return vals[-1] if vals else default


def _uints(msg: Dict[int, list], field: int) -> List[int]:
    """A repeated unsigned field, packed or not."""
    out: List[int] = []
    for v in msg.get(field, []):
        if isinstance(v, bytes):
            pos = 0
            while pos < len(v):
                x, pos = _varint(v, pos)
                out.append(x)
        else:
            out.append(v)
    return out


class PbWriter:
    """Builds one message field by field."""

    def __init__(self):
        self.out = bytearray()

    def _key(self, field: int, wire: int) -> None:
        self._varint((field << 3) | wire)

    def _varint(self, v: int) -> None:
        while v >= 0x80:
            self.out.append((v & 0x7F) | 0x80)
            v >>= 7
        self.out.append(v)

    def uint(self, field: int, v: Optional[int]) -> "PbWriter":
        if v is not None:
            self._key(field, 0)
            self._varint(int(v))
        return self

    def bytes_(self, field: int, v) -> "PbWriter":
        if v is not None:
            b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            self._key(field, 2)
            self._varint(len(b))
            self.out += b
        return self

    def packed(self, field: int, vals: Sequence[int]) -> "PbWriter":
        w = PbWriter()
        for v in vals:
            w._varint(int(v))
        return self.bytes_(field, w.out)

    def done(self) -> bytes:
        return bytes(self.out)


# -- compression --------------------------------------------------------------


def _inflate(kind: int, chunk, block: int):
    if kind == ZLIB:
        try:
            out = zlib.decompressobj(-15).decompress(bytes(chunk), block + 1)
        except zlib.error as e:
            raise ColumnarProcessingError(f"corrupt ORC ZLIB chunk: {e}") \
                from None
        if len(out) > block:
            raise ColumnarProcessingError("ORC ZLIB chunk larger than the "
                                          "compression block")
        return out
    if kind == SNAPPY:
        try:
            return N.snappy_decompress(chunk)
        except ValueError as e:
            raise ColumnarProcessingError(f"ORC SNAPPY chunk: {e}") from None
    if kind == LZ4:
        return N.lz4_decompress(chunk, block)
    if kind == ZSTD:
        return N.zstd_decompress(chunk, block)
    raise PF.unsupported_codec("ORC", COMPRESSION_NAMES, kind, "reader")


def decompress(kind: int, data, block: int):
    """A stream (or the footer) through ORC's chunk framing: 3-byte
    little-endian headers of ``length << 1 | isOriginal``."""
    if kind == NONE:
        return data
    if kind not in (ZLIB, SNAPPY, LZ4, ZSTD):
        raise PF.unsupported_codec("ORC", COMPRESSION_NAMES, kind, "reader")
    mv = memoryview(data)
    parts, pos, n = [], 0, len(mv)
    while pos < n:
        if n - pos < 3:
            raise ColumnarProcessingError("truncated ORC compression chunk")
        h = mv[pos] | (mv[pos + 1] << 8) | (mv[pos + 2] << 16)
        pos += 3
        ln, original = h >> 1, h & 1
        if ln > n - pos:
            raise ColumnarProcessingError("truncated ORC compression chunk")
        chunk = mv[pos:pos + ln]
        pos += ln
        parts.append(bytes(chunk) if original else _inflate(kind, chunk,
                                                            block))
    if len(parts) < 2:
        return parts[0] if parts else b""
    return np.concatenate([np.frombuffer(p, dtype=np.uint8) for p in parts])


def compress(kind: int, data: bytes, block: int = BLOCK_SIZE) -> bytes:
    if kind == NONE:
        return data
    out = bytearray()
    for lo in range(0, len(data), block):
        chunk = data[lo:lo + block]
        if kind == ZSTD:
            comp = N.zstd_compress(chunk)
        elif kind == ZLIB:
            c = zlib.compressobj(6, zlib.DEFLATED, -15)
            comp = c.compress(chunk) + c.flush()
        elif kind == SNAPPY:
            comp = N.snappy_compress(chunk)
        elif kind == LZ4:
            comp = N.lz4_compress(chunk)
        else:
            raise PF.unsupported_codec("ORC", COMPRESSION_NAMES, kind,
                                       "writer")
        if len(comp) < len(chunk):
            out += struct.pack("<I", len(comp) << 1)[:3]
            out += comp
        else:
            out += struct.pack("<I", (len(chunk) << 1) | 1)[:3]
            out += chunk
    return bytes(out)


# -- the file tail ------------------------------------------------------------


def _kind_name(kind: int) -> str:
    return KIND_NAMES[kind] if 0 <= kind < len(KIND_NAMES) else str(kind)


class Column:
    """One top-level column of a file: its name, ORC column id, kind and
    the Spark type it maps to (``spark`` is None, with ``unsupported``
    naming why, for a column the port cannot read)."""

    __slots__ = ("name", "id", "kind", "precision", "scale", "spark",
                 "unsupported")

    def __init__(self, name: str, cid: int, typ: Dict[int, list]):
        self.name, self.id = name, cid
        self.kind = _one(typ, 1, 0)
        self.precision = _one(typ, 5, 0)
        self.scale = _one(typ, 6, 0)
        self.spark, self.unsupported = None, None
        k = self.kind
        simple = {BOOLEAN: T.BOOLEAN, BYTE: T.BYTE, SHORT: T.SHORT,
                  INT: T.INT, LONG: T.LONG, FLOAT: T.FLOAT,
                  DOUBLE: T.DOUBLE, STRING: T.STRING, VARCHAR: T.STRING,
                  CHAR: T.STRING, DATE: T.DATE, TIMESTAMP: T.TIMESTAMP,
                  TIMESTAMP_INSTANT: T.TIMESTAMP}
        if k in simple:
            self.spark = simple[k]
        elif k == DECIMAL and self.precision:
            self.spark = T.DecimalType(int(self.precision), int(self.scale))
        elif k in (LIST, MAP, STRUCT, UNION):
            self.unsupported = (
                f"ORC {KIND_NAMES[k]} column {name!r}: nested types are not "
                "supported by the port's ORC reader (ROADMAP item 9)")
        else:
            kname = "DECIMAL without a precision" if k == DECIMAL \
                else _kind_name(k)
            self.unsupported = (
                f"ORC {kname} column {name!r} is not supported by the "
                "port's ORC reader (the reference's type mapping rejects "
                "it)")

    def require(self) -> T.DataType:
        if self.spark is None:
            raise NotImplementedError(self.unsupported)
        return self.spark


class StripeMeta:
    __slots__ = ("offset", "index_length", "data_length", "footer_length",
                 "num_rows")

    def __init__(self, msg: Dict[int, list]):
        self.offset = _one(msg, 1, 0)
        self.index_length = _one(msg, 2, 0)
        self.data_length = _one(msg, 3, 0)
        self.footer_length = _one(msg, 4, 0)
        self.num_rows = _one(msg, 5, 0)


class FileMeta:
    """A file's tail: its columns, row count, stripes and codec."""

    def __init__(self, path: str, compression: int, block: int,
                 footer: Dict[int, list]):
        self.path = path
        self.compression = compression
        self.block = block
        self.num_rows = _one(footer, 6, 0)
        self.stripes = [StripeMeta(pb_parse(s)) for s in footer.get(3, [])]
        types = [pb_parse(t) for t in footer.get(4, [])]
        if not types:
            raise ColumnarProcessingError(f"{path}: ORC file with no types")
        root = types[0]
        if _one(root, 1) != STRUCT:
            raise NotImplementedError(
                f"{path}: ORC file whose root type is "
                f"{_kind_name(_one(root, 1, 0))}, not a STRUCT")
        ids = _uints(root, 2)
        names = [b.decode("utf-8") for b in root.get(3, [])]
        if len(ids) != len(names) or any(i >= len(types) for i in ids):
            raise ColumnarProcessingError(f"{path}: malformed ORC types")
        self.columns = [Column(nm, cid, types[cid])
                        for nm, cid in zip(names, ids)]

    def column(self, name: str) -> Column:
        for c in self.columns:
            if c.name == name:
                return c
        raise ColumnarProcessingError(
            f"column {name!r} not in {[c.name for c in self.columns]}")

    def schema(self) -> List[Tuple[str, T.DataType]]:
        return [(c.name, c.require()) for c in self.columns]


def read_tail(path: str) -> FileMeta:
    with open(path, "rb") as f:
        f.seek(0, 2)
        size = f.tell()
        if size < 4:
            raise ColumnarProcessingError(f"{path}: not an ORC file")
        tail_len = min(size, 16 * 1024)
        f.seek(size - tail_len)
        tail = f.read(tail_len)
        ps_len = tail[-1]
        if ps_len + 1 > len(tail):
            raise ColumnarProcessingError(f"{path}: not an ORC file")
        ps = pb_parse(tail[-1 - ps_len:-1])
        if _one(ps, 8000) != MAGIC:
            f.seek(0)
            if f.read(3) != MAGIC:
                raise ColumnarProcessingError(f"{path}: not an ORC file")
        footer_len = _one(ps, 1, 0)
        meta_len = _one(ps, 5, 0)
        kind = _one(ps, 2, NONE)
        block = _one(ps, 3, BLOCK_SIZE)
        start = size - 1 - ps_len - footer_len
        if start < 3 or meta_len > start:
            raise ColumnarProcessingError(f"{path}: truncated ORC tail")
        f.seek(start)
        raw = f.read(footer_len)
    footer = pb_parse(decompress(kind, raw, block))
    return FileMeta(path, kind, block, footer)


# -- stripes ------------------------------------------------------------------


class _Stripe:
    """One stripe's footer: where each (column, stream kind) lies, each
    column's encoding and the writer's zone."""

    def __init__(self, f, meta: FileMeta, sm: StripeMeta):
        self.f, self.meta, self.sm = f, meta, sm
        f.seek(sm.offset + sm.index_length + sm.data_length)
        raw = f.read(sm.footer_length)
        if len(raw) != sm.footer_length:
            raise ColumnarProcessingError(
                f"{meta.path}: truncated ORC stripe footer")
        sf = pb_parse(decompress(meta.compression, raw, meta.block))
        self.streams: Dict[Tuple[int, int], Tuple[int, int]] = {}
        pos = sm.offset
        for s in sf.get(1, []):
            st = pb_parse(s)
            kind, col, ln = _one(st, 1, 0), _one(st, 2, 0), _one(st, 3, 0)
            self.streams[(col, kind)] = (pos, ln)
            pos += ln
        self.encodings = [pb_parse(e) for e in sf.get(2, [])]
        tz = _one(sf, 3)
        self.zone = tz.decode("utf-8") if tz else ""

    def encoding(self, col: int) -> Tuple[int, int]:
        if col >= len(self.encodings):
            return DIRECT, 0
        e = self.encodings[col]
        return _one(e, 1, DIRECT), _one(e, 2, 0)

    def stream(self, col: int, kind: int):
        """The decompressed bytes of one stream, or None."""
        at = self.streams.get((col, kind))
        if at is None:
            return None
        pos, ln = at
        self.f.seek(pos)
        raw = self.f.read(ln)
        if len(raw) != ln:
            raise ColumnarProcessingError(
                f"{self.meta.path}: truncated ORC stream")
        return decompress(self.meta.compression, raw, self.meta.block)

    def need(self, col: int, kind: int, what: str):
        got = self.stream(col, kind)
        if got is None:
            raise ColumnarProcessingError(
                f"{self.meta.path}: ORC column {col} has no {what} stream")
        return got


def _bools(buf, count: int) -> np.ndarray:
    """``count`` bits of a boolean RLE stream (bits MSB first over byte
    RLE)."""
    if count == 0:
        return np.zeros(0, dtype=np.bool_)
    raw = N.orc_byte_rle_decode(buf, (count + 7) // 8)
    return np.unpackbits(raw)[:count].astype(np.bool_)


def _ints(buf, count: int, enc: int, signed: bool) -> np.ndarray:
    if count == 0:
        return np.zeros(0, dtype=np.int64)
    version = 2 if enc in (DIRECT_V2, DICTIONARY_V2) else 1
    return N.orc_int_rle_decode(buf, count, version, signed)


def _timestamps(secs: np.ndarray, nanos_enc: np.ndarray, kind: int,
                zone: str, path: str) -> np.ndarray:
    """ORC (seconds from 2015, encoded nanos) -> int64 micros, as ORC C++
    gives pyarrow nanoseconds and the reference casts them to micros."""
    if kind == TIMESTAMP and zone not in _UTC_ZONES:
        raise NotImplementedError(
            f"{path}: ORC TIMESTAMP written in zone {zone!r} (the port's ORC "
            "reader reads TIMESTAMP written in UTC, and TIMESTAMP_INSTANT)")
    zeros = (nanos_enc & 7).astype(np.int64)
    nanos = (nanos_enc >> 3).astype(np.int64)
    scaled = zeros != 0
    if scaled.any():
        nanos[scaled] *= 10 ** (zeros[scaled] + 1)
    unix = secs + ORC_EPOCH
    unix = np.where((unix < 0) & (nanos > 999_999), unix - 1, unix)
    if (nanos % 1000).any():
        raise ColumnarProcessingError(
            f"{path}: an ORC timestamp with nanoseconds would lose data as "
            "microseconds (the reference's safe cast raises)")
    return unix * 1_000_000 + nanos // 1000


def _decimals(lo: np.ndarray, hi: np.ndarray, scales: np.ndarray,
              dt: T.DecimalType):
    """Unscaled values at ``dt.scale``: int64 (DECIMAL64) or Python ints."""
    n = len(lo)
    dec128 = T.is_dec128(dt)
    fits = bool((hi == (lo.view(np.int64) >> 63)).all()) if n else True
    rescale = scales != dt.scale
    if not dec128 and fits and not rescale.any():
        return lo.view(np.int64).copy()
    vals = (hi.astype(object) << 64) + lo.astype(object) if n else \
        np.zeros(0, dtype=object)
    if rescale.any():
        for i in np.flatnonzero(rescale):
            d = int(dt.scale) - int(scales[i])
            v = int(vals[i])
            if d > 0:
                vals[i] = v * 10 ** d
            else:
                q = abs(v) // 10 ** (-d)
                vals[i] = q if v >= 0 else -q
    if dec128:
        out = np.empty(n, dtype=object)
        out[:] = vals
        return out
    return np.array([int(v) for v in vals], dtype=np.int64)


class _ColumnParts:
    """A column's stripes as they decode: validity and values, or, for a
    string column, each stripe's value table and codes into it."""

    def __init__(self, col: Column):
        self.col = col
        self.valid: List[np.ndarray] = []
        self.values: List[np.ndarray] = []
        self.tables: List[Tuple[np.ndarray, np.ndarray]] = []
        self.codes: List[np.ndarray] = []
        self.table_rows = 0

    def add_stripe(self, st: _Stripe, nrows: int) -> None:
        col, cid = self.col, self.col.id
        present = st.stream(cid, PRESENT)
        valid = (_bools(present, nrows) if present is not None
                 else np.ones(nrows, dtype=np.bool_))
        self.valid.append(valid)
        k = int(valid.sum())
        enc, dict_size = st.encoding(cid)
        kind = col.kind
        if k == 0 and kind not in (STRING, VARCHAR, CHAR):
            self.values.append(np.zeros(0, dtype=np.int64))
            return
        if kind == BOOLEAN:
            vals = _bools(st.need(cid, DATA, "DATA"), k)
        elif kind == BYTE:
            vals = N.orc_byte_rle_decode(st.need(cid, DATA, "DATA"),
                                         k).view(np.int8)
        elif kind in (SHORT, INT, LONG, DATE):
            vals = _ints(st.need(cid, DATA, "DATA"), k, enc, True)
        elif kind in (FLOAT, DOUBLE):
            dt = "<f4" if kind == FLOAT else "<f8"
            buf = st.need(cid, DATA, "DATA")
            if len(buf) < k * np.dtype(dt).itemsize:
                raise ColumnarProcessingError(
                    f"{st.meta.path}: truncated ORC {KIND_NAMES[kind]} data")
            vals = np.frombuffer(buf, dtype=dt, count=k)
        elif kind in (TIMESTAMP, TIMESTAMP_INSTANT):
            secs = _ints(st.need(cid, DATA, "DATA"), k, enc, True)
            nanos = _ints(st.need(cid, SECONDARY, "SECONDARY"), k, enc,
                          False)
            vals = _timestamps(secs, nanos, kind, st.zone, st.meta.path)
        elif kind == DECIMAL:
            lo, hi = N.orc_varint128_decode(st.need(cid, DATA, "DATA"), k)
            scales = _ints(st.need(cid, SECONDARY, "SECONDARY"), k, enc,
                           True)
            vals = _decimals(lo, hi, scales, col.spark)
        else:
            self._add_strings(st, cid, enc, dict_size, k)
            return
        self.values.append(vals)

    def _add_strings(self, st: _Stripe, cid: int, enc: int, dict_size: int,
                     k: int) -> None:
        if enc in (DICTIONARY, DICTIONARY_V2):
            lens = _ints(st.need(cid, LENGTH, "LENGTH") if dict_size
                         else b"", dict_size, enc, False)
            data = st.stream(cid, DICTIONARY_DATA)
            idx = _ints(st.need(cid, DATA, "DATA"), k, enc, False)
            if k and (int(idx.min()) < 0 or int(idx.max()) >= dict_size):
                raise ColumnarProcessingError(
                    f"{st.meta.path}: ORC dictionary index out of range")
        else:
            lens = _ints(st.need(cid, LENGTH, "LENGTH") if k else b"", k,
                         enc, False)
            data = st.stream(cid, DATA)
            idx = None
        offsets = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        data = np.frombuffer(data, dtype=np.uint8) if data is not None \
            else np.zeros(0, dtype=np.uint8)
        if (len(lens) and int(lens.min()) < 0) or offsets[-1] > len(data):
            raise ColumnarProcessingError(
                f"{st.meta.path}: truncated ORC string data")
        data = data[:offsets[-1]]
        if idx is None:
            # DIRECT values: their distinct bytes (a hash in C++) become
            # the stripe's table, so only distinct values are decoded
            idx, first = N.span_dedup(data, offsets)
            data, offsets = N.gather_spans(data, offsets, first)
        self.codes.append(idx + self.table_rows)
        self.tables.append((data, offsets))
        self.table_rows += len(offsets) - 1

    def finish(self) -> HostColumn:
        dt = self.col.spark
        valid = (np.concatenate(self.valid) if self.valid
                 else np.zeros(0, dtype=np.bool_))
        n = len(valid)
        if isinstance(dt, T.StringType):
            data, offsets = PF._joined_table(self.tables)
            codes = (np.concatenate(self.codes) if self.codes
                     else np.zeros(0, dtype=np.int64))
            return PF._string_column(valid, N.strings_from(data, offsets),
                                     codes)
        parts = [v for v in self.values if len(v)]
        if T.is_dec128(dt):
            vals = np.concatenate(parts) if parts else []
        else:
            vals = (np.concatenate(parts).astype(dt.np_dtype, copy=False)
                    if parts else [])
        return HostColumn(dt, PF._fill(dt, n, valid, vals), valid)


def read_columns(path: str, meta: FileMeta, names: Sequence[str],
                 stripes: Optional[Sequence[int]] = None) -> HostTable:
    """Decode ``names`` of ``path``'s stripes (all, or the listed ones)
    into one HostTable."""
    cols = [meta.column(nm) for nm in names]
    for c in cols:
        c.require()
    picked = (meta.stripes if stripes is None
              else [meta.stripes[i] for i in stripes])
    parts = [_ColumnParts(c) for c in cols]
    if cols:
        with open(path, "rb") as f:
            for sm in picked:
                st = _Stripe(f, meta, sm)
                for p in parts:
                    p.add_stripe(st, sm.num_rows)
    return HostTable(list(names), [p.finish() for p in parts])


def read_table(path: str, columns: Optional[Sequence[str]] = None
               ) -> HostTable:
    """Every row of ``path`` (``columns``, or all of them)."""
    meta = read_tail(path)
    names = list(columns) if columns is not None else \
        [c.name for c in meta.columns]
    return read_columns(path, meta, names)


# -- writing ------------------------------------------------------------------

CODECS = {"zstd": ZSTD, "zlib": ZLIB, "snappy": SNAPPY, "lz4": LZ4,
          "none": NONE, "uncompressed": NONE}


def _kind_of(dt: T.DataType) -> int:
    for cls, kind in ((T.BooleanType, BOOLEAN), (T.ByteType, BYTE),
                      (T.ShortType, SHORT), (T.IntegerType, INT),
                      (T.LongType, LONG), (T.FloatType, FLOAT),
                      (T.DoubleType, DOUBLE), (T.StringType, STRING),
                      (T.DateType, DATE), (T.TimestampType,
                                           TIMESTAMP_INSTANT),
                      (T.DecimalType, DECIMAL)):
        if isinstance(dt, cls):
            return kind
    raise NotImplementedError(f"writing {dt} to ORC")


def _utf8_table(col: HostColumn):
    """A string column's (codes, UTF-8 dictionary data, its offsets, its
    lengths): each distinct value encoded once, for every stripe."""
    codes, dictionary = col.encoded()
    parts = [s.encode("utf-8") for s in dictionary]
    dlens = np.fromiter((len(p) for p in parts), dtype=np.int64,
                        count=len(parts))
    doffs = np.zeros(len(parts) + 1, dtype=np.int64)
    np.cumsum(dlens, out=doffs[1:])
    return codes, np.frombuffer(b"".join(parts), dtype=np.uint8), doffs, \
        dlens


def _timestamp_streams(micros: np.ndarray) -> Tuple[bytes, bytes]:
    """(seconds from 2015, encoded nanos) as ORC C++ writes them."""
    unix = micros // 1_000_000
    nanos = (micros - unix * 1_000_000) * 1000
    unix = np.where((unix < 0) & (nanos > 999_999), unix + 1, unix)
    enc = nanos << 3
    nz = nanos != 0
    if nz.any():
        v = nanos[nz]
        z = np.zeros(len(v), dtype=np.int64)
        ok = v % 100 == 0
        v = np.where(ok, v // 100, v)
        z[ok] = 1
        for _ in range(6):
            more = ok & (v % 10 == 0) & (z < 7)
            if not more.any():
                break
            v = np.where(more, v // 10, v)
            z += more
        enc[nz] = (v << 3) | z
    return (N.orc_int_rle_encode(unix - ORC_EPOCH, True),
            N.orc_int_rle_encode(enc, False))


def _column_streams(col: HostColumn, kind: int, utf8=None
                    ) -> Tuple[List[Tuple[int, bytes]], int]:
    """[(stream kind, raw bytes)] of one column's stripe slice, and its
    encoding; a string slice takes its rows' codes and the column's
    ``_utf8_table`` as ``utf8``."""
    valid = np.asarray(col.validity, dtype=np.bool_)
    out: List[Tuple[int, bytes]] = []
    if not valid.all():
        out.append((PRESENT, N.orc_byte_rle_encode(np.packbits(valid))))
    if kind == STRING:
        codes, ddata, doffs, dlens = utf8 if utf8 is not None \
            else _utf8_table(col)
        codes = codes[valid]
        data, _ = N.gather_spans(ddata, doffs, codes)
        out.append((DATA, data.tobytes()))
        out.append((LENGTH, N.orc_int_rle_encode(dlens[codes], False)))
        return out, DIRECT_V2
    vals = col.data[valid]
    if kind == BOOLEAN:
        out.append((DATA, N.orc_byte_rle_encode(
            np.packbits(vals.astype(np.bool_)))))
        return out, DIRECT
    if kind == BYTE:
        out.append((DATA, N.orc_byte_rle_encode(vals.astype(np.int8)
                                                .view(np.uint8))))
        return out, DIRECT
    if kind in (FLOAT, DOUBLE):
        dt = "<f4" if kind == FLOAT else "<f8"
        out.append((DATA, np.ascontiguousarray(vals, dtype=dt).tobytes()))
        return out, DIRECT
    if kind == TIMESTAMP_INSTANT:
        secs, nanos = _timestamp_streams(vals.astype(np.int64))
        out += [(DATA, secs), (SECONDARY, nanos)]
        return out, DIRECT_V2
    if kind == DECIMAL:
        if T.is_dec128(col.dtype):
            obj = np.asarray(vals, dtype=object)
            lo = (obj & ((1 << 64) - 1)).astype(np.uint64) if len(obj) \
                else np.zeros(0, np.uint64)
            hi = (obj >> 64).astype(np.int64) if len(obj) \
                else np.zeros(0, np.int64)
        else:
            v = np.asarray(vals, dtype=np.int64)
            lo, hi = v.view(np.uint64), v >> 63
        out.append((DATA, N.orc_varint128_encode(lo, hi)))
        out.append((SECONDARY, N.orc_int_rle_encode(
            np.full(len(vals), col.dtype.scale, dtype=np.int64), True)))
        return out, DIRECT_V2
    out.append((DATA, N.orc_int_rle_encode(vals.astype(np.int64), True)))
    return out, DIRECT_V2


def _type_message(dt: T.DataType) -> bytes:
    w = PbWriter().uint(1, _kind_of(dt))
    if isinstance(dt, T.DecimalType):
        w.uint(5, dt.precision).uint(6, dt.scale)
    return w.done()


def write_table(table: HostTable, path: str, compression: str = "zstd",
                stripe_rows: int = 1 << 20) -> None:
    """Write ``table`` to the ORC file ``path``."""
    key = (compression or "none").lower()
    if key not in CODECS:
        raise NotImplementedError(
            f"ORC compression {compression!r} is not supported by the "
            "port's ORC writer (zstd, zlib, snappy, lz4 and none are)")
    codec = CODECS[key]
    kinds = [_kind_of(c.dtype) for c in table.columns]
    n = table.num_rows
    step = max(1, int(stripe_rows))
    utf8 = {i: _utf8_table(c) for i, (c, k) in
            enumerate(zip(table.columns, kinds)) if k == STRING}
    stripes: List[bytes] = []
    values = [0] * len(kinds)
    has_null = [False] * len(kinds)
    with open(path, "wb") as f:
        f.write(MAGIC)
        for lo in range(0, n, step):
            part = table.slice(lo, min(step, n - lo))
            offset = f.tell()
            streams, encodings = [], [PbWriter().uint(1, DIRECT).done()]
            data_len = 0
            for i, (c, kind) in enumerate(zip(part.columns, kinds)):
                strings = None
                if i in utf8:
                    codes, ddata, doffs, dlens = utf8[i]
                    strings = (codes[lo:lo + part.num_rows], ddata, doffs,
                               dlens)
                got, enc = _column_streams(c, kind, strings)
                nv = int(np.count_nonzero(c.validity))
                values[i] += nv
                has_null[i] |= nv < part.num_rows
                for skind, raw in got:
                    body = compress(codec, raw)
                    f.write(body)
                    data_len += len(body)
                    streams.append(PbWriter().uint(1, skind).uint(2, i + 1)
                                   .uint(3, len(body)).done())
                encodings.append(PbWriter().uint(1, enc).done())
            sf = PbWriter()
            for s in streams:
                sf.bytes_(1, s)
            for e in encodings:
                sf.bytes_(2, e)
            sf.bytes_(3, "GMT")
            footer = compress(codec, sf.done())
            f.write(footer)
            stripes.append(PbWriter().uint(1, offset).uint(2, 0)
                           .uint(3, data_len).uint(4, len(footer))
                           .uint(5, part.num_rows).done())
        content = f.tell() - len(MAGIC)
        meta = compress(codec, b"")
        f.write(meta)
        ft = PbWriter().uint(1, len(MAGIC)).uint(2, content)
        for s in stripes:
            ft.bytes_(3, s)
        root = PbWriter().uint(1, STRUCT).packed(
            2, range(1, len(kinds) + 1))
        for nm in table.names:
            root.bytes_(3, nm)
        ft.bytes_(4, root.done())
        for c in table.columns:
            ft.bytes_(4, _type_message(c.dtype))
        ft.uint(6, n)
        ft.bytes_(7, PbWriter().uint(1, n).uint(10, 0).done())
        for nv, hn in zip(values, has_null):
            ft.bytes_(7, PbWriter().uint(1, nv).uint(10, int(hn)).done())
        ft.uint(8, 0)
        footer = compress(codec, ft.done())
        f.write(footer)
        ps = (PbWriter().uint(1, len(footer)).uint(2, codec)
              .uint(3, BLOCK_SIZE).packed(4, [0, 12]).uint(5, len(meta))
              .uint(6, 6).bytes_(8000, MAGIC).done())
        f.write(ps)
        f.write(bytes([len(ps)]))
