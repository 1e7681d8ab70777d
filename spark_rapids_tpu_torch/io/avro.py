"""Avro object-container-file scan (port of the columnar part of
``spark_rapids_tpu/io/avro.py``; reference: GpuAvroScan /
AvroDataFileReader).

The container is decoded on the host by a pure-Python binary decoder
(``struct``, ``zlib``, ``json``: no Avro library) into columnar numpy, and
uploads through the shared scan machinery, so PERFILE, COALESCING and
MULTITHREADED come from FileScanNode (io/common.py).

Schemas: records of null/boolean/int/long/float/double/string, nullable
unions ``["null", T]``, and the logical types date (int) and
timestamp-millis/micros (long). Other branches (bytes, fixed, enum, map,
nested records, arrays, unions of several types) raise with a reason
instead of decoding wrongly. Codecs: null and deflate; zstandard when the
``zstandard`` module imports (else it raises naming the module); snappy is
rejected, as in the reference. The reference's generic nested-record
decoder (Iceberg's manifests) is not ported."""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

from spark_rapids_tpu_torch import conf as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.io.common import FileScanNode
from spark_rapids_tpu_torch.plan.nodes import Schema

MAGIC = b"Obj\x01"

_F32 = struct.Struct("<f")
_F64 = struct.Struct("<d")


class ByteReader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise ColumnarProcessingError("truncated avro data")
        self.pos += n
        return b

    def read_long(self) -> int:
        """Zigzag varint (avro int and long share the encoding)."""
        buf, pos = self.buf, self.pos
        shift = 0
        acc = 0
        while True:
            if pos >= len(buf):
                raise ColumnarProcessingError("truncated avro varint")
            b = buf[pos]
            pos += 1
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        self.pos = pos
        return (acc >> 1) ^ -(acc & 1)

    def read_bytes(self) -> bytes:
        return self.read(self.read_long())

    def at_end(self) -> bool:
        return self.pos >= len(self.buf)


# -- schema mapping ----------------------------------------------------------

def _spark_type_of(field_schema: Any) -> Tuple[T.DataType, bool]:
    """(spark type, nullable) for one avro field schema; raises on
    unsupported shapes (the reference's willNotWorkOnGpu analog)."""
    if isinstance(field_schema, list):  # union
        branches = [b for b in field_schema if b != "null"]
        if len(branches) != 1 or len(field_schema) > 2:
            raise ColumnarProcessingError(
                f"unsupported avro union {field_schema} (only "
                "[\"null\", T] unions are supported)")
        dt, _ = _spark_type_of(branches[0])
        return dt, True
    if isinstance(field_schema, dict):
        logical = field_schema.get("logicalType")
        base = field_schema.get("type")
        if logical == "date" and base == "int":
            return T.DATE, False
        if logical == "timestamp-micros" and base == "long":
            return T.TIMESTAMP, False
        if logical == "timestamp-millis" and base == "long":
            return T.TIMESTAMP, False
        if logical is None and isinstance(base, str):
            return _spark_type_of(base)
        raise ColumnarProcessingError(
            f"unsupported avro logical type {field_schema}")
    mapping = {"boolean": T.BOOLEAN, "int": T.INT, "long": T.LONG,
               "float": T.FLOAT, "double": T.DOUBLE, "string": T.STRING}
    if field_schema in mapping:
        return mapping[field_schema], False
    raise ColumnarProcessingError(
        f"unsupported avro type {field_schema!r} (bytes/fixed/enum/map/"
        "array/nested records are not supported)")


def _decoder_of(field_schema: Any) -> Callable[[ByteReader], Any]:
    """Value decoder for one (non-null-branch) schema; None return means
    the null branch was taken."""
    if isinstance(field_schema, list):
        branches = list(field_schema)
        inner = _decoder_of([b for b in branches if b != "null"][0])
        null_index = branches.index("null")

        def dec_union(r: ByteReader):
            idx = r.read_long()
            if idx == null_index:
                return None
            return inner(r)
        return dec_union
    if isinstance(field_schema, dict):
        logical = field_schema.get("logicalType")
        if logical == "timestamp-millis":
            return lambda r: r.read_long() * 1000  # -> micros
        return _decoder_of(field_schema["type"])
    if field_schema in ("int", "long"):
        return ByteReader.read_long
    if field_schema == "boolean":
        return lambda r: r.read(1) == b"\x01"
    if field_schema == "float":
        return lambda r: _F32.unpack(r.read(4))[0]
    if field_schema == "double":
        return lambda r: _F64.unpack(r.read(8))[0]
    if field_schema == "string":
        return lambda r: r.read_bytes().decode("utf-8")
    raise ColumnarProcessingError(f"unsupported avro type {field_schema!r}")


# -- container file ----------------------------------------------------------

class AvroFileInfo:
    def __init__(self, schema_json: dict, codec: str, sync: bytes,
                 blocks_offset: int):
        self.schema_json = schema_json
        self.codec = codec
        self.sync = sync
        self.blocks_offset = blocks_offset


def read_header(buf: bytes) -> AvroFileInfo:
    """Parse the container header: magic, metadata map, sync marker
    (AvroDataFileReader header parse analog)."""
    if buf[:4] != MAGIC:
        raise ColumnarProcessingError("not an avro object container file")
    r = ByteReader(buf, 4)
    meta: Dict[str, bytes] = {}
    while True:
        n = r.read_long()
        if n == 0:
            break
        if n < 0:  # negative count: abs count + byte size follows
            n = -n
            r.read_long()
        for _ in range(n):
            key = r.read_bytes().decode("utf-8")
            meta[key] = r.read_bytes()
    sync = r.read(16)
    schema_json = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    return AvroFileInfo(schema_json, codec, sync, r.pos)


def _decompress_block(codec: str, data: bytes) -> bytes:
    if codec == "null":
        return data
    if codec == "deflate":
        return zlib.decompress(data, wbits=-15)  # raw DEFLATE per spec
    if codec == "zstandard":
        try:
            import zstandard
        except ImportError:
            raise ColumnarProcessingError(
                "avro zstandard codec needs the zstandard module")
        return zstandard.ZstdDecompressor().decompress(data)
    raise ColumnarProcessingError(f"unsupported avro codec {codec!r}")


def decode_file(buf: bytes) -> HostTable:
    """Decode a whole container file to a HostTable."""
    info = read_header(buf)
    schema = info.schema_json
    if schema.get("type") != "record":
        raise ColumnarProcessingError("avro top-level schema must be a record")
    fields = schema["fields"]
    names = [f["name"] for f in fields]
    spark_types = []
    decoders = []
    for f in fields:
        dt, _nullable = _spark_type_of(f["type"])
        spark_types.append(dt)
        decoders.append(_decoder_of(f["type"]))

    values: List[List[Any]] = [[] for _ in fields]
    r = ByteReader(buf, info.blocks_offset)
    while not r.at_end():
        count = r.read_long()
        size = r.read_long()
        block = ByteReader(_decompress_block(info.codec, r.read(size)))
        if r.read(16) != info.sync:
            raise ColumnarProcessingError("avro sync marker mismatch")
        for _ in range(count):
            for dec, out in zip(decoders, values):
                out.append(dec(block))

    cols = []
    for dt, vals in zip(spark_types, values):
        validity = np.array([v is not None for v in vals], dtype=np.bool_)
        if isinstance(dt, T.StringType):
            data = np.array(vals, dtype=object)
        else:
            fill = [v if v is not None else 0 for v in vals]
            data = np.asarray(fill, dtype=dt.np_dtype)
        cols.append(HostColumn(dt, data, validity))
    return HostTable(names, cols)


class AvroScanNode(FileScanNode):
    format_name = "avro"

    def _conf_reader_type(self) -> str:
        return self.conf.get_entry(C.AVRO_READER_TYPE)

    def file_schema(self, path: str) -> Schema:
        with open(path, "rb") as f:
            head = f.read(1 << 16)
        try:
            info = read_header(head)
        except ColumnarProcessingError:
            with open(path, "rb") as f:  # header larger than probe window
                info = read_header(f.read())
        return [(f["name"], _spark_type_of(f["type"])[0])
                for f in info.schema_json["fields"]]

    def read_file(self, path: str) -> HostTable:
        with open(path, "rb") as f:
            buf = f.read()
        table = decode_file(buf)
        if self.columns is not None:
            data_names = [n for n, _ in self.data_schema]
            idx = {n: i for i, n in enumerate(table.names)}
            table = HostTable([n for n in data_names],
                              [table.columns[idx[n]] for n in data_names])
        return table
