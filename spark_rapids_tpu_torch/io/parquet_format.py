"""The port's own Parquet codec, in place of pyarrow (which the reference's
``io/parquet.py`` and ``io/arrow_convert.py`` decode through, and which
the card's machine does not have): the Thrift compact protocol of the
footer and the page headers, the page decoder and the file writer.

Reading covers flat schemas of REQUIRED and OPTIONAL columns: BOOLEAN,
INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY and FIXED_LEN_BYTE_ARRAY,
with the annotations signed ``Int`` 8/16/32/64, STRING/UTF8, DATE,
TIMESTAMP (MILLIS, MICROS and NANOS) and DECIMAL, each mapped to the Spark
type ``io/arrow_convert.py:21-47`` maps pyarrow's type to (INT96 and NANOS
as micros: a sub-microsecond remainder raises, as the reference's safe
cast does); the encodings PLAIN, PLAIN_DICTIONARY, RLE_DICTIONARY, RLE,
BIT_PACKED, DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY
and BYTE_STREAM_SPLIT; DATA_PAGE v1 and v2 pages after an optional
dictionary page (a chunk may fall back to another encoding after it); the
codecs UNCOMPRESSED, SNAPPY, GZIP, ZSTD, LZ4_RAW and LZ4 (Hadoop-framed
blocks, else one raw block, as Arrow reads it). Nested columns read too
(:class:`NestedColumn`): LIST in its 3-level form and the legacy 2-level
form (a repeated field, bare or under a LIST group), MAP (``key_value``)
and STRUCT groups, over fixed-width leaves; their offsets and validity at
each level are rebuilt from the repetition and definition levels
(:func:`list_layout`), vectorised. Everything else raises
NotImplementedError naming itself: BROTLI (its decoder needs RFC 7932's
static dictionary, which is not in the repository) and LZO (nothing the
port can test against writes it), nested columns without a device layout
(a list of structs, a list of lists, string leaves: an extension the
reference lacks, whose reader raises on every nested Arrow type; ROADMAP
item [9-ext]), unsigned integers and plain binary.

Values come out in the host layout of ``interop.host_table_from_arrays``:
dates as int32 days, timestamps as int64 micros, DECIMAL64 as int64
unscaled, DECIMAL128 as Python ints. A string column's chunks merge into
one sorted dictionary whose codes seed the column's ``encoded()`` cache
(equal to what ``encode_sorted_dict`` gives for the same rows), and its
values are ``dictionary[codes]``, which makes no new str objects.
Decoding is vectorised: the host library for Snappy, the RLE /
bit-packed hybrid, BYTE_ARRAY values and the DELTA encodings
(``native/parquet_host.cpp``), ZSTD (``native/zstd_host.cpp``) and LZ4
(``native/lz4_host.cpp``), numpy for the rest.

Writing makes version-1 data pages with RLE definition levels (every
column OPTIONAL, as Spark writes), RLE_DICTIONARY for strings and PLAIN
for every other type, statistics (min, max, null count) on every chunk,
SNAPPY (the default), GZIP, ZSTD, LZ4 (as pyarrow writes ``"lz4"``: the
LZ4_RAW codec) or no compression, ``row_group_rows`` rows a
row group and pages of about ``page_bytes``. Array, map and struct
columns are written as pyarrow writes them: the 3-level LIST (``list`` /
``element``), MAP (``key_value`` / ``key`` / ``value``) and a STRUCT
group, each leaf with RLE repetition and definition levels. Types are written as pyarrow
writes the reference's tables: BYTE and SHORT as annotated INT32, DATE as
INT32 (Date), TIMESTAMP as INT64 micros adjusted to UTC, DECIMAL as the
shortest FIXED_LEN_BYTE_ARRAY that holds its precision.
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

MAGIC = b"PAR1"

# physical types
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FLBA = range(8)
PHYSICAL_NAMES = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE",
                  "BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY")
# repetition
REQUIRED, OPTIONAL, REPEATED = range(3)
# compression codecs
UNCOMPRESSED, SNAPPY, GZIP, LZO, BROTLI, LZ4, ZSTD, LZ4_RAW = range(8)
CODEC_NAMES = ("UNCOMPRESSED", "SNAPPY", "GZIP", "LZO", "BROTLI", "LZ4",
               "ZSTD", "LZ4_RAW")
# encodings
PLAIN, PLAIN_DICTIONARY, RLE, BIT_PACKED = 0, 2, 3, 4
DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY = 5, 6, 7
RLE_DICTIONARY, BYTE_STREAM_SPLIT = 8, 9
ENCODING_NAMES = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE",
                  4: "BIT_PACKED", 5: "DELTA_BINARY_PACKED",
                  6: "DELTA_LENGTH_BYTE_ARRAY", 7: "DELTA_BYTE_ARRAY",
                  8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
# page types
DATA_PAGE, INDEX_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = range(4)
# converted types (the legacy annotations)
CT_UTF8, CT_ENUM, CT_DECIMAL, CT_DATE = 0, 4, 5, 6
CT_TIMESTAMP_MILLIS, CT_TIMESTAMP_MICROS = 9, 10
#: the Julian day of 1970-01-01 (INT96 timestamps count Julian days)
JULIAN_UNIX_EPOCH = 2440588
CT_UINT = (11, 12, 13, 14)
CT_INT_8, CT_INT_16, CT_INT_32, CT_INT_64 = 15, 16, 17, 18
CT_JSON = 19

# -- Thrift compact protocol --------------------------------------------------

_STOP, _TRUE, _FALSE, _I8, _I16, _I32, _I64, _DOUBLE, _BINARY = range(9)
_LIST, _SET, _MAP, _STRUCT = 9, 10, 11, 12


class ThriftReader:
    """Reads compact-protocol structs into {field id: value} dicts
    (nested structs as dicts, lists as lists); fields a reader does not
    know are read and left unused, which skips them."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _byte(self) -> int:
        try:
            b = self.buf[self.pos]
        except IndexError:
            raise ColumnarProcessingError("truncated Thrift data") from None
        self.pos += 1
        return b

    def varint(self) -> int:
        acc = shift = 0
        while True:
            b = self._byte()
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                return acc
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def value(self, ttype: int):
        if ttype in (_TRUE, _FALSE):
            return ttype == _TRUE
        if ttype == _I8:
            b = self._byte()
            return b - 256 if b > 127 else b
        if ttype in (_I16, _I32, _I64):
            return self.zigzag()
        if ttype == _DOUBLE:
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if ttype == _BINARY:
            n = self.varint()
            v = bytes(self.buf[self.pos:self.pos + n])
            if len(v) != n:
                raise ColumnarProcessingError("truncated Thrift binary")
            self.pos += n
            return v
        if ttype in (_LIST, _SET):
            head = self._byte()
            size, etype = head >> 4, head & 0x0F
            if size == 15:
                size = self.varint()
            if etype in (_TRUE, _FALSE):
                return [self._byte() == _TRUE for _ in range(size)]
            return [self.value(etype) for _ in range(size)]
        if ttype == _MAP:
            size = self.varint()
            if size == 0:
                return {}
            kv = self._byte()
            return {self.value(kv >> 4): self.value(kv & 0x0F)
                    for _ in range(size)}
        if ttype == _STRUCT:
            return self.struct()
        raise ColumnarProcessingError(f"bad Thrift type {ttype}")

    def struct(self) -> Dict[int, object]:
        out: Dict[int, object] = {}
        last = 0
        while True:
            head = self._byte()
            if head == _STOP:
                return out
            delta, ttype = head >> 4, head & 0x0F
            fid = last + delta if delta else self.zigzag()
            out[fid] = self.value(ttype)
            last = fid


class ThriftWriter:
    """Writes compact-protocol structs from [(field id, type, value)]
    lists; a STRUCT value is such a list, a LIST value is (element type,
    [values]); None values are left out."""

    def __init__(self):
        self.out = bytearray()

    def varint(self, v: int) -> None:
        while v >= 0x80:
            self.out.append((v & 0x7F) | 0x80)
            v >>= 7
        self.out.append(v)

    def zigzag(self, v: int) -> None:
        self.varint((v << 1) ^ (v >> 63))

    def value(self, ttype: int, v) -> None:
        if ttype in (_I16, _I32, _I64):
            self.zigzag(int(v))
        elif ttype == _I8:
            self.out.append(int(v) & 0xFF)
        elif ttype == _DOUBLE:
            self.out += struct.pack("<d", v)
        elif ttype == _BINARY:
            b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            self.varint(len(b))
            self.out += b
        elif ttype == _LIST:
            etype, items = v
            if len(items) < 15:
                self.out.append((len(items) << 4) | etype)
            else:
                self.out.append(0xF0 | etype)
                self.varint(len(items))
            for item in items:
                if etype in (_TRUE, _FALSE):
                    self.out.append(_TRUE if item else _FALSE)
                else:
                    self.value(etype, item)
        elif ttype == _STRUCT:
            self.struct(v)
        else:
            raise ValueError(f"unsupported Thrift type {ttype}")

    def struct(self, fields) -> None:
        last = 0
        for fid, ttype, v in fields:
            if v is None:
                continue
            if ttype in (_TRUE, _FALSE):
                ttype = _TRUE if v else _FALSE
            delta = fid - last
            if 0 < delta <= 15:
                self.out.append((delta << 4) | ttype)
            else:
                self.out.append(ttype)
                self.zigzag(fid)
            if ttype not in (_TRUE, _FALSE):
                self.value(ttype, v)
            last = fid
        self.out.append(_STOP)


def thrift_bytes(fields) -> bytes:
    w = ThriftWriter()
    w.struct(fields)
    return bytes(w.out)


# -- the footer ---------------------------------------------------------------

class Leaf:
    """One flat column of a file: its name, physical type, repetition and
    the Spark type its annotations map it to (``spark`` is None with
    ``unsupported`` naming why, for a column the port cannot read)."""

    __slots__ = ("name", "physical", "type_length", "optional", "spark",
                 "ts_scale", "ts_nanos", "unsupported", "max_def",
                 "max_rep")

    def __init__(self, el: Dict[int, object]):
        self.name = el[4].decode("utf-8")
        self.physical = el.get(1)
        self.type_length = el.get(2, 0)
        self.optional = el.get(3, REQUIRED) == OPTIONAL
        #: the leaf's level maxima (a nested leaf's set by its column)
        self.max_def = 1 if self.optional else 0
        self.max_rep = 0
        self.ts_scale = 1
        self.ts_nanos = False
        self.unsupported = None
        try:
            self.spark = _spark_type(el, self)
        except NotImplementedError as e:
            self.spark, self.unsupported = None, str(e)

    def require(self) -> T.DataType:
        if self.spark is None:
            raise NotImplementedError(self.unsupported)
        return self.spark


def _spark_type(el: Dict[int, object], leaf: Leaf) -> T.DataType:
    """The Spark type of one leaf, as pyarrow's type maps through
    ``arrow_type_to_spark``."""
    name, phys = leaf.name, leaf.physical
    ct = el.get(6)
    lt = el.get(10) or {}
    if phys == INT96:
        # Julian day and nanos of day, decoded to micros in _plain
        return T.TIMESTAMP
    if 5 in lt or ct == CT_DECIMAL:
        dec = lt.get(5) or {}
        precision = dec.get(2, el.get(8))
        scale = dec.get(1, el.get(7, 0))
        if phys not in (INT32, INT64, FLBA, BYTE_ARRAY) or not precision:
            raise NotImplementedError(
                f"Parquet DECIMAL on {PHYSICAL_NAMES[phys]} (column "
                f"{name!r})")
        return T.DecimalType(int(precision), int(scale))
    if 8 in lt or ct in (CT_TIMESTAMP_MILLIS, CT_TIMESTAMP_MICROS):
        unit = (lt.get(8) or {}).get(2) or {}
        leaf.ts_nanos = 3 in unit
        millis = 1 in unit or (not unit and ct == CT_TIMESTAMP_MILLIS)
        leaf.ts_scale = 1000 if millis else 1
        if phys != INT64:
            raise NotImplementedError(f"TIMESTAMP on {PHYSICAL_NAMES[phys]}")
        return T.TIMESTAMP
    if 6 in lt or ct == CT_DATE:
        return T.DATE
    if 10 in lt or ct in CT_UINT or ct in (CT_INT_8, CT_INT_16, CT_INT_32,
                                           CT_INT_64):
        it = lt.get(10) or {}
        signed = it.get(2, ct not in CT_UINT)
        width = it.get(1) or {CT_INT_8: 8, CT_INT_16: 16, CT_INT_32: 32,
                              CT_INT_64: 64}.get(ct, 0)
        if not signed:
            raise NotImplementedError(
                f"Parquet unsigned Int({width}) (column {name!r}) is not "
                "supported")
        return {8: T.BYTE, 16: T.SHORT, 32: T.INT, 64: T.LONG}[width]
    if any(k in lt for k in (7, 11, 14, 15)):
        raise NotImplementedError(
            f"Parquet logical type {sorted(lt)} (column {name!r}) is not "
            "supported by the port's Parquet reader")
    if phys == BYTE_ARRAY:
        if 1 in lt or 4 in lt or 12 in lt or ct in (CT_UTF8, CT_ENUM,
                                                    CT_JSON):
            return T.STRING
        raise NotImplementedError(
            f"Parquet BYTE_ARRAY without a string annotation (binary "
            f"column {name!r}) is not supported")
    if phys == FLBA:
        raise NotImplementedError(
            f"Parquet FIXED_LEN_BYTE_ARRAY without DECIMAL (column "
            f"{name!r}) is not supported")
    return {BOOLEAN: T.BOOLEAN, INT32: T.INT, INT64: T.LONG,
            FLOAT: T.FLOAT, DOUBLE: T.DOUBLE}[phys]


class ChunkMeta:
    """One column chunk's metadata: where its pages are, how they are
    compressed, and its statistics."""

    __slots__ = ("codec", "num_values", "start", "length", "null_count",
                 "min_raw", "max_raw")

    def __init__(self, cc: Dict[int, object]):
        md = cc.get(3)
        if md is None:
            raise NotImplementedError(
                "a Parquet column chunk in another file (file_path) is not "
                "supported")
        self.codec = md[4]
        self.num_values = md[5]
        data_off = md[9]
        dict_off = md.get(11)
        self.start = (dict_off if dict_off is not None and 0 < dict_off
                      < data_off else data_off)
        self.length = md[7]
        st = md.get(12) or {}
        self.null_count = st.get(3)
        self.min_raw, self.max_raw = st.get(6), st.get(5)
        if self.min_raw is None and md[1] not in (BYTE_ARRAY, FLBA):
            # the deprecated min/max: their byte arrays compared signed,
            # so only numeric ones are trusted
            self.min_raw, self.max_raw = st.get(2), st.get(1)


class RowGroupMeta:
    """One row group: its row count and its chunks by leaf path (a flat
    column's path is its name; a nested leaf's is dotted,
    ``a.list.element``)."""

    __slots__ = ("num_rows", "chunks")

    def __init__(self, rg: Dict[int, object], paths: Sequence[str]):
        self.num_rows = rg[3]
        self.chunks = {}
        for i, cc in enumerate(rg[1]):
            md = cc.get(3) or {}
            got = md.get(3)
            key = (".".join(p.decode("utf-8") for p in got) if got
                   else paths[i])
            self.chunks[key] = ChunkMeta(cc)


class _Node:
    """A schema element with its children (the footer's flat list as a
    tree)."""

    __slots__ = ("el", "name", "rep", "children")

    def __init__(self, el):
        self.el = el
        self.name = el[4].decode("utf-8")
        self.rep = el.get(3, REQUIRED)
        self.children: List["_Node"] = []


def _schema_tree(schema) -> List[_Node]:
    """The root's children, each with its subtree."""
    pos = 1

    def take(k):
        nonlocal pos
        out = []
        for _ in range(k):
            if pos >= len(schema):
                raise ColumnarProcessingError("truncated Parquet schema")
            node = _Node(schema[pos])
            pos += 1
            node.children = take(node.el.get(5) or 0)
            out.append(node)
        return out

    return take(schema[0].get(5, len(schema) - 1))


#: a column nested deeper than these shapes has no device layout
_LIST_GROUP_NAMES = ("array",)


class NestedColumn:
    """One top-level nested column of a file: its Spark type and its
    leaves, each with its dotted path and level thresholds.

    ``kind`` is "array", "map" or "struct". ``d_row``: the definition
    level from which a row is non-null; ``d_rep``: the repeated node's
    (an element slot exists from it on; arrays and maps); each leaf's
    ``max_def`` marks a non-null value."""

    __slots__ = ("name", "kind", "spark", "optional", "d_row", "d_rep",
                 "leaves", "unsupported", "physical")

    def __init__(self, name, kind, spark, optional, d_row, d_rep, leaves,
                 unsupported=None):
        self.name = name
        self.kind = kind
        self.spark = spark
        self.optional = optional
        self.d_row = d_row
        self.d_rep = d_rep
        self.leaves = leaves
        self.unsupported = unsupported
        self.physical = None

    def require(self) -> T.DataType:
        if self.unsupported is not None:
            raise NotImplementedError(self.unsupported)
        return self.spark


def _levels_leaf(node: _Node, path: List[str], d: int, r: int) -> tuple:
    """(dotted path, Leaf) of a primitive node at definition level ``d``
    and repetition level ``r`` above it."""
    leaf = Leaf(node.el)
    leaf.max_def = d + (node.rep != REQUIRED)
    leaf.max_rep = r + (node.rep == REPEATED)
    return ".".join(path + [node.name]), leaf


def _nested_column(node: _Node, path: str) -> NestedColumn:
    """The NestedColumn of a top-level group or repeated field."""
    el = node.el
    ct, lt = el.get(6), el.get(10) or {}
    name = node.name
    top_opt = node.rep == OPTIONAL
    d0 = int(top_opt)

    def unsupported(kind, why):
        return NestedColumn(
            name, kind, None, top_opt, d0, 0, [],
            f"Parquet column {name!r} in {path}: {why}: the reference "
            "reads no nested Parquet column (its Arrow conversion raises), "
            "and the port reads those of fixed-width leaves only (ROADMAP "
            "item [9-ext])")

    def fixed(leaf):
        return leaf.spark is not None and isinstance(
            leaf.spark, _FIXED_SPARK)

    if not node.children:
        # a bare repeated primitive: the legacy list of required elements
        p, leaf = _levels_leaf(node, [], 0, 0)
        if not fixed(leaf):
            return unsupported("array", f"a list of {leaf.spark or 'an '}"
                               "unsupported element")
        return NestedColumn(name, "array", T.ArrayType(leaf.spark), False,
                            0, 1, [(p, leaf)])
    if ct == 3 or 3 in lt:  # LIST
        if len(node.children) != 1 or node.children[0].rep != REPEATED:
            return unsupported("array", "a LIST without one repeated child")
        rnode = node.children[0]
        d_rep = d0 + 1
        if not rnode.children:
            elem, epath = rnode, [name]  # 2-level: the repeated element
            p, leaf = _levels_leaf(elem, epath, d0, 0)
        elif (len(rnode.children) == 1 and rnode.name not in
              _LIST_GROUP_NAMES and rnode.name != f"{name}_tuple"):
            elem = rnode.children[0]
            if elem.children:
                return unsupported("array", "a list of structs or of lists")
            p, leaf = _levels_leaf(elem, [name, rnode.name], d_rep, 1)
        else:
            return unsupported("array", "a list of structs")
        if not fixed(leaf):
            return unsupported("array", "a list of non-fixed-width "
                               "elements")
        return NestedColumn(name, "array", T.ArrayType(leaf.spark), top_opt,
                            d0, d_rep, [(p, leaf)])
    if ct in (1, 2) or 2 in lt:  # MAP
        kv = node.children[0] if len(node.children) == 1 else None
        if kv is None or kv.rep != REPEATED or len(kv.children) != 2 or \
                any(c.children for c in kv.children):
            return unsupported("map", "a MAP of nested keys or values")
        d_rep = d0 + 1
        kp, kleaf = _levels_leaf(kv.children[0], [name, kv.name], d_rep, 1)
        vp, vleaf = _levels_leaf(kv.children[1], [name, kv.name], d_rep, 1)
        if not (fixed(kleaf) and fixed(vleaf)):
            return unsupported("map", "a MAP of non-fixed-width keys or "
                               "values")
        return NestedColumn(name, "map", T.MapType(kleaf.spark, vleaf.spark),
                            top_opt, d0, d_rep, [(kp, kleaf), (vp, vleaf)])
    # a STRUCT group
    leaves = []
    for c in node.children:
        if c.children or c.rep == REPEATED:
            return unsupported("struct", "a STRUCT with a nested field")
        leaves.append(_levels_leaf(c, [name], d0, 0))
    if not all(fixed(lf) for _, lf in leaves):
        return unsupported("struct", "a STRUCT with non-fixed-width fields")
    st = T.StructType([T.StructField(lf.name, lf.spark) for _, lf in leaves])
    return NestedColumn(name, "struct", st, top_opt, d0, 0, leaves)


class FileMeta:
    """A file's footer: its top-level columns (a flat :class:`Leaf` or a
    :class:`NestedColumn`), row count and row groups."""

    def __init__(self, fm: Dict[int, object], path: str = "?"):
        schema = fm[2]
        self.num_rows = fm[3]
        self.leaves: List = []
        paths: List[str] = []
        for node in _schema_tree(schema):
            if node.children or node.rep == REPEATED:
                col = _nested_column(node, path)
                self.leaves.append(col)
                paths.extend(p for p, _ in col.leaves)
            else:
                self.leaves.append(Leaf(node.el))
                paths.append(node.name)
        self.row_groups = [RowGroupMeta(rg, paths) for rg in fm.get(4, [])]

    def leaf(self, name: str) -> Leaf:
        for lf in self.leaves:
            if lf.name == name:
                return lf
        raise ColumnarProcessingError(
            f"column {name!r} not in {[lf.name for lf in self.leaves]}")

    def schema(self) -> List[Tuple[str, T.DataType]]:
        return [(lf.name, lf.require()) for lf in self.leaves]


def read_footer(path: str) -> FileMeta:
    with open(path, "rb") as f:
        f.seek(0, 2)
        size = f.tell()
        if size < 12:
            raise ColumnarProcessingError(f"{path}: not a Parquet file")
        f.seek(size - 8)
        tail = f.read(8)
        if tail[4:] != MAGIC:
            raise ColumnarProcessingError(f"{path}: not a Parquet file")
        n = struct.unpack("<I", tail[:4])[0]
        f.seek(size - 8 - n)
        footer = f.read(n)
    return FileMeta(ThriftReader(footer).struct(), path)


# -- decoding -----------------------------------------------------------------

#: why the codecs the port's readers (Parquet's and ORC's) do not take
#: are not taken, by name
CODEC_REASONS = {
    "BROTLI": "its decoder needs RFC 7932's 122,784-byte static "
              "dictionary, which is not in the repository",
    "LZO": "pyarrow writes LZO for neither Parquet nor ORC, so nothing the "
           "port can test against writes it"}


def unsupported_codec(fmt: str, names: Sequence[str], codec: int,
                      where: str) -> NotImplementedError:
    """The error for codec id ``codec`` (named by ``names``) that the
    port's ``fmt`` (Parquet or ORC) ``where`` (reader, writer) does not
    take, with the reason."""
    name = names[codec] if 0 <= codec < len(names) else str(codec)
    why = CODEC_REASONS.get(name, "an unknown codec id")
    return NotImplementedError(
        f"{fmt} codec {name} is not supported by the port's {fmt} "
        f"{where}: {why}")


def _lz4_hadoop(data, size: int):
    """Parquet's legacy LZ4 page as Arrow reads it: blocks each behind
    big-endian (decompressed, compressed) lengths, else one raw block."""
    mv = memoryview(data)
    parts, pos, total = [], 0, 0
    try:
        while len(mv) - pos >= 8:
            want, clen = struct.unpack_from(">II", mv, pos)
            pos += 8
            if clen > len(mv) - pos or total + want > size:
                raise ColumnarProcessingError("not Hadoop-framed")
            got = N.lz4_decompress(mv[pos:pos + clen], want)
            if len(got) != want:
                raise ColumnarProcessingError("not Hadoop-framed")
            parts.append(got)
            total += want
            pos += clen
        if pos != len(mv) or not parts:
            raise ColumnarProcessingError("not Hadoop-framed")
    except ColumnarProcessingError:
        return N.lz4_decompress(data, size)
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _decompress(codec: int, data, size: int):
    if codec == UNCOMPRESSED:
        return data
    if codec == SNAPPY:
        return N.snappy_decompress(data)
    if codec == GZIP:
        return zlib.decompress(bytes(data), 32 + zlib.MAX_WBITS)
    if codec == ZSTD:
        return N.zstd_decompress(data, size)
    if codec == LZ4_RAW:
        return N.lz4_decompress(data, size)
    if codec == LZ4:
        return _lz4_hadoop(data, size)
    raise unsupported_codec("Parquet", CODEC_NAMES, codec, "reader")


_ENCODINGS = (PLAIN, PLAIN_DICTIONARY, RLE_DICTIONARY, RLE, BIT_PACKED,
              DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY,
              BYTE_STREAM_SPLIT)


def _check_encoding(enc: int) -> None:
    if enc in _ENCODINGS:
        return
    raise NotImplementedError(
        f"Parquet encoding {ENCODING_NAMES.get(enc, enc)} is not supported "
        "by the port's Parquet reader")


_NP_PLAIN = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}


def _plain(buf, count: int, leaf: Leaf):
    """``count`` PLAIN values: a numpy array of the physical type, an
    (count, type_length) uint8 matrix for FIXED_LEN_BYTE_ARRAY, or
    (data, offsets) for BYTE_ARRAY."""
    phys = leaf.physical
    if phys == INT96:
        raw = np.frombuffer(buf, dtype=np.uint8, count=12 * count)
        raw = raw.reshape(count, 12)
        nanos = raw[:, :8].copy().view("<i8").reshape(-1)
        days = raw[:, 8:].copy().view("<i4").reshape(-1).astype(np.int64)
        return _nanos_to_micros(
            (days - JULIAN_UNIX_EPOCH) * 86_400_000_000_000 + nanos, leaf)
    if phys == BOOLEAN:
        bits = np.unpackbits(np.frombuffer(buf, dtype=np.uint8,
                                           count=(count + 7) // 8),
                             bitorder="little")
        return bits[:count].astype(np.bool_)
    if phys in _NP_PLAIN:
        return np.frombuffer(buf, dtype=_NP_PLAIN[phys], count=count)
    if phys == FLBA:
        tl = leaf.type_length
        return np.frombuffer(buf, dtype=np.uint8,
                             count=count * tl).reshape(count, tl)
    if phys == BYTE_ARRAY:
        data, offsets, _ = N.byte_array_unpack(buf, count)
        return data, offsets
    raise NotImplementedError(f"Parquet {PHYSICAL_NAMES[phys]} values")


def _nanos_to_micros(nanos: np.ndarray, leaf: Leaf) -> np.ndarray:
    """Nanosecond timestamps -> micros; a sub-microsecond remainder
    raises, as the reference's safe cast of pyarrow's nanoseconds does."""
    if len(nanos) and (nanos % 1000).any():
        raise ColumnarProcessingError(
            f"Parquet column {leaf.name!r}: a nanosecond timestamp would "
            "lose data as microseconds (the reference's safe cast raises)")
    return nanos // 1000


def _delta_values(buf, count: int, leaf: Leaf):
    """``count`` values of a DELTA_* page body, as _plain gives them."""
    phys = leaf.physical
    if phys in (INT32, INT64):
        vals, _ = N.delta_binary_decode(buf, count)
        return vals.astype(np.int32) if phys == INT32 else vals
    raise NotImplementedError(
        f"Parquet DELTA_BINARY_PACKED for {PHYSICAL_NAMES[phys]} values")


def _delta_lengths(buf, count: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """DELTA_LENGTH_BYTE_ARRAY: (data, offsets, bytes consumed)."""
    lens, used = N.delta_binary_decode(buf, count)
    offsets = np.zeros(count + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    body = np.frombuffer(buf, dtype=np.uint8)[used:]
    if (count and int(lens.min()) < 0) or offsets[-1] > len(body):
        raise ColumnarProcessingError("corrupt DELTA_LENGTH_BYTE_ARRAY data")
    return body[:offsets[-1]], offsets, used + int(offsets[-1])


def _byte_array_values(data: np.ndarray, offsets: np.ndarray, leaf: Leaf):
    """(data, offsets) as _plain gives a BYTE_ARRAY or FLBA leaf."""
    if leaf.physical == FLBA:
        tl = leaf.type_length
        if (np.diff(offsets) != tl).any():
            raise ColumnarProcessingError(
                f"FIXED_LEN_BYTE_ARRAY values of another length than {tl}")
        return data.reshape(-1, tl)
    return data, offsets


def _byte_stream_split(buf, count: int, leaf: Leaf):
    """BYTE_STREAM_SPLIT: byte k of every value in stream k."""
    phys = leaf.physical
    width = (leaf.type_length if phys == FLBA
             else np.dtype(_NP_PLAIN[phys]).itemsize if phys in _NP_PLAIN
             else None)
    if width is None:
        raise NotImplementedError(
            f"Parquet BYTE_STREAM_SPLIT for {PHYSICAL_NAMES[phys]} values")
    raw = np.frombuffer(buf, dtype=np.uint8, count=count * width)
    rows = np.ascontiguousarray(raw.reshape(width, count).T)
    if phys == FLBA:
        return rows
    return rows.view(_NP_PLAIN[phys]).reshape(-1)


def _level_values(buf, max_level: int, count: int, prefixed: bool
                  ) -> Tuple[np.ndarray, int]:
    """``count`` repetition or definition levels of a nested leaf (RLE,
    bit width of ``max_level``): (int32 levels, bytes used)."""
    bw = max(1, int(max_level).bit_length())
    if prefixed:
        n = struct.unpack_from("<I", buf, 0)[0]
        vals, _ = N.rle_decode(memoryview(buf)[4:4 + n], bw, count)
        return vals, 4 + n
    return N.rle_decode(buf, bw, count)


def _levels(buf, encoding: int, count: int, prefixed: bool
            ) -> Tuple[np.ndarray, int]:
    """Definition levels of a flat OPTIONAL column (max level 1): (bool
    mask of defined values, bytes used)."""
    if encoding == BIT_PACKED:
        nbytes = (count + 7) // 8
        bits = np.unpackbits(np.frombuffer(buf, dtype=np.uint8,
                                           count=nbytes), bitorder="big")
        return bits[:count].astype(np.bool_), nbytes
    if encoding != RLE:
        raise NotImplementedError(
            f"Parquet level encoding {ENCODING_NAMES.get(encoding)}")
    if prefixed:
        n = struct.unpack_from("<I", buf, 0)[0]
        vals, _ = N.rle_decode(memoryview(buf)[4:4 + n], 1, count)
        return vals.astype(np.bool_), 4 + n
    vals, used = N.rle_decode(buf, 1, count)
    return vals.astype(np.bool_), used


class _ChunkValues:
    """A chunk's non-null values as they decode, page by page: arrays of
    the physical type, or, for BYTE_ARRAY, codes into a table of values
    (the dictionary first, then each PLAIN page's values)."""

    def __init__(self, leaf: Leaf):
        self.leaf = leaf
        self.parts: List = []       # physical values or code arrays
        self.table: List = []       # BYTE_ARRAY (data, offsets) parts
        self.table_rows = 0
        self.dictionary = None      # decoded dictionary page
        self.dict_base = 0

    def set_dictionary(self, values) -> None:
        if self.leaf.physical == BYTE_ARRAY:
            data, offsets = values
            self.dict_base = self.table_rows
            self.table.append((data, offsets))
            self.table_rows += len(offsets) - 1
            self.dictionary = len(offsets) - 1
        else:
            self.dictionary = values

    def add_plain(self, values) -> None:
        if self.leaf.physical == BYTE_ARRAY:
            data, offsets = values
            k = len(offsets) - 1
            self.parts.append(np.arange(self.table_rows,
                                        self.table_rows + k, dtype=np.int64))
            self.table.append((data, offsets))
            self.table_rows += k
        else:
            self.parts.append(values)

    def add_indices(self, idx: np.ndarray) -> None:
        if self.dictionary is None:
            raise ColumnarProcessingError(
                "dictionary-encoded Parquet page without a dictionary page")
        if self.leaf.physical == BYTE_ARRAY:
            if len(idx) and int(idx.max()) >= self.dictionary:
                raise ColumnarProcessingError("Parquet dictionary index out "
                                              "of range")
            self.parts.append(idx.astype(np.int64) + self.dict_base)
        else:
            self.parts.append(self.dictionary[idx])


def _decode_chunk(raw, cm: ChunkMeta, leaf: Leaf, values: _ChunkValues,
                  levels: Optional[list] = None) -> np.ndarray:
    """Walk one column chunk's pages; non-null values go to ``values``.
    Returns the chunk's validity (one entry a level: a nested leaf's value
    slots). A nested leaf (``levels`` given) appends each page's
    (repetition levels, definition levels) to ``levels``."""
    pos, got = 0, 0
    valid_parts = []
    rdr = ThriftReader(raw)
    while got < cm.num_values:
        rdr.pos = pos
        ph = rdr.struct()
        pos = rdr.pos
        ptype, usize, csize = ph[1], ph[2], ph[3]
        page = memoryview(raw)[pos:pos + csize]
        if len(page) != csize:
            raise ColumnarProcessingError("truncated Parquet page")
        pos += csize
        if ptype == DICTIONARY_PAGE:
            dh = ph[7]
            _check_encoding(dh.get(2, PLAIN))
            data = _decompress(cm.codec, page, usize)
            values.set_dictionary(_plain(data, dh[1], leaf))
            continue
        if ptype == DATA_PAGE:
            dh = ph[5]
            n, enc = dh[1], dh[2]
            _check_encoding(enc)
            data = _decompress(cm.codec, page, usize)
            off = 0
            if levels is not None:
                rl = np.zeros(n, dtype=np.int32)
                dl = np.full(n, leaf.max_def, dtype=np.int32)
                if leaf.max_rep:
                    rl, used = _level_values(data, leaf.max_rep, n, True)
                    off += used
                if leaf.max_def:
                    dl, used = _level_values(memoryview(data)[off:],
                                             leaf.max_def, n, True)
                    off += used
                levels.append((rl, dl))
                valid = dl == leaf.max_def
            elif leaf.optional:
                valid, off = _levels(data, dh.get(3, RLE), n, True)
            else:
                valid = np.ones(n, dtype=np.bool_)
            vbuf = memoryview(data)[off:]
        elif ptype == DATA_PAGE_V2:
            dh = ph[8]
            n, enc = dh[1], dh[4]
            _check_encoding(enc)
            dl, rl = dh.get(5, 0), dh.get(6, 0)
            if levels is not None:
                rls = (_level_values(page[:rl], leaf.max_rep, n, False)[0]
                       if leaf.max_rep else np.zeros(n, dtype=np.int32))
                dls = (_level_values(page[rl:rl + dl], leaf.max_def, n,
                                     False)[0] if leaf.max_def
                       else np.zeros(n, dtype=np.int32))
                levels.append((rls, dls))
                valid = dls == leaf.max_def
            elif leaf.optional:
                valid, _ = _levels(page[rl:rl + dl], RLE, n, False)
            else:
                valid = np.ones(n, dtype=np.bool_)
            body = page[rl + dl:]
            vbuf = (_decompress(cm.codec, body, usize - rl - dl)
                    if dh.get(7, True) else body)
        else:
            continue  # an index page
        k = int(valid.sum())
        if enc == PLAIN:
            values.add_plain(_plain(vbuf, k, leaf))
        elif enc in (PLAIN_DICTIONARY, RLE_DICTIONARY):
            bw = vbuf[0] if len(vbuf) else 0
            idx, _ = N.rle_decode(memoryview(vbuf)[1:], bw, k)
            values.add_indices(idx)
        elif enc == RLE and leaf.physical == BOOLEAN:
            n_bytes = struct.unpack_from("<I", vbuf, 0)[0]
            bits, _ = N.rle_decode(memoryview(vbuf)[4:4 + n_bytes], 1, k)
            values.add_plain(bits.astype(np.bool_))
        elif enc == DELTA_BINARY_PACKED:
            values.add_plain(_delta_values(vbuf, k, leaf))
        elif enc == DELTA_LENGTH_BYTE_ARRAY and leaf.physical == BYTE_ARRAY:
            data, offsets, _ = _delta_lengths(vbuf, k)
            values.add_plain((data, offsets))
        elif enc == DELTA_BYTE_ARRAY and leaf.physical in (BYTE_ARRAY, FLBA):
            prefix, used = N.delta_binary_decode(vbuf, k)
            sdata, soffs, _ = _delta_lengths(memoryview(vbuf)[used:], k)
            data, offsets = N.delta_byte_array(prefix, sdata, soffs)
            values.add_plain(_byte_array_values(data, offsets, leaf))
        elif enc == BYTE_STREAM_SPLIT:
            values.add_plain(_byte_stream_split(vbuf, k, leaf))
        else:
            raise NotImplementedError(
                f"Parquet encoding {ENCODING_NAMES.get(enc, enc)} for "
                f"{PHYSICAL_NAMES[leaf.physical]} values")
        valid_parts.append(valid)
        got += n
    return (np.concatenate(valid_parts) if valid_parts
            else np.zeros(0, dtype=np.bool_))


def _be_matrix_to_unscaled(mat: np.ndarray, precision: int) -> np.ndarray:
    """Big-endian two's complement rows (n, k <= 16 bytes) -> int64
    unscaled values (precision <= 18) or Python ints (above)."""
    n, k = mat.shape
    if k > 16:
        raise NotImplementedError(f"Parquet DECIMAL of {k} bytes")
    full = np.empty((n, 16), dtype=np.uint8)
    if k:
        neg = mat[:, 0] >= 0x80
        full[:, :16 - k] = np.where(neg, 0xFF, 0)[:, None]
        full[:, 16 - k:] = mat
    else:
        full[:] = 0
    hi = full[:, :8].copy().view(">i8").reshape(-1).astype(np.int64)
    lo = full[:, 8:].copy().view(">u8").reshape(-1).astype(np.uint64)
    if precision <= T.DecimalType.MAX_LONG_DIGITS:
        return lo.view(np.int64)
    out = np.empty(n, dtype=object)
    out[:] = (hi.astype(object) << 64) + lo.astype(object)
    return out


def _byte_array_decimals(data: np.ndarray, offsets: np.ndarray,
                         precision: int) -> np.ndarray:
    lens = np.diff(offsets)
    n = len(lens)
    if n and int(lens.max()) > 16:
        raise NotImplementedError("Parquet DECIMAL of more than 16 bytes")
    cols = np.arange(16)
    start = (16 - lens)[:, None]
    idx = offsets[:-1, None] + cols[None, :] - start
    inside = cols[None, :] >= start
    mat = np.zeros((n, 16), dtype=np.uint8)
    if len(data):
        mat = np.where(inside, data[np.clip(idx, 0, len(data) - 1)], 0)
    first = np.where(lens > 0, mat[np.arange(n), np.minimum(16 - lens, 15)],
                     0)
    mat = np.where(~inside & (first >= 0x80)[:, None], 0xFF, mat)
    return _be_matrix_to_unscaled(mat.astype(np.uint8), precision)


def _to_spark(phys_vals, leaf: Leaf) -> np.ndarray:
    """Non-null physical values -> the Spark host representation."""
    dt = leaf.spark
    if isinstance(dt, T.DecimalType):
        if leaf.physical == FLBA:
            return _be_matrix_to_unscaled(phys_vals, dt.precision)
        if leaf.physical == BYTE_ARRAY:
            return _byte_array_decimals(*phys_vals, dt.precision)
        vals = phys_vals.astype(np.int64)
        if T.is_dec128(dt):
            out = np.empty(len(vals), dtype=object)
            out[:] = vals.astype(object)
            return out
        return vals
    if isinstance(dt, T.TimestampType):
        if leaf.ts_nanos:
            return _nanos_to_micros(phys_vals.astype(np.int64), leaf)
        return phys_vals.astype(np.int64) * leaf.ts_scale
    return phys_vals.astype(dt.np_dtype, copy=False)


#: Spark types of the leaves a nested layout holds (columnar/nested.py)
_FIXED_SPARK = (T.BooleanType, T.ByteType, T.ShortType, T.IntegerType,
                T.LongType, T.FloatType, T.DoubleType, T.DateType,
                T.TimestampType)


def _fill(dt: T.DataType, n: int, valid: np.ndarray, vals) -> np.ndarray:
    """Scatter the non-null ``vals`` into an n-row array (nulls 0)."""
    if T.is_dec128(dt):
        out = np.empty(n, dtype=object)
        out[:] = 0
    else:
        out = np.zeros(n, dtype=dt.np_dtype)
    if len(vals) == n:
        out[:] = vals
    else:
        out[valid] = vals
    return out


def decode_column(raws: Sequence, metas: Sequence[ChunkMeta], leaf: Leaf,
                  levels: Optional[list] = None) -> HostColumn:
    """One column from its chunks (one per row group read, in order); for
    a nested leaf (``levels`` given) its value slots, one a level, with
    the levels appended to ``levels``."""
    dt = leaf.require()
    valid_parts, table_parts, code_parts, phys_parts = [], [], [], []
    base = 0
    for raw, cm in zip(raws, metas):
        vals = _ChunkValues(leaf)
        valid_parts.append(_decode_chunk(raw, cm, leaf, vals, levels))
        if leaf.physical == BYTE_ARRAY:
            code_parts.extend(p + base for p in vals.parts)
            table_parts.extend(vals.table)
            base += vals.table_rows
        else:
            phys_parts.extend(vals.parts)
    valid = (np.concatenate(valid_parts) if valid_parts
             else np.zeros(0, dtype=np.bool_))
    n = len(valid)
    if leaf.physical == BYTE_ARRAY:
        data, offsets = _joined_table(table_parts)
        codes = (np.concatenate(code_parts) if code_parts
                 else np.zeros(0, dtype=np.int64))
        if isinstance(dt, T.StringType):
            return _string_column(valid, N.strings_from(data, offsets),
                                  codes)
        vals = _to_spark((data, offsets), leaf)[codes]
    elif phys_parts:
        vals = _to_spark(np.concatenate(phys_parts), leaf)
    else:
        vals = []
    return HostColumn(dt, _fill(dt, n, valid, vals), valid)


def _joined_table(table_parts) -> Tuple[np.ndarray, np.ndarray]:
    """The BYTE_ARRAY value table of every chunk as one (data, offsets)."""
    if not table_parts:
        return np.zeros(0, dtype=np.uint8), np.zeros(1, dtype=np.int64)
    offs, shift = [np.zeros(1, dtype=np.int64)], 0
    for d, o in table_parts:
        offs.append(o[1:] + shift)
        shift += len(d)
    return (np.concatenate([d for d, _ in table_parts]),
            np.concatenate(offs))


def _string_column(valid: np.ndarray, table: np.ndarray,
                   codes_of_valid: np.ndarray) -> HostColumn:
    """A string column from its value table (str objects) and the valid
    rows' codes into it: the values are ``dictionary[codes]`` over one
    sorted dictionary, with ``encoded()`` seeded; the dictionary holds
    the values the rows use, and "" where a row is null, as
    ``encode_sorted_dict`` of the rows (nulls read as "") gives."""
    from spark_rapids_tpu_torch.columnar.column import encode_sorted_dict
    n = len(valid)
    tcodes, tdict = encode_sorted_dict(table)
    all_valid = bool(valid.all())
    if all_valid:
        codes = tcodes[codes_of_valid].astype(np.int64)
    else:
        codes = np.zeros(n, dtype=np.int64)
        codes[valid] = tcodes[codes_of_valid] if len(table) else 0
    if not all_valid:
        if not (len(tdict) and tdict[0] == ""):
            # "" sorts first: it becomes code 0
            tdict = np.concatenate([np.array([""], dtype=object), tdict])
            codes[valid] += 1
        codes[~valid] = 0
    used = np.bincount(codes, minlength=len(tdict)) > 0 if n else \
        np.zeros(len(tdict), dtype=bool)
    if not used.all():
        remap = np.cumsum(used) - 1
        tdict = tdict[used]
        codes = remap[codes]
    codes = codes.astype(np.int32)
    data = tdict[codes] if len(tdict) else np.empty(n, dtype=object)
    if not all_valid:
        data[~valid] = None
    col = HostColumn(T.STRING, data, valid)
    col._cache["encode"] = (codes, tdict)
    return col


def list_layout(rep: np.ndarray, deff: np.ndarray, d_row: int, d_rep: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A repeated leaf's rows from its levels: (row validity, int32
    offsets, the definition level of each element slot). A level with
    repetition 0 starts a row; its definition tells a null row (below
    ``d_row``) from an empty one (below ``d_rep``) from one with
    elements; every level at ``d_rep`` or above is an element slot, and
    its definition tells a null element (or, in a list of structs, a null
    struct) from a value."""
    starts = rep == 0
    row_of = np.cumsum(starts) - 1
    nrows = int(starts.sum())
    row_valid = deff[starts] >= d_row
    slot = deff >= d_rep
    lengths = np.bincount(row_of[slot], minlength=nrows)
    offsets = np.zeros(nrows + 1, dtype=np.int32)
    offsets[1:] = np.cumsum(lengths)
    return row_valid, offsets, deff[slot]


def _decode_nested(path: str, col: NestedColumn, rgs) -> HostColumn:
    """A nested column from its leaves' chunks: offsets and validity at
    each level rebuilt from the levels, the leaves' values placed at
    their non-null slots."""
    from spark_rapids_tpu_torch.columnar import nested as CN
    parts = []
    with open(path, "rb") as f:
        for p, leaf in col.leaves:
            raws = []
            for rg in rgs:
                cm = rg.chunks[p]
                f.seek(cm.start)
                raw = f.read(cm.length)
                if len(raw) != cm.length:
                    raise ColumnarProcessingError(
                        f"{path}: truncated column chunk {p!r}")
                raws.append(raw)
            levels: list = []
            slots = decode_column(raws, [rg.chunks[p] for rg in rgs], leaf,
                                  levels)
            rl = (np.concatenate([x for x, _ in levels]) if levels
                  else np.zeros(0, np.int32))
            dl = (np.concatenate([y for _, y in levels]) if levels
                  else np.zeros(0, np.int32))
            parts.append((leaf, slots, rl, dl))
    if col.kind == "struct":
        fields = [(slots.data, slots.validity) for _, slots, _, _ in parts]
        row_valid = parts[0][3] >= col.d_row
        return HostColumn(col.spark, CN.StructData(fields), row_valid)
    streams = []
    row_valid = offsets = None
    for leaf, slots, rl, dl in parts:
        row_valid, offsets, _ = list_layout(rl, dl, col.d_row, col.d_rep)
        slot = dl >= col.d_rep
        streams.append((np.ascontiguousarray(slots.data[slot]),
                        np.ascontiguousarray(slots.validity[slot])))
    if col.kind == "array":
        return HostColumn(col.spark, CN.ArrayData(offsets, *streams[0]),
                          row_valid)
    (kd, kv), (vd, vv) = streams
    return HostColumn(col.spark, CN.MapData(offsets, kd, kv, vd, vv),
                      row_valid)


def read_columns(path: str, meta: FileMeta, names: Sequence[str],
                 row_groups: Optional[Sequence[int]] = None) -> HostTable:
    """Decode ``names`` of ``path``'s row groups (all, or the listed
    ones) into one HostTable."""
    rgs = (meta.row_groups if row_groups is None
           else [meta.row_groups[i] for i in row_groups])
    leaves = [meta.leaf(nm) for nm in names]
    for lf in leaves:
        lf.require()
    raws: Dict[str, list] = {nm: [] for nm, lf in zip(names, leaves)
                             if isinstance(lf, Leaf)}
    with open(path, "rb") as f:
        for rg in rgs:
            for nm in raws:
                cm = rg.chunks[nm]
                f.seek(cm.start)
                raw = f.read(cm.length)
                if len(raw) != cm.length:
                    raise ColumnarProcessingError(
                        f"{path}: truncated column chunk {nm!r}")
                raws[nm].append(raw)
    cols = [decode_column(raws[nm], [rg.chunks[nm] for rg in rgs], lf)
            if isinstance(lf, Leaf) else _decode_nested(path, lf, rgs)
            for nm, lf in zip(names, leaves)]
    return HostTable(list(names), cols)


def read_table(path: str, columns: Optional[Sequence[str]] = None
               ) -> HostTable:
    """Every row of ``path`` (``columns``, or all of them)."""
    meta = read_footer(path)
    names = list(columns) if columns is not None else \
        [lf.name for lf in meta.leaves]
    return read_columns(path, meta, names)


def stat_value(raw: Optional[bytes], leaf: Leaf):
    """A chunk statistic decoded into the Spark host domain (days, micros,
    unscaled decimals, str), or None."""
    if raw is None or leaf.spark is None:
        return None
    phys, dt = leaf.physical, leaf.spark
    try:
        if phys == BOOLEAN:
            return bool(raw[0])
        if phys in _NP_PLAIN:
            v = np.frombuffer(raw, dtype=_NP_PLAIN[phys], count=1)[0].item()
            if isinstance(dt, T.TimestampType):
                return v // 1000 if leaf.ts_nanos else v * leaf.ts_scale
            return v
        if isinstance(dt, T.DecimalType):
            return int.from_bytes(raw, "big", signed=True) if raw else 0
        if isinstance(dt, T.StringType):
            return raw.decode("utf-8")
    except (ValueError, IndexError, UnicodeDecodeError):
        return None
    return None


# -- writing ------------------------------------------------------------------

def decimal_bytes(precision: int) -> int:
    """Bytes of the shortest FIXED_LEN_BYTE_ARRAY holding ``precision``
    digits (pyarrow's choice: 7 for 15 digits, 13 for 30, 16 for 38)."""
    k = 1
    while 2 ** (8 * k - 1) <= 10 ** precision - 1:
        k += 1
    return k


def _schema_element(name: str, dt: T.DataType):
    """[(field id, type, value)] of one OPTIONAL leaf, annotated as pyarrow
    annotates the reference's Arrow types."""
    phys, tl, ct, lt = None, None, None, None
    if isinstance(dt, T.BooleanType):
        phys = BOOLEAN
    elif isinstance(dt, (T.ByteType, T.ShortType)):
        width = 8 if isinstance(dt, T.ByteType) else 16
        phys, ct = INT32, CT_INT_8 if width == 8 else CT_INT_16
        lt = [(10, _STRUCT, [(1, _I8, width), (2, _TRUE, True)])]
    elif isinstance(dt, T.IntegerType):
        phys = INT32
    elif isinstance(dt, T.LongType):
        phys = INT64
    elif isinstance(dt, T.FloatType):
        phys = FLOAT
    elif isinstance(dt, T.DoubleType):
        phys = DOUBLE
    elif isinstance(dt, T.StringType):
        phys, ct, lt = BYTE_ARRAY, CT_UTF8, [(1, _STRUCT, [])]
    elif isinstance(dt, T.DateType):
        phys, ct, lt = INT32, CT_DATE, [(6, _STRUCT, [])]
    elif isinstance(dt, T.TimestampType):
        phys, ct = INT64, CT_TIMESTAMP_MICROS
        lt = [(8, _STRUCT, [(1, _TRUE, True),
                            (2, _STRUCT, [(2, _STRUCT, [])])])]
    elif isinstance(dt, T.DecimalType):
        phys, tl, ct = FLBA, decimal_bytes(dt.precision), CT_DECIMAL
        lt = [(5, _STRUCT, [(1, _I32, dt.scale), (2, _I32, dt.precision)])]
    else:
        raise NotImplementedError(f"writing {dt} to Parquet")
    fields = [(1, _I32, phys), (2, _I32, tl), (3, _I32, OPTIONAL),
              (4, _BINARY, name), (6, _I32, ct)]
    if isinstance(dt, T.DecimalType):
        fields += [(7, _I32, dt.scale), (8, _I32, dt.precision)]
    if lt is not None:
        fields.append((10, _STRUCT, lt))
    return phys, fields


def _compress(codec: int, data: bytes) -> bytes:
    if codec == UNCOMPRESSED:
        return data
    if codec == SNAPPY:
        return N.snappy_compress(data)
    if codec == ZSTD:
        return N.zstd_compress(data)
    if codec == LZ4_RAW:
        return N.lz4_compress(data)
    c = zlib.compressobj(6, zlib.DEFLATED, 16 + zlib.MAX_WBITS)
    return c.compress(data) + c.flush()


def _unscaled_be(vals: np.ndarray, k: int, dec128: bool) -> np.ndarray:
    """Unscaled decimals -> (n, k) big-endian two's complement bytes."""
    n = len(vals)
    if dec128:
        obj = np.asarray(vals, dtype=object)
        hi = (obj >> 64).astype(np.int64) if n else np.zeros(0, np.int64)
        lo = (obj & ((1 << 64) - 1)).astype(np.uint64) if n else \
            np.zeros(0, np.uint64)
    else:
        v = np.asarray(vals, dtype=np.int64)
        hi = np.where(v < 0, -1, 0).astype(np.int64)
        lo = v.view(np.uint64)
    full = np.empty((n, 16), dtype=np.uint8)
    full[:, :8] = hi.astype(">i8").view(np.uint8).reshape(n, 8)
    full[:, 8:] = lo.astype(">u8").view(np.uint8).reshape(n, 8)
    return np.ascontiguousarray(full[:, 16 - k:])


class _Encoded:
    """One column's values in a row group, encoded once: the PLAIN bytes
    of each non-null value (fixed width, or offsets into a buffer), or,
    for strings, dictionary codes; plus its statistics."""

    def __init__(self, col: HostColumn, phys: int, tl: Optional[int]):
        dt = col.dtype
        self.phys = phys
        self.valid = np.asarray(col.validity, dtype=np.bool_)
        vals = col.data[self.valid]
        self.dictionary = None
        self.min = self.max = None
        if isinstance(dt, T.StringType):
            codes, dictionary = col.encoded()
            codes = codes[self.valid]
            if len(codes):
                used, self.codes = np.unique(codes, return_inverse=True)
                self.codes = self.codes.astype(np.int32).reshape(-1)
                self.dictionary = dictionary[used]
                self.min = self.dictionary[0].encode("utf-8")
                self.max = self.dictionary[-1].encode("utf-8")
            return
        if isinstance(dt, T.DecimalType):
            if len(vals):
                lo_v, hi_v = min(vals), max(vals)
                self.min = int(lo_v).to_bytes(tl, "big", signed=True)
                self.max = int(hi_v).to_bytes(tl, "big", signed=True)
            self.fixed = _unscaled_be(vals, tl, T.is_dec128(dt))
            return
        if phys == BOOLEAN:
            self.fixed = vals.astype(np.bool_)
            if len(vals):
                self.min = bytes([int(vals.min())])
                self.max = bytes([int(vals.max())])
            return
        np_t = _NP_PLAIN[phys]
        self.fixed = np.ascontiguousarray(vals.astype(np_t))
        stat_vals = self.fixed
        if phys in (FLOAT, DOUBLE):
            stat_vals = stat_vals[~np.isnan(stat_vals)]
        if len(stat_vals):
            lo, hi = stat_vals.min(), stat_vals.max()
            if phys in (FLOAT, DOUBLE):
                # Parquet's rule for signed zeros: min -0.0, max +0.0
                lo = -abs(lo) if lo == 0 else lo
                hi = abs(hi) if hi == 0 else hi
            self.min = np.array([lo], dtype=np_t).tobytes()
            self.max = np.array([hi], dtype=np_t).tobytes()

    def plain_values(self, lo: int, hi: int) -> bytes:
        """PLAIN bytes of the non-null values among rows [lo, hi)."""
        a = int(np.count_nonzero(self.valid[:lo]))
        b = a + int(np.count_nonzero(self.valid[lo:hi]))
        part = self.fixed[a:b]
        if self.phys == BOOLEAN:
            return np.packbits(part, bitorder="little").tobytes()
        return part.tobytes()


def _write_chunk(f, name: str, col: HostColumn, phys: int,
                 tl: Optional[int], codec: int, page_bytes: int):
    """Write one column chunk at f's position; returns its ColumnChunk
    fields and its uncompressed and compressed sizes."""
    enc = _Encoded(col, phys, tl)
    n = len(col)
    start = f.tell()
    usize_total = csize_total = 0
    dict_offset = None
    if enc.dictionary is not None:
        parts = [s.encode("utf-8") for s in enc.dictionary]
        lens = np.fromiter((len(p) for p in parts), dtype=np.int64,
                           count=len(parts))
        offsets = np.zeros(len(parts) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        body = N.byte_array_pack(
            np.frombuffer(b"".join(parts), dtype=np.uint8), offsets)
        comp = _compress(codec, body)
        head = thrift_bytes([
            (1, _I32, DICTIONARY_PAGE), (2, _I32, len(body)),
            (3, _I32, len(comp)),
            (7, _STRUCT, [(1, _I32, len(parts)), (2, _I32, PLAIN)])])
        dict_offset = start
        f.write(head)
        f.write(comp)
        usize_total += len(head) + len(body)
        csize_total += len(head) + len(comp)
        bit_width = max(1, (len(parts) - 1).bit_length())
        value_encoding = RLE_DICTIONARY
        row_bytes = max(1, (bit_width + 7) // 8)
    else:
        value_encoding = PLAIN
        if phys in (BOOLEAN, BYTE_ARRAY):
            row_bytes = 1
        elif phys == FLBA:
            row_bytes = tl
        else:
            row_bytes = np.dtype(_NP_PLAIN[phys]).itemsize
    data_offset = f.tell()
    rows_per_page = max(1, page_bytes // row_bytes)
    codes_at = 0
    lo = 0
    while lo < n or lo == 0:
        hi = min(n, lo + rows_per_page)
        valid = enc.valid[lo:hi]
        levels = N.rle_encode(valid.astype(np.int32), 1)
        body = bytearray(struct.pack("<I", len(levels)))
        body += levels
        if value_encoding == RLE_DICTIONARY:
            k = int(np.count_nonzero(valid))
            body.append(bit_width)
            body += N.rle_encode(enc.codes[codes_at:codes_at + k], bit_width)
            codes_at += k
        elif enc.dictionary is None and isinstance(col.dtype, T.StringType):
            pass  # every row null: no values
        else:
            body += enc.plain_values(lo, hi)
        body = bytes(body)
        comp = _compress(codec, body)
        head = thrift_bytes([
            (1, _I32, DATA_PAGE), (2, _I32, len(body)), (3, _I32, len(comp)),
            (5, _STRUCT, [(1, _I32, hi - lo), (2, _I32, value_encoding),
                          (3, _I32, RLE), (4, _I32, RLE)])])
        f.write(head)
        f.write(comp)
        usize_total += len(head) + len(body)
        csize_total += len(head) + len(comp)
        lo = hi
        if n == 0:
            break
    stats = [(3, _I64, int(n - np.count_nonzero(enc.valid))),
             (5, _BINARY, enc.max), (6, _BINARY, enc.min)]
    encodings = [value_encoding, RLE] + ([PLAIN] if dict_offset is not None
                                         else [])
    meta = [(1, _I32, phys), (2, _LIST, (_I32, encodings)),
            (3, _LIST, (_BINARY, [name])), (4, _I32, codec),
            (5, _I64, n), (6, _I64, usize_total), (7, _I64, csize_total),
            (9, _I64, data_offset), (11, _I64, dict_offset),
            (12, _STRUCT, stats)]
    return [(2, _I64, start), (3, _STRUCT, meta)], usize_total, csize_total


def _set_repetition(fields, repetition: int):
    return [(fid, ft, repetition if fid == 3 else v) for fid, ft, v in fields]


def _nested_schema(name: str, dt) -> Tuple[list, list]:
    """(schema elements, leaves) of one nested column as pyarrow writes
    it: the 3-level LIST, the MAP's ``key_value`` group, a STRUCT group.
    A leaf is (path, Spark type, physical type, max repetition, max
    definition)."""
    from spark_rapids_tpu_torch.columnar.nested import layout_supported
    if not layout_supported(dt):
        raise NotImplementedError(
            f"writing Parquet column {name!r} of type {dt.simple_string()}: "
            "the port writes nested columns of fixed-width leaves only "
            "(ROADMAP item [9-ext])")
    if isinstance(dt, T.ArrayType):
        phys, el = _schema_element("element", dt.element_type)
        groups = [[(3, _I32, OPTIONAL), (4, _BINARY, name), (5, _I32, 1),
                   (6, _I32, 3), (10, _STRUCT, [(3, _STRUCT, [])])],
                  [(3, _I32, REPEATED), (4, _BINARY, "list"), (5, _I32, 1)],
                  el]
        return groups, [([name, "list", "element"], dt.element_type, phys,
                         1, 3)]
    if isinstance(dt, T.MapType):
        kphys, kel = _schema_element("key", dt.key_type)
        vphys, vel = _schema_element("value", dt.value_type)
        groups = [[(3, _I32, OPTIONAL), (4, _BINARY, name), (5, _I32, 1),
                   (6, _I32, 1), (10, _STRUCT, [(2, _STRUCT, [])])],
                  [(3, _I32, REPEATED), (4, _BINARY, "key_value"),
                   (5, _I32, 2)],
                  _set_repetition(kel, REQUIRED), vel]
        return groups, [([name, "key_value", "key"], dt.key_type, kphys,
                         1, 2),
                        ([name, "key_value", "value"], dt.value_type, vphys,
                         1, 3)]
    groups = [[(3, _I32, OPTIONAL), (4, _BINARY, name),
               (5, _I32, len(dt.fields))]]
    leaves = []
    for f in dt.fields:
        phys, el = _schema_element(f.name, f.data_type)
        groups.append(el)
        leaves.append(([name, f.name], f.data_type, phys, 0, 2))
    return groups, leaves


def _nested_levels(col: HostColumn) -> list:
    """Per leaf of a nested host column, (repetition levels, definition
    levels, slot data, slot validity), one entry a level, in the order
    ``_nested_schema`` lists the leaves."""
    from spark_rapids_tpu_torch.columnar import nested as CN
    data = col.data
    row_ok = np.asarray(col.validity, dtype=bool)
    if isinstance(data, CN.StructData):
        out = []
        for d, v in data.fields:
            v = np.asarray(v, dtype=bool) & row_ok
            deff = np.where(row_ok, np.where(v, 2, 1), 0).astype(np.int32)
            out.append((np.zeros(len(d), np.int32), deff, d, v))
        return out
    data = CN.drop_null_rows(data, row_ok)
    off = data.offsets.astype(np.int64)
    n = len(off) - 1
    lens = off[1:] - off[:-1]
    nlev = np.maximum(lens, 1)
    total = int(nlev.sum())
    row_of = np.repeat(np.arange(n), nlev)
    starts = np.zeros(n + 1, dtype=np.int64)
    starts[1:] = np.cumsum(nlev)
    rep = np.ones(total, dtype=np.int32)
    rep[starts[:-1]] = 0
    is_elem = np.repeat(lens > 0, nlev)
    empty_def = np.where(row_ok[row_of[~is_elem]], 1, 0).astype(np.int32)
    out = []
    streams = [(data.data, data.validity)] if isinstance(
        data, CN.ArrayData) else [(data.kdata, None),
                                  (data.vdata, data.vvalid)]
    for d, v in streams:
        deff = np.empty(total, dtype=np.int32)
        deff[~is_elem] = empty_def
        slot_d = np.zeros(total, dtype=d.dtype)
        slot_d[is_elem] = d[off[0]:off[-1]]
        if v is None:  # a map's key: REQUIRED
            deff[is_elem] = 2
            slot_v = is_elem.copy()
        else:
            ev = np.asarray(v[off[0]:off[-1]], dtype=bool)
            deff[is_elem] = np.where(ev, 3, 2)
            slot_v = np.zeros(total, dtype=bool)
            slot_v[is_elem] = ev
        out.append((rep, deff, slot_d, slot_v))
    return out


def _write_nested_chunk(f, path: List[str], dt, phys: int, max_rep: int,
                        max_def: int, levels, codec: int, page_bytes: int):
    """One leaf of a nested column as a column chunk at f's position:
    version-1 data pages, each starting at a row, of RLE repetition and
    definition levels and the PLAIN non-null values. Returns its
    ColumnChunk fields and sizes."""
    rep, deff, slot_d, slot_v = levels
    enc = _Encoded(HostColumn(dt, slot_d, slot_v), phys, None)
    total = len(rep)
    start = f.tell()
    row_starts = np.flatnonzero(rep == 0)
    width = np.dtype(_NP_PLAIN[phys]).itemsize if phys != BOOLEAN else 1
    per_page = max(1, page_bytes // (width + 1))
    usize_total = csize_total = 0
    lo = 0
    while lo < total or lo == 0:
        # the first row start at or past lo + per_page ends the page
        j = np.searchsorted(row_starts, lo + per_page)
        hi = int(row_starts[j]) if j < len(row_starts) else total
        body = bytearray()
        if max_rep:
            lv = N.rle_encode(rep[lo:hi], max(1, max_rep.bit_length()))
            body += struct.pack("<I", len(lv)) + lv
        lv = N.rle_encode(deff[lo:hi], max(1, max_def.bit_length()))
        body += struct.pack("<I", len(lv)) + lv
        body += enc.plain_values(lo, hi)
        body = bytes(body)
        comp = _compress(codec, body)
        head = thrift_bytes([
            (1, _I32, DATA_PAGE), (2, _I32, len(body)), (3, _I32, len(comp)),
            (5, _STRUCT, [(1, _I32, hi - lo), (2, _I32, PLAIN),
                          (3, _I32, RLE), (4, _I32, RLE)])])
        f.write(head)
        f.write(comp)
        usize_total += len(head) + len(body)
        csize_total += len(head) + len(comp)
        lo = hi
        if total == 0:
            break
    stats = [(3, _I64, int(total - np.count_nonzero(slot_v))),
             (5, _BINARY, enc.max), (6, _BINARY, enc.min)]
    meta = [(1, _I32, phys), (2, _LIST, (_I32, [PLAIN, RLE])),
            (3, _LIST, (_BINARY, path)), (4, _I32, codec),
            (5, _I64, total), (6, _I64, usize_total),
            (7, _I64, csize_total), (9, _I64, start), (12, _STRUCT, stats)]
    return [(2, _I64, start), (3, _STRUCT, meta)], usize_total, csize_total


#: writer codec names; ``"lz4"`` is LZ4_RAW, the id pyarrow writes for it
CODECS = {"snappy": SNAPPY, "gzip": GZIP, "zstd": ZSTD, "lz4": LZ4_RAW,
          "lz4_raw": LZ4_RAW, "none": UNCOMPRESSED,
          "uncompressed": UNCOMPRESSED}


def write_table(table: HostTable, path: str, compression: str = "snappy",
                row_group_rows: int = 1 << 20,
                page_bytes: int = 1 << 20) -> None:
    """Write ``table`` to the Parquet file ``path``."""
    key = (compression or "none").lower()
    named = {"brotli": BROTLI, "lzo": LZO}
    if key in named:
        raise unsupported_codec("Parquet", CODEC_NAMES, named[key],
                                "writer")
    if key not in CODECS:
        raise NotImplementedError(
            f"Parquet codec {compression!r} is not supported by the port's "
            "Parquet writer (snappy, gzip, zstd, lz4 and none are)")
    codec = CODECS[key]
    elements = [[(4, _BINARY, "schema"), (5, _I32, len(table.names))]]
    physical = []
    n_leaves = 0
    for name, c in zip(table.names, table.columns):
        if isinstance(c.dtype, (T.ArrayType, T.MapType, T.StructType)):
            groups, leaves = _nested_schema(name, c.dtype)
            elements.extend(groups)
            physical.append(leaves)
            n_leaves += len(leaves)
            continue
        phys, fields = _schema_element(name, c.dtype)
        tl = (decimal_bytes(c.dtype.precision)
              if isinstance(c.dtype, T.DecimalType) else None)
        physical.append((phys, tl))
        elements.append(fields)
        n_leaves += 1
    n = table.num_rows
    step = max(1, int(row_group_rows))
    row_groups = []
    with open(path, "wb") as f:
        f.write(MAGIC)
        for ordinal, lo in enumerate(range(0, n, step)):
            part = table.slice(lo, min(step, n - lo))
            rg_start = f.tell()
            chunks, usize, csize = [], 0, 0
            for name, c, spec in zip(part.names, part.columns, physical):
                if isinstance(spec, list):  # a nested column's leaves
                    outs = [_write_nested_chunk(f, path, dt, phys, mr, md,
                                                lv, codec, page_bytes)
                            for (path, dt, phys, mr, md), lv in
                            zip(spec, _nested_levels(c))]
                else:
                    outs = [_write_chunk(f, name, c, spec[0], spec[1],
                                         codec, page_bytes)]
                for cc, u, cz in outs:
                    chunks.append((_STRUCT, cc))
                    usize += u
                    csize += cz
            row_groups.append([
                (1, _LIST, (_STRUCT, [c for _, c in chunks])),
                (2, _I64, usize), (3, _I64, part.num_rows),
                (5, _I64, rg_start), (6, _I64, csize),
                (7, _I16, ordinal)])
        footer = thrift_bytes([
            (1, _I32, 2),
            (2, _LIST, (_STRUCT, elements)),
            (3, _I64, n),
            (4, _LIST, (_STRUCT, row_groups)),
            (6, _BINARY, "spark_rapids_tpu_torch"),
            (7, _LIST, (_STRUCT, [[(1, _STRUCT, [])]
                                  for _ in range(n_leaves)])),
        ])
        f.write(footer)
        f.write(struct.pack("<I", len(footer)))
        f.write(MAGIC)

