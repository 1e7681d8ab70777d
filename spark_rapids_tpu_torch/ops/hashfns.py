"""Hash expressions (port of ``spark_rapids_tpu/ops/hashfns.py``):
``Murmur3Hash`` (Spark's ``hash()``), ``XxHash64`` and ``HiveHash``.

Murmur3 and XxHash64 hash their children in order with seed 42, each
column's hash seeding the next; a null child passes the running hash
through. Murmur3 runs through the shuffle layer's device hash
(shuffle/hashing.py). XxHash64 is Spark's XXH64 variant: a fixed-width
value is one 8- or 4-byte round; a string the full XXH64 over its UTF-8
bytes, gathered word by word from its dictionary's byte matrix by code
(the reference's byte-row form). A DECIMAL128 child hashes as Spark does
for a precision above 18: the minimal big-endian two's-complement bytes
of the unscaled value (``BigInteger.toByteArray``), computed per row on
the device. (The shuffle partitioner keeps hashing a DECIMAL128's two
limbs, the reference's partitioner convention.)

64-bit lanes: torch has no uint64 arithmetic, so XXH64 runs on int64,
whose products and sums wrap to the same low 64 bits, with logical right
shifts masked out of the arithmetic ones. ``HiveHash`` folds 31 * h + f
in int32, which wraps as Java's int does."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.ops.expr import DevVal, EvalCtx, Expression, \
    NodePrep, PrepCtx
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.shuffle.hashing import (
    _dec128_twos_complement_bytes,
    _float_bits,
    dec128_byte_rows,
    device_string_bytes,
    murmur3_hash_device,
    murmur3_hash_host,
)

P1 = 0x9E3779B185EBCA87
P2 = 0xC2B2AE3D27D4EB4F
P3 = 0x165667B19E3779F9
P4 = 0x85EBCA77C2B2AE63
P5 = 0x27D4EB2F165667C5
XX_SEED = 42
_M32 = 0xFFFFFFFF


def _s64(c: int) -> int:
    """A 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


def _shr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 bits by 0 < r < 64."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr(x, 64 - r)


def _xx_fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _shr(h, 33)
    h = h * _s64(P2)
    h = h ^ _shr(h, 29)
    h = h * _s64(P3)
    return h ^ _shr(h, 32)


def _xx_round(acc: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
    acc = acc + word * _s64(P2)
    return _rotl(acc, 31) * _s64(P1)


def _xx_long(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark XXH64 hashLong: one 8-byte round and the avalanche."""
    h = seed + _s64((P5 + 8) & ((1 << 64) - 1))
    h = h ^ _xx_round(torch.zeros_like(v), v)
    return _xx_fmix(_rotl(h, 27) * _s64(P1) + _s64(P4))


def _xx_int(v32: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Spark XXH64 hashInt of 32-bit words (int64 in [0, 2^32))."""
    h = seed + _s64((P5 + 4) & ((1 << 64) - 1))
    h = h ^ (v32 * _s64(P1))
    return _xx_fmix(_rotl(h, 23) * _s64(P2) + _s64(P3))


def _le_words(b: torch.Tensor, width: int) -> torch.Tensor:
    """Little-endian words of ``width`` bytes from a (d, L) int64 byte
    matrix (L a multiple of ``width``): (d, L / width) int64."""
    out = torch.zeros((b.shape[0], b.shape[1] // width), dtype=torch.int64,
                      device=b.device)
    for k in range(width):
        out = out | (b[:, k::width] << (8 * k))
    return out


def xx_hash_bytes(codes: torch.Tensor, byte_matrix: torch.Tensor,
                  lengths: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """XXH64 of each row's byte string, seeded per row: row i hashes
    entry ``codes[i]`` of ``byte_matrix`` (d, L) uint8 (L a multiple of 8,
    zero-padded) with ``lengths`` (d,) bytes."""
    d, width = byte_matrix.shape
    if width % 8:
        byte_matrix = torch.cat([byte_matrix, byte_matrix.new_zeros(
            (d, 8 - width % 8))], dim=1)
        width = byte_matrix.shape[1]
    b = byte_matrix.to(torch.int64)
    w8, w4 = _le_words(b, 8), _le_words(b, 4)
    c = codes.to(torch.int64).clamp(0, d - 1)
    n_len = lengths.to(torch.int64)[c]

    def word8(i):  # the 8-byte word at 8-aligned word index i of each row
        return w8.reshape(-1)[c * w8.shape[1] + i.clamp(0, w8.shape[1] - 1)]

    nstripes = n_len // 32
    v = [seed + _s64((P1 + P2) & ((1 << 64) - 1)), seed + _s64(P2), seed,
         seed - _s64(P1)]
    for s in range(width // 32):
        active = s < nstripes
        for j in range(4):
            nv = _xx_round(v[j], w8[:, 4 * s + j][c])
            v[j] = torch.where(active, nv, v[j])
    merged = _rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + \
        _rotl(v[3], 18)
    for j in range(4):
        merged = (merged ^ _xx_round(torch.zeros_like(merged), v[j])) * \
            _s64(P1) + _s64(P4)
    h = torch.where(nstripes > 0, merged, seed + _s64(P5)) + n_len
    pos = nstripes * 32
    for _ in range(3):  # below 32 bytes remain: at most three 8-byte words
        active = pos + 8 <= n_len
        k1 = _xx_round(torch.zeros_like(h), word8(pos // 8))
        h = torch.where(active, _rotl(h ^ k1, 27) * _s64(P1) + _s64(P4), h)
        pos = torch.where(active, pos + 8, pos)
    active = pos + 4 <= n_len
    word4 = w4.reshape(-1)[c * w4.shape[1] + (pos // 4).clamp(
        0, w4.shape[1] - 1)] & _M32
    nh = _rotl(h ^ (word4 * _s64(P1)), 23) * _s64(P2) + _s64(P3)
    h = torch.where(active, nh, h)
    pos = torch.where(active, pos + 4, pos)
    for _ in range(3):
        byte = b.reshape(-1)[c * width + pos.clamp(0, width - 1)]
        active = pos < n_len
        nh = _rotl(h ^ (byte * _s64(P5)), 11) * _s64(P1)
        h = torch.where(active, nh, h)
        pos = torch.where(active, pos + 1, pos)
    return _xx_fmix(h)


class _HashBase(Expression):
    """n-ary row hash: never null; the string children's dictionary bytes
    are a device input the prep walk uploads."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    def with_children(self, children):
        return type(self)(*children)

    def resolve(self, bound):
        for c in bound:
            if isinstance(c.data_type, (T.ArrayType, T.StructType,
                                        T.MapType)):
                raise NotImplementedError(
                    f"{self.name} over {c.data_type.simple_string()} is not "
                    "ported")
        return self.with_children(bound)

    def prep(self, pctx: PrepCtx, child_preps) -> NodePrep:
        return NodePrep(aux={
            i: device_string_bytes(p.out_dict, pctx.table.device)
            for i, (c, p) in enumerate(zip(self.children, child_preps))
            if isinstance(c.data_type, T.StringType)})


class Murmur3Hash(_HashBase):
    """Spark's ``hash()``: INT."""

    @property
    def data_type(self):
        return T.INT

    def eval_dev(self, ctx: EvalCtx, child_vals, prep: NodePrep) -> DevVal:
        cols = [(v.data, v.validity, c.data_type)
                for c, v in zip(self.children, child_vals)]
        h = murmur3_hash_device(cols, string_bytes=prep.aux,
                                dec128_bytes=True)
        return DevVal(h, torch.ones(ctx.capacity, dtype=torch.bool,
                                    device=ctx.device))

    def eval_cpu(self, table: HostTable) -> HostColumn:
        cols = [c.eval_cpu(table) for c in self.children]
        n = table.num_rows
        out = np.empty(n, dtype=np.int32)
        for r in range(n):
            out[r] = murmur3_hash_host(
                [(cols[j].data[r], bool(cols[j].validity[r]),
                  self.children[j].data_type) for j in range(len(cols))])
        return HostColumn(T.INT, out, np.ones(n, dtype=np.bool_))


def xxhash64_device(cols, seed: int = XX_SEED,
                    string_bytes: Optional[dict] = None) -> torch.Tensor:
    """XxHash64 row hash over (data, validity, DataType) columns: int64."""
    data0 = cols[0][0]
    n = data0.shape[0]
    h = torch.full((n,), seed, dtype=torch.int64, device=data0.device)
    for i, (data, validity, dt) in enumerate(cols):
        if isinstance(dt, T.StringType):
            mat, lens = string_bytes[i]
            nh = xx_hash_bytes(data, mat, lens, h)
        elif T.is_dec128(dt):
            rows, lens = dec128_byte_rows(data)
            nh = xx_hash_bytes(torch.arange(n, device=data.device), rows,
                               lens, h)
        elif isinstance(dt, (T.LongType, T.TimestampType, T.DecimalType)):
            nh = _xx_long(data.to(torch.int64), h)
        elif isinstance(dt, T.DoubleType):
            nh = _xx_long(_float_bits(data), h)
        elif isinstance(dt, T.FloatType):
            nh = _xx_int(_float_bits(data), h)
        elif isinstance(dt, T.BooleanType):
            nh = _xx_int(data.to(torch.int64), h)
        else:  # byte/short/int/date: widened to int32, then its word
            nh = _xx_int(data.to(torch.int32).to(torch.int64) & _M32, h)
        h = torch.where(validity, nh, h)
    return h


class XxHash64(_HashBase):
    """Spark's ``xxhash64()``: LONG."""

    @property
    def data_type(self):
        return T.LONG

    def eval_dev(self, ctx: EvalCtx, child_vals, prep: NodePrep) -> DevVal:
        cols = [(v.data, v.validity, c.data_type)
                for c, v in zip(self.children, child_vals)]
        h = xxhash64_device(cols, string_bytes=prep.aux)
        return DevVal(h, torch.ones(ctx.capacity, dtype=torch.bool,
                                    device=ctx.device))

    def eval_cpu(self, table: HostTable) -> HostColumn:
        cols = [c.eval_cpu(table) for c in self.children]
        n = table.num_rows
        out = np.empty(n, dtype=np.int64)
        for r in range(n):
            out[r] = xxhash64_host(
                [(cols[j].data[r], bool(cols[j].validity[r]),
                  self.children[j].data_type) for j in range(len(cols))])
        return HostColumn(T.LONG, out, np.ones(n, dtype=np.bool_))


# -- hive hash ---------------------------------------------------------------

def hive_string_hash(s: str) -> int:
    """Hive's HiveHasher.hashUnsafeBytes: a fold of the SIGNED UTF-8 bytes
    (31 * h + byte) in int32."""
    h = 0
    for byte in s.encode("utf-8"):
        signed = byte - 256 if byte >= 128 else byte
        h = (h * 31 + signed) & 0xFFFFFFFF
    return h - (1 << 32) if h >= (1 << 31) else h


def _fold_long(x: torch.Tensor) -> torch.Tensor:
    """Java's Long.hashCode: (int) (x ^ (x >>> 32))."""
    return (x ^ ((x >> 32) & _M32)).to(torch.int32)


class HiveHash(_HashBase):
    """Hive's hash: row hash = fold(31 * h + fieldHash), a null field
    hashes to 0; INT."""

    @property
    def data_type(self):
        return T.INT

    def resolve(self, bound):
        for c in bound:
            if isinstance(c.data_type, T.DecimalType) or not isinstance(
                    c.data_type, (T.NumericType, T.StringType, T.DateType,
                                  T.TimestampType, T.BooleanType)):
                raise NotImplementedError(
                    f"hive hash of {c.data_type.simple_string()} is not "
                    "ported")
        return self.with_children(bound)

    def prep(self, pctx: PrepCtx, child_preps) -> NodePrep:
        aux = {}
        for i, (c, p) in enumerate(zip(self.children, child_preps)):
            if isinstance(c.data_type, T.StringType):
                d = p.out_dict if p.out_dict is not None else []
                hashes = np.array([hive_string_hash(s) for s in d] or [0],
                                  dtype=np.int32)
                aux[i] = torch.from_numpy(hashes).to(pctx.table.device)
        return NodePrep(aux=aux)

    def eval_dev(self, ctx: EvalCtx, child_vals, prep: NodePrep) -> DevVal:
        h = torch.zeros(ctx.capacity, dtype=torch.int32, device=ctx.device)
        for j, (c, v) in enumerate(zip(self.children, child_vals)):
            dt = c.data_type
            if j in prep.aux:
                tbl = prep.aux[j]
                f = tbl.index_select(0, v.data.clamp(0, tbl.shape[0] - 1))
            elif isinstance(dt, T.TimestampType):
                micros = v.data.to(torch.int64)
                seconds = micros // 1_000_000
                nanos = (micros - seconds * 1_000_000) * 1000
                f = _fold_long((seconds << 30) | nanos)
            elif isinstance(dt, T.LongType):
                f = _fold_long(v.data)
            elif isinstance(dt, T.FloatType):
                f = v.data.to(torch.float32).view(torch.int32)
            elif isinstance(dt, T.DoubleType):
                f = _fold_long(v.data.to(torch.float64).view(torch.int64))
            else:  # boolean, byte, short, int, date
                f = v.data.to(torch.int32)
            f = torch.where(v.validity, f, torch.zeros_like(f))
            h = h * 31 + f
        return DevVal(h, torch.ones(ctx.capacity, dtype=torch.bool,
                                    device=ctx.device))

    def eval_cpu(self, table: HostTable) -> HostColumn:
        cols = [c.eval_cpu(table) for c in self.children]
        n = table.num_rows
        out = np.empty(n, dtype=np.int32)
        for r in range(n):
            h = 0
            for j, c in enumerate(cols):
                f = _hive_field_host(c.data[r], bool(c.validity[r]),
                                     self.children[j].data_type)
                h = (h * 31 + f) & 0xFFFFFFFF
            out[r] = np.uint32(h).astype(np.int32).item() \
                if h < (1 << 31) else h - (1 << 32)
        return HostColumn(T.INT, out, np.ones(n, dtype=np.bool_))


# ---------------------------------------------------------------------------
# host evaluation helpers (the CPU route)
# ---------------------------------------------------------------------------


M64 = (1 << 64) - 1


def _np_rotl64(x, r):
    x = int(x) & M64
    return ((x << r) | (x >> (64 - r))) & M64


def _np_xx_fmix(h):
    h = int(h) & M64
    h ^= h >> 33
    h = (h * P2) & M64
    h ^= h >> 29
    h = (h * P3) & M64
    h ^= h >> 32
    return h


def _np_xx_long(v, seed):
    v = int(np.int64(v)) & M64
    h = (seed + P5 + 8) & M64
    k1 = (v * P2) & M64
    k1 = _np_rotl64(k1, 31)
    k1 = (k1 * P1) & M64
    h ^= k1
    h = (_np_rotl64(h, 27) * P1 + P4) & M64
    return _np_xx_fmix(h)


def _np_xx_int(v, seed):
    v = int(np.uint32(np.int32(v)))
    h = (seed + P5 + 4) & M64
    h ^= (v * P1) & M64
    h = (_np_rotl64(h, 23) * P2 + P3) & M64
    return _np_xx_fmix(h)


def _np_xx_bytes(b: bytes, seed: int) -> int:
    length = len(b)
    if length >= 32:
        v1 = (seed + P1 + P2) & M64
        v2 = (seed + P2) & M64
        v3 = seed & M64
        v4 = (seed - P1) & M64
        i = 0
        while i + 32 <= length:
            for vi, off in ((1, 0), (2, 8), (3, 16), (4, 24)):
                w = int.from_bytes(b[i + off:i + off + 8], "little")
                v = {1: v1, 2: v2, 3: v3, 4: v4}[vi]
                v = (v + w * P2) & M64
                v = _np_rotl64(v, 31)
                v = (v * P1) & M64
                if vi == 1:
                    v1 = v
                elif vi == 2:
                    v2 = v
                elif vi == 3:
                    v3 = v
                else:
                    v4 = v
            i += 32
        h = (_np_rotl64(v1, 1) + _np_rotl64(v2, 7) + _np_rotl64(v3, 12)
             + _np_rotl64(v4, 18)) & M64
        for v in (v1, v2, v3, v4):
            k = (v * P2) & M64
            k = _np_rotl64(k, 31)
            k = (k * P1) & M64
            h ^= k
            h = (h * P1 + P4) & M64
        pos = i
    else:
        h = (seed + P5) & M64
        pos = 0
    h = (h + length) & M64
    while pos + 8 <= length:
        w = int.from_bytes(b[pos:pos + 8], "little")
        k1 = (w * P2) & M64
        k1 = _np_rotl64(k1, 31)
        k1 = (k1 * P1) & M64
        h ^= k1
        h = (_np_rotl64(h, 27) * P1 + P4) & M64
        pos += 8
    if pos + 4 <= length:
        w = int.from_bytes(b[pos:pos + 4], "little")
        h ^= (w * P1) & M64
        h = (_np_rotl64(h, 23) * P2 + P3) & M64
        pos += 4
    while pos < length:
        h ^= (b[pos] * P5) & M64
        h = (_np_rotl64(h, 11) * P1) & M64
        pos += 1
    return _np_xx_fmix(h)


def xxhash64_host(values, seed: int = XX_SEED) -> int:
    h = seed
    for v, valid, dt in values:
        if not valid:
            continue
        if isinstance(dt, T.StringType):
            h = _np_xx_bytes(str(v).encode("utf-8"), h)
        elif T.is_dec128(dt):
            # Spark-exact: bytes of the unscaled BigInteger (see
            # shuffle/hashing.py murmur3 dec128 note)
            h = _np_xx_bytes(_dec128_twos_complement_bytes(int(v)), h)
        elif isinstance(dt, (T.LongType, T.TimestampType, T.DecimalType)):
            h = _np_xx_long(v, h)
        elif isinstance(dt, T.DoubleType):
            d = 0.0 if v == 0.0 else float(v)
            h = _np_xx_long(np.float64(d).view(np.int64), h)
        elif isinstance(dt, T.FloatType):
            f = 0.0 if v == 0.0 else float(v)
            h = _np_xx_int(np.float32(f).view(np.int32), h)
        elif isinstance(dt, T.BooleanType):
            h = _np_xx_int(1 if v else 0, h)
        else:
            h = _np_xx_int(int(v), h)
    return int(np.uint64(h).view(np.int64))


def _hive_timestamp_value(micros: int) -> int:
    """Hive TimestampWritable.hashCode layout: (seconds << 30) | nanos,
    before the standard long fold."""
    seconds, rem = divmod(int(micros), 1_000_000)
    return (seconds << 30) | (rem * 1000)


def _hive_field_host(value, valid: bool, dtype) -> int:
    if not valid:
        return 0
    if isinstance(dtype, T.BooleanType):
        return 1 if value else 0
    if isinstance(dtype, (T.ByteType, T.ShortType, T.IntegerType,
                          T.DateType)):
        return int(np.int32(value))
    if isinstance(dtype, T.LongType):
        v = int(np.int64(value))
        return int(np.int32((v ^ ((v >> 32) & 0xFFFFFFFF)) & 0xFFFFFFFF))
    if isinstance(dtype, T.FloatType):
        bits = np.float32(value).view(np.int32)
        return int(bits)
    if isinstance(dtype, (T.DoubleType, T.TimestampType)):
        if isinstance(dtype, T.TimestampType):
            v = _hive_timestamp_value(int(np.int64(value)))
        else:
            v = int(np.float64(value).view(np.int64))
        return int(np.int32((v ^ ((v >> 32) & 0xFFFFFFFF)) & 0xFFFFFFFF))
    if isinstance(dtype, T.StringType):
        return hive_string_hash(value)
    raise ColumnarProcessingError(f"hive hash of {dtype} not supported")
