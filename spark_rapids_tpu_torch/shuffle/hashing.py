"""Spark-exact Murmur3 (x86_32) on the device (port of
``spark_rapids_tpu/shuffle/hashing.py``: ``murmur3_hash_device``,
``string_dict_bytes`` and the numpy mirror).

Spark's algorithm is Murmur3_x86_32 with seed 42, hashed column by column
with each column's hash seeding the next:

  int/short/byte/bool/date -> hashInt(v)
  long/timestamp/decimal64 -> hashLong(v) (a decimal: its unscaled value)
  float                    -> hashInt(floatToIntBits(f)), -0.0 -> 0.0
  double                   -> hashLong(doubleToLongBits(d)), -0.0 -> 0.0
  string                   -> hashUnsafeBytes(utf8): full 4-byte words get a
                              mix round, then EACH tail byte (sign-extended)
                              gets its own full mix round (Spark's
                              non-standard tail)
  null                     -> hash unchanged (the seed passes through)

Doubles keep their raw NaN bits, as both forms of the reference do
(Spark's doubleToLongBits would collapse every NaN to one pattern).
DECIMAL128 hashes its two limbs as two longs in the partitioner: the
reference's partitioner convention (partition assignment never changes a
result); the ``hash()`` expression asks for Spark's byte hash of the
unscaled value instead (``dec128_bytes``).

Device mapping: torch has few uint32 operations and CUDA no unsigned
multiply, so every 32-bit lane lives in an int64 in [0, 2^32): each
product is masked back to 32 bits (the int64 product wraps, its low 32
bits stay right) and rotations shift the masked value. A string column
hashes through its dictionary's byte matrix (``string_dict_bytes``,
uploaded by the caller): each row gathers its entry's words by code, so
per-row seeds work.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T

C1 = 0xCC9E2D51
C2 = 0x1B873593
SPARK_SEED = 42
M32 = 0xFFFFFFFF


# -- device (torch, 32-bit lanes in int64) ----------------------------------

def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    k1 = (k1 * C1) & M32
    k1 = _rotl(k1, 15)
    return (k1 * C2) & M32


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h1 = _rotl(h1 ^ k1, 13)
    return (h1 * 5 + 0xE6546B64) & M32


def _fmix(h1: torch.Tensor, length) -> torch.Tensor:
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = (h1 * 0x85EBCA6B) & M32
    h1 = h1 ^ (h1 >> 13)
    h1 = (h1 * 0xC2B2AE35) & M32
    return h1 ^ (h1 >> 16)


def _hash_int(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """hashInt of 32-bit words ``v`` (int64 in [0, 2^32))."""
    return _fmix(_mix_h1(seed, _mix_k1(v)), 4)


def _hash_long(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    h1 = _mix_h1(seed, _mix_k1(v & M32))
    h1 = _mix_h1(h1, _mix_k1((v >> 32) & M32))
    return _fmix(h1, 8)


def _float_bits(data: torch.Tensor) -> torch.Tensor:
    """The IEEE bits of ``data`` as int64 (-0.0 -> 0.0; NaN bits raw);
    a float32's bits as a 32-bit word."""
    data = torch.where(data == 0.0, torch.zeros_like(data), data)
    if data.dtype == torch.float32:
        return data.view(torch.int32).to(torch.int64) & M32
    return data.view(torch.int64)


def _hash_string(codes: torch.Tensor, byte_matrix: torch.Tensor,
                 lengths: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """murmur3 of each row's dictionary entry, seeded by ``h``.

    byte_matrix: (d, L) uint8, L a multiple of 4 (zero-padded);
    lengths:     (d,) int32 byte lengths. Bytes past the last aligned word
    are hashed one by one as SIGN-EXTENDED ints, each with a full round."""
    d, width = byte_matrix.shape
    b = byte_matrix.to(torch.int64)
    words = b[:, 0::4] | (b[:, 1::4] << 8) | (b[:, 2::4] << 16) \
        | (b[:, 3::4] << 24)
    lens = lengths.to(torch.int64)
    aligned = (lens // 4) * 4
    c = codes.to(torch.int64).clamp(0, d - 1)
    row_len, row_aligned = lens[c], aligned[c]
    for w in range(width // 4):
        nxt = _mix_h1(h, _mix_k1(words[:, w][c]))
        h = torch.where(4 * w + 4 <= row_aligned, nxt, h)
    for i in range(3):  # the tail is at most 3 bytes
        pos = (aligned + i).clamp(0, width - 1)
        byte = b.gather(1, pos[:, None])[:, 0]
        signed = torch.where(byte >= 128, byte - 256, byte) & M32
        nxt = _mix_h1(h, _mix_k1(signed[c]))
        h = torch.where(row_aligned + i < row_len, nxt, h)
    return _fmix(h, row_len)


def dec128_byte_rows(data: torch.Tensor) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Spark's bytes of a DECIMAL128 unscaled value, per row: the minimal
    big-endian two's complement (``BigInteger.toByteArray``), left-aligned
    in a (n, 16) uint8 matrix, and the lengths (1..16)."""
    hi, lo = data[:, 0], data[:, 1]
    shifts = torch.arange(56, -8, -8, device=data.device)
    be = torch.cat([(hi[:, None] >> shifts) & 0xFF,
                    (lo[:, None] >> shifts) & 0xFF], dim=1)  # (n, 16)
    # the magnitude bits of v >= 0, or of ~v for v < 0, set the length
    mag = torch.where((hi < 0)[:, None], 0xFF - be, be)
    nz = mag != 0
    first = torch.where(nz.any(dim=1), nz.to(torch.int8).argmax(dim=1),
                        torch.full_like(hi, 16))
    top = mag.gather(1, first.clamp(max=15)[:, None])[:, 0]
    top_bits = sum((top >= (1 << k)).to(torch.int64) for k in range(8))
    bitlen = torch.where(first < 16, (15 - first) * 8 + top_bits, 0)
    lengths = bitlen // 8 + 1
    idx = (16 - lengths)[:, None] + torch.arange(16, device=data.device)
    rows = be.gather(1, idx.clamp(max=15))
    rows = torch.where(idx <= 15, rows, torch.zeros_like(rows))
    return rows.to(torch.uint8), lengths.to(torch.int32)



def murmur3_hash_device(cols: List[Tuple[torch.Tensor, torch.Tensor,
                                         T.DataType]],
                        seed: int = SPARK_SEED,
                        string_bytes: Optional[dict] = None,
                        dec128_bytes: bool = False) -> torch.Tensor:
    """Row hash over several columns: int32 (Spark's ``hash()`` value).

    cols: (data, validity, DataType) each; for a STRING column data is
    the code array and ``string_bytes[i] = (byte_matrix, lengths)``, the
    device form of ``string_dict_bytes`` of its dictionary. A DECIMAL128
    column hashes its two limbs as longs (the partitioner's convention),
    or with ``dec128_bytes`` Spark's bytes of the unscaled value
    (``dec128_byte_rows``), as the ``hash()`` expression does."""
    data0 = cols[0][0]
    h = torch.full((data0.shape[0],), seed, dtype=torch.int64,
                   device=data0.device)
    for i, (data, validity, dt) in enumerate(cols):
        if isinstance(dt, T.StringType):
            nh = _hash_string(data, *string_bytes[i], h)
        elif T.is_dec128(dt) and dec128_bytes:
            rows, lengths = dec128_byte_rows(data)
            nh = _hash_string(torch.arange(data.shape[0],
                                           device=data.device),
                              rows, lengths, h)
        elif T.is_dec128(dt):
            nh = _hash_long(data[:, 1], _hash_long(data[:, 0], h))
        elif isinstance(dt, (T.LongType, T.TimestampType, T.DecimalType)):
            nh = _hash_long(data.to(torch.int64), h)
        elif isinstance(dt, T.DoubleType):
            nh = _hash_long(_float_bits(data), h)
        elif isinstance(dt, T.FloatType):
            nh = _hash_int(_float_bits(data), h)
        elif isinstance(dt, T.BooleanType):
            nh = _hash_int(data.to(torch.int64), h)
        else:  # byte/short/int/date: widened to int32, then its word
            nh = _hash_int(data.to(torch.int32).to(torch.int64) & M32, h)
        h = torch.where(validity, nh, h)  # null: the seed passes through
    return h.to(torch.int32)


def string_dict_bytes(dictionary: Optional[np.ndarray],
                      max_bytes: int = 1 << 16
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Host prep: a string dictionary as a (d, L) uint8 matrix of its
    UTF-8 bytes + lengths, L a power of two of at least 4."""
    if dictionary is None or len(dictionary) == 0:
        return np.zeros((1, 4), dtype=np.uint8), np.zeros(1, dtype=np.int32)
    encoded = [s.encode("utf-8") if s is not None else b""
               for s in dictionary]
    lens = np.array([len(b) for b in encoded], dtype=np.int32)
    width = 4
    while width < int(lens.max()):
        width <<= 1
    if width > max_bytes:
        raise ValueError(f"string too long for the device hash: "
                         f"{lens.max()} bytes")
    mat = np.zeros((len(encoded), width), dtype=np.uint8)
    for i, b in enumerate(encoded):
        mat[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    return mat, lens


def device_string_bytes(dictionary, device) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """``string_dict_bytes`` of ``dictionary`` on ``device``."""
    mat, lens = string_dict_bytes(dictionary)
    return (torch.from_numpy(mat).to(device),
            torch.from_numpy(lens).to(device))


# -- numpy mirror (the oracle of the tests and of chip_smoke.py) -----------

def _np_u32(x):
    return np.uint32(int(x) & M32)


def _np_mix_k1(k1):
    k1 = np.uint32((int(k1) * C1) & M32)
    k1 = np.uint32(((int(k1) << 15) | (int(k1) >> 17)) & M32)
    return np.uint32((int(k1) * C2) & M32)


def _np_mix_h1(h1, k1):
    h1 = np.uint32(int(h1) ^ int(k1))
    h1 = np.uint32(((int(h1) << 13) | (int(h1) >> 19)) & M32)
    return np.uint32((int(h1) * 5 + 0xE6546B64) & M32)


def _np_fmix(h1, length):
    h1 = int(h1) ^ length
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & M32
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & M32
    h1 ^= h1 >> 16
    return np.uint32(h1)


def _np_hash_int(v, seed):
    return _np_fmix(_np_mix_h1(seed, _np_mix_k1(_np_u32(v))), 4)


def _np_hash_long(v, seed):
    v = int(np.int64(v))
    h1 = _np_mix_h1(seed, _np_mix_k1(_np_u32(v)))
    h1 = _np_mix_h1(h1, _np_mix_k1(_np_u32(v >> 32)))
    return _np_fmix(h1, 8)


def _dec128_twos_complement_bytes(v: int) -> bytes:
    """java.math.BigInteger.toByteArray(): minimal-length big-endian
    two's complement."""
    if v == 0:
        return b"\x00"
    bitlen = (~v).bit_length() if v < 0 else v.bit_length()
    return v.to_bytes(bitlen // 8 + 1, byteorder="big", signed=True)


def _np_hash_bytes(b: bytes, seed):
    h1 = np.uint32(seed)
    aligned = len(b) - len(b) % 4
    for i in range(0, aligned, 4):
        word = int.from_bytes(b[i:i + 4], "little")
        h1 = _np_mix_h1(h1, _np_mix_k1(np.uint32(word)))
    for i in range(aligned, len(b)):
        byte = b[i] - 256 if b[i] >= 128 else b[i]  # signed
        h1 = _np_mix_h1(h1, _np_mix_k1(_np_u32(byte)))
    return _np_fmix(h1, len(b))


def murmur3_hash_host(values: List[Tuple[object, bool, T.DataType]],
                      seed: int = SPARK_SEED) -> int:
    """One row's hash on the host: (value, valid, DataType) per column.
    DECIMAL128 is Spark's byte hash of the unscaled BigInteger here (the
    device partitioner hashes its limbs instead)."""
    h = np.uint32(seed)
    for v, valid, dt in values:
        if not valid:
            continue
        if isinstance(dt, T.StringType):
            h = _np_hash_bytes(str(v).encode("utf-8"), h)
        elif T.is_dec128(dt):
            h = _np_hash_bytes(_dec128_twos_complement_bytes(int(v)), h)
        elif isinstance(dt, (T.LongType, T.TimestampType, T.DecimalType)):
            h = _np_hash_long(v, h)
        elif isinstance(dt, T.DoubleType):
            d = 0.0 if v == 0.0 else float(v)
            h = _np_hash_long(np.float64(d).view(np.int64), h)
        elif isinstance(dt, T.FloatType):
            f = 0.0 if v == 0.0 else float(v)
            h = _np_hash_int(np.float32(f).view(np.int32), h)
        elif isinstance(dt, T.BooleanType):
            h = _np_hash_int(1 if v else 0, h)
        else:
            h = _np_hash_int(int(v), h)
    return int(np.int32(h))
