"""The port's host library (the counterpart of the reference's
``spark_rapids_tpu/native.py``): C++ sources beside this file, built with
``g++ -O3 -std=c++17 -shared -fPIC`` at first use into the git-ignored
``spark_rapids_tpu_torch/_build/`` under a hash of the source and the
flags (as ``kernels/build.py`` builds the CUDA sources), loaded with
ctypes.

- ``strcodec.cpp``: a copy of the repo-root ``native/strcodec.cpp``, the
  order-preserving dictionary encoder's sort of many distinct strings
  (``columnar/column.py::encode_sorted_dict``);
- ``parquet_host.cpp``: raw Snappy decompress and compress, the RLE /
  bit-packed hybrid decoder and encoder, the PLAIN BYTE_ARRAY splitter and
  packer, the padding of values into fixed-width rows, and the
  DELTA_BINARY_PACKED and DELTA_BYTE_ARRAY decoders
  (``io/parquet_format.py``);
- ``zstd_host.cpp``: a Zstandard (RFC 8878) decoder of the whole frame
  format but dictionaries, XXH64, and a simple encoder (greedy LZ77,
  predefined FSE tables, raw literals);
- ``lz4_host.cpp``: the LZ4 block codec (a copy of the repo-root
  ``native/lz4codec.cpp``);
- ``orc_host.cpp``: ORC's run-length streams (byte RLE, integer RLE v1
  and v2, the 128-bit varints of DECIMAL), decode and encode
  (``io/orc_format.py``);
- ``text_host.cpp``: the text codec of CSV, Hive text and JSON lines
  (``io/text_format.py``): the record tokenizer and the comment-line
  filter, the typed field parsers (integers, floats through
  ``std::from_chars``, booleans, dates, ISO and strptime timestamps,
  decimals) and Arrow's type inference over them, the distinct-span
  dictionary of string fields, the JSON scanner and its line
  normalisation, and the value formatters and row layout of the
  writers (``std::to_chars``).

Unlike the reference, which falls back to numpy, a failed build raises
with the compiler's output. Build ahead of first use with::

    python -m spark_rapids_tpu_torch.native
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from spark_rapids_tpu_torch.errors import ColumnarProcessingError

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
SOURCES = ("strcodec", "parquet_host", "text_host", "zstd_host",
           "lz4_host", "orc_host")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_SIGNATURES = {
    "encode_sorted_dict_u32": (_I64, [_P, _I64, _I64, _P, _P]),
    "srt_snappy_uncompressed_length": (_I64, [_P, _I64]),
    "srt_snappy_decompress": (_I64, [_P, _I64, _P, _I64]),
    "srt_snappy_max_compressed_length": (_I64, [_I64]),
    "srt_snappy_compress": (_I64, [_P, _I64, _P]),
    "srt_rle_decode": (_I64, [_P, _I64, ctypes.c_int32, _I64, _P]),
    "srt_rle_encode": (_I64, [_P, _I64, ctypes.c_int32, _P, _I64]),
    "srt_byte_array_unpack": (_I64, [_P, _I64, _I64, _P, _P]),
    "srt_byte_array_pack": (_I64, [_P, _P, _I64, _P]),
    "srt_pad_rows": (_I64, [_P, _P, _P, _I64, _I64, _P, _P]),
    "srt_delta_binary_decode": (_I64, [_P, _I64, _I64, _P]),
    "srt_delta_byte_array": (_I64, [_P, _I64, _P, _P, _P, _I64, _P]),
    "srt_zstd_content_size": (_I64, [_P, _I64]),
    "srt_zstd_decompress": (_I64, [_P, _I64, _P, _I64]),
    "srt_zstd_compress_bound": (_I64, [_I64]),
    "srt_zstd_compress": (_I64, [_P, _I64, _P, _I64, _I32]),
    "srt_lz4_compress_bound": (_I64, [_I64]),
    "srt_lz4_compress": (_I64, [_P, _I64, _P, _I64]),
    "srt_lz4_decompress": (_I64, [_P, _I64, _P, _I64]),
    "srt_orc_byte_rle_decode": (_I64, [_P, _I64, _I64, _P]),
    "srt_orc_int_rle_decode": (_I64, [_P, _I64, _I64, _I32, _I32, _P]),
    "srt_orc_varint128_decode": (_I64, [_P, _I64, _I64, _P, _P]),
    "srt_orc_byte_rle_encode": (_I64, [_P, _I64, _P, _I64]),
    "srt_orc_int_rle_encode": (_I64, [_P, _I64, _I32, _P, _I64]),
    "srt_orc_varint128_encode": (_I64, [_P, _P, _I64, _P, _I64]),
    "srt_filter_comment_lines": (_I64, [_P, _I64, _P, _I64, _P]),
    "srt_csv_tokenize": (_I64, [_P, _I64, _I32, _I32, _I32, _I32, _P, _P,
                                _P, _I64, _P, _P, _I64, _P]),
    "srt_null_mask": (None, [_P, _P, _P, _P, _I64, _P, _P, _I32, _P]),
    "srt_csv_infer": (_I64, [_P, _P, _P, _I64]),
    "srt_parse": (_I64, [_P, _P, _P, _I64, _I32, _I64, _P, _P]),
    "srt_parse_strptime": (_I64, [_P, _P, _P, _I64, _P, _I64, _P, _P]),
    "srt_span_dedup": (_I64, [_P, _P, _P, _I64, _P, _P]),
    "srt_gather_spans": (None, [_P, _P, _P, _I64, _P, _P]),
    "srt_json_scan": (_I64, [_P, _I64, _I32, _P, _P, _P, _P, _P, _I64, _P,
                             _P, _I64, _P]),
    "srt_json_normalize": (_I64, [_P, _I64, _I32, _P]),
    "srt_fmt_i64": (_I64, [_P, _I64, _P, _P]),
    "srt_fmt_f64": (_I64, [_P, _I64, _I32, _P, _P]),
    "srt_fmt_f32": (_I64, [_P, _I64, _P, _P]),
    "srt_fmt_bool": (_I64, [_P, _I64, _P, _P]),
    "srt_fmt_date": (_I64, [_P, _I64, _P, _P]),
    "srt_fmt_ts": (_I64, [_P, _I64, _I32, _P, _P]),
    "srt_fmt_decimal": (_I64, [_P, _I64, _I32, _P, _P]),
    "srt_escape": (_I64, [_P, _P, _I64, _I32, _I32, _I32, _P, _P]),
    "srt_assemble": (_I64, [_I32, _P, _P, _P, _P, _P, _P, _P, _I64, _P,
                            _I64, _P, _I64, _P, _I64, _I32, _P]),
}


def compiler() -> str:
    """``$CXX``, else ``g++`` on PATH."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (set CXX): the port's host "
                           "library builds from source at first use")
    return cxx


def _target(name: str) -> Path:
    text = (SRC_DIR / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(text + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"host-{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source that has no current library, one g++
    each, all at once. Returns {name: seconds} for the sources this call
    compiled; a failed build raises with the compiler's output."""
    import time
    todo = {n: _target(n) for n in names if not _target(n).is_file()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = compiler()
    t0 = time.perf_counter()
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}"
                                 ".tmp")
        cmd = [cxx, *GXX_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cpp")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    took, failures = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name}.cpp (exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, target)
        took[name] = time.perf_counter() - t0
    if failures:
        raise RuntimeError("host library build failed:\n"
                           + "\n".join(failures))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``<name>.cpp``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fn, (res, args) in _SIGNATURES.items():
                f = getattr(lib, fn, None)
                if f is not None:
                    f.restype, f.argtypes = res, args
            _LIBS[name] = lib
        return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _u8(buf) -> np.ndarray:
    """A uint8 view of a bytes-like object (no copy)."""
    if isinstance(buf, np.ndarray):
        return np.ascontiguousarray(buf).view(np.uint8).reshape(-1)
    return np.frombuffer(buf, dtype=np.uint8)


# -- strcodec -----------------------------------------------------------------

def sort_rank_distinct(keys: np.ndarray):
    """Rank of each of ``keys`` (an object array of DISTINCT str) in
    code-point order, through the UTF-32 sort of ``strcodec.cpp``; None
    when two keys share a padded UTF-32 form (a trailing NUL), which the
    caller ranks another way."""
    lib = load("strcodec")
    k = len(keys)
    u = keys.astype("U")
    width = max(u.dtype.itemsize // 4, 1)
    chars = np.ascontiguousarray(u).view(np.uint32).reshape(k, width)
    codes = np.empty(k, dtype=np.int32)
    dict_row = np.empty(k, dtype=np.int64)
    ndict = lib.encode_sorted_dict_u32(_ptr(chars), k, width, _ptr(codes),
                                       _ptr(dict_row))
    if ndict != k:
        return None
    return codes


# -- parquet_host -------------------------------------------------------------

def snappy_decompress(buf) -> np.ndarray:
    """A raw Snappy block's bytes, as a uint8 array (no copy out)."""
    lib = load("parquet_host")
    src = _u8(buf)
    want = lib.srt_snappy_uncompressed_length(_ptr(src), len(src))
    if want < 0:
        raise ValueError("corrupt Snappy block (bad length preamble)")
    out = np.empty(max(want, 1), dtype=np.uint8)
    got = lib.srt_snappy_decompress(_ptr(src), len(src), _ptr(out), want)
    if got != want:
        raise ValueError("corrupt Snappy block")
    return out[:want]


def snappy_compress(buf) -> bytes:
    lib = load("parquet_host")
    src = _u8(buf)
    out = np.empty(lib.srt_snappy_max_compressed_length(len(src)),
                   dtype=np.uint8)
    n = lib.srt_snappy_compress(_ptr(src), len(src), _ptr(out))
    return out[:n].tobytes()


def rle_decode(buf, bit_width: int, count: int) -> Tuple[np.ndarray, int]:
    """``count`` values of the RLE / bit-packed hybrid in ``buf``: (int32
    values, bytes consumed)."""
    lib = load("parquet_host")
    src = _u8(buf)
    out = np.empty(count, dtype=np.int32)
    used = lib.srt_rle_decode(_ptr(src), len(src), int(bit_width), count,
                              _ptr(out))
    if used < 0:
        raise ValueError(f"corrupt RLE/bit-packed data ({count} values of "
                         f"{bit_width} bits)")
    return out, int(used)


def rle_encode(values: np.ndarray, bit_width: int) -> bytes:
    lib = load("parquet_host")
    vals = np.ascontiguousarray(values, dtype=np.int32)
    n = len(vals)
    cap = 16 + n * 5 + ((n + 7) // 8) * (bit_width + 10)
    out = np.empty(cap, dtype=np.uint8)
    got = lib.srt_rle_encode(_ptr(vals), n, int(bit_width), _ptr(out), cap)
    if got < 0:
        raise ValueError("RLE encode overflow")
    return out[:got].tobytes()


def byte_array_unpack(buf, count: int
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
    """``count`` PLAIN BYTE_ARRAY values: (contiguous uint8 data, int64
    offsets[count + 1], bytes consumed)."""
    lib = load("parquet_host")
    src = _u8(buf)
    data = np.empty(max(len(src), 1), dtype=np.uint8)
    offsets = np.empty(count + 1, dtype=np.int64)
    used = lib.srt_byte_array_unpack(_ptr(src), len(src), count,
                                     _ptr(data), _ptr(offsets))
    if used < 0:
        raise ValueError(f"corrupt PLAIN BYTE_ARRAY data ({count} values)")
    return data[:offsets[-1]], offsets, int(used)


def byte_array_pack(data: np.ndarray, offsets: np.ndarray) -> bytes:
    lib = load("parquet_host")
    data = np.ascontiguousarray(data, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    count = len(offsets) - 1
    out = np.empty(max(4 * count + int(offsets[-1]), 1), dtype=np.uint8)
    n = lib.srt_byte_array_pack(_ptr(data) if len(data) else 0,
                                _ptr(offsets), count, _ptr(out))
    return out[:n].tobytes()


#: value widths of the fixed-width groups strings decode in; longer values
#: (few, since their bytes are bounded) decode one by one
_WIDTHS = (8, 16, 32, 64, 128, 256, 1024)


def strings_from(data: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """An object array of str from UTF-8 values ``data[offsets[i]:
    offsets[i + 1]]``, with no Python loop over the values: each width
    group is padded into fixed-width rows in C++, viewed as numpy bytes
    and decoded in C (ASCII by a cast, else ``np.char.decode``)."""
    lib = load("parquet_host")
    n = len(offsets) - 1
    out = np.empty(n, dtype=object)
    if n == 0:
        return out
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if len(data) == 0:
        out[:] = ""
        return out
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lens = np.diff(offsets)
    lo = -1
    flags = np.zeros(2, dtype=np.int32)
    for w in _WIDTHS + (None,):
        sel = lens > lo if w is None else (lens > lo) & (lens <= w)
        rows = np.flatnonzero(sel).astype(np.int64)
        lo = w
        if not len(rows):
            continue
        if w is None:
            # the few values past the widest group (their bytes bound
            # their count)
            out[rows] = [bytes(data[offsets[r]:offsets[r + 1]])
                         .decode("utf-8") for r in rows]
            continue
        mat = np.empty((len(rows), w), dtype=np.uint8)
        if lib.srt_pad_rows(_ptr(data), _ptr(offsets), _ptr(rows),
                            len(rows), w, _ptr(mat), _ptr(flags)) < 0:
            raise ValueError(f"a value wider than its {w}-byte group")
        if flags[1]:
            # a value ending in a zero byte: a fixed-width row drops it
            out[rows] = [bytes(data[offsets[r]:offsets[r + 1]])
                         .decode("utf-8") for r in rows]
            continue
        raw = mat.view(f"S{w}").reshape(-1)
        if flags[0]:
            out[rows] = np.char.decode(raw, "utf-8").astype(object)
        else:
            out[rows] = raw.astype(f"U{w}").astype(object)
    return out


def delta_binary_decode(buf, count: int) -> Tuple[np.ndarray, int]:
    """``count`` DELTA_BINARY_PACKED values: (int64 values, bytes
    consumed)."""
    lib = load("parquet_host")
    src = _u8(buf)
    out = np.empty(max(count, 1), dtype=np.int64)
    used = lib.srt_delta_binary_decode(_ptr(src), len(src), count, _ptr(out))
    if used < 0:
        raise ColumnarProcessingError(
            f"corrupt DELTA_BINARY_PACKED data ({count} values)")
    return out[:count], int(used)


def delta_byte_array(prefix: np.ndarray, sdata: np.ndarray,
                     soffsets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """DELTA_BYTE_ARRAY values from their prefix lengths and suffixes:
    (contiguous uint8 data, int64 offsets)."""
    lib = load("parquet_host")
    prefix = np.ascontiguousarray(prefix, dtype=np.int64)
    sdata = np.ascontiguousarray(sdata, dtype=np.uint8)
    soffsets = np.ascontiguousarray(soffsets, dtype=np.int64)
    n = len(prefix)
    offsets = np.empty(n + 1, dtype=np.int64)
    cap = int(prefix.sum()) + len(sdata)
    out = np.empty(max(cap, 1), dtype=np.uint8)
    got = lib.srt_delta_byte_array(
        _ptr(prefix), n, _ptr(sdata) if len(sdata) else 0, _ptr(soffsets),
        _ptr(out), cap, _ptr(offsets))
    if got < 0:
        raise ColumnarProcessingError("corrupt DELTA_BYTE_ARRAY data")
    return out[:got], offsets


# -- text_host's span helpers -------------------------------------------------

def span_dedup(data: np.ndarray, offsets: np.ndarray,
               idx: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The distinct byte values among the spans ``idx`` (all of them by
    default) of ``data[offsets[i]:offsets[i + 1]]``, by a hash in C++:
    (int64 code of each span of ``idx`` in first-seen order, the int64
    position in ``idx`` of each code's first span)."""
    lib = load("text_host")
    data = np.ascontiguousarray(data, dtype=np.uint8)
    buf = data if len(data) else np.zeros(1, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    idx = np.arange(len(offsets) - 1, dtype=np.int64) if idx is None \
        else np.ascontiguousarray(idx, dtype=np.int64)
    n = len(idx)
    codes = np.empty(max(n, 1), dtype=np.int64)
    first = np.empty(max(n, 1), dtype=np.int64)
    k = lib.srt_span_dedup(_ptr(buf), _ptr(offsets), _ptr(idx), n,
                           _ptr(codes), _ptr(first))
    return codes[:n], first[:k]


def gather_spans(data: np.ndarray, offsets: np.ndarray, idx: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Values ``idx`` of (data, offsets) copied contiguously: (data,
    offsets[len(idx) + 1])."""
    lib = load("text_host")
    data = np.ascontiguousarray(data, dtype=np.uint8)
    buf = data if len(data) else np.zeros(1, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    total = int((offsets[idx + 1] - offsets[idx]).sum()) if len(idx) else 0
    out = np.empty(max(total, 1), dtype=np.uint8)
    out_off = np.empty(len(idx) + 1, dtype=np.int64)
    out_off[0] = 0
    if len(idx):
        lib.srt_gather_spans(_ptr(buf), _ptr(offsets), _ptr(idx), len(idx),
                             _ptr(out), _ptr(out_off))
    return out[:total], out_off


# -- zstd_host ----------------------------------------------------------------

_ZSTD_DICTIONARY = ("a frame needs a dictionary, which the port's decoder "
                    "does not take")


def zstd_decompress(buf, size: Optional[int] = None) -> np.ndarray:
    """The bytes of the Zstandard frame(s) in ``buf``, as a uint8 array.
    ``size`` bounds the output where the caller knows it (an ORC chunk,
    a Parquet page); otherwise the frames' content sizes do, or the
    buffer grows until it holds the output. A corrupt, truncated or
    dictionary frame raises ColumnarProcessingError."""
    lib = load("zstd_host")
    src = _u8(buf)
    if len(src) == 0:
        raise ColumnarProcessingError("empty Zstandard input")
    cap = size
    if cap is None:
        stated = lib.srt_zstd_content_size(_ptr(src), len(src))
        if stated < -1:
            raise ColumnarProcessingError(
                "Zstandard decode failed: " + (
                    _ZSTD_DICTIONARY if stated == -5
                    else "corrupt Zstandard frame header"))
        cap = stated if stated >= 0 else max(4 * len(src), 1 << 16)
    while True:
        out = np.empty(max(cap, 1), dtype=np.uint8)
        got = lib.srt_zstd_decompress(_ptr(src), len(src), _ptr(out), cap)
        if got >= 0:
            return out[:got]
        if got == -2 and size is None:
            cap *= 2
            continue
        reason = {-2: "output larger than its stated size",
                  -3: _ZSTD_DICTIONARY}.get(got, "corrupt or truncated data")
        raise ColumnarProcessingError(f"Zstandard decode failed: {reason}")


def zstd_compress(buf, checksum: bool = False) -> bytes:
    """One Zstandard frame holding ``buf`` (its content size stated)."""
    lib = load("zstd_host")
    src = _u8(buf)
    cap = lib.srt_zstd_compress_bound(len(src))
    out = np.empty(cap, dtype=np.uint8)
    n = lib.srt_zstd_compress(_ptr(src) if len(src) else 0, len(src),
                              _ptr(out), cap, int(checksum))
    if n < 0:
        raise ColumnarProcessingError("Zstandard encode failed")
    return out[:n].tobytes()


# -- lz4_host -----------------------------------------------------------------

def lz4_decompress(buf, size: int) -> np.ndarray:
    """One raw LZ4 block of at most ``size`` bytes, as a uint8 array."""
    lib = load("lz4_host")
    src = _u8(buf)
    out = np.empty(max(size, 1), dtype=np.uint8)
    got = lib.srt_lz4_decompress(_ptr(src) if len(src) else 0, len(src),
                                 _ptr(out), size)
    if got < 0:
        raise ColumnarProcessingError("corrupt or truncated LZ4 block")
    return out[:got]


def lz4_compress(buf) -> bytes:
    lib = load("lz4_host")
    src = _u8(buf)
    out = np.empty(lib.srt_lz4_compress_bound(len(src)), dtype=np.uint8)
    n = lib.srt_lz4_compress(_ptr(src) if len(src) else 0, len(src),
                             _ptr(out), len(out))
    if n < 0:
        raise ColumnarProcessingError("LZ4 encode failed")
    return out[:n].tobytes()


# -- orc_host -----------------------------------------------------------------

def _orc_fail(what: str, count: int):
    return ColumnarProcessingError(f"corrupt or truncated ORC {what} stream "
                                   f"({count} values)")


def orc_byte_rle_decode(buf, count: int) -> np.ndarray:
    lib = load("orc_host")
    src = _u8(buf)
    out = np.empty(max(count, 1), dtype=np.uint8)
    if lib.srt_orc_byte_rle_decode(_ptr(src) if len(src) else 0, len(src),
                                   count, _ptr(out)) < 0:
        raise _orc_fail("byte RLE", count)
    return out[:count]


def orc_int_rle_decode(buf, count: int, version: int, signed: bool
                       ) -> np.ndarray:
    """``count`` integers of an RLE v1 or v2 stream, as int64."""
    lib = load("orc_host")
    src = _u8(buf)
    out = np.empty(max(count, 1), dtype=np.int64)
    if lib.srt_orc_int_rle_decode(_ptr(src) if len(src) else 0, len(src),
                                  count, int(version), int(signed),
                                  _ptr(out)) < 0:
        raise _orc_fail(f"integer RLE v{version}", count)
    return out[:count]


def orc_varint128_decode(buf, count: int) -> Tuple[np.ndarray, np.ndarray]:
    """``count`` zigzag varints of up to 128 bits: (low uint64 words, high
    int64 words)."""
    lib = load("orc_host")
    src = _u8(buf)
    lo = np.empty(max(count, 1), dtype=np.uint64)
    hi = np.empty(max(count, 1), dtype=np.int64)
    if lib.srt_orc_varint128_decode(_ptr(src) if len(src) else 0, len(src),
                                    count, _ptr(lo), _ptr(hi)) < 0:
        raise _orc_fail("DECIMAL varint", count)
    return lo[:count], hi[:count]


def orc_byte_rle_encode(values: np.ndarray) -> bytes:
    lib = load("orc_host")
    v = np.ascontiguousarray(values, dtype=np.uint8)
    cap = len(v) + len(v) // 128 + 16
    out = np.empty(cap, dtype=np.uint8)
    n = lib.srt_orc_byte_rle_encode(_ptr(v) if len(v) else 0, len(v),
                                    _ptr(out), cap)
    if n < 0:
        raise ColumnarProcessingError("ORC byte RLE encode overflow")
    return out[:n].tobytes()


def orc_int_rle_encode(values: np.ndarray, signed: bool) -> bytes:
    """An integer RLE v2 stream of ``values``."""
    lib = load("orc_host")
    v = np.ascontiguousarray(values, dtype=np.int64)
    cap = 9 * len(v) + 4 * (len(v) // 8 + 1) + 16
    out = np.empty(cap, dtype=np.uint8)
    n = lib.srt_orc_int_rle_encode(_ptr(v) if len(v) else 0, len(v),
                                   int(signed), _ptr(out), cap)
    if n < 0:
        raise ColumnarProcessingError("ORC integer RLE encode overflow")
    return out[:n].tobytes()


def orc_varint128_encode(lo: np.ndarray, hi: np.ndarray) -> bytes:
    lib = load("orc_host")
    lo = np.ascontiguousarray(lo, dtype=np.uint64)
    hi = np.ascontiguousarray(hi, dtype=np.int64)
    cap = 19 * len(lo) + 16
    out = np.empty(cap, dtype=np.uint8)
    n = lib.srt_orc_varint128_encode(_ptr(lo) if len(lo) else 0,
                                     _ptr(hi) if len(hi) else 0, len(lo),
                                     _ptr(out), cap)
    if n < 0:
        raise ColumnarProcessingError("ORC varint encode overflow")
    return out[:n].tobytes()
