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
  packer, and the padding of values into fixed-width rows
  (``io/parquet_format.py``).

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
from typing import Dict, Iterable, Tuple

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
SOURCES = ("strcodec", "parquet_host")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
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


if __name__ == "__main__":
    for src, secs in build().items():
        print(f"built {src}.cpp in {secs:.1f} s into {BUILD_DIR}")
