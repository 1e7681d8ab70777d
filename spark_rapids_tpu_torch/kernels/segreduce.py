"""Segmented reductions: per-(block, segment) partial sums and per-segment
64-bit MIN/MAX (port of ``spark_rapids_tpu/kernels/segreduce.py``:
``onehot_partials`` and ``fused_minmax``).

``onehot_partials``: the TPU kernel built each row block's one-hot in VMEM
and contracted it on the MXU. The CUDA kernel (``csrc/segreduce.cu``)
keeps the same function and output shape, but does work per element that
does not depend on the segment count: it ranks each block's rows by gid
(a stable counting sort in shared memory), stages the columns in that
order and sums each segment's contiguous range in a fixed order, with no
float atomics, so its bits repeat from run to run.

``fused_minmax``: the TPU kernel reduced the two 32-bit limbs of a 64-bit
value in two passes. The CUDA kernel (``csrc/minmax.cu``) reduces native
int64 values, and doubles, as order-preserving unsigned keys with one pass
of 64-bit atomics over runs of 8 rows a thread, and computes what the TPU
kernel and its caller (``ops/segsum.py::segment_minmax_64``) compute
together: Spark's NaN rule, the canonical NaN, ordered signed zeros and
identities in empty segments.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from spark_rapids_tpu_torch.kernels import (
    check_launch,
    record,
    require_contiguous,
    require_cuda,
    stream_handle,
)

#: block rows the CUDA kernel takes at most (256 threads x 4 rows)
MAX_BLOCK = 1024
#: segments the CUDA kernel takes at most (ops/segsum.MATMUL_MAX_SEGMENTS)
MAX_SEGMENTS = 32

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)
#: the magnitude bits of a double
_MAG = _I64_MAX
#: the bits of +inf, and the key of every NaN (the canonical NaN's bits,
#: the greatest key of any double)
_INF_BITS = 0x7FF0_0000_0000_0000
_NAN_KEY = 0x7FF8_0000_0000_0000
#: the key of -inf: its bits 0xfff0... xor _MAG
_NEG_INF_KEY = 0x800F_FFFF_FFFF_FFFF - (1 << 64)


_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
#: the C signature of each library's entry point
_SIGNATURES = {
    "segreduce": ("srt_onehot_partials",
                  [_P, _P, _P, _I64, _I, _I, _I, _I64, _I64, _I, _P]),
    "minmax": ("srt_fused_minmax", [_P, _P, _P, _P, _I64, _I, _I, _I, _P, _P]),
}
_LIBS: Dict[str, ctypes.CDLL] = {}


def _library(name: str) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` with its entry point's argument types
    set, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        from spark_rapids_tpu_torch.kernels.build import load_library
        lib = load_library(name)
        fn_name, argtypes = _SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _LIBS[name] = lib
    return lib


#: fused_minmax's ticket counter of each (device, stream): one int32, zeroed
#: once; each launch leaves it 0
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


def onehot_partials_plain(x: torch.Tensor, gid: torch.Tensor, nseg: int,
                          nb: int, block: int) -> torch.Tensor:
    """The plain version: one index_add_ over block-major segment ids.
    Rows whose gid is outside [0, nseg) add nothing."""
    c = int(x.shape[1])
    g = gid.to(torch.int64)
    blk = torch.arange(nb * block, dtype=torch.int64, device=x.device) // block
    ok = (g >= 0) & (g < nseg)
    out = torch.zeros(nb * nseg, c, dtype=x.dtype, device=x.device)
    out.index_add_(0, (blk * nseg + g)[ok], x[ok])
    return out.reshape(nb, nseg, c)


def onehot_partials(x: torch.Tensor, gid: torch.Tensor, nseg: int, nb: int,
                    block: int) -> torch.Tensor:
    """(nb, nseg, c) partial sums of ``x`` (capacity, c) by row block and
    segment id ``gid`` (capacity,) int32, in ``x``'s dtype (f64 or f32).
    ``x`` may have any element strides: a column-major view
    (``torch.stack(cols).t()``) gives the kernel coalesced loads."""
    if x.ndim != 2 or gid.ndim != 1:
        raise ValueError("onehot_partials: x must be (capacity, c) and gid "
                         "(capacity,)")
    if x.shape[0] != nb * block or gid.shape[0] != nb * block:
        raise ValueError(f"onehot_partials: capacity {x.shape[0]} != "
                         f"{nb} blocks x {block} rows")
    if x.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"onehot_partials: x dtype {x.dtype}")
    if gid.dtype != torch.int32:
        raise TypeError(f"onehot_partials: gid dtype {gid.dtype}")
    if x.device.type == "cpu":
        return onehot_partials_plain(x, gid, nseg, nb, block)
    require_cuda(x, "onehot_partials")
    if gid.device != x.device:
        raise ValueError("onehot_partials: x and gid on different devices")
    require_contiguous(gid, "onehot_partials gid")
    if min(x.stride()) < 1:
        raise ValueError("onehot_partials: x strides must be positive")
    if not 1 <= nseg <= MAX_SEGMENTS:
        raise ValueError(f"onehot_partials: {nseg} segments (kernel takes "
                         f"1..{MAX_SEGMENTS})")
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"onehot_partials: block {block} (kernel takes "
                         f"1..{MAX_BLOCK})")
    c = int(x.shape[1])
    out = torch.empty((nb, nseg, c), dtype=x.dtype, device=x.device)
    lib = _library("segreduce")
    rc = lib.srt_onehot_partials(
        x.data_ptr(), gid.data_ptr(), out.data_ptr(), nb, nseg, c, block,
        x.stride(0), x.stride(1), int(x.dtype == torch.float64),
        stream_handle(x))
    check_launch(lib, rc, "onehot_partials")
    onehot_partials.launches += 1
    record("onehot_partials", (x, gid, nseg, nb, block), out)
    return out


onehot_partials.launches = 0


def _f64_keys(values: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 keys of doubles: b ^ (b < 0 ? _MAG : 0) on
    the bits b (so -0.0 < 0.0), and every NaN the canonical NaN's key."""
    b = values.view(torch.int64)
    keys = b ^ ((b >> 63) & _MAG)
    return torch.where(torch.isnan(values),
                       torch.full((), _NAN_KEY, dtype=torch.int64,
                                  device=values.device), keys)


def _minmax_identity(is_min: bool, f64: bool) -> int:
    """The identity key: a double min's is INT64_MAX, above the NaN key,
    and ends as +inf; a double max's is -inf's key."""
    if is_min:
        return _I64_MAX
    return _NEG_INF_KEY if f64 else _I64_MIN


def fused_minmax_plain(is_min: bool, values: torch.Tensor,
                       valid: torch.Tensor, gid: torch.Tensor,
                       nseg: int) -> torch.Tensor:
    """The plain version: the same keys reduced by one int64
    ``scatter_reduce_`` ("amin"/"amax", include_self=True) over the rows
    that are valid and inside [0, nseg)."""
    f64 = values.dtype == torch.float64
    keys = _f64_keys(values) if f64 else values
    g = gid.to(torch.int64)
    use = valid & (g >= 0) & (g < nseg)
    out = torch.full((nseg,), _minmax_identity(is_min, f64),
                     dtype=torch.int64, device=values.device)
    out.scatter_reduce_(0, g[use], keys[use], "amin" if is_min else "amax",
                        include_self=True)
    if not f64:
        return out
    bits = out ^ ((out >> 63) & _MAG)
    if is_min:
        bits = torch.where(out == _I64_MAX,
                           torch.full((), _INF_BITS, dtype=torch.int64,
                                      device=out.device), bits)
    return bits.view(torch.float64)


def fused_minmax(is_min: bool, values: torch.Tensor, valid: torch.Tensor,
                 gid: torch.Tensor, nseg: int) -> torch.Tensor:
    """(nseg,) per-segment min (``is_min``) or max of ``values`` (n,) int64
    or float64 over the rows with ``valid`` (n,) bool and ``gid`` (n,)
    int32 in [0, nseg), in ``values``' dtype; empty segments hold the
    identity (INT64_MAX/MIN, +inf/-inf). Doubles order as Spark does:
    -0.0 < 0.0, NaN greater than every other value (canonical NaN out)."""
    if values.ndim != 1 or valid.shape != values.shape or \
            gid.shape != values.shape:
        raise ValueError("fused_minmax: values, valid and gid must be (n,)")
    if values.dtype not in (torch.int64, torch.float64):
        raise TypeError(f"fused_minmax: values dtype {values.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"fused_minmax: valid dtype {valid.dtype}")
    if gid.dtype != torch.int32:
        raise TypeError(f"fused_minmax: gid dtype {gid.dtype}")
    if not 1 <= nseg < (1 << 31):
        raise ValueError(f"fused_minmax: {nseg} segments (takes 1..2^31-1)")
    if values.device.type == "cpu":
        return fused_minmax_plain(is_min, values, valid, gid, nseg)
    require_cuda(values, "fused_minmax")
    if valid.device != values.device or gid.device != values.device:
        raise ValueError("fused_minmax: inputs on different devices")
    for t, what in ((values, "values"), (valid, "valid"), (gid, "gid")):
        require_contiguous(t, f"fused_minmax {what}")
    out = torch.empty(nseg, dtype=values.dtype, device=values.device)
    lib = _library("minmax")
    stream = stream_handle(values)
    rc = lib.srt_fused_minmax(
        values.data_ptr(), valid.data_ptr(), gid.data_ptr(), out.data_ptr(),
        int(values.shape[0]), nseg, int(is_min),
        int(values.dtype == torch.float64),
        _ticket(values.device, stream).data_ptr(), stream)
    check_launch(lib, rc, "fused_minmax")
    fused_minmax.launches += 1
    record("fused_minmax", (is_min, values, valid, gid, nseg), out)
    return out


fused_minmax.launches = 0
