"""Per-(block, segment) partial sums (port of
``spark_rapids_tpu/kernels/segreduce.py::onehot_partials``).

The TPU kernel built each row block's one-hot in VMEM and contracted it on
the MXU. The CUDA kernel (``csrc/segreduce.cu``) keeps the same function
and output shape, with a fixed reduction order and no float atomics, so
its bits repeat from run to run. ``fused_minmax``, the module's other TPU
kernel, is not ported yet (MIN/MAX aggregates are off the q1 path).
"""

from __future__ import annotations

import ctypes

import torch

from spark_rapids_tpu_torch.kernels import (
    check_launch,
    require_contiguous,
    require_cuda,
    stream_handle,
)

#: block rows the CUDA kernel takes at most (128 threads x 8 rows)
MAX_BLOCK = 1024
#: segments the CUDA kernel takes at most (ops/segsum.MATMUL_MAX_SEGMENTS)
MAX_SEGMENTS = 32


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
    from spark_rapids_tpu_torch.kernels.build import load_library
    lib = load_library("segreduce")
    fn = lib.srt_onehot_partials
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p]
    rc = fn(x.data_ptr(), gid.data_ptr(), out.data_ptr(), nb, nseg, c, block,
            x.stride(0), x.stride(1), int(x.dtype == torch.float64),
            stream_handle(x))
    check_launch(lib, rc, "onehot_partials")
    onehot_partials.launches += 1
    return out


onehot_partials.launches = 0
