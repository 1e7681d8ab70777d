"""Build the CUDA kernels under ``csrc/`` into shared libraries with a
plain C interface, and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with one ``nvcc`` process into
``_build/<name>-<hash>.so`` beside the package (the directory is
git-ignored); the hash covers the source text and the flags, so an edited
source never loads a stale library. All sources build in parallel. The
build happens at first use, or ahead of it with::

    python -m spark_rapids_tpu_torch.kernels.build

which also prints what ``ptxas -v`` reports for every kernel (registers,
shared memory, spills). A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
#: where the libraries go: the package's git-ignored ``_build/``, or
#: ``$SRT_KERNEL_BUILD_DIR`` (a fresh directory makes a process build
#: every kernel again, as a first run on a new machine does)
BUILD_DIR = Path(os.environ.get("SRT_KERNEL_BUILD_DIR") or
                 Path(__file__).resolve().parent.parent / "_build")
SOURCES = ("segreduce", "minmax", "compact", "sort", "hashprobe",
           "dec128div")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels build from source at first use")


def _target(name: str) -> Path:
    text = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no current library, all at
    once, one nvcc each. Returns {name: ptxas report} for the sources
    compiled by this call."""
    todo = {n: _target(n) for n in names if not _target(n).is_file()}
    if not todo:
        return {}
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    reports, failures = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu (exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, target)
        reports[name] = out
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    # the query's "traces" and kernelCompileTime (dispatch.py)
    from spark_rapids_tpu_torch.dispatch import note_kernel_build
    note_kernel_build(len(reports), time.perf_counter() - t0)
    return reports


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            lib.srt_error_string.restype = ctypes.c_char_p
            lib.srt_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
        return lib


if __name__ == "__main__":
    t0 = time.perf_counter()
    for src, report in build().items():
        print(f"== {src}.cu")
        print(report.strip())
    print(f"build {time.perf_counter() - t0:.1f}s into {BUILD_DIR}")
