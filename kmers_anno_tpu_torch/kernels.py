"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, ``_build/libkan_cuda.so``, at first use;
``ctypes`` loads it, the way ``kmers_anno_tpu/native`` builds and loads
its host library.  No PyTorch header is compiled, so a build takes
seconds.  Every C entry point takes raw device pointers and the CUDA
stream as ``c_void_p`` and returns ``cudaGetLastError()``; :func:`check`
turns a non-zero code into an exception.

A build or load failure raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libkan_cuda.so")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[str]:
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith(".cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in _sources())


def build() -> str:
    """Compile ``csrc/*.cu`` into the shared library if it is missing or
    older than a source.  Returns nvcc's output (with ptxas's register and
    shared-memory report), empty when the library was up to date.  Raises
    on failure."""
    if not _stale():
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    output = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{output}")
    os.replace(tmp, LIB_PATH)       # atomic: no reader sees a partial .so
    return output


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        build()
        handle = ctypes.CDLL(LIB_PATH)
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        handle.kan_contig_scan.restype = ctypes.c_int
        handle.kan_contig_scan.argtypes = [p, i64, p, i32, p, p, p, p]
        handle.kan_probe_wide.restype = ctypes.c_int
        handle.kan_probe_wide.argtypes = [
            p, i64, p, p, p, i64, ctypes.c_uint32, i32, p, p]
        handle.kan_cuda_error_string.restype = ctypes.c_char_p
        handle.kan_cuda_error_string.argtypes = [ctypes.c_int]
        _lib = handle
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err:
        msg = lib().kan_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def stream_of(tensor) -> int:
    """The raw ``cudaStream_t`` PyTorch is using on the tensor's device."""
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream
