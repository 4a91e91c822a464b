"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, ``_build/libkan_cuda.so``, at first use;
``ctypes`` loads it, the way the port's ``native`` package builds and
loads its host library.  No PyTorch header is compiled, so a build takes
seconds.  Every C entry point takes raw device pointers and the CUDA
stream as ``c_void_p`` and returns ``cudaGetLastError()``; :func:`check`
turns a non-zero code into an exception.  ``build`` and ``load`` also
take another source tree and library path, so that a measurement can
load a second build (another commit's) beside this one.

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


def _files(src_dir: str, *suffixes: str) -> list[str]:
    return sorted(os.path.join(src_dir, f) for f in os.listdir(src_dir)
                  if f.endswith(suffixes))


def _sources(src_dir: str | None = None) -> list[str]:
    """The translation units nvcc compiles (the ``.cu`` files)."""
    return _files(src_dir or SRC_DIR, ".cu")


def _inputs(src_dir: str | None = None) -> list[str]:
    """Every file the library is built from: the sources and the
    ``.cuh`` headers they include."""
    return _files(src_dir or SRC_DIR, ".cu", ".cuh")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _stale(src_dir: str | None = None, lib_path: str | None = None) -> bool:
    lib_path = lib_path or LIB_PATH
    if not os.path.exists(lib_path):
        return True
    built = os.path.getmtime(lib_path)
    return any(os.path.getmtime(s) > built for s in _inputs(src_dir))


def build(src_dir: str | None = None, lib_path: str | None = None) -> str:
    """Compile ``src_dir/*.cu`` into the shared library ``lib_path`` if it
    is missing or older than a source or header: one nvcc per source, all
    started together, then one link.  Returns nvcc's output (with ptxas's
    register and shared-memory report), empty when the library was up to
    date.  Raises on failure."""
    src_dir, lib_path = src_dir or SRC_DIR, lib_path or LIB_PATH
    if not _stale(src_dir, lib_path):
        return ""
    build_dir = os.path.dirname(lib_path)
    os.makedirs(build_dir, exist_ok=True)
    nvcc = _nvcc()
    sources = _sources(src_dir)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o")
                for s in sources]
        procs = [subprocess.Popen(
            [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        output = "".join(p.communicate()[0] for p in procs)
        failed = [os.path.basename(s)
                  for s, p in zip(sources, procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{output}")
        lib_tmp = os.path.join(tmp, os.path.basename(lib_path))
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", lib_tmp,
                               *objs], capture_output=True, text=True)
        output += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{output}")
        os.replace(lib_tmp, lib_path)   # atomic: no reader sees a partial .so
    return output


_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64

# every C entry point the port calls: name → argument types (all return
# the CUDA error code as an int)
ENTRY_POINTS = {
    "kan_contig_scan": [_P, _I64, _P, _I32, _P, _P, _P, _P],
    "kan_probe_wide": [_P, _I64, _P, _P, _P, _I64, ctypes.c_uint32, _I32,
                       _P, _P],
    "kan_apply_rows": [_P, _I64, _P, _P, _I64, _I64, _I32, _I32,
                       ctypes.c_uint32, _I32, _I32, _P, _P, _P],
    "kan_hash_commons": [_P, _I64, _I32, _P, _I64, _P, _P, _P, _P, _I64,
                         _I64, _I64, _P, _P, _P],
    "kan_hash_best": [_P, _I64, _I64, _P, _P, _P, _I64, _P, _P, _P, _P,
                      _I64, _P],
    "kan_flat_unanimous": [_P, _I64, _I32, _P, _I64, _P, _P, _P, _I64, _I32,
                           _I32, _I64, _I32, _P, _P, _P, _P],
    "kan_flat_weighted": [_P, _I64, _I32, _P, _I64, _P, _P, _P, _I64, _I32,
                          _I32, _I64, _I64, _I64, ctypes.c_float, _P, _P, _P,
                          _P, _P, _P],
    "kan_dna_probe": [_P, _I64, _I32, _P, _P, _I64, _I32, _P, _P],
    "kan_dna_probe_filtered": [_P, _I64, _I32, _P, _I64, _P, _P, _I64, _I32,
                               _P, _P],
    "kan_probe_keys": [_P, _I64, _I32, _P, _I64, _P, _P, _P, _I64, _P, _P],
    "kan_table_build": [_P, _P, _P, _I64, _I64, ctypes.c_uint32, _I32, _I32,
                        _I32, _I32, _P, _I64, _P, _P, _P, _P],
    "kan_union_dedupe": [_P, _P, _I64, _P, _I64, _P, _P],
    "kan_union_build": [_P, _I64, _I64, _P, _P, _P],
}


def load(lib_path: str) -> ctypes.CDLL:
    """Load a built kernel library and declare its C entry points.  An
    entry point the library lacks (a build of an older tree, timed beside
    this one) is left undeclared."""
    handle = ctypes.CDLL(lib_path)
    for name, argtypes in ENTRY_POINTS.items():
        if hasattr(handle, name):
            fn = getattr(handle, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
    handle.kan_cuda_error_string.restype = ctypes.c_char_p
    handle.kan_cuda_error_string.argtypes = [ctypes.c_int]
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        build()
        _lib = load(LIB_PATH)
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
