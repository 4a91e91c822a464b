"""kmers_anno_tpu_torch — the PyTorch + CUDA port of ``kmers_anno_tpu``.

The JAX package beside this one is the reference: this package runs the
same algorithms on ``torch`` tensors and answers the same inputs with the
same outputs.  Plain tensor code is PyTorch; every TPU kernel on a ported
path is a CUDA C++ kernel written for Hopper (``csrc/``), built with
``nvcc`` at first use and bound with ``ctypes`` (``kernels``).  Each kernel
keeps a plain-PyTorch version beside it, which a wrapper takes only for a
tensor on the CPU.

Ported so far: the ORF-projection engine (``kmers`` / ``batch``) with its
two routes, which the input picks (the fused union probe + device window
scan; the per-close-genome RLE probe where the input does not fit it), and
``build`` / ``apply`` for protein signature tables.  The host side keeps
its own copies of the reference's host modules, in the reference's layout:
``genome/`` (GTO model, locations, DNA translation, roles, sources),
``ops/encode``, ``ops/orf``, ``ops/hashing``, ``commands/base``,
``reports/``, ``utils/`` and ``native/`` (the C++ host library).  This
package imports neither jax nor ``kmers_anno_tpu``.
"""

__version__ = "0.1.0"


def _tune_malloc() -> None:
    """Keep large allocations on the heap instead of per-call mmap/munmap.

    The pipelines cycle many multi-MB NumPy buffers (row batches, probe
    tables, flat token streams).  glibc serves those via mmap and unmaps
    them on free, so every cycle refaults every page.  Raising
    M_MMAP_THRESHOLD/M_TRIM_THRESHOLD makes the heap retain the pages (a
    one-time cost).
    """
    import ctypes
    import sys
    if not sys.platform.startswith("linux"):
        return
    try:
        libc = ctypes.CDLL(None)
        libc.mallopt(-3, 1 << 30)   # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)   # M_TRIM_THRESHOLD
    except (OSError, AttributeError):
        pass


_tune_malloc()
