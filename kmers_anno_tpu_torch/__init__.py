"""kmers_anno_tpu_torch — the PyTorch + CUDA port of ``kmers_anno_tpu``.

The JAX package beside this one is the reference: this package runs the
same algorithms on ``torch`` tensors and answers the same inputs with the
same outputs.  Plain tensor code is PyTorch; every TPU kernel on a ported
path is a CUDA C++ kernel written for Hopper (``csrc/``), built with
``nvcc`` at first use and bound with ``ctypes`` (``kernels``).  Each kernel
keeps a plain-PyTorch version beside it, which a wrapper takes only for a
tensor on the CPU.

Ported so far: the ORF-projection engine (``kmers`` / ``batch``) through
the stream-window index and the per-close-genome probe.  Host-only modules
of the reference (GTO model, locations, ORF scans, the C++ host runtime)
load without jax; the port takes them from ``kmers_anno_tpu`` as they are,
all through ``host``.  This package never imports jax.
"""

__version__ = "0.1.0"
