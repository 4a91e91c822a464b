"""Protein kmer sets with Jaccard distance, and the drop-last window fence.

A copy of ``kmers_anno_tpu/engine/protein_kmers.py``: importing the
reference's ``engine`` package imports jax, so the port keeps its own copy
and its own ``DROP_LAST_WINDOW`` flag, which the port's ``--dropLast``
sets.  The two flags are independent: code that runs both packages in one
process sets both.
"""

from __future__ import annotations

import numpy as np

# The external ``ProteinKmers`` class that backs the reference tool's
# build/apply paths could not be run, so its window count is unverified.
# This port, like the JAX package, assumes it yields ALL L-K+1 windows; the
# in-repo extractors provably drop the final window (KmerReference.java:
# 134-136).  If the external class drops it too, flip this to True (or pass
# ``--dropLast`` to build/apply): every ProteinKmers-backed window mask
# routes through this flag.
DROP_LAST_WINDOW = False


def set_drop_last(value: bool) -> None:
    """Process-wide override (the ``--dropLast`` CLI flag)."""
    global DROP_LAST_WINDOW
    DROP_LAST_WINDOW = bool(value)


def apply_drop_last(valid: np.ndarray) -> np.ndarray:
    """Drop the final window of every run of valid windows.

    ``valid`` marks kmer-window start positions along the LAST axis (flat
    token stream or row layout).  Valid windows of one protein form one
    contiguous run, so its last window is the run position whose
    successor is invalid; returns valid unchanged (same object) when
    DROP_LAST_WINDOW is off.
    """
    if not DROP_LAST_WINDOW:
        return valid
    nxt = np.zeros_like(valid)
    nxt[..., :-1] = valid[..., 1:]
    return valid & nxt


class ProteinKmers:
    """Kmer set of one protein (all L-K+1 windows, no filtering; with
    DROP_LAST_WINDOW the final window is dropped, see the flag above)."""

    def __init__(self, protein: str, k: int = 8):
        self.protein = protein or ""
        self.k = k
        n = len(self.protein) - k + 1 - int(DROP_LAST_WINDOW)
        self.kmers = {self.protein[i: i + k] for i in range(n)}

    def __iter__(self):
        return iter(self.kmers)

    def __len__(self) -> int:
        return len(self.kmers)

    def distance(self, other: "ProteinKmers") -> float:
        """Jaccard distance: 1 - |common| / |union|; 1.0 when either set
        is empty."""
        if not self.kmers or not other.kmers:
            return 1.0
        common = len(self.kmers & other.kmers)
        union = len(self.kmers) + len(other.kmers) - common
        return 1.0 - common / union
