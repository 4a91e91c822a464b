"""Genetic-code translation of DNA code arrays (plain PyTorch).

Counterpart of ``kmers_anno_tpu/ops/translate.py``: a 65-entry LUT in
protein-code space over ``c0*16 + c1*4 + c2`` (NCBI base order), with any
ambiguous base mapping the codon to LUT index 64.  The LUT is built from
``genome.dna.GeneticCode`` so host and device translation cannot disagree.
"""

from __future__ import annotations

import numpy as np
import torch

from ..host import GeneticCode, encode_protein

_LUT_CACHE: dict[int, np.ndarray] = {}


def codon_lut(gc: int) -> np.ndarray:
    """65-entry uint8 LUT in *protein-code* space (index 64 = ambiguous)."""
    if gc not in _LUT_CACHE:
        ascii_lut = GeneticCode.get(gc).aa_lut()
        _LUT_CACHE[gc] = encode_protein(ascii_lut.tobytes().decode("ascii"))
    return _LUT_CACHE[gc]


def sliding_translate(dna_codes: torch.Tensor,
                      lut: torch.Tensor) -> torch.Tensor:
    """Translate every codon start position of a DNA code array.

    dna_codes: (N,) uint8 (0..3 = t,c,a,g; >=4 ambiguous/pad)
    lut:       (65,) protein-code LUT on the same device
    returns:   (N-2,) protein codes of ``lut``'s dtype; position i is the
               amino acid of the codon starting at 0-based position i.
    """
    c = dna_codes.to(torch.int64)
    c0, c1, c2 = c[:-2], c[1:-1], c[2:]
    valid = (c0 < 4) & (c1 < 4) & (c2 < 4)
    idx = torch.where(valid, c0 * 16 + c1 * 4 + c2, 64)
    return lut[idx]
