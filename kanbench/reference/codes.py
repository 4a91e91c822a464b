"""Residue and base codes, the genetic code and kmer keys of the reference.

Written from the published definitions, not from the program: NCBI
translation table 11 (its amino acids are table 1's), the start codons the
SEEDtk tool extends to (ttg, ctg, atg), protein letters as 0..25 for A..Z,
and a kmer's key as its letters packed 5 bits each, the first letter in the
lowest bits.  The same key is what a signature table file holds for a kmer
(its low 30 bits one word, the rest the other), so tables the benchmark makes
can be handed to the program as they are.
"""

from __future__ import annotations

import numpy as np

AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"
BITS = 5                           # bits a residue in a packed key
LOW_RESIDUES = 6                   # residues in a key's low 32-bit word

# NCBI table 1 amino acids, codons in t, c, a, g order (TTT .. GGG)
TABLE_11 = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
STARTS_11 = ("ttg", "ctg", "atg")
BASES = "tcag"

STOP = ord("*") - ord("A") + 32    # letter codes past Z mark a stop ...
OTHER = STOP + 1                   # ... and an ambiguous codon or residue


def letter_codes(text: str) -> np.ndarray:
    """A protein as letter codes: A..Z 0..25, '*' STOP, anything else
    OTHER."""
    raw = np.frombuffer(text.encode("ascii", "replace"), np.uint8)
    lut = np.full(256, OTHER, np.uint8)
    lut[65:91] = np.arange(26)
    lut[97:123] = np.arange(26)
    lut[ord("*")] = STOP
    return lut[raw]


def base_codes(dna: str) -> np.ndarray:
    """DNA as base codes: t c a g 0..3, anything else 4."""
    raw = np.frombuffer(dna.encode("ascii", "replace"), np.uint8)
    lut = np.full(256, 4, np.uint8)
    for i, b in enumerate(BASES):
        lut[ord(b)] = lut[ord(b.upper())] = i
    return lut[raw]


def reverse_complement_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in base codes (t<->a, c<->g; 4 stays 4)."""
    comp = np.array([2, 3, 0, 1, 4], np.uint8)
    return comp[codes[::-1]]


def codon_ids(codes: np.ndarray, start: int) -> np.ndarray:
    """Codon ids (0..63, 64 for a codon with a base other than tcag) of the
    whole codons from 0-based ``start``."""
    n = (len(codes) - start) // 3
    c = codes[start: start + 3 * n].reshape(n, 3).astype(np.int64)
    ids = c[:, 0] * 16 + c[:, 1] * 4 + c[:, 2]
    return np.where((c < 4).all(1), ids, 64)


def codon_letters() -> np.ndarray:
    """Codon id -> letter code (64: OTHER, as 'X' is)."""
    lut = letter_codes(TABLE_11 + "X")
    return lut


def codon_classes() -> tuple[np.ndarray, np.ndarray]:
    """Codon id -> (is a stop, is a start) under table 11."""
    stop = np.array([a == "*" for a in TABLE_11] + [False])
    start = np.zeros(65, bool)
    for codon in STARTS_11:
        start[BASES.index(codon[0]) * 16 + BASES.index(codon[1]) * 4
              + BASES.index(codon[2])] = True
    return stop, start


def pack_windows(letters: np.ndarray, k: int) -> np.ndarray:
    """Every length-k window's key of a letter-code array, as uint64: window
    i is ``letters[i:i+k]``, letter j at bits 5j."""
    n = len(letters) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    c = letters.astype(np.uint64)
    key = np.zeros(n, np.uint64)
    for j in range(k):
        key |= c[j: j + n] << np.uint64(BITS * j)
    return key


def window_has(mask: np.ndarray, k: int) -> np.ndarray:
    """Whether each length-k window of a bool array holds a True."""
    n = len(mask) - k + 1
    if n <= 0:
        return np.zeros(0, bool)
    out = np.zeros(n, bool)
    for j in range(k):
        out |= mask[j: j + n]
    return out


def split_key(key: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A key as its two 32-bit words (low 6 residues, the rest): the
    layout of a signature table's key columns."""
    key = np.asarray(key, np.uint64)
    lo = (key & np.uint64((1 << (BITS * LOW_RESIDUES)) - 1)).astype(
        np.uint32)
    hi = (key >> np.uint64(BITS * LOW_RESIDUES)).astype(np.uint32)
    return lo, hi


def lossy_key(key: np.ndarray) -> np.ndarray:
    """A 32-bit hash of each key: the control's lossy key (two kmers that
    share it are taken as one)."""
    with np.errstate(over="ignore"):
        h = np.asarray(key, np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    return h >> np.uint64(32)
