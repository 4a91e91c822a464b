"""Host-side string ↔ integer-array codecs (NumPy).

A copy of the reference package's ``ops/encode.py``, holding what the port
uses.  Sequences are encoded once on the host and kept as integer tensors
on the device.  Code assignments are chosen so device-side translation,
packing and filtering are pure arithmetic:

* Protein codes: 'A'..'Z' → 0..25 (case-insensitive), '*' → 26 (stop),
  anything else → 27, PAD → 31.  'X' is therefore code 23; the ambiguity
  filters (KmerReference.java:139,190) test codes, not characters.
* DNA codes: t,c,a,g → 0,1,2,3 (NCBI codon-table order, matching
  genome.dna), any IUPAC-ambiguous base → 4, PAD → 5.  Reverse complement
  in code space is ``code XOR 2`` for codes < 4.
"""

from __future__ import annotations

import numpy as np

# ----- protein codes -----

PROT_STOP = 26      # '*'
PROT_OTHER = 27     # any character outside A-Z / '*'
PROT_PAD = 31
PROT_X = ord("X") - ord("A")  # 23

_PROT_LUT = np.full(256, PROT_OTHER, dtype=np.uint8)
for _i in range(26):
    _PROT_LUT[ord("A") + _i] = _i
    _PROT_LUT[ord("a") + _i] = _i
_PROT_LUT[ord("*")] = PROT_STOP

_PROT_CHARS = np.frombuffer(
    (bytes(range(ord("A"), ord("Z") + 1)) + b"*????" + b"?"), dtype=np.uint8)
# index 0..25 = A..Z, 26 = '*', 27..31 = '?'


def encode_protein(s: str) -> np.ndarray:
    """Protein string → uint8 code array."""
    raw = np.frombuffer(s.encode("ascii", errors="replace"), dtype=np.uint8)
    return _PROT_LUT[raw]


def decode_protein(codes: np.ndarray) -> str:
    """uint8 code array → protein string (A..Z / '*' / '?')."""
    return _PROT_CHARS[np.asarray(codes)].tobytes().decode("ascii")


# ----- DNA codes -----

DNA_AMBIG = 4
DNA_PAD = 5

_DNA_LUT = np.full(256, DNA_AMBIG, dtype=np.uint8)
for _c, _v in (("t", 0), ("c", 1), ("a", 2), ("g", 3), ("u", 0)):
    _DNA_LUT[ord(_c)] = _v
    _DNA_LUT[ord(_c.upper())] = _v

_DNA_CHARS = np.frombuffer(b"tcagnn", dtype=np.uint8)


def encode_dna(s: str) -> np.ndarray:
    """DNA string → uint8 code array (IUPAC ambiguity folded to 4)."""
    raw = np.frombuffer(s.encode("ascii", errors="replace"), dtype=np.uint8)
    return _DNA_LUT[raw]


def decode_dna(codes: np.ndarray) -> str:
    """uint8 DNA code array → lower-case string (ambiguity and PAD → n)."""
    return _DNA_CHARS[np.asarray(codes)].tobytes().decode("ascii")


def reverse_complement_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space: complement = code ^ 2 for ACGT,
    ambiguous stays ambiguous."""
    comp = np.where(codes < 4, codes ^ 2, codes)
    return comp[::-1].copy()
