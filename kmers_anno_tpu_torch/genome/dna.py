"""Genetic-code aware DNA translation (host reference implementation).

Implements the contract of the reference's external ``DnaTranslator``
(sequence jar), inferred from call sites (SURVEY.md §2b):

* ``DnaTranslator(gc)``                  — KmerReference.java:160
* ``translate(seq, frame1based, len)``   — KmerReference.java:184
* ``translate(dna)``                     — AppTest.java:135
* ``pegTranslate(dna, 1, len-3)``        — KmerProcessor.java:304-305 (start-codon
  aware: an alternative start codon in position 1 translates as 'M')

Codon tables are the NCBI translation tables; table 11 (bacteria) shares its
amino-acid assignments with table 1.  Start codons follow the reference's
test oracle (AppTest.java:169: ``CodonSet("ttg", "ctg", "atg")``).

Any codon containing a non-ACGT character translates to ``X``; stop codons
translate to ``*``.  These two symbols drive the ambiguity filters of the
k-mer extractors (KmerReference.java:139, 190 — SURVEY.md §2c Q2).

The device-side equivalent (vectorized codon LUT over uint8 tensors) lives
in ``kmers_anno_tpu_torch.ops.translate``; its LUTs are generated from this
module so host and device can never disagree.  A copy of the reference
package's ``genome/dna.py``.
"""

from __future__ import annotations

import numpy as np

# Base ordering used for codon indexing: t=0, c=1, a=2, g=3 (NCBI convention).
BASES = "tcag"
BASE_INDEX = {b: i for i, b in enumerate(BASES)}
BASE_INDEX.update({b.upper(): i for i, b in enumerate(BASES)})

# NCBI translation table 1 (standard) amino acids, codon order TTT..GGG with
# bases ordered t, c, a, g.
_AA_TABLE_1 = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"


def _codon_index(codon: str) -> int:
    return (BASE_INDEX[codon[0]] * 16 + BASE_INDEX[codon[1]] * 4
            + BASE_INDEX[codon[2]])


def codon_mask(codons) -> np.ndarray:
    """65-entry bool mask of the given codons, indexed as ``aa_lut``
    (b0*16+b1*4+b2; index 64, the ambiguous codon, never set)."""
    mask = np.zeros(65, bool)
    for codon in codons:
        mask[_codon_index(codon)] = True
    return mask


def _table_with(base: str, **overrides: str) -> str:
    aas = list(base)
    for codon, aa in overrides.items():
        aas[_codon_index(codon)] = aa
    return "".join(aas)


# Amino-acid strings per supported genetic code.  Table 11 == table 1 for
# amino acids (they differ only in permitted starts).
_GC_AAS = {
    1: _AA_TABLE_1,
    2: _table_with(_AA_TABLE_1, aga="*", agg="*", ata="M", tga="W"),
    3: _table_with(_AA_TABLE_1, ata="M", ctt="T", ctc="T", cta="T", ctg="T",
                   tga="W"),
    4: _table_with(_AA_TABLE_1, tga="W"),
    11: _AA_TABLE_1,
}

# Start codons.  The reference's own test oracle asserts extension snaps the
# begin to one of ttg/ctg/atg (AppTest.java:169,183-184), so that is the set
# used for Location.extend and pegTranslate start-awareness.
_GC_STARTS = {
    1: ("ttg", "ctg", "atg"),
    2: ("att", "atc", "ata", "atg", "gtg"),
    3: ("ata", "atg", "gtg"),
    4: ("ttg", "ctg", "atg"),
    11: ("ttg", "ctg", "atg"),
}

_COMPLEMENT = str.maketrans("acgtumrwsykvhdbnACGTUMRWSYKVHDBN",
                            "tgcaakywsrmbdhvnTGCAAKYWSRMBDHVN")


def reverse_complement(dna: str) -> str:
    """Reverse complement with IUPAC ambiguity support (Contig.getRSequence)."""
    return dna.translate(_COMPLEMENT)[::-1]


class GeneticCode:
    """A single genetic code: 64-entry codon→AA map plus start/stop sets."""

    _cache: dict[int, "GeneticCode"] = {}

    def __init__(self, gc: int):
        # Unknown codes fail loudly: silently translating with table 1
        # would miscall proteins for e.g. mycoplasma (gc 4 tga=W) inputs
        # declaring a code we never implemented (r2 VERDICT rot).
        if gc not in _GC_AAS:
            raise ValueError(
                f"unsupported genetic code {gc}; supported: "
                f"{sorted(_GC_AAS)}")
        aas = _GC_AAS[gc]
        self.gc = gc
        self.aa_string = aas
        self.starts = frozenset(_GC_STARTS.get(gc, _GC_STARTS[11]))
        self.stops = frozenset(
            BASES[i // 16] + BASES[(i // 4) % 4] + BASES[i % 4]
            for i, aa in enumerate(aas) if aa == "*")
        # codon text (lowercase) -> amino acid
        self.codon_map = {
            BASES[i // 16] + BASES[(i // 4) % 4] + BASES[i % 4]: aa
            for i, aa in enumerate(aas)}

    @classmethod
    def get(cls, gc: int) -> "GeneticCode":
        if gc not in cls._cache:
            cls._cache[gc] = cls(gc)
        return cls._cache[gc]

    def aa_lut(self) -> np.ndarray:
        """65-entry uint8 LUT: index = b0*16+b1*4+b2 (t,c,a,g = 0..3);
        index 64 = ambiguous codon -> 'X'.  Consumed by ops.translate."""
        lut = np.frombuffer(self.aa_string.encode("ascii"), dtype=np.uint8)
        return np.concatenate([lut, np.array([ord("X")], dtype=np.uint8)])

    def is_start(self, codon: str) -> bool:
        return codon.lower() in self.starts

    def is_stop(self, codon: str) -> bool:
        return codon.lower() in self.stops


class DnaTranslator:
    """Host reference translator matching the external DnaTranslator contract."""

    def __init__(self, gc: int = 11):
        self.code = GeneticCode.get(gc)

    def translate(self, dna: str, frame: int = 1, length: int | None = None) -> str:
        """Translate ``length`` base pairs starting at 1-based offset ``frame``.

        Mirrors ``xlator.translate(sequence, frame, sequence.length())`` at
        KmerReference.java:184: the translated region is clipped to the
        sequence end and truncated to whole codons.
        """
        if length is None:
            length = len(dna) - frame + 1
        start = frame - 1
        end = min(start + length, len(dna))
        region = dna[start:end].lower()
        n_codons = len(region) // 3
        if n_codons >= 24 and "u" not in region:
            # vectorized path: codes → codon ids → AA LUT (identical
            # output; ambiguous bases → 'X' like the codon_map miss,
            # and 'u' — which encode_dna folds to 't' but codon_map
            # treats as unknown — falls back to the scalar path)
            from ..ops.encode import encode_dna
            codes = encode_dna(region[: 3 * n_codons]).astype(
                np.int64).reshape(n_codons, 3)
            ok = (codes < 4).all(axis=1)
            ids = np.where(
                ok, codes[:, 0] * 16 + codes[:, 1] * 4 + codes[:, 2], 64)
            return self.code.aa_lut()[ids].tobytes().decode("ascii")
        cmap = self.code.codon_map
        out = []
        for i in range(n_codons):
            codon = region[3 * i: 3 * i + 3]
            out.append(cmap.get(codon, "X"))
        return "".join(out)

    def peg_translate(self, dna: str, frame: int = 1, length: int | None = None) -> str:
        """Start-codon-aware translation (KmerProcessor.java:304-305): the
        first codon translates to 'M' when it is a permitted start codon."""
        prot = self.translate(dna, frame, length)
        if prot:
            first = dna[frame - 1: frame + 2].lower()
            if first in self.code.starts:
                prot = "M" + prot[1:]
        return prot


def translate_pegs(contig_codes: list, gc: int, contig: np.ndarray,
                   minus: np.ndarray, left: np.ndarray,
                   right: np.ndarray) -> list:
    """Proteins of many pegs in one pass over already encoded contigs.

    contig_codes: per contig its uint8 codes (``ops.encode.encode_dna``:
    t, c, a, g = 0..3, ambiguity 4).  One entry a peg in ``contig`` (an
    index into contig_codes), ``minus`` (bool), ``left`` and ``right``
    (1-based, inclusive).  Each protein is what
    ``DnaTranslator(gc).peg_translate(dna, 1, len(dna) - 3)`` gives for
    the peg's region ``dna`` read in its direction: ``(len - 3) // 3``
    codons, the minus strand read from the complement (``code ^ 2``)
    right to left, ``X`` for a codon with an ambiguous base, ``M`` for a
    start codon in front.  A peg whose contig index is negative, or
    whose bounds are not ``1 <= left <= right <= len(contig)``, gets
    None.  Codes cannot tell ``u`` from ``t``, which ``peg_translate``
    treats apart: a contig whose text holds ``u`` is the caller's to
    leave out.
    """
    code = GeneticCode.get(gc)
    contig = np.asarray(contig, np.int64)
    minus = np.asarray(minus, bool)
    left = np.asarray(left, np.int64)
    right = np.asarray(right, np.int64)
    lens = np.array([len(c) for c in contig_codes] or [0], np.int64)
    known = (contig >= 0) & (contig < len(contig_codes))
    ci = np.where(known, contig, 0)
    ok = known & (left >= 1) & (left <= right) & (right <= lens[ci])
    n_cod = np.where(ok, np.maximum((right - left - 2) // 3, 0), 0)
    # each peg's bases in reading order: a view of its contig's codes
    parts = [np.zeros(0, np.uint8)]
    for c, m, lo, hi, n in zip(ci.tolist(), minus.tolist(), left.tolist(),
                               right.tolist(), n_cod.tolist()):
        if n:
            codes = contig_codes[c]
            parts.append(codes[hi - 3 * n: hi][::-1] if m
                         else codes[lo - 1: lo - 1 + 3 * n])
    bases = np.concatenate(parts).reshape(-1, 3)
    flip = np.repeat(minus.astype(np.uint8) * 2, n_cod)  # complement: ^ 2
    b0, b1, b2 = bases[:, 0], bases[:, 1], bases[:, 2]
    ids = np.where((b0 | b1 | b2) < 4,
                   ((b0 ^ flip) << 4) | ((b1 ^ flip) << 2) | (b2 ^ flip),
                   64)
    aas = code.aa_lut()[ids]
    starts = np.cumsum(n_cod) - n_cod
    heads = starts[n_cod > 0]
    aas[heads[codon_mask(code.starts)[ids[heads]]]] = ord("M")
    text = aas.tobytes().decode("ascii")
    return [text[s: s + n] if good else None
            for s, n, good in zip(starts.tolist(), n_cod.tolist(),
                                  ok.tolist())]
