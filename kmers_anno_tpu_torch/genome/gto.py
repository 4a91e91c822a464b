"""GTO (Genome Typed Object) JSON model.

A copy of the reference package's ``genome/gto.py``, holding what the
port uses.  Implements the contract of the reference tool's external
``Genome`` / ``Feature`` / ``Contig`` classes (schema: keys domain/
taxonomy/features/contigs/genetic_code/id/close_genomes/subsystems;
feature = {id, type, function, location: [[contig, begin, strand, len]],
protein_translation, annotations, aliases}; contig = {id, dna,
genetic_code}).

Unknown JSON keys are preserved verbatim so load→save round-trips do not
lose information the engines don't model.  The port's engines read
genomes through these attributes only, so a genome of the reference
package works as well as one of these.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import IO, Iterator

from .locations import Location

_PEG_TYPES = {"CDS", "peg"}


def protein_md5(protein: str) -> str:
    """MD5 of a protein sequence (MD5Hex.sequenceMD5 contract)."""
    return hashlib.md5(protein.upper().encode("ascii")).hexdigest()


class Contig:
    """One contig: id, dna sequence, genetic code."""

    def __init__(self, raw: dict):
        self.raw = raw

    @property
    def id(self) -> str:
        return self.raw["id"]

    @property
    def sequence(self) -> str:
        return self.raw.get("dna", "")

    @property
    def genetic_code(self) -> int:
        return int(self.raw.get("genetic_code", 11))

    @property
    def length(self) -> int:
        return len(self.sequence)

    def __len__(self) -> int:
        return self.length


class Feature:
    """One feature (gene).  GTO location tuples are strand-relative:
    [contig, begin, strand, length] where begin is the leftmost base for '+'
    and the rightmost base for '-'."""

    def __init__(self, raw: dict):
        self.raw = raw
        self.genome: "Genome | None" = None  # backref set by Genome

    @staticmethod
    def create(fid: str, function: str, contig_id: str, strand: str,
               left: int, right: int, ftype: str = "CDS") -> "Feature":
        """A new feature (the projection engine's, KmerProcessor.java:302)."""
        begin = left if strand == "+" else right
        length = right - left + 1
        return Feature({
            "id": fid,
            "type": ftype,
            "function": function,
            "location": [[contig_id, str(begin), strand, length]],
            "annotations": [],
            "aliases": [],
            "family_assignments": [],
        })

    @property
    def id(self) -> str:
        return self.raw["id"]

    @property
    def type(self) -> str:
        return self.raw.get("type", "")

    @property
    def is_protein(self) -> bool:
        return self.type in _PEG_TYPES

    @property
    def function(self) -> str:
        return self.raw.get("function", "") or ""

    @function.setter
    def function(self, value: str) -> None:
        self.raw["function"] = value

    @property
    def peg_function(self) -> str:
        """Function with empty mapped to "hypothetical protein"
        (Feature.getPegFunction contract)."""
        fun = self.function
        return fun if fun else "hypothetical protein"

    @property
    def protein_translation(self) -> str | None:
        return self.raw.get("protein_translation")

    @protein_translation.setter
    def protein_translation(self, value: str) -> None:
        self.raw["protein_translation"] = value

    @property
    def protein_length(self) -> int:
        prot = self.protein_translation
        return len(prot) if prot else 0

    @property
    def regions(self) -> list[Location]:
        """Feature location segments as Location objects."""
        out = []
        for seg in self.raw.get("location", []):
            contig, begin, strand, length = (seg[0], int(seg[1]), seg[2],
                                             int(seg[3]))
            if strand == "+":
                out.append(Location(contig, "+", begin, begin + length - 1))
            else:
                out.append(Location(contig, "-", begin - length + 1, begin))
        return out

    @property
    def location(self) -> Location | None:
        """Overall location: single region, or the span of all regions."""
        regions = self.regions
        if not regions:
            return None
        if len(regions) == 1:
            return regions[0]
        left = min(r.left for r in regions)
        right = max(r.right for r in regions)
        return Location(regions[0].contig_id, regions[0].strand, left, right)

    def add_annotation(self, text: str, tool: str) -> None:
        """Append an annotation-history entry (Feature.addAnnotation)."""
        self.raw.setdefault("annotations", []).append(
            [text, tool, time.time(), ""])

    def get_useful_roles(self, role_map) -> list:
        """Roles of this feature's function present in the role map
        (Feature.getUsefulRoles contract, BuildKmerProcessor.java:158)."""
        return role_map.useful_roles(self.function)


class CloseGenome:
    """Entry of a GTO close_genomes list, ordered closest-first."""

    def __init__(self, raw: dict):
        self.raw = raw

    @property
    def genome_id(self) -> str:
        return self.raw.get("genome", self.raw.get("genome_id", ""))

    @property
    def genome_name(self) -> str:
        return self.raw.get("genome_name", "")

    @property
    def closeness(self) -> float:
        return float(self.raw.get("closeness_measure", 0.0))

    def sort_key(self) -> tuple:
        # Closest (highest measure) first; genome id breaks ties.
        return (-self.closeness, self.genome_id)


class Genome:
    """A GTO genome: JSON load/save plus the accessor surface the engines
    use."""

    def __init__(self, raw: dict):
        self.raw = raw
        self._features = [Feature(f) for f in raw.get("features", [])]
        for f in self._features:
            f.genome = self
        self._contigs = [Contig(c) for c in raw.get("contigs", [])]

    # ----- I/O -----

    @classmethod
    def load(cls, source: str | IO) -> "Genome":
        if hasattr(source, "read"):
            return cls(json.load(source))
        with open(source, "r") as fh:
            return cls(json.load(fh))

    def save(self, target: str | IO) -> None:
        self.raw["features"] = [f.raw for f in self._features]
        self.raw["contigs"] = [c.raw for c in self._contigs]
        if hasattr(target, "write"):
            json.dump(self.raw, target, indent=3)
        else:
            with open(target, "w") as fh:
                json.dump(self.raw, fh, indent=3)

    # ----- identity -----

    @property
    def id(self) -> str:
        return self.raw.get("id", "")

    @property
    def name(self) -> str:
        return self.raw.get("scientific_name", "")

    @property
    def genetic_code(self) -> int:
        return int(self.raw.get("genetic_code", 11))

    def __str__(self) -> str:
        return f"{self.id} ({self.name})"

    # ----- contigs -----

    @property
    def contigs(self) -> list[Contig]:
        return self._contigs

    def get_contig(self, contig_id: str) -> Contig | None:
        for c in self._contigs:
            if c.id == contig_id:
                return c
        return None

    def get_dna(self, loc: Location) -> str:
        contig = self.get_contig(loc.contig_id)
        if contig is None:
            return ""
        return loc.dna(contig.sequence)

    # ----- features -----

    @property
    def features(self) -> list[Feature]:
        return self._features

    @property
    def pegs(self) -> list[Feature]:
        return [f for f in self._features if f.is_protein]

    def add_feature(self, feat: Feature) -> None:
        feat.genome = self
        self._features.append(feat)

    def de_annotate(self) -> None:
        """Remove protein features and subsystems so the genome can be
        re-annotated from scratch (BatchKmerProcessor.java:67)."""
        self._features = [f for f in self._features if not f.is_protein]
        self.raw["subsystems"] = []

    # ----- close genomes -----

    @property
    def close_genomes(self) -> list[CloseGenome]:
        """Close genomes sorted closest-first (KmerProcessor.java:178-186)."""
        out = [CloseGenome(c) for c in self.raw.get("close_genomes", [])]
        out.sort(key=CloseGenome.sort_key)
        return out


class GenomeDirectory:
    """Iterable over the ``*.gto`` files of a directory
    (GenomeDirectory contract, BuildKmerProcessor.java:146-148)."""

    def __init__(self, path: str):
        self.path = path
        self.files = sorted(
            f for f in os.listdir(path) if f.endswith(".gto"))

    def __len__(self) -> int:
        return len(self.files)

    def __iter__(self) -> Iterator[Genome]:
        for name in self.files:
            yield Genome.load(os.path.join(self.path, name))

    @property
    def ids(self) -> list[str]:
        return [f[:-4] for f in self.files]
