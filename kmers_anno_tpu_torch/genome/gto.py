"""GTO (Genome Typed Object) JSON model.

A copy of the reference package's ``genome/gto.py``.  Implements the
contract of the reference tool's external ``Genome`` / ``Feature`` /
``Contig`` classes (schema: keys domain/taxonomy/features/contigs/
genetic_code/id/close_genomes/subsystems; feature = {id, type, function,
location: [[contig, begin, strand, len]], protein_translation,
annotations, aliases}; contig = {id, dna, genetic_code}).

Unknown JSON keys are preserved verbatim so load→save round-trips do not
lose information the engines don't model.  The port's engines read
genomes through these attributes only, so a genome of the reference
package works as well as one of these.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time
from typing import IO, Iterator

from .dna import reverse_complement
from .locations import Location

_PEG_TYPES = {"CDS", "peg"}
_FID_GENOME_RE = re.compile(r"fig\|(\d+\.\d+)\.")


def protein_md5(protein: str) -> str:
    """MD5 of a protein sequence (MD5Hex.sequenceMD5 contract)."""
    return hashlib.md5(protein.upper().encode("ascii")).hexdigest()


def dna_md5(dna: str) -> str:
    """MD5 of a DNA sequence, case-insensitive."""
    return hashlib.md5(dna.lower().encode("ascii")).hexdigest()


class Contig:
    """One contig: id, dna sequence, genetic code."""

    def __init__(self, raw: dict):
        self.raw = raw
        self._seq_lower: str | None = None

    @property
    def id(self) -> str:
        return self.raw["id"]

    @property
    def sequence(self) -> str:
        return self.raw.get("dna", "")

    @property
    def seq_lower(self) -> str:
        """Lower-cased sequence, cached."""
        if self._seq_lower is None:
            self._seq_lower = self.sequence.lower()
        return self._seq_lower

    @property
    def r_sequence(self) -> str:
        """Reverse complement (Contig.getRSequence, KmerReference.java:166)."""
        return reverse_complement(self.sequence)

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
    def md5(self) -> str:
        prot = self.protein_translation
        return protein_md5(prot) if prot else ""

    @property
    def aliases(self) -> list:
        return self.raw.setdefault("aliases", [])

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

    @property
    def subsystem_rows(self) -> list["SubsystemRow"]:
        """Subsystem rows binding this feature (Feature.getSubsystemRows)."""
        return self.genome.subsystem_rows_of(self.id) if self.genome else []

    def get_useful_roles(self, role_map) -> list:
        """Roles of this feature's function present in the role map
        (Feature.getUsefulRoles contract, BuildKmerProcessor.java:158)."""
        return role_map.useful_roles(self.function)

    def is_interesting(self, role_map) -> bool:
        """True when the function has at least one role in the map
        (Feature.isInteresting, SequenceCheckProcessor.java:129)."""
        return bool(role_map.useful_roles(self.function))

    @property
    def alias_map(self) -> dict[str, list[str]]:
        """Aliases grouped by type (Feature.getAliasMap contract,
        GeneCopyProcessor.java:107).  GTO alias entries are either
        [type, value] pairs or bare strings (type inferred as 'misc')."""
        out: dict[str, list[str]] = {}
        for entry in self.raw.get("aliases", []) or []:
            if isinstance(entry, (list, tuple)) and len(entry) >= 2:
                atype, value = entry[0], entry[1]
            else:
                atype, value = "misc", entry
            bucket = out.setdefault(atype, [])
            if value not in bucket:
                bucket.append(value)
        return out

    def add_alias(self, alias_type: str, alias: str) -> None:
        """Append an alias (Feature.addAlias contract)."""
        aliases = self.raw.setdefault("aliases", [])
        entry = [alias_type, alias]
        if entry not in aliases and alias not in aliases:
            aliases.append(entry)

    # -- protein families + gene name (Feature.setPlfam/setPgfam/
    #    setGeneName contract, GtoBuildProcessor.java:146-148, 216, 227;
    #    GTO family_assignments entries are [type, id, function] lists) --

    def _set_family(self, fam_type: str, fam_id: str | None) -> None:
        fams = [f for f in self.raw.get("family_assignments", [])
                if not (isinstance(f, (list, tuple)) and f
                        and f[0] == fam_type)]
        if fam_id:
            fams.append([fam_type, fam_id, self.function])
        self.raw["family_assignments"] = fams

    def _get_family(self, fam_type: str) -> str | None:
        for f in self.raw.get("family_assignments", []):
            if isinstance(f, (list, tuple)) and f and f[0] == fam_type:
                return f[1]
        return None

    @property
    def plfam(self) -> str | None:
        return self._get_family("PLFAM")

    @plfam.setter
    def plfam(self, fam_id: str | None) -> None:
        self._set_family("PLFAM", fam_id)

    @property
    def pgfam(self) -> str | None:
        return self._get_family("PGFAM")

    @pgfam.setter
    def pgfam(self, fam_id: str | None) -> None:
        self._set_family("PGFAM", fam_id)

    @property
    def gene_name(self) -> str:
        for entry in self.raw.get("aliases", []) or []:
            if (isinstance(entry, (list, tuple)) and len(entry) >= 2
                    and entry[0] == "gene_name"):
                return entry[1]
        return ""

    @gene_name.setter
    def gene_name(self, name: str) -> None:
        aliases = [a for a in self.raw.get("aliases", []) or []
                   if not (isinstance(a, (list, tuple)) and a
                           and a[0] == "gene_name")]
        if name:
            aliases.append(["gene_name", name])
        self.raw["aliases"] = aliases

    @staticmethod
    def genome_of(fid: str) -> str:
        m = _FID_GENOME_RE.match(fid)
        return m.group(1) if m else ""


class SubsystemRow:
    """One subsystem of a genome (the reference tool's SubsystemRow
    contract: getName/getRoles/getClassifications/isActive,
    UpdateJsonProcessor.java:311-326).  GTO schema: {name, role_bindings:
    [{role_id, features}], classification: [..], variant_code}."""

    def __init__(self, raw: dict):
        self.raw = raw

    @property
    def name(self) -> str:
        return self.raw.get("name", "")

    @property
    def classifications(self) -> list[str]:
        return list(self.raw.get("classification", []))

    @property
    def variant_code(self) -> str:
        return self.raw.get("variant_code", "")

    @property
    def is_active(self) -> bool:
        code = self.variant_code
        return code not in ("", "0", "-1", "inactive", "dirty.-1", "*-1")

    @property
    def role_bindings(self) -> list[dict]:
        return self.raw.get("role_bindings", [])

    @property
    def roles(self) -> list[str]:
        return [b.get("role_id", "") for b in self.role_bindings]

    def feature_ids(self) -> set[str]:
        out: set[str] = set()
        for b in self.role_bindings:
            out.update(b.get("features", []))
        return out


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
        self._by_id: dict[str, Feature] | None = None
        self._sub_index: dict[str, list["SubsystemRow"]] | None = None

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

    @property
    def length(self) -> int:
        return sum(c.length for c in self._contigs)

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

    @property
    def md5(self) -> str:
        """Whole-genome sequence MD5: md5 over the sorted contig sequence
        MD5s (the convention for MD5Hex.sequenceMD5(genome); only used to
        match genomes against each other, BaseCompareProcessor.java:89)."""
        parts = sorted(dna_md5(c.sequence) for c in self._contigs)
        return hashlib.md5(";".join(parts).encode("ascii")).hexdigest()

    # ----- features -----

    @property
    def features(self) -> list[Feature]:
        return self._features

    @property
    def pegs(self) -> list[Feature]:
        return [f for f in self._features if f.is_protein]

    def get_feature(self, fid: str) -> Feature | None:
        if self._by_id is None or len(self._by_id) != len(self._features):
            self._by_id = {f.id: f for f in self._features}
        return self._by_id.get(fid)

    def add_feature(self, feat: Feature) -> None:
        feat.genome = self
        self._features.append(feat)
        self._by_id = None

    def de_annotate(self) -> None:
        """Remove protein features and subsystems so the genome can be
        re-annotated from scratch (BatchKmerProcessor.java:67)."""
        self._features = [f for f in self._features if not f.is_protein]
        self._by_id = None
        self.raw["subsystems"] = []

    # ----- close genomes / subsystems -----

    @property
    def close_genomes(self) -> list[CloseGenome]:
        """Close genomes sorted closest-first (KmerProcessor.java:178-186)."""
        out = [CloseGenome(c) for c in self.raw.get("close_genomes", [])]
        out.sort(key=CloseGenome.sort_key)
        return out

    @property
    def subsystems(self) -> list[SubsystemRow]:
        return [SubsystemRow(s) for s in self.raw.get("subsystems", [])]

    def subsystem_rows_of(self, fid: str) -> list[SubsystemRow]:
        """Subsystem rows binding a feature (Feature.getSubsystemRows
        contract, FullCompareAnnotationReporter.java:46-47)."""
        if self._sub_index is None:
            self._sub_index = {}
            for row in self.subsystems:
                for bound_fid in row.feature_ids():
                    self._sub_index.setdefault(bound_fid, []).append(row)
        return self._sub_index.get(fid, [])

    def clear_subsystems(self) -> None:
        self.raw["subsystems"] = []
        self._sub_index = None


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
