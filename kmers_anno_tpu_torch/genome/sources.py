"""Genome sources and targets (GenomeSource contract: enum-typed sources
created with ``GenomeSource.create(type, path)``, ``ids()``, ``get(id)``;
GenomeTarget contract: enum-typed targets created with
``GenomeTarget.create(type, path, clear)`` that accept genomes).  A copy
of the reference package's ``genome/sources.py``.

The PATRIC source (P3Genome.load, KmerProcessor.java:189) is cache-first:
genomes are looked up as ``<cache>/<id>.gto`` before any network attempt,
and downloaded GTOs are written back to the cache.  In a network-isolated
deployment the cache is the only backing store; fetch failures warn and
return None exactly like the reference tool's not-found path
(KmerProcessor.java:190-191).
"""

from __future__ import annotations

import os
from typing import Iterator

from ..utils.io import FastaWriter, Sequence
from .gto import Genome


class GenomeSource:
    """Base genome source."""

    TYPES: dict[str, type] = {}

    @classmethod
    def create(cls, type_name: str, path: str) -> "GenomeSource":
        try:
            return cls.TYPES[type_name.upper()](path)
        except KeyError:
            raise ValueError(f"unknown genome source type {type_name!r}")

    def ids(self) -> list[str]:
        raise NotImplementedError

    def get(self, genome_id: str) -> Genome | None:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.ids())

    def __iter__(self) -> Iterator[Genome]:
        for gid in self.ids():
            g = self.get(gid)
            if g is not None:
                yield g


class DirGenomeSource(GenomeSource):
    """A directory of ``<genomeId>.gto`` files."""

    def __init__(self, path: str):
        if not os.path.isdir(path):
            raise FileNotFoundError(f"genome directory {path} not found")
        self.path = path

    def ids(self) -> list[str]:
        return sorted(f[:-4] for f in os.listdir(self.path)
                      if f.endswith(".gto"))

    def get(self, genome_id: str) -> Genome | None:
        p = os.path.join(self.path, genome_id + ".gto")
        return Genome.load(p) if os.path.isfile(p) else None


class PatricGenomeSource(GenomeSource):
    """BV-BRC genomes (GenomeSource.Type.PATRIC contract,
    GtoBuildProcessor.java:100).

    ``path`` selects the enumeration mode:

    * a FILE of genome IDs (one per line; a ``genome_id`` header line is
      skipped).  IDs enumerate the file; ``get`` loads cache-first then
      fetches via the data-api client (genome.p3api).
    * a DIRECTORY: cache-only mode.  IDs enumerate the cached
      ``<id>.gto`` files, and the directory doubles as the fetch cache.

    In a network-isolated deployment every fetch miss warns loudly and
    returns None (KmerProcessor.java:190-191).
    """

    def __init__(self, path: str | None, cache: str | None = None):
        self.cache = cache
        self._id_list: list[str] | None = None
        if path is None:
            pass
        elif os.path.isdir(path):
            self.cache = path if cache is None else cache
        elif os.path.isfile(path):
            ids = []
            with open(path) as fh:
                for line in fh:
                    gid = line.split("\t")[0].strip()
                    if gid and gid != "genome_id":
                        ids.append(gid)
            self._id_list = ids
        else:
            raise FileNotFoundError(
                f"PATRIC source {path} is neither a genome-ID file nor "
                "a cache directory")

    def ids(self) -> list[str]:
        if self._id_list is not None:
            return list(self._id_list)
        if self.cache is None:
            # enumerating PATRIC remotely is not possible without a
            # network; a silent [] would make every downstream command a
            # quiet no-op, so fail loudly instead
            raise RuntimeError(
                "PATRIC source cannot enumerate genomes remotely in "
                "this deployment: give it a genome-ID file or a cache "
                "directory")
        return sorted(f[:-4] for f in os.listdir(self.cache)
                      if f.endswith(".gto"))

    def get(self, genome_id: str) -> Genome | None:
        from .p3api import Details, P3Connection, P3Genome
        return P3Genome.load(P3Connection(), genome_id,
                             Details.FULL, self.cache)


GenomeSource.TYPES.update(DIR=DirGenomeSource, PATRIC=PatricGenomeSource)


class GenomeTarget:
    """Base genome target (the reference tool's IGenomeTarget /
    GenomeTargetType contract, ApplyAnnotationProcessor.java:23, 33-34,
    105: enum-typed targets created with ``type.create(fileOrDir,
    clearFlag)`` that accept genomes; the non-annotation types LIST and
    DNAFASTA exist alongside DIR)."""

    TYPES: dict[str, type] = {}

    @classmethod
    def create(cls, type_name: str, path: str,
               clear: bool = False) -> "GenomeTarget":
        try:
            return cls.TYPES[type_name.upper()](path, clear=clear)
        except KeyError:
            raise ValueError(f"unknown genome target type {type_name!r}")

    def add(self, genome: Genome) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Flush file-backed targets (directory targets are no-ops)."""


class DirGenomeTarget(GenomeTarget):
    """Writes genomes as ``<id>.gto`` files (IGenomeTarget DIR contract)."""

    def __init__(self, path: str, clear: bool = False):
        os.makedirs(path, exist_ok=True)
        if clear:
            for name in os.listdir(path):
                if name.endswith(".gto"):
                    os.unlink(os.path.join(path, name))
        self.path = path

    def add(self, genome: Genome) -> None:
        genome.save(os.path.join(self.path, genome.id + ".gto"))


class ListGenomeTarget(GenomeTarget):
    """Writes one ``<genomeId>\\t<name>`` line per genome to a text file
    (the LIST target type: annotations are not retained —
    ApplyAnnotationProcessor.java:33-34).  ``clear`` truncates an existing
    file; otherwise genomes append."""

    def __init__(self, path: str, clear: bool = False):
        self.fh = open(path, "w" if clear else "a")

    def add(self, genome: Genome) -> None:
        self.fh.write(f"{genome.id}\t{genome.name}\n")

    def close(self) -> None:
        self.fh.close()


class DnaFastaGenomeTarget(GenomeTarget):
    """Writes every contig of each genome as DNA FASTA records
    (the DNAFASTA target type — annotations are not retained).  Record
    label = contig id, comment = ``<genomeId> <genomeName>``."""

    def __init__(self, path: str, clear: bool = False):
        self.fh = open(path, "w" if clear else "a")

    def add(self, genome: Genome) -> None:
        writer = FastaWriter(self.fh)
        for contig in genome.contigs:
            writer.write(Sequence(contig.id,
                                  f"{genome.id} {genome.name}",
                                  contig.sequence))

    def close(self) -> None:
        self.fh.close()


GenomeTarget.TYPES.update(DIR=DirGenomeTarget, LIST=ListGenomeTarget,
                          DNAFASTA=DnaFastaGenomeTarget)
