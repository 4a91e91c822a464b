"""Host-side genome domain model: GTO JSON, locations, DNA translation,
roles, genome sources and comparisons (copies of the reference package's
``genome/`` modules)."""

from .dna import DnaTranslator, GeneticCode, reverse_complement
from .locations import Location, Frame, SortedLocationList
from .gto import Genome, Feature, Contig, CloseGenome, SubsystemRow
from .roles import Role, RoleMap, Function, FunctionMap

__all__ = [
    "DnaTranslator", "GeneticCode", "reverse_complement",
    "Location", "Frame", "SortedLocationList",
    "Genome", "Feature", "Contig", "CloseGenome", "SubsystemRow",
    "Role", "RoleMap", "Function", "FunctionMap",
]
