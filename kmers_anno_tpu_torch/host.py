"""The reference package's host modules that the port shares.

The port takes the host side of ``kmers_anno_tpu`` as it is instead of
copying it: the GTO genome model and locations, the DNA translator and the
NumPy sequence codecs, the kmer hash constants and salts, the ORF
extender, the role map, the command framework, tabular I/O and the
``apply`` reporters, and the C++ host library (``native``: the flat peg,
flat-batch and row-batch loaders, the group-by, the streaming signature
builder and the single-core projection and apply baselines).  Each of
these modules is plain Python, NumPy or C++ and imports no jax.

This is the one module of the port that names ``kmers_anno_tpu``; every
other module, and ``chip_smoke.py``, reaches the reference's host code
through it (``tests/test_torch_imports.py`` holds them to that).
"""

from kmers_anno_tpu import native
from kmers_anno_tpu.commands.app import COMMANDS as REFERENCE_COMMANDS
from kmers_anno_tpu.commands.base import BaseProcessor, ParseFailureException
from kmers_anno_tpu.genome.dna import (DnaTranslator, GeneticCode,
                                       reverse_complement)
from kmers_anno_tpu.genome.gto import Feature, Genome, GenomeDirectory
from kmers_anno_tpu.genome.locations import Location
from kmers_anno_tpu.genome.roles import Role, RoleMap
from kmers_anno_tpu.genome.sources import PatricGenomeSource
from kmers_anno_tpu.ops.encode import (DNA_AMBIG, PROT_PAD, PROT_STOP, PROT_X,
                                       decode_protein, encode_dna,
                                       encode_protein,
                                       reverse_complement_codes)
from kmers_anno_tpu.ops.hashing import _M1 as M1
from kmers_anno_tpu.ops.hashing import _M2 as M2
from kmers_anno_tpu.ops.hashing import GOLDEN
from kmers_anno_tpu.ops.hashing import mix_kmer as mix_kmer_np
from kmers_anno_tpu.ops.hashing import mix_kmer_salted as mix_kmer_salted_np
from kmers_anno_tpu.ops.hashing import salt_sequence
from kmers_anno_tpu.ops.orf import OrfExtender
from kmers_anno_tpu.reports.apply_reports import ApplyKmerReporter
from kmers_anno_tpu.utils.counters import CountMap
from kmers_anno_tpu.utils.io import LineReader, TabbedLineReader, read_set
from kmers_anno_tpu.utils.prefetch import Prefetcher, prefetch_map

__all__ = [
    "native", "REFERENCE_COMMANDS", "BaseProcessor", "ParseFailureException",
    "DnaTranslator", "GeneticCode", "reverse_complement", "Feature",
    "Genome", "GenomeDirectory", "Location", "Role", "RoleMap",
    "PatricGenomeSource", "DNA_AMBIG", "PROT_PAD", "PROT_STOP", "PROT_X",
    "decode_protein", "encode_dna", "encode_protein",
    "reverse_complement_codes", "M1", "M2", "GOLDEN", "mix_kmer_np",
    "mix_kmer_salted_np", "salt_sequence", "OrfExtender",
    "ApplyKmerReporter", "CountMap", "LineReader", "TabbedLineReader",
    "read_set", "Prefetcher", "prefetch_map",
]
