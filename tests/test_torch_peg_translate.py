"""The batched peg translation of the projection annotator's features
(``genome.dna.translate_pegs``, ``engine.projection.peg_proteins``)
against the reference package's per-peg translation,
``DnaTranslator.peg_translate`` on ``Genome.get_dna``'s slice, and
``annotate_genome``'s features with the batched pass against those the
port makes peg by peg.  Every comparison is exact.  The reference's
genome modules import only numpy, so the file imports no jax.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from kmers_anno_tpu.genome import dna as ref_dna
from kmers_anno_tpu.genome import gto as ref_gto
from kmers_anno_tpu.genome import locations as ref_locations
from kmers_anno_tpu_torch.engine import projection
from kmers_anno_tpu_torch.genome.dna import translate_pegs
from kmers_anno_tpu_torch.genome.gto import Genome
from kmers_anno_tpu_torch.genome.locations import Location
from kmers_anno_tpu_torch.ops.encode import encode_dna
from kmers_anno_tpu_torch.utils import spans

ROOT = Path(__file__).resolve().parents[1]
FLANK_L, FLANK_R = "gattacacg", "ccatgtta"
BODY = "gcaaagatcgtttggcaccgtgaaatcctgtactagctgaacggc"   # 15 codons

# peg regions in reading direction, the start codon first
GENES = {
    "len_mod0": "atg" + BODY * 2,
    "len_mod1": "atg" + BODY * 2 + "a",
    "len_mod2": "atg" + BODY * 2 + "ac",
    "len3": "atg",
    "len4": "atga",
    "len5": "atgac",
    "len6": "atgaaa",
    "len7": "ttgaaac",
    "ambig_first": "anggca" + BODY,
    "ambig_inside": "atggcnaarytgaswgcatagbdhkm" + BODY,
    "start_ttg": "ttg" + BODY,
    "start_ctg": "ctg" + BODY,
    "start_atg": "atg" + BODY,
    "start_gtg": "gtg" + BODY,
    "nonstart": "aaa" + BODY,
    "upper": ("ATG" + BODY + "NRYACG").upper(),
    "mixed_case": "AtG" + BODY.upper()[:30] + BODY[30:],
}


def _raw(contigs: list, gc: int) -> dict:
    return {"id": "900.1", "scientific_name": "Testus",
            "genetic_code": gc, "domain": "Bacteria",
            "contigs": [{"id": cid, "dna": dna} for cid, dna in contigs],
            "features": []}


def _genome(contigs: list, gc: int) -> Genome:
    return Genome(_raw(contigs, gc))


def _per_peg(contigs: list, gc: int, locs: list) -> list:
    """The reference package's protein of each location, peg by peg."""
    genome = ref_gto.Genome(_raw(contigs, gc))
    xlator = ref_dna.DnaTranslator(gc)
    dnas = (genome.get_dna(ref_locations.Location(
        loc.contig_id, loc.strand, loc.left, loc.right)) for loc in locs)
    return [xlator.peg_translate(dna, 1, len(dna) - 3) for dna in dnas]


def _codes(genome: Genome) -> list:
    return [encode_dna(c.sequence) for c in genome.contigs]


def _placed(gene: str, strand: str) -> tuple[str, Location]:
    """A contig holding ``gene`` on ``strand`` between two flanks, and the
    gene's location."""
    body = gene if strand == "+" else ref_dna.reverse_complement(gene)
    left = len(FLANK_L) + 1
    return (FLANK_L + body + FLANK_R,
            Location("c1", strand, left, left + len(gene) - 1))


@pytest.mark.parametrize("case", list(GENES))
@pytest.mark.parametrize("strand", ["+", "-"])
@pytest.mark.parametrize("gc", [11, 4, 2])
def test_batched_matches_peg_translate(gc, strand, case):
    dna, loc = _placed(GENES[case], strand)
    contigs = [("c0", FLANK_R * 3), ("c1", dna)]
    genome = _genome(contigs, gc)
    assert genome.get_dna(loc) == GENES[case]
    want = _per_peg(contigs, gc, [loc])
    got = translate_pegs(_codes(genome), gc, np.array([1]),
                         np.array([strand == "-"]), np.array([loc.left]),
                         np.array([loc.right]))
    assert got == want
    assert projection.peg_proteins([loc], genome, _codes(genome)) == (want,
                                                                      0)
    assert len(want[0]) == max(0, (len(GENES[case]) - 3) // 3)


@pytest.mark.parametrize("gc", [11, 4, 2])
def test_batched_matches_peg_translate_on_random_pegs(gc):
    """Many pegs at once, on both strands of contigs with ambiguity
    codes, among locations the batch leaves to the per-peg path."""
    rng = random.Random(gc)
    alphabet = "acgt" * 6 + "ACGT" * 2 + "nrykmswbdhv"
    contigs = [(f"c{i}", "".join(rng.choice(alphabet)
                                 for _ in range(rng.randint(1, 900))))
               for i in range(12)]
    genome = _genome(contigs, gc)
    locs = []
    for _ in range(600):
        cid, dna = rng.choice(contigs)
        if rng.random() < 0.8:
            left = rng.randint(1, len(dna))
            right = rng.randint(left, min(len(dna), left + 300))
        else:
            left = rng.randint(-2, len(dna) + 2)
            right = rng.randint(left - 3, left + 300)
        locs.append(Location(rng.choice([cid] * 5 + ["absent"]),
                             rng.choice("+-"), left, right))
    got, fallbacks = projection.peg_proteins(locs, genome, _codes(genome))
    assert got == _per_peg(contigs, gc, locs)
    lens = dict(contigs)
    outside = sum(loc.contig_id not in lens or not 1 <= loc.left
                  <= loc.right <= len(lens[loc.contig_id]) for loc in locs)
    assert fallbacks == outside and 0 < outside < len(locs) // 2


FALLBACKS = {
    # encode_dna folds u to t; peg_translate gives X and takes no start
    "u_contig": ([("cu", "gg" + "augcugaaauuu" * 6 + "cc")],
                 [("cu", "+", 3, 74), ("cu", "-", 3, 74)]),
    "past_contig_end": ([], [("c0", "+", 20, 120), ("c0", "-", 40, 500)]),
    "before_contig_start": ([], [("c0", "+", 0, 30), ("c0", "-", -2, 30)]),
    "missing_contig": ([], [("absent", "+", 1, 30),
                            ("absent", "-", 1, 30)]),
    "non_ascii_contig": ([("cx", "atgé" + "gcaaag" * 5)],
                         [("cx", "+", 1, 30), ("cx", "-", 5, 34)]),
}


@pytest.mark.parametrize("case", list(FALLBACKS))
def test_pegs_the_codes_cannot_answer_take_the_per_peg_path(case):
    extra, odd = FALLBACKS[case]
    contigs = [("c0", "ttg" + BODY * 2 + "ggatc")] + extra
    genome = _genome(contigs, 11)
    fine = [Location("c0", "+", 1, 93), Location("c0", "-", 4, 96)]
    locs = [fine[0]] + [Location(*o) for o in odd] + [fine[1]]
    got, fallbacks = projection.peg_proteins(locs, genome, _codes(genome))
    assert got == _per_peg(contigs, 11, locs)
    assert fallbacks == len(odd)
    assert got[0].startswith("M")


def test_no_pegs_and_no_contigs():
    assert translate_pegs([], 11, np.zeros(0, np.int64), np.zeros(0, bool),
                          np.zeros(0, np.int64), np.zeros(0, np.int64)) == []
    genome = _genome([], 11)
    locs = [Location("c0", "+", 1, 30)]
    assert projection.peg_proteins(locs, genome, []) == ([""], 1)


# ----- annotate_genome's features -----

def _projection_cell():
    from kanbench.systems import projection as cell_system

    conf = json.loads((ROOT / "kanbench" / "configs" / "proj_k8_close10.json")
                      .read_text())
    conf.update(n_genes=48, contigs=4, pool_genomes=3, n_genomes=3)
    return cell_system.Cell(conf, {"close_sets": "rotating"}, 2**33 + 19,
                            torch.device("cpu"))


def _untimed(genome: Genome) -> str:
    """The features' raw text, each annotation's timestamp set aside."""
    feats = []
    for f in genome.features:
        raw = dict(f.raw)
        raw["annotations"] = [[a[0], a[1], a[3]]
                              for a in raw.get("annotations", [])]
        feats.append(raw)
    return json.dumps(feats)


@pytest.fixture
def one_thread_untraced():
    """One intra-op thread (the suite runs several workers), and the
    tracer left off and empty."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.disable()
    spans.clear()
    yield
    spans.disable()
    spans.clear()
    torch.set_num_threads(n)


@pytest.mark.parametrize("route", ["fused", "rle"])
def test_annotate_features_match_the_per_peg_route(
        monkeypatch, one_thread_untraced, route):
    cell = _projection_cell()
    if route == "rle":
        cell.annot._close_set = lambda olds: None
    ids = cell.sets.next()
    batched = cell.request(ids)
    before = projection.ProjectionAnnotator.batch_translated
    spans.enable()
    stats = cell.annot.annotate_genome(batched, cell.pool.get)
    assert stats["pegs"] > 0
    assert (projection.ProjectionAnnotator.batch_translated - before
            == stats["pegs"])
    assert {f.location.strand for f in batched.features} == {"+", "-"}
    # every peg through the per-peg path, as before the batched pass
    monkeypatch.setattr(projection, "translate_pegs",
                        lambda codes, gc, contig, *rest: [None] * len(contig))
    per_peg = cell.request(ids)
    assert cell.annot.annotate_genome(per_peg, cell.pool.get) == stats
    assert _untimed(batched) == _untimed(per_peg)
    features = [r.attrs for r in spans.records()
                if r.name == "proj.features"]
    assert features == [{"pegs": stats["pegs"], "fallbacks": 0},
                        {"pegs": stats["pegs"],
                         "fallbacks": stats["pegs"]}]
    assert (projection.ProjectionAnnotator.batch_translated - before
            == stats["pegs"])
