"""The benchmark's hashAnno cell on the CPU at a small size: its generator
(``kanbench/systems/hashanno.py``), its plain reference
(``kanbench/reference/hashanno.py``) and the port's
``annotate_genomes_batched`` giving the reference's rows exactly, the
control (ties sent to the latest prototype) breaking them, and the
reference on the port's host route.

The data are the cell's own generator at 2 batches of 4 genomes of 60
pegs against 512 prototypes, seeded.  The file imports no jax.
"""

from __future__ import annotations

import json
import random
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from kanbench.reference import hashanno as ref
from kanbench.systems import hashanno as cell_mod
from kmers_anno_tpu_torch.engine import hashanno
from kmers_anno_tpu_torch.genome.gto import Genome

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(pegs_per_genome=60, prototypes=512, pool_genomes=8,
             annotations=128)
SEED = 2**33 + 23
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module's tests run: the suite runs
    several workers, and their threads would outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(**small) -> dict:
    conf = json.loads((ROOT / "kanbench" / "configs"
                       / "hashanno_k8_p32k.json").read_text())
    return dict(conf, **small)


@pytest.fixture(scope="module")
def small():
    config = _config(**SMALL)
    data = cell_mod.make_data(config, SEED)
    protos = ref.Prototypes(data["prototypes"], config["k"],
                            config["min_len"])
    return config, data, protos


def _port_rows(config, batch, prototypes) -> list:
    pset = hashanno.PrototypeSet(
        [hashanno.Prototype(p, a) for p, a in prototypes
         if a.strip() and len(p) >= config["min_len"]], config["k"])
    genomes = [Genome(cell_mod.genome_raw(f)) for f in batch]
    out = hashanno.annotate_genomes_batched(genomes, pset, config["k"],
                                            config["min_sim"], device=CPU)
    return [rows for rows, _, _ in out]


def _row_class(row) -> str:
    _, score, new, old = row
    if score == "":
        return "skipped"
    if score == "0.0":
        return "defaulted"
    return "confirmed" if new == old else "changed"


def test_port_rows_equal_the_reference(small):
    config, data, protos = small
    assert len(data["batches"]) == 2
    for batch in data["batches"]:
        assert len(batch) == 4 and all(len(g) == 60 for g in batch)
        got = _port_rows(config, batch, data["prototypes"])
        want = ref.batch_rows(batch, protos, config["min_sim"])
        assert got == want


def test_control_sends_ties_to_the_latest_prototype(small):
    config, data, protos = small
    n_bad = 0
    for batch in data["batches"]:
        want = ref.batch_rows(batch, protos, config["min_sim"])
        ctl = ref.batch_rows(batch, protos, config["min_sim"], latest=True)
        bad = [(w, c) for gw, gc in zip(want, ctl)
               for w, c in zip(gw, gc) if w != c]
        # only the new annotation moves: a tie's score is the same
        assert all(w[:2] == c[:2] and w[3] == c[3] for w, c in bad)
        n_bad += len(bad)
    assert n_bad > 0


def test_generator_gives_every_class_ties_and_copies(small):
    config, data, protos = small
    classes = Counter(
        _row_class(r) for batch in data["batches"]
        for g in ref.batch_rows(batch, protos, config["min_sim"]) for r in g)
    assert set(classes) == {"skipped", "defaulted", "confirmed", "changed"}
    # skipped features: empty, or holding a '*'
    skipped = [p for batch in data["batches"] for g in batch
               for _, _, p in g if not p or "*" in p]
    assert any(not p for p in skipped) and any(p for p in skipped)
    # exact-copy prototypes under another annotation
    rows = data["prototypes"]
    for c in data["copies"]:
        earlier = [i for i in range(c) if rows[i][0] == rows[c][0]]
        assert earlier and rows[earlier[0]][1] != rows[c][1]
    # a protein shared by two genomes of a batch (one MD5, two genomes)
    for batch in data["batches"]:
        owners: dict = {}
        for j, g in enumerate(batch):
            for _, _, p in g:
                if p and "*" not in p:
                    owners.setdefault(p, set()).add(j)
        assert any(len(v) > 1 for v in owners.values())
    # the lengths of the pool's distinct proteins (the indexes' work) are
    # the same multiset for every seed
    other = cell_mod.make_data(config, SEED + 1)

    def lengths(d):
        return sorted(len(p) for p in {p for b in d["batches"] for g in b
                                       for _, _, p in g})

    assert lengths(other) == lengths(data)
    assert sorted(len(p) for p, _ in other["prototypes"]) == \
        sorted(len(p) for p, _ in data["prototypes"])


def test_defaults_are_each_genomes_own(small):
    """A copy with no proposal defaults to its own genome's old
    annotation, not the registering genome's."""
    config, data, protos = small
    seen = 0
    for batch in data["batches"]:
        want = ref.batch_rows(batch, protos, config["min_sim"])
        first: dict = {}
        for j, (g, rows) in enumerate(zip(batch, want)):
            for (fid, fn, p), row in zip(g, rows):
                if row[1] != "0.0":
                    continue
                first.setdefault((j, p), fn)
                assert row[2] == first[(j, p)]
                others = [k for (k, q) in first if q == p and k != j]
                seen += bool(others and first[(others[0], p)] != row[2])
    assert seen > 0


def test_cell_check_counts_a_changed_row(small):
    config = _config(**SMALL)
    cell = cell_mod.Cell(config, {}, SEED, CPU)
    cell.warm_up(lambda: None)
    before = cell.route_counters()
    w = cell.window(0.0, lambda: None)
    assert w["n_done"] == 4 and cell.done[0][0] == 0
    assert cell.route_counters() == before      # the fast route, no launch
    cell.free()
    limits = {"row_mismatches": 0}
    assert cell.check(limits)["row_mismatches"] == (0, 0)
    fid, score, new, old = cell.done[0][1][2][5]
    cell.done[0][1][2][5] = (fid, score, new + " ", old)
    assert cell.check(limits)["row_mismatches"] == (1, 0)
    assert cell.failed == 1


def _heavy_batch(rng: random.Random) -> tuple:
    """Two genomes whose proteins share one kmer 33 times over, one past
    the owner cap, and prototypes holding it."""
    aa = "ACDEFGHIKLMNPQRSTVWY"
    motif = "WMKHCYFP"

    def rand(n):
        return "".join(rng.choice(aa) for _ in range(n))

    genomes = []
    for j in range(2):
        feats = []
        for i in range(30):
            p = rand(40) + (motif if i < 17 - j else "") + rand(30)
            feats.append((f"fig|77.{j + 1}.peg.{i + 1}",
                          f"Family {i % 5}", p))
        feats.append((f"fig|77.{j + 1}.peg.31", "", ""))
        genomes.append(feats)
    protos = [(rand(20) + motif + rand(60), f"Proto {i}") for i in range(6)]
    protos += [(genomes[0][i][2][:60] + rand(10), f"Near {i}")
               for i in range(3)]
    protos += [(protos[-1][0], "A copy of near 2")]
    return genomes, protos


def test_host_route_rows_equal_the_reference():
    genomes, protos = _heavy_batch(random.Random(5))
    owners = sum(1 for g in genomes for _, _, p in g if "WMKHCYFP" in p)
    assert owners == 33 == hashanno.OWNER_CAP + 1
    before = hashanno.GenomeProteinKmers.host_route
    got = _port_rows(_config(), genomes, protos)
    assert hashanno.GenomeProteinKmers.host_route == before + 1
    want = ref.batch_rows(genomes, ref.Prototypes(protos, 8, 50), 0.0125)
    assert got == want
    assert {_row_class(r) for g in want for r in g} >= {"skipped",
                                                         "changed"}


def test_reference_kmer_pairs_count_every_window():
    key, owner, n = ref.kmer_pairs(["ACDEFGHIK", "AAAAAAAAAA", "ACD", ""], 8)
    assert n.tolist() == [2, 1, 0, 0]
    assert owner.tolist() == [0, 0, 1]
    # a protein's case does not matter
    assert np.array_equal(ref.kmer_pairs(["acdefghik"], 8)[0], key[:2])
