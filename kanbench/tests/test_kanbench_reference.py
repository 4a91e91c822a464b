"""The plain references against a scalar transcription of the tool's loops
and against the program on the CPU, at small sizes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kanbench.reference import apply as ref_apply
from kanbench.reference import codes as C
from kanbench.reference import projection as ref_proj
from kanbench.systems import apply as sys_apply
from kanbench.systems import projection as sys_proj

AA_TABLE = dict(zip((a + b + c for a in C.BASES for b in C.BASES
                     for c in C.BASES), C.TABLE_11))
COMP = str.maketrans("acgt", "tgca")


def _translate(dna):
    return "".join(AA_TABLE.get(dna[i: i + 3], "X")
                   for i in range(0, len(dna) - 2, 3))


def _extend(seq, strand, left, right):
    """Location.extend, one codon at a time."""
    n = len(seq)

    def codon(p):
        c = seq[p: p + 3]
        return c.translate(COMP)[::-1] if strand == "-" else c

    stops = {c for c, a in AA_TABLE.items() if a == "*"}
    if (right - left + 1) % 3:
        return None
    if strand == "+":
        pos, new_r = right, None
        while pos + 3 <= n:
            if codon(pos) in stops:
                new_r = pos + 3
                break
            pos += 3
        pos, new_l = left - 1, None
        while pos >= 0:
            if codon(pos) in C.STARTS_11:
                new_l = pos + 1
                break
            if codon(pos) in stops:
                return None
            pos -= 3
    else:
        pos, new_l = left - 4, None
        while pos >= 0:
            if codon(pos) in stops:
                new_l = pos + 1
                break
            pos -= 3
        pos, new_r = right - 3, None
        while pos + 3 <= n:
            if codon(pos) in C.STARTS_11:
                new_r = pos + 3
                break
            if codon(pos) in stops:
                return None
            pos += 3
    if new_l is None or new_r is None:
        return None
    return new_l, new_r


def scalar_annotate(contigs, olds, k=8, s=0.5, max_fuzz=1.5, min_fuzz=0.8,
                    min_ev=10):
    """KmerProcessor.annotateGenome as loops over dicts and lists;
    ``contigs`` is a list of (contig id, DNA)."""
    real = s / 3
    dna_of = dict(contigs)
    contig = {}
    for cid, dna in contigs:
        rc = dna.translate(COMP)[::-1]
        for strand, seq in (("+", dna), ("-", rc)):
            for frame in (1, 2, 3):
                prot = _translate(seq[frame - 1:])
                for i in range(len(prot) - k):
                    km = prot[i: i + k]
                    if "*" in km or "X" in km:
                        continue
                    left = (i * 3 + frame if strand == "+"
                            else len(dna) - 3 * k + 2 - (i * 3 + frame))
                    contig.setdefault(km, []).append(
                        (cid, strand, left, left + 3 * k - 1))
    by_orf, counts = {}, dict(made=0, merged=0, rejected=0, weak=0, small=0)
    for pegs in olds:
        seen = {}
        for pid, func, prot in pegs:
            for i in range(len(prot) - k):
                km = prot[i: i + k]
                if "X" not in km:
                    seen.setdefault(km, [pid, 0])[1] += 1
        plen = {pid: len(prot) for pid, _, prot in pegs}
        funcs = {pid: f for pid, f, _ in pegs}
        framer = {}
        for km, (pid, c) in seen.items():
            if c != 1:
                continue
            for cid, strand, left, right in contig.get(km, ()):
                frame = (3 + left % 3) if strand == "+" else right % 3
                framer.setdefault((frame, pid), []).append(
                    (cid, left, right, strand))
        for (_, pid), locs in framer.items():
            locs.sort()
            L = plen[pid] * 3
            max_len, min_len = int(L * max_fuzz + 1), int(L * min_fuzz)
            min_k = int(L * real)
            if min_k > len(locs):
                continue
            for i in range(len(locs) - min_k + 1):
                cid, left, right, strand = locs[i]
                ev, best = 1, right
                for c2, l2, r2, _ in locs[i + 1:]:
                    if c2 == cid and r2 < left + max_len:
                        ev += 1
                        best = max(best, r2)
                if best < left + min_len:
                    continue
                counts["made"] += 1
                ext = _extend(dna_of[cid], strand, left, best)
                if ext is None:
                    counts["rejected"] += 1
                    continue
                length = ext[1] - ext[0] + 1
                if ev / length < real:
                    counts["weak"] += 1
                    continue
                if ev < min_ev:
                    counts["small"] += 1
                    continue
                end = ext[1] if strand == "+" else ext[0]
                key = (cid, end, strand)
                old = by_orf.get(key)
                if old is None:
                    by_orf[key] = [ext, funcs[pid], ev]
                elif ev > old[2] or (ev == old[2] and length
                                     > old[0][1] - old[0][0] + 1):
                    by_orf[key] = [ext, funcs[pid], ev]
                    counts["merged"] += 1
    props = sorted(by_orf.items(), key=lambda kv: (
        kv[0][0], kv[1][0][0], kv[1][0][1] - kv[1][0][0]))
    feats = [(f"fig|400.1.peg.{n}", v[1], key[0], key[2], v[0][0], v[0][1])
             for n, (key, v) in enumerate(props, 1)]
    counts.update(kept=len(feats), pegs=len(feats))
    return feats, counts


def _small_projection(seed, n_genes=40, pool=4, contigs=4):
    cfg = dict(k=8, n_genes=n_genes, contigs=contigs, codons_min=57,
               codons_max=475,
               lead_bases=50, spacer_bases=30, pool_genomes=pool,
               substitution_rate=0.01, n_genomes=3, min_strength=0.5,
               max_fuzz=1.5, min_fuzz=0.8, min_evidence=10)
    return cfg, sys_proj.make_data(cfg, seed)


@pytest.mark.parametrize("seed,contigs", [(1, 4), (2**40 + 9, 1),
                                          (2**40 + 9, 9)])
def test_projection_reference_against_the_tools_loops(seed, contigs):
    cfg, data = _small_projection(seed, contigs=contigs)
    assert len(data["contigs"]) == contigs
    ids = tuple(sorted(data["pool"])[:3])
    draft, calls = sys_proj.reference_calls(cfg, data["contigs"],
                                            data["pool"], ids)
    got = sys_proj.reference_outputs(cfg, draft, calls, ids)
    olds = [[(f["id"], f["function"], f["protein_translation"])
             for f in data["pool"][g]["features"]] for g in ids]
    assert got == scalar_annotate(data["contigs"], olds)


def test_extend_against_the_codon_walk():
    rng = np.random.default_rng(5)
    dna = "".join("tcag"[c] for c in rng.integers(0, 4, 3000))
    draft = ref_proj.Draft("g", [("c", dna)], 8)
    left = rng.integers(1, 2900, 400)
    right = left + 3 * rng.integers(8, 30, 400) - 1
    right = np.minimum(right, 3000)
    strand = rng.integers(0, 2, 400)
    el, er, ok = ref_proj.extend(draft, np.zeros(400, np.int64), strand,
                                 left, right)
    for i in range(400):
        want = _extend(dna, "+-"[strand[i]], int(left[i]), int(right[i]))
        assert (want is not None) == bool(ok[i]), i
        if want is not None:
            assert want == (int(el[i]), int(er[i])), i


def test_close_order_is_closest_first_then_id():
    got = ref_proj.close_order([("b", 99.0), ("a", 99.0), ("c", 99.5)], 2)
    assert got == ["c", "a"]


def _apply_cell(weighted, monkeypatch, flat):
    from kmers_anno_tpu_torch.engine import signature

    if flat:
        monkeypatch.setattr(signature, "fits_wide", lambda n: False)
    cfg = dict(k=8, min_hits=5, table_keys=60_000, roles=90,
               prototype_residues=120, member_divergence=0.3,
               weight_low=0.05, weight_high=3.0, pool_genomes=3,
               pegs_min=100, pegs_max=300, length_median=280,
               length_sigma=0.6, length_min=30, length_max=5000,
               role_share=0.5, two_role_share=0.02, substitution_rate=0.03)
    traffic = dict(weighted=weighted)
    torch.set_num_threads(2)
    return sys_apply.Cell(cfg, traffic, 2**35 + 1, torch.device("cpu"))


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_apply_reference_against_the_program(monkeypatch, weighted, flat):
    cell = _apply_cell(weighted, monkeypatch, flat)
    assert cell.engine.mode == ("flat" if flat else "wide")
    for g, genome in enumerate(cell.genomes):
        cell.kept.append((g, cell.engine.call_genome(genome)))
    cell.free()
    checks = cell.check({"call_mismatches": 0, "role_mismatches": 0,
                         "tally_gap": 0.0})
    assert all(v == 0 for k, (v, _) in checks.items()
               if k != "genomes_checked"), checks
    assert checks["genomes_checked"][0] == 3


def test_apply_reference_against_a_dict():
    """The unanimity and weighted votes, one protein at a time."""
    rng = np.random.default_rng(3)
    k = 4
    prots = ["".join(C.AMINO_ACIDS[i] for i in rng.integers(0, 5, n))
             for n in (3, 12, 30, 25, 9)]
    kmers = sorted({p[i: i + k] for p in prots
                    for i in range(len(p) - k + 1)})
    keep = [km for j, km in enumerate(kmers) if j % 3]
    roles = rng.integers(0, 3, len(keep))
    weights = rng.uniform(0.05, 3, len(keep)).astype(np.float16).astype(
        np.float32)
    keys = np.array([C.pack_windows(C.letter_codes(km), k)[0]
                     for km in keep], np.uint64)
    letters = np.concatenate([C.letter_codes(p) for p in prots])
    offsets = np.r_[0, np.cumsum([len(p) for p in prots])]
    table = ref_apply.Table(keys, roles, weights, device="cpu")
    role, hits = ref_apply.call(table, letters, offsets, k, 2)
    w_role, tally = ref_apply.call(table, letters, offsets, k, 2,
                                   weighted=True, n_roles=3)
    db = dict(zip(keep, zip(roles, weights)))
    for i, p in enumerate(prots):
        got = [db[p[j: j + k]] for j in range(len(p) - k + 1)
               if p[j: j + k] in db]
        rs = {r for r, _ in got}
        want = (int(next(iter(rs))), len(got)) if (
            len(rs) == 1 and len(got) >= 2) else (-1, 0)
        assert (role[i], hits[i]) == want
        sums = [np.float32(sum(float(w) for r, w in got if r == q))
                for q in range(3)]
        best = max(sums)
        want_w = (sums.index(best), best) if best >= 2 else (-1, 0.0)
        assert (w_role[i], tally[i]) == want_w
