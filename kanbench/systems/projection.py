"""The projection cells: a draft annotated from ordered sets of close
genomes through ``ProjectionAnnotator.annotate_genome``, as ``kmers`` /
``batch`` run it, in a closed loop.

The data, from the seed: a draft of contigs with planted genes (the
numbers of contigs and genes, the multisets of gene lengths and of genes a
contig fixed by the configuration, their order and bases drawn), and a
pool of close genomes,
each carrying every planted protein with its own substitutions.  A request
is a fresh de-annotated copy of the draft whose ``close_genomes`` are an
ordered set of the pool, given falling closeness so that the tool takes
them in that order.  The traffic file says how the sets are drawn:
``rotating`` (a new ordered set a request, never one used before in the
run, so no cached close set is found) or ``fixed`` (one ordered set, built
in set-up and found cached by every request).
"""

from __future__ import annotations

import time

import numpy as np

from ..reference import codes as C
from ..reference import projection as ref

DRAFT_ID = "400.1"


def _sense_codons() -> np.ndarray:
    stop, _ = C.codon_classes()
    return np.flatnonzero(~stop[:64])


def contig_genes(config: dict, rng) -> np.ndarray:
    """Genes a contig, in the draft's contig order: a multiset fixed by the
    configuration (one each, the rest spread by an exponential law's
    quantiles, as a draft's contig lengths fall), in the seed's order."""
    n, n_genes = config["contigs"], config["n_genes"]
    w = -np.log1p(-(np.arange(n) + 0.5) / n)
    cut = np.rint(np.cumsum(w) / w.sum() * (n_genes - n)).astype(np.int64)
    return rng.permutation(1 + np.diff(np.r_[0, cut]))


def contig_id(i: int) -> str:
    return f"{DRAFT_ID}.con.{i + 1:04d}"


def make_data(config: dict, seed: int) -> dict:
    """The draft's contigs (id, DNA) and the pool's close genomes (raw GTO
    dicts), from the seed."""
    rng = np.random.default_rng(seed)
    n_genes = config["n_genes"]
    n_cod = np.rint(np.linspace(config["codons_min"], config["codons_max"],
                                n_genes)).astype(np.int64)
    n_cod = rng.permutation(n_cod)
    sense = _sense_codons()
    cod = sense[rng.integers(0, len(sense), int(n_cod.sum()))]
    bases = np.stack([cod // 16, (cod // 4) % 4, cod % 4], 1).astype(np.uint8)
    atg, taa = C.base_codes("atg"), C.base_codes("taa")
    lead, gap = config["lead_bases"], config["spacer_bases"]
    per_contig = contig_genes(config, rng)
    spacer = rng.integers(0, 4, lead * len(per_contig)
                          + gap * n_genes).astype(np.uint8)
    starts = np.cumsum(np.r_[0, n_cod[:-1]])
    letter_of = np.frombuffer(C.BASES.encode(), np.uint8)
    contigs, i = [], 0
    for c, n_here in enumerate(per_contig):
        parts = [spacer[lead * c: lead * (c + 1)]]
        for _ in range(n_here):
            gene = np.concatenate([atg, bases[starts[i]: starts[i] + n_cod[i]]
                                   .reshape(-1), taa])
            parts.append(gene if i % 2 == 0
                         else C.reverse_complement_codes(gene))
            o = lead * len(per_contig) + gap * i
            parts.append(spacer[o: o + gap])
            i += 1
        dna = letter_of[np.concatenate(parts)].tobytes().decode()
        contigs.append((contig_id(c), dna))
    letters = np.frombuffer(C.TABLE_11.encode(), np.uint8)[cod]
    letters = letters.tobytes().decode()
    proteins = ["M" + letters[s: s + n] for s, n in zip(starts, n_cod)]
    pool = {}
    aa = np.frombuffer(C.AMINO_ACIDS.encode(), np.uint8)
    aa_index = np.full(256, 0, np.int64)
    aa_index[aa] = np.arange(20)
    flat = np.frombuffer("".join(proteins).encode(), np.uint8)
    lengths = np.array([len(p) for p in proteins])
    bounds = np.cumsum(np.r_[0, lengths])
    for j in range(config["pool_genomes"]):
        gid = f"{300 + j}.1"
        sub = rng.random(len(flat)) < config["substitution_rate"]
        new = flat.copy()
        idx = aa_index[flat[sub]] + rng.integers(1, 20, int(sub.sum()))
        new[sub] = aa[idx % 20]
        text = new.tobytes().decode()
        feats = [{"id": f"fig|{gid}.peg.{i + 1}", "type": "CDS",
                  "function": f"Projected role number {i + 1}",
                  "location": [["oc", str(1000 * i + 1), "+",
                                3 * lengths[i] + 3]],
                  "protein_translation": text[bounds[i]: bounds[i + 1]],
                  "annotations": [], "aliases": []}
                 for i in range(n_genes)]
        pool[gid] = {"id": gid, "scientific_name": "Oldus",
                     "genetic_code": 11, "domain": "Bacteria",
                     "features": feats,
                     "contigs": [{"id": "oc", "dna": "acgt" * 50}],
                     "close_genomes": [], "subsystems": []}
    return dict(contigs=contigs, pool=pool)


def request_raw(contigs: list, close_ids: list) -> dict:
    """A de-annotated draft of ``contigs`` whose close genomes are
    ``close_ids``, closest first."""
    return {"id": DRAFT_ID, "scientific_name": "Novus", "genetic_code": 11,
            "domain": "Bacteria", "features": [],
            "contigs": [{"id": cid, "dna": dna, "genetic_code": 11}
                        for cid, dna in contigs],
            "close_genomes": [{"genome": gid, "genome_name": "Oldus",
                               "closeness_measure": 99.0 - 0.01 * r}
                              for r, gid in enumerate(close_ids)],
            "subsystems": []}


class CloseSets:
    """The ordered close sets of a run, drawn from the seed."""

    def __init__(self, traffic: dict, pool_ids: list, n_close: int,
                 seed: int):
        self.rng = np.random.default_rng([seed, 1])
        self.pool_ids = pool_ids
        self.n_close = n_close
        self.rotating = traffic["close_sets"] == "rotating"
        self.used: set = set()
        self.fixed = self._draw() if not self.rotating else None

    def _draw(self) -> tuple:
        """A new ordered set; a set used before only when a hundred draws
        in a row find none (a pool far smaller than the configuration's)."""
        for _ in range(100):
            got = tuple(self.pool_ids[i] for i in self.rng.permutation(
                len(self.pool_ids))[: self.n_close])
            if got not in self.used:
                break
        self.used.add(got)
        return got

    def next(self) -> tuple:
        return self._draw() if self.rotating else self.fixed

    def warm_sets(self) -> list:
        """Set-up's close sets: the fixed set, or sets that hold every
        genome of the pool (each also barred from the window)."""
        if not self.rotating:
            return [self.fixed]
        out, seen = [], set()
        while len(seen) < len(self.pool_ids):
            s = self._draw()
            out.append(s)
            seen.update(s)
        return out


def features_of(genome) -> list:
    """A genome's features as the check compares them."""
    return [(f.id, f.function, f.location.contig_id, f.location.strand,
             f.location.left, f.location.right) for f in genome.features]


class Cell:
    """One projection cell: set-up, the window, the check."""

    e2e = ("s_per_genome", "peak_device_gib", "setup_s")

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from kmers_anno_tpu_torch.engine.projection import (
            ProjectionAnnotator)
        from kmers_anno_tpu_torch.genome.gto import Genome

        self.config, self.traffic, self.device = config, traffic, device
        self.Genome = Genome
        data = make_data(config, seed)
        self.contigs = data["contigs"]
        self.pool_raw = data["pool"]
        self.pool = {gid: Genome(raw) for gid, raw in data["pool"].items()}
        self.sets = CloseSets(traffic, list(self.pool), config["n_genomes"],
                              seed)
        self.annot = ProjectionAnnotator(
            min_strength=config["min_strength"], max_fuzz=config["max_fuzz"],
            min_fuzz=config["min_fuzz"], max_genomes=config["n_genomes"],
            min_evidence=config["min_evidence"], k=config["k"],
            device=device)
        self.done: list = []
        self.failed = 0

    def route_counters(self) -> dict:
        """The program's launch counters of this path's kernels and its
        host table builds."""
        from kmers_anno_tpu_torch.engine import projection
        from kmers_anno_tpu_torch.ops.contig_scan import scan_stream
        from kmers_anno_tpu_torch.ops.table_build import build_wide
        from kmers_anno_tpu_torch.ops.widetable import probe_wide

        return {"contig_scan": scan_stream.launches,
                "probe_wide": probe_wide.launches,
                "table_build_wide": build_wide.launches,
                "host_fallback": projection.host_fallback.count}

    def facts(self) -> dict:
        """What the cached close sets hold: their unions' distinct keys."""
        sets = list(self.annot._closeset_cache.values())
        return {"union_keys": [cs.n_union_keys for cs in sets]}

    def request(self, close_ids) -> object:
        return self.Genome(request_raw(self.contigs, list(close_ids)))

    def warm_up(self, sync) -> None:
        """Every close genome's singletons and every kernel of the path,
        through the entry the window drives."""
        for s in self.sets.warm_sets():
            self.annot.annotate_genome(self.request(s), self.pool.get)
        sync()

    def window(self, seconds: float, sync, clock=time.perf_counter) -> dict:
        t0 = clock()
        while True:
            ids = self.sets.next()
            genome = self.request(ids)
            stats = self.annot.annotate_genome(genome, self.pool.get)
            sync()
            self.done.append((ids, genome, stats))
            if clock() - t0 >= seconds:
                break
        window_s = clock() - t0
        return dict(window_s=window_s, n_done=len(self.done),
                    s_per_genome=window_s / len(self.done))

    def free(self) -> None:
        """Drop the program's state, keeping what the window produced."""
        self.done = [(ids, features_of(g), stats)
                     for ids, g, stats in self.done]
        self.annot = None
        self.pool = None

    def check(self, limits: dict, control: bool = False) -> dict:
        """Every genome of the window against the reference: features that
        differ (either side's that the other lacks), and genomes whose
        counts differ."""
        got, self.failed = check_outputs(self.config, self.contigs,
                                         self.pool_raw, self.done, limits,
                                         control)
        return got


def reference_calls(config: dict, contigs: list, pool_raw: dict,
                    ids) -> tuple[ref.Draft, dict]:
    draft = ref.Draft(DRAFT_ID, contigs, config["k"])
    calls = {}
    for gid in ids:
        pegs = [(f["id"], f["function"], f["protein_translation"])
                for f in pool_raw[gid]["features"]
                if f.get("type") in ("CDS", "peg")
                and f.get("protein_translation")]
        calls[gid] = ref.CloseGenomeCalls(
            draft, pegs, min_strength=config["min_strength"],
            max_fuzz=config["max_fuzz"], min_fuzz=config["min_fuzz"],
            min_evidence=config["min_evidence"])
    return draft, calls


def reference_outputs(config, draft, calls, ids,
                      n_genomes=None) -> tuple[list, dict]:
    close = [(gid, 99.0 - 0.01 * r) for r, gid in enumerate(ids)]
    order = ref.close_order(close, n_genomes or config["n_genomes"])
    return ref.annotate(draft, [calls[g] for g in order])


def check_outputs(config, contigs, pool_raw, done, limits, control=False):
    """``control``: the reference in the program's place, taking one close
    genome fewer than the configuration's ``n_genomes``."""
    used = sorted({g for ids, _, _ in done for g in ids})
    draft, calls = reference_calls(config, contigs, pool_raw, used)
    want: dict = {}
    n_feat = n_stats = failed = 0
    for ids, feats, stats in done:
        if ids not in want:
            want[ids] = reference_outputs(config, draft, calls, ids)
        if control:
            feats, stats = reference_outputs(config, draft, calls, ids,
                                             config["n_genomes"] - 1)
        w_feats, w_stats = want[ids]
        bad = len(set(feats) ^ set(w_feats))
        n_feat += bad
        n_stats += int(stats != w_stats)
        failed += int(bad > 0 or stats != w_stats)
    return {"genomes_checked": (len(done), None),
            "feature_mismatches": (n_feat, limits["feature_mismatches"]),
            "stats_mismatches": (n_stats, limits["stats_mismatches"])}, failed
