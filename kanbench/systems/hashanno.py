"""The hashAnno cell: batches of one species' genomes re-annotated against a
role annotation file through ``annotate_genomes_batched``, as the
``hashAnno`` command's ``run_command`` drives it: one ``PrototypeSet``
packed once, at set-up, then a batch of the configuration's ``batch``
genomes a device pass, one batch at a time, in a closed loop over the
pool's batches in order, starting at the first after the warm-up.  The
command's GTO loads and file writes are its I/O and stay out.

The data, from the seed:

* Prototypes: random proteins whose lengths are the log-normal law's
  quantiles (every seed holds the same lengths, in its own order), over
  ``annotations`` distinct annotations, each used equally often.  A share
  are exact copies of an earlier prototype of the same length under
  another annotation, so a protein can tie between two.
* Genomes, ``batch`` a species: a share of a genome's features hold no
  usable protein (empty, or holding a '*'); a share are exact copies of a
  peg of another genome of its batch, under an old annotation of their
  own; the rest are its own pegs.  Of those, a share are derived from a
  prototype at a substitution rate spread evenly over a range (the
  prototypes taken by length rank, so every seed holds the same lengths),
  half of them under their prototype's annotation, the rest under another;
  the others are random.  One random peg of each genome carries the
  batch's conserved 8-residue motif.
"""

from __future__ import annotations

import time
from statistics import NormalDist

import numpy as np

from ..reference import hashanno as ref

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
MOTIF = 8                   # residues of a batch's conserved motif


def quantile_lengths(n: int, config: dict) -> np.ndarray:
    """``n`` lengths: the log-normal law's quantiles, clipped, sorted."""
    law = NormalDist(np.log(config["length_median"]), config["length_sigma"])
    q = np.array([law.inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.rint(np.exp(q)), config["length_min"],
                   config["length_max"]).astype(np.int64)


def annotation(a: int) -> str:
    return f"Protein family {a:05d}"


class Letters:
    """Sequences of residues as one buffer, cut into strings at the end."""

    def __init__(self):
        self.parts: list = []

    def add(self, letters: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """Sequences of ``lengths`` out of the flat ``letters``; their
        indices."""
        base = sum(len(n) for _, n in self.parts)
        self.parts.append((letters, lengths))
        return base + np.arange(len(lengths))

    def strings(self) -> list:
        out = []
        for letters, lengths in self.parts:
            text = letters.tobytes().decode()
            ends = np.cumsum(lengths)
            out.extend(text[e - n: e] for e, n in zip(ends, lengths))
        return out


def _substitute(letters: np.ndarray, rate: np.ndarray, rng) -> np.ndarray:
    """Residues, each replaced by another with its probability in
    ``rate`` (one a residue)."""
    out = letters.copy()
    sub = rng.random(len(out)) < rate
    idx = np.searchsorted(AA, out[sub])
    out[sub] = AA[(idx + rng.integers(1, len(AA), int(sub.sum()))) % len(AA)]
    return out


def _random(n: int, rng) -> np.ndarray:
    return AA[rng.integers(0, len(AA), n)]


def make_prototypes(config: dict, rng) -> tuple:
    """The prototypes' letters (one buffer), lengths, offsets and
    annotation ids, and the positions that copy an earlier prototype."""
    n = config["prototypes"]
    lengths = rng.permutation(quantile_lengths(n, config))
    letters = _random(int(lengths.sum()), rng)
    offsets = np.r_[0, np.cumsum(lengths)]
    annos = rng.permutation(np.arange(n) % config["annotations"])
    # copies: pairs of adjacent length ranks of equal length, the later
    # position an exact copy of the earlier under another annotation
    rank = np.argsort(lengths, kind="stable")
    pairs = rank[: n // 2 * 2].reshape(-1, 2)
    same = np.flatnonzero(lengths[pairs[:, 0]] == lengths[pairs[:, 1]])
    n_copy = int(round(config["copy_share"] * n))
    chosen = pairs[rng.permutation(same)[:n_copy]]
    orig, copy = chosen.min(1), chosen.max(1)
    for o, c in zip(orig, copy):
        letters[offsets[c]: offsets[c + 1]] = \
            letters[offsets[o]: offsets[o + 1]]
    shift = rng.integers(1, config["annotations"], len(copy))
    annos[copy] = (annos[orig] + shift) % config["annotations"]
    return letters, lengths, offsets, annos, copy


def make_data(config: dict, seed: int) -> dict:
    """Prototype rows (protein, annotation) and the pool's batches: a list
    a batch of genomes, each a list of (id, function, protein) features."""
    rng = np.random.default_rng(seed)
    p_letters, p_len, p_off, p_anno, copies = make_prototypes(config, rng)
    n_anno = config["annotations"]
    G, F = config["pool_genomes"], config["pegs_per_genome"]
    B = config["batch"]
    n_skip = int(round(config["skipped_share"] * F))
    n_copy = int(round(config["species_share"] * F))
    n_own = F - n_skip - n_copy
    n_der = int(round(config["derived_share"] * n_own))
    n_rand = n_own - n_der
    seqs = Letters()

    # derived pegs: prototypes by length rank, stratified over all of them
    m = G * n_der
    by_len = np.argsort(p_len, kind="stable")
    src = rng.permutation(by_len[((np.arange(m) + 0.5) * len(p_len)
                                  / m).astype(np.int64)])
    d_len = p_len[src]
    rate = rng.permutation(np.linspace(config["substitution_min"],
                                       config["substitution_max"], m))
    d_letters = np.concatenate([p_letters[p_off[s]: p_off[s + 1]]
                                for s in src])
    d_letters = _substitute(d_letters, np.repeat(rate, d_len), rng)
    d_idx = seqs.add(d_letters, d_len)
    confirmed = np.zeros(m, bool)
    confirmed[rng.permutation(m)[: m // 2]] = True
    d_old = np.where(confirmed, p_anno[src],
                     (p_anno[src] + rng.integers(1, n_anno, m)) % n_anno)

    # random pegs; a motif a batch in one random peg of each genome
    r_len = rng.permutation(quantile_lengths(G * n_rand, config))
    r_letters = _random(int(r_len.sum()), rng)
    r_start = np.r_[0, np.cumsum(r_len)]
    for b in range(G // B):
        motif = _random(MOTIF, rng)
        for g in range(b * B, (b + 1) * B):
            i = g * n_rand + int(rng.integers(0, n_rand))
            at = r_start[i] + int(rng.integers(0, r_len[i] - MOTIF + 1))
            r_letters[at: at + MOTIF] = motif
    r_idx = seqs.add(r_letters, r_len)
    # features without a usable protein: half empty, half holding a '*'
    n_empty = G * n_skip // 2
    s_len = rng.permutation(quantile_lengths(G * n_skip - n_empty, config))
    s_letters = _random(int(s_len.sum()), rng)
    s_letters[np.r_[0, np.cumsum(s_len)][:-1]
              + rng.integers(0, s_len)] = ord("*")
    s_idx = seqs.add(s_letters, s_len)
    texts = seqs.strings()
    skipped = rng.permutation(np.array([""] * n_empty
                                       + [texts[i] for i in s_idx],
                                       dtype=object))

    batches = []
    for b in range(G // B):
        own = []
        for g in range(b * B, (b + 1) * B):
            d = slice(g * n_der, (g + 1) * n_der)
            feats = [(texts[i], annotation(a))
                     for i, a in zip(d_idx[d], d_old[d])]
            feats += [(texts[i], annotation(int(rng.integers(0, n_anno))))
                      for i in r_idx[g * n_rand: (g + 1) * n_rand]]
            own.append(feats)
        genomes = []
        for j, g in enumerate(range(b * B, (b + 1) * B)):
            others = [p for jj in range(B) if jj != j for p, _ in own[jj]]
            pick = rng.integers(0, len(others), n_copy)
            feats = list(own[j])
            feats += [(others[i], annotation(int(rng.integers(0, n_anno))))
                      for i in pick]
            feats += [(t, annotation(int(rng.integers(0, n_anno))))
                      for t in skipped[g * n_skip: (g + 1) * n_skip]]
            order = rng.permutation(len(feats))
            gid = f"{1000 + b}.{j + 1}"
            genomes.append([(f"fig|{gid}.peg.{i + 1}", feats[o][1],
                             feats[o][0]) for i, o in enumerate(order)])
        batches.append(genomes)
    p_texts = Letters()
    p_texts.add(p_letters, p_len)
    protos = [(p, annotation(int(a)))
              for p, a in zip(p_texts.strings(), p_anno)]
    return dict(prototypes=protos, batches=batches, copies=copies)



def no_hugepage_advice() -> None:
    """NumPy's ``NUMPY_MADVISE_HUGEPAGE=0``, set in the running process:
    no huge-page advice on its large arrays.  Each batch's index build
    makes fresh arrays of tens of MB; on a host that backs such advice
    slowly (the card's, a sandbox) the advice made a batch slower, and
    by an amount that differed between processes."""
    try:
        from numpy._core.multiarray import _set_madvise_hugepage
    except ImportError:                 # numpy 1.x
        from numpy.core.multiarray import _set_madvise_hugepage
    _set_madvise_hugepage(False)


def genome_raw(feats: list) -> dict:
    gid = feats[0][0].split("|")[1].rsplit(".peg.", 1)[0]
    return {"id": gid, "scientific_name": f"Species {gid.split('.')[0]}",
            "genetic_code": 11, "domain": "Bacteria",
            "features": [{"id": fid, "type": "CDS", "function": function,
                          "protein_translation": prot}
                         for fid, function, prot in feats],
            "contigs": [], "subsystems": []}


class Cell:
    """The hashAnno cell: set-up, the window, the check."""

    e2e = ("s_per_genome", "peak_device_gib", "setup_s")

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from kmers_anno_tpu_torch.engine import hashanno
        from kmers_anno_tpu_torch.genome.gto import Genome

        no_hugepage_advice()
        self.config, self.traffic, self.device = config, traffic, device
        self.hashanno = hashanno
        self.data = make_data(config, seed)
        # the annotation file's rows as the command keeps them
        protos = [hashanno.Prototype(p, a)
                  for p, a in self.data["prototypes"]
                  if a.strip() and len(p) >= config["min_len"]]
        self.protoset = hashanno.PrototypeSet(protos, config["k"])
        self.batches = [[Genome(genome_raw(f)) for f in batch]
                        for batch in self.data["batches"]]
        self.done: list = []             # (batch, rows a genome)
        self.failed = 0

    def route_counters(self) -> dict:
        """The chunk kernels' launch counters, and the indexes scored on
        the host route (where the program counts them)."""
        from kmers_anno_tpu_torch.ops.hash_chunk import (hash_best,
                                                         hash_commons)

        out = {"hash_commons": hash_commons.launches,
               "hash_best": hash_best.launches}
        host = getattr(self.hashanno.GenomeProteinKmers, "host_route", None)
        if host is not None:
            out["hash.host_route"] = host
        return out

    def facts(self) -> dict:
        """Batches the window ran and genomes a batch; the prototype
        chunks packed, by chunk size."""
        sizes = {str(chunk): len(got)
                 for (chunk, _), got in self.protoset._cache.items()}
        return {"batches": len(self.done), "batch": self.config["batch"],
                "prototype_chunks": sizes}

    def _run(self, b: int) -> list:
        cfg = self.config
        return self.hashanno.annotate_genomes_batched(
            self.batches[b], self.protoset, cfg["k"], cfg["min_sim"],
            device=self.device)

    def warm_up(self, sync) -> None:
        """The last batch once: the prototypes packed, the kernels built
        and the host scratch buffers made; every batch has the same
        shapes (the table's buckets, the owner matrix, the padded
        proteins, the chunks)."""
        self._run(len(self.batches) - 1)
        sync()

    def window(self, seconds: float, sync, clock=time.perf_counter) -> dict:
        """Batches in order from the first, a batch a device pass, until
        ``seconds`` have passed; the last batch counts whole."""
        t0 = clock()
        i = 0
        while True:
            b = i % len(self.batches)
            results = self._run(b)
            sync()
            self.done.append((b, [rows for rows, _, _ in results]))
            i += 1
            if clock() - t0 >= seconds:
                break
        window_s = clock() - t0
        n_done = sum(len(rows) for _, rows in self.done)
        return dict(window_s=window_s, n_done=n_done,
                    s_per_genome=window_s / n_done)

    def free(self) -> None:
        """Drop the program's state, keeping what the window produced."""
        self.protoset = None
        self.batches = None

    def check(self, limits: dict, control: bool = False) -> dict:
        """Every row of every window batch against the reference's rows
        for that batch, byte for byte: rows that differ, or that either
        side lacks.  ``control`` puts the reference with ties sent to the
        latest prototype in the program's place."""
        cfg = self.config
        protos = ref.Prototypes(self.data["prototypes"], cfg["k"],
                                cfg["min_len"])
        want, ctl = {}, {}
        for b in sorted({b for b, _ in self.done}):
            batch = self.data["batches"][b]
            want[b] = ref.batch_rows(batch, protos, cfg["min_sim"])
            if control:
                ctl[b] = ref.batch_rows(batch, protos, cfg["min_sim"],
                                        latest=True)
        n_bad = 0
        self.failed = 0
        for b, got in self.done:
            if control:
                got = ctl[b]
            for g_rows, w_rows in zip(got, want[b]):
                bad = sum(1 for x, y in zip(g_rows, w_rows) if x != y)
                bad += abs(len(g_rows) - len(w_rows))
                n_bad += bad
                self.failed += int(bad > 0)
            n_bad += sum(len(r) for r in want[b][len(got):])
            n_bad += sum(len(r) for r in got[len(want[b]):])
        return {"batches_checked": (len(self.done), None),
                "row_mismatches": (n_bad, limits["row_mismatches"])}
