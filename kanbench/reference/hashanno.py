"""hashAnno's scoring, written from the tool's contract
(HashAnnotationProcessor.java:221-328), not from the program.

A genome batch's usable proteins (a protein neither empty nor holding a
'*') are taken once each by sequence, case aside.  Each distinct
protein's kmer set is its distinct length-k windows, every window
counted.  A prototype (a row of the role annotation file, at least
``min_len`` long) proposes its annotation to a protein at the Jaccard
similarity c / u of their kmer sets, in float64: c the kmers they share,
u = n1 + n2 - c.  A proposal is taken only at or above ``min_sim`` and only
when strictly greater than the protein's best so far, the prototypes in
file order, so a tie goes to the earliest prototype.  A protein with no
proposal keeps its old annotation at score 0.0: in a batch, the old
annotation of its own genome's first feature with that protein.

Each feature gives a row ``(id, score, new, old)``: ``old`` the feature's
function ("hypothetical protein" where it is empty); ``score`` the
``repr`` of the float64 similarity, "0.0" for the default, and "" with
``new`` = ``old`` for a feature without a usable protein.

The counts come from a sort-join: the batch's (kmer, protein) pairs and
the prototypes' (kmer, prototype) pairs, both deduplicated and sorted by
kmer, matched on the kmer a block of protein pairs at a time, and the
matches counted by (prototype, protein) pair.  Taking each protein's
greatest similarity with ties to the earliest prototype is what the
tool's strictly-greater pass in file order gives.  ``latest=True`` sends a
tie to the latest prototype instead: the control, which breaks the tie
rule the tool guarantees.
"""

from __future__ import annotations

import numpy as np

BITS = 6                    # bits a residue in a kmer key
BLOCK = 1 << 20             # protein pairs a block of the join


def residue_codes(text: str) -> np.ndarray:
    """A protein's letters as codes: A..Z 0..25 (either case), anything
    else 26."""
    raw = np.frombuffer(text.encode("ascii", "replace"), np.uint8)
    lut = np.full(256, 26, np.int64)
    lut[65:91] = np.arange(26)
    lut[97:123] = np.arange(26)
    return lut[raw]


def kmer_pairs(seqs: list, k: int) -> tuple:
    """The distinct (kmer key, owner) pairs of the sequences, owner the
    index in ``seqs``, sorted by owner and then key; and each owner's count
    of distinct kmers."""
    if k * BITS > 62:
        raise ValueError(f"k {k} does not fit a 62-bit key")
    lengths = np.array([len(s) for s in seqs], np.int64)
    n_win = np.maximum(lengths - k + 1, 0)
    if not n_win.sum():
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(len(seqs), np.int64)
    codes = residue_codes("".join(seqs))
    starts = np.r_[0, np.cumsum(lengths)[:-1]]
    owner = np.repeat(np.arange(len(seqs)), n_win)
    pos = (np.arange(int(n_win.sum()))
           - np.repeat(np.cumsum(n_win) - n_win, n_win)
           + np.repeat(starts, n_win))
    key = np.zeros(len(pos), np.int64)
    for j in range(k):
        key |= codes[pos + j] << (BITS * j)
    shift = BITS * k
    if len(seqs) <= 1 << (63 - shift):
        # one sort of (owner, key) packed into a non-negative int64
        both = np.unique((owner << shift) | key)
        key, owner = both & ((1 << shift) - 1), both >> shift
    else:
        order = np.lexsort((key, owner))
        key, owner = key[order], owner[order]
        keep = np.ones(len(key), bool)
        keep[1:] = (key[1:] != key[:-1]) | (owner[1:] != owner[:-1])
        key, owner = key[keep], owner[keep]
    return key, owner, np.bincount(owner, minlength=len(seqs))


class Prototypes:
    """The annotation file's prototypes at least ``min_len`` long, in file
    order, with their kmer pairs sorted by kmer (computed once, for every
    batch)."""

    def __init__(self, rows: list, k: int, min_len: int):
        kept = [(p, a) for p, a in rows if a.strip() and len(p) >= min_len]
        self.annotations = [a for _, a in kept]
        key, proto, self.n2 = kmer_pairs([p.upper() for p, _ in kept], k)
        order = np.argsort(key, kind="stable")
        self.key, self.proto = key[order], proto[order]
        self.k = k

    def __len__(self) -> int:
        return len(self.annotations)


def best_proposals(seqs: list, protos: Prototypes, min_sim: float,
                   latest: bool = False) -> tuple:
    """Each distinct protein's best similarity (0.0 where none) and the
    index of the prototype that proposed it (-1 where none)."""
    p_key, p_own, n1 = kmer_pairs(seqs, protos.k)
    order = np.argsort(p_key, kind="stable")
    p_key, p_own = p_key[order], p_own[order]
    n = len(seqs)
    best = np.zeros(n, np.float64)
    winner = np.full(n, -1, np.int64)
    # the join: each protein pair's kmer among the prototypes' sorted
    # pairs, the matches expanded a block of protein pairs at a time
    lo = np.searchsorted(protos.key, p_key, "left")
    cnt = np.searchsorted(protos.key, p_key, "right") - lo
    found = []
    for s in range(0, len(p_key), BLOCK):
        c = cnt[s: s + BLOCK]
        if not c.sum():
            continue
        rep = np.repeat(np.arange(len(c)), c)
        at = np.repeat(lo[s: s + BLOCK], c) + (
            np.arange(len(rep)) - np.repeat(np.cumsum(c) - c, c))
        found.append(protos.proto[at] * n + p_own[s: s + BLOCK][rep])
    if not found:
        return best, winner
    # shared kmers counted by (prototype, protein) pair
    pair, c = np.unique(np.concatenate(found), return_counts=True)
    proto, own = pair // n, pair % n
    sim = c / (n1[own] + protos.n2[proto] - c)
    ok = sim >= min_sim
    proto, own, sim = proto[ok], own[ok], sim[ok]
    # each protein's greatest similarity; a tie to the earliest prototype
    # (the latest for the control)
    pick = np.lexsort((-proto if latest else proto, -sim, own))
    first = np.ones(len(pick), bool)
    first[1:] = own[pick][1:] != own[pick][:-1]
    pick = pick[first]
    best[own[pick]] = sim[pick]
    winner[own[pick]] = proto[pick]
    return best, winner


def batch_rows(genomes: list, protos: Prototypes, min_sim: float,
               latest: bool = False) -> list:
    """The rows of each genome of a batch, in feature order.  ``genomes``:
    a list a genome of (id, function, protein) features, protein "" or
    None where absent."""
    index: dict = {}
    for feats in genomes:
        for _, _, prot in feats:
            if prot and "*" not in prot:
                index.setdefault(prot.upper(), len(index))
    best, winner = best_proposals(list(index), protos, min_sim, latest)
    out = []
    for feats in genomes:
        first_old: dict = {}
        rows = []
        for fid, function, prot in feats:
            old = function or "hypothetical protein"
            if not prot or "*" in prot:
                rows.append((fid, "", old, old))
                continue
            seq = prot.upper()
            first_old.setdefault(seq, old)
            i = index[seq]
            if winner[i] < 0:
                rows.append((fid, "0.0", first_old[seq], old))
            else:
                rows.append((fid, repr(float(best[i])),
                             protos.annotations[winner[i]], old))
        out.append(rows)
    return out
