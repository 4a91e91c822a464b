"""The plain reference of ORF projection (SEEDtk ``kmers.anno``
KmerProcessor.annotateGenome), in NumPy.

What a close genome gives the draft does not depend on the other close
genomes, so the work is split as the tool's loop allows: ``CloseGenomeCalls``
holds one close genome's candidate proposals against one draft, and
``annotate`` replays the candidates of an ordered close set through the
proposal list.  Semantics, as the tool defines them:

* the draft's kmers: each contig, strand ('+' then '-') and frame (1-3)
  translated with the genetic code; window i of a frame's protein for
  i < len(protein) - k (the last window is dropped); windows with a stop
  or an ambiguous residue ('*', 'X') are skipped; a window's location is
  left = 3i + frame on '+', len(contig) - 3k + 2 - (3i + frame) on '-',
  right = left + 3k - 1;
* a close genome's kmers: the same drop-last windows of each peg's protein,
  'X' windows skipped; only kmers found once in the whole genome count;
* each (frame, peg) pair gathers the draft locations of the peg's kmers,
  sorted by (contig, left, right); with L = 3 * protein length, a pair with
  fewer than int(L * s / 3) locations is dropped (s the minimum strength);
  otherwise each location i up to len - int(L * s / 3) proposes
  (left_i, best edge) with evidence 1 + the later locations on its contig
  whose right edge is below left_i + int(1.5 L + 1) (the best edge the
  largest of those rights), when the best edge reaches left_i + int(0.8 L);
* a proposal extends to a start codon (ttg, ctg, atg) upstream, from its
  begin codon and failing at a stop or the contig's end, and to the first
  stop codon downstream; it is rejected if either fails, weak if evidence
  over length is below s / 3, small if evidence is below the minimum;
  one proposal an ORF (contig, end, strand) is kept, a later one replacing
  it only with more evidence, or as much and a longer ORF;
* the close genomes are taken closest first (ties by genome id), at most
  ``n_genomes``; the kept proposals are numbered by (contig, left, length).
"""

from __future__ import annotations

import numpy as np

from . import codes as C

# Location.frame: '-' frames 0-2 by right % 3, '+' frames 3-5 by left % 3
_X = C.letter_codes("X")[0]


class Draft:
    """A draft genome's kmer windows and codon classes, made once.

    contigs: list of (contig id, DNA string), in the genome's order."""

    def __init__(self, genome_id: str, contigs: list, k: int):
        self.genome_id = genome_id
        self.k = k
        self.contig_ids = [cid for cid, _ in contigs]
        letters = C.codon_letters()
        stop, start = C.codon_classes()
        keys, cidx, strand, left = [], [], [], []
        self.classes = []            # per contig: (n, plus, minus)
        for ci, (_, dna) in enumerate(contigs):
            fwd = C.base_codes(dna)
            n = len(fwd)
            self.classes.append(_codon_class_arrays(fwd, stop, start))
            for s, seq in ((0, fwd), (1, C.reverse_complement_codes(fwd))):
                for frame in (1, 2, 3):
                    prot = letters[C.codon_ids(seq, frame - 1)]
                    n_win = len(prot) - k          # the last one dropped
                    if n_win <= 0:
                        continue
                    key = C.pack_windows(prot, k)[:n_win]
                    bad = C.window_has((prot == C.STOP) | (prot == _X),
                                       k)[:n_win]
                    i = np.flatnonzero(~bad)
                    pos = 3 * i + frame
                    lft = pos if s == 0 else (n - 3 * k + 2) - pos
                    keys.append(key[i])
                    cidx.append(np.full(len(i), ci, np.int64))
                    strand.append(np.full(len(i), s, np.int8))
                    left.append(lft.astype(np.int64))
        key = np.concatenate(keys) if keys else np.zeros(0, np.uint64)
        # scan order is the order above; windows sorted by key, stably
        self.order = np.argsort(key, kind="stable")
        self.key = key
        self.sorted_key = key[self.order]
        self.contig = np.concatenate(cidx) if cidx else np.zeros(0, np.int64)
        self.strand = (np.concatenate(strand) if strand
                       else np.zeros(0, np.int8))
        self.left = np.concatenate(left) if left else np.zeros(0, np.int64)
        self.right = self.left + 3 * k - 1
        self.frame = np.where(self.strand == 0, 3 + self.left % 3,
                              self.right % 3)


def _codon_class_arrays(fwd: np.ndarray, stop: np.ndarray,
                        start: np.ndarray):
    """Per 0-based position p of a contig, the codon seq[p:p+3] read on
    '+' and its reverse complement read on '-': stop and start flags."""
    n = len(fwd)
    if n < 3:
        e = np.zeros(0, bool)
        return n, (e, e), (e, e)
    c = fwd.astype(np.int64)
    ok = (c[:-2] < 4) & (c[1:-1] < 4) & (c[2:] < 4)
    plus = np.where(ok, c[:-2] * 16 + c[1:-1] * 4 + c[2:], 64)
    comp = np.array([2, 3, 0, 1, 4], np.int64)[c]
    minus = np.where(ok, comp[2:] * 16 + comp[1:-1] * 4 + comp[:-2], 64)
    return n, (stop[plus], start[plus]), (stop[minus], start[minus])


def _next_at_or_after(flag: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """For each query position, the least p >= pos with p = pos (mod 3)
    and flag[p], else -1 (positions past the array: -1)."""
    out = np.full(len(pos), -1, np.int64)
    n = len(flag)
    for r in range(3):
        idx = np.arange(r, n, 3)
        if not len(idx):
            continue
        cand = np.where(flag[idx], idx, np.iinfo(np.int64).max)
        nxt = np.minimum.accumulate(cand[::-1])[::-1]
        q = (pos % 3 == r) & (pos >= 0) & (pos < n)
        got = nxt[pos[q] // 3]
        out[q] = np.where(got == np.iinfo(np.int64).max, -1, got)
    return out


def _last_at_or_before(flag: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """For each query position, the largest p <= pos with p = pos (mod 3)
    and flag[p], else -1."""
    out = np.full(len(pos), -1, np.int64)
    n = len(flag)
    for r in range(3):
        idx = np.arange(r, n, 3)
        if not len(idx):
            continue
        prev = np.maximum.accumulate(np.where(flag[idx], idx, -1))
        q = (pos % 3 == r) & (pos >= 0)
        j = np.minimum(pos[q], idx[-1])          # idx[-1] = r (mod 3)
        out[q] = prev[j // 3]
    return out


def extend(draft: Draft, contig: np.ndarray, strand: np.ndarray,
           left: np.ndarray, right: np.ndarray):
    """Location.extend of each (contig, strand, left, right): the new
    (left, right) and whether it succeeded."""
    ext_l = left.copy()
    ext_r = right.copy()
    ok = ((right - left + 1) % 3 == 0)
    for ci, (n, (p_stop, p_start), (m_stop, m_start)) in enumerate(
            draft.classes):
        for s in (0, 1):
            sel = np.flatnonzero((contig == ci) & (strand == s))
            if not len(sel):
                continue
            lo, hi = left[sel], right[sel]
            if s == 0:
                stop_at = _next_at_or_after(p_stop, hi)        # after end
                edge = _last_at_or_before(p_start | p_stop, lo - 1)
                good = (stop_at >= 0) & (edge >= 0)
                good &= ~p_stop[np.maximum(edge, 0)]
                ext_l[sel] = edge + 1
                ext_r[sel] = stop_at + 3
            else:
                stop_at = _last_at_or_before(m_stop, lo - 4)
                edge = _next_at_or_after(m_start | m_stop, hi - 3)
                good = (stop_at >= 0) & (edge >= 0)
                good &= ~m_stop[np.maximum(edge, 0)]
                ext_l[sel] = stop_at + 1
                ext_r[sel] = edge + 3
            ok[sel] &= good
    return ext_l, ext_r, ok


class CloseGenomeCalls:
    """One close genome's proposals for a draft: every candidate's counts
    and the live ones (after extension and the weak and small filters), in
    the tool's candidate order.

    pegs: list of (peg id, function, protein), the genome's pegs with a
    protein, in the genome's order."""

    def __init__(self, draft: Draft, pegs: list, *, min_strength=0.5,
                 max_fuzz=1.5, min_fuzz=0.8, min_evidence=10):
        k = draft.k
        real_strength = min_strength / 3
        self.functions = [f for _, f, _ in pegs]
        plen = np.array([len(p) for _, _, p in pegs], np.int64)
        # the genome's drop-last, 'X'-free windows and their counts
        keys, peg_of = [], []
        for pi, (_, _, prot) in enumerate(pegs):
            let = C.letter_codes(prot)
            n_win = len(let) - k
            if n_win <= 0:
                continue
            key = C.pack_windows(let, k)[:n_win]
            key = key[~C.window_has(let == _X, k)[:n_win]]
            keys.append(key)
            peg_of.append(np.full(len(key), pi, np.int64))
        key = np.concatenate(keys) if keys else np.zeros(0, np.uint64)
        peg_of = (np.concatenate(peg_of) if peg_of
                  else np.zeros(0, np.int64))
        dkey, d_order = draft.sorted_key, draft.order
        uniq, first, count = np.unique(key, return_index=True,
                                       return_counts=True)
        single = np.sort(first[count == 1])          # first-occurrence order
        s_key, s_peg = key[single], peg_of[single]
        # every (singleton, draft window) pair with equal keys
        by_key = np.argsort(s_key)          # sorted queries search faster
        lo = np.empty(len(s_key), np.int64)
        hi = np.empty(len(s_key), np.int64)
        lo[by_key] = np.searchsorted(dkey, s_key[by_key], "left")
        hi[by_key] = np.searchsorted(dkey, s_key[by_key], "right")
        n_hit = hi - lo
        s_idx = np.repeat(np.arange(len(s_key)), n_hit)
        w_pos = (np.arange(n_hit.sum())
                 - np.repeat(np.cumsum(n_hit) - n_hit, n_hit) + lo[s_idx])
        w = d_order[w_pos]           # window index, in scan order per key
        peg = s_peg[s_idx]
        frame = draft.frame[w]
        # (frame, peg) groups in the order the tool first fills them:
        # singletons in order, each key's windows in scan order
        group = peg * 6 + frame
        first_seen = np.unique(group, return_index=True)
        rank = np.empty(first_seen[0].max() + 1 if len(group) else 0,
                        np.int64)
        rank[first_seen[0][np.argsort(first_seen[1])]] = np.arange(
            len(first_seen[0]))
        g_rank = rank[group] if len(group) else group
        contig, left = draft.contig[w], draft.left[w]
        right = draft.right[w]
        order = np.lexsort((right, left, contig, g_rank))
        g_rank, contig, left, right = (g_rank[order], contig[order],
                                       left[order], right[order])
        peg, strand = peg[order], draft.strand[w][order]
        m = len(order)
        g_start = np.flatnonzero(np.r_[True, g_rank[1:] != g_rank[:-1]]) \
            if m else np.zeros(0, np.int64)
        g_size = np.diff(np.r_[g_start, m])
        pos_in = np.arange(m) - np.repeat(g_start, g_size)
        size = np.repeat(g_size, g_size)
        peg_len3 = plen[peg] * 3
        max_len = (peg_len3 * max_fuzz + 1).astype(np.int64)
        min_len = (peg_len3 * min_fuzz).astype(np.int64)
        min_kmers = (peg_len3 * real_strength).astype(np.int64)
        # evidence: locations after i on its contig ending before
        # left_i + max_len (rights ascend within a (group, contig) run)
        seg = np.cumsum(np.r_[True, (g_rank[1:] != g_rank[:-1])
                              | (contig[1:] != contig[:-1])]) \
            if m else np.zeros(0, np.int64)
        span = int(right.max()) + int(max_len.max()) + 2 if m else 1
        comp = seg * span + right
        idx = np.searchsorted(comp, seg * span + left + max_len, "left")
        evidence = idx - np.arange(m)
        best = right[np.maximum(idx - 1, 0)] if m else right
        cand = (pos_in <= size - min_kmers) & (best >= left + min_len)
        c = np.flatnonzero(cand)
        self.made = len(c)
        c_contig, c_strand = contig[c], strand[c]
        c_ev, c_func = evidence[c], peg[c]
        ext_l, ext_r, ok = extend(draft, c_contig, c_strand, left[c],
                                  best[c])
        length = ext_r - ext_l + 1
        self.rejected = int((~ok).sum())
        with np.errstate(divide="ignore", invalid="ignore"):
            weak = ok & (c_ev / length < real_strength)
        self.weak = int(weak.sum())
        small = ok & ~weak & (c_ev < min_evidence)
        self.small = int(small.sum())
        live = ok & ~weak & ~small
        self.live = dict(contig=c_contig[live], strand=c_strand[live],
                         left=ext_l[live], right=ext_r[live],
                         evidence=c_ev[live], func=c_func[live])


def close_order(close: list, n_genomes: int) -> list:
    """The close genomes the tool takes: (genome id, closeness) sorted
    closest first, ties by id, the first ``n_genomes`` of those present."""
    got = sorted(close, key=lambda c: (-c[1], c[0]))
    return [gid for gid, _ in got][:n_genomes]


def annotate(draft: Draft, calls: list) -> tuple[list, dict]:
    """Replay the ordered close genomes' ``CloseGenomeCalls`` through one
    proposal list: the draft's features (peg id, function, contig id,
    strand, left, right) in numbering order, and the proposal counts."""
    parts = [c.live for c in calls]
    cat = {f: np.concatenate([p[f] for p in parts]) for f in parts[0]} \
        if parts else {}
    funcs = []
    for c in calls:
        funcs.append(c.functions)
    func_base = np.cumsum([0] + [len(f) for f in funcs])[:-1]
    func_all = [f for fl in funcs for f in fl]
    gfunc = (np.concatenate([p["func"] + b for p, b in zip(parts, func_base)])
             if parts else np.zeros(0, np.int64))
    stats = dict(made=sum(c.made for c in calls), merged=0,
                 rejected=sum(c.rejected for c in calls),
                 weak=sum(c.weak for c in calls),
                 small=sum(c.small for c in calls), kept=0)
    m = len(gfunc)
    if not m:
        stats["pegs"] = 0
        return [], stats
    end = np.where(cat["strand"] == 0, cat["right"], cat["left"])
    length = cat["right"] - cat["left"] + 1
    order = np.lexsort((np.arange(m), cat["strand"], end, cat["contig"]))
    key_c, key_e, key_s = (cat["contig"][order], end[order],
                           cat["strand"][order])
    first = np.r_[True, (key_c[1:] != key_c[:-1]) | (key_e[1:] != key_e[:-1])
                  | (key_s[1:] != key_s[:-1])]
    gid = np.cumsum(first) - 1
    score = (cat["evidence"][order] << np.int64(32)) | length[order]
    # a candidate is stored when it beats every earlier one of its ORF: a
    # running max within each ORF, each ORF's ranks offset above the last
    rank = np.unique(score, return_inverse=True)[1].astype(np.int64)
    off = gid * (int(rank.max()) + 2)
    cm = np.maximum.accumulate(off + rank)
    prev = np.r_[np.int64(-1), cm[:-1]]
    prev_best = np.where(prev >= off, prev - off, -1)
    stored = rank > prev_best
    stats["merged"] = int((stored & (prev_best >= 0)).sum())
    last_stored = np.zeros(int(gid[-1]) + 1, np.int64)
    s_pos = np.flatnonzero(stored)
    last_stored[gid[s_pos]] = s_pos               # the later store wins
    win = order[last_stored]
    stats["kept"] = len(win)
    cid = [draft.contig_ids[i] for i in cat["contig"][win]]
    lft, rgt = cat["left"][win], cat["right"][win]
    srt = sorted(range(len(win)),
                 key=lambda i: (cid[i], int(lft[i]), int(rgt[i] - lft[i])))
    feats = []
    for n, i in enumerate(srt, 1):
        feats.append((f"fig|{draft.genome_id}.peg.{n}",
                      func_all[gfunc[win[i]]], cid[i],
                      "+" if cat["strand"][win[i]] == 0 else "-",
                      int(lft[i]), int(rgt[i])))
    stats["pegs"] = len(feats)
    return feats, stats
