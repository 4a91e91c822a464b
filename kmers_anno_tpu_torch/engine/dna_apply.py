"""DNA-mode annotation over raw contigs (BASELINE config 3).

Counterpart of ``kmers_anno_tpu/engine/dna_apply.py``.  A nucleotide
signature table (k ≤ 15, built by ``build --dna`` from coding-strand CDS
DNA) is probed against every window of both strands of every raw contig,
with no gene calls, and the hits are clustered into called regions.

Dataflow:

    host:   encode the contigs once (uint8 codes), append the reverse
            complement of each contig as its own stream entry, and compute
            window validity (no ambiguous base, window inside its entry)
    device: upload codes and validity, one probe launch a genome
            (``ops.dna_probe``: the 2-bit pack, the table's key filter and
            the 8-slot table walk), download one int32 payload array
    host:   cluster hit windows into regions: consecutive same-role hits
            at most ``max_gap`` window starts apart merge; a cluster with
            at least ``min_hits`` hits (weighted: a summed weight of at
            least ``min_weight``) is called as a region feature

Region coordinates are 1-based on the forward strand; a hit at reverse-
complement window start w of a length-L contig covers forward positions
[L−w−k+1, L−w].  Clustering stays on the host in NumPy float64, as in the
reference, so the reports are the reference's byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import pow2_bucket, resolve_device
from ..genome.gto import Feature, Genome
from ..ops.dna_kmers import dna_valid_np
# the reference's name for the window probe: the kernel on a CUDA table,
# the plain version on a CPU one
from ..ops.dna_probe import probe_dna as probe_dna_flat
from ..ops.encode import DNA_PAD, encode_dna, reverse_complement_codes
from .signature import SignatureTable


class DnaContigBatch:
    """Flat two-strand token stream of one genome's contigs (host side).

    entries: list of (contig_id, strand, offset, length), one per (contig,
    strand); ``offset`` indexes into the flat ``codes`` array.  The entries
    lie back to back with no separator, padded with ``DNA_PAD`` to a power
    of two of at least ``min_tokens``; ``valid`` marks the window starts
    whose k bases lie inside one entry and are all unambiguous.
    """

    __slots__ = ("codes", "valid", "entries")

    def __init__(self, contigs: list[tuple[str, str]], k: int,
                 min_tokens: int = 1 << 16):
        parts: list[np.ndarray] = []
        valids: list[np.ndarray] = []
        self.entries: list[tuple[str, str, int, int]] = []
        pos = 0
        for cid, seq in contigs:
            fwd = encode_dna(seq)
            for strand, codes in (("+", fwd),
                                  ("-", reverse_complement_codes(fwd))):
                n = len(codes)
                v = np.zeros(n, bool)
                if n >= k:
                    v[: n - k + 1] = dna_valid_np(codes, k)
                self.entries.append((cid, strand, pos, n))
                parts.append(codes)
                valids.append(v)
                pos += n
        width = pow2_bucket(pos, min_tokens)
        self.codes = np.full(width, DNA_PAD, np.uint8)
        self.valid = np.zeros(width, bool)
        if parts:
            flat = np.concatenate(parts)
            self.codes[: len(flat)] = flat
            self.valid[: len(flat)] = np.concatenate(valids)


def split_payload_np(vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Packed (fp16 weight, role) probe payloads → (roles int32 with -1
    kept for a miss, weights float32, 0 for a miss)."""
    miss = vals < 0
    roles = np.where(miss, -1, vals & 0xFFFF).astype(np.int32)
    bits = (vals.astype(np.uint32) >> np.uint32(16)).astype(np.uint16)
    weights = bits.view(np.float16).astype(np.float32)
    return roles, np.where(miss, 0.0, weights).astype(np.float32)


def cluster_hits(roles: np.ndarray, k: int, max_gap: int, min_hits: int,
                 weights: np.ndarray | None = None,
                 min_weight: float = 0.0
                 ) -> list[tuple[int, int, int, int | float]]:
    """Cluster the hit windows of ONE stream entry.

    roles: (W,) int32, the role of each window start, -1 for a miss
    weights: optional (W,) float32 hit weights; clusters then score by
    their summed weight (float64, rounded to 4 places) and need
    ``min_weight`` instead of ``min_hits`` hits
    returns [(first_window, last_window, role_idx, score), ...], window
    starts ascending; score is the int hit count or the weight sum.
    """
    hp = np.flatnonzero(roles >= 0)
    if len(hp) == 0:
        return []
    hr = roles[hp]
    brk = np.flatnonzero((np.diff(hp) > max_gap) | (np.diff(hr) != 0))
    starts = np.concatenate([[0], brk + 1])
    ends = np.concatenate([brk, [len(hp) - 1]])
    if weights is None:
        score = (ends - starts + 1).astype(np.int64)
        keep = score >= min_hits
        conv = int
    else:
        csum = np.concatenate([[0.0], np.cumsum(weights[hp],
                                                dtype=np.float64)])
        score = csum[ends + 1] - csum[starts]
        keep = score >= min_weight
        conv = lambda s: round(float(s), 4)
    return [(int(hp[s]), int(hp[e]), int(hr[s]), conv(sc))
            for s, e, sc in zip(starts[keep], ends[keep], score[keep])]


def cluster_calls(genome: Genome, batch: DnaContigBatch, vals: np.ndarray,
                  k: int, max_gap: int, min_hits: int, role_ids: list[str],
                  weighted: bool = False, min_weight: float = 0.0
                  ) -> list[tuple[Feature, str, int | float]]:
    """Host clustering of one genome's probed window stream.

    vals: the probe's payloads over ``batch.codes`` positions: role
    indices, or packed (weight, role) when ``weighted``.
    returns (region feature, role ID, score) triples in entry order.
    """
    vals = np.asarray(vals)
    if weighted:
        roles, weights = split_payload_np(vals)
    else:
        roles, weights = vals, None
    calls: list[tuple[Feature, str, int | float]] = []
    n = 0
    for cid, strand, off, length in batch.entries:
        w = max(length - k + 1, 0)
        for w0, w1, ridx, score in cluster_hits(
                roles[off: off + w], k, max_gap, min_hits,
                weights=None if weights is None else weights[off: off + w],
                min_weight=min_weight):
            if strand == "+":
                left, right = w0 + 1, w1 + k
            else:
                left = length - w1 - k + 1
                right = length - w0
            n += 1
            feat = Feature.create(
                f"fig|{genome.id}.region.{n}", "", cid, strand,
                left, right, ftype="region")
            calls.append((feat, role_ids[ridx], score))
    return calls


class DnaApplyEngine:
    """Annotates raw contigs against a DNA signature table on ``device``.

    weighted=True probes packed (fp16 weight, role) payloads and calls a
    cluster whose summed hit weight is at least ``min_weight`` (default:
    ``min_hits``), the positional analogue of the weighted protein vote.
    The 8-slot table is built on the host and stays on the device, with
    its key filter (``ops.key_filter``, ``key_filter``), which the probe
    reads in front of the walk.
    """

    def __init__(self, signatures: SignatureTable, min_hits: int = 5,
                 max_gap: int = 500, weighted: bool = False,
                 min_weight: float | None = None, *,
                 device: str | torch.device):
        if signatures.alphabet != "dna":
            raise ValueError("DnaApplyEngine requires a DNA signature table")
        self.device = resolve_device(device)
        self.signatures = signatures
        self.k = signatures.k
        self.min_hits = min_hits
        self.max_gap = max_gap
        self.weighted = weighted
        self.min_weight = float(min_hits if min_weight is None
                                else min_weight)
        self.table, self.max_probes = signatures.device_table(
            packed_weights=weighted, device=self.device)
        self.key_filter = signatures.device_key_filter(device=self.device)
        self.role_ids = signatures.role_ids

    def prepare(self, genome: Genome) -> DnaContigBatch:
        """Host-side encode (safe to run in a prefetch worker thread)."""
        return DnaContigBatch(
            [(c.id, c.sequence) for c in genome.contigs], self.k)

    def call_prepared(self, genome: Genome, batch: DnaContigBatch
                      ) -> list[tuple[Feature, str, int | float]]:
        """Upload a prepared batch, probe it on the device, download its
        (T,) int32 payloads and cluster them on the host; returns (region
        feature, role ID, score) triples in contig order."""
        codes = torch.from_numpy(batch.codes).to(self.device)
        valid = torch.from_numpy(batch.valid).to(self.device)
        vals = probe_dna_flat(self.table, codes, valid, k=self.k,
                              max_probes=self.max_probes,
                              key_filter=self.key_filter).cpu().numpy()
        return cluster_calls(genome, batch, vals, self.k, self.max_gap,
                             self.min_hits, self.role_ids,
                             weighted=self.weighted,
                             min_weight=self.min_weight)

    def call_genome(self, genome: Genome
                    ) -> list[tuple[Feature, str, int | float]]:
        """All called (region, role ID, score) triples over both strands of
        the genome's raw contigs."""
        return self.call_prepared(genome, self.prepare(genome))
