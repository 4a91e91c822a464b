"""Kmer-hash similarity annotation engine (the ``hashAnno`` command,
HashAnnotationProcessor.java:63-330).

Counterpart of ``kmers_anno_tpu/engine/hashanno.py``, on one torch device:

* A genome batch's usable proteins (non-blank, no '*') are deduplicated by
  MD5 and their DISTINCT kmers become an 8-slot probe table of unique
  kmers plus an owner matrix: each unique kmer's owner proteins, built on
  the device from one upload of the proteins' codes (:func:`_device_index`;
  the table through ``ops.table_build.build_bucketed`` in its
  ``OPEN_WALK`` layout, which places a wrapping key as the host
  ``ops.hashtable.build_table`` does), byte-equal to the reference's host
  build.
* Every protein starts with the **default proposal**: its old annotation
  at similarity 0.0 (Q12, HashAnnotationProcessor.java:297).
* Prototypes are scored in chunks on the device (``ops.hash_chunk``): per
  chunk one ``hash_commons`` (probe, owner gather and pair count into a
  dense (prototypes, proteins) matrix) and one ``hash_best`` (the exact
  first-max best proposal, folded into device state that lives across
  chunks); one small pull at the end, and the printed score is the
  float64 quotient c / u on the host.  Similarity is the Jaccard
  similarity of distinct kmer sets |∩| / |∪|.
* Owners past ``OWNER_CAP`` or proteins over 16,384 aa take the host
  route: ``hash_commons`` only, the (chunk, proteins) matrix pulled to the
  host, the heavy owners added from a host CSR, float64 Jaccard and
  ``argmax`` there.
* A proposal improves only on strictly greater similarity at or above
  the min-score floor; within a chunk the earliest prototype wins ties,
  the reference tool's sequential first-wins order.

Spans (``utils.spans``, off unless enabled; none waits for the device):
``hash.batch`` (a request) covers ``annotate_genomes_batched``, and inside
it ``hash.register`` (the ``add_protein`` loop and its MD5s),
``hash.index`` (``_build``), ``hash.score`` (the chunk launches, or the
host route's chunk loop), ``hash.pull`` (the fast route's final pull) and
``hash.emit`` (the rows); ``hash.protos`` covers a ``PrototypeSet.chunks``
cache miss.  ``GenomeProteinKmers.host_route`` counts the indexes scored
on the host route, ``device_index`` the indexes built on the device.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..device import min_ev_table, pow2_bucket, resolve_device
from ..genome.gto import Genome, protein_md5
from ..ops.encode import encode_protein
from ..ops.hash_chunk import DENSE_CELLS, OWNER_CAP, hash_best, hash_commons
from ..ops.hashtable import table_size_for
from ..ops.kmers import pack_kmer_windows
from ..ops.table_build import OPEN_WALK, build_bucketed
from ..utils import spans
from . import protein_kmers

log = logging.getLogger(__name__)

MAX_DEVICE_LEN = 16384   # longer proteins leave the int32 device compare


@dataclass
class Prototype:
    """One row of the role annotation file (protein, annotation)."""

    protein: str
    annotation: str


class RateLogger:
    """Every-N-seconds progress rate logger (the reference logs prototype
    lines/second every 5 s, HashAnnotationProcessor.java:265-270)."""

    def __init__(self, unit: str = "lines", interval: float = 5.0):
        self.unit = unit
        self.interval = interval
        self.start = time.time()
        self._last = self.start
        self.n = 0

    def add(self, n: int) -> None:
        self.n += n
        now = time.time()
        if now - self._last >= self.interval:
            rate = self.n / max(now - self.start, 1e-9)
            log.info("%d %s processed (%.0f %s/second).",
                     self.n, self.unit, rate, self.unit)
            self._last = now


def _device_i32(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)


class PrototypeSet:
    """Prototype kmers packed once and reused across every genome.

    The reference tool re-walks the prototype list per genome
    (HashAnnotationProcessor.java:259-263); here the chunked, packed,
    device-resident query arrays are cached per chunk size and device, so
    an N-genome run pays the prototype encode/pack/upload cost once.
    """

    def __init__(self, protos: list[Prototype], k: int):
        self.protos = protos
        self.k = k
        self._cache: dict[tuple, list] = {}

    def __len__(self) -> int:
        return len(self.protos)

    def chunks(self, chunk: int, device: torch.device) -> list:
        """Prepared chunks: (d_lo, d_hi, d_proto, d_valid, n2, protos,
        n_proto, d_n2), the query arrays and ``d_n2`` on ``device``; ``n2``
        is the host copy of the distinct-kmer counts, padded to
        ``n_proto`` rows.  A chunk's distinct (kmer, prototype) pairs come
        in the order of :func:`_similar_prototypes_adjacent`."""
        key = (chunk, str(device))
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        with spans.span("hash.protos") as sp:
            cached = self._pack(chunk, device)
            sp.set(chunks=len(cached),
                   kmers=sum(int(c[4].sum()) for c in cached))
        self._cache[key] = cached
        return cached

    def _pack(self, chunk: int, device: torch.device) -> list:
        cached = []
        for start in range(0, len(self.protos), chunk):
            sub = self.protos[start: start + chunk]
            lo, hi, proto_of, n2 = _read_pairs([p.protein for p in sub],
                                               self.k, device)
            order = _similar_prototypes_adjacent(proto_of, len(sub))
            lo, hi, proto_of = lo[order], hi[order], proto_of[order]
            n_proto = pow2_bucket(len(sub), 64)
            h = pow2_bucket(len(lo), 4096)
            qlo = np.zeros(h, np.int32)
            qhi = np.zeros(h, np.int32)
            qproto = np.full(h, n_proto, np.int32)
            qvalid = np.zeros(h, bool)
            qlo[: len(lo)], qhi[: len(lo)] = lo, hi
            qproto[: len(lo)] = proto_of
            qvalid[: len(lo)] = True
            n2 = np.pad(n2, (0, n_proto - len(n2)))
            cached.append((_device_i32(qlo, device), _device_i32(qhi, device),
                           _device_i32(qproto, device),
                           torch.from_numpy(qvalid).to(device), n2, sub,
                           n_proto, _device_i32(n2, device)))
        return cached


def _similar_prototypes_adjacent(proto_of: np.ndarray, n: int) -> np.ndarray:
    """The order in which a chunk's distinct (kmer, prototype) pairs are
    packed, from the key-major order of :func:`_distinct_pairs`:
    prototype by prototype, each prototype's kmers in key order, the ``n``
    prototypes sorted by their smallest kmer (their first pair in key
    order).  Prototypes that share many kmers mostly share their smallest,
    so they sit side by side, and a block of the count kernel
    (``hash_commons``) reads their table buckets and owner rows into its
    cache once."""
    own = torch.from_numpy(proto_of.astype(np.int64))
    first = torch.full((n,), len(own), dtype=torch.int64).scatter_reduce_(
        0, own, torch.arange(len(own)), "amin")
    place = torch.empty(n, dtype=torch.int32)
    place[torch.sort(first, stable=True).indices] = torch.arange(
        n, dtype=torch.int32)
    return torch.sort(place[own], stable=True).indices.numpy()


_NO_KEY = torch.iinfo(torch.int64).max   # an invalid window's key: last


def _stream_codes(proteins: list[str]) -> np.ndarray:
    """The proteins' residue codes end to end, by the C++ encoder where it
    is built."""
    joined = "".join(proteins)
    codes = native.encode_protein(joined)
    return encode_protein(joined) if codes is None else codes


def _sorted_windows(proteins: list[str], k: int,
                    device: torch.device) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Every kmer window of the proteins, packed on ``device`` from one
    upload of their codes and lengths, in key-major order: (keys (T,)
    int64, ``hi << 32 | lo``, an invalid window's ``_NO_KEY`` and so
    last; owners (T,) int32).  A window counts where it lies inside its
    protein (the external ProteinKmers contract), through the drop-last
    fence of ``apply_drop_last``.  The stream is in owner order and the
    sort is stable, so equal keys keep their owners ascending: the
    reference's ``lexsort((owner, key))``.  Keys are below 2^62, so their
    int64 order is their uint64 order."""
    lengths = torch.from_numpy(np.fromiter(map(len, proteins), np.int64,
                                           len(proteins))).to(device)
    codes = torch.from_numpy(_stream_codes(proteins)).to(device)
    total = codes.numel()
    owner = torch.repeat_interleave(
        torch.arange(len(proteins), dtype=torch.int32, device=device),
        lengths, output_size=total)
    ends = torch.repeat_interleave(torch.cumsum(lengths, 0), lengths,
                                   output_size=total)
    valid = torch.arange(k, total + k, device=device) <= ends
    del ends
    if protein_kmers.DROP_LAST_WINDOW:
        valid &= torch.cat([valid[1:], valid.new_zeros(1)])
    lo, hi = pack_kmer_windows(codes, k)
    del codes
    keys = torch.where(valid, (hi.to(torch.int64) << 32) | lo, _NO_KEY)
    del lo, hi, valid
    keys, order = torch.sort(keys, stable=True)
    return keys, owner[order]


def _distinct_pairs(proteins: list[str], k: int,
                    device: torch.device) -> tuple:
    """The proteins' distinct (kmer, protein) pairs on ``device``:
    :func:`_sorted_windows`' (keys, owners), and over them the masks
    ``first`` (a kmer's first pair) and ``pair`` (a distinct (kmer,
    owner) pair), both False on invalid windows, and each protein's
    distinct-kmer count ((n,) int64).  ``keys[pair]`` and
    ``owner[pair]`` are the pairs key-major, each kmer's owners
    ascending."""
    keys, owner = _sorted_windows(proteins, k, device)
    real = keys != _NO_KEY
    step = torch.ones(keys.numel(), dtype=torch.bool, device=device)
    step[1:] = keys[1:] != keys[:-1]
    first = real & step             # a kmer's first pair
    step[1:] |= owner[1:] != owner[:-1]
    pair = real & step              # a distinct (kmer, owner) pair
    counts = torch.zeros(len(proteins), dtype=torch.int64,
                         device=device).index_add_(0, owner,
                                                   pair.to(torch.int64))
    return keys, owner, first, pair, counts


def _read_pairs(proteins: list[str], k: int, device: torch.device):
    """:func:`_distinct_pairs` read back to the host in one read: (lo, hi,
    owner) int32 arrays of the pairs, key-major, and the (n,) int64
    distinct-kmer counts.  The device's arrays are freed on return."""
    keys, owner, _, pair, counts = _distinct_pairs(proteins, k, device)
    got = torch.cat((keys[pair], owner[pair].to(torch.int64),
                     counts)).cpu().numpy()
    n = (len(got) - len(proteins)) // 2
    key = got[:n]
    return ((key & 0xFFFFFFFF).astype(np.int32),
            (key >> 32).astype(np.int32), got[n: 2 * n].astype(np.int32),
            got[2 * n:])


class GenomeProteinKmers:
    """Per-genome (or genome-batch) kmer hash with best-proposal
    bookkeeping (GenomeProteinKmers contract,
    HashAnnotationProcessor.java:233-291), on ``device``."""

    host_route = 0      # indexes scored on the host route, process-wide
    device_index = 0    # indexes built on the device, process-wide

    def __init__(self, k: int, min_score: float, *,
                 device: str | torch.device):
        self.k = k
        self.min_score = min_score
        self.device = resolve_device(device)
        self._fids: list[str] = []
        self._proteins: list[str] = []
        self._annotations: list[str] = []
        self._md5_of: dict[str, int] = {}
        self._built = False

    def add_protein(self, fid: str, prot: str, annotation: str) -> None:
        md5 = protein_md5(prot)
        if md5 in self._md5_of:
            return  # identical sequence already registered
        self._md5_of[md5] = len(self._proteins)
        self._fids.append(fid)
        self._proteins.append(prot)
        self._annotations.append(annotation)
        self._built = False

    # ----- index construction -----

    def _build(self) -> None:
        with spans.span("hash.index") as sp:
            self._build_index()
            sp.set(kmers=self.kmer_count,
                   buckets=0 if self.table is None else self.table.shape[0],
                   heavy=len(self.heavy_owners))

    def _build_index(self) -> None:
        """The index on ``self.device``."""
        n = len(self._proteins)
        # defaults: old annotation at similarity 0.0
        self.best_sim = np.zeros(n, np.float64)
        self.best_anno = list(self._annotations)
        self.protein_kmer_counts = np.zeros(n, np.int64)
        self.table = None
        self.kmer_count = 0
        self.heavy_owners = np.zeros(0, np.int32)
        if any(self._proteins):
            self._device_index()
        self._built = True

    def _device_index(self) -> None:
        """Pack, sort and dedup the (kmer, protein) pairs on the device,
        then the owner matrix and the 8-slot table there: one read of the
        sizes and the proteins' kmer counts, one of the table build's
        ``bad`` and longest walk, and the overflow owners only where there
        are any."""
        dev = self.device
        n = len(self._proteins)
        keys, owner, first, pair, counts = _distinct_pairs(self._proteins,
                                                           self.k, dev)
        total = keys.numel()
        rank = torch.cumsum(first, 0) - 1       # each window's kmer rank
        at = torch.cumsum(pair, 0) - 1          # ... and pair index
        # a pair's column in the owner matrix: its index less its kmer's
        # first pair's
        start = torch.zeros(total + 1, dtype=torch.int64, device=dev)
        start[torch.where(first, rank, total)] = at
        col = at - start[rank.clamp(min=0)]
        del start, at
        most = torch.where(pair, col, -1).max() + 1
        got = torch.cat((torch.stack((rank[-1] + 1, most)),
                         counts)).cpu().numpy()
        u, most = int(got[0]), int(got[1])
        self.protein_kmer_counts = got[2:]
        if not u:
            return 0
        # fixed-width owner matrix: rank → its owner proteins, padded
        # with the (bucketed) protein count; rows and the protein count
        # are bucketed as in the reference
        cap = min(most, OWNER_CAP)
        self.n_pad = pow2_bucket(n, 256)
        u_pad = pow2_bucket(u, 4096)
        self.owner_mat = torch.full((u_pad, cap), self.n_pad,
                                    dtype=torch.int32, device=dev)
        # the other windows write slot 0, which the first window (rank
        # 0's first owner) then takes back: no slot past the matrix
        flat = self.owner_mat.view(-1)
        flat[torch.where(pair & (col < cap), rank * cap + col, 0)] = owner
        flat[0] = owner[0]
        # host CSR of the overflow owners (ranks sorted; usually empty)
        if most > cap:
            over = pair & (col >= cap)
            h_ranks, h_counts = np.unique(rank[over].cpu().numpy(),
                                          return_counts=True)
            self.heavy_ranks = h_ranks.astype(np.int32)
            self.heavy_off = np.concatenate(
                [[0], np.cumsum(h_counts)]).astype(np.int64)
            self.heavy_owners = owner[over].cpu().numpy()
            log.info("%d kmers exceed the owner cap %d (%d overflow "
                     "owner entries on the host CSR path).",
                     len(h_ranks), cap, len(self.heavy_owners))
        else:
            self.heavy_ranks = np.zeros(0, np.int32)
            self.heavy_off = np.zeros(1, np.int64)
        # the unique keys in rank order, payload = rank
        ukeys = torch.empty(u + 1, dtype=torch.int64, device=dev)
        ukeys[torch.where(first, rank, u)] = keys
        del keys, owner, first, pair, rank, col
        lo = (ukeys[:u] & 0xFFFFFFFF).to(torch.int32)
        hi = (ukeys[:u] >> 32).to(torch.int32)
        del ukeys
        n_buckets = table_size_for(u)
        table, bad, walk = build_bucketed(
            lo, hi, torch.arange(u, dtype=torch.int32, device=dev),
            n_buckets, OPEN_WALK)
        bad, walk = torch.stack((bad.to(torch.int32), walk)).tolist()
        if bad:     # table_size_for leaves at least twice the slots
            raise RuntimeError(f"index table of {u} kmers is over-full at "
                               f"{n_buckets} buckets")
        GenomeProteinKmers.device_index += 1
        self.kmer_count = u
        self.table, self.max_probes = table, walk + 1

    @property
    def n_kmers(self) -> int:
        if not self._built:
            self._build()
        return self.kmer_count

    # ----- prototype scoring -----

    def process_proposals(self,
                          prototypes: "list[Prototype] | PrototypeSet",
                          chunk: int = 4096,
                          rate: "RateLogger | None" = None) -> int:
        """Score every prototype; returns the improvement count, counted
        per chunk (proteins whose proposal a chunk's best prototype
        improved).  Pass a PrototypeSet to reuse the packed prototype
        kmers across genomes; ``rate`` gets one ``add`` per scored
        chunk."""
        if not self._built:
            self._build()
        if isinstance(prototypes, list):
            prototypes = PrototypeSet(prototypes, self.k)
        # bound the dense (chunk x proteins) pair matrix
        n_pad = getattr(self, "n_pad",
                        pow2_bucket(max(len(self._proteins), 1), 256))
        chunk = max(1, min(chunk, DENSE_CELLS // (n_pad + 1) - 1))
        max_len = max((len(p) for p in self._proteins), default=0)
        max_len = max(max_len,
                      max((len(p.protein) for p in prototypes.protos),
                          default=0))
        fast = (self.table is not None and not len(self.heavy_owners)
                and max_len <= MAX_DEVICE_LEN)
        chunks = prototypes.chunks(chunk, self.device)
        if not fast:
            # heavy-owner CSR or huge proteins: host-float64 route
            GenomeProteinKmers.host_route += 1
            matches = 0
            with spans.span("hash.score") as sp:
                sp.set(chunks=len(chunks))
                for prepared in chunks:
                    matches += self._process_chunk(prepared)
                    if rate is not None:
                        rate.add(len(prepared[5]))
            return matches
        # fast route: device-resident exact-rational best reduction, one
        # small pull at the end
        with spans.span("hash.score") as sp:
            sp.set(chunks=len(chunks))
            run = self._device_run(chunks, max_len)
            self._score_chunks(chunks, run, rate)
        with spans.span("hash.pull"):
            return self._pull_best(run, prototypes.protos)

    def _device_run(self, chunks: list, max_len: int) -> tuple:
        """The fast route's device tensors: (minc, n1, state (c, u, index,
        improvements), one zeroed count buffer for every chunk, which
        hash_best clears as it reads)."""
        dev = self.device
        n = len(self._proteins)
        state = (torch.zeros(self.n_pad, dtype=torch.int32, device=dev),
                 torch.ones(self.n_pad, dtype=torch.int32, device=dev),
                 torch.full((self.n_pad,), -1, dtype=torch.int32, device=dev),
                 torch.zeros(1, dtype=torch.int32, device=dev))
        rows = max((len(c[5]) for c in chunks), default=0)
        return (self._minc_table(pow2_bucket(2 * max_len + 4, 1024)),
                _device_i32(np.pad(self.protein_kmer_counts,
                                   (0, self.n_pad - n)), dev),
                state,
                torch.zeros((rows, self.n_pad), dtype=torch.int32,
                            device=dev))

    def _score_chunks(self, chunks: list, run: tuple,
                      rate: "RateLogger | None" = None) -> None:
        """One hash_commons and one hash_best launch a chunk."""
        minc, d_n1, state, common = run
        base = 0
        for prepared in chunks:
            d_lo, d_hi, d_proto, d_valid, _, protos, _, d_n2 = prepared
            if protos:
                hash_commons(self.table, self.max_probes, self.owner_mat,
                             d_lo, d_hi, d_proto, d_valid, len(protos),
                             self.n_pad, out=common)
                hash_best(common, len(protos), d_n1, d_n2, minc, state,
                          base)
            base += len(protos)
            if rate is not None:
                rate.add(len(protos))

    def _pull_best(self, run: tuple, protos_all: list[Prototype]) -> int:
        """Pull the final state: best similarity, annotation; returns the
        improvement count."""
        n = len(self._proteins)
        state = run[2]
        bc = state[0][:n].cpu().numpy().astype(np.int64)
        bu = state[1][:n].cpu().numpy().astype(np.int64)
        bi = state[2][:n].cpu().numpy()
        matches = int(state[3].item())
        # float64 division reproduces the Java double the reference tool
        # emits; the device compared the same rationals exactly
        self.best_sim = np.where(bc > 0, bc / np.maximum(bu, 1), 0.0)
        for p in np.flatnonzero(bi >= 0):
            self.best_anno[p] = protos_all[int(bi[p])].annotation
        return matches

    def _minc_table(self, size: int) -> torch.Tensor:
        """minc[u] = smallest common count c with (c / u as float64)
        >= minScore: the device's integer floor test matches the host's
        double compare bit for bit."""
        cache = getattr(self, "_minc_cache", None)
        if cache is None:
            cache = self._minc_cache = {}
        got = cache.get(size)
        if got is None:
            got = _device_i32(min_ev_table(self.min_score, size),
                              self.device)
            cache[size] = got
        return got

    def _process_chunk(self, prepared) -> int:
        d_lo, d_hi, d_proto, d_valid, n2, protos, _, _ = prepared
        if self.table is None or not protos:
            return 0
        n_prot = len(self._proteins)
        heavy = bool(len(self.heavy_owners))
        got = hash_commons(self.table, self.max_probes, self.owner_mat,
                           d_lo, d_hi, d_proto, d_valid, len(protos),
                           self.n_pad, with_ranks=heavy)
        common = (got[0] if heavy else got)[: len(protos), : n_prot]
        common = common.cpu().numpy().astype(np.int32)
        if heavy:
            # owners beyond OWNER_CAP: host CSR add onto the common matrix
            r = got[1].cpu().numpy()
            p = d_proto.cpu().numpy()
            pos = np.flatnonzero((r >= 0) & (p < len(protos))
                                 & np.isin(r, self.heavy_ranks))
            if len(pos):
                hidx = np.searchsorted(self.heavy_ranks, r[pos])
                lens = self.heavy_off[hidx + 1] - self.heavy_off[hidx]
                # CSR slice concatenation without a Python loop
                flat = (np.repeat(self.heavy_off[hidx], lens)
                        + np.arange(int(lens.sum()))
                        - np.repeat(np.cumsum(lens) - lens, lens))
                np.add.at(common,
                          (np.repeat(p[pos], lens),
                           self.heavy_owners[flat]), 1)
        # exact float64 Jaccard + first-max argmax (Java-double parity)
        n1 = self.protein_kmer_counts[None, :]
        union = n1 + n2[: len(protos), None] - common
        sim = np.where(common > 0, common / np.maximum(union, 1), 0.0)
        sim[sim < self.min_score] = 0.0
        best = sim.max(axis=0)
        winner = sim.argmax(axis=0)  # first max = earliest prototype
        improved = np.flatnonzero(best > self.best_sim)
        self.best_sim[improved] = best[improved]
        for p in improved:
            self.best_anno[p] = protos[int(winner[p])].annotation
        return len(improved)

    # ----- lookup -----

    def get_proposal(self, md5: str):
        """(similarity, annotation) for a protein MD5, or None."""
        idx = self._md5_of.get(md5)
        if idx is None:
            return None
        if not self._built:
            self._build()
        return float(self.best_sim[idx]), self.best_anno[idx]


def _emit_rows(genome: Genome, gk: GenomeProteinKmers,
               defaults: "dict[str, str] | None" = None):
    """Per-feature output rows of one genome against a scored index
    (Q12 output classes, HashAnnotationProcessor.java:278-305).

    ``defaults``: per-genome md5 → first-registered old annotation.  In
    batched mode the shared index's 0.0-score default would otherwise be
    whichever genome registered the sequence first; this map restores the
    per-genome default the reference tool computes."""
    rows = []
    changes = []
    d_count = c_count = 0
    for feat in genome.features:
        old = feat.peg_function
        prot = feat.protein_translation
        md5 = protein_md5(prot) if prot else ""
        proposal = gk.get_proposal(md5) if md5 else None
        if proposal is None:
            rows.append((feat.id, "", old, old))
        else:
            score, new = proposal
            if score == 0.0 and defaults is not None:
                new = defaults.get(md5, new)
            score_str = repr(score) if score else "0.0"
            row = (feat.id, score_str, new, old)
            rows.append(row)
            if score == 0.0:
                d_count += 1
            elif old == new:
                c_count += 1
            else:
                changes.append(row)
    return rows, changes, d_count, c_count


def annotate_genome_rows(genome: Genome,
                         prototypes: "list[Prototype] | PrototypeSet",
                         k: int, min_score: float,
                         rate: "RateLogger | None" = None, *,
                         device: str | torch.device):
    """Full hashAnno pass over one genome.  Pass a PrototypeSet when
    annotating many genomes so prototype packing happens once.

    returns (rows: one (fid, score_str, new, old) per feature in order,
             change_rows subset, stats dict).
    """
    gk = GenomeProteinKmers(k, min_score, device=device)
    f_count = s_count = p_count = 0
    for feat in genome.features:
        prot = feat.protein_translation
        f_count += 1
        if not prot or "*" in prot:
            s_count += 1
        else:
            p_count += 1
            gk.add_protein(feat.id, prot, feat.peg_function)
    log.info("%d features processed, %d skipped, %d proteins, %d kmers "
             "in %s.", f_count, s_count, p_count, gk.n_kmers, genome)
    matches = gk.process_proposals(prototypes, rate=rate)
    rows, changes, d_count, c_count = _emit_rows(genome, gk)
    stats = dict(features=f_count, skipped=s_count, proteins=p_count,
                 matches=matches, defaulted=d_count, confirmed=c_count,
                 changed=len(changes))
    return rows, changes, stats


def annotate_genomes_batched(genomes: "list[Genome]",
                             prototypes: "list[Prototype] | PrototypeSet",
                             k: int, min_score: float,
                             rate: "RateLogger | None" = None, *,
                             device: str | torch.device):
    """Score several genomes through one combined device index.

    A protein's best proposal depends only on its sequence, so the
    distinct proteins of a genome batch share one owner matrix and probe
    table and are scored by one device pass (the device analogue of the
    reference tool's genome fan-out, HashAnnotationProcessor.java:208).

    returns [(rows, changes, stats) per genome, in input order]; each
    stats carries the per-genome Q12 class counts and the batch-wide
    ``matches`` total.
    """
    with spans.span("hash.batch", spans.request()) as batch:
        gk = GenomeProteinKmers(k, min_score, device=device)
        per_counts = []
        per_defaults: list[dict[str, str]] = []
        with spans.span("hash.register"):
            for genome in genomes:
                f_count = s_count = p_count = 0
                defaults: dict[str, str] = {}
                for feat in genome.features:
                    prot = feat.protein_translation
                    f_count += 1
                    if not prot or "*" in prot:
                        s_count += 1
                    else:
                        p_count += 1
                        gk.add_protein(feat.id, prot, feat.peg_function)
                        defaults.setdefault(protein_md5(prot),
                                            feat.peg_function)
                per_counts.append((f_count, s_count, p_count))
                per_defaults.append(defaults)
        batch.set(genomes=len(genomes), proteins=len(gk._proteins))
        log.info("%d proteins (%d kmers) from %d genomes in one device "
                 "batch.", len(gk._proteins), gk.n_kmers, len(genomes))
        matches = gk.process_proposals(prototypes, rate=rate)
        out = []
        with spans.span("hash.emit"):
            for genome, (f_count, s_count, p_count), defaults in zip(
                    genomes, per_counts, per_defaults):
                rows, changes, d_count, c_count = _emit_rows(genome, gk,
                                                             defaults)
                out.append((rows, changes,
                            dict(features=f_count, skipped=s_count,
                                 proteins=p_count, matches=matches,
                                 defaulted=d_count, confirmed=c_count,
                                 changed=len(changes))))
    return out
