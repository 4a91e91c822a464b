"""Signature-table annotation engine (the ``apply`` hot path).

Counterpart of ``kmers_anno_tpu/engine/apply_engine.py`` (ApplyKmerProcessor
.java:113-155).  Two layouts, chosen by the table's size as the reference
chooses them:

**Row layout** (tables that fit one wide table, ~3.1M keys).  Proteins are
length-sorted and encoded on the host into (rows, width) code matrices
(``make_row_batches``, the C++ loader), and each batch takes one device
step:

* unweighted (the reference's unanimity vote): ``apply_rows``
  (``ops/apply_rows.py``, ``apply_engine.py:183-195``), one launch of the
  fused kernel ``csrc/apply_rows.cu`` on CUDA (pack, wide-table probe and
  vote per row) and its plain version on the CPU;
* weighted: :func:`apply_rows_weighted`, the torch pack, the
  ``probe_wide`` kernel, the payload split and the row-sort tally vote.

**Flat-stream layout** (bigger tables).  Every protein of a call is one
``FlatBatch`` token stream with segment ids, probed against the 8-slot
table, with per-protein votes:
``ops/apply_flat.apply_flat`` and ``apply_weighted_flat``
(``apply_engine.py:61-128``), the kernels of ``csrc/apply_flat.cu`` on
CUDA, with the table's key filter (``ops.key_filter``) in front of the
walk, and their plain versions on the CPU.

The Java loop walks kmers in order and stops at the first conflicting
hit; its outcome is order-free, so every step reduces with min/max/sum.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from ..genome.gto import Feature, Genome
from ..ops.apply_flat import apply_flat, apply_weighted_flat
from ..ops.apply_rows import apply_rows   # the unweighted apply step
from ..ops.encode import PROT_PAD, encode_protein
from ..ops.kmers import pack_kmer_windows
from ..ops.vote import split_packed_payload, weighted_vote_rows
from ..ops.widetable import probe_wide
from ..utils import spans
from .protein_kmers import apply_drop_last
from .signature import SignatureTable

# coarse width buckets (<= ~14% padding between steps)
_W_BUCKETS = [64, 96, 128, 160, 192, 224, 256, 320, 384, 448, 512, 640,
              768, 896, 1024, 1280, 1536, 1792, 2048, 2560, 3072, 3584,
              4096, 5120, 6144, 7168, 8192, 10240, 12288, 14336, 16384]
_MAX_ROW_TOKENS = 1 << 22      # per-step token budget
_MIN_SPLIT_ROWS = 64           # don't split batches smaller than this


def _bucket_width(n: int) -> int:
    for w in _W_BUCKETS:
        if n <= w:
            return w
    return -(-n // 2048) * 2048


def _bucket(n: int, minimum: int) -> int:
    """Round up to the next power of two, at least ``minimum``
    (``apply_engine.py:55-58``)."""
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()


class FlatBatch:
    """A flat token-stream batch of protein sequences (host side,
    ``apply_engine.py:131-160``): codes (PROT_PAD after the last protein),
    each token's protein (``n_seqs`` after the last), and which tokens
    start a kmer window inside their protein.  The stream and the protein
    count are padded to powers of two.  ``request`` is the spans' request
    id of the genome it was prepared for (``KmerApplyEngine.prepare``)."""

    __slots__ = ("codes", "seg_ids", "valid", "n_seqs", "request")

    def __init__(self, proteins: list[str], k: int,
                 min_tokens: int = 16384, min_seqs: int = 256):
        self.request = None
        n = len(proteins)
        total = sum(map(len, proteins))
        width = _bucket(total, min_tokens)
        self.n_seqs = _bucket(n, min_seqs)
        got = native.flat_batch(proteins, k, width, self.n_seqs)
        if got is not None:  # C++ data loader (kan_host.cpp)
            self.codes, self.seg_ids, self.valid = got
            self.valid = apply_drop_last(self.valid)
            return
        codes = np.full(width, PROT_PAD, np.uint8)
        seg_ids = np.full(width, self.n_seqs, np.int32)
        valid = np.zeros(width, bool)
        pos = 0
        for i, prot in enumerate(proteins):
            ln = len(prot)
            codes[pos: pos + ln] = encode_protein(prot)
            seg_ids[pos: pos + ln] = i
            if ln >= k:
                valid[pos: pos + ln - k + 1] = True
            pos += ln
        self.codes = codes
        self.seg_ids = seg_ids
        self.valid = apply_drop_last(valid)


def apply_rows_weighted(table: torch.Tensor, salt: int, codes: torch.Tensor,
                        valid: torch.Tensor, min_weight: float, *, k: int,
                        max_probes: int):
    """Row-layout weighted apply step (``apply_engine.py:198-206``):
    packed (weight, role) payloads and the row-sort best-tally vote.
    returns (role (rows,) int32, tally (rows,) float32)."""
    lo, hi = pack_kmer_windows(codes, k)
    val = probe_wide(table, lo, hi, valid, salt, max_probes=max_probes)
    roles, weights = split_packed_payload(val)
    return weighted_vote_rows(roles, weights, valid, min_weight)


class RowBatch:
    """A (rows, width) padded batch of protein sequences (host side).

    ``idx`` maps local row -> caller protein index (batches are cut from
    length-sorted slices, so results are scattered back); ``request`` as
    ``FlatBatch``'s."""

    __slots__ = ("codes", "valid", "idx", "n", "request")

    def __init__(self, proteins: list[str], k: int, idx: np.ndarray):
        self.request = None
        self.idx = idx
        self.n = len(proteins)
        width = _bucket_width(max(map(len, proteins)))
        rows = -(-self.n // 8) * 8
        got = native.row_batch(proteins, k, rows, width)
        if got is not None:            # C++ data loader (kan_host.cpp)
            self.codes, self.valid = got
            self.valid = apply_drop_last(self.valid)
            return
        codes = np.full((rows, width), PROT_PAD, np.uint8)
        valid = np.zeros((rows, width), bool)
        for i, prot in enumerate(proteins):
            ln = len(prot)
            codes[i, :ln] = encode_protein(prot)
            if ln >= k:
                valid[i, : ln - k + 1] = True
        self.codes = codes
        self.valid = apply_drop_last(valid)


def make_row_batches(proteins: list[str], k: int) -> list[RowBatch]:
    """Split a protein list into length-homogeneous RowBatches
    (``apply_engine.py:238-265``).

    Sorts by length (stable), then cuts a new batch when the padded token
    count would pass the per-step budget or padding would pass ~30%.
    """
    lens = np.fromiter(map(len, proteins), np.int64, len(proteins))
    order = np.argsort(lens, kind="stable")
    batches: list[RowBatch] = []
    i, n = 0, len(proteins)
    while i < n:
        j, real = i, 0
        while j < n:
            width = _bucket_width(int(lens[order[j]]))
            rows = j - i + 1
            if rows * width > _MAX_ROW_TOKENS and rows > 1:
                break
            if (rows > _MIN_SPLIT_ROWS
                    and real + lens[order[j]] < 0.7 * rows * width):
                break
            real += int(lens[order[j]])
            j += 1
        sel = order[i:j]
        batches.append(RowBatch([proteins[s] for s in sel], k, sel))
        i = j
    return batches


def _batches(prepared: list[RowBatch] | FlatBatch) -> list:
    """A prepared genome's batches: one FlatBatch, or its RowBatches."""
    return [prepared] if isinstance(prepared, FlatBatch) else prepared


class KmerApplyEngine:
    """Annotates proteins and genomes against a signature table
    (``apply_engine.py:268-381``) on one device.

    weighted=False (default) is the reference's unanimity vote
    (ApplyKmerProcessor.java:122-147); weighted=True calls the best-tally
    role when its summed hit weights reach ``min_weight`` (default:
    min_hits).  The table is built once, on the host, and kept on the
    device: the wide table when the keys fit one (``mode`` "wide", row
    batches), else the 8-slot table (``mode`` "flat", one FlatBatch a
    call, with the table's key filter, ``key_filter``).
    """

    def __init__(self, signatures: SignatureTable, min_hits: int = 5,
                 weighted: bool = False, min_weight: float | None = None,
                 *, device: str | torch.device):
        self.signatures = signatures
        self.k = signatures.k
        self.min_hits = min_hits
        self.weighted = weighted
        self.min_weight = float(min_hits if min_weight is None
                                else min_weight)
        self.role_ids = signatures.role_ids
        self.device = resolve_device(device)
        wide = signatures.device_wide_table(packed_weights=weighted,
                                            device=self.device)
        self.key_filter = None
        if wide is not None:
            self.mode = "wide"
            self.table, self.salt, self.max_probes = wide
        else:
            self.mode = "flat"
            self.table, self.max_probes = signatures.device_table(
                packed_weights=weighted, device=self.device)
            self.key_filter = signatures.device_key_filter(
                device=self.device)

    def _upload(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        """A batch's host arrays copied to the device."""
        with spans.span("apply.upload") as sp:
            sp.set(bytes=sum(a.nbytes for a in arrays))
            return [torch.from_numpy(a).to(self.device) for a in arrays]

    def _flat_step(self, batch: FlatBatch) -> list[np.ndarray]:
        """The batch's step, its (role, hits) read back to the host."""
        args = self._upload(batch.codes, batch.seg_ids, batch.valid)
        kw = dict(k=self.k, max_probes=self.max_probes, n_seqs=batch.n_seqs,
                  key_filter=self.key_filter)
        with spans.span("apply.run"):
            if self.weighted:
                out = apply_weighted_flat(self.table, *args, self.min_weight,
                                          n_roles=len(self.role_ids), **kw)
            else:
                out = apply_flat(self.table, *args, self.min_hits, **kw)
            return [t.cpu().numpy() for t in out]

    def _row_step(self, batch: RowBatch):
        """The batch's step, launched; its (role, hits) on the device."""
        codes, valid = self._upload(batch.codes, batch.valid)
        with spans.span("apply.run"):
            if self.weighted:
                return apply_rows_weighted(self.table, self.salt, codes,
                                           valid, self.min_weight, k=self.k,
                                           max_probes=self.max_probes)
            return apply_rows(self.table, self.salt, codes, valid,
                              self.min_hits, self.k, self.max_probes)

    def _call_batches(self, n: int, prepared: list[RowBatch] | FlatBatch
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Run prepared batches; returns (role, hits) in caller order."""
        with spans.span("apply.run"):
            # the result arrays: allocating them can wait on the GIL that
            # prefetch workers hold (milliseconds a genome on the card)
            role = np.full(n, -1, np.int32)
            hits = np.zeros(n, np.float32 if self.weighted else np.int32)
        if isinstance(prepared, FlatBatch):
            r, h = self._flat_step(prepared)
            role[:] = r[:n]
            hits[:] = h[:n]
            return role, hits
        outs = [self._row_step(b) for b in prepared]  # queue every step
        with spans.span("apply.run"):
            for batch, (r, h) in zip(prepared, outs):
                role[batch.idx] = r.cpu().numpy()[: batch.n]
                hits[batch.idx] = h.cpu().numpy()[: batch.n]
        return role, hits

    def _convert(self):
        return (lambda h: round(float(h), 4)) if self.weighted else int

    def _decode(self, role: np.ndarray, hits: np.ndarray):
        conv = self._convert()
        return [(self.role_ids[r], conv(h)) if r >= 0 else None
                for r, h in zip(role, hits)]

    # ----- public API -----

    def call_proteins(self, proteins: list[str]
                      ) -> list[tuple[str, int] | None]:
        """Per protein: (role_id, hit count or tally), or None when no role
        is called (miss, conflicting hits, below the threshold)."""
        if not proteins:
            return []
        role, hits = self._call_batches(
            len(proteins), self._prepare_proteins(proteins))
        return self._decode(role, hits)

    def _prepare_proteins(self, proteins: list[str]):
        if self.mode == "wide":
            return make_row_batches(proteins, self.k)
        return FlatBatch(proteins, self.k)

    def prepare(self, genome: Genome):
        """Host-side preparation (peg selection and batch encode); safe to
        run in a prefetch worker thread.  The batches carry the genome's
        request id, which ``call_prepared``'s spans take up."""
        req = spans.request()
        with spans.span("apply.prepare", req) as sp:
            pegs = [f for f in genome.pegs if f.protein_translation]
            sp.set(proteins=len(pegs))
            if not pegs:
                return pegs, None
            prepared = self._prepare_proteins(
                [f.protein_translation for f in pegs])
        for batch in _batches(prepared):
            batch.request = req
        return pegs, prepared

    def call_prepared(self, pegs: list[Feature], prepared
                      ) -> list[tuple[Feature, str, int]]:
        """Device steps and decode of a prepared genome."""
        if prepared is None:
            return []
        req = next((b.request for b in _batches(prepared)), None)
        with spans.span("apply.call", req):
            role, hits = self._call_batches(len(pegs), prepared)
            with spans.span("apply.decode"):
                conv = self._convert()
                return [(feat, self.role_ids[r], conv(h))
                        for feat, r, h in zip(pegs, role, hits) if r >= 0]

    def call_genome(self, genome: Genome
                    ) -> list[tuple[Feature, str, int]]:
        """All called (feature, role_id, hits) triples of a genome's pegs,
        in peg order (ApplyKmerProcessor.java:122-147)."""
        return self.call_prepared(*self.prepare(genome))
