"""Discriminating-kmer signature table: build, save/load, device table.

Counterpart of ``kmers_anno_tpu/engine/signature.py``, for protein kmers
(5-bit codes, k <= 12, ``ops.kmers``) and DNA kmers (``build --dna``: the
coding-strand CDS DNA of each peg, 2-bit codes with a marker bit, k <= 15,
``ops.dna_kmers``).  The two-pass ``build`` semantics
(BuildKmerProcessor.java:137-223):

* a peg contributes kmers only when its function has exactly ONE
  interesting role after RoleMap filtering (BuildKmerProcessor.java:
  156-175);
* pegs with NO interesting role form a kill list: any kmer they contain is
  deleted from the table (pass 2, BuildKmerProcessor.java:196-208);
* a kmer survives pass 1 only if every occurrence carries the same role
  (min(role) == max(role) over its occurrences);
* the table lists one (kmer, role) per surviving kmer, in the sorted order
  of the packed keys (hi, then lo), as the reference does.

The group-bys run in the shared C++ merge builder (``native.make_builder``)
by default, as in the reference; ``backend="device"`` runs them as plain
torch on a device: one stable sort of the int64 key ``hi << 32 | lo``,
segment min/max by ``scatter_reduce``, and the kill pass as a probe of
the kill kmers into an 8-slot table of the candidates (``ops.hashtable``).

The table goes to the device as the wide-bucket table (``ops.widetable``)
when its keys fit one, else as the 8-slot table of the flat-stream apply
step; a DNA table always as the 8-slot table (``engine.dna_apply``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import IO, Iterable, Sequence

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from ..genome.gto import Genome
from ..genome.roles import RoleMap
from ..ops.dna_kmers import dna_valid_np, pack_dna_np, unpack_dna_np
from ..ops.encode import (decode_dna, decode_protein, encode_dna,
                          encode_protein)
from ..ops.hashtable import build_table, probe_table
from ..ops.key_filter import build_key_filter
from ..ops.kmers import pack_kmers_np, unpack_kmer_np
from ..ops.widetable import build_wide_table, fits_wide
from ..utils.counters import CountMap
from .convert import wide_table_from_numpy
from .protein_kmers import apply_drop_last

log = logging.getLogger(__name__)

CONFLICT = np.int32(-2)     # role tombstone: key seen with >= 2 roles
_INT32_MAX = 2**31 - 1
_FP16_MAX = 65504.0         # largest finite float16


# ---------------------------------------------------------------------------
# device group-bys (plain torch on the tensors' device)
# ---------------------------------------------------------------------------

def _first_of_run(skey: torch.Tensor) -> torch.Tensor:
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    return first


def _resolve_groupby(lo: torch.Tensor, hi: torch.Tensor, role: torch.Tensor):
    """Sort (hi, lo) keys and resolve each key's role by unanimity
    (``signature.py:105-128``).

    lo/hi: (N,) int64 holding uint32 key words, hi < 2^31
    role:  (N,) int32 role per occurrence; CONFLICT (-2) marks a key
           already known conflicted, which keeps its key conflicted
    returns (slo, shi, out_role, keep): the sorted keys as int64, the
    unanimous role or CONFLICT of each position's key, and True at the
    first position of every key.
    """
    n = lo.shape[0]
    skey, order = torch.sort((hi << 32) | lo, stable=True)
    srole = role[order]
    first = _first_of_run(skey)
    seg = torch.cumsum(first, 0) - 1
    rmin = torch.full((n,), _INT32_MAX, dtype=torch.int32, device=lo.device)
    rmax = torch.full((n,), -_INT32_MAX, dtype=torch.int32, device=lo.device)
    rmin = rmin.scatter_reduce(0, seg, srole, "amin")
    rmax = rmax.scatter_reduce(0, seg, srole, "amax")
    out_role = torch.where(rmin == rmax, rmin, int(CONFLICT))[seg]
    return skey & 0xFFFFFFFF, skey >> 32, out_role, first


def _dedup_groupby(lo: torch.Tensor, hi: torch.Tensor):
    """Sorted keys and a first-of-key mask (``signature.py:131-138``);
    lo/hi as in :func:`_resolve_groupby`."""
    skey = torch.sort((hi << 32) | lo).values
    return skey & 0xFFFFFFFF, skey >> 32, _first_of_run(skey)


def _mark_killed(cand_table: torch.Tensor, kill_lo: torch.Tensor,
                 kill_hi: torch.Tensor, n_cand: int,
                 max_probes: int) -> torch.Tensor:
    """Probe kill kmers (int32 key words) into the 8-slot table of the
    candidates, whose payloads are candidate indices; returns the
    (n_cand,) mask of candidates hit (``signature.py:141-148``)."""
    valid = torch.ones_like(kill_lo, dtype=torch.bool)
    idx = probe_table(cand_table, kill_lo, kill_hi, valid, max_probes)
    dead = torch.zeros(n_cand, dtype=torch.bool, device=cand_table.device)
    dead[idx[idx >= 0].long()] = True
    return dead


class StreamingTableBuilder:
    """Bounded-memory accumulator for the signature build
    (``signature.py:165-282``).

    Feed per-genome (key, role) occurrences and kill keys.  The builder
    keeps only the sorted unique state, one (lo, hi, role) per key with
    CONFLICT tombstones, and re-resolves state + pending occurrences in one
    group-by whenever the pending pool reaches ``chunk_entries``.

    backend: "auto" = the C++ merge builder when the native library is
    available, else the torch group-bys; "native" = require the C++
    builder; "device" = the torch group-bys on ``device``.
    """

    def __init__(self, chunk_entries: int = 1 << 23, backend: str = "auto",
                 *, device: str | torch.device):
        if backend not in ("auto", "native", "device"):
            raise ValueError(f"unknown builder backend {backend!r}")
        self.chunk_entries = chunk_entries
        self.device = resolve_device(device)
        self._native = (native.make_builder()
                        if backend in ("auto", "native") else None)
        if backend == "native" and self._native is None:
            raise RuntimeError("native builder unavailable")
        z = np.zeros(0, np.uint32)
        self.state: tuple[np.ndarray, np.ndarray, np.ndarray] = (
            z, z, np.zeros(0, np.int32))
        self.kill_state: tuple[np.ndarray, np.ndarray] = (z, z)
        self._pend: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._pend_n = 0
        self._pend_kill: list[tuple[np.ndarray, np.ndarray]] = []
        self._pend_kill_n = 0

    @staticmethod
    def _check_keys(hi: np.ndarray) -> None:
        if len(hi) and int(np.max(hi)) >> 31:
            raise ValueError("key hi words must be below 2^31 (packed "
                             "protein kmers)")

    def add_candidates(self, lo: np.ndarray, hi: np.ndarray,
                       role: np.ndarray) -> None:
        if len(lo):
            self._check_keys(hi)
            if self._native is not None:
                self._native.add_candidates(lo, hi, role)
                return
            self._pend.append((lo, hi, role))
            self._pend_n += len(lo)
            if self._pend_n >= self.chunk_entries:
                self._flush()

    def add_kills(self, lo: np.ndarray, hi: np.ndarray) -> None:
        if len(lo):
            self._check_keys(hi)
            if self._native is not None:
                self._native.add_kills(lo, hi)
                return
            self._pend_kill.append((lo, hi))
            self._pend_kill_n += len(lo)
            if self._pend_kill_n >= self.chunk_entries:
                self._flush_kills()

    def _words(self, parts: list[np.ndarray]) -> torch.Tensor:
        """Concatenated uint32 key words as an int64 tensor on the
        builder's device."""
        words = np.concatenate(parts).astype(np.uint32).astype(np.int64)
        return torch.from_numpy(words).to(self.device)

    @staticmethod
    def _u32(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy().astype(np.uint32)

    def _flush(self) -> None:
        if not self._pend:
            return
        slo, shi, srole = self.state
        lo = self._words([slo] + [p[0] for p in self._pend])
        hi = self._words([shi] + [p[1] for p in self._pend])
        role = torch.from_numpy(np.concatenate(
            [srole] + [p[2] for p in self._pend]).astype(np.int32)).to(
                self.device)
        self._pend, self._pend_n = [], 0
        dlo, dhi, drole, keep = _resolve_groupby(lo, hi, role)
        self.state = (self._u32(dlo[keep]), self._u32(dhi[keep]),
                      drole[keep].cpu().numpy())
        log.info("build state: %d unique kmers (%d conflicted).",
                 len(self.state[0]),
                 int((self.state[2] == CONFLICT).sum()))

    def _flush_kills(self) -> None:
        if not self._pend_kill:
            return
        klo, khi = self.kill_state
        lo = self._words([klo] + [p[0] for p in self._pend_kill])
        hi = self._words([khi] + [p[1] for p in self._pend_kill])
        self._pend_kill, self._pend_kill_n = [], 0
        dlo, dhi, keep = _dedup_groupby(lo, hi)
        self.kill_state = (self._u32(dlo[keep]), self._u32(dhi[keep]))

    def finish(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, dict]:
        """Resolve everything: returns (lo, hi, role) of the surviving
        discriminating kmers, sorted by key, and the stats."""
        if self._native is not None:
            lo, hi, role, stats = self._native.finish()
            self._native.close()
            self._native = None
            return lo, hi, role, stats
        self._flush()
        self._flush_kills()
        lo, hi, role = self.state
        n_unique = len(lo)
        live = role != CONFLICT
        lo, hi, role = lo[live], hi[live], role[live]
        n_pruned = n_unique - len(lo)

        n_killed = 0
        klo, khi = self.kill_state
        if len(klo) and len(lo):
            table, max_probes = build_table(
                lo, hi, np.arange(len(lo), dtype=np.uint32))
            cand = wide_table_from_numpy(table, self.device)
            dead = torch.zeros(len(lo), dtype=torch.bool,
                               device=self.device)
            step = self.chunk_entries
            for s in range(0, len(klo), step):
                kl, kh = (torch.from_numpy(w[s: s + step].view(np.int32))
                          .to(self.device) for w in (klo, khi))
                dead |= _mark_killed(cand, kl, kh, len(lo), max_probes)
            dead = dead.cpu().numpy()
            n_killed = int(dead.sum())
            lo, hi, role = lo[~dead], hi[~dead], role[~dead]
        stats = {"pruned": n_pruned, "killed": n_killed,
                 "unique": n_unique}
        return lo, hi, role, stats


def _dedup_pairs(lo: np.ndarray, hi: np.ndarray,
                 role: np.ndarray | None) -> tuple[np.ndarray, ...]:
    """Host dedup of (key, role) pairs within one genome through one
    uint64 key and a lexsort (``signature.py:285-303``).  Unanimity depends
    only on the SET of roles seen per kmer, not on counts."""
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    if role is None:
        k_u = np.unique(key)
        return ((k_u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                (k_u >> np.uint64(32)).astype(np.uint32))
    order = np.lexsort((role, key))
    k_s, r_s = key[order], role[order]
    keep = np.ones(len(order), bool)
    keep[1:] = (k_s[1:] != k_s[:-1]) | (r_s[1:] != r_s[:-1])
    k_u, r_u = k_s[keep], r_s[keep]
    return ((k_u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (k_u >> np.uint64(32)).astype(np.uint32),
            r_u.astype(np.int32))


# ---------------------------------------------------------------------------
# the signature table object
# ---------------------------------------------------------------------------

@dataclass
class SignatureTable:
    """A built discriminating-kmer table: packed keys and role indices
    (``signature.py:310-555``), host NumPy arrays.  ``alphabet`` selects
    the key packing: "prot" (5-bit codes, k <= 12) or "dna" (2-bit codes
    with a marker bit, k <= 15); both give (lo, hi) uint32 pairs served by
    the same tables."""

    k: int
    key_lo: np.ndarray          # (N,) uint32
    key_hi: np.ndarray          # (N,) uint32
    role_idx: np.ndarray        # (N,) int32, index into role_ids
    role_ids: list[str]         # role index -> role ID string
    alphabet: str = "prot"      # "prot" | "dna"
    weights: np.ndarray | None = None  # (N,) float32 >= 0, or None
    stats: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.key_lo)

    # ----- text round trip (the reference interchange format) -----

    def kmer_texts(self) -> list[str]:
        if self.alphabet == "dna":
            codes = unpack_dna_np(self.key_lo, self.key_hi, self.k)
            return [decode_dna(row) for row in codes]
        codes = unpack_kmer_np(self.key_lo, self.key_hi, self.k)
        return [decode_protein(row) for row in codes]

    def save(self, target: str | IO) -> None:
        """Write ``kmer TAB roleId`` lines (BuildKmerProcessor.java:215);
        weighted tables add a third ``weight`` column.  A ``.kdb`` /
        ``.npz`` path selects the binary format (:meth:`save_binary`)."""
        if isinstance(target, str) and target.endswith((".kdb", ".npz")):
            return self.save_binary(target)
        fh = open(target, "w") if isinstance(target, str) else target
        try:
            if self.weights is None:
                for text, ridx in zip(self.kmer_texts(), self.role_idx):
                    fh.write(f"{text}\t{self.role_ids[ridx]}\n")
            else:
                for text, ridx, w in zip(self.kmer_texts(), self.role_idx,
                                         self.weights):
                    fh.write(f"{text}\t{self.role_ids[ridx]}\t{w:.6g}\n")
        finally:
            if isinstance(target, str):
                fh.close()

    # ----- binary round trip: the packed arrays as an uncompressed npz -----

    def save_binary(self, path: str) -> None:
        with open(path, "wb") as fh:
            np.savez(
                fh, format=np.array("kmers-anno-tpu-kdb-1"),
                k=np.array(self.k, np.int32),
                alphabet=np.array(self.alphabet),
                role_ids=np.array(self.role_ids, dtype="U"),
                key_lo=self.key_lo, key_hi=self.key_hi,
                role_idx=self.role_idx,
                **({"weights": self.weights}
                   if self.weights is not None else {}))

    @classmethod
    def load_binary(cls, path: str) -> "SignatureTable":
        with np.load(path, allow_pickle=False) as z:
            fmt = str(z["format"])
            if fmt != "kmers-anno-tpu-kdb-1":
                raise ValueError(f"unknown kmer DB format {fmt!r}")
            return cls(
                k=int(z["k"]), key_lo=z["key_lo"], key_hi=z["key_hi"],
                role_idx=z["role_idx"], role_ids=list(z["role_ids"]),
                alphabet=str(z["alphabet"]),
                weights=z["weights"] if "weights" in z else None)

    @classmethod
    def load(cls, source: str | IO,
             alphabet: str | None = None) -> "SignatureTable":
        """Load a kmer DB TSV; K is the length of the kmer text
        (ApplyKmerProcessor.java:108).  Binary DBs are recognised by their
        zip magic.  ``alphabet`` None detects it as the reference does:
        kmer texts made of ``acgtu`` alone, in either case, are DNA;
        everything else is protein.  Pass "prot" or "dna" to force.  A DNA
        kmer with an ambiguous base raises."""
        if isinstance(source, str):
            with open(source, "rb") as bf:
                if bf.read(4) == b"PK\x03\x04":  # npz zip magic
                    return cls.load_binary(source)
        fh = open(source, "r") if isinstance(source, str) else source
        try:
            kmers: list[str] = []
            ridx: list[int] = []
            role_ids: list[str] = []
            role_index: dict[str, int] = {}
            wcol: list[float] = []
            for line in fh:
                line = line.rstrip("\r\n")
                if not line:
                    continue
                fields = line.split("\t")
                kmer, role = fields[:2]
                i = role_index.get(role)
                if i is None:
                    i = role_index[role] = len(role_ids)
                    role_ids.append(role)
                kmers.append(kmer)
                ridx.append(i)
                if len(fields) >= 3:
                    w = float(fields[2])
                    if w < 0:
                        raise ValueError(f"negative kmer weight {w}")
                    wcol.append(w)
        finally:
            if isinstance(source, str):
                fh.close()
        if not kmers:
            raise ValueError("empty kmer database")
        if wcol and len(wcol) != len(kmers):
            raise ValueError("weight column present on only some rows")
        weights = np.asarray(wcol, np.float32) if wcol else None
        k = len(kmers[0])
        if alphabet is None:
            dna_chars = set("acgtu")
            alphabet = ("dna" if all(set(km.lower()) <= dna_chars
                                     for km in kmers) else "prot")
        if min(map(len, kmers)) < k:
            raise ValueError(f"a kmer is shorter than the first ({k})")
        if alphabet == "dna":
            bad = np.flatnonzero(encode_dna("".join(kmers)) >= 4)
            if len(bad):
                ends = np.cumsum([len(km) for km in kmers])
                km = kmers[int(np.searchsorted(ends, bad[0], side="right"))]
                raise ValueError(f"ambiguous base in DNA kmer {km.lower()!r}")
            encode, pack = encode_dna, pack_dna_np
        else:
            encode, pack = encode_protein, pack_kmers_np
        # each kmer's first k residues, as the reference packs them, in
        # one encode and one pack: window i * k of the joined text is kmer i
        lo, hi = pack(encode("".join(km[:k] for km in kmers)), k)
        return cls(k=k, key_lo=lo[::k].copy(), key_hi=hi[::k].copy(),
                   role_idx=np.asarray(ridx, np.int32), role_ids=role_ids,
                   alphabet=alphabet, weights=weights)

    # ----- device tables -----

    def device_wide_table(self, packed_weights: bool = False, *,
                          device: str | torch.device):
        """The wide-bucket table (``ops.widetable``), resident on
        ``device`` so the hot path never uploads it again.

        packed_weights=True stores ``fp16_bits(weight) << 16 | role_idx``
        payloads for the weighted vote (1.0 where the table has no
        weights); otherwise the payloads are the role indices.

        returns (table (rows, 72) int32 tensor, salt int, max_probes int),
        or None when the keys do not fit one wide table.
        """
        if not fits_wide(len(self.key_lo)):
            return None
        table, salt, max_probes = build_wide_table(
            self.key_lo, self.key_hi, self._payloads(packed_weights))
        return (wide_table_from_numpy(table, resolve_device(device)), salt,
                max_probes)

    def device_table(self, load_factor: float = 0.5,
                     packed_weights: bool = False, *,
                     device: str | torch.device):
        """The 8-slot bucket table (``ops.hashtable``) of the flat-stream
        apply step, built on the host and resident on ``device``
        (``signature.py:469-485``); payloads as for
        :meth:`device_wide_table`.

        The table stays in this plain layout at every size.  The reference's
        ``device_probe_table`` lays tables past 48 MB out in probe windows
        for its sort-and-stream probe; a walk on the card leaves its home
        bucket too rarely for the window to pay for twice the memory.

        returns (table (B, 24) int32 tensor, max_probes int)
        """
        table, max_probes = build_table(
            self.key_lo, self.key_hi, self._payloads(packed_weights),
            load_factor=load_factor)
        return wide_table_from_numpy(table, resolve_device(device)), max_probes

    def device_key_filter(self, *, device: str | torch.device
                          ) -> torch.Tensor:
        """The key filter (``ops.key_filter``) of :meth:`device_table`'s
        keys, built and resident on ``device``: the flat-stream kernels
        read it in front of the table walk.  A separate array, so the
        table's bytes stay the reference's.

        returns (sectors, 8) int32 tensor (the uint32 words)
        """
        return build_key_filter(self.key_lo, self.key_hi,
                                resolve_device(device))

    def _payloads(self, packed_weights: bool) -> np.ndarray:
        if packed_weights:
            if len(self.role_ids) >= 1 << 16:
                raise ValueError("weighted payload packing supports "
                                 "< 65536 roles")
            w = (self.weights if self.weights is not None
                 else np.ones(len(self.key_lo), np.float32))
            # fp16 payload: clamp to the finite range.  'balance' weights
            # of rare roles can exceed 65504; as +inf a single hit would
            # win any threshold.
            if len(w) and float(w.max()) > _FP16_MAX:
                log.warning(
                    "clamping %d kmer weights above %.0f to the fp16 "
                    "payload maximum", int((w > _FP16_MAX).sum()), _FP16_MAX)
                w = np.minimum(w, _FP16_MAX)
            bits = w.astype(np.float16).view(np.uint16).astype(np.uint32)
            return (bits << np.uint32(16)) | self.role_idx.astype(np.uint32)
        return self.role_idx.astype(np.uint32)

    def role_counts(self) -> CountMap:
        """Kmers a role, the roles in order of their first kmer (one
        ``np.unique``, not a Python step a kmer)."""
        roles, first, n = np.unique(self.role_idx, return_index=True,
                                    return_counts=True)
        counts = CountMap()
        for i in np.argsort(first):
            counts.count(self.role_ids[roles[i]], int(n[i]))
        return counts


# ---------------------------------------------------------------------------
# the build pipeline
# ---------------------------------------------------------------------------

def _peg_source(genome: Genome, peg, k: int, alphabet: str):
    """What one peg contributes to the build, or None when it has no usable
    sequence (``signature.py:562-584``): its protein translation, packed
    with the genome's other pegs by :func:`_flat_protein_keys`; in DNA mode
    the (lo, hi) keys of the unambiguous windows of its coding-strand CDS
    DNA (apply scans both strands, so genes on either strand are found
    without storing reverse complements)."""
    if alphabet == "dna":
        loc = peg.location
        if loc is None:
            return None
        dna = genome.get_dna(loc)
        if len(dna) < k:
            return None
        codes = encode_dna(dna)
        lo, hi = pack_dna_np(codes, k)
        ok = dna_valid_np(codes, k)
        return lo[ok], hi[ok]
    prot = peg.protein_translation
    if not prot or len(prot) < k:
        return None
    return prot


def _batch_keys(sources: list, k: int, alphabet: str
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The keys of a genome's pegs (:func:`_peg_source` of each) and the
    index of the peg of each key."""
    if alphabet != "dna":
        return _flat_protein_keys(sources, k)
    seg = np.repeat(np.arange(len(sources), dtype=np.int32),
                    [len(lo) for lo, _ in sources])
    return (np.concatenate([lo for lo, _ in sources]),
            np.concatenate([hi for _, hi in sources]), seg)


def _flat_protein_keys(prots: list[str], k: int
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Packed kmer keys of a protein batch over ONE flat token stream
    (``signature.py:587-620``): the C++ loader ``native.flat_batch`` when
    available, then one vectorised pack.  returns (lo, hi, seg): every
    in-protein window's key and the index of its protein."""
    if not prots:
        z = np.zeros(0, np.uint32)
        return z, z, np.zeros(0, np.int32)
    total = sum(map(len, prots))
    width = total + k   # tail pad so the window pack covers every start
    got = native.flat_batch(prots, k, width, -1)
    if got is not None:
        codes, seg, valid = got
    else:
        codes = np.full(width, 0, np.uint8)
        seg = np.full(width, -1, np.int32)
        valid = np.zeros(width, bool)
        pos = 0
        for i, p in enumerate(prots):
            ln = len(p)
            codes[pos: pos + ln] = encode_protein(p)
            seg[pos: pos + ln] = i
            if ln >= k:
                valid[pos: pos + ln - k + 1] = True
            pos += ln
    lo, hi = pack_kmers_np(codes, k)
    v = apply_drop_last(valid[: len(lo)])
    return lo[v], hi[v], seg[: len(lo)][v]


def compute_weights(role_idx: np.ndarray, mode: str) -> np.ndarray | None:
    """Per-kmer weights for the weighted vote (``signature.py:623-641``).

    "uniform": every kmer weighs 1.0.  "balance": kmers of a role weigh
    mean_kmers_per_role / kmers(role), so every role carries the same
    total vote mass.  "none": None (the reference's unweighted table).
    """
    if mode == "none":
        return None
    if mode == "uniform":
        return np.ones(len(role_idx), np.float32)
    if mode == "balance":
        if len(role_idx) == 0:
            return np.zeros(0, np.float32)
        counts = np.bincount(role_idx)
        mean = len(role_idx) / max((counts > 0).sum(), 1)
        return (mean / counts[role_idx]).astype(np.float32)
    raise ValueError(f"unknown weight mode {mode!r}")


def build_signatures(genomes: Iterable[Genome], role_map: RoleMap,
                     good_roles: Sequence[str], k: int = 8,
                     genome_filter: set[str] | None = None,
                     progress: bool = True,
                     alphabet: str = "prot",
                     weight_mode: str = "none",
                     backend: str = "auto", *,
                     device: str | torch.device) -> SignatureTable:
    """Build the discriminating-kmer table (``build`` command semantics,
    ``signature.py:644-761``).

    genomes:       iterable of Genome (one pass)
    role_map:      role definitions (roles.in.subsystems)
    good_roles:    interesting role IDs (roles.to.use column 1)
    genome_filter: optional set of genome IDs to process (-g option)
    alphabet:      "prot", or "dna" (nucleotide kmers of the CDS DNA)
    weight_mode:   "none" | "uniform" | "balance" per-kmer vote weights
    backend, device: the group-by's (:class:`StreamingTableBuilder`)
    """
    if alphabet not in ("prot", "dna"):
        raise ValueError(f"unknown alphabet {alphabet!r}")
    good = set(good_roles)
    role_ids: list[str] = []
    role_index: dict[str, int] = {}

    builder = StreamingTableBuilder(backend=backend, device=device)
    buffered = 0

    for genome in genomes:
        if genome_filter is not None and genome.id not in genome_filter:
            continue
        n_interesting = 0
        n_buffered = 0
        i_pegs: list = []
        i_ridx: list[int] = []
        k_pegs: list = []
        for peg in genome.pegs:
            source = _peg_source(genome, peg, k, alphabet)
            if source is None:
                continue
            peg_roles = [r for r in peg.get_useful_roles(role_map)
                         if r.id in good]
            if not peg_roles:
                # kill-list protein (BuildKmerProcessor.java:160-164)
                k_pegs.append(source)
                n_buffered += 1
            elif len(peg_roles) == 1:
                # sole interesting role
                rid = peg_roles[0].id
                ridx = role_index.get(rid)
                if ridx is None:
                    ridx = role_index[rid] = len(role_ids)
                    role_ids.append(rid)
                i_pegs.append(source)
                i_ridx.append(ridx)
                n_interesting += 1
        if i_pegs:
            lo, hi, seg = _batch_keys(i_pegs, k, alphabet)
            lo, hi, role = _dedup_pairs(
                lo, hi, np.asarray(i_ridx, np.int32)[seg])
            builder.add_candidates(lo, hi, role)
        if k_pegs:
            lo, hi, _ = _batch_keys(k_pegs, k, alphabet)
            builder.add_kills(*_dedup_pairs(lo, hi, None))
        buffered += n_buffered
        if progress:
            log.info("%s: %d interesting pegs, %d buffered.",
                     genome, n_interesting, n_buffered)

    # pass 1 prune (unanimity) + pass 2 kill, streamed (bounded memory)
    slo, shi, srole, bstats = builder.finish()
    log.info("%d non-unique kmers deleted.  %d discriminating kmers left.  "
             "%d proteins buffered.", bstats["pruned"],
             bstats["unique"] - bstats["pruned"], buffered)
    log.info("%d kmers killed by buffered proteins.  "
             "%d discriminating kmers remaining.",
             bstats["killed"], len(slo))

    table = SignatureTable(
        k=k, key_lo=slo, key_hi=shi, role_idx=srole, role_ids=role_ids,
        alphabet=alphabet, weights=compute_weights(srole, weight_mode),
        stats={"buffered": buffered, "pruned": bstats["pruned"],
               "killed": bstats["killed"]})
    counts = table.role_counts()
    for rid in good:
        if counts.get_count(rid) == 0:
            log.warning("No kmers found for %s: %s.",
                        rid, role_map.get_name(rid))
    return table
