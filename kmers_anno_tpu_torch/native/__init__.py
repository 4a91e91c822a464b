"""Native host runtime (C++ data loader) with transparent NumPy fallback.

``kan_host.cpp`` implements the host-side hot loops (protein and DNA
encoding, fused flat-batch, peg-batch and row-batch construction, FASTA
parsing, the streaming signature builder, the key group-by) and the
single-core baselines the port is checked against, as a C ABI shared
library loaded via ctypes.
Every call releases the GIL, so Python-thread prefetching overlaps with
device compute.  The library is built on first use with g++ (one-time,
~2 s) into ``kmers_anno_tpu_torch/_build/``; if that fails, callers fall
back to the pure-NumPy implementations and everything still works.

Set ``KAN_NATIVE=0`` to disable the native path entirely.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "kan_host.cpp")
_SO = os.path.join(os.path.dirname(_DIR), "_build", "libkan_host.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build() -> bool:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)    # atomic: no reader sees a partial library
        return True
    except (OSError, subprocess.SubprocessError) as exc:
        log.debug("native build failed: %s", exc)
        return False


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, building it on first use; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("KAN_NATIVE", "1") == "0":
            return None
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError as exc:
            log.debug("native load failed: %s", exc)
            return None
        c_char_p = ctypes.c_char_p
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        i32 = ctypes.c_int32
        lib.kan_encode_protein.argtypes = [c_char_p, i64, u8p]
        lib.kan_encode_dna.argtypes = [c_char_p, i64, u8p]
        lib.kan_flat_batch.argtypes = [
            c_char_p, i64p, i64, i64, i32, i32, u8p, i32p, u8p]
        lib.kan_flat_peg_batch.argtypes = [
            c_char_p, i64p, i64, i64, i32, u8p, i32p, i32p, i32p]
        lib.kan_row_batch.argtypes = [
            c_char_p, i64p, i64, i64, i64, i32, u8p, u8p]
        lib.kan_fasta_read.restype = ctypes.c_void_p
        lib.kan_fasta_read.argtypes = [c_char_p]
        for fn in (lib.kan_fasta_nseq, lib.kan_fasta_seqbytes,
                   lib.kan_fasta_hdrbytes):
            fn.restype = i64
            fn.argtypes = [ctypes.c_void_p]
        lib.kan_fasta_fill.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, i64p, ctypes.c_char_p, i64p]
        lib.kan_fasta_free.argtypes = [ctypes.c_void_p]
        lib.kan_apply_baseline.argtypes = [
            u8p, i64, i64, u32p, i64, i32, i32, i32, i32p]
        lib.kan_build_new.restype = ctypes.c_void_p
        lib.kan_build_add.argtypes = [ctypes.c_void_p, u32p, u32p, i32p, i64]
        lib.kan_build_kills.argtypes = [ctypes.c_void_p, u32p, u32p, i64]
        lib.kan_build_finish.restype = i64
        lib.kan_build_finish.argtypes = [ctypes.c_void_p, i64p]
        lib.kan_build_fill.argtypes = [ctypes.c_void_p, u32p, u32p, i32p]
        lib.kan_build_free.argtypes = [ctypes.c_void_p]
        lib.kan_groupby.restype = i64
        lib.kan_groupby.argtypes = [u32p, u32p, i64, i32p, i64p]
        lib.kan_proj_new.restype = ctypes.c_void_p
        lib.kan_proj_new.argtypes = [u8p, i64p, i64, u8p, i32]
        lib.kan_proj_map_size.restype = i64
        lib.kan_proj_map_size.argtypes = [ctypes.c_void_p]
        lib.kan_proj_match.argtypes = [
            ctypes.c_void_p, u8p, i64p, i64, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, i64p]
        lib.kan_proj_free.argtypes = [ctypes.c_void_p]
        lib.kan_java_new.restype = ctypes.c_void_p
        lib.kan_java_new.argtypes = [i64]
        lib.kan_java_add.argtypes = [ctypes.c_void_p, c_char_p, i64, i32,
                                     i32p]
        lib.kan_java_apply.argtypes = [ctypes.c_void_p, c_char_p, i64p,
                                       i64, i32, i32, i32p]
        lib.kan_java_free.argtypes = [ctypes.c_void_p]
        lib.kan_jproj_new.restype = ctypes.c_void_p
        lib.kan_jproj_new.argtypes = [u8p, i64p, i64, u8p, i32]
        lib.kan_jproj_map_size.restype = i64
        lib.kan_jproj_map_size.argtypes = [ctypes.c_void_p]
        lib.kan_jproj_match.argtypes = [
            ctypes.c_void_p, u8p, i64p, i64, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, i64p]
        lib.kan_jproj_free.argtypes = [ctypes.c_void_p]
        lib.kan_hash_new.restype = ctypes.c_void_p
        lib.kan_hash_new.argtypes = [u8p, i64p, i64, i32, ctypes.c_double]
        lib.kan_hash_kmers.restype = i64
        lib.kan_hash_kmers.argtypes = [ctypes.c_void_p]
        lib.kan_hash_score.restype = i64
        lib.kan_hash_score.argtypes = [ctypes.c_void_p, u8p, i64p, i64, i32]
        lib.kan_hash_best.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"), i32p]
        lib.kan_hash_free.argtypes = [ctypes.c_void_p]
        lib.kan_dna_baseline.restype = i64
        lib.kan_dna_baseline.argtypes = [u8p, i64, u32p, i64, i32, i32]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _concat_offsets(seqs: list[str]) -> tuple[bytes, np.ndarray]:
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    return "".join(seqs).encode("ascii", errors="replace"), offsets


def _encoded(lib, seqs: list[str]) -> tuple[np.ndarray, np.ndarray]:
    concat_b, offs = _concat_offsets(seqs)
    codes = np.empty(len(concat_b), np.uint8)
    lib.kan_encode_protein(concat_b, len(concat_b), codes)
    return codes, offs


def flat_batch(proteins: list[str], k: int, width: int, pad_seg: int
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Fused FlatBatch arrays (codes, seg_ids, valid) or None (no native)."""
    lib = get_lib()
    if lib is None:
        return None
    concat, offsets = _concat_offsets(proteins)
    codes = np.empty(width, np.uint8)
    seg_ids = np.empty(width, np.int32)
    valid = np.empty(width, np.uint8)
    lib.kan_flat_batch(concat, offsets, len(proteins), width, pad_seg, k,
                       codes, seg_ids, valid)
    return codes, seg_ids, valid.view(bool)


def row_batch(proteins: list[str], k: int, n_rows: int, width: int
              ) -> tuple[np.ndarray, np.ndarray] | None:
    """Fused RowBatch arrays (codes (n_rows, width) uint8, valid bool) or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    concat, offsets = _concat_offsets(proteins)
    codes = np.empty((n_rows, width), np.uint8)
    valid = np.empty((n_rows, width), np.uint8)
    lib.kan_row_batch(concat, offsets, len(proteins), n_rows, width, k,
                      codes.reshape(-1), valid.reshape(-1))
    return codes, valid.view(bool)


def flat_peg_batch(proteins: list[str], width: int, pad_seg: int
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray] | None:
    """Fused peg-singleton arrays (codes, seg_ids, pos_in_seq, len_bcast)."""
    lib = get_lib()
    if lib is None:
        return None
    concat, offsets = _concat_offsets(proteins)
    codes = np.empty(width, np.uint8)
    seg_ids = np.empty(width, np.int32)
    pos_in_seq = np.empty(width, np.int32)
    len_bcast = np.empty(width, np.int32)
    lib.kan_flat_peg_batch(concat, offsets, len(proteins), width, pad_seg,
                           codes, seg_ids, pos_in_seq, len_bcast)
    return codes, seg_ids, pos_in_seq, len_bcast


def apply_baseline(codes: np.ndarray, table: np.ndarray, max_probes: int,
                   k: int, min_hits: int) -> np.ndarray | None:
    """Single-core compiled apply loop over the 8-slot table.

    codes: (n_prot, plen) uint8 protein codes; table: (B, 24) uint32
    returns (n_prot,) int32 called role per protein (-1 = uncalled),
    or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    table = np.ascontiguousarray(table, np.uint32)
    n_prot, plen = codes.shape
    out = np.empty(n_prot, np.int32)
    lib.kan_apply_baseline(codes.reshape(-1), n_prot, plen,
                           table.reshape(-1), table.shape[0],
                           max_probes, k, min_hits, out)
    return out


def encode_protein(s: str) -> np.ndarray | None:
    """Protein string → uint8 codes (``ops.encode.encode_protein``), or None
    when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    raw = s.encode("ascii", errors="replace")
    out = np.empty(len(raw), np.uint8)
    lib.kan_encode_protein(raw, len(raw), out)
    return out


def encode_dna(s: str) -> np.ndarray | None:
    """DNA string → uint8 codes (``ops.encode.encode_dna``), or None when
    the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    raw = s.encode("ascii", errors="replace")
    out = np.empty(len(raw), np.uint8)
    lib.kan_encode_dna(raw, len(raw), out)
    return out


def dna_baseline(codes: np.ndarray, table: np.ndarray, max_probes: int,
                 k: int) -> int | None:
    """Single-core DNA window probe (kan_dna_baseline): packs every 2-bit
    kmer window of a code stream without an ambiguous base and walks the
    same 8-slot table as the device DNA mode.  Returns the hit count, or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    table = np.ascontiguousarray(table, np.uint32)
    return int(lib.kan_dna_baseline(codes, len(codes), table.reshape(-1),
                                    table.shape[0], max_probes, k))


def read_fasta(path: str) -> list[tuple[str, str, str]] | None:
    """Parse a FASTA file natively → [(label, comment, sequence)], or None
    when the native library is unavailable.  The label ends at the first
    blank, tab or carriage return; the comment is the rest of the header
    line after that one character, trailing blanks dropped; sequence lines
    are joined with every blank, tab and carriage return removed."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.kan_fasta_read(path.encode())
    if not h:
        raise FileNotFoundError(f"cannot read FASTA file {path}")
    try:
        n = lib.kan_fasta_nseq(h)
        seq = ctypes.create_string_buffer(max(1, lib.kan_fasta_seqbytes(h)))
        hdr = ctypes.create_string_buffer(max(1, lib.kan_fasta_hdrbytes(h)))
        offs = np.empty(n + 1, np.int64)
        hoffs = np.empty(n + 1, np.int64)
        lib.kan_fasta_fill(h, seq, offs, hdr, hoffs)
    finally:
        lib.kan_fasta_free(h)
    sq = seq.raw
    hd = hdr.raw
    out = []
    for i in range(n):
        label, _, comment = (
            hd[hoffs[i]: hoffs[i + 1]].decode("ascii", "replace")
            .partition("\t"))
        out.append((label, comment, sq[offs[i]: offs[i + 1]].decode(
            "ascii", "replace")))
    return out


class _Handle:
    """Owner of one C++ handle: ``close`` (and garbage collection) frees
    it with the library's ``free`` function."""

    __slots__ = ("_lib", "_h", "_free")

    def __init__(self, lib, handle, free):
        if not handle:
            raise MemoryError("native handle allocation failed")
        self._lib = lib
        self._h = handle
        self._free = free

    def close(self):
        if self._h:
            self._free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeBuilder(_Handle):
    """The C++ streaming signature builder (kan_build_* in kan_host.cpp).
    Same semantics as the device group-by StreamingTableBuilder:
    sorted-unique state, CONFLICT (-2) role tombstones, kill-list
    subtraction at finish."""

    __slots__ = ()

    def __init__(self, lib):
        super().__init__(lib, lib.kan_build_new(), lib.kan_build_free)

    def add_candidates(self, lo, hi, role):
        self._lib.kan_build_add(
            self._h, np.ascontiguousarray(lo, np.uint32),
            np.ascontiguousarray(hi, np.uint32),
            np.ascontiguousarray(role, np.int32), len(lo))

    def add_kills(self, lo, hi):
        self._lib.kan_build_kills(
            self._h, np.ascontiguousarray(lo, np.uint32),
            np.ascontiguousarray(hi, np.uint32), len(lo))

    def finish(self):
        stats = np.zeros(3, np.int64)
        n = self._lib.kan_build_finish(self._h, stats)
        lo = np.empty(n, np.uint32)
        hi = np.empty(n, np.uint32)
        role = np.empty(n, np.int32)
        self._lib.kan_build_fill(self._h, lo, hi, role)
        return lo, hi, role, {"unique": int(stats[0]),
                              "pruned": int(stats[1]),
                              "killed": int(stats[2])}


def groupby(lo: np.ndarray, hi: np.ndarray
            ) -> tuple[np.ndarray, np.ndarray] | None:
    """Stable key group-by (kan_groupby): returns (order (n,) int32,
    ustarts (U,) int64) or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    lo = np.ascontiguousarray(lo, np.uint32)
    hi = np.ascontiguousarray(hi, np.uint32)
    n = len(lo)
    order = np.empty(n, np.int32)
    ustarts = np.empty(n, np.int64)
    u = lib.kan_groupby(lo, hi, n, order, ustarts)
    return order, ustarts[:u]


def make_builder() -> "NativeBuilder | None":
    """A native streaming builder handle, or None (no native library)."""
    lib = get_lib()
    if lib is None:
        return None
    return NativeBuilder(lib)


def _required_lib() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


class ProjectionBaseline(_Handle):
    """Single-core compiled ORF-projection hot loops (kan_proj_* in
    kan_host.cpp), the stand-in for the reference tool's single-core
    annotateGenome path (KmerProcessor.java:166-287).  Build the contig
    kmer map once, then ``match`` each close genome's proteins; returns
    (pairs, groups, live-candidate) counters for cross-checking against
    the device engine."""

    __slots__ = ()

    def __init__(self, contig_codes: list[np.ndarray], lut65: np.ndarray,
                 k: int):
        lib = _required_lib()
        concat = np.ascontiguousarray(
            np.concatenate(contig_codes) if contig_codes
            else np.zeros(0, np.uint8), np.uint8)
        offs = np.zeros(len(contig_codes) + 1, np.int64)
        np.cumsum([len(c) for c in contig_codes], out=offs[1:])
        super().__init__(lib, lib.kan_proj_new(
            concat, offs, len(contig_codes),
            np.ascontiguousarray(lut65, np.uint8), k), lib.kan_proj_free)

    def map_size(self) -> int:
        return int(self._lib.kan_proj_map_size(self._h))

    def match(self, proteins: list[str], min_strength: float,
              max_fuzz: float, min_fuzz: float) -> tuple[int, int, int]:
        codes, offs = _encoded(self._lib, proteins)
        out = np.zeros(3, np.int64)
        self._lib.kan_proj_match(self._h, codes, offs, len(proteins),
                                 min_strength, max_fuzz, min_fuzz, out)
        return int(out[0]), int(out[1]), int(out[2])


class JavaProjectionBaseline(_Handle):
    """Java-dataflow ORF-projection hot loops (kan_jproj_* in
    kan_host.cpp): a string-keyed contig kmer map, CountMap<String>
    singleton counting and per-window substring hashing, the closest
    single-core model of what KmerProcessor.annotateGenome runs on the JVM
    (KmerReference.java:157-203, KmerProcessor.java:197-254).  Same
    ``match`` contract as :class:`ProjectionBaseline`."""

    __slots__ = ()

    def __init__(self, contig_codes: list[np.ndarray], lut65: np.ndarray,
                 k: int):
        lib = _required_lib()
        concat = np.ascontiguousarray(
            np.concatenate(contig_codes) if contig_codes
            else np.zeros(0, np.uint8), np.uint8)
        offs = np.zeros(len(contig_codes) + 1, np.int64)
        np.cumsum([len(c) for c in contig_codes], out=offs[1:])
        super().__init__(lib, lib.kan_jproj_new(
            concat, offs, len(contig_codes),
            np.ascontiguousarray(lut65, np.uint8), k), lib.kan_jproj_free)

    def map_size(self) -> int:
        return int(self._lib.kan_jproj_map_size(self._h))

    def match(self, proteins: list[str], min_strength: float,
              max_fuzz: float, min_fuzz: float) -> tuple[int, int, int]:
        codes, offs = _encoded(self._lib, proteins)
        out = np.zeros(3, np.int64)
        self._lib.kan_jproj_match(self._h, codes, offs, len(proteins),
                                  min_strength, max_fuzz, min_fuzz, out)
        return int(out[0]), int(out[1]), int(out[2])


class JavaDataflowBaseline(_Handle):
    """String-keyed hash-map apply walk (kan_java_*): the stand-in that
    reproduces the reference tool's Java dataflow (string kmer keys,
    per-lookup substring + character hashing; ApplyKmerProcessor.java:
    101-110, 122-145)."""

    __slots__ = ()

    def __init__(self, kmers: list[str], roles: np.ndarray, k: int):
        lib = _required_lib()
        super().__init__(lib, lib.kan_java_new(len(kmers)),
                         lib.kan_java_free)
        concat = "".join(kmers).encode("ascii")
        lib.kan_java_add(self._h, concat, len(kmers), k,
                         np.ascontiguousarray(roles, np.int32))

    def apply(self, proteins: list[str], k: int,
              min_hits: int) -> np.ndarray:
        concat, offs = _concat_offsets(proteins)
        out = np.empty(len(proteins), np.int32)
        self._lib.kan_java_apply(self._h, concat, offs, len(proteins),
                                 k, min_hits, out)
        return out


class HashAnnoBaseline(_Handle):
    """Single-core hashAnno hot loop (kan_hash_*): the sequential
    GenomeProteinKmers dataflow, a kmer → protein hash build and, per
    prototype, probe + Jaccard best-proposal update
    (HashAnnotationProcessor.java:233-263).  The independent check of the
    device engine's best similarities and winners."""

    __slots__ = ("_n", "_base")

    def __init__(self, proteins: list[str], k: int, min_score: float):
        lib = _required_lib()
        codes, offs = _encoded(lib, proteins)
        super().__init__(lib, lib.kan_hash_new(codes, offs, len(proteins),
                                               k, min_score),
                         lib.kan_hash_free)
        self._n = len(proteins)
        self._base = 0

    def n_kmers(self) -> int:
        return int(self._lib.kan_hash_kmers(self._h))

    def score(self, prototypes: list[str]) -> int:
        """Score prototypes sequentially; returns improvement events."""
        codes, offs = _encoded(self._lib, prototypes)
        got = int(self._lib.kan_hash_score(self._h, codes, offs,
                                           len(prototypes), self._base))
        self._base += len(prototypes)
        return got

    def best(self) -> tuple[np.ndarray, np.ndarray]:
        """(best_sim float64, winning prototype index or -1) per protein."""
        sim = np.zeros(self._n, np.float64)
        proto = np.zeros(self._n, np.int32)
        self._lib.kan_hash_best(self._h, sim, proto)
        return sim, proto
