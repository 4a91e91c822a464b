#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Requires the port's C++ host library (``kmers_anno_tpu_torch/native``) to
build.  Builds the CUDA kernels from ``kmers_anno_tpu_torch/csrc`` and
holds each against its plain-PyTorch version on made-up inputs at full
size (k = 8 and 12, many hits; the scanner also on a slice that starts
off a 16-byte boundary, with an odd length), and both lookup kernels on
tables built to hold several keys of one lo word in a row and to walk
from the last row to row 0 (query counts and row widths off multiples of 32, all-invalid
queries, rows with no valid window).  Then drives the projection engine's three routes, one
after another, on a 2.94 Mb genome with 3500 planted genes and 10 close
genomes (the "realistic" projection workload of bench.py, seed 0):

1. ``kmers`` through the CLI, which must take the fused route (union
   probe + per-genome device window scan);
2. the RLE route, forced as the reference's tests force it
   (``_close_set`` gives None);
3. the host contig index route (``engine="host"``), whose per-strand
   extraction runs the contig scanner once per strand.

Each route's per-close-genome counts must equal the single-core C++ hot
loop (``ProjectionBaseline``), and all three must give the same stats and
features; each reports its seconds per genome (the fused route's median
and range of five warm runs, the RLE route's of three; the host-index
route, which builds its index on every call, its one cold run), and
one more warm fused genome runs with the port's tracer on, its spans
printed as a tree (host milliseconds and attributes).  The
last lines before the results give each phase's seconds.  Every kernel
wrapper's launch count is set to 0 before each route and read after it.
Last, each kernel is held against its plain version again on the inputs
those routes give it: the genome's padded window stream and its two
strands (contig scanner), the union table and the ten close-genome tables
of both stream routes (probe).  Both stream routes build every close
genome's table on the card (``csrc/table_build.cu``), ten launches a
close set, with no host build.

Then the ``table_build`` phase.  The table build kernel, in both layouts
(wide at the close set's common rows and salt 0; 8-slot at load 1/8), is
held to its plain version bit for bit, table and ``bad`` flag, on the
realistic close set's ten singleton sets (914,109 keys each, padded as the
engine pads them) and on forced cases (a row given 24 and 25 keys, 25 in
the last row; an 8-slot walk of 1 and of 2, a wrap past the last bucket;
rows of 300 keys, every key in one row, a chain of walks through five
buckets, pads between keys, one key, key counts off the kernel's block),
and launched five times more on memory filled with junk, every table the
same.  Its bound counts the keys read once and the table written once.
The cold ``_close_set`` of the realistic cell (singletons cached) is timed
with the device builds and with the engine's own host build in turns,
and run once more with the tracer on, its spans printed; a
batch of 4 genomes, each the realistic genome with another ordered 10 of
a pool of 14 close genomes (the 10 and copies of 4 under new ids), runs
both ways in turns, every genome's stats and features equal to the warm
fused run's; and the RLE route runs once with every close table in the
8-slot layout.

Then the signature slice.  ``build`` and ``apply`` (VERIFY, then APPLY)
run through the CLI on four synthetic genomes whose table holds about 1M
kmers; the build's torch group-by on the card must equal the C++ builder,
and every call must equal the single-core string-keyed C++ baseline
(``JavaDataflowBaseline``).  Last, the apply benchmark's shape (bench.py's
generator: a 1M-key table, 32 batches of 8192 proteins of 300 aa) runs
through ``KmerApplyEngine.call_proteins``, with roles against
``native.apply_baseline`` and proteins/s over five runs; the fused apply
kernel, its plain version and the unfused composition are timed on those
batches, and the weighted path is held against its CPU run, with uniform
weights and with fractional fp16 weights (roles and float32 tallies bit
for bit).  The main-path
comparisons give the ``kernels`` line's times and errors; ``apply_rows``
is also checked on made-up rows (k = 8, and k = 12 with lookups that walk).

Then the flat-stream path of tables past one wide table (BASELINE
config 4).  ``apply`` (VERIFY) runs through the CLI on the same genomes
with a 4M-key ``.kdb`` (the build's table plus kmers absent from every
peg), which must take the flat route and give the wide route's report
byte for byte; then ``apply_flat`` on every peg against that table,
with its key filter and without, in turns.  bench.py's proteins (32 x
8,192 of 300 aa) run through
``KmerApplyEngine.call_proteins`` against a 10M-key 8-slot table (about
403 MB) and its key filter, as one FlatBatch:
roles against ``native.apply_baseline`` on every 8th protein, both flat
kernels (``apply_flat``; ``apply_flat_weighted`` with fractional fp16
weights, one walk a call, on 8,192 proteins and on all) bit for bit
against their plain versions (dense, and role blocks) on the card and
the weighted step against a CPU run on a sample; proteins/s and a split
of one run; the filter's size, build seconds, false-positive share and
the windows that skip the walk, and both kernels with the filter and
without in turns.  On bench.py's
big-table shape (10M random keys, 4M queries) the plain-torch sliced
probe (on the probe-window layout) is timed beside the apply kernel's
walk of the same queries on the plain table.  The flat kernels are also
held to their plain versions, with the filter and without, on made-up
streams with buckets of equal lo words and walks that wrap, and the
weighted one on its edges (``WEIGHTED_EDGES``: a 40,000-aa protein,
30,000 roles, float32 ties of unequal sums, zero weights, empty
proteins, owner-round edges).

Then hashAnno.  Both chunk kernels (``hash_commons``, ``hash_best``) are
held against their plain versions on made-up chunks (k = 8 and 12, a
table whose lookups walk, owner rows at the cap, 5,000-aa prototypes,
chunk and protein counts off powers of two), each in the engine's order,
shuffled and key-major.  bench.py's hashAnno shape (4 genomes x 1,500
proteins of 250 aa, 32,768 prototypes; generator copied, seed 7) runs
through one combined ``GenomeProteinKmers``: every protein's best
similarity and winning prototype must equal ``native.HashAnnoBaseline``
(one hash a genome); it reports prototype-genome pairs/s over five warm
runs and a split of one run, and times both kernels on its first chunk
beside their plain versions, the unfused torch scatter and one
``torch.bincount`` (``library_ms``), with ``hash_commons`` also on that
chunk key-major and each order's distinct cells a kernel tile (its global
adds).  Last, ``hashAnno --batch 4`` runs
twice (cold, warm) through the CLI on the four signature genomes with a
32,832-row annotation file; every row of every ``<gid>.anno.tbl`` must
equal the baseline's best similarity (``repr``) and winner, the engine
must take its fast route, and each kernel launches once a chunk.
Then the ``commands`` phase, through the port's CLI on what the card
wrote, each command's seconds printed and each output held to a recount
that this script makes from the files themselves (no kernel may launch):
``checkAnno``, ``applyAnno`` (the DIR, LIST and DNAFASTA targets) and
``listAnno`` (FULL and NEW_ROLES) on the first hashAnno run's
``.anno.tbl`` files and ``changes.tbl``; ``compare``, ``funMap`` (its
rows the mapping file of ``funApply``), ``seqCheck`` and ``genes`` on
the ``kmers`` output against a genome of the planted genes (even genes
under the close genomes' names, odd ones under another system's);
``merge``, ``updateJson`` and ``buildGtos`` on small files it writes.
Then DNA mode.  ``probe_dna`` (``kan_dna_probe``, and
``kan_dna_probe_filtered`` with the table's key filter) is held to its
plain version bit for bit on made-up streams (k = 4, 8, 11 and 15,
unweighted and with packed fp16 weights; ambiguous bases, entries
shorter than k and of exactly k bases, entries joined where every window
across the boundary is a table key, lengths off every power of two, an
all-invalid stream, a stream valid to its end, streams of one kernel
tile less one, exactly one and one more window and of two tiles + k - 2,
windows alternating valid and invalid, slices of odd length at byte
offsets 1, 7 and 15), each with the filter and without, over tables
whose walks wrap from the last bucket to bucket 0.  ``build --dna`` (k = 15) runs through the CLI
on four genomes of one 3.86 Mb contig (``make_dna_signature_genomes``:
2,000 role CDS of 900 bp, 3% variants of 2,000 prototypes, strands
alternating; 2,000 hypothetical CDS, one in ten with 90 bp of a
prototype; 20 two-role CDS; seed 0), unweighted and with ``--weights
balance``; then ``apply`` (VERIFY, APPLY, and ``--weighted`` on the
balance build) on a fifth such genome, one launch each: every report
must equal the CPU engine's byte for byte and every strand's hits
``native.dna_baseline``'s.  Last, bench.py's DNA shape (a 2M-key k = 15
table, 4 contigs of 4,000,000 bases; generator copied, seed 7): the
kernel against its plain version and the baseline on every contig,
contig bases/s over five runs, a split of one call, and the kernel
alone against its bound.  On bench contig 0 and on the CLI genome's
stream (the 100.7 MB table) the kernel also runs with the key filter and
without in turns, beside the filter's false-positive share and a
same-shape gather (``torch.index_select`` of one 32-byte lo-key sector a
valid window).
Then several devices, every member on the one card.  ``probe_keys``
(``kan_probe_keys``, the mesh shards' key lookup) is held to its plain
version (``probe_table``) bit for bit on tables with equal-lo buckets and
wrapping walks (``keys_cases``) and on slots 0%, 3%, 28.6% and 100% live
(``live_share_keys``).  ``MeshApplyEngine`` runs the big-table
phase's 10M-key table and bench.py's 262,144 proteins as 8 genomes of
32,768 in every mode of ``MESH_MODES`` (replicated 4x1, pmax 2x2, routed
2x2 and 1x4, a routed 2x2 whose routing capacity overflows and re-runs,
weighted routed 2x2 and weighted replicated 2x1): calls equal to the
single-device engine's, weighted tallies bit for bit; proteins/s over
five runs; the split of one routed call (its count read, one a row, a
part of its own); ``probe_keys`` on both of its inputs against its plain
version and its bound: the live keys a routed member receives (and,
alone, the padded buffer that the exchange sent before it took split
sizes) and the window stream with flags that a pmax member looks up.
``DnaMeshApplyEngine`` (2x1 and 1x2) runs the DNA bench genomes and the
DNA CLI genome against ``DnaApplyEngine`` (contig bases/s).  Through the
CLI, after the ``.kdb`` run: ``apply --mesh 1x1`` in one process and
``--mesh 2x1`` in two processes joined on gloo by the ``KAN_*``
variables, in turns, three runs each, every primary report equal to
plain ``apply``'s and the secondary's the header alone; and ``batch
--data-parallel 2`` and ``hashAnno --batch 2 --data-parallel 2`` (one
lane: one card) against their sequential runs.
Each kernel's row also gives its bound (``bound_ms``): the larger of the
bytes its work needs over the card's memory rate (inputs read once,
outputs written once, and of a table the lo-key block of each row the
lookups read plus a hit's hi and payload words) and its integer
operations over the card's 32-bit rate, with ``bound_share`` = bound / time;
``launch_ms`` is the kernel alone, the mean of ``LAUNCH_REPS`` launches
back to back through its C entry point between one pair of CUDA events
(``ms`` is one call of the wrapper between its own pair, host set-up
included), with ``launch_share`` = bound / ``launch_ms``.

Usage, from the repository root:
    python3 chip_smoke.py [--profile] [--compare DIR [DIR ...]]
                          [--dna-only | --keys-only | --tables-only]

``--profile`` also traces three warm fused-route genomes with
``torch.profiler`` (device activity only) and reports, within that one
traced run, the device's busy share (the union of its kernel and copy
intervals over the run's wall time) and the kernels that take the most
device time; then a ``cProfile`` of one more warm genome on the host.

``--compare DIR [DIR ...]`` also times the kernels (``contig_scan`` on
the padded window stream and on the two strands, ``probe_wide`` on the
union table and on the fused close tables, the table build on the
realistic singleton sets in both layouts, ``apply_rows`` on the bench
batches, and ``hash_commons`` on the hashAnno bench chunk and on the
first chunk of the hashAnno CLI batch, each in the engine's order and
key-major, and ``hash_best`` on the bench chunk, and both flat apply
kernels on the big-table batch, through the earlier flat entry points on
a build that has them, and the DNA probe on the bench contigs and on the
CLI genome's stream, each without the key filter and on the engine's
path, with it, through ``kan_dna_probe`` on a build without the filtered
entry, and ``probe_keys`` on a routed member's padded buffer, on its
dense keys, on each tree's layout (this tree's dense keys against the
other tree's padded buffer, outputs held at the live slots) and on the
pmax member's stream) of this tree's build against the build of the tree at each DIR
(the root of another checkout, such as the parent commit's) through
their C entry points: in turns (A B C C B A), each turn ``LAUNCH_REPS``
passes back to back, each output equal to this build's; a build that
lacks a kernel sits that case out.

``--dna-only`` runs the kernel build, the dna phase and ``--compare`` on
its cases alone, and prints the ``dna_probe`` row in place of the result
lines.  ``--tables-only`` does the same for the table build: the
realistic projection workload, one fused annotation of it, the
``table_build`` phase and ``--compare`` on its cases (each tree's whole
device build on the realistic singleton sets).  ``--keys-only`` does the
same for the key lookup: its checks, the
big-table cell's table as 2x2 shards, ``measure_probe_keys`` on the
first two mesh genomes and ``--compare`` on its cases.

Prints the card's name and power limit, the kernel comparisons and timings,
one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Any failed check raises, so the exit code is non-zero and no result line
is printed; so does a machine without CUDA.  Imports only torch, numpy
and the port (``kmers_anno_tpu_torch``), never jax.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import io
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
K = 8
STREAM_BASES = 2 * 3_700_000     # a two-strand stream of 3.7 Mb
TABLE_KEYS = 1_000_000
N_QUERIES = 7_400_000
N_GENES = 3500
N_CLOSE = 10
REPS = 5
LAUNCH_REPS = 20                 # launches back to back in a launch_ms
SPIN_CYCLES_PER_S = 1.98e9       # the boost clock: a spin lasts at least this
WARM_RUNS = 5
RLE_WARM_RUNS = 3                # the RLE route takes ~2 s a genome
PROFILED_GENOMES = 3
AA = "ACDEFGHIKLMNPQRSTVWY"
# build + apply on synthetic genomes: each carries a ~3% substitution
# variant of every role prototype, hypothetical proteins (the kill list)
# and a few two-role pegs; sized so the table holds about 1M kmers
SIG_GENOMES = 4
SIG_ROLES = 2000
SIG_HYPOTHETICAL = 2000
SIG_MULTI = 20
SIG_SUBSTITUTION = 0.03
MIN_HITS = 5
# the apply benchmark's shape (bench.py:59-69, seed 7): a 1M-key table of
# 2000 roles, 32 batches of 8192 proteins x 300 aa
BENCH_SEED = 7
BENCH_KEYS = 1_000_000
BENCH_PROTEINS = 8192
BENCH_BATCHES = 32
PROT_LEN = 300
BENCH_WIDTH = 320                # PROT_LEN in the engine's width buckets
WEIGHTED_SAMPLE = 512            # proteins the weighted CPU run checks
# hashAnno, bench.py's shape (bench.py:651-675; seed 7, drawn fresh): 4
# genomes x 1500 proteins of 250 aa, 32,768 prototypes, min score 0.0125
HASH_SEED = 7
HASH_GENOMES = 4
HASH_PROTEINS = 1500
HASH_LEN = 250
HASH_PROTOTYPES = 32768
HASH_MIN_SCORE = 0.0125
HASH_CHUNK = 4096                # the engine's default chunk
HASH_CONFIRM = 64                # peg copies in the CLI's annotation file


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def timed(fn, reps: int = REPS, setup=None) -> tuple[float, object]:
    """Median milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up run, each timed by CUDA events recorded on the current stream
    before and after it (the stream's time from the first to the last
    launch, host gaps between launches included).  ``setup()``, if given,
    runs before every run, outside the event pair (to restore inputs that
    ``fn`` consumes)."""
    if setup:
        setup()
    out = fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        if setup:
            setup()
        torch.cuda.synchronize()
        start.record()
        out = fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times), out


def host_seconds(fn) -> tuple[float, object]:
    """Host-clock seconds of ``fn()``, ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def max_abs_err(pairs) -> int:
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               for a, b in pairs)


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a kernel's work
# ---------------------------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
# 32-bit integer operations: 64 INT32 lanes an SM (half the 128 float32
# lanes behind the data sheet's 67 TFLOP/s, which counts an FMA as two),
# 132 SMs at the 1.98 GHz boost clock
INT_OPS_PER_S = 132 * 64 * 1.98e9
LOOKUP_OPS = 40                 # a lookup: two fmix32, masks, 24 compares
ROW_LO_BYTES = 96               # a table row's 24 lo keys
HIT_BYTES = 8                   # a hit's hi key and payload words
LIBRARY_NOTE = ("none: no single PyTorch call computes a hash-table probe "
                "or a codon-scan pack")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float, ms: float) -> dict:
    """``bound_ms``, the larger of bytes over the memory rate and
    operations over the integer rate, with what bounds it and its share of
    the measured ``ms``; ``library_ms`` is null (``LIBRARY_NOTE``)."""
    bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * n_ops / INT_OPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    return dict(bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_share=bound_ms / ms, bound_bytes=int(n_bytes),
                bound_ops=int(n_ops), library_ms=None, library=LIBRARY_NOTE)


def table_reads(table, lo, hi, valid, salt, max_probes) -> tuple[int, int,
                                                                  int]:
    """What this run's lookups need from a wide table: (distinct rows whose
    lo keys they read, row reads, hits).  A key walks from its home row
    until its row is found or ``max_probes`` rows are read."""
    from kmers_anno_tpu_torch.ops.hashing import mix_kmer_salted
    from kmers_anno_tpu_torch.ops.widetable import SLOTS

    mask = table.shape[0] - 1
    seen = torch.zeros(table.shape[0], dtype=torch.bool, device=table.device)
    reads = hits = 0
    lo, hi, valid = lo.reshape(-1), hi.reshape(-1), valid.reshape(-1)
    for s in range(0, lo.numel(), 1 << 20):
        v = valid[s: s + (1 << 20)]
        qlo, qhi = lo[s: s + (1 << 20)][v], hi[s: s + (1 << 20)][v]
        row = mix_kmer_salted(qlo, qhi, salt) & mask
        for _ in range(max_probes):
            if not row.numel():
                break
            seen[row] = True
            reads += row.numel()
            rows = table[row]
            hit = ((rows[:, :SLOTS] == qlo[:, None])
                   & (rows[:, SLOTS: 2 * SLOTS] == qhi[:, None])).any(1)
            hits += int(hit.sum())
            qlo, qhi, row = qlo[~hit], qhi[~hit], (row[~hit] + 1) & mask
    return int(seen.sum()), reads, hits


def probe_bound(table, lo, hi, valid, salt, max_probes, ms) -> dict:
    """probe_wide's bound: each query's keys and flag read once and its
    payload written once; the lo-key block of every row the lookups read,
    and a hit's hi and payload words."""
    rows, reads, hits = table_reads(table, lo, hi, valid, salt, max_probes)
    n_bytes = (nbytes(lo, hi, valid) + 4 * lo.numel() + ROW_LO_BYTES * rows
               + HIT_BYTES * hits)
    return bound(n_bytes, LOOKUP_OPS * reads, ms)


def apply_bound(table, salt, batches, valid, k, max_probes, ms) -> dict:
    """apply_rows's bound for one launch, the mean over ``batches`` (one
    launch each, timed together as ``ms`` a launch): codes and mask read
    once, role and count written once, and the table as for the probe;
    operations: each valid window's pack (2 per residue) and lookups."""
    from kmers_anno_tpu_torch.ops.kmers import pack_kmer_windows

    n_bytes = n_ops = 0
    for codes in batches:
        lo, hi = pack_kmer_windows(codes, k)
        rows, reads, hits = table_reads(table, lo, hi, valid, salt,
                                        max_probes)
        n_bytes += (nbytes(codes, valid) + 8 * codes.shape[0]
                    + ROW_LO_BYTES * rows + HIT_BYTES * hits)
        n_ops += 2 * k * int(valid.sum()) + LOOKUP_OPS * reads
    return dict(bound(n_bytes / len(batches), n_ops / len(batches), ms),
                windows=int(valid.sum()))


def scan_bound(streams, outputs, k, ms) -> dict:
    """contig_scan's bound: each base read once, its (lo, hi, bad) written
    once; operations: k codon lookups and packs (4 each) per base."""
    n_bytes = sum(nbytes(s) for s in streams) + sum(
        nbytes(*out) for out in outputs)
    return bound(n_bytes, 4 * k * sum(s.numel() for s in streams), ms)


# ---------------------------------------------------------------------------
# the kernels through their C entry points: back-to-back times, and another
# build of the kernels timed in turns with this one
# ---------------------------------------------------------------------------

def launch_scan(lib, stream, k, lut, outs):
    """contig_scan through a kernel library's C entry point into the
    outputs ``outs`` = (lo, hi, bad) it is given (uncounted)."""
    lo, hi, bad = outs
    err = lib.kan_contig_scan(
        stream.data_ptr(), stream.numel(), lut.tobytes(), k, lo.data_ptr(),
        hi.data_ptr(), bad.data_ptr(), torch.cuda.current_stream().cuda_stream)
    require(err == 0, f"kan_contig_scan returned CUDA error {err}")
    return outs


def scan_outputs(stream):
    """Empty (lo, hi, bad) for ``launch_scan`` on ``stream``."""
    lo = torch.empty(stream.numel(), dtype=torch.int32, device=stream.device)
    return lo, torch.empty_like(lo), torch.empty(
        stream.numel(), dtype=torch.uint8, device=stream.device)


def launch_ms(launch, arg_sets, lib=None, reps: int = LAUNCH_REPS) -> float:
    """Milliseconds of one pass of ``launch(lib, *args)`` over ``arg_sets``:
    after a warm-up pass, ``reps`` passes back to back between one pair of
    CUDA events, the mean a pass.  A spin kernel holds the stream while the
    host enqueues the passes, so that the launches run with no host gaps
    between them; the spin is lengthened until it outlasts the enqueue.
    ``lib`` defaults to this tree's build."""
    from kmers_anno_tpu_torch import kernels

    lib = lib or kernels.lib()

    def run():
        return [launch(lib, *a) for a in arg_sets]

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    spin_s = 2 * reps * (time.perf_counter() - t0) + 1e-3
    for _ in range(4):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        start.record()
        for _ in range(reps):
            run()
        stop.record()
        held = not start.query()           # still spinning: no host gaps
        stop.synchronize()
        if held:
            return start.elapsed_time(stop) / reps
        spin_s *= 4
    raise RuntimeError("chip_smoke: the spin never outlasted the enqueue")


def with_launch(row: dict, ms: float) -> dict:
    """``row`` with ``launch_ms`` and its ``launch_share`` of the bound."""
    return dict(row, launch_ms=ms, launch_share=row["bound_ms"] / ms)


def launch_probe(lib, table, lo, hi, valid, salt, max_probes):
    """probe_wide through a kernel library's C entry point (uncounted)."""
    out = torch.empty(lo.shape, dtype=torch.int32, device=lo.device)
    err = lib.kan_probe_wide(
        table.data_ptr(), table.shape[0], lo.data_ptr(), hi.data_ptr(),
        valid.data_ptr(), lo.numel(), int(salt) & 0xFFFFFFFF, max_probes,
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    require(err == 0, f"kan_probe_wide returned CUDA error {err}")
    return out


def launch_apply(lib, table, salt, codes, valid, min_hits, k, max_probes):
    """apply_rows through a kernel library's C entry point (uncounted)."""
    from kmers_anno_tpu_torch.ops.encode import PROT_PAD

    n = codes.shape[0]
    role = torch.empty(n, dtype=torch.int32, device=codes.device)
    count = torch.empty(n, dtype=torch.int32, device=codes.device)
    err = lib.kan_apply_rows(
        table.data_ptr(), table.shape[0], codes.data_ptr(), valid.data_ptr(),
        n, codes.shape[1], k, PROT_PAD, int(salt) & 0xFFFFFFFF, max_probes,
        int(min_hits), role.data_ptr(), count.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    require(err == 0, f"kan_apply_rows returned CUDA error {err}")
    return role, count


def launch_hash_commons(lib, table, max_probes, owner_mat, lo, hi, proto,
                        valid, n_rows, n_pad, out):
    """hash_commons through a kernel library's C entry point, adding into
    ``out`` (uncounted; repeated launches keep adding, which changes no
    work)."""
    err = lib.kan_hash_commons(
        table.data_ptr(), table.shape[0], max_probes, owner_mat.data_ptr(),
        owner_mat.shape[1], lo.data_ptr(), hi.data_ptr(), proto.data_ptr(),
        valid.data_ptr(), lo.numel(), n_rows, n_pad, out.data_ptr(), None,
        torch.cuda.current_stream().cuda_stream)
    require(err == 0, f"kan_hash_commons returned CUDA error {err}")
    return out


def launch_hash_best(lib, common, n_rows, n1, n2, minc, state, base):
    """hash_best through a kernel library's C entry point (uncounted).  It
    clears the counts it reads, so a pass after the first reads a zero
    matrix: the same bytes, without the clearing writes and the floor
    tests of the non-zero cells, and the state no longer improves."""
    sc, su, si, sm = state
    err = lib.kan_hash_best(
        common.data_ptr(), n_rows, common.shape[1], n1.data_ptr(),
        n2.data_ptr(), minc.data_ptr(), minc.shape[0], sc.data_ptr(),
        su.data_ptr(), si.data_ptr(), sm.data_ptr(), base,
        torch.cuda.current_stream().cuda_stream)
    require(err == 0, f"kan_hash_best returned CUDA error {err}")
    return state


launch_scan.entry = "kan_contig_scan"
launch_probe.entry = "kan_probe_wide"
launch_apply.entry = "kan_apply_rows"
launch_hash_commons.entry = "kan_hash_commons"
# the pass whose outputs ``--compare`` checks adds into a zeroed buffer
launch_hash_commons.reset = lambda *args: args[-1].zero_()
launch_hash_best.entry = "kan_hash_best"


def build_contenders(others: list[str], tmp: str) -> dict:
    """Kernel libraries to time in turns: this tree's build ("this") and
    the build of each tree rooted at one of ``others`` (named by its
    directory)."""
    from kmers_anno_tpu_torch import kernels

    libs = {"this": kernels.lib()}
    for i, other in enumerate(others):
        name = os.path.basename(os.path.normpath(other)) or f"other{i}"
        name = name if name not in libs else f"{name}{i}"
        path = os.path.join(tmp, str(i), "libkan_cuda.so")
        out = kernels.build(
            os.path.join(other, "kmers_anno_tpu_torch", "csrc"), path)
        for line in out.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  ptxas ({name}):", line.strip(), flush=True)
        libs[name] = kernels.load(path)
        declare_earlier_entries(libs[name])
    return libs


def compare_contenders(libs: dict, cases: dict) -> dict:
    """Each case's kernel under every library, in turns (A B C C B A); a
    turn is ``launch_ms`` (``LAUNCH_REPS`` passes back to back), and its
    outputs must equal this build's (after the launch's ``reset`` of its
    arguments, where it has one); a launch's ``reps`` sets the passes a
    turn where it has one.  A case given a third element, its
    bound in ms, also prints each library's share of it.  Returns {case:
    {library: mean of its two turns' ms per launch}}."""
    def flat(outs):
        return [t for o in outs for t in (o if isinstance(o, tuple)
                                          else (o,))]

    out = {}
    for case, (launch, arg_sets, *bound_ms) in cases.items():
        # a build of an older tree may lack this kernel: it sits out
        entries = (launch.entry if isinstance(launch.entry, tuple)
                   else (launch.entry,))
        names = [n for n in libs
                 if any(hasattr(libs[n], e) for e in entries)]
        order = names + names[::-1]

        def run(lib):
            for a in arg_sets:
                getattr(launch, "reset", lambda *_: None)(*a)
            outs = [launch(lib, *a) for a in arg_sets]
            view = getattr(launch, "view", None)
            return ([view(lib, o, *a) for o, a in zip(outs, arg_sets)]
                    if view else outs)
        # a copy: a launch may write into outputs it is given
        want = [t.clone() for t in flat(run(libs["this"]))]
        times = {n: [] for n in names}
        for n in order:
            ms = launch_ms(launch, arg_sets, libs[n],
                           reps=getattr(launch, "reps", LAUNCH_REPS))
            got = flat(run(libs[n]))
            require(all(torch.equal(g, w) for g, w in zip(got, want)),
                    f"{n} differs from this build on {case}")
            times[n].append(ms / len(arg_sets))
        out[case] = {n: statistics.mean(t) for n, t in times.items()}
        print(f"kernel builds on {case} (ms per launch, turns "
              f"{' '.join(order)}): " + ", ".join(
                  f"{n} {statistics.mean(t):.4f} ({', '.join(f'{x:.4f}' for x in t)})"
                  for n, t in times.items()), flush=True)
        if bound_ms:
            print(f"  against the bound {bound_ms[0]:.4f} ms: " + ", ".join(
                f"{n} share {bound_ms[0] / ms:.3f}"
                for n, ms in out[case].items()), flush=True)
    return out


def card_line() -> str:
    got = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return got.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel A: contig scanner
# ---------------------------------------------------------------------------

def check_contig_scan(dev) -> None:
    from kmers_anno_tpu_torch.ops.contig_scan import (scan_stream,
                                                      scan_stream_plain)
    from kmers_anno_tpu_torch.ops.translate import codon_lut

    rng = np.random.default_rng(SEED)
    codes = rng.integers(0, 4, STREAM_BASES).astype(np.uint8)
    codes[rng.random(STREAM_BASES) < 0.01] = 4           # ~1% ambiguous
    stream = torch.from_numpy(codes).to(dev)
    lut = codon_lut(11)
    for k in (8, 12):
        ms, got = timed(lambda: scan_stream(stream, k, lut))
        plain_ms, want = timed(lambda: scan_stream_plain(stream, k, lut))
        n_out = STREAM_BASES - 3 * k + 1
        require(all(torch.equal(g[:n_out], w[:n_out])
                    for g, w in zip(got, want)),
                f"contig_scan k={k} differs from its plain version")
        err = max_abs_err(zip(got, want))
        print(f"contig_scan k={k}: {STREAM_BASES} bases, exact over "
              f"[0, {n_out}), max_abs_err {err}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms", flush=True)
    # a slice that starts off a 16-byte boundary, with an odd length
    offset, n = 7, STREAM_BASES - 9
    sliced = stream[offset: offset + n]
    got = scan_stream(sliced, K, lut)
    want = scan_stream_plain(sliced, K, lut)
    require(sliced.data_ptr() % 16 == offset % 16
            and all(torch.equal(g, w) for g, w in zip(got, want)),
            "contig_scan differs from its plain version on a misaligned "
            "slice")
    print(f"contig_scan k={K}: {n} bases from byte {offset} of the stream "
          f"(misaligned, odd length), exact over all {n} outputs",
          flush=True)


# ---------------------------------------------------------------------------
# kernel B: wide-table probe
# ---------------------------------------------------------------------------

def check_probe_wide(dev) -> None:
    from kmers_anno_tpu_torch.engine.convert import wide_table_from_numpy
    from kmers_anno_tpu_torch.ops.widetable import (build_wide_table,
                                                    probe_wide,
                                                    probe_wide_plain)

    rng = np.random.default_rng(SEED + 1)
    keys = np.unique(rng.integers(0, 1 << 60, 2 * TABLE_KEYS,
                                  dtype=np.int64))
    rng.shuffle(keys)
    table_keys, miss_keys = keys[:TABLE_KEYS], keys[TABLE_KEYS:]
    mask30 = (1 << 30) - 1
    t0 = time.perf_counter()
    table, salt, max_probes = build_wide_table(
        table_keys & mask30, table_keys >> 30,
        np.arange(TABLE_KEYS, dtype=np.uint32))
    build_s = time.perf_counter() - t0
    half = N_QUERIES // 2
    q = np.concatenate([rng.choice(table_keys, half),
                        rng.choice(miss_keys, N_QUERIES - half)])
    rng.shuffle(q)
    valid = rng.random(N_QUERIES) >= 0.08
    d_table = wide_table_from_numpy(table, dev)
    d_lo = torch.from_numpy((q & mask30).astype(np.int32)).to(dev)
    d_hi = torch.from_numpy((q >> 30).astype(np.int32)).to(dev)
    d_valid = torch.from_numpy(valid).to(dev)
    args = (d_table, d_lo, d_hi, d_valid, salt, max_probes)
    ms, got = timed(lambda: probe_wide(*args))
    plain_ms, want = timed(lambda: probe_wide_plain(*args))
    require(torch.equal(got, want), "probe_wide differs from its plain "
            "version")
    n_hit = int((got >= 0).sum())
    require(0 < n_hit < int(valid.sum()), "probe_wide hit count")
    err = max_abs_err([(got, want)])
    print(f"probe_wide: {TABLE_KEYS} keys in {table.shape[0]} rows "
          f"(host build {build_s:.2f} s, max_probes {max_probes}), "
          f"{N_QUERIES} queries, {n_hit} hits, exact, max_abs_err {err}, "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)


# ---------------------------------------------------------------------------
# the main path: kmers on the realistic projection workload
# ---------------------------------------------------------------------------

def make_projection_workload(rng, n_genes, n_close, lo_cod=60, hi_cod=500,
                             planted=None):
    """Synthetic genome with planted clean ORFs + close genomes carrying
    the source proteins (the generator of bench.py's projection bench).
    ``planted``, a list if given, receives each gene's (strand, left,
    right) on the new genome's contig."""
    from kmers_anno_tpu_torch.genome.dna import (DnaTranslator,
                                                 reverse_complement)
    from kmers_anno_tpu_torch.genome.gto import Genome

    xl = DnaTranslator(11)
    parts = ["".join("acgt"[c] for c in rng.integers(0, 4, 50))]
    n_bases = len(parts[0])
    genes = []
    for i in range(n_genes):
        n_cod = int(rng.integers(lo_cod, hi_cod))
        body = "".join("tcag"[c] for c in rng.integers(0, 4, 3 * n_cod))
        # force a clean ORF: atg + stop-free frame + taa
        codons = [body[j: j + 3] for j in range(0, len(body), 3)]
        codons = [c for c in codons if c not in ("taa", "tag", "tga")]
        gene = "atg" + "".join(codons) + "taa"
        strand = "+" if i % 2 == 0 else "-"
        if planted is not None:
            planted.append((strand, n_bases + 1, n_bases + len(gene)))
        parts.append(gene if strand == "+" else reverse_complement(gene))
        parts.append("".join("acgt"[c] for c in rng.integers(0, 4, 30)))
        n_bases += len(gene) + 30
        genes.append(gene)
    dna = "".join(parts)

    prots = [xl.peg_translate(g, 1, len(g) - 3) for g in genes]

    def old_genome(gid):
        feats = []
        for i, gene in enumerate(genes):
            feats.append({
                "id": f"fig|{gid}.peg.{i + 1}", "type": "CDS",
                "function": f"Projected role number {i + 1}",
                "location": [["oc", str(1000 * i + 1), "+", len(gene)]],
                "protein_translation": prots[i],
                "annotations": [], "aliases": []})
        return Genome({
            "id": gid, "scientific_name": "Oldus", "genetic_code": 11,
            "domain": "Bacteria", "features": feats,
            "contigs": [{"id": "oc", "dna": "acgt" * 50}],
            "close_genomes": [], "subsystems": []})

    olds = {f"30{i}.1": old_genome(f"30{i}.1") for i in range(n_close)}
    new = Genome({
        "id": "400.1", "scientific_name": "Novus",
        "genetic_code": 11, "domain": "Bacteria", "features": [],
        "contigs": [{"id": "nc", "dna": dna, "genetic_code": 11}],
        "close_genomes": [
            {"genome": gid, "genome_name": "Oldus",
             "closeness_measure": 99.0} for gid in olds],
        "subsystems": []})
    return dna, olds, new


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def port_counts(messages: list[str]) -> list[tuple[int, int, int]]:
    """Per close genome (matching kmers, peg/frame pairs, proposals made)
    from the engine's own log lines."""
    out = []
    for msg in messages:
        words = msg.split()
        if msg.endswith("matching kmers found."):
            out.append([int(words[0]), 0, 0])
        elif "peg/frame pairs examined" in msg:
            out[-1][1] = int(words[0])
            out[-1][2] = int(words[-4])
    return [tuple(c) for c in out]


class _Launches:
    """Every kernel wrapper's launch count, and which projection route
    ran, over one ``with`` block: the counts are set to 0 on entry and
    read on exit."""

    def __init__(self):
        from kmers_anno_tpu_torch.engine import projection
        from kmers_anno_tpu_torch.ops.apply_flat import (apply_flat,
                                                         apply_weighted_flat)
        from kmers_anno_tpu_torch.ops.apply_rows import apply_rows
        from kmers_anno_tpu_torch.ops.contig_scan import scan_stream
        from kmers_anno_tpu_torch.ops.dna_probe import probe_dna
        from kmers_anno_tpu_torch.ops.hash_chunk import (hash_best,
                                                         hash_commons)
        from kmers_anno_tpu_torch.ops.probe_keys import probe_keys
        from kmers_anno_tpu_torch.ops.table_build import (build_bucketed,
                                                          build_wide)
        from kmers_anno_tpu_torch.ops.widetable import probe_wide

        self.wrappers = {"contig_scan": scan_stream,
                         "probe_wide": probe_wide,
                         "apply_rows": apply_rows,
                         "hash_commons": hash_commons,
                         "hash_best": hash_best,
                         "apply_flat": apply_flat,
                         "apply_flat_weighted": apply_weighted_flat,
                         "dna_probe": probe_dna,
                         "probe_keys": probe_keys,
                         "table_build_wide": build_wide,
                         "table_build_bucketed": build_bucketed}
        self.projection = projection
        self.counts: dict = {}
        self.fused_calls = 0

    def __enter__(self):
        for w in self.wrappers.values():
            w.launches = 0
        self.lines = _Lines()
        logging.getLogger(self.projection.__name__).addHandler(self.lines)
        self._orig = self.projection._scan_genomes

        def spy(*a, **kw):
            self.fused_calls += 1
            return self._orig(*a, **kw)

        self.fused_calls = 0
        self.projection._scan_genomes = spy
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.projection._scan_genomes = self._orig
        logging.getLogger(self.projection.__name__).removeHandler(self.lines)
        self.counts = {n: w.launches for n, w in self.wrappers.items()}
        return False


def features_of(genome) -> list:
    return [(f.id, f.function, f.location.contig_id, f.location.strand,
             f.location.left, f.location.right, f.protein_translation)
            for f in genome.features]


def warm_runs(annot, new_path, olds, n_runs: int) -> tuple[list, dict]:
    """Host-clock seconds of ``n_runs`` warm annotate_genome calls, each
    ending in a synchronise; returns the times and the last stats."""
    from kmers_anno_tpu_torch.genome.gto import Genome

    times = []
    for _ in range(n_runs):
        genome = Genome.load(new_path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = annot.annotate_genome(genome, olds.get)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, stats


def summary(times: list) -> str:
    return (f"{statistics.median(times):.4f} s/genome (median of "
            f"{len(times)}, range {min(times):.4f}-{max(times):.4f}: "
            f"{', '.join(f'{t:.4f}' for t in times)})")


def check_strand_scan(dev, genome) -> tuple[dict, list]:
    """The per-strand route's scanner against its plain version on the
    genome's two strands, as ``extract_contig_kmers`` feeds it.  Returns
    the row and the two strands' ``launch_scan`` arguments."""
    from kmers_anno_tpu_torch.ops.encode import encode_dna
    from kmers_anno_tpu_torch.ops.contig_scan import (scan_stream,
                                                      scan_stream_plain)
    from kmers_anno_tpu_torch.ops.translate import codon_lut

    lut = codon_lut(genome.genetic_code)
    codes = encode_dna(genome.contigs[0].sequence)
    rc = np.where(codes < 4, codes ^ 2, codes)[::-1].copy()
    ms, plain_ms, errs, streams, outs = [], [], [], [], []
    for seq in (codes, rc):
        stream = torch.from_numpy(seq).to(dev)
        t_k, got = timed(lambda: scan_stream(stream, K, lut))
        t_p, want = timed(lambda: scan_stream_plain(stream, K, lut))
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                "contig_scan differs from its plain version on a strand")
        ms.append(t_k)
        plain_ms.append(t_p)
        errs.append(max_abs_err(zip(got, want)))
        streams.append(stream)
        outs.append(got)
    args = [(s, K, lut, scan_outputs(s)) for s in streams]
    out = with_launch(dict(ms=sum(ms), plain_ms=sum(plain_ms),
                           max_abs_err=max(errs),
                           **scan_bound(streams, outs, K, sum(ms))),
                      launch_ms(launch_scan, args))
    require(all(torch.equal(g, w) for a, want in zip(args, outs)
                for g, w in zip(a[3], want)),
            "launch_scan's outputs differ from the wrapper's on a strand")
    print(f"main path contig_scan per strand k={K}: {len(codes)} bases x 2 "
          f"strands, exact, max_abs_err {out['max_abs_err']}, kernel "
          f"{ms[0]:.4f} + {ms[1]:.4f} ms through the wrapper, "
          f"{out['launch_ms']:.4f} ms for both back to back, plain "
          f"{plain_ms[0]:.4f} + {plain_ms[1]:.4f} ms; bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']}, "
          f"{out['bound_bytes']} bytes), share {out['bound_share']:.3f}, "
          f"back to back {out['launch_share']:.3f}", flush=True)
    return out, args


def check_kernels_on_main_path(dev, genome, fused, rle) -> dict:
    """Each kernel against its plain version on the inputs the main path
    gives it: the contig scanner on the genome's padded window stream and
    on its two strands; the probe on that stream against the union table
    and every RLE close-genome table, and on the compacted union hits
    against every fused close-genome table.  Exact equality over every
    output; CUDA-event times."""
    from kmers_anno_tpu_torch.engine.projection import (StreamWindowIndex,
                                                        _union_compact)
    from kmers_anno_tpu_torch.ops.encode import encode_dna
    from kmers_anno_tpu_torch.ops.contig_scan import (scan_stream,
                                                      scan_stream_plain)
    from kmers_anno_tpu_torch.ops.translate import codon_lut
    from kmers_anno_tpu_torch.ops.widetable import (probe_wide,
                                                    probe_wide_plain)

    codes, _ = StreamWindowIndex.window_stream(
        [encode_dna(c.sequence) for c in genome.contigs], K)
    stream = torch.from_numpy(codes).to(dev)
    lut = codon_lut(genome.genetic_code)
    ms, got = timed(lambda: scan_stream(stream, K, lut))
    plain_ms, want = timed(lambda: scan_stream_plain(stream, K, lut))
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            "contig_scan differs from its plain version on the main path")
    index = StreamWindowIndex.build(genome, K, False, dev)
    require(torch.equal(index.d_lo, got[0]) and torch.equal(index.d_hi,
                                                            got[1]),
            "the index's window keys are not the kernel's")
    scan_args = [(stream, K, lut, scan_outputs(stream))]
    scan = with_launch(dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_abs_err(
        zip(got, want)), **scan_bound([stream], [got], K, ms)),
        launch_ms(launch_scan, scan_args))
    require(all(torch.equal(g, w) for g, w in zip(scan_args[0][3], want)),
            "launch_scan's outputs differ from the plain version's")
    print(f"main path contig_scan k={K}: {stream.numel()} bases "
          f"({len(genome.contigs)} contig, both strands, padded), exact, "
          f"max_abs_err {scan['max_abs_err']}, kernel {ms:.4f} ms through "
          f"the wrapper, {scan['launch_ms']:.4f} ms a launch back to back, "
          f"plain {plain_ms:.4f} ms; bound {scan['bound_ms']:.4f} ms "
          f"({scan['bound_by']}, {scan['bound_bytes']} bytes), share "
          f"{scan['bound_share']:.3f}, back to back "
          f"{scan['launch_share']:.3f}", flush=True)

    def probe_check(what, table, lo, hi, valid, salt, max_probes):
        args = (table, lo, hi, valid, salt, max_probes)
        t_k, got = timed(lambda: probe_wide(*args))
        t_p, want = timed(lambda: probe_wide_plain(*args))
        require(torch.equal(got, want),
                f"probe_wide differs from its plain version on {what}")
        return (t_k, t_p, max_abs_err([(got, want)]), int((got >= 0).sum()),
                probe_bound(*args, t_k))

    require(len(fused._closeset_cache) == 1, "no fused close set")
    cs = next(iter(fused._closeset_cache.values()))
    stream_args = (index.d_lo, index.d_hi, index.d_valid)
    union = probe_check("the union table", cs.union_table, *stream_args,
                        cs.union_salt, cs.union_mp)
    u_ms, u_plain, u_err, n_union = union[:4]
    lo_c, hi_c = _union_compact(cs.union_table, cs.union_salt, cs.union_mp,
                                index)[:2]
    ones = torch.ones_like(lo_c, dtype=torch.bool)
    close = [probe_check("a fused close-genome table", t, lo_c, hi_c, ones,
                         salt, mp)
             for t, salt, mp in zip(cs.tables, cs.salts, cs.mps)]
    rle_tables = [e for e in rle._table_cache.values() if e[0] is not None]
    require(len(close) == len(rle_tables) == N_CLOSE,
            "a close genome's table is missing")
    per = [probe_check("an RLE close-genome table", t, *stream_args, salt,
                       mp) for t, mp, salt, _, _ in rle_tables]
    errs = [u_err] + [c[2] for c in close + per]
    u_bound = with_launch(union[4], launch_ms(launch_probe, [(
        cs.union_table, *stream_args, cs.union_salt, cs.union_mp)]))
    probe = dict(ms=u_ms, plain_ms=u_plain, max_abs_err=max(errs),
                 close_ms=statistics.median(c[0] for c in close),
                 close_plain_ms=statistics.median(c[1] for c in close),
                 close_bound_ms=statistics.median(
                     c[4]["bound_ms"] for c in close),
                 rle_ms=statistics.median(c[0] for c in per),
                 rle_plain_ms=statistics.median(c[1] for c in per),
                 rle_bound_ms=statistics.median(
                     c[4]["bound_ms"] for c in per), **u_bound)
    print(f"main path probe_wide, union table ({cs.n_union_keys} keys, "
          f"{cs.union_table.shape[0]} rows) x {index.d_lo.numel()} "
          f"windows: {n_union} hits, exact, kernel {u_ms:.4f} ms, "
          f"{u_bound['launch_ms']:.4f} ms a launch back to back, plain "
          f"{u_plain:.4f} ms; bound {u_bound['bound_ms']:.4f} ms "
          f"({u_bound['bound_by']}, {u_bound['bound_bytes']} bytes), share "
          f"{u_bound['bound_share']:.3f}, back to back "
          f"{u_bound['launch_share']:.3f}", flush=True)
    print(f"main path probe_wide, {N_CLOSE} fused close tables x "
          f"{lo_c.numel()} union hits: {sum(c[3] for c in close)} hits in "
          f"all, exact; kernel ms {', '.join(f'{c[0]:.4f}' for c in close)}"
          f" (median {probe['close_ms']:.4f}); plain median "
          f"{probe['close_plain_ms']:.4f}; bound median "
          f"{probe['close_bound_ms']:.4f} ms", flush=True)
    print(f"RLE route probe_wide, {N_CLOSE} close tables x "
          f"{index.d_lo.numel()} windows: {sum(c[3] for c in per)} hits in "
          f"all, exact; kernel ms {', '.join(f'{c[0]:.4f}' for c in per)} "
          f"(median {probe['rle_ms']:.4f}); plain median "
          f"{probe['rle_plain_ms']:.4f}; bound median "
          f"{probe['rle_bound_ms']:.4f} ms; max_abs_err over every probe "
          f"{probe['max_abs_err']}", flush=True)
    strand, strand_args = check_strand_scan(dev, genome)
    cases = {
        "the padded window stream": (launch_scan, scan_args),
        "the two strands": (launch_scan, strand_args),
        "the union table": (launch_probe, [(cs.union_table, *stream_args,
                                            cs.union_salt, cs.union_mp)]),
        "the fused close tables": (launch_probe, [
            (t, lo_c, hi_c, ones, salt, mp)
            for t, salt, mp in zip(cs.tables, cs.salts, cs.mps)])}
    return {"contig_scan": scan, "probe_wide": probe,
            "contig_scan_strand": strand}, cases


def print_spans(what: str, fn) -> None:
    """Run ``fn`` with the port's tracer on and print the spans it
    recorded as a tree: each span's host milliseconds and attributes."""
    from kmers_anno_tpu_torch.utils import spans

    spans.clear()
    spans.enable()
    try:
        fn()
    finally:
        spans.disable()
    depth = {}
    print(f"spans of {what} (host ms, attributes):", flush=True)
    for r in sorted(spans.records(), key=lambda r: r.start):
        depth[r.id] = depth.get(r.parent, -1) + 1
        attrs = " ".join(f"{k}={v}" for k, v in r.attrs.items())
        print(f"  {'  ' * depth[r.id]}{r.name} "
              f"{1e3 * (r.end - r.start):.3f} {attrs}", flush=True)
    spans.clear()


def busy_seconds(spans: list) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile_fused(annot, new_path, olds, s_per_genome) -> None:
    """Device busy share and top device entries over warm fused genomes,
    measured within one traced run; then a host cProfile of one more."""
    import cProfile
    import pstats
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kmers_anno_tpu_torch.genome.gto import Genome

    genomes = [Genome.load(new_path) for _ in range(PROFILED_GENOMES)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for genome in genomes:
            annot.annotate_genome(genome, olds.get)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    require(device, "the profiler saw no device activity")
    busy = busy_seconds([(e.time_range.start, e.time_range.end)
                         for e in device]) / 1e6
    by_name = defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    summed = sum(v[0] for v in by_name.values())
    print(f"profile: {PROFILED_GENOMES} warm fused genomes traced (device "
          f"activity only) in {wall:.4f} s ({wall / PROFILED_GENOMES:.4f} "
          f"s/genome; untraced median {s_per_genome:.4f}); device busy "
          f"{busy:.4f} s (union of {len(device)} kernel and copy "
          f"intervals), busy share {busy / wall:.4f}; summed device time "
          f"{summed:.3f} ms", flush=True)
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:12]:
        print(f"  device {ms:9.3f} ms {100 * ms / summed:5.1f}% "
              f"{n:5d} x {name[:90]}", flush=True)
    genome = Genome.load(new_path)
    host = cProfile.Profile()
    host.enable()
    annot.annotate_genome(genome, olds.get)
    torch.cuda.synchronize()
    host.disable()
    stats = pstats.Stats(host)
    print(f"profile: cProfile of one warm fused genome, "
          f"{stats.total_tt:.4f} s in all; top by own time:", flush=True)
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:12]
    for (path, line, func), (_, ncalls, tottime, cumtime, _) in rows:
        print(f"  host own {tottime:.4f} s, cum {cumtime:.4f} s, {ncalls:6d}"
              f" x {os.path.basename(path)}:{line}({func})", flush=True)


def run_main_path(dev, tmp: str, profile: bool,
                  keep: dict) -> tuple[dict, dict]:
    from kmers_anno_tpu_torch.commands.app import main
    from kmers_anno_tpu_torch.engine.projection import (ProjectionAnnotator,
                                                        host_fallback)
    from kmers_anno_tpu_torch import native
    from kmers_anno_tpu_torch.genome.gto import Genome
    from kmers_anno_tpu_torch.ops.encode import encode_dna
    from kmers_anno_tpu_torch.ops.translate import codon_lut

    t0 = time.perf_counter()
    planted: list = []
    dna, olds, new = make_projection_workload(
        np.random.default_rng(SEED), N_GENES, N_CLOSE, planted=planted)
    cache = os.path.join(tmp, "cache")
    os.makedirs(cache)
    for gid, og in olds.items():
        og.save(os.path.join(cache, f"{gid}.gto"))
    new_path = os.path.join(tmp, "new.gto")
    out_path = os.path.join(tmp, "out.gto")
    new.save(new_path)
    # the planted genes and their proteins, for the commands phase
    write_planted(tmp, planted, next(iter(olds.values())))
    print(f"workload: {len(dna)} bases, {N_GENES} planted genes, "
          f"{len(olds)} close genomes, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    base = native.ProjectionBaseline(
        [encode_dna(c.sequence) for c in new.contigs],
        np.asarray(codon_lut(11), np.uint8), K)
    want = [base.match([f.protein_translation for f in og.pegs
                        if f.protein_translation], 0.50, 1.5, 0.8)
            for og in olds.values()]
    base.close()

    def check_counts(route, launches):
        got = port_counts(launches.lines.messages)
        require(len(got) == N_CLOSE, f"{route}: {len(got)} close genomes "
                "probed")
        require(got == want, f"{route}: port counts {got} != baseline "
                f"{want}")
        print(f"independent check, {route} route: per close genome "
              f"(matching kmers, peg/frame pairs, proposals made) = "
              f"{got[0]} x {len(got)}, equal to ProjectionBaseline",
              flush=True)

    # -- route 1, the main path: kmers through the CLI, fused route --
    t0 = time.perf_counter()
    fallbacks = host_fallback.count
    with _Launches() as fused_run:
        rc = main(["kmers", "--cache", cache, "-i", new_path, "-o",
                   out_path, "--device", str(dev)])
    cold_s = time.perf_counter() - t0
    require(rc == 0, f"kmers exited with {rc}")
    require(fused_run.fused_calls == 1, "kmers did not take the fused route")
    require(fused_run.counts["contig_scan"] > 0
            and fused_run.counts["probe_wide"] > 0,
            f"a kernel of the path never launched: {fused_run.counts}")
    # every close genome's table built on the card, none on the host
    require(fused_run.counts["table_build_wide"] == N_CLOSE
            and host_fallback.count == fallbacks,
            f"kmers: {fused_run.counts['table_build_wide']} device table "
            f"builds, {host_fallback.count - fallbacks} host builds")
    want_feats = features_of(Genome.load(out_path))
    n_pegs = len(want_feats)
    require(n_pegs > 0, "out.gto holds no pegs")
    print(f"kmers, fused route (cold, tables built): rc {rc}, {n_pegs} "
          f"pegs, {cold_s:.2f} s, launches {fused_run.counts}", flush=True)
    check_counts("fused", fused_run)

    fused = ProjectionAnnotator(device=dev)
    fused.annotate_genome(Genome.load(new_path), olds.get)  # warm tables
    times, want_stats = warm_runs(fused, new_path, olds, WARM_RUNS)
    require(want_stats["pegs"] == n_pegs, "warm pegs differ from the CLI's")
    print(f"fused route, warm annotate_genome: {summary(times)}, stats "
          f"{want_stats}", flush=True)
    keep["projection"] = (new_path, olds, want_feats, want_stats)
    genome = Genome.load(new_path)
    print_spans("one warm fused genome", lambda: (
        fused.annotate_genome(genome, olds.get), torch.cuda.synchronize()))
    if profile:
        profile_fused(fused, new_path, olds, statistics.median(times))
    routes = {"fused": dict(launches=fused_run.counts, times=times)}

    # -- route 2, RLE, forced as the reference's tests force it --
    rle = ProjectionAnnotator(device=dev)
    rle._close_set = lambda olds_: None
    # -- route 3, the host contig index --
    host = ProjectionAnnotator(device=dev, engine="host")
    for name, annot in (("rle", rle), ("host", host)):
        genome = Genome.load(new_path)
        t0 = time.perf_counter()
        with _Launches() as run:
            stats = annot.annotate_genome(genome, olds.get)
        cold_s = time.perf_counter() - t0
        require(run.fused_calls == 0, f"{name} took the fused route")
        if name == "host":
            # no stream index: every scanner launch is a per-strand one
            require(run.counts["contig_scan"] == 2 * len(genome.contigs)
                    and run.counts["probe_wide"] == 0,
                    f"host: not one scanner launch per strand: "
                    f"{run.counts}")
        else:
            require(run.counts["contig_scan"] > 0
                    and run.counts["probe_wide"] > 0
                    and run.counts["table_build_wide"] == N_CLOSE,
                    f"{name}: a kernel of the route never launched: "
                    f"{run.counts}")
        require(stats == want_stats, f"{name} stats {stats} != fused "
                f"{want_stats}")
        require(features_of(genome) == want_feats,
                f"{name} features differ from the fused route's")
        print(f"{name} route (cold, tables built): {cold_s:.2f} s, stats "
              f"and {n_pegs} features equal to the fused route's, launches "
              f"{run.counts}", flush=True)
        check_counts(name, run)
        if name == "host":
            # the host route builds its contig index and close tables on
            # every call (~8 s), so its cold run is its only run
            times = [cold_s]
        else:
            times, stats = warm_runs(annot, new_path, olds, RLE_WARM_RUNS)
            require(stats == want_stats, f"{name} warm stats differ")
            print(f"{name} route, warm annotate_genome: {summary(times)}",
                  flush=True)
        routes[name] = dict(launches=run.counts, times=times)
    return routes, check_kernels_on_main_path(dev, Genome.load(new_path),
                                              fused, rle)


# ---------------------------------------------------------------------------
# the close-genome table builds (csrc/table_build.cu)
# ---------------------------------------------------------------------------

# forced placements: layout, rows, row -> keys homed there, random keys
# (none homed in those rows or beside them), the expected bad flag and,
# where given, where the EMPTY pads go ("end", the default, as the engine
# pads; "between" real keys; "none": no pads, an odd key count)
TABLE_BUILD_EDGES = {
    "wide_row_of_24": ("wide", 128, {5: 24}, 300, False),
    "wide_row_of_25": ("wide", 128, {5: 25}, 300, True),
    "wide_last_row_of_25": ("wide", 128, {127: 25}, 300, True),
    "bucket_walk_of_1": ("bucketed", 64, {3: 9}, 40, False),
    "bucket_walk_of_2": ("bucketed", 64, {3: 17}, 40, True),
    "bucket_wrap": ("bucketed", 64, {63: 9}, 40, True),
    # a row's keys past one warp of the kernel's row pass
    "wide_row_of_300": ("wide", 128, {5: 300}, 300, True),
    "bucket_row_of_300": ("bucketed", 64, {3: 300}, 40, True),
    "wide_all_in_one_row": ("wide", 64, {9: 100}, 0, True),
    "bucket_all_in_one_row": ("bucketed", 32, {0: 100}, 0, True),
    # each bucket's overflow walks one bucket on, through five buckets
    "bucket_chain": ("bucketed", 64, {10: 12, 11: 10, 12: 9, 13: 8}, 40,
                     False),
    "wide_pads_between": ("wide", 128, {5: 24}, 300, False, "between"),
    "bucket_pads_between": ("bucketed", 64, {3: 9}, 40, False, "between"),
    "wide_one_key": ("wide", 128, {}, 1, False),
    "bucket_one_key": ("bucketed", 64, {}, 1, False),
    "wide_odd_count": ("wide", 128, {5: 24}, 1000, False, "none"),
    "bucket_odd_count": ("bucketed", 512, {3: 9}, 1000, False, "none"),
}
KEY_BYTES = 12          # a key's lo, hi and payload words
# the sort-based build's bound also counted a sort's pass (a 4-byte home
# read, the sorted home and its int64 index written): printed beside
SORT_PASS_BYTES = 16
TABLE_LIBRARY_NOTE = "none: no single PyTorch call builds a hash table"
ROTATING_GENOMES = 4
POOL_EXTRA = 4          # the pool: the 10 close genomes and 4 copies


def random_keys(rng, n):
    """n distinct random packed keys (30-bit words), 20-bit payloads."""
    lo = rng.integers(0, 1 << 30, 2 * n + 16).astype(np.uint32)
    hi = rng.integers(0, 1 << 30, 2 * n + 16).astype(np.uint32)
    keys = rng.permutation(np.unique(hi.astype(np.uint64) << np.uint64(32)
                                     | lo))[:n]
    return ((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (keys >> np.uint64(32)).astype(np.uint32),
            rng.integers(0, 1 << 20, n).astype(np.uint32))


def homed_keys(rng, n, n_rows, salt, row):
    """n distinct keys whose home row at ``salt`` is ``row``."""
    from kmers_anno_tpu_torch.ops.hashing import mix_kmer_salted_np

    got = [np.zeros(0, np.uint32)] * 3
    while len(got[0]) < n:
        lo, hi, val = random_keys(rng, 50_000)
        at = (mix_kmer_salted_np(lo, hi, salt) & np.uint32(n_rows - 1)) == row
        got = [np.concatenate([g, a[at]]) for g, a in zip(got, (lo, hi, val))]
    return [g[:n] for g in got]


def padded_keys(parts, n_pad, rng):
    """Key sets joined, shuffled and padded to ``n_pad`` with EMPTY keys
    and 0 payloads, as the engine pads a singleton set: (lo, hi, val)
    uint32 arrays."""
    lo, hi, val = (np.concatenate(p) for p in zip(*parts))
    perm = rng.permutation(len(lo))
    out = []
    for words, fill in ((lo, 0xFFFFFFFF), (hi, 0xFFFFFFFF), (val, 0)):
        padded = np.full(n_pad, fill, np.uint32)
        padded[: len(words)] = words[perm]
        out.append(padded)
    return out


def edge_keys(name):
    """One ``TABLE_BUILD_EDGES`` case: (layout, the key parts (homed
    groups, then the random keys), padded (lo, hi, val) uint32 arrays,
    rows, salt, the expected bad flag)."""
    from kmers_anno_tpu_torch.ops.hashing import GOLDEN, mix_kmer_salted_np

    layout, n_rows, groups, n_random, want_bad, *pads = TABLE_BUILD_EDGES[
        name]
    pads = pads[0] if pads else "end"
    salt = 0 if layout == "wide" else GOLDEN
    rng = np.random.default_rng(len(name))
    parts = [homed_keys(rng, c, n_rows, salt, row)
             for row, c in groups.items()]
    lo, hi, val = random_keys(rng, n_random)
    far = ~np.isin(mix_kmer_salted_np(lo, hi, salt) & np.uint32(n_rows - 1),
                   [r + d for r in groups for d in (-1, 0, 1, 2)])
    parts.append((lo[far], hi[far], val[far]))
    n_real = sum(len(p[0]) for p in parts)
    n_pad = n_real if pads == "none" else 1 << (n_real + 7).bit_length()
    keys = padded_keys(parts, n_pad, rng)
    if pads == "between":
        perm = rng.permutation(n_pad)
        keys = [a[perm] for a in keys]
    return layout, parts, keys, n_rows, salt, want_bad


def int32_tensors(arrays, dev) -> list:
    """uint32 arrays as int32 tensors of the same bits on ``dev``."""
    return [torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(
        np.int32).copy()).to(dev) for a in arrays]


def table_build_of(layout: str):
    """A layout name's wrapper and ``Layout``."""
    from kmers_anno_tpu_torch.ops import table_build

    if layout == "wide":
        return table_build.build_wide, table_build.WIDE
    return table_build.build_bucketed, table_build.BUCKETED


def check_table_build(what, layout, keys, n_rows, salt, want_bad=None):
    """The kernel against its plain version on the card, table and bad
    bit for bit: (kernel ms, plain ms, max_abs_err, bad, table)."""
    from kmers_anno_tpu_torch.ops.table_build import build_table_plain

    wrapper, lay = table_build_of(layout)
    extra = (salt,) if layout == "wide" else ()
    t_k, (table, bad) = timed(lambda: wrapper(*keys, n_rows, *extra))
    t_p, (want, want_b) = timed(lambda: build_table_plain(*keys, n_rows, lay,
                                                          salt))
    require(torch.equal(table, want) and bool(bad) == bool(want_b),
            f"the {layout} table build differs from its plain version on "
            f"{what}")
    require(want_bad is None or bool(bad) == want_bad,
            f"the {layout} table build's bad flag is wrong on {what}")
    return t_k, t_p, max_abs_err([(table, want)]), bool(bad), table


def launch_table_build(lib, lo, hi, val, n_rows, lay, salt, scratch, table,
                       bad):
    """A whole table build through a kernel library (uncounted): this
    tree's ``kan_table_build`` into ``table`` and ``bad`` (a 0-dim bool);
    on a build without it (the sort-based build), that build's whole
    device work as its wrapper ran it: the table filled with EMPTY keys and
    0 payloads, ``kan_table_homes``, the stable ``torch.sort`` of the
    homes, ``kan_table_place``.  ``scratch`` holds either build's scratch.
    Returns (table, bad)."""
    stream = torch.cuda.current_stream().cuda_stream
    n = lo.numel()
    if hasattr(lib, "kan_table_build"):
        err = lib.kan_table_build(
            lo.data_ptr(), hi.data_ptr(), val.data_ptr(), n, n_rows,
            salt & 0xFFFFFFFF, lay.slots, lay.max_walk, int(lay.keep_walkers),
            scratch.data_ptr(), scratch.numel(), table.data_ptr(),
            bad.data_ptr(), stream)
        require(err == 0, f"kan_table_build returned CUDA error {err}")
        return table, bad
    table.fill_(-1)
    table[:, 2 * lay.slots:] = 0
    tiles = -(-n // 1024)                    # its place pass's tile
    tile_max = scratch[: 8 * tiles].view(torch.int64)
    flag = scratch[8 * tiles: 8 * tiles + 4].view(torch.int32)
    home = scratch[8 * tiles + 16: 8 * tiles + 16 + 4 * n].view(torch.int32)
    flag.zero_()
    err = lib.kan_table_homes(lo.data_ptr(), hi.data_ptr(), n, n_rows,
                              salt & 0xFFFFFFFF, home.data_ptr(), stream)
    require(err == 0, f"kan_table_homes returned CUDA error {err}")
    hb, order = torch.sort(home, stable=True)
    err = lib.kan_table_place(hb.data_ptr(), order.data_ptr(), lo.data_ptr(),
                              hi.data_ptr(), val.data_ptr(), n, n_rows,
                              lay.slots, lay.max_walk, int(lay.keep_walkers),
                              tile_max.data_ptr(), table.data_ptr(),
                              flag.data_ptr(), stream)
    require(err == 0, f"kan_table_place returned CUDA error {err}")
    return table, flag[0] != 0


launch_table_build.entry = ("kan_table_build", "kan_table_place")
# passes of ten builds a launch_ms: the sort-based build is some 12
# launches, and 20 passes would fill the card's queue of pending launches
# while the spin holds the stream
launch_table_build.reps = 4


def table_build_args(layout, keys, n_rows, salt) -> tuple:
    """``launch_table_build``'s arguments for one key set: its layout, the
    scratch and the outputs.  The scratch has room for the kernel's earlier
    designs too (a 16-byte bucket entry for each slot of a row's
    ``max_walk``, and 64 bytes a key), so that ``--compare`` can time
    them."""
    from kmers_anno_tpu_torch.ops.table_build import scratch_bytes

    _, lay = table_build_of(layout)
    n = keys[0].numel()
    dev = keys[0].device
    room = max(scratch_bytes(n, n_rows, lay),
               16 * n_rows * lay.slots * lay.max_walk + 64 * n + (4 << 20))
    return (*keys, n_rows, lay, salt,
            torch.empty(room, dtype=torch.uint8, device=dev),
            torch.empty((n_rows, 3 * lay.slots), dtype=torch.int32,
                        device=dev),
            torch.empty((), dtype=torch.bool, device=dev))


def check_repeats(layout, args, want) -> int:
    """Launches of the build on the same keys, the table and scratch
    overwritten with junk before each, must each write ``want`` (table,
    bad): atomics' arrival order and earlier contents never show.
    Returns the launches made."""
    from kmers_anno_tpu_torch import kernels

    scratch, table, bad = args[-3:]
    for junk in (0x5A5A5A5A, -1, 0, 0x7FFFFFFF, 0x12345678):
        scratch.view(torch.int32)[: scratch.numel() // 4].fill_(junk)
        table.fill_(junk)
        bad.fill_(bool(junk & 1))
        got = launch_table_build(kernels.lib(), *args)
        require(torch.equal(got[0], want[0])
                and bool(got[1]) == bool(want[1]),
                f"a repeated {layout} build wrote another table")
    return 5


def table_build_passes(args) -> dict:
    """Each pass of the build's device time, mean ms a build, from a
    ``torch.profiler`` trace (device activity only) of two passes of
    ``launch_table_build`` over ``args``; empty when the trace holds no
    device time."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kmers_anno_tpu_torch import kernels

    lib = kernels.lib()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            for a in args:
                launch_table_build(lib, *a)
        torch.cuda.synchronize()
    by_name = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.removeprefix("void ").removeprefix(
                "(anonymous namespace)::").split("(")[0].split("<")[0]
            by_name[name] += e.time_range.elapsed_us() / 1e3 / (2 * len(args))
    return dict(by_name)


def table_build_bound(keys, table, ms) -> dict:
    """A build's bound: each key's 12 bytes read once and the table
    written once, whatever builds it; operations: a key's hash
    (``HASH_KEY_OPS``).  ``sort_bound_ms`` is the sort-based build's bound,
    with a sort's pass (``SORT_PASS_BYTES`` a key) added."""
    n = keys[0].numel()
    row = dict(bound(KEY_BYTES * n + nbytes(table), HASH_KEY_OPS * n, ms),
               library=TABLE_LIBRARY_NOTE)
    row["sort_bound_ms"] = bound(
        KEY_BYTES * n + nbytes(table) + SORT_PASS_BYTES * n,
        HASH_KEY_OPS * n, ms)["bound_ms"]
    return row


def check_table_builds(dev, annot, singles) -> tuple[dict, dict]:
    """Both layouts' kernels against their plain versions on the realistic
    close set's singleton sets (the wide layout at the close set's common
    rows, salt 0; the 8-slot layout at ``device_table_buckets``, as for a
    singleton set past the wide table's capacity) and on the forced
    cases.  The realistic sets are padded by the engine's own
    ``_padded_keys``.  Returns the two ``kernels`` rows and the
    ``--compare`` cases."""
    from kmers_anno_tpu_torch.engine.projection import _bucket
    from kmers_anno_tpu_torch.ops.hashing import GOLDEN
    from kmers_anno_tpu_torch.ops.hashtable import device_table_buckets
    from kmers_anno_tpu_torch.ops.widetable import wide_rows_for

    sets = [list(annot._padded_keys(lo, hi, peg, _bucket(len(lo), 4096)))
            for lo, hi, peg, _ in singles]
    n_pad = max(k[0].numel() for k in sets)
    rows = {"wide": max(wide_rows_for(k[0].numel()) for k in sets),
            "bucketed": device_table_buckets(n_pad)}
    names = {"wide": "build_wide_table_device",
             "bucketed": "build_table_device"}
    measured, cases = {}, {}
    for layout, salt in (("wide", 0), ("bucketed", GOLDEN)):
        got = [check_table_build("a realistic singleton set", layout, keys,
                                 rows[layout], salt) for keys in sets]
        require(not any(g[3] for g in got),
                f"the {layout} build reported bad on a realistic set")
        args = [table_build_args(layout, keys, rows[layout], salt)
                for keys in sets]
        alone = launch_ms(launch_table_build, args,
                          reps=launch_table_build.reps) / len(args)
        require(all(torch.equal(a[-2], g[4]) for a, g in zip(args, got)),
                f"launch_table_build's {layout} tables differ from the "
                f"wrapper's")
        repeats = check_repeats(layout, args[0], (got[0][4], got[0][3]))
        passes = table_build_passes(args)
        ms = statistics.median(g[0] for g in got)
        row = with_launch(dict(
            ms=ms, plain_ms=statistics.median(g[1] for g in got),
            max_abs_err=max(g[2] for g in got),
            keys=statistics.median(len(s[0]) for s in singles),
            padded_keys=n_pad, rows=rows[layout], passes_ms=passes,
            **table_build_bound(sets[0], got[0][4], ms)), alone)
        measured[names[layout]] = row
        cases[f"the realistic singleton sets, {layout}"] = (
            launch_table_build, args, row["bound_ms"])
        print(f"table build, {layout} layout: {len(sets)} realistic "
              f"singleton sets of {[len(s[0]) for s in singles]} keys "
              f"(padded to {n_pad}) into {rows[layout]} rows, no bad, "
              f"tables equal to the plain version's, max_abs_err "
              f"{row['max_abs_err']}, {repeats} repeated launches over junk "
              f"identical; kernel {ms:.4f} ms a build through the wrapper "
              f"(median), {alone:.4f} ms the entry point alone back to "
              f"back; plain {row['plain_ms']:.4f} ms; bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
              f"{row['bound_bytes']} bytes: keys read once, the table "
              f"written once; with a sort's pass, as the sort-based build "
              f"counted it, {row['sort_bound_ms']:.4f} ms), share "
              f"{row['bound_share']:.3f}, alone {row['launch_share']:.3f}; "
              f"device ms a build by pass (torch.profiler): " + (", ".join(
                  f"{k} {v:.4f}" for k, v in passes.items())
                  or "not measured"), flush=True)
    for name in TABLE_BUILD_EDGES:
        layout, _, arrays, n_rows, salt, want_bad = edge_keys(name)
        check_table_build(name, layout, int32_tensors(arrays, dev), n_rows,
                          salt, want_bad)
    print(f"table build: both layouts equal to their plain versions, bad "
          f"flags as forced, on {', '.join(TABLE_BUILD_EDGES)}", flush=True)
    return measured, cases


def declined(*_args):
    """A device table build that declines (reports ``bad``), so that the
    engine takes its own host build for every table: the host side of the
    smoke's turns.  No switch in the package does this."""
    return None, torch.tensor(True)


def projection_workload(dev, tmp: str) -> tuple:
    """The realistic projection workload, its new genome written to
    ``tmp``, and one fused annotation of it: (new genome's path, close
    genomes, features, stats), what the projection phase leaves for the
    ``table_build`` phase."""
    from kmers_anno_tpu_torch.engine.projection import ProjectionAnnotator
    from kmers_anno_tpu_torch.genome.gto import Genome

    _, olds, new = make_projection_workload(np.random.default_rng(SEED),
                                            N_GENES, N_CLOSE)
    new_path = os.path.join(tmp, "new.gto")
    new.save(new_path)
    genome = Genome.load(new_path)
    stats = ProjectionAnnotator(device=dev).annotate_genome(genome, olds.get)
    return new_path, olds, features_of(genome), stats


def run_table_build(dev, keep: dict) -> tuple[dict, dict, dict]:
    """The ``table_build`` phase: the kernel on the realistic singleton
    sets and forced cases; the cold ``_close_set`` of the realistic cell,
    device builds against the engine's host build in turns; a batch of 4
    genomes whose close sets rotate through a pool of 14, in turns; and
    the RLE route with every close table in the 8-slot layout."""
    from kmers_anno_tpu_torch.engine import projection
    from kmers_anno_tpu_torch.engine.projection import (ProjectionAnnotator,
                                                        host_fallback)
    from kmers_anno_tpu_torch.genome.gto import Genome

    new_path, olds, want_feats, want_stats = keep.pop("projection")
    annot = ProjectionAnnotator(device=dev)
    olds_list = list(olds.values())
    singles = [annot._singletons(og) for og in olds_list]
    measured, cases = check_table_builds(dev, annot, singles)
    device_build = projection.build_wide_table_device

    def with_build(build_fn, fn):
        projection.build_wide_table_device = build_fn
        try:
            annot._closeset_cache.clear()
            before = host_fallback.count
            out = fn()
            return out, host_fallback.count - before
        finally:
            projection.build_wide_table_device = device_build

    turns = (("device", device_build), ("host", declined),
             ("host", declined), ("device", device_build))
    cold = {"device": [], "host": []}
    for name, build_fn in turns:
        (s, _), fallbacks = with_build(build_fn, lambda: host_seconds(
            lambda: annot._close_set(olds_list)))
        require(fallbacks == (0 if name == "device" else N_CLOSE),
                f"cold close set, {name} builds: {fallbacks} host builds")
        cold[name].append(s)
    print(f"cold _close_set of the realistic cell ({N_CLOSE} close genomes,"
          f" singletons cached), turns device host host device: device "
          f"{', '.join(f'{s:.4f}' for s in cold['device'])} s, host "
          f"{', '.join(f'{s:.4f}' for s in cold['host'])} s; no host "
          f"build on the device turns", flush=True)
    annot._closeset_cache.clear()
    print_spans(f"a cold _close_set of the realistic cell ({N_CLOSE} close "
                "genomes, singletons cached)",
                lambda: annot._close_set(olds_list))

    # the rotating batch: each genome's close set an ordered 10 of 14
    pool = dict(olds)
    for j, gid in enumerate(list(olds)[:POOL_EXTRA]):
        raw = copy.deepcopy(olds[gid].raw)
        raw["id"] = f"31{j}.1"
        pool[raw["id"]] = Genome(raw)
    pool_ids = list(pool)
    for og in pool.values():
        annot._singletons(og)             # cached, as in a batch run

    def rotating_batch():
        """Seconds a genome: its close set built, then the rest of its
        annotation (which finds the close set cached)."""
        times, set_times = [], []
        with _Launches() as run:
            for g in range(ROTATING_GENOMES):
                ids = pool_ids[g: g + N_CLOSE]
                genome = Genome.load(new_path)
                genome.raw["close_genomes"] = [
                    {"genome": gid, "genome_name": "Oldus",
                     "closeness_measure": 99.0} for gid in ids]
                s_set, _ = host_seconds(
                    lambda: annot._close_set([pool[i] for i in ids]))
                s, stats = host_seconds(
                    lambda: annot.annotate_genome(genome, pool.get))
                require(stats == want_stats
                        and features_of(genome) == want_feats,
                        f"rotating genome {g}: stats or features differ "
                        f"from the warm fused run's")
                times.append(s_set + s)
                set_times.append(s_set)
        require(run.fused_calls == ROTATING_GENOMES,
                "a rotating genome left the fused route")
        return (times, set_times), run.counts

    rotating = {"device": [], "host": []}
    set_s = {"device": [], "host": []}
    for name, build_fn in turns:
        ((times, set_times), counts), fallbacks = with_build(
            build_fn, rotating_batch)
        require(fallbacks == (0 if name == "device"
                              else ROTATING_GENOMES * N_CLOSE),
                f"rotating batch, {name} builds: {fallbacks} host builds")
        want_launches = ROTATING_GENOMES * N_CLOSE if name == "device" else 0
        require(counts["table_build_wide"] == want_launches,
                f"rotating batch, {name} builds: {counts['table_build_wide']}"
                f" launches of the wide build")
        rotating[name].extend(times)
        set_s[name].extend(set_times)
        if name == "device":
            device_counts = counts
    for name, times in rotating.items():
        print(f"rotating close sets ({ROTATING_GENOMES} genomes a turn, "
              f"each an ordered {N_CLOSE} of {len(pool)} close genomes, "
              f"features equal to the warm fused run's), {name} builds: "
              f"{summary(times)}; of which its close set "
              f"{summary(set_s[name])}", flush=True)

    # the RLE route with every close table in the 8-slot layout, as for
    # singleton sets past the wide table's capacity
    rle8 = ProjectionAnnotator(device=dev)
    rle8._close_set = lambda olds_: None
    wide_rows_for = projection.wide_rows_for
    projection.wide_rows_for = lambda n: None
    try:
        genome = Genome.load(new_path)
        before = host_fallback.count
        with _Launches() as run8:
            s, stats = host_seconds(
                lambda: rle8.annotate_genome(genome, olds.get))
    finally:
        projection.wide_rows_for = wide_rows_for
    require(stats == want_stats and features_of(genome) == want_feats,
            "the 8-slot RLE run differs from the warm fused run")
    require(run8.counts["table_build_bucketed"] == N_CLOSE
            and host_fallback.count == before,
            f"the 8-slot RLE run: launches {run8.counts}, "
            f"{host_fallback.count - before} host builds")
    print(f"RLE route, every close table 8-slot (cold): {s:.4f} s, stats "
          f"and features equal to the fused route's, launches "
          f"{run8.counts}", flush=True)
    routes = {"rotating": dict(launches=device_counts,
                               times=rotating["device"]),
              "rle_bucketed": dict(launches=run8.counts)}
    return routes, measured, cases


# ---------------------------------------------------------------------------
# kernel C: the fused apply step
# ---------------------------------------------------------------------------

def made_up_rows(rng, k, n_rows, width, n_keys, table_rows=None):
    """Protein rows of random residues (1% X, lengths from width/2 to
    width, PROT_PAD after) and a wide table of ``n_keys`` of their valid
    windows, each with its row's role (one in 200 another role, so that
    some rows conflict).
    ``table_rows`` squeezes the keys into that many table rows with one
    salt, so that lookups walk (max_probes > 1)."""
    from kmers_anno_tpu_torch.ops.encode import PROT_PAD, PROT_X
    from kmers_anno_tpu_torch.ops.kmers import pack_kmers_np
    from kmers_anno_tpu_torch.ops.widetable import build_wide_table

    lengths = rng.integers(width // 2, width + 1, n_rows)
    codes = rng.integers(0, 20, (n_rows, width)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = PROT_X
    pos = np.arange(width)
    codes[pos[None, :] >= lengths[:, None]] = PROT_PAD
    valid = pos[None, :] <= (lengths - k)[:, None]
    lo, hi = pack_kmers_np(codes.reshape(-1), k)
    windows = np.flatnonzero(valid.reshape(-1)[: len(lo)])
    take = rng.choice(windows, n_keys, replace=False)
    key, first = np.unique(hi[take].astype(np.int64) << 32 | lo[take],
                           return_index=True)
    role = (take[first] // width % SIG_ROLES).astype(np.uint32)
    flip = rng.random(len(key)) < 0.005
    role[flip] = (role[flip] + 1) % SIG_ROLES
    kw = dict(n_rows=table_rows, max_salts=1) if table_rows else {}
    table, salt, mp = build_wide_table(key & 0xFFFFFFFF, key >> 32, role,
                                       **kw)
    return codes, valid, table, salt, mp


def collision_keys(rng, lo, hi, n_rows, n_keys, n_last):
    """Indices of ``n_keys`` distinct candidate keys for an ``n_rows``
    wide table: ``n_last`` of them have the last row as their home under
    the first salt, so that row overflows and its keys wrap to row 0."""
    from kmers_anno_tpu_torch.ops.hashing import mix_kmer_np

    key = (hi.astype(np.uint64) << np.uint64(32)) | lo
    _, first = np.unique(key, return_index=True)
    first = rng.permutation(first)
    home = mix_kmer_np(lo[first], hi[first]) & np.uint32(n_rows - 1)
    last = first[home == n_rows - 1][:n_last]
    rest = first[home != n_rows - 1][: n_keys - n_last]
    require(len(last) == n_last and len(rest) == n_keys - n_last,
            "too few candidate keys for the collision table")
    return rng.permutation(np.concatenate([last, rest]))


def check_collisions_and_wrap(table, salt, mp) -> None:
    """The table holds a row with two keys of one lo word, and a key whose
    home is the last row in a row before it: its walk wrapped to row 0."""
    from kmers_anno_tpu_torch.ops.hashing import mix_kmer_salted_np
    from kmers_anno_tpu_torch.ops.widetable import EMPTY, SLOTS

    lo_keys = table[:, :SLOTS]
    require(any(len(set(r[r != EMPTY])) < int((r != EMPTY).sum())
                for r in lo_keys), "no row holds two keys of one lo word")
    used = lo_keys != EMPTY
    home = mix_kmer_salted_np(lo_keys[used], table[:, SLOTS: 2 * SLOTS][used],
                              salt) & np.uint32(len(table) - 1)
    stored = np.nonzero(used)[0]
    require(mp >= 2 and ((home == len(table) - 1)
                         & (stored < len(table) - 1)).any(),
            "no key's walk wraps from the last row to row 0")


def collision_table(rng, n_queries, valid_mode="mixed", n_rows=8,
                    n_keys=150, n_last=30):
    """A wide table whose keys share six lo words, so that its rows hold
    several keys with one lo and different hi, with a walk that wraps from
    the last row to row 0 (``collision_keys``); and ``n_queries`` queries
    drawn from its keys, keys of those lo words that it lacks, and random
    keys, all valid, 70% valid ("mixed") or none.
    Returns (table, salt, max_probes, (key lo, hi, payloads),
    (query lo, hi, valid))."""
    from kmers_anno_tpu_torch.ops.widetable import build_wide_table

    los = rng.integers(0, 1 << 30, 6).astype(np.uint32)
    lo = rng.choice(los, 40 * n_keys)
    hi = rng.integers(0, 1 << 30, 40 * n_keys).astype(np.uint32)
    pick = collision_keys(rng, lo, hi, n_rows, n_keys, n_last)
    vals = rng.integers(0, 1 << 31, n_keys).astype(np.uint32)
    table, salt, mp = build_wide_table(lo[pick], hi[pick], vals,
                                       n_rows=n_rows, max_salts=1)
    check_collisions_and_wrap(table, salt, mp)
    spare = np.ones(len(lo), bool)
    spare[pick] = False
    n_rand = max(n_queries, 200)
    qlo = np.concatenate([np.tile(lo[pick], 1 + n_queries // n_keys),
                          lo[spare],
                          rng.integers(0, 1 << 30, n_rand).astype(np.uint32)])
    qhi = np.concatenate([np.tile(hi[pick], 1 + n_queries // n_keys),
                          hi[spare],
                          rng.integers(0, 1 << 30, n_rand).astype(np.uint32)])
    order = rng.permutation(len(qlo))[:n_queries]
    valid = {"all_valid": np.ones(n_queries, bool),
             "mixed": rng.random(n_queries) < 0.7,
             "all_invalid": np.zeros(n_queries, bool)}[valid_mode]
    return (table, salt, mp, (lo[pick], hi[pick], vals),
            (qlo[order], qhi[order], valid))


def collision_rows(rng, k, width, n_rows):
    """Protein rows over a two-residue alphabet, so that many windows share
    a lo word, and an 8-row table of 150 keys of that alphabet, 26 of them
    homed on the last row so that the walk wraps to row 0
    (``collision_keys``).  Every fourth row has no valid window."""
    from kmers_anno_tpu_torch.ops.encode import PROT_PAD
    from kmers_anno_tpu_torch.ops.kmers import pack_kmers_np
    from kmers_anno_tpu_torch.ops.widetable import build_wide_table

    codes = rng.integers(0, 2, (n_rows, width)).astype(np.uint8)
    lengths = rng.integers(0, width + 1, n_rows)
    lengths[0] = width
    codes[np.arange(width)[None, :] >= lengths[:, None]] = PROT_PAD
    valid = np.arange(width)[None, :] <= (lengths - k)[:, None]
    valid[::4] = False
    # candidate keys: the rows' windows, then more of the same alphabet
    flat = np.concatenate([codes.reshape(-1),
                           rng.integers(0, 2, 4000).astype(np.uint8)])
    lo, hi = pack_kmers_np(flat, k)
    pick = collision_keys(rng, lo, hi, 8, 150, 26)
    vals = rng.integers(0, 4, len(pick)).astype(np.uint32)
    table, salt, mp = build_wide_table(lo[pick], hi[pick], vals, n_rows=8,
                                       max_salts=1)
    check_collisions_and_wrap(table, salt, mp)
    return codes, valid, table, salt, mp


def check_collisions(dev) -> None:
    """Both lookup kernels against their plain versions on tables that
    hold keys of one lo word and another hi in one row and whose walks
    wrap from the last row to row 0; query counts and row widths off
    multiples of 32; all-invalid queries and rows
    with no valid window.  Exact equality."""
    from kmers_anno_tpu_torch.engine.convert import wide_table_from_numpy
    from kmers_anno_tpu_torch.ops.apply_rows import (apply_rows,
                                                     apply_rows_plain)
    from kmers_anno_tpu_torch.ops.widetable import (probe_wide,
                                                    probe_wide_plain)

    rng = np.random.default_rng(SEED + 3)
    n_probe = 0
    for n in (1, 7, 31, 33, 1001, 100_003):
        for mode in ("all_valid", "mixed", "all_invalid"):
            table, salt, mp, _, (qlo, qhi, valid) = collision_table(
                rng, n, mode)
            args = (wide_table_from_numpy(table, dev),
                    torch.from_numpy(qlo.view(np.int32)).to(dev),
                    torch.from_numpy(qhi.view(np.int32)).to(dev),
                    torch.from_numpy(valid).to(dev), salt, mp)
            got, want = probe_wide(*args), probe_wide_plain(*args)
            require(torch.equal(got, want), f"probe_wide differs from its "
                    f"plain version on a collision table ({n}, {mode})")
            n_probe += 1
    n_apply = 0
    for k, width, n_rows in ((12, 45, 21), (12, 100, 40), (12, 320, 333),
                             (8, 33, 17), (8, 1, 5), (8, 257, 64)):
        codes, valid, table, salt, mp = collision_rows(rng, k, width, n_rows)
        for min_hits in (1, 3):
            args = (wide_table_from_numpy(table, dev), salt,
                    torch.from_numpy(codes).to(dev),
                    torch.from_numpy(valid).to(dev), min_hits, k, mp)
            got, want = apply_rows(*args), apply_rows_plain(*args)
            require(all(torch.equal(g, w) for g, w in zip(got, want)),
                    f"apply_rows differs from its plain version on "
                    f"collision rows (k={k}, width {width})")
            n_apply += 1
    print(f"collision and wrap tables: {n_probe} probe_wide and {n_apply} "
          f"apply_rows cases equal to their plain versions", flush=True)


def check_apply_rows(dev) -> None:
    """The fused apply kernel against its plain version on made-up rows:
    k = 8 on a 1M-key table, k = 12 on a table squeezed so that lookups
    walk.  Exact equality; CUDA-event times."""
    from kmers_anno_tpu_torch.engine.convert import wide_table_from_numpy
    from kmers_anno_tpu_torch.ops.apply_rows import (apply_rows,
                                                     apply_rows_plain)

    rng = np.random.default_rng(SEED + 2)
    walk_keys = 3 * BENCH_KEYS // 5
    walk_rows = 1 << (-(-walk_keys // 20) - 1).bit_length()  # ~18 keys/row
    for k, n_keys, table_rows in ((8, BENCH_KEYS, None),
                                  (12, walk_keys, walk_rows)):
        codes, valid, table, salt, mp = made_up_rows(
            rng, k, BENCH_PROTEINS, BENCH_WIDTH, n_keys, table_rows)
        args = (wide_table_from_numpy(table, dev), salt,
                torch.from_numpy(codes).to(dev),
                torch.from_numpy(valid).to(dev), MIN_HITS, k, mp)
        ms, got = timed(lambda: apply_rows(*args))
        plain_ms, want = timed(lambda: apply_rows_plain(*args))
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"apply_rows k={k} differs from its plain version")
        require(table_rows is None or mp > 1, "the k=12 table does not walk")
        n_called = int((got[0] >= 0).sum())
        require(0 < n_called < BENCH_PROTEINS, "apply_rows call count")
        print(f"apply_rows k={k}: {BENCH_PROTEINS} rows x {BENCH_WIDTH}, "
              f"{len(table) * 24} slots for {n_keys} keys, max_probes {mp},"
              f" {n_called} rows called, exact, max_abs_err "
              f"{max_abs_err(zip(got, want))}, kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms", flush=True)


# ---------------------------------------------------------------------------
# build + apply through the CLI on synthetic genomes
# ---------------------------------------------------------------------------

def make_signature_genomes(rng, n_genomes, n_roles, n_hypothetical,
                           n_multi, plen=PROT_LEN,
                           substitution=SIG_SUBSTITUTION):
    """Genomes for ``build`` and ``apply``, and their role map.

    Each genome has one peg per role, a ``substitution``-rate variant of
    that role's prototype; ``n_hypothetical`` "hypothetical protein" pegs,
    the kill list, one in ten carrying 30 residues of a prototype (whose
    kmers are killed); and ``n_multi`` pegs whose function names two roles
    (build skips them).  Prototypes 2i and 2i+1 share 24 residues for the
    first tenth of the roles, so those kmers are seen under two roles and
    pruned."""
    from kmers_anno_tpu_torch.genome.gto import Genome
    from kmers_anno_tpu_torch.genome.roles import Role, RoleMap

    aa = np.frombuffer(AA.encode(), np.uint8)
    protos = rng.integers(0, 20, (n_roles, plen))
    for r in range(0, n_roles // 10, 2):
        protos[r + 1, 50:74] = protos[r, 50:74]
    names = [f"Synthetic signature protein {r}" for r in range(n_roles)]
    role_map = RoleMap()
    for r, name in enumerate(names):
        role_map.put(Role(f"SynRole{r}", name))
    genomes = []
    for g in range(n_genomes):
        gid = f"900{g}.1"
        variants = protos.copy()
        hit = rng.random(variants.shape) < substitution
        variants[hit] = rng.integers(0, 20, int(hit.sum()))
        hypo = rng.integers(0, 20, (n_hypothetical, plen))
        src = rng.integers(0, n_roles, n_hypothetical)
        hypo[::10, 100:130] = protos[src[::10], 100:130]
        multi = rng.integers(0, 20, (n_multi, plen))
        prots = [*variants, *hypo, *multi]
        funcs = (names + ["hypothetical protein"] * n_hypothetical
                 + [f"{names[2 * i]} / {names[2 * i + 1]}"
                    for i in range(n_multi)])
        feats = [{"id": f"fig|{gid}.peg.{i + 1}", "type": "CDS",
                  "function": f,
                  "location": [["c1", str(100 * i + 1), "+", 3 * plen]],
                  "protein_translation": aa[p].tobytes().decode(),
                  "annotations": [], "aliases": []}
                 for i, (p, f) in enumerate(zip(prots, funcs))]
        genomes.append(Genome({
            "id": gid, "scientific_name": f"Synthetica {g}",
            "genetic_code": 11, "domain": "Bacteria", "features": feats,
            "contigs": [{"id": "c1", "dna": "acgt" * 25}],
            "close_genomes": [], "subsystems": []}))
    return genomes, role_map


def run_signature_path(dev, tmp: str) -> tuple[dict, dict]:
    """``build`` then ``apply`` (VERIFY, then APPLY) through the CLI on
    synthetic genomes; the device group-by against the C++ builder; every
    call against the single-core string-keyed baseline; cold and warm
    seconds per genome.  Returns each run's launch counts, and the
    genomes, files and VERIFY report for ``run_big_kdb_cli``."""
    from kmers_anno_tpu_torch.commands.app import main
    from kmers_anno_tpu_torch.engine.apply_engine import KmerApplyEngine
    from kmers_anno_tpu_torch.engine.signature import (SignatureTable,
                                                       build_signatures)
    from kmers_anno_tpu_torch import native
    from kmers_anno_tpu_torch.genome.gto import Genome, GenomeDirectory

    t0 = time.perf_counter()
    genomes, role_map = make_signature_genomes(
        np.random.default_rng(SEED), SIG_GENOMES, SIG_ROLES,
        SIG_HYPOTHETICAL, SIG_MULTI)
    gto_dir = os.path.join(tmp, "gtos")
    os.makedirs(gto_dir)
    for g in genomes:
        g.save(os.path.join(gto_dir, f"{g.id}.gto"))
    role_file = os.path.join(tmp, "roles.in.subsystems")
    use_file = os.path.join(tmp, "roles.to.use")
    role_map.save(role_file)
    with open(use_file, "w") as fh:
        fh.writelines(f"{rid}\n" for rid in role_map.ids())
    n_pegs = sum(len(g.pegs) for g in genomes)
    print(f"signature workload: {SIG_GENOMES} genomes x {n_pegs // SIG_GENOMES}"
          f" pegs ({SIG_ROLES} role variants at {SIG_SUBSTITUTION:.0%} "
          f"substitution, {SIG_HYPOTHETICAL} hypothetical, {SIG_MULTI} "
          f"two-role) of {PROT_LEN} aa, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    db = os.path.join(tmp, "kmerdb.tbl")
    t0 = time.perf_counter()
    with _Launches() as build_run:
        rc = main(["build", "-K", str(K), "--device", str(dev), "-o", db,
                   role_file, use_file, gto_dir])
    build_s = time.perf_counter() - t0
    require(rc == 0, f"build exited with {rc}")
    table = SignatureTable.load(db)
    native_s, want = host_seconds(lambda: build_signatures(
        GenomeDirectory(gto_dir), role_map, set(role_map.ids()), k=K,
        progress=False, device=dev))
    device_s, got = host_seconds(lambda: build_signatures(
        GenomeDirectory(gto_dir), role_map, set(role_map.ids()), k=K,
        progress=False, backend="device", device=dev))
    for name in ("key_lo", "key_hi", "role_idx"):
        require(np.array_equal(getattr(got, name), getattr(want, name)),
                f"device group-by {name} differs from the C++ builder's")
    require(got.stats == want.stats and got.role_ids == want.role_ids,
            f"device group-by stats {got.stats} != C++ {want.stats}")
    require(table.kmer_texts() == want.kmer_texts(),
            "the CLI's table differs from the library build")
    stats = want.stats
    require(stats["pruned"] > 0 and stats["killed"] > 0,
            f"the build neither pruned nor killed: {stats}")
    print(f"build (CLI, C++ group-by): {len(table)} kmers of "
          f"{len(table.role_ids)} roles, stats {stats}, {build_s:.2f} s "
          f"(GTO load included); library build: C++ {native_s:.2f} s, "
          f"torch group-by on {dev} {device_s:.2f} s, equal arrays and "
          f"stats; launches {build_run.counts}", flush=True)

    verify = os.path.join(tmp, "verify.tbl")
    train = os.path.join(tmp, "train.tbl")
    runs = {}
    for route, fmt, out in (("apply", "VERIFY", verify),
                            ("apply_train", "APPLY", train)):
        t0 = time.perf_counter()
        with _Launches() as run:
            rc = main(["apply", "--format", fmt, "-m", str(MIN_HITS),
                       "--device", str(dev), "-o", out, db, use_file,
                       gto_dir])
        cold_s = time.perf_counter() - t0
        require(rc == 0, f"apply --format {fmt} exited with {rc}")
        require(run.counts["apply_rows"] > 0,
                f"apply --format {fmt} never launched apply_rows: "
                f"{run.counts}")
        runs[route] = dict(launches=run.counts)
        print(f"apply --format {fmt} (CLI, cold: table load and build, GTO "
              f"load): {cold_s:.2f} s, {cold_s / SIG_GENOMES:.3f} s/genome, "
              f"launches {run.counts}", flush=True)

    lines = open(verify).read().splitlines()
    require(lines[0] == "genome_id\tpeg_id\trole\thits\tfunction",
            "VERIFY header")
    calls = [tuple(line.split("\t")[:3]) for line in lines[1:]]
    counts = {}
    for gid, _, _ in calls:
        counts[gid] = counts.get(gid, 0) + 1
    trained = [line.split("\t") for line in open(train).read().splitlines()]
    require(len(trained) == SIG_GENOMES and all(
        sum(map(int, row[1:])) == counts.get(row[0], 0) for row in trained),
        "the APPLY report's role counts differ from the VERIFY calls")

    baseline = native.JavaDataflowBaseline(table.kmer_texts(),
                                           table.role_idx, K)
    want_calls = []
    for g in sorted(genomes, key=lambda g: g.id):
        pegs = [f for f in g.pegs if f.protein_translation]
        roles = baseline.apply([f.protein_translation for f in pegs], K,
                               MIN_HITS)
        want_calls += [(g.id, f.id, table.role_ids[r])
                       for f, r in zip(pegs, roles) if r >= 0]
    baseline.close()
    require(calls == want_calls, f"apply's {len(calls)} calls differ from "
            f"JavaDataflowBaseline's {len(want_calls)}")
    print(f"independent check: {len(calls)} called (peg, role) pairs "
          f"(of {n_pegs} pegs) equal to JavaDataflowBaseline", flush=True)

    engine_s, engine = host_seconds(
        lambda: KmerApplyEngine(table, min_hits=MIN_HITS, device=dev))
    loaded = [Genome.load(os.path.join(gto_dir, f"{g.id}.gto"))
              for g in genomes]
    cold = [host_seconds(lambda: engine.call_genome(g))[0]
            for g in loaded[:1]]
    warm = [host_seconds(lambda: engine.call_genome(g))[0]
            for _ in range(WARM_RUNS) for g in loaded]
    print(f"apply engine: wide table built and uploaded in {engine_s:.3f} "
          f"s; first genome {cold[0]:.4f} s; warm call_genome "
          f"{summary(warm)}", flush=True)
    return runs, dict(genomes=genomes, table=table, use_file=use_file,
                      gto_dir=gto_dir, verify=verify)


# ---------------------------------------------------------------------------
# the apply benchmark's shape
# ---------------------------------------------------------------------------

def make_bench_proteins(rng, protos, n, which):
    """``bench.make_proteins``: random proteins with a planted 120-residue
    role segment."""
    proteins = rng.integers(0, 20, size=(n, PROT_LEN)).astype(np.uint8)
    proteins[:, 100:220] = protos[which]
    return proteins


def make_bench_workload(rng, n_keys=BENCH_KEYS):
    """``bench.make_workload``: the kmers of 2000 role prototypes plus
    random fill up to ``n_keys`` keys, first occurrence kept (each key
    packed into one uint64 for ``np.unique``)."""
    from kmers_anno_tpu_torch.ops.kmers import pack_kmers_np

    protos = rng.integers(0, 20, size=(SIG_ROLES, 120)).astype(np.uint8)
    lo_all, hi_all, role_all = [], [], []
    for r in range(SIG_ROLES):
        lo, hi = pack_kmers_np(protos[r], K)
        lo_all.append(lo)
        hi_all.append(hi)
        role_all.append(np.full(len(lo), r, np.int32))
    n_proto = sum(len(x) for x in lo_all)
    n_fill = max(0, n_keys - n_proto)
    fill = rng.integers(0, 20, size=(n_fill + K - 1,)).astype(np.uint8)
    flo, fhi = pack_kmers_np(fill, K)
    lo_all.append(flo)
    hi_all.append(fhi)
    role_all.append(rng.integers(0, SIG_ROLES, size=len(flo)).astype(
        np.int32))
    lo = np.concatenate(lo_all)
    hi = np.concatenate(hi_all)
    role = np.concatenate(role_all)
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo
    _, idx = np.unique(key, return_index=True)
    idx = np.sort(idx)
    return protos, lo[idx], hi[idx], role[idx]


def run_bench_shape(dev) -> tuple[dict, dict]:
    """32 batches of 8192 proteins through ``KmerApplyEngine.call_proteins``
    (roles against ``native.apply_baseline`` on the 8-slot table); the
    apply step on those batches three ways; the weighted path with a
    uniform-weight table against its CPU run."""
    from kmers_anno_tpu_torch.engine.apply_engine import (KmerApplyEngine,
                                                          make_row_batches)
    from kmers_anno_tpu_torch.engine.signature import SignatureTable
    from kmers_anno_tpu_torch import native
    from kmers_anno_tpu_torch.ops.encode import PROT_PAD, decode_protein
    from kmers_anno_tpu_torch.ops.apply_rows import (apply_rows,
                                                     apply_rows_plain)
    from kmers_anno_tpu_torch.ops.hashtable import build_table
    from kmers_anno_tpu_torch.ops.kmers import pack_kmer_windows
    from kmers_anno_tpu_torch.ops.vote import unanimous_vote
    from kmers_anno_tpu_torch.ops.widetable import probe_wide

    rng = np.random.default_rng(BENCH_SEED)
    protos, key_lo, key_hi, roles = make_bench_workload(rng)
    batches = [make_bench_proteins(rng, protos, BENCH_PROTEINS,
                                   rng.integers(0, SIG_ROLES,
                                                size=BENCH_PROTEINS))
               for _ in range(BENCH_BATCHES)]
    codes = np.concatenate(batches)
    prots = [decode_protein(p) for p in codes]
    n = len(prots)
    role_ids = [f"Role{r}" for r in range(SIG_ROLES)]
    table = SignatureTable(k=K, key_lo=key_lo, key_hi=key_hi,
                           role_idx=roles, role_ids=role_ids)
    engine = KmerApplyEngine(table, min_hits=MIN_HITS, device=dev)
    runs = {}
    with _Launches() as run:
        got = engine.call_proteins(prots)
    runs["bench"] = dict(launches=run.counts)
    require(run.counts["apply_rows"] > 0, "the bench shape never launched "
            "apply_rows")
    index = {rid: i for i, rid in enumerate(role_ids)}
    got_roles = np.array([index[c[0]] if c else -1 for c in got], np.int32)
    table8, mp8 = build_table(key_lo, key_hi, roles.astype(np.uint32))
    want_roles = native.apply_baseline(codes, table8, mp8, K, MIN_HITS)
    require(np.array_equal(got_roles, want_roles),
            f"{int((got_roles != want_roles).sum())} roles differ from "
            "native.apply_baseline")
    n_called = int((got_roles >= 0).sum())
    print(f"bench shape: {len(key_lo)} keys, {n} proteins "
          f"({BENCH_BATCHES} x {BENCH_PROTEINS} x {PROT_LEN} aa), "
          f"{n_called} called, roles equal to native.apply_baseline "
          f"(8-slot table, max_probes {mp8}); launches {run.counts}",
          flush=True)

    times = [host_seconds(lambda: engine.call_proteins(prots))[0]
             for _ in range(REPS)]
    rates = sorted(n / t for t in times)
    host_s, prepared = host_seconds(lambda: make_row_batches(prots, K))
    device_s, _ = host_seconds(lambda: engine._call_batches(n, prepared))
    print(f"bench shape call_proteins: {statistics.median(rates):.1f} "
          f"proteins/s (median of {REPS}, range {rates[0]:.1f}-"
          f"{rates[-1]:.1f}; s per run {', '.join(f'{t:.4f}' for t in times)}"
          f"); split of one more run: host row batches {host_s:.4f} s, "
          f"device steps with copies {device_s:.4f} s ({len(prepared)} "
          f"batches)", flush=True)

    padded = np.full((BENCH_BATCHES, BENCH_PROTEINS, BENCH_WIDTH), PROT_PAD,
                     np.uint8)
    padded[:, :, :PROT_LEN] = np.stack(batches)
    valid_np = np.zeros((BENCH_PROTEINS, BENCH_WIDTH), bool)
    valid_np[:, : PROT_LEN - K + 1] = True
    d_codes = torch.from_numpy(padded).to(dev)
    valid = torch.from_numpy(valid_np).to(dev)
    args = (engine.table, engine.salt)

    def kernel():
        return [apply_rows(*args, c, valid, MIN_HITS, K, engine.max_probes)
                for c in d_codes]

    def plain():
        return [apply_rows_plain(*args, c, valid, MIN_HITS, K,
                                 engine.max_probes) for c in d_codes]

    def unfused():
        out = []
        for c in d_codes:
            lo, hi = pack_kmer_windows(c, K)
            r = probe_wide(engine.table, lo, hi, valid, engine.salt,
                           engine.max_probes)
            out.append(unanimous_vote(r, valid, MIN_HITS))
        return out

    ms, got_k = timed(kernel)
    plain_ms, got_p = timed(plain)
    unfused_ms, got_u = timed(unfused)
    pairs = [(g, w) for a, b in zip(got_k, got_p) for g, w in zip(a, b)]
    require(all(torch.equal(g, w) for g, w in pairs),
            "apply_rows differs from its plain version on the bench batches")
    require(all(torch.equal(g, w) for a, b in zip(got_k, got_u)
                for g, w in zip(a, b)),
            "apply_rows differs from the unfused composition")
    first = got_k[0][0].cpu().numpy()[:BENCH_PROTEINS]
    require(np.array_equal(first, want_roles[:BENCH_PROTEINS]),
            "the padded batch's roles differ from the baseline")
    measured = dict(ms=ms / BENCH_BATCHES, plain_ms=plain_ms / BENCH_BATCHES,
                    unfused_ms=unfused_ms / BENCH_BATCHES,
                    max_abs_err=max_abs_err(pairs))
    measured.update(apply_bound(engine.table, engine.salt, d_codes, valid,
                                K, engine.max_probes, measured["ms"]))
    apply_args = [(engine.table, engine.salt, c, valid, MIN_HITS, K,
                   engine.max_probes) for c in d_codes]
    measured = with_launch(measured, launch_ms(launch_apply, apply_args)
                           / BENCH_BATCHES)
    print(f"bench shape apply_rows per {BENCH_PROTEINS} x {BENCH_WIDTH} "
          f"batch (median of {REPS} runs over {BENCH_BATCHES} batches), "
          f"exact: kernel {measured['ms']:.4f} ms ("
          f"{measured['launch_ms']:.4f} ms a launch back to back), plain "
          f"{measured['plain_ms']:.4f} ms, unfused (torch pack + probe_wide "
          f"kernel + torch vote) {measured['unfused_ms']:.4f} ms; bound "
          f"(mean of the batches) {measured['bound_ms']:.4f} ms "
          f"({measured['bound_by']}, {measured['bound_bytes']} bytes), "
          f"share {measured['bound_share']:.3f}, back to back "
          f"{measured['launch_share']:.3f}", flush=True)
    cases = {"the bench batches": (launch_apply, apply_args)}

    weighted = SignatureTable(k=K, key_lo=key_lo, key_hi=key_hi,
                              role_idx=roles, role_ids=role_ids,
                              weights=np.ones(len(key_lo), np.float32))
    w_engine = KmerApplyEngine(weighted, min_hits=MIN_HITS, weighted=True,
                               device=dev)
    with _Launches() as run:
        w_got = w_engine.call_proteins(prots)
    runs["weighted_apply"] = dict(launches=run.counts)
    require(run.counts["probe_wide"] > 0 and run.counts["apply_rows"] == 0,
            f"the weighted path's launches: {run.counts}")
    w_s = [host_seconds(lambda: w_engine.call_proteins(prots))[0]
           for _ in range(3)]
    sample = list(range(0, n, n // WEIGHTED_SAMPLE))
    cpu = KmerApplyEngine(weighted, min_hits=MIN_HITS, weighted=True,
                          device="cpu")
    want_w = cpu.call_proteins([prots[i] for i in sample])
    require([w_got[i] for i in sample] == want_w,
            "the weighted path on the card differs from its CPU run")
    print(f"bench shape weighted (uniform weights): "
          f"{sum(c is not None for c in w_got)} called, equal to the CPU run "
          f"on {len(sample)} proteins; {n / statistics.median(w_s):.1f} "
          f"proteins/s (median of 3); launches {run.counts}", flush=True)

    # non-integer weights, cast through fp16 as the build packs them: the
    # card's tallies must equal the CPU's bit for bit (order-free sums)
    w_rng = np.random.default_rng(BENCH_SEED)
    real = w_rng.uniform(0.05, 3.0, len(key_lo)).astype(np.float16).astype(
        np.float32)
    fractional = SignatureTable(k=K, key_lo=key_lo, key_hi=key_hi,
                                role_idx=roles, role_ids=role_ids,
                                weights=real)
    engines = [KmerApplyEngine(fractional, min_hits=MIN_HITS, weighted=True,
                               device=d) for d in (dev, "cpu")]
    picked = [prots[i] for i in sample]
    got_f = engines[0].call_proteins(prots)
    require([got_f[i] for i in sample] == engines[1].call_proteins(picked),
            "the weighted path with fractional weights differs from its "
            "CPU run")
    raw = [e._call_batches(len(picked), make_row_batches(picked, K))
           for e in engines]
    require(np.array_equal(raw[0][0], raw[1][0])
            and np.array_equal(raw[0][1].view(np.int32),
                               raw[1][1].view(np.int32)),
            "fractional-weight tallies on the card differ from the CPU's "
            "in their bits")
    called = raw[0][0] >= 0
    frac = raw[0][1][called]
    require(called.any() and (frac != np.round(frac)).any(),
            "the fractional-weight check saw no fractional tally")
    print(f"bench shape weighted (fp16 weights from U[0.05, 3.0], seed "
          f"{BENCH_SEED}): {sum(c is not None for c in got_f)} called; on "
          f"{len(sample)} proteins the card's roles and float32 tallies "
          f"equal the CPU's bit for bit ({int(called.sum())} called, "
          f"{int((frac != np.round(frac)).sum())} fractional tallies)",
          flush=True)
    return runs, measured, cases


# ---------------------------------------------------------------------------
# kernels F and G: the flat-stream apply step over the 8-slot table
# ---------------------------------------------------------------------------

BIG_KEYS = 10_000_000            # BASELINE config 4: a 10M-entry table
BIG_QUERIES = 4_000_000          # bench.py's big-table queries (bench.py:333)
BIG_BASELINE_EVERY = 8           # apply_baseline checks every 8th protein
KDB_KEYS = 4_000_000             # the CLI's .kdb past one wide table
FLAT_VOTE_OPS = 3                # a hit's count, min and max (or its add)
# a token's step of a rolling kmer pack: lo = lo >> 5 | (hi & 31) << 25,
# hi = hi >> 5 | code << 25
ROLL_PACK_OPS = 7
HIT_BUCKET_BYTES = 64            # a hit bucket's hi-key and payload sectors
FLAT_EDGES = {
    "k8": dict(k=8, n_prot=300, max_len=200),
    "k12": dict(k=12, n_prot=97, max_len=150),
    # two residues: buckets hold several keys of one lo word; keys squeezed
    # into few buckets, with the last one overflowing into bucket 0
    "k8_collide_wrap": dict(k=8, n_prot=60, max_len=90, alphabet=2,
                            n_buckets=16, n_keys=100, n_last=10),
    "k12_collide_wrap": dict(k=12, n_prot=45, max_len=70, alphabet=2,
                             n_buckets=32, n_keys=200, n_last=12),
}


def flat_case(rng, k, n_prot, max_len, n_roles, weights=None, alphabet=20,
              n_buckets=None, n_keys=400, n_last=0):
    """A FlatBatch of ``n_prot`` random proteins of 0..max_len residues over
    the first ``alphabet`` codes (1% X with all 20), and an 8-slot table of
    ``n_keys`` distinct kmers of its valid windows, each with its protein's
    role modulo ``n_roles`` (one in ten the next role, so that some
    proteins conflict); payloads packed with fp16 ``weights`` ("uniform",
    or "fp16" from U[0.05, 3)) when given.  ``n_buckets`` squeezes the keys
    into that many buckets with ``n_last`` of them homed on the last one,
    so that it overflows and walks wrap to bucket 0 (``collision_keys``).
    Returns (batch, table, max_probes)."""
    from kmers_anno_tpu_torch.engine.apply_engine import FlatBatch
    from kmers_anno_tpu_torch.ops.encode import PROT_X, decode_protein
    from kmers_anno_tpu_torch.ops.hashtable import build_table
    from kmers_anno_tpu_torch.ops.kmers import pack_kmers_np

    prots = []
    for n in rng.integers(0, max_len + 1, n_prot):
        c = rng.integers(0, alphabet, n).astype(np.uint8)
        if alphabet == 20:
            c[rng.random(n) < 0.01] = PROT_X
        prots.append(decode_protein(c))
    batch = FlatBatch(prots, k)
    lo, hi = pack_kmers_np(batch.codes, k)
    windows = np.flatnonzero(batch.valid[: len(lo)])
    if n_buckets:
        pick = windows[collision_keys(rng, lo[windows], hi[windows],
                                      n_buckets, n_keys, n_last)]
    else:
        key = (hi[windows].astype(np.uint64) << np.uint64(32)) | lo[windows]
        _, first = np.unique(key, return_index=True)
        pick = rng.choice(windows[first], min(n_keys, len(first)),
                          replace=False)
    role = (batch.seg_ids[pick] % n_roles).astype(np.uint32)
    flip = rng.random(len(pick)) < 0.1
    role[flip] = (role[flip] + 1) % n_roles
    if weights is not None:
        w = (np.ones(len(pick), np.float16) if weights == "uniform"
             else rng.uniform(0.05, 3.0, len(pick)).astype(np.float16))
        role |= w.view(np.uint16).astype(np.uint32) << np.uint32(16)
    table, mp = build_table(lo[pick], hi[pick], role, n_buckets=n_buckets)
    if n_buckets:
        check_bucket_collisions_and_wrap(table, mp)
    return batch, table, mp


def check_bucket_collisions_and_wrap(table, mp) -> None:
    """The 8-slot table holds a bucket with two keys of one lo word, and a
    key homed on the last bucket stored in a bucket before it: its walk
    wrapped to bucket 0."""
    from kmers_anno_tpu_torch.ops.hashing import mix_kmer_np
    from kmers_anno_tpu_torch.ops.hashtable import BUCKET, EMPTY

    lo_keys = table[:, :BUCKET]
    require(any(len(set(r[r != EMPTY])) < int((r != EMPTY).sum())
                for r in lo_keys), "no bucket holds two keys of one lo word")
    used = lo_keys != EMPTY
    home = mix_kmer_np(lo_keys[used], table[:, BUCKET: 2 * BUCKET][used]
                       ) & np.uint32(len(table) - 1)
    stored = np.nonzero(used)[0]
    require(mp >= 2 and ((home == len(table) - 1)
                         & (stored < len(table) - 1)).any(),
            "no key's walk wraps from the last bucket to bucket 0")


# weighted streams at the one-walk kernel's edges (``weighted_case``'s
# arguments; lengths a list or (proteins, longest) drawn at random), and
# "float_ties" (``crafted_ties``)
WEIGHTED_EDGES = {
    # one 40,000-aa protein whose hits span thousands of roles, past the
    # shared tally: its kept hits are swept in role ranges
    "long_protein": dict(k=8, lengths=[40_000, 300, 0, 7, 500],
                         n_roles=30_000, n_keys=20_000),
    "roles_30000": dict(k=12, lengths=(200, 400), n_roles=30_000,
                        n_keys=6_000),
    "zero_weights": dict(k=8, lengths=(150, 200), n_roles=9, n_keys=2_000,
                         zero_share=0.5),
    "empty_proteins": dict(k=8, lengths=[0, 0, 3, 0, 7, 8, 0, 50, 0, 0, 9,
                                         120, 0], n_roles=9, n_keys=60),
    # windows a protein: 1, and 127-129, 255-257, 383-385 about the owner
    # block's rounds of 128
    "tile_edges": dict(k=8, lengths=[7 + w for w in (
        1, 127, 128, 129, 255, 256, 257, 383, 384, 385)] * 3, n_roles=9,
        n_keys=1_500),
    "float_ties": None,
}


def random_proteins(rng, lengths) -> list[str]:
    """Proteins of the given lengths over the 20 residues (1% X)."""
    from kmers_anno_tpu_torch.ops.encode import PROT_X, decode_protein

    prots = []
    for n in lengths:
        c = rng.integers(0, 20, n).astype(np.uint8)
        c[rng.random(n) < 0.01] = PROT_X
        prots.append(decode_protein(c))
    return prots


def weighted_case(rng, k, lengths, n_roles, n_keys, zero_share=0.0):
    """A FlatBatch of random proteins and an 8-slot table of ``n_keys``
    distinct kmers of its valid windows, each with a role drawn from
    [0, n_roles) and an fp16 weight from U[0.05, 3) (``zero_share`` of them
    0).  Returns (batch, table, max_probes)."""
    from kmers_anno_tpu_torch.engine.apply_engine import FlatBatch
    from kmers_anno_tpu_torch.ops.hashtable import build_table
    from kmers_anno_tpu_torch.ops.kmers import pack_kmers_np

    if isinstance(lengths, tuple):
        lengths = rng.integers(0, lengths[1] + 1, lengths[0])
    batch = FlatBatch(random_proteins(rng, lengths), k)
    lo, hi = pack_kmers_np(batch.codes, k)
    windows = np.flatnonzero(batch.valid[: len(lo)])
    key = (hi[windows].astype(np.uint64) << np.uint64(32)) | lo[windows]
    _, first = np.unique(key, return_index=True)
    pick = rng.choice(windows[first], min(n_keys, len(first)), replace=False)
    w = rng.uniform(0.05, 3.0, len(pick)).astype(np.float16)
    w[rng.random(len(pick)) < zero_share] = 0
    payload = ((w.view(np.uint16).astype(np.uint32) << np.uint32(16))
               | rng.integers(0, n_roles, len(pick)).astype(np.uint32))
    table, mp = build_table(lo[pick], hi[pick], payload)
    return batch, table, mp


# crafted_ties's proteins: their hits as (role, fp16 weight), and the call
TIE_PLANS = [
    # 3 sums 2^25 + 1 units, 5 sums 2^25: both 2.0 as float32, 3 called
    ([(3, 2.0), (3, 2.0 ** -24), (5, 2.0)], 3),
    # the other way round: 5's sum is larger, the smaller role 3 is called
    ([(5, 2.0), (5, 2.0 ** -24), (3, 2.0)], 3),
    ([(6, 2.0), (6, 2.0 ** -24), (2, 2.0)], 2),
    # 2^25 + 4 units is 2.0000002 as float32: 4 beats 1
    ([(1, 2.0), (4, 2.0), (4, 2.0 ** -22)], 4),
    # only hits of zero weight: nothing called
    ([(2, 0.0), (2, 0.0)], -1),
]


def crafted_ties(rng, k=8):
    """Proteins holding the hits of ``TIE_PLANS``, each kmer once in the
    whole stream, and the 8-slot table of those kmers.  Returns (batch,
    table, max_probes, the expected calls)."""
    from kmers_anno_tpu_torch.engine.apply_engine import FlatBatch
    from kmers_anno_tpu_torch.ops.hashtable import build_table
    from kmers_anno_tpu_torch.ops.kmers import pack_kmers_np

    for _ in range(100):
        prots, keys, vals = [], [], []
        for hits, _ in TIE_PLANS:
            parts = random_proteins(rng, [int(rng.integers(3, 9))])
            for role, weight in hits:
                kmer, = random_proteins(rng, [k])
                parts += [kmer, *random_proteins(rng, [
                    int(rng.integers(3, 9))])]
                keys.append(kmer)
                bits = int(np.float16(weight).view(np.uint16))
                vals.append(bits << 16 | role)
            prots.append("".join(parts))
        batch = FlatBatch(prots, k)
        lo, hi = pack_kmers_np(batch.codes, k)
        windows = np.flatnonzero(batch.valid[: len(lo)])
        seen = (hi[windows].astype(np.uint64) << np.uint64(32)) | lo[windows]
        klo, khi = pack_kmers_np(FlatBatch(keys, k).codes, k)
        starts = np.cumsum([0] + [k] * (len(keys) - 1))
        kkey = (khi[starts].astype(np.uint64) << np.uint64(32)) | klo[starts]
        if (len(set(kkey.tolist())) == len(keys)
                and all(int((seen == x).sum()) == 1 for x in kkey)):
            table, mp = build_table(klo[starts], khi[starts],
                                    np.array(vals, np.uint32))
            expect = np.full(batch.n_seqs, -1, np.int32)
            expect[: len(TIE_PLANS)] = [want for _, want in TIE_PLANS]
            return batch, table, mp, expect
    raise RuntimeError("no stream of distinct tie kmers in 100 draws")


def weighted_edge(rng, name):
    """``WEIGHTED_EDGES[name]``: (batch, table, max_probes, k, n_roles,
    expected calls or None)."""
    if name == "float_ties":
        batch, table, mp, expect = crafted_ties(rng)
        return batch, table, mp, 8, 9, expect
    params = WEIGHTED_EDGES[name]
    return (*weighted_case(rng, **params), params["k"], params["n_roles"],
            None)


def flat_tensors(batch, table, dev):
    """(table, codes, seg_ids, valid) on ``dev``."""
    from kmers_anno_tpu_torch.engine.convert import wide_table_from_numpy

    return (wide_table_from_numpy(table, dev),
            *(torch.from_numpy(a).to(dev)
              for a in (batch.codes, batch.seg_ids, batch.valid)))


def tally_bits(out) -> tuple:
    """A weighted step's (role, tally) with the tally's float32 bits."""
    return out[0], out[1].view(torch.int32)


def flat_filter(table):
    """The key filter of a (buckets, 24) int32 table tensor, on its
    device (``ops.key_filter``, from the table's own keys)."""
    from kmers_anno_tpu_torch.ops.key_filter import (build_key_filter,
                                                     table_keys)

    words = table.cpu().numpy().view(np.uint32)
    return build_key_filter(*table_keys(words), table.device)


# the C signatures of earlier entry points, declared on a build that has
# them so that --compare can time it: the flat ones (no filter; the
# weighted one a launch a role block) and the sort-based table build
# (homes, then the placement of the stably sorted homes)
EARLIER_ENTRIES = {
    "kan_apply_flat": [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int32,
                               ctypes.c_int32, ctypes.c_int64,
                               ctypes.c_int32] + [ctypes.c_void_p] * 4,
    "kan_apply_flat_weighted": [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_int32] + [ctypes.c_void_p] * 3
    + [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32] + [ctypes.c_int64] * 3
    + [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_float]
    + [ctypes.c_void_p] * 3,
    "kan_table_homes": [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2
    + [ctypes.c_uint32] + [ctypes.c_void_p] * 2,
    "kan_table_place": [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2
    + [ctypes.c_int32] * 3 + [ctypes.c_void_p] * 4,
}


def declare_earlier_entries(lib) -> None:
    for name, argtypes in EARLIER_ENTRIES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes


def launch_flat(lib, table, codes, seg_ids, valid, k, max_probes, n_seqs,
                min_hits, key_filter=None):
    """apply_flat through a kernel library's C entry point (uncounted):
    ``kan_flat_unanimous`` with ``key_filter`` (None: every window walks),
    or on a build without it the earlier ``kan_apply_flat`` (no filter)."""
    from kmers_anno_tpu_torch.ops.encode import PROT_PAD
    from kmers_anno_tpu_torch.ops.key_filter import filter_args

    role, hits, rmin = (torch.empty(n_seqs, dtype=torch.int32,
                                    device=codes.device) for _ in range(3))
    stream = torch.cuda.current_stream().cuda_stream
    if hasattr(lib, "kan_flat_unanimous"):
        err = lib.kan_flat_unanimous(
            table.data_ptr(), table.shape[0], max_probes,
            *filter_args(key_filter), codes.data_ptr(), seg_ids.data_ptr(),
            valid.data_ptr(), codes.numel(), k, PROT_PAD, n_seqs,
            int(min_hits), role.data_ptr(), hits.data_ptr(), rmin.data_ptr(),
            stream)
    else:
        err = lib.kan_apply_flat(
            table.data_ptr(), table.shape[0], max_probes, codes.data_ptr(),
            seg_ids.data_ptr(), valid.data_ptr(), codes.numel(), k, PROT_PAD,
            n_seqs, int(min_hits), role.data_ptr(), hits.data_ptr(),
            rmin.data_ptr(), stream)
    require(err == 0, f"the apply_flat entry returned CUDA error {err}")
    return role, hits


class FlatScratch:
    """The weighted entry points' scratch on the card: ``starts``, ``flags``
    and (past ``DIRECT_ROLES`` roles) ``kept`` for ``kan_flat_weighted``;
    the earlier entry's zeroed (n_seqs x block) int64 tally, made on first
    use."""

    def __init__(self, n_tokens, n_seqs, n_roles, dev):
        from kmers_anno_tpu_torch.ops import apply_flat

        self.n_seqs, self.n_roles, self.dev = n_seqs, n_roles, dev
        self.starts = torch.empty(n_seqs + 1, dtype=torch.int64, device=dev)
        # two int32: room for a build that keeps a protein counter beside
        # its error flag
        self.flags = torch.empty(2, dtype=torch.int32, device=dev)
        self.kept = (torch.empty(max(n_tokens, 1), dtype=torch.int32,
                                 device=dev)
                     if n_roles > apply_flat.DIRECT_ROLES else None)
        self._cells = None

    def cells(self):
        from kmers_anno_tpu_torch.ops.vote import vote_block

        if self._cells is None:
            self._cells = torch.zeros(
                self.n_seqs * vote_block(self.n_seqs, self.n_roles),
                dtype=torch.int64, device=self.dev)
        return self._cells


def launch_flat_weighted(lib, table, codes, seg_ids, valid, k, max_probes,
                         n_seqs, n_roles, min_weight, scratch,
                         key_filter=None):
    """apply_weighted_flat through a kernel library's C entry point
    (uncounted): ``kan_flat_weighted`` once, with ``key_filter`` (None:
    every window walks), or on a build without it the earlier
    ``kan_apply_flat_weighted`` once a role block (no filter).  ``scratch``
    is a ``FlatScratch``."""
    from kmers_anno_tpu_torch.ops import apply_flat
    from kmers_anno_tpu_torch.ops.encode import PROT_PAD
    from kmers_anno_tpu_torch.ops.key_filter import filter_args
    from kmers_anno_tpu_torch.ops.vote import vote_block

    role = torch.empty(n_seqs, dtype=torch.int32, device=codes.device)
    best = torch.empty(n_seqs, dtype=torch.float32, device=codes.device)
    stream = torch.cuda.current_stream().cuda_stream
    if hasattr(lib, "kan_flat_weighted"):
        kept = scratch.kept
        err = lib.kan_flat_weighted(
            table.data_ptr(), table.shape[0], max_probes,
            *filter_args(key_filter), codes.data_ptr(),
            seg_ids.data_ptr(), valid.data_ptr(), codes.numel(), k, PROT_PAD,
            n_seqs, n_roles, apply_flat.DIRECT_ROLES, float(min_weight),
            scratch.starts.data_ptr(), scratch.flags.data_ptr(),
            None if kept is None else kept.data_ptr(), role.data_ptr(),
            best.data_ptr(), stream)
        require(err == 0, f"kan_flat_weighted returned CUDA error {err}")
        return tally_bits((role, best))
    r_blk = vote_block(n_seqs, n_roles)
    bases = range(0, n_roles, r_blk)
    for i, base in enumerate(bases):
        err = lib.kan_apply_flat_weighted(
            table.data_ptr(), table.shape[0], max_probes, codes.data_ptr(),
            seg_ids.data_ptr(), valid.data_ptr(), codes.numel(), k, PROT_PAD,
            n_seqs, base, r_blk, scratch.cells().data_ptr(), int(i == 0),
            int(i == len(bases) - 1), float(min_weight), role.data_ptr(),
            best.data_ptr(), stream)
        require(err == 0, f"kan_apply_flat_weighted returned CUDA error "
                f"{err}")
    return tally_bits((role, best))


# the entry points each launcher calls, this build's first
launch_flat.entry = ("kan_flat_unanimous", "kan_apply_flat")
launch_flat_weighted.entry = ("kan_flat_weighted", "kan_apply_flat_weighted")


def check_apply_flat(dev) -> None:
    """Both flat kernels against their plain versions on made-up streams,
    each with the table's key filter and without: k = 8 and 12, buckets
    with keys of one lo word and walks that wrap to bucket 0, proteins at
    and past ``n_seqs``, an all-invalid stream; the weighted step with
    uniform (ties) and fractional fp16 weights against the plain version's
    dense and role-block votes, and on ``WEIGHTED_EDGES`` (a 40,000-aa
    protein, 30,000 roles, float32 ties of unequal sums, zero weights,
    empty proteins, owner-round edges) with the shared tally at
    ``DIRECT_ROLES`` and at 5 roles (the kept hits swept in ranges), at
    min_weight 1.5 and 0.  One launch a call; a stream whose seg_ids
    decrease raises.  Exact equality, tallies bit for bit."""
    from kmers_anno_tpu_torch.ops import apply_flat as apply_flat_mod
    from kmers_anno_tpu_torch.ops import vote
    from kmers_anno_tpu_torch.ops.apply_flat import (
        apply_flat, apply_flat_plain, apply_weighted_flat,
        apply_weighted_flat_plain)

    rng = np.random.default_rng(SEED + 7)
    n_unanimous = n_weighted = 0
    limit, direct = vote.DENSE_VOTE_LIMIT, apply_flat_mod.DIRECT_ROLES

    def same(got, want):
        return all(torch.equal(g, w) for g, w in zip(got, want))

    try:
        for name, params in FLAT_EDGES.items():
            batch, table, mp = flat_case(rng, n_roles=5, **params)
            args = flat_tensors(batch, table, dev)
            filt = flat_filter(args[0])
            no_valid = (*args[:3], torch.zeros_like(args[3]))
            for a, n_seqs in ((args, batch.n_seqs),
                              (args, params["n_prot"] - 7),
                              (no_valid, batch.n_seqs)):
                kw = dict(k=params["k"], max_probes=mp, n_seqs=n_seqs)
                for min_hits in (1, 3):
                    want = apply_flat_plain(*a, min_hits, **kw)
                    for f in (None, filt):
                        got = apply_flat(*a, min_hits, **kw, key_filter=f)
                        require(same(got, want), f"apply_flat differs from "
                                f"its plain version ({name})")
                        n_unanimous += 1
            for weights in ("uniform", "fp16"):
                batch, table, mp = flat_case(rng, n_roles=9, weights=weights,
                                             **params)
                a = flat_tensors(batch, table, dev)
                filt = flat_filter(a[0])
                kw = dict(k=params["k"], max_probes=mp, n_seqs=batch.n_seqs,
                          n_roles=9)
                for r_blk in (9, 4, 1):
                    vote.DENSE_VOTE_LIMIT = batch.n_seqs * r_blk
                    want = tally_bits(apply_weighted_flat_plain(*a, 1.5,
                                                                **kw))
                    for f in (None, filt):
                        got = tally_bits(apply_weighted_flat(
                            *a, 1.5, **kw, key_filter=f))
                        require(same(got, want), f"apply_weighted_flat "
                                f"differs from its plain version ({name}, "
                                f"{weights}, blocks of {r_blk})")
                        n_weighted += 1
        vote.DENSE_VOTE_LIMIT = limit
        for name in WEIGHTED_EDGES:
            batch, table, mp, k, n_roles, expect = weighted_edge(rng, name)
            a = flat_tensors(batch, table, dev)
            filt = flat_filter(a[0])
            kw = dict(k=k, max_probes=mp, n_seqs=batch.n_seqs,
                      n_roles=n_roles)
            for min_weight in (1.5, 0.0):
                want = tally_bits(apply_weighted_flat_plain(
                    *a, min_weight, **kw))
                require(expect is None
                        or np.array_equal(want[0].cpu().numpy(), expect),
                        f"the plain weighted vote misses the calls of {name}")
                for apply_flat_mod.DIRECT_ROLES in (direct, 5):
                    for f in (None, filt):
                        before = apply_weighted_flat.launches
                        got = tally_bits(apply_weighted_flat(
                            *a, min_weight, **kw, key_filter=f))
                        require(apply_weighted_flat.launches == before + 1,
                                "a weighted call launched more than once")
                        require(same(got, want), f"apply_weighted_flat "
                                f"differs from its plain version ({name}, "
                                f"min_weight {min_weight}, tally of "
                                f"{apply_flat_mod.DIRECT_ROLES})")
                        n_weighted += 1
            apply_flat_mod.DIRECT_ROLES = direct
        shuffled = a[2].flip(0).contiguous()
        try:
            apply_weighted_flat(a[0], a[1], shuffled, a[3], 1.5, **kw)
        except ValueError:
            pass
        else:
            require(False, "a stream whose seg_ids decrease did not raise")
    finally:
        vote.DENSE_VOTE_LIMIT = limit
        apply_flat_mod.DIRECT_ROLES = direct
    print(f"flat apply kernels on made-up streams: {n_unanimous} apply_flat "
          f"and {n_weighted} apply_weighted_flat cases, with the key filter "
          f"and without, equal to their plain versions (tallies bit for "
          f"bit); a stream out of order raised", flush=True)


def flat_bound(table, codes, seg_ids, valid, k, max_probes, n_seqs,
               ms) -> dict:
    """A flat apply step's bound, each input read once: a flag byte a
    token, a code byte a token inside a protein (no valid window reads the
    padding after the last one), a hit's segment id (4 B), the 32-byte
    lo-key sector of every distinct bucket the lookups read and the hi-key
    and payload sectors of every distinct bucket holding a hit (64 B), the
    (role, count or tally) outputs (8 B a protein).  Operations: a rolling
    pack (``ROLL_PACK_OPS`` a token inside a protein), a valid window's
    hash, 16 a bucket read, 3 a hit's vote.  The weighted step's bound is
    the same one walk.  Neither counts the key filter, which the function
    does not need."""
    from kmers_anno_tpu_torch.ops.kmers import pack_kmer_windows

    seen = torch.zeros(table.shape[0], dtype=torch.bool, device=table.device)
    hit_seen = torch.zeros_like(seen)
    reads = hits = 0
    step = 1 << 24
    for s in range(0, codes.numel(), step):
        v = valid[s: s + step]
        lo, hi = pack_kmer_windows(codes[s: s + step + k - 1], k)
        _, r, h = bucket_reads(table, lo[: v.numel()], hi[: v.numel()], v,
                               max_probes, seen, hit_seen)
        reads += r
        hits += h
    n_valid = int(valid.sum())
    n_inside = int((seg_ids < n_seqs).sum())
    n_buckets, n_hit_buckets = int(seen.sum()), int(hit_seen.sum())
    n_bytes = (codes.numel() + n_inside + 4 * hits + 32 * n_buckets
               + HIT_BUCKET_BYTES * n_hit_buckets + 8 * n_seqs)
    n_ops = (ROLL_PACK_OPS * n_inside + HASH_KEY_OPS * n_valid
             + HASH_BUCKET_OPS * reads + FLAT_VOTE_OPS * hits)
    return dict(bound(n_bytes, n_ops, ms), buckets=n_buckets,
                hit_buckets=n_hit_buckets, bucket_reads=reads, hits=hits,
                windows=n_valid, tokens_inside=n_inside)


def proteins_of(codes: np.ndarray) -> list[str]:
    """(n, length) protein codes -> n strings, in one decode."""
    from kmers_anno_tpu_torch.ops.encode import decode_protein

    n, length = codes.shape
    text = decode_protein(codes.reshape(-1))
    return [text[i * length: (i + 1) * length] for i in range(n)]


def time_flat_step(kernel_fn, plain_fn, what, reps=REPS) -> dict:
    """One wrapper call and one call of the plain version, each timed by
    CUDA events (median of ``reps``); outputs equal, tallies bit for
    bit."""
    ms, got = timed(kernel_fn)
    plain_ms, want = timed(plain_fn, reps=reps)
    got, want = [tally_bits(o) if o[1].dtype == torch.float32 else o
                 for o in (got, want)]
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"{what} differs from its plain version")
    return dict(ms=ms, plain_ms=plain_ms,
                max_abs_err=max_abs_err(zip(got, want)), outputs=got)


def filter_stats(key_filter, codes, valid, k, hits, pack=None) -> dict:
    """What the key filter does on a stream whose windows hit the table
    ``hits`` times: its bytes, the windows it lets through to the walk and
    those it answers, and its false-positive share of the windows that
    miss (plain ``may_hold``).  ``pack`` packs the windows (default
    ``pack_kmer_windows``, protein codes)."""
    from kmers_anno_tpu_torch.ops.key_filter import may_hold
    from kmers_anno_tpu_torch.ops.kmers import pack_kmer_windows

    pack = pack or pack_kmer_windows
    passed = 0
    step = 1 << 24
    for s in range(0, codes.numel(), step):
        v = valid[s: s + step]
        lo, hi = pack(codes[s: s + step + k - 1], k)
        passed += int(may_hold(key_filter, lo[: v.numel()][v],
                               hi[: v.numel()][v]).sum())
    windows = int(valid.sum())
    return dict(filter_bytes=nbytes(key_filter), filter_passed=passed,
                filter_skipped=windows - passed,
                filter_fp_share=(passed - hits) / max(windows - hits, 1))


def filter_turns(what, launch, with_filter, without) -> dict:
    """This build's kernel with the key filter and without, in turns
    (with, without, without, with), each turn ``launch_ms``; outputs
    equal.  Returns each one's mean and turns (ms a pass)."""
    from kmers_anno_tpu_torch import kernels

    lib = kernels.lib()
    sets = {"with": with_filter, "without": without}
    outs = {n: [t for a in sets[n] for t in launch(lib, *a)] for n in sets}
    require(all(torch.equal(x, y)
                for x, y in zip(outs["with"], outs["without"])),
            f"the key filter changes the outputs on {what}")
    turns = {"with": [], "without": []}
    for n in ("with", "without", "without", "with"):
        turns[n].append(launch_ms(launch, sets[n], lib))
    means = {n: statistics.mean(t) for n, t in turns.items()}
    print(f"key filter in turns on {what} (ms a pass, with without without "
          f"with): with {means['with']:.4f} "
          f"({', '.join(f'{x:.4f}' for x in turns['with'])}), without "
          f"{means['without']:.4f} "
          f"({', '.join(f'{x:.4f}' for x in turns['without'])}); "
          f"{means['without'] / means['with']:.3f}x", flush=True)
    return dict(filtered_ms=means["with"], unfiltered_ms=means["without"],
                filter_turns=turns)


def make_big_workload():
    """The big-table cell's inputs: ``make_bench_workload``'s construction
    at 10M keys (seed 7) as a SignatureTable, and bench.py's 32 x 8,192
    proteins of 300 aa.  Returns (table, codes, proteins)."""
    from kmers_anno_tpu_torch.engine.signature import SignatureTable

    rng = np.random.default_rng(BENCH_SEED)
    protos, key_lo, key_hi, roles = make_bench_workload(rng, BIG_KEYS)
    codes = np.concatenate([make_bench_proteins(
        rng, protos, BENCH_PROTEINS, rng.integers(0, SIG_ROLES,
                                                  size=BENCH_PROTEINS))
        for _ in range(BENCH_BATCHES)])
    table = SignatureTable(k=K, key_lo=key_lo, key_hi=key_hi,
                           role_idx=roles,
                           role_ids=[f"Role{r}" for r in range(SIG_ROLES)])
    return table, codes, proteins_of(codes)


def run_big_table(dev, keep: dict) -> tuple[dict, dict, dict]:
    """BASELINE config 4's table size: ``make_bench_workload``'s construction
    at 10M keys (seed 7), an 8-slot table of about 403 MB with its key
    filter, and bench.py's 32 x 8,192 proteins of 300 aa
    through ``KmerApplyEngine.call_proteins`` as one FlatBatch.  Roles
    against ``native.apply_baseline`` on a sample, hits against the plain
    version on the card; proteins/s and a split of one run; what the
    filter answers, and both kernels with and without it in turns; the
    weighted step (fractional fp16 weights, one walk a call) on 8,192
    proteins and on all of them, bit for bit against its plain version
    (dense, and role blocks) on the card and against a CPU run on a
    sample.  Returns the runs' launches, both kernels' measurements and
    their ``--compare`` cases; leaves both tables, their engines and the
    proteins in ``keep["big"]`` for the mesh phase."""
    from kmers_anno_tpu_torch.engine.apply_engine import (FlatBatch,
                                                          KmerApplyEngine)
    from kmers_anno_tpu_torch.engine.signature import SignatureTable
    from kmers_anno_tpu_torch import native
    from kmers_anno_tpu_torch.ops.apply_flat import (
        apply_flat, apply_flat_plain, apply_weighted_flat,
        apply_weighted_flat_plain)
    from kmers_anno_tpu_torch.ops.vote import vote_block
    from kmers_anno_tpu_torch.ops.widetable import fits_wide

    gen_s, (table, codes, prots) = host_seconds(make_big_workload)
    key_lo, key_hi, roles, role_ids = (table.key_lo, table.key_hi,
                                       table.role_idx, table.role_ids)
    n = len(prots)
    require(not fits_wide(len(table)), "the big table fits one wide table")
    engine_s, engine = host_seconds(
        lambda: KmerApplyEngine(table, min_hits=MIN_HITS, device=dev))
    filter_s, _ = host_seconds(lambda: table.device_key_filter(device=dev))
    keep["big"] = dict(table=table, engine=engine, prots=prots)
    mp = engine.max_probes
    key_filter = engine.key_filter
    require(engine.mode == "flat" and key_filter is not None,
            f"the big table took mode {engine.mode}")
    n_buckets = engine.table.shape[0]
    with _Launches() as run:
        got = engine.call_proteins(prots)
    routes = {"big": dict(launches=run.counts)}
    require(run.counts["apply_flat"] == 1 and run.counts["apply_rows"] == 0,
            f"the big table's call_proteins launches {run.counts}")
    index = {rid: i for i, rid in enumerate(role_ids)}
    got_roles = np.array([index[c[0]] if c else -1 for c in got], np.int32)
    table8 = engine.table.cpu().numpy().view(np.uint32)
    sample = np.arange(0, n, BIG_BASELINE_EVERY)
    base_s, want_roles = host_seconds(lambda: native.apply_baseline(
        codes[sample], table8, mp, K, MIN_HITS))
    require(np.array_equal(got_roles[sample], want_roles),
            f"{int((got_roles[sample] != want_roles).sum())} big-table roles "
            "differ from native.apply_baseline")
    n_called = int((got_roles >= 0).sum())
    print(f"big table: {len(key_lo)} keys of {SIG_ROLES} roles (made in "
          f"{gen_s:.1f} s), {n_buckets} buckets ({engine.table.numel() * 4} "
          f"B on the card, max_probes {mp}) and a {nbytes(key_filter)}-B key "
          f"filter, built and uploaded in {engine_s:.2f} s (the filter "
          f"alone {filter_s:.4f} s); {n} proteins "
          f"({BENCH_BATCHES} x {BENCH_PROTEINS} x {PROT_LEN} aa), "
          f"{n_called} called; roles of {len(sample)} (every "
          f"{BIG_BASELINE_EVERY}th) equal to native.apply_baseline "
          f"({base_s:.2f} s single-core); launches {run.counts}", flush=True)

    times = [host_seconds(lambda: engine.call_proteins(prots))[0]
             for _ in range(REPS)]
    rates = sorted(n / t for t in times)
    t0 = time.perf_counter()
    batch = FlatBatch(prots, K)
    flat_s = time.perf_counter() - t0
    upload_s, stream = host_seconds(lambda: [
        torch.from_numpy(a).to(dev)
        for a in (batch.codes, batch.seg_ids, batch.valid)])
    kw = dict(k=K, max_probes=mp, n_seqs=batch.n_seqs)
    fkw = dict(kw, key_filter=key_filter)
    args = (engine.table, *stream)
    kernel_s, out = host_seconds(lambda: apply_flat(*args, MIN_HITS, **fkw))
    download_s, (r, h) = host_seconds(
        lambda: [o.cpu().numpy()[:n] for o in out])
    t0 = time.perf_counter()
    decoded = engine._decode(r, h)
    decode_s = time.perf_counter() - t0
    require(decoded == got, "the split run's calls differ")
    print(f"big table call_proteins: {statistics.median(rates):.1f} "
          f"proteins/s (median of {REPS}, range {rates[0]:.1f}-"
          f"{rates[-1]:.1f}; s per run {', '.join(f'{t:.4f}' for t in times)}"
          f"); split of one more run: host FlatBatch {flat_s:.4f} s "
          f"({batch.codes.size} tokens, {batch.n_seqs} segments), upload "
          f"{upload_s:.4f} s, kernel {kernel_s:.4f} s, download "
          f"{download_s:.4f} s, decode {decode_s:.4f} s", flush=True)

    flat = time_flat_step(
        lambda: apply_flat(*args, MIN_HITS, **fkw),
        lambda: apply_flat_plain(*args, MIN_HITS, **kw),
        "apply_flat on the big-table batch")
    require(np.array_equal(flat.pop("outputs")[0].cpu().numpy()[:n],
                           got_roles), "the kernel's roles differ from the "
            "engine's")
    flat.update(flat_bound(engine.table, *stream, K, mp, batch.n_seqs,
                           flat["ms"]))
    flat.update(filter_stats(key_filter, stream[0], stream[2], K,
                             flat["hits"]))
    flat_args = [(engine.table, *stream, K, mp, batch.n_seqs, MIN_HITS,
                  key_filter)]
    flat = with_launch(flat, launch_ms(launch_flat, flat_args))
    flat["lookups_per_s"] = flat["windows"] / flat["launch_ms"] * 1e3
    print(f"big table apply_flat ({stream[0].numel()} tokens, "
          f"{flat['tokens_inside']} inside proteins, {flat['windows']} "
          f"windows, {flat['bucket_reads']} bucket reads, {flat['hits']} "
          f"hits, {flat['buckets']} distinct buckets, {flat['hit_buckets']} "
          f"of them with a hit), exact "
          f"(role, hits) against its plain version: kernel {flat['ms']:.4f} "
          f"ms through the wrapper, {flat['launch_ms']:.4f} ms a launch back "
          f"to back ({flat['lookups_per_s']:.4e} kmer lookups/s), plain "
          f"{flat['plain_ms']:.4f} ms; bound {flat['bound_ms']:.4f} ms "
          f"({flat['bound_by']}, {flat['bound_bytes']} bytes, "
          f"{flat['bound_ops']} ops), share {flat['bound_share']:.3f}, back "
          f"to back {flat['launch_share']:.3f}", flush=True)
    print(f"big table key filter: {flat['filter_bytes']} B "
          f"({flat['filter_bytes'] * 8 / len(key_lo):.2f} bits a key), built "
          f"in {filter_s:.4f} s; of {flat['windows']} windows "
          f"{flat['filter_skipped']} skip the walk and "
          f"{flat['filter_passed']} walk ({flat['hits']} hits); "
          f"false-positive share of the misses "
          f"{flat['filter_fp_share']:.6f}", flush=True)
    flat.update(filter_turns(
        "the big-table batch (apply_flat)", launch_flat, flat_args,
        [a[:-1] + (None,) for a in flat_args]))
    cases = {"the big-table batch": (launch_flat, flat_args)}
    del out, r, h

    # -- the weighted step: fractional fp16 weights --
    w_rng = np.random.default_rng(BENCH_SEED)
    weights = w_rng.uniform(0.05, 3.0, len(key_lo)).astype(
        np.float16).astype(np.float32)
    w_table = SignatureTable(k=K, key_lo=key_lo, key_hi=key_hi,
                             role_idx=roles, role_ids=role_ids,
                             weights=weights)
    w_engine = KmerApplyEngine(w_table, min_hits=MIN_HITS, weighted=True,
                               device=dev)
    require(w_engine.mode == "flat", "the weighted big table is not flat")
    keep["big"].update(w_table=w_table, w_engine=w_engine)
    require(torch.equal(w_engine.key_filter, key_filter),
            "the weighted table's key filter differs")
    dense_prots = prots[:BENCH_PROTEINS]
    with _Launches() as run:
        w_engine.call_proteins(dense_prots)
    routes["big_dense"] = dict(launches=run.counts)
    require(run.counts["apply_flat_weighted"] == 1,
            f"the dense weighted call launches {run.counts}")
    with _Launches() as run:
        w_got = w_engine.call_proteins(prots)
    routes["big_weighted"] = dict(launches=run.counts)
    # one walk a call: the plain version would take 16 role blocks
    r_blk = vote_block(batch.n_seqs, SIG_ROLES)
    require(run.counts["apply_flat_weighted"] == 1 < SIG_ROLES // r_blk
            and run.counts["apply_flat"] == 0,
            f"the weighted big-table call launches {run.counts}, expected "
            f"one walk")
    w_kw = dict(k=K, max_probes=w_engine.max_probes, n_seqs=batch.n_seqs,
                n_roles=SIG_ROLES)
    w_fkw = dict(w_kw, key_filter=key_filter)
    w_args = (w_engine.table, *stream)
    w_s = [host_seconds(lambda: w_engine.call_proteins(prots))[0]
           for _ in range(3)]

    weighted = time_flat_step(
        lambda: apply_weighted_flat(*w_args, float(MIN_HITS), **w_fkw),
        lambda: apply_weighted_flat_plain(*w_args, float(MIN_HITS), **w_kw),
        "apply_weighted_flat on the big-table batch", reps=3)
    w_role, w_bits = (o.cpu().numpy()[:n] for o in weighted.pop("outputs"))
    w_tally = w_bits.view(np.float32)
    frac = w_tally[w_role >= 0]
    require((w_role >= 0).any() and (frac != np.round(frac)).any(),
            "the weighted check saw no fractional tally")
    require([(role_ids[a], round(float(b), 4)) if a >= 0 else None
             for a, b in zip(w_role, w_tally)] == w_got,
            "the weighted kernel's calls differ from the engine's")
    # a CPU run of the plain version on a sample, bit for bit
    pick = list(range(0, n, n // WEIGHTED_SAMPLE))
    cpu_batch = FlatBatch([prots[i] for i in pick], K)
    cpu = apply_weighted_flat_plain(
        w_engine.table.cpu(), *(torch.from_numpy(a) for a in (
            cpu_batch.codes, cpu_batch.seg_ids, cpu_batch.valid)),
        float(MIN_HITS), **dict(w_kw, n_seqs=cpu_batch.n_seqs))
    require(np.array_equal(cpu[0].numpy()[:len(pick)], w_role[pick])
            and np.array_equal(cpu[1].numpy()[:len(pick)].view(np.int32),
                               w_bits[pick]),
            "the weighted step on the card differs from its CPU run")
    w_launch = [(*w_args, K, w_engine.max_probes, batch.n_seqs, SIG_ROLES,
                 float(MIN_HITS),
                 FlatScratch(batch.codes.size, batch.n_seqs, SIG_ROLES, dev),
                 key_filter)]
    # the same keys in the same buckets: the unweighted step's lookups
    require(w_engine.max_probes == mp, "the weighted table walks otherwise")
    weighted.update(bound(flat["bound_bytes"], flat["bound_ops"],
                          weighted["ms"]))
    weighted = with_launch(weighted, launch_ms(launch_flat_weighted,
                                               w_launch))
    weighted["launches_a_call"] = 1
    weighted.update(filter_turns(
        "the big-table batch (apply_weighted_flat)", launch_flat_weighted,
        w_launch, [a[:-1] + (None,) for a in w_launch]))
    # the dense shape: the first 8,192 proteins
    d_batch = FlatBatch(dense_prots, K)
    d_stream = [torch.from_numpy(a).to(dev)
                for a in (d_batch.codes, d_batch.seg_ids, d_batch.valid)]
    d_kw = dict(w_kw, n_seqs=d_batch.n_seqs)
    require(vote_block(d_batch.n_seqs, SIG_ROLES) == SIG_ROLES,
            "the 8,192-protein weighted call is not dense")
    dense = time_flat_step(
        lambda: apply_weighted_flat(w_engine.table, *d_stream,
                                    float(MIN_HITS), **d_kw,
                                    key_filter=key_filter),
        lambda: apply_weighted_flat_plain(
            w_engine.table, *d_stream, float(MIN_HITS), **d_kw),
        "apply_weighted_flat on the dense batch")
    d_role, d_bits = (o.cpu().numpy()[:BENCH_PROTEINS]
                      for o in dense.pop("outputs"))
    require(np.array_equal(d_role, w_role[:BENCH_PROTEINS])
            and np.array_equal(d_bits, w_bits[:BENCH_PROTEINS]),
            "the dense and the whole batch's weighted votes differ")
    d_launch = [(w_engine.table, *d_stream, K, w_engine.max_probes,
                 d_batch.n_seqs, SIG_ROLES, float(MIN_HITS),
                 FlatScratch(d_batch.codes.size, d_batch.n_seqs, SIG_ROLES,
                             dev), key_filter)]
    weighted.update(dense_ms=dense["ms"], dense_plain_ms=dense["plain_ms"],
                    dense_launch_ms=launch_ms(launch_flat_weighted, d_launch))
    # one 40,000-aa protein (134 of the others end to end) after the dense
    # batch: a single block walks it
    long_prot = "".join(prots[BENCH_PROTEINS: BENCH_PROTEINS + 134])[:40_000]
    l_batch = FlatBatch(dense_prots + [long_prot], K)
    l_stream = [torch.from_numpy(a).to(dev)
                for a in (l_batch.codes, l_batch.seg_ids, l_batch.valid)]
    l_kw = dict(w_kw, n_seqs=l_batch.n_seqs)
    got = tally_bits(apply_weighted_flat(w_engine.table, *l_stream,
                                         float(MIN_HITS), **l_kw,
                                         key_filter=key_filter))
    want = tally_bits(apply_weighted_flat_plain(
        w_engine.table, *l_stream, float(MIN_HITS), **l_kw))
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            "apply_weighted_flat differs from its plain version on the "
            "dense batch with a 40,000-aa protein")
    weighted["long_launch_ms"] = launch_ms(launch_flat_weighted, [(
        w_engine.table, *l_stream, K, w_engine.max_probes, l_batch.n_seqs,
        SIG_ROLES, float(MIN_HITS),
        FlatScratch(l_batch.codes.size, l_batch.n_seqs, SIG_ROLES, dev),
        key_filter)])
    print(f"big table weighted (fp16 weights from U[0.05, 3.0], seed "
          f"{BENCH_SEED}): {int((w_role >= 0).sum())} of {n} called, "
          f"{int((frac != np.round(frac)).sum())} fractional tallies; "
          f"call_proteins {n / statistics.median(w_s):.1f} proteins/s "
          f"(median of 3); one walk a call (the plain version: "
          f"{-(-SIG_ROLES // r_blk)} role blocks of {r_blk}): kernel "
          f"{weighted['ms']:.4f} ms a call through the wrapper, "
          f"{weighted['launch_ms']:.4f} ms a call back to back "
          f"(one launch), plain {weighted['plain_ms']:.4f} ms, "
          f"bit for bit; bound {weighted['bound_ms']:.4f} ms "
          f"({weighted['bound_by']}), share {weighted['bound_share']:.3f}, "
          f"back to back {weighted['launch_share']:.3f}; dense on "
          f"{BENCH_PROTEINS} proteins ({d_batch.codes.size} tokens): kernel "
          f"{dense['ms']:.4f} ms, "
          f"{weighted['dense_launch_ms']:.4f} ms back to back, plain "
          f"{dense['plain_ms']:.4f} ms, bit for bit and equal to the whole "
          f"batch's calls; with a 40,000-aa protein after it "
          f"{weighted['long_launch_ms']:.4f} ms back to back, bit for bit; "
          f"the card's calls equal a CPU run of the plain "
          f"version on {len(pick)} proteins bit for bit", flush=True)
    cases["the big-table weighted batch"] = (launch_flat_weighted, w_launch)
    return routes, {"apply_flat": flat, "apply_flat_weighted": weighted}, cases


def time_sliced_walks(dev) -> dict:
    """bench.py's big-table shape (bench.py:326-345: 10M random keys of 59
    bits, 4M queries of table keys, seed 7): the plain-torch sliced probe
    in payload mode, on the probe-window layout the reference gives it,
    against the apply kernel's walk of the same queries on the plain table.
    Each query is laid out as the 12 codes of a k=12
    window (its lo and hi words cut into 5-bit fields), the windows 12
    tokens apart and only their starts valid, so the kernel walks exactly
    these keys; all segment ids are padding, so it counts nothing.  The
    walk's values are checked through a run that gives each query its own
    protein (min_hits 1: the called role is the stored value)."""
    from kmers_anno_tpu_torch.engine.convert import wide_table_from_numpy
    from kmers_anno_tpu_torch.ops.hashtable import build_table, probe_table
    from kmers_anno_tpu_torch.ops.apply_flat import apply_flat
    from kmers_anno_tpu_torch.ops.sliced_probe import (probe_table_sliced,
                                                       windowed_table)

    rng = np.random.default_rng(BENCH_SEED)
    combined = np.unique(rng.integers(0, 1 << 59, BIG_KEYS + 200_000,
                                      dtype=np.uint64))[:BIG_KEYS]
    key_lo = (combined & np.uint64(0x3FFFFFFF)).astype(np.uint32)
    key_hi = (combined >> np.uint64(30)).astype(np.uint32)
    vals = rng.integers(0, SIG_ROLES, len(key_lo), dtype=np.int64)
    table, mp = build_table(key_lo, key_hi, vals.astype(np.uint32))
    q = rng.integers(0, len(key_lo), BIG_QUERIES)
    qlo, qhi = key_lo[q], key_hi[q]
    d_plain = wide_table_from_numpy(table, dev)
    d_win = wide_table_from_numpy(windowed_table(table, mp), dev)
    lo = torch.from_numpy(qlo.view(np.int32)).to(dev)
    hi = torch.from_numpy(qhi.view(np.int32)).to(dev)
    valid = torch.ones(BIG_QUERIES, dtype=torch.bool, device=dev)
    seg = torch.arange(BIG_QUERIES, dtype=torch.int32, device=dev) >> 6
    sliced_ms, (s_val, s_seg) = timed(lambda: probe_table_sliced(
        d_win, lo, hi, valid, mp, payload=seg))
    want = probe_table(d_plain, lo, hi, valid, mp)
    require(torch.equal(torch.sort(s_val).values, torch.sort(want).values)
            and bool((want >= 0).all()),
            "the sliced probe's values differ from probe_table's")
    # the queries as k=12 windows, 12 tokens apart
    fields = [(w >> np.uint32(5 * j)) & np.uint32(31)
              for w in (qlo, qhi) for j in range(6)]
    codes = torch.from_numpy(np.stack(fields, 1).astype(np.uint8).reshape(
        -1)).to(dev)
    starts = torch.zeros(codes.numel(), dtype=torch.bool, device=dev)
    starts[::12] = True
    pad_seg = torch.ones(codes.numel(), dtype=torch.int32, device=dev)
    own = torch.arange(codes.numel(), dtype=torch.int32, device=dev) // 12
    role, _ = apply_flat(d_plain, codes, own, starts, 1, k=12, max_probes=mp,
                         n_seqs=BIG_QUERIES)
    require(torch.equal(role, want),
            "the kernel's walk of the table differs from probe_table")
    walk_ms = launch_ms(launch_flat, [(d_plain, codes, pad_seg, starts, 12,
                                       mp, 1, 1)])
    print(f"sliced probe on bench.py's big-table shape ({len(key_lo)} keys, "
          f"{table.shape[0]} buckets, {table.nbytes} B, max_probes {mp}; "
          f"{BIG_QUERIES} queries, all hits): plain-torch probe_table_sliced "
          f"(payload mode, probe windows of {mp}) {sliced_ms:.4f} ms "
          f"({BIG_QUERIES / sliced_ms * 1e3:.4e} lookups/s); the apply "
          f"kernel's walk of the same queries on the plain table "
          f"{walk_ms:.4f} ms ({BIG_QUERIES / walk_ms * 1e3:.4e} lookups/s); "
          f"values equal to probe_table", flush=True)
    return dict(sliced_ms=sliced_ms, walk_ms=walk_ms)


def run_big_kdb_cli(dev, tmp: str, ctx: dict) -> dict:
    """``apply --format VERIFY`` through the CLI on the signature genomes
    with a ``.kdb`` of KDB_KEYS keys: the CLI build's table plus random
    kmers absent from every peg's windows, with roles drawn from the
    table's own.  The engine must take the flat route (an 8-slot table of
    about 100 MB), and the report must equal the wide route's byte for
    byte."""
    from kmers_anno_tpu_torch.commands.app import main
    from kmers_anno_tpu_torch.engine import signature
    from kmers_anno_tpu_torch.ops.kmers import pack_kmers_np
    from kmers_anno_tpu_torch.ops.widetable import fits_wide

    t0 = time.perf_counter()
    base = ctx["table"]
    lo, hi, _ = signature._flat_protein_keys(
        [f.protein_translation for g in ctx["genomes"] for f in g.pegs
         if f.protein_translation], K)

    def keys(lo_, hi_):
        return (hi_.astype(np.uint64) << np.uint64(32)) | lo_

    have = np.unique(np.concatenate([keys(lo, hi),
                                     keys(base.key_lo, base.key_hi)]))
    rng = np.random.default_rng(SEED + 9)
    n_fill = KDB_KEYS - len(base)
    flo, fhi = pack_kmers_np(rng.integers(0, 20, n_fill * 5 // 4 + K - 1
                                          ).astype(np.uint8), K)
    fill = np.unique(keys(flo, fhi))
    fill = fill[~np.isin(fill, have)]
    fill = fill[rng.permutation(len(fill))[:n_fill]]
    require(len(fill) == n_fill, "too few fill keys for the .kdb")
    big = signature.SignatureTable(
        k=K, key_lo=np.concatenate([base.key_lo, (fill & np.uint64(
            0xFFFFFFFF)).astype(np.uint32)]),
        key_hi=np.concatenate([base.key_hi, (fill >> np.uint64(32)).astype(
            np.uint32)]),
        role_idx=np.concatenate([base.role_idx,
                                 rng.choice(base.role_idx, n_fill)]),
        role_ids=base.role_ids)
    require(not fits_wide(len(big)), "the .kdb fits one wide table")
    kdb = ctx["kdb"] = os.path.join(tmp, "big.kdb")
    big.save(kdb)
    make_s = time.perf_counter() - t0
    out = os.path.join(tmp, "verify_big.tbl")
    t0 = time.perf_counter()
    with _Launches() as run:
        rc = main(["apply", "--format", "VERIFY", "-m", str(MIN_HITS),
                   "--device", str(dev), "-o", out, kdb, ctx["use_file"],
                   ctx["gto_dir"]])
    cold_s = time.perf_counter() - t0
    require(rc == 0, f"apply on the .kdb exited with {rc}")
    require(run.counts["apply_flat"] == SIG_GENOMES
            and run.counts["apply_rows"] == 0,
            f"apply on the .kdb launches {run.counts}")
    same = open(out, "rb").read() == open(ctx["verify"], "rb").read()
    require(same, "the .kdb's VERIFY report differs from the wide route's")
    print(f"apply --format VERIFY (CLI) on a {len(big)}-key .kdb (the "
          f"build's {len(base)} kmers and {n_fill} absent from every peg, "
          f"made in {make_s:.2f} s): the flat route, one apply_flat launch "
          f"a genome; report byte "
          f"for byte equal to the wide route's; {cold_s:.2f} s cold "
          f"(table load and build, GTO load); launches {run.counts}",
          flush=True)
    kdb_filter(dev, big, ctx)
    return {"big_cli": dict(launches=run.counts)}


def kdb_filter(dev, big, ctx) -> dict:
    """The key filter on the ``.kdb`` table: every peg of the CLI genomes
    as one FlatBatch through ``apply_flat``, with the filter and without
    in turns; the filter's size, build seconds and false-positive share."""
    from kmers_anno_tpu_torch.engine.apply_engine import FlatBatch
    from kmers_anno_tpu_torch.ops.kmers import pack_kmer_windows

    table_s, (table, mp) = host_seconds(lambda: big.device_table(device=dev))
    filter_s, key_filter = host_seconds(
        lambda: big.device_key_filter(device=dev))
    batch = FlatBatch([f.protein_translation for g in ctx["genomes"]
                       for f in g.pegs if f.protein_translation], K)
    stream = [torch.from_numpy(a).to(dev)
              for a in (batch.codes, batch.seg_ids, batch.valid)]
    lo, hi = pack_kmer_windows(stream[0], K)
    _, _, hits = bucket_reads(table, lo, hi, stream[2], mp)
    stats = filter_stats(key_filter, stream[0], stream[2], K, hits)
    print(f".kdb key filter: {stats['filter_bytes']} B for {len(big)} keys "
          f"(the table {table.numel() * 4} B, built and uploaded in "
          f"{table_s:.4f} s), built and uploaded in {filter_s:.4f} s; of "
          f"{int(stream[2].sum())} windows of {batch.n_seqs} segments "
          f"{stats['filter_skipped']} skip the walk and "
          f"{stats['filter_passed']} walk ({hits} hits); false-positive "
          f"share of the misses {stats['filter_fp_share']:.6f}", flush=True)
    args = [(table, *stream, K, mp, batch.n_seqs, MIN_HITS, key_filter)]
    return dict(stats, **filter_turns(
        "the .kdb table (apply_flat, every peg)", launch_flat, args,
        [a[:-1] + (None,) for a in args]))


# ---------------------------------------------------------------------------
# kernels D and E: hashAnno's chunk step
# ---------------------------------------------------------------------------

def _variant(rng, seq: np.ndarray, n_sub: int) -> np.ndarray:
    out = seq.copy()
    pos = rng.integers(0, len(out), n_sub)
    out[pos] = rng.integers(0, 20, n_sub)
    return out


def made_up_chunk(rng, k, n_prot, n_rows, plen=90, family=1, squeeze=False,
                  exact_cols=False, min_score=0.0125):
    """A genome batch's protein index and one chunk of prototypes, as the
    hashAnno engine builds them (on the CPU), for the chunk kernels.

    ``n_prot`` proteins come in families of ``family`` three-substitution
    variants of one sequence (a kmer of a family has up to ``family``
    owners; past ``OWNER_CAP`` the owner rows are full); ``n_rows``
    prototypes are 0-7-substitution variants of random proteins, one in
    eight random.  ``squeeze`` rebuilds the 8-slot table with one bucket
    per 7 keys, so lookups walk; ``exact_cols`` gives ``n_pad`` =
    ``n_prot`` (columns off any power of two) instead of the engine's
    bucket.  Returns a dict of CPU tensors and ints: table, max_probes,
    owner_mat, lo, hi, proto, valid (the chunk's kmers), n_rows, n_pad,
    n1, n2, minc."""
    from kmers_anno_tpu_torch.engine.hashanno import (GenomeProteinKmers,
                                                      Prototype, PrototypeSet)
    from kmers_anno_tpu_torch.engine.projection import _min_ev_table
    from kmers_anno_tpu_torch.ops.hashtable import BUCKET, EMPTY, build_table

    aa = np.frombuffer(AA.encode(), np.uint8)
    pool = rng.integers(0, 20, (max(n_prot // family, 1), plen))
    seqs = [_variant(rng, pool[i % len(pool)], 3) for i in range(n_prot)]
    gk = GenomeProteinKmers(k, min_score, device="cpu")
    for i, s in enumerate(seqs):
        gk.add_protein(f"p{i}", aa[s].tobytes().decode(), "old")
    gk._build()
    protos = []
    for i in range(n_rows):
        src = (rng.integers(0, 20, plen) if i % 8 == 7
               else _variant(rng, seqs[int(rng.integers(0, n_prot))],
                             int(rng.integers(0, 8))))
        protos.append(Prototype(aa[src].tobytes().decode(), f"a{i}"))
    lo, hi, proto, valid, _, _, _, n2 = PrototypeSet(protos, k).chunks(
        n_rows, "cpu")[0]
    table = gk.table.numpy().view(np.uint32)
    max_probes = gk.max_probes
    if squeeze:
        used = table[:, :BUCKET] != EMPTY
        keys = (table[:, :BUCKET][used], table[:, BUCKET: 2 * BUCKET][used],
                table[:, 2 * BUCKET:][used])
        n_buckets = 1 << (-(-len(keys[0]) // 7) - 1).bit_length()
        table, max_probes = build_table(*keys, n_buckets=n_buckets)
    n_pad = len(seqs) if exact_cols else gk.n_pad
    n1 = np.zeros(n_pad, np.int32)
    n1[:n_prot] = gk.protein_kmer_counts
    return dict(
        table=torch.from_numpy(table.view(np.int32).copy()),
        max_probes=max_probes, owner_mat=gk.owner_mat, lo=lo, hi=hi,
        proto=proto, valid=valid, n_rows=n_rows, n_pad=n_pad,
        n1=torch.from_numpy(n1), n2=n2,
        minc=torch.from_numpy(_min_ev_table(min_score, 4 * plen + 1024)))


def carried_state(rng, n_pad, device="cpu"):
    """A best-proposal state (c, u, index, improvements) as earlier chunks
    leave it: a third of the proteins carry a best c / u."""
    c = rng.integers(1, 40, n_pad).astype(np.int32)
    u = c + rng.integers(0, 300, n_pad).astype(np.int32)
    none = rng.random(n_pad) < 2 / 3
    c[none], u[none] = 0, 1
    i = np.where(none, -1, rng.integers(0, 5000, n_pad)).astype(np.int32)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (c, u, i, np.array([17], np.int32)))


CHUNK_ORDERS = ("engine", "shuffled", "key-major")


def reorder_chunk(c: dict, order: str, rng=None) -> tuple[dict, torch.Tensor]:
    """Chunk ``c`` with its kmers in another order, and the permutation
    (``new[j] = old[perm[j]]``): "engine" as the engine packs it
    (prototype by prototype, key order within a prototype, prototypes that
    share their smallest kmer side by side), "shuffled" a seeded
    permutation of every position (``rng``), "key-major" the valid kmers
    by key, then prototype (equal kmers adjacent), padding last."""
    n = c["lo"].numel()
    if order == "engine":
        perm = np.arange(n)
    elif order == "shuffled":
        perm = rng.permutation(n)
    elif order == "key-major":
        key = ((c["hi"].cpu().numpy().view(np.uint32).astype(np.uint64)
                << np.uint64(32))
               | c["lo"].cpu().numpy().view(np.uint32).astype(np.uint64))
        perm = np.lexsort((c["proto"].cpu().numpy(), key,
                           ~c["valid"].cpu().numpy()))
    else:
        raise ValueError(f"unknown chunk order {order!r}")
    perm = torch.from_numpy(perm).to(c["lo"].device)
    return dict(c, **{k: c[k][perm] for k in ("lo", "hi", "proto",
                                               "valid")}), perm


def tile_cells(c: dict, ranks: torch.Tensor) -> torch.Tensor:
    """The distinct count cells (prototype row, owner) of each tile of
    ``COMMONS_TILE`` chunk kmers, as ``kan_hash_commons`` counts them
    (``ranks``: each kmer's probed rank).  A tile with at most
    ``COMMONS_TABLE_CELLS`` makes one global add a cell; a tile with more
    spills the counts of its later cells straight to the matrix."""
    from kmers_anno_tpu_torch.ops.hash_chunk import COMMONS_TILE

    n_rows, n_pad = c["n_rows"], c["n_pad"]
    own = c["owner_mat"][torch.clamp(ranks, min=0).long()].long()
    keep = (((ranks >= 0) & (c["proto"] >= 0)
             & (c["proto"] < n_rows))[:, None] & (own < n_pad))
    tile = (torch.arange(ranks.numel(), device=ranks.device)
            // COMMONS_TILE)[:, None].expand_as(own)[keep]
    cell = (c["proto"].long()[:, None] * n_pad + own)[keep]
    n_cells = max(n_rows * n_pad, 1)
    first = torch.unique(tile * n_cells + cell) // n_cells
    return torch.bincount(first, minlength=-(-ranks.numel() // COMMONS_TILE))


def bucket_reads(table, lo, hi, valid, max_probes, seen=None,
                 hit_seen=None) -> tuple[int, int, int]:
    """What this run's lookups need from an 8-slot table: (distinct
    buckets whose lo keys they read, bucket reads, hits).  A key walks
    from its home bucket until its bucket is found, a bucket has a free
    slot, or ``max_probes`` buckets are read.  ``seen``, a (buckets,) bool
    tensor, gathers the buckets read over several calls; ``hit_seen``, when
    given, the buckets holding a hit."""
    from kmers_anno_tpu_torch.ops.hashing import mix_kmer
    from kmers_anno_tpu_torch.ops.hashtable import BUCKET, EMPTY

    empty = int(EMPTY.view(np.int32))
    mask = table.shape[0] - 1
    if seen is None:
        seen = torch.zeros(table.shape[0], dtype=torch.bool,
                           device=table.device)
    reads = hits = 0
    lo, hi, valid = lo.reshape(-1), hi.reshape(-1), valid.reshape(-1)
    for s in range(0, lo.numel(), 1 << 22):
        v = valid[s: s + (1 << 22)]
        qlo, qhi = lo[s: s + (1 << 22)][v], hi[s: s + (1 << 22)][v]
        b = mix_kmer(qlo, qhi) & mask
        for _ in range(max_probes):
            if not b.numel():
                break
            seen[b] = True
            reads += b.numel()
            rows = table[b]
            hit = ((rows[:, :BUCKET] == qlo[:, None])
                   & (rows[:, BUCKET: 2 * BUCKET] == qhi[:, None])).any(1)
            hits += int(hit.sum())
            if hit_seen is not None:
                hit_seen[b[hit]] = True
            go = ~hit & (rows[:, :BUCKET] != empty).all(1)
            qlo, qhi, b = qlo[go], qhi[go], (b[go] + 1) & mask
    return int(seen.sum()), reads, hits


HASH_KEY_OPS = 14               # a key's two fmix32 and the mask
HASH_BUCKET_OPS = 16            # 8 lo compares and 8 free-slot tests
HASH_OWNER_OPS = 2              # an owner's bound test and its count
HASH_CELL_OPS = 2               # a count's load and zero test
HASH_COUNT_OPS = 10             # a non-zero count's floor and compare


def hash_commons_bound(c, ranks, n_touched, ms) -> dict:
    """hash_commons's bound, each input read once: 13 B a chunk kmer (lo,
    hi, prototype, flag), the 32 B of lo keys of every distinct bucket the
    lookups read, a hit's hi and payload words (8 B), 4 B an owner slot of
    every distinct owner row the hits name (``ranks``, the probed rank of
    each chunk kmer), and 4 B a count-matrix cell this chunk's data writes
    (``n_touched``, the non-zero cells: the buffer comes zeroed, so no
    other cell need be written); the operations above, per lookup."""
    buckets, reads, hits = bucket_reads(c["table"], c["lo"], c["hi"],
                                        c["valid"], c["max_probes"])
    cap = c["owner_mat"].shape[1]
    owner_rows = int(torch.unique(ranks[ranks >= 0]).numel())
    n_bytes = (13 * c["lo"].numel() + 32 * buckets + HIT_BYTES * hits
               + 4 * cap * owner_rows + 4 * n_touched)
    n_ops = (HASH_KEY_OPS * int(c["valid"].sum()) + HASH_BUCKET_OPS * reads
             + HASH_OWNER_OPS * cap * hits)
    return dict(bound(n_bytes, n_ops, ms), buckets=buckets,
                bucket_reads=reads, hits=hits, owner_rows=owner_rows)


def hash_best_bound(c, n_nonzero, ms) -> dict:
    """hash_best's bound: each count read once (4 B a cell) and each
    non-zero count cleared (4 B), n1, n2 and the minc table read once, the
    state (c, u, index) read and written once; the operations above."""
    n_pad, n_rows = c["n_pad"], c["n_rows"]
    n_bytes = (4 * n_rows * n_pad + 4 * n_nonzero + 4 * n_pad + 4 * n_rows
               + nbytes(c["minc"]) + 2 * 12 * n_pad)
    n_ops = HASH_CELL_OPS * n_rows * n_pad + HASH_COUNT_OPS * n_nonzero
    return bound(n_bytes, n_ops, ms)


def hash_chunk_args(c):
    return (c["table"], c["max_probes"], c["owner_mat"], c["lo"], c["hi"],
            c["proto"], c["valid"], c["n_rows"], c["n_pad"])


def commons_orders(c: dict, what: str, total: int) -> tuple[dict, dict]:
    """``hash_commons`` on chunk ``c`` (tensors on the card) in the
    engine's order and key-major: the key-major counts and ranks equal to
    the plain version's; for each order the distinct cells of each kernel
    tile (one global add a cell where the tile keeps them all), its time
    alone (``launch_ms``) and its ``--compare`` case, "the {what} chunk"
    and "the key-major {what} chunk".  ``total`` is the chunk's count of
    counts, a global atomic each in the kernel this one replaced."""
    from kmers_anno_tpu_torch.ops.hash_chunk import (COMMONS_TABLE_CELLS,
                                                     COMMONS_TILE,
                                                     hash_commons,
                                                     hash_commons_plain)
    from kmers_anno_tpu_torch.ops.hashtable import probe_table

    km, _ = reorder_chunk(c, "key-major")
    got, ranks = hash_commons(*hash_chunk_args(km), with_ranks=True)
    want, want_ranks = hash_commons_plain(*hash_chunk_args(km),
                                          with_ranks=True)
    require(torch.equal(got, want) and torch.equal(ranks, want_ranks),
            f"hash_commons differs from its plain version on the key-major "
            f"{what} chunk")
    stats, cases = {}, {}
    for order, chunk_c in (("engine", c), ("key-major", km)):
        cells = tile_cells(chunk_c, probe_table(
            chunk_c["table"], chunk_c["lo"], chunk_c["hi"], chunk_c["valid"],
            chunk_c["max_probes"]))
        spilled = cells > COMMONS_TABLE_CELLS
        buf = torch.zeros((c["n_rows"], c["n_pad"]), dtype=torch.int32,
                          device=c["lo"].device)
        launch = (launch_hash_commons, [(*hash_chunk_args(chunk_c), buf)])
        t = stats[order] = dict(
            tiles=len(cells), spilled_tiles=int(spilled.sum()),
            max_tile_cells=int(cells.max()),
            global_adds=int(cells[~spilled].sum()),
            spilled_tile_cells=int(cells[spilled].sum()),
            launch_ms=launch_ms(*launch))
        name = "" if order == "engine" else "key-major "
        cases[f"the {name}{what} chunk (hash_commons)"] = launch
        print(f"hash_commons on the {what} chunk, {order} order: "
              f"{t['launch_ms']:.4f} ms a launch back to back; {t['tiles']} "
              f"tiles of {COMMONS_TILE} chunk kmers, at most "
              f"{t['max_tile_cells']} distinct cells a tile; "
              f"{t['tiles'] - t['spilled_tiles']} tiles keep every cell in "
              f"the shared table and make {t['global_adds']} global adds; "
              f"{t['spilled_tiles']} tiles hold more than "
              f"{COMMONS_TABLE_CELLS} cells ({t['spilled_tile_cells']} in "
              f"all) and spill; one global atomic a count would be {total}",
              flush=True)
    return stats, cases


def check_hash_pair(c, state, base=0) -> tuple[int, int]:
    """Both chunk kernels against their plain versions on chunk ``c``
    (tensors on the card): counts and ranks equal, then the state from
    ``state`` bit-equal and the counts cleared.  Returns (total count,
    improvements)."""
    from kmers_anno_tpu_torch.ops.hash_chunk import (hash_best,
                                                     hash_best_plain,
                                                     hash_commons,
                                                     hash_commons_plain)

    args = hash_chunk_args(c)
    got, ranks = hash_commons(*args, with_ranks=True)
    want, want_ranks = hash_commons_plain(*args, with_ranks=True)
    require(torch.equal(got, want) and torch.equal(ranks, want_ranks),
            "hash_commons differs from its plain version")
    total = int(got.sum())
    got_state = tuple(t.clone() for t in state)
    want_state = tuple(t.clone() for t in state)
    hash_best(got, c["n_rows"], c["n1"], c["n2"], c["minc"], got_state, base)
    hash_best_plain(want, c["n_rows"], c["n1"], c["n2"], c["minc"],
                    want_state, base)
    require(all(torch.equal(g, w) for g, w in zip(got_state, want_state)),
            "hash_best's state differs from its plain version's")
    require(not got.any(), "hash_best left counts behind")
    return total, int(got_state[3][0]) - int(state[3][0])


def on_device(c: dict, dev) -> dict:
    return {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in c.items()}


def check_hash_chunk(dev) -> None:
    """The chunk kernels against their plain versions on made-up chunks,
    each in the engine's order, shuffled and key-major: k = 8 and 12, a
    table whose lookups walk, owner rows at the cap (whose key-major tiles
    overflow the kernel's shared table), 5,000-aa prototypes whose kmers
    span several tiles, chunk and protein counts off powers of two and off
    multiples of 256."""
    from kmers_anno_tpu_torch.ops.hash_chunk import (COMMONS_TABLE_CELLS,
                                                     COMMONS_TILE)
    from kmers_anno_tpu_torch.ops.hashtable import probe_table

    rng = np.random.default_rng(SEED + 4)
    for what, params in (
            ("k=8", dict(k=8, n_prot=3001, n_rows=1001)),
            ("k=12, walking buckets", dict(k=12, n_prot=2000, n_rows=999,
                                           squeeze=True)),
            ("k=8, owners at the cap", dict(k=8, n_prot=1000, n_rows=257,
                                            family=40)),
            ("k=8, 5,000-aa prototypes", dict(k=8, n_prot=60, n_rows=5,
                                              plen=5000)),
            ("k=8, n_pad = 5,000 proteins", dict(k=8, n_prot=5000,
                                                 n_rows=4093,
                                                 exact_cols=True))):
        made = on_device(made_up_chunk(rng, **params), dev)
        require(not params.get("squeeze") or made["max_probes"] > 1,
                "the squeezed table does not walk")
        for order in CHUNK_ORDERS:
            c, _ = reorder_chunk(made, order, rng)
            total, improved = check_hash_pair(
                c, carried_state(rng, c["n_pad"], dev), 99)
            require(total > 0 and improved > 0,
                    f"hash chunk {what}, {order}: no counts")
            cells = tile_cells(c, probe_table(c["table"], c["lo"], c["hi"],
                                              c["valid"], c["max_probes"]))
            spilled = int((cells > COMMONS_TABLE_CELLS).sum())
            require(params.get("family", 1) == 1 or order != "key-major"
                    or spilled, f"hash chunk {what}: no key-major tile "
                    f"overflows the shared table")
            print(f"hash_commons + hash_best, {what}, {order} order: "
                  f"{c['lo'].numel()} chunk kmers x {c['n_rows']} prototypes "
                  f"x {c['n_pad']} columns, cap {c['owner_mat'].shape[1]}, "
                  f"max_probes {c['max_probes']}: {total} counts, "
                  f"{improved} improvements, equal to the plain versions; "
                  f"{len(cells)} tiles of {COMMONS_TILE}, at most "
                  f"{int(cells.max())} cells a tile, {spilled} over the "
                  f"shared table", flush=True)


def make_hash_bench(rng):
    """bench.py:651-675: 4 genomes, each a three-point-mutation copy of a
    pool of 1,500 proteins of 250 aa; 32,768 prototypes, each a
    0-7-substitution variant of a pool protein."""
    from kmers_anno_tpu_torch.engine.hashanno import Prototype

    aa = np.frombuffer(AA.encode(), np.uint8)
    pool = ["".join(chr(c) for c in aa[rng.integers(0, len(aa), HASH_LEN)])
            for _ in range(HASH_PROTEINS)]
    genomes = []
    for _ in range(HASH_GENOMES):
        prots = []
        for p in pool:
            b = list(p)
            for _ in range(3):
                b[int(rng.integers(0, len(b)))] = AA[
                    int(rng.integers(0, len(AA)))]
            prots.append("".join(b))
        genomes.append(prots)
    protos = []
    for i in range(HASH_PROTOTYPES):
        b = list(pool[int(rng.integers(0, len(pool)))])
        for _ in range(int(rng.integers(0, 8))):
            b[int(rng.integers(0, len(b)))] = AA[
                int(rng.integers(0, len(AA)))]
        protos.append(Prototype("".join(b), f"Role {i}"))
    return genomes, protos


def hash_baselines(per_genome: list[list[str]], protos: list[str],
                   min_score: float) -> tuple[list, float, float]:
    """``native.HashAnnoBaseline`` per genome (one hash a genome, as the
    reference tool's per-genome threads build), one thread each: returns
    [(best sim, winning prototype) per genome], the wall seconds and the
    sum of the per-genome seconds (each single-core)."""
    import threading

    from kmers_anno_tpu_torch import native

    out = [None] * len(per_genome)
    secs = [0.0] * len(per_genome)

    def one(i):
        t0 = time.perf_counter()
        hb = native.HashAnnoBaseline(per_genome[i], K, min_score)
        hb.score(protos)
        out[i] = hb.best()
        hb.close()
        secs[i] = time.perf_counter() - t0

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(per_genome))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    require(all(o is not None for o in out), "a hash baseline failed")
    return out, time.perf_counter() - t0, sum(secs)


def run_hash_bench_shape(dev) -> tuple[dict, dict, dict]:
    """bench.py's hashAnno shape through one combined GenomeProteinKmers on
    the card: every protein's best similarity and winner against
    ``HashAnnoBaseline``, prototype-genome pairs/s over five warm runs, a
    split of one run; then both chunk kernels on the first chunk against
    their plain versions, timed beside the plain versions, the unfused
    torch scatter and one ``torch.bincount``."""
    from kmers_anno_tpu_torch.engine.hashanno import (GenomeProteinKmers,
                                                      PrototypeSet,
                                                      _distinct_kmers_flat,
                                                      _emit_rows)
    from kmers_anno_tpu_torch.genome.gto import Genome, protein_md5
    from kmers_anno_tpu_torch.ops.hash_chunk import (hash_best,
                                                     hash_best_plain,
                                                     hash_commons,
                                                     hash_commons_plain)
    from kmers_anno_tpu_torch.ops.hashtable import probe_table

    t0 = time.perf_counter()
    genomes, protos = make_hash_bench(np.random.default_rng(HASH_SEED))
    pset = PrototypeSet(protos, K)
    pset.chunks(HASH_CHUNK, dev)            # pack once (cached, as in a run)
    print(f"hash bench shape: {HASH_GENOMES} genomes x {HASH_PROTEINS} "
          f"proteins of {HASH_LEN} aa, {HASH_PROTOTYPES} prototypes, "
          f"generated and packed in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def index():
        gk = GenomeProteinKmers(K, HASH_MIN_SCORE, device=dev)
        for gi, prots in enumerate(genomes):
            for i, p in enumerate(prots):
                gk.add_protein(f"fig|{gi}.peg.{i}", p, "hypothetical protein")
        return gk

    with _Launches() as run:
        gk = index()
        gk.process_proposals(pset, chunk=HASH_CHUNK)
    chunk = min(HASH_CHUNK, (1 << 26) // (gk.n_pad + 1) - 1)
    n_chunks = -(-HASH_PROTOTYPES // chunk)
    require(run.counts["hash_commons"] == run.counts["hash_best"]
            == n_chunks, f"hash bench shape: {n_chunks} chunks of {chunk} "
            f"(n_pad {gk.n_pad}), launches {run.counts}")
    routes = {"hash_bench": dict(launches=run.counts)}
    want, base_wall, base_sum = hash_baselines(
        genomes, [p.protein for p in protos], HASH_MIN_SCORE)
    n_called = 0
    for prots, (sim, winner) in zip(genomes, want):
        idx = np.array([gk._md5_of[protein_md5(p)] for p in prots])
        require(np.array_equal(gk.best_sim[idx], sim),
                "hash bench shape: a best similarity differs from "
                "HashAnnoBaseline")
        got_anno = [gk.best_anno[i] for i in idx]
        require(all(a == protos[w].annotation for a, s_, w in zip(
            got_anno, sim, winner) if s_ > 0),
            "hash bench shape: a winning prototype differs from "
            "HashAnnoBaseline")
        n_called += int((sim > 0).sum())
    print(f"hash bench shape: {len(gk._proteins)} distinct proteins (n_pad "
          f"{gk.n_pad}), {gk.n_kmers} kmers, {n_chunks} chunks of "
          f"{chunk}; {n_called} proteins with a proposal; best sim and "
          f"winner of every protein equal to HashAnnoBaseline (one run, one "
          f"thread a genome: {base_wall:.2f} s wall, {base_sum:.2f} s "
          f"single-core in all); launches {run.counts}", flush=True)

    def full():
        g = index()
        g.process_proposals(pset, chunk=HASH_CHUNK)
        return g

    times = [host_seconds(full)[0] for _ in range(WARM_RUNS)]
    pairs = HASH_PROTOTYPES * HASH_GENOMES
    rates = sorted(pairs / t for t in times)
    # the split of one more run
    gk = index()
    flat_s, _ = host_seconds(lambda: _distinct_kmers_flat(gk._proteins, K))
    build_s, _ = host_seconds(gk._build)
    chunks = pset.chunks(chunk, dev)
    max_len = max(max(map(len, gk._proteins)),
                  max(len(p.protein) for p in protos))
    dev_run = gk._device_run(chunks, max_len)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    gk._score_chunks(chunks, dev_run)
    stop.record()
    stop.synchronize()
    steps_host_s = time.perf_counter() - t0
    steps_ms = start.elapsed_time(stop)
    gtos = [Genome({"id": f"9{gi}.1", "scientific_name": "Hashus",
                    "features": [{"id": f"fig|{gi}.peg.{i}", "type": "CDS",
                                  "function": "hypothetical protein",
                                  "protein_translation": p}
                                 for i, p in enumerate(prots)]})
            for gi, prots in enumerate(genomes)]
    pull_s, _ = host_seconds(lambda: (gk._pull_best(dev_run, protos),
                                      [_emit_rows(g, gk) for g in gtos]))
    print(f"hash bench shape process_proposals: "
          f"{statistics.median(rates):.1f} prototype-genome pairs/s (median "
          f"of {WARM_RUNS}, range {rates[0]:.1f}-{rates[-1]:.1f}; s per run "
          f"{', '.join(f'{t:.4f}' for t in times)}); split of one more run: "
          f"host _distinct_kmers_flat of the proteins {flat_s:.4f} s, _build "
          f"(that flat pass, owner matrix, 8-slot table, upload) "
          f"{build_s:.4f} s, device chunk steps {steps_ms:.4f} ms by CUDA "
          f"events ({steps_host_s:.4f} s host), final pull and _emit_rows "
          f"{pull_s:.4f} s", flush=True)

    # the kernels on the first chunk, at full size
    d_lo, d_hi, d_proto, d_valid, _, sub, _, d_n2 = chunks[0]
    c = dict(table=gk.table, max_probes=gk.max_probes,
             owner_mat=gk.owner_mat, lo=d_lo, hi=d_hi, proto=d_proto,
             valid=d_valid, n_rows=len(sub), n_pad=gk.n_pad,
             n1=dev_run[1], n2=d_n2, minc=dev_run[0])
    fresh = (torch.zeros(gk.n_pad, dtype=torch.int32, device=dev),
             torch.ones(gk.n_pad, dtype=torch.int32, device=dev),
             torch.full((gk.n_pad,), -1, dtype=torch.int32, device=dev),
             torch.zeros(1, dtype=torch.int32, device=dev))
    total, improved = check_hash_pair(c, fresh)
    args = hash_chunk_args(c)
    buf = torch.zeros((c["n_rows"], c["n_pad"]), dtype=torch.int32,
                      device=dev)
    ms, _ = timed(lambda: hash_commons(*args, out=buf))
    plain_ms, want = timed(lambda: hash_commons_plain(*args), reps=1)
    ranks = probe_table(c["table"], c["lo"], c["hi"], c["valid"],
                        c["max_probes"])

    def unfused():
        # the reference's composition with an in-place int32 scatter:
        # probe, owner gather, then index_add_ of ones
        r = probe_table(c["table"], c["lo"], c["hi"], c["valid"],
                        c["max_probes"])
        own = c["owner_mat"][torch.clamp(r, min=0).long()]
        keep = (r >= 0)[:, None] & (own < c["n_pad"])
        idx = (c["proto"].long()[:, None] * c["n_pad"] + own.long())[keep]
        out = torch.zeros(c["n_rows"] * c["n_pad"], dtype=torch.int32,
                          device=dev)
        out.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
        return out.view(c["n_rows"], c["n_pad"])

    unfused_ms, got_u = timed(unfused, reps=1)
    require(torch.equal(got_u, want), "the unfused scatter differs from "
            "the plain version")
    own = c["owner_mat"][torch.clamp(ranks, min=0).long()]
    keep = (ranks >= 0)[:, None] & (own < c["n_pad"])
    pair_idx = (c["proto"].long()[:, None] * c["n_pad"] + own.long())[keep]
    library_ms, counted = timed(lambda: torch.bincount(
        pair_idx, minlength=c["n_rows"] * c["n_pad"]), reps=1)
    require(torch.equal(counted.view(c["n_rows"], c["n_pad"]).to(
        torch.int32), want), "torch.bincount differs from the plain version")
    commons = with_launch(dict(
        ms=ms, plain_ms=plain_ms, unfused_ms=unfused_ms, max_abs_err=0,
        **hash_commons_bound(c, ranks, int((want != 0).sum()), ms)),
        launch_ms(launch_hash_commons, [(*args, buf)]))
    commons.update(library_ms=library_ms, library=(
        "torch.bincount over the chunk's (prototype, owner) pair indices: "
        "the scatter only, without the probe and the owner gather"))
    # the same chunk key-major (the order before the engine's prototype
    # order), and each order's cells a kernel tile
    orders, order_cases = commons_orders(c, "bench", total)
    commons.update(tiles=orders, key_major_launch_ms=orders["key-major"][
        "launch_ms"])

    # hash_best on the same counts, which it clears: each timed pass gets
    # them and the fresh state back outside its event pair
    n_nonzero = int((want != 0).sum())
    state = tuple(t.clone() for t in fresh)
    plain_state = tuple(t.clone() for t in fresh)
    best_args = (buf, c["n_rows"], c["n1"], c["n2"], c["minc"], state, 0)

    def restore(st):
        buf.copy_(want)
        for t, f in zip(st, fresh):
            t.copy_(f)

    b_ms, _ = timed(lambda: hash_best(*best_args), setup=lambda:
                    restore(state))
    require(not buf.any(), "hash_best left counts behind")
    b_plain_ms, _ = timed(lambda: hash_best_plain(
        buf, c["n_rows"], c["n1"], c["n2"], c["minc"], plain_state, 0),
        reps=1, setup=lambda: restore(plain_state))
    require(all(torch.equal(a, b) for a, b in zip(state, plain_state)),
            "hash_best's timed passes differ from the plain version's")
    restore(state)
    best = with_launch(dict(ms=b_ms, plain_ms=b_plain_ms,
                            unfused_ms=b_plain_ms, max_abs_err=0,
                            **hash_best_bound(c, n_nonzero, b_ms)),
                       launch_ms(launch_hash_best, [best_args]))
    best.update(library="none: no single PyTorch call computes the "
                "floored first-max tournament and its state update")
    print(f"hash_commons on chunk 0 of the bench shape ({c['lo'].numel()} "
          f"chunk kmers, {commons['hits']} hits, {commons['bucket_reads']} "
          f"bucket reads, cap {c['owner_mat'].shape[1]}, {total} counts into "
          f"{c['n_rows']} x {c['n_pad']}; {commons['buckets']} distinct "
          f"buckets, {commons['owner_rows']} distinct owner rows), exact: "
          f"kernel {ms:.4f} ms "
          f"({commons['launch_ms']:.4f} ms a launch back to back), plain "
          f"{plain_ms:.4f} ms, unfused (probe_table + gather + index_add_) "
          f"{unfused_ms:.4f} ms, torch.bincount of the pairs "
          f"{library_ms:.4f} ms; bound {commons['bound_ms']:.4f} ms "
          f"({commons['bound_by']}, {commons['bound_bytes']} bytes, "
          f"{commons['bound_ops']} int ops), share "
          f"{commons['bound_share']:.3f}, back to back "
          f"{commons['launch_share']:.3f}", flush=True)
    print(f"hash_best on chunk 0 ({n_nonzero} non-zero of "
          f"{c['n_rows'] * c['n_pad']} cells, {improved} improvements), "
          f"state equal: kernel {b_ms:.4f} ms ({best['launch_ms']:.4f} ms a "
          f"launch back to back), plain tournament {b_plain_ms:.4f} ms; "
          f"bound {best['bound_ms']:.4f} ms ({best['bound_by']}, "
          f"{best['bound_bytes']} bytes), share {best['bound_share']:.3f}, "
          f"back to back {best['launch_share']:.3f}", flush=True)
    cases = dict(order_cases)
    cases["the bench chunk (hash_best)"] = (launch_hash_best, [best_args])
    return routes, {"hash_commons": commons, "hash_best": best}, cases


def make_hash_annotations(rng, genomes, path: str) -> list[str]:
    """The CLI's role annotation file: copies of ``HASH_CONFIRM`` pegs
    with each peg's own function (so some annotations are confirmed), then
    ``HASH_PROTOTYPES`` prototypes, each a 0-7-substitution variant of a
    random peg under a new annotation.  Returns the prototypes' proteins
    in file order."""
    pegs = [f for g in genomes for f in g.pegs]
    rows = []
    for i in rng.choice(len(pegs), HASH_CONFIRM, replace=False):
        rows.append((pegs[i].protein_translation, pegs[i].function))
    for i in range(HASH_PROTOTYPES):
        b = list(pegs[int(rng.integers(0, len(pegs)))].protein_translation)
        for _ in range(int(rng.integers(0, 8))):
            b[int(rng.integers(0, len(b)))] = AA[
                int(rng.integers(0, len(AA)))]
        rows.append(("".join(b), f"Hash role {i}"))
    with open(path, "w") as fh:
        fh.write("protein\tannotation\n")
        fh.writelines(f"{p}\t{a}\n" for p, a in rows)
    return rows


class _CheckedChunks:
    """Over one ``with`` block, every chunk step of the hashAnno engine
    held against the plain versions on its own inputs: each
    ``hash_commons`` call's counts, and each ``hash_best`` call's state
    and cleared counts, bit-equal.  The engine's calls launch the kernels
    once each, as they would unchecked."""

    def __init__(self):
        from kmers_anno_tpu_torch.engine import hashanno

        self.hashanno = hashanno
        self.chunks = []            # (rows, columns, non-zero counts)
        self.first = None           # the first chunk's hash_commons inputs

    def commons(self, *a, out=None, **kw):
        from kmers_anno_tpu_torch.ops.hash_chunk import hash_commons_plain

        if self.first is None:
            self.first = dict(zip(("table", "max_probes", "owner_mat", "lo",
                                   "hi", "proto", "valid", "n_rows",
                                   "n_pad"), a))
        before = None if out is None else out[: a[7]].clone()
        got = self._commons(*a, out=out, **kw)
        want = hash_commons_plain(*a, out=before, **kw)
        got, want = ((got, want) if isinstance(got, tuple)
                     else ((got,), (want,)))
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                "hash_commons differs from its plain version on an engine "
                "chunk")
        return got if len(got) > 1 else got[0]

    def best(self, common, n_rows, n1, n2, minc, state, base):
        from kmers_anno_tpu_torch.ops.hash_chunk import hash_best_plain

        counts = common[:n_rows].clone()
        n_nonzero = int(counts.count_nonzero())
        want = tuple(t.clone() for t in state)
        self._best(common, n_rows, n1, n2, minc, state, base)
        hash_best_plain(counts, n_rows, n1, n2, minc, want, base)
        require(all(torch.equal(g, w) for g, w in zip(state, want))
                and not common[:n_rows].any(),
                "hash_best differs from its plain version on an engine "
                "chunk")
        self.chunks.append((n_rows, common.shape[1], n_nonzero))

    def __enter__(self):
        self._commons = self.hashanno.hash_commons
        self._best = self.hashanno.hash_best
        self.hashanno.hash_commons = self.commons
        self.hashanno.hash_best = self.best
        return self

    def __exit__(self, *exc):
        self.hashanno.hash_commons = self._commons
        self.hashanno.hash_best = self._best
        return False


def run_hash_cli(dev, tmp: str) -> tuple[dict, dict]:
    """``hashAnno --batch 4`` through the CLI on the signature genomes
    (four genomes of 4,020 pegs of 300 aa) with a 32,832-row annotation
    file, twice (cold, warm).  Every row of every ``<gid>.anno.tbl``
    against ``HashAnnoBaseline``; the fast route, one launch of each chunk
    kernel a chunk.  A third, untimed run holds both chunk kernels against
    their plain versions on every chunk of this shape, and its first chunk
    goes through ``commons_orders``.  Returns the route's launches and the
    ``--compare`` cases of that chunk."""
    from kmers_anno_tpu_torch.commands.app import main
    from kmers_anno_tpu_torch.engine import hashanno
    from kmers_anno_tpu_torch.genome.gto import protein_md5
    from kmers_anno_tpu_torch.ops.hash_chunk import hash_commons_plain

    t0 = time.perf_counter()
    genomes, _ = make_signature_genomes(
        np.random.default_rng(SEED), SIG_GENOMES, SIG_ROLES,
        SIG_HYPOTHETICAL, SIG_MULTI)
    gto_dir = os.path.join(tmp, "hash_gtos")
    os.makedirs(gto_dir)
    for g in genomes:
        g.save(os.path.join(gto_dir, f"{g.id}.gto"))
    anno_file = os.path.join(tmp, "hash_annos.tbl")
    rows = make_hash_annotations(np.random.default_rng(SEED + 5), genomes,
                                 anno_file)
    n_pegs = sum(len(g.pegs) for g in genomes)
    print(f"hashAnno CLI workload: {SIG_GENOMES} genomes x "
          f"{n_pegs // SIG_GENOMES} pegs of {PROT_LEN} aa, {len(rows)} "
          f"annotation rows, written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    fast_only = []
    orig = hashanno.GenomeProteinKmers._process_chunk
    hashanno.GenomeProteinKmers._process_chunk = (
        lambda self, p: (fast_only.append(1), orig(self, p))[1])
    runs, secs = [], []
    try:
        for name in ("cold", "warm"):
            out_dir = os.path.join(tmp, f"hash_{name}")
            t0 = time.perf_counter()
            with _Launches() as run:
                rc = main(["hashAnno", "--batch", "4", "--device",
                           str(dev), "-D", out_dir, anno_file, gto_dir])
            secs.append(time.perf_counter() - t0)
            require(rc == 0, f"hashAnno exited with {rc}")
            runs.append(run.counts)
        with _CheckedChunks() as checked:
            rc = main(["hashAnno", "--batch", "4", "--device", str(dev),
                       "-D", os.path.join(tmp, "hash_checked"), anno_file,
                       gto_dir])
        require(rc == 0, f"hashAnno (checked) exited with {rc}")
    finally:
        hashanno.GenomeProteinKmers._process_chunk = orig
    n_prot = len({protein_md5(f.protein_translation) for g in genomes
                  for f in g.pegs})
    n_pad = 1 << (max(n_prot, 256) - 1).bit_length()
    chunk = min(HASH_CHUNK, (1 << 26) // (n_pad + 1) - 1)
    n_chunks = -(-len(rows) // chunk)
    require(not fast_only, "hashAnno took the host-float64 route")
    require(all(r["hash_commons"] == r["hash_best"] == n_chunks
                for r in runs), f"hashAnno launches {runs}, expected "
            f"{n_chunks} chunks of {chunk} (n_pad {n_pad})")
    require(len(checked.chunks) == n_chunks
            and all(r <= chunk and cols == n_pad
                    for r, cols, _ in checked.chunks),
            f"checked chunks {checked.chunks}, expected {n_chunks} of "
            f"<= {chunk} x {n_pad}")
    print(f"hashAnno --batch 4 (CLI, checked run): hash_commons and "
          f"hash_best equal to their plain versions on all {n_chunks} "
          f"chunks of {checked.chunks[0][0]} x {n_pad} (non-zero counts a "
          f"chunk: {[c[2] for c in checked.chunks]})", flush=True)
    first = checked.first
    counts = int(hash_commons_plain(*hash_chunk_args(first)).sum())
    _, cases = commons_orders(first, "CLI", counts)
    want, base_wall, base_sum = hash_baselines(
        [[f.protein_translation for f in g.features] for g in genomes],
        [p for p, _ in rows], HASH_MIN_SCORE)
    classes = dict(defaulted=0, confirmed=0, changed=0)
    for g, (sim, winner) in zip(genomes, want):
        for name in ("cold", "warm", "checked"):
            lines = open(os.path.join(tmp, f"hash_{name}",
                                      f"{g.id}.anno.tbl")).read().splitlines()
            require(lines[0] == "fid\tscore\tnew_annotation\told_annotation"
                    and len(lines) == len(g.features) + 1,
                    f"{g.id}.anno.tbl has {len(lines)} lines")
            first: dict[str, str] = {}
            for f in g.features:
                first.setdefault(protein_md5(f.protein_translation),
                                 f.peg_function)
            for line, f, s_, w in zip(lines[1:], g.features, sim, winner):
                old = f.peg_function
                new = (rows[w][1] if s_ > 0
                       else first[protein_md5(f.protein_translation)])
                score = repr(float(s_)) if s_ else "0.0"
                require(line == "\t".join((f.id, score, new, old)),
                        f"{g.id}: row {line!r} != baseline's "
                        f"{(f.id, score, new, old)}")
                if name == "cold":
                    key = ("defaulted" if not s_ else
                           "confirmed" if new == old else "changed")
                    classes[key] += 1
    require(all(classes.values()), f"an output class never occurs: {classes}")
    print(f"hashAnno --batch 4 (CLI): n_pad {n_pad}, {n_chunks} chunks of "
          f"{chunk}, the fast route; every row of the {SIG_GENOMES} "
          f".anno.tbl files (both runs) equal to HashAnnoBaseline's best sim "
          f"(repr) and winner ({classes}); baseline one run, one thread a "
          f"genome: {base_wall:.2f} s wall, {base_sum:.2f} s single-core in "
          f"all; cold {secs[0]:.2f} s, warm {secs[1]:.2f} s for the "
          f"4-genome batch (GTO load included); launches {runs[0]}",
          flush=True)
    return {"hash_cli": dict(launches=runs[0])}, cases


# ---------------------------------------------------------------------------
# the host commands on what the card wrote
# ---------------------------------------------------------------------------

def write_planted(tmp: str, planted: list, old_genome) -> None:
    """``planted.json`` beside the projection's files: each planted gene's
    strand, left, right and protein (a close genome's peg of that gene)."""
    prots = [f.protein_translation for f in old_genome.pegs]
    with open(os.path.join(tmp, "planted.json"), "w") as fh:
        json.dump([[*p, prot] for p, prot in zip(planted, prots)], fh)


def read_rows(path: str) -> list[list[str]]:
    with open(path) as fh:
        return [line.rstrip("\n").split("\t") for line in fh]


def read_gto(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def peg_fn(feat: dict) -> str:
    return feat.get("function") or "hypothetical protein"


def orf_key(feat: dict) -> tuple:
    contig, begin, strand, length = feat["location"][0]
    begin, length = int(begin), int(length)
    end = begin + length - 1 if strand == "+" else begin - length + 1
    return contig, end, strand


def anno_score(text: str) -> float:
    try:
        return float(text) if text else float("nan")
    except ValueError:
        return float("nan")


class CommandClock:
    """Runs port commands through the CLI; each must exit 0, and its
    seconds are printed and kept."""

    def __init__(self):
        from kmers_anno_tpu_torch.commands.app import main
        self.main = main
        self.seconds: list[tuple[str, float]] = []

    def __call__(self, what: str, *argv: str) -> None:
        t0 = time.perf_counter()
        rc = self.main(list(argv))
        secs = time.perf_counter() - t0
        require(rc == 0, f"{what} exited with {rc}")
        self.seconds.append((what, secs))
        print(f"command {what}: {secs:.4f} s", flush=True)


def check_anno_trio(run: CommandClock, tmp: str, anno_dir: str,
                    gto_dir: str) -> None:
    """checkAnno, applyAnno (DIR, LIST twice, DNAFASTA) and listAnno (FULL,
    NEW_ROLES) on hashAnno's files, each held to a recount made here from
    the files themselves."""
    annos = {name.split(".anno.tbl")[0]: read_rows(os.path.join(anno_dir,
                                                                name))[1:]
             for name in sorted(os.listdir(anno_dir))
             if name.endswith(".anno.tbl")}
    gids = sorted(annos)
    inputs = {gid: read_gto(os.path.join(gto_dir, f"{gid}.gto"))
              for gid in gids}
    require(gids == sorted(n[:-4] for n in os.listdir(gto_dir)) and all(
        len(annos[g]) == len(inputs[g]["features"]) for g in gids),
        f"hashAnno's files do not cover the genomes: {gids}")

    # -- checkAnno: counts a genome and their sums --
    confirmed = {(r[3], r[2]) for r in read_rows(
        os.path.join(anno_dir, "changes.tbl"))[1:] if anno_score(r[1]) >= 0.9}
    run("checkAnno", "checkAnno", "-o", os.path.join(tmp, "check.tbl"),
        anno_dir)
    rows = read_rows(os.path.join(tmp, "check.tbl"))
    require(rows[0][:4] == ["genome", "fids", "defaulted", "hypo_defaulted"]
            and [r[0] for r in rows[1:]] == gids + ["TOTALS"],
            f"checkAnno's rows: {[r[0] for r in rows]}")
    totals = np.zeros(5, np.int64)
    good_scores: list[float] = []
    for gid, row in zip(gids, rows[1:]):
        # fids, hypothetical defaults, other defaults, good, other
        want = np.zeros(5, np.int64)
        for _, score, new, old in annos[gid]:
            x = anno_score(score)
            want[0] += 1
            if x != x or x == 0.0:
                want[1 if new == "hypothetical protein" else 2] += 1
            elif new == old or (old, new) in confirmed:
                want[3] += 1
                good_scores.append(x)
            else:
                want[4] += 1
        # the reference's report swaps the two default columns on purpose
        got = [int(row[i]) for i in (1, 2, 3, 4, 8)]
        require(got == want.tolist(), f"checkAnno {gid}: {got} != recount "
                f"{want.tolist()}")
        totals += want
    got = [int(rows[-1][i]) for i in (1, 2, 3, 4, 8)]
    require(got == totals.tolist() and totals[3] > 0 and totals[4] > 0,
            f"checkAnno TOTALS {got} != the genomes' sum {totals.tolist()}")
    mean = float(rows[-1][5])
    require(abs(mean - statistics.fmean(good_scores)) <= 1e-12 * mean,
            f"checkAnno good_mean {mean} != recount")

    # -- applyAnno DIR: every feature gets the recounted function --
    applied = os.path.join(tmp, "applied")
    run("applyAnno DIR", "applyAnno", "--clear", anno_dir, gto_dir, applied)
    changed: dict[str, set] = {}
    for gid in gids:
        by_fid = {r[0]: r[2] for r in annos[gid]}
        got = read_gto(os.path.join(applied, f"{gid}.gto"))
        changed[gid] = set()
        for f_in, f_out in zip(inputs[gid]["features"], got["features"]):
            new = by_fid[f_in["id"]]
            want_fn = f_in.get("function", "")
            if new != peg_fn(f_in):
                want_fn = new
                changed[gid].add(f_in["id"])
            require(f_out["id"] == f_in["id"]
                    and f_out.get("function", "") == want_fn,
                    f"applyAnno {f_in['id']}: {f_out.get('function')!r} != "
                    f"{want_fn!r}")
    n_changed = sum(map(len, changed.values()))
    require(n_changed > 0, "applyAnno changed no function")

    # -- applyAnno LIST (appends without --clear) and DNAFASTA --
    listed = os.path.join(tmp, "genomes.list")
    run("applyAnno LIST", "applyAnno", "--target", "LIST", "--clear",
        anno_dir, gto_dir, listed)
    run("applyAnno LIST, appended", "applyAnno", "--target", "LIST",
        anno_dir, gto_dir, listed)
    want = "".join(f"{gid}\t{inputs[gid]['scientific_name']}\n"
                   for gid in gids)
    require(open(listed).read() == 2 * want, "applyAnno LIST's lines")
    fasta = os.path.join(tmp, "genomes.fna")
    run("applyAnno DNAFASTA", "applyAnno", "--target", "DNAFASTA",
        "--clear", anno_dir, gto_dir, fasta)
    want = ""
    for gid in gids:
        for c in inputs[gid]["contigs"]:
            want += f">{c['id']} {gid} {inputs[gid]['scientific_name']}\n"
            want += "".join(c["dna"][i:i + 60] + "\n"
                            for i in range(0, len(c["dna"]), 60))
    require(open(fasta).read() == want, "applyAnno DNAFASTA's records")

    # -- listAnno FULL and NEW_ROLES between the inputs and the applied --
    full = os.path.join(tmp, "full.tbl")
    run("listAnno FULL", "listAnno", "-o", full, gto_dir, applied)
    rows = read_rows(full)
    want_fids = [f["id"] for gid in gids for f in inputs[gid]["features"]]
    require(rows[0][0] == "fid" and [r[0] for r in rows[1:]] == want_fids,
            "listAnno FULL: not one row a feature, in genome order")
    listed_changes = {r[0] for r in rows[1:] if r[1] != r[6]}
    require(listed_changes == set().union(*changed.values()),
            f"listAnno FULL lists {len(listed_changes)} changes, applyAnno "
            f"made {n_changed}")
    new_roles = os.path.join(tmp, "new_roles.tbl")
    run("listAnno NEW_ROLES", "listAnno", "--format", "NEW_ROLES", "-o",
        new_roles, gto_dir, applied)
    want = [f["id"] for gid in gids for f in inputs[gid]["features"]
            if f["id"] in changed[gid]
            and peg_fn(f) == "hypothetical protein"]
    rows = read_rows(new_roles)
    require([r[0] for r in rows[1:]] == want and want,
            f"listAnno NEW_ROLES: {len(rows) - 1} rows, {len(want)} "
            "hypothetical proteins renamed")
    print(f"anno trio on hashAnno's {len(want_fids)} rows: checkAnno "
          f"{totals.tolist()} (fids, hypothetical and other defaults, "
          f"good, other) equal to the recount; applyAnno changed "
          f"{n_changed} functions, all listed by listAnno; "
          f"{len(want)} NEW_ROLES rows", flush=True)


def truth_genome(proj: str) -> dict:
    """The projection's input genome with the planted genes as its pegs:
    even genes keep the close genomes' names, odd ones carry a name of
    another annotation system, and every gene a gene name."""
    planted = read_gto(os.path.join(proj, "planted.json"))
    raw = read_gto(os.path.join(proj, "new.gto"))
    contig = raw["contigs"][0]["id"]
    raw["features"] = [{
        "id": f"fig|{raw['id']}.peg.{i + 1}", "type": "CDS",
        "function": (f"Projected role number {i + 1}" if i % 2 == 0
                     else f"Core role number {i + 1}"),
        "location": [[contig, str(left if strand == "+" else right), strand,
                      right - left + 1]],
        "protein_translation": prot, "annotations": [],
        "aliases": [["gene_name", f"gen{i + 1}"]]}
        for i, (strand, left, right, prot) in enumerate(planted)]
    return raw


def kmer_distance(a: str, b: str, k: int = 8) -> float:
    ka = {a[i:i + k] for i in range(len(a) - k + 1)}
    kb = {b[i:i + k] for i in range(len(b) - k + 1)}
    if not ka or not kb:
        return 1.0
    common = len(ka & kb)
    return 1.0 - common / (len(ka) + len(kb) - common)


def check_projection_commands(run: CommandClock, tmp: str,
                              proj: str) -> None:
    """compare, funMap into funApply, seqCheck and genes on the ``kmers``
    output the card projected, against a truth genome of the planted
    genes; each output held to a recount made here."""
    truth = truth_genome(proj)
    out = read_gto(os.path.join(proj, "out.gto"))
    dirs = {name: os.path.join(tmp, name)
            for name in ("truth", "kmers", "fun_applied", "seq")}
    for d in dirs.values():
        os.makedirs(d)
    for d in (dirs["truth"], dirs["seq"]):
        with open(os.path.join(d, f"{truth['id']}.gto"), "w") as fh:
            json.dump(truth, fh)
    for d in (dirs["kmers"], dirs["seq"]):
        with open(os.path.join(d, "projected.gto"), "w") as fh:
            json.dump(out, fh)
    truth_by_orf = {orf_key(f): f for f in truth["features"]}
    pairs = [(f, truth_by_orf[orf_key(f)]) for f in out["features"]
             if orf_key(f) in truth_by_orf]
    good = sum(peg_fn(a) == peg_fn(b) for a, b in pairs)
    require(len(pairs) > 0.9 * len(truth["features"]) and 0 < good
            < len(pairs), f"{len(pairs)} projected pegs on planted ORFs, "
            f"{good} with the truth's name")

    # -- compare --
    table = os.path.join(tmp, "compare.tbl")
    run("compare", "compare", "-o", table, dirs["truth"], dirs["kmers"])
    pct = "%8.4f" % (good * 100.0 / len(pairs))
    require(read_rows(table) == [["reference", "kmers"], [truth["id"], pct],
                                 [""], ["TOTAL", pct]],
            f"compare: {read_rows(table)} != recount {pct}")

    # -- funMap, its rows as the mapping file of funApply --
    fun_map = os.path.join(tmp, "fun_map.tbl")
    run("funMap", "funMap", "-o", fun_map, dirs["truth"], dirs["kmers"])
    rows = read_rows(fun_map)
    total: dict[str, int] = {}
    miss: dict[tuple, int] = {}
    for a, b in pairs:
        total[a["function"]] = total.get(a["function"], 0) + 1
        if a["function"] != b["function"]:
            key = (a["function"], b["function"])
            miss[key] = miss.get(key, 0) + 1
    want = sorted([a, b, str(n), "%8.2f" % (n * 100 / total[a])]
                  for (a, b), n in miss.items())
    require(rows[0] == ["old_function", "new_function", "count", "percent"]
            and sorted(r for r in rows[1:] if r[1]) == want,
            "funMap's mapped rows differ from the recount")
    misses = sorted(miss)
    mapping = os.path.join(tmp, "mapping.tbl")
    with open(mapping, "w") as fh:
        fh.write("patric_function\tcore_function\tgood\n")
        fh.writelines(f"{old}\t{new}\tY\n" for old, new in misses)
    run("funApply", "funApply", "--clear", mapping, dirs["kmers"],
        dirs["fun_applied"])
    applied = read_gto(os.path.join(dirs["fun_applied"], f"{out['id']}.gto"))
    to_core = dict(misses)
    require([f.get("function") for f in applied["features"]] == [
        to_core.get(f.get("function"), f.get("function"))
        for f in out["features"]] and applied["subsystems"] == [],
        "funApply's functions differ from the mapping's")
    require(all(peg_fn(f) == peg_fn(truth_by_orf[orf_key(f)])
                for f in applied["features"] if orf_key(f) in truth_by_orf),
            "funApply left a planted ORF named apart from the truth")

    # -- seqCheck: proteins named two ways across the two genomes --
    checked = os.path.join(tmp, "seq_check.tbl")
    run("seqCheck", "seqCheck", "-o", checked, dirs["seq"])
    by_protein: dict[str, list] = {}
    for f in out["features"] + truth["features"]:
        if f.get("type") in ("CDS", "peg") and f.get("protein_translation"):
            by_protein.setdefault(f["protein_translation"].upper(),
                                  []).append(f)
    flagged = [g for g in by_protein.values() if len(g) > 1
               and len({" ".join(peg_fn(f).lower().split()) for f in g}) > 1]
    rows = [r for r in read_rows(checked)[1:] if r != [""]]
    require({r[1] for r in rows} == {f["id"] for g in flagged for f in g}
            and len({r[0] for r in rows}) == len(flagged) > 0,
            f"seqCheck flags {len({r[0] for r in rows})} proteins, the "
            f"recount {len(flagged)}")

    # -- genes: gene names onto the renamed projection --
    genes_out = os.path.join(tmp, "genes.gto")
    run("genes", "genes", os.path.join(dirs["truth"], f"{truth['id']}.gto"),
        os.path.join(dirs["fun_applied"], f"{out['id']}.gto"), genes_out)
    source = {f["function"]: f for f in truth["features"]}
    want = {}
    for f in applied["features"]:
        if f.get("type") not in ("CDS", "peg"):
            continue
        src = source.get(peg_fn(f))
        if src and kmer_distance(f.get("protein_translation") or "",
                                 src["protein_translation"]) <= 0.5:
            want[f["id"]] = src["aliases"]
    got = {f["id"]: f["aliases"] for f in read_gto(genes_out)["features"]
           if f.get("aliases")}
    require(got == want and want, f"genes named {len(got)} pegs, the "
            f"recount {len(want)}")
    print(f"projection commands: {len(pairs)} projected pegs on the "
          f"{len(truth['features'])} planted ORFs, compare {pct.strip()}% "
          f"equal names, funMap mapped {len(misses)} functions and funApply "
          f"applied them, seqCheck flagged {len(flagged)} proteins, genes "
          f"named {len(got)} pegs; each equal to the recount", flush=True)


def check_small_commands(run: CommandClock, tmp: str) -> None:
    """merge, updateJson and buildGtos on small files written here."""
    d = os.path.join(tmp, "eval")
    os.makedirs(d)
    for name, text in (
            ("roles.to.use", "R1\nR2\nR3\n"),
            ("training.tbl", "genome\tR1\tR2\tR3\n100.1\t1\t2\t3\n"
                             "100.2\t4\t5\t6\n"),
            ("testing.tbl", "200.1\t7\t0\t9\n200.2\t1\t0\t0\n")):
        with open(os.path.join(d, name), "w") as fh:
            fh.write(text)
    run("merge", "merge", d)
    require(open(os.path.join(d, "training.tbl")).read()
            == "genome\tR1\tR3\n200.1\t7\t9\n200.2\t1\t0\n100.1\t1\t3\n"
               "100.2\t4\t6\n"
            and open(os.path.join(d, "roles.to.use")).read() == "R1\nR3\n"
            and os.path.isfile(os.path.join(d, "Backup", "training.tbl")),
            "merge's files")

    gid = "600.1"
    feats = [{"id": f"fig|{gid}.peg.{i + 1}", "type": "CDS",
              "function": f"Small role {i + 1}",
              "location": [["c1", str(100 * i + 1), "+", 90]],
              "protein_translation": "M" + "AK" * 20, "annotations": [],
              "aliases": []} for i in range(4)]
    genome = {"id": gid, "scientific_name": "Parvus", "genetic_code": 11,
              "domain": "Bacteria", "features": feats,
              "contigs": [{"id": "c1", "dna": "acgt" * 200}],
              "close_genomes": [],
              "subsystems": [{"name": "Small subsystem",
                              "variant_code": "active",
                              "classification": ["Metabolism", "Energy"],
                              "role_bindings": [{"role_id": "Small role 1",
                                                 "features": [feats[0]["id"]]
                                                 }]}]}
    gto_dir = os.path.join(tmp, "small_gtos")
    os.makedirs(gto_dir)
    with open(os.path.join(gto_dir, f"{gid}.gto"), "w") as fh:
        json.dump(genome, fh)
    json_in = os.path.join(tmp, "json_in", gid)
    os.makedirs(json_in)
    with open(os.path.join(json_in, "genome_feature.json"), "w") as fh:
        json.dump([{"patric_id": f["id"], "product": "old product",
                    "genome_id": gid, "start": 1, "end": 90}
                   for f in feats[:3]], fh)
    with open(os.path.join(json_in, "genome.json"), "w") as fh:
        json.dump([{"genome_id": gid}], fh)
    roles_file = os.path.join(tmp, "roles.in.subsystems")
    with open(roles_file, "w") as fh:
        fh.writelines(f"SmallRole{i + 1}\t0\tSmall role {i + 1}\n"
                      for i in range(4))
    json_out = os.path.join(tmp, "json_out")
    run("updateJson", "updateJson", "-R", roles_file,
        os.path.dirname(json_in), gto_dir, json_out)
    got = read_gto(os.path.join(json_out, gid, "genome_feature.json"))
    subs = read_gto(os.path.join(json_out, gid, "subsystem.json"))
    require([f["product"] for f in got] == [f["function"]
                                            for f in feats[:3]]
            and os.path.isfile(os.path.join(json_out, gid, "genome.json"))
            and [(s["patric_id"], s["role_name"], s["subsystem_name"],
                  s["active"], s["superclass"]) for s in subs]
            == [(feats[0]["id"], "Small role 1", "Small subsystem", "active",
                 "Metabolism")], "updateJson's files")

    in_dir = os.path.join(tmp, "annofiles")
    os.makedirs(in_dir)
    for name, text in (
            ("calls", f"{feats[0]['id']}\tCalled function one\t\t\n"
                      f"{feats[1]['id']}\tCalled function two\t\t\n"
                      "fig|9999.9.peg.1\tbogus\t\t\n"),
            ("local.family.defs", "17\tFamily function seventeen\t\t\t\t\n"),
            ("local.family.members.expanded",
             f"17\t{feats[1]['id']}\tx\tx\tgenA\n")):
        with open(os.path.join(in_dir, name), "w") as fh:
            fh.write(text)
    gtos_out = os.path.join(tmp, "gtos_out")
    run("buildGtos", "buildGtos", "-D", gtos_out, "-t", "DIR", "1234",
        in_dir, gto_dir)
    got = read_gto(os.path.join(gtos_out, f"{gid}.gto"))["features"]
    require([f["function"] for f in got] == [
        "Called function one", "Family function seventeen",
        "hypothetical protein", "hypothetical protein"]
        # the family takes the function it had when it was set: the call's
        and got[1]["family_assignments"] == [
            ["PLFAM", "PLF_1234_00000017", "Called function two"]]
        and ["gene_name", "genA"] in got[1]["aliases"], "buildGtos' GTO")
    print("merge, updateJson and buildGtos: files as expected", flush=True)


def run_commands(tmp: str, anno_dir: str, gto_dir: str, proj: str) -> None:
    """The commands phase: the anno trio on hashAnno's output
    (``anno_dir``, genomes in ``gto_dir``), compare, funMap, funApply,
    seqCheck and genes on the ``kmers`` output in ``proj``, then merge,
    updateJson and buildGtos on small files; outputs under ``tmp``.  The
    commands run on the host; every kernel's count must stay 0."""
    run = CommandClock()
    parts = [os.path.join(tmp, p) for p in ("trio", "projection", "small")]
    for p in parts:
        os.makedirs(p)
    with _Launches() as launches:
        check_anno_trio(run, parts[0], anno_dir, gto_dir)
        check_projection_commands(run, parts[1], proj)
        check_small_commands(run, parts[2])
    require(not any(launches.counts.values()),
            f"a host command launched a kernel: {launches.counts}")
    print("commands, seconds: " + ", ".join(f"{w} {s:.4f}"
                                            for w, s in run.seconds),
          flush=True)


# ---------------------------------------------------------------------------
# kernel H: DNA mode's window probe
# ---------------------------------------------------------------------------

DNA_K = 15
DNA_GENOMES = 4                  # the build's genomes; a fifth is applied
DNA_ROLES = 2000
DNA_HYPOTHETICAL = 2000
DNA_MULTI = 20
DNA_CDS = 900                    # bp of every CDS
DNA_SPACER = 60                  # bp of random DNA before every CDS
DNA_KILL_BP = 90                 # bp of a prototype in 1 of 10 hypotheticals
DNA_MAX_GAP = 500
DNA_BENCH_KEYS = 2_000_000       # bench.py's bench_dna (bench.py:384-432)
DNA_BENCH_CONTIGS = 4
DNA_BENCH_BASES = 4_000_000
DNA_KS = (4, 8, 11, 15)
# a window's bytes for the bound: its code, its flag and its output word
DNA_WINDOW_BYTES = 6
BUCKET_SECTOR_BYTES = 32         # a bucket's lo keys


def dna_wrap_table(rng, k, weighted):
    """An 8-slot table of the k-mers of a random sequence, built so that
    walks wrap from the last bucket to bucket 0: more keys than the 16
    slots of the last two buckets are homed there (up to 400 of 3,000 keys
    in 1,024 buckets; for k < 6, whose 4^k keys are few, all such keys of
    96 in 16 buckets).  Payloads are roles below 37, or fp16 weights in
    U[0.05, 3.0] over roles when ``weighted``.  Returns (the uint32 table,
    max_probes, the sequence's codes)."""
    from kmers_anno_tpu_torch.ops.dna_kmers import pack_dna_np
    from kmers_anno_tpu_torch.ops.hashing import mix_kmer_np
    from kmers_anno_tpu_torch.ops.hashtable import build_table

    n_buckets, n_keys, n_last = (16, 96, 40) if k < 6 else (1024, 3000, 400)
    seq = rng.integers(0, 4, 24_000).astype(np.uint8)
    key = np.unique(pack_dna_np(seq, k)[0])
    rng.shuffle(key)
    home = mix_kmer_np(key, np.zeros_like(key)) & np.uint32(n_buckets - 1)
    last = home >= n_buckets - 2
    key = np.concatenate([key[last][:n_last],
                          key[~last][: n_keys - min(n_last, last.sum())]])
    vals = rng.integers(0, 37, len(key)).astype(np.uint32)
    if weighted:
        w = rng.uniform(0.05, 3.0, len(key)).astype(np.float16)
        vals |= w.view(np.uint16).astype(np.uint32) << np.uint32(16)
    table, mp = build_table(key, np.zeros_like(key), vals,
                            n_buckets=n_buckets)
    return table, mp, seq


def dna_streams(rng, k, seq):
    """Made-up DNA streams as (name, codes, valid, offsets) NumPy arrays,
    drawn from ``seq`` (the table's sequence) so that windows hit:
    two-strand contig batches with ambiguous bases, entries shorter than k
    and of exactly k bases (a last window that ends at its entry's end),
    entries that join where the windows across the boundary are table keys
    (and invalid), stream lengths off every power of two; an all-invalid
    stream; a stream valid to its last position, whose tail windows reach
    past its end (the probe reads code 0 there, as the plain version pads);
    streams of one kernel tile (``ops.dna_probe.KERNEL_TILE``) less one,
    exactly one and one more window, and of two tiles + k - 2, valid to
    their ends, so that windows cross tile boundaries; streams whose
    windows alternate valid and invalid, one by one and three by three;
    and slices of odd length whose codes and flags start 1, 7 or 15 bytes
    past a 16-byte boundary.  ``offsets`` = (codes', valid's) byte offset
    into the tensors that hold them (``dna_stream_tensors``)."""
    from kmers_anno_tpu_torch.engine.dna_apply import DnaContigBatch
    from kmers_anno_tpu_torch.ops.dna_probe import KERNEL_TILE
    from kmers_anno_tpu_torch.ops.encode import DNA_PAD, decode_dna

    text = decode_dna(seq)
    out = []
    for n_contigs, tail in ((3, 1), (40, 37), (400, 5)):
        contigs = []
        for i in range(n_contigs):
            at = int(rng.integers(0, len(text) - 2000))
            n = int(rng.choice([k - 1, k, k + 1, 97, 1000, 1999]))
            s = list(text[at: at + n])
            for j in rng.integers(0, n, int(n > 50) * 3):
                s[j] = "nrykmswbdhv"[int(rng.integers(0, 11))]
            contigs.append((f"c{i}", "".join(s)))
        batch = DnaContigBatch(contigs, k, min_tokens=1)
        used = sum(e[3] for e in batch.entries)
        codes = np.full(used + tail, DNA_PAD, np.uint8)
        valid = np.zeros(used + tail, bool)
        codes[:used], valid[:used] = batch.codes[:used], batch.valid[:used]
        out.append((f"{n_contigs} contigs, T {used + tail}", codes, valid))
    # entries that join inside the table's own sequence: every window across
    # a boundary is a key, and invalid
    cut = np.sort(rng.choice(np.arange(k, 6000), 20, replace=False))
    codes = seq[: 6000 + 3].copy()
    valid = np.zeros(len(codes), bool)
    for a, b in zip(np.concatenate([[0], cut]), np.concatenate([cut,
                                                                [6000]])):
        valid[a: b - k + 1] = True
    out.append(("joined entries", codes, valid))
    out.append(("all invalid", codes, np.zeros(len(codes), bool)))
    tail = seq[: (1 << 16) + 11].copy()
    out.append(("valid to the end", tail, np.ones(len(tail), bool)))
    for n in (KERNEL_TILE - 1, KERNEL_TILE, KERNEL_TILE + 1,
              2 * KERNEL_TILE + k - 2):
        at = int(rng.integers(0, len(seq) - n))
        out.append((f"T {n}, valid to the end", seq[at: at + n].copy(),
                    np.ones(n, bool)))
    n = 2 * KERNEL_TILE + 333
    for step in (1, 3):
        valid = (np.arange(n) // step) % 2 == 0
        out.append((f"valid and invalid by {step}", seq[:n].copy(), valid))
    streams = [(name, c, v, (0, 0)) for name, c, v in out]
    for offsets in ((1, 1), (7, 7), (15, 15), (15, 1)):
        at = int(rng.integers(0, len(seq) - n))
        valid = rng.random(n) < 0.9
        valid[-k:] = True
        streams.append((f"T {n}, codes at byte {offsets[0]}, flags at "
                        f"byte {offsets[1]}", seq[at: at + n].copy(), valid,
                        offsets))
    return streams


def dna_stream_tensors(codes, valid, offsets, dev):
    """``codes`` and ``valid`` on ``dev`` as slices that start ``offsets``
    = (codes', valid's) bytes into freshly allocated (so 16-byte aligned)
    tensors."""
    held = []
    for arr, dtype, off in ((codes, torch.uint8, offsets[0]),
                            (valid, torch.bool, offsets[1])):
        t = torch.zeros(off + len(arr), dtype=dtype, device=dev)
        t[off:] = torch.from_numpy(arr).to(dev)
        held.append(t[off:])
    return tuple(held)


def check_dna_probe(dev) -> None:
    """``probe_dna`` against its plain version on made-up streams
    (``dna_streams``) for k = 4, 8, 11 and 15, unweighted and with packed
    fp16 weights, on tables whose walks wrap from the last bucket to bucket
    0 (``dna_wrap_table``), each with the table's key filter and without;
    one launch a call; bit for bit (``torch.equal``); every invalid window
    -1."""
    from kmers_anno_tpu_torch.engine.convert import wide_table_from_numpy
    from kmers_anno_tpu_torch.ops.dna_probe import probe_dna, probe_dna_plain

    rng = np.random.default_rng(SEED + 10)
    n_cases = n_hits = 0
    for k in DNA_KS:
        for weighted in (False, True):
            table, mp, seq = dna_wrap_table(rng, k, weighted)
            require(mp >= 3, f"the k={k} table's walks do not wrap")
            t = wide_table_from_numpy(table, dev)
            key_filter = flat_filter(t)
            for name, codes_np, valid_np, offsets in dna_streams(rng, k,
                                                                 seq):
                codes, valid = dna_stream_tensors(codes_np, valid_np,
                                                  offsets, dev)
                require(codes.data_ptr() % 16 == offsets[0]
                        and valid.data_ptr() % 16 == offsets[1],
                        f"the {name} stream lies at the wrong offsets")
                want = probe_dna_plain(t, codes, valid, k=k, max_probes=mp)
                for f in (None, key_filter):
                    before = probe_dna.launches
                    got = probe_dna(t, codes, valid, k=k, max_probes=mp,
                                    key_filter=f)
                    torch.cuda.synchronize()
                    require(probe_dna.launches == before + 1,
                            "probe_dna did not launch once")
                    require(torch.equal(got, want), f"probe_dna differs from "
                            f"its plain version (k {k}, weighted {weighted}, "
                            f"{name}, filter {f is not None})")
                    n_cases += 1
                require(bool((want[~valid] == -1).all()),
                        f"an invalid window hit (k {k}, {name})")
                n_hits += int((want >= 0).sum())
    print(f"dna probe on made-up streams: {n_cases} cases (k "
          f"{', '.join(map(str, DNA_KS))}; unweighted and fp16-weighted "
          f"payloads; tables whose walks wrap; tile edges, alternating "
          f"validity, slices at byte offsets 1, 7 and 15; each with the key "
          f"filter and without) equal to the plain version bit for bit, "
          f"{n_hits} hits", flush=True)


def make_dna_signature_genomes(rng, n_genomes, n_roles, n_hypothetical,
                               n_multi, cds=DNA_CDS,
                               substitution=SIG_SUBSTITUTION):
    """Genomes for ``build --dna`` and DNA ``apply`` (``make_signature_
    genomes`` laid onto real contigs, as ``tests/test_dna_mode.py``'s
    ``make_dna_genome`` lays CDS DNA): one contig each, on which every CDS
    of ``cds`` bp follows a random spacer of ``DNA_SPACER`` bp, strands
    alternating.  Each genome has one CDS per role, a
    ``substitution``-rate variant of that role's random prototype;
    ``n_hypothetical`` hypothetical CDS, the kill list, one in ten carrying
    ``DNA_KILL_BP`` bp of a prototype; and ``n_multi`` CDS whose function
    names two roles (build skips them).  Prototypes 2i and 2i+1 share 90 bp
    for the first tenth of the roles, so those kmers are pruned.  Returns
    the genomes and their role map."""
    from kmers_anno_tpu_torch.genome.gto import Genome
    from kmers_anno_tpu_torch.genome.roles import Role, RoleMap
    from kmers_anno_tpu_torch.ops.encode import decode_dna

    protos = rng.integers(0, 4, (n_roles, cds)).astype(np.uint8)
    for r in range(0, n_roles // 10, 2):
        protos[r + 1, 150:240] = protos[r, 150:240]
    names = [f"Synthetic DNA signature protein {r}" for r in range(n_roles)]
    role_map = RoleMap()
    for r, name in enumerate(names):
        role_map.put(Role(f"DnaRole{r}", name))
    genomes = []
    for g in range(n_genomes):
        gid = f"910{g}.1"
        variants = protos.copy()
        hit = rng.random(variants.shape) < substitution
        variants[hit] = rng.integers(0, 4, int(hit.sum()))
        hypo = rng.integers(0, 4, (n_hypothetical, cds)).astype(np.uint8)
        src = rng.integers(0, n_roles, n_hypothetical)
        hypo[::10, 300:300 + DNA_KILL_BP] = protos[src[::10],
                                                   300:300 + DNA_KILL_BP]
        multi = rng.integers(0, 4, (n_multi, cds)).astype(np.uint8)
        genes = np.concatenate([variants, hypo, multi])
        funcs = (names + ["hypothetical protein"] * n_hypothetical
                 + [f"{names[2 * i]} / {names[2 * i + 1]}"
                    for i in range(n_multi)])
        n = len(genes)
        minus = np.arange(n) % 2 == 1
        # reverse complement in code space: code ^ 2, order reversed
        placed = np.where(minus[:, None], genes[:, ::-1] ^ 2, genes)
        spacers = rng.integers(0, 4, (n, DNA_SPACER)).astype(np.uint8)
        contig = np.concatenate([np.concatenate([spacers, placed], axis=1)
                                 .reshape(-1),
                                 rng.integers(0, 4, DNA_SPACER).astype(
                                     np.uint8)])
        left = np.arange(n) * (DNA_SPACER + cds) + DNA_SPACER + 1
        feats = [{"id": f"fig|{gid}.peg.{i + 1}", "type": "CDS",
                  "function": f,
                  "location": [["c1", str(int(left[i] + (cds - 1) * m)),
                                "-" if m else "+", cds]],
                  "protein_translation": "M",
                  "annotations": [], "aliases": []}
                 for i, (f, m) in enumerate(zip(funcs, minus))]
        genomes.append(Genome({
            "id": gid, "scientific_name": f"Synthetica dna {g}",
            "genetic_code": 11, "domain": "Bacteria", "features": feats,
            "contigs": [{"id": "c1", "dna": decode_dna(contig),
                         "genetic_code": 11}],
            "close_genomes": [], "subsystems": []}))
    return genomes, role_map


def dna_hits_against_baseline(engine, batch, vals, what) -> int:
    """Hits of each stream entry (one strand of a contig) of a probed
    batch against ``native.dna_baseline`` on that strand's codes; returns
    the total."""
    from kmers_anno_tpu_torch import native

    table = engine.table.cpu().numpy().view(np.uint32)
    total = 0
    for cid, strand, off, length in batch.entries:
        got = int((vals[off: off + max(length - engine.k + 1, 0)] >= 0).sum())
        want = native.dna_baseline(batch.codes[off: off + length], table,
                                   engine.max_probes, engine.k)
        require(got == want, f"{what}: {got} hits on {cid} {strand} against "
                f"native.dna_baseline's {want}")
        total += got
    return total


def dna_report(engine, genomes, fmt, use_file) -> str:
    """The ``apply`` report of ``engine``'s calls on ``genomes``, written
    as the CLI writes it."""
    from kmers_anno_tpu_torch.reports.apply_reports import ApplyKmerReporter

    out = io.StringIO()
    reporter = ApplyKmerReporter.create(fmt, out)
    reporter.init_report(use_file)
    for genome in genomes:
        reporter.open_genome(genome)
        for feat, role, score in engine.call_genome(genome):
            reporter.record_feature(feat, role, score)
        reporter.close_genome()
    reporter.close_report()
    return out.getvalue()


def run_dna_cli(dev, tmp: str, keep: dict) -> tuple[dict, dict, dict]:
    """``build --dna`` (k = 15) through the CLI on four bacterial-size
    genomes (``make_dna_signature_genomes``, seed 0), unweighted and with
    ``--weights balance``; then ``apply`` in both formats, and
    ``--weighted`` on the balance build, on a fifth genome made the same
    way.  Every report equals, byte for byte, the same engine's on the
    CPU (the plain version); every strand's hits equal
    ``native.dna_baseline``'s; the kernel equals its plain version on the
    genome's stream, with the table's key filter too.  Returns each apply
    run's launch counts, the kernel's times on that stream and the
    ``--compare`` cases of the unweighted table's stream; leaves the
    unweighted table and the fifth genome in ``keep["dna_cli"]``."""
    from kmers_anno_tpu_torch.commands.app import main
    from kmers_anno_tpu_torch.engine.dna_apply import DnaApplyEngine
    from kmers_anno_tpu_torch.engine.signature import SignatureTable
    from kmers_anno_tpu_torch.ops.dna_probe import probe_dna, probe_dna_plain
    from kmers_anno_tpu_torch.ops.hashtable import table_size_for

    t0 = time.perf_counter()
    genomes, role_map = make_dna_signature_genomes(
        np.random.default_rng(SEED), DNA_GENOMES + 1, DNA_ROLES,
        DNA_HYPOTHETICAL, DNA_MULTI)
    train_dir, target_dir = (os.path.join(tmp, d) for d in ("dna_train",
                                                             "dna_target"))
    os.makedirs(train_dir)
    os.makedirs(target_dir)
    for g in genomes[:DNA_GENOMES]:
        g.save(os.path.join(train_dir, f"{g.id}.gto"))
    target = genomes[DNA_GENOMES]
    target.save(os.path.join(target_dir, f"{target.id}.gto"))
    role_file = os.path.join(tmp, "dna.roles.in.subsystems")
    use_file = os.path.join(tmp, "dna.roles.to.use")
    role_map.save(role_file)
    with open(use_file, "w") as fh:
        fh.writelines(f"{rid}\n" for rid in role_map.ids())
    bases = len(target.contigs[0].sequence)
    print(f"dna workload: {DNA_GENOMES} + 1 genomes of one {bases}-base "
          f"contig, {len(target.pegs)} CDS of {DNA_CDS} bp each "
          f"({DNA_ROLES} role variants at {SIG_SUBSTITUTION:.0%} "
          f"substitution, {DNA_HYPOTHETICAL} hypothetical, {DNA_MULTI} "
          f"two-role; strands alternating), written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    runs, tables = {}, {}
    for weights in ("none", "balance"):
        db = os.path.join(tmp, f"dna.{weights}.kdb")
        t0 = time.perf_counter()
        with _Launches() as run:
            rc = main(["build", "--dna", "-K", str(DNA_K), "--weights",
                       weights, "--device", str(dev), "-o", db, role_file,
                       use_file, train_dir])
        build_s = time.perf_counter() - t0
        require(rc == 0, f"build --dna --weights {weights} exited with {rc}")
        table = tables[weights] = SignatureTable.load(db)
        keep.setdefault("dna_cli", (table, target))
        require(table.alphabet == "dna" and table.k == DNA_K,
                f"build --dna wrote a {table.alphabet} table of k {table.k}")
        require(weights == "none" or table.weights is not None,
                "build --weights balance wrote no weights")
        n_buckets = table_size_for(len(table))
        print(f"build --dna --weights {weights} (CLI, C++ group-by): "
              f"{len(table)} kmers of {len(table.role_ids)} roles, 8-slot "
              f"table {n_buckets} buckets ({n_buckets * 96} B), "
              f"{build_s:.2f} s (GTO load included); launches "
              f"{run.counts}", flush=True)

    for route, fmt, weights in (("dna_verify", "VERIFY", "none"),
                                ("dna_apply", "APPLY", "none"),
                                ("dna_weighted", "VERIFY", "balance")):
        out = os.path.join(tmp, f"{route}.out")
        extra = ["--weighted"] if weights == "balance" else []
        t0 = time.perf_counter()
        with _Launches() as run:
            rc = main(["apply", "--format", fmt, "-m", str(MIN_HITS),
                       "--max-gap", str(DNA_MAX_GAP), *extra, "--device",
                       str(dev), "-o", out,
                       os.path.join(tmp, f"dna.{weights}.kdb"), use_file,
                       target_dir])
        cold_s = time.perf_counter() - t0
        require(rc == 0, f"DNA apply --format {fmt} {extra} exited with {rc}")
        require(run.counts["dna_probe"] == 1,
                f"DNA apply --format {fmt} {extra} launched probe_dna "
                f"{run.counts['dna_probe']} times, not once")
        runs[route] = dict(launches=run.counts)
        cpu = DnaApplyEngine(tables[weights], min_hits=MIN_HITS,
                             max_gap=DNA_MAX_GAP, weighted=bool(extra),
                             device="cpu")
        cpu_s, want = host_seconds(lambda: dna_report(cpu, [target], fmt,
                                                      use_file))
        got = open(out).read()
        require(got == want, f"DNA apply --format {fmt} {extra} on the card "
                "differs from the CPU engine's report")
        if fmt == "VERIFY":
            n_calls = got.count(".region.")
        else:   # one line a genome: its id, then a count a role
            n_calls = sum(int(x) for x in got.splitlines()[-1].split("\t")[1:])
        require(n_calls >= DNA_ROLES // 2, f"DNA apply --format {fmt} "
                f"{extra} called only {n_calls} regions")
        print(f"dna apply --format {fmt} {' '.join(extra)} (CLI, cold: "
              f"table load and build, GTO load): {cold_s:.2f} s; "
              f"{len(got.splitlines())} report lines ({n_calls} regions) "
              f"equal byte for byte to the CPU engine's ({cpu_s:.2f} s); "
              f"launches {run.counts}", flush=True)

    measured, cases = {}, {}
    for weights in ("none", "balance"):
        engine = DnaApplyEngine(tables[weights], min_hits=MIN_HITS,
                                max_gap=DNA_MAX_GAP,
                                weighted=weights == "balance", device=dev)
        batch = engine.prepare(target)
        codes = torch.from_numpy(batch.codes).to(dev)
        valid = torch.from_numpy(batch.valid).to(dev)
        args = (engine.table, codes, valid)
        kw = dict(k=DNA_K, max_probes=engine.max_probes)
        ms, got = timed(lambda: probe_dna(*args, **kw,
                                          key_filter=engine.key_filter))
        plain_ms, want = timed(lambda: probe_dna_plain(*args, **kw))
        require(torch.equal(got, want), f"probe_dna differs from its plain "
                f"version on the CLI genome (weights {weights})")
        hits = dna_hits_against_baseline(engine, batch, got.cpu().numpy(),
                                         f"the CLI genome ({weights})")
        row = dict(ms=ms, plain_ms=plain_ms,
                   max_abs_err=max_abs_err([(got, want)]))
        row.update(dna_bound(*args, DNA_K, engine.max_probes, ms))
        launch_args = [(*args, DNA_K, engine.max_probes)]
        filtered_args = [(*a, engine.key_filter) for a in launch_args]
        row = with_launch(row, launch_ms(launch_dna_probe_filtered,
                                         filtered_args))
        measured[weights] = row
        print(f"dna probe with the engine's key filter on the CLI genome "
              f"(weights {weights}; "
              f"{codes.numel()} windows, {int(valid.sum())} valid, {hits} "
              f"hits equal to native.dna_baseline on both strands; table "
              f"{engine.table.shape[0]} buckets, max_probes "
              f"{engine.max_probes}): kernel {ms:.4f} ms "
              f"({row['launch_ms']:.4f} alone), plain {plain_ms:.4f} ms, "
              f"equal; bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
              f"{row['bound_bytes']} B, {row['bound_ops']} int ops, "
              f"{row['buckets']} distinct buckets), share "
              f"{row['bound_share']:.3f}, alone {row['launch_share']:.3f}",
              flush=True)
        if weights == "none":
            row.update(dna_filter_and_floor(
                "the DNA CLI genome", engine.table, codes, valid,
                engine.max_probes, engine.key_filter, row["hits"]))
            cases["the DNA CLI genome"] = (launch_dna_probe, launch_args)
            cases["the DNA CLI genome, the engine's path"] = (
                launch_dna_probe_filtered, filtered_args)
    return runs, measured, cases


def dna_bound(table, codes, valid, k, max_probes, ms) -> dict:
    """probe_dna's bound: each window's code, flag and output word read or
    written once (``DNA_WINDOW_BYTES``), and the 32-byte lo-key sector of
    each distinct bucket the walks read; operations: a rolling pack
    (``ROLL_PACK_OPS``) a window, a valid window's hash, 16 a bucket read.
    A hit's hi key and payload lie in the sector after its lo keys; they
    are not counted."""
    from kmers_anno_tpu_torch.ops.dna_kmers import pack_dna_windows

    lo, hi = pack_dna_windows(codes, k)
    n_buckets, reads, hits = bucket_reads(table, lo, hi, valid, max_probes)
    n_valid = int(valid.sum())
    n_bytes = (DNA_WINDOW_BYTES * codes.numel()
               + BUCKET_SECTOR_BYTES * n_buckets)
    n_ops = (ROLL_PACK_OPS * codes.numel() + HASH_KEY_OPS * n_valid
             + HASH_BUCKET_OPS * reads)
    return dict(bound(n_bytes, n_ops, ms), buckets=n_buckets,
                bucket_reads=reads, hits=hits, windows=n_valid)


def launch_dna_probe(lib, table, codes, valid, k, max_probes,
                     key_filter=None):
    """probe_dna through a kernel library's C entry point (uncounted):
    ``kan_dna_probe``, or with ``key_filter`` ``kan_dna_probe_filtered``."""
    from kmers_anno_tpu_torch.ops.key_filter import filter_args

    out = torch.empty(codes.shape, dtype=torch.int32, device=codes.device)
    tail = (codes.data_ptr(), valid.data_ptr(), codes.numel(), k,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if key_filter is None:
        err = lib.kan_dna_probe(table.data_ptr(), table.shape[0],
                                max_probes, *tail)
    else:
        err = lib.kan_dna_probe_filtered(table.data_ptr(), table.shape[0],
                                         max_probes,
                                         *filter_args(key_filter), *tail)
    require(err == 0, f"the dna_probe entry returned CUDA error {err}")
    return out


def launch_dna_probe_filtered(lib, *args):
    """The engine's path: ``launch_dna_probe`` with the key filter, the last
    of ``args``, or on a build without ``kan_dna_probe_filtered`` (an
    earlier tree's) ``kan_dna_probe`` without it."""
    if not hasattr(lib, "kan_dna_probe_filtered"):
        args = args[:-1]
    return launch_dna_probe(lib, *args)


# the entry points each launcher calls, this build's first
launch_dna_probe.entry = "kan_dna_probe"
launch_dna_probe_filtered.entry = ("kan_dna_probe_filtered", "kan_dna_probe")


def dna_filter_and_floor(what, table, codes, valid, max_probes, key_filter,
                         hits) -> dict:
    """On one DNA stream: the key filter's bytes, the valid windows it
    answers and its false-positive share; the kernel with the filter and
    without in turns (``filter_turns``); and the same-shape gather floor,
    one 32-byte lo-key sector at each valid window's home bucket
    (``torch.index_select`` of rows 3b of a (3 x buckets, 8) int32 view of
    the table, an 8-row a window output), timed alone as ``launch_ms`` is.
    The gather does not compute the probe: it shows how close the kernel
    comes to the card's rate for random sectors."""
    from kmers_anno_tpu_torch.ops.dna_kmers import pack_dna_windows
    from kmers_anno_tpu_torch.ops.hashing import mix_kmer

    stats = filter_stats(key_filter, codes, valid, DNA_K, hits,
                         pack=pack_dna_windows)
    args = (table, codes, valid, DNA_K, max_probes)
    turns = filter_turns(
        what, lambda lib, *a: (launch_dna_probe(lib, *a),),
        [(*args, key_filter)], [args])
    lo, hi = pack_dna_windows(codes, DNA_K)
    rows = (3 * (mix_kmer(lo[valid], hi[valid]) & (table.shape[0] - 1))).to(
        torch.int64)
    sectors = table.view(-1, 8)
    floor_ms = launch_ms(lambda lib, v, r: torch.index_select(v, 0, r),
                         [(sectors, rows)])
    print(f"dna probe on {what}: key filter {stats['filter_bytes']} B, "
          f"{stats['filter_skipped']} of {int(valid.sum())} valid windows "
          f"answered by it, false-positive share "
          f"{stats['filter_fp_share']:.5f}; gather floor ({rows.numel()} "
          f"sectors of 32 B by torch.index_select) {floor_ms:.4f} ms",
          flush=True)
    return dict(stats, **turns, gather_floor_ms=floor_ms)


def run_dna_bench(dev, keep: dict) -> tuple[dict, dict, dict]:
    """bench.py's DNA shape (``bench_dna``, generator copied, seed 7): a
    2M-key k = 15 table of one random sequence's windows, roles drawn from
    2,000; 4 contigs of 4,000,000 random bases, each a genome of one
    contig, one two-strand ``DnaContigBatch`` a call.  The kernel equals
    its plain version and its hits ``native.dna_baseline`` on every
    contig; contig bases/s over five runs; a split of one call; the
    kernel alone against its bound, with the engine's key filter (the
    engine's path) and without.  Leaves the table and the genomes in
    ``keep["dna_bench"]``."""
    from kmers_anno_tpu_torch.engine.dna_apply import (DnaApplyEngine,
                                                       cluster_calls)
    from kmers_anno_tpu_torch.engine.signature import SignatureTable
    from kmers_anno_tpu_torch.genome.gto import Genome
    from kmers_anno_tpu_torch.ops.dna_kmers import pack_dna_np
    from kmers_anno_tpu_torch.ops.dna_probe import probe_dna, probe_dna_plain
    from kmers_anno_tpu_torch.ops.encode import decode_dna

    rng = np.random.default_rng(BENCH_SEED)
    seq = rng.integers(0, 4, size=DNA_BENCH_KEYS + DNA_K - 1).astype(np.uint8)
    lo, hi = pack_dna_np(seq, DNA_K)
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo
    _, idx = np.unique(key, return_index=True)
    vals = rng.integers(0, SIG_ROLES, len(idx)).astype(np.int32)
    table = SignatureTable(k=DNA_K, key_lo=lo[idx], key_hi=hi[idx],
                           role_idx=vals, alphabet="dna",
                           role_ids=[f"DnaBenchRole{r}"
                                     for r in range(SIG_ROLES)])
    contigs = [rng.integers(0, 4, size=DNA_BENCH_BASES).astype(np.uint8)
               for _ in range(DNA_BENCH_CONTIGS)]
    genomes = [Genome({"id": f"920{i}.1", "scientific_name": "Bench",
                       "genetic_code": 11, "domain": "Bacteria",
                       "features": [], "close_genomes": [],
                       "subsystems": [],
                       "contigs": [{"id": "c1", "dna": decode_dna(c)}]})
               for i, c in enumerate(contigs)]
    keep["dna_bench"] = (table, genomes)
    engine_s, engine = host_seconds(lambda: DnaApplyEngine(
        table, min_hits=MIN_HITS, max_gap=DNA_MAX_GAP, device=dev))
    batches = [engine.prepare(g) for g in genomes]
    args = [(engine.table, torch.from_numpy(b.codes).to(dev),
             torch.from_numpy(b.valid).to(dev)) for b in batches]
    kw = dict(k=DNA_K, max_probes=engine.max_probes)
    runs = {}
    with _Launches() as run:
        calls = [engine.call_genome(g) for g in genomes]
    runs["dna_bench"] = dict(launches=run.counts)
    require(run.counts["dna_probe"] == DNA_BENCH_CONTIGS,
            f"the DNA bench shape launched probe_dna "
            f"{run.counts['dna_probe']} times for {DNA_BENCH_CONTIGS} calls")
    fkw = dict(kw, key_filter=engine.key_filter)
    hits = 0
    for i, (b, a) in enumerate(zip(batches, args)):
        got = probe_dna(*a, **fkw)
        require(torch.equal(got, probe_dna_plain(*a, **kw)),
                f"probe_dna differs from its plain version on bench contig "
                f"{i}")
        hits += dna_hits_against_baseline(engine, b, got.cpu().numpy(),
                                          f"bench contig {i}")
    print(f"dna bench shape: {len(table)} keys (k {DNA_K}, "
          f"{engine.table.shape[0]} buckets, "
          f"{engine.table.numel() * 4} B, max_probes {engine.max_probes}; "
          f"built and uploaded in {engine_s:.3f} s), {DNA_BENCH_CONTIGS} "
          f"contigs of {DNA_BENCH_BASES} bases, a two-strand stream of "
          f"{batches[0].codes.size} windows each; {hits} hits equal to "
          f"native.dna_baseline on every strand, kernel equal to its plain "
          f"version; {sum(map(len, calls))} regions called; launches "
          f"{run.counts}", flush=True)

    times = [host_seconds(lambda: [engine.call_genome(g)
                                   for g in genomes])[0]
             for _ in range(REPS)]
    rates = sorted(DNA_BENCH_CONTIGS * DNA_BENCH_BASES / t for t in times)
    g = genomes[0]
    prep_s, b = host_seconds(lambda: engine.prepare(g))
    up_s, (codes, valid) = host_seconds(lambda: (
        torch.from_numpy(b.codes).to(dev), torch.from_numpy(b.valid).to(dev)))
    kernel_s, out = host_seconds(lambda: probe_dna(engine.table, codes,
                                                   valid, **fkw))
    down_s, vals = host_seconds(lambda: out.cpu().numpy())
    cluster_s, _ = host_seconds(lambda: cluster_calls(
        g, b, vals, DNA_K, DNA_MAX_GAP, MIN_HITS, engine.role_ids))
    print(f"dna bench shape call_genome: {statistics.median(rates):.1f} "
          f"contig bases/s (median of {REPS}, range {rates[0]:.1f}-"
          f"{rates[-1]:.1f}; s per run of {DNA_BENCH_CONTIGS} contigs "
          f"{', '.join(f'{t:.4f}' for t in times)}); split of one more call "
          f"(one contig): encode + valid {prep_s:.4f} s, upload {up_s:.4f} s "
          f"({b.codes.nbytes + b.valid.nbytes} B), kernel {kernel_s:.4f} s, "
          f"download {down_s:.4f} s, clustering {cluster_s:.4f} s",
          flush=True)

    def kernel():
        return [probe_dna(*a, **fkw) for a in args]

    def plain():
        return [probe_dna_plain(*a, **kw) for a in args]

    ms, got = timed(kernel)
    plain_ms, want = timed(plain)
    pairs = list(zip(got, want))
    require(all(torch.equal(x, y) for x, y in pairs),
            "probe_dna differs from its plain version on the bench contigs")
    n = DNA_BENCH_CONTIGS
    measured = dict(ms=ms / n, plain_ms=plain_ms / n,
                    max_abs_err=max_abs_err(pairs))
    bounds = [dna_bound(*a, DNA_K, engine.max_probes, 1.0) for a in args]
    for key_ in ("bound_bytes", "bound_ops", "buckets", "bucket_reads",
                 "hits", "windows"):
        measured[key_] = sum(x[key_] for x in bounds) / n
    measured.update(bound(measured["bound_bytes"], measured["bound_ops"],
                          measured["ms"]))
    launch_args = [(*a, DNA_K, engine.max_probes) for a in args]
    filtered_args = [(*a, engine.key_filter) for a in launch_args]
    measured = with_launch(measured, launch_ms(launch_dna_probe_filtered,
                                               filtered_args) / n)
    measured["bases_per_s"] = statistics.median(rates)
    measured.update(dna_filter_and_floor(
        "bench contig 0", *args[0], engine.max_probes, engine.key_filter,
        bounds[0]["hits"]))
    print(f"dna bench shape probe_dna with the engine's key filter per "
          f"contig (median of {REPS} runs over {n} contigs), exact: kernel "
          f"{measured['ms']:.4f} ms "
          f"({measured['launch_ms']:.4f} ms a launch back to back, "
          f"{measured['windows'] / measured['launch_ms'] * 1e3:.4e} valid "
          f"windows/s), plain {measured['plain_ms']:.4f} ms; bound (mean of "
          f"the contigs) {measured['bound_ms']:.4f} ms "
          f"({measured['bound_by']}, {measured['bound_bytes']:.0f} B, "
          f"{measured['bound_ops']:.0f} int ops, {measured['buckets']:.0f} "
          f"distinct buckets, {measured['bucket_reads']:.0f} bucket reads), "
          f"share {measured['bound_share']:.3f}, alone "
          f"{measured['launch_share']:.3f}; card {card_line()}", flush=True)
    cases = {"the DNA bench contigs": (launch_dna_probe, launch_args),
             "the DNA bench contigs, the engine's path": (
                 launch_dna_probe_filtered, filtered_args)}
    return runs, measured, cases


def run_dna(dev, tmp: str, keep: dict) -> tuple[dict, dict, dict]:
    """DNA mode: the probe kernel on made-up streams, the CLI at bacterial
    size, and bench.py's DNA shape.  Returns the launch counts by route,
    the ``dna_probe`` row's numbers (the bench shape's, with the CLI
    genome's as ``cli_*``) and the ``--compare`` cases (the bench contigs
    and the CLI genome, each with the key filter and without); leaves the
    CLI genome's and the bench shape's tables and genomes in ``keep``."""
    check_dna_probe(dev)
    runs, cli, cases = run_dna_cli(dev, tmp, keep)
    bench_runs, measured, bench_cases = run_dna_bench(dev, keep)
    runs.update(bench_runs)
    cases.update(bench_cases)
    for weights, row in cli.items():
        tag = "cli" if weights == "none" else "cli_weighted"
        for name in ("ms", "launch_ms", "plain_ms", "bound_ms",
                     "bound_share", "launch_share", "filtered_ms",
                     "unfiltered_ms", "gather_floor_ms"):
            if name in row:
                measured[f"{tag}_{name}"] = row[name]
        measured["max_abs_err"] = max(measured["max_abs_err"],
                                      row["max_abs_err"])
    return runs, measured, cases


# ---------------------------------------------------------------------------
# several devices: apply --mesh and the --data-parallel lanes
# ---------------------------------------------------------------------------

MESH_GENOMES = 8                 # bench.py's 262,144 proteins as 8 genomes
MESH_RETRY_FACTOR = 0.25         # a routing capacity the keys overflow
# processes of the CLI mesh runs, in turns (1: --mesh 1x1, 2: --mesh 2x1)
PROCESS_TURNS = (1, 2, 2, 1, 1, 2)
PROCESS_TIMEOUT = 600
# (route, n_data, n_table, mode, weighted, capacity_factor); the members
# are all the one card
MESH_MODES = (
    ("mesh_replicated", 4, 1, "replicated", False, None),
    ("mesh_pmax", 2, 2, "pmax", False, None),
    ("mesh_routed", 2, 2, "routed", False, None),
    ("mesh_routed_1x4", 1, 4, "routed", False, None),
    ("mesh_retry", 2, 2, "routed", False, MESH_RETRY_FACTOR),
    ("mesh_weighted", 2, 2, "routed", True, None),
    ("mesh_weighted_replicated", 2, 1, "replicated", True, None),
)


def launch_probe_keys(lib, table, lo, hi, valid, max_probes, key_filter):
    """probe_keys through a kernel library's C entry point (uncounted)."""
    from kmers_anno_tpu_torch.ops.key_filter import filter_args

    out = torch.empty(lo.shape, dtype=torch.int32, device=lo.device)
    err = lib.kan_probe_keys(
        table.data_ptr(), table.shape[0], max_probes,
        *filter_args(key_filter), lo.data_ptr(), hi.data_ptr(),
        None if valid is None else valid.data_ptr(), lo.numel(),
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    require(err == 0, f"kan_probe_keys returned CUDA error {err}")
    return out


launch_probe_keys.entry = "kan_probe_keys"


def keys_bound(table, lo, hi, valid, max_probes, ms) -> dict:
    """probe_keys' bound, each input read once: a key's lo word, a valid
    key's hi word, the flag byte where flags are given, the output (4 B a
    key), the 32-byte lo-key sector of every distinct bucket the lookups
    read and the hi-key and payload sectors of every distinct bucket
    holding a hit (64 B).  Operations: a valid key's hash, 16 a bucket
    read (``bucket_reads``).  The key filter is not counted: the function
    does not need it."""
    v = lo != -1 if valid is None else valid
    hit_seen = torch.zeros(table.shape[0], dtype=torch.bool,
                           device=table.device)
    n_buckets, reads, hits = bucket_reads(table, lo, hi, v, max_probes,
                                          hit_seen=hit_seen)
    n_valid = int(v.sum())
    n_bytes = (8 * lo.numel() + 4 * n_valid
               + (0 if valid is None else valid.numel()) + 32 * n_buckets
               + HIT_BUCKET_BYTES * int(hit_seen.sum()))
    n_ops = HASH_KEY_OPS * n_valid + HASH_BUCKET_OPS * reads
    return dict(bound(n_bytes, n_ops, ms), keys=n_valid, buckets=n_buckets,
                bucket_reads=reads, hits=hits)


def keys_cases(rng):
    """8-slot tables whose buckets hold several keys of one lo word and
    whose walks wrap from the last bucket to bucket 0, with queries: the
    table's keys, keys of its lo words that it lacks, and random keys.
    Yields (name, table, max_probes, query lo, query hi) as numpy."""
    from kmers_anno_tpu_torch.ops.hashtable import build_table
    from kmers_anno_tpu_torch.ops.key_filter import table_keys

    _, _, _, (klo, khi, vals), (qlo, qhi, _) = collision_table(rng, 3001)
    table, mp = build_table(klo, khi, vals, n_buckets=32)
    require(mp >= 2, "the collision table's walks never leave home")
    yield "collision_table", table, mp, qlo, qhi
    for case in ("k8_collide_wrap", "k12_collide_wrap"):
        _, table, mp = flat_case(rng, n_roles=5, **FLAT_EDGES[case])
        tlo, thi = table_keys(table)
        n = 2 * len(tlo) + 37
        yield (case, table, mp,
               np.concatenate([tlo, rng.integers(0, 1 << 30, n).astype(
                   np.uint32)]),
               np.concatenate([thi, rng.integers(0, 1 << 30, n).astype(
                   np.uint32)]))


KEYS_SHARES = (0.0, 0.03, 0.286, 1.0)    # live shares of the lookup's input


def live_share_keys(rng, table, n, share):
    """n query slots of an 8-slot ``table`` (numpy), a ``share`` of them
    live at random places (all or none at 0 and 1): half the keys the
    table's own, half random ones.  Returns (lo, hi, live) as numpy
    (uint32, uint32, bool); a caller marks the dead slots EMPTY, or passes
    ``live`` as the flags."""
    from kmers_anno_tpu_torch.ops.key_filter import table_keys

    tlo, thi = table_keys(table)
    pick = rng.integers(0, len(tlo), n)
    own = rng.random(n) < 0.5
    lo = np.where(own, tlo[pick], rng.integers(0, 1 << 30, n)).astype(
        np.uint32)
    hi = np.where(own, thi[pick], rng.integers(0, 1 << 30, n)).astype(
        np.uint32)
    return lo, hi, rng.random(n) < share


def check_probe_keys(dev) -> None:
    """``probe_keys`` against its plain version (``probe_table``) bit for
    bit on ``keys_cases``' tables, with one key in ten an empty slot
    (EMPTY), validity given (70% valid) and taken from the keys, with the
    table's key filter and without; on the last table, inputs of each
    ``KEYS_SHARES`` live share (``live_share_keys``, a size that is no
    multiple of 4 or of the kernel's tile); every key of each table found;
    an empty query launches nothing."""
    from kmers_anno_tpu_torch.engine.convert import wide_table_from_numpy
    from kmers_anno_tpu_torch.ops.key_filter import (build_key_filter,
                                                     table_keys)
    from kmers_anno_tpu_torch.ops.probe_keys import (KERNEL_TILE,
                                                     probe_keys,
                                                     probe_keys_plain)

    rng = np.random.default_rng(SEED + 12)
    n_checks = 0
    for name, table, mp, qlo, qhi in keys_cases(rng):
        qlo = qlo.copy()
        qlo[rng.random(len(qlo)) < 0.1] = 0xFFFFFFFF
        d_table = wide_table_from_numpy(table, dev)
        key_filter = build_key_filter(*table_keys(table), dev)
        lo, hi = (torch.from_numpy(a.view(np.int32)).to(dev)
                  for a in (qlo, qhi))
        for valid in (None, torch.from_numpy(rng.random(len(qlo)) < 0.7
                                             ).to(dev)):
            want = probe_keys_plain(d_table, lo, hi, valid, max_probes=mp)
            for filt in (None, key_filter):
                before = probe_keys.launches
                got = probe_keys(d_table, lo, hi, valid, max_probes=mp,
                                 key_filter=filt)
                torch.cuda.synchronize()
                require(probe_keys.launches == before + 1,
                        f"probe_keys on {name} did not launch once")
                require(torch.equal(got, want), f"probe_keys differs from "
                        f"its plain version on {name} (valid "
                        f"{'given' if valid is not None else 'from keys'}, "
                        f"filter {filt is not None})")
                n_checks += 1
        used = table[:, :8] != 0xFFFFFFFF
        keys = [torch.from_numpy(table[:, o: o + 8][used].view(
            np.int32)).to(dev) for o in (0, 8)]
        found = probe_keys(d_table, *keys, None, max_probes=mp,
                           key_filter=key_filter)
        require(torch.equal(found.cpu(), torch.from_numpy(
            table[:, 16:24][used].view(np.int32))),
                f"probe_keys misses a key of {name}")
    for share in KEYS_SHARES:
        klo, khi, live = live_share_keys(rng, table, 3 * KERNEL_TILE + 7,
                                         share)
        for flags in (False, True):
            lo, hi = (torch.from_numpy(a.view(np.int32)).to(dev) for a in (
                klo if flags else np.where(live, klo, 0xFFFFFFFF), khi))
            valid = torch.from_numpy(live).to(dev) if flags else None
            want = probe_keys_plain(d_table, lo, hi, valid, max_probes=mp)
            for filt in (None, key_filter):
                got = probe_keys(d_table, lo, hi, valid, max_probes=mp,
                                 key_filter=filt)
                require(torch.equal(got, want), f"probe_keys differs from "
                        f"its plain version at live share {share}")
                n_checks += 1
    before = probe_keys.launches
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    require(probe_keys(d_table, empty, empty, None, max_probes=mp).numel()
            == 0 and probe_keys.launches == before,
            "an empty query launched probe_keys")
    print(f"probe_keys: {n_checks} checks bit for bit against probe_table "
          f"on tables with equal-lo buckets and wrapping walks (EMPTY "
          f"slots, validity given and from the keys, key filter on and "
          f"off, live shares {KEYS_SHARES}); every table key found",
          flush=True)


def mesh_genomes(prots: list[str]) -> list:
    """``prots`` as MESH_GENOMES genomes of equal peg counts."""
    from kmers_anno_tpu_torch.genome.gto import Genome

    per = len(prots) // MESH_GENOMES
    genomes = []
    for g in range(MESH_GENOMES):
        gid = f"930{g}.1"
        feats = [{"id": f"fig|{gid}.peg.{i + 1}", "type": "CDS",
                  "function": "", "protein_translation": p,
                  "location": [["c1", str(1000 * i + 1), "+", 3 * len(p)]],
                  "annotations": [], "aliases": []}
                 for i, p in enumerate(prots[g * per: (g + 1) * per])]
        genomes.append(Genome({
            "id": gid, "scientific_name": f"Mesh {g}", "genetic_code": 11,
            "domain": "Bacteria", "features": feats, "contigs": [],
            "close_genomes": [], "subsystems": []}))
    return genomes


def calls_of(pairs) -> list:
    return [[(f.id, role, hits) for f, role, hits in calls]
            for _, calls in pairs]


class _Messages(logging.Handler):
    """The log messages of one logger over a ``with`` block."""

    def __init__(self, name: str):
        super().__init__(logging.INFO)
        self.logger = logging.getLogger(name)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.old_level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.old_level)
        return False


def mesh_tally_bits(engine, genomes) -> list:
    """A weighted mesh engine's (roles, float32 tally bits) of each
    genome's pegs, from its rows' results (its calls print the tallies to
    4 places)."""
    out = []
    for c in range(0, len(genomes), engine.n_data):
        chunk = [(g, g.pegs) for g in genomes[c: c + engine.n_data]]
        roles, tally = engine.run_rows(*engine.encode_chunk(chunk))
        out += [(roles[i][: len(g.pegs)].numpy(),
                 tally[i][: len(g.pegs)].numpy().view(np.int32))
                for i, (g, _) in enumerate(chunk)]
    return out


def routed_split(engine, chunk) -> tuple[dict, list]:
    """One routed call on ``chunk`` in its parts, each timed on the host
    and ending in a synchronise: host encode (FlatBatch and the split over
    the table axis), upload, routing (pack, owner, rank, buffers and live
    counts on the card), count read (the host read of each row's split
    sizes, one a row), exchange copies (each owner's live keys alone),
    lookup kernels (``probe_keys``), votes (partial tallies and their
    merge) and download.  Returns the seconds by part and each row's
    (roles, hits)."""
    from kmers_anno_tpu_torch.ops.encode import PROT_PAD
    from kmers_anno_tpu_torch.ops.probe_keys import probe_keys
    from kmers_anno_tpu_torch.parallel import mesh as mesh_mod

    mesh, nt, split = engine.mesh, engine.n_table, {}

    def part(name, fn):
        s, out = host_seconds(fn)
        split[name] = split.get(name, 0.0) + s
        return out

    codes, seg_ids, valid, n_seqs = part(
        "host encode", lambda: engine.encode_chunk(chunk))
    rows = part("host encode", lambda: [
        mesh_mod.split_tokens_for_table_axis(
            codes[j], seg_ids[j], valid[j], nt, engine.k, n_seqs, PROT_PAD)
        for j in range(codes.shape[0])])
    cap = rows[0][0].shape[-1]
    out = []
    for r, i in enumerate(engine.rows_mine):
        devs = mesh.devices[i]
        placed = part("upload", lambda: [
            [torch.from_numpy(rows[r][w][c]).to(devs[c]) for w in range(3)]
            for c in range(nt)])
        sent = part("routing", lambda: [mesh_mod.route_keys(
            *placed[c], k=engine.k, n_table=nt, capacity=cap,
            n_seqs=n_seqs) for c in range(nt)])
        sizes, _ = part("count read",
                        lambda: mesh_mod.split_sizes(sent, devs[0]))
        recv = part("exchange copies",
                    lambda: mesh_mod.exchange_keys(sent, sizes, devs))
        vals = part("lookup kernels", lambda: [probe_keys(
            engine.tables.on(mesh, i, s)[0], recv[s][0], recv[s][1], None,
            max_probes=engine.max_probes,
            key_filter=engine.tables.on(mesh, i, s)[1]) for s in range(nt)])
        voted = part("votes", lambda: mesh_mod._unanimous(
            [mesh_mod._partial_unanimous(vals[s], recv[s][2], n_seqs)
             for s in range(nt)], engine.min_hits, devs[0]))
        out.append(part("download", lambda: [t.cpu() for t in voted]))
    return split, out


def routed_inputs(engine, chunk) -> dict:
    """What member 0 of row 0 looks up in a routed call on ``chunk``, in
    both layouts: its shard's ``table`` and ``key_filter``; ``dense`` (lo,
    hi), the live keys the split-size exchange sends it; ``padded`` (lo,
    hi), bucket 0 of every member's routing buffers whole, the layout the
    exchange sent before it took split sizes; and ``live``, the
    positions of the dense keys in the padded buffer."""
    from kmers_anno_tpu_torch.ops.encode import PROT_PAD
    from kmers_anno_tpu_torch.parallel import mesh as mesh_mod

    mesh, nt = engine.mesh, engine.n_table
    codes, seg_ids, valid, n_seqs = engine.encode_chunk(chunk)
    row = mesh_mod.split_tokens_for_table_axis(
        codes[0], seg_ids[0], valid[0], nt, engine.k, n_seqs, PROT_PAD)
    devs = mesh.devices[0]
    cap = row[0].shape[-1]
    sent = [mesh_mod.route_keys(
        *(torch.from_numpy(row[w][c]).to(devs[c]) for w in range(3)),
        k=engine.k, n_table=nt, capacity=cap, n_seqs=n_seqs)
        for c in range(nt)]
    sizes, _ = mesh_mod.split_sizes(sent, devs[0])
    table, key_filter = engine.tables.on(mesh, 0, 0)
    return dict(
        table=table, key_filter=key_filter,
        dense=mesh_mod.exchange_keys(sent, sizes, devs)[0][:2],
        padded=tuple(torch.cat([b[w][0] for b in sent]) for w in range(2)),
        live=torch.cat([c * cap + torch.arange(sizes[c][0], device=devs[0])
                        for c in range(nt)]))


def pmax_inputs(engine, chunk) -> dict:
    """What member (0, 0) of a pmax 2x2 looks up on ``chunk``: row 0's
    whole window stream, every window packed (``lo``, ``hi``) with the
    host's validity flags (``valid``), against shard 0 (``table``,
    ``key_filter``)."""
    from kmers_anno_tpu_torch.ops.kmers import pack_kmer_windows

    codes, _, valid, _ = engine.encode_chunk(chunk)
    dev = engine.mesh.devices[0][0]
    lo, hi = pack_kmer_windows(torch.from_numpy(codes[0]).to(dev), engine.k)
    table, key_filter = engine.tables.on(engine.mesh, 0, 0)
    return dict(table=table, key_filter=key_filter, lo=lo, hi=hi,
                valid=torch.from_numpy(valid[0]).to(dev))


def launch_routed_lookup(lib, table, max_probes, key_filter, dense, padded,
                         live):
    """The routed lookup as each tree lays out its keys: this tree's
    build on the live keys its split-size exchange sends, another tree's
    on the padded buffer its exchange sent (uncounted)."""
    from kmers_anno_tpu_torch import kernels

    keys = dense if lib is kernels.lib() else padded
    return launch_probe_keys(lib, table, *keys, None, max_probes,
                             key_filter)


def _at_live_slots(lib, out, table, max_probes, key_filter, dense, padded,
                   live):
    from kmers_anno_tpu_torch import kernels

    return out if lib is kernels.lib() else out[live]


launch_routed_lookup.entry = "kan_probe_keys"
# ``--compare`` holds a padded buffer's outputs at its live slots
launch_routed_lookup.view = _at_live_slots


def measure_probe_keys(engine, chunk) -> tuple[dict, dict]:
    """``probe_keys`` on both of the mesh's inputs, ``chunk``'s first row
    against shard 0 of ``engine``'s 2x2 tables: the keys a routed member
    receives (row ``probe_keys``; also the padded buffer of the exchange
    before split sizes, this build alone and its bound) and the pmax member's window
    stream with flags (row ``probe_keys_pmax``).  Each bit for bit against
    its plain version; through the wrapper, alone, alone without the key
    filter, and its bound.  Returns both rows and the ``--compare`` cases:
    the padded buffer, the dense keys, each tree's layout (this tree's
    dense keys against another tree's padded buffer, outputs at the live
    slots) and the pmax stream."""
    from kmers_anno_tpu_torch.ops.probe_keys import (probe_keys,
                                                     probe_keys_plain)

    mp = engine.max_probes
    rin, pin = routed_inputs(engine, chunk), pmax_inputs(engine, chunk)
    table, filt = rin["table"], rin["key_filter"]
    inputs = {"probe_keys": (rin["dense"], None, "the keys member 0 of a "
                             "routed 2x2 row receives"),
              "probe_keys_pmax": ((pin["lo"], pin["hi"]), pin["valid"],
                                  "the window stream member (0, 0) of a "
                                  "pmax 2x2 looks up")}
    rows = {}
    for name, ((lo, hi), valid, what) in inputs.items():
        ms, got = timed(lambda: probe_keys(table, lo, hi, valid,
                                           max_probes=mp, key_filter=filt))
        plain_ms, want = timed(lambda: probe_keys_plain(
            table, lo, hi, valid, max_probes=mp))
        require(torch.equal(got, want), f"probe_keys differs from its plain "
                f"version on {what}")
        row = dict(ms=ms, plain_ms=plain_ms,
                   max_abs_err=max_abs_err([(got, want)]))
        row.update(keys_bound(table, lo, hi, valid, mp, ms))
        args = [(table, lo, hi, valid, mp, filt)]
        row = with_launch(row, launch_ms(launch_probe_keys, args))
        row["unfiltered_launch_ms"] = launch_ms(
            launch_probe_keys, [a[:-1] + (None,) for a in args])
        rows[name] = row
        print(f"probe_keys on {what} ({lo.numel()} slots, {row['keys']} "
              f"keys, {row['hits']} hits, {row['buckets']} distinct buckets "
              f"of {table.shape[0]}, {row['bucket_reads']} bucket reads), "
              f"bit for bit against probe_table: kernel {ms:.4f} ms through "
              f"the wrapper, {row['launch_ms']:.4f} ms alone "
              f"({row['unfiltered_launch_ms']:.4f} without the key filter), "
              f"plain {plain_ms:.4f} ms; bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}, {row['bound_bytes']} B, "
              f"{row['bound_ops']} int ops), share {row['bound_share']:.3f}, "
              f"alone {row['launch_share']:.3f}", flush=True)

    plo, phi = rin["padded"]
    got = probe_keys(table, plo, phi, None, max_probes=mp, key_filter=filt)
    dense_out = probe_keys(table, *rin["dense"], None, max_probes=mp,
                           key_filter=filt)
    dead = torch.ones(plo.numel(), dtype=torch.bool, device=plo.device)
    dead[rin["live"]] = False
    require(torch.equal(got[rin["live"]], dense_out)
            and bool((got[dead] == -1).all()),
            "probe_keys on the padded buffer differs from the dense keys")
    args = [(table, plo, phi, None, mp, filt)]
    padded = dict(slots=plo.numel(),
                  launch_ms=launch_ms(launch_probe_keys, args),
                  bound_ms=keys_bound(table, plo, phi, None, mp, 1.0)[
                      "bound_ms"])
    rows["probe_keys"]["padded"] = padded
    print(f"probe_keys on the padded buffer of that member ({plo.numel()} "
          f"slots, {rin['live'].numel()} live; the exchange before split "
          f"sizes): {padded['launch_ms']:.4f} ms alone, its bound "
          f"{padded['bound_ms']:.4f} ms; outputs at the live slots equal "
          f"the dense keys', -1 elsewhere", flush=True)
    cases = {
        "the routed keys, padded": (launch_probe_keys, args),
        "the routed keys, dense": (launch_probe_keys, [
            (table, *rin["dense"], None, mp, filt)]),
        "the routed keys, each tree's layout": (launch_routed_lookup, [
            (table, mp, filt, rin["dense"], rin["padded"], rin["live"])]),
        "the pmax stream": (launch_probe_keys, [
            (table, pin["lo"], pin["hi"], pin["valid"], mp, filt)]),
    }
    return rows, cases


def run_keys(dev) -> tuple[dict, dict]:
    """The quick loop for key-lookup designs (``--keys-only``):
    ``check_probe_keys``, then ``measure_probe_keys`` on the big-table
    cell's table as 2x2 shards and the first two mesh genomes, as the mesh
    phase measures them."""
    check_probe_keys(dev)
    table, _, prots = make_big_workload()
    genomes = mesh_genomes(prots)[:2]
    build_s, engine = host_seconds(lambda: mesh_engine(
        table, 2, 2, "routed", False, dev))
    print(f"mesh 2x2 tables ({engine.max_probes} probes) built and placed "
          f"in {build_s:.2f} s", flush=True)
    return measure_probe_keys(engine, [(g, g.pegs) for g in genomes])


def mesh_engine(table, n_data, n_table, mode, weighted, dev):
    from kmers_anno_tpu_torch.engine.mesh_apply import MeshApplyEngine

    return MeshApplyEngine(table, n_data, n_table, min_hits=MIN_HITS,
                           mode=mode, weighted=weighted,
                           devices=[dev] * (n_data * n_table))


def run_mesh(dev, keep: dict) -> tuple[dict, dict, dict]:
    """The mesh at BASELINE config 4's table size: the big-table phase's
    10M-key table and bench.py's 262,144 proteins as 8 genomes of 32,768,
    through ``MeshApplyEngine.call_genomes`` with every member on the one
    card (``MESH_MODES``: replicated 4x1, pmax 2x2, routed 2x2 and 1x4, a
    routed 2x2 whose capacity must overflow and re-run, weighted routed
    2x2 and weighted replicated 2x1 with the fp16 weights of that phase).
    Each mode's calls equal the single-device ``KmerApplyEngine``'s, and
    the weighted modes' float32 tallies its bits (``mesh_tally_bits``);
    proteins/s, median of 5; the split of one routed call; ``probe_keys``
    on both of its inputs (``measure_probe_keys``).  Then
    ``DnaMeshApplyEngine`` replicated 2x1 and sharded 1x2 on the DNA bench
    genomes and the DNA CLI genome, against ``DnaApplyEngine``; contig
    bases/s.  Returns the launches by route, the ``probe_keys`` rows and
    their ``--compare`` cases."""
    from kmers_anno_tpu_torch.engine.dna_apply import DnaApplyEngine
    from kmers_anno_tpu_torch.engine.mesh_apply import DnaMeshApplyEngine

    check_probe_keys(dev)
    big = keep["big"]
    t0 = time.perf_counter()
    genomes = mesh_genomes(big["prots"])
    n_prot = sum(len(g.pegs) for g in genomes)
    want = {}
    for weighted in (False, True):
        engine = big["w_engine" if weighted else "engine"]
        want[weighted] = [[(f.id, role, hits) for f, role, hits
                           in engine.call_genome(g)] for g in genomes]
    w_engine = big["w_engine"]
    single_bits = []
    for g in genomes:
        role, tally = w_engine._call_batches(len(g.pegs), w_engine
                                             ._prepare_proteins(
            [f.protein_translation for f in g.pegs]))
        single_bits.append((role, tally.view(np.int32)))
    n_called = sum(map(len, want[False]))
    made_s = time.perf_counter() - t0
    times = [host_seconds(lambda: [[(f.id, role, hits) for f, role, hits
                                    in big["engine"].call_genome(g)]
                                   for g in genomes])[0]
             for _ in range(REPS)]
    rates = sorted(n_prot / t for t in times)
    print(f"mesh workload: {MESH_GENOMES} genomes x {n_prot // MESH_GENOMES} "
          f"proteins on the {len(big['table'])}-key table, every member on "
          f"{dev}; single-device calls {n_called} (weighted "
          f"{sum(map(len, want[True]))}), made in {made_s:.1f} s; the "
          f"single-device KmerApplyEngine.call_genome on these genomes "
          f"{statistics.median(rates):.1f} proteins/s (median of {REPS}, "
          f"range {rates[0]:.1f}-{rates[-1]:.1f})", flush=True)
    routes, engines = {}, {}
    for route, n_data, n_table, mode, weighted, factor in MESH_MODES:
        layout = (n_table if mode != "replicated" else 1, n_data * n_table,
                  weighted)
        if layout not in engines:
            build_s, engines[layout] = host_seconds(lambda: mesh_engine(
                big["w_table" if weighted else "table"], n_data, n_table,
                mode, weighted, dev))
            print(f"mesh {n_data}x{n_table} {'weighted ' * weighted}"
                  f"tables ({engines[layout].max_probes} probes) "
                  f"built and placed in {build_s:.2f} s", flush=True)
        # one table layout serves every mode of its shape (pmax and
        # routed shard alike): only the step changes
        engine = copy.copy(engines[layout])
        engine.mode, engine.capacity_factor = mode, factor
        with _Launches() as run, _Messages(
                "kmers_anno_tpu_torch.engine.mesh_apply") as log:
            got = calls_of(engine.call_genomes(genomes))
        routes[route] = dict(launches=run.counts)
        require(got == want[weighted], f"{route}: the mesh's calls differ "
                "from the single-device engine's")
        retries = sum("overflowed" in m for m in log.messages)
        require(retries == (MESH_GENOMES // n_data if factor else 0),
                f"{route}: {retries} routing re-runs")
        if weighted:
            got_bits = mesh_tally_bits(engine, genomes)
            require(all(np.array_equal(a, b) for g, w in zip(
                got_bits, single_bits) for a, b in zip(g, w)),
                    f"{route}: the mesh's tallies differ from the "
                    "single-device engine's in their bits")
        times = [host_seconds(lambda: calls_of(engine.call_genomes(
            genomes)))[0] for _ in range(REPS)]
        rates = sorted(n_prot / t for t in times)
        routes[route]["rate"] = statistics.median(rates)
        print(f"mesh {route} ({n_data}x{n_table} {mode}"
              f"{', weighted' if weighted else ''}"
              f"{f', capacity factor {factor}, {retries} re-runs' if factor else ''}"
              f"): calls equal the single-device engine's"
              f"{', tallies bit for bit' if weighted else ''}; "
              f"{statistics.median(rates):.1f} proteins/s (median of {REPS}"
              f", range {rates[0]:.1f}-{rates[-1]:.1f}); launches "
              f"{run.counts}", flush=True)
    require(routes["mesh_routed"]["launches"]["probe_keys"]
            == MESH_GENOMES * 2 and routes["mesh_pmax"]["launches"][
                "probe_keys"] == MESH_GENOMES * 2
            and routes["mesh_replicated"]["launches"]["apply_flat"]
            == MESH_GENOMES
            and routes["mesh_weighted_replicated"]["launches"][
                "apply_flat_weighted"] == MESH_GENOMES,
            "the mesh modes' launches differ from one a member a row")

    routed = copy.copy(engines[(2, 4, False)])
    routed.mode = "routed"
    chunk = [(g, g.pegs) for g in genomes[:2]]
    split, out = routed_split(routed, chunk)
    codes, seg_ids, valid, n_seqs = routed.encode_chunk(chunk)
    roles, hits = routed.run_rows(codes, seg_ids, valid, n_seqs)
    require(all(torch.equal(o[0], roles[i]) and torch.equal(o[1], hits[i])
                for i, o in enumerate(out)), "the split routed call differs")
    print("mesh routed 2x2 call split (2 genomes, " + ", ".join(
        f"{k} {v:.4f} s" for k, v in split.items()) + ")", flush=True)

    keys_rows, cases = measure_probe_keys(routed, chunk)

    for name, (table, dna_genomes) in (
            ("DNA bench genomes", keep["dna_bench"]),
            ("DNA CLI genome", (keep["dna_cli"][0], [keep["dna_cli"][1]]))):
        kw = dict(min_hits=MIN_HITS, max_gap=DNA_MAX_GAP)
        single = DnaApplyEngine(table, device=dev, **kw)
        want_dna = [[(f.id, f.location.strand, f.location.left,
                      f.location.right, role, hits)
                     for f, role, hits in single.call_genome(g)]
                    for g in dna_genomes]
        bases = sum(len(c.sequence) for g in dna_genomes for c in g.contigs)
        times = [host_seconds(lambda: [single.call_genome(g)
                                       for g in dna_genomes])[0]
                 for _ in range(REPS)]
        rates = sorted(bases / t for t in times)
        print(f"dna single-device DnaApplyEngine.call_genome on the {name}: "
              f"{statistics.median(rates):.1f} contig bases/s (median of "
              f"{REPS}, range {rates[0]:.1f}-{rates[-1]:.1f})", flush=True)
        for n_data, n_table in ((2, 1), (1, 2)):
            route = f"mesh_dna_{'replicated' if n_table == 1 else 'sharded'}"
            engine = DnaMeshApplyEngine(table, n_data, n_table,
                                        devices=[dev] * 2, **kw)
            with _Launches() as run:
                got = [[(f.id, f.location.strand, f.location.left,
                         f.location.right, role, hits)
                        for f, role, hits in calls]
                       for _, calls in engine.call_genomes(dna_genomes)]
            require(got == want_dna, f"{route} on the {name} differs from "
                    "DnaApplyEngine")
            times = [host_seconds(lambda: list(engine.call_genomes(
                dna_genomes)))[0] for _ in range(REPS)]
            rates = sorted(bases / t for t in times)
            # one launch a member a row, padding rows included
            require(run.counts["dna_probe"] == -(-len(dna_genomes) // n_data)
                    * n_data * n_table, f"{route} on the {name} launched "
                    f"{run.counts}")
            if name.startswith("DNA bench"):
                routes[route] = dict(launches=run.counts,
                                     rate=statistics.median(rates))
            print(f"dna mesh {n_data}x{n_table} on the {name} "
                  f"({len(dna_genomes)} genomes, {bases} bases; "
                  f"{sum(map(len, got))} regions called, equal to "
                  f"DnaApplyEngine): {statistics.median(rates):.1f} contig "
                  f"bases/s (median of {REPS}, range {rates[0]:.1f}-"
                  f"{rates[-1]:.1f}); launches {run.counts}", flush=True)
    return routes, keys_rows, cases


def process_env(**kan) -> dict:
    """This process's environment for a CLI process started from the
    repository's root, with the ``KAN_*`` variables given and no others."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("KAN_")}
    env.update(kan)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def apply_processes(dev, n: int, args: list[str], outs: list[str]) -> float:
    """``apply`` through the CLI in ``n`` processes (``--mesh 1x1`` in one,
    ``--mesh 2x1`` in two joined by the ``KAN_*`` variables), each writing
    its own report; host seconds from the first start to the last exit.
    Every process is waited for, or killed at ``PROCESS_TIMEOUT``."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "kmers_anno_tpu_torch", "apply", "--mesh",
           f"{n}x1", "--device", dev.type]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [*cmd, "-o", outs[rank], *args],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=process_env(KAN_COORDINATOR=f"127.0.0.1:{port}",
                        KAN_NUM_PROCESSES=str(n), KAN_PROCESS_ID=str(rank))
        if n > 1 else process_env(),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for rank in range(n)]
    try:
        errs = [p.communicate(timeout=PROCESS_TIMEOUT)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    secs = time.perf_counter() - t0
    for rank, (p, err) in enumerate(zip(procs, errs)):
        require(p.returncode == 0, f"apply --mesh {n}x1, process {rank}, "
                f"exited with {p.returncode}: {err[-2000:]}")
    return secs


def run_mesh_cli(dev, tmp: str, ctx: dict) -> None:
    """``apply --mesh`` through the CLI on the signature genomes and the
    4M-key ``.kdb`` of ``run_big_kdb_cli``: ``--mesh 1x1`` in one process
    and ``--mesh 2x1`` in two processes on the one card (a data row each,
    gloo between them), in turns, 3 runs each.  The one process's and the
    primary's reports equal plain ``apply``'s byte for byte; the
    secondary's holds the header alone.  Then the ``--data-parallel``
    lanes on ``cuda`` (one lane a card: one here): ``batch
    --data-parallel 2`` on two jobs of a 500-gene projection genome with 3
    close genomes, and ``hashAnno --batch 2 --data-parallel 2`` on four
    small signature genomes, byte for byte against their sequential
    runs."""
    from kmers_anno_tpu_torch.commands.app import main
    from kmers_anno_tpu_torch.genome.gto import Genome

    args = ["--format", "VERIFY", "-m", str(MIN_HITS), ctx["kdb"],
            ctx["use_file"], ctx["gto_dir"]]
    want = open(ctx["verify"]).read()
    times = {1: [], 2: []}
    for turn, n in enumerate(PROCESS_TURNS):
        outs = [os.path.join(tmp, f"mesh{turn}.{rank}.tbl")
                for rank in range(n)]
        times[n].append(apply_processes(dev, n, args, outs))
        require(open(outs[0]).read() == want, f"apply --mesh {n}x1 in {n} "
                "process(es): the primary's report differs from plain "
                "apply's")
        if n == 2:
            require(open(outs[1]).read().splitlines()
                    == want.splitlines()[:1],
                    "the secondary process wrote more than the header")
    def spread(t):
        return (f"{statistics.median(t):.4f} s a run (median of {len(t)}, "
                f"range {min(t):.4f}-{max(t):.4f}: "
                f"{', '.join(f'{x:.4f}' for x in t)})")

    print(f"apply --mesh (CLI, .kdb of {KDB_KEYS} keys, {SIG_GENOMES} "
          f"genomes, every process on {dev}): one process --mesh 1x1 "
          f"{spread(times[1])}; two processes --mesh 2x1 {spread(times[2])} "
          f"(turns "
          f"{' '.join(map(str, PROCESS_TURNS))}; each run from the first "
          f"start to the last exit, interpreter start, table load and "
          f"kernel load included); reports equal plain apply's byte for "
          f"byte, the secondary's the header alone", flush=True)

    # -- the lanes --
    dna, olds, new = make_projection_workload(np.random.default_rng(SEED),
                                              500, 3)
    outs = {}
    for tag, extra in (("seq", []), ("lanes", ["--data-parallel", "2"])):
        d = os.path.join(tmp, f"batch_{tag}")
        os.makedirs(os.path.join(d, "cache"))
        for gid, og in olds.items():
            og.save(os.path.join(d, "cache", f"{gid}.gto"))
        for i in range(2):
            new.save(os.path.join(d, f"in{i}.gto"))
        with open(os.path.join(d, "batch.tbl"), "w") as fh:
            fh.writelines(f"in{i}.gto\tout{i}.gto\n" for i in range(2))
        with _Launches() as run:
            rc = main(["batch", "--cache", os.path.join(d, "cache"),
                       "--device", str(dev), *extra,
                       os.path.join(d, "batch.tbl")])
        require(rc == 0, f"batch {extra} exited with {rc}")
        outs[tag] = [features_of(Genome.load(os.path.join(d, f"out{i}.gto")))
                     for i in range(2)]
        require(run.counts["contig_scan"] == 2, f"batch {extra} launched "
                f"{run.counts}")
    require(outs["lanes"] == outs["seq"] and outs["seq"][0],
            "batch --data-parallel 2 differs from the sequential batch")
    genomes, _ = make_signature_genomes(np.random.default_rng(SEED + 3), 4,
                                        200, 200, 2)
    gto_dir = os.path.join(tmp, "lane_gtos")
    os.makedirs(gto_dir)
    for g in genomes:
        g.save(os.path.join(gto_dir, f"{g.id}.gto"))
    anno_file = os.path.join(tmp, "lane_annos.tbl")
    with open(anno_file, "w") as fh:
        fh.write("protein\tannotation\n")
        fh.writelines(f"{f.protein_translation}\tLane role {i}\n"
                      for i, f in enumerate(genomes[0].pegs[:300]))
    files = {}
    for tag, extra in (("seq", []), ("lanes", ["--data-parallel", "2"])):
        out_dir = os.path.join(tmp, f"hash_{tag}")
        rc = main(["hashAnno", "--batch", "2", "--device", str(dev), *extra,
                   "-D", out_dir, anno_file, gto_dir])
        require(rc == 0, f"hashAnno {extra} exited with {rc}")
        files[tag] = {n: open(os.path.join(out_dir, n), "rb").read()
                      for n in sorted(os.listdir(out_dir))}
    require(files["lanes"] == files["seq"] and len(files["seq"]) == 5,
            "hashAnno --data-parallel 2 differs from the sequential run")
    print(f"lanes on {dev} (one a card, {torch.cuda.device_count()} here): "
          f"batch --data-parallel 2 on 2 genomes of {len(dna)} bases "
          f"({len(outs['seq'][0])} features each) and hashAnno --batch 2 "
          f"--data-parallel 2 on 4 genomes ({len(files['seq'])} files) equal "
          f"their sequential runs byte for byte", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also trace warm fused-route genomes")
    parser.add_argument(
        "--compare", metavar="DIR", nargs="+", default=None,
        help="also time the kernels of this tree against the build of the "
             "tree at each DIR (the root of another checkout), in turns on "
             "the main path's inputs")
    parser.add_argument(
        "--dna-only", action="store_true",
        help="run only the dna phase (and --compare on its cases); prints "
             "no result line")
    parser.add_argument(
        "--tables-only", action="store_true",
        help="run only the realistic projection workload's one fused "
             "annotation and the table_build phase (and --compare on its "
             "cases); prints no result line")
    parser.add_argument(
        "--keys-only", action="store_true",
        help="run only the key lookup's checks and measurements (and "
             "--compare on its cases); prints no result line")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; no result")
    os.environ["KMERS_ANNO_LOG"] = "off"     # no log file in the checkout
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name}; nvidia-smi: {card}", flush=True)
    print(sys.version.split()[0], "torch", torch.__version__, "cuda",
          torch.version.cuda, flush=True)

    from kmers_anno_tpu_torch import kernels, native

    require(native.available(), "the C++ host library did not build")
    t0 = time.perf_counter()
    nvcc_output = kernels.build()
    kernels.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for line in nvcc_output.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip(), flush=True)

    phases = []
    keep: dict = {}     # workloads an earlier phase leaves for the mesh

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phases.append((name, time.perf_counter() - t0))
        return out

    if args.keys_only:
        keys_measured, cases = phase("keys", run_keys, dev)
        if args.compare:
            with tempfile.TemporaryDirectory() as tmp:
                phase("compare", lambda: compare_contenders(
                    build_contenders(args.compare, tmp), cases))
        print("seconds by phase: " + ", ".join(f"{n} {t:.1f}"
                                               for n, t in phases))
        print(json.dumps(keys_measured), flush=True)
        return
    if args.tables_only:
        with tempfile.TemporaryDirectory() as tmp:
            keep["projection"] = phase("workload", projection_workload, dev,
                                       tmp)
            _, tb_measured, cases = phase("table_build", run_table_build,
                                          dev, keep)
        if args.compare:
            with tempfile.TemporaryDirectory() as tmp:
                phase("compare", lambda: compare_contenders(
                    build_contenders(args.compare, tmp), cases))
        print("seconds by phase: " + ", ".join(f"{n} {t:.1f}"
                                               for n, t in phases))
        print(json.dumps(tb_measured), flush=True)
        return
    if args.dna_only:
        with tempfile.TemporaryDirectory() as tmp:
            _, dna_measured, cases = phase("dna", run_dna, dev, tmp, keep)
        if args.compare:
            with tempfile.TemporaryDirectory() as tmp:
                phase("compare", lambda: compare_contenders(
                    build_contenders(args.compare, tmp), cases))
        print("seconds by phase: " + ", ".join(f"{n} {t:.1f}"
                                               for n, t in phases))
        print(json.dumps({"dna_probe": dna_measured}), flush=True)
        return

    phase("kernel checks", lambda: (check_contig_scan(dev),
                                    check_probe_wide(dev),
                                    check_apply_rows(dev),
                                    check_collisions(dev),
                                    check_apply_flat(dev)))
    # the projection's files stay for the commands phase
    proj = tempfile.TemporaryDirectory()
    routes, (measured, cases) = phase("projection", run_main_path, dev,
                                      proj.name, args.profile, keep)
    tb_routes, tb_measured, tb_cases = phase("table_build", run_table_build,
                                             dev, keep)
    routes.update(tb_routes)
    measured.update(tb_measured)
    cases.update(tb_cases)
    with tempfile.TemporaryDirectory() as tmp:
        sig_routes, sig_files = phase("build + apply", run_signature_path,
                                      dev, tmp)
        routes.update(sig_routes)
        routes.update(phase("apply, big .kdb CLI", run_big_kdb_cli, dev,
                            tmp, sig_files))
        phase("mesh CLI", run_mesh_cli, dev, tmp, sig_files)
    bench_routes, measured["apply_rows"], bench_cases = phase(
        "apply bench shape", run_bench_shape, dev)
    routes.update(bench_routes)
    cases.update(bench_cases)
    big_routes, big_measured, big_cases = phase("apply, big table",
                                                run_big_table, dev, keep)
    routes.update(big_routes)
    measured.update(big_measured)
    cases.update(big_cases)
    walks = phase("sliced probe timing", time_sliced_walks, dev)
    phase("hash kernel checks", check_hash_chunk, dev)
    hash_routes, hash_measured, hash_cases = phase(
        "hashAnno bench shape", run_hash_bench_shape, dev)
    routes.update(hash_routes)
    measured.update(hash_measured)
    cases.update(hash_cases)
    with tempfile.TemporaryDirectory() as tmp:
        cli_routes, cli_cases = phase("hashAnno CLI", run_hash_cli, dev, tmp)
        os.makedirs(os.path.join(tmp, "commands"))
        phase("commands", run_commands, os.path.join(tmp, "commands"),
              os.path.join(tmp, "hash_cold"), os.path.join(tmp, "hash_gtos"),
              proj.name)
    proj.cleanup()
    routes.update(cli_routes)
    cases.update(cli_cases)
    with tempfile.TemporaryDirectory() as tmp:
        dna_routes, measured["dna_probe"], dna_cases = phase(
            "dna", run_dna, dev, tmp, keep)
    routes.update(dna_routes)
    cases.update(dna_cases)
    mesh_routes, keys_measured, mesh_cases = phase(
        "mesh", run_mesh, dev, keep)
    routes.update(mesh_routes)
    measured.update(keys_measured)
    cases.update(mesh_cases)
    del keep
    if args.compare:
        with tempfile.TemporaryDirectory() as tmp:
            phase("compare", lambda: compare_contenders(
                build_contenders(args.compare, tmp), cases))
    print("seconds by phase: " + ", ".join(f"{n} {t:.1f}"
                                           for n, t in phases), flush=True)
    require("jax" not in sys.modules, "jax was imported")
    require(not any(m.split(".")[0] == "kmers_anno_tpu" for m in sys.modules),
            "the JAX package was imported")

    def row(name, counter, source, replaces, main_route, of_routes):
        by_route = {r: routes[r]["launches"][counter] for r in of_routes}
        return dict(name=name, route="cuda",
                    source=f"kmers_anno_tpu_torch/{source}",
                    replaces=f"kmers_anno_tpu/{replaces}",
                    launches=by_route[main_route],
                    launches_by_route=by_route, **measured[name])

    rows = [
        row("contig_scan", "contig_scan", "csrc/contig_scan.cu",
            "ops/pallas_contig.py:103", "fused", ("fused", "rle")),
        row("probe_wide", "probe_wide", "csrc/probe_wide.cu",
            "ops/widetable.py:199", "fused",
            ("fused", "rle", "host", "weighted_apply")),
        # the host route builds no stream index: its scanner launches are
        # the per-strand ones
        row("contig_scan_strand", "contig_scan", "csrc/contig_scan.cu",
            "ops/pallas_contig.py:161", "host", ("host",)),
        # the apply path: CLI apply in both formats, the bench shape and
        # the weighted path (which launches the probe, not apply_rows)
        row("apply_rows", "apply_rows", "csrc/apply_rows.cu",
            "engine/apply_engine.py:184", "apply",
            ("apply", "apply_train", "bench", "weighted_apply")),
        # hashAnno: the CLI batch and the library bench shape, a launch of
        # each a chunk
        row("hash_commons", "hash_commons", "csrc/hash_chunk.cu",
            "engine/hashanno.py:122", "hash_cli", ("hash_cli", "hash_bench")),
        row("hash_best", "hash_best", "csrc/hash_chunk.cu",
            "engine/hashanno.py:71", "hash_cli", ("hash_cli", "hash_bench")),
        # the flat-stream path of tables past one wide table: the 10M-key
        # bench table's call_proteins and the CLI's 4M-key .kdb; weighted,
        # the call in role blocks and the dense 8,192-protein call
        # (and the mesh's replicated rows, one launch a row)
        row("apply_flat", "apply_flat", "csrc/apply_flat.cu",
            "engine/apply_engine.py:61", "big",
            ("big", "big_cli", "mesh_replicated")),
        row("apply_flat_weighted", "apply_flat_weighted",
            "csrc/apply_flat.cu", "engine/apply_engine.py:104",
            "big_weighted",
            ("big_weighted", "big_dense", "mesh_weighted_replicated")),
        # DNA mode: the CLI apply in both formats, weighted, and the bench
        # shape's calls (one launch a genome), and the DNA mesh's (one a
        # member a row)
        row("dna_probe", "dna_probe", "csrc/dna_probe.cu",
            "engine/dna_apply.py:49", "dna_verify",
            ("dna_verify", "dna_apply", "dna_weighted", "dna_bench",
             "mesh_dna_replicated", "mesh_dna_sharded")),
        # the mesh's table shards: routed (the keys a member receives) and
        # pmax (every window against every shard), one launch a member a
        # row
        row("probe_keys", "probe_keys", "csrc/probe_keys.cu",
            "ops/hashtable.py:186", "mesh_routed",
            ("mesh_routed", "mesh_pmax", "mesh_routed_1x4", "mesh_retry",
             "mesh_weighted")),
        # the same kernel on the pmax step's input: a row's whole window
        # stream with flags
        row("probe_keys_pmax", "probe_keys", "csrc/probe_keys.cu",
            "ops/hashtable.py:186", "mesh_pmax", ("mesh_pmax",)),
        # the close-genome tables: one wide build a close genome on the
        # fused route's CLI run and on the RLE route (10 a close set), 40
        # a rotating batch of 4; the 8-slot build on the RLE run whose
        # tables all take that layout
        row("build_wide_table_device", "table_build_wide",
            "csrc/table_build.cu", "ops/widetable.py:153", "fused",
            ("fused", "rle", "rotating")),
        row("build_table_device", "table_build_bucketed",
            "csrc/table_build.cu", "ops/hashtable.py:129", "rle_bucketed",
            ("rle_bucketed",)),
    ]
    for r, v in routes.items():
        if "times" in v:
            kind = {"host": "cold", "rotating": "close set built, device "
                    "builds"}.get(r, "warm")
            print(f"{kind} s/genome, {r} route: {summary(v['times'])}",
                  flush=True)
    apply_lookups = measured["apply_rows"]["windows"] / measured[
        "apply_rows"]["launch_ms"] * 1e3
    print(f"kmer lookups/s, kernel alone: apply_flat on the "
          f"{BIG_KEYS // 10**6}M-key 8-slot table (HBM-resident) "
          f"{measured['apply_flat']['lookups_per_s']:.4e}; apply_rows on the "
          f"1M-key wide table (L2-resident) {apply_lookups:.4e}; the sliced "
          f"probe {BIG_QUERIES / walks['sliced_ms'] * 1e3:.4e}, the apply "
          f"kernel's walk of the same queries "
          f"{BIG_QUERIES / walks['walk_ms'] * 1e3:.4e}", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
