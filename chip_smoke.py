#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Builds the CUDA kernels from ``kmers_anno_tpu_torch/csrc`` and holds each
against its plain-PyTorch version on made-up inputs at full size (k = 8
and 12, many hits).  Then drives the ``kmers`` command end to end on a
2.94 Mb genome with 3500 planted genes and 10 close genomes (the
"realistic" projection workload of bench.py, seed 0), checks every close
genome's counts against the single-core C++ hot loop
(``ProjectionBaseline``), and holds each kernel against its plain version
again on the inputs that path gives it: the genome's padded window stream
and the ten close-genome tables.  Those last comparisons give the
``kernels`` line's times and errors.

Usage, from the repository root:  python3 chip_smoke.py

Prints the card's name and power limit, the kernel comparisons and timings,
one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Any failed check raises, so the exit code is non-zero and no result line
is printed; so does a machine without CUDA.  Imports only torch, numpy
and the port (``kmers_anno_tpu_torch``), never jax.
"""

from __future__ import annotations

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
WARM_RUNS = 5


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def timed(fn, reps: int = REPS) -> tuple[float, object]:
    """Median milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up run, each timed by CUDA events recorded on the current stream
    before and after it (the stream's time from the first to the last
    launch, host gaps between launches included)."""
    out = fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times), out


def max_abs_err(pairs) -> int:
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               for a, b in pairs)


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

def make_projection_workload(rng, n_genes, n_close, lo_cod=60, hi_cod=500):
    """Synthetic genome with planted clean ORFs + close genomes carrying
    the source proteins (the generator of bench.py's projection bench)."""
    from kmers_anno_tpu_torch.host import (DnaTranslator, Genome,
                                           reverse_complement)

    xl = DnaTranslator(11)
    parts = ["".join("acgt"[c] for c in rng.integers(0, 4, 50))]
    genes = []
    for i in range(n_genes):
        n_cod = int(rng.integers(lo_cod, hi_cod))
        body = "".join("tcag"[c] for c in rng.integers(0, 4, 3 * n_cod))
        # force a clean ORF: atg + stop-free frame + taa
        codons = [body[j: j + 3] for j in range(0, len(body), 3)]
        codons = [c for c in codons if c not in ("taa", "tag", "tga")]
        gene = "atg" + "".join(codons) + "taa"
        strand = "+" if i % 2 == 0 else "-"
        parts.append(gene if strand == "+" else reverse_complement(gene))
        parts.append("".join("acgt"[c] for c in rng.integers(0, 4, 30)))
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


def check_kernels_on_main_path(dev, genome, annot) -> dict:
    """Each kernel against its plain version on the inputs the main path
    gives it: the contig scanner on the genome's padded window stream, the
    probe on that stream's window keys against every cached close-genome
    table.  Exact equality over every output; CUDA-event times."""
    from kmers_anno_tpu_torch.engine.projection import StreamWindowIndex
    from kmers_anno_tpu_torch.ops.contig_scan import (scan_stream,
                                                      scan_stream_plain)
    from kmers_anno_tpu_torch.ops.translate import codon_lut
    from kmers_anno_tpu_torch.ops.widetable import (probe_wide,
                                                    probe_wide_plain)

    codes, _ = StreamWindowIndex.window_stream(genome, K)
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
    scan = dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_abs_err(
        zip(got, want)))
    print(f"main path contig_scan k={K}: {stream.numel()} bases "
          f"({len(genome.contigs)} contig, both strands, padded), exact, "
          f"max_abs_err {scan['max_abs_err']}, kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms", flush=True)

    kernel_ms, plain_ms, errs, n_hits = [], [], [], 0
    n_valid = int(index.d_valid.sum())
    for table, max_probes, salt, _, _ in annot._table_cache.values():
        args = (table, index.d_lo, index.d_hi, index.d_valid, salt,
                max_probes)
        t_k, got = timed(lambda: probe_wide(*args))
        t_p, want = timed(lambda: probe_wide_plain(*args))
        require(torch.equal(got, want),
                "probe_wide differs from its plain version on the main path")
        kernel_ms.append(t_k)
        plain_ms.append(t_p)
        errs.append(max_abs_err([(got, want)]))
        n_hits += int((got >= 0).sum())
    require(len(kernel_ms) == N_CLOSE, "a close genome's table is missing")
    probe = dict(ms=statistics.median(kernel_ms),
                 plain_ms=statistics.median(plain_ms), max_abs_err=max(errs))
    print(f"main path probe_wide: {N_CLOSE} tables x {index.d_lo.numel()} "
          f"windows ({n_valid} valid), {n_hits} hits in all, exact, "
          f"max_abs_err {probe['max_abs_err']}; kernel ms per table "
          f"{', '.join(f'{t:.4f}' for t in kernel_ms)} (median "
          f"{probe['ms']:.4f}); plain {', '.join(f'{t:.4f}' for t in plain_ms)}"
          f" (median {probe['plain_ms']:.4f})", flush=True)
    return {"contig_scan": scan, "probe_wide": probe}


def run_main_path(dev, tmp: str) -> tuple[dict, dict]:
    from kmers_anno_tpu_torch.commands.app import main
    from kmers_anno_tpu_torch.engine.projection import (ProjectionAnnotator,
                                                        StreamWindowIndex,
                                                        probe_hits)
    from kmers_anno_tpu_torch.host import Genome, encode_dna, native
    from kmers_anno_tpu_torch.ops.contig_scan import scan_stream
    from kmers_anno_tpu_torch.ops.translate import codon_lut
    from kmers_anno_tpu_torch.ops.widetable import probe_wide

    t0 = time.perf_counter()
    dna, olds, new = make_projection_workload(
        np.random.default_rng(SEED), N_GENES, N_CLOSE)
    cache = os.path.join(tmp, "cache")
    os.makedirs(cache)
    for gid, og in olds.items():
        og.save(os.path.join(cache, f"{gid}.gto"))
    new_path = os.path.join(tmp, "new.gto")
    out_path = os.path.join(tmp, "out.gto")
    new.save(new_path)
    print(f"workload: {len(dna)} bases, {N_GENES} planted genes, "
          f"{len(olds)} close genomes, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    lines = _Lines()
    engine_log = logging.getLogger("kmers_anno_tpu_torch.engine.projection")
    engine_log.addHandler(lines)
    scan_stream.launches = 0
    probe_wide.launches = 0
    t0 = time.perf_counter()
    rc = main(["kmers", "--cache", cache, "-i", new_path, "-o", out_path,
               "--device", str(dev)])
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = {"contig_scan": scan_stream.launches,
                "probe_wide": probe_wide.launches}
    engine_log.removeHandler(lines)
    require(rc == 0, f"kmers exited with {rc}")
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the path never launched: {launches}")
    n_pegs = len(Genome.load(out_path).pegs)
    require(n_pegs > 0, "out.gto holds no pegs")
    print(f"kmers (cold, tables built): rc {rc}, {n_pegs} pegs, "
          f"{cold_s:.2f} s, launches {launches}", flush=True)

    got = port_counts(lines.messages)
    base = native.ProjectionBaseline(
        [encode_dna(c.sequence) for c in new.contigs],
        np.asarray(codon_lut(11), np.uint8), K)
    want = [base.match([f.protein_translation for f in og.pegs
                        if f.protein_translation], 0.50, 1.5, 0.8)
            for og in olds.values()]
    base.close()
    require(len(got) == N_CLOSE, f"{len(got)} close genomes probed")
    require(got == want, f"port counts {got} != baseline {want}")
    print(f"independent check: per close genome (matching kmers, peg/frame "
          f"pairs, proposals made) = {got[0]} x {len(got)}, equal to "
          "ProjectionBaseline", flush=True)

    annot = ProjectionAnnotator(device=dev)
    annot.annotate_genome(Genome.load(new_path), olds.get)   # warm tables
    times = []
    for _ in range(WARM_RUNS):
        genome = Genome.load(new_path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = annot.annotate_genome(genome, olds.get)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    require(stats["pegs"] == n_pegs, "warm run pegs differ from the CLI's")
    s_per_genome = statistics.median(times)
    print(f"warm annotate_genome: {s_per_genome:.4f} s/genome (median of "
          f"{WARM_RUNS}: {', '.join(f'{t:.4f}' for t in times)}), "
          f"stats {stats}", flush=True)

    # where the warm time goes: the device-side stages, timed alone
    genome = Genome.load(new_path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = StreamWindowIndex.build(genome, K, False, dev)
    torch.cuda.synchronize()
    t_index = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_hits = sum(len(probe_hits(t, salt, mp, index)[0])
                 for t, mp, salt, _, _ in annot._table_cache.values())
    t_probe = time.perf_counter() - t0
    print(f"breakdown of {s_per_genome:.4f} s: stream index (scan kernel, "
          f"masks, upload) {t_index:.4f} s; {N_CLOSE} probes with hit "
          f"compaction and pull ({n_hits} hits) {t_probe:.4f} s; host "
          f"window scan, proposals and features (the rest) "
          f"{s_per_genome - t_index - t_probe:.4f} s", flush=True)
    return launches, check_kernels_on_main_path(dev, genome, annot)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; no result")
    os.environ["KMERS_ANNO_LOG"] = "off"     # no log file in the checkout
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name}; nvidia-smi: {card}", flush=True)
    print(sys.version.split()[0], "torch", torch.__version__, "cuda",
          torch.version.cuda, flush=True)

    from kmers_anno_tpu_torch import kernels

    t0 = time.perf_counter()
    nvcc_output = kernels.build()
    kernels.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for line in nvcc_output.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip(), flush=True)

    check_contig_scan(dev)
    check_probe_wide(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches, measured = run_main_path(dev, tmp)
    require("jax" not in sys.modules, "jax was imported")

    rows = [
        dict(name="contig_scan", route="cuda",
             source="kmers_anno_tpu_torch/csrc/contig_scan.cu",
             replaces="kmers_anno_tpu/ops/pallas_contig.py:103",
             launches=launches["contig_scan"], **measured["contig_scan"]),
        dict(name="probe_wide", route="cuda",
             source="kmers_anno_tpu_torch/csrc/probe_wide.cu",
             replaces="kmers_anno_tpu/ops/widetable.py:199",
             launches=launches["probe_wide"], **measured["probe_wide"]),
    ]
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
