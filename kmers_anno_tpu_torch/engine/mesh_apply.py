"""Multi-device signature-table annotation (the ``apply --mesh`` path).

Counterpart of ``kmers_anno_tpu/engine/mesh_apply.py``.  Streams genome
batches across the data axis of a (data, table) mesh of members
(``parallel.mesh``) and runs one of its apply steps:

* ``replicated`` — the table copied to every member, genomes fanned over
  the data axis;
* ``pmax``       — the table hash-sharded over the table axis, every
  window looked up in every shard, the answers merged by maximum;
* ``routed``     — the table hash-sharded and each window's key routed to
  its owner shard by one exchange (the default when the table axis is >1).

Per-genome results equal the single-device ``KmerApplyEngine``'s, down to
report bytes, weighted tallies bit for bit: every vote sums exact integer
or int64 fixed-point tallies.  Genomes are grouped into chunks of
``n_data`` consecutive rows sharing one bucketed shape; chunk rows past
the last genome are padding.

A ``capacity_factor`` below the worst case trades routing-buffer size for
a rare re-run: the routed step reports whether a buffer overflowed, and an
overflowed chunk runs again at the safe capacity, so results stay exact.

Members come from ``devices=``: this process's devices, a device as often
as it stands for members.  In a multi-process run
(``parallel.distributed``) each process contributes the same number of
members, the mesh takes them in rank order, and each data row's members
must lie in one process; a process encodes and runs only its own rows,
and the rows' results reach every process by a host allgather.
"""

from __future__ import annotations

import logging
from typing import Iterable, Iterator

import numpy as np
import torch

from ..device import pow2_bucket
from ..genome.gto import Feature, Genome
from ..ops.encode import DNA_PAD, PROT_PAD
from ..ops.hashtable import build_table
from ..parallel.distributed import allgather, process_count, process_index
from ..parallel.mesh import (MemberTables, make_mesh, replicated_apply_step,
                             replicated_probe_step, routed_apply_step,
                             shard_signature_table, sharded_apply_step,
                             sharded_probe_step, split_tokens_for_table_axis)
from .apply_engine import FlatBatch
from .dna_apply import DnaContigBatch, cluster_calls
from .signature import SignatureTable

log = logging.getLogger(__name__)


def parse_mesh_spec(spec: str) -> tuple[int, int]:
    """'DxT' → (n_data, n_table); 'D' → (D, 1)."""
    parts = spec.lower().replace("×", "x").split("x")
    try:
        if len(parts) == 1:
            return int(parts[0]), 1
        if len(parts) == 2:
            return int(parts[0]), int(parts[1])
    except ValueError:
        pass
    raise ValueError(f"bad mesh spec {spec!r}; expected DATAxTABLE, e.g. 4x2")


class _MeshPlumbing:
    """The (data, table) mesh over this process's members and the
    processes' rows: each process encodes and runs the data rows its
    members hold, and reads every row's results back by a host
    allgather."""

    def __init__(self, n_data: int, n_table: int, devices: list):
        self.n_data = n_data
        self.n_table = n_table
        devices = [torch.device(d) for d in devices]
        self.n_proc = process_count()
        me = process_index()
        if self.n_proc > 1:
            counts = allgather(len(devices))
            if len(set(counts)) != 1:
                raise ValueError("every process must contribute the same "
                                 f"number of members, got {counts}")
            members = [devices[m] if p == me else None
                       for p in range(self.n_proc) for m in range(counts[0])]
            procs = [p for p in range(self.n_proc) for _ in range(counts[0])]
            self.mesh = make_mesh(n_data, n_table, members, procs)
            row_proc = []
            for i in range(n_data):
                held = set(self.mesh.processes[i])
                if len(held) != 1:
                    raise ValueError(
                        "multi-process meshes must keep each data row's "
                        "table axis within one process "
                        f"(row {i} spans processes {sorted(held)})")
                row_proc.append(held.pop())
            self.rows_mine = [i for i, p in enumerate(row_proc) if p == me]
        else:
            self.mesh = make_mesh(n_data, n_table, devices)
            self.rows_mine = list(range(n_data))

    def _place_tables(self, signatures: SignatureTable, weighted: bool,
                      sharded: bool) -> None:
        """Build the table on the host, whole or hash-sharded over the
        table axis, and place it on this process's members (``tables``,
        with the walk bound ``max_probes``)."""
        payloads = signatures._payloads(weighted)
        if sharded:
            tables, self.max_probes = shard_signature_table(
                signatures.key_lo, signatures.key_hi, payloads, self.n_table)
        else:
            table, self.max_probes = build_table(
                signatures.key_lo, signatures.key_hi, payloads)
            tables = table[None]
        self.tables = MemberTables(self.mesh, tables, self.rows_mine,
                                   sharded)

    def _host(self, local: tuple) -> tuple:
        """This process's rows' host tensors → every row's, on every
        process (the gloo allgather; rows in rank order)."""
        if self.n_proc == 1:
            return local
        parts = [p for p in allgather(local) if p[0].shape[0]]
        return tuple(torch.cat([p[n] for p in parts])
                     for n in range(len(local)))


class MeshApplyEngine(_MeshPlumbing):
    """Annotates genome streams of protein pegs on a (data, table) mesh.

    weighted=True swaps the unanimity vote for the weighted best-tally
    vote (packed payloads) in every mode, the routed one included: the
    members' partial tallies are exact int64 sums, so the results equal
    ``KmerApplyEngine(weighted=True)``'s bit for bit in every topology.
    """

    def __init__(self, signatures: SignatureTable, n_data: int,
                 n_table: int = 1, min_hits: int = 5, mode: str = "auto",
                 capacity_factor: float | None = None,
                 weighted: bool = False, min_weight: float | None = None, *,
                 devices: list):
        if mode == "auto":
            mode = "replicated" if n_table == 1 else "routed"
        if mode not in ("replicated", "pmax", "routed"):
            raise ValueError(f"unknown table mode {mode!r}")
        if n_table == 1 and mode != "replicated":
            raise ValueError("sharded modes need a table axis > 1")
        if signatures.alphabet != "prot":
            raise ValueError("MeshApplyEngine requires a protein table; a "
                             "DNA table runs DnaMeshApplyEngine")
        super().__init__(n_data, n_table, devices)
        self.mode = mode
        self.k = signatures.k
        self.min_hits = min_hits
        self.weighted = weighted
        self.min_weight = float(min_hits if min_weight is None
                                else min_weight)
        self.capacity_factor = capacity_factor
        self.role_ids = signatures.role_ids
        self._place_tables(signatures, weighted, mode != "replicated")

    def _thresh(self):
        return self.min_weight if self.weighted else self.min_hits

    def _step(self, n_seqs: int, capacity: int | None):
        kw = dict(k=self.k, max_probes=self.max_probes, n_seqs=n_seqs,
                  weighted=self.weighted, n_roles=len(self.role_ids))
        if self.mode == "replicated":
            return replicated_apply_step(self.mesh, **kw)
        if self.mode == "pmax":
            return sharded_apply_step(self.mesh, **kw)
        return routed_apply_step(self.mesh, capacity=capacity, **kw)

    # ----- one chunk of ≤ n_data genomes -----

    def encode_chunk(self, chunk: list[tuple[Genome, list[Feature]]]):
        """Host encode of this process's rows of a chunk: (codes, seg_ids,
        valid) (rows, width) arrays and the chunk's ``n_seqs``.  Widths and
        protein counts are bucketed over the WHOLE chunk, so every process
        shapes its rows alike."""
        prots = [[f.protein_translation for f in pegs]
                 for _, pegs in chunk]
        width = pow2_bucket(
            max((sum(map(len, p)) for p in prots), default=1), 16384)
        n_seqs = pow2_bucket(max((len(p) for p in prots), default=1), 256)
        n_local = len(self.rows_mine)
        codes = np.full((n_local, width), PROT_PAD, np.uint8)
        seg_ids = np.full((n_local, width), n_seqs, np.int32)
        valid = np.zeros((n_local, width), bool)
        for j, i in enumerate(self.rows_mine):
            if i < len(prots):
                b = FlatBatch(prots[i], self.k, min_tokens=width,
                              min_seqs=n_seqs)
                codes[j], seg_ids[j], valid[j] = b.codes, b.seg_ids, b.valid
        return codes, seg_ids, valid, n_seqs

    def run_rows(self, codes, seg_ids, valid, n_seqs):
        """The device step of this process's encoded rows: (roles, hits)
        host tensors, (rows, n_seqs)."""
        if self.mode == "routed":
            return self._run_routed(codes, seg_ids, valid, n_seqs)
        return self._step(n_seqs, None)(
            self.tables, codes, seg_ids, valid, self._thresh(),
            rows=self.rows_mine)

    def _run_chunk(self, chunk: list[tuple[Genome, list[Feature]]]
                   ) -> list[list[tuple[Feature, str, int]]]:
        codes, seg_ids, valid, n_seqs = self.encode_chunk(chunk)
        if self.rows_mine:
            local = self.run_rows(codes, seg_ids, valid, n_seqs)
        else:
            empty = torch.empty((0, n_seqs), dtype=torch.int32)
            local = (empty, empty.to(torch.float32 if self.weighted
                                     else torch.int32))
        roles, hits = (t.numpy() for t in self._host(local))
        conv = (lambda h: round(float(h), 4)) if self.weighted else int
        return [[(feat, self.role_ids[r], conv(h))
                 for feat, r, h in zip(pegs, roles[i], hits[i]) if r >= 0]
                for i, (_, pegs) in enumerate(chunk)]

    def _run_routed(self, codes, seg_ids, valid, n_seqs):
        rows = [split_tokens_for_table_axis(
                    codes[j], seg_ids[j], valid[j], self.n_table, self.k,
                    n_seqs, PROT_PAD)
                for j in range(codes.shape[0])]
        sc, ss, sv = (np.stack([r[w] for r in rows]) for w in range(3))
        tc = sc.shape[-1]
        capacity = None
        if self.capacity_factor is not None:
            capacity = min(tc, int(np.ceil(
                tc / self.n_table * self.capacity_factor)))
        args = (self.tables, sc, ss, sv, self._thresh())
        r, h, ovf = self._step(n_seqs, capacity)(*args, rows=self.rows_mine)
        if capacity is not None and ovf:
            log.info("Routing capacity %d overflowed; re-running chunk at "
                     "the safe bound %d.", capacity, tc)
            r, h, ovf = self._step(n_seqs, None)(*args, rows=self.rows_mine)
        if ovf:
            raise RuntimeError("the safe routing capacity overflowed")
        return r, h

    # ----- the genome stream -----

    def call_genomes(self, genomes: Iterable[Genome]
                     ) -> Iterator[tuple[Genome, list]]:
        """Yield (genome, [(feature, role_id, hits), …]) in input order,
        grouping ``n_data`` genomes per device step."""
        chunk: list[tuple[Genome, list[Feature]]] = []

        def flush():
            if not chunk:
                return
            for (genome, _), calls in zip(chunk, self._run_chunk(chunk)):
                yield genome, calls
            chunk.clear()

        for genome in genomes:
            pegs = [f for f in genome.pegs if f.protein_translation]
            chunk.append((genome, pegs))
            if len(chunk) == self.n_data:
                yield from flush()
        yield from flush()


class DnaMeshApplyEngine(_MeshPlumbing):
    """DNA-mode annotation on a (data, table) mesh.

    Each data row carries one genome's two-strand contig window stream
    (``DnaContigBatch``); the probe returns every window's payload, because
    DNA hits are clustered by position on the host (``cluster_calls``, as
    ``DnaApplyEngine``).  n_table == 1 replicates the table; n_table > 1
    hash-shards it and merges every window's answers by maximum
    (``sharded_probe_step``).  Weighted tables come back as packed
    payloads, and the clustering thresholds on summed hit weight.
    """

    def __init__(self, signatures: SignatureTable, n_data: int,
                 n_table: int = 1, min_hits: int = 5, max_gap: int = 500,
                 weighted: bool = False, min_weight: float | None = None, *,
                 devices: list):
        if signatures.alphabet != "dna":
            raise ValueError("DnaMeshApplyEngine requires a DNA table")
        super().__init__(n_data, n_table, devices)
        self.k = signatures.k
        self.min_hits = min_hits
        self.max_gap = max_gap
        self.weighted = weighted
        self.min_weight = float(min_hits if min_weight is None
                                else min_weight)
        self.role_ids = signatures.role_ids
        self._place_tables(signatures, weighted, n_table > 1)

    def _step(self):
        kw = dict(k=self.k, max_probes=self.max_probes)
        if self.n_table == 1:
            return replicated_probe_step(self.mesh, **kw)
        return sharded_probe_step(self.mesh, **kw)

    def encode_chunk(self, chunk: list[tuple[Genome, DnaContigBatch]]):
        """This process's rows of a chunk as (codes, valid) (rows, width)
        arrays, the width bucketed over the whole chunk."""
        width = pow2_bucket(
            max((len(b.codes) for _, b in chunk), default=1), 1 << 16)
        n_local = len(self.rows_mine)
        codes = np.full((n_local, width), DNA_PAD, np.uint8)
        valid = np.zeros((n_local, width), bool)
        for j, i in enumerate(self.rows_mine):
            if i < len(chunk):
                b = chunk[i][1]
                codes[j, : len(b.codes)] = b.codes
                valid[j, : len(b.valid)] = b.valid
        return codes, valid

    def _run_chunk(self, chunk: list[tuple[Genome, DnaContigBatch]]
                   ) -> list[list[tuple[Feature, str, int | float]]]:
        codes, valid = self.encode_chunk(chunk)
        if self.rows_mine:
            local = self._step()(self.tables, codes, valid,
                                 rows=self.rows_mine)
        else:
            local = torch.empty((0, codes.shape[1]), dtype=torch.int32)
        vals = self._host((local,))[0].numpy()
        return [cluster_calls(genome, batch, vals[i], self.k, self.max_gap,
                              self.min_hits, self.role_ids,
                              weighted=self.weighted,
                              min_weight=self.min_weight)
                for i, (genome, batch) in enumerate(chunk)]

    def call_genomes(self, genomes: Iterable[Genome]
                     ) -> Iterator[tuple[Genome, list]]:
        """Yield (genome, [(region feature, role_id, hits), …]) in input
        order, grouping ``n_data`` genomes per device step."""
        chunk: list[tuple[Genome, DnaContigBatch]] = []

        def flush():
            if not chunk:
                return
            for (genome, _), calls in zip(chunk, self._run_chunk(chunk)):
                yield genome, calls
            chunk.clear()

        for genome in genomes:
            batch = DnaContigBatch(
                [(c.id, c.sequence) for c in genome.contigs], self.k)
            chunk.append((genome, batch))
            if len(chunk) == self.n_data:
                yield from flush()
        yield from flush()
