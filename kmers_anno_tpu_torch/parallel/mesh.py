"""A (data, table) mesh of members and the apply steps over it.

Counterpart of ``kmers_anno_tpu/parallel/mesh.py``.  A mesh is a grid of
``n_data x n_table`` members, each a ``torch.device``; a device may stand
for several members (virtual members: the CPU tests run a 4x2 mesh on
the CPU, and one card can hold a 2x2 mesh).  A data row votes one flat
token stream; the table axis holds the signature table in one of three
layouts (SURVEY.md §5.8):

* **replicated** — every member holds the whole table; the row's first
  member runs the flat apply step (``ops.apply_flat``, the kernels of
  ``csrc/apply_flat.cu`` on a card) with the table's key filter;
* **broadcast-sharded** (``sharded_apply_step``) — keys are partitioned
  on the host by ``mix_kmer(key) % n_shards`` into per-shard tables of one
  bucket count; member j of a row holds shard j, packs every window of the
  row's stream and looks it up in its shard (``ops.probe_keys``), and the
  shards' answers merge with a maximum (the reference's ``pmax``: exactly
  one shard owns a key, and a miss, -1, loses);
* **all_to_all-routed** (``routed_apply_step``) — the row's stream is
  split over the table axis too, with a k-1 halo; each member packs its
  chunk, buckets each valid window's key by owner shard (its rank within
  the bucket by a cumulative sum a shard, stable), and one exchange with
  split sizes hands every key with its protein to its owner: the row's
  live counts are read on the host once, and owner s receives only the
  live prefix of each member's bucket s.  The owner looks the keys up and
  reduces partial votes per protein; the partial votes merge by sum, min
  and max (weighted: exact int64 tallies, summed before the one float32
  conversion).

A table-axis exchange is a plain tensor exchange among one row's members:
a ``.to()`` where two members' devices differ, the merge on the row's
first member.  Every step is a plain function over the members (no
``shard_map``); it takes the rows' host arrays, places each row's share on
its members and returns host arrays.  The per-window DNA steps
(``replicated_probe_step``, ``sharded_probe_step``) return every window's
payload, which the host clusters by position.

Multi-process runs (``parallel.distributed``) give each process whole data
rows; the steps run on the rows a process holds (``rows=``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.apply_flat import apply_flat, apply_weighted_flat
from ..ops.dna_probe import probe_dna
from ..ops.hashing import mix_kmer, mix_kmer_np
from ..ops.hashtable import build_table, table_size_for
from ..ops.key_filter import build_key_filter, table_keys
from ..ops.kmers import pack_kmer_windows
from ..ops.probe_keys import EMPTY_KEY, probe_keys
from ..ops.vote import (best_of_units, split_packed_payload, tally_units,
                        vote_block)

_INT32_MAX = 2**31 - 1


class Mesh:
    """A (data, table) grid of members: ``devices[i][j]`` is member (i, j)'s
    device (None for a member another process holds) and
    ``processes[i][j]`` the rank that holds it."""

    def __init__(self, devices: list[list], processes: list[list[int]]):
        self.devices = devices
        self.processes = processes
        self.shape = {"data": len(devices), "table": len(devices[0])}

    @property
    def n_data(self) -> int:
        return self.shape["data"]

    @property
    def n_table(self) -> int:
        return self.shape["table"]

    def first(self, row: int) -> torch.device:
        """The member a row's merges and votes run on."""
        return self.devices[row][0]


def make_mesh(n_data: int, n_table: int = 1, devices: list | None = None,
              processes: list[int] | None = None) -> Mesh:
    """A (data, table) mesh over the first n_data*n_table members.

    devices: the members, in order (default: every visible card); a
    device may appear more than once.  processes: each member's rank
    (default: all 0)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    need = n_data * n_table
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    if processes is None:
        processes = [0] * len(devices)
    grid = [list(devices[i * n_table: (i + 1) * n_table])
            for i in range(n_data)]
    procs = [list(processes[i * n_table: (i + 1) * n_table])
             for i in range(n_data)]
    return Mesh(grid, procs)


# ---------------------------------------------------------------------------
# tables (host build, placement on the members)
# ---------------------------------------------------------------------------

def shard_signature_table(key_lo: np.ndarray, key_hi: np.ndarray,
                          values: np.ndarray, n_shards: int,
                          load_factor: float = 0.5):
    """Partition keys by hash and build one bucketed table per shard
    (``mesh.py:74-100``).

    returns (tables (n_shards, B, 24) uint32 np array, max_probes int)
    All shard tables share the bucket count of the largest shard, so the
    stack is rectangular.
    """
    h = mix_kmer_np(key_lo.astype(np.uint32), key_hi.astype(np.uint32))
    owner = (h % np.uint32(n_shards)).astype(np.int64)
    counts = np.bincount(owner, minlength=n_shards)
    n_buckets = table_size_for(int(counts.max()), load_factor)
    tables = []
    max_probes = 1
    for s in range(n_shards):
        mask = owner == s
        tbl, probes = build_table(key_lo[mask], key_hi[mask],
                                  values[mask].astype(np.uint32),
                                  n_buckets=n_buckets)
        tables.append(tbl)
        max_probes = max(max_probes, probes)
    return np.stack(tables), max_probes


class MemberTables:
    """Host tables placed on a mesh's members, each with the key filter of
    its own keys: one copy a (shard, device), however many members share
    the device.  ``sharded`` gives member (i, j) shard j; otherwise every
    member holds shard 0, the whole table."""

    def __init__(self, mesh: Mesh, tables: np.ndarray, rows: list[int],
                 sharded: bool):
        self.sharded = sharded
        self._placed: dict = {}
        for i in rows:
            for j in range(mesh.n_table):
                s = j if sharded else 0
                dev = mesh.devices[i][j]
                if (s, dev) in self._placed:
                    continue
                host = np.ascontiguousarray(tables[s])
                table = torch.from_numpy(host.view(np.int32)).to(dev)
                key_filter = build_key_filter(*table_keys(host), dev)
                self._placed[(s, dev)] = (table, key_filter)

    def on(self, mesh: Mesh, row: int, col: int):
        """(table, key_filter) of member (row, col)."""
        s = col if self.sharded else 0
        return self._placed[(s, mesh.devices[row][col])]


# ---------------------------------------------------------------------------
# votes (plain torch, on the row's first member)
# ---------------------------------------------------------------------------

def _hits(vals, seg_ids, n_seqs):
    """The payloads and proteins (int64) of the lookups that hit a protein
    below ``n_seqs`` (an invalid key's lookup gives -1, a miss).
    Compacted before any scatter: the misses would otherwise all land on
    one overflow cell, whose atomics on the card run one after another."""
    keep = (vals >= 0) & (seg_ids >= 0) & (seg_ids < n_seqs)
    idx = keep.nonzero().squeeze(1)
    return vals[idx], seg_ids[idx].to(torch.int64)


def _partial_unanimous(vals, seg_ids, n_seqs):
    """One member's (hit count, min role, max role) of every protein."""
    vals, seg = _hits(vals, seg_ids, n_seqs)
    dev = vals.device
    n_hits = torch.zeros(n_seqs, dtype=torch.int32, device=dev)
    n_hits.index_add_(0, seg, torch.ones_like(vals))
    rmin = torch.full((n_seqs,), _INT32_MAX, dtype=torch.int32,
                      device=dev).scatter_reduce(0, seg, vals, "amin")
    rmax = torch.full((n_seqs,), -1, dtype=torch.int32,
                      device=dev).scatter_reduce(0, seg, vals, "amax")
    return n_hits, rmin, rmax


def _unanimous(parts, min_hits, dev):
    """Merge members' partial tallies on ``dev`` (the reference's psum,
    pmin and pmax) and call: (role or -1, hit count or 0)."""
    n_hits = sum(p[0].to(dev) for p in parts)
    rmin = parts[0][1].to(dev)
    rmax = parts[0][2].to(dev)
    for p in parts[1:]:
        rmin = torch.minimum(rmin, p[1].to(dev))
        rmax = torch.maximum(rmax, p[2].to(dev))
    called = (n_hits > 0) & (rmin == rmax) & (n_hits >= min_hits)
    return (torch.where(called, rmax, -1).to(torch.int32),
            torch.where(called, n_hits, 0).to(torch.int32))


def _weighted(parts, min_weight, n_seqs, n_roles, dev):
    """The weighted vote of members' packed payloads (``_weighted_tally``,
    ``mesh.py:117-161``): each part is one member's (payloads, seg_ids).
    A block of roles at a time, as many as ``vote_block``
    allows, each member's exact int64 tallies (units of 2^-24) are summed
    on ``dev`` before the one float32 conversion and the first maximum; a
    later block displaces the running best only with a greater tally, so
    equal tallies call the smaller role.  Bit-equal to the single-device
    vote in every topology."""
    split = []
    for part in parts:
        vals, seg = _hits(*part, n_seqs)
        split.append((*split_packed_payload(vals), seg,
                      torch.ones_like(seg, dtype=torch.bool)))
    r_blk = vote_block(n_seqs, n_roles)
    best = torch.zeros(n_seqs, dtype=torch.float32, device=dev)
    role = torch.full((n_seqs,), -1, dtype=torch.int32, device=dev)
    for base in range(0, n_roles, r_blk):
        units = sum(tally_units(*p, n_seqs, base, r_blk).to(dev)
                    for p in split)
        bmax, barg = best_of_units(units)
        better = bmax > best
        best = torch.where(better, bmax, best)
        role = torch.where(better, barg + base, role)
    called = (best >= min_weight) & (best > 0.0)
    return (torch.where(called, role, -1).to(torch.int32),
            torch.where(called, best, 0.0))


# ---------------------------------------------------------------------------
# apply steps
# ---------------------------------------------------------------------------

def _rows(mesh: Mesh, rows):
    return list(range(mesh.n_data)) if rows is None else list(rows)


def _on(array, dev, cache: dict | None = None):
    """A host array (or CPU tensor) as a tensor on ``dev``, once a device
    when a ``cache`` is given."""
    if cache is not None and dev in cache:
        return cache[dev]
    t = torch.as_tensor(array).to(dev)
    if cache is not None:
        cache[dev] = t
    return t


def _download(outs) -> tuple:
    """Stack rows' device results into host tensors."""
    return tuple(torch.stack([o[i].cpu() for o in outs])
                 for i in range(len(outs[0])))


def replicated_apply_step(mesh: Mesh, *, k: int, max_probes: int,
                          n_seqs: int, weighted: bool = False,
                          n_roles: int = 0):
    """The apply step with the table replicated, token streams one a data
    row (``mesh.py:173-200``).

    Returned fn: (tables ``MemberTables``, codes (R, T), seg_ids (R, T),
    valid (R, T), thresh, rows=None) → (roles (R, n_seqs) int32, hits (R,
    n_seqs)) host tensors, R the rows (default: every row of the mesh).
    Each row's first member runs ``apply_flat`` (weighted:
    ``apply_weighted_flat``, float32 tallies, the threshold a min_weight).
    """

    def step(tables, codes, seg_ids, valid, thresh, rows=None):
        outs = []
        for r, i in enumerate(_rows(mesh, rows)):
            dev = mesh.first(i)
            table, key_filter = tables.on(mesh, i, 0)
            args = [_on(a[r], dev) for a in (codes, seg_ids, valid)]
            kw = dict(k=k, max_probes=max_probes, n_seqs=n_seqs,
                      key_filter=key_filter)
            if weighted:
                outs.append(apply_weighted_flat(table, *args, float(thresh),
                                                n_roles=n_roles, **kw))
            else:
                outs.append(apply_flat(table, *args, int(thresh), **kw))
        return _download(outs)

    return step


def sharded_apply_step(mesh: Mesh, *, k: int, max_probes: int, n_seqs: int,
                       weighted: bool = False, n_roles: int = 0):
    """The apply step with the table hash-sharded over the table axis and
    the merge by maximum (``mesh.py:203-236``).

    Returned fn: as :func:`replicated_apply_step`'s.  Member j of a row
    packs every window of the row's stream and looks it up in shard j
    (``probe_keys`` with the shard's key filter); the row's first member
    takes the maximum of the members' payloads and votes.  The merge
    serves weighted payloads too: they are non-negative.
    """

    def step(tables, codes, seg_ids, valid, thresh, rows=None):
        outs = []
        for r, i in enumerate(_rows(mesh, rows)):
            dev0 = mesh.first(i)
            placed_codes, placed_valid, keys = {}, {}, {}
            merged = None
            for j in range(mesh.n_table):
                dev = mesh.devices[i][j]
                c = _on(codes[r], dev, placed_codes)
                v = _on(valid[r], dev, placed_valid)
                if dev not in keys:
                    keys[dev] = pack_kmer_windows(c, k)
                table, key_filter = tables.on(mesh, i, j)
                local = probe_keys(table, *keys[dev], v,
                                   max_probes=max_probes,
                                   key_filter=key_filter).to(dev0)
                merged = local if merged is None else torch.maximum(merged,
                                                                    local)
            s0 = _on(seg_ids[r], dev0)
            if weighted:
                outs.append(_weighted([(merged, s0)], float(thresh),
                                      n_seqs, n_roles, dev0))
            else:
                outs.append(_unanimous(
                    [_partial_unanimous(merged, s0, n_seqs)],
                    int(thresh), dev0))
        return _download(outs)

    return step


def split_tokens_for_table_axis(codes: np.ndarray, seg_ids: np.ndarray,
                                valid: np.ndarray, n_table: int, k: int,
                                n_seqs: int, pad_code: int):
    """Split one flat token stream into n_table chunks with k-1 halos
    (``mesh.py:244-274``).

    Chunk c covers core token positions [c·Tc, (c+1)·Tc) plus a k-1 halo so
    every kmer window starting in the core is packable locally; ``valid`` is
    True only at core starts, so each window is routed exactly once.

    returns (codes (n_table, Tc+k-1) uint8, seg_ids (…) int32,
             valid (…) bool).
    """
    t = len(codes)
    tc = -(-t // n_table)
    width = tc + k - 1
    total = n_table * tc + k - 1
    pc = np.full(total, pad_code, codes.dtype)
    ps = np.full(total, n_seqs, np.int32)
    pv = np.zeros(total, bool)
    pc[:t] = codes
    ps[:t] = seg_ids
    pv[:t] = valid
    out_c = np.empty((n_table, width), codes.dtype)
    out_s = np.empty((n_table, width), np.int32)
    out_v = np.zeros((n_table, width), bool)
    for c in range(n_table):
        lo = c * tc
        out_c[c] = pc[lo: lo + width]
        out_s[c] = ps[lo: lo + width]
        out_v[c, :tc] = pv[lo: lo + tc]   # halo starts stay invalid
    return out_c, out_s, out_v


def route_keys(codes: torch.Tensor, seg_ids: torch.Tensor,
               valid: torch.Tensor, *, k: int, n_table: int, capacity: int,
               n_seqs: int):
    """One member's routing buffers (``mesh.py:320-336``): pack its
    chunk's windows and place each valid window's (lo, hi, seg) in the
    bucket of its owner shard, ``mix_kmer % n_table``, at its rank among
    that owner's keys in stream order.

    returns (lo, hi, seg (n_table, capacity) int32, overflow bool tensor,
    live (n_table,) int64): empty slots hold EMPTY keys and segment
    ``n_seqs``; a key ranked past ``capacity`` is dropped and sets
    ``overflow``; ``live[s]`` is owner s's key count cut to ``capacity``,
    the length of the live prefix of its bucket.
    """
    lo, hi = pack_kmer_windows(codes, k)
    dev = codes.device
    owner = torch.where(valid, mix_kmer(lo, hi) % n_table, n_table)
    rank = torch.zeros(owner.shape, dtype=torch.int64, device=dev)
    counts = []
    for s in range(n_table):       # a cumulative sum a shard: stable
        mine = owner == s
        csum = torch.cumsum(mine, 0)
        rank = torch.where(mine, csum - 1, rank)
        counts.append(csum[-1:])
    counts = torch.cat(counts)
    ok = (owner < n_table) & (rank < capacity)
    sink = n_table * capacity
    slot = torch.where(ok, owner * capacity + rank, sink)
    out = []
    for vals, fill in ((lo, EMPTY_KEY), (hi, EMPTY_KEY), (seg_ids, n_seqs)):
        buf = torch.full((sink + 1,), fill, dtype=torch.int32, device=dev)
        buf[slot] = vals
        out.append(buf[:sink].view(n_table, capacity))
    return (*out, (counts > capacity).any(), counts.clamp(max=capacity))


def split_sizes(sent, dev) -> tuple[list[list[int]], bool]:
    """The host read of a row's split sizes, one synchronisation a row:
    ``sizes[c][s]``, the live keys member c sends owner s, and whether a
    bucket of the row overflowed.  ``sent``: each member's
    :func:`route_keys` buffers; ``dev``: the row's first member."""
    head = torch.stack([torch.cat([b[4], b[3].view(1).to(torch.int64)])
                        .to(dev) for b in sent]).tolist()
    return [h[:-1] for h in head], any(h[-1] for h in head)


def exchange_keys(sent, sizes, devs) -> list[tuple]:
    """The all_to_all with split sizes: owner s receives, on ``devs[s]``,
    the live prefix of bucket s of every member's buffers, in member
    order: a dense (lo, hi, seg) of ``sum(sizes[c][s])`` keys each."""
    return [tuple(torch.cat([b[w][s, : sizes[c][s]].to(devs[s])
                             for c, b in enumerate(sent)])
                  for w in range(3))
            for s in range(len(devs))]


def routed_apply_step(mesh: Mesh, *, k: int, max_probes: int, n_seqs: int,
                      capacity: int | None = None, weighted: bool = False,
                      n_roles: int = 0):
    """The apply step routing kmers to their owner shard
    (``mesh.py:277-395``).

    Returned fn: (tables ``MemberTables`` (sharded), codes (R, n_table,
    Tc), seg_ids (…), valid (…), thresh, rows=None), the layout of
    :func:`split_tokens_for_table_axis`, → (roles (R, n_seqs) int32, hits
    (R, n_seqs), overflow int: 1 if a routing bucket of these rows
    overflowed ``capacity``, and the results then undercount).  The
    default capacity, Tc, cannot overflow.

    Member c of a row packs chunk c and routes its keys
    (:func:`route_keys`); the row's split sizes are read on the host
    (:func:`split_sizes`), and the exchange hands member s the live keys
    of bucket s of every member's buffers (:func:`exchange_keys`); member s
    looks them up in its shard (``probe_keys``; an owner that receives no
    key launches nothing) and reduces partial votes, which merge on the
    row's first member.  Weighted: each member's exact
    int64 partial tallies, summed there before the float32 conversion.
    """
    n_table = mesh.n_table

    def step(tables, codes, seg_ids, valid, thresh, rows=None):
        outs, overflow = [], False
        for r, i in enumerate(_rows(mesh, rows)):
            devs = mesh.devices[i]
            dev0 = devs[0]
            cap = codes.shape[-1] if capacity is None else capacity
            sent = [route_keys(*(_on(a[r][c], devs[c])
                                 for a in (codes, seg_ids, valid)),
                               k=k, n_table=n_table, capacity=cap,
                               n_seqs=n_seqs)
                    for c in range(n_table)]
            sizes, row_overflow = split_sizes(sent, dev0)
            overflow |= row_overflow
            parts = []
            for s, (rlo, rhi, rseg) in enumerate(exchange_keys(sent, sizes,
                                                               devs)):
                table, key_filter = tables.on(mesh, i, s)
                vals = probe_keys(table, rlo, rhi, None,
                                  max_probes=max_probes,
                                  key_filter=key_filter)
                if weighted:
                    parts.append((vals, rseg))
                else:
                    parts.append(_partial_unanimous(vals, rseg, n_seqs))
            if weighted:
                outs.append(_weighted(parts, float(thresh), n_seqs, n_roles,
                                      dev0))
            else:
                outs.append(_unanimous(parts, int(thresh), dev0))
        return (*_download(outs), int(overflow))

    return step


# ---------------------------------------------------------------------------
# per-window probe steps (DNA mode: hits are clustered by position on the
# host, so the mesh returns every window's payload, not a vote)
# ---------------------------------------------------------------------------

def replicated_probe_step(mesh: Mesh, *, k: int, max_probes: int):
    """(tables ``MemberTables``, codes (R, T), valid (R, T), rows=None) →
    payloads (R, T) int32 (``mesh.py:398-417``): the table replicated, a
    DNA window stream a data row, probed on the row's first member
    (``probe_dna`` with the table's key filter)."""

    def step(tables, codes, valid, rows=None):
        outs = []
        for r, i in enumerate(_rows(mesh, rows)):
            dev = mesh.first(i)
            table, key_filter = tables.on(mesh, i, 0)
            outs.append((probe_dna(table, _on(codes[r], dev),
                                   _on(valid[r], dev), k=k,
                                   max_probes=max_probes,
                                   key_filter=key_filter),))
        return _download(outs)[0]

    return step


def sharded_probe_step(mesh: Mesh, *, k: int, max_probes: int):
    """The per-window probe with the table hash-sharded over the table
    axis (``mesh.py:420-447``): member j of a row probes the row's whole
    stream against shard j (``probe_dna`` with the shard's key filter) and
    the row's first member takes the maximum, a merge that keeps every
    window's position.  Fn as :func:`replicated_probe_step`'s."""

    def step(tables, codes, valid, rows=None):
        outs = []
        for r, i in enumerate(_rows(mesh, rows)):
            dev0 = mesh.first(i)
            placed_codes, placed_valid = {}, {}
            merged = None
            for j in range(mesh.n_table):
                dev = mesh.devices[i][j]
                table, key_filter = tables.on(mesh, i, j)
                local = probe_dna(table, _on(codes[r], dev, placed_codes),
                                  _on(valid[r], dev, placed_valid), k=k,
                                  max_probes=max_probes,
                                  key_filter=key_filter).to(dev0)
                merged = local if merged is None else torch.maximum(merged,
                                                                    local)
            outs.append((merged,))
        return _download(outs)[0]

    return step
