"""hashAnno's device chunk step: the common-kmer count matrix and the exact
first-max best-proposal update.

Counterpart of ``kmers_anno_tpu/engine/hashanno.py``'s ``_chunk_commons``
(:122-155, with the ``probe_table`` call before it, :423) and
``_chunk_best`` (:70-119).  One chunk holds the distinct kmers of up to a
few thousand prototypes; the genome batch's proteins own the kmers of an
8-slot table (``ops.hashtable``), each unique kmer's owners listed in a
row of the owner matrix.

* :func:`hash_commons` counts, for every (prototype, protein) pair, the
  kmers they share: ``common[p, o]`` = |kmers(p) ∩ kmers(o)|.  CUDA
  tensors launch ``kan_hash_commons`` (``csrc/hash_chunk.cu``): a block
  takes a tile of ``COMMONS_TILE`` chunk kmers, one a thread; a thread
  probes the table for its kmer and adds each owner's count into the
  block's table of at most ``COMMONS_TABLE_CELLS`` (prototype, owner)
  cells in shared memory, and each of its cells is one global integer
  atomic at the end of the tile (a new cell past that goes straight to the
  global matrix).  Integer adds are order-free, so the counts are exact in
  any order of the chunk's kmers; the engine packs a chunk prototype by
  prototype, which keeps a tile's cells few.
* :func:`hash_best` turns the counts into each protein's best prototype
  and folds it into the carried state (c, u, index, improvements):
  similarity is the Jaccard quotient c / u with u = n1 + n2 - c, the
  min-score floor is the f64-exact integer table ``minc``, and the
  earliest prototype wins ties.  CUDA tensors launch ``kan_hash_best``;
  it reads each cell once and clears it, so the count buffer serves the
  next chunk without a memset.

CPU tensors take the plain versions, :func:`hash_commons_plain` (the
probe, the owner gather and a ``bincount``, as the reference writes it)
and :func:`hash_best_plain` (the reference's log2 first-max tournament on
a power-of-two prototype axis); the plain best update clears the counts
too, so callers see one contract.

Exactness: c and u stay below 2^15 under the engine's 16,384-aa guard, so
every cross product c1·u2 is below 2^30 and int32 compares decide exactly
what the reference tool's float64 compares decide.
"""

from __future__ import annotations

import torch

from .. import kernels
from .hashtable import BUCKET, probe_table
from .widetable import check_probe_args

# dense (prototypes x proteins) chunks are capped at this many cells
DENSE_CELLS = 1 << 26

# chunk kmers a block of the kernel counts, and the distinct cells its
# shared table keeps (``kTileKmers``, ``kTableCells`` in csrc/hash_chunk.cu)
COMMONS_TILE = 1024
COMMONS_TABLE_CELLS = 1024

# the kernel indexes the count cells of a chunk (n_rows x n_pad) in 32 bits
MAX_CELLS = (1 << 31) - 1

# owner-matrix width cap: a kmer with more owners keeps its first OWNER_CAP
# in the device matrix and the rest in a host CSR (the engine's host route)
OWNER_CAP = 32


def _check_commons(table, max_probes, owner_mat, key_lo, key_hi, proto,
                   valid, n_rows, n_pad, out) -> None:
    check_probe_args("hash_commons", 3 * BUCKET, table, key_lo, key_hi,
                     valid, max_probes)
    if owner_mat.dim() != 2 or owner_mat.dtype != torch.int32:
        raise ValueError("hash_commons: owner_mat must be a (U, cap) int32 "
                         "tensor")
    if proto.dtype != torch.int32 or proto.shape != key_lo.shape \
            or key_lo.dim() != 1:
        raise ValueError("hash_commons: keys, proto and valid must be 1-D, "
                         "proto int32")
    if n_rows < 0 or n_pad < 1:
        raise ValueError("hash_commons: n_rows >= 0 and n_pad >= 1")
    if n_rows * n_pad > MAX_CELLS:
        raise ValueError(f"hash_commons: n_rows x n_pad must be at most "
                         f"{MAX_CELLS} cells")
    if out is not None and (out.dtype != torch.int32 or out.dim() != 2
                            or out.shape[0] < n_rows
                            or out.shape[1] != n_pad):
        raise ValueError("hash_commons: out must be an int32 (>= n_rows, "
                         "n_pad) tensor")
    devs = {t.device for t in (table, owner_mat, key_lo, proto)}
    if out is not None:
        devs.add(out.device)
    if len(devs) != 1:
        raise ValueError(f"hash_commons: arguments span devices {devs}")


def hash_commons_plain(table: torch.Tensor, max_probes: int,
                       owner_mat: torch.Tensor, key_lo: torch.Tensor,
                       key_hi: torch.Tensor, proto: torch.Tensor,
                       valid: torch.Tensor, n_rows: int, n_pad: int, *,
                       out: torch.Tensor | None = None,
                       with_ranks: bool = False):
    """Plain-PyTorch version of :func:`hash_commons`, on any device."""
    _check_commons(table, max_probes, owner_mat, key_lo, key_hi, proto,
                   valid, n_rows, n_pad, out)
    ranks = probe_table(table, key_lo, key_hi, valid, max_probes)
    hit = ranks >= 0
    owners = owner_mat[torch.clamp(ranks, min=0).long()]         # (H, cap)
    owners = torch.where(hit[:, None] & (owners < n_pad), owners, n_pad)
    p = torch.where(hit & (proto < n_rows), proto, n_rows)
    idx = p.long()[:, None] * (n_pad + 1) + owners.long()
    counts = torch.bincount(idx.reshape(-1),
                            minlength=(n_rows + 1) * (n_pad + 1))
    common = counts[: (n_rows + 1) * (n_pad + 1)].reshape(
        n_rows + 1, n_pad + 1)[:n_rows, :n_pad].to(torch.int32)
    if out is not None:
        out[:n_rows] += common
        common = out[:n_rows]
    return (common, ranks) if with_ranks else common


def hash_commons(table: torch.Tensor, max_probes: int,
                 owner_mat: torch.Tensor, key_lo: torch.Tensor,
                 key_hi: torch.Tensor, proto: torch.Tensor,
                 valid: torch.Tensor, n_rows: int, n_pad: int, *,
                 out: torch.Tensor | None = None, with_ranks: bool = False):
    """Common-kmer counts of one prototype chunk.

    table:     (B, 24) int32, the uint32 words of ``hashtable.build_table``
               over the unique protein kmers, payload = the kmer's rank
    owner_mat: (U, cap) int32, the owner proteins of each rank, padded
               with ``n_pad``
    key_lo/key_hi/proto/valid: (H,) the chunk's kmers, each with its
               prototype row, in any order (the kernel is fastest when a
               prototype's kmers are adjacent); invalid entries count
               nothing
    n_rows:    prototype rows of the chunk; a kmer of a row >= n_rows counts
               nothing; n_rows * n_pad is at most ``MAX_CELLS``
    out:       optional zeroed int32 (>= n_rows, n_pad) buffer the counts
               are added into (its first n_rows rows are returned)
    returns    common (n_rows, n_pad) int32, and with ``with_ranks`` the
               probed rank of every chunk kmer ((H,) int32, -1 = miss)

    A CPU tensor takes :func:`hash_commons_plain`; a CUDA tensor launches
    the kernel or raises.
    """
    _check_commons(table, max_probes, owner_mat, key_lo, key_hi, proto,
                   valid, n_rows, n_pad, out)
    if table.device.type == "cpu":
        return hash_commons_plain(table, max_probes, owner_mat, key_lo,
                                  key_hi, proto, valid, n_rows, n_pad,
                                  out=out, with_ranks=with_ranks)
    if table.device.type != "cuda":
        raise ValueError(f"hash_commons: unsupported device {table.device}")
    for name, t in (("table", table), ("owner_mat", owner_mat),
                    ("key_lo", key_lo), ("key_hi", key_hi),
                    ("proto", proto), ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"hash_commons: {name} must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("hash_commons: table must be 16-byte aligned")
    dev = table.device
    if out is None:
        out = torch.zeros((n_rows, n_pad), dtype=torch.int32, device=dev)
    elif not out.is_contiguous():
        raise ValueError("hash_commons: out must be contiguous")
    ranks = (torch.empty(key_lo.shape, dtype=torch.int32, device=dev)
             if with_ranks else None)
    h = key_lo.numel()
    if h:
        with torch.cuda.device(dev):
            err = kernels.lib().kan_hash_commons(
                table.data_ptr(), table.shape[0], max_probes,
                owner_mat.data_ptr(), owner_mat.shape[1], key_lo.data_ptr(),
                key_hi.data_ptr(), proto.data_ptr(), valid.data_ptr(), h,
                n_rows, n_pad, out.data_ptr(),
                ranks.data_ptr() if with_ranks else None,
                kernels.stream_of(table))
        kernels.check(err, "hash_commons kernel")
        hash_commons.launches += 1
    common = out[:n_rows]
    return (common, ranks) if with_ranks else common


hash_commons.launches = 0


def _check_best(common, n_rows, n1, n2, minc, state) -> None:
    if common.dtype != torch.int32 or common.dim() != 2 \
            or common.shape[0] < n_rows:
        raise ValueError("hash_best: common must be an int32 (>= n_rows, "
                         "n_pad) tensor")
    n_pad = common.shape[1]
    if n1.dtype != torch.int32 or n1.shape != (n_pad,):
        raise ValueError("hash_best: n1 must be (n_pad,) int32")
    if n2.dtype != torch.int32 or n2.dim() != 1 or n2.shape[0] < n_rows:
        raise ValueError("hash_best: n2 must be (>= n_rows,) int32")
    if minc.dtype != torch.int32 or minc.dim() != 1 or minc.shape[0] < 2:
        raise ValueError("hash_best: minc must be a (>= 2,) int32 table")
    if len(state) != 4 or any(t.dtype != torch.int32 for t in state) \
            or any(t.shape != (n_pad,) for t in state[:3]) \
            or state[3].shape != (1,):
        raise ValueError("hash_best: state must be (c, u, index) (n_pad,) "
                         "and improvements (1,), all int32")
    devs = {t.device for t in (common, n1, n2, minc, *state)}
    if len(devs) != 1:
        raise ValueError(f"hash_best: arguments span devices {devs}")


def hash_best_plain(common: torch.Tensor, n_rows: int, n1: torch.Tensor,
                    n2: torch.Tensor, minc: torch.Tensor, state,
                    chunk_base: int) -> None:
    """Plain-PyTorch version of :func:`hash_best`, on any device: the
    reference's tournament over rows padded to a power of two."""
    _check_best(common, n_rows, n1, n2, minc, state)
    state_c, state_u, state_i, state_m = state
    n_pad = common.shape[1]
    rows = 1 << max(n_rows - 1, 0).bit_length()
    c = torch.zeros((rows, n_pad), dtype=torch.int32, device=common.device)
    c[:n_rows] = common[:n_rows]
    nn2 = torch.zeros(rows, dtype=torch.int32, device=common.device)
    nn2[:n_rows] = n2[:n_rows]
    u = n1[None, :] + nn2[:, None] - c
    uc = torch.clamp(u, 1, minc.shape[0] - 1)
    c = torch.where(c >= minc[uc.long()], c, 0)          # min-score floor
    cc, uu = c, torch.where(c > 0, u, 1)
    ii = torch.arange(rows, dtype=torch.int32,
                      device=common.device)[:, None].expand(rows, n_pad)
    r = rows
    while r > 1:                                        # first-max tournament
        half = r // 2
        c1, u1, i1 = cc[:half], uu[:half], ii[:half]
        c2, u2, i2 = cc[half:], uu[half:], ii[half:]
        p1 = c1 * u2
        p2 = c2 * u1
        win1 = (p1 > p2) | ((p1 == p2) & (i1 < i2))
        cc = torch.where(win1, c1, c2)
        uu = torch.where(win1, u1, u2)
        ii = torch.where(win1, i1, i2)
        r = half
    bc, bu, bi = cc[0], uu[0], ii[0]
    improved = (bc > 0) & (bc * state_u > state_c * bu)
    state_c.copy_(torch.where(improved, bc, state_c))
    state_u.copy_(torch.where(improved, bu, state_u))
    state_i.copy_(torch.where(improved, chunk_base + bi, state_i))
    state_m += improved.sum(dtype=torch.int32)
    common[:n_rows] = 0


def hash_best(common: torch.Tensor, n_rows: int, n1: torch.Tensor,
              n2: torch.Tensor, minc: torch.Tensor, state,
              chunk_base: int) -> None:
    """Fold one chunk's best prototype per protein into the carried state.

    common: (>= n_rows, n_pad) int32 counts of :func:`hash_commons`; rows
            [:n_rows] are the chunk's prototypes in order, and are zero on
            return
    n1:     (n_pad,) int32 distinct kmers per protein (0 for padding)
    n2:     (>= n_rows,) int32 distinct kmers per prototype
    minc:   (M,) int32, minc[u] = smallest c with c / u >= min score (as
            float64); u is clamped to [1, M - 1]
    state:  (c, u, index) (n_pad,) int32 and improvements (1,) int32,
            updated in place: a protein's best improves only on a strictly
            greater c / u, to prototype ``chunk_base + row``
    The earliest row wins ties; a floored count is 0 and never wins.

    A CPU tensor takes :func:`hash_best_plain`; a CUDA tensor launches the
    kernel or raises.
    """
    _check_best(common, n_rows, n1, n2, minc, state)
    if common.device.type == "cpu":
        return hash_best_plain(common, n_rows, n1, n2, minc, state,
                               chunk_base)
    if common.device.type != "cuda":
        raise ValueError(f"hash_best: unsupported device {common.device}")
    for t in (common, n1, n2, minc, *state):
        if not t.is_contiguous():
            raise ValueError("hash_best: every tensor must be contiguous")
    if n_rows == 0:
        return None
    state_c, state_u, state_i, state_m = state
    with torch.cuda.device(common.device):
        err = kernels.lib().kan_hash_best(
            common.data_ptr(), n_rows, common.shape[1], n1.data_ptr(),
            n2.data_ptr(), minc.data_ptr(), minc.shape[0],
            state_c.data_ptr(), state_u.data_ptr(), state_i.data_ptr(),
            state_m.data_ptr(), int(chunk_base), kernels.stream_of(common))
    kernels.check(err, "hash_best kernel")
    hash_best.launches += 1
    return None


hash_best.launches = 0
