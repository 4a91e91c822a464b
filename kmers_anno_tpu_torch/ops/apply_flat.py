"""The flat-stream apply step: pack, 8-slot table probe and per-protein vote.

Counterpart of ``kmers_anno_tpu/engine/apply_engine.py``'s ``apply_flat``
(:61-101) and ``apply_weighted_flat`` (:104-128), the step of tables past
one wide table.  Every protein of a call is one flat token stream: codes,
the protein (segment) of each token, and which tokens start a kmer window
inside their protein.  The table is the 8-slot table (``ops.hashtable``)
in its plain layout at every size; the reference's probe-window layout and
sort-and-stream probe (``ops.sliced_probe``) give the same calls.  Both
steps take the table's key filter (``ops.key_filter``), which lets the
kernels answer most misses without reading the table; it changes no
output, and the plain versions do not read it.

CUDA tensors launch ``csrc/apply_flat.cu``, one C entry point a call:
``kan_flat_unanimous`` packs, filters, walks and counts each hit into
per-protein integer atomics, in any token order; ``kan_flat_weighted``
walks the stream once whatever the role count, one block of the card a
protein, and sums each hit's weight exactly into the protein's int64 tally
in shared memory (roles past ``DIRECT_ROLES`` are swept in ranges over the
protein's kept hits).  The weighted step requires seg_ids never to
decrease (each protein's tokens contiguous, proteins in order, as
``FlatBatch`` lays them out) and raises on a stream that breaks it, on the
card and on the CPU.  What bounds both kernels is the latency of each
window's chain of dependent reads (flag and codes, filter sector, bucket,
a hit's payload).  CPU tensors take the plain versions, the reference's
composition in torch: ``pack_kmer_windows``, ``probe_table``,
then the votes.

The unanimity vote calls a protein's role when it has hits, they agree and
there are at least ``min_hits``; an uncalled protein's count is 0 (unlike
the row vote, which keeps a unanimous row's count below ``min_hits``).  The
weighted vote is exact (``ops.vote``): kernel and plain version give the
same role and tally bits on the CPU and the card, in any order.
"""

from __future__ import annotations

import torch

from .. import kernels
from .encode import PROT_PAD
from .hashtable import BUCKET, probe_table
from .key_filter import check_filter, filter_args
from .kmers import MAX_K, pack_kmer_windows
from .vote import pick_weighted_vote, split_packed_payload
from .widetable import check_table

_INT32_MAX = 2**31 - 1

# the roles the weighted kernel's shared tally holds (8 bytes each); roles
# past it are swept in ranges over each protein's kept hits
DIRECT_ROLES = 4096
_MAX_ROLES = 1 << 16            # a payload's role field


def _check_args(what, table, codes, seg_ids, valid, k, max_probes,
                n_seqs) -> None:
    check_table(what, 3 * BUCKET, table, max_probes)
    if codes.dim() != 1 or codes.dtype != torch.uint8:
        raise ValueError(f"{what}: codes must be a (T,) uint8 tensor")
    if seg_ids.dtype != torch.int32 or seg_ids.shape != codes.shape:
        raise ValueError(f"{what}: seg_ids must be int32, shaped like codes")
    if valid.dtype != torch.bool or valid.shape != codes.shape:
        raise ValueError(f"{what}: valid must be bool, shaped like codes")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{what}: k must be in 1..{MAX_K}, got {k}")
    if n_seqs < 0:
        raise ValueError(f"{what}: n_seqs must be >= 0")
    devs = {t.device for t in (table, codes, seg_ids, valid)}
    if len(devs) != 1:
        raise ValueError(f"{what}: arguments span devices {devs}")


def _out_of_order(what) -> ValueError:
    return ValueError(f"{what}: seg_ids must never decrease (each "
                      "protein's tokens contiguous, proteins in order)")


def _probe(table, codes, valid, k, max_probes):
    """Pack and probe every window: (payloads, hit mask)."""
    lo, hi = pack_kmer_windows(codes, k)
    val = probe_table(table, lo, hi, valid, max_probes)
    return val, valid & (val >= 0)


def apply_flat_plain(table: torch.Tensor, codes: torch.Tensor,
                     seg_ids: torch.Tensor, valid: torch.Tensor,
                     min_hits: int, *, k: int, max_probes: int, n_seqs: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch version of :func:`apply_flat`, on any device."""
    _check_args("apply_flat", table, codes, seg_ids, valid, k, max_probes,
                n_seqs)
    roles, hit = _probe(table, codes, valid, k, max_probes)
    hit = hit & (seg_ids >= 0) & (seg_ids < n_seqs)
    s = torch.where(hit, seg_ids, n_seqs).to(torch.int64)
    dev = table.device
    n_hits = torch.zeros(n_seqs + 1, dtype=torch.int32, device=dev)
    n_hits.index_add_(0, s, hit.to(torch.int32))
    rmin = torch.full((n_seqs + 1,), _INT32_MAX, dtype=torch.int32,
                      device=dev).scatter_reduce(
        0, s, torch.where(hit, roles, _INT32_MAX), "amin")
    rmax = torch.full((n_seqs + 1,), -1, dtype=torch.int32,
                      device=dev).scatter_reduce(
        0, s, torch.where(hit, roles, -1), "amax")
    n_hits, rmin, rmax = n_hits[:n_seqs], rmin[:n_seqs], rmax[:n_seqs]
    called = (n_hits > 0) & (rmin == rmax) & (n_hits >= min_hits)
    return (torch.where(called, rmax, -1).to(torch.int32),
            torch.where(called, n_hits, 0).to(torch.int32))


def _launchable(what, table, codes, seg_ids, valid, key_filter) -> None:
    if table.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {table.device}")
    for name, t in (("table", table), ("codes", codes),
                    ("seg_ids", seg_ids), ("valid", valid),
                    ("key_filter", key_filter)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if table.data_ptr() % 16 or (key_filter is not None
                                 and key_filter.data_ptr() % 16):
        raise ValueError(f"{what}: table and key_filter must be 16-byte "
                         "aligned")


def apply_flat(table: torch.Tensor, codes: torch.Tensor,
               seg_ids: torch.Tensor, valid: torch.Tensor, min_hits: int, *,
               k: int, max_probes: int, n_seqs: int,
               key_filter: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Call a role for every protein of a flat token stream.

    table:   (B, 24) int32, the uint32 words of ``hashtable.build_table``
    codes:   (T,) uint8 protein codes, ``PROT_PAD`` padding
    seg_ids: (T,) int32 protein of each token (padding: n_seqs)
    valid:   (T,) bool, a kmer window starting here stays in its protein
    key_filter: (sectors, 8) int32, the table's ``key_filter``, or None
    returns (role (n_seqs,) int32, the called role or -1;
             hits (n_seqs,) int32, the unanimous hit count, 0 if uncalled)

    A CPU tensor takes :func:`apply_flat_plain`; a CUDA tensor launches
    the kernel or raises.
    """
    _check_args("apply_flat", table, codes, seg_ids, valid, k, max_probes,
                n_seqs)
    check_filter("apply_flat", key_filter, table)
    if table.device.type == "cpu":
        return apply_flat_plain(table, codes, seg_ids, valid, min_hits, k=k,
                                max_probes=max_probes, n_seqs=n_seqs)
    _launchable("apply_flat", table, codes, seg_ids, valid, key_filter)
    dev = table.device
    role = torch.empty(n_seqs, dtype=torch.int32, device=dev)
    hits = torch.empty(n_seqs, dtype=torch.int32, device=dev)
    if n_seqs == 0:
        return role, hits
    rmin = torch.empty(n_seqs, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = kernels.lib().kan_flat_unanimous(
            table.data_ptr(), table.shape[0], max_probes,
            *filter_args(key_filter), codes.data_ptr(), seg_ids.data_ptr(),
            valid.data_ptr(), codes.numel(), k, PROT_PAD, n_seqs,
            int(min_hits), role.data_ptr(), hits.data_ptr(), rmin.data_ptr(),
            kernels.stream_of(table))
    kernels.check(err, "apply_flat kernel")
    apply_flat.launches += 1
    return role, hits


apply_flat.launches = 0


def apply_weighted_flat_plain(table: torch.Tensor, codes: torch.Tensor,
                              seg_ids: torch.Tensor, valid: torch.Tensor,
                              min_weight: float, *, k: int, max_probes: int,
                              n_seqs: int, n_roles: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch version of :func:`apply_weighted_flat`, on any
    device: the dense or role-block vote ``pick_weighted_vote`` routes to.
    It takes the stream in any order."""
    _check_args("apply_weighted_flat", table, codes, seg_ids, valid, k,
                max_probes, n_seqs)
    val, hit = _probe(table, codes, valid, k, max_probes)
    roles, weights = split_packed_payload(val)
    vote = pick_weighted_vote(n_seqs, n_roles)
    return vote(roles, weights, seg_ids, hit, min_weight)


def apply_weighted_flat(table: torch.Tensor, codes: torch.Tensor,
                        seg_ids: torch.Tensor, valid: torch.Tensor,
                        min_weight: float, *, k: int, max_probes: int,
                        n_seqs: int, n_roles: int,
                        key_filter: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The weighted vote of every protein of a flat token stream.

    Arguments as :func:`apply_flat`, with payloads packed as
    ``fp16_bits(weight) << 16 | role`` and ``n_roles`` the table's roles
    (at most 65,536); seg_ids must never decrease.
    returns (role (n_seqs,) int32, the best-tally role or -1;
             tally (n_seqs,) float32, its tally, 0.0 when uncalled)
    A role is called when its tally is >= ``min_weight`` and > 0; equal
    tallies call the smaller role.

    A CPU tensor takes :func:`apply_weighted_flat_plain`; a CUDA tensor
    launches the kernel once (one walk of the stream) or raises.  A stream
    whose seg_ids decrease raises ValueError on both.
    """
    what = "apply_weighted_flat"
    _check_args(what, table, codes, seg_ids, valid, k, max_probes, n_seqs)
    check_filter(what, key_filter, table)
    if not 1 <= n_roles <= _MAX_ROLES:
        raise ValueError(f"{what}: n_roles must be in 1..{_MAX_ROLES}, got "
                         f"{n_roles}")
    if table.device.type == "cpu":
        if seg_ids.numel() > 1 and bool((seg_ids[1:] < seg_ids[:-1]).any()):
            raise _out_of_order(what)
        return apply_weighted_flat_plain(
            table, codes, seg_ids, valid, min_weight, k=k,
            max_probes=max_probes, n_seqs=n_seqs, n_roles=n_roles)
    _launchable(what, table, codes, seg_ids, valid, key_filter)
    dev = table.device
    role = torch.empty(n_seqs, dtype=torch.int32, device=dev)
    tally = torch.empty(n_seqs, dtype=torch.float32, device=dev)
    if n_seqs == 0:
        return role, tally
    starts = torch.empty(n_seqs + 1, dtype=torch.int64, device=dev)
    bad = torch.empty(1, dtype=torch.int32, device=dev)
    kept = (torch.empty(max(codes.numel(), 1), dtype=torch.int32, device=dev)
            if n_roles > DIRECT_ROLES else None)
    with torch.cuda.device(dev):
        err = kernels.lib().kan_flat_weighted(
            table.data_ptr(), table.shape[0], max_probes,
            *filter_args(key_filter), codes.data_ptr(), seg_ids.data_ptr(),
            valid.data_ptr(), codes.numel(), k, PROT_PAD, n_seqs, n_roles,
            DIRECT_ROLES, float(min_weight), starts.data_ptr(),
            bad.data_ptr(), None if kept is None else kept.data_ptr(),
            role.data_ptr(), tally.data_ptr(), kernels.stream_of(table))
    kernels.check(err, "apply_flat_weighted kernel")
    apply_weighted_flat.launches += 1
    if int(bad.item()):      # the kernel called nothing
        raise _out_of_order(what)
    return role, tally


apply_weighted_flat.launches = 0
