"""Per-protein role votes over probed kmer windows: unanimous and weighted.

Counterpart of ``kmers_anno_tpu/ops/vote.py``, in plain PyTorch on the
tensors' device.  ``unanimous_vote`` is the ``apply`` voting loop
(ApplyKmerProcessor.java:122-147) as an order-free reduction: a protein is
bad iff two hits disagree (min role != max role), the called role is the
unanimous one and its count is the number of hits.  The weighted votes sum
hit weights per (protein, role) and call the best tally; equal tallies call
the smaller role index.  ``weighted_vote_rows`` works on the row layout;
``weighted_vote_flat`` (one sort), ``weighted_vote_dense`` (one tally
matrix) and ``weighted_vote_chunked`` (the matrix in role blocks) on a flat
token stream with segment ids, routed by ``pick_weighted_vote``.

Every weighted vote sums a tally exactly and rounds it once: a hit weight is
a non-negative fp16, so ``weight * 2^24`` is an integer below 2^40, and each
(protein, role) sum is taken in int64 fixed point (units of 2^-24) and
converted to float32 once.  Tallies are compared as those float32 values, so
every path, on the CPU and on the card, calls the same role with the same
tally bits whatever order it adds in.  (int64 rather than float64: a run of
more than about 8,192 weights of 65,504 is no longer exact in float64.)  The
reference sums in float32 in XLA's order, so its tallies of non-integer
weights may differ from these in the last bit.
"""

from __future__ import annotations

from functools import partial

import torch

_INT32_MAX = 2**31 - 1
_FIXED_ONE = float(1 << 24)     # fp16's smallest step, 2^-24, is one unit

# dense tally matrices beyond this many cells are swept in role blocks
DENSE_VOTE_LIMIT = 1 << 25


def _fixed(weights: torch.Tensor) -> torch.Tensor:
    """fp16-valued weights -> exact int64 units of 2^-24."""
    return (weights.to(torch.float64) * _FIXED_ONE).to(torch.int64)


def _to_tally(units: torch.Tensor) -> torch.Tensor:
    """Exact int64 sums of units -> float32 tallies, rounded once."""
    return units.to(torch.float32) * (1.0 / _FIXED_ONE)


def unanimous_vote(roles: torch.Tensor, valid: torch.Tensor,
                   min_hits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Vote per row (``vote.py:34-54``).

    roles: (B, L) int32 probed role per kmer window, -1 = miss
    valid: (B, L) bool window validity
    returns (role (B,) int32, called role or -1;
             count (B,) int32, the hit count of a unanimous row, else 0)

    ``count`` is not zeroed when a unanimous row has fewer than
    ``min_hits`` hits: the role is -1 there but the count stays.
    """
    hit = valid & (roles >= 0)
    n_hits = hit.sum(-1, dtype=torch.int32)
    rmin = torch.where(hit, roles, _INT32_MAX).amin(-1)
    rmax = torch.where(hit, roles, -1).amax(-1)
    unanimous = (n_hits > 0) & (rmin == rmax)
    called = unanimous & (n_hits >= min_hits)
    role = torch.where(called, rmax, -1).to(torch.int32)
    count = torch.where(unanimous, n_hits, 0).to(torch.int32)
    return role, count


def split_packed_payload(val: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Split packed (weight, role) payloads (``vote.py:57-70``).

    val: (...,) int32 probe results: -1 = miss, else
         ``fp16_bits(weight) << 16 | role_idx`` with bit 31 clear
    returns (role (...,) int32 with -1 kept, weight (...,) float32, 0.0 on
    a miss)

    A hit's weight bits are below 0x8000 (weights are >= 0), so they fit
    an int16 whose bits are then read as float16.
    """
    miss = val < 0
    role = torch.where(miss, -1, val & 0xFFFF).to(torch.int32)
    bits = torch.where(miss, 0, (val >> 16) & 0xFFFF).to(torch.int16)
    weight = bits.view(torch.float16).to(torch.float32)
    return role, torch.where(miss, 0.0, weight)


def _call(best: torch.Tensor, role: torch.Tensor, min_weight: float):
    """(role or -1, tally or 0.0): a role is called when its tally reaches
    ``min_weight`` and is positive."""
    called = (best >= min_weight) & (best > 0.0)
    return (torch.where(called, role, -1).to(torch.int32),
            torch.where(called, best, 0.0))


def weighted_vote_rows(roles: torch.Tensor, weights: torch.Tensor,
                       valid: torch.Tensor, min_weight: float
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted best-role vote on the row layout (``vote.py:147-188``).

    roles:   (B, L) int32 probed role per window, -1 = miss
    weights: (B, L) float32 hit weights
    valid:   (B, L) bool window validity
    returns (role (B,) int32, called role or -1;
             tally (B,) float32, the winning tally, 0.0 when uncalled)

    Each row is sorted by role (stable), a row cumsum turns equal-role
    runs into tallies (``cummax`` carries each run's base), and ``argmax``
    takes the first best run, so equal tallies call the smaller role.

    Each run is summed exactly and rounded once (module docstring).
    """
    hit = valid & (roles >= 0)
    r = torch.where(hit, roles, _INT32_MAX)
    w = torch.where(hit, _fixed(weights), 0)
    rs, order = torch.sort(r, dim=-1, stable=True)
    ws = torch.gather(w, -1, order)
    cw = torch.cumsum(ws, dim=-1)
    change = rs[:, 1:] != rs[:, :-1]
    edge = torch.ones((rs.shape[0], 1), dtype=torch.bool, device=rs.device)
    first = torch.cat([edge, change], dim=-1)
    last = torch.cat([change, edge], dim=-1)
    base = torch.cummax(torch.where(first, cw - ws, -1), dim=-1).values
    tally = _to_tally(cw - base)
    cand = torch.where(last & (rs != _INT32_MAX), tally, -1.0)
    arg = torch.argmax(cand, dim=-1, keepdim=True)
    best = torch.gather(cand, -1, arg)[:, 0]
    return _call(best, torch.gather(rs, -1, arg)[:, 0], min_weight)


def _flat_hits(roles, seg_ids, valid, n_seqs) -> torch.Tensor:
    """Windows that count: valid hits of a protein below ``n_seqs``."""
    return valid & (roles >= 0) & (seg_ids >= 0) & (seg_ids < n_seqs)


def tally_units(roles, weights, seg_ids, hit, n_seqs, base, r_blk):
    """The exact (n_seqs, r_blk) int64 tallies, in units of 2^-24, of the
    hits on roles [base, base + r_blk): partial tallies of one stream
    share add up exactly, in any order, before :func:`best_of_units`."""
    in_blk = hit & (roles >= base) & (roles < base + r_blk)
    idx = torch.where(in_blk, seg_ids.long() * r_blk + (roles - base),
                      n_seqs * r_blk)
    cells = torch.zeros(n_seqs * r_blk + 1, dtype=torch.int64,
                        device=roles.device)
    cells.index_add_(0, idx.reshape(-1),
                     torch.where(in_blk, _fixed(weights), 0).reshape(-1))
    return cells[:-1].reshape(n_seqs, r_blk)


def best_of_units(units: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's first best float32 tally of an exact int64 tally matrix,
    rounded once, and its column."""
    tally = _to_tally(units)
    arg = torch.argmax(tally, dim=1, keepdim=True)      # the first maximum
    return torch.gather(tally, 1, arg)[:, 0], arg[:, 0].to(torch.int32)


def _block_best(roles, weights, seg_ids, hit, n_seqs, base, r_blk):
    """Each protein's first best float32 tally over roles [base, base +
    r_blk), from an exact (n_seqs, r_blk) int64 tally matrix."""
    return best_of_units(tally_units(roles, weights, seg_ids, hit, n_seqs,
                                     base, r_blk))


def weighted_vote_flat(roles: torch.Tensor, weights: torch.Tensor,
                       seg_ids: torch.Tensor, valid: torch.Tensor,
                       min_weight: float, *, n_seqs: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted best-role vote over a flat token stream, by one sort
    (``vote.py:73-120``).

    roles:   (T,) int32 role per window, -1 = miss
    weights: (T,) float32 hit weights (fp16 values)
    seg_ids: (T,) int32 protein of each window (padding: >= n_seqs)
    valid:   (T,) bool window validity
    returns (role (n_seqs,) int32, called role or -1;
             tally (n_seqs,) float32, the winning tally, 0.0 when uncalled)

    One stable sort of the (protein, role) pairs makes runs, each summed
    exactly; a protein's best run is its largest rounded tally, and the
    smallest role among the runs that reach it is called.
    """
    dev = roles.device
    hit = _flat_hits(roles, seg_ids, valid, n_seqs)
    seg = torch.where(hit, seg_ids, n_seqs).to(torch.int64)
    key = (seg << 32) | torch.where(hit, roles, _INT32_MAX).to(torch.int64)
    skey, order = torch.sort(key, stable=True)
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    run = torch.cumsum(first, 0) - 1
    units = torch.zeros(skey.shape[0], dtype=torch.int64, device=dev)
    units.index_add_(0, run, torch.where(hit, _fixed(weights), 0)[order])
    run_key = skey[first]
    run_seg = run_key >> 32
    run_role = run_key & 0xFFFFFFFF
    run_tally = _to_tally(units[: run_key.shape[0]])
    best = torch.zeros(n_seqs + 1, dtype=torch.float32, device=dev)
    best = best.scatter_reduce(0, run_seg, run_tally, "amax")
    is_best = (run_seg < n_seqs) & (run_tally >= best[run_seg])
    role = torch.full((n_seqs + 1,), _INT32_MAX, dtype=torch.int64,
                      device=dev)
    role = role.scatter_reduce(
        0, run_seg, torch.where(is_best, run_role, _INT32_MAX), "amin")
    return _call(best[:n_seqs], role[:n_seqs], min_weight)


def weighted_vote_dense(roles: torch.Tensor, weights: torch.Tensor,
                        seg_ids: torch.Tensor, valid: torch.Tensor,
                        min_weight: float, *, n_seqs: int, n_roles: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted vote through one (n_seqs, n_roles) tally matrix
    (``vote.py:123-144``); arguments and returns as
    :func:`weighted_vote_flat`.  ``argmax`` takes the first maximum, so
    equal tallies call the smaller role."""
    hit = _flat_hits(roles, seg_ids, valid, n_seqs)
    best, role = _block_best(roles, weights, seg_ids, hit, n_seqs, 0,
                             n_roles)
    return _call(best, role, min_weight)


def weighted_vote_chunked(roles: torch.Tensor, weights: torch.Tensor,
                          seg_ids: torch.Tensor, valid: torch.Tensor,
                          min_weight: float, *, n_seqs: int, n_roles: int,
                          r_blk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense vote in blocks of ``r_blk`` roles (``vote.py:195-234``),
    for role spaces whose matrix would pass ``DENSE_VOTE_LIMIT``.  A running
    (best, role) starts at (0.0, -1); a block displaces it only with a
    strictly greater tally, so equal tallies call the smaller role, as in
    the other paths."""
    hit = _flat_hits(roles, seg_ids, valid, n_seqs)
    best = torch.zeros(n_seqs, dtype=torch.float32, device=roles.device)
    role = torch.full((n_seqs,), -1, dtype=torch.int32, device=roles.device)
    for base in range(0, n_roles, r_blk):
        bmax, barg = _block_best(roles, weights, seg_ids, hit, n_seqs, base,
                                 r_blk)
        better = bmax > best
        best = torch.where(better, bmax, best)
        role = torch.where(better, barg + base, role)
    return _call(best, role, min_weight)


def vote_block(n_seqs: int, n_roles: int) -> int:
    """The roles a tally block holds: all of them when the (n_seqs,
    n_roles) matrix fits ``DENSE_VOTE_LIMIT``, else as many as fit."""
    if n_roles <= 0:
        raise ValueError("weighted vote requires a known role count")
    if n_seqs * n_roles <= DENSE_VOTE_LIMIT:
        return n_roles
    return max(1, DENSE_VOTE_LIMIT // n_seqs)


def pick_weighted_vote(n_seqs: int, n_roles: int):
    """Route a flat weighted vote by shape (``vote.py:237-247``): dense when
    the tally matrix fits, role blocks otherwise."""
    r_blk = vote_block(n_seqs, n_roles)
    if r_blk == n_roles:
        return partial(weighted_vote_dense, n_seqs=n_seqs, n_roles=n_roles)
    return partial(weighted_vote_chunked, n_seqs=n_seqs, n_roles=n_roles,
                   r_blk=r_blk)
