"""Per-protein role votes over probed kmer windows: unanimous and weighted.

Counterpart of ``kmers_anno_tpu/ops/vote.py``, in plain PyTorch on the
tensors' device.  ``unanimous_vote`` is the ``apply`` voting loop
(ApplyKmerProcessor.java:122-147) as an order-free reduction: a protein is
bad iff two hits disagree (min role != max role), the called role is the
unanimous one and its count is the number of hits.  The weighted vote of
the row layout sums hit weights per role and calls the best tally; equal
tallies call the smaller role index.
"""

from __future__ import annotations

import torch

_INT32_MAX = 2**31 - 1
_FIXED_ONE = float(1 << 24)     # fp16's smallest step, 2^-24, is one unit


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

    The sums are order-free.  A hit weight is a non-negative fp16, so
    ``weight * 2^24`` is an integer below 2^40: each run is summed exactly
    in int64 fixed point (units of 2^-24) and converted to float32 once,
    so a tally is rounded once and the CPU and CUDA give the same bits
    whatever order they add in.  (int64 rather than float64: a run of more
    than about 8,192 weights of 65,504 is no longer exact in float64.)
    The reference sums in float32 in XLA's order, so its tallies of
    non-integer weights may still differ from these in the last bit.
    """
    hit = valid & (roles >= 0)
    r = torch.where(hit, roles, _INT32_MAX)
    fixed = (weights.to(torch.float64) * _FIXED_ONE).to(torch.int64)
    w = torch.where(hit, fixed, 0)
    rs, order = torch.sort(r, dim=-1, stable=True)
    ws = torch.gather(w, -1, order)
    cw = torch.cumsum(ws, dim=-1)
    change = rs[:, 1:] != rs[:, :-1]
    edge = torch.ones((rs.shape[0], 1), dtype=torch.bool, device=rs.device)
    first = torch.cat([edge, change], dim=-1)
    last = torch.cat([change, edge], dim=-1)
    base = torch.cummax(torch.where(first, cw - ws, -1), dim=-1).values
    tally = (cw - base).to(torch.float32) * (1.0 / _FIXED_ONE)
    cand = torch.where(last & (rs != _INT32_MAX), tally, -1.0)
    arg = torch.argmax(cand, dim=-1, keepdim=True)
    best = torch.gather(cand, -1, arg)[:, 0]
    role = torch.gather(rs, -1, arg)[:, 0]
    called = (best >= min_weight) & (best > 0.0)
    return (torch.where(called, role, -1).to(torch.int32),
            torch.where(called, best, 0.0))
