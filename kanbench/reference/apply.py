"""The plain reference of role calling against a signature table (SEEDtk
``kmers.anno`` ApplyKmerProcessor), in PyTorch.

Every window of a protein, all len - k + 1 of them, is looked up in the
table by its full key.  The unanimity vote (the tool's default) calls a
protein's role when it has hits, every hit names the same role and there
are at least ``min_hits``; the hit count is reported.  The weighted vote
sums each role's hit weights (fp16 values) exactly, rounds each sum once
to float32 and calls the largest, the smaller role index on a tie, when it
reaches ``min_weight`` and is above 0.

``lossy`` and ``tally_dtype`` exist for the controls: a 32-bit hash of each
key in place of the key, and the weighted sums taken in a lower precision.
"""

from __future__ import annotations

import numpy as np
import torch

from . import codes as C

BLOCK_PROTEINS = 8192


class Table:
    """A signature table on ``device``: keys (uint64 packed kmers), role
    index and optional weight of each, sorted by key for lookups."""

    def __init__(self, keys: np.ndarray, roles: np.ndarray, weights=None,
                 *, device, lossy: bool = False):
        key = C.lossy_key(keys) if lossy else np.asarray(keys, np.uint64)
        self.lossy = lossy
        k = torch.from_numpy(key.astype(np.int64)).to(device)
        self.keys, order = torch.sort(k, stable=True)
        self.roles = torch.from_numpy(
            np.asarray(roles, np.int64)).to(device)[order]
        self.weights = None if weights is None else torch.from_numpy(
            np.asarray(weights, np.float64)).to(device)[order]
        self.device = device

    def lookup(self, qkeys: torch.Tensor) -> torch.Tensor:
        """Each query's table row, or -1."""
        i = torch.searchsorted(self.keys, qkeys).clamp_(max=len(self.keys)
                                                         - 1)
        return torch.where(self.keys[i] == qkeys, i, -1)


def _windows(letters: torch.Tensor, seg: torch.Tensor, ends: torch.Tensor,
             k: int, lossy: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Keys of the windows that lie inside their protein, and each one's
    protein."""
    n = letters.numel() - k + 1
    if n <= 0:
        e = torch.zeros(0, dtype=torch.int64, device=letters.device)
        return e, e
    key = torch.zeros(n, dtype=torch.int64, device=letters.device)
    for j in range(k):
        key |= letters[j: j + n].to(torch.int64) << (C.BITS * j)
    pos = torch.arange(n, device=letters.device)
    inside = pos + k <= ends[seg[:n]]
    key, s = key[inside], seg[:n][inside]
    if lossy:
        key = torch.from_numpy(C.lossy_key(key.cpu().numpy().astype(
            np.uint64)).astype(np.int64)).to(letters.device)
    return key, s


def call(table: Table, letters: np.ndarray, offsets: np.ndarray, k: int,
         min_hits: int, *, weighted: bool = False,
         min_weight: float | None = None, n_roles: int = 0,
         tally_dtype=torch.float64) -> tuple[np.ndarray, np.ndarray]:
    """Calls of the proteins ``letters[offsets[i]:offsets[i + 1]]``:
    (role index or -1, hit count or float32 tally) a protein."""
    dev = table.device
    n = len(offsets) - 1
    role = np.full(n, -1, np.int64)
    hits = np.zeros(n, np.float32 if weighted else np.int64)
    min_weight = float(min_hits if min_weight is None else min_weight)
    for b0 in range(0, n, BLOCK_PROTEINS):
        b1 = min(n, b0 + BLOCK_PROTEINS)
        lo, hi = int(offsets[b0]), int(offsets[b1])
        let = torch.from_numpy(letters[lo:hi]).to(dev)
        lens = torch.from_numpy(np.diff(offsets[b0: b1 + 1])).to(dev)
        seg = torch.repeat_interleave(torch.arange(b1 - b0, device=dev),
                                      lens)
        ends = torch.cumsum(lens, 0)
        qkey, s = _windows(let, seg, ends, k, table.lossy)
        row = table.lookup(qkey)
        hit = row >= 0
        s, row = s[hit], row[hit]
        r = table.roles[row]
        m = b1 - b0
        if not weighted:
            cnt = torch.bincount(s, minlength=m)
            rmin = torch.full((m,), 1 << 40, dtype=torch.int64, device=dev)
            rmax = torch.full((m,), -1, dtype=torch.int64, device=dev)
            rmin.scatter_reduce_(0, s, r, "amin")
            rmax.scatter_reduce_(0, s, r, "amax")
            ok = (cnt > 0) & (rmin == rmax) & (cnt >= min_hits)
            role[b0:b1] = torch.where(ok, rmax, -1).cpu().numpy()
            hits[b0:b1] = torch.where(ok, cnt, 0).cpu().numpy()
            continue
        w = table.weights[row].to(tally_dtype)
        tally = torch.zeros(m * n_roles, dtype=tally_dtype, device=dev)
        tally.index_add_(0, s * n_roles + r, w)
        t32 = tally.to(torch.float32).view(m, n_roles)
        best = t32.max(1).values
        # max's index on ties is unspecified: take the first best role
        first = (t32 == best[:, None]).to(torch.int8).argmax(1)
        ok = (best >= min_weight) & (best > 0)
        role[b0:b1] = torch.where(ok, first, -1).cpu().numpy()
        hits[b0:b1] = torch.where(ok, best, 0.0).cpu().numpy()
    return role, hits
