"""The frozen roofline counts, checked by hand on tables of a few rows."""

from __future__ import annotations

import pytest
import torch

from kanbench import tablewalk as W
from kanbench.trace import load_module


def _wide_table(keys, n_rows, salt):
    """A wide table holding (lo, hi, payload) keys at their home rows."""
    table = torch.full((n_rows, 3 * W.WIDE_SLOTS), -1, dtype=torch.int32)
    fill = [0] * n_rows
    for lo, hi, pay in keys:
        row = int(W.mix(torch.tensor([lo]), torch.tensor([hi]), salt)
                  [0]) & (n_rows - 1)
        s = fill[row]
        fill[row] += 1
        table[row, s] = lo
        table[row, W.WIDE_SLOTS + s] = hi
        table[row, 2 * W.WIDE_SLOTS + s] = pay
    return table


def test_probe_wide_count_by_hand():
    count = load_module("counts", "kan_probe_wide")
    salt = 12345
    keys = [(7, 1, 0), (9, 2, 1), (11, 3, 2)]
    table = _wide_table(keys, 4, salt)
    # two hits, one miss, one invalid query
    lo = torch.tensor([7, 11, 5, 9], dtype=torch.int32)
    hi = torch.tensor([1, 3, 6, 2], dtype=torch.int32)
    valid = torch.tensor([True, True, True, False])
    hit_rows = {int(W.mix(lo[i: i + 1], hi[i: i + 1], salt)[0]) & 3
                for i in range(2)}
    n_bytes, n_ops = count.count(table, lo, hi, valid, salt, max_probes=1)
    assert n_bytes == 13 * 4 + 96 * len(hit_rows) + 8 * 2
    assert n_ops == 14 * 3 + 26 * 2


def test_probe_wide_walk_finds_the_next_row():
    salt = 7
    table = _wide_table([(1, 1, 5)], 8, salt)
    home = int(W.mix(torch.tensor([1]), torch.tensor([1]), salt)[0]) & 7
    moved = torch.full_like(table, -1)
    moved[(home + 1) % 8] = table[home]       # the key one row on
    one = torch.tensor([1], dtype=torch.int32)
    valid = torch.tensor([True])
    assert W.wide_reads(moved, one, one, valid, salt, 1) == (0, 0)
    assert W.wide_reads(moved, one, one, valid, salt, 2) == (1, 1)


def _bucket_table(keys, n_buckets):
    table = torch.full((n_buckets, 3 * W.BUCKET_SLOTS), -1,
                       dtype=torch.int32)
    fill = [0] * n_buckets
    for lo, hi, pay in keys:
        b = int(W.mix(torch.tensor([lo]), torch.tensor([hi]), W.GOLDEN)
                [0]) & (n_buckets - 1)
        while fill[b] == W.BUCKET_SLOTS:
            b = (b + 1) & (n_buckets - 1)
        s = fill[b]
        fill[b] += 1
        table[b, s] = lo
        table[b, W.BUCKET_SLOTS + s] = hi
        table[b, 2 * W.BUCKET_SLOTS + s] = pay
    return table


@pytest.mark.parametrize("kernel", ["kan_flat_unanimous",
                                    "kan_flat_weighted"])
def test_flat_count_by_hand(kernel):
    count = load_module("counts", kernel)
    k = 3
    # two proteins of 5 and 4 letters, then 3 padding tokens
    codes = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, 8, 31, 31, 31],
                         dtype=torch.uint8)
    seg = torch.tensor([0] * 5 + [1] * 4 + [2] * 3, dtype=torch.int32)
    valid = torch.tensor([1, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0],
                         dtype=torch.bool)
    lo, hi = W.pack_windows(codes, k)
    # windows at 0 and 5 are in the table
    keys = [(int(lo[0]), int(hi[0]), 3), (int(lo[5]), int(hi[5]), 4)]
    table = _bucket_table(keys, 4)
    hit_homes = {int(W.mix(lo[i: i + 1], hi[i: i + 1], W.GOLDEN)[0]) & 3
                 for i in (0, 5)}
    kw = dict(k=k, max_probes=1, n_seqs=2)
    if kernel == "kan_flat_weighted":
        kw["n_roles"] = 8
    n_bytes, n_ops = count.count(table, codes, seg, valid, 1, **kw)
    n_inside = 9
    assert n_bytes == (12 + n_inside + 4 * 2 + 96 * len(hit_homes)
                       + 8 * 2)
    assert n_ops == 7 * n_inside + 14 * 5 + (16 + 3) * 2


def test_pack_windows_matches_the_key_layout():
    """Letters 0-5 in the low word at 5 bits each, 6 and 7 in the high."""
    codes = torch.tensor(list(range(1, 9)), dtype=torch.uint8)
    lo, hi = W.pack_windows(codes, 8)
    assert int(lo[0]) == sum(c << (5 * j) for j, c in enumerate(range(1, 7)))
    assert int(hi[0]) == 7 | (8 << 5)
