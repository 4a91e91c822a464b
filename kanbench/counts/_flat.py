"""The one walk of a flat token stream that both flat apply kernels need.

Bytes: a flag byte a token, a code byte a token inside a protein (no
window reads the padding past the last protein), a hit's protein id (4 B),
the 96 bytes (low keys, high keys, payloads) of each distinct bucket
holding a hit, the (role, count or tally) outputs (8 B a protein).  A miss
needs no table bytes from memory: the table's key filter, or any
membership filter held in cache, answers it.  Operations: a rolling pack
(7 a token inside a protein), a valid window's hash (14), and for a hit
its bucket's 16 compares and 3 for its vote."""

import torch

from ..tablewalk import bucket_reads, pack_windows

ROLL_PACK_OPS = 7
HASH_KEY_OPS = 14
HIT_OPS = 16 + 3
HIT_BUCKET_BYTES = 96


def count_walk(table, codes, seg_ids, valid, k, max_probes, n_seqs):
    hit_seen = torch.zeros(table.shape[0], dtype=torch.bool,
                           device=table.device)
    hits = 0
    step = 1 << 24
    for s in range(0, codes.numel(), step):
        v = valid[s: s + step]
        lo, hi = pack_windows(codes[s: s + step + k - 1], k)
        hits += bucket_reads(table, lo[: v.numel()], hi[: v.numel()], v,
                             max_probes, hit_seen)
    n_valid = int(valid.sum())
    n_inside = int((seg_ids < n_seqs).sum())
    n_bytes = (codes.numel() + n_inside + 4 * hits
               + HIT_BUCKET_BYTES * int(hit_seen.sum()) + 8 * n_seqs)
    n_ops = (ROLL_PACK_OPS * n_inside + HASH_KEY_OPS * n_valid
             + HIT_OPS * hits)
    return n_bytes, n_ops
