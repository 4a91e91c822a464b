"""``kan_probe_wide``: keys looked up in a wide table.

Bytes: each query's key words and flag read once and its payload written
once (13 B); for each distinct row holding a hit, its 96 bytes of low keys,
and a hit's high key and payload words (8 B).  A miss needs no table bytes
from memory: a membership filter held in cache can answer it, so counting
misses' rows would let a filtered kernel pass its bound.  Operations: a
valid query's hash (two fmix32 and a mask, 14), and 26 a hit (24 compares
of its row, the high key's and the payload's reads)."""

from ..tablewalk import wide_reads

WRAPPERS = (("kmers_anno_tpu_torch.engine.projection", "probe_wide"),)
KERNELS = ("probe_wide_kernel",)
QUERY_BYTES = 13
ROW_LO_BYTES = 96
HIT_BYTES = 8
HASH_OPS = 14
HIT_OPS = 26


def count(table, key_lo, key_hi, valid, salt, max_probes=1):
    hit_rows, hits = wide_reads(table, key_lo, key_hi, valid, salt,
                                max_probes)
    n_bytes = (QUERY_BYTES * key_lo.numel() + ROW_LO_BYTES * hit_rows
               + HIT_BYTES * hits)
    return n_bytes, HASH_OPS * int(valid.sum()) + HIT_OPS * hits
