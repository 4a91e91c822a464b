"""``kan_flat_unanimous``: the unanimity vote of a flat token stream; its
three kernels (init, walk, finalize) count as one call.  The work is the
one walk of ``_flat``."""

from ._flat import count_walk

WRAPPERS = (("kmers_anno_tpu_torch.engine.apply_engine", "apply_flat"),)
KERNELS = ("flat_init_kernel", "flat_unanimous_kernel",
           "flat_finalize_kernel")


def count(table, codes, seg_ids, valid, min_hits, *, k, max_probes, n_seqs,
          key_filter=None):
    return count_walk(table, codes, seg_ids, valid, k, max_probes, n_seqs)
