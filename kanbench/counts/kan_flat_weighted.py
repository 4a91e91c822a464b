"""``kan_flat_weighted``: the weighted vote of a flat token stream; its two
kernels (protein starts, walk) count as one call.  The work is the same one
walk of ``_flat`` as the unanimity vote's: the tallies are kept where the
hits are summed and written once."""

from ._flat import count_walk

WRAPPERS = (("kmers_anno_tpu_torch.engine.apply_engine",
             "apply_weighted_flat"),)
KERNELS = ("flat_starts_kernel", "flat_weighted_kernel")


def count(table, codes, seg_ids, valid, min_weight, *, k, max_probes,
          n_seqs, n_roles, key_filter=None):
    return count_walk(table, codes, seg_ids, valid, k, max_probes, n_seqs)
