"""``kan_hash_best``: a chunk's counts turned into each protein's best
prototype and folded into the state carried across chunks, one kernel a
call.

Bytes: each count cell read once (4 B), the proteins' and the prototypes'
kmer counts (n1, n2) and the floor table (minc) read once, the state (c,
u, index: 12 B a protein) read and written once.  Operations: 2 a cell
(its load and zero test).  The kernel also clears the chunk's non-zero
cells and tests their floor; a call's arguments no longer hold them when
a traced run counts (the kernel has cleared them), so they are left out,
which lowers the bound: a chunk's few thousand against its ~67M cells."""

WRAPPERS = (("kmers_anno_tpu_torch.engine.hashanno", "hash_best"),)
KERNELS = ("hash_best_kernel",)
CELL_OPS = 2
STATE_BYTES = 12


def count(common, n_rows, n1, n2, minc, state, chunk_base):
    n_pad = common.shape[1]
    n_cells = n_rows * n_pad
    n_bytes = (4 * n_cells + 4 * n_pad + 4 * n_rows
               + minc.numel() * minc.element_size() + 2 * STATE_BYTES * n_pad)
    return n_bytes, CELL_OPS * n_cells
