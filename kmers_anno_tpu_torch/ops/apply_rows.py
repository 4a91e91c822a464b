"""The row-layout unanimity apply step: pack, wide-table probe and vote.

``apply_rows`` launches ``csrc/apply_rows.cu`` for CUDA tensors: one
kernel that packs each valid kmer window of a protein row, looks it up in
the wide table and reduces the row's hits, so the (rows, width) key and
role arrays never reach device memory.  A CPU tensor takes
:func:`apply_rows_plain`, the composition the reference jits
(``engine/apply_engine.py:183-195``): ``pack_kmer_windows`` +
``probe_wide_plain`` + ``unanimous_vote``.
"""

from __future__ import annotations

import torch

from .. import kernels
from .encode import PROT_PAD
from .kmers import MAX_K, pack_kmer_windows
from .vote import unanimous_vote
from .widetable import SLOTS, check_table, probe_wide_plain


def _check_args(table, codes, valid, k, max_probes) -> None:
    check_table("apply_rows", 3 * SLOTS, table, max_probes)
    if codes.dim() != 2 or codes.dtype != torch.uint8:
        raise ValueError("apply_rows: codes must be a (rows, width) uint8 "
                         "tensor")
    if valid.dtype != torch.bool or valid.shape != codes.shape:
        raise ValueError("apply_rows: valid must be a bool tensor shaped "
                         "like codes")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"apply_rows: k must be in 1..{MAX_K}, got {k}")
    if codes.device != table.device or valid.device != table.device:
        raise ValueError("apply_rows: table, codes and valid must be on "
                         "one device")


def apply_rows_plain(table: torch.Tensor, salt: int, codes: torch.Tensor,
                     valid: torch.Tensor, min_hits: int, k: int,
                     max_probes: int = 1
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch version of :func:`apply_rows`, on any device."""
    _check_args(table, codes, valid, k, max_probes)
    lo, hi = pack_kmer_windows(codes, k)
    roles = probe_wide_plain(table, lo, hi, valid, salt, max_probes)
    return unanimous_vote(roles, valid, min_hits)


def apply_rows(table: torch.Tensor, salt: int, codes: torch.Tensor,
               valid: torch.Tensor, min_hits: int, k: int,
               max_probes: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Call a role for every protein row of a batch.

    table:  (rows, 72) int32, the uint32 words of ``build_wide_table``
    salt:   the salt ``build_wide_table`` chose
    codes:  (B, W) uint8 protein codes, ``PROT_PAD`` padding, contiguous
    valid:  (B, W) bool kmer-window validity, contiguous
    returns (role (B,) int32, the called role or -1;
             count (B,) int32, the hit count of a unanimous row, else 0;
             a unanimous row below ``min_hits`` keeps its count)

    A CPU tensor takes :func:`apply_rows_plain`; a CUDA tensor launches
    the kernel or raises.
    """
    _check_args(table, codes, valid, k, max_probes)
    if table.device.type == "cpu":
        return apply_rows_plain(table, salt, codes, valid, min_hits, k,
                                max_probes)
    if table.device.type != "cuda":
        raise ValueError(f"apply_rows: unsupported device {table.device}")
    for name, t in (("table", table), ("codes", codes), ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"apply_rows: {name} must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("apply_rows: table must be 16-byte aligned")
    n_rows, width = codes.shape
    role = torch.empty(n_rows, dtype=torch.int32, device=codes.device)
    count = torch.empty(n_rows, dtype=torch.int32, device=codes.device)
    if n_rows == 0:
        return role, count
    with torch.cuda.device(table.device):
        err = kernels.lib().kan_apply_rows(
            table.data_ptr(), table.shape[0], codes.data_ptr(),
            valid.data_ptr(), n_rows, width, k, PROT_PAD,
            int(salt) & 0xFFFFFFFF, max_probes, int(min_hits),
            role.data_ptr(), count.data_ptr(), kernels.stream_of(table))
    kernels.check(err, "apply_rows kernel")
    apply_rows.launches += 1
    return role, count


apply_rows.launches = 0
