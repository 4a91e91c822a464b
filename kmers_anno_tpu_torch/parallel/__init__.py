"""Several devices: the (data, table) mesh of members and its apply steps,
and the multi-process start-up (counterpart of ``kmers_anno_tpu/parallel``).

* data axis — genome streams spread over the rows of members.
* table axis — the signature table replicated on every member, or
  hash-sharded with every window looked up in every shard and the answers
  merged by maximum, or hash-sharded with each window's key routed to its
  owner shard by one exchange and the partial votes merged.

Exchanges among one process's members are tensor copies; across processes
only host results travel, on ``torch.distributed``'s gloo backend.
"""

from .distributed import distributed_env, maybe_init_distributed
from .mesh import (make_mesh, replicated_apply_step, routed_apply_step,
                   shard_signature_table, sharded_apply_step,
                   split_tokens_for_table_axis)

__all__ = ["distributed_env", "make_mesh", "maybe_init_distributed",
           "replicated_apply_step", "routed_apply_step",
           "shard_signature_table", "sharded_apply_step",
           "split_tokens_for_table_axis"]
