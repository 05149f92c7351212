"""The multi-device paths on torch.distributed: a (dp, sp) grid of ranks,
one device each (mesh, multihost), the sp-sharded bulk GCM whose tag is one
XOR all-reduce (sharded), and the six dp-sharded batch engines, which need
no collective (batch)."""
from ._dist import PG_TIMEOUT, backend_for, xor_allreduce
from .batch import (
    aead_sharded_fn,
    chain_sharded_fn,
    gcm_chain_sharded_fn,
    seal_batch_sharded_fn,
    siv_sharded_fn,
    xts_sectors_sharded_fn,
)
from .mesh import Mesh, make_mesh
from .multihost import global_mesh, host_local_batch, init_distributed
from .sharded import (
    fused_shard_body,
    gcm_seal_sharded_fn,
    gcm_seal_sharded_fused_fn,
    gcm_sharded_fused_fn,
    seal_shard_body,
    shard_adjust_matrices,
    shard_adjust_matrices_fused,
    sharded_aad_args,
    sharded_tags,
)

__all__ = [
    "Mesh", "PG_TIMEOUT", "aead_sharded_fn", "backend_for", "chain_sharded_fn",
    "fused_shard_body", "gcm_chain_sharded_fn", "gcm_seal_sharded_fn",
    "gcm_seal_sharded_fused_fn", "gcm_sharded_fused_fn", "global_mesh", "host_local_batch",
    "init_distributed", "make_mesh", "seal_batch_sharded_fn", "seal_shard_body",
    "shard_adjust_matrices", "shard_adjust_matrices_fused", "sharded_aad_args",
    "sharded_tags", "siv_sharded_fn", "xor_allreduce", "xts_sectors_sharded_fn",
]
