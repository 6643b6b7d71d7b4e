"""Sequence parallelism over torch.distributed: the rank layout and its
subgroups, Ulysses x ring attention and the token-sharded DiT step (JAX
counterpart: parallel/)."""
from .mesh import (ParallelConfig, SPGroups, make_groups, parallel_config,
                   parse_mesh_shape)
from .multihost import initialize_multihost, is_primary, local_batch_slice
from .sp_attention import usp_joint_attention
from .sp_dit import (cfg_reorder_for_dp, cfg_unreorder_for_dp,
                     check_sp_compat, gather_tokens, sp_mean)

__all__ = [
    "ParallelConfig", "SPGroups", "make_groups", "parallel_config",
    "parse_mesh_shape", "initialize_multihost", "is_primary",
    "local_batch_slice", "usp_joint_attention", "cfg_reorder_for_dp",
    "cfg_unreorder_for_dp", "check_sp_compat", "gather_tokens",
    "sp_mean",
]
