"""Parallelism: the (dp, mp) mesh as process groups, the collectives of a
step and the tensor-parallel sharding rules."""

from butd_detr_tpu_torch.parallel.mesh import Mesh, bind_batchnorm, make_mesh
from butd_detr_tpu_torch.parallel.tp import (
    gather_full_state_dict,
    param_spec,
    shard_model_,
    shard_state_dict,
    unshard_state_dicts,
)

__all__ = [
    "Mesh",
    "bind_batchnorm",
    "gather_full_state_dict",
    "make_mesh",
    "param_spec",
    "shard_model_",
    "shard_state_dict",
    "unshard_state_dicts",
]
