"""The (dp, mp) mesh as process groups, and a rank's rows of a batch.

Counterpart of `butd_detr_tpu/parallel/mesh.py`. The JAX package lays a
`(dp, mp)` device mesh under one process and shards the batch over `dp`
with global-array meaning: `--batch_size` is the batch of one step across
all dp shards, BatchNorm statistics and the loss's box count are the
global batch's, gradients are averaged. Here each device of the mesh is a
`torch.distributed` rank: rank r has dp index r // mp and mp index r % mp
(the JAX mesh's row-major `reshape(dp, mp)`), reads rows
[i·B/dp, (i+1)·B/dp) of the batch that one process would read, and meets
the other ranks through two groups:

  * its dp group, the ranks of its mp index: BatchNorm statistics, the box
    count, gradient averaging, the evaluators' merge;
  * its mp group, the ranks of its dp index: the tensor-parallel
    products (`parallel/tp.py`). Every rank of an mp group holds the same
    rows.

A group of one rank is None, and the collectives on it are skipped.
"""

from dataclasses import dataclass
from typing import Dict, Optional

import torch.distributed as dist

from butd_detr_tpu_torch.utils.dist import process_count, process_index


@dataclass(frozen=True)
class Mesh:
    dp: int = 1
    mp: int = 1
    rank: int = 0
    dp_group: Optional[object] = None
    mp_group: Optional[object] = None

    @property
    def dp_index(self) -> int:
        return self.rank // self.mp

    @property
    def mp_index(self) -> int:
        return self.rank % self.mp

    def rows(self, batch_size: int) -> slice:
        """This rank's rows of a batch of `batch_size`."""
        if batch_size % self.dp:
            raise ValueError(f"the batch of {batch_size} does not split "
                             f"over --dp {self.dp}")
        per = batch_size // self.dp
        return slice(self.dp_index * per, (self.dp_index + 1) * per)

    def shard_batch(self, batch: Dict) -> Dict:
        """This rank's rows of every array and list of a batch (the keys
        whose leading dimension is the batch's)."""
        size = len(batch["point_clouds"])
        rows = self.rows(size)
        return {k: v[rows] if (isinstance(v, list) or getattr(v, "ndim", 0))
                and len(v) == size else v
                for k, v in batch.items()}


def make_mesh(dp: Optional[int] = None, mp: int = 1) -> Mesh:
    """The mesh of the initialised process group (one process: 1 x 1).
    `dp` None takes world size / mp; dp x mp must equal the world size.
    Every rank must call this, in the same order as its other group
    constructions: each group is made on all ranks."""
    world, rank = process_count(), process_index()
    if dp is None:
        if world % mp:
            raise ValueError(f"--mp {mp} does not divide the world size "
                             f"{world}")
        dp = world // mp
    if dp < 1 or mp < 1 or dp * mp != world:
        raise ValueError(f"--dp {dp} x --mp {mp} = {dp * mp} ranks, but "
                         f"the world size is {world}")
    if world == 1:
        return Mesh()
    dp_groups = [dist.new_group([d * mp + m for d in range(dp)])
                 for m in range(mp)]
    mp_groups = [dist.new_group([d * mp + m for m in range(mp)])
                 for d in range(dp)]
    return Mesh(dp=dp, mp=mp, rank=rank,
                dp_group=dp_groups[rank % mp] if dp > 1 else None,
                mp_group=mp_groups[rank // mp] if mp > 1 else None)


def bind_batchnorm(model, group) -> None:
    """Make every BatchNorm of `model` reduce its train-mode statistics
    over `group` (None: its own rows)."""
    from butd_detr_tpu_torch.nn.mlp import BatchNorm

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group
