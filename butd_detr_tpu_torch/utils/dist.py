"""Process groups: set-up, rank and world size, and the evaluators' merge.

Counterpart of `butd_detr_tpu/utils/dist.py`, which merges evaluator
counters across JAX processes with a host-side allgather. Here every rank
is a process of `torch.distributed`: `init_distributed` starts the group
(from `torchrun`'s environment or from explicit arguments) with the
backend its caller names, and `allreduce_dict` sums the counters over a
group with one all-reduce. The counts read `torch.distributed` when a group
is initialised and are 1 and 0 otherwise.
"""

import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from butd_detr_tpu_torch.utils.spans import to_host


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def launched_by_torchrun() -> bool:
    """True when the process environment names a rank (`torchrun`)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def local_rank() -> int:
    """The rank among the host's processes (`LOCAL_RANK`, else 0)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def init_distributed(backend: str, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None) -> None:
    """Start the default process group with `backend` ("nccl" or "gloo").

    Without arguments the rank, the world size and the rendezvous come
    from `torchrun`'s environment (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`,
    `MASTER_PORT`); a caller that spawns its own ranks passes them and an
    `init_method` such as `tcp://localhost:<port>`. NCCL needs each rank's
    device to be current before its first collective: the caller sets it
    (`torch.cuda.set_device`)."""
    if _initialized():
        raise RuntimeError("the process group is already initialised")
    if rank is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world_size)


def collective_device(group=None) -> torch.device:
    """Where a collective's tensors must lie: the current CUDA device under
    NCCL, the host under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allreduce_dict(d: Dict, group=None) -> Dict:
    """Sum dict values (python/numpy scalars) across the processes of
    `group` (None: all of them), as float64 in one all-reduce over the
    keys in sorted order. Keys are identical on every process (evaluator
    accumulators are built from static config); their order in the dict
    is not."""
    if not _initialized() or dist.get_world_size(group) == 1:
        return dict(d)
    keys = sorted(d.keys(), key=repr)
    vec = torch.tensor([float(d[k]) for k in keys], dtype=torch.float64,
                       device=collective_device(group))
    dist.all_reduce(vec, group=group)
    return {k: float(v) for k, v in zip(keys, to_host(vec).tolist())}
