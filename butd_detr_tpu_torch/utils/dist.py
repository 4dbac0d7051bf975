"""Process-group helpers, for one process.

Counterpart of `butd_detr_tpu/utils/dist.py`, which merges evaluator
counters across JAX processes with a host-side allgather. The port runs in
one process so far: the counts below read `torch.distributed` when a group
is initialised, and the multi-process merge raises until the port's
distribution is written (ROADMAP queue 1, "Distribution"). It is never
silently skipped: counters of one rank would pass for the whole epoch's.
"""

from typing import Dict

import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def allreduce_dict(d: Dict) -> Dict:
    """Sum dict values (python/numpy scalars) across all processes. Keys
    are identical on every process (evaluator accumulators are built from
    static config)."""
    if process_count() == 1:
        return dict(d)
    raise NotImplementedError(
        "allreduce_dict across processes belongs to the port's "
        "distribution slice (ROADMAP queue 1, 'Distribution'); run one "
        "process")
