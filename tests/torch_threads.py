"""One torch thread for a test module.

The tier-1 suite runs six worker processes on the machine's cores. With
torch's default of one intra-op thread a core in every worker the cores
are oversubscribed, and OpenMP threads that spin while they wait slow
every worker many times over (six heavy port files took 807 s together
at the default and 129 s at one thread, on 8 cores). A test module that
imports `one_torch_thread` runs its torch work on one thread and gives
the count back after its last test. Modules with a comparison that moves
with the reduction order of another thread count (the dp batch
statistics, the study's trajectory, the bf16 dense layer's bits) keep
the default.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
