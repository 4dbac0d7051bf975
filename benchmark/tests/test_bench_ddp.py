"""The multi-process path of a cell on several GPUs, at a size a CPU test
run holds: four ranks over gloo, each a spawned process, the harness's
whole run but the look for the GPUs. A sound run is correct with its
replicas equal and every rank taking the window's steps; a run whose
exchange between the ranks is broken underneath is not correct; a worker
that raises or stalls ends the whole run, with no process left. On four
cards (`cuda`-marked) a traced sound run is correct and reads its trace,
the control and the broken exchanges fail at the cell's own size, and a
failed worker ends the run. The cell is `cls_train_ddp4`'s workload file,
which BENCHMARK.json does not list yet, on four GPUs."""

import json
import multiprocessing
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from benchmark.harness import ranks, readers, report
from benchmark.tests.tiny import held_back_cell, tiny_cell

SEED = 2 ** 31 + 77
DDP = "cls_train_ddp4"
FAULTS = ("local_bn", "unsynced")


def _cell():
    """`cls_train_ddp4` at the tiny widths, a scene a rank, one encoder
    and one decoder layer and a one-layer text tower (the run's cost on
    the CPU is mostly per layer)."""
    c = tiny_cell(DDP, batch=1, cell=held_back_cell(DDP, 4))
    cfg = c["config"]
    cfg["flags"].update(num_decoder_layers=1, num_encoder_layers=1)
    cfg["model"].update(num_decoder_layers=1, num_encoder_layers=1)
    cfg["text_encoder"].update(num_hidden_layers=1)
    return c


def _run(fault=None, seconds=0.05, **kw):
    return ranks.run_cell_ranks(_cell(), SEED, seconds, False, device="cpu",
                                fault=fault, **kw)


def test_a_sound_run_is_correct_with_equal_replicas():
    res = _run(seconds=0.5)
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["replica_gap"] == {"value": 0.0, "limit": 0.0}
    # every rank took the window's steps, which rank 0 fixed
    steps = res["steps_by_rank"]
    assert len(steps) == 4 and len(set(steps)) == 1 and steps[0] >= 1
    run = res["run"]
    assert run.steps == steps[0] and len(run.spans["step"]) == steps[0]
    assert run.scenes == 4 * steps[0] and run.chips == 4
    assert res["device"]["count"] == 4 and res["forbidden"] == []
    assert multiprocessing.active_children() == []


@pytest.fixture(scope="module")
def broken():
    """Both broken exchanges' runs, side by side (eight processes)."""
    with ThreadPoolExecutor(len(FAULTS)) as pool:
        runs = {f: pool.submit(_run, f) for f in FAULTS}
        return {f: r.result() for f, r in runs.items()}


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_exchange_is_not_correct(fault, broken):
    """BatchNorm on each rank's own statistics, or the last rank stepping
    on its own gradient: the reference's global statistics and averaged
    gradients tell, and the replicas part."""
    res = broken[fault]
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["replica_gap"]["value"] > 0
    assert multiprocessing.active_children() == []


def _raises_on_rank3(rank, *args):
    if rank == 3:
        raise RuntimeError("a failure planted on rank 3")
    ranks.work(rank, *args)


def _stalls_on_rank3(rank, *args):
    if rank == 3:
        time.sleep(600)
    ranks.work(rank, *args)


@pytest.mark.parametrize("worker,stall_s", [(_raises_on_rank3, 600.0),
                                            (_stalls_on_rank3, 4.0)])
def test_a_failed_worker_ends_the_run(worker, stall_s):
    """Ranks 0-2 wait for rank 3 in the process group's rendezvous, which
    it never joins: the run ends at once when rank 3 raises, after
    `stall_s` when it hangs, and no worker is left."""
    t = time.monotonic()
    with pytest.raises(ranks.RanksFailed):
        _run(worker=worker, stall_s=stall_s)
    assert time.monotonic() - t < 60
    assert multiprocessing.active_children() == []


def _on_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    return held_back_cell(DDP, 4)


@pytest.mark.cuda
def test_a_traced_run_on_four_cards_is_correct():
    """A sound traced run at the cell's own size: correct with equal
    replicas and every rank's steps alike; every per-layer metric the cell
    reports is read, and so are rank 0's NCCL kernels, with every rank
    traced alike."""
    cell = _on_cards()
    res = ranks.run_cell_ranks(cell, SEED + 1, 5.0, True, device="cuda")
    line = report.result(cell, res, True, "cuda")
    report.earlier_lines(res, "cuda")
    print(json.dumps(line))
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["replica_gap"]["value"] == 0
    assert len(set(res["steps_by_rank"])) == 1
    assert set(line["metrics"]) == {m["name"] for m in cell["per_layer"]}
    assert readers.collective_ms(res["run"], "train") > 0
    assert line["device"]["count"] == 4 and res["forbidden"] == []
    assert multiprocessing.active_children() == []


@pytest.mark.cuda
@pytest.mark.parametrize("control,fault", [(True, None), (False, "local_bn"),
                                           (False, "unsynced")])
def test_the_control_and_a_broken_exchange_fail_on_four_cards(control,
                                                              fault):
    """The program's --use_bf16 path, BatchNorm on each rank's own
    statistics, or the last rank stepping on its own gradient, at the
    cell's own size on four cards: `correct` comes out false."""
    res = ranks.run_cell_ranks(_on_cards(), SEED, 3.0, False, device="cuda",
                               control=control, fault=fault)
    print(control, fault, json.dumps(
        {k: c["value"] for k, c in res["checks"].items()}))
    assert res["correct"] is False


@pytest.mark.cuda
def test_a_failed_worker_ends_the_run_on_four_cards():
    """Over NCCL as over gloo: rank 3 raises before it joins the process
    group, and the run ends at once with no worker left."""
    cell = _on_cards()
    t = time.monotonic()
    with pytest.raises(ranks.RanksFailed):
        ranks.run_cell_ranks(cell, SEED, 3.0, False, device="cuda",
                             worker=_raises_on_rank3)
    assert time.monotonic() - t < 60
    assert multiprocessing.active_children() == []
