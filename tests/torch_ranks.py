"""Spawned `torch.distributed` ranks for the port's multi-process tests.

`run_ranks(task, world_size, *args)` starts `world_size` processes with
the `spawn` method, joins them into one gloo group over localhost, runs
`task(rank, *args)` in each, and returns the ranks' results in rank order
(each written with `torch.save`, read back here). A rank that raises fails
the call with its traceback. The tasks live in this module, which imports
only torch, numpy and the port, so that a child starts without JAX.
"""

import os
import socket
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

TIMEOUT = 600


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, world_size, port, out_dir, task, args):
    torch.set_num_threads(1)
    os.environ["USE_TF"] = "0"  # `transformers` need not import TensorFlow
    from butd_detr_tpu_torch.utils.dist import init_distributed
    import torch.distributed as dist

    init_distributed("gloo", rank=rank, world_size=world_size,
                     init_method=f"tcp://localhost:{port}")
    try:
        result = task(rank, *args)
    except BaseException:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _read(path):
    with open(path) as f:
        return f.read()


def run_ranks(task, world_size, *args):
    """[task(rank, *args) for each rank], run in spawned processes; the
    world must finish within TIMEOUT seconds."""
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            _entry, args=(world_size, _free_port(), out_dir, task, args),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + TIMEOUT
        try:
            # join returns False while a rank is still running
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    raise AssertionError(f"{task.__name__}: the ranks did "
                                         f"not finish in {TIMEOUT} s")
        except ProcessException as e:
            errors = [_read(os.path.join(out_dir, f))
                      for f in sorted(os.listdir(out_dir))
                      if f.startswith("error")]
            raise AssertionError("\n".join(errors) or str(e)) from None
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]


# ------------------------------------------------------------------ tasks

def no_dropout(model):
    """Dropout 0 in every layer of `model` (elementwise and attention)."""
    from butd_detr_tpu_torch.nn.attention import MultiheadAttention
    from butd_detr_tpu_torch.nn.dropout import Dropout

    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
        elif isinstance(m, MultiheadAttention):
            m.dropout = 0.0


def gradient_step(trainer, batch, train=True):
    """The loss of `batch` (train or eval mode) and the gradients averaged
    over the dp group, with nothing applied; (loss, {name: grad},
    {BatchNorm buffer: value})."""
    trainer.model.train(train)
    trainer.optimizer.zero_grad(set_to_none=True)
    loss, ep = trainer.loss(trainer.forward(trainer.to_device(batch)))
    loss.backward()
    trainer.sync_gradients()
    metrics = trainer.dp_mean({"loss": loss.detach()})
    grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()
             if p.grad is not None}
    buffers = {n: b.clone() for n, b in trainer.model.named_buffers()
               if n.endswith(("running_mean", "running_var"))}
    return float(metrics["loss"]), grads, buffers


def make_trainer(cfg_kw, roberta_kw, npoints, state_dict, dp=None, mp=1):
    from butd_detr_tpu_torch.config import Config
    from butd_detr_tpu_torch.lang import RobertaConfig
    from butd_detr_tpu_torch.parallel import make_mesh
    from butd_detr_tpu_torch.train import Trainer

    trainer = Trainer(Config(**cfg_kw), roberta_config=RobertaConfig(
        **roberta_kw), backbone_npoints=npoints, device="cpu",
        state_dict=state_dict, mesh=make_mesh(dp=dp, mp=mp))
    no_dropout(trainer.model)
    return trainer


def dp_gradients(rank, cfg_kw, roberta_kw, npoints, state_dict, batch):
    """The `--dp` world's gradient steps on its rows of `batch`, in eval
    and in train mode."""
    trainer = make_trainer(cfg_kw, roberta_kw, npoints, state_dict)
    rows = trainer.mesh.shard_batch(batch)
    return dict(eval=gradient_step(trainer, rows, train=False),
                train=gradient_step(trainer, rows))


def global_batchnorm(rank, x, seed):
    """A BatchNorm over the dp group on this rank's rows of `x`: output,
    running buffers and the input's gradient of a fixed cotangent."""
    from butd_detr_tpu_torch.nn.mlp import BatchNorm
    from butd_detr_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    bn = BatchNorm(x.shape[-1])
    bn.group = mesh.dp_group
    torch.manual_seed(seed)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    rows = mesh.rows(len(x))
    xs = torch.as_tensor(x[rows]).clone().requires_grad_(True)
    y = bn.train()(xs)
    cot = torch.as_tensor(np.random.RandomState(seed).randn(*x.shape)
                          .astype(np.float32))[rows]
    (y * cot).sum().backward()
    return dict(y=y.detach(), grad=xs.grad, mean=bn.running_mean.clone(),
                var=bn.running_var.clone())


def merge_counters(rank, dicts):
    """`allreduce_dict` of this rank's dict, and the one-process helpers'
    view of the group."""
    from butd_detr_tpu_torch.utils.dist import (
        allreduce_dict,
        is_main_process,
        process_count,
        process_index,
    )

    return dict(merged=allreduce_dict(dicts[rank]), count=process_count(),
                index=process_index(), main=is_main_process())


def eval_end_points(trainer, batch):
    """The eval-mode end points of `batch`, as numpy arrays."""
    from butd_detr_tpu_torch.train import INPUT_KEYS

    trainer.model.eval()
    with torch.no_grad():
        ep = trainer.model({k: torch.as_tensor(batch[k])
                            for k in INPUT_KEYS})
    return {k: v.numpy() for k, v in ep.items()
            if isinstance(v, torch.Tensor)}


def tp_world(rank, cfg_kw, roberta_kw, npoints, state_dict, batch,
             ckpt_dir):
    """An `--mp 2` world: the eval forward, one eval-mode gradient (the
    rank's shards) and its clip norm, three train steps with dropout, a
    checkpoint written and read back."""
    from butd_detr_tpu_torch.train import load_checkpoint, save_checkpoint

    trainer = make_trainer(cfg_kw, roberta_kw, npoints, state_dict, mp=2)
    out = dict(specs=dict(trainer.sharded),
               forward=eval_end_points(trainer, batch))
    _, grads, _ = gradient_step(trainer, batch, train=False)
    out["grads"] = grads
    from butd_detr_tpu_torch.train.optimizer import clip_by_global_norm_

    out["norm"] = float(clip_by_global_norm_(
        [p.grad for p in trainer._params()], float("inf"),
        sharded=trainer._sharded_mask, group=trainer.mesh.mp_group))

    live = make_trainer(cfg_kw, roberta_kw, npoints, state_dict, mp=2)
    for m in live.model.modules():  # dropout 0.1 everywhere
        if hasattr(m, "p"):
            m.p = 0.1
        if hasattr(m, "dropout") and isinstance(m.dropout, float):
            m.dropout = 0.1
    out["losses"] = [live.train_step(batch)["loss"] for _ in range(3)]
    out["after"] = {k: v.clone() for k, v in live.model.state_dict().items()}
    out["checkpoint"] = save_checkpoint(ckpt_dir, 3, live)
    out["after_forward"] = eval_end_points(live, batch)
    back = make_trainer(cfg_kw, roberta_kw, npoints, state_dict, mp=2)
    load_checkpoint(out["checkpoint"], back)
    out["restored"] = all(torch.equal(v, out["after"][k])
                          for k, v in back.model.state_dict().items())
    out["restored_step"] = back.step
    return out


# ------------------------------------------------------------ the harness

def synthetic_tester(cfg_kw, roberta_kw, npoints, scenes, n_train=8,
                     n_test=10):
    """A `TrainTester` over seeded synthetic scenes and a small model,
    through the `get_datasets` seam (test_torch_harness.py's)."""
    from butd_detr_tpu_torch.config import Config
    from butd_detr_tpu_torch.data import SyntheticGroundingDataset
    from butd_detr_tpu_torch.lang import RobertaConfig
    from butd_detr_tpu_torch.predict import build_model
    from butd_detr_tpu_torch.train import TrainTester

    class Tester(TrainTester):
        def get_datasets(self):
            return (SyntheticGroundingDataset(n_train, seed=11, **scenes),
                    SyntheticGroundingDataset(n_test, seed=12, **scenes))

        def _roberta_config(self):
            return RobertaConfig(**roberta_kw)

        def get_model(self):
            return build_model(self.cfg, self._roberta_config(), npoints)

    return Tester(Config(**cfg_kw), device="cpu")


def harness_world(rank, cfg_kw, roberta_kw, npoints, scenes):
    """`TrainTester.main` in this world (one epoch, a checkpoint, an
    evaluation), then one evaluation epoch of freshly seeded weights:
    the steps, the counters, the evaluation's log lines."""
    tester = synthetic_tester(cfg_kw, roberta_kw, npoints, scenes)
    trained = tester.main()
    train_loader, test_loader = tester.get_loaders()
    fresh = tester.get_trainer(len(train_loader))
    evaluator = tester.evaluate_one_epoch(0, test_loader, fresh)
    return dict(step=trained.step, dets=dict(evaluator.dets),
                gts=dict(evaluator.gts),
                rows=[int(b["point_clouds"].shape[0]) for b in test_loader],
                valid=[b.get("__valid__") for b in test_loader])


def detection_world(rank, cfg_kw, roberta_kw, npoints, state_dict):
    """A detection epoch (`--test_dataset scannet`) of this world through
    the harness's own datasets, with the given weights: the first
    process's {threshold: metrics}, None elsewhere."""
    from butd_detr_tpu_torch.config import Config
    from butd_detr_tpu_torch.lang import RobertaConfig
    from butd_detr_tpu_torch.predict import build_model
    from butd_detr_tpu_torch.train import TrainTester

    class Tester(TrainTester):
        def _roberta_config(self):
            return RobertaConfig(**roberta_kw)

        def get_model(self):
            return build_model(self.cfg, self._roberta_config(), npoints)

    tester = Tester(Config(**cfg_kw), device="cpu")
    _, test_loader = tester.get_loaders()
    trainer = tester.get_trainer(1)
    trainer.load_checkpoint_state(state_dict)
    return tester.evaluate_one_epoch(1, test_loader, trainer)
