"""The train and eval steps of the port.

Counterpart of `butd_detr_tpu/train/step.py`. `Trainer.train_step` runs
forward in train mode -> 7-prefix Hungarian loss (matching on the host, one
copy) -> backward -> global-norm clip -> 3-group AdamW step, on `cuda`
unless the caller passes `device="cpu"`. The JAX package compiles this
into one program over a device mesh; here it is eager PyTorch, with the
TPU kernels' counterparts (FPS, ball query, attention forward and
backward, row scatter-add) as CUDA kernels. Each stage opens its span
(`utils/spans.py`: `train_step` > `to_device`, `begin_step`, `forward`,
`loss`, `backward`, `optimizer`; `eval_step`), which costs a flag test
unless the spans are on.

Across processes (`mesh`, `parallel/mesh.py`) each rank steps on its rows
of the batch: BatchNorm statistics and the loss's box count are the dp
group's, gradients are averaged over it before the clip (one flat
all-reduce), the logged losses are its mean, and under `--mp` the
transformer's projections hold the rank's shard (`parallel/tp.py`) and
the clip counts each shard once. Checkpoints carry the one-process
weights (`checkpoint_state`, `load_checkpoint_state`).
"""

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from butd_detr_tpu_torch.config import Config
from butd_detr_tpu_torch.init import init_weights_
from butd_detr_tpu_torch.lang.roberta import RobertaConfig, \
    roberta_base_config
from butd_detr_tpu_torch.losses import CriterionConfig, \
    compute_hungarian_loss
from butd_detr_tpu_torch.parallel.collectives import reduce_from_group
from butd_detr_tpu_torch.parallel.mesh import Mesh, bind_batchnorm
from butd_detr_tpu_torch.parallel.tp import (
    gather_full_state_dict,
    shard_model_,
    shard_state_dict,
    shard_tensor,
)
from butd_detr_tpu_torch.predict import (
    build_model,
    load_state_dict,
    resolve_device,
)
from butd_detr_tpu_torch.train.optimizer import (
    clip_by_global_norm_,
    make_optimizer,
    make_schedule,
)
from butd_detr_tpu_torch.utils.spans import span, to_host

# GT keys the criterion reads from the batch
TARGET_KEYS = (
    "center_label",
    "size_gts",
    "sem_cls_label",
    "positive_map",
    "box_label_mask",
    "point_instance_label",
    "text_mask",
)

# model input keys
INPUT_KEYS = (
    "point_clouds",
    "text_ids",
    "text_mask",
    "det_boxes",
    "det_class_ids",
    "det_bbox_label_mask",
)

METRIC_KEYS = (
    "loss",
    "loss_ce",
    "loss_bbox",
    "loss_giou",
    "loss_contrastive_align",
    "query_points_generation_loss",
)


def criterion_config(cfg: Config) -> CriterionConfig:
    return CriterionConfig(
        eos_coef=cfg.eos_coef,
        temperature=0.07,
        cost_class=1.0,
        cost_bbox=0.0,
        cost_giou=2.0,
        use_contrastive_align=cfg.use_contrastive_align,
        use_soft_token=cfg.use_soft_token_loss,
    )


class Trainer:
    """The model, its optimizer and the step counter.

    cfg: model, loss and optimizer flags (`config.butd_cls_config()` for
        the SR3D butd_cls setup).
    steps_per_epoch: converts the schedule's epochs into steps.
    state_dict: reference-named weights; None fills the model with seeded
        random weights from `seed`.
    model: a model built by the caller (`build_model`), used instead of
        building one from `roberta_config` and `backbone_npoints`.
    device: `cuda` unless given.
    seed: also seeds the trainer's `torch.Generator` (on the host), from
        which each step draws the seed of its dropout masks (the same on
        every rank; the dp index is mixed in, so that the dp shards draw
        different masks and the mp ranks of one shard equal ones).
    mesh: the process groups of this rank (`parallel.make_mesh`); None is
        one process. `state_dict` and `model` hold the full weights: the
        trainer takes its rank's shard.
    """

    def __init__(self, cfg: Config, steps_per_epoch: int = 1, *,
                 roberta_config: Optional[RobertaConfig] = None,
                 backbone_npoints=(2048, 1024, 512, 256), state_dict=None,
                 model=None, device=None, seed: int = 0,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh or Mesh()
        if model is None:
            model = build_model(cfg, roberta_config or roberta_base_config(),
                                backbone_npoints)
        if state_dict is None:
            init_weights_(model, seed)
        else:
            load_state_dict(model, state_dict)
        # {name: spec} of the parameters this rank holds a shard of
        self.sharded = shard_model_(model, self.mesh)
        bind_batchnorm(model, self.mesh.dp_group)
        self.model = model.to(self.device)
        self.criterion = criterion_config(cfg)
        self.optimizer = make_optimizer(cfg, self.model.named_parameters())
        names = {id(p): n for n, p in self.model.named_parameters()}
        # optimizer order: the parameters' names, and which are shards
        self._order = [names[id(p)] for g in self.optimizer.param_groups
                       for p in g["params"]]
        self._sharded_mask = torch.tensor(
            [n in self.sharded for n in self._order], dtype=torch.bool,
            device=self.device)
        self.schedules = {
            g["name"]: make_schedule(g["base_lr"], steps_per_epoch, cfg)
            for g in self.optimizer.param_groups}
        self.generator = torch.Generator().manual_seed(seed)
        self.step = 0

    def to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The batch's arrays (numpy or tensors) on the trainer's device."""
        with span("to_device"):
            return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                    for k, v in batch.items()}

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """The model's end points for a batch on the device, with the
        batch's targets added for the criterion."""
        with span("forward"):
            end_points = self.model(
                {k: batch[k] for k in INPUT_KEYS if k in batch})
        for k in TARGET_KEYS:
            if k in batch:
                end_points[k] = batch[k]
        return end_points

    def loss(self, end_points: Dict[str, torch.Tensor]):
        """(loss, end_points with the losses added); the box count is the
        dp group's."""
        with span("loss"):
            return compute_hungarian_loss(
                end_points, self.cfg.num_decoder_layers, self.criterion,
                self.cfg.query_points_obj_topk, group=self.mesh.dp_group)

    def begin_step(self) -> None:
        """Train mode, this step's dropout seed and learning rates, and
        cleared gradients."""
        with span("begin_step"):
            self.model.train()
            seed = int(torch.randint(0, 2 ** 62, (1,),
                                     generator=self.generator))
            self.model.rng.seed((seed + self.mesh.dp_index * 1_000_003)
                                % 2 ** 62)
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedules[group["name"]](self.step)
            self.optimizer.zero_grad(set_to_none=True)

    def backward(self, loss: torch.Tensor) -> None:
        """The gradients of `loss` (the autograd engine's dispatch)."""
        with span("backward"):
            loss.backward()

    def _params(self):
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def sync_gradients(self) -> None:
        """Give every trainable parameter a gradient (zeros where it was
        unused: it still decays, as under optax) and average the gradients
        over the dp group, in one flat all-reduce."""
        params = self._params()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        group = self.mesh.dp_group
        if group is None:
            return
        grads = [p.grad for p in params]
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=group)
        flat.div_(self.mesh.dp)
        for g, avg in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(avg)

    def apply_gradients(self) -> torch.Tensor:
        """Average the gradients over the dp group, clip their global norm
        (each shard counted once under mp), take the optimizer step;
        returns the norm before clipping (on the device)."""
        with span("optimizer"):
            self.sync_gradients()
            grad_norm = clip_by_global_norm_(
                [p.grad for p in self._params()], self.cfg.clip_norm,
                sharded=self._sharded_mask, group=self.mesh.mp_group)
            self.optimizer.step()
            self.step += 1
            return grad_norm

    def dp_mean(self, named: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """0-d tensors averaged over the dp group (one all-reduce)."""
        if self.mesh.dp_group is None or not named:
            return named
        values = reduce_from_group(
            torch.stack([v.float() for v in named.values()]),
            self.mesh.dp_group) / self.mesh.dp
        return dict(zip(named, values.unbind()))

    # ---------------- checkpoints: the one-process weights ----------------

    def checkpoint_state(self) -> Dict:
        """{"model", "optimizer"} state dicts with the full (one-process)
        tensors; every mp rank must call this (the shards are gathered)."""
        model = gather_full_state_dict(self.model.state_dict(), self.sharded,
                                       self.mesh)
        optimizer = self.optimizer.state_dict()
        for i, state in optimizer["state"].items():
            spec = self.sharded.get(self._order[i])
            if spec is None:
                continue
            optimizer["state"][i] = dict(state, **gather_full_state_dict(
                {k: v for k, v in state.items() if v.ndim},
                {k: spec for k, v in state.items() if v.ndim}, self.mesh))
        return {"model": model, "optimizer": optimizer}

    def load_checkpoint_state(self, model_state: Dict,
                              optimizer_state: Optional[Dict] = None) -> None:
        """Load full (one-process) state dicts, taking this rank's shard."""
        mesh = self.mesh
        self.model.load_state_dict(
            shard_state_dict(model_state, mesh.mp, mesh.mp_index))
        if optimizer_state is None:
            return
        optimizer_state = dict(optimizer_state,
                               state=dict(optimizer_state["state"]))
        for i, state in optimizer_state["state"].items():
            spec = self.sharded.get(self._order[i])
            if spec is not None:
                optimizer_state["state"][i] = {
                    k: shard_tensor(v, spec, mesh.mp, mesh.mp_index)
                    if v.ndim else v for k, v in state.items()}
        self.optimizer.load_state_dict(optimizer_state)

    def train_step_on_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One optimizer step on `batch` (this rank's rows); returns the
        losses under METRIC_KEYS (their mean over the dp group) and the gradients' global norm before clipping
        (`grad_norm`) as 0-d tensors on the device, not read back."""
        with span("train_step", step=self.step):
            batch = self.to_device(batch)
            self.begin_step()
            loss, end_points = self.loss(self.forward(batch))
            self.backward(loss)
            grad_norm = self.apply_gradients()
            named = self.dp_mean({
                k: torch.as_tensor(end_points[k], dtype=torch.float32,
                                   device=grad_norm.device).detach()
                for k in METRIC_KEYS if k in end_points})
            named["grad_norm"] = grad_norm
            return named

    def train_step(self, batch: Dict) -> Dict[str, float]:
        """`train_step_on_device`, its metrics read back in one copy (the
        losses the dp group's mean)."""
        return metrics_to_host(self.train_step_on_device(batch))

    @torch.no_grad()
    def eval_step(self, batch: Dict, with_loss: bool = True
                  ) -> Dict[str, torch.Tensor]:
        """The eval-mode end points of `batch`, with the losses added when
        `with_loss` (the batch then carries the TARGET_KEYS)."""
        with span("eval_step"):
            batch = self.to_device(batch)
            self.model.eval()
            end_points = self.forward(batch)
            return self.loss(end_points)[1] if with_loss else end_points


def metrics_to_host(named: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """0-d tensors on one device -> floats, in one copy (a read-back)."""
    values = to_host(torch.stack([v.float() for v in named.values()]))
    return dict(zip(named, values.tolist()))


__all__ = ["INPUT_KEYS", "METRIC_KEYS", "TARGET_KEYS", "Trainer",
           "build_model", "criterion_config", "metrics_to_host"]
