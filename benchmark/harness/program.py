"""The system under test: the port's `Trainer` and grounding evaluators,
built from a configuration file, and the entries a cell's window drives.

Only this module imports the program (`butd_detr_tpu_torch`). Besides the
entries it reads the kernel launch counter (`ops/_cuda.py:LAUNCHES`) and,
in the steps whose outputs are judged, records what the program decided
on its way: the query selection (from the model's end points, through a
forward hook) and the matching (through a wrapper around the criterion's
`hungarian_match`). The faults that a correctness check has to catch are
planted here.
"""

import dataclasses
from typing import Dict, List, Optional

import torch

from butd_detr_tpu_torch import native
from butd_detr_tpu_torch.config import Config
from butd_detr_tpu_torch.eval.grounding import (
    GroundingEvaluator,
    GroundingGTEvaluator,
)
from butd_detr_tpu_torch.lang.roberta import RobertaConfig
from butd_detr_tpu_torch.losses import criterion as _criterion
from butd_detr_tpu_torch.models.bdetr import prediction_prefixes
from butd_detr_tpu_torch.ops import _cuda
from butd_detr_tpu_torch.parallel.mesh import Mesh, bind_batchnorm, make_mesh
from butd_detr_tpu_torch.train.step import (
    INPUT_KEYS,
    TARGET_KEYS,
    Trainer,
    metrics_to_host,
)
from butd_detr_tpu_torch.utils.dist import init_distributed

FAULTS = ("unchanged", "half_batch", "altered", "head", "local_bn",
          "unsynced")
# what the grounding evaluators read of a batch besides the end points
EVALUATOR_KEYS = ("all_bboxes", "all_bbox_label_mask", "is_view_dep",
                  "is_hard", "is_unique")


def port_config(config: Dict, control: bool = False, dp: int = 1
                ) -> Config:
    """The port's `Config` of a configuration file's flags; `control`
    switches on the program's lower-precision path (`--use_bf16`). Over
    `dp` processes the port's `--batch_size` is the global batch, the
    file's batch a process times `dp`."""
    flags = dict(config["flags"])
    if control:
        flags["use_bf16"] = True
    if dp > 1:
        flags.update(dp=dp, batch_size=flags["batch_size"] * dp)
    return Config(**flags)


def build_trainer(config: Dict, weights: Dict, seed: int, device,
                  control: bool = False, mesh: Optional[Mesh] = None
                  ) -> Trainer:
    """The port's `Trainer` on `device`; with a `mesh`, this rank's."""
    cfg = port_config(config, control, mesh.dp if mesh else 1)
    t = config["text_encoder"]
    roberta = RobertaConfig(**{f.name: t[f.name]
                               for f in dataclasses.fields(RobertaConfig)
                               if f.name in t})
    return Trainer(cfg, config["steps_per_epoch"], roberta_config=roberta,
                   backbone_npoints=tuple(config["model"]["backbone_npoints"]),
                   state_dict=weights, device=device, seed=seed,
                   mesh=mesh)


def join_ranks(backend: str, rank: int, world: int, init_method: str
               ) -> Mesh:
    """This process into the world's default process group, through the
    port's own set-up (`utils/dist.py:init_distributed`); the mesh of every
    rank of the world on one dp axis (`parallel.make_mesh`)."""
    init_distributed(backend, rank=rank, world_size=world,
                     init_method=init_method)
    return make_mesh(dp=world)


def load_kernels() -> None:
    """Build, where the checkout has no build of them yet, and load the
    port's CUDA kernels and its host runtime."""
    _cuda.build_all()
    native.library()


def build_evaluator(config: Dict):
    cfg = port_config(config)
    prefixes = prediction_prefixes(cfg.num_decoder_layers)
    prefixes = prefixes[-1:] + prefixes[:-1]  # the harness's order
    if cfg.butd_cls or cfg.butd_gt:
        return GroundingGTEvaluator(prefixes=prefixes, logger=_Quiet(),
                                    with_contrast=cfg.use_contrastive_align)
    return GroundingEvaluator(only_root=True, thresholds=(0.25, 0.5),
                              topks=(1, 5, 10), prefixes=prefixes,
                              logger=_Quiet(),
                              with_contrast=cfg.use_contrastive_align)


class _Quiet:
    def info(self, *_):
        pass


def with_loss(config: Dict) -> bool:
    """The harness evaluates with the loss unless the setup is butd_cls."""
    return not port_config(config).butd_cls


def train_feed(batch: Dict) -> Dict:
    return {k: batch[k] for k in (*INPUT_KEYS, *TARGET_KEYS)}


def eval_feed(batch: Dict) -> Dict:
    return {k: batch[k] for k in (*INPUT_KEYS, *TARGET_KEYS) if k in batch}


def launches() -> Dict[str, int]:
    return dict(_cuda.LAUNCHES)


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in _cuda.LAUNCHES.items()}


INDEX_KEYS = ("query_points_sample_inds", "sa1_inds", "sa2_inds")
OUTPUT_SUFFIXES = ("center", "pred_size", "sem_cls_scores", "proj_queries",
                   "proj_tokens", "seeds_obj_cls_logits", "fp2_features",
                   "fp2_xyz", "fp2_inds")


class Recorder:
    """Records, while armed, the program's query selection and feature
    sampling indices (the model's end points; the first forward's answers
    too) and its matching (the criterion's `hungarian_match`), each as the
    program computed them."""

    def __init__(self, trainer: Trainer):
        self.armed = False
        self.forward: List[Dict[str, torch.Tensor]] = []
        self.matches: List[torch.Tensor] = []
        self._hook = trainer.model.register_forward_hook(self._on_forward)
        self._match = _criterion.hungarian_match
        _criterion.hungarian_match = self._on_match

    def _on_forward(self, module, inputs, ep):
        if self.armed:
            keys = INDEX_KEYS if self.forward else INDEX_KEYS + tuple(
                k for k in ep if k.endswith(OUTPUT_SUFFIXES))
            self.forward.append({k: ep[k].detach().clone() for k in keys})

    def _on_match(self, *args, **kwargs):
        out = self._match(*args, **kwargs)
        if self.armed:
            self.matches.append(out.detach().clone())
        return out

    def close(self):
        self._hook.remove()
        _criterion.hungarian_match = self._match


def plant(trainer: Trainer, fault: Optional[str]) -> None:
    """Break the timed path underneath the entries: `unchanged` makes the
    optimizer step leave the state as it was, `half_batch` leaves out the
    second half of every batch (its rows replaced by the first half's, so
    that the losses are the mean over the first half), `head` shifts the
    last decoder layer's box centres by one query where its head produces
    them; `altered` is the evaluator's (`plant_evaluator`). Across
    processes: `local_bn` makes every BatchNorm normalise with its own
    rank's statistics (the all-reduces bypassed), and `unsynced` makes the
    last rank step on its own gradient (it still joins the gradients'
    all-reduce, so that the other ranks do not wait for it, and leaves its
    result unused)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if fault == "unchanged":
        trainer.optimizer.step = lambda *a, **k: None
    elif fault == "half_batch":
        to_device = trainer.to_device

        def half(batch):
            b = next(iter(batch.values())).shape[0] // 2
            return to_device({k: torch.cat([v[:b], v[:b], v[2 * b:]])
                              for k, v in batch.items()})

        trainer.to_device = half
    elif fault == "head":
        def shifted(module, inputs, out):
            return dict(out, center=out["center"].roll(1, dims=1))

        trainer.model.prediction_heads[-1].register_forward_hook(shifted)
    elif fault == "local_bn":
        bind_batchnorm(trainer.model, None)
    elif fault == "unsynced" and \
            trainer.mesh.dp_index == trainer.mesh.dp - 1:
        sync = trainer.sync_gradients

        def unsynced():
            params = trainer._params()
            own = [None if p.grad is None else p.grad.clone()
                   for p in params]
            sync()
            for p, g in zip(params, own):
                if g is None:
                    p.grad.zero_()
                else:
                    p.grad.copy_(g)

        trainer.sync_gradients = unsynced


def plant_evaluator(evaluator, fault: Optional[str]) -> None:
    """`altered`: the evaluator's first hit of every batch (its first
    layer's first mode, the first row) turned over where it is produced."""
    if fault != "altered":
        return
    hits = evaluator._hits

    def altered(end_points):
        out = dict(hits(end_points))
        key = next(k for k in out if k not in ("mask", "root_found"))
        flipped = out[key].copy()
        flipped.reshape(-1)[0] = 1.0 - flipped.reshape(-1)[0]
        out[key] = flipped
        return out

    evaluator._hits = altered


__all__ = ["EVALUATOR_KEYS", "FAULTS", "Recorder", "build_evaluator",
           "build_trainer", "eval_feed", "join_ranks",
           "launches", "launches_since", "load_kernels", "metrics_to_host",
           "plant", "plant_evaluator", "port_config", "train_feed",
           "with_loss"]
