"""Train/eval harness: loaders, epoch loops, grounding evaluation.

Counterpart of `butd_detr_tpu/train/harness.py` (reference
`main_utils.py:286-494` BaseTrainTester and `train_dist_mod.py:31-278`
TrainTester). The JAX package threads a jitted step, a state and a device
mesh through its loops; here `train.step.Trainer` holds the model, the
optimizer and the step counter, and the loops take the trainer. Everything
runs on `cuda` unless the caller passes `device="cpu"`.

What waits for its slice raises `NotImplementedError` naming the ROADMAP
queue: `get_datasets` (the ScanNet/ReferIt3D datasets, "Data": callers
subclass it, as the studies do), the detection evaluation for
`test_dataset == "scannet"` ("Evaluation: detection"), `--mp` and `--dp`
above 1 ("Distribution"), `--use_bf16` ("Precision") and the profiler
window ("The rest of the surface").
"""

import os
import time
from typing import Dict, List

from butd_detr_tpu_torch.config import Config
from butd_detr_tpu_torch.data.loader import DataLoader
from butd_detr_tpu_torch.eval.grounding import (
    GroundingEvaluator,
    GroundingGTEvaluator,
)
from butd_detr_tpu_torch.lang.roberta import RobertaConfig, \
    roberta_base_config
from butd_detr_tpu_torch.predict import build_model, resolve_device
from butd_detr_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from butd_detr_tpu_torch.train.pretrained import apply_pretrained_init
from butd_detr_tpu_torch.train.step import (
    INPUT_KEYS,
    METRIC_KEYS,
    TARGET_KEYS,
    Trainer,
    metrics_to_host,
)
from butd_detr_tpu_torch.utils.dist import (
    is_main_process,
    process_count,
    process_index,
)
from butd_detr_tpu_torch.utils.logging import setup_logger

# what the evaluators read from a batch besides the model's end points; it
# stays on the host
EVALUATOR_KEYS = (
    "all_bboxes", "all_bbox_label_mask", "is_view_dep", "is_hard",
    "is_unique", "sem_cls_label", "box_label_mask", "center_label",
    "size_gts", "positive_map", "point_clouds",
)


def _refuse_unported(cfg: Config) -> None:
    waits = {
        "--mp > 1 (tensor parallelism)": (cfg.mp > 1, "Distribution"),
        "--dp > 1 (data parallelism)": ((cfg.dp or 1) > 1, "Distribution"),
        "--use_bf16 (the bf16 transformer stack)": (cfg.use_bf16,
                                                    "Precision"),
        "--profile_dir (the profiler window)": (
            bool(cfg.profile_dir), "The rest of the surface"),
    }
    for what, (asked, queue) in waits.items():
        if asked:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP queue 1, '{queue}')")


class TrainTester:
    """End-to-end harness. `main()` mirrors BaseTrainTester.main
    (main_utils.py:286-359)."""

    def __init__(self, cfg: Config, device=None):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        os.makedirs(cfg.log_dir, exist_ok=True)
        self.logger = setup_logger(output=cfg.log_dir,
                                   distributed_rank=process_index())
        with open(os.path.join(cfg.log_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())

    # ---------------- datasets / loaders ----------------

    def get_datasets(self):
        """(train_dataset, test_dataset): map-style datasets with `__len__`
        and `get(index, rng)` (train_dist_mod.py:38-74)."""
        raise NotImplementedError(
            "JointGroundingDataset is not ported yet (ROADMAP queue 1, "
            "'Data'); subclass TrainTester and return (train_dataset, "
            "test_dataset) from get_datasets, e.g. two "
            "data.SyntheticGroundingDataset")

    def get_loaders(self):
        cfg = self.cfg
        train_dataset, test_dataset = self.get_datasets()
        kw = dict(batch_size=cfg.batch_size, seed=cfg.rng_seed,
                  num_workers=cfg.num_workers,
                  process_index=process_index(),
                  process_count=process_count())
        train_loader = DataLoader(train_dataset, shuffle=True, **kw)
        test_loader = DataLoader(test_dataset, shuffle=False,
                                 drop_last=False, **kw)
        return train_loader, test_loader

    # ---------------- model / trainer ----------------

    def _roberta_config(self) -> RobertaConfig:
        return roberta_base_config()

    def get_model(self):
        return build_model(self.cfg, self._roberta_config())

    def get_trainer(self, steps_per_epoch: int) -> Trainer:
        """The model of `get_model` with seeded random weights, its
        optimizer and schedules, on the harness's device."""
        return Trainer(self.cfg, steps_per_epoch=max(steps_per_epoch, 1),
                       model=self.get_model(), device=self.device,
                       seed=self.cfg.rng_seed)

    def init_pretrained(self, trainer: Trainer) -> Dict[str, str]:
        """From-scratch initialization from pretrained sources, matching
        the reference (bdetr.py:60-94): frozen roberta-base trunk,
        GroupFree PointNet++ via --pp_checkpoint, class_embeddings3d.npy
        table (by default under --data_root). A later checkpoint restore
        overwrites all of this (the reference's load order,
        main_utils.py:286-330). Returns the report."""
        return apply_pretrained_init(trainer.model, self.cfg,
                                     logger=self.logger,
                                     roberta_config=self._roberta_config())

    def prefixes(self) -> List[str]:
        cfg = self.cfg
        if cfg.num_decoder_layers > 0:
            return (["last_", "proposal_"]
                    + [f"{i}head_" for i in range(cfg.num_decoder_layers - 1)])
        return ["proposal_"]

    # ---------------- main ----------------

    def main(self) -> Trainer:
        cfg = self.cfg
        train_loader, test_loader = self.get_loaders()
        self.logger.info(f"lengths: train {len(train_loader.dataset)}, "
                         f"test {len(test_loader.dataset)}")
        t0 = time.time()
        trainer = self.get_trainer(len(train_loader))
        self.logger.info(f"trainer built: {time.time() - t0:.1f}s")
        self.init_pretrained(trainer)

        start_epoch = cfg.start_epoch
        ckpt = cfg.checkpoint_path or (
            latest_checkpoint(cfg.log_dir) if not cfg.eval else None)
        if ckpt:
            start_epoch = load_checkpoint(ckpt, trainer,
                                          reduce_lr=cfg.reduce_lr)
            self.logger.info(f"restored {ckpt}; start_epoch={start_epoch}")

        if cfg.eval:
            self.evaluate_one_epoch(start_epoch, test_loader, trainer)
            return trainer

        for epoch in range(start_epoch, cfg.max_epoch + 1):
            train_loader.set_epoch(epoch)
            tic = time.time()
            self.train_one_epoch(epoch, train_loader, trainer)
            self.logger.info(
                f"epoch {epoch}, total time {time.time() - tic:.2f}")
            if epoch % cfg.val_freq == 0:
                if is_main_process():
                    save_checkpoint(cfg.log_dir, epoch, trainer)
                self.evaluate_one_epoch(epoch, test_loader, trainer)

        if is_main_process():
            path = save_checkpoint(cfg.log_dir, cfg.max_epoch, trainer)
            self.logger.info(f"saved {path}")
        self.evaluate_one_epoch(cfg.max_epoch, test_loader, trainer)
        return trainer

    # ---------------- loops ----------------

    def train_one_epoch(self, epoch: int, train_loader, trainer: Trainer):
        """main_utils.py:401-456. The metrics stay on the device and are
        read back once per `print_freq` window (the window's last step, as
        the JAX harness logs)."""
        cfg = self.cfg
        n = len(train_loader)
        for batch_idx, batch in enumerate(train_loader):
            metrics = trainer.train_step_on_device(
                {k: batch[k] for k in (*INPUT_KEYS, *TARGET_KEYS)})
            if (batch_idx + 1) % cfg.print_freq == 0:
                stat = metrics_to_host(metrics)
                self.logger.info(
                    f"Train: [{epoch}][{batch_idx + 1}/{n}] " + " ".join(
                        f"{k} {v:.4f}" for k, v in sorted(stat.items())))

    def _eval_batches(self, test_loader, trainer: Trainer):
        """Yield (batch, end_points) for every eval batch, accumulating and
        logging running-mean loss stats per print_freq window as the
        reference's `_main_eval_branch` does (main_utils.py:458-494)."""
        stat: Dict[str, float] = {}
        wsum = 0.0
        n = len(test_loader)
        B = self.cfg.batch_size
        with_loss = not self.cfg.butd_cls
        for batch_idx, batch in enumerate(test_loader):
            # drop_last=False tail batches are padded to the fixed shape
            # by cyclic repetition (data/loader.py); only the first
            # `valid` rows are real samples
            valid = batch.pop("__valid__", B)
            end_points = trainer.eval_step(
                {k: batch[k] for k in (*INPUT_KEYS, *TARGET_KEYS)
                 if k in batch}, with_loss=with_loss)
            loss_keys = [k for k in METRIC_KEYS if k in end_points]
            if loss_keys:
                vals = metrics_to_host({k: end_points[k] for k in loss_keys})
                # a padded tail's loss scalars are means over the FULL
                # padded batch: weight by valid / B to keep the running
                # mean per real sample
                w = valid / B
                wsum += w
                for k, v in vals.items():
                    stat[k] = stat.get(k, 0.0) + v * w
                if (batch_idx + 1) % self.cfg.print_freq == 0:
                    self.logger.info(
                        f"Eval: [{batch_idx + 1}/{n}] " + " ".join(
                            f"{k} {v / wsum:.4f}"
                            for k, v in sorted(stat.items())))
            # the targets the step already moved stay on the device for
            # the evaluator; its other inputs stay on the host
            for k in EVALUATOR_KEYS:
                if k in batch:
                    end_points.setdefault(k, batch[k])
            if valid < B:
                # cut the padded duplicate rows so that the evaluator
                # counts each real sample exactly once
                end_points = {
                    k: v[:valid]
                    if (hasattr(v, "ndim") and v.ndim >= 1
                        and v.shape[0] == B)
                    or (isinstance(v, list) and len(v) == B)
                    else v
                    for k, v in end_points.items()}
            yield batch, end_points

    def evaluate_one_epoch(self, epoch: int, test_loader, trainer: Trainer):
        """Grounding evaluation (train_dist_mod.py:112-159); returns the
        evaluator."""
        cfg = self.cfg
        if cfg.test_dataset == "scannet":
            raise NotImplementedError(
                "the detection evaluation (test_dataset 'scannet') is not "
                "ported yet (ROADMAP queue 1, 'Evaluation: detection')")
        prefixes = self.prefixes()
        if cfg.butd_cls or cfg.butd_gt:
            evaluator = GroundingGTEvaluator(
                prefixes=prefixes, logger=self.logger,
                with_contrast=cfg.use_contrastive_align)
        else:
            evaluator = GroundingEvaluator(
                only_root=True, thresholds=(0.25, 0.5), topks=(1, 5, 10),
                prefixes=prefixes, logger=self.logger,
                with_contrast=cfg.use_contrastive_align)
        for _, end_points in self._eval_batches(test_loader, trainer):
            evaluator.evaluate(end_points)
        evaluator.synchronize_between_processes()
        if is_main_process():
            evaluator.print_stats()
        return evaluator


__all__ = ["EVALUATOR_KEYS", "TrainTester"]
