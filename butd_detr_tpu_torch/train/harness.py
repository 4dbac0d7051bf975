"""Train/eval harness: loaders, epoch loops, grounding evaluation.

Counterpart of `butd_detr_tpu/train/harness.py` (reference
`main_utils.py:286-494` BaseTrainTester and `train_dist_mod.py:31-278`
TrainTester). The JAX package threads a jitted step, a state and a device
mesh through its loops; here `train.step.Trainer` holds the model, the
optimizer and the step counter, and the loops take the trainer. Everything
runs on `cuda` unless the caller passes `device="cpu"`.

`get_datasets` builds the two `JointGroundingDataset`s from
`--data_root` as the JAX harness does; a caller may subclass it (the smoke
script and the profile scripts return synthetic scenes). Each epoch logs
one `epoch stats` line of JSON: steps or batches, scenes/s, the share of
the epoch spent waiting on the loader, the kernels launched and, on the
card, the peak memory.

With `--test_dataset scannet` the evaluation is detection mAP and AR at
`--ap_iou_thresholds` on the fixed 18-class prompt, as the JAX harness's
`evaluate_one_epoch_det`: contrastive scores projected onto the classes,
NMS and VOC AP on the host (`eval/detection.py`: the NMS and the VOC
matcher in the host C++ of `native.py`, the rest numpy).

`--use_bf16` builds the model in the bf16 compute dtype
(`predict.build_model`); `--use_multiview` adds the ENet features to each
point (`data/joint_dataset.py`).

Across processes (`torchrun`, or ranks that a caller spawns) the caller
starts the process group (`utils/dist.py:init_distributed`) before
building the `TrainTester`, which lays the `(dp, mp)` mesh over it
(`parallel/mesh.py`) with the JAX harness's meaning: `--batch_size` is
the step's batch across the dp shards, each rank loads and steps on its
rows, BatchNorm statistics are always global (`--syncbn` is logged and
changes nothing), `--mp` shards the transformer (`parallel/tp.py`). The
grounding evaluators' counters are summed over the dp group; detection
gathers every shard's boxes onto the first process, which computes the AP
of one process. Checkpoints hold the one-process weights.

`--profile_dir` traces `--profile_steps` training steps with
`torch.profiler` once a run, from the second batch of the first epoch
(the first if the epoch has one), as the JAX harness's window, and writes
one Chrome trace a rank into the directory. The program's stage spans
(`utils/spans.py`) are on while it records, so the trace holds them as
host annotations (`train_step`, `forward`, `loss`, `backward`, ...).
"""

import json
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from butd_detr_tpu_torch.config import Config
from butd_detr_tpu_torch.data.joint_dataset import JointGroundingDataset
from butd_detr_tpu_torch.data.loader import DataLoader
from butd_detr_tpu_torch.data.positive_map import normalize_caption
from butd_detr_tpu_torch.data.scannet_config import ScannetDatasetConfig
from butd_detr_tpu_torch.eval.detection import (
    APCalculator,
    default_parse_config,
    parse_groundtruths,
    parse_predictions,
)
from butd_detr_tpu_torch.eval.grounding import (
    GroundingEvaluator,
    GroundingGTEvaluator,
    _to_host,
)
from butd_detr_tpu_torch.lang.roberta import RobertaConfig, \
    roberta_base_config
from butd_detr_tpu_torch.native import CALLS as NATIVE_CALLS
from butd_detr_tpu_torch.ops import _cuda
from butd_detr_tpu_torch.parallel.mesh import make_mesh
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
from butd_detr_tpu_torch.utils import spans
from butd_detr_tpu_torch.utils.logging import setup_logger

# what the evaluators read from a batch besides the model's end points; it
# stays on the host
EVALUATOR_KEYS = (
    "all_bboxes", "all_bbox_label_mask", "is_view_dep", "is_hard",
    "is_unique", "sem_cls_label", "box_label_mask", "center_label",
    "size_gts", "positive_map", "point_clouds",
)
# what the detection evaluation reads of a batch's end points: the
# projection's features and the boxes of parse_predictions and
# parse_groundtruths
DETECTION_KEYS = (
    "last_proj_queries", "proj_tokens", "last_center", "last_pred_size",
    "center_label", "size_gts", "box_label_mask", "sem_cls_label",
)

DET18_PROMPT_NAMES = (
    "cabinet", "bed", "chair", "couch", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "other furniture",
)


def detection_token_map(tokenizer) -> Tuple[np.ndarray, np.ndarray]:
    """(wordidx, tokenidx): which token positions of the fixed 18-class
    detection prompt vote for which class (18 = the classes, plus bin 0
    for no-object). Computed from the tokenizer's char_to_token — for HF
    RoBERTa this reproduces the reference's hardcoded tables
    (train_dist_mod.py:206-218)."""
    prompt = " . ".join(DET18_PROMPT_NAMES) + " . not mentioned"
    caption = normalize_caption(prompt)
    tok = tokenizer([caption], max_len=256)
    wordidx, tokenidx = [], []
    cursor = 0
    for w, name in enumerate(list(DET18_PROMPT_NAMES) + ["not mentioned"]):
        start = caption.index(name, cursor)
        cursor = start + len(name)
        toks = set()
        for ci in range(start, start + len(name)):
            t = tok.char_to_token(0, ci)
            if t is not None:
                toks.add(t)
        for t in sorted(toks):
            wordidx.append(0 if name == "not mentioned" else w + 1)
            tokenidx.append(t)
    return np.asarray(wordidx), np.asarray(tokenidx)


def detection_inputs_to_host(end_points: Dict) -> Dict[str, np.ndarray]:
    """The `DETECTION_KEYS` entries of one batch as numpy arrays: the
    device's tensors in one copy (as f32, exact for their f32 values,
    labels and masks), the host's as they are."""
    on_device = {k: end_points[k] for k in DETECTION_KEYS
                 if isinstance(end_points[k], torch.Tensor)}
    host = {k: np.asarray(end_points[k]) for k in DETECTION_KEYS
            if k not in on_device}
    return dict(host, **(_to_host(on_device) if on_device else {}))


class EpochMeter:
    """Iterates a loader for one epoch and times it: the epoch's seconds,
    the seconds spent waiting for a batch from the loader (the first
    batch's apart: it starts the workers), the host seconds spent on each
    batch between its arrival and the request for the next (a step's wall
    time where the caller reads its metrics back), the kernel launches,
    the read-backs (`utils/spans.py`: the blocking copies to the host,
    with their bytes) and, on the card, the peak memory. The clock starts
    at construction, after the device has finished what came before."""

    def __init__(self, loader, device: torch.device):
        self.loader = loader
        self.device = device
        self.wait = []
        self.handled = []
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        self._launches = dict(_cuda.LAUNCHES)
        self._readbacks = spans.counts()["readbacks"]
        self._t0 = time.perf_counter()

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        batches = iter(self.loader)
        while True:
            t = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                return
            arrived = time.perf_counter()
            self.wait.append(arrived - t)
            yield batch
            self.handled.append(time.perf_counter() - arrived)

    def stats(self, scenes: int) -> Dict:
        """The epoch's numbers, once its last batch has been handled."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - self._t0
        wait = sum(self.wait)
        return dict(
            batches=len(self.wait), scenes=scenes, seconds=seconds,
            scenes_per_second=scenes / seconds,
            loader_wait_seconds=wait, loader_wait_share=wait / seconds,
            first_batch_wait_seconds=self.wait[0] if self.wait else 0.0,
            batch_seconds=self.handled,
            launches={k: v - self._launches[k]
                      for k, v in _cuda.LAUNCHES.items()},
            readbacks={k: v - self._readbacks[k] for k, v in
                       spans.counts()["readbacks"].items()},
            peak_memory_bytes=(torch.cuda.max_memory_allocated(self.device)
                               if cuda else None))


class TrainTester:
    """End-to-end harness. `main()` mirrors BaseTrainTester.main
    (main_utils.py:286-359)."""

    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # every rank makes the mesh's groups, before anything else does
        self.mesh = make_mesh(dp=cfg.dp, mp=cfg.mp)
        os.makedirs(cfg.log_dir, exist_ok=True)
        self.logger = setup_logger(output=cfg.log_dir,
                                   distributed_rank=process_index())
        if is_main_process():
            with open(os.path.join(cfg.log_dir, "config.json"), "w") as f:
                f.write(cfg.to_json())
        backend = (dist.get_backend() if dist.is_initialized()
                   else "none (one process)")
        self.logger.info(
            f"process group: backend {backend}, world size "
            f"{process_count()}, dp {self.mesh.dp}, mp {self.mesh.mp}; "
            f"rank {process_index()} on {self.device}")
        if cfg.syncbn:
            self.logger.info(
                "--syncbn: BatchNorm statistics are global over the dp "
                "group in every train step; cross-replica sync is "
                "inherent")
        self._profiled = False

    # ---------------- datasets / loaders ----------------

    def get_datasets(self):
        """(train_dataset, test_dataset): map-style datasets with `__len__`
        and `get(index, rng)` (train_dist_mod.py:38-74). The test set
        shares the train set's tokenizer, and its scans under `--debug`
        (both on the val split) or `--eval_train` (both on train)."""
        cfg = self.cfg
        dataset_dict = {d: 1 for d in cfg.dataset}
        if cfg.joint_det:
            dataset_dict["scannet"] = 10
        self.logger.info(f"Loading datasets: {sorted(dataset_dict)}")
        common = dict(
            test_dataset=cfg.test_dataset, data_path=cfg.data_root,
            use_color=cfg.use_color, use_height=cfg.use_height,
            use_multiview=cfg.use_multiview,
            detect_intermediate=cfg.detect_intermediate, butd=cfg.butd,
            butd_gt=cfg.butd_gt, butd_cls=cfg.butd_cls, overfit=cfg.debug,
            max_text_len=cfg.max_text_len, max_num_obj=cfg.max_num_obj,
            max_det_boxes=cfg.max_det_boxes, spatial_sort=cfg.spatial_sort)
        train_dataset = JointGroundingDataset(
            dataset_dict=dataset_dict,
            split="train" if not cfg.debug else "val",
            augment_det=cfg.augment_det, **common)
        test_dataset = JointGroundingDataset(
            dataset_dict=dataset_dict,
            split="val" if not cfg.eval_train else "train",
            scans=train_dataset.scans if cfg.debug or cfg.eval_train
            else None,
            tokenizer=train_dataset.tokenizer, **common)
        return train_dataset, test_dataset

    def get_loaders(self):
        cfg = self.cfg
        train_dataset, test_dataset = self.get_datasets()
        kw = dict(batch_size=cfg.batch_size, seed=cfg.rng_seed,
                  num_workers=cfg.num_workers, dp_index=self.mesh.dp_index,
                  dp_size=self.mesh.dp)
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
                       seed=self.cfg.rng_seed, mesh=self.mesh)

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
        train_loader, test_loader = self.get_loaders()
        try:
            return self._main(train_loader, test_loader)
        finally:
            for loader in (train_loader, test_loader):
                loader.close()

    def _main(self, train_loader, test_loader) -> Trainer:
        cfg = self.cfg
        self.logger.info(f"lengths: train {len(train_loader.dataset)}, "
                         f"test {len(test_loader.dataset)}")
        t0 = time.time()
        trainer = self.get_trainer(len(train_loader))
        self.logger.info(f"trainer built: {time.time() - t0:.1f}s; compute "
                         f"dtype {trainer.model.dtype}, backbone "
                         f"{trainer.model.backbone_net.sa1.mlp_module.dtype}")
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
                save_checkpoint(cfg.log_dir, epoch, trainer)
                self.evaluate_one_epoch(epoch, test_loader, trainer)

        path = save_checkpoint(cfg.log_dir, cfg.max_epoch, trainer)
        self.logger.info(f"saved {path}")
        self.evaluate_one_epoch(cfg.max_epoch, test_loader, trainer)
        return trainer

    # ---------------- loops ----------------

    def _log_epoch_stats(self, phase: str, epoch: int, stats: Dict):
        self.logger.info("epoch stats " + json.dumps(
            dict(phase=phase, epoch=epoch, **stats), sort_keys=True))

    def train_one_epoch(self, epoch: int, train_loader, trainer: Trainer):
        """main_utils.py:401-456. The metrics stay on the device and are
        read back once per `print_freq` window (the window's last step, as
        the JAX harness logs)."""
        cfg = self.cfg
        n = len(train_loader)
        # the profiler window: `profile_steps` steps from the second batch
        # (the first also warms the allocator and the kernels' builds),
        # once a run
        profile_at = (min(1, n - 1) if cfg.profile_dir and not self._profiled
                      else None)
        profiler = None
        meter = EpochMeter(train_loader, self.device)
        for batch_idx, batch in enumerate(meter):
            if batch_idx == profile_at:
                profiler = self._start_profiler()
            metrics = trainer.train_step_on_device(
                {k: batch[k] for k in (*INPUT_KEYS, *TARGET_KEYS)})
            if profiler is not None and \
                    batch_idx >= profile_at + cfg.profile_steps - 1:
                self._stop_profiler(profiler)
                profiler = None
                self.logger.info(
                    f"profiler trace ({cfg.profile_steps} steps) written "
                    f"to {cfg.profile_dir}")
            if (batch_idx + 1) % cfg.print_freq == 0:
                stat = metrics_to_host(metrics)
                self.logger.info(
                    f"Train: [{epoch}][{batch_idx + 1}/{n}] " + " ".join(
                        f"{k} {v:.4f}" for k, v in sorted(stat.items())))
        if profiler is not None:  # an epoch shorter than the window
            self._stop_profiler(profiler)
        self._log_epoch_stats("train", epoch,
                              meter.stats(scenes=n * cfg.batch_size))

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        self._spans_were_on = spans.enable(True)
        return profiler

    def _stop_profiler(self, profiler) -> str:
        """Stop the window once the device has finished its steps; write
        the rank's Chrome trace into `--profile_dir`."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        spans.enable(self._spans_were_on)
        profiler.stop()
        self._profiled = True
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir,
                            f"trace_rank{process_index()}.json")
        profiler.export_chrome_trace(path)
        return path

    def _eval_batches(self, test_loader, trainer: Trainer):
        """Yield (batch index, end_points) for every eval batch that holds
        real rows of this dp shard, accumulating and logging running-mean
        loss stats (the dp group's) per print_freq window as the
        reference's `_main_eval_branch` does (main_utils.py:458-494)."""
        stat: Dict[str, float] = {}
        wsum = 0.0
        n = len(test_loader)
        B = self.cfg.batch_size
        rows = self.mesh.rows(B)  # this dp shard's rows of every batch
        b = rows.stop - rows.start
        with_loss = not self.cfg.butd_cls
        for batch_idx, batch in enumerate(test_loader):
            # drop_last=False tail batches are padded to the fixed shape
            # by cyclic repetition (data/loader.py); only the first
            # `valid` rows of the whole batch are real samples, and
            # `mine` of this shard's
            valid = batch.pop("__valid__", B)
            mine = min(max(valid - rows.start, 0), b)
            end_points = trainer.eval_step(
                {k: batch[k] for k in (*INPUT_KEYS, *TARGET_KEYS)
                 if k in batch}, with_loss=with_loss)
            loss_keys = [k for k in METRIC_KEYS if k in end_points]
            if loss_keys:
                vals = metrics_to_host(trainer.dp_mean(
                    {k: end_points[k] for k in loss_keys}))
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
            if mine == 0:  # this shard holds only padding
                continue
            if mine < b:
                # cut the padded duplicate rows so that the evaluator
                # counts each real sample exactly once
                end_points = {
                    k: v[:mine]
                    if (hasattr(v, "ndim") and v.ndim >= 1
                        and v.shape[0] == b)
                    or (isinstance(v, list) and len(v) == b)
                    else v
                    for k, v in end_points.items()}
            yield batch_idx, end_points

    def evaluate_one_epoch(self, epoch: int, test_loader, trainer: Trainer):
        """Grounding evaluation (train_dist_mod.py:112-159), or detection
        evaluation when testing on scannet (:161-278); returns the
        evaluator, or the detection metrics."""
        cfg = self.cfg
        if cfg.test_dataset == "scannet":
            return self.evaluate_one_epoch_det(epoch, test_loader, trainer)
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
        meter = EpochMeter(test_loader, self.device)
        for _, end_points in self._eval_batches(meter, trainer):
            evaluator.evaluate(end_points)
        if self.mesh.dp_group is not None:  # each dp shard's rows once
            evaluator.synchronize_between_processes(self.mesh.dp_group)
        self._log_epoch_stats("eval", epoch, meter.stats(
            scenes=len(test_loader.dataset)))
        if is_main_process():
            evaluator.print_stats()
        return evaluator

    def evaluate_one_epoch_det(self, epoch: int, test_loader,
                               trainer: Trainer) -> Dict[float, Dict]:
        """Detection mAP on the scannet prompt (train_dist_mod.py:161-278):
        contrastive scores -> 256-bin -> 19-class projection -> NMS -> AP,
        at every `ap_iou_thresholds`. Returns {threshold: metrics}. The
        `epoch stats` line adds `detection_seconds`, the host seconds of
        the projection, NMS and AP, `detection_copy_seconds`, those of
        the end points' copy to the host, which waits for the batch's
        forward pass, and `native_calls`, this process's calls of the
        host C++ NMS and VOC matcher in the epoch.

        Across dp shards every rank parses its rows and the first process
        steps the AP calculators through every shard's boxes in the order
        of one process's batches; the others return None."""
        cfg = self.cfg
        dc18 = ScannetDatasetConfig(18)
        parse_cfg = default_parse_config(dataset_num_class=dc18.num_class)
        wordidx, tokenidx = detection_token_map(
            test_loader.dataset.tokenizer)
        calculators = [APCalculator(t, dc18.class2type)
                       for t in cfg.ap_iou_thresholds]
        meter = EpochMeter(test_loader, self.device)
        seconds = copy_seconds = 0.0
        calls = {k: NATIVE_CALLS[k] for k in ("greedy_nms", "voc_match")}
        parsed = []  # (batch index, dp index, predictions, ground truths)
        for batch_idx, end_points in self._eval_batches(meter, trainer):
            t0 = time.perf_counter()
            ep = detection_inputs_to_host(end_points)
            t1 = time.perf_counter()
            copy_seconds += t1 - t0
            # contrastive similarities as 256-bin scores (a numpy
            # division, as the JAX harness's)
            sim = np.einsum(
                "bqd,btd->bqt",
                np.asarray(ep["last_proj_queries"], np.float32),
                np.asarray(ep["proj_tokens"], np.float32)) / 0.07
            scores = np.zeros(sim.shape[:2] + (256,), np.float32)
            scores[:, :, :sim.shape[-1]] = sim
            # token -> 19-class projection (bin 18 collects 'not mentioned')
            sem = np.zeros(sim.shape[:2] + (19,), np.float32)
            for w, t in zip(wordidx, tokenidx):
                cls = 18 if w == 0 else w - 1
                sem[..., cls] += scores[..., t]
            ep["last_sem_cls_scores"] = sem
            parsed.append((batch_idx, self.mesh.dp_index,
                           parse_predictions(ep, parse_cfg, "last_"),
                           parse_groundtruths(ep)))
            seconds += time.perf_counter() - t1
        t0 = time.perf_counter()
        if self.mesh.dp_group is not None:
            shards = [None] * self.mesh.dp
            dist.all_gather_object(shards, parsed, group=self.mesh.dp_group)
            parsed = sorted((p for shard in shards for p in shard),
                            key=lambda p: p[:2])
        results = None
        if is_main_process():
            for _, _, preds, gts in parsed:
                for calc in calculators:
                    calc.step(preds, gts)
            results = {t: calc.compute_metrics() for t, calc in
                       zip(cfg.ap_iou_thresholds, calculators)}
        seconds += time.perf_counter() - t0
        stats = meter.stats(scenes=len(test_loader.dataset))
        self._log_epoch_stats("eval", epoch, dict(
            stats, detection_seconds=seconds,
            detection_copy_seconds=copy_seconds,
            native_calls={k: NATIVE_CALLS[k] - v for k, v in calls.items()}))
        for t, metrics in (results or {}).items():
            self.logger.info(f"=====> last_ IOU THRESH: {t} <=====")
            self.logger.info(
                f"mAP {metrics['mAP']:.4f} AR {metrics['AR']:.4f}")
        return results


__all__ = ["DET18_PROMPT_NAMES", "EVALUATOR_KEYS", "EpochMeter",
           "TrainTester", "detection_token_map"]
