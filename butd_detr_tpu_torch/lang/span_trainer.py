"""Span-predictor training, evaluation and `--store`.

Counterpart of `butd_detr_tpu/lang/span_trainer.py` (reference
`src/text_cls.py`: Trainer:19, Joint3DDataset:138, main:409): train the
per-token binary classifier (`SpanPredictor`, a trainable RoBERTa and its
projector) with BCE against ground-truth span maps built from the target
name's character span; `--store` writes `{dataset}_pred_spans.json`, which
the grounding dataset reads (`data/joint_dataset.py`).

Text only: the batches are tokenized at a fixed length on the host, one
training step is a forward in train mode, the loss, the backward and the
optimizer's update, all on the trainer's device. The parameters are saved
with `torch.save` of the state dict (the JAX package writes flax msgpack,
which needs flax; `convert.span_state_dict_from_jax` carries JAX weights
across).
"""

import csv
import json
import os
import os.path as osp
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from butd_detr_tpu_torch.data.positive_map import (
    normalize_caption,
    token_positive_map,
)
from butd_detr_tpu_torch.init import init_weights_
from butd_detr_tpu_torch.lang.roberta import (
    RobertaConfig,
    roberta_base_config,
)
from butd_detr_tpu_torch.lang.span_predictor import (
    SpanPredictor,
    scores_to_pred_spans,
    span_bce_loss,
)
from butd_detr_tpu_torch.lang.tokenizer import get_tokenizer

BATCH_KEYS = ("text_ids", "text_mask", "positive_map")


class SpanTextDataset:
    """Text-only annotations and per-utterance ground-truth span maps
    (text_cls.py:138-352) for sr3d / sr3d+, nr3d and scanrefer. `store`
    keeps every utterance of the train and test scans, in file order (the
    rows of the stored JSON), with a first-word target where the target
    name is absent."""

    def __init__(self, dataset: str = "sr3d", split: str = "train",
                 data_path: str = "./", store: bool = False,
                 tokenizer=None, max_len: int = 128):
        self.dataset = dataset
        self.split = split
        self.data_path = data_path
        self.store = store
        self.max_len = max_len
        self.tokenizer = tokenizer or get_tokenizer(max_len=max_len)
        self.annos = self.load_annos(dataset)

    # -- annotations ------------------------------------------------------

    def _scan_ids(self, name: str) -> set:
        ids = set()
        meta = osp.join(self.data_path, "meta_data")
        split = "test" if self.split == "val" else self.split
        files = (
            [f"{name}_train_scans.txt", f"{name}_test_scans.txt"]
            if self.store
            else [f"{name}_{split}_scans.txt"]
        )
        for fn in files:
            with open(osp.join(meta, fn)) as f:
                ids |= set(eval(f.read()))
        return ids

    def _read_csv(self, path):
        with open(path) as f:
            reader = csv.reader(f)
            headers = {h: i for i, h in enumerate(next(reader))}
            for line in reader:
                yield headers, line

    def load_annos(self, dset: str) -> List[Dict]:
        if dset in ("sr3d", "sr3d+"):
            return self._load_referit(dset, "sr3d")
        if dset == "nr3d":
            return self._load_referit("nr3d", "nr3d")
        if dset == "scanrefer":
            return self._load_scanrefer()
        raise ValueError(dset)

    def _load_referit(self, dset, scans_name):
        scan_ids = self._scan_ids(scans_name)
        annos = []
        for h, line in self._read_csv(
            osp.join(self.data_path, "refer_it_3d", f"{dset}.csv")
        ):
            if line[h["scan_id"]] not in scan_ids:
                continue
            if (
                not self.store
                and str(line[h["mentions_target_class"]]).lower() != "true"
            ):
                continue
            annos.append({
                "utterance": line[h["utterance"]],
                "target": line[h["instance_type"]],
            })
        return self._fix_targets(annos)

    def _load_scanrefer(self):
        base = osp.join(self.data_path, "scanrefer", "ScanRefer_filtered")
        split = "val" if self.split in ("val", "test") else self.split
        with open(f"{base}_{split}.txt") as f:
            scan_ids = {line.strip() for line in f if line.strip()}
        with open(f"{base}_{split}.json") as f:
            reader = json.load(f)
        annos = [
            {
                "utterance": " ".join(a["token"]),
                "target": " ".join(str(a["object_name"]).split("_")),
            }
            for a in reader
            if a["scene_id"] in scan_ids
        ]
        for a in annos:  # text_cls.py:277-281
            if a["target"] not in a["utterance"]:
                last = a["target"].split()[-1]
                if last in a["utterance"]:
                    a["target"] = last
        return self._fix_targets(annos)

    def _fix_targets(self, annos):
        """Training keeps the utterances that contain their target;
        storing gives the others their first word as the target
        (text_cls.py:243-252)."""
        if not self.store:
            return [a for a in annos if a["target"] in a["utterance"]]
        for a in annos:
            if a["target"] not in a["utterance"]:
                a["target"] = a["utterance"].split()[0].strip(",")
        return annos

    # -- samples ----------------------------------------------------------

    def __len__(self):
        return len(self.annos)

    def __getitem__(self, index: int) -> Dict:
        anno = self.annos[index]
        _, pmap = token_positive_map(
            self.tokenizer, anno["utterance"], [anno["target"]],
            max_num_obj=1, max_len=self.max_len,
        )
        utterance = normalize_caption(anno["utterance"]) + " . not mentioned"
        tok = self.tokenizer([utterance], max_len=self.max_len)
        return {
            "text_ids": tok.ids[0],
            "text_mask": tok.attention_mask[0],
            "positive_map": pmap[0],  # (256,)
            "orig_utterance": anno["utterance"],
        }


def batch_iter(dataset: SpanTextDataset, batch_size: int, shuffle: bool,
               seed: int = 0, drop_last: bool = False):
    """numpy batches of `BATCH_KEYS`, in order or shuffled by
    `RandomState(seed)`."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    nb = (
        len(order) // batch_size
        if drop_last
        else (len(order) + batch_size - 1) // batch_size
    )
    for b in range(nb):
        idx = order[b * batch_size:(b + 1) * batch_size]
        samples = [dataset[int(i)] for i in idx]
        yield {k: np.stack([s[k] for s in samples]) for k in BATCH_KEYS}


class SpanTrainer:
    """Trains, evaluates and stores (text_cls.py Trainer:19-135) on
    `device`. Adam with betas (0, 0.9) (text_cls.py:27-29, the JAX
    package's `optax.adam(lr, b1=0.0, b2=0.9)`), no weight decay. Weights
    are random from `seed`; each step's dropout seed is drawn from a
    generator of `seed`. `precise` selects the attention kernels' f32 mode
    (default: bf16 operands, as the TPU kernel's default)."""

    def __init__(self, config: RobertaConfig, max_len: int = 128,
                 lr: float = 1e-4, seed: int = 0, device="cuda",
                 precise: bool = False):
        self.device = torch.device(device)
        self.max_len = max_len
        self.model = init_weights_(SpanPredictor(config, precise=precise),
                                   seed).to(self.device)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr,
                                          betas=(0.0, 0.9), eps=1e-8)
        self.generator = torch.Generator().manual_seed(seed)
        self.step = 0

    def tensors(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {
            "text_ids": torch.as_tensor(batch["text_ids"]).long()
            .to(self.device, non_blocking=True),
            "text_mask": torch.as_tensor(batch["text_mask"])
            .to(self.device, non_blocking=True),
            "positive_map": torch.as_tensor(batch["positive_map"])
            .to(self.device, non_blocking=True),
        }

    def loss(self, t: Dict[str, torch.Tensor], train: bool) -> torch.Tensor:
        logits = self.model(t["text_ids"], t["text_mask"], train=train)
        return span_bce_loss(logits, t["positive_map"][:, :logits.shape[1]])

    def train_step(self, batch: Dict) -> torch.Tensor:
        """One optimizer step; returns the loss (a 0-d tensor on the
        device: no synchronisation)."""
        self.model.train()
        self.model.rng.seed(int(torch.randint(0, 2 ** 62, (1,),
                                              generator=self.generator)))
        loss = self.loss(self.tensors(batch), train=True)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return loss.detach()

    @torch.no_grad()
    def score_step(self, batch: Dict) -> torch.Tensor:
        """Eval-mode span logits (B, L) on the device."""
        self.model.eval()
        t = self.tensors(batch)
        return self.model(t["text_ids"], t["text_mask"], train=False)

    def train_epoch(self, batches: Iterable[Dict]) -> float:
        losses = [self.train_step(b) for b in batches]
        return float(torch.stack(losses).mean()) if losses else 0.0

    def eval_accuracy(self, batches: Iterable[Dict]) -> float:
        """The share of utterances whose every token is classified right
        (text_cls.py:105-111)."""
        correct = total = 0
        for batch in batches:
            scores = self.score_step(batch).float().cpu().numpy()
            pred = (scores > 0).astype(np.float32)
            want = np.asarray(batch["positive_map"])[:, : scores.shape[1]]
            correct += ((pred == (want > 0)).all(axis=1)).sum()
            total += len(scores)
        return correct / max(total, 1)

    def store_spans(self, batches: Iterable[Dict], utterances: List[str],
                    path: str) -> List[Dict]:
        """`--store`: write the predicted spans' JSON (text_cls.py:111-135),
        one {"utterance", "span"} row per utterance."""
        spans = [scores_to_pred_spans(
            self.score_step(b).float().cpu().numpy()) for b in batches]
        spans = np.concatenate(spans) if spans else np.zeros((0, 256))
        payload = [
            {"utterance": u, "span": s.tolist()}
            for u, s in zip(utterances, spans)
        ]
        with open(path, "w") as f:
            json.dump(payload, f)
        return payload

    def save(self, path: str) -> None:
        torch.save(self.model.state_dict(), path)

    def load(self, path: str) -> None:
        self.model.load_state_dict(
            torch.load(path, map_location=self.device, weights_only=True))


def run_span_training(args, config: Optional[RobertaConfig] = None,
                      tokenizer=None) -> SpanTrainer:
    """What the command line runs (text_cls.py main:409-451): train with a
    validation accuracy an epoch, keeping the best parameters in
    `checkpoint_path/checkpoint`; `--eval` and `--store` load them."""
    tokenizer = tokenizer or get_tokenizer(max_len=args.max_len)
    datasets = {
        split: SpanTextDataset(
            args.dataset, split, args.data_root, args.store,
            tokenizer=tokenizer, max_len=args.max_len,
        )
        for split in ("train", "val")
    }
    print(len(datasets["train"]), len(datasets["val"]))
    trainer = SpanTrainer(config or roberta_base_config(),
                          max_len=args.max_len, lr=args.lr,
                          device=args.device)
    ckpt = osp.join(args.checkpoint_path, args.checkpoint)
    os.makedirs(args.checkpoint_path, exist_ok=True)
    if args.eval or args.store:
        if not osp.exists(ckpt):
            raise FileNotFoundError(
                f"no span predictor parameters at {ckpt}: train first")
        trainer.load(ckpt)
    best = -1.0
    if not args.eval and not args.store:
        for epoch in range(args.epochs):
            loss = trainer.train_epoch(batch_iter(
                datasets["train"], args.batch_size, True, seed=epoch,
                drop_last=True,
            ))
            acc = trainer.eval_accuracy(
                batch_iter(datasets["val"], args.batch_size, False)
            )
            print(f"epoch {epoch + 1}/{args.epochs} loss {loss:.4f} "
                  f"val_acc {acc:.4f}")
            if acc >= best:
                best = acc
                trainer.save(ckpt)
    if args.store:
        ds = datasets["train"]
        trainer.store_spans(
            batch_iter(ds, args.batch_size, False),
            [a["utterance"] for a in ds.annos],
            f"{args.dataset}_pred_spans.json",
        )
    elif args.eval:
        acc = trainer.eval_accuracy(
            batch_iter(datasets["val"], args.batch_size, False)
        )
        print(f"val_acc {acc:.4f}")
    return trainer
