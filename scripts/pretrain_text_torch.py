"""Class-discrimination pretraining of the small text trunk, with the
PyTorch + CUDA port.

The port's counterpart of `scripts/pretrain_text.py`, with its flags and
`--device`: the accuracy study's `--small_text` trunk
(`small_text_roberta_config`: 4 layers x 128-d x 4 heads over
`SimpleTokenizer`'s hashed 1024-word vocabulary) learns to tell the 485
ScanNet class names apart, alone or inside the sr3d template "the <cls>
<rel> the <anchor>" (the target class is the label): the mean-pooled
trunk output goes through Dense(485) and cross-entropy, AdamW (lr 1e-3,
weight decay 1e-4, as optax's `adamw`). The batches come from
`RandomState(--seed)` in the JAX script's order, so both draw the same
texts. After the steps every class name is classified once (the final
sweep), and the trunk is saved under the JAX tower's flax paths
(`layer_0/attention/q_proj/kernel`, ...), which `convert.load_text_init`
and the JAX study's `--text_init` both read:

    python scripts/pretrain_text_torch.py --out text_init.npz
"""

import argparse
import os
import os.path as osp
import sys
import time

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))


def make_batch(rng, tok, classes, relations, bs):
    """(ids, mask, labels) numpy arrays of `bs` texts drawn from `rng` as
    the JAX script draws them."""
    n_cls = len(classes)
    labels = rng.randint(0, n_cls, bs)
    texts = []
    for c in labels:
        if rng.rand() < 0.5:
            texts.append(classes[c])
        else:
            rel = relations[rng.randint(len(relations))]
            anchor = classes[rng.randint(n_cls)]
            texts.append(f"the {classes[c]} {rel} the {anchor}")
    enc = tok(texts)
    return enc.ids, enc.attention_mask, labels


def classifier(config, n_cls, precise=True):
    """The trunk (`trunk`, a RobertaModel) and the class head (`cls`)."""
    from torch import nn

    from butd_detr_tpu_torch.lang.roberta import RobertaModel
    from butd_detr_tpu_torch.nn.mlp import Dense

    class Classifier(nn.Module):
        def __init__(self):
            super().__init__()
            self.trunk = RobertaModel(config, precise=precise)
            self.cls = Dense(config.hidden_size, n_cls)

        def forward(self, ids, mask):
            h = self.trunk(ids, mask)
            m = mask[..., None].to(h.dtype)
            pooled = (h * m).sum(1) / m.sum(1).clamp(min=1.0)
            return self.cls(pooled)

    return Classifier()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="studies/attrib_r5/text_init_torch.npz")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--max_len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the torch device to run on (cuda or cpu)")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from butd_detr_tpu_torch.convert import text_encoder_to_jax
    from butd_detr_tpu_torch.data.scannet_config import (
        relations as scannet_relations,
        scannet_classes,
    )
    from butd_detr_tpu_torch.init import init_weights_
    from butd_detr_tpu_torch.lang import (
        SimpleTokenizer,
        small_text_roberta_config,
    )
    from butd_detr_tpu_torch.predict import resolve_device

    device = resolve_device(args.device)
    classes = scannet_classes(485)
    relations = scannet_relations()
    n_cls = len(classes)
    print(f"{n_cls} classes, {len(relations)} relations")

    tok = SimpleTokenizer(max_len=args.max_len)
    rng_np = np.random.RandomState(args.seed)
    model = init_weights_(classifier(small_text_roberta_config(), n_cls),
                          args.seed).to(device)
    opt = torch.optim.AdamW(model.parameters(), args.lr, weight_decay=1e-4)

    def tensors(ids, mask, labels):
        return (torch.from_numpy(ids).long().to(device),
                torch.from_numpy(mask).to(device),
                torch.from_numpy(labels).long().to(device))

    make_batch(rng_np, tok, classes, relations, args.batch)  # init's batch
    t0 = time.time()
    for it in range(args.steps):
        ids, mask, labels = tensors(*make_batch(rng_np, tok, classes,
                                                relations, args.batch))
        logits = model(ids, mask)
        ce = F.cross_entropy(logits, labels)
        opt.zero_grad(set_to_none=True)
        ce.backward()
        opt.step()
        if it % 200 == 0 or it == args.steps - 1:
            acc = (logits.argmax(-1) == labels).float().mean()
            print(f"step {it} ce {float(ce.detach()):.3f} "
                  f"acc {float(acc):.3f} ({time.time()-t0:.0f}s)",
                  flush=True)

    # held-out-template check: pure class names, full sweep
    enc = tok(classes)
    with torch.no_grad():
        logits = model(torch.from_numpy(enc.ids).long().to(device),
                       torch.from_numpy(enc.attention_mask).to(device))
    final_acc = float((logits.argmax(-1).cpu()
                       == torch.arange(n_cls)).float().mean())
    print(f"final class-name sweep acc {final_acc:.3f}")

    flat = text_encoder_to_jax(model.trunk)
    os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **flat)
    print(f"saved {len(flat)} trunk arrays -> {args.out}")


if __name__ == "__main__":
    main()
