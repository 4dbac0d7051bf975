#!/usr/bin/env python3
"""Does the JAX package's jitted-vs-eager gradient gap grow along a training
trajectory? Three trajectories of the same tiny model from the same
weights, on the CPU:

    python3 scripts/probe_torch_gradient_gap.py [--steps 30] [--lr 1e-5]
                                                [--report PATH]

the JAX train step (`train/step.py:make_train_step`) under `jax.jit`, the
same step run eagerly (`jax.disable_jit`), and the port's
`Trainer.train_step`. The model and batch are those of
tests/test_torch_study.py (e): the tiny text tower, trainable; 1 encoder
and 1 decoder layer; strict f32; 4 unaugmented samples of a small
`make_rich_scannet` root; dropout 0 everywhere (flax's `Dropout` patched
to the identity, the port's rates set to 0), BatchNorm in train mode.
Each step prints the three losses and gradient global norms and the
relative gaps |jit - eager| / eager and |port - eager| / eager; the last
line is one JSON object (also written to `--report PATH`). Needs JAX and
the JAX package, which the port never imports.
"""

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NPOINTS = (256, 128, 64, 32)


def probe_config(lr):
    """tests/test_torch_study.py's PROBE_CFG at learning rate `lr`."""
    return dict(
        dataset=["sr3d"], test_dataset="sr3d", use_color=True, butd=False,
        butd_cls=True, self_attend=True, use_soft_token_loss=True,
        use_contrastive_align=True, batch_size=4, num_points=1024,
        max_num_obj=16, max_det_boxes=16, max_text_len=32, lr=lr,
        lr_backbone=lr, weight_decay=5e-4, freeze_text_encoder=False,
        text_encoder_lr=lr, lr_decay_epochs=[10 ** 6], num_target=16,
        eos_coef=0.02, num_encoder_layers=1, num_decoder_layers=1,
        backbone_bf16=False, attn_precise=True)


def probe_batch(root):
    from butd_detr_tpu_torch.data import collate, make_rich_scannet
    from butd_detr_tpu_torch.lang import SimpleTokenizer
    from butd_detr_tpu_torch.train.study import build_dataset

    make_rich_scannet(root, n_train=2, n_val=1, points_per_scan=1500)
    ds = build_dataset(root, SimpleTokenizer(max_len=32), "val",
                       joint_det=False, num_points=1024, eval_train=True)
    return collate([ds[i] for i in range(4)])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--report", default=None)
    args = ap.parse_args(argv)

    import flax.linen
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from butd_detr_tpu.lang import roberta as j_roberta
    from butd_detr_tpu.train.config import Config as JConfig
    from butd_detr_tpu.train.optimizer import make_optimizer as j_optimizer
    from butd_detr_tpu.train.step import build_model as j_build_model
    from butd_detr_tpu.train.step import init_state, make_train_step
    from butd_detr_tpu_torch.config import Config
    from butd_detr_tpu_torch.convert import state_dict_from_jax
    from butd_detr_tpu_torch.lang import tiny_roberta_config
    from butd_detr_tpu_torch.nn.attention import MultiheadAttention
    from butd_detr_tpu_torch.nn.dropout import Dropout
    from butd_detr_tpu_torch.train import INPUT_KEYS, TARGET_KEYS, Trainer

    flax.linen.Dropout.__call__ = lambda self, inputs, *a, **k: inputs
    cfg = probe_config(args.lr)
    with tempfile.TemporaryDirectory() as tmp:
        full = probe_batch(os.path.join(tmp, "data"))
    batch = {k: full[k] for k in (*INPUT_KEYS, *TARGET_KEYS) if k in full}
    jcfg = JConfig(**cfg)
    jm = j_build_model(jcfg, roberta_config=j_roberta.tiny_roberta_config(),
                       backbone_npoints=NPOINTS)
    optimizer = j_optimizer(jcfg, steps_per_epoch=10 ** 6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(0)
    start = init_state(jm, optimizer, jbatch, rng)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    trainer = Trainer(Config(**cfg), steps_per_epoch=10 ** 6,
                      roberta_config=tiny_roberta_config(),
                      backbone_npoints=NPOINTS, device="cpu",
                      state_dict=state_dict_from_jax(
                          to_np(start.params), to_np(start.batch_stats)))
    for m in trainer.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
        elif isinstance(m, MultiheadAttention):
            m.dropout = 0.0

    step = make_train_step(jm, jcfg, optimizer)
    jitted = jax.jit(step)
    s_jit = s_eager = start
    rows = []
    for i in range(args.steps):
        s_jit, m_jit = jitted(s_jit, jbatch, rng)
        with jax.disable_jit():
            s_eager, m_eager = step(s_eager, jbatch, rng)
        m_port = trainer.train_step(batch)
        row = dict(step=i + 1)
        for name, m in (("jit", m_jit), ("eager", m_eager),
                        ("port", m_port)):
            row[f"loss_{name}"] = float(m["loss"])
            row[f"grad_norm_{name}"] = float(m["grad_norm"])
        ge = row["grad_norm_eager"]
        row["gap_jit_eager"] = abs(row["grad_norm_jit"] - ge) / ge
        row["gap_port_eager"] = abs(row["grad_norm_port"] - ge) / ge
        row["gap_port_jit"] = abs(row["grad_norm_port"]
                                  - row["grad_norm_jit"]) / row[
                                      "grad_norm_jit"]
        rows.append(row)
        print(f"step {i + 1:3d}: grad norm jit {row['grad_norm_jit']:.5f} "
              f"eager {ge:.5f} port {row['grad_norm_port']:.5f}; gap "
              f"jit-eager {row['gap_jit_eager']:.2e} port-eager "
              f"{row['gap_port_eager']:.2e} port-jit "
              f"{row['gap_port_jit']:.2e}; loss jit {row['loss_jit']:.5f} "
              f"eager {row['loss_eager']:.5f} port {row['loss_port']:.5f}",
              flush=True)
    result = dict(steps=args.steps, lr=args.lr, rows=rows)
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
