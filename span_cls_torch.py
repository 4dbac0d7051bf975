#!/usr/bin/env python
"""Train, evaluate or store the span predictor with the PyTorch + CUDA
port.

The port's counterpart of `span_cls.py` (reference `src/text_cls.py`),
with its flags and `--device`:

    python span_cls_torch.py --data_root ./data --dataset sr3d
    python span_cls_torch.py --data_root ./data --dataset sr3d --eval
    python span_cls_torch.py --data_root ./data --dataset sr3d --store

trains RoBERTa-base and the span head with BCE against the target names'
spans, keeping the best validation accuracy's parameters in
`--checkpoint_path/--checkpoint` (a `torch.save` state dict); `--eval`
prints the validation accuracy of those parameters and `--store` writes
`{dataset}_pred_spans.json` into the working directory, the file the
grounding dataset reads from its data root. Runs on `cuda` unless
`--device cpu`. Imports only the port.
"""

import argparse
import os
import sys


def main(argv=None):
    os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_path", default="checkpoints/")
    parser.add_argument("--checkpoint", default="sr3d.pth")
    parser.add_argument("--dataset", default="sr3d")
    parser.add_argument("--data_root", default="./")
    parser.add_argument("--epochs", default=20, type=int)
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--lr", default=1e-4, type=float)
    parser.add_argument("--max_len", default=128, type=int)
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--store", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="the torch device to run on (cuda or cpu)")
    parser.add_argument("--tiny_roberta", action="store_true",
                        help="tiny random-vocab text trunk (tests)")
    args = parser.parse_args(argv)

    from butd_detr_tpu_torch.lang import (
        SimpleTokenizer,
        roberta_base_config,
        tiny_roberta_config,
    )
    from butd_detr_tpu_torch.lang.span_trainer import run_span_training
    from butd_detr_tpu_torch.predict import resolve_device

    args.device = resolve_device(args.device)
    if args.tiny_roberta:
        config = tiny_roberta_config()
        tokenizer = SimpleTokenizer(vocab_size=config.vocab_size,
                                    max_len=args.max_len)
    else:
        config, tokenizer = roberta_base_config(), None
    run_span_training(args, config, tokenizer)


if __name__ == "__main__":
    sys.exit(main())
