#!/usr/bin/env python
"""Generate the 485-class RoBERTa embedding table with the PyTorch + CUDA
port.

The port's counterpart of `gen_class_embeddings.py` (reference
`data/gen_class_embeddings.py`): writes `class_embeddings3d.npy`
(num_classes, 768), which initializes the detected-box class stream
(`train/pretrained.py:init_class_embeddings`):

    python gen_class_embeddings_torch.py --output data/class_embeddings3d.npy
    python gen_class_embeddings_torch.py --params roberta-base.pth

RoBERTa-base's weights come from `--params` (a torch state dict with HF
names, a snapshot directory or an `.npz`) or, without it, from the local
Hugging Face cache, offline. Runs on `cuda` unless `--device cpu`.
Imports only the port.
"""

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output", default="data/class_embeddings3d.npy")
    parser.add_argument("--params", default=None,
                        help="RoBERTa-base weights, HF names (optional)")
    parser.add_argument("--num_classes", type=int, default=485)
    parser.add_argument("--device", default="cuda",
                        help="the torch device to run on (cuda or cpu)")
    parser.add_argument("--tiny_roberta", action="store_true",
                        help="tiny random-vocab text trunk (tests)")
    args = parser.parse_args(argv)

    import numpy as np

    from butd_detr_tpu_torch.data.scannet_config import scannet_classes
    from butd_detr_tpu_torch.lang import (
        RobertaModel,
        SimpleTokenizer,
        get_tokenizer,
        roberta_base_config,
        tiny_roberta_config,
    )
    from butd_detr_tpu_torch.lang.class_embeddings import (
        generate_class_embeddings,
        load_roberta_weights,
    )
    from butd_detr_tpu_torch.predict import resolve_device

    device = resolve_device(args.device)
    config = tiny_roberta_config() if args.tiny_roberta \
        else roberta_base_config()
    model = RobertaModel(config)
    try:
        load_roberta_weights(model, args.params)
    except (ImportError, OSError, KeyError, ValueError) as e:
        raise SystemExit(
            f"no RoBERTa weights available ({e}); pass --params")
    model = model.to(device).eval()
    tokenizer = SimpleTokenizer(vocab_size=config.vocab_size, max_len=16) \
        if args.tiny_roberta else get_tokenizer(max_len=16)
    names = scannet_classes(args.num_classes)
    table = generate_class_embeddings(model, tokenizer, names)
    np.save(args.output, table)
    print(f"wrote {args.output} {table.shape}")


if __name__ == "__main__":
    sys.exit(main())
