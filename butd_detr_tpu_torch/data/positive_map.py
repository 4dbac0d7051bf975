"""Box->token positive maps for soft-token prediction.

The port's copy of `butd_detr_tpu/data/positive_map.py` (reference
`joint_det_dataset.py:853-927`, `_get_token_positive_map` and
`get_positive_map`): find each target category-name's character span
inside the utterance, convert char spans to token spans with the
tokenizer's `char_to_token`, and emit a row-normalized (num_objects, 256)
map. The dataset and the predictor share it.
"""

from typing import Sequence, Tuple

import numpy as np

NUM_BINS = 256


def normalize_caption(utterance: str) -> str:
    """Whitespace-normalize + separate commas, as the reference does
    everywhere before tokenizing (joint_det_dataset.py:856,744)."""
    return " ".join(utterance.replace(",", " ,").split())


def find_char_spans(utterance: str, cat_names: Sequence[str],
                    max_num_obj: int = 132) -> np.ndarray:
    """Character [start, end) spans of each name in the padded caption:
    exact ' name ' match, then prefix match, then a substring extended to
    word boundaries (reference joint_det_dataset.py:856-884)."""
    caption = " " + normalize_caption(utterance) + " "
    spans = np.zeros((max_num_obj, 2))
    for c, cat_name in enumerate(cat_names):
        start = caption.find(f" {cat_name} ")
        if start >= 0:
            length = len(cat_name)
        else:
            start = caption.find(" " + cat_name)
            if start >= 0:
                length = len(caption[start + 1:].split()[0])
            else:
                start = caption.find(cat_name)
                if start < 0:
                    raise ValueError(f"{cat_name!r} not in {caption!r}")
                orig = start
                while caption[start - 1] != " ":
                    start -= 1
                length = len(cat_name) + orig - start
                while caption[length + start] != " ":
                    length += 1
        spans[c] = start, start + length
    return spans


def get_positive_map(tokenized, char_spans: np.ndarray,
                     batch_idx: int = 0) -> np.ndarray:
    """(n, 2) char spans -> (n, 256) row-normalized token map, with the
    reference's +-1/2/3 char_to_token probing (joint_det_dataset.py:
    899-927). `tokenized` is a lang.tokenizer `Tokenized` batch."""
    positive_map = np.zeros((len(char_spans), NUM_BINS), np.float32)
    c2t = lambda ci: tokenized.char_to_token(batch_idx, ci)  # noqa: E731
    for j, (beg, end) in enumerate(char_spans):
        beg, end = int(beg), int(end)
        beg_pos = c2t(beg)
        if beg_pos is None:
            beg_pos = c2t(beg + 1)
            if beg_pos is None:
                beg_pos = c2t(beg + 2)
        end_pos = c2t(end - 1)
        if end_pos is None:
            end_pos = c2t(end - 2)
            if end_pos is None:
                end_pos = c2t(end - 3)
        if beg_pos is None or end_pos is None:
            continue
        positive_map[j, beg_pos:min(end_pos + 1, NUM_BINS)] = 1.0
    return positive_map / (positive_map.sum(-1, keepdims=True) + 1e-12)


def token_positive_map(tokenizer, utterance: str, cat_names: Sequence[str],
                       max_num_obj: int = 132, max_len: int = 256
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(max_num_obj, 2) char spans and (max_num_obj, 256) token map. The
    spans are found in the caption padded with one leading space and
    handed to `char_to_token` of the unpadded caption unchanged, as the
    reference does (its None-fallback then probes beg + 1)."""
    caption = normalize_caption(utterance)
    spans = find_char_spans(utterance, cat_names, max_num_obj)
    tokenized = tokenizer([caption], max_len=max_len)
    pmap = np.zeros((max_num_obj, NUM_BINS), np.float32)
    pmap[:len(cat_names)] = get_positive_map(tokenized,
                                             spans[:len(cat_names)])
    return spans, pmap
