"""Host-side tokenization into fixed-shape id/mask arrays.

The port's copy of `butd_detr_tpu/lang/tokenizer.py`:
  * `SimpleTokenizer`: a deterministic, dependency-free word-level
    tokenizer with RoBERTa's special token layout (bos=0, pad=1, eos=2)
    and a `char_to_token` map, so the positive-map code works unchanged.
    Ids are hashed into `vocab_size`;
  * `HFTokenizer`: `transformers`' RoBERTa tokenizer read from the local
    cache only (the repository carries no vocabulary files);
  * `get_tokenizer`: the first when the second does not load, the rule of
    the JAX package, so both pick the same tokenizer on one machine.
"""

import hashlib
import os
import re
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

BOS_ID, PAD_ID, EOS_ID, UNK_ID = 0, 1, 2, 3


@dataclass
class Tokenized:
    """A fixed-shape tokenized batch."""

    ids: np.ndarray  # (B, L) int32
    attention_mask: np.ndarray  # (B, L) int32, 1 = real token
    _char_to_token: list  # per-sample char -> token callables

    def char_to_token(self, batch_idx: int, char_idx: int) -> Optional[int]:
        return self._char_to_token[batch_idx](char_idx)


_WORD_RE = re.compile(r"\w+|[^\w\s]")


def _stable_id(token: str, vocab_size: int) -> int:
    h = int.from_bytes(hashlib.md5(token.encode()).digest()[:4], "little")
    return 4 + (h % (vocab_size - 4))


class SimpleTokenizer:
    """Deterministic word-level tokenizer over a hashed vocabulary."""

    def __init__(self, vocab_size: int = 1024, max_len: int = 64):
        self.vocab_size = vocab_size
        self.max_len = max_len

    def __call__(self, texts: List[str], max_len: Optional[int] = None):
        L = max_len or self.max_len
        B = len(texts)
        ids = np.full((B, L), PAD_ID, np.int32)
        mask = np.zeros((B, L), np.int32)
        char_fns = []
        for b, text in enumerate(texts):
            spans = [(m.start(), m.end(), m.group()) for m in
                     _WORD_RE.finditer(text.lower())][: L - 2]
            ids[b, 0] = BOS_ID
            for t, (_, _, tok) in enumerate(spans):
                ids[b, t + 1] = _stable_id(tok, self.vocab_size)
            ids[b, len(spans) + 1] = EOS_ID
            mask[b, : len(spans) + 2] = 1

            def c2t(char_idx, spans=spans):
                for t, (s, e, _) in enumerate(spans):
                    if s <= char_idx < e:
                        return t + 1  # +1 for bos
                return None

            char_fns.append(c2t)
        return Tokenized(ids=ids, attention_mask=mask,
                         _char_to_token=char_fns)


class HFTokenizer:
    """`RobertaTokenizerFast` from the local cache, emitting fixed-shape
    arrays; never reaches the network."""

    def __init__(self, name: str = "roberta-base", max_len: int = 64):
        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        from transformers import RobertaTokenizerFast

        self.tok = RobertaTokenizerFast.from_pretrained(
            name, local_files_only=True)
        self.max_len = max_len
        self.vocab_size = self.tok.vocab_size

    def __call__(self, texts: List[str], max_len: Optional[int] = None):
        L = max_len or self.max_len
        enc = self.tok(texts, padding="max_length", truncation=True,
                       max_length=L, return_tensors="np")
        # one more encoding a text for char_to_token (host side, cold path)
        encs = [self.tok(t, truncation=True, max_length=L) for t in texts]
        return Tokenized(
            ids=enc["input_ids"].astype(np.int32),
            attention_mask=enc["attention_mask"].astype(np.int32),
            _char_to_token=[(lambda ci, e=e: e.char_to_token(ci))
                            for e in encs])


def get_tokenizer(name: str = "roberta-base", max_len: int = 64,
                  vocab_size: int = 1024):
    """HF fast tokenizer when it loads, else the deterministic fallback."""
    try:
        return HFTokenizer(name, max_len=max_len)
    except Exception:  # no transformers, or no cached vocabulary
        return SimpleTokenizer(vocab_size=vocab_size, max_len=max_len)
