"""RoBERTa encoder with Hugging Face parameter names, frozen in the model.

Counterpart of `butd_detr_tpu/lang/roberta.py`: post-LN transformer
encoder, exact-erf GELU FFN, learned positions with RoBERTa's pad-offset
position ids (cumsum(mask) * mask + pad_id). The attention core is
`ops.attention` (the CUDA kernel for CUDA tensors). Keys follow HF's
`RobertaModel` (`embeddings.*`, `encoder.layer.{i}.*`); the pooler is not
part of the grounding model's forward and is left out.
"""

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from butd_detr_tpu_torch.nn.attention import multi_head


@dataclasses.dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5


def roberta_base_config() -> RobertaConfig:
    return RobertaConfig()


def tiny_roberta_config(**kw) -> RobertaConfig:
    """A small config for tests: the JAX package's tiny trunk."""
    defaults = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128,
                    max_position_embeddings=130)
    defaults.update(kw)
    return RobertaConfig(**defaults)


def small_text_roberta_config() -> RobertaConfig:
    """The accuracy study's `--small_text` trunk: 4 layers x 128-d x 4
    heads over SimpleTokenizer's hashed 1024 vocabulary, small enough to
    train from scratch within a study of a few thousand steps (the JAX
    package's `small_text_roberta_config`)."""
    return tiny_roberta_config(hidden_size=128, num_hidden_layers=4,
                               num_attention_heads=4, intermediate_size=256)


def create_position_ids(input_ids: torch.Tensor, pad_token_id: int):
    mask = (input_ids != pad_token_id).long()
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


class _Dense(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.dense = nn.Linear(cin, cout)

    def forward(self, x):
        return self.dense(x)


class _DenseLN(nn.Module):
    def __init__(self, cin, cout, eps):
        super().__init__()
        self.dense = nn.Linear(cin, cout)
        self.LayerNorm = nn.LayerNorm(cout, eps=eps)


class RobertaEmbeddings(nn.Module):
    def __init__(self, c: RobertaConfig):
        super().__init__()
        self.pad_token_id = c.pad_token_id
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings,
                                                c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size,
                                                  c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, input_ids):
        pos = create_position_ids(input_ids, self.pad_token_id)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        return self.LayerNorm(x)


class _SelfAttention(nn.Module):
    def __init__(self, c: RobertaConfig):
        super().__init__()
        self.query = nn.Linear(c.hidden_size, c.hidden_size)
        self.key = nn.Linear(c.hidden_size, c.hidden_size)
        self.value = nn.Linear(c.hidden_size, c.hidden_size)


class _Attention(nn.Module):
    def __init__(self, c: RobertaConfig):
        super().__init__()
        self.self = _SelfAttention(c)
        self.output = _DenseLN(c.hidden_size, c.hidden_size,
                               c.layer_norm_eps)


class RobertaLayer(nn.Module):
    def __init__(self, c: RobertaConfig, precise: bool = False):
        super().__init__()
        self.num_heads = c.num_attention_heads
        self.precise = precise
        self.attention = _Attention(c)
        self.intermediate = _Dense(c.hidden_size, c.intermediate_size)
        self.output = _DenseLN(c.intermediate_size, c.hidden_size,
                               c.layer_norm_eps)

    def forward(self, x, pad_mask):
        sa = self.attention.self
        a = multi_head(sa.query(x), sa.key(x), sa.value(x), self.num_heads,
                       pad_mask, dropout_p=0.0, precise=self.precise)
        ao = self.attention.output
        x = ao.LayerNorm(x + ao.dense(a))
        h = F.gelu(self.intermediate(x))
        return self.output.LayerNorm(x + self.output.dense(h))


class _Encoder(nn.Module):
    def __init__(self, c: RobertaConfig, precise: bool):
        super().__init__()
        self.layer = nn.ModuleList(
            RobertaLayer(c, precise) for _ in range(c.num_hidden_layers))


class RobertaModel(nn.Module):
    """input_ids (B, L), attention_mask (B, L) 1 == real -> last hidden
    state (B, L, hidden)."""

    def __init__(self, config: RobertaConfig, precise: bool = False):
        super().__init__()
        self.config = config
        self.embeddings = RobertaEmbeddings(config)
        self.encoder = _Encoder(config, precise)

    def forward(self, input_ids, attention_mask):
        pad_mask = attention_mask == 0  # True == PAD
        x = self.embeddings(input_ids.long())
        for layer in self.encoder.layer:
            x = layer(x, pad_mask)
        return x
