"""RoBERTa encoder with Hugging Face parameter names, frozen in the model.

Counterpart of `butd_detr_tpu/lang/roberta.py`: post-LN transformer
encoder, exact-erf GELU FFN, learned positions with RoBERTa's pad-offset
position ids (cumsum(mask) * mask + pad_id). The attention core is
`ops.attention` (the CUDA kernel for CUDA tensors). Keys follow HF's
`RobertaModel` (`embeddings.*`, `encoder.layer.{i}.*`); the pooler is not
part of the grounding model's forward and is left out.

`dtype` is the compute dtype of the embeddings and the dense layers, as
the JAX tower's `dtype`: the looked-up embedding rows are cast to it (the
rows of the table cast to it, as flax's `nn.Embed(dtype=...)` gives
them), the LayerNorms normalize in f32.
"""

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from butd_detr_tpu_torch.nn.attention import multi_head
from butd_detr_tpu_torch.nn.mlp import Dense, LayerNorm


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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU. In f32 torch's; in a narrower dtype op by op as
    `jax.nn.gelu(x, approximate=False)` computes it there, each op
    rounded: (x / 2) * erfc(-x * bf16(2^-1/2)) (torch's fused GELU rounds
    once and differs in the last bit of ~40 % of bf16 values). The
    constant is a tensor of x's dtype: a Python one would enter the
    product unrounded."""
    if x.dtype is torch.float32:
        return F.gelu(x)
    return (x * 0.5) * torch.special.erfc(-x * x.new_full((), 2.0 ** -0.5))


def create_position_ids(input_ids: torch.Tensor, pad_token_id: int):
    mask = (input_ids != pad_token_id).long()
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


class _Dense(nn.Module):
    def __init__(self, cin, cout, dtype):
        super().__init__()
        self.dense = Dense(cin, cout, dtype=dtype)

    def forward(self, x):
        return self.dense(x)


class _DenseLN(nn.Module):
    def __init__(self, cin, cout, eps, dtype):
        super().__init__()
        self.dense = Dense(cin, cout, dtype=dtype)
        self.LayerNorm = LayerNorm(cout, eps=eps)


class RobertaEmbeddings(nn.Module):
    def __init__(self, c: RobertaConfig, dtype=torch.float32):
        super().__init__()
        self.pad_token_id = c.pad_token_id
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings,
                                                c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size,
                                                  c.hidden_size)
        self.LayerNorm = LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, input_ids):
        pos = create_position_ids(input_ids, self.pad_token_id)
        dt = self.dtype
        x = (self.word_embeddings(input_ids).to(dt)
             + self.position_embeddings(pos).to(dt)
             + self.token_type_embeddings(torch.zeros_like(input_ids)).to(dt))
        return self.LayerNorm(x)


class _SelfAttention(nn.Module):
    def __init__(self, c: RobertaConfig, dtype):
        super().__init__()
        self.query = Dense(c.hidden_size, c.hidden_size, dtype=dtype)
        self.key = Dense(c.hidden_size, c.hidden_size, dtype=dtype)
        self.value = Dense(c.hidden_size, c.hidden_size, dtype=dtype)


class _Attention(nn.Module):
    def __init__(self, c: RobertaConfig, dtype):
        super().__init__()
        self.self = _SelfAttention(c, dtype)
        self.output = _DenseLN(c.hidden_size, c.hidden_size,
                               c.layer_norm_eps, dtype)


class RobertaLayer(nn.Module):
    def __init__(self, c: RobertaConfig, precise: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = c.num_attention_heads
        self.precise = precise
        self.attention = _Attention(c, dtype)
        self.intermediate = _Dense(c.hidden_size, c.intermediate_size, dtype)
        self.output = _DenseLN(c.intermediate_size, c.hidden_size,
                               c.layer_norm_eps, dtype)

    def forward(self, x, pad_mask):
        sa = self.attention.self
        a = multi_head(sa.query(x), sa.key(x), sa.value(x), self.num_heads,
                       pad_mask, dropout_p=0.0, precise=self.precise)
        ao = self.attention.output
        x = ao.LayerNorm(x + ao.dense(a))
        h = gelu(self.intermediate(x))
        return self.output.LayerNorm(x + self.output.dense(h))


class _Encoder(nn.Module):
    def __init__(self, c: RobertaConfig, precise: bool, dtype):
        super().__init__()
        self.layer = nn.ModuleList(
            RobertaLayer(c, precise, dtype)
            for _ in range(c.num_hidden_layers))


class RobertaModel(nn.Module):
    """input_ids (B, L), attention_mask (B, L) 1 == real -> last hidden
    state (B, L, hidden), f32 (the last LayerNorm's)."""

    def __init__(self, config: RobertaConfig, precise: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.config = config
        self.embeddings = RobertaEmbeddings(config, dtype)
        self.encoder = _Encoder(config, precise, dtype)

    def forward(self, input_ids, attention_mask):
        pad_mask = attention_mask == 0  # True == PAD
        x = self.embeddings(input_ids.long())
        for layer in self.encoder.layer:
            x = layer(x, pad_mask)
        return x
