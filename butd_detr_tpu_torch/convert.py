"""JAX parameter trees -> the port's state dict.

`state_dict_from_jax(params, batch_stats)` takes the JAX package's flax
trees (as numpy arrays) and returns the port's state dict, under the
reference torch names. It inverts the JAX package's
`train/torch_convert.py` and RoBERTa's HF converter:
  * Dense kernel (in, out)          -> Linear weight (out, in), or the
                                       reference Conv1d/Conv2d 1x1 shape
  * BN {scale, bias} + {mean, var}  -> BatchNorm weight/bias/running stats
  * q/k/v_proj + out_proj           -> MultiheadAttention in_proj_* +
                                       out_proj (RoBERTa keeps HF's
                                       query/key/value/output.dense)
  * Embed embedding / raw table     -> Embedding weight
Any flax path without a mapping raises KeyError naming it.

`named_arrays_from_jax(tree)` applies the same name and layout map to any
tree shaped like the JAX parameters — a tree of gradients, say — so that a
test can lay `jax.grad`'s result beside `param.grad` by parameter name.

`span_state_dict_from_jax(params)` maps the JAX `SpanPredictor`'s
parameters (its RoBERTa under `text_encoder`, `Dense_0` and `Dense_1`)
onto `lang/span_predictor.py:SpanPredictor` (`text_encoder.*`,
`projector.0`, `projector.3`).

`text_encoder_to_jax(encoder)` goes the other way for a RoBERTa trunk:
{flax path: array}, the keys of the JAX tower's parameter tree, as
`scripts/pretrain_text_torch.py` writes its npz.

`load_text_init(path, model)` loads a text trunk saved under flax paths
(`studies/attrib_r5/text_init.npz`, from `scripts/pretrain_text.py`) into
`model.text_encoder` through the same map.

The evaluation epoch (harness, evaluators, checkpoints) adds no parameter,
so its tests move one set of weights across with this map unchanged.
"""

import re
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch

_POS = {"Dense_0": "0", "BatchNorm_0": "1", "Dense_1": "3"}
_CONTRASTIVE = {"Dense_0": "0", "Dense_1": "2", "Dense_2": "4"}
_TLM = {"dense_0": "net.0", "bn_0": "net.1", "dense_1": "net.4",
        "bn_1": "net.5", "dense_out": "net.8"}
_FFN = {"Dense_0": "0", "Dense_1": "3"}
_ROBERTA_LAYER = {
    ("attention", "q_proj"): ("attention.self.query", "linear"),
    ("attention", "k_proj"): ("attention.self.key", "linear"),
    ("attention", "v_proj"): ("attention.self.value", "linear"),
    ("attention", "out_proj"): ("attention.output.dense", "linear"),
    ("attention_norm",): ("attention.output.LayerNorm", "ln"),
    ("intermediate",): ("intermediate.dense", "linear"),
    ("output",): ("output.dense", "linear"),
    ("output_norm",): ("output.LayerNorm", "ln"),
}
_MHA_SLOT = {"q_proj": 0, "k_proj": 1, "v_proj": 2}


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _mha(base: str, proj: str):
    if proj == "out_proj":
        return f"{base}.out_proj", "linear"
    return f"{base}|{_MHA_SLOT[proj]}", "mha"


def _module(p: Tuple[str, ...]):
    """flax module path -> (torch module key, kind)."""
    if p == ("text_projector",):
        return "text_projector.0", "linear"
    if p == ("text_projector_ln",):
        return "text_projector.1", "ln"
    if p == ("class_embeddings",):
        return "class_embeddings", "linear"
    if p == ("decoder_query_proj",):
        return "decoder_query_proj", "conv1"
    if len(p) == 2 and p[0] in ("box_embeddings", "pos_embed"):
        return (f"{p[0]}.position_embedding_head.{_POS[p[1]]}",
                "bn" if p[1].startswith("BatchNorm") else "conv1")
    if p[0] == "backbone_net" and len(p) == 4:
        attr = "mlp_module" if p[1].startswith("sa") else "mlp"
        m = re.fullmatch(r"(Dense|BatchNorm)_(\d+)", p[3])
        layer = f"backbone_net.{p[1]}.{attr}.layer{m.group(2)}"
        if m.group(1) == "Dense":
            return f"{layer}.conv", "conv2"
        return f"{layer}.bn.bn", "bn"
    if p[0] == "points_obj_cls" and len(p) == 2:
        if p[1].endswith("_bn"):
            return f"points_obj_cls.bn{p[1][4]}", "bn"
        return f"points_obj_cls.{p[1]}", "conv1"
    if p[0].startswith("contrastive_align_projection") and len(p) == 2:
        return f"{p[0]}.{_CONTRASTIVE[p[1]]}", "linear"
    if (p[0] == "proposal_head" or p[0].startswith("prediction_head_")) \
            and len(p) == 3:
        head = ("proposal_head" if p[0] == "proposal_head"
                else f"prediction_heads.{p[0].rsplit('_', 1)[1]}")
        return (f"{head}.{p[1]}.{_TLM[p[2]]}",
                "bn" if p[2].startswith("bn") else "conv1")
    if p[0] == "cross_encoder":
        base = f"cross_encoder.layers.{p[1].rsplit('_', 1)[1]}"
        rest = p[2:]
        if rest[0] in ("self_attention_visual", "self_attention_lang"):
            if rest[1] == "self_attn":
                return _mha(f"{base}.{rest[0]}.self_attn", rest[2])
            return f"{base}.{rest[0]}.norm1", "ln"
        if rest[0] == "cross_layer":
            sub = f"{base}.cross_layer"
            if rest[1] in ("cross_lv", "cross_vl", "cross_d"):
                return _mha(f"{sub}.{rest[1]}", rest[2])
            if rest[1].startswith("norm"):
                return f"{sub}.{rest[1]}", "ln"
            if rest[1].startswith("ffn"):
                return f"{sub}.{rest[1]}.{_FFN[rest[2]]}", "linear"
    if re.fullmatch(r"decoder_\d+", p[0]):
        base = f"decoder.{p[0].rsplit('_', 1)[1]}"
        rest = p[1:]
        if rest[0] == "self_posembed":
            return (f"{base}.self_posembed.position_embedding_head."
                    f"{_POS[rest[1]]}",
                    "bn" if rest[1].startswith("BatchNorm") else "conv1")
        if rest[0] in ("self_attn", "cross_l", "cross_d", "cross_v"):
            return _mha(f"{base}.{rest[0]}", rest[1])
        if rest[0].startswith("norm"):
            return f"{base}.{rest[0]}", "ln"
        if rest[0] == "ffn":
            return f"{base}.ffn.{_FFN[rest[1]]}", "linear"
    if p[0] == "text_encoder":
        if p[1] == "embeddings":
            if p[2] == "layer_norm":
                return "text_encoder.embeddings.LayerNorm", "ln"
            return f"text_encoder.embeddings.{p[2]}", "embed"
        i = p[1].rsplit("_", 1)[1]
        key, kind = _ROBERTA_LAYER[p[2:]]
        return f"text_encoder.encoder.layer.{i}.{key}", kind
    raise KeyError(f"no port mapping for flax path {'/'.join(p)}")


_LEAF = {
    "bn": {"scale": "weight", "bias": "bias", "mean": "running_mean",
           "var": "running_var"},
    "ln": {"scale": "weight", "bias": "bias"},
    "embed": {"embedding": "weight"},
}


def named_arrays_from_jax(*trees: Dict) -> Dict[str, np.ndarray]:
    """Flax-shaped trees (parameters, batch statistics, gradients) ->
    {port parameter or buffer name: array in the port's layout}."""
    flat = {}
    for tree in trees:
        flat.update(_flatten(tree))
    out: Dict[str, np.ndarray] = {}
    mha: Dict[str, Dict[str, list]] = {}
    for path, arr in flat.items():
        arr = np.asarray(arr, np.float32)
        if path == ("butd_class_embeddings",):
            out["butd_class_embeddings.weight"] = arr
            continue
        key, kind = _module(path[:-1])
        leaf = path[-1]
        try:
            if kind in _LEAF:
                out[f"{key}.{_LEAF[kind][leaf]}"] = arr
                continue
            name = {"kernel": "weight", "bias": "bias"}[leaf]
        except KeyError:
            raise KeyError(f"unexpected leaf {'/'.join(path)}") from None
        if name == "weight":
            arr = arr.T
            if kind == "conv1":
                arr = arr[:, :, None]
            elif kind == "conv2":
                arr = arr[:, :, None, None]
        if kind == "mha":
            base, slot = key.split("|")
            mha.setdefault(base, {"weight": [None] * 3,
                                  "bias": [None] * 3})[name][int(slot)] = arr
        else:
            out[f"{key}.{name}"] = arr
    for base, parts in mha.items():
        for name in ("weight", "bias"):
            if any(a is None for a in parts[name]):
                raise KeyError(f"{base}: incomplete q/k/v {name}")
            out[f"{base}.in_proj_{name}"] = np.concatenate(parts[name], 0)
    return out


def state_dict_from_jax(params: Dict, batch_stats: Dict
                        ) -> "OrderedDict[str, torch.Tensor]":
    """The port's state dict for JAX `{params, batch_stats}` trees."""
    out = named_arrays_from_jax(params, batch_stats)
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[:-len("running_mean")] + "num_batches_tracked"] = np.zeros(
            (), np.int64)
    return OrderedDict(
        (k, torch.from_numpy(np.array(v)))  # a writable copy
        for k, v in sorted(out.items()))


_SPAN_PROJECTOR = {"Dense_0": "projector.0", "Dense_1": "projector.3"}


def span_state_dict_from_jax(params: Dict
                             ) -> "OrderedDict[str, torch.Tensor]":
    """The port's `SpanPredictor` state dict for the JAX `SpanPredictor`'s
    parameter tree (numpy leaves)."""
    out = named_arrays_from_jax({"text_encoder": params["text_encoder"]})
    for name, key in _SPAN_PROJECTOR.items():
        out[f"{key}.weight"] = np.asarray(params[name]["kernel"],
                                          np.float32).T
        out[f"{key}.bias"] = np.asarray(params[name]["bias"], np.float32)
    extra = set(params) - {"text_encoder", *_SPAN_PROJECTOR}
    if extra:
        raise KeyError(f"no port mapping for span predictor {sorted(extra)}")
    return OrderedDict(
        (k, torch.from_numpy(np.array(v))) for k, v in sorted(out.items()))


def text_encoder_to_jax(encoder) -> Dict[str, np.ndarray]:
    """A port `RobertaModel`'s parameters under the JAX tower's flax paths
    (`embeddings/word_embeddings/embedding`,
    `layer_0/attention/q_proj/kernel`, ...), in the flax layout."""
    own = {k: v.detach().cpu().float().numpy()
           for k, v in encoder.state_dict().items()}
    inverse = {f"encoder.layer.{{i}}.{key}": parts
               for parts, (key, _) in _ROBERTA_LAYER.items()}
    out = {}
    for i in range(len(encoder.encoder.layer)):
        for key, parts in inverse.items():
            base, path = key.format(i=i), "/".join((f"layer_{i}", *parts))
            if parts[-1].endswith("norm"):
                out[f"{path}/scale"] = own[f"{base}.weight"]
            else:
                out[f"{path}/kernel"] = own[f"{base}.weight"].T
            out[f"{path}/bias"] = own[f"{base}.bias"]
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[f"embeddings/{name}/embedding"] = \
            own[f"embeddings.{name}.weight"]
    out["embeddings/layer_norm/scale"] = own["embeddings.LayerNorm.weight"]
    out["embeddings/layer_norm/bias"] = own["embeddings.LayerNorm.bias"]
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def load_text_init(path: str, model) -> None:
    """Load the text trunk of the npz at `path` (flax-path keys such as
    `layer_0/attention/q_proj/kernel`, the tree of the JAX model's
    `params["text_encoder"]`) into `model.text_encoder`, in place.

    Shape-checked as the JAX package's loader
    (`scripts/probe_common.py:load_text_init`): raises KeyError naming the
    first key that is missing or has no place in the trunk, and ValueError
    naming the first whose shape differs."""
    data = np.load(path)
    prefix = "text_encoder."
    current = model.text_encoder.state_dict()
    arrays, source = {}, {}
    for key in sorted(data.files):
        tree = node = {}
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = data[key]
        try:
            ((name, arr),) = named_arrays_from_jax(
                {"text_encoder": tree}).items()
        except KeyError:  # a flax path the converter does not know
            name, arr = "", None
        name = name[len(prefix):]
        if name not in current:
            raise KeyError(f"text_init {path}: {key} has no place in the "
                           f"text encoder")
        arrays[name], source[name] = arr, key
    missing = sorted(set(current) - set(arrays))
    if missing:
        raise KeyError(f"text_init {path}: no array for text_encoder."
                       f"{missing[0]} ({len(missing)} missing)")
    for name, arr in arrays.items():
        if tuple(arr.shape) != tuple(current[name].shape):
            raise ValueError(
                f"text_init {path}: {source[name]} has shape "
                f"{tuple(data[source[name]].shape)}, the text encoder's "
                f"{name} {tuple(current[name].shape)}")
    model.text_encoder.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})
