"""Checkpoint-converter roundtrip: synthesize a reference-named torch state
dict from our init tree (inverse mapping implemented here, independently of
the converter), run convert_torch_checkpoint, and require exact recovery of
every leaf. Covers every param/stat leaf of the tiny flagship."""

import re

import numpy as np
import pytest

from butd_detr_tpu.lang import tiny_roberta_config
from butd_detr_tpu.train import Config
from butd_detr_tpu.train.step import build_model
from butd_detr_tpu.train.torch_convert import (
    convert_torch_checkpoint,
    flatten,
)
from torch_threads import one_torch_thread  # noqa: F401

_POS_IDX = {"Dense_0": "0", "BatchNorm_0": "1", "Dense_1": "3"}
_CON_IDX = {"Dense_0": "0", "Dense_1": "2", "Dense_2": "4"}
_TLM_IDX = {"dense_0": "net.0", "bn_0": "net.1",
            "dense_1": "net.4", "bn_1": "net.5", "dense_out": "net.8"}
_FFN_IDX = {"Dense_0": "0", "Dense_1": "3"}
_BN_LEAF = {"scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}


def _put_linear(sd, key, leaf, v):
    if leaf == "kernel":
        sd[f"{key}.weight"] = np.asarray(v).T
    else:
        sd[f"{key}.bias"] = np.asarray(v)


def _put_conv(sd, key, leaf, v):
    if leaf == "kernel":
        sd[f"{key}.weight"] = np.asarray(v).T[..., None]  # (out, in, 1)
    else:
        sd[f"{key}.bias"] = np.asarray(v)


def _put_ln(sd, key, leaf, v):
    sd[f"{key}.weight" if leaf == "scale" else f"{key}.bias"] = np.asarray(v)


def _put_bn(sd, key, leaf, v):
    sd[f"{key}.{_BN_LEAF[leaf]}"] = np.asarray(v)


def _put_mha(sd, key, leaf, which, v, store):
    """Accumulate q/k/v pieces; in_proj assembled at the end."""
    if which == "out_proj":
        _put_linear(sd, f"{key}.out_proj", leaf, v)
        return
    store.setdefault((key, leaf), {})[which] = np.asarray(v)


def _flush_mha(sd, store):
    for (key, leaf), parts in store.items():
        stacked = np.concatenate(
            [parts["q_proj"].T if leaf == "kernel" else parts["q_proj"],
             parts["k_proj"].T if leaf == "kernel" else parts["k_proj"],
             parts["v_proj"].T if leaf == "kernel" else parts["v_proj"]],
            axis=0,
        )
        sd[f"{key}.in_proj_weight" if leaf == "kernel"
           else f"{key}.in_proj_bias"] = stacked


def _put_roberta(sd, path, v):
    """HF RobertaModel key names (inverse of convert_hf_roberta_state_dict)."""
    rest, leaf = path[1:-1], path[-1]
    v = np.asarray(v)
    base = "text_encoder"
    if rest[0] == "embeddings":
        names = {
            "word_embeddings": "embeddings.word_embeddings",
            "position_embeddings": "embeddings.position_embeddings",
            "token_type_embeddings": "embeddings.token_type_embeddings",
        }
        if rest[1] in names:
            sd[f"{base}.{names[rest[1]]}.weight"] = v
        else:  # layer_norm
            _put_ln(sd, f"{base}.embeddings.LayerNorm", leaf, v)
        return
    m = re.match(r"layer_(\d+)", rest[0])
    p = f"{base}.encoder.layer.{m.group(1)}"
    if rest[1] == "attention":
        names = {"q_proj": "attention.self.query",
                 "k_proj": "attention.self.key",
                 "v_proj": "attention.self.value",
                 "out_proj": "attention.output.dense"}
        _put_linear(sd, f"{p}.{names[rest[2]]}", leaf, v)
    elif rest[1] == "attention_norm":
        _put_ln(sd, f"{p}.attention.output.LayerNorm", leaf, v)
    elif rest[1] == "intermediate":
        _put_linear(sd, f"{p}.intermediate.dense", leaf, v)
    elif rest[1] == "output":
        _put_linear(sd, f"{p}.output.dense", leaf, v)
    elif rest[1] == "output_norm":
        _put_ln(sd, f"{p}.output.LayerNorm", leaf, v)
    else:
        raise KeyError(path)


def synthesize_torch_sd(params, batch_stats):
    sd = {}
    mha_store = {}
    for tree in (params, batch_stats):
        for path, v in flatten(tree).items():
            p, leaf = list(path[:-1]), path[-1]
            if path == ("butd_class_embeddings",):
                sd["butd_class_embeddings.weight"] = np.asarray(v)
            elif p == ["text_projector"]:
                _put_linear(sd, "text_projector.0", leaf, v)
            elif p == ["text_projector_ln"]:
                _put_ln(sd, "text_projector.1", leaf, v)
            elif p == ["class_embeddings"]:
                _put_linear(sd, "class_embeddings", leaf, v)
            elif p == ["decoder_query_proj"]:
                _put_conv(sd, "decoder_query_proj", leaf, v)
            elif p and p[0] == "text_encoder":
                _put_roberta(sd, path, v)
            elif p and p[0] in ("box_embeddings", "pos_embed"):
                key = f"{p[0]}.position_embedding_head.{_POS_IDX[p[1]]}"
                (_put_bn if "BatchNorm" in p[1] else _put_conv)(
                    sd, key, leaf, v
                )
            elif p and p[0] == "backbone_net":
                attr = "mlp_module" if p[1].startswith("sa") else "mlp"
                m = re.match(r"(Dense|BatchNorm)_(\d+)", p[3])
                key = f"backbone_net.{p[1]}.{attr}.layer{m.group(2)}"
                if m.group(1) == "Dense":
                    _put_conv(sd, f"{key}.conv", leaf, v)
                else:
                    _put_bn(sd, f"{key}.bn.bn", leaf, v)
            elif p and p[0] == "points_obj_cls":
                if p[1].endswith("_bn"):
                    _put_bn(sd, f"points_obj_cls.bn{p[1][4]}", leaf, v)
                else:
                    _put_conv(sd, f"points_obj_cls.{p[1]}", leaf, v)
            elif p and p[0].startswith("contrastive_align_projection"):
                _put_linear(sd, f"{p[0]}.{_CON_IDX[p[1]]}", leaf, v)
            elif p and (
                p[0] == "proposal_head" or p[0].startswith("prediction_head_")
            ):
                head = ("proposal_head" if p[0] == "proposal_head"
                        else f"prediction_heads.{p[0].split('_')[-1]}")
                key = f"{head}.{p[1]}.{_TLM_IDX[p[2]]}"
                (_put_bn if p[2].startswith("bn") else _put_conv)(
                    sd, key, leaf, v
                )
            elif p and p[0] == "cross_encoder":
                base = f"cross_encoder.layers.{p[1].split('_')[-1]}"
                rest = p[2:]
                if rest[0] in ("self_attention_visual",
                               "self_attention_lang"):
                    if rest[1] == "self_attn":
                        _put_mha(sd, f"{base}.{rest[0]}.self_attn", leaf,
                                 rest[2], v, mha_store)
                    else:
                        _put_ln(sd, f"{base}.{rest[0]}.norm1", leaf, v)
                else:  # cross_layer
                    sub = f"{base}.cross_layer"
                    inner = rest[1]
                    if inner in ("cross_lv", "cross_vl", "cross_d"):
                        _put_mha(sd, f"{sub}.{inner}", leaf, rest[2], v,
                                 mha_store)
                    elif inner.startswith("norm"):
                        _put_ln(sd, f"{sub}.{inner}", leaf, v)
                    else:
                        _put_linear(
                            sd, f"{sub}.{inner}.{_FFN_IDX[rest[2]]}", leaf, v
                        )
            elif p and p[0].startswith("decoder_"):
                base = f"decoder.{p[0].split('_')[-1]}"
                rest = p[1:]
                if rest[0] == "self_posembed":
                    key = (f"{base}.self_posembed.position_embedding_head."
                           f"{_POS_IDX[rest[1]]}")
                    (_put_bn if "BatchNorm" in rest[1] else _put_conv)(
                        sd, key, leaf, v
                    )
                elif rest[0] in ("self_attn", "cross_l", "cross_d",
                                 "cross_v"):
                    _put_mha(sd, f"{base}.{rest[0]}", leaf, rest[1], v,
                             mha_store)
                elif rest[0].startswith("norm"):
                    _put_ln(sd, f"{base}.{rest[0]}", leaf, v)
                else:
                    _put_linear(sd, f"{base}.ffn.{_FFN_IDX[rest[1]]}",
                                leaf, v)
            else:
                raise KeyError(path)
    _flush_mha(sd, mha_store)
    return sd


def test_torch_checkpoint_roundtrip():
    import jax
    import jax.numpy as jnp

    from butd_detr_tpu.data.synthetic import synthetic_batch
    from butd_detr_tpu.train.step import INPUT_KEYS

    cfg = Config(
        use_contrastive_align=True, use_soft_token_loss=True, butd=True,
        self_attend=True, num_encoder_layers=1, num_decoder_layers=2,
        num_target=8, max_text_len=12, num_points=128, max_num_obj=8,
        max_det_boxes=8,
    )
    model = build_model(cfg, roberta_config=tiny_roberta_config(),
                        backbone_npoints=(32, 16, 8, 4))
    batch = synthetic_batch(batch_size=2, num_points=128, max_text_len=12,
                            max_num_obj=8, max_det_boxes=8,
                            n_true_objects=3, n_true_tokens=6, n_true_det=4)
    inputs = {k: jnp.asarray(batch[k]) for k in INPUT_KEYS}
    # shape-only init: the roundtrip compares trees, not forward outputs
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), inputs)
    )
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    rng = np.random.RandomState(0)
    variables = jax.tree_util.tree_unflatten(treedef, [
        rng.rand(*s.shape).astype(s.dtype) if s.shape else
        np.zeros(s.shape, s.dtype)
        for s in leaves
    ])
    params = jax.device_get(variables["params"])
    stats = jax.device_get(variables["batch_stats"])

    sd = synthesize_torch_sd(params, stats)
    # DDP prefix handling (README.md:65)
    sd = {f"module.{k}": v for k, v in sd.items()}
    new_params, new_stats = convert_torch_checkpoint(sd, params, stats)

    flat_old = flatten(params)
    flat_new = flatten(new_params)
    assert set(flat_old) == set(flat_new)
    for path in flat_old:
        np.testing.assert_array_equal(
            np.asarray(flat_old[path]), np.asarray(flat_new[path]),
            err_msg=str(path),
        )
    for path, v in flatten(stats).items():
        np.testing.assert_array_equal(
            np.asarray(v), np.asarray(flatten(new_stats)[path]),
            err_msg=str(path),
        )
