"""The whole serving slice: the JAX package's `BeaUTyDETR.apply(train=
False)` against the port's model with the same weights (moved across by
`convert.state_dict_from_jax`), on the same numpy inputs, at a small size;
then the two `GroundingPredictor`s, and the weight round trip.

Tolerances: integer end points (FPS, ball query, kps top-k) equal; floats
within the golden bound of tests/test_full_model_golden.py,
|err| <= 1e-3 + 5e-3 * std(reference). The port runs f32 with the precise
attention mode; the JAX side runs its CPU path.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from butd_detr_tpu.lang.roberta import RobertaConfig as JRobertaConfig
from butd_detr_tpu.lang.tokenizer import SimpleTokenizer as JTokenizer
from butd_detr_tpu.models import BeaUTyDETR as JBeaUTyDETR
from butd_detr_tpu.predict import GroundingPredictor as JPredictor
from butd_detr_tpu.train.config import Config as JConfig
from butd_detr_tpu.train.torch_convert import convert_torch_checkpoint
from butd_detr_tpu_torch.config import Config
from butd_detr_tpu_torch.convert import state_dict_from_jax
from butd_detr_tpu_torch.lang import RobertaConfig, SimpleTokenizer
from butd_detr_tpu_torch.models import BeaUTyDETR
from butd_detr_tpu_torch.predict import GroundingPredictor, load_state_dict
from torch_threads import one_torch_thread  # noqa: F401

ROBERTA = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=96,
               max_position_embeddings=40)
NPOINTS = (64, 32, 16, 8)
NQ, ENC, DEC = 16, 2, 2
B, N, L, D = 2, 1024, 12, 10


def _inputs():
    rng = np.random.RandomState(0)
    pc = np.concatenate([rng.rand(B, N, 3) * 3, rng.rand(B, N, 3) - 0.5],
                        -1).astype(np.float32)
    ids = rng.randint(4, 128, (B, L)).astype(np.int32)
    ids[:, 0] = 0
    mask = np.ones((B, L), np.int32)
    ids[1, 8:], mask[1, 8:] = 1, 0
    return {
        "point_clouds": pc,
        "text_ids": ids,
        "text_mask": mask,
        "det_boxes": rng.rand(B, D, 6).astype(np.float32),
        "det_bbox_label_mask": np.arange(D)[None] < np.array([[7], [10]]),
        "det_class_ids": rng.randint(0, 485, (B, D)).astype(np.int32),
    }


@pytest.fixture(scope="module")
def pair():
    inputs = _inputs()
    jm = JBeaUTyDETR(num_queries=NQ, num_encoder_layers=ENC,
                     num_decoder_layers=DEC,
                     roberta=JRobertaConfig(**ROBERTA),
                     backbone_npoints=NPOINTS)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jin)
    want = jax.jit(lambda v, i: jm.apply(v, i, train=False))(variables, jin)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    sd = state_dict_from_jax(params, stats)
    pm = BeaUTyDETR(RobertaConfig(**ROBERTA), num_queries=NQ,
                    num_encoder_layers=ENC, num_decoder_layers=DEC,
                    backbone_npoints=NPOINTS, attn_precise=True)
    assert load_state_dict(pm, sd) == []
    with torch.no_grad():
        got = pm.eval()({k: torch.from_numpy(v) for k, v in inputs.items()})
    return {
        "params": params, "stats": stats, "sd": sd, "model": pm,
        "want": {k: np.asarray(v) for k, v in want.items()},
        "got": {k: v.numpy() for k, v in got.items()},
    }


def test_slice_end_points_match(pair):
    want, got = pair["want"], pair["got"]
    assert set(got) == set(want)
    ints = [k for k in want if want[k].dtype.kind in "ib"]
    assert {"sa1_inds", "sa2_inds", "seed_inds",
            "query_points_sample_inds"} <= set(ints)
    for k in ints:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    bad = []
    for k in sorted(set(want) - set(ints)):
        err = np.abs(got[k].astype(np.float64) - want[k]).max()
        lim = 1e-3 + 5e-3 * float(np.std(want[k]))
        if err > lim:
            bad.append((k, float(err), lim))
    assert not bad, bad


def test_slice_variant_without_boxes_or_contrast_matches():
    """The model's other flags: no box stream, no contrastive heads, no
    self-attention in the encoder, xyz-only query positions."""
    inputs = {k: v[:, :256] if k == "point_clouds" else v
              for k, v in _inputs().items()}
    flags = dict(butd=False, contrastive_align_loss=False,
                 self_attend=False, self_position_embedding="xyz_learned",
                 num_queries=8, num_encoder_layers=1, num_decoder_layers=2,
                 backbone_npoints=(32, 16, 8, 4))
    jm = JBeaUTyDETR(roberta=JRobertaConfig(**ROBERTA), **flags)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1), jin)
    want = jax.jit(lambda v, i: jm.apply(v, i, train=False))(variables, jin)
    pm = BeaUTyDETR(RobertaConfig(**ROBERTA), attn_precise=True, **flags)
    sd = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    assert load_state_dict(pm, sd) == []
    with torch.no_grad():
        got = pm.eval()({k: torch.from_numpy(v) for k, v in inputs.items()})
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        if w.dtype.kind in "ib":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            lim = 1e-3 + 5e-3 * float(np.std(w))
            assert np.abs(g.astype(np.float64) - w).max() <= lim, k


def test_state_dict_round_trips_through_the_jax_converter(pair):
    """The JAX package's own converter turns the port's state dict back
    into exactly the JAX trees it came from."""
    zeros = jax.tree_util.tree_map(np.zeros_like, pair["params"])
    zstats = jax.tree_util.tree_map(np.zeros_like, pair["stats"])
    params, stats = convert_torch_checkpoint(
        pair["model"].state_dict(), zeros, zstats)
    for a, b in ((params, pair["params"]), (stats, pair["stats"])):
        la, ta = jax.tree_util.tree_flatten(a)
        lb, tb = jax.tree_util.tree_flatten(b)
        assert ta == tb
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(np.asarray(x), y)


def test_predictor_matches_jax_predictor(pair):
    kw = dict(use_color=True, butd_cls=True, self_attend=True,
              use_contrastive_align=True, num_target=NQ,
              num_encoder_layers=ENC, num_decoder_layers=DEC,
              max_text_len=16, num_points=N, max_det_boxes=D,
              backbone_bf16=False, attn_precise=True)
    rng = np.random.RandomState(7)
    cloud = np.concatenate([rng.rand(3000, 3) * 4, rng.rand(3000, 3)],
                           1).astype(np.float32)
    boxes = rng.rand(6, 6).astype(np.float32)
    req = dict(utterance="the chair near the brown table", phrase="chair",
               det_boxes=boxes, det_class_ids=[3, 1, 4, 1, 5, 9], top_k=5)

    jp = JPredictor(JConfig(**kw), {"params": pair["params"],
                                    "batch_stats": pair["stats"]},
                    JTokenizer(128, 16),
                    roberta_config=JRobertaConfig(**ROBERTA),
                    backbone_npoints=NPOINTS)
    pp = GroundingPredictor(Config(**kw), SimpleTokenizer(128, 16),
                            pair["sd"],
                            roberta_config=RobertaConfig(**ROBERTA),
                            backbone_npoints=NPOINTS, device="cpu")
    for mode in ("bbf", "bbs"):
        want = jp.predict(cloud, mode=mode, **req)
        got = pp.predict(cloud, mode=mode, **req)
        np.testing.assert_array_equal(got["query_index"],
                                      want["query_index"])
        np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(got["scores"], want["scores"],
                                   atol=1e-5, rtol=1e-4)


def test_predictor_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GroundingPredictor(Config(), roberta_config=RobertaConfig(
            **ROBERTA), backbone_npoints=NPOINTS)
