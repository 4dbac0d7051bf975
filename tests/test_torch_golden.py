"""The port against the original torch reference, without JAX.

tests/golden/full_model_golden.npz holds the reference BeaUTyDETR's state
dict (`sd.*`), its inputs (`in.*`) and every end point of its eval-mode
forward (`out.*`): B=2, 2048 points, 64 queries, a 96-d RoBERTa. The `sd.*`
keys load straight into the port's model (reference parameter names), and
its end points must match at tests/test_full_model_golden.py's bounds:
integers equal, floats |err| <= 1e-3 + 5e-3 * std(reference).
"""

import os.path as osp

import numpy as np
import pytest
import torch

from butd_detr_tpu_torch.lang import RobertaConfig
from butd_detr_tpu_torch.models import BeaUTyDETR
from butd_detr_tpu_torch.predict import load_state_dict
from torch_threads import one_torch_thread  # noqa: F401

FIX = osp.join(osp.dirname(osp.abspath(__file__)), "golden",
               "full_model_golden.npz")
# the reference stores these channels-first (B, C, V)
CHANNELS_FIRST = {"sa1_features", "sa2_features", "sa3_features",
                  "sa4_features", "fp2_features", "seed_features",
                  "query_points_feature"}
# the reference state dict's keys the port's forward has no use for
UNUSED = ["text_encoder.pooler.dense.bias",
          "text_encoder.pooler.dense.weight"]


@pytest.fixture(scope="module")
def golden():
    gold = dict(np.load(FIX))
    model = BeaUTyDETR(
        RobertaConfig(vocab_size=1024, hidden_size=96, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=128,
                      max_position_embeddings=80),
        num_queries=64, input_feature_dim=3, attn_precise=True)
    sd = {k[3:]: v for k, v in gold.items() if k.startswith("sd.")}
    unused = load_state_dict(model, sd)
    inputs = {k[3:]: torch.from_numpy(v) for k, v in gold.items()
              if k.startswith("in.")}
    with torch.no_grad():
        ep = model.eval()(inputs)
    ref = {k[4:]: v for k, v in gold.items() if k.startswith("out.")}
    return model, sd, unused, {k: v.numpy() for k, v in ep.items()}, ref


def test_every_port_parameter_is_in_the_reference(golden):
    model, sd, unused, _, _ = golden
    assert set(model.state_dict()) <= set(sd)
    assert unused == UNUSED
    assert len(sd) == 844


def test_integer_end_points_match(golden):
    _, _, _, ep, ref = golden
    ints = [k for k in ref if ref[k].dtype.kind in "iu"]
    assert {"sa1_inds", "sa2_inds", "seed_inds",
            "query_points_sample_inds"} <= set(ints)
    for k in ints:
        np.testing.assert_array_equal(ep[k].astype(np.int64),
                                      ref[k].astype(np.int64), err_msg=k)


def test_float_end_points_match(golden):
    _, _, _, ep, ref = golden
    floats = sorted(k for k in ref if ref[k].dtype.kind == "f")
    assert len(floats) >= 50 and set(floats) <= set(ep)
    bad = []
    for k in floats:
        want = ref[k].astype(np.float64)
        if k in CHANNELS_FIRST:
            want = want.transpose(0, 2, 1)
        want = want.reshape(ep[k].shape)
        err = np.abs(ep[k] - want).max()
        lim = 1e-3 + 5e-3 * float(np.std(want))
        if err > lim:
            bad.append((k, float(err), lim))
    assert not bad, bad
