"""The whole model at the recipes' default precision mode, against the JAX
model at its defaults, with the same weights and inputs.

The recipes run a bf16 backbone (`backbone_bf16=True`) and the attention
with bf16 operands (`attn_precise=False`). The JAX side:
`BeaUTyDETR(backbone_dtype=bfloat16, attn_precise=None)` with every
`MultiHeadAttention` on the Pallas kernel (`fused_attention`) in
interpret mode, reached only through this test's patches: the attention
module reads `jax.default_backend()` through a proxy that reports `tpu`,
and `fused_attention` is bound to `interpret=True`. Nothing else sees a
TPU backend, so the point ops keep their CPU paths. The port:
`backbone_dtype=torch.bfloat16, attn_precise=False`, its plain versions on
the CPU. Weights through `convert.state_dict_from_jax`, inputs those of
tests/test_torch_model.py.

What is held (BF16_TOL = 1e-3 + 2^-8 * max|JAX|: the f32 bound's
absolute term plus the largest error of one bf16 rounding of the end
point's largest value):
- every integer end point of the backbone (FPS and ball-query indices)
  equal;
- every float end point up to the kps logits (`seeds_obj_cls_logits`)
  within BF16_TOL. Observed at this size: 4.9e-4 (`sa1_features`, bound
  1.1e-2), 3.9e-3 (`fp2_features`, 1.6e-2), 3.7e-3 (`seed_features`,
  1.6e-2), 9.1e-4 (the logits, 2.2e-3);
- the near-tie rule: the kps selection is equal, or every rank where it
  differs holds JAX logits within twice the logits' measured error (two
  seeds whose logits lie closer than the two sides' rounding may swap;
  observed: 1 of 32 ranks, a JAX-logit gap of 3.0e-4 against twice the
  logits' error, 1.8e-3);
- the port's `decode` then runs on the JAX selection, and every
  query-side end point lies within BF16_TOL of the JAX model's (observed
  at most 3.2e-3, `query_points_feature`, bound 1.6e-2).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from butd_detr_tpu.lang.roberta import RobertaConfig as JRobertaConfig
from butd_detr_tpu.models import BeaUTyDETR as JBeaUTyDETR
from butd_detr_tpu.nn import attention as jattention
from butd_detr_tpu.ops import pallas_attention
from butd_detr_tpu_torch.convert import state_dict_from_jax
from butd_detr_tpu_torch.lang import RobertaConfig
from butd_detr_tpu_torch.models import BeaUTyDETR
from butd_detr_tpu_torch.predict import load_state_dict

from test_torch_model import DEC, ENC, NPOINTS, NQ, ROBERTA, _inputs
from torch_threads import one_torch_thread  # noqa: F401


def bf16_tol(want: np.ndarray) -> float:
    """1e-3 + 2^-8 * max|want|: the f32 bound's absolute term plus the
    largest error of one bf16 rounding of the end point's largest value."""
    return 1e-3 + 2.0 ** -8 * float(np.abs(want).max())


class _TpuBackend:
    """`jax` as the attention module sees it: a TPU backend, so that it
    takes the Pallas path; every other name is jax's own."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@pytest.fixture(scope="module")
def defaults():
    inputs = _inputs()
    jm = JBeaUTyDETR(num_queries=NQ, num_encoder_layers=ENC,
                     num_decoder_layers=DEC,
                     roberta=JRobertaConfig(**ROBERTA),
                     backbone_npoints=NPOINTS,
                     backbone_dtype=jnp.bfloat16, attn_precise=None)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    calls = []
    fused = pallas_attention.fused_attention

    def interpret(*a, **kw):
        calls.append(kw.get("precise"))
        return fused(*a, **dict(kw, interpret=True))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattention, "jax", _TpuBackend())
        mp.setattr(pallas_attention, "fused_attention",
                   functools.wraps(fused)(interpret))
        variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jin)
        calls.clear()  # count the forward's calls only
        want = jax.jit(lambda v, i: jm.apply(v, i, train=False))(
            variables, jin)
    sd = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    pm = BeaUTyDETR(RobertaConfig(**ROBERTA), num_queries=NQ,
                    num_encoder_layers=ENC, num_decoder_layers=DEC,
                    backbone_npoints=NPOINTS, backbone_dtype=torch.bfloat16,
                    attn_precise=False)
    assert load_state_dict(pm, sd) == []
    pm.eval()
    with torch.no_grad():
        got, detected = pm.encode({k: torch.from_numpy(v)
                                   for k, v in inputs.items()})
        encoded = {k: v.clone() for k, v in got.items()}
        port_inds = torch.sort(
            got["seeds_obj_cls_logits"], dim=-1, descending=True,
            stable=True).indices[:, :NQ]
        jinds = torch.from_numpy(
            np.array(want["query_points_sample_inds"], np.int32))
        decoded = pm.decode(got, detected, jinds)
    return dict(
        calls=calls, encoded={k: v.float().numpy() if v.is_floating_point()
                              else v.numpy() for k, v in encoded.items()},
        port_inds=port_inds.numpy(),
        want={k: np.asarray(v) for k, v in want.items()},
        decoded={k: v.float().numpy() if v.is_floating_point()
                 else v.numpy() for k, v in decoded.items()})


def _float_errors(got, want, keys):
    bad = []
    for k in keys:
        g, w = got[k], want[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        err = float(np.abs(g.astype(np.float64) - w.astype(np.float64)).max())
        if not err <= bf16_tol(w):
            bad.append((k, err, bf16_tol(w)))
    return bad


def test_the_jax_side_ran_its_pallas_kernel_with_bf16_operands(defaults):
    # the text tower's 2 layers, the encoder's 2 x (self, text cross, box
    # cross, text self, text-to-visual cross) ... : some dozens of calls,
    # every one in the default (bf16-operand) mode
    assert len(defaults["calls"]) >= 20
    assert set(defaults["calls"]) == {None}


def test_backbone_and_kps_logits_match_at_the_defaults(defaults):
    got, want = defaults["encoded"], defaults["want"]
    ints = [k for k in got if got[k].dtype.kind in "iub"]
    assert {"sa1_inds", "sa2_inds", "fp2_inds", "seed_inds"} <= set(ints)
    for k in ints:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    floats = sorted(set(got) - set(ints))
    assert {"sa1_features", "fp2_features", "seed_features",
            "seeds_obj_cls_logits", "text_memory", "proj_tokens"} \
        <= set(floats)
    bad = _float_errors(got, want, floats)
    assert not bad, bad


def test_kps_selection_is_equal_up_to_near_ties(defaults):
    got = defaults["encoded"]["seeds_obj_cls_logits"].astype(np.float64)
    want = defaults["want"]["seeds_obj_cls_logits"].astype(np.float64)
    jinds = defaults["want"]["query_points_sample_inds"].astype(np.int64)
    pinds = defaults["port_inds"]
    logit_err = float(np.abs(got - want).max())
    differ = jinds != pinds
    gap = np.abs(np.take_along_axis(want, jinds, 1)
                 - np.take_along_axis(want, pinds, 1))
    assert (gap[differ] <= 2 * logit_err).all(), (
        int(differ.sum()), gap[differ], logit_err)


def test_query_side_matches_on_the_jax_selection(defaults):
    got, want = defaults["decoded"], defaults["want"]
    assert set(got) == set(want)
    encoded = set(defaults["encoded"])
    query_side = sorted(k for k in set(want) - encoded)
    ints = [k for k in query_side if want[k].dtype.kind in "iub"]
    for k in ints:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    floats = [k for k in query_side if k not in ints]
    assert {"last_center", "last_pred_size", "last_sem_cls_scores",
            "proposal_center", "query_points_feature"} <= set(floats)
    bad = _float_errors(got, want, floats)
    assert not bad, bad
