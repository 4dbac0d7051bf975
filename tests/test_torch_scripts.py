"""The port's last tools against the JAX package's, on the CPU at small
sizes: the two training setups' launch scripts, the stage-by-stage
backward timer and the input-pipeline timer.

(a) `scripts/train_test_{cls,det}_torch.sh` pass train_torch.py the flags
    that `scripts/train_test_{cls,det}.sh` pass train.py, and the port's
    `parse_config` reads them as the JAX one does (the flag lists are also
    cases of test_torch_harness.py's parametrised parse test).
(b) `BENCH_TINY=1 scripts/bench_backward_torch.py --device cpu` prints
    every key of scripts/bench_backward.py, finite, and the device keys
    as not measured (None) on the CPU.
(c) The timer's stages (`build_stages` with dropout 0, strict f32)
    against the same stages built from the JAX modules as
    scripts/bench_backward.py builds them, with the weights carried by
    `convert.state_dict_from_jax` and the same numpy inputs, at the
    bench's tiny batch of 8 with each row's tokens and detected boxes
    padded from a seeded length on (the synthetic batch pads none, and
    a stage that dropped a mask would pass). BatchNorm runs on its running statistics on
    both sides, as test_torch_train_step.py holds the model: on batch
    statistics this model's gradients are ill-conditioned in f32 (the
    JAX package's own eager and jitted train-mode gradients differ beyond
    the bound below, test_torch_dp.py; here the backbone's differ from the
    port's by up to 8 % of max|g|), and train-mode BatchNorm is held by
    test_torch_train_modules.py. The loss stage takes the end points
    of the port's train-mode forward, as the timer does. Each stage's
    outputs, element by element, within atol 1e-5 + rtol 1e-4 (the f32
    module tests' bound). Each stage is then differentiated through
    sum(out * w), w a seeded standard-normal weight for each output, so
    that every output element moves the scalar (the timer's plain sum of
    a LayerNorm's outputs is 0 whatever the input): the scalar within
    rtol 1e-4 (the train-step test's loss bound), and the gradient of
    every parameter (by the port's name; the JAX one through
    `convert.named_arrays_from_jax`) and of every differentiated input,
    element by element, within 2e-3 * max|g| + 1e-6 (the train-step
    test's gradient bound).
(d) `scripts/bench_input_pipeline_torch.py` with 0 and 2 workers prints
    the JAX script's keys and `warmup_s`, and its `build_loader` gives
    the JAX loader's first two batches on the same root, key by key and
    bit for bit (as test_torch_data.py holds the loader).
"""

import dataclasses
import json
import math
import os
import re
import shlex
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from butd_detr_tpu.data import DataLoader as JDataLoader
from butd_detr_tpu.data import JointGroundingDataset as JDataset
from butd_detr_tpu.data.scan import load_scans_parallel as j_load_scans
from butd_detr_tpu.lang import tiny_roberta_config as j_tiny_roberta
from butd_detr_tpu.lang.tokenizer import SimpleTokenizer as JTokenizer
from butd_detr_tpu.losses import compute_hungarian_loss as j_hungarian_loss
from butd_detr_tpu.models.decoder import BiDecoderLayer as JBiDecoderLayer
from butd_detr_tpu.models.encoder import BiEncoder as JBiEncoder
from butd_detr_tpu.models.heads import ClsAgnosticPredictHead as JHead
from butd_detr_tpu.nn.backbone import Pointnet2Backbone as JBackbone
from butd_detr_tpu.train.config import Config as JConfig
from butd_detr_tpu.train.config import parse_config as j_parse_config
from butd_detr_tpu.train.step import build_model as j_build_model
from butd_detr_tpu.train.step import criterion_config as j_criterion_config
from butd_detr_tpu_torch.config import parse_config
from butd_detr_tpu_torch.convert import (
    named_arrays_from_jax,
    state_dict_from_jax,
)
from butd_detr_tpu_torch.lang import tiny_roberta_config
from butd_detr_tpu_torch.predict import build_model, load_state_dict
from butd_detr_tpu_torch.train import INPUT_KEYS, TARGET_KEYS
from chip_smoke import BENCH_BACKWARD_KEYS, INPUT_PIPELINE_KEYS
from scripts.bench_backward_torch import (
    STAGES,
    bench_setup,
    build_stages,
    stage_activations,
)
from scripts.bench_input_pipeline_torch import (
    build_loader,
    data_root,
    parse_args,
)
from test_torch_harness import DET_SCRIPT_FLAGS, SCRIPT_FLAGS
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")


# ------------------------------------------------- (a) the launch scripts

def script_flags(name: str, entry: str):
    """The words of scripts/<name> between `entry` and "$@"."""
    with open(os.path.join(SCRIPTS, name)) as f:
        text = "\n".join(line for line in f.read().splitlines()
                         if not line.lstrip().startswith("#"))
    words = shlex.split(text.replace("\\\n", " "))
    return words[words.index(entry) + 1:words.index("$@")]


def with_defaults(flags):
    """Shell default expansions (${VAR:-value}) replaced by their value."""
    return [re.sub(r"\$\{\w+:-([^}]*)\}", r"\1", w) for w in flags]


@pytest.mark.parametrize("setup", ["cls", "det"])
def test_launch_scripts_pass_the_jax_scripts_flags(setup):
    got = script_flags(f"train_test_{setup}_torch.sh", "train_torch.py")
    want = script_flags(f"train_test_{setup}.sh", "train.py")
    assert got == want
    assert "${DATA_ROOT:-./data}" in got
    assert with_defaults(got) == {"cls": SCRIPT_FLAGS,
                                  "det": DET_SCRIPT_FLAGS}[setup]
    got_cfg = parse_config(with_defaults(got))
    want_cfg = j_parse_config(with_defaults(want))
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    assert got_cfg.butd_cls == (setup == "cls")
    assert got_cfg.augment_det == got_cfg.butd == (setup == "det")
    with open(os.path.join(SCRIPTS, f"train_test_{setup}_torch.sh")) as f:
        launcher = shlex.split(f.read().split("train_torch.py")[0]
                               .replace("\\\n", " "), comments=True)
    assert launcher == ["torchrun", "--standalone", "--nproc_per_node",
                        "${NPROC_PER_NODE:-$(nvidia-smi -L | wc -l)}"]


# ---------------------------------------- (b) the backward timer's output

def test_backward_timer_prints_the_jax_scripts_keys():
    env = dict(os.environ, BENCH_TINY="1", BENCH_BATCH="2", BENCH_REPS="1",
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "bench_backward_torch.py"),
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    device_keys = {f"{k}_device_ms" for k in BENCH_BACKWARD_KEYS}
    assert set(result) == {*BENCH_BACKWARD_KEYS, *device_keys, "peak_gib",
                           "device"}
    for k in BENCH_BACKWARD_KEYS:
        assert isinstance(result[k], float) and math.isfinite(result[k]), k
    timed = [k for k in BENCH_BACKWARD_KEYS
             if k.endswith(("_fwd", "_fwdbwd"))]
    for k in ("canary_fps_tier1", "full_step", "adamw_update", *timed):
        assert result[k] > 0, k
    # a CPU run measures no device time
    assert all(result[k] is None for k in (*device_keys, "peak_gib"))
    assert result["device"] == "cpu"


# ------------------------------------ (c) the stages against the JAX ones

# the f32 module tests' bound on outputs (test_torch_modules.py)
ATOL, RTOL = 1e-5, 1e-4


def projections(outputs, seed):
    """A standard-normal f32 weight for each output, from a numpy seed:
    the stage's scalar sum(out * w) then moves with every output element,
    where the timer's plain sum of a LayerNorm's outputs does not."""
    rng = np.random.RandomState(seed)
    return {k: rng.standard_normal(np.shape(outputs[k])).astype(np.float32)
            for k in sorted(outputs)}


@pytest.fixture(scope="module")
def stages():
    """Both packages' stages on one tiny batch, dropout 0, strict f32:
    {stage: (port, JAX)}, each {"outputs": {name: array}, "value": the
    projected scalar, "grads": {port parameter or input name: array}}."""
    cfg, _, npoints, batch = bench_setup(tiny=True, batch_size=8)
    cfg = dataclasses.replace(cfg, backbone_bf16=False, attn_precise=True)
    # the synthetic batch pads no token and no detected box: pad each
    # row's tail, so that the stages' masks matter
    rng = np.random.RandomState(0)
    for key in ("text_mask", "det_bbox_label_mask"):
        B, n = batch[key].shape
        keep = rng.randint(n // 2, n + 1, size=(B, 1))
        batch[key] = (np.arange(n) < keep).astype(batch[key].dtype)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    jm = j_build_model(jcfg, roberta_config=j_tiny_roberta(),
                       backbone_npoints=npoints)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    inputs = {k: jbatch[k] for k in INPUT_KEYS}
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), inputs)
    params, stats = variables["params"], variables["batch_stats"]
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    model = build_model(cfg, tiny_roberta_config(), npoints)
    load_state_dict(model, state_dict_from_jax(to_np(params), to_np(stats)))
    got = build_stages(model, cfg, batch, npoints, "cpu", dropout=0.0)
    # the loss on the port's train-mode end points (dropout 0: the forward
    # inside build_stages gave these values)
    with torch.no_grad():
        ep = model({k: torch.from_numpy(batch[k]) for k in INPUT_KEYS})
    ep = {k: v.numpy() for k, v in ep.items()}
    for k in TARGET_KEYS:
        ep[k] = batch[k]
    diff_keys = list(got["loss"].inputs)
    for k in diff_keys:
        np.testing.assert_array_equal(ep[k], got["loss"].inputs[k].detach())
    rest = {k: jnp.asarray(v) for k, v in ep.items() if k not in diff_keys}

    # BatchNorm on the JAX package's running statistics (the train-mode
    # forwards above moved the port's)
    load_state_dict(model, state_dict_from_jax(to_np(params), to_np(stats)))
    model.eval()

    result, weights = {}, {}
    for i, name in enumerate(STAGES):
        stage = got[name]
        for t in stage.wrt:  # the stages share their stand-in inputs
            t.grad = None
        outputs = stage.outputs()
        w = weights[name] = projections(
            {k: v.detach().numpy() for k, v in outputs.items()}, seed=i)
        value = sum((v.float() * torch.from_numpy(w[k])).sum()
                    for k, v in outputs.items())
        value.backward()
        grads = {k: t.grad.numpy() for k, t in
                 (*stage.params.items(), *stage.inputs.items())}
        result[name] = [dict(
            outputs={k: v.detach().numpy() for k, v in outputs.items()},
            value=float(value.detach()), grads=grads)]

    B, L = batch["text_ids"].shape
    act = {k: jnp.asarray(v) for k, v in stage_activations(
        B, npoints[1], L, cfg.max_det_boxes, cfg.num_target).items()}
    vis_mask = jnp.zeros((B, npoints[1]), bool)
    text_pad = jbatch["text_mask"] == 0
    det_pad = ~jbatch["det_bbox_label_mask"]

    bb = JBackbone(input_feature_dim=jm.input_feature_dim, output_dim=288,
                   npoints=jm.backbone_npoints,
                   input_presorted=jm.input_presorted,
                   dtype=jm.backbone_dtype or jm.dtype)

    def backbone(p, x):
        ep = bb.apply({"params": p["backbone_net"],
                       "batch_stats": stats["backbone_net"]},
                      jbatch["point_clouds"], train=False)
        return {"fp2_features": ep["fp2_features"]}

    enc = JBiEncoder(num_layers=cfg.num_encoder_layers, d_model=288,
                     n_heads=8, dim_feedforward=256, dropout=0.0,
                     self_attend=True, use_butd_enc_attn=True,
                     dtype=jm.dtype, attn_precise=True)

    def encoder(p, x):
        v, t = enc.apply({"params": p["cross_encoder"]}, x["vis"],
                         act["pos"], vis_mask, x["txt"], text_pad,
                         act["det"], det_pad, train=False)
        return {"vis": v, "txt": t}

    dec = JBiDecoderLayer(288, n_heads=8, dim_feedforward=256, dropout=0.0,
                          self_position_embedding="loc_learned", butd=True,
                          dtype=jm.dtype, attn_precise=True)
    layers = [f"decoder_{i}" for i in range(cfg.num_decoder_layers)]

    def decoder(p, x):
        q = x["query"]
        for layer in layers:
            q = dec.apply(
                {"params": p[layer], "batch_stats": stats[layer]}, q,
                x["vis"], x["txt"], act["query_pos"], None, text_pad,
                act["det"], det_pad, train=False)
        return {"query": q}

    head_names = ["proposal_head", *(f"prediction_head_{i}" for i in
                                     range(cfg.num_decoder_layers))]
    hd = JHead(256, 288, dtype=jm.dtype)

    def heads7(p, x):
        out = {}
        for i, name in enumerate(head_names):
            o = hd.apply({"params": p[name], "batch_stats": stats[name]},
                         x["query"], act["base_xyz"], train=False)
            out.update({f"{i}.{k}": v for k, v in o.items()})
        return out

    def loss(p, x):
        value, _ = j_hungarian_loss(
            dict(rest, **x), cfg.num_decoder_layers,
            j_criterion_config(jcfg), cfg.query_points_obj_topk)
        return {"loss": value}

    runs = {
        "backbone": (backbone, ["backbone_net"], {}),
        "encoder": (encoder, ["cross_encoder"],
                    {k: act[k] for k in ("vis", "txt")}),
        "decoder": (decoder, layers,
                    {k: act[k] for k in ("query", "vis", "txt")}),
        "heads7": (heads7, head_names, {"query": act["query"]}),
        "loss": (loss, [], {k: jnp.asarray(ep[k]) for k in diff_keys}),
    }
    for name, (fn, modules, x) in runs.items():
        w = weights[name]

        def projected(p, x, fn=fn, w=w):
            out = fn(p, x)
            return sum(jnp.sum(out[k] * w[k]) for k in w), out

        (value, outputs), (gp, gx) = jax.jit(jax.value_and_grad(
            projected, argnums=(0, 1), has_aux=True))(
                {m: params[m] for m in modules}, x)
        grads = dict(named_arrays_from_jax(to_np(gp)) if modules else {},
                     **to_np(gx))
        result[name].append(dict(outputs=to_np(outputs), value=float(value),
                                 grads=grads))
    return result


@pytest.mark.parametrize("stage", STAGES)
def test_stages_match_the_jax_stages(stages, stage):
    got, want = stages[stage]
    assert set(got["outputs"]) == set(want["outputs"]) != set()
    for k, w in want["outputs"].items():
        np.testing.assert_allclose(got["outputs"][k], w, atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    assert got["value"] == pytest.approx(want["value"], rel=1e-4)
    assert set(got["grads"]) == set(want["grads"]) != set()
    bad = []
    for k, w in sorted(want["grads"].items()):
        g = got["grads"][k]
        assert g.shape == w.shape, k
        err = float(np.abs(g - w).max())
        lim = 2e-3 * float(np.abs(w).max()) + 1e-6
        if err > lim:
            bad.append((k, err, lim))
    assert not bad, bad
    # the comparison is not one of zeros
    assert sum(bool(np.any(w)) for w in want["grads"].values()) \
        >= len(want["grads"]) // 2


# ------------------------------------------- (d) the input-pipeline timer

SMALL = ["--points", "2048", "--batch", "2", "--scenes", "3",
         "--batches", "2"]



@pytest.fixture(scope="module")
def pipeline_out(tmp_path_factory):
    return str(tmp_path_factory.mktemp("pipeline"))


@pytest.mark.parametrize("workers", [0, 2])
def test_input_pipeline_timer_prints_the_jax_scripts_keys(pipeline_out,
                                                          workers):
    out = subprocess.run(
        [sys.executable,
         os.path.join(SCRIPTS, "bench_input_pipeline_torch.py"), *SMALL,
         "--workers", str(workers), "--out", pipeline_out], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(result) == {*INPUT_PIPELINE_KEYS, "warmup_s"}
    assert result["metric"] == "host_input_pipeline_scenes_per_sec"
    assert (result["workers"], result["batch"], result["points"]) == (
        workers, 2, 2048)
    assert result["scenes_per_sec"] > 0 and result["warmup_s"] >= 0


def test_input_pipeline_batches_equal_the_jax_loaders(pipeline_out):
    args = parse_args([*SMALL, "--workers", "0", "--out", pipeline_out])
    got = build_loader(args)
    root = data_root(args)
    with open(os.path.join(root, "meta_data", "scannetv2_train.txt")) as f:
        ids = [line.strip() for line in f if line.strip()]
    # bench_input_pipeline.py:52-66
    scans = j_load_scans(ids, os.path.join(root, "scans"),
                         os.path.join(root, "meta_data"), num_workers=1,
                         keep_points=args.points)
    want = JDataLoader(JDataset(
        dataset_dict={"sr3d": 1}, split="train", test_dataset="sr3d",
        data_path=root, scans=scans, tokenizer=JTokenizer(max_len=32),
        use_color=True, butd=True, max_text_len=32, max_num_obj=16,
        max_det_boxes=16), batch_size=args.batch, shuffle=True, seed=0,
        num_workers=0)
    for loader in (got, want):
        loader.set_epoch(0)
    pairs = list(zip(got, want))[:2]
    assert len(pairs) == 2
    for g, w in pairs:
        assert list(g) == list(w)
        for k, wv in w.items():
            gv = g[k]
            if not isinstance(wv, np.ndarray):
                assert type(gv) is type(wv) and gv == wv, k
                continue
            assert (gv.dtype, gv.shape) == (wv.dtype, wv.shape), k
            np.testing.assert_array_equal(gv, wv, err_msg=k)
