#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: build, check, serve,
train, evaluate.

    python3 chip_smoke.py [--seed 0] [--requests 3] [--train-steps 3]
                          [--train-batch 8] [--eval-scenes 20]
                          [--report PATH]

Run from the root of a checkout, on a machine with one NVIDIA H100 (sm_90a)
and the CUDA toolkit. Phases, in order; any failure exits non-zero before
the last line is printed:

1. build: compile butd_detr_tpu_torch/csrc/*.cu with nvcc (in parallel)
   and print the seconds and ptxas's register/shared-memory report; for
   each attention kernel, forward and backward, also its spills and the
   HMMA (tensor-core) instructions in its SASS (cuobjdump -sass), which
   every kernel of the default (bf16-operand) mode must have (and the
   forward's no spill); the row gather's and the assignment's kernels'
   registers, static shared memory and spills by instantiation; FPS's
   layout per tier size: the blocks of a cloud's cluster and
   cudaOccupancyMaxActiveClusters;
2. kernels vs plain versions on the card, at the paths' shapes:
   FPS and ball query bit-equal at the 4 SA tiers (one scene, and again
   on the training batch's clouds; plus an all-zero cloud and centers
   with no neighbour), FPS timed with its us a step, the ball query with
   the kernel each tier took (the hashed grid at sa1, the index-order scan
   below) and the candidates its centers tested beside the index-order
   scan's; the grid kernel also bit-equal on clouds made to break a grid
   (points at r and r (1 +- 2^-23) across cell borders, a dense cluster
   whose centers must take the per-center guard, far outliers, NaN and
   inf, identical points, two clouds of very different extents);
   attention within its stated bound in both modes at every (Lq, Lk, Dh)
   the forward uses, with key padding and a fully masked row, timed at
   B = 1 and at the training batch with p = 0 (evaluation) and 0.1
   (training), beside SDPA at the
   same B and p; with dropout 0.1 against the plain version fed the
   kernel's own mask (which must equal the plain Philox generator's and
   keep 90 % within 4 sigma); the attention backward against its plain
   version at every shape the training forward differentiates, both
   modes, p in {0, 0.1}, a fully masked row, bit-equal between two runs,
   timed at p = 0.1 and p = 0 beside autograd through SDPA at the same
   two p; the row scatter-add
   against its plain version at every gather of a training step (real
   ball-query and 3-NN indices at the training batch), f32 and bf16, with
   dropped entries and with all rows on one index, the same bits in 5 runs
   of each, and its bits against the plain version run on the CPU
   reported shape by shape; the row gather and the
   grouped gather bit-equal (as integer views) to their plain versions at
   every shape the three paths launch them, f32 and bf16 rows, one scene
   and the batch, strided sources, int64 indices and an index out of
   range, the row gather also timed with int32 and with int64 indices
   (each read as it is; the row gather and torch.gather in turns, the
   median of three rounds, a call's ms by CUDA events over 20 calls and
   its host us on the host's clock, since a call is bound by the host;
   at the f32 backbone's sa2-sa4 groupings its device ms, CUDA events
   over 20 launches queued behind a spin kernel, beside torch.gather's
   and the bound); the grouped gather's
   MLP-input kernel (each set-abstraction tier's bf16 MLP input in one
   pass) bit-equal to its plain version with special values in the rows
   and centres, int32 and int64 indices and an index out of range, timed
   beside the chain it replaced (the copy kernel, subtract, scale,
   concatenate, cast) and the same function from PyTorch operators
   (concatenate, torch.gather, subtract, scale, concatenate, cast), its
   bound counting the index, the centres and the distinct source rows
   read once and the bf16 rows written once; the assignment kernel of the
   loss's matching (K8, csrc/assignment.cu, no Pallas counterpart)
   bit-equal to its plain version, run on the card and on the CPU, at
   the matcher call of every path that takes one (56 x (132, 256) at
   B = 8, 168 x (132, 256) at B = 24, 84 and 168 x (16, 32) in the probe
   and the study; 132 valid rows), with NaN and infinite costs and with
   every cost tied, and at n_valid = R and R + 1 (R the rows a warp
   stages in shared memory: every row staged, one read from device
   memory), its optimum scipy's within 1e-5 relative, timed (a call, and
   its device ms over 50 launches queued behind a spin kernel) beside
   scipy on the host with both copies (the port's earlier path); its plan
   at each path's (G, Q) (matrices a block, R, shared bytes, blocks
   resident an SM: every path's call in one wave, or the phase fails).
   Each is timed against
   its plain version and a library yardstick
   the port never calls (scaled_dot_product_attention and autograd through
   it, index_add_, torch.gather and the concatenate-gather-cast);
3. serving: GroundingPredictor at the full width of the SR3D butd_cls
   model (50k points, RoBERTa-base shape, 3 encoder + 6 decoder layers)
   with seeded random weights answers `--requests` synthetic requests; the
   launch counters must show 4 FPS, 4 ball-query, 51 attention, 8 row
   gather and 4 grouped gather launches per request, and no assignment;
4. card vs CPU: one request again in f32 with the precise attention mode,
   on the card and with the plain versions on the CPU (same weights):
   integer end points equal (the kps order up to f32 near-ties, see
   compare_card_cpu), floats within 1e-3 + 5e-3 * std; then the same
   request on the card in the default mode (bf16 backbone MLPs,
   bf16-operand attention), held against that f32 CPU run with the same
   near-tie protocol: backbone indices equal, every prefix's boxes
   (centres, sizes) and scores (class scores, contrastive projections)
   within 1e-2 + 2^-8 * max|CPU|, the largest error of each end-point
   group printed; and once more with `--use_bf16` (the whole model in
   bf16, K3 reading bf16 operands), every float end point within 5e-2 +
   2^-6 * max|CPU| (`bf16_mode_bound`), its centres bf16;
5. gradients, card vs CPU: the loss and every parameter's gradient of a
   small model (2 encoder + 2 decoder layers, 4096 points, 2 scenes; f32,
   precise attention, eval mode so that no dropout mask differs) computed
   on the card (forward and backward kernels) and on the CPU (plain
   versions), same weights: loss to 1e-4 relative, each gradient within
   5e-3 * max|g| + 1e-6;
6. training: `Trainer` at the same full width (dropout 0.1, bf16 backbone,
   RoBERTa frozen) takes 1 warm-up and `--train-steps` timed optimizer
   steps on synthetic batches of `--train-batch` scenes: finite losses and
   gradient norm, the text tower unchanged, and per step 4 FPS, 4 ball
   query, 51 attention, 39 attention-backward, 7 scatter-add, 9 row
   gather, 4 grouped gather and 1 assignment launches; then one step's
   `compute_hungarian_loss` under torch.cuda.set_sync_debug_mode("error"),
   which fails on any synchronisation; then one step taken twice from
   the same state and generator, and the largest parameter difference
   printed (a number: library kernels may still add with atomics);
7. evaluation: the weights of phase 6 are saved with `save_checkpoint`,
   a fresh `TrainTester` restores them (`--eval`, `--checkpoint_path`) and
   runs `evaluate_one_epoch` over `--eval-scenes` synthetic scenes in
   batches of `--train-batch` (20 and 8: two full batches and a padded
   tail of 4) at the same full width: the restored parameters equal the
   saved ones, every batch launches 4 FPS, 4 ball query, 51 attention, 8
   row gather and 4 grouped gather kernels and no backward kernel, the
   evaluator counts every scene once per prefix and mode, and every
   accuracy lies in [0, 1]. A second, warm epoch is timed (scenes/s). A
   third runs with scripts/train_test_det.sh's `--butd` in place of
   `--butd_cls`, whose batches carry the loss: per batch also 7 row
   gathers and 1 assignment;
8. the command line, as a user starts it: `make_rich_scannet` writes a
   ScanNet-format root (8 train and 8 val scenes, 5 objects each, 60,000
   points a scan), `prepare_data_torch.py --num_workers 2` builds its scan
   caches (50,000 points a scan, subsampled without replacement), and
   scripts/train_test_cls_torch.sh (torchrun and `train_torch.py` with
   the flags of scripts/train_test_cls.sh, B = 24; one process over NCCL,
   `--dp 1`) with `--max_epoch 1 --val_freq 1 --save_freq 1
   --num_workers 4` trains one epoch (40
   sr3d rows and 80 detection prompts: 5 steps), saves a checkpoint and
   evaluates the 40 val rows twice (after the epoch and at the end). Both
   processes must exit 0; every logged loss is finite, every accuracy in
   [0, 1], and the epochs' `epoch stats` lines give the launches (per step
   and per batch those of phases 6 and 7), the scenes/s, the share of the
   epoch spent waiting on the loader and the peak memory, printed beside
   the card's name and power limit. From the checkpoint it wrote, on the
   same root: `predict_torch.py` grounds one request on a val scan as a
   child process (its JSON parsed, its 10 boxes and scores finite; its
   wall seconds) and again in this process through `predict_torch.main`
   (the launch counts, a request's kernels, read around that call; the
   child's answer), both equal to an in-process
   `GroundingPredictor.from_checkpoint(...).predict` on the same scan,
   then once more in this process with `--use_bf16` (the f32 checkpoint
   into the bf16-compute model: a request's launches, a finite answer),
   and `train_torch.py --eval --test_dataset scannet --checkpoint_path`
   runs the detection evaluation on the 18-class prompt over the 8 val
   scenes (mAP and AR in [0, 1] at 0.25 and 0.5, an evaluation batch's
   launches, the scenes/s, the projection/NMS/AP host seconds and the
   end points' copy to the host printed);
9. the overfit probe: `scripts/overfit_probe_torch.py` with the JAX
   package's jax_b12_nt32 invocation (12 fixed samples of a
   `make_rich_scannet` root of 24 + 8 scenes at 20,000 points, 5,000
   points a cloud, the 4-layer 128-d text tower started from
   studies/attrib_r5/text_init.npz and trained, 32 queries, eos 0.02,
   220 steps, a probe every 15) as a child process; each probe row is
   printed beside the JAX row of the same step. Fails unless every value
   is finite, `last_matched_ce` at step 220 is below 0.75 x its step-0
   value, and every step and probe forward launched the worked-out counts
   (a step: K1 4, K2 4, K3 43, K4 43, K5 13, K6 15, K7 4, K8 1; a probe:
   K1 4, K2 4, K3 43, K6 8, K7 4);
10. a study resumed: `scripts/accuracy_study_torch.py` with the nt32
   study's flags (studies/cls_r5_nt32/invocation.json) cut to the same 24
   + 8 scenes and 2 epochs, evaluated each epoch, epoch 1 in one process
   and epoch 2 in a second that `--resume`s its checkpoint. Fails unless
   both exit 0, the history has rows at epochs 1 and 2 with the step
   count continuing, every accuracy lies in [0, 1], every logged loss is
   finite and every step and evaluation batch launched the counts of
   phase 9 (the text at 128 tokens);
11. `--use_bf16` beside the default mode, in one process (run after
   phase 7): for each mode 3 warm requests and 2 training steps at
   `--train-batch` at full width, with the same weights: the medians, the
   device-busy ms of a request and a step by group (matrix products,
   attention kernels, the rest; torch.profiler) and the peak memory,
   printed beside the card's name and power limit. The bf16 requests and
   steps must launch the counts of phases 3 and 6, their losses be
   finite, the parameters f32, and the bf16 loss must not synchronise.
12. training across processes (run last):
   (a) `--dp 2`: two ranks spawned on the one card and joined over gloo
   (NCCL refuses two ranks on one device), half the batch each, beside one
   process at the whole batch: phase 5's small model's eval-mode
   gradients, averaged over the ranks, within 5e-3 * max|g| + 1e-6 of the
   one process's; then two full-width steps in strict f32 without dropout:
   each rank launches the one process's step counts, finite losses, and
   the BatchNorm buffers after one step within 1e-4 * max(|buffer|, 1) of
   the one process's (all of them where the kps selections agree, else
   those before the selection, phase 4's near-tie protocol); each rank's
   step ms and peak memory beside the one process's. (b) `--mp 2`: two
   ranks' forward of one request (f32, precise) against the one process's
   with phase 4's bound and near-tie protocol, K3 on 4 of the 8 heads in
   the encoder and decoder and on RoBERTa's 12 (one spawned world of two
   for both meshes). (c) phase 8's `train_torch.py` run starts under
   torchrun (scripts/train_test_cls_torch.sh, `NPROC_PER_NODE=1 ... --dp
   1`) over NCCL, world size 1: its log must name the backend. (d) one
   `--use_multiview` training step at
   `--train-batch` (128 features a point from an array, so that the step
   needs no `h5py`): a step's launches, and K7's MLP input at sa1's 131 channels
   bit-equal to its plain version, timed beside its bound and the
   `torch.gather` chain. (e) `--profile_dir` on a short training epoch
   (3 steps at `--train-batch`, 2 traced): the window's log line, a
   step's launches, and every port kernel named in the trace.
13. the text side (run after phase 12): K3 and K4 at the text paths'
   shapes, against their plain versions fed the kernel's own dropout mask
   and timed beside SDPA and autograd through it: the span step's (128,
   12, 128, 64) at p = 0.1, its scoring batch's at p = 0, the class
   table's (64, 12, 16, 64) and the text pretraining's (64, 4, 32, 32,
   precise); then (a) the span predictor at full width (RoBERTa-base, B
   128, L 128, lr 1e-4, dropout 0.1, the default attention mode) on a
   text-only root this phase writes (1,280 train and 256 test sr3d rows
   "the <class> <relation> the <anchor>"): 1 warm and 30 timed steps, ms
   a step and peak memory, every loss finite and the last below 0.75 x
   the first, K3 and K4 12 launches a step and nothing else, one batch's
   eval-mode logits on the card within 1e-2 + 2^-8 * max|CPU| of the f32
   CPU run, and one f32 training step on 32 of the batch's rows
   (attention dropout 0.1, no elementwise dropout) whose loss and
   gradients lie within 1e-4 and 5e-3 * max|g| + 1e-6 of the CPU's; (b) `span_cls_torch.py` on that root
   (1 epoch, then `--eval` and `--store`), its main in this process with
   the launches read around each run, and the port's grounding dataset
   reading the stored `sr3d_pred_spans.json` (each row's `pred_pos_map`
   the stored span); (c) `gen_class_embeddings_torch.py --params` on a
   seeded RoBERTa-base state dict, its main in this process (96 K3
   launches): a finite (485, 768) table equal to the function's, loaded
   through `init_class_embeddings`; (d) `scripts/pretrain_text_torch.py
   --steps 50` in this process: the cross-entropy at step 49 below step
   0's, its npz loaded through `load_text_init`; (e) `PointnetSAModuleMSG`
   at B 4 on 50,000 x 6 points (npoint 2,048, three radii), a `GroupAll`
   module and `PointnetLFPModuleMSG`, forward and backward, against the
   CPU (indices equal, floats and gradients within 5e-3 * max + 1e-6),
   with the launches by kernel; (f) `demo_torch.py`, its main in this
   process (every kernel launched), prints `[demo] OK`; then the entry
   points of (b), (c) and (f) as five child processes side by side (their
   wall seconds), with the same accuracy, spans and table as in process
   and `[demo] OK`. Each part's seconds are printed.
14. the host runtime (butd_detr_tpu_torch/native.py, the port's
   copy of the JAX package's host C++, built with g++ at first use): the
   compiler, a fresh build's seconds, the `-march` it resolved and the
   host CPU; (a) `augment_pointcloud` on a 50,000-point f32 cloud with
   colour, the fused pass within 1e-6 x max|plain| of the numpy passes
   (4 seeds), the median ms of each; (b) `read_ply` on every PLY of
   phase 8's root, the C++ columns bit-equal to the Python parser's,
   ms a scan of each; (c) the same-class NMS on 32 scenes x 256 boxes
   with distinct scores, keep lists equal to numpy's, and on three tied
   equal boxes the highest index kept, ms of each; (d) `eval_det` at 0.25
   and 0.5 on the kept boxes, recall, precision and every AP equal to the
   numpy loop's, seconds of each; (e) phase 8's detection epoch ran the
   NMS (once a scene) and the VOC matcher in the host C++: its
   `detection_seconds`; (f) `scripts/train_split_eval_torch.py` as a
   child on phase 10's study: one row per checkpoint, every accuracy in
   [0, 1], the last row equal to an in-process `evaluate_one_epoch` of
   the same weights (and the study's own row of that epoch printed
   beside it).
15. the JAX package's last tools, each a child process (run last): (a)
   scripts/train_test_det_torch.sh (`--butd --augment_det`) trains one
   epoch on phase 8's root with `--max_epoch 1 --val_freq 2 --num_workers
   4` and evaluates it once, at the run's end: its config must be the
   setup's, its epochs train then eval, every logged loss finite, and
   every step and evaluation
   batch (with the loss) must launch the worked-out counts; (b)
   scripts/bench_backward_torch.py at full width, B = 24, BENCH_REPS=3:
   its JSON (printed on one line) must hold every key of
   scripts/bench_backward.py, each `_fwd`/`_fwdbwd` entry and its
   `_device_ms` finite and positive; (c)
   scripts/bench_input_pipeline_torch.py at 50,000 points, B = 24, 10
   timed batches, a worker a host CPU: its JSON line. The phase's seconds
   are printed.
Phase 2 also holds K1, K2, K6 and K7 bit-equal, and K3 and K4 within
their bounds (p = 0 and 0.1, both modes), at the shapes of phases 9 and
10: B = 12 at 5,000 points and B = 24 at 20,000, the small text tower's
4 heads of Dh 32 at L 32 and 128 with key padding, 32 queries. For
`--use_bf16` it holds K3 and K4 with bf16 operands bit-equal to the same
kernels fed f32 operands of the same values, at every shape of a request
and of a B = 8 step, p = 0 and 0.1, timed beside them, and K6 and K5 at
the bf16 model's rows (xyz C 3, boxes C 6, features C 288) bit-equal to
their plain versions.

Prints the whole run's wall time, the `kernels` JSON line, the card's
name and power limit, and last
`{"ok": true, "device": {...}}`. `--report PATH` also writes a fuller JSON
report (per-tier and per-shape times, latencies, the card-vs-CPU errors).
"""

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 (CUDA cores) and
# dense bf16 tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


_T0 = time.perf_counter()


def log(*a):
    if a and str(a[0]).startswith("== phase"):  # the run's clock, by phase
        a = (f"[{time.perf_counter() - _T0:.0f} s]", *a)
    print(*a, flush=True)


# ------------------------------------------------------------- scenes

REQUESTS = [
    ("the chair next to the wooden table", "chair"),
    ("find the lamp that is on the desk", "lamp"),
    ("the sofa facing the window", "sofa"),
    ("the cabinet beside the door", "cabinet"),
    ("the bed under the shelf", "bed"),
]


def make_scene(rng, n_points=80_000, n_objects=12):
    """A synthetic room: floor and walls plus box-shaped objects, xyz in
    metres and rgb in [0, 1]; returns the (N, 6) cloud, the objects'
    (D, 6) cxcyczwhd boxes and their class ids."""
    import numpy as np

    size = np.array([6.0, 5.0, 3.0])
    centers = rng.uniform([0.5, 0.5, 0.3], size - [0.5, 0.5, 1.5],
                          (n_objects, 3))
    dims = rng.uniform(0.3, 1.2, (n_objects, 3))
    n_obj = n_points // 2
    which = rng.randint(0, n_objects, n_obj)
    obj = centers[which] + (rng.rand(n_obj, 3) - 0.5) * dims[which]
    n_room = n_points - n_obj
    room = rng.rand(n_room, 3) * size
    face = rng.randint(0, 3, n_room)
    room[face == 0, 2] = 0.0  # floor
    room[face == 1, 0] = 0.0  # wall
    room[face == 2, 1] = 0.0  # wall
    xyz = np.concatenate([obj, room])
    rgb = np.concatenate([rng.rand(n_objects, 3)[which] * 0.8 + 0.1,
                          np.full((n_room, 3), 0.6)])
    rgb += rng.normal(0, 0.03, rgb.shape)
    cloud = np.concatenate([xyz, np.clip(rgb, 0, 1)], 1).astype(np.float32)
    boxes = np.concatenate([centers, dims], 1).astype(np.float32)
    class_ids = rng.randint(0, 485, n_objects)
    return cloud[rng.permutation(len(cloud))], boxes, class_ids


# ------------------------------------------------------------- timing

def time_ms(fn, reps, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(fn, reps, rounds=3):
    """The median of `rounds` runs of time_ms: a call bound by the host
    meets the host's hiccups, which one run alone would keep."""
    return sorted(time_ms(fn, reps) for _ in range(rounds))[rounds // 2]


def device_ms(fn, reps):
    """Device ms a call of `fn`: `reps` calls queued behind a spin kernel
    (`torch.cuda._sleep`) that holds the stream until they are all queued,
    timed by two CUDA events around them, so the host's time a call does
    not enter it. Raises if the host took longer to queue them than the
    spin held the stream."""
    import torch

    fn()
    torch.cuda.synchronize()
    held = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    held.record()
    torch.cuda._sleep(int(4e6))  # ~2 ms at the card's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    if queued_ms >= held.elapsed_time(start):
        raise SmokeFailure(f"the host queued {reps} calls in "
                           f"{queued_ms:.2f} ms, longer than the spin held "
                           "the stream")
    return start.elapsed_time(end) / reps


def host_us(fn, calls=200):
    """Host µs a call of `fn`: `calls` back-to-back calls from a
    synchronized start, on the host's clock, not waiting for the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def bound_ms(nbytes, ops_by_rate):
    """Least time: the larger of bytes over HBM rate and the operations
    over their type's peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / rate for n, rate in ops_by_rate)
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by


# ------------------------------------------------------------- phase 1

def _cuobjdump():
    """The toolkit's cuobjdump, or None."""
    import shutil

    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    return cand if os.path.exists(cand) else shutil.which("cuobjdump")


def _short_name(mangled):
    """attention_bwd_dq_mma_kernel<48, 1, bf16> from its mangled name (the
    operand type of the mma kernels last: f32 or bf16)."""
    import re

    m = re.search(r"\d+(attention_\w+?_kernel)I(\w*?)EEv", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[ib](\d+)E", m.group(2) + "E")
    if "bfloat16" in m.group(2):
        args.append("bf16")
    elif m.group(2).endswith("Ef"):
        args.append("f32")
    return f"{m.group(1)}<{', '.join(args)}>"


def _ptxas_report(lib_name):
    """{mangled kernel: registers, static shared bytes, spill stores and
    loads} from ptxas's -v lines in the build log of csrc/<lib_name>.cu."""
    import re

    from butd_detr_tpu_torch.ops import _cuda

    funcs, cur = {}, None
    for line in _cuda.build_log(lib_name).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["smem_bytes"] = int(m.group(1))
    check(len(funcs) > 0, f"{lib_name}: no ptxas report in the build log")
    return funcs


def tile_kernel_resources(lib_name):
    """The row gather's and the assignment's kernels, one line each:
    ptxas's registers, static shared memory and spills by instantiation
    (the dynamic shared memory a launch takes is planned per call)."""
    import re

    out = {}
    for mangled, res in _ptxas_report(lib_name).items():
        m = re.search(r"\d+((?:gather|assignment)\w*?_kernel)I(\w*?)EEv",
                      mangled)
        if m:  # <the literals, then int32 or int64>: the index or counts
            args = re.findall(r"L[ib](\d+)E", m.group(2) + "E")
            kind = re.sub(r"L[ib]\d+E", "", m.group(2))
            args.append("int32" if kind == "i" else "int64")
            name = f"{m.group(1)}<{', '.join(args)}>"
        else:
            name = mangled
        out[name] = res
        log(f"  [{lib_name}] {name}: {res.get('registers')} registers, "
            f"{res.get('smem_bytes')} B static smem, spills "
            f"{res.get('spill_stores')}/{res.get('spill_loads')} B")
    return out


def attention_resources(lib_name):
    """Per kernel function of csrc/<lib_name>.cu (the attention forward or
    backward): ptxas's registers, shared memory and spills (from the build
    log) and the HMMA (tensor-core mma) instructions in its SASS (cuobjdump
    -sass, where the toolkit has it). Fails if a default-mode (mma) kernel
    has no HMMA, or if one of the forward's spills."""
    import re

    from butd_detr_tpu_torch.ops import _cuda

    funcs = _ptxas_report(lib_name)
    tool = _cuobjdump()
    if tool:
        sass = subprocess.run([tool, "-sass",
                               str(_cuda._lib_path(lib_name))],
                              capture_output=True, text=True, timeout=300)
        check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr[-500:]}")
        cur = None
        for line in sass.stdout.splitlines():
            m = re.search(r"Function : (\w+)", line)
            if m:
                cur = funcs.setdefault(m.group(1), {})
                cur["hmma"] = 0
            elif cur is not None and "HMMA" in line:
                cur["hmma"] += 1
    lib = _cuda.lib(lib_name)
    smem_bytes = lib.attention_bwd_smem_bytes if lib_name == "attention_bwd" \
        else lib.attention_fwd_smem_bytes
    out = {}
    for mangled, res in funcs.items():
        name = _short_name(mangled)
        out[name] = res
        if "_mma_kernel<" in name:  # dynamic shared memory, by head dim
            res["smem_bytes"] = smem_bytes(               # and operand type
                int(name.split("<")[1].split(",")[0]), int("bf16" in name))
        if lib_name == "attention" and "_mma_kernel" in name:
            check(res.get("spill_stores", 0) == 0
                  and res.get("spill_loads", 0) == 0,
                  f"{name}: spills registers")
        if tool and "_mma_kernel" in name:
            check(res.get("hmma", 0) > 0,
                  f"{name}: no HMMA instruction in its SASS")
        log(f"  [{lib_name}] {name}: {res.get('registers')} registers, "
            f"{res.get('smem_bytes')} B smem, spills "
            f"{res.get('spill_stores')}/{res.get('spill_loads')} B, HMMA "
            f"{res.get('hmma', 'not read (no cuobjdump)')}")
    return dict(cuobjdump=tool, kernels=out)


def fps_plan(sizes):
    """K1's layout for each cloud size: the blocks a cloud takes (a
    cluster, or 1) and how many such clusters can be resident at once
    (cudaOccupancyMaxActiveClusters): a batch of more clouds than that
    runs in waves."""
    from butd_detr_tpu_torch.ops import _cuda

    lib = _cuda.lib("fps")
    out = []
    for n in sizes:
        plan = dict(n=n, cluster=lib.fps_cluster_size(n),
                    max_active=lib.fps_max_active_clusters(0, n))
        check(plan["max_active"] > 0,
              f"fps at N={n}: no cluster can be resident "
              f"({plan['max_active']})")
        out.append(plan)
        log(f"  [fps] N={n}: {plan['cluster']} block(s) a cloud, at most "
            f"{plan['max_active']} such resident at once")
    return out


# ------------------------------------------------------------- phase 2

def sa_tiers(cloud_xyz, cfg_npoints, radii, nsamples):
    """The (xyz, npoint, radius, nsample) each SA layer gives FPS and ball
    query in one forward: xyz of tier i+1 is tier i's FPS sample."""
    from butd_detr_tpu_torch.ops import furthest_point_sample, gather_points

    tiers, xyz = [], cloud_xyz
    for npoint, r, ns in zip(cfg_npoints, radii, nsamples):
        inds = furthest_point_sample(xyz, npoint)
        new_xyz = gather_points(xyz, inds)
        tiers.append((xyz, new_xyz, npoint, r, ns))
        xyz = new_xyz
    return tiers


def scanned_candidates(xyz, centers, radius, nsample):
    """Candidates the ball query must test on this data: each center scans
    in index order up to its nsample-th hit (all N without one)."""
    import numpy as np
    import torch

    r2 = float(np.float32(radius * radius))
    N = xyz.shape[1]
    total = 0
    for c0 in range(0, centers.shape[1], 256):
        c = centers[:, c0:c0 + 256]
        dx = c[:, :, None, 0] - xyz[:, None, :, 0]
        dy = c[:, :, None, 1] - xyz[:, None, :, 1]
        dz = c[:, :, None, 2] - xyz[:, None, :, 2]
        d = (dx * dx + dy * dy) + dz * dz
        cnt = torch.cumsum((d < r2).int(), -1)
        full = cnt[..., -1] >= nsample
        pos = torch.argmax((cnt >= nsample).int(), -1) + 1
        total += int(torch.where(full, pos, torch.full_like(pos, N)).sum())
    return total


def ball_query_tier(r, ns, xyz, new_xyz, want):
    """K2 once through `ball_query_stats`, held bit-equal to `want` (the
    plain version): the kernel it took ("grid" or "scan"), the candidates
    its centers tested, how many took the grid's guard, and the candidates
    the index-order scan would test on this data (information only)."""
    import torch

    from butd_detr_tpu_torch.ops import ball_query_stats

    got, stats, path = ball_query_stats(r, ns, xyz, new_xyz)
    B, N = xyz.shape[:2]
    check(torch.equal(got, want),
          f"ball query kernel ({path}) != plain at B={B}, N={N}")
    return dict(path=path, tested=int(stats[..., 0].sum()),
                guards=int(stats[..., 1].sum()),
                scanned=scanned_candidates(xyz, new_xyz, r, ns))


def grid_breaking_cloud(kind, r=0.2, n=50_000):
    """(xyz (2, n, 3), centers (2, m, 3)) CPU tensors made to break a hashed
    grid of cells a little larger than r (csrc/ball_query.cu):
      uniform:   points in a 4 m cube;
      at_radius: centers on cell borders, points at r, r (1 +- 2^-23) and
                 r (1 +- 2^-22) from them along each axis, both signs;
      dense:     4000 points in a 5 cm cube, its points as centers: more
                 hits than a warp holds, so the per-center guard;
      outliers:  |x| ~ 1e7, NaN and +-inf coordinates, as points and
                 centers;
      identical: every point the same;
      extents:   one cloud of 0.5 m, one of 100 m."""
    import numpy as np
    import torch

    rng = np.random.RandomState(len(kind))
    xyz = (rng.rand(2, n, 3) * 4).astype(np.float32)
    cen = xyz[:, ::400].copy()
    if kind == "at_radius":
        edge = r * (1 + 2 ** -10)
        cen = np.zeros((2, 128, 3), np.float32)
        cen[:, :, 0] = np.arange(128) * edge
        cen[1, :, 1] = 1.0 + np.arange(128) * edge * 0.5
        k = 0
        for j in range(128):
            for f in (1.0, 1 - 2 ** -23, 1 + 2 ** -23, 1 - 2 ** -22,
                      1 + 2 ** -22):
                for ax in range(3):
                    for sgn in (1.0, -1.0):
                        q = cen[:, j].astype(np.float64)
                        q[:, ax] += sgn * r * f
                        xyz[:, k] = q.astype(np.float32)
                        k += 1
    elif kind == "dense":
        xyz[:, :4000] = rng.rand(2, 4000, 3) * 0.05 + 1.0
        cen = np.concatenate([xyz[:, :64], cen], 1)
    elif kind == "outliers":
        xyz[:, :64] *= 1e7
        xyz[:, 64:80] = np.nan
        xyz[:, 80:90, 1] = np.inf
        xyz[:, 90:100, 2] = -np.inf
        xyz[:, 100, 0] = np.nan
        cen = np.concatenate([xyz[:, :128], cen], 1)
    elif kind == "identical":
        xyz[:] = 1.5
        cen = xyz[:, :64].copy()
    elif kind == "extents":
        xyz[0] *= 0.125
        xyz[1] *= 25.0
        cen = xyz[:, ::400].copy()
    return torch.from_numpy(xyz), torch.from_numpy(np.ascontiguousarray(cen))


GRID_CLOUDS = ("uniform", "at_radius", "dense", "outliers", "identical",
               "extents")


def check_ball_query_grid():
    """K2's grid kernel at sa1's shape (50000 points, r = 0.2, 64 samples)
    on every cloud of `grid_breaking_cloud`: bit-equal to the plain
    version, and the dense clouds send at least one center through the
    per-center guard."""
    from butd_detr_tpu_torch.ops import ball_query_plain

    out = {}
    for kind in GRID_CLOUDS:
        xyz, cen = grid_breaking_cloud(kind)
        want = ball_query_plain(0.2, 64, xyz, cen).cuda()
        res = ball_query_tier(0.2, 64, xyz.cuda(), cen.cuda(), want)
        check(res["path"] == "grid", f"{kind}: took the {res['path']} path")
        if kind in ("dense", "identical"):
            check(res["guards"] > 0, f"{kind}: no center took the guard")
        out[kind] = res
        log(f"  ball query grid, {kind} clouds: equal; {res['tested']} "
            f"candidates tested (index-order scan {res['scanned']}), "
            f"{res['guards']} of {cen.shape[0] * cen.shape[1]} centers "
            f"guarded")
    return out


def check_point_kernels(tiers):
    import torch

    from butd_detr_tpu_torch.ops import (
        ball_query,
        ball_query_plain,
        furthest_point_sample,
        furthest_point_sample_plain,
    )

    fps_row = dict(name="fps", ms=0.0, plain_ms=0.0, bound_ms=0.0,
                   max_abs_err=0, tiers=[])
    bq_row = dict(name="ball_query", ms=0.0, plain_ms=0.0, bound_ms=0.0,
                  max_abs_err=0, tiers=[])
    for xyz, new_xyz, npoint, r, ns in tiers:
        N = xyz.shape[1]
        got = furthest_point_sample(xyz, npoint)
        want = furthest_point_sample_plain(xyz, npoint)
        check(torch.equal(got, want), f"FPS kernel != plain at N={N}")
        ms = time_ms(lambda: furthest_point_sample(xyz, npoint), 5)
        pms = time_ms(lambda: furthest_point_sample_plain(xyz, npoint), 2)
        # per step: 3 sub, 3 mul, 2 add, 1 min, 1 compare per point
        b_ms, by = bound_ms(N * 12 + npoint * 4,
                            [(10 * N * (npoint - 1), F32_OPS_PER_S)])
        steps = max(npoint - 1, 1)
        fps_row["tiers"].append(dict(n=N, npoint=npoint, ms=ms, plain_ms=pms,
                                     bound_ms=b_ms, bound_by=by,
                                     us_per_step=ms * 1e3 / steps,
                                     bound_us_per_step=b_ms * 1e3 / steps))
        fps_row["ms"] += ms
        fps_row["plain_ms"] += pms
        fps_row["bound_ms"] += b_ms

        m = new_xyz.shape[1]
        want = ball_query_plain(r, ns, xyz, new_xyz)
        tier = ball_query_tier(r, ns, xyz, new_xyz, want)
        ms = time_ms(lambda: ball_query(r, ns, xyz, new_xyz), 10)
        pms = time_ms(lambda: ball_query_plain(r, ns, xyz, new_xyz), 2)
        # the function's bytes, whatever implements it: points and centres
        # read once, the indices written once
        b_ms, by = bound_ms(N * 12 + m * 12 + m * ns * 4, [])
        tier.update(n=N, m=m, radius=r, nsample=ns, ms=ms, plain_ms=pms,
                    bound_ms=b_ms, bound_by=by)
        bq_row["tiers"].append(tier)
        bq_row["ms"] += ms
        bq_row["plain_ms"] += pms
        bq_row["bound_ms"] += b_ms
        f, q = fps_row["tiers"][-1], bq_row["tiers"][-1]
        log(f"  N={N:6d} -> {npoint:5d}: fps {f['ms']:.3f} ms = "
            f"{f['us_per_step']:.3f} us a step (plain {f['plain_ms']:.1f}, "
            f"bound {f['bound_ms']:.4f}), ball query "
            f"r={r} ns={ns} {q['path']} {q['ms']:.3f} ms (plain "
            f"{q['plain_ms']:.2f}, bound {q['bound_ms']:.4f}; "
            f"{q['tested']} candidates tested, the index-order scan's "
            f"{q['scanned']}; {q['guards']} guarded): equal")

    # degenerate inputs: an all-zero cloud, centers with no neighbour
    zeros = torch.zeros_like(tiers[0][0])
    got = furthest_point_sample(zeros, tiers[0][2])
    check(int(got.abs().max()) == 0,
          "FPS of an all-zero cloud is not all zeros")
    check(torch.equal(got, furthest_point_sample_plain(zeros, tiers[0][2])),
          "FPS kernel != plain on an all-zero cloud")
    xyz, new_xyz, _, r, ns = tiers[0]
    far = new_xyz.clone()
    far[:, ::7] += 100.0
    got = ball_query(r, ns, xyz, far)
    check(torch.equal(got, ball_query_plain(r, ns, xyz, far)),
          "ball query kernel != plain with empty balls")
    check(int(got[:, ::7].abs().max()) == 0, "an empty ball is not all 0")
    for row in (fps_row, bq_row):
        row["bound_by"] = "operations" if all(
            t["bound_by"] == "operations" for t in row["tiers"]) else "bytes"
    bq_row["paths"] = [t["path"] for t in bq_row["tiers"]]
    bq_row["candidates_tested"] = sum(t["tested"] for t in bq_row["tiers"])
    bq_row["candidates_index_order_scan"] = sum(t["scanned"]
                                                for t in bq_row["tiers"])
    return fps_row, bq_row


def check_point_kernels_batched(tiers, fps_row, bq_row):
    """K1 and K2 once more on the training batch's clouds (B scenes, one
    block or warp set per scene): bit-equal to the plain versions, and
    timed (`training_ms`, the 4 tiers of one step)."""
    import torch

    from butd_detr_tpu_torch.ops import (
        ball_query,
        ball_query_plain,
        furthest_point_sample,
        furthest_point_sample_plain,
    )

    fps_row["training_ms"] = bq_row["training_ms"] = 0.0
    for i, (xyz, new_xyz, npoint, r, ns) in enumerate(tiers):
        B, N = xyz.shape[:2]
        check(torch.equal(furthest_point_sample(xyz, npoint),
                          furthest_point_sample_plain(xyz, npoint)),
              f"FPS kernel != plain at B={B}, N={N}")
        tier = ball_query_tier(r, ns, xyz, new_xyz,
                               ball_query_plain(r, ns, xyz, new_xyz))
        ms = time_ms(lambda: ball_query(r, ns, xyz, new_xyz), 5)
        tier["ms"] = ms
        bq_row["tiers"][i]["training"] = tier
        bq_row["training_ms"] += ms
        ms = time_ms(lambda: furthest_point_sample(xyz, npoint), 3)
        tier = fps_row["tiers"][i]
        tier["training_ms"] = ms
        tier["training_us_per_step"] = ms * 1e3 / max(npoint - 1, 1)
        fps_row["training_ms"] += ms
    per_step = ", ".join(f"{t['training_us_per_step']:.3f}"
                         for t in fps_row["tiers"])
    paths = ", ".join(
        f"{t['training']['path']} {t['training']['ms']:.3f} ms "
        f"({t['training']['tested']} tested, scan {t['training']['scanned']}"
        f", {t['training']['guards']} guarded)" for t in bq_row["tiers"])
    log(f"  B={tiers[0][0].shape[0]} (training batch), 4 tiers: fps "
        f"{fps_row['training_ms']:.3f} ms ({per_step} us a step), ball query "
        f"{bq_row['training_ms']:.3f} ms ({paths}): equal")


def attention_shapes(cfg, roberta, npoints):
    """(name, H, Lq, Lk, Dh, key-padding kind, launches per request) for
    every attention of the serving forward."""
    d, H = 288, 8
    Dh = d // H
    T, V, Q, G = cfg.max_text_len, npoints[1], cfg.num_target, \
        cfg.max_det_boxes
    rh = roberta.num_attention_heads
    return [
        ("roberta_self", rh, T, T, roberta.hidden_size // rh, "text",
         roberta.num_hidden_layers),
        ("enc_visual_self", H, V, V, Dh, "none", cfg.num_encoder_layers),
        ("enc_text_self", H, T, T, Dh, "text", cfg.num_encoder_layers),
        ("enc_text_to_visual", H, T, V, Dh, "none", cfg.num_encoder_layers),
        ("enc_visual_to_text", H, V, T, Dh, "text", cfg.num_encoder_layers),
        ("enc_visual_to_boxes", H, V, G, Dh, "boxes",
         cfg.num_encoder_layers),
        ("dec_self", H, Q, Q, Dh, "none", cfg.num_decoder_layers),
        ("dec_to_text", H, Q, T, Dh, "text", cfg.num_decoder_layers),
        ("dec_to_boxes", H, Q, G, Dh, "boxes", cfg.num_decoder_layers),
        ("dec_to_visual", H, Q, V, Dh, "none", cfg.num_decoder_layers),
    ]


def check_attention(shapes, gen, batch, seed):
    """K3 against attention_plain at every shape of the forward (both
    modes), timed at B = 1 in the serving mode, and at the batch of
    training and evaluation at p = 0 and p = 0.1, each beside SDPA at the
    same B and p."""
    import torch
    import torch.nn.functional as F

    from butd_detr_tpu_torch.ops import attention, attention_plain

    # f32 mode: reassociation only. bf16 mode: P is rounded to bf16 after
    # an f32 sum whose order differs, so one entry may move a bf16 step
    # (2^-8 relative): bounded by 4e-3 at |V| ~ 1.
    tol = {True: (2e-5, 1e-4), False: (4e-3, 4e-3)}
    row = dict(name="attention", ms=0.0, plain_ms=0.0, bound_ms=0.0,
               library_ms=0.0, training_ms=0.0, library_training_ms=0.0,
               evaluation_ms=0.0, library_evaluation_ms=0.0,
               max_abs_err=0.0, shapes=[])
    worst = {True: 0.0, False: 0.0}

    def inputs(B, H, Lq, Lk, Dh, pad_kind, fully_masked):
        # (B, L, H, Dh) projections viewed as (B, H, L, Dh), as the MHA
        # hands them to the kernel
        q, k, v = (torch.randn(B, L, H, Dh, device="cuda",
                               generator=gen).transpose(1, 2)
                   for L in (Lq, Lk, Lk))
        pad = torch.zeros(B, Lk, dtype=torch.bool, device="cuda")
        if pad_kind == "text":
            pad[:, 14:] = True  # a 12-word utterance + bos/eos
        elif pad_kind == "boxes":
            pad[:, 12:] = True  # 12 detected boxes
        if fully_masked:
            pad[-1] = True
        return q, k, v, pad

    # the two named checks: key padding and one fully masked batch row
    for H, L, Dh in ((8, 1024, 36), (12, 128, 64)):
        q, k, v, pad = inputs(2, H, L, L, Dh, "text", True)
        for precise in (True, False):
            got = attention(q, k, v, pad, sm_scale=Dh ** -0.5,
                            precise=precise)
            want = attention_plain(q, k, v, pad, sm_scale=Dh ** -0.5,
                                   precise=precise)
            err = (got - want).abs().max().item()
            atol, rtol = tol[precise]
            check(torch.allclose(got, want, atol=atol, rtol=rtol),
                  f"attention L={L} Dh={Dh} precise={precise}: "
                  f"max err {err}")
            worst[precise] = max(worst[precise], err)
            if precise:
                uniform = v[-1].mean(dim=1, keepdim=True).expand_as(got[-1])
                check(torch.allclose(got[-1], uniform, atol=atol),
                      "a fully masked row is not uniform over its keys")

    for name, H, Lq, Lk, Dh, pad_kind, per_req in shapes:
        q, k, v, pad = inputs(1, H, Lq, Lk, Dh, pad_kind, False)
        scale = Dh ** -0.5
        for precise in (True, False):
            got = attention(q, k, v, pad, sm_scale=scale, precise=precise)
            want = attention_plain(q, k, v, pad, sm_scale=scale,
                                   precise=precise)
            atol, rtol = tol[precise]
            err = (got - want).abs().max().item()
            check(torch.allclose(got, want, atol=atol, rtol=rtol),
                  f"attention {name} precise={precise}: max err {err}")
            worst[precise] = max(worst[precise], err)
        # timed in the serving mode (bf16 operands, f32 accumulation)
        ms = time_ms(lambda: attention(q, k, v, pad, sm_scale=scale), 20)
        pms = time_ms(lambda: attention_plain(q, k, v, pad, sm_scale=scale),
                      20)
        amask = ~pad[:, None, None, :]
        lms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=amask, scale=scale), 20)
        pairs = H * Lq * Lk
        nbytes = 4 * H * Dh * (2 * Lq + 2 * Lk) + Lk
        b_ms, by = bound_ms(nbytes, [(4 * pairs * Dh, BF16_OPS_PER_S),
                                     (5 * pairs, F32_OPS_PER_S)])
        # at the batch of training and evaluation: p = 0 (evaluation, and
        # the frozen text tower in training) and p = 0.1 (training)
        qb, kb, vb, padb = inputs(batch, H, Lq, Lk, Dh, pad_kind, False)
        amask = ~padb[:, None, None, :]
        at_b, sdpa_b = {}, {}
        for p in (0.0, 0.1):
            at_b[p] = time_ms(lambda: attention(
                qb, kb, vb, padb, sm_scale=scale, dropout_p=p, seed=seed), 10)
            sdpa_b[p] = time_ms(lambda: F.scaled_dot_product_attention(
                qb, kb, vb, attn_mask=amask, scale=scale, dropout_p=p), 10)
        del qb, kb, vb, padb, amask
        p_train = 0.0 if name == "roberta_self" else 0.1
        row["shapes"].append(dict(
            name=name, H=H, Lq=Lq, Lk=Lk, Dh=Dh, per_request=per_req, ms=ms,
            plain_ms=pms, library_ms=lms, bound_ms=b_ms, bound_by=by,
            batch=batch, batch_ms_p0=at_b[0.0], batch_ms_p01=at_b[0.1],
            library_batch_ms_p0=sdpa_b[0.0],
            library_batch_ms_p01=sdpa_b[0.1]))
        for key, val in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                         ("bound_ms", b_ms), ("evaluation_ms", at_b[0.0]),
                         ("library_evaluation_ms", sdpa_b[0.0]),
                         ("training_ms", at_b[p_train]),
                         ("library_training_ms", sdpa_b[p_train])):
            row[key] += per_req * val
        log(f"  {name:20s} H={H:2d} Lq={Lq:4d} Lk={Lk:4d} Dh={Dh}: "
            f"{ms:.3f} ms (plain {pms:.3f}, sdpa {lms:.3f}, bound "
            f"{b_ms:.4f} by {by}); B={batch} p = 0 {at_b[0.0]:.3f} (sdpa "
            f"{sdpa_b[0.0]:.3f}), p = 0.1 {at_b[0.1]:.3f} (sdpa "
            f"{sdpa_b[0.1]:.3f}) x{per_req}")
    row["max_abs_err"] = worst[False]
    row["max_abs_err_precise"] = worst[True]
    row["bound_by"] = "operations" if all(
        s["bound_by"] == "operations" for s in row["shapes"]) else "bytes"
    log(f"  attention at B={batch}: training {row['training_ms']:.3f} ms "
        f"(sdpa {row['library_training_ms']:.3f}), evaluation "
        f"{row['evaluation_ms']:.3f} ms (sdpa "
        f"{row['library_evaluation_ms']:.3f}) for 51 calls")
    return row


def check_dropout(gen, seed):
    """K3 with p = 0.1: the kernels' mask writer equals the plain Philox
    generator, keeps 90 % within 4 sigma, and the forward equals the plain
    version fed that mask."""
    import torch

    from butd_detr_tpu_torch.ops import (
        attention,
        attention_plain,
        dropout_keep_mask,
        dropout_keep_mask_plain,
    )

    p = 0.1
    out = dict(p=p, shapes=[])
    for B, H, Lq, Lk, Dh in ((2, 8, 1024, 1024, 36), (2, 8, 256, 132, 36),
                             (3, 12, 50, 67, 64)):
        mask = dropout_keep_mask(seed, B, H, Lq, Lk, p, device="cuda")
        plain = dropout_keep_mask_plain(seed, B, H, Lq, Lk, p,
                                        device="cuda")
        check(torch.equal(mask, plain),
              f"dropout mask kernel != plain Philox at {(B, H, Lq, Lk)}")
        n = mask.numel()
        rate = mask.float().mean().item()
        sigma = (p * (1 - p) / n) ** 0.5
        check(abs(rate - (1 - p)) <= 4 * sigma,
              f"keep rate {rate} is not within 4 sigma of {1 - p} (n={n})")
        q, k, v = (torch.randn(B, L, H, Dh, device="cuda",
                               generator=gen).transpose(1, 2)
                   for L in (Lq, Lk, Lk))
        pad = torch.zeros(B, Lk, dtype=torch.bool, device="cuda")
        pad[0, Lk - 9:] = True
        for precise, (atol, rtol) in ((True, (2e-5, 1e-4)),
                                      (False, (4e-3, 4e-3))):
            got = attention(q, k, v, pad, sm_scale=Dh ** -0.5, dropout_p=p,
                            seed=seed, precise=precise)
            want = attention_plain(q, k, v, pad, sm_scale=Dh ** -0.5,
                                   precise=precise, keep_mask=mask,
                                   dropout_p=p)
            err = (got - want).abs().max().item()
            check(torch.allclose(got, want, atol=atol, rtol=rtol),
                  f"attention with dropout {(B, H, Lq, Lk, Dh)} "
                  f"precise={precise}: max err {err}")
        other = dropout_keep_mask(seed + 1, B, H, Lq, Lk, p, device="cuda")
        check(not torch.equal(mask, other), "two seeds gave one mask")
        out["shapes"].append(dict(B=B, H=H, Lq=Lq, Lk=Lk, keep_rate=rate,
                                  sigma=sigma))
        log(f"  dropout B={B} H={H} {Lq}x{Lk}: mask == plain Philox, keep "
            f"rate {rate:.5f} (4 sigma {4 * sigma:.5f}), forward within "
            f"bound")
    return out


def check_attention_backward(shapes, gen, seed, batch):
    """K4 against attention_backward_plain at every shape the training
    forward differentiates (all but the frozen text tower's)."""
    import torch
    import torch.nn.functional as F

    from butd_detr_tpu_torch.ops import (
        attention_backward,
        attention_backward_plain,
        dropout_keep_mask,
    )

    # f32 mode: reassociation only. bf16 mode: dS and D o P are rounded to
    # bf16 after f32 sums whose order differs, so entries may land one bf16
    # step (2^-8 relative) away: bounded by 4e-3 of the largest gradient.
    row = dict(name="attention_bwd", ms=0.0, ms_p0=0.0, plain_ms=0.0,
               bound_ms=0.0, library_ms=0.0, library_ms_p0=0.0,
               max_abs_err=0.0, shapes=[])
    worst = {True: 0.0, False: 0.0}

    def inputs(B, H, Lq, Lk, Dh, pad_kind, fully_masked):
        q, k, v, do = (torch.randn(B, L, H, Dh, device="cuda",
                                   generator=gen).transpose(1, 2)
                       for L in (Lq, Lk, Lk, Lq))
        pad = torch.zeros(B, Lk, dtype=torch.bool, device="cuda")
        if pad_kind == "text":
            pad[:, 14:] = True
        elif pad_kind == "boxes":
            pad[:, 12:] = True
        else:
            pad[0, Lk - 5:] = True
        if fully_masked:
            pad[-1] = True
        return q, k, v, do, pad

    for name, H, Lq, Lk, Dh, pad_kind, per_step in shapes:
        if name == "roberta_self":
            continue  # frozen: runs under no_grad, never differentiated
        scale = Dh ** -0.5
        q, k, v, do, pad = inputs(2, H, Lq, Lk, Dh, pad_kind, True)
        for p in (0.0, 0.1):
            keep = dropout_keep_mask(seed, 2, H, Lq, Lk, p, device="cuda") \
                if p else None
            for precise in (True, False):
                kw = dict(sm_scale=scale, dropout_p=p, precise=precise)
                got = attention_backward(q, k, v, do, pad, seed=seed, **kw)
                again = attention_backward(q, k, v, do, pad, seed=seed, **kw)
                want = attention_backward_plain(q, k, v, do, pad,
                                                keep_mask=keep, **kw)
                for what, g, a, w in zip("qkv", got, again, want):
                    check(torch.equal(g, a),
                          f"attention backward {name} d{what}: two runs "
                          f"differ")
                    err = (g - w).abs().max().item()
                    if precise:
                        ok = torch.allclose(g, w, atol=2e-5, rtol=1e-4)
                    else:
                        ok = err <= 4e-3 + 4e-3 * w.abs().max().item()
                    check(ok, f"attention backward {name} d{what} p={p} "
                              f"precise={precise}: max err {err}")
                    worst[precise] = max(worst[precise], err)
        del keep, got, again, want
        # timed at the training batch, in the training mode (bf16
        # operands, p = 0.1), without a fully masked row
        q, k, v, do, pad = inputs(batch, H, Lq, Lk, Dh, pad_kind, False)
        kw = dict(sm_scale=scale, dropout_p=0.1, precise=False)
        ms = time_ms(lambda: attention_backward(q, k, v, do, pad, seed=seed,
                                                **kw), 10)
        keep = dropout_keep_mask(seed, batch, H, Lq, Lk, 0.1, device="cuda")
        pms = time_ms(lambda: attention_backward_plain(
            q, k, v, do, pad, keep_mask=keep, **kw), 5)
        del keep
        ms0 = time_ms(lambda: attention_backward(
            q, k, v, do, pad, sm_scale=scale, precise=False), 10)
        # autograd through SDPA at p = 0.1 (like for like with K4's timed
        # mode) and at p = 0; SDPA is a yardstick the port never calls
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lms = {}
        for p in (0.1, 0.0):
            out = F.scaled_dot_product_attention(
                *leaves, attn_mask=~pad[:, None, None, :], scale=scale,
                dropout_p=p)
            lms[p] = time_ms(lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True), 10)
            del out
        del leaves
        pairs = batch * H * Lq * Lk
        nbytes = 4 * batch * H * Dh * (3 * Lq + 4 * Lk) + batch * Lk
        b_ms, by = bound_ms(nbytes, [(10 * pairs * Dh, BF16_OPS_PER_S),
                                     (12 * pairs, F32_OPS_PER_S)])
        row["shapes"].append(dict(name=name, B=batch, H=H, Lq=Lq, Lk=Lk,
                                  Dh=Dh, per_step=per_step, ms=ms,
                                  ms_p0=ms0, plain_ms=pms,
                                  library_ms=lms[0.1], library_ms_p0=lms[0.0],
                                  bound_ms=b_ms, bound_by=by))
        for key, val in (("ms", ms), ("ms_p0", ms0), ("plain_ms", pms),
                         ("library_ms", lms[0.1]),
                         ("library_ms_p0", lms[0.0]), ("bound_ms", b_ms)):
            row[key] += per_step * val
        log(f"  bwd {name:20s} B={batch} Lq={Lq:4d} Lk={Lk:4d}: {ms:.3f} ms "
            f"(p = 0: {ms0:.3f}; plain {pms:.3f}, sdpa autograd p = 0.1 "
            f"{lms[0.1]:.3f}, p = 0 {lms[0.0]:.3f}, bound {b_ms:.4f} by "
            f"{by}) x{per_step}")
    row["max_abs_err"] = worst[False]
    row["max_abs_err_precise"] = worst[True]
    row["bound_by"] = "operations" if all(
        s["bound_by"] == "operations" for s in row["shapes"]) else "bytes"
    return row


def check_attention_bf16_operands(shapes, gen, seed, batch):
    """K3 and K4 with bf16 operands (the `--use_bf16` model's projections,
    read as they are) against the same kernels with f32 operands holding
    the same values: the outputs and gradients must be equal bit for bit,
    at every shape of a request (B = 1) and of a training step (B =
    `batch`), at p = 0 and p = 0.1. Times both operand types at the
    request's (p = 0) and the step's (p = 0.1 but RoBERTa's) shapes, each
    summed over its launches: K3 over 51 calls, K4 over the 39 of a step.
    Returns (the K3 fields, the K4 fields)."""
    import torch

    from butd_detr_tpu_torch.ops import attention, attention_backward

    fwd = dict(ms_bf16_operands=0.0, ms_f32_operands=0.0,
               training_ms_bf16_operands=0.0, training_ms_f32_operands=0.0,
               bit_equal_bf16_f32_operands=True, shapes_bf16=[])
    bwd = dict(ms_bf16_operands=0.0, ms_f32_operands=0.0,
               bit_equal_bf16_f32_operands=True, shapes_bf16=[])

    def operands(B, H, Lq, Lk, Dh, pad_kind):
        # (B, L, H, Dh) bf16 projections viewed as (B, H, L, Dh), as the
        # bf16 model's MHA hands them over, and f32 copies of their values
        qkvd = [torch.randn(B, L, H, Dh, device="cuda", generator=gen)
                .to(torch.bfloat16).transpose(1, 2)
                for L in (Lq, Lk, Lk, Lq)]
        pad = torch.zeros(B, Lk, dtype=torch.bool, device="cuda")
        if pad_kind == "text":
            pad[:, 14:] = True
        elif pad_kind == "boxes":
            pad[:, 12:] = True
        return qkvd, [t.float() for t in qkvd], pad

    for name, H, Lq, Lk, Dh, pad_kind, per_req in shapes:
        scale = Dh ** -0.5
        entry = dict(name=name, H=H, Lq=Lq, Lk=Lk, Dh=Dh)
        for B in (1, batch):
            (qb, kb, vb, db), (qf, kf, vf, df), pad = operands(
                B, H, Lq, Lk, Dh, pad_kind)
            for p in (0.0, 0.1):
                kw = dict(sm_scale=scale, dropout_p=p, seed=seed)
                ob = attention(qb, kb, vb, pad, **kw)
                of = attention(qf, kf, vf, pad, **kw)
                check(ob.dtype == torch.float32
                      and torch.equal(_bits(ob), _bits(of)),
                      f"K3 {name} B={B} p={p}: bf16 operands differ from "
                      "f32 operands of the same values")
                if name == "roberta_self":
                    continue  # frozen: never differentiated
                gb = attention_backward(qb, kb, vb, db, pad, **kw)
                gf = attention_backward(qf, kf, vf, df, pad, **kw)
                for what, a, b in zip("qkv", gb, gf):
                    check(a.dtype == torch.float32
                          and torch.equal(_bits(a), _bits(b)),
                          f"K4 {name} B={B} p={p} d{what}: bf16 operands "
                          "differ from f32 operands of the same values")
            if B == 1:
                kw = dict(sm_scale=scale)
                entry["ms_bf16"] = time_ms(
                    lambda: attention(qb, kb, vb, pad, **kw), 10)
                entry["ms_f32"] = time_ms(
                    lambda: attention(qf, kf, vf, pad, **kw), 10)
                fwd["ms_bf16_operands"] += per_req * entry["ms_bf16"]
                fwd["ms_f32_operands"] += per_req * entry["ms_f32"]
                continue
            p_train = 0.0 if name == "roberta_self" else 0.1
            kw = dict(sm_scale=scale, dropout_p=p_train, seed=seed)
            entry["training_ms_bf16"] = time_ms(
                lambda: attention(qb, kb, vb, pad, **kw), 10)
            entry["training_ms_f32"] = time_ms(
                lambda: attention(qf, kf, vf, pad, **kw), 10)
            fwd["training_ms_bf16_operands"] += per_req * entry[
                "training_ms_bf16"]
            fwd["training_ms_f32_operands"] += per_req * entry[
                "training_ms_f32"]
            if name != "roberta_self":
                entry["bwd_ms_bf16"] = time_ms(lambda: attention_backward(
                    qb, kb, vb, db, pad, **kw), 10)
                entry["bwd_ms_f32"] = time_ms(lambda: attention_backward(
                    qf, kf, vf, df, pad, **kw), 10)
                bwd["ms_bf16_operands"] += per_req * entry["bwd_ms_bf16"]
                bwd["ms_f32_operands"] += per_req * entry["bwd_ms_f32"]
        fwd["shapes_bf16"].append(entry)
        log(f"  bf16 operands {name:20s}: bit-equal to f32 operands (K3"
            f"{'' if name == 'roberta_self' else ', K4'}; B = 1 and "
            f"{batch}, p = 0 and 0.1); K3 request {entry['ms_bf16']:.4f} "
            f"ms (f32 operands {entry['ms_f32']:.4f}), step "
            f"{entry['training_ms_bf16']:.4f} ({entry['training_ms_f32']:.4f})"
            + ("" if name == "roberta_self" else
               f"; K4 {entry['bwd_ms_bf16']:.4f} ({entry['bwd_ms_f32']:.4f})")
            + f" x{per_req}")
    log(f"  bf16 operands: K3 {fwd['ms_bf16_operands']:.3f} ms a request "
        f"(f32 operands {fwd['ms_f32_operands']:.3f}), "
        f"{fwd['training_ms_bf16_operands']:.3f} a step "
        f"({fwd['training_ms_f32_operands']:.3f}); K4 "
        f"{bwd['ms_bf16_operands']:.3f} a step "
        f"({bwd['ms_f32_operands']:.3f})")
    return fwd, bwd


def check_bf16_rows(gen, batch):
    """K6 and K5 at the rows the `--use_bf16` model adds: bf16 xyz (C 3,
    6-byte rows: the queries' xyz), bf16 boxes (C 6: the loss's matched
    boxes) and bf16 features (C 288), at a request's (B = 1) and a step's
    (B = `batch`) shapes. K6 bit-equal to gather_rows_plain (-0.0, inf, a
    denormal and NaN planted), K5 bit-equal to scatter_rows_add_plain run
    on the CPU (both sum in ascending m). Returns (K6 rows, K5 rows)."""
    import torch

    from butd_detr_tpu_torch.ops import (
        gather_rows,
        gather_rows_plain,
        scatter_rows_add,
        scatter_rows_add_plain,
    )

    gathers, scatters = [], []
    # (name, source rows n, gathered rows M, channels)
    for name, n, M, C in (("query_xyz", 1024, 256, 3),
                          ("matched_boxes", 256, 132, 6),
                          ("features", 1024, 256, 288)):
        for B in (1, batch):
            src = _special_rows(torch.randn(
                B, n, C, device="cuda", generator=gen).to(torch.bfloat16))
            idx = torch.randint(0, n, (B, M), device="cuda", generator=gen,
                                dtype=torch.int32)
            got = gather_rows(src, idx)
            check(got.dtype == torch.bfloat16 and torch.equal(
                _bits(got), _bits(gather_rows_plain(src, idx))),
                f"K6 bf16 {name} B={B}: differs from its plain version")
            ms = time_ms(lambda: gather_rows(src, idx), 20)
            pms = time_ms(lambda: gather_rows_plain(src, idx), 20)
            gathers.append(dict(name=name, B=B, n=n, M=M, C=C, ms=ms,
                                plain_ms=pms))
            g = torch.randn(B, M, C, device="cuda", generator=gen).to(
                torch.bfloat16)
            out = scatter_rows_add(g, idx, n)
            check(out.dtype == torch.float32 and torch.equal(
                out.cpu(), scatter_rows_add_plain(g.cpu(), idx.cpu(), n)),
                f"K5 bf16 {name} B={B}: differs from its plain version on "
                "the CPU")
            ms5 = time_ms(lambda: scatter_rows_add(g, idx, n), 20)
            pms5 = time_ms(lambda: scatter_rows_add_plain(g, idx, n), 20)
            scatters.append(dict(name=name, B=B, n=n, M=M, C=C, ms=ms5,
                                 plain_ms=pms5))
            log(f"  bf16 rows {name:13s} B={B} C={C:3d}: K6 {ms:.4f} ms "
                f"(plain {pms:.4f}), K5 {ms5:.4f} ms (plain {pms5:.4f}); "
                "both bit-equal to their plain versions")
    return gathers, scatters


def training_gathers(tiers, npoints, cfg, gen):
    """(name, dtype, launches per step, idx (B, M), n, C) of every row
    gather whose backward a training step runs, with the own ball-query
    and 3-NN indices of the training batch's `sa_tiers`. The backbone legs
    carry bf16 cotangents, the kps and matched-box gathers f32."""
    import torch

    from butd_detr_tpu_torch.ops import ball_query, three_nn

    B = tiers[0][0].shape[0]
    bf16, f32 = torch.bfloat16, torch.float32
    out = []
    for i, c in ((1, 128), (2, 256), (3, 256)):
        xyz, new_xyz, _, r, ns = tiers[i]
        idx = ball_query(r, ns, xyz, new_xyz)
        out.append((f"sa{i + 1}_group", bf16, 1, idx.reshape(B, -1),
                    xyz.shape[1], c))
    xyz2, xyz3, xyz4 = tiers[1][1], tiers[2][1], tiers[3][1]
    for name, unknown, known in (("fp1_interpolate", xyz3, xyz4),
                                 ("fp2_interpolate", xyz2, xyz3)):
        _, idx = three_nn(unknown, known)
        out.append((name, bf16, 1, idx.reshape(B, -1), known.shape[1], 256))

    def distinct(m, n, rows=B):
        return torch.stack([torch.randperm(n, device="cuda",
                                           generator=gen)[:m]
                            for _ in range(rows)]).to(torch.int32)

    out.append(("kps_features", f32, 1, distinct(cfg.num_target, npoints[1]),
                npoints[1], 288))
    # the loss gathers every prefix's matched boxes in one call
    prefixes = cfg.num_decoder_layers + 1
    out.append(("matched_boxes", f32, 1,
                distinct(cfg.max_num_obj, cfg.num_target, prefixes * B),
                cfg.num_target, 6))
    return out


def check_scatter(gathers, gen, repeats=5):
    """K5 against scatter_rows_add_plain at every gather of a training
    step, f32 and bf16 rows, and with dropped entries (idx = n and < 0) and
    all rows on one index: |err| <= 1e-5 * sum |g| per output, and the
    same bits in `repeats` runs (`run_to_run` must be 0). Reported, shape
    by shape: whether the card's sums are the bits of the plain version run
    on the CPU (both add in ascending m)."""
    import torch

    from butd_detr_tpu_torch.ops import (
        scatter_rows_add,
        scatter_rows_add_plain,
    )

    row = dict(name="scatter", ms=0.0, plain_ms=0.0, bound_ms=0.0,
               library_ms=0.0, max_abs_err=0.0, run_to_run=0.0, shapes=[])

    def compare(g, idx, n, what):
        got = scatter_rows_add(g, idx, n)
        want = scatter_rows_add_plain(g, idx, n)
        lim = 1e-5 * scatter_rows_add_plain(g.abs(), idx, n) + 1e-30
        err = (got - want).abs()
        check(bool((err <= lim).all()),
              f"scatter {what}: max err {err.max().item()} over its bound")
        check(got.dtype == torch.float32 and got.shape == want.shape,
              f"scatter {what}: {got.dtype} {tuple(got.shape)}")
        again = max((scatter_rows_add(g, idx, n) - got).abs().max().item()
                    for _ in range(repeats - 1))
        check(again == 0.0, f"scatter {what}: two runs differ by {again}")
        row["run_to_run"] = max(row["run_to_run"], again)
        cpu = torch.equal(got.cpu(), scatter_rows_add_plain(
            g.cpu(), idx.cpu(), n))
        return err.max().item(), cpu

    for name, dtype, per_step, idx, n, C in gathers:
        B, M = idx.shape
        equal_cpu = {}
        for dt in (torch.float32, torch.bfloat16):
            g = torch.randn(B, M, C, device="cuda", generator=gen).to(dt)
            err, equal_cpu[str(dt)[6:]] = compare(g, idx, n, f"{name} {dt}")
            row["max_abs_err"] = max(row["max_abs_err"], err)
            dropped = idx.clone()
            dropped[:, ::5] = n  # entries >= n are ignored
            dropped[:, 1::7] = -1  # and entries < 0
            compare(g, dropped, n, f"{name} {dt} with idx = n and -1")
            compare(g, torch.full_like(idx, n // 2), n,
                    f"{name} {dt} all rows on one index")
        g = torch.randn(B, M, C, device="cuda", generator=gen).to(dtype)
        ms = time_ms(lambda: scatter_rows_add(g, idx, n), 20)
        pms = time_ms(lambda: scatter_rows_add_plain(g, idx, n), 20)
        flat = (idx.long() + n * torch.arange(B, device="cuda")[:, None]) \
            .reshape(-1)
        gf = g.reshape(B * M, C).float()
        lms = time_ms(lambda: torch.zeros(B * n, C, device="cuda")
                      .index_add_(0, flat, gf), 20)
        nbytes = B * (M * C * g.element_size() + M * idx.element_size()
                      + n * C * 4)
        b_ms, by = bound_ms(nbytes, [(B * M * C, F32_OPS_PER_S)])
        row["shapes"].append(dict(name=name, B=B, M=M, C=C, n=n,
                                  dtype=str(dtype), per_step=per_step, ms=ms,
                                  plain_ms=pms, library_ms=lms, bound_ms=b_ms,
                                  bound_by=by, bit_equal_cpu=equal_cpu))
        row["ms"] += per_step * ms
        row["plain_ms"] += per_step * pms
        row["library_ms"] += per_step * lms
        row["bound_ms"] += per_step * b_ms
        same = ", ".join(f"{k} {'equal' if v else 'differs'}"
                         for k, v in equal_cpu.items())
        log(f"  scatter {name:16s} B={B} M={M:6d} C={C:3d} n={n:5d} "
            f"{str(dtype)[6:]}: {ms:.4f} ms (plain {pms:.4f}, index_add_ "
            f"{lms:.4f}, bound {b_ms:.5f} by {by}) x{per_step}; bits vs the "
            f"plain version on the CPU: {same}")
    row["bound_by"] = "operations" if all(
        s["bound_by"] == "operations" for s in row["shapes"]) else "bytes"
    row["bit_equal_cpu"] = all(all(s["bit_equal_cpu"].values())
                               for s in row["shapes"])
    log(f"  scatter: largest |kernel - plain| {row['max_abs_err']:.3g}, "
        f"largest run-to-run difference over {repeats} runs "
        f"{row['run_to_run']:.3g}; bit-equal to the CPU at every training "
        f"shape: {row['bit_equal_cpu']}")
    return row


def forward_gathers(tiers, npoints, cfg, gen):
    """Every row gather of the forward and the loss, with the own FPS,
    ball-query and 3-NN indices of `tiers` (one scene or the batch).

    Returns (row gathers, grouped gathers). A row gather is (name, dtype,
    n, C, idx (B, M), launches a request or evaluation batch, launches a
    training step); a grouped gather (name, n, Cf, idx (B, m, ns),
    new_xyz (B, m, 3), inv_r), the four set-abstraction groupings of the
    bf16 backbone: xyz in f32 beside bf16 features, centred and scaled into
    the MLP's bf16 input. Dtypes are the default (bf16 backbone) mode's;
    the f32 mode's groupings are listed last with no launch on these
    paths."""
    import torch

    from butd_detr_tpu_torch.ops import (
        ball_query,
        furthest_point_sample,
        three_nn,
    )
    from butd_detr_tpu_torch.utils import reciprocal_f32

    B = tiers[0][0].shape[0]
    bf16, f32 = torch.bfloat16, torch.float32
    rows, groups = [], []
    feat_c = (3, 128, 256, 256)  # channels entering each SA tier
    ball = []
    for i, (xyz, new_xyz, npoint, r, ns) in enumerate(tiers):
        inds = furthest_point_sample(xyz, npoint)
        rows.append((f"sa{i + 1}_new_xyz", f32, xyz.shape[1], 3, inds, 1, 1))
        ball.append(ball_query(r, ns, xyz, new_xyz))
        groups.append((f"sa{i + 1}_group", xyz.shape[1], feat_c[i],
                       ball[-1], new_xyz, reciprocal_f32(r)))
    xyz2, xyz3, xyz4 = tiers[1][1], tiers[2][1], tiers[3][1]
    for name, unknown, known in (("fp1_interpolate", xyz3, xyz4),
                                 ("fp2_interpolate", xyz2, xyz3)):
        _, idx = three_nn(unknown, known)
        rows.append((name, bf16, known.shape[1], 256, idx.reshape(B, -1),
                     1, 1))

    def distinct(m, n, dtype, rows=B):
        return torch.stack([torch.randperm(n, device="cuda",
                                           generator=gen)[:m]
                            for _ in range(rows)]).to(dtype)

    kps = distinct(cfg.num_target, npoints[1], torch.int32)
    rows.append(("kps_xyz", f32, npoints[1], 3, kps, 1, 1))
    rows.append(("kps_features", f32, npoints[1], 288, kps, 1, 1))
    # the matcher's assignment arrives as int64; one call gathers every
    # prefix's matched boxes
    prefixes = cfg.num_decoder_layers + 1
    rows.append(("matched_boxes", f32, cfg.num_target, 6,
                 distinct(cfg.max_num_obj, cfg.num_target, torch.int64,
                          prefixes * B), 0, 1))
    # f32 mode: xyz and features concatenated, one payload
    for i in (1, 2, 3):
        rows.append((f"sa{i + 1}_group_f32", f32, tiers[i][0].shape[1],
                     3 + feat_c[i], ball[i].reshape(B, -1), 0, 0))
    return rows, groups


def _bits(t):
    """The tensor's bits as integers: equality then includes -0.0, NaN
    payloads and denormals."""
    import torch

    return t.contiguous().view(torch.int32 if t.element_size() == 4
                               else torch.int16)


def _special_rows(src):
    """Plant -0.0, an infinity, a denormal and a NaN in row 0 of every
    scene (as many as the row holds)."""
    import torch

    vals = torch.tensor([-0.0, float("inf"), 1e-42, float("nan")],
                        device=src.device)[:src.shape[-1]].to(src.dtype)
    src[:, 0, :len(vals)] = vals
    return src


def _distinct_rows(idx, n):
    """How many different source rows the index names: what a gather must
    read of its source on this data."""
    import torch

    B = idx.shape[0]
    seen = torch.zeros(B, n, dtype=torch.bool, device=idx.device)
    seen.scatter_(1, idx.reshape(B, -1).long(), True)
    return int(seen.sum())


def check_gathers(rows, groups, gen, batched):
    """K6 and K7 against their plain versions, bit for bit, and timed.
    `batched` says whether these are the batch's shapes (the evaluation
    batch and the training step) or one scene's (a request)."""
    import torch

    from butd_detr_tpu_torch.ops import (
        gather_rows,
        gather_rows_plain,
        group_rows,
        group_rows_mlp_input,
        group_rows_mlp_input_plain,
        group_rows_plain,
        group_rows_split,
        group_rows_split_plain,
    )

    g_row = dict(name="gather", ms=0.0, ms_int32=0.0, ms_int64=0.0,
                 plain_ms=0.0, bound_ms=0.0, library_ms=0.0, step_ms=0.0,
                 host_us=0.0, library_host_us=0.0, max_abs_err=0, shapes=[],
                 groupings_device_ms={})
    # K7's main-path form is the MLP-input kernel (ms, plain, bound,
    # library: the four tiers summed); the copy kernel's keep copy_*
    gg_row = dict(name="group_gather", ms=0.0, plain_ms=0.0, bound_ms=0.0,
                  library_ms=0.0, chain_ms=0.0, step_ms=0.0, copy_ms=0.0,
                  copy_plain_ms=0.0, copy_bound_ms=0.0, copy_library_ms=0.0,
                  max_abs_err=0, shapes=[], mlp_input_shapes=[])

    def same(got, want, what):
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"{what}: {got.dtype} {tuple(got.shape)}")
        check(torch.equal(_bits(got), _bits(want)),
              f"{what}: kernel and plain version differ in some bit")

    for name, dtype, n, C, idx, per_batch, per_step in rows:
        B, M = idx.shape
        for dt in (torch.float32, torch.bfloat16):
            src = _special_rows(torch.randn(B, n, C, device="cuda",
                                            generator=gen).to(dt))
            probe = idx.clone()
            probe[:, 0] = 0  # the row of special values
            same(gather_rows(src, probe), gather_rows_plain(src, probe),
                 f"gather {name} {dt}")
            same(gather_rows(src, probe.long()),
                 gather_rows_plain(src, probe), f"gather {name} {dt} int64")
        # a strided source (a channel slice of a wider cloud) and an index
        # out of range
        wide = torch.randn(B, n, C + 3, device="cuda", generator=gen)
        same(gather_rows(wide[..., :C], idx),
             gather_rows_plain(wide[..., :C], idx), f"gather {name} strided")
        out = idx.clone()
        out[:, -1] = n
        got = gather_rows(wide[..., :C], out)
        same(got, gather_rows_plain(wide[..., :C], out),
             f"gather {name} index out of range")
        check(float(got[:, -1].abs().max()) == 0.0,
              f"gather {name}: an index out of range gave no zero row")
        del wide
        src = torch.randn(B, n, C, device="cuda", generator=gen).to(dtype)
        # each index type read as it is (no cast kernel before the gather)
        idx32, idx64 = idx.int(), idx.long()
        wide_idx = idx.long()[..., None].expand(-1, -1, C)

        def k6():
            return gather_rows(src, idx)

        def library():
            return torch.gather(src, 1, wide_idx)

        # K6 and torch.gather in turns, three rounds, the median kept: a
        # call's ms (CUDA events over 20 back-to-back calls: the host's
        # time at the main paths' shapes) and its host us (the host's
        # clock, not waiting for the device)
        turns = {key: [] for key in ("ms", "lms", "ms32", "ms64", "us",
                                     "lus")}
        main_path = per_batch or per_step
        for _ in range(3):
            turns["ms"].append(time_ms(k6, 20))
            turns["lms"].append(time_ms(library, 20))
            turns["ms32"].append(time_ms(lambda: gather_rows(src, idx32), 20))
            turns["ms64"].append(time_ms(lambda: gather_rows(src, idx64), 20))
            if main_path:
                turns["us"].append(host_us(k6))
                turns["lus"].append(host_us(library))
        ms, lms, ms32, ms64 = (sorted(turns[k])[1] for k in
                               ("ms", "lms", "ms32", "ms64"))
        us, lus = (sorted(turns[k])[1] if turns[k] else None
                   for k in ("us", "lus"))
        pms = time_ms(lambda: gather_rows_plain(src, idx), 20)
        row_bytes = C * src.element_size()
        nbytes = B * M * 4 + (_distinct_rows(idx, n) + B * M) * row_bytes
        b_ms, by = bound_ms(nbytes, [])
        entry = dict(
            name=name, B=B, n=n, M=M, C=C, dtype=str(dtype),
            index_dtype=str(idx.dtype), per_batch=per_batch,
            per_step=per_step, ms=ms, ms_int32=ms32, ms_int64=ms64,
            plain_ms=pms, library_ms=lms, bound_ms=b_ms, bound_by=by,
            host_us=us, library_host_us=lus, turns=turns)
        if not main_path:  # the f32 groupings: the device's time
            entry["device_ms"] = device_ms(k6, 20)
            entry["library_device_ms"] = device_ms(library, 20)
            g_row["groupings_device_ms"][name] = dict(
                ms=entry["device_ms"], library_ms=entry["library_device_ms"],
                bound_ms=b_ms)
        g_row["shapes"].append(entry)
        for key, val in (("ms", ms), ("ms_int32", ms32), ("ms_int64", ms64),
                         ("plain_ms", pms), ("library_ms", lms),
                         ("bound_ms", b_ms), ("host_us", us or 0.0),
                         ("library_host_us", lus or 0.0)):
            g_row[key] += per_batch * val
        g_row["step_ms"] += per_step * ms
        cmp = "<=" if ms <= lms else ">"
        log(f"  gather {name:18s} B={B} n={n:5d} M={M:6d} C={C:3d} "
            f"{str(dtype)[6:]}: {ms:.4f} ms {cmp} torch.gather {lms:.4f} "
            f"(int32 {ms32:.4f}, int64 {ms64:.4f}; plain {pms:.4f}, bound "
            f"{b_ms:.5f}) x{per_batch} a batch, x{per_step} a step"
            + (f"; host {us:.2f} us a call, torch.gather {lus:.2f}"
               if main_path else
               f"; device {entry['device_ms']:.4f} ms, torch.gather "
               f"{entry['library_device_ms']:.4f}, "
               f"{entry['device_ms'] / b_ms:.2f}x the bound")
            + ": bit-equal")

    for name, n, cf, idx, new_xyz, inv_r in groups:
        B, m, ns = idx.shape
        cloud = _special_rows(torch.randn(B, n, 3 + cf, device="cuda",
                                          generator=gen))
        xyz = cloud[..., :3]  # strided, as the backbone hands it over
        probe = idx.clone()
        probe[:, 0, 0] = 0
        for dt in (torch.bfloat16, torch.float32):
            feats = cloud[..., 3:].to(dt)
            gx, gf = group_rows_split(xyz, feats, probe.long())
            wx, wf = group_rows_split_plain(xyz, feats, probe)
            same(gx, wx, f"group_gather {name} xyz beside {dt}")
            same(gf, wf, f"group_gather {name} features {dt}")
        out = idx.clone()
        out[:, -1, -1] = n
        gx, gf = group_rows_split(xyz, feats, out)
        check(float(gx[:, -1, -1].abs().max()) == 0.0
              and float(gf[:, -1, -1].abs().max()) == 0.0,
              f"group_gather {name}: an index out of range gave no zero row")
        # the MLP-input kernel: special rows (row 0 of every scene), a
        # centre with the special values, int32 and int64, an index out of
        # range; bit-equal to the plain version
        feats = cloud[..., 3:].to(torch.bfloat16)
        centres = new_xyz.clone()
        centres[:, :2] = cloud[:, :1, :3]  # inf - inf: a NaN, and -inf
        for index in (probe, probe.long(), out):
            same(group_rows_mlp_input(xyz, centres, feats, index, inv_r),
                 group_rows_mlp_input_plain(xyz, centres, feats, index,
                                            inv_r),
                 f"group_gather {name} MLP input, {index.dtype} index")
        got = group_rows_mlp_input(xyz, new_xyz, feats, out, inv_r)
        check(float(got[:, -1, -1, 3:].float().abs().max()) == 0.0,
              f"group_gather {name}: an index out of range gave features "
              "in the MLP input")
        xyz_c = xyz.contiguous()
        del centres, got
        ms = time_ms(lambda: group_rows_split(xyz_c, feats, idx), 20)
        pms = time_ms(lambda: group_rows_split_plain(xyz_c, feats, idx), 10)

        def concat_gather_cast():
            cat = torch.cat([xyz_c, feats.to(xyz_c.dtype)], dim=-1)
            g = torch.gather(cat, 1, idx.reshape(B, m * ns).long()[..., None]
                             .expand(-1, -1, 3 + cf)).reshape(B, m, ns, -1)
            return g[..., :3], g[..., 3:].to(feats.dtype)

        lms = time_ms(concat_gather_cast, 10)
        row_bytes = 12 + 2 * cf
        distinct = _distinct_rows(idx, n)
        nbytes = B * m * ns * 4 + (distinct + B * m * ns) * row_bytes
        b_ms, by = bound_ms(nbytes, [])
        gg_row["shapes"].append(dict(
            name=name, B=B, n=n, m=m, ns=ns, Cf=cf, per_batch=1, per_step=1,
            ms=ms, plain_ms=pms, library_ms=lms, bound_ms=b_ms, bound_by=by))
        for key, val in (("copy_ms", ms), ("copy_plain_ms", pms),
                         ("copy_library_ms", lms), ("copy_bound_ms", b_ms)):
            gg_row[key] += val
        log(f"  group_gather {name:10s} B={B} n={n:5d} m={m:4d} ns={ns:2d} "
            f"3 f32 + {cf:3d} bf16: {ms:.4f} ms (plain {pms:.4f}, "
            f"concatenate-gather-cast {lms:.4f}, bound {b_ms:.5f}): "
            f"bit-equal")

        # the MLP input, as the backbone groups it: sa1's xyz is a strided
        # view of the cloud, the later tiers' the previous tier's centres
        src = xyz if name.startswith("sa1") else xyz_c

        def fused():
            return group_rows_mlp_input(src, new_xyz, feats, idx, inv_r)

        def chain():  # what the bf16 branch ran before: K7's copy + 4 passes
            gx, gf = group_rows_split(src, feats, idx)
            y = (gx - new_xyz[:, :, None, :]) * inv_r
            return torch.cat([y, gf], dim=-1).to(torch.bfloat16)

        def library():  # the same function from PyTorch's own operators
            cat = torch.cat([src, feats.to(src.dtype)], dim=-1)
            g = torch.gather(cat, 1, idx.reshape(B, m * ns).long()[..., None]
                             .expand(-1, -1, 3 + cf)).reshape(B, m, ns, -1)
            y = (g[..., :3] - new_xyz[:, :, None, :]) * inv_r
            return torch.cat([y, g[..., 3:]], dim=-1).to(torch.bfloat16)

        fms = time_ms(fused, 20)
        fpms = time_ms(lambda: group_rows_mlp_input_plain(
            src, new_xyz, feats, idx, inv_r), 10)
        cms = time_ms(chain, 10)
        flms = time_ms(library, 10)
        # index, centres and distinct source rows read once, the bf16
        # rows written once
        f_bytes = (B * m * ns * idx.element_size() + B * m * 12
                   + distinct * row_bytes + B * m * ns * 2 * (3 + cf))
        fb_ms, fby = bound_ms(f_bytes, [])
        gg_row["mlp_input_shapes"].append(dict(
            name=name, B=B, n=n, m=m, ns=ns, Cf=cf, per_batch=1, per_step=1,
            ms=fms, plain_ms=fpms, chain_ms=cms, library_ms=flms,
            bound_ms=fb_ms, bound_by=fby, bytes=f_bytes))
        for key, val in (("ms", fms), ("plain_ms", fpms), ("chain_ms", cms),
                         ("library_ms", flms), ("bound_ms", fb_ms),
                         ("step_ms", fms)):
            gg_row[key] += val
        log(f"  group_gather {name:10s} MLP input (3 + {cf:3d}) bf16: "
            f"{fms:.4f} ms (plain {fpms:.4f}, replaced chain "
            f"{cms:.4f}, PyTorch operators {flms:.4f}, bound {fb_ms:.5f}): "
            f"bit-equal")

    # the one-payload form at the first tier: the f32 mode's grouping of
    # the (xyz, colour) cloud; on no default path, so it adds to no sum
    name, n, cf, idx = groups[0][:4]
    B, m, ns = idx.shape
    for dt in (torch.float32, torch.bfloat16):
        cloud = torch.randn(B, n, 3 + cf, device="cuda", generator=gen).to(dt)
        same(group_rows(cloud, idx), group_rows_plain(cloud, idx),
             f"group_gather {name} one payload {dt}")
    cloud = cloud.float()
    ms = time_ms(lambda: group_rows(cloud, idx), 20)
    pms = time_ms(lambda: group_rows_plain(cloud, idx), 10)
    wide_idx = idx.reshape(B, m * ns).long()[..., None].expand(-1, -1, 3 + cf)
    lms = time_ms(lambda: torch.gather(cloud, 1, wide_idx), 10)
    nbytes = (B * m * ns * 4
              + (_distinct_rows(idx, n) + B * m * ns) * 4 * (3 + cf))
    b_ms, by = bound_ms(nbytes, [])
    gg_row["shapes"].append(dict(
        name=name + "_one_payload_f32", B=B, n=n, m=m, ns=ns, Cf=cf,
        per_batch=0, per_step=0, ms=ms, plain_ms=pms, library_ms=lms,
        bound_ms=b_ms, bound_by=by))
    log(f"  group_gather {name} one payload of {3 + cf} f32: {ms:.4f} ms "
        f"(plain {pms:.4f}, torch.gather {lms:.4f}, bound {b_ms:.5f}): "
        f"bit-equal")
    for row in (g_row, gg_row):
        row["bound_by"] = "bytes"
        row["batched"] = batched
    log(f"  gather: an evaluation batch's 8 launches {g_row['ms']:.4f} ms, "
        f"torch.gather {g_row['library_ms']:.4f}; host "
        f"{g_row['host_us']:.1f} us, torch.gather "
        f"{g_row['library_host_us']:.1f}")
    return g_row, gg_row


# ------------------------------------------------------------- phase 2,
# the accuracy study's shapes

# the overfit probe (scripts/overfit_probe_torch.py, the JAX package's
# jax_b12_nt32 invocation) and the nt32 study (studies/cls_r5_nt32)
PROBE_FLAGS = ["--overfit", "12", "--steps", "220", "--probe_freq", "15",
               "--num_points", "5000", "--small_text", "--text_init",
               os.path.join("studies", "attrib_r5", "text_init.npz"),
               "--eos_coef", "0.02", "--num_target", "32"]
STUDY_FLAGS = ["--butd_cls", "--trainable_text", "--small_text",
               "--text_init",
               os.path.join("studies", "attrib_r5", "text_init.npz"),
               "--eos_coef", "0.02", "--num_target", "32",
               "--eval_train_split", "--joint_det", "--val_freq", "1",
               "--lr_decay_epochs", "55", "70", "--num_points", "20000"]
# the scenes both phases read: the study's 20,000-point scans, cut to
# 24 train + 8 val scenes (the probe's 12 samples are the first scenes',
# the same whatever the count)
STUDY_SCENES = dict(n_train=24, n_val=8, objects_per_scan=5,
                    points_per_scan=20_000)


def study_configs():
    """(name, Config, batch, points) of the probe and the study, as their
    scripts build them."""
    from butd_detr_tpu_torch.config import Config

    common = dict(use_color=True, butd_cls=True, self_attend=True,
                  use_soft_token_loss=True, use_contrastive_align=True,
                  max_num_obj=16, max_det_boxes=16, max_text_len=32,
                  num_target=32, eos_coef=0.02, freeze_text_encoder=False,
                  text_encoder_lr=1e-4, lr=1e-4, lr_backbone=1e-3)
    return [("probe", Config(batch_size=12, num_points=5000, **common),
             12, 5000),
            ("study", Config(batch_size=24, num_points=20000,
                             joint_det=True, detect_intermediate=True,
                             **common), 24, 20000)]


def check_study_shapes(gen, seed):
    """K1, K2, K6 and K7 bit-equal to their plain versions on the clouds
    of the probe (B = 12, 5,000 points) and the study (B = 24, 20,000),
    at every tier; K3 and K4 within their bounds at every attention shape
    of those two models (the 4-layer, 128-d text tower: 4 heads, Dh 32, L
    32 or 128 with key padding; 32 queries), p = 0 and 0.1, both modes."""
    import numpy as np
    import torch

    from butd_detr_tpu_torch.lang import small_text_roberta_config
    from butd_detr_tpu_torch.ops import (
        attention,
        attention_backward,
        attention_backward_plain,
        attention_plain,
        ball_query_plain,
        dropout_keep_mask,
        furthest_point_sample,
        furthest_point_sample_plain,
        gather_rows,
        gather_rows_plain,
        group_rows_mlp_input,
        group_rows_mlp_input_plain,
    )

    npoints = (2048, 1024, 512, 256)
    roberta = small_text_roberta_config()
    out = {}
    for name, cfg, B, N in study_configs():
        t0 = time.perf_counter()
        rng = np.random.RandomState(seed + N)
        clouds = np.stack([make_scene(rng, n_points=N)[0] for _ in range(B)])
        xyz = torch.from_numpy(clouds[..., :3].copy()).cuda()
        tiers = sa_tiers(xyz, npoints, (0.2, 0.4, 0.8, 1.2), (64, 32, 16, 16))
        paths = []
        for t_xyz, new_xyz, npoint, r, ns in tiers:
            check(torch.equal(furthest_point_sample(t_xyz, npoint),
                              furthest_point_sample_plain(t_xyz, npoint)),
                  f"{name}: FPS kernel != plain at B={B}, "
                  f"N={t_xyz.shape[1]}")
            paths.append(ball_query_tier(
                r, ns, t_xyz, new_xyz,
                ball_query_plain(r, ns, t_xyz, new_xyz))["path"])
        rows, groups = forward_gathers(tiers, npoints, cfg, gen)
        for gname, dtype, n, C, idx, per_batch, per_step in rows:
            if not (per_batch or per_step):
                continue
            src = torch.randn(idx.shape[0], n, C, device="cuda",
                              generator=gen).to(dtype)
            check(torch.equal(_bits(gather_rows(src, idx)),
                              _bits(gather_rows_plain(src, idx))),
                  f"{name}: gather {gname} kernel != plain")
        for gname, n, cf, idx, new_xyz, inv_r in groups:
            i = int(gname[2]) - 1
            feats = torch.randn(B, n, cf, device="cuda",
                                generator=gen).to(torch.bfloat16)
            src = tiers[i][0]
            check(torch.equal(
                _bits(group_rows_mlp_input(src, new_xyz, feats, idx, inv_r)),
                _bits(group_rows_mlp_input_plain(src, new_xyz, feats, idx,
                                                 inv_r))),
                f"{name}: group_gather {gname} MLP input kernel != plain")
        del tiers, rows, groups

        shapes = attention_shapes(cfg, roberta, npoints)
        worst = {True: 0.0, False: 0.0}
        for sname, H, Lq, Lk, Dh, pad_kind, _ in shapes:
            q, k, v, do = (torch.randn(B, L, H, Dh, device="cuda",
                                       generator=gen).transpose(1, 2)
                           for L in (Lq, Lk, Lk, Lq))
            keys = torch.arange(Lk, device="cuda")[None].expand(B, -1)
            pad = torch.zeros(B, Lk, dtype=torch.bool, device="cuda")
            if pad_kind == "text":  # utterances of 4 to 12 words
                pad = keys >= 6 + torch.arange(B, device="cuda")[:, None] % 9
            elif pad_kind == "boxes":
                pad = (keys >= 5).contiguous()  # 5 objects a scene
            scale = Dh ** -0.5
            for p in (0.0, 0.1):
                keep = (dropout_keep_mask(seed, B, H, Lq, Lk, p,
                                          device="cuda") if p else None)
                for precise in (True, False):
                    kw = dict(sm_scale=scale, dropout_p=p, precise=precise)
                    got = attention(q, k, v, pad, seed=seed, **kw)
                    want = attention_plain(q, k, v, pad, keep_mask=keep,
                                           **kw)
                    err = (got - want).abs().max().item()
                    # bf16 mode: each entry of P may land one bf16 step
                    # (2^-8 relative) away, so at most 2^-8 max|v| / (1 - p)
                    # when a row has few keys (5 boxes) and P is large
                    atol = 2e-5 if precise else (
                        4e-3 + 2 ** -8 * v.abs().max().item() / (1 - p))
                    check(torch.allclose(got, want, atol=atol,
                                         rtol=1e-4 if precise else 4e-3),
                          f"{name}: attention {sname} p={p} "
                          f"precise={precise}: max err {err}")
                    worst[precise] = max(worst[precise], err)
                    grads = attention_backward(q, k, v, do, pad, seed=seed,
                                               **kw)
                    wants = attention_backward_plain(q, k, v, do, pad,
                                                     keep_mask=keep, **kw)
                    for what, g, w in zip("qkv", grads, wants):
                        err = (g - w).abs().max().item()
                        ok = (torch.allclose(g, w, atol=2e-5, rtol=1e-4)
                              if precise else
                              err <= 4e-3 + 4e-3 * w.abs().max().item())
                        check(ok, f"{name}: attention backward {sname} "
                                  f"d{what} p={p} precise={precise}: max "
                                  f"err {err}")
                        worst[precise] = max(worst[precise], err)
            del q, k, v, do
        out[name] = dict(batch=B, points=N, ball_query_paths=paths,
                         attention_shapes=[s[:5] for s in shapes],
                         attention_max_abs_err=worst[False],
                         attention_max_abs_err_precise=worst[True],
                         seconds=time.perf_counter() - t0)
        log(f"  {name} shapes (B = {B}, {N} points; text tower 4 x 128, "
            f"L {cfg.max_text_len}; 32 queries): fps, ball query "
            f"({', '.join(paths)}), gathers and the MLP input bit-equal; "
            f"attention forward and backward at {len(shapes)} shapes, "
            f"p = 0 and 0.1, within bound (max err {worst[False]:.3g}, "
            f"precise {worst[True]:.3g}); {out[name]['seconds']:.1f} s")
    return out


# ------------------------------------------------------------- phase 2,
# the assignment

# (name, matrices, targets G, queries Q, valid targets a matrix): the one
# matcher call of a loss (7 prefixes x B scenes) on each path that takes
# it. synthetic_batch gives 6 valid targets a scene; make_rich_scannet's
# rows 1 (sr3d) to 5 (a detection prompt over its 5 objects).
ASSIGNMENT_SHAPES = [
    ("training", 7 * 8, 132, 256, (6,)),
    ("cli", 7 * 24, 132, 256, (1, 2, 3, 4, 5)),
    ("probe", 7 * 12, 16, 32, (1, 2, 3, 4, 5)),
    ("study", 7 * 24, 16, 32, (1, 2, 3, 4, 5)),
    ("full", 7 * 8, 132, 256, (132,)),
]


def matcher_costs(gen, M, G, Q, n_valid):
    """The transposed (M, G, Q) view of `matcher_cost_matrix` on random
    predictions (M, Q) and targets (M, G), the first n_valid[m] valid:
    the solver's input as `hungarian_match` hands it over."""
    import torch

    from butd_detr_tpu_torch.losses import matcher_cost_matrix

    def boxes(n):
        return torch.cat([torch.rand(M, n, 3, device="cuda",
                                     generator=gen) * 3 + 1,
                          torch.rand(M, n, 3, device="cuda",
                                     generator=gen) * 0.5 + 0.2], -1)

    mask = (torch.arange(G, device="cuda")[None] < n_valid[:, None]).float()
    pmap = torch.zeros(M, G, 256, device="cuda")
    start = torch.randint(1, 10, (M, G), device="cuda", generator=gen)
    ar = torch.arange(M, device="cuda")[:, None]
    gr = torch.arange(G, device="cuda")[None]
    pmap[ar, gr, start] = 0.5
    pmap[ar, gr, start + 1] = 0.5
    logits = torch.randn(M, Q, 256, device="cuda", generator=gen)
    cost = matcher_cost_matrix(logits, boxes(Q), pmap * mask[..., None],
                               boxes(G), mask)
    return cost.transpose(1, 2)


def scipy_host_assignment(cost_mgq, n_valid):
    """The port's earlier path, the yardstick: one copy of the costs and
    counts to the host, scipy on each matrix's valid rows, the assignment
    copied back to the device."""
    import numpy as np
    import torch
    from scipy.optimize import linear_sum_assignment

    M, G, Q = cost_mgq.shape
    host = torch.cat([cost_mgq.reshape(M, -1),
                      n_valid[:, None].float()], 1).cpu().numpy()
    out = np.zeros((M, G), np.int64)
    for m in range(M):
        n = int(host[m, -1])
        rows, cols = linear_sum_assignment(
            host[m, :-1].reshape(G, Q)[:n])
        out[m, rows] = cols
    return torch.from_numpy(out).to(cost_mgq.device)


def host_ms(fn, reps=5):
    """The median host time of `fn` from a synchronized start to a
    synchronized end."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)[reps // 2]


def check_assignment(gen):
    """The assignment kernel bit-equal to its plain version (run on the
    card and on the CPU) at every path's shape (ASSIGNMENT_SHAPES), with
    NaN and infinite costs and with every cost tied; its optimum equal to
    scipy's within 1e-5 relative; timed beside the plain version, its
    bound and scipy on the host with the copies (the port's earlier
    path)."""
    import numpy as np
    import torch
    from scipy.optimize import linear_sum_assignment

    from butd_detr_tpu_torch.ops import _cuda
    from butd_detr_tpu_torch.ops.assignment import (
        batched_linear_sum_assignment as solve,
        batched_linear_sum_assignment_plain as solve_plain,
    )

    lib = _cuda.lib("assignment")
    plan = check_assignment_plan(lib)
    cases = []
    for name, M, G, Q, counts in ASSIGNMENT_SHAPES:
        pick = torch.randint(0, len(counts), (M,), device="cuda",
                             generator=gen)
        n_valid = torch.tensor(counts, device="cuda")[pick]
        cases.append((name, matcher_costs(gen, M, G, Q, n_valid), n_valid))
    M, G, Q = 56, 132, 256
    # every valid row staged in the warp's slice (R), and one row past it
    # read from device memory (R + 1)
    R = plan["rows_staged"]
    for name, n in (("staged_R", R), ("staged_R+1", R + 1)):
        n_valid = torch.full((M,), n, device="cuda")
        cases.append((name, matcher_costs(gen, M, G, Q, n_valid), n_valid))
    n_valid = torch.full((M,), 20, device="cuda")
    nan = matcher_costs(gen, M, G, Q, n_valid).contiguous()
    nan[0, 3] = float("nan")
    nan[1, :, 7] = float("inf")
    nan[2] = float("nan")
    nan[3, 5, 9] = -float("inf")
    cases.append(("nan", nan, n_valid))
    cases.append(("all_tied", torch.full((4, G, Q), 0.5, device="cuda"),
                  torch.tensor([G, 64, 1, 0], device="cuda")))

    row = dict(name="assignment", max_abs_err=0, shapes={}, plan=plan)
    for name, cost, n_valid in cases:
        M, G, Q = cost.shape
        got = solve(cost, n_valid)
        want = solve_plain(cost, n_valid)
        check(torch.equal(got, want),
              f"assignment {name}: kernel != plain on the card "
              f"({int((got != want).sum())} of {got.numel()} rows)")
        check(torch.equal(got.cpu(), solve_plain(cost.cpu(),
                                                 n_valid.cpu())),
              f"assignment {name}: kernel != plain on the CPU")
        # scipy's optimum on the valid rows of the guarded costs
        host = torch.nan_to_num(cost, nan=1e6, posinf=1e6,
                                neginf=-1e6).double().cpu().numpy()
        a = got.cpu().numpy()
        worst = 0.0
        for m, n in enumerate(n_valid.tolist()):
            rows, cols = linear_sum_assignment(host[m, :n])
            best = host[m, rows, cols].sum()
            ours = host[m, np.arange(n), a[m, :n]].sum()
            check(len(set(a[m, :n].tolist())) == n,
                  f"assignment {name}: matrix {m} repeats a column")
            worst = max(worst, abs(ours - best) / max(abs(best), 1e-30))
        check(worst <= 1e-5, f"assignment {name}: optimum {worst:.3g} "
                             "relative from scipy's")
        # a warp stages a matrix's first R valid rows in shared memory;
        # the rows past R are read from device memory
        staged = int(lib.assignment_staged_rows(G, Q))
        entry = dict(matrices=M, targets=G, queries=Q,
                     rows=int(n_valid.sum()),
                     slice_bytes=int(lib.assignment_slice_bytes(G, Q)),
                     rows_staged=staged,
                     matrices_past_staged=int((n_valid > staged).sum()),
                     optimum_rel_err=worst)
        if name in ("training", "cli", "probe", "study", "full",
                    "staged_R", "staged_R+1"):
            before = _cuda.LAUNCHES["assignment"]
            entry["ms"] = time_ms(lambda: solve(cost, n_valid), 20)
            check(_cuda.LAUNCHES["assignment"] == before + 21,
                  f"assignment {name}: not one launch a call")
            entry["device_ms"] = device_ms(lambda: solve(cost, n_valid), 50)
            entry["plain_ms"] = time_ms(lambda: solve_plain(cost, n_valid),
                                        1)
            entry["library_ms"] = host_ms(
                lambda: scipy_host_assignment(cost, n_valid))
            # bytes: the valid rows' costs and the counts read once, the
            # assignment written once; operations: at least one path step
            # a row, 3 additions, a compare and a select a column
            rows = entry["rows"]
            entry["bound_ms"], entry["bound_by"] = bound_ms(
                rows * Q * 4 + M * 8 + M * G * 4,
                [(5 * rows * Q, F32_OPS_PER_S)])
        row["shapes"][name] = entry
        log(f"  assignment {name}: {M} x ({G}, {Q}), {entry['rows']} rows "
            f"solved ({entry['matrices_past_staged']} matrices past R = "
            f"{staged}), bit-equal (card and CPU), optimum within "
            f"{worst:.2g} of scipy's" + (
                f"; {entry['ms']:.4f} ms a call, device "
                f"{entry['device_ms']:.4f} (plain {entry['plain_ms']:.1f}, "
                f"bound {entry['bound_ms']:.5f}, scipy on the host with the "
                f"copies {entry['library_ms']:.2f}); {entry['slice_bytes']} "
                f"B of shared memory a matrix" if "ms" in entry else ""))
    main = row["shapes"]["training"]
    for k in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
              "bound_by"):
        row[k] = main[k]
    for name in ("cli", "probe", "study"):
        for k in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms"):
            row[f"{k}_{name}"] = row["shapes"][name][k]
    return row


def check_assignment_plan(lib):
    """K8's plan for each path's call: matrices (warps) a block, the rows a
    warp stages (R), a matrix's and a block's shared bytes and the blocks
    resident on an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), as
    the kernel's C entries give them; fails unless every path's matcher
    call runs in one wave, or unless ops/assignment.py:assignment_plan,
    the mirror the CPU tests size their cases by, gives the same numbers.
    Returns the plan of a training step's call (56 x (132, 256)), with
    every path's."""
    import torch

    from butd_detr_tpu_torch.ops.assignment import assignment_plan

    dev = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = {}
    for name, M, G, Q, _ in ASSIGNMENT_SHAPES:
        warps = int(lib.assignment_warps(dev, M))
        plan = dict(warps=warps,
                    rows_staged=int(lib.assignment_staged_rows(G, Q)),
                    slice_bytes=int(lib.assignment_slice_bytes(G, Q)),
                    smem_bytes=warps * int(lib.assignment_slice_bytes(G, Q)))
        want = assignment_plan(G, Q, M, sms)
        check(plan == want, f"assignment plan of {M} x ({G}, {Q}): the C "
                            f"entries give {plan}, ops/assignment.py {want}")
        resident = int(lib.assignment_resident_blocks(dev, M, G, Q))
        blocks = -(-M // warps)
        plan.update(resident_blocks_an_sm=resident, sms=sms, blocks=blocks,
                    matrices=M, waves=-(-blocks // max(resident * sms, 1)))
        check(resident > 0 and plan["waves"] == 1,
              f"assignment {name}: {blocks} blocks of {warps} matrices, "
              f"{resident} resident an SM on {sms} SMs: {plan['waves']} "
              "waves")
        log(f"  assignment plan {name}: {M} x ({G}, {Q}): {warps} matrices "
            f"(warps) a block, R = {plan['rows_staged']} rows staged, "
            f"{plan['slice_bytes']} B of shared memory a matrix, "
            f"{plan['smem_bytes']} a block, {resident} blocks resident an SM "
            f"x {sms} SMs; {blocks} blocks: one wave")
        plans[name] = plan
    return plans["training"] | {"by_path": plans}


# ------------------------------------------------------------- phase 5

def compare_gradients_card_cpu(args):
    """One backward pass of a small model on the card and on the CPU, same
    seeded weights and batch, without dropout (eval mode, gradients on):
    the whole chain of kernels against the whole chain of plain versions.
    Integer end points must be equal; should the kps selection differ (an
    f32 near-tie, see compare_card_cpu) the check fails and says so.

    Bound per parameter: 5e-3 * max|g| + 1e-6. The two devices sum in
    other orders, and where that flips a ReLU or a max-pool winner at an
    f32 near-tie a whole row of a gradient moves: the largest error seen
    over seeds 0-5 on an H100 was 1.5e-3 * max|g| (sa1's first conv
    weight, seed 0), the others under 7e-4."""
    import torch

    from butd_detr_tpu_torch.config import butd_cls_config
    from butd_detr_tpu_torch.data import synthetic_batch
    from butd_detr_tpu_torch.lang import tiny_roberta_config
    from butd_detr_tpu_torch.ops import _cuda
    from butd_detr_tpu_torch.train import Trainer

    cfg = butd_cls_config(num_target=64, num_encoder_layers=2,
                          num_decoder_layers=2, num_points=4096,
                          max_num_obj=16, max_det_boxes=16,
                          backbone_bf16=False, attn_precise=True)
    roberta = tiny_roberta_config()
    batch = synthetic_batch(
        batch_size=2, num_points=cfg.num_points,
        max_text_len=cfg.max_text_len, max_num_obj=cfg.max_num_obj,
        max_det_boxes=cfg.max_det_boxes, n_true_det=8, seed=args.seed,
        vocab_size=roberta.vocab_size, spatial_sort=cfg.spatial_sort)
    out = []
    _cuda.reset_launches()
    for dev in ("cuda", "cpu"):
        trainer = Trainer(cfg, roberta_config=roberta,
                          backbone_npoints=(512, 256, 128, 64), device=dev,
                          seed=args.seed)
        trainer.model.eval()
        loss, ep = trainer.loss(trainer.forward(trainer.to_device(batch)))
        loss.backward()
        out.append((
            float(loss.detach()),
            {k: ep[k].cpu() for k in ("sa1_inds", "seed_inds",
                                      "query_points_sample_inds")},
            {n: p.grad.cpu() for n, p in trainer.model.named_parameters()
             if p.grad is not None}))
    launches = dict(_cuda.LAUNCHES)
    check(launches["attention_bwd"] > 0 and launches["scatter"] > 0,
          f"the small model's backward launched no kernel: {launches}")
    # f32 mode at 4096 points: 4 new_xyz, the 4 groupings (none large
    # enough for the grouped gather), 2 interpolations, 2 kps gathers and
    # the loss's one gather of every prefix's matched boxes
    want_gather = 12 + 1
    check(launches["gather"] == want_gather
          and launches["group_gather"] == 0,
          f"the small model launched {launches['gather']} row gathers and "
          f"{launches['group_gather']} grouped gathers, expected "
          f"{want_gather} and 0")
    (loss_c, ints_c, grads_c), (loss_p, ints_p, grads_p) = out
    for k in ints_p:
        check(torch.equal(ints_c[k], ints_p[k]),
              f"gradients card vs CPU: {k} differs, so the two backward "
              f"passes are not of one function")
    check(abs(loss_c - loss_p) <= 1e-4 * abs(loss_p),
          f"gradients card vs CPU: loss {loss_c} vs {loss_p}")
    check(set(grads_c) == set(grads_p) and len(grads_p) > 100,
          "gradients card vs CPU: other parameters have gradients")
    worst = (0.0, "", 0.0, 0.0)
    for name, want in grads_p.items():
        check(bool(torch.isfinite(grads_c[name]).all()),
              f"card: gradient of {name} not finite")
        err = float((grads_c[name] - want).abs().max())
        lim = 5e-3 * float(want.abs().max()) + 1e-6
        check(err <= lim, f"gradients card vs CPU: {name} err {err} > {lim}")
        worst = max(worst, (err / lim, name, err, lim))
    log(f"  loss {loss_c:.6f} (card) vs {loss_p:.6f} (CPU); "
        f"{len(grads_p)} gradients within bound, worst {worst[1]} "
        f"{worst[2]:.3g} <= {worst[3]:.3g}; launches {launches}")
    return dict(loss_card=loss_c, loss_cpu=loss_p, gradients=len(grads_p),
                worst=dict(name=worst[1], err=worst[2], lim=worst[3]),
                launches=launches)


# ------------------------------------------------------------- phase 6

TRAIN_LAUNCHES = {"fps": 4, "ball_query": 4, "group_gather": 4}


def attention_calls(cfg, roberta):
    """Attention calls of one forward: RoBERTa's layers, 5 a BiEncoder
    layer, 4 a decoder layer."""
    return (roberta.num_hidden_layers + 5 * cfg.num_encoder_layers
            + 4 * cfg.num_decoder_layers)


def training_step_launches(cfg, roberta):
    """Launches of one training step: the forward's, the backward of every
    attention call but a frozen text tower's, a scatter-add for each of
    the model's 6 gathers and for the loss's one matched-box gather (all
    prefixes' rows in one call), and the loss's one assignment (all
    prefixes' matrices in one call)."""
    att = attention_calls(cfg, roberta)
    frozen = roberta.num_hidden_layers if cfg.freeze_text_encoder else 0
    return dict(TRAIN_LAUNCHES, attention=att,
                attention_bwd=att - frozen,
                scatter=6 + 1, gather=FORWARD_LAUNCHES["gather"] + 1,
                assignment=1)


def evaluation_batch_launches(cfg, roberta, with_loss=False):
    """Launches of one evaluation batch; with the loss (an evaluation
    without butd_cls), also the loss's one matched-box gather and its
    assignment, each for all prefixes."""
    loss_gathers = int(with_loss)
    return dict(FORWARD_LAUNCHES, attention=attention_calls(cfg, roberta),
                attention_bwd=0, scatter=0,
                gather=FORWARD_LAUNCHES["gather"] + loss_gathers,
                assignment=int(with_loss))


def loss_without_sync(trainer, batch):
    """One step's `compute_hungarian_loss` (the trainer's loss, on the end
    points of a train-mode forward) under
    torch.cuda.set_sync_debug_mode("error"), so that any operation of the
    loss that makes the host wait for the card raises: the matching
    included. Returns the loss and the call's assignment launches."""
    import math

    import torch

    from butd_detr_tpu_torch.ops import _cuda

    end_points = trainer.forward(trainer.to_device(batch))
    torch.cuda.synchronize()
    before = _cuda.LAUNCHES["assignment"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, _ = trainer.loss(end_points)
    except RuntimeError as e:
        raise SmokeFailure(f"compute_hungarian_loss synchronised: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launched = _cuda.LAUNCHES["assignment"] - before
    value = float(loss.detach())
    check(launched == 1, f"the loss launched {launched} assignments, not 1")
    check(math.isfinite(value), f"the loss is {value}")
    log(f"  compute_hungarian_loss under set_sync_debug_mode('error'): no "
        f"synchronisation, loss {value:.3f}, {launched} assignment launch")
    return dict(loss=value, assignment_launches=launched)


def train_steps(args, cfg, roberta, npoints, batches):
    """`Trainer` at full width: 1 warm-up step, then the timed steps.
    Returns the phase's report and the trainer."""
    import math

    import torch

    from butd_detr_tpu_torch.ops import _cuda
    from butd_detr_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    trainer = Trainer(cfg, steps_per_epoch=1000, roberta_config=roberta,
                      backbone_npoints=npoints, device="cuda",
                      seed=args.seed)
    model = trainer.model
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    log(f"  trainer built in {time.perf_counter() - t0:.1f} s "
        f"({n_train / 1e6:.1f}M trainable parameters)")
    text_before = [p.detach().clone()
                   for p in model.text_encoder.parameters()]
    probe = model.decoder_query_proj.weight.detach().clone()
    bn = model.backbone_net.sa1.mlp_module.layer0.bn.bn
    bn_before = bn.running_var.detach().clone()

    trainer.train_step(batches[0])  # warm-up: handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    step_ms, metrics = [], []
    for batch in batches[1:]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        metrics.append(m)
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps = len(step_ms)
    repeat_diff = repeat_step_difference(trainer, batches[-1])

    expect = training_step_launches(cfg, roberta)
    for name, n in expect.items():
        check(launches[name] == n * steps,
              f"{name}: {launches[name]} launches in {steps} training "
              f"steps, expected {n} each")
    for i, m in enumerate(metrics):
        check(all(math.isfinite(v) for v in m.values()),
              f"training step {i}: non-finite metrics {m}")
        check(m["grad_norm"] > 0, f"training step {i}: zero gradient")
    check(all(torch.equal(a, b) for a, b in
              zip(text_before, model.text_encoder.parameters())),
          "the frozen text tower changed")
    check(not torch.equal(probe, model.decoder_query_proj.weight),
          "decoder_query_proj did not move")
    check(not torch.equal(bn_before, bn.running_var)
          and bool(torch.isfinite(bn.running_var).all()),
          "BatchNorm running statistics did not move or are not finite")
    losses = ", ".join(f"{m['loss']:.3f}" for m in metrics)
    norms = ", ".join(f"{m['grad_norm']:.1f}" for m in metrics)
    log(f"  {steps} steps at B={args.train_batch}: "
        f"{', '.join(f'{x:.1f}' for x in step_ms)} ms; loss {losses}; grad "
        f"norm {norms}; peak device memory {peak / 2 ** 30:.2f} GiB; "
        f"launches {launches}")
    log(f"  one step taken twice from the same state and generator: "
        f"largest parameter difference {repeat_diff['max_abs']:.3g} "
        f"({repeat_diff['differing']} of {repeat_diff['tensors']} tensors "
        f"differ; other library kernels may still add with atomics)")
    return dict(batch=args.train_batch, steps=steps, step_ms=step_ms,
                metrics=metrics, launches=launches, per_step=expect,
                peak_memory_bytes=peak, repeat_step=repeat_diff,
                trainable_parameters=n_train), trainer


def repeat_step_difference(trainer, batch):
    """Take one training step, restore the model, optimizer, generator and
    step counter, take it again: the largest difference between the two
    resulting parameter and statistics sets (a number, not a check)."""
    import copy

    import torch

    state = (copy.deepcopy(trainer.model.state_dict()),
             copy.deepcopy(trainer.optimizer.state_dict()),
             trainer.generator.get_state(), trainer.step)
    trainer.train_step(batch)
    first = {k: v.detach().clone()
             for k, v in trainer.model.state_dict().items()}
    trainer.model.load_state_dict(state[0])
    trainer.optimizer.load_state_dict(state[1])
    trainer.generator.set_state(state[2])
    trainer.step = state[3]
    trainer.train_step(batch)
    worst, differing = 0.0, 0
    for k, v in trainer.model.state_dict().items():
        d = (v.double() - first[k].double()).abs().max().item() \
            if v.numel() else 0.0
        worst = max(worst, d)
        differing += d > 0
    return dict(max_abs=worst, differing=differing, tensors=len(first))


# ------------------------------------------------------------- phase 7

# one eval-mode forward in the bf16-backbone mode: 4 new_xyz, 2
# interpolation and 2 kps row gathers; the 4 groupings are grouped gathers
FORWARD_LAUNCHES = {"fps": 4, "ball_query": 4, "gather": 8,
                    "group_gather": 4}


def evaluation_epoch(args, cfg, roberta, npoints, trainer):
    """Save the trainer's weights, restore them into a fresh `TrainTester`
    and run `evaluate_one_epoch` over synthetic scenes through
    `TrainTester.main` (`--eval` with a checkpoint); then a second, warm
    epoch for the time; then a third with the evaluation flags of
    scripts/train_test_det.sh (`--butd` in place of `--butd_cls`), whose
    batches carry the loss, the matching included."""
    import dataclasses
    import tempfile

    import torch

    from butd_detr_tpu_torch.data import SyntheticGroundingDataset
    from butd_detr_tpu_torch.ops import _cuda
    from butd_detr_tpu_torch.predict import build_model
    from butd_detr_tpu_torch.train import TrainTester, save_checkpoint

    n, B = args.eval_scenes, args.train_batch
    scenes = dict(num_points=cfg.num_points, max_text_len=cfg.max_text_len,
                  max_num_obj=cfg.max_num_obj,
                  max_det_boxes=cfg.max_det_boxes,
                  vocab_size=roberta.vocab_size,
                  spatial_sort=cfg.spatial_sort)
    test_set = SyntheticGroundingDataset(n, seed=args.seed + 1000, **scenes)
    epochs = []

    class SmokeTester(TrainTester):
        def get_datasets(self):
            return test_set, test_set

        def _roberta_config(self):
            return roberta

        def get_model(self):
            return build_model(self.cfg, roberta, npoints)

        def evaluate_one_epoch(self, epoch, test_loader, trainer):
            torch.cuda.synchronize()
            _cuda.reset_launches()
            t = time.perf_counter()
            evaluator = super().evaluate_one_epoch(epoch, test_loader,
                                                   trainer)
            torch.cuda.synchronize()
            epochs.append(dict(seconds=time.perf_counter() - t,
                               launches=dict(_cuda.LAUNCHES),
                               batches=len(test_loader),
                               evaluator=evaluator))
            return evaluator

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = save_checkpoint(tmp, args.train_steps, trainer)
        size = os.path.getsize(path)
        log(f"  saved {size / 2 ** 20:.0f} MiB of checkpoint in "
            f"{time.perf_counter() - t0:.1f} s")
        ecfg = dataclasses.replace(
            cfg, batch_size=B, num_workers=0, eval=True,
            checkpoint_path=path, log_dir=os.path.join(tmp, "log"),
            rng_seed=args.seed + 1, print_freq=1)
        tester = SmokeTester(ecfg, device="cuda")
        restored = tester.main()  # the first epoch: restore, evaluate
        saved = trainer.model.state_dict()
        got = restored.model.state_dict()
        check(set(saved) == set(got), "restored model has other entries")
        for k, v in saved.items():
            check(torch.equal(got[k], v), f"restored {k} != saved")
        check(restored.step == trainer.step,
              f"restored step {restored.step} != {trainer.step}")
        check(restored.device.type == "cuda"
              and next(restored.model.parameters()).is_cuda,
              "the evaluation did not run on the card")
        _, test_loader = tester.get_loaders()
        tester.evaluate_one_epoch(args.train_steps + 1, test_loader,
                                  restored)  # the warm, timed epoch
        det = SmokeTester(dataclasses.replace(
            ecfg, butd_cls=False, butd=True,
            log_dir=os.path.join(tmp, "log_det")), device="cuda")
        _, det_loader = det.get_loaders()
        det.evaluate_one_epoch(args.train_steps + 1, det_loader, restored)
    check(len(epochs) == 3, f"{len(epochs)} evaluation epochs ran, not 3")
    with_loss = epochs.pop()
    per_batch_loss = evaluation_batch_launches(cfg, roberta, with_loss=True)
    batches = -(-n // B)
    for name, k in per_batch_loss.items():
        check(with_loss["launches"][name] == k * batches,
              f"{name}: {with_loss['launches'][name]} launches in {batches} "
              f"evaluation batches with the loss, expected {k} each")
    ev = with_loss.pop("evaluator")
    check(type(ev).__name__ == "GroundingEvaluator"
          and ev.gts[("last_", 0.25, 1, "bbf")] == n,
          "the evaluation with the loss did not count every scene once")
    log(f"  an epoch with the loss (train_test_det.sh's --butd): "
        f"{with_loss['seconds'] * 1e3:.1f} ms, launches "
        f"{with_loss['launches']}")

    per_batch = evaluation_batch_launches(cfg, roberta)
    accuracies = {}
    for ep in epochs:
        check(ep["batches"] == batches, f"{ep['batches']} batches")
        for name, k in per_batch.items():
            check(ep["launches"][name] == k * batches,
                  f"{name}: {ep['launches'][name]} launches in {batches} "
                  f"evaluation batches, expected {k} each")
        ev = ep.pop("evaluator")
        for p in tester.prefixes():
            for m in ("bbs", "bbf"):
                check(ev.gts[(p, m)] == n,
                      f"evaluator counted {ev.gts[(p, m)]} samples for "
                      f"{p}{m}, not {n}")
                acc = ev.accuracy(p, m)
                check(0.0 <= acc <= 1.0, f"accuracy {p}{m} = {acc}")
                accuracies[p + m] = acc
        flags = sum(ev.gts[f] for f in ("easy", "hard"))
        check(abs(flags - n) < 1e-6, f"breakdown counted {flags} samples")
    first, warm = epochs
    rate = n / warm["seconds"]
    log(f"  {n} scenes in {batches} batches of {B} (tail of "
        f"{n - (batches - 1) * B}): first epoch {first['seconds']:.2f} s, "
        f"warm epoch {warm['seconds'] * 1e3:.1f} ms = {rate:.1f} scenes/s; "
        f"launches {warm['launches']}")
    log("  accuracies " + ", ".join(f"{k} {v:.3f}"
                                    for k, v in accuracies.items()))
    return dict(scenes=n, batch=B, batches=batches,
                first_epoch_seconds=first["seconds"],
                warm_epoch_seconds=warm["seconds"], scenes_per_second=rate,
                launches=warm["launches"], per_batch=per_batch,
                accuracies=accuracies, checkpoint_bytes=size,
                with_loss=dict(seconds=with_loss["seconds"],
                               launches=with_loss["launches"],
                               per_batch=per_batch_loss))


# ------------------------------------------------------------- phase 8

# scripts/train_test_cls.sh's model, data and optimizer flags at its batch
CLS_FLAGS = [
    "--num_decoder_layers", "6", "--use_color", "--weight_decay", "0.0005",
    "--lr_backbone", "1e-3", "--lr", "1e-4", "--dataset", "sr3d",
    "--test_dataset", "sr3d", "--detect_intermediate", "--joint_det",
    "--use_soft_token_loss", "--use_contrastive_align", "--butd_cls",
    "--self_attend", "--batch_size", "24",
]
CLI_SCENES = dict(n_train=8, n_val=8, objects_per_scan=5,
                  points_per_scan=60_000)
# the repository's two setups as a user starts them (phases 8 and 15 (a)),
# with one epoch, evaluated, and the steps logged
CLS_SCRIPT = os.path.join("scripts", "train_test_cls_torch.sh")
DET_SCRIPT = os.path.join("scripts", "train_test_det_torch.sh")
SCRIPT_RUN_FLAGS = ["--max_epoch", "1", "--num_workers", "4",
                    "--print_freq", "1", "--dp", "1"]


def script_env(root):
    """A setup script's environment: the data root, one process (one
    card)."""
    return {"DATA_ROOT": root, "NPROC_PER_NODE": "1"}


def run_child(cmd, timeout, what, cwd=ROOT, env=None):
    """Run `cmd` from `cwd` (the checkout's root) in a session of its
    own, with `env` added to this process's environment; on timeout kill
    the whole session (the child and its loader workers). Returns its
    output; fails when it exits non-zero."""
    import signal

    proc = subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True,
                            env=dict(os.environ, **(env or {})))
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SmokeFailure(f"{what} did not finish in {timeout} s")
    if proc.returncode != 0:
        tail = "\n".join(out.splitlines()[-40:])
        raise SmokeFailure(f"{what} exited {proc.returncode}:\n{tail}")
    return out


def _accuracies(text):
    """[(name, value)] of every per-prefix accuracy the evaluators logged
    ('<prefix> Box given span (<mode>) Acc: <value>'), in order."""
    out = []
    for line in text.splitlines():
        msg = line.split("INFO: ", 1)[-1]
        if " Acc: " in msg:
            name, value = msg.rsplit(" Acc: ", 1)
            out.append((name, float(value)))
    return out


def _epoch_stats(text):
    """Every `epoch stats` line of a harness log, parsed, in order."""
    return [json.loads(line.split("epoch stats ", 1)[1])
            for line in text.splitlines() if "epoch stats " in line]


def _check_launches(stats, per_step, per_batch, what):
    """Each epoch of `stats` launched `per_step` (a training epoch) or
    `per_batch` (an evaluation) times its batches, kernel by kernel."""
    for x in stats:
        per = per_step if x["phase"] == "train" else per_batch
        for name, n in per.items():
            check(x["launches"][name] == n * x["batches"],
                  f"{what} {x['phase']} epoch {x['epoch']}: {name} "
                  f"launched {x['launches'][name]} times in {x['batches']} "
                  f"batches, expected {n} each")


# the process group of one torchrun process, as the harness logs it
NCCL_WORLD_OF_1 = "process group: backend nccl, world size 1, dp 1, mp 1"


def train_and_evaluate_from_a_data_root(args, cfg, roberta, card, tmp):
    """Write a ScanNet-format root (`make_rich_scannet`) under `tmp/data`,
    build its scan caches with `prepare_data_torch.py`, then train one
    epoch and evaluate through scripts/train_test_cls_torch.sh (torchrun
    and train_torch.py with the flags of scripts/train_test_cls.sh), 4
    loader workers: two processes started as a user starts them. The
    numbers come from the `epoch stats` lines of the run's log. The
    training run is one process over NCCL (phase 12 (c))."""
    from butd_detr_tpu_torch.data import make_rich_scannet

    root = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    make_rich_scannet(root, seed=args.seed, **CLI_SCENES)
    written = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_child([sys.executable, "prepare_data_torch.py", "--data_root",
               root, "--num_workers", "2"], 300, "prepare_data_torch.py")
    prepared = time.perf_counter() - t0
    log(f"  wrote {CLI_SCENES['n_train']} + {CLI_SCENES['n_val']} scenes "
        f"of {CLI_SCENES['points_per_scan']} points in {written:.1f} s; "
        f"prepare_data_torch.py built their caches in {prepared:.1f} s")
    log_dir = os.path.join(tmp, "log")
    # scripts/train_test_cls_torch.sh: torchrun, one process over NCCL
    # (this run is also phase 12 (c)); the detection evaluation below
    # starts train_torch.py without it
    t0 = time.perf_counter()
    run_child(["bash", CLS_SCRIPT, *SCRIPT_RUN_FLAGS, "--val_freq", "1",
               "--save_freq", "1", "--rng_seed", str(args.seed),
               "--log_dir", log_dir],
              600, CLS_SCRIPT, env=script_env(root))
    seconds = time.perf_counter() - t0
    with open(os.path.join(log_dir, "log.txt")) as f:
        text = f.read()
    nccl = NCCL_WORLD_OF_1 in text
    check(nccl, f"{CLS_SCRIPT}: the log names no NCCL world of 1")
    checkpoints = sorted(n for n in os.listdir(log_dir)
                         if n.startswith("ckpt_epoch_"))
    check(checkpoints == ["ckpt_epoch_1.pth"],
          f"checkpoints written: {checkpoints}")
    ckpt = os.path.join(log_dir, checkpoints[0])
    grounding = ground_from_the_checkpoint(args, cfg, roberta, root,
                                           ckpt)
    detection = detection_epoch_from_the_checkpoint(
        args, cfg, roberta, root, ckpt, os.path.join(tmp, "det_log"))

    stats = _epoch_stats(text)
    check([s["phase"] for s in stats] == ["train", "eval", "eval"],
          f"epochs run: {[s['phase'] for s in stats]}")
    train, evals = stats[0], stats[1:]
    steps = train["batches"]
    check(steps >= 1 and train["scenes"] == steps * 24,
          f"{steps} training steps for {train['scenes']} scenes")
    losses = _finite_metrics(text, 1)
    check(len(losses) == steps, f"{len(losses)} logged steps of {steps}")
    check(train["peak_memory_bytes"] is not None,
          "the training epoch did not run on the card")
    per_step = training_step_launches(cfg, roberta)
    for name, n in per_step.items():
        check(train["launches"][name] == n * steps,
              f"{name}: {train['launches'][name]} launches in {steps} "
              f"training steps, expected {n} each")
    per_batch = evaluation_batch_launches(cfg, roberta)
    for ev in evals:
        check(ev["scenes"] == 5 * CLI_SCENES["n_val"]
              and ev["batches"] == -(-ev["scenes"] // 24),
              f"evaluated {ev['scenes']} scenes in {ev['batches']} batches")
        for name, n in per_batch.items():
            check(ev["launches"][name] == n * ev["batches"],
                  f"{name}: {ev['launches'][name]} launches in "
                  f"{ev['batches']} evaluation batches, expected {n} each")
    logged = _accuracies(text)
    modes = 2 * (cfg.num_decoder_layers + 1)  # 7 prefixes x bbs, bbf
    check(len(logged) == modes * len(evals),
          f"{len(logged)} accuracies logged, not {modes * len(evals)}")
    check(all(0.0 <= v <= 1.0 for _, v in logged),
          f"an accuracy outside [0, 1]: {logged}")
    accuracies = dict(logged[-modes:])
    ev = evals[-1]
    def ms(xs):
        return ", ".join(f"{x * 1e3:.0f}" for x in xs)

    log(f"  {CLS_SCRIPT} (torchrun, NCCL, world size 1) ran {seconds:.1f} "
        f"s: {steps} steps at B = 24 "
        f"({train['scenes']} scenes), {train['scenes_per_second']:.2f} "
        f"scenes/s over the epoch ({train['seconds']:.2f} s), loader wait "
        f"{train['loader_wait_share']:.1%} of it (the first batch "
        f"{train['first_batch_wait_seconds']:.2f} s), steps "
        f"{ms(train['batch_seconds'])} ms, peak device memory "
        f"{train['peak_memory_bytes'] / 1e9:.2f} GB; losses "
        f"{', '.join(f'{x:.3f}' for x in losses)}")
    log(f"  evaluation: {ev['scenes']} scenes in {ev['batches']} batches, "
        f"{ev['scenes_per_second']:.2f} scenes/s (the first epoch "
        f"{evals[0]['scenes_per_second']:.2f}), loader wait "
        f"{ev['loader_wait_share']:.1%}, batches {ms(ev['batch_seconds'])} "
        f"ms, peak device memory {ev['peak_memory_bytes'] / 1e9:.2f} GB; "
        f"card {card}")
    log("  accuracies " + ", ".join(f"{k} {v:.3f}"
                                    for k, v in accuracies.items()))
    log(f"  predict_torch.py ran {grounding['cli_seconds']:.1f} s (the "
        f"process, start to end); the same request in process "
        f"{grounding['request_ms']:.1f} ms warm; top-10 scores "
        f"{', '.join(f'{x:.3f}' for x in grounding['scores'])}; card "
        f"{card}")
    det = detection["stats"]
    log(f"  detection evaluation (train_torch.py --eval --test_dataset "
        f"scannet) ran {detection['seconds']:.1f} s: {det['scenes']} scenes "
        f"in {det['batches']} batch(es), {det['scenes_per_second']:.2f} "
        f"scenes/s over the epoch ({det['seconds']:.2f} s), of which the "
        f"projection, NMS and AP {det['detection_seconds']:.3f} host s "
        f"(the end points' copy to the host, which waits for the forward "
        f"pass, {det['detection_copy_seconds']:.3f} s); "
        + ", ".join(f"mAP@{t} {m['mAP']:.4f} AR@{t} {m['AR']:.4f}"
                    for t, m in detection["metrics"].items())
        + f"; card {card}")
    launches = {k: train["launches"][k] + det["launches"][k]
                + grounding["launches"][k] + grounding["launches_bf16"][k]
                + sum(e["launches"][k] for e in evals)
                for k in train["launches"]}
    return dict(seconds=seconds, prepare_seconds=prepared, steps=steps,
                nccl=nccl, losses=losses, train=train, evaluations=evals,
                per_step=per_step, per_batch=per_batch,
                accuracies=accuracies, card=card, grounding=grounding,
                detection=detection, launches=launches)


# a request of the command line: one val scene of phase 8's root
CLI_REQUEST = ("the chair next to the wooden table", "chair")


def ground_from_the_checkpoint(args, cfg, roberta, root, ckpt):
    """`predict_torch.py` as a user starts it, on one val scan of `root`
    with the checkpoint `train_torch.py` wrote and its flags; its JSON
    must parse and its 10 boxes and scores be finite (the child process
    gives the command's wall seconds). The same command line then runs in
    this process, `predict_torch.main(argv)`, with the launch counts set
    to 0 just before and read just after: it must launch a request's
    kernels (phase 3) and print the child's answer. Both must equal an
    in-process `GroundingPredictor.from_checkpoint(...).predict` on the
    same scan, which gives the warm request's ms."""
    import contextlib
    import io

    import numpy as np
    import torch

    from butd_detr_tpu_torch.config import parse_config
    from butd_detr_tpu_torch.data.scan import Scan
    from butd_detr_tpu_torch.lang import get_tokenizer
    from butd_detr_tpu_torch.ops import _cuda
    from butd_detr_tpu_torch.predict import GroundingPredictor

    with open(os.path.join(root, "meta_data", "scannetv2_val.txt")) as f:
        scan_id = f.read().split()[0]
    utterance, phrase = CLI_REQUEST
    argv = [*CLS_FLAGS, "--data_root", root, "--checkpoint_path", ckpt,
            "--scan_id", scan_id, "--utterance", utterance,
            "--phrase", phrase, "--top_k", "10"]
    t0 = time.perf_counter()
    out = run_child([sys.executable, "predict_torch.py", *argv], 300,
                    "predict_torch.py")
    cli_seconds = time.perf_counter() - t0
    lines = [x for x in out.splitlines() if x.startswith("{")]
    check(bool(lines), f"predict_torch.py printed no JSON:\n{out[-2000:]}")
    answer = json.loads(lines[-1])
    check([answer[k] for k in ("scan_id", "utterance", "phrase", "mode")]
          == [scan_id, utterance, phrase, "bbf"],
          f"predict_torch.py answered {lines[-1][:300]}")
    boxes = np.asarray(answer["boxes_cxcyczwhd"], np.float64)
    scores = np.asarray(answer["scores"], np.float64)
    check(boxes.shape == (10, 6) and scores.shape == (10,)
          and np.isfinite(boxes).all() and np.isfinite(scores).all(),
          f"predict_torch.py: boxes {boxes.shape}, scores {scores.shape}, "
          "or not finite")

    # the entry point's own launches: its main, in this process
    import predict_torch

    pcfg = parse_config(CLS_FLAGS)
    printed = io.StringIO()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    with contextlib.redirect_stdout(printed):
        predict_torch.main(argv)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    expect = dict(FORWARD_LAUNCHES, attention=attention_calls(pcfg, roberta),
                  assignment=0)
    for name, n in expect.items():
        check(launches[name] == n, f"predict_torch.main: {launches[name]} "
              f"{name} launches, expected {n}")
    check(json.loads(printed.getvalue().splitlines()[-1]) == answer,
          "predict_torch.main in process answered otherwise than the "
          f"child process: {printed.getvalue()[-300:]}")
    torch.cuda.empty_cache()

    # the same command line with --use_bf16: the f32 checkpoint loads
    # into the bf16-compute model, which launches a request's kernels
    printed = io.StringIO()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    with contextlib.redirect_stdout(printed):
        predict_torch.main([*argv, "--use_bf16"])
    torch.cuda.synchronize()
    launches_bf16 = dict(_cuda.LAUNCHES)
    for name, n in expect.items():
        check(launches_bf16[name] == n, f"predict_torch.main --use_bf16: "
              f"{launches_bf16[name]} {name} launches, expected {n}")
    answer_bf16 = json.loads(printed.getvalue().splitlines()[-1])
    boxes_bf16 = np.asarray(answer_bf16["boxes_cxcyczwhd"], np.float64)
    check(boxes_bf16.shape == (10, 6) and np.isfinite(boxes_bf16).all()
          and np.isfinite(answer_bf16["scores"]).all(),
          f"predict_torch.py --use_bf16 answered {printed.getvalue()[-300:]}")
    log(f"  predict_torch.main --use_bf16 in process: launches "
        f"{ {k: v for k, v in launches_bf16.items() if v} }; top box "
        f"{np.round(boxes_bf16[0], 3).tolist()} (f32 "
        f"{np.round(boxes[0], 3).tolist()})")
    torch.cuda.empty_cache()


    pred = GroundingPredictor.from_checkpoint(
        pcfg, ckpt, get_tokenizer(max_len=pcfg.max_text_len),
        roberta_config=roberta, device="cuda")
    scan = Scan(scan_id, os.path.join(root, "scans"),
                meta_dir=os.path.join(root, "meta_data"))
    cloud = np.concatenate([scan.orig_pc, scan.color], axis=1)

    def request():
        return pred.predict(cloud, utterance, phrase=phrase, top_k=10)

    request()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = request()
    request_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(boxes, want["boxes"].astype(np.float64))
          and np.array_equal(scores, want["scores"].astype(np.float64)),
          "predict_torch.py's boxes or scores differ from the in-process "
          f"predictor's: {scores} vs {want['scores']}")
    del pred
    torch.cuda.empty_cache()
    return dict(scan_id=scan_id, cli_seconds=cli_seconds,
                request_ms=request_ms, scores=scores.tolist(),
                launches=launches, launches_bf16=launches_bf16,
                scores_bf16=answer_bf16["scores"])


def detection_epoch_from_the_checkpoint(args, cfg, roberta, root, ckpt,
                                        log_dir):
    """`train_torch.py --eval --test_dataset scannet --checkpoint_path`
    with the checkpoint's flags: the detection evaluation on the 18-class
    prompt over `root`'s val scenes. mAP and AR must lie in [0, 1] at
    every `ap_iou_thresholds`, and every batch launch an evaluation
    batch's kernels (phase 7, without the loss: `--butd_cls`)."""
    flags = list(CLS_FLAGS)
    flags[flags.index("--test_dataset") + 1] = "scannet"
    t0 = time.perf_counter()
    run_child([sys.executable, "train_torch.py", *flags, "--eval",
               "--checkpoint_path", ckpt, "--num_workers", "4",
               "--print_freq", "1", "--rng_seed", str(args.seed),
               "--data_root", root, "--log_dir", log_dir], 600,
              "train_torch.py --eval --test_dataset scannet")
    seconds = time.perf_counter() - t0
    with open(os.path.join(log_dir, "log.txt")) as f:
        text = f.read()
    stats = _epoch_stats(text)
    check([s["phase"] for s in stats] == ["eval"],
          f"detection evaluation: epochs run {[s['phase'] for s in stats]}")
    stats = stats[0]
    check(stats["scenes"] == CLI_SCENES["n_val"]
          and stats["batches"] == -(-stats["scenes"] // 24),
          f"detection evaluation: {stats['scenes']} scenes in "
          f"{stats['batches']} batches")
    per_batch = evaluation_batch_launches(cfg, roberta)
    for name, n in per_batch.items():
        check(stats["launches"][name] == n * stats["batches"],
              f"detection evaluation: {stats['launches'][name]} {name} "
              f"launches in {stats['batches']} batches, expected {n} each")
    metrics, threshold = {}, None
    for line in text.splitlines():
        msg = line.split("INFO: ", 1)[-1]
        if msg.startswith("=====> last_ IOU THRESH: "):
            threshold = float(msg.split(": ", 1)[1].split()[0])
        elif msg.startswith("mAP ") and threshold is not None:
            fields = msg.split()
            metrics[threshold] = dict(mAP=float(fields[1]),
                                      AR=float(fields[3]))
    check(sorted(metrics) == [0.25, 0.5],
          f"detection evaluation: metrics at {sorted(metrics)}")
    check(all(0.0 <= v <= 1.0 for m in metrics.values() for v in m.values()),
          f"detection evaluation: mAP or AR outside [0, 1]: {metrics}")
    return dict(seconds=seconds, stats=stats, metrics=metrics)


# ------------------------------------------------------------- phases 9, 10

def _finite_metrics(text, epoch):
    """The loss values of every 'Train: [epoch][' line of a harness log;
    fails on a non-finite one."""
    import math

    losses = []
    for line in text.splitlines():
        if f"Train: [{epoch}][" not in line:
            continue
        fields = line.split("] ", 2)[-1].split()
        values = dict(zip(fields[::2], map(float, fields[1::2])))
        check(all(math.isfinite(v) for v in values.values()),
              f"non-finite training metrics: {line}")
        losses.append(values["loss"])
    return losses


def overfit_probe(args, root, card):
    """scripts/overfit_probe_torch.py as a child process with the JAX
    package's jax_b12_nt32 invocation (12 fixed samples, 5,000 points, the
    small text tower from text_init.npz, trainable; 32 queries, eos 0.02;
    220 steps, a probe every 15). Every probe row is printed beside the
    JAX row of the same step; fails unless every value is finite, the last
    prefix's matched CE at step 220 is below 0.75 x its step-0 value, and
    every training step and probe forward launched the worked-out
    counts."""
    import math
    import tempfile

    from butd_detr_tpu_torch.lang import small_text_roberta_config

    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "probe")
        t0 = time.perf_counter()
        text = run_child(
            [sys.executable, os.path.join("scripts", "overfit_probe_torch.py"),
             "--data", root, "--out", out_dir, "--seed", str(args.seed),
             *PROBE_FLAGS], 900, "overfit_probe_torch.py")
        seconds = time.perf_counter() - t0
        with open(os.path.join(out_dir, "probe.jsonl")) as f:
            rows = [json.loads(line) for line in f]
    summary = json.loads(text.strip().splitlines()[-1])
    with open(os.path.join(ROOT, "studies", "attrib_r5", "jax_b12_nt32",
                           "probe.jsonl")) as f:
        jax_rows = {r["step"]: r for r in map(json.loads, f)}
    steps = [r["step"] for r in rows]
    check(steps == [*range(0, 220, 15), 220], f"probe steps {steps}")
    check(all(math.isfinite(v) for r in rows for v in r.values()),
          "a probe value is not finite")
    first, last = rows[0]["last_matched_ce"], rows[-1]["last_matched_ce"]
    keys = ("last_matched_ce", "last_eos_ce", "last_p_span",
            "proposal_matched_ce", "last_acc")
    for r in rows:
        j = jax_rows.get(r["step"], {})
        log(f"  step {r['step']:3d}: " + ", ".join(
            f"{k} {r[k]:.3f} (JAX {j[k]:.3f})" if k in j else
            f"{k} {r[k]:.3f}" for k in keys))
    cfg, roberta = study_configs()[0][1], small_text_roberta_config()
    per_step = training_step_launches(cfg, roberta)
    per_probe = evaluation_batch_launches(cfg, roberta)
    n_steps, n_probes = summary["steps"], summary["probes"]
    for name, n in per_step.items():
        check(summary["train_launches"][name] == n * n_steps,
              f"probe: {name} launched {summary['train_launches'][name]} "
              f"times in {n_steps} steps, expected {n} each")
    for name, n in per_probe.items():
        check(summary["probe_launches"][name] == n * n_probes,
              f"probe: {name} launched {summary['probe_launches'][name]} "
              f"times in {n_probes} probe forwards, expected {n} each")
    check(summary["finite"], "the probe's last training metrics are not "
          "finite")
    check(last < 0.75 * first,
          f"last_matched_ce {last} at step 220 is not below 0.75 x its "
          f"step-0 value {first}")
    log(f"  overfit_probe_torch.py ran {seconds:.1f} s: {n_steps} steps at "
        f"B = 12, {summary['seconds_per_step'] * 1e3:.1f} ms a step; "
        f"last_matched_ce {first:.3f} -> {last:.3f} (JAX "
        f"{jax_rows[0]['last_matched_ce']} -> "
        f"{jax_rows[220]['last_matched_ce']}); launches a step {per_step}, "
        f"a probe {per_probe}; card {card}")
    return dict(seconds=seconds, rows=rows, summary=summary,
                per_step=per_step, per_probe=per_probe,
                launches={k: summary["train_launches"][k]
                          + summary["probe_launches"][k]
                          for k in summary["train_launches"]})


def study_with_resume(args, root, card, out_dir):
    """scripts/accuracy_study_torch.py with the nt32 study's flags, cut to
    24 train and 8 val scenes and 2 epochs, evaluated each epoch, into
    `out_dir` (its data a link to `root`): epoch 1 in one process, epoch
    2 in a second that resumes its checkpoint. Fails unless both exit 0,
    the history has rows at epochs 1 and 2 with the step count continuing
    across the resume, every accuracy lies in [0, 1], every logged loss is
    finite, and every step and evaluation batch launched the worked-out
    counts."""
    from butd_detr_tpu_torch.lang import small_text_roberta_config

    os.makedirs(out_dir)
    os.symlink(root, os.path.join(out_dir, "data"))
    cmd = [sys.executable, os.path.join("scripts", "accuracy_study_torch.py"),
           "--out", out_dir, *STUDY_FLAGS,
           "--n_train", str(STUDY_SCENES["n_train"]),
           "--n_val", str(STUDY_SCENES["n_val"])]
    seconds = []
    for extra, what in ((["--epochs", "1"], "epoch 1"),
                        (["--epochs", "2", "--resume", os.path.join(
                            out_dir, "log", "ckpt_epoch_1.pth")],
                         "epoch 2, resumed")):
        t0 = time.perf_counter()
        run_child(cmd + extra, 900, f"accuracy_study_torch.py ({what})")
        seconds.append(time.perf_counter() - t0)
    with open(os.path.join(out_dir, "history.jsonl")) as f:
        history = [json.loads(line) for line in f]
    with open(os.path.join(out_dir, "log", "log.txt")) as f:
        text = f.read()

    check([r["epoch"] for r in history] == [1, 1, 2, 2],
          f"history epochs {[r['epoch'] for r in history]}")
    s1, s2 = history[0]["step"], history[2]["step"]
    check(s1 > 0 and s2 == 2 * s1 and history[1]["step"] == s1
          and history[3]["step"] == s2,
          f"history steps {[r['step'] for r in history]}")
    accs = [v for r in history for k, v in r.items() if k.startswith("acc")]
    check(len(accs) == 16 and all(0.0 <= v <= 1.0 for v in accs),
          f"accuracies {accs}")
    check("restored " in text and "start_epoch=2" in text,
          "the second process did not resume epoch 1's checkpoint")
    losses = _finite_metrics(text, 1) + _finite_metrics(text, 2)
    check(len(losses) == 2 * (s1 // 10), f"{len(losses)} logged windows")
    stats = _epoch_stats(text)
    check([x["phase"] for x in stats] == ["train", "eval", "eval"] * 2,
          f"epochs run: {[x['phase'] for x in stats]}")
    cfg, roberta = study_configs()[1][1], small_text_roberta_config()
    per_step = training_step_launches(cfg, roberta)
    per_batch = evaluation_batch_launches(cfg, roberta)
    _check_launches(stats, per_step, per_batch, "study")
    trains = [x for x in stats if x["phase"] == "train"]
    evals = [x for x in stats if x["phase"] == "eval"]
    check(all(x["peak_memory_bytes"] is not None for x in stats),
          "the study did not run on the card")
    steps_ms = ", ".join(f"{t * 1e3:.0f}" for t in trains[1]["batch_seconds"])
    log(f"  accuracy_study_torch.py: epoch 1 in {seconds[0]:.1f} s, epoch 2 "
        f"(resumed) in {seconds[1]:.1f} s; {s1} steps an epoch at B = 24, "
        f"steps {steps_ms} ms in epoch 2 ({trains[1]['scenes_per_second']:.2f} scenes/s, "
        f"loader wait {trains[1]['loader_wait_share']:.1%}, peak "
        f"{trains[1]['peak_memory_bytes'] / 1e9:.2f} GB); evaluation "
        f"{evals[-1]['scenes_per_second']:.2f} scenes/s warm; history "
        f"{history[2]}; launches a step {per_step}, a batch {per_batch}; "
        f"card {card}")
    return dict(seconds=seconds, history=history, losses=losses,
                epochs=stats, per_step=per_step, per_batch=per_batch,
                launches={k: sum(x["launches"][k] for x in stats)
                          for k in stats[0]["launches"]})


# ------------------------------------------------------------- phase 4

# the default mode (bf16 backbone MLPs, bf16-operand K3) against the f32
# CPU run, on the same queries: every float end point (the backbone's
# features, the encoder's, the kps logits, every prefix's box centres and
# sizes in metres and its class and contrastive scores) must lie within
# 1e-2 + 2^-8 * max|CPU| (a bf16 rounding of the end point's largest
# value, plus 1 cm / 0.01 of a score); a reduced-size CPU rehearsal
# (8,192 points, 128 queries) gave at most 3.5e-3 on boxes and 4.5e-3 on
# scores. The largest error of each group is logged.
DEFAULT_MODE_GROUPS = {
    "boxes": ("center", "pred_size"),
    "scores": ("sem_cls_scores", "proj_queries"),
}


def default_mode_bound(want):
    import numpy as np

    return 1e-2 + 2.0 ** -8 * float(np.abs(want).max())


# `--use_bf16` (the whole model in bf16, K3 and K4 reading bf16 operands)
# against the same f32 CPU run: every float end point within 5e-2 + 2^-6 *
# max|CPU| (four bf16 roundings of the end point's largest value, plus 5
# cm / 0.05 of a score). A CPU rehearsal (8,192 points, 128 queries, the
# plain versions in bf16) gave at most 6.3e-2 (`text_feats`, max|CPU|
# 3.1: 0.64 of this bound), boxes 4.0e-2 (max 6.0), scores 2.9e-2 (max
# 2.5), the xyz end points one bf16 rounding (1.6e-2 at 6 m); 127 of 128
# kps ranks differed, all near-ties.
def bf16_mode_bound(want):
    import numpy as np

    return 5e-2 + 2.0 ** -6 * float(np.abs(want).max())


def _group(key):
    """The end-point group of `key`, for the default mode's log."""
    for name, suffixes in DEFAULT_MODE_GROUPS.items():
        if key.endswith(suffixes):
            return name
    if key.startswith(("sa", "fp2")):
        return "backbone"
    return "encoder" if key in ("seed_features", "text_feats",
                                "text_memory", "proj_tokens",
                                "seeds_obj_cls_logits") else "queries"


def _near_tie_selection(card, logits_cpu):
    """The card run's kps selection against the CPU's top k: (the card's
    selection, ranks that differ, the largest CPU-logit gap at such a
    rank, the logits' error). A rank may differ only where the CPU logits
    lie within twice the logits' card-vs-CPU error."""
    from butd_detr_tpu_torch.models import top_k_stable

    logits_card = card["seeds_obj_cls_logits"]
    inds_c = card["query_points_sample_inds"].long()
    inds_p = top_k_stable(logits_cpu, inds_c.shape[1])
    n_diff = int((inds_c != inds_p).sum())
    logit_err = float((logits_card - logits_cpu).abs().max())
    gap = float((logits_cpu.gather(1, inds_c)
                 - logits_cpu.gather(1, inds_p)).abs().max())
    return inds_c, n_diff, gap, logit_err


def compare_card_cpu(args, roberta, npoints, scene, utterance):
    """One request in f32 with the precise attention mode, on the card
    (kernels) and on the CPU (plain versions), with the same seeded
    weights. Integer end points must be equal and floats within
    1e-3 + 5e-3 * std(CPU).

    The kps selection takes the top 256 of 1024 f32 logits; among 1024
    values some neighbours lie closer than the two devices' f32 rounding
    differences, so the card's order may swap such a near-tie. The check:
    the selections are equal, or every rank where they differ holds CPU
    logits within twice the logits' measured card-vs-CPU error. The CPU
    decoder then runs on the card's selection, so every later end point is
    compared on the same queries.

    Then the same request on the card in the default mode (bf16 backbone
    MLPs, bf16-operand K3; the same weights), held against the same f32
    CPU run with the same near-tie protocol (the CPU decoder runs again,
    on this run's selection; the kps logits are first held within the
    bound below, so that a fault there cannot widen its own near-tie
    tolerance): the integer end points of the backbone equal, every float
    end point (backbone, encoder, queries, every prefix's boxes and
    scores) within 1e-2 + 2^-8 * max|CPU| (`default_mode_bound`); the
    largest error of every end-point group is logged. And so, once more,
    with `--use_bf16` (the whole model in bf16, K3 reading bf16
    operands), within `bf16_mode_bound`."""
    import numpy as np
    import torch

    from butd_detr_tpu_torch.config import butd_cls_config
    from butd_detr_tpu_torch.ops import _cuda
    from butd_detr_tpu_torch.predict import GroundingPredictor

    cfg32 = butd_cls_config(backbone_bf16=False, attn_precise=True)
    cfg_default = butd_cls_config()
    cfg_bf16 = butd_cls_config(use_bf16=True)
    cloud, boxes, cids = scene
    preds = {}
    for name, cfg, dev in (("cuda", cfg32, "cuda"), ("cpu", cfg32, "cpu"),
                           ("default", cfg_default, "cuda"),
                           ("bf16", cfg_bf16, "cuda")):
        preds[name] = GroundingPredictor(cfg, roberta_config=roberta,
                                         backbone_npoints=npoints,
                                         device=dev, seed=args.seed)
    weights = preds["cuda"].model.state_dict()
    for mode in ("default", "bf16"):
        check(all(torch.equal(v, weights[k]) for k, v in
                  preds[mode].model.state_dict().items()),
              f"the {mode}-mode model's weights differ from the f32 model's")
    with torch.inference_mode():
        t = time.perf_counter()
        pc = preds["cuda"]
        _cuda.reset_launches()
        card = pc.model(pc.make_inputs(cloud, utterance, boxes, cids))
        card = {k: v.cpu() for k, v in card.items()}
        # f32 mode: xyz and features are grouped as one payload, at the
        # first tier by the grouped gather and at the others by the row
        # gather, beside its 8 launches of the default mode
        check(_cuda.LAUNCHES["gather"] == FORWARD_LAUNCHES["gather"] + 3
              and _cuda.LAUNCHES["group_gather"] == 1,
              f"f32 request: {_cuda.LAUNCHES['gather']} row gathers and "
              f"{_cuda.LAUNCHES['group_gather']} grouped gathers, expected "
              f"{FORWARD_LAUNCHES['gather'] + 3} and 1")
        log(f"  card forward {time.perf_counter() - t:.1f} s")
        modes = {}
        for mode, cfg in (("default", cfg_default), ("bf16", cfg_bf16)):
            pd = preds[mode]
            _cuda.reset_launches()
            out = pd.model(pd.make_inputs(cloud, utterance, boxes, cids))
            modes[mode] = {k: v.float().cpu() if v.is_floating_point()
                           else v.cpu() for k, v in out.items()}
            expect = dict(FORWARD_LAUNCHES,
                          attention=attention_calls(cfg, roberta))
            for name, n in expect.items():
                check(_cuda.LAUNCHES[name] == n,
                      f"{mode}-mode request: {_cuda.LAUNCHES[name]} {name} "
                      f"launches, expected {n}")
        check(out["last_center"].dtype == torch.bfloat16,
              f"--use_bf16 request: centres in {out['last_center'].dtype}")
        t = time.perf_counter()
        pp = preds["cpu"]
        encoded, detected = pp.model.encode(
            pp.make_inputs(cloud, utterance, boxes, cids))
        logits_p = encoded["seeds_obj_cls_logits"]
        inds_c, n_diff, gap, logit_err = _near_tie_selection(card, logits_p)
        check(n_diff == 0 or gap <= 2 * logit_err,
              f"kps selection: {n_diff} ranks differ by up to {gap} in "
              f"logit, more than twice the logits' error {logit_err}")
        selections = {}
        for mode, bound in (("default", default_mode_bound),
                            ("bf16", bf16_mode_bound)):
            inds_d, d_diff, d_gap, d_logit_err = _near_tie_selection(
                modes[mode], logits_p)
            check(d_logit_err <= bound(logits_p.numpy()),
                  f"{mode} mode: seeds_obj_cls_logits err {d_logit_err} > "
                  f"{bound(logits_p.numpy())}")
            check(d_diff == 0 or d_gap <= 2 * d_logit_err,
                  f"{mode} mode, kps selection: {d_diff} ranks differ by up "
                  f"to {d_gap} in logit, more than twice the logits' error "
                  f"{d_logit_err}")
            selections[mode] = (inds_d, d_diff, d_gap, d_logit_err)
        cpu = pp.model.decode({k: v.clone() for k, v in encoded.items()},
                              detected, inds_c.to(torch.int32))
        cpu_modes = {mode: pp.model.decode(
            {k: v.clone() for k, v in encoded.items()}, detected,
            sel[0].to(torch.int32)) for mode, sel in selections.items()}
        log(f"  cpu forward {time.perf_counter() - t:.1f} s")
    del preds
    log(f"  kps selection: {n_diff} of {inds_c.numel()} ranks differ "
        f"(largest CPU-logit gap at a differing rank {gap:.3g}; logits' "
        f"card-vs-CPU error {logit_err:.3g})")
    worst, ints = [], []
    for key, want in cpu.items():
        want = want.numpy()
        got = card[key].numpy()
        if want.dtype.kind in "iub":
            if key != "query_points_sample_inds":
                check(np.array_equal(got, want),
                      f"card vs CPU: {key} differs")
                ints.append(key)
            continue
        check(np.isfinite(got).all(), f"card: {key} not finite")
        err = float(np.abs(got.astype(np.float64) - want).max())
        lim = 1e-3 + 5e-3 * float(np.std(want))
        worst.append((err / lim, key, err, lim))
        check(err <= lim, f"card vs CPU: {key} err {err} > {lim}")
    worst.sort(reverse=True)
    log(f"  equal: {', '.join(ints)}; {len(worst)} float end points "
        f"within bound, worst {worst[0][1]} {worst[0][2]:.3g} <= "
        f"{worst[0][3]:.3g}")

    # the default and bf16 modes against the f32 CPU run, each on its own
    # selection
    report = dict(kps_ranks_differing=n_diff, kps_gap=gap,
                  logit_err=logit_err, equal_ints=ints,
                  worst=[dict(key=k, err=e, lim=lm)
                         for _, k, e, lm in worst[:5]])
    for mode, bound in (("default", default_mode_bound),
                        ("bf16", bf16_mode_bound)):
        inds_d, d_diff, d_gap, d_logit_err = selections[mode]
        groups = {}
        for key, want in cpu_modes[mode].items():
            want = want.numpy()
            got = modes[mode][key].numpy()
            if want.dtype.kind in "iub":
                if key.startswith(("sa", "fp2", "seed_inds")):
                    check(np.array_equal(got, want),
                          f"{mode} mode vs CPU: {key} differs")
                continue
            check(np.isfinite(got).all(), f"{mode} mode: {key} not finite")
            err = float(np.abs(got.astype(np.float64) - want).max())
            lim = bound(want)
            name = _group(key)
            check(err <= lim, f"{mode} mode vs CPU: {key} err {err} > {lim}")
            if err / lim > groups.get(name, {}).get("ratio", -1.0):
                groups[name] = dict(key=key, err=err, lim=lim,
                                    ratio=err / lim,
                                    max_abs=float(np.abs(want).max()))
        log(f"  {mode} mode: kps selection {d_diff} of {inds_d.numel()} "
            f"ranks differ (largest CPU-logit gap {d_gap:.3g}; logits' "
            f"error {d_logit_err:.3g}); largest error by group: "
            + "; ".join(f"{name} {g['key']} {g['err']:.3g} (bound "
                        f"{g['lim']:.3g}, max|CPU| {g['max_abs']:.3g})"
                        for name, g in groups.items()))
        report[f"{mode}_mode"] = dict(
            kps_ranks_differing=d_diff, kps_gap=d_gap,
            logit_err=d_logit_err, groups=groups)
    return report


# ------------------------------------------------------------- phase 11

# device-busy groups of the --use_bf16 phase
BUSY_GROUPS = (("attention", ("attention_",)),
               ("matmul", ("gemm", "sgemm", "cutlass", "gemv", "xmma",
                           "nvjet")))


def device_busy_ms(fn, reps=2):
    """fn() under torch.profiler: (device-busy ms a call, by group:
    matrix products, the attention kernels, the rest)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    groups = {"matmul": 0.0, "attention": 0.0, "other": 0.0}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = evt.key.lower()
        group = next((g for g, keys in BUSY_GROUPS
                      if any(k in name for k in keys)), "other")
        groups[group] += dev_us / 1e3 / reps
    return sum(groups.values()), groups


def bf16_mode(args, cfg, roberta, npoints, scenes, batches, card):
    """`--use_bf16` beside the default mode, in one process: for each
    mode a predictor and a trainer at full width (the same seed, so the
    same weights), one warm request and step, then the timed requests and
    steps (launches counted, peak memory), and one request and one step
    under torch.profiler for the device-busy ms by group. The bf16 steps
    must be finite and launch each step's kernels as the default's
    (section 4 of PERF.md), and the bf16 loss must not synchronise."""
    import math

    import numpy as np
    import torch

    from butd_detr_tpu_torch.config import butd_cls_config
    from butd_detr_tpu_torch.ops import _cuda
    from butd_detr_tpu_torch.predict import GroundingPredictor
    from butd_detr_tpu_torch.train import Trainer

    out = {"card": card}
    cloud, boxes, cids = scenes[0]
    utt, phrase = REQUESTS[0]
    for mode, mcfg in (("default", cfg),
                       ("bf16", butd_cls_config(use_bf16=True))):
        pred = GroundingPredictor(mcfg, roberta_config=roberta,
                                  backbone_npoints=npoints, device="cuda",
                                  seed=args.seed)

        def request():
            return pred.predict(cloud, utt, phrase=phrase, det_boxes=boxes,
                                det_class_ids=cids, top_k=10)

        request()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        lat = []
        for _ in range(3):
            t = time.perf_counter()
            ans = request()
            lat.append((time.perf_counter() - t) * 1e3)
        req_launches = dict(_cuda.LAUNCHES)
        req_peak = torch.cuda.max_memory_allocated()
        check(np.isfinite(ans["boxes"]).all()
              and np.isfinite(ans["scores"]).all(),
              f"{mode} request: non-finite answer")
        for name, n in dict(FORWARD_LAUNCHES,
                            attention=attention_calls(mcfg, roberta)).items():
            check(req_launches[name] == 3 * n,
                  f"{mode} requests: {req_launches[name]} {name} launches, "
                  f"expected {n} each")
        req_busy, req_groups = device_busy_ms(request)
        del pred
        torch.cuda.empty_cache()

        trainer = Trainer(mcfg, steps_per_epoch=1000, roberta_config=roberta,
                          backbone_npoints=npoints, device="cuda",
                          seed=args.seed)
        trainer.train_step(batches[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        step_ms, metrics = [], []
        for batch in batches[1:3]:
            t = time.perf_counter()
            metrics.append(trainer.train_step(batch))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
        step_launches = dict(_cuda.LAUNCHES)
        step_peak = torch.cuda.max_memory_allocated()
        for name, n in training_step_launches(mcfg, roberta).items():
            check(step_launches[name] == n * len(step_ms),
                  f"{mode} steps: {step_launches[name]} {name} launches in "
                  f"{len(step_ms)} steps, expected {n} each")
        for m in metrics:
            check(all(math.isfinite(v) for v in m.values())
                  and m["grad_norm"] > 0, f"{mode} step: metrics {m}")
        if mode == "bf16":
            check(trainer.model.dtype == torch.bfloat16,
                  "--use_bf16 trainer: the model is not bf16")
            check({p.dtype for p in trainer.model.parameters()}
                  == {torch.float32}, "--use_bf16: parameters not f32")
            out["loss_without_sync"] = loss_without_sync(trainer,
                                                         batches[-1])
        step_busy, step_groups = device_busy_ms(
            lambda: trainer.train_step(batches[1]), reps=1)
        del trainer
        torch.cuda.empty_cache()
        med = lambda x: sorted(x)[len(x) // 2]
        out[mode] = dict(
            request_ms=lat, request_ms_median=med(lat),
            request_busy_ms=req_busy, request_busy_by_group=req_groups,
            request_peak_memory_bytes=req_peak, request_launches=req_launches,
            step_ms=step_ms, step_ms_median=med(step_ms),
            step_busy_ms=step_busy, step_busy_by_group=step_groups,
            step_peak_memory_bytes=step_peak, step_launches=step_launches,
            losses=[m["loss"] for m in metrics])
        groups = lambda g: ", ".join(f"{k} {v:.2f}" for k, v in g.items())
        log(f"  {mode:7s}: request {med(lat):.1f} ms ({', '.join(f'{x:.1f}' for x in lat)}), "
            f"device-busy {req_busy:.2f} ms ({groups(req_groups)}), peak "
            f"{req_peak / 2 ** 30:.2f} GiB; step B={args.train_batch} "
            f"{med(step_ms):.1f} ms ({', '.join(f'{x:.1f}' for x in step_ms)}), "
            f"device-busy {step_busy:.2f} ms ({groups(step_groups)}), peak "
            f"{step_peak / 2 ** 30:.2f} GiB; losses "
            f"{', '.join(f'{x:.3f}' for x in out[mode]['losses'])} "
            f"[{card}]")
    return out


# ------------------------------------------------------------- main


# ------------------------------------------------------------- phase 12
#
# Training across processes. Two ranks share the one card: NCCL refuses
# two ranks on one device, so they join over gloo (asked for through
# `init_distributed`), which reduces CUDA tensors through the host. The
# ranks are spawned processes that import the port, and each builds its
# model from the seed that the one-process run uses.

FULL_NPOINTS = (2048, 1024, 512, 256)


def _rank_main(rank, world, port, out_dir, task, task_args):
    import traceback

    import torch
    import torch.distributed as dist

    from butd_detr_tpu_torch.utils.dist import init_distributed

    torch.cuda.set_device(0)
    init_distributed("gloo", rank=rank, world_size=world,
                     init_method=f"tcp://localhost:{port}")
    try:
        result = task(rank, *task_args)
    except BaseException:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def run_ranks(task, world, *task_args, timeout=600):
    """[task(rank, *task_args) for each rank], each rank a spawned process
    on the card, the ranks joined over gloo. A rank that raises, or a
    world that outlives `timeout`, fails the phase (every rank stopped)."""
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as out:
        ctx = mp.start_processes(
            _rank_main, args=(world, port, out, task, task_args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.perf_counter() + timeout
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    raise SmokeFailure(f"{task.__name__}: the ranks did not "
                                       f"finish in {timeout} s")
        except ProcessException as e:
            errors = "\n".join(
                open(os.path.join(out, f)).read()
                for f in sorted(os.listdir(out)) if f.startswith("error"))
            raise SmokeFailure(f"{task.__name__}: a rank failed:\n"
                               f"{errors or e}") from None
        return [torch.load(os.path.join(out, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def _no_dropout(model):
    from butd_detr_tpu_torch.nn.attention import MultiheadAttention
    from butd_detr_tpu_torch.nn.dropout import Dropout

    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
        elif isinstance(m, MultiheadAttention):
            m.dropout = 0.0


def small_gradient_model(seed):
    """Phase 5's small model (f32, precise attention) and its batch of 2."""
    from butd_detr_tpu_torch.config import butd_cls_config
    from butd_detr_tpu_torch.data import synthetic_batch
    from butd_detr_tpu_torch.lang import tiny_roberta_config

    cfg = butd_cls_config(num_target=64, num_encoder_layers=2,
                          num_decoder_layers=2, num_points=4096,
                          max_num_obj=16, max_det_boxes=16,
                          backbone_bf16=False, attn_precise=True)
    roberta = tiny_roberta_config()
    batch = synthetic_batch(
        batch_size=2, num_points=cfg.num_points,
        max_text_len=cfg.max_text_len, max_num_obj=cfg.max_num_obj,
        max_det_boxes=cfg.max_det_boxes, n_true_det=8, seed=seed,
        vocab_size=roberta.vocab_size, spatial_sort=cfg.spatial_sort)
    return cfg, roberta, (512, 256, 128, 64), batch


def full_width_batches(seed, batch_size, n, **cfg_kw):
    from butd_detr_tpu_torch.config import butd_cls_config
    from butd_detr_tpu_torch.data import synthetic_batch
    from butd_detr_tpu_torch.lang import roberta_base_config

    cfg = butd_cls_config(**cfg_kw)
    roberta = roberta_base_config()
    return cfg, roberta, [synthetic_batch(
        batch_size=batch_size, num_points=cfg.num_points,
        max_text_len=cfg.max_text_len, max_num_obj=cfg.max_num_obj,
        max_det_boxes=cfg.max_det_boxes, seed=seed + i,
        vocab_size=roberta.vocab_size, spatial_sort=cfg.spatial_sort)
        for i in range(n)]


def dp_steps(seed, batch_size, mesh=None):
    """The `--dp` comparison of one process or rank: phase 5's small
    model's eval-mode gradients of its rows, then two full-width training
    steps in strict f32 without dropout: the first returns what decides
    the queries (the kps logits and selection) and the BatchNorm buffers
    it leaves, the second is timed and counted."""
    import torch

    from butd_detr_tpu_torch.ops import _cuda
    from butd_detr_tpu_torch.parallel import Mesh
    from butd_detr_tpu_torch.train import Trainer

    mesh = mesh or Mesh()
    cfg, roberta, npoints, batch = small_gradient_model(seed)
    trainer = Trainer(cfg, roberta_config=roberta, backbone_npoints=npoints,
                      device="cuda", seed=seed, mesh=mesh)
    trainer.model.eval()
    loss, _ = trainer.loss(trainer.forward(trainer.to_device(
        mesh.shard_batch(batch))))
    loss.backward()
    trainer.sync_gradients()
    small = (float(trainer.dp_mean({"loss": loss.detach()})["loss"]),
             {n: p.grad.cpu() for n, p in trainer.model.named_parameters()
              if p.grad is not None})
    del trainer

    cfg, roberta, batches = full_width_batches(
        seed, batch_size, 2, backbone_bf16=False, attn_precise=True)
    trainer = Trainer(cfg, steps_per_epoch=1000, roberta_config=roberta,
                      backbone_npoints=FULL_NPOINTS, device="cuda",
                      seed=seed, mesh=mesh)
    _no_dropout(trainer.model)
    trainer.begin_step()
    loss, ep = trainer.loss(trainer.forward(trainer.to_device(
        mesh.shard_batch(batches[0]))))
    loss.backward()
    trainer.apply_gradients()
    metrics = [{"loss": float(trainer.dp_mean({"loss": loss.detach()})[
        "loss"])}]
    selection = (ep["seeds_obj_cls_logits"].detach().cpu(),
                 ep["query_points_sample_inds"].cpu())
    buffers = {n: b.to("cpu", copy=True)
               for n, b in trainer.model.named_buffers()
               if n.endswith(("running_mean", "running_var"))}
    del loss, ep
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t = time.perf_counter()
    metrics.append(trainer.train_step(mesh.shard_batch(batches[1])))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    return dict(small=small, metrics=metrics, selection=selection,
                buffers=buffers, ms=ms, launches=dict(_cuda.LAUNCHES),
                peak=torch.cuda.max_memory_allocated())


def dist_rank(rank, seed, batch_size, inputs):
    """One rank of phase 12's world of two: the `--dp 2` steps, then the
    `--mp 2` forward (a second mesh over the same two processes)."""
    from butd_detr_tpu_torch.parallel import make_mesh

    return dict(dp=dp_steps(seed, batch_size, make_mesh(dp=2)),
                tp=tp_forward(seed, inputs, make_mesh(mp=2)))


def data_parallel(args, ranks):
    """(a) Two `--dp 2` ranks (each half of the batch) beside one process
    at the whole batch, same weights and batches. The ranks' BatchNorm
    buffers after one step must lie within 1e-4 * max(|buffer|, 1) of the
    one process's: all of them where the kps selections agree, else
    (phase 4's near-tie protocol: a differing rank's logits within twice
    the logits' error) those of the layers before the selection (the
    backbone and the objectness head), since a swapped query changes
    every later layer's batch."""
    import math

    import torch

    one = dp_steps(args.seed, args.train_batch)
    want_loss, want = one["small"]
    worst = (0.0, "", 0.0, 0.0)
    for r, got in enumerate(ranks):
        loss, grads = got["small"]
        check(abs(loss - want_loss) <= 1e-4 * abs(want_loss),
              f"dp rank {r}: small model's loss {loss} vs {want_loss}")
        check(set(grads) == set(want) and len(want) > 100,
              f"dp rank {r}: other parameters have gradients")
        for name, w in want.items():
            err = float((grads[name] - w).abs().max())
            lim = 5e-3 * float(w.abs().max()) + 1e-6
            check(err <= lim, f"dp rank {r}: gradient of {name} err {err} "
                  f"> {lim}")
            worst = max(worst, (err / lim, name, err, lim))
        check(got["launches"] == one["launches"]
              and all(got["launches"].values()),
              f"dp rank {r}: a step launched {got['launches']}, one "
              f"process's step {one['launches']}")
        check(all(math.isfinite(v) for m in got["metrics"]
                  for v in m.values()), f"dp rank {r}: non-finite metrics")
    check(ranks[0]["metrics"] == ranks[1]["metrics"],
          "the dp ranks logged different losses")
    logits = torch.cat([r["selection"][0] for r in ranks])
    inds = torch.cat([r["selection"][1] for r in ranks])
    _, n_diff, gap, logit_err = _near_tie_selection(
        {"seeds_obj_cls_logits": logits, "query_points_sample_inds": inds},
        one["selection"][0])
    check(n_diff == 0 or gap <= 2 * logit_err,
          f"dp kps selection: {n_diff} ranks differ by up to {gap} in "
          f"logit, more than twice the logits' error {logit_err}")
    before = ("backbone_net.", "points_obj_cls.")
    held = [n for n in one["buffers"] if n_diff == 0 or n.startswith(before)]
    buf_err = 0.0
    for r, got in enumerate(ranks):
        for name in held:
            w = one["buffers"][name]
            err = float((got["buffers"][name] - w).abs().max())
            lim = 1e-4 * max(float(w.abs().max()), 1.0)
            check(err <= lim, f"dp rank {r}: BatchNorm {name} err {err} > "
                  f"{lim}")
            buf_err = max(buf_err, err)
    log(f"  small model: both ranks' averaged gradients within 5e-3 max|g| "
        f"of one process's, worst {worst[1]} {worst[2]:.3g} <= "
        f"{worst[3]:.3g}")
    for who, r in (("rank 0", ranks[0]), ("rank 1", ranks[1]),
                   ("one process", one)):
        log(f"  {who}: step {r['ms']:.1f} ms, peak device memory "
            f"{r['peak'] / 2 ** 30:.2f} GiB, losses "
            f"{', '.join(format(m['loss'], '.4f') for m in r['metrics'])}, "
            f"launches {r['launches']}")
    log(f"  kps selection: {n_diff} ranks differ (near-ties); "
        f"{len(held)} of {len(one['buffers'])} BatchNorm buffers held, "
        f"largest difference {buf_err:.3g}")
    launches = {k: ranks[0]["launches"][k] + ranks[1]["launches"][k]
                for k in ranks[0]["launches"]}
    return dict(
        ranks=[dict(step_ms=r["ms"], peak_memory_bytes=r["peak"],
                    launches=r["launches"], metrics=r["metrics"])
               for r in ranks],
        one=dict(step_ms=one["ms"], peak_memory_bytes=one["peak"],
                 launches=one["launches"], metrics=one["metrics"]),
        gradient_worst=dict(name=worst[1], err=worst[2], lim=worst[3]),
        kps_ranks_differing=n_diff, buffers_held=len(held),
        buffer_err=buf_err, launches=launches)


def tp_forward(seed, inputs, mesh):
    """An `--mp 2` rank's eval forward at full width (f32, precise), with
    the head count of every attention call."""
    import torch

    import butd_detr_tpu_torch.nn.attention as mha
    from butd_detr_tpu_torch.config import butd_cls_config
    from butd_detr_tpu_torch.lang import roberta_base_config
    from butd_detr_tpu_torch.ops import _cuda
    from butd_detr_tpu_torch.train import Trainer

    trainer = Trainer(butd_cls_config(backbone_bf16=False, attn_precise=True),
                      roberta_config=roberta_base_config(),
                      backbone_npoints=FULL_NPOINTS, device="cuda",
                      seed=seed, mesh=mesh)
    heads = []
    core = mha.attention

    def counted(q, *a, **kw):
        heads.append(q.shape[1])
        return core(q, *a, **kw)

    mha.attention = counted
    trainer.model.eval()
    _cuda.reset_launches()
    try:
        with torch.no_grad():
            out = trainer.model({k: v.cuda() for k, v in inputs.items()})
        torch.cuda.synchronize()
    finally:
        mha.attention = core
    return dict(out={k: v.cpu() for k, v in out.items()}, heads=heads,
                launches=dict(_cuda.LAUNCHES),
                sharded=len(trainer.sharded))


def tensor_parallel(roberta, pred, inputs, ranks):
    """(b) Two `--mp 2` ranks' forward of one request against the one
    process's (`pred`, the f32 precise predictor whose `inputs` the ranks
    took) on the card, phase 4's bound and near-tie protocol."""
    import numpy as np
    import torch

    cfg = pred.cfg
    r0, r1 = ranks
    for key, v in r0["out"].items():
        check(torch.equal(v, r1["out"][key]),
              f"the mp ranks' {key} differ")
    attention = attention_calls(cfg, roberta)
    want_heads = [roberta.num_attention_heads] * roberta.num_hidden_layers \
        + [8 // 2] * (attention - roberta.num_hidden_layers)
    check(sorted(r0["heads"], reverse=True) == want_heads,
          f"K3's heads a call under --mp 2: {r0['heads']}")
    for r, got in enumerate(ranks):
        expect = dict(FORWARD_LAUNCHES, attention=attention)
        expect["gather"] += 3  # the f32 mode's groupings (phase 4)
        expect["group_gather"] = 1
        for name, n in expect.items():
            check(got["launches"][name] == n,
                  f"mp rank {r}: {name} launched {got['launches'][name]} "
                  f"times in a request, expected {n}")
    card = r0["out"]
    with torch.no_grad():
        encoded, detected = pred.model.encode(inputs)
        logits = encoded["seeds_obj_cls_logits"].cpu()
        inds, n_diff, gap, logit_err = _near_tie_selection(card, logits)
        check(n_diff == 0 or gap <= 2 * logit_err,
              f"--mp 2 kps selection: {n_diff} ranks differ by up to {gap} "
              f"in logit, more than twice the logits' error {logit_err}")
        want = pred.model.decode(encoded, detected,
                                 inds.to(torch.int32).cuda())
    worst = (0.0, "", 0.0, 0.0)
    for key, w in want.items():
        w = w.cpu().numpy()
        got = card[key].numpy()
        if w.dtype.kind in "iub":
            if key != "query_points_sample_inds":
                check(np.array_equal(got, w), f"--mp 2: {key} differs")
            continue
        err = float(np.abs(got.astype(np.float64) - w).max())
        lim = 1e-3 + 5e-3 * float(np.std(w))
        check(err <= lim, f"--mp 2 vs one process: {key} err {err} > {lim}")
        worst = max(worst, (err / lim, key, err, lim))
    log(f"  {r0['sharded']} parameters sharded a rank; K3 on "
        f"{want_heads.count(4)} calls of 4 heads and "
        f"{roberta.num_hidden_layers} of {roberta.num_attention_heads}; kps ranks differing {n_diff}; "
        f"every end point within 1e-3 + 5e-3 std of one process's, worst "
        f"{worst[1]} {worst[2]:.3g} <= {worst[3]:.3g}")
    return dict(kps_ranks_differing=n_diff, worst=dict(
        key=worst[1], err=worst[2], lim=worst[3]),
        sharded=r0["sharded"],
        launches={k: r0["launches"][k] + r1["launches"][k]
                  for k in r0["launches"]})


PORT_KERNEL_NAMES = {
    "fps": "fps_", "ball_query": "ball_query_", "attention":
    "attention_fwd_", "attention_bwd": "attention_bwd_", "scatter":
    "scatter_rows_add_", "gather": "gather_tile_kernel", "group_gather":
    "group_gather_", "assignment": "assignment_kernel"}


def profiler_window(args, cfg, roberta, npoints):
    """(e) `--profile_dir` on one short training epoch at full width (three
    steps of synthetic scenes at `--train-batch`, through
    `TrainTester.train_one_epoch`): the window of 2 steps logs its line
    and writes a trace whose kernel names hold every port kernel."""
    import dataclasses
    import tempfile

    import torch

    from butd_detr_tpu_torch.data import SyntheticGroundingDataset
    from butd_detr_tpu_torch.ops import _cuda
    from butd_detr_tpu_torch.predict import build_model
    from butd_detr_tpu_torch.train import TrainTester

    B = args.train_batch
    scenes = SyntheticGroundingDataset(
        3 * B, seed=args.seed + 2000, num_points=cfg.num_points,
        max_text_len=cfg.max_text_len, max_num_obj=cfg.max_num_obj,
        max_det_boxes=cfg.max_det_boxes, vocab_size=roberta.vocab_size,
        spatial_sort=cfg.spatial_sort)

    class SmokeTester(TrainTester):
        def get_datasets(self):
            return scenes, scenes

        def _roberta_config(self):
            return roberta

        def get_model(self):
            return build_model(self.cfg, roberta, npoints)

    with tempfile.TemporaryDirectory() as tmp:
        prof = os.path.join(tmp, "profile")
        tester = SmokeTester(dataclasses.replace(
            cfg, batch_size=B, num_workers=0, log_dir=os.path.join(tmp, "log"),
            profile_dir=prof, profile_steps=2), device="cuda")
        train_loader, _ = tester.get_loaders()
        trainer = tester.get_trainer(len(train_loader))
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        tester.train_one_epoch(1, train_loader, trainer)
        seconds = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        with open(os.path.join(tmp, "log", "log.txt")) as f:
            text = f.read()
        with open(os.path.join(prof, "trace_rank0.json")) as f:
            trace = json.load(f)
    check(f"profiler trace (2 steps) written to {prof}" in text,
          "the profiler window logged no trace")
    names = {e.get("name", "") for e in trace.get("traceEvents", [])
             if e.get("cat") == "kernel"}
    found = {k: sum(p in n for n in names)
             for k, p in PORT_KERNEL_NAMES.items()}
    check(all(found.values()),
          f"the profiler's trace lacks port kernels: {found}")
    for name, n in training_step_launches(cfg, roberta).items():
        check(launches[name] == 3 * n, f"profiled epoch: {name} launched "
              f"{launches[name]} times in 3 steps, expected {n} each")
    log(f"  3 steps at B = {B} in {seconds:.1f} s, 2 of them traced: "
        f"{len(names)} kernel names, the port's {found}")
    return dict(seconds=seconds, kernel_names=found, launches=launches)


def multiview_step(args, roberta):
    """(d) One B = 8 training step with `--use_multiview`: 128 features a
    point beside the colour, so that sa1 groups 131 channels; K7's
    MLP-input kernel at that width against its plain version. The
    features come from an array, not from `make_fake_multiview`'s file, so
    that the step needs no `h5py` (the file reader is held on the CPU by
    tests/test_torch_data.py)."""
    import math

    import numpy as np
    import torch

    import butd_detr_tpu_torch.ops.pointcloud as pointcloud
    from butd_detr_tpu_torch.ops import (
        _cuda,
        group_rows_mlp_input,
        group_rows_mlp_input_plain,
    )
    from butd_detr_tpu_torch.train import INPUT_KEYS, TARGET_KEYS, Trainer

    B = args.train_batch
    cfg, _, (batch,) = full_width_batches(args.seed, B, 1,
                                          use_multiview=True)
    rng = np.random.RandomState(args.seed)
    batch["point_clouds"] = np.concatenate([
        batch["point_clouds"], rng.rand(
            *batch["point_clouds"].shape[:2], 128).astype(np.float32)],
        axis=-1)
    check(batch["point_clouds"].shape == (B, cfg.num_points, 3 + 3 + 128),
          f"multiview batch {batch['point_clouds'].shape}")
    trainer = Trainer(cfg, steps_per_epoch=1000, roberta_config=roberta,
                      backbone_npoints=FULL_NPOINTS, device="cuda",
                      seed=args.seed)
    seen = []
    fused = pointcloud.group_rows_mlp_input

    def record(xyz, new_xyz, feats, idx, inv_r):
        if feats.shape[-1] == 131:
            seen.append((xyz, new_xyz, feats, idx, inv_r))
        return fused(xyz, new_xyz, feats, idx, inv_r)

    pointcloud.group_rows_mlp_input = record
    try:
        _cuda.reset_launches()
        metrics = trainer.train_step(
            {k: batch[k] for k in (*INPUT_KEYS, *TARGET_KEYS)})
        launches = dict(_cuda.LAUNCHES)
    finally:
        pointcloud.group_rows_mlp_input = fused
    check(all(math.isfinite(v) for v in metrics.values()),
          f"multiview step: non-finite metrics {metrics}")
    for name, n in training_step_launches(cfg, roberta).items():
        check(launches[name] == n, f"multiview step: {name} launched "
              f"{launches[name]} times, expected {n}")
    check(len(seen) == 1, f"sa1 grouped 131 channels {len(seen)} times")
    xyz, new_xyz, feats, idx, inv_r = seen[0]
    got = group_rows_mlp_input(xyz, new_xyz, feats, idx, inv_r)
    want = group_rows_mlp_input_plain(xyz, new_xyz, feats, idx, inv_r)
    check(got.shape == (*idx.shape, 3 + 131) and got.dtype == torch.bfloat16
          and torch.equal(got.view(torch.int16), want.view(torch.int16)),
          "K7's MLP input at 131 channels differs from its plain version")
    _, m, ns = idx.shape
    cf = feats.shape[-1]

    def library():
        cat = torch.cat([xyz, feats.to(xyz.dtype)], dim=-1)
        g = torch.gather(cat, 1, idx.reshape(B, m * ns).long()[..., None]
                         .expand(-1, -1, 3 + cf)).reshape(B, m, ns, -1)
        y = (g[..., :3] - new_xyz[:, :, None, :]) * inv_r
        return torch.cat([y, g[..., 3:]], dim=-1).to(torch.bfloat16)

    ms = time_ms(lambda: group_rows_mlp_input(xyz, new_xyz, feats, idx,
                                              inv_r), 20)
    plain_ms = time_ms(lambda: group_rows_mlp_input_plain(
        xyz, new_xyz, feats, idx, inv_r), 10)
    library_ms = time_ms(library, 10)
    distinct = sum(int(torch.unique(idx[b]).numel()) for b in range(B))
    row_bytes = 3 * xyz.element_size() + cf * feats.element_size()
    nbytes = (idx.numel() * idx.element_size() + B * m * 12
              + distinct * row_bytes + B * m * ns * 2 * (3 + cf))
    b_ms, by = bound_ms(nbytes, [])
    log(f"  --use_multiview step at B = {B} (features from an array): loss "
        f"{metrics['loss']:.3f}, launches {launches}; K7's MLP input at "
        f"(3 + {cf}) bit-equal: {ms:.4f} ms (plain {plain_ms:.4f}, "
        f"torch.gather chain {library_ms:.4f}, bound {b_ms:.5f}, {by})")
    del trainer
    torch.cuda.empty_cache()
    return dict(loss=metrics["loss"], launches=launches,
                k7=dict(shape=list(got.shape), ms=ms, plain_ms=plain_ms,
                        library_ms=library_ms, bound_ms=b_ms, bound_by=by,
                        bytes=nbytes))


# ------------------------------------------------------------- phase 13,
# the text side

# the span predictor's data: sr3d rows on train scans, then on test scans
TEXT_ROWS = dict(n_train=1280, n_test=256)
SPAN_BATCH, SPAN_LEN, SPAN_STEPS = 128, 128, 30
# K3 and K4 at the text paths' shapes: (name, B, H, L, Dh, p, precise,
# K3 calls, K4 calls) a span step, a span scoring batch, a class table
# and a pretraining step
TEXT_SHAPES = [
    ("span_train", SPAN_BATCH, 12, SPAN_LEN, 64, 0.1, False, 12, 12),
    ("span_score", SPAN_BATCH, 12, SPAN_LEN, 64, 0.0, False, 12, 0),
    ("class_embeddings", 64, 12, 16, 64, 0.0, False, 96, 0),
    ("pretrain", 64, 4, 32, 32, 0.0, True, 4, 4),
]
# the rows of the span step held against the CPU's (the CPU's f32 step
# at all 128 took ~110 s of a 1,200 s run)
SPAN_CPU_ROWS = 32
MSG_BATCH, MSG_POINTS = 4, 50_000


def write_text_root(root, seed, n_train, n_test):
    """A text-only data root for the span predictor: `meta_data` scan
    lists (and the label table the grounding dataset opens) and
    `refer_it_3d/sr3d.csv`, `n_train` rows on train scans, then `n_test`
    on test scans, each "the <class> <relation> the <anchor>" with the
    class as its target."""
    import csv

    import numpy as np

    from butd_detr_tpu_torch.data.scannet_config import (
        relations,
        scannet_classes,
    )

    rng = np.random.RandomState(seed)
    classes, rels = scannet_classes(485), relations()
    meta = os.path.join(root, "meta_data")
    os.makedirs(meta, exist_ok=True)
    os.makedirs(os.path.join(root, "refer_it_3d"), exist_ok=True)
    scans = {"train": [f"scene{i:04d}_00" for i in range(64)],
             "test": [f"scene{i:04d}_00" for i in range(64, 80)]}
    for split, ids in scans.items():
        with open(os.path.join(meta, f"sr3d_{split}_scans.txt"), "w") as f:
            f.write(repr(ids))
    with open(os.path.join(meta, "scannetv2-labels.combined.tsv"),
              "w") as f:
        f.write("raw_category\tid\tnyu40id\tnyu40class\n")
    with open(os.path.join(root, "refer_it_3d", "sr3d.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(["scan_id", "target_id", "distractor_ids", "utterance",
                    "instance_type", "anchors_types", "anchor_ids",
                    "mentions_target_class"])
        for i in range(n_train + n_test):
            ids = scans["train" if i < n_train else "test"]
            c, a = rng.randint(len(classes), size=2)
            w.writerow([ids[rng.randint(len(ids))], rng.randint(20), "[]",
                        f"the {classes[c]} "
                        f"{rels[rng.randint(len(rels))]} the {classes[a]}",
                        classes[c], repr([classes[a]]), "[1]", "True"])
    return root


def check_text_attention(gen, seed):
    """K3 and K4 at the text paths' shapes (TEXT_SHAPES, utterance-length
    key padding), against their plain versions fed the kernel's own
    dropout mask (which must equal the plain Philox generator's), in the
    path's mode; each timed beside the plain version, SDPA and autograd
    through SDPA at the same p. Returns ({shape: K3 numbers}, {shape: K4
    numbers}, worst errors)."""
    import torch
    import torch.nn.functional as F

    from butd_detr_tpu_torch.ops import (
        attention,
        attention_backward,
        attention_backward_plain,
        attention_plain,
        dropout_keep_mask,
        dropout_keep_mask_plain,
    )

    fwd, bwd = {}, {}
    worst = {"attention": 0.0, "attention_bwd": 0.0}
    for name, B, H, L, Dh, p, precise, n3, n4 in TEXT_SHAPES:
        q, k, v, do = (torch.randn(B, L, H, Dh, device="cuda",
                                   generator=gen).transpose(1, 2)
                       for _ in range(4))
        keys = torch.arange(L, device="cuda")[None]
        # utterances of L/8 to L tokens
        lengths = L // 8 + torch.arange(B, device="cuda")[:, None] \
            % (L - L // 8 + 1)
        pad = (keys >= lengths).contiguous()
        scale = Dh ** -0.5
        kw = dict(sm_scale=scale, dropout_p=p, precise=precise)
        keep = None
        if p:
            keep = dropout_keep_mask(seed, B, H, L, L, p, device="cuda")
            check(torch.equal(keep.cpu(), dropout_keep_mask_plain(
                seed, B, H, L, L, p)),
                f"{name}: the kernel's dropout mask != the plain Philox's")
        got = attention(q, k, v, pad, seed=seed, **kw)
        want = attention_plain(q, k, v, pad, keep_mask=keep, **kw)
        err = (got - want).abs().max().item()
        atol = 2e-5 if precise else (
            4e-3 + 2 ** -8 * v.abs().max().item() / (1 - p))
        check(torch.allclose(got, want, atol=atol,
                             rtol=1e-4 if precise else 4e-3),
              f"attention {name}: max err {err}")
        worst["attention"] = max(worst["attention"], err)
        pairs = B * H * L * L
        rate = F32_OPS_PER_S if precise else BF16_OPS_PER_S
        b3, by3 = bound_ms(4 * B * H * Dh * 4 * L + B * L,
                           [(4 * pairs * Dh, rate),
                            (5 * pairs, F32_OPS_PER_S)])
        amask = ~pad[:, None, None, :]
        fwd[name] = dict(
            B=B, H=H, L=L, Dh=Dh, p=p, precise=precise, calls=n3,
            max_abs_err=err,
            ms=time_ms(lambda: attention(q, k, v, pad, seed=seed, **kw), 10),
            plain_ms=time_ms(lambda: attention_plain(
                q, k, v, pad, keep_mask=keep, **kw), 3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=amask, scale=scale, dropout_p=p), 10),
            bound_ms=b3, bound_by=by3)
        if n4:
            grads = attention_backward(q, k, v, do, pad, seed=seed, **kw)
            again = attention_backward(q, k, v, do, pad, seed=seed, **kw)
            wants = attention_backward_plain(q, k, v, do, pad,
                                             keep_mask=keep, **kw)
            errs = []
            for what, g, a, w in zip("qkv", grads, again, wants):
                check(torch.equal(g, a),
                      f"attention backward {name} d{what}: two runs differ")
                e = (g - w).abs().max().item()
                ok = (torch.allclose(g, w, atol=2e-5, rtol=1e-4) if precise
                      else e <= 4e-3 + 4e-3 * w.abs().max().item())
                check(ok, f"attention backward {name} d{what}: max err {e}")
                errs.append(e)
            del grads, again, wants
            worst["attention_bwd"] = max(worst["attention_bwd"], *errs)
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(
                *leaves, attn_mask=amask, scale=scale, dropout_p=p)
            b4, by4 = bound_ms(4 * B * H * Dh * 7 * L + B * L,
                               [(10 * pairs * Dh, rate),
                                (12 * pairs, F32_OPS_PER_S)])
            bwd[name] = dict(
                B=B, H=H, L=L, Dh=Dh, p=p, precise=precise, calls=n4,
                max_abs_err=max(errs),
                ms=time_ms(lambda: attention_backward(
                    q, k, v, do, pad, seed=seed, **kw), 10),
                plain_ms=time_ms(lambda: attention_backward_plain(
                    q, k, v, do, pad, keep_mask=keep, **kw), 3),
                library_ms=time_ms(lambda: torch.autograd.grad(
                    out, leaves, do, retain_graph=True), 10),
                bound_ms=b4, bound_by=by4)
            del leaves, out
        log(f"  K3 {name:16s} ({B}, {H}, {L}, {Dh}) p={p} "
            f"precise={precise}: {fwd[name]['ms']:.3f} ms (plain "
            f"{fwd[name]['plain_ms']:.3f}, sdpa {fwd[name]['library_ms']:.3f}"
            f", bound {b3:.4f} by {by3}), err {err:.3g}"
            + (f"; K4 {bwd[name]['ms']:.3f} ms (plain "
               f"{bwd[name]['plain_ms']:.3f}, sdpa autograd "
               f"{bwd[name]['library_ms']:.3f}, bound {b4:.4f} by {by4}), "
               f"err {max(errs):.3g}" if n4 else ""))
        del q, k, v, do, keep, got, want
    torch.cuda.empty_cache()
    return fwd, bwd, worst


def span_training(args, root, card):
    """(a) The span predictor at full width (RoBERTa-base, B 128, L 128,
    lr 1e-4, dropout 0.1, the default attention mode): 1 warm and
    SPAN_STEPS timed steps on the root's shuffled training rows; every
    loss finite, the last below 0.75 x the first, K3 and K4 12 launches a
    step and nothing else; then one batch's eval-mode logits on the card
    against the f32 CPU run of the same weights (phase 4's default-mode
    bound), and one training step on SPAN_CPU_ROWS rows against the CPU's
    (`span_step_against_the_cpu`)."""
    import numpy as np
    import torch

    from butd_detr_tpu_torch.lang import get_tokenizer, roberta_base_config
    from butd_detr_tpu_torch.lang.span_predictor import SpanPredictor
    from butd_detr_tpu_torch.lang.span_trainer import (
        SpanTextDataset,
        SpanTrainer,
        batch_iter,
    )
    from butd_detr_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    tok = get_tokenizer(max_len=SPAN_LEN)
    ds = SpanTextDataset("sr3d", "train", root, tokenizer=tok,
                         max_len=SPAN_LEN)
    check(len(ds) == TEXT_ROWS["n_train"],
          f"span dataset: {len(ds)} rows, expected {TEXT_ROWS['n_train']}")
    batches, epoch = [], 0
    while len(batches) < SPAN_STEPS + 1:
        batches += batch_iter(ds, SPAN_BATCH, True, seed=epoch,
                              drop_last=True)
        epoch += 1
    trainer = SpanTrainer(roberta_base_config(), max_len=SPAN_LEN, lr=1e-4,
                          seed=args.seed, device="cuda")
    build_s = time.perf_counter() - t0
    losses = [trainer.train_step(batches[0])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    ms = []
    for batch in batches[1:SPAN_STEPS + 1]:
        t = time.perf_counter()
        losses.append(trainer.train_step(batch))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    check(np.isfinite(losses).all(), f"span training: losses {losses}")
    check(losses[-1] < 0.75 * losses[0],
          f"span training: step {SPAN_STEPS} loss {losses[-1]:.4f} is not "
          f"below 0.75 x step 0's {losses[0]:.4f}")
    for name, n in launches.items():
        want = 12 * SPAN_STEPS if name in ("attention",
                                           "attention_bwd") else 0
        check(n == want, f"span training: {name} launched {n} times in "
                         f"{SPAN_STEPS} steps, expected {want}")

    # one batch's eval-mode logits, card (default mode) against CPU (f32)
    batch = batches[0]
    score_ms = median_ms(lambda: trainer.score_step(batch), 3)
    got = trainer.score_step(batch).float().cpu().numpy()
    cpu = SpanPredictor(roberta_base_config(), precise=True)
    cpu.load_state_dict({k: v.cpu()
                         for k, v in trainer.model.state_dict().items()})
    t = trainer.tensors(batch)
    with torch.no_grad():
        want = cpu.eval()(t["text_ids"].cpu(), t["text_mask"].cpu()).numpy()
    err = float(np.abs(got - want).max())
    lim = default_mode_bound(want)
    check(err <= lim, f"span logits, card vs CPU: max err {err} > {lim}")
    med = sorted(ms)[len(ms) // 2]
    log(f"  (a) span training, RoBERTa-base at B {SPAN_BATCH}, L "
        f"{SPAN_LEN}: {SPAN_STEPS} steps median {med:.1f} ms "
        f"({min(ms):.1f}-{max(ms):.1f}), peak {peak / 2 ** 30:.2f} GiB, "
        f"K3 {launches['attention'] // SPAN_STEPS} and K4 "
        f"{launches['attention_bwd'] // SPAN_STEPS} a step; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; a scoring batch "
        f"{score_ms:.1f} ms; logits vs CPU max err {err:.3g} (bound "
        f"{lim:.3g}); model built in {build_s:.1f} s; {card}")
    del trainer, cpu
    torch.cuda.empty_cache()
    step = span_step_against_the_cpu(args, batch)
    return dict(step_ms=ms, median_step_ms=med, peak_memory_bytes=peak,
                losses=losses, launches=launches, score_ms=score_ms,
                logits_max_abs_err=err, logits_bound=lim, step_vs_cpu=step,
                tokenizer=type(tok).__name__,
                seconds=time.perf_counter() - t0)


def span_step_against_the_cpu(args, batch):
    """One span training step at full width (RoBERTa-base, L 128) on the
    first SPAN_CPU_ROWS rows of `batch`, on the card and on the CPU, in
    the f32 mode, from the same seeded weights, batch and
    step seed, with the attention dropout at 0.1 and every elementwise
    dropout at 0. An elementwise mask comes from each device's own
    generator, but the attention's is one Philox stream on both: the CPU's
    plain forward and backward draw the mask K3 and K4 regenerate on the
    card. The loss must agree within 1e-4 relative and every gradient
    within phase 5's bound, 5e-3 * max|g| + 1e-6, which a wrong gradient,
    or a K4 that does not get its forward's seed, breaks; the card's step
    launches K3 and K4 12 times each. (The default mode's bf16 operands
    are held to their own bounds by phases 2 and 4, not to this one.)"""
    import dataclasses

    import torch

    from butd_detr_tpu_torch.lang import roberta_base_config
    from butd_detr_tpu_torch.lang.span_trainer import SpanTrainer
    from butd_detr_tpu_torch.ops import _cuda

    config = dataclasses.replace(roberta_base_config(), hidden_dropout=0.0)
    batch = {k: v[:SPAN_CPU_ROWS] for k, v in batch.items()}
    runs = {}
    for device in ("cuda", "cpu"):
        t = time.perf_counter()
        trainer = SpanTrainer(config, max_len=SPAN_LEN, lr=1e-4,
                              seed=args.seed, device=device, precise=True)
        trainer.model.projector[2].p = 0.0
        if device == "cuda":
            torch.cuda.synchronize()
        _cuda.reset_launches()
        loss = float(trainer.train_step(batch))
        runs[device] = (loss, {n: p.grad.detach().cpu() for n, p in
                               trainer.model.named_parameters()},
                        dict(_cuda.LAUNCHES), time.perf_counter() - t)
        del trainer
        torch.cuda.empty_cache()
    (loss_c, grads_c, launches, card_s), (loss_p, grads_p, _, cpu_s) = \
        runs["cuda"], runs["cpu"]
    check(launches["attention"] == 12 and launches["attention_bwd"] == 12,
          f"span step vs CPU: the card's step launched {launches}")
    check(abs(loss_c - loss_p) <= 1e-4 * abs(loss_p),
          f"span step vs CPU: loss {loss_c} vs {loss_p}")
    worst = (0.0, "", 0.0, 0.0)
    for name, want in grads_p.items():
        err = float((grads_c[name] - want).abs().max())
        lim = 5e-3 * float(want.abs().max()) + 1e-6
        check(bool(torch.isfinite(grads_c[name]).all()) and err <= lim,
              f"span step vs CPU: gradient of {name} err {err} > {lim}")
        worst = max(worst, (err / lim, name, err, lim))
    log(f"  (a) one span step at B {SPAN_CPU_ROWS}, L {SPAN_LEN}, attention "
        f"dropout 0.1, f32 mode, card vs CPU: loss {loss_c:.6f} vs "
        f"{loss_p:.6f}; {len(grads_p)} gradients within 5e-3 max + 1e-6, "
        f"worst {worst[1]} at {worst[0]:.3f} of its bound; card "
        f"{card_s:.1f} s, CPU {cpu_s:.1f} s (each building its model)")
    return dict(loss_card=loss_c, loss_cpu=loss_p, gradients=len(grads_p),
                worst=dict(name=worst[1], err=worst[2], lim=worst[3],
                           ratio=worst[0]),
                card_seconds=card_s, cpu_seconds=cpu_s)


def in_process(main, argv, cwd=None):
    """`main(argv)` of an entry point in this process, from `cwd`, with the
    launch counts set to 0 just before and read just after. Returns (what
    it printed, the launches, its seconds)."""
    import contextlib
    import io

    import torch

    from butd_detr_tpu_torch.ops import _cuda

    printed = io.StringIO()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    with contextlib.chdir(cwd or os.getcwd()), \
            contextlib.redirect_stdout(printed):
        main(argv)
    torch.cuda.synchronize()
    return printed.getvalue(), dict(_cuda.LAUNCHES), time.perf_counter() - t0


def _val_acc(text, what):
    acc = [float(line.split()[-1]) for line in text.splitlines()
           if line.startswith("val_acc ")]
    check(len(acc) == 1 and 0.0 <= acc[0] <= 1.0,
          f"{what} printed no accuracy: {text[-2000:]}")
    return acc[0]


def span_command_line(root, tmp):
    """(b) `span_cls_torch.py` on the root, its main in this process with
    the launches read around each run: one epoch (K3 12 a training step
    and a validation batch, K4 12 a training step), then `--eval` and
    `--store` from the epoch's checkpoint (K3 12 a batch), nothing else.
    The port's grounding dataset then reads the stored
    `sr3d_pred_spans.json` from the root, every row's `pred_pos_map` the
    stored span of its csv row. `entry_point_children` runs the same
    command lines as a user starts them."""
    import json

    import span_cls_torch

    from butd_detr_tpu_torch.data import JointGroundingDataset
    from butd_detr_tpu_torch.lang import SimpleTokenizer

    t0 = time.perf_counter()
    n_train, n_test = TEXT_ROWS["n_train"], TEXT_ROWS["n_test"]
    steps = n_train // SPAN_BATCH
    val_batches = -(-n_test // SPAN_BATCH)
    store_batches = -(-(n_train + n_test) // SPAN_BATCH)
    flags = ["--data_root", root, "--epochs", "1", "--batch_size",
             str(SPAN_BATCH), "--max_len", str(SPAN_LEN)]
    argv = flags + ["--checkpoint_path", os.path.join(tmp, "span_ckpt")]
    runs = {}
    for what, extra, want in (
            ("train", [], {"attention": 12 * (steps + val_batches),
                           "attention_bwd": 12 * steps}),
            ("eval", ["--eval"], {"attention": 12 * val_batches}),
            ("store", ["--store"], {"attention": 12 * store_batches})):
        text, launches, secs = in_process(span_cls_torch.main, argv + extra,
                                          cwd=root)
        for name, n in launches.items():
            check(n == want.get(name, 0),
                  f"span_cls_torch.main {' '.join(extra)}: {n} {name} "
                  f"launches, expected {want.get(name, 0)}")
        runs[what] = dict(seconds=secs, launches=launches, text=text)
    epoch_lines = [line for line in runs["train"]["text"].splitlines()
                   if line.startswith("epoch 1/1 ")]
    check(len(epoch_lines) == 1, f"span_cls_torch.main: {runs['train']}")
    acc = _val_acc(runs["eval"]["text"], "span_cls_torch.main --eval")
    with open(os.path.join(root, "sr3d_pred_spans.json")) as f:
        stored = json.load(f)
    check(len(stored) == n_train + n_test,
          f"stored spans: {len(stored)} rows, expected {n_train + n_test}")
    ds = JointGroundingDataset(
        dataset_dict={"sr3d": 1}, split="train", data_path=root, scans={},
        tokenizer=SimpleTokenizer(max_len=SPAN_LEN),
        max_text_len=SPAN_LEN)
    check(len(ds.annos) == n_train,
          f"grounding dataset: {len(ds.annos)} sr3d rows")
    for i, anno in enumerate(ds.annos):  # the train rows come first
        check(anno["pred_pos_map"] == stored[i]["span"]
              and anno["span_utterance"] == stored[i]["utterance"],
              f"grounding dataset row {i}: not the stored span")
    log(f"  (b) span_cls_torch.main in process: 1 epoch "
        f"{runs['train']['seconds']:.1f} s ({epoch_lines[0]}; K3 "
        f"{runs['train']['launches']['attention']}, K4 "
        f"{runs['train']['launches']['attention_bwd']}), --eval "
        f"{runs['eval']['seconds']:.1f} s (val_acc {acc:.4f}, K3 "
        f"{runs['eval']['launches']['attention']}), --store "
        f"{runs['store']['seconds']:.1f} s (K3 "
        f"{runs['store']['launches']['attention']}); {len(stored)} spans "
        f"stored, the grounding dataset reads its {len(ds.annos)} rows")
    return dict(seconds_in_process={k: r["seconds"] for k, r in runs.items()},
                launches_in_process={k: r["launches"]
                                     for k, r in runs.items()},
                launches={k: sum(r["launches"][k] for r in runs.values())
                          for k in runs["train"]["launches"]},
                val_acc=acc, epoch_line=epoch_lines[0], stored=stored,
                flags=flags, argv=argv, seconds=time.perf_counter() - t0)


def class_embedding_table(args, tmp):
    """(c) `gen_class_embeddings_torch.py --params` (a seeded RoBERTa-base
    state dict): its main in this process launches K3 96 times and nothing
    else and writes a finite (485, 768) table equal to the function's on
    the card (timed warm), which loads into a model through
    `init_class_embeddings`. `entry_point_children` runs the same command
    line as a user starts it."""
    import gen_class_embeddings_torch
    import numpy as np
    import torch

    from butd_detr_tpu_torch.config import butd_cls_config
    from butd_detr_tpu_torch.data.scannet_config import scannet_classes
    from butd_detr_tpu_torch.init import init_weights_
    from butd_detr_tpu_torch.lang import (
        RobertaModel,
        get_tokenizer,
        roberta_base_config,
        tiny_roberta_config,
    )
    from butd_detr_tpu_torch.lang.class_embeddings import (
        generate_class_embeddings,
    )
    from butd_detr_tpu_torch.ops import _cuda
    from butd_detr_tpu_torch.predict import build_model
    from butd_detr_tpu_torch.train.pretrained import init_class_embeddings

    t0 = time.perf_counter()
    model = init_weights_(RobertaModel(roberta_base_config()),
                          args.seed + 14)
    weights = os.path.join(tmp, "roberta_base_seeded.pth")
    torch.save(model.state_dict(), weights)
    out = os.path.join(tmp, "class_embeddings3d.npy")
    argv = ["--output", out, "--params", weights]
    printed, main_launches, main_s = in_process(
        gen_class_embeddings_torch.main, argv)
    for name, n in main_launches.items():
        check(n == (96 if name == "attention" else 0),
              f"gen_class_embeddings_torch.main: {n} {name} launches")
    table = np.load(out)
    check(table.shape == (485, 768) and np.isfinite(table).all(),
          f"class table: shape {table.shape}, finite "
          f"{np.isfinite(table).all()}")
    model = model.cuda().eval()
    tok = get_tokenizer(max_len=16)
    names = scannet_classes(485)
    generate_class_embeddings(model, tok, names)  # warm
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t = time.perf_counter()
    want = generate_class_embeddings(model, tok, names)
    table_ms = (time.perf_counter() - t) * 1e3
    launches = dict(_cuda.LAUNCHES)
    check(launches["attention"] == 96,
          f"class table: {launches['attention']} K3 launches, expected 96")
    err = float(np.abs(table - want).max())
    check(err <= 1e-6 * float(np.abs(want).max()),
          f"class table: the script's main differs from the function by "
          f"{err}")
    grounding = build_model(butd_cls_config(num_target=16),
                            tiny_roberta_config(), (64, 32, 16, 8))
    check(init_class_embeddings(grounding, out) and np.array_equal(
        grounding.butd_class_embeddings.weight.detach().numpy(), table),
        "class table: did not load into butd_class_embeddings")
    log(f"  (c) gen_class_embeddings_torch.main in process: "
        f"`{printed.strip().splitlines()[-1]}` in {main_s:.1f} s, K3 "
        f"{main_launches['attention']}; the function warm {table_ms:.1f} "
        f"ms, K3 {launches['attention']}, max diff {err:.3g}; loads into "
        f"butd_class_embeddings")
    del model
    torch.cuda.empty_cache()
    return dict(main_seconds=main_s, table_ms=table_ms,
                launches=main_launches, function_launches=launches,
                max_abs_diff=err, table=out, params=weights,
                seconds=time.perf_counter() - t0)


def text_pretraining(tmp):
    """(d) `scripts/pretrain_text_torch.py --steps 50`, in this process
    (the launch counts): the cross-entropy at step 49 below step 0's, K3
    4 a step (and 4 for the final sweep) and K4 4 a step; its npz loads
    through `convert.load_text_init` into the small text tower."""
    import contextlib
    import io
    import re
    import types

    from butd_detr_tpu_torch.convert import load_text_init
    from butd_detr_tpu_torch.lang import (
        RobertaModel,
        small_text_roberta_config,
    )
    from butd_detr_tpu_torch.ops import _cuda

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import pretrain_text_torch
    finally:
        sys.path.pop(0)
    out = os.path.join(tmp, "text_init_torch.npz")
    printed = io.StringIO()
    t0 = time.perf_counter()
    _cuda.reset_launches()
    with contextlib.redirect_stdout(printed):
        pretrain_text_torch.main(["--out", out, "--steps", "50"])
    launches = dict(_cuda.LAUNCHES)
    seconds = time.perf_counter() - t0
    ce = {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"^step (\d+) ce ([-\d.naif]+)", printed.getvalue(), re.M)}
    check(set(ce) == {0, 49} and ce[49] < ce[0],
          f"pretraining: step cross-entropies {ce}")
    check(launches["attention"] == 4 * 50 + 4
          and launches["attention_bwd"] == 4 * 50,
          f"pretraining: launches {launches}")
    tower = types.SimpleNamespace(
        text_encoder=RobertaModel(small_text_roberta_config()))
    load_text_init(out, tower)
    sweep = [line for line in printed.getvalue().splitlines()
             if line.startswith("final class-name sweep")]
    log(f"  (d) pretrain_text_torch.py --steps 50: ce {ce[0]:.3f} -> "
        f"{ce[49]:.3f}, {sweep[-1] if sweep else ''}, {seconds:.1f} s; "
        f"K3 {launches['attention']}, K4 {launches['attention_bwd']}; the "
        f"npz loads through load_text_init")
    return dict(ce=ce, launches=launches, seconds=seconds)


def msg_modules(args, card):
    """(e) `PointnetSAModuleMSG` at B 4 on 50,000 x 6 points (npoint
    2,048, radii 0.1 / 0.2 / 0.4, nsamples 16 / 32 / 64), then a global
    `PointnetSAModule` (`GroupAll`) on 256 of its points with 256 of its
    channels, then `PointnetLFPModuleMSG` from 512 of its points onto
    1,024; forward and backward in eval mode, on the card and with the
    plain versions on the CPU (same weights and inputs): the integer
    indices equal, every output and gradient within phase 5's bound
    (5e-3 * max + 1e-6); launches by kernel."""
    import numpy as np
    import torch

    from butd_detr_tpu_torch.init import init_weights_
    from butd_detr_tpu_torch.nn import (
        PointnetLFPModuleMSG,
        PointnetSAModule,
        PointnetSAModuleMSG,
    )
    from butd_detr_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    torch.manual_seed(args.seed)
    modules = torch.nn.ModuleDict(dict(
        msg=PointnetSAModuleMSG(2048, (0.1, 0.2, 0.4), (16, 32, 64), 3,
                                ((32, 32, 64), (64, 64, 128),
                                 (64, 96, 128))),
        group_all=PointnetSAModule((256, 512), 256),
        lfp=PointnetLFPModuleMSG((0.2, 0.4), (16, 32), 320,
                                 ((128, 128), (128, 128)), (256,),
                                 skip_channels=320)))
    init_weights_(modules, args.seed + 13)
    rng = np.random.RandomState(args.seed + 13)
    clouds = np.stack([make_scene(rng, n_points=MSG_POINTS)[0]
                       for _ in range(MSG_BATCH)])

    def run(device):
        mods = {k: m.to(device).eval() for k, m in modules.items()}
        xyz = torch.from_numpy(clouds[..., :3].copy()).to(device)
        feats = torch.from_numpy(clouds[..., 3:].copy()).to(device) \
            .requires_grad_(True)
        new_xyz, f1, inds = mods["msg"](xyz, feats)
        _, f_all, _ = mods["group_all"](new_xyz[:, :256], f1[:, :256, :256])
        f_lfp = mods["lfp"](new_xyz[:, :1024], new_xyz[:, :512],
                            f1[:, :1024], f1[:, :512])
        loss = sum(f.square().mean() for f in (f1, f_all, f_lfp))
        for m in mods.values():
            m.zero_grad(set_to_none=True)
        loss.backward()
        out = dict(inds=inds, new_xyz=new_xyz, msg=f1, group_all=f_all,
                   lfp=f_lfp, dfeats=feats.grad)
        out.update({f"d{k}.{n}": p.grad for k, m in mods.items()
                    for n, p in m.named_parameters()})
        return {k: v.detach().cpu() for k, v in out.items()}

    run("cuda")  # warm
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t = time.perf_counter()
    card_out = run("cuda")
    card_ms = (time.perf_counter() - t) * 1e3
    launches = dict(_cuda.LAUNCHES)
    t = time.perf_counter()
    cpu_out = run("cpu")
    cpu_s = time.perf_counter() - t
    check(torch.equal(card_out["inds"], cpu_out["inds"])
          and torch.equal(card_out["new_xyz"], cpu_out["new_xyz"]),
          "MSG: FPS indices or sampled points differ from the plain "
          "versions'")
    worst = (None, 0.0)
    for k, want in cpu_out.items():
        if k in ("inds", "new_xyz"):
            continue
        err = float((card_out[k] - want).abs().max())
        lim = 5e-3 * float(want.abs().max()) + 1e-6
        check(err <= lim, f"MSG {k}: card vs CPU max err {err} > {lim}")
        if err / lim > worst[1]:
            worst = (k, err / lim)
    for name in ("fps", "ball_query", "gather", "group_gather", "scatter"):
        check(launches[name] > 0, f"MSG: {name} not launched")
    log(f"  (e) MSG at B {MSG_BATCH}, {MSG_POINTS} x 6 points -> GroupAll "
        f"-> LFP, forward and backward: {card_ms:.1f} ms on the card "
        f"(CPU {cpu_s:.1f} s); indices equal, worst {worst[0]} at "
        f"{worst[1]:.3f} of its bound; launches {launches}; {card}")
    modules.cpu()
    torch.cuda.empty_cache()
    return dict(card_ms=card_ms, cpu_seconds=cpu_s, launches=launches,
                worst=worst, seconds=time.perf_counter() - t0)


def demo(tmp):
    """(f) `demo_torch.py`'s main in this process: every kernel launches
    (the tiny model's training epoch and request) and it ends with
    `[demo] OK`. `entry_point_children` runs it as a user starts it."""
    import demo_torch

    text, launches, seconds = in_process(
        demo_torch.main, ["--workdir", os.path.join(tmp, "demo_main")])
    check(text.rstrip().endswith("[demo] OK"),
          f"demo_torch.main did not print [demo] OK:\n{text[-2000:]}")
    for name, n in launches.items():
        check(n > 0, f"demo_torch.main: {name} not launched")
    log(f"  (f) demo_torch.main in process: [demo] OK in {seconds:.1f} s, "
        f"launches {launches}")
    return dict(launches=launches, seconds=seconds)


def entry_point_children(root, tmp, span_cli, stored, table):
    """The entry points of (b), (c) and (f) as a user starts them, five
    child processes side by side, for their wall seconds (their launches
    were counted in process): `span_cls_torch.py` for one epoch (into a
    checkpoint of its own), `--eval` and `--store` from (b)'s checkpoint,
    whose accuracy and spans must equal (b)'s in-process runs';
    `gen_class_embeddings_torch.py` with (c)'s `--params`, whose table must
    equal (c)'s; `demo_torch.py`, which must end with `[demo] OK`."""
    import json

    import numpy as np

    t0 = time.perf_counter()
    span = [sys.executable, os.path.join(ROOT, "span_cls_torch.py")]
    out = os.path.join(tmp, "class_embeddings_child.npy")
    children = {
        "span_cls_torch.py": (span + span_cli["flags"] + [
            "--checkpoint_path", os.path.join(tmp, "span_ckpt_child")], root),
        "span_cls_torch.py --eval": (span + span_cli["argv"] + ["--eval"],
                                     root),
        "span_cls_torch.py --store": (span + span_cli["argv"]
                                      + ["--store"], root),
        "gen_class_embeddings_torch.py": ([
            sys.executable,
            os.path.join(ROOT, "gen_class_embeddings_torch.py"),
            "--output", out, "--params", table["params"]], ROOT),
        "demo_torch.py": ([
            sys.executable, os.path.join(ROOT, "demo_torch.py"),
            "--workdir", os.path.join(tmp, "demo")], ROOT),
    }

    def timed(what):
        cmd, cwd = children[what]
        t = time.perf_counter()
        return run_child(cmd, 600, what, cwd), time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(len(children)) as ex:
        futures = {what: ex.submit(timed, what) for what in children}
        done = {what: f.result() for what, f in futures.items()}
    text = {what: r[0] for what, r in done.items()}
    seconds = {what: r[1] for what, r in done.items()}
    check(any(line.startswith("epoch 1/1 ")
              for line in text["span_cls_torch.py"].splitlines()),
          f"span_cls_torch.py: {text['span_cls_torch.py'][-2000:]}")
    check(_val_acc(text["span_cls_torch.py --eval"],
                   "span_cls_torch.py --eval") == span_cli["val_acc"],
          "span_cls_torch.py --eval: another accuracy than its main's in "
          "this process")
    with open(os.path.join(root, "sr3d_pred_spans.json")) as f:
        check(json.load(f) == stored, "span_cls_torch.py "
              "--store: other spans than its main's in this process")
    check(np.array_equal(np.load(out), np.load(table["table"])),
          "gen_class_embeddings_torch.py: another table than its main's in "
          "this process")
    check(text["demo_torch.py"].rstrip().endswith("[demo] OK"),
          f"demo_torch.py did not print [demo] OK:\n"
          f"{text['demo_torch.py'][-2000:]}")
    log("  (b, c, f) as child processes side by side: " + ", ".join(
        f"{what} {s:.1f} s" for what, s in seconds.items())
        + "; the same accuracy, spans and table as in process, [demo] OK")
    return dict(child_seconds=seconds, seconds=time.perf_counter() - t0)


def text_side(args, gen, card, tmp):
    """Phase 13: K3 and K4 at the text shapes, then parts (a) to (f); the
    launches of each part's main path, read around it."""
    report = {}
    t = time.perf_counter()
    report["attention"], report["attention_bwd"], report["worst"] = \
        check_text_attention(gen, 0x5EED0000 + args.seed)
    report["attention_seconds"] = time.perf_counter() - t
    root = write_text_root(os.path.join(tmp, "text_root"), args.seed,
                           **TEXT_ROWS)
    report["span"] = span_training(args, root, card)
    report["span_cli"] = span_command_line(root, tmp)
    report["class_embeddings"] = class_embedding_table(args, tmp)
    report["pretrain"] = text_pretraining(tmp)
    report["msg"] = msg_modules(args, card)
    report["demo"] = demo(tmp)
    report["children"] = entry_point_children(
        root, tmp, report["span_cli"], report["span_cli"].pop("stored"),
        report["class_embeddings"])
    report["launches"] = {
        k: sum(report[part]["launches"][k] for part in
               ("span", "span_cli", "class_embeddings", "pretrain", "msg",
                "demo"))
        for k in report["span"]["launches"]}
    for part in ("attention", "span", "span_cli", "class_embeddings",
                 "pretrain", "msg", "demo", "children"):
        s = report[part]["seconds"] if part != "attention" \
            else report["attention_seconds"]
        log(f"  phase 13 {part}: {s:.1f} s")
    return report


# ------------------------------------------------------------- phase 14

def _resolved_march(cxx):
    """The -march that `cxx -march=native` resolves to on this host."""
    out = subprocess.run([*cxx, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, timeout=60)
    for line in out.stdout.splitlines():
        fields = line.split()
        if len(fields) == 2 and fields[0] == "-march=":
            return fields[1]
    return "not reported"


def _host_cpu():
    """The host CPU's model name from /proc/cpuinfo; where it names none
    (a virtualised host may say "unknown"), its vendor, family and model
    numbers."""
    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break  # the first processor's block
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    name = fields.get("model name", "unknown")
    if name != "unknown":
        return name
    return (f"{fields.get('vendor_id', '?')} family "
            f"{fields.get('cpu family', '?')} model "
            f"{fields.get('model', '?')} (no model name in /proc/cpuinfo)")


def host_library_build():
    """The host library's compiler, the seconds of a fresh build (into a
    temporary directory), the -march the compiler resolved and the CPU."""
    import tempfile

    from butd_detr_tpu_torch import native

    cxx = native.compiler()
    version = subprocess.run([*cxx, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        native.build(tmp)
        seconds = time.perf_counter() - t0
    native.library()  # the build every path of this process loads
    return dict(compiler=" ".join(cxx), version=version,
                build_seconds=seconds, march=_resolved_march(cxx),
                cpu=_host_cpu(), library=str(native.library_path()))


def augmentation_against_plain(seed, n=50_000, reps=21):
    """(a) `augment_pointcloud` on an f32 cloud of `n` points with colour:
    the fused pass within 1e-6 x max|plain| of the plain (numpy) passes,
    on 4 seeds; the median ms of each."""
    import numpy as np

    from butd_detr_tpu_torch import native
    from butd_detr_tpu_torch.data import augment_pointcloud

    rng = np.random.RandomState(seed)
    pc = (rng.rand(n, 3) * [8.0, 8.0, 3.0]).astype(np.float32)
    color = rng.rand(n, 3).astype(np.float32)
    worst = 0.0
    for s in range(4):
        got = augment_pointcloud(pc, color, True, np.random.RandomState(s))
        plain = augment_pointcloud(pc, color, True, np.random.RandomState(s),
                                   plain=True)
        for g, p in zip(got[:2], plain[:2]):
            err = float(np.abs(g.astype(np.float64) - p).max()
                        / np.abs(p).max())
            check(err <= 1e-6, f"(a) augmentation: the fused pass is {err} "
                  "x max|plain| off the numpy passes (bound 1e-6)")
            worst = max(worst, err)
    calls = native.CALLS["augment_fused"]
    ms = host_ms(lambda: augment_pointcloud(
        pc, color, True, np.random.RandomState(0)), reps)
    check(native.CALLS["augment_fused"] == calls + reps,
          "(a) augmentation: the default path did not take the fused pass")
    plain_ms = host_ms(lambda: augment_pointcloud(
        pc, color, True, np.random.RandomState(0), plain=True), reps)
    return dict(points=n, worst_relative_err=worst, ms=ms,
                plain_ms=plain_ms)


def ply_reader_against_plain(root, reps=3):
    """(b) `read_ply` (the C++ reader) on every PLY of the scans of
    `root`: the same columns as the Python parser, bit for bit (labels as
    values: the parser keeps the file's ushort); ms a scan of each."""
    import glob

    import numpy as np

    from butd_detr_tpu_torch import native
    from butd_detr_tpu_torch.data.scan import _read_ply_py, read_ply

    paths = sorted(glob.glob(os.path.join(root, "scans", "*", "*.ply")))
    n_scans = CLI_SCENES["n_train"] + CLI_SCENES["n_val"]
    check(len(paths) == 2 * n_scans,
          f"(b) {len(paths)} PLY files under {root}, not {2 * n_scans}")
    points = 0
    for path in paths:
        got, want = read_ply(path), _read_ply_py(path)
        check(sorted(got) == sorted(want),
              f"(b) {path}: columns {sorted(got)} against {sorted(want)}")
        for k, w in want.items():
            g = np.ascontiguousarray(got[k])
            same = (np.array_equal(g, w) if k == "label" else
                    g.dtype == w.dtype and g.tobytes() == w.tobytes())
            check(same, f"(b) {path}: column {k} differs")
        points += len(want["x"])
    calls = native.CALLS["ply_read_vertices"]
    ms = host_ms(lambda: [read_ply(p) for p in paths], reps)
    check(native.CALLS["ply_read_vertices"] == calls + reps * len(paths),
          "(b) read_ply did not take the C++ reader")
    plain_ms = host_ms(lambda: [_read_ply_py(p) for p in paths], reps)
    # a scan: its cloud and its labels file
    return dict(files=len(paths), scans=n_scans, points=points,
                ms_a_scan=ms / n_scans, plain_ms_a_scan=plain_ms / n_scans)


def detection_scenes(seed, n_scenes=32, n_boxes=256, n_objects=12,
                     n_classes=18):
    """`n_scenes` scenes of `n_objects` ground-truth boxes and `n_boxes`
    predicted boxes around them (centres jittered by 0.2 of the size,
    sizes x 0.7-1.3, the object's class 80 % of the time), every score
    distinct: [(gt_class, gt_corners, pred_aabb (K, 6), score, class,
    pred_corners)]."""
    import numpy as np

    from butd_detr_tpu_torch.eval import corners_to_aabb, get_3d_box_batch

    rng = np.random.RandomState(seed)
    scenes = []
    for _ in range(n_scenes):
        center = rng.rand(n_objects, 3) * [8.0, 8.0, 2.0]
        size = rng.rand(n_objects, 3) * 1.5 + 0.2
        gcls = rng.randint(0, n_classes, n_objects)
        src = rng.randint(0, n_objects, n_boxes)
        pc = center[src] + rng.randn(n_boxes, 3) * 0.2 * size[src]
        ps = size[src] * rng.uniform(0.7, 1.3, (n_boxes, 3))
        pcls = np.where(rng.rand(n_boxes) < 0.8, gcls[src],
                        rng.randint(0, n_classes, n_boxes))
        corners = get_3d_box_batch(ps, np.zeros(n_boxes), pc)
        scenes.append(dict(
            gt_cls=gcls,
            gt_corners=get_3d_box_batch(size, np.zeros(n_objects), center),
            aabb=corners_to_aabb(corners),
            score=(rng.permutation(n_boxes) + 1) / n_boxes, cls=pcls,
            corners=corners))
    return scenes


def nms_and_ap_against_plain(seed, reps=5):
    """(c) the same-class 3D NMS of the detection path (IoU 0.25) on 32
    scenes x 256 boxes with distinct scores: keep lists equal to the plain
    (numpy) path's; on a hand-built tie the higher index is kept first.
    (d) `eval_det` on the kept boxes at 0.25 and 0.5: recall, precision
    (so tp and fp) and every AP equal to the numpy loop's. The ms / s of
    each."""
    import numpy as np

    from butd_detr_tpu_torch import native
    from butd_detr_tpu_torch.eval import eval_det, nms_3d_faster, \
        nms_3d_faster_samecls

    scenes = detection_scenes(seed)
    boxes = [np.concatenate([s["aabb"], s["score"][:, None],
                             s["cls"][:, None].astype(np.float64)], 1)
             for s in scenes]
    keeps = [nms_3d_faster_samecls(b, 0.25) for b in boxes]
    for i, b in enumerate(boxes):
        check(keeps[i] == nms_3d_faster_samecls(b, 0.25, plain=True),
              f"(c) scene {i}: the C++ NMS keeps another list than numpy")
        check(nms_3d_faster(b[:, :7], 0.25)
              == nms_3d_faster(b[:, :7], 0.25, plain=True),
              f"(c) scene {i}: the class-blind NMS differs from numpy")
    tie = np.tile([[0, 0, 0, 1, 1, 1, 0.5]], (4, 1)).astype(np.float64)
    tie[0] = [5, 5, 5, 6, 6, 6, 0.25]
    tie_keep = nms_3d_faster(tie, 0.25)
    check(tie_keep == [3, 0],
          f"(c) three tied equal boxes kept {tie_keep}, not [3, 0]")
    calls = native.CALLS["greedy_nms"]
    ms = host_ms(lambda: [nms_3d_faster_samecls(b, 0.25) for b in boxes],
                 reps)
    check(native.CALLS["greedy_nms"] == calls + reps * len(boxes),
          "(c) the NMS did not take the C++ path")
    plain_ms = host_ms(lambda: [nms_3d_faster_samecls(b, 0.25, plain=True)
                                for b in boxes], reps)

    pred_all = {i: [(int(s["cls"][j]), s["corners"][j], float(s["score"][j]))
                    for j in keep]
                for i, (s, keep) in enumerate(zip(scenes, keeps))}
    gt_all = {i: [(int(c), s["gt_corners"][j])
                  for j, c in enumerate(s["gt_cls"])]
              for i, s in enumerate(scenes)}
    ap_rows = {}
    seconds = plain_seconds = 0.0
    for thr in (0.25, 0.5):
        calls = native.CALLS["voc_match"]
        t0 = time.perf_counter()
        rec, prec, ap = eval_det(pred_all, gt_all, thr)
        t1 = time.perf_counter()
        rec_p, prec_p, ap_p = eval_det(pred_all, gt_all, thr, plain=True)
        t2 = time.perf_counter()
        seconds += t1 - t0
        plain_seconds += t2 - t1
        check(native.CALLS["voc_match"] == calls + len(ap),
              f"(d) at {thr}: the C++ matcher ran "
              f"{native.CALLS['voc_match'] - calls} times for {len(ap)} "
              "classes")
        check(ap == ap_p, f"(d) at {thr}: AP {ap} against numpy's {ap_p}")
        for c in ap:
            check(np.array_equal(rec[c], rec_p[c])
                  and np.array_equal(prec[c], prec_p[c]),
                  f"(d) at {thr}, class {c}: recall or precision (tp, fp) "
                  "differs from numpy's")
        ap_rows[thr] = float(np.mean(list(ap.values())))
    return dict(scenes=len(scenes), boxes=boxes[0].shape[0],
                kept=sum(map(len, keeps)), tie_keep=tie_keep,
                nms_ms=ms, nms_plain_ms=plain_ms, eval_det_seconds=seconds,
                eval_det_plain_seconds=plain_seconds, mAP=ap_rows)


def train_split_evaluation(study_dir, history):
    """(f) scripts/train_split_eval_torch.py as a child process on phase
    10's study: one row per checkpoint (epochs 1 and 2), every accuracy in
    [0, 1], and the last row equal to an in-process evaluate_one_epoch of
    the same weights (the script's `evaluation`, `evaluate_checkpoint`)."""
    t0 = time.perf_counter()
    text = run_child([sys.executable, os.path.join(
        "scripts", "train_split_eval_torch.py"), "--study", study_dir,
        "--small_text"], 600, "train_split_eval_torch.py")
    seconds = time.perf_counter() - t0
    with open(os.path.join(study_dir, "train_split_eval.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    check(json.loads(text.strip().splitlines()[-1]) == rows,
          "(f) the printed rows are not the file's")
    check([r["epoch"] for r in rows] == [1, 2],
          f"(f) rows for epochs {[r['epoch'] for r in rows]}, not [1, 2]")
    accs = [v for r in rows for k, v in r.items() if k.startswith("acc")]
    check(len(accs) == 8 and all(0.0 <= v <= 1.0 for v in accs),
          f"(f) accuracies {accs}")
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import train_split_eval_torch as script
    finally:
        sys.path.pop(0)
    t0 = time.perf_counter()
    tester, loader, trainer = script.evaluation(study_dir, small_text=True,
                                                device="cuda")
    try:
        row = script.evaluate_checkpoint(tester, loader, trainer, study_dir,
                                         rows[-1]["epoch"])
    finally:
        loader.close()
    in_process = time.perf_counter() - t0
    check(row == rows[-1], f"(f) the child's last row {rows[-1]} is not "
          f"the in-process evaluation's {row}")
    studied = {k: v for k, v in history[-1].items() if k != "step"}
    return dict(rows=rows, in_process=row, seconds=seconds,
                in_process_seconds=in_process, study_row=studied,
                equals_study_row=studied == rows[-1])


def host_runtime(args, card, cli_root, det_stats, study_dir, history):
    """Phase 14: the port's host C++ runtime (butd_detr_tpu_torch/native.py)
    on the card's host, (a)-(f); every time beside the card and the CPU."""
    build = host_library_build()
    cpu = build["cpu"]
    log(f"  built with {build['compiler']} ({build['version']}) in "
        f"{build['build_seconds']:.2f} s, -march=native -> {build['march']}; "
        f"host CPU {cpu}")
    aug = augmentation_against_plain(args.seed)
    log(f"  (a) augment_pointcloud, {aug['points']} f32 points with colour: "
        f"fused {aug['ms']:.3f} ms, numpy {aug['plain_ms']:.3f} ms (median "
        f"of 21); worst error {aug['worst_relative_err']:.3g} x max|plain| "
        f"(bound 1e-6); {cpu}; card {card}")
    ply = ply_reader_against_plain(cli_root)
    log(f"  (b) read_ply on phase 8's {ply['scans']} scans ({ply['files']} "
        f"files, {ply['points']} points): C++ {ply['ms_a_scan']:.3f} ms a "
        f"scan, Python {ply['plain_ms_a_scan']:.3f} ms a scan; columns "
        f"bit-equal; {cpu}")
    det = nms_and_ap_against_plain(args.seed)
    log(f"  (c) same-class NMS, {det['scenes']} scenes x {det['boxes']} "
        f"boxes ({det['kept']} kept): C++ {det['nms_ms']:.3f} ms, numpy "
        f"{det['nms_plain_ms']:.3f} ms for all; keep lists equal; a tie "
        f"kept {det['tie_keep']}; {cpu}")
    log(f"  (d) eval_det at 0.25 and 0.5 on the kept boxes (mAP "
        f"{det['mAP'][0.25]:.4f}, {det['mAP'][0.5]:.4f}): C++ matcher "
        f"{det['eval_det_seconds']:.3f} s, numpy loop "
        f"{det['eval_det_plain_seconds']:.3f} s; recall, precision and AP "
        f"equal; {cpu}")
    calls = det_stats.get("native_calls", {})
    check(calls.get("greedy_nms") == CLI_SCENES["n_val"]
          and calls.get("voc_match", 0) > 0,
          f"(e) phase 8's detection epoch made {calls} host C++ calls "
          f"(expected greedy_nms {CLI_SCENES['n_val']}, voc_match > 0)")
    log(f"  (e) phase 8's detection epoch on the default path: "
        f"detection_seconds {det_stats['detection_seconds']:.3f} "
        f"(projection, NMS, AP), copy "
        f"{det_stats['detection_copy_seconds']:.3f} s, host C++ calls "
        f"{calls}; {cpu}; card {card}")
    tse = train_split_evaluation(study_dir, history)
    studied = ("equal" if tse["equals_study_row"]
               else f"differs: {tse['study_row']}")
    log(f"  (f) train_split_eval_torch.py ran {tse['seconds']:.1f} s: rows "
        f"{tse['rows']}; the in-process evaluation of epoch "
        f"{tse['rows'][-1]['epoch']} ({tse['in_process_seconds']:.1f} s) "
        f"equal; the study's own row of that epoch {studied}; card {card}")
    return dict(build=build, augmentation=aug, ply=ply, detection=det,
                detection_epoch=dict(
                    detection_seconds=det_stats["detection_seconds"],
                    detection_copy_seconds=det_stats[
                        "detection_copy_seconds"],
                    native_calls=calls),
                train_split_eval=tse)


# ------------------------------------------------------------- phase 15

# scripts/bench_backward.py:120-310, the keys it prints
BENCH_BACKWARD_KEYS = (
    "canary_fps_tier1", "full_step", "fwd_loss_value", "fwd_loss_grad",
    "bwd_total", "adamw_update", "backbone_fwd", "backbone_fwdbwd",
    "text_fwd", "encoder_fwd", "encoder_fwdbwd", "decoder_fwd",
    "decoder_fwdbwd", "heads7_fwd", "heads7_fwdbwd", "loss_fwd",
    "loss_fwdbwd", "backbone_bwd", "encoder_bwd", "decoder_bwd",
    "heads7_bwd", "loss_bwd",
)
# scripts/bench_input_pipeline.py:85-93, the keys it prints
INPUT_PIPELINE_KEYS = ("metric", "scenes_per_sec", "ms_per_batch",
                       "workers", "batch", "points", "host_cpus")


def _last_json(out, what):
    """The JSON object on the last line of a child's output."""
    try:
        return json.loads(out.strip().splitlines()[-1])
    except (IndexError, ValueError):
        raise SmokeFailure(f"{what} printed no JSON line last:\n"
                           + "\n".join(out.splitlines()[-20:]))


def det_setup_from_the_data_root(args, roberta, root, tmp, card):
    """scripts/train_test_det_torch.sh (the `--butd --augment_det`
    setup) trains one epoch on phase 8's root as a user starts it
    (torchrun, one process over NCCL) and evaluates it. Fails unless the
    run's config is the setup's, its epochs are train then eval, every
    logged loss is finite, and every step and evaluation batch (with the
    loss, as --butd evaluates) launched the worked-out counts."""
    from butd_detr_tpu_torch.config import Config

    log_dir = os.path.join(tmp, "det_setup_log")
    t0 = time.perf_counter()
    # `--val_freq 2`: only the run's closing evaluation (epoch 1 is no
    # multiple of 2), which the in-loop one would repeat on the same
    # weights
    run_child(["bash", DET_SCRIPT, *SCRIPT_RUN_FLAGS, "--val_freq", "2",
               "--rng_seed", str(args.seed), "--log_dir", log_dir], 600,
              DET_SCRIPT, env=script_env(root))
    seconds = time.perf_counter() - t0
    with open(os.path.join(log_dir, "config.json")) as f:
        cfg = Config(**json.load(f))
    check(cfg.butd and cfg.augment_det and not cfg.butd_cls
          and cfg.data_root == root,
          f"{DET_SCRIPT}: the run's config is not the setup's: {cfg}")
    with open(os.path.join(log_dir, "log.txt")) as f:
        text = f.read()
    check(NCCL_WORLD_OF_1 in text,
          f"{DET_SCRIPT}: the log names no NCCL world of 1")
    stats = _epoch_stats(text)
    check([s["phase"] for s in stats] == ["train", "eval"],
          f"{DET_SCRIPT}: epochs run: {[s['phase'] for s in stats]}")
    train, evaluation = stats
    losses = _finite_metrics(text, 1)
    check(len(losses) == train["batches"] >= 1,
          f"{len(losses)} logged steps of {train['batches']}")
    per_step = training_step_launches(cfg, roberta)
    per_batch = evaluation_batch_launches(cfg, roberta, with_loss=True)
    _check_launches(stats, per_step, per_batch, DET_SCRIPT)
    launches = {k: sum(x["launches"][k] for x in stats)
                for k in train["launches"]}
    steps_ms = ", ".join(f"{t * 1e3:.0f}" for t in train["batch_seconds"])
    log(f"  (a) {DET_SCRIPT} (torchrun, NCCL, world size 1) ran "
        f"{seconds:.1f} s: {train['batches']} steps at B = "
        f"{cfg.batch_size} ({train['scenes']} scenes), "
        f"{train['scenes_per_second']:.2f} scenes/s over the epoch "
        f"({train['seconds']:.2f} s), loader wait "
        f"{train['loader_wait_share']:.1%} (the first batch "
        f"{train['first_batch_wait_seconds']:.2f} s), steps {steps_ms} ms, "
        f"peak {train['peak_memory_bytes'] / 1e9:.2f} GB; losses "
        f"{', '.join(f'{x:.3f}' for x in losses)}; evaluation with the "
        f"loss {evaluation['scenes']} scenes, "
        f"{evaluation['scenes_per_second']:.2f} scenes/s; launches "
        f"{launches}; card {card}")
    return dict(seconds=seconds, losses=losses, epochs=stats,
                per_step=per_step, per_batch=per_batch, launches=launches)


def backward_by_stage(card):
    """scripts/bench_backward_torch.py at full width, B = 24, 3 timed
    calls an entry: every key of the JAX script, each `_fwd` and
    `_fwdbwd` entry finite and positive on the host clock and in its
    `_device_ms`."""
    import math

    t0 = time.perf_counter()
    out = run_child([sys.executable, os.path.join(
        "scripts", "bench_backward_torch.py")], 600,
        "bench_backward_torch.py",
        env={"BENCH_TINY": "0", "BENCH_BATCH": "24", "BENCH_REPS": "3"})
    seconds = time.perf_counter() - t0
    result = _last_json(out, "bench_backward_torch.py")
    missing = [k for k in BENCH_BACKWARD_KEYS if k not in result]
    check(not missing, f"bench_backward_torch.py lacks {missing}")
    timed = [k for k in BENCH_BACKWARD_KEYS
             if k.endswith(("_fwd", "_fwdbwd"))]
    for k in (*timed, *(f"{k}_device_ms" for k in timed)):
        v = result.get(k)
        check(isinstance(v, (int, float)) and math.isfinite(v) and v > 0,
              f"bench_backward_torch.py: {k} = {v}")
    check(result["device"] == card,
          f"bench_backward_torch.py ran on {result['device']!r}")
    log(f"  (b) bench_backward_torch.py ran {seconds:.1f} s, B = 24: "
        + json.dumps(result))
    return dict(seconds=seconds, result=result)


def input_pipeline(card, tmp):
    """scripts/bench_input_pipeline_torch.py at 50,000 points, B = 24,
    10 timed batches, a worker a host CPU: the JAX script's keys and
    `warmup_s`."""
    t0 = time.perf_counter()
    out = run_child([sys.executable, os.path.join(
        "scripts", "bench_input_pipeline_torch.py"), "--points", "50000",
        "--batch", "24", "--batches", "10", "--workers", str(os.cpu_count()),
        "--out", os.path.join(tmp, "input_pipeline")], 600,
        "bench_input_pipeline_torch.py")
    seconds = time.perf_counter() - t0
    result = _last_json(out, "bench_input_pipeline_torch.py")
    missing = [k for k in (*INPUT_PIPELINE_KEYS, "warmup_s")
               if k not in result]
    check(not missing, f"bench_input_pipeline_torch.py lacks {missing}")
    check(result["scenes_per_sec"] > 0 and result["points"] == 50_000,
          f"bench_input_pipeline_torch.py: {result}")
    log(f"  (c) bench_input_pipeline_torch.py ran {seconds:.1f} s: "
        + json.dumps(result) + f"; host of {card}")
    return dict(seconds=seconds, result=result)


def run(args):
    import numpy as np
    import torch

    from butd_detr_tpu_torch.config import butd_cls_config
    from butd_detr_tpu_torch.lang import roberta_base_config
    from butd_detr_tpu_torch.ops import _cuda
    from butd_detr_tpu_torch.predict import GroundingPredictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"seed": args.seed}

    # 1. build
    log("== phase 1: build the kernels")
    secs = _cuda.build_all()
    report["build_seconds"] = secs
    log(f"  built {sorted(_cuda.KERNELS)} in {secs:.1f} s")
    for name in _cuda.KERNELS:
        if name.startswith("attention"):
            continue
        for line in _cuda.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"  [{name}] {line.strip()}")
    report["gather_resources"] = tile_kernel_resources("gather")
    report["assignment_resources"] = tile_kernel_resources("assignment")
    report["attention_resources"] = attention_resources("attention")
    report["attention_bwd_resources"] = attention_resources("attention_bwd")
    report["fps_plan"] = fps_plan((50_000, 2048, 1024, 512))

    # 2. kernels vs plain versions at the path's shapes
    log("== phase 2: kernels vs plain versions on the card")
    cfg = butd_cls_config()
    roberta = roberta_base_config()
    npoints = (2048, 1024, 512, 256)
    rng = np.random.RandomState(args.seed)
    scenes = [make_scene(rng) for _ in range(max(args.requests, 1))]
    from butd_detr_tpu_torch.predict import prepare_point_cloud

    pc = prepare_point_cloud(scenes[0][0], cfg.num_points, cfg.use_color)
    xyz = torch.from_numpy(pc[None, :, :3].copy()).cuda()
    tiers = sa_tiers(xyz, npoints, (0.2, 0.4, 0.8, 1.2), (64, 32, 16, 16))
    fps_row, bq_row = check_point_kernels(tiers)
    report["ball_query_grid"] = check_ball_query_grid()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    log("  row gathers of one request (B = 1)")
    g1_row, gg1_row = check_gathers(
        *forward_gathers(tiers, npoints, cfg, gen), gen, batched=False)
    shapes = attention_shapes(cfg, roberta, npoints)
    att_row = check_attention(shapes, gen, args.train_batch,
                              0x5EED0000 + args.seed)
    report["dropout"] = check_dropout(gen, 0x5EED0000 + args.seed)
    bwd_row = check_attention_backward(shapes, gen, 0x5EED0000 + args.seed,
                                       args.train_batch)
    log("  K3 and K4 with bf16 operands (--use_bf16), against f32 operands")
    fwd_bf16, bwd_bf16 = check_attention_bf16_operands(
        shapes, gen, 0x5EED0000 + args.seed, args.train_batch)
    att_row.update(fwd_bf16)
    bwd_row.update(bwd_bf16)
    from butd_detr_tpu_torch.data import synthetic_batch

    def train_batch(i):
        return synthetic_batch(
            batch_size=args.train_batch, num_points=cfg.num_points,
            max_text_len=cfg.max_text_len, max_num_obj=cfg.max_num_obj,
            max_det_boxes=cfg.max_det_boxes, seed=args.seed + i,
            vocab_size=roberta.vocab_size, spatial_sort=cfg.spatial_sort)

    batches = [train_batch(i) for i in range(args.train_steps + 1)]
    cloud = torch.from_numpy(batches[0]["point_clouds"][..., :3].copy())
    train_tiers = sa_tiers(cloud.cuda(), npoints, (0.2, 0.4, 0.8, 1.2),
                           (64, 32, 16, 16))
    check_point_kernels_batched(train_tiers, fps_row, bq_row)
    sc_row = check_scatter(training_gathers(train_tiers, npoints, cfg, gen),
                           gen)
    log(f"  row gathers of one batch (B = {args.train_batch})")
    g_row, gg_row = check_gathers(
        *forward_gathers(train_tiers, npoints, cfg, gen), gen, batched=True)
    for row, one in ((g_row, g1_row), (gg_row, gg1_row)):
        row["request_ms"] = one["ms"]
        row["request_shapes"] = one["shapes"]
    del train_tiers
    log("  K6 and K5 at the rows of the --use_bf16 model")
    g_row["bf16_rows"], sc_row["bf16_rows"] = check_bf16_rows(
        gen, args.train_batch)
    log("  the accuracy study's shapes (phases 9 and 10)")
    report["study_shapes"] = check_study_shapes(gen, args.seed)
    log("  the assignment of the loss's matching, at every path's shape")
    as_row = check_assignment(gen)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # 3. serving at full width
    log("== phase 3: serve requests at full width (butd_cls, SR3D)")
    t0 = time.perf_counter()
    pred = GroundingPredictor(cfg, roberta_config=roberta,
                              backbone_npoints=npoints, device="cuda",
                              seed=args.seed)
    log(f"  predictor built in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in pred.model.parameters()) / 1e6:.1f}M "
        f"parameters)")

    def request(i):
        cloud, boxes, cids = scenes[i % len(scenes)]
        utt, phrase = REQUESTS[i % len(REQUESTS)]
        return pred.predict(cloud, utt, phrase=phrase, det_boxes=boxes,
                            det_class_ids=cids, mode="bbf", top_k=10)

    request(0)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    _cuda.reset_launches()
    lat = []
    outs = []
    for i in range(args.requests):
        t = time.perf_counter()
        out = request(i)
        lat.append((time.perf_counter() - t) * 1e3)
        outs.append(out)
    launches = dict(_cuda.LAUNCHES)
    expect = dict(FORWARD_LAUNCHES, attention=attention_calls(cfg, roberta),
                  assignment=0)
    for name, n in expect.items():
        check(launches[name] == n * args.requests,
              f"{name}: {launches[name]} launches for {args.requests} "
              f"requests, expected {n} each")
    for i, out in enumerate(outs):
        check(out["boxes"].shape == (10, 6) and out["scores"].shape == (10,),
              f"request {i}: shapes {out['boxes'].shape}")
        check(np.isfinite(out["boxes"]).all()
              and np.isfinite(out["scores"]).all(),
              f"request {i}: non-finite output")
    lat_sorted = sorted(lat)
    median = lat_sorted[len(lat) // 2] if len(lat) % 2 else \
        0.5 * (lat_sorted[len(lat) // 2 - 1] + lat_sorted[len(lat) // 2])
    report["serving"] = dict(requests=args.requests, latency_ms=lat,
                             median_ms=median, launches=launches)
    log(f"  {args.requests} requests: median warm latency {median:.1f} ms "
        f"({', '.join(f'{x:.1f}' for x in lat)}); top-k boxes "
        f"{outs[0]['boxes'].shape}, scores {outs[0]['scores'].shape}; "
        f"launches {launches}")
    del pred
    torch.cuda.empty_cache()

    # 4. card vs CPU, f32 + precise, same weights; then the default mode
    log("== phase 4: one request on the card and on the CPU (f32, precise), "
        "and on the card in the default and --use_bf16 modes")
    report["card_vs_cpu"] = compare_card_cpu(args, roberta, npoints,
                                             scenes[0], REQUESTS[0][0])
    torch.cuda.empty_cache()

    # 5. gradients of a small model, card vs CPU
    log("== phase 5: gradients of a small model on the card and on the CPU")
    report["gradients_card_vs_cpu"] = compare_gradients_card_cpu(args)
    torch.cuda.empty_cache()

    # 6. training at full width
    log(f"== phase 6: {args.train_steps} training steps at full width, "
        f"B={args.train_batch}")
    report["training"], trainer = train_steps(args, cfg, roberta, npoints,
                                              batches)
    train_launches = report["training"]["launches"]
    report["training"]["loss_without_sync"] = loss_without_sync(
        trainer, batches[-1])

    # 7. an evaluation epoch at full width, from a checkpoint
    log(f"== phase 7: checkpoint round trip and an evaluation epoch of "
        f"{args.eval_scenes} scenes at full width, B={args.train_batch}")
    report["evaluation"] = evaluation_epoch(args, cfg, roberta, npoints,
                                            trainer)
    eval_launches = {k: v + report["evaluation"]["with_loss"]["launches"][k]
                     for k, v in report["evaluation"]["launches"].items()}
    del trainer
    torch.cuda.empty_cache()

    # 11 (run here, while the phase-6 batches are at hand). --use_bf16
    # beside the default mode: requests and training steps
    card = card_name_and_limit()
    log("== phase 11: --use_bf16 beside the default mode: 3 requests and "
        f"2 training steps at B={args.train_batch} each, device-busy ms "
        "by group, peak memory")
    report["bf16_mode"] = bf16_mode(args, cfg, roberta, npoints, scenes,
                                    batches, card)
    bf16_launches = {
        k: report["bf16_mode"]["bf16"]["request_launches"][k]
        + report["bf16_mode"]["bf16"]["step_launches"][k]
        for k in report["bf16_mode"]["bf16"]["step_launches"]}
    torch.cuda.empty_cache()

    # 8. train and evaluate from a data root through the CLI
    import tempfile

    log("== phase 8: prepare_data_torch.py, train_torch.py, predict_torch.py "
        "and the detection evaluation on a "
        f"ScanNet-format root ({CLI_SCENES['points_per_scan']} points a "
        "scan), B=24, 4 loader workers")
    # phase 8's root and phase 10's study stay until phase 14 reads them
    kept = tempfile.TemporaryDirectory()
    cli_tmp = os.path.join(kept.name, "cli")
    os.makedirs(cli_tmp)
    report["cli"] = train_and_evaluate_from_a_data_root(
        args, cfg, roberta, card, cli_tmp)
    cli_launches = report["cli"]["launches"]

    # 9, 10. the accuracy study: the overfit probe, a study resumed
    from butd_detr_tpu_torch.data import make_rich_scannet

    root = os.path.join(kept.name, "study_data")
    make_rich_scannet(root, **STUDY_SCENES)
    log("== phase 9: overfit_probe_torch.py, the jax_b12_nt32 "
        "invocation (220 steps at B = 12, 5,000 points, small text "
        "tower from text_init.npz)")
    report["probe"] = overfit_probe(args, root, card)
    log("== phase 10: accuracy_study_torch.py, the nt32 study cut to "
        f"{STUDY_SCENES['n_train']} + {STUDY_SCENES['n_val']} scenes "
        "and 2 epochs, the second resumed in a new process")
    study_dir = os.path.join(kept.name, "study")
    report["study"] = study_with_resume(args, root, card, study_dir)
    probe_launches = report["probe"]["launches"]
    study_launches = report["study"]["launches"]

    # 12. training across processes
    from butd_detr_tpu_torch.config import butd_cls_config as _cls_config

    dist_report = report["distributed"] = {}
    log(f"== phase 12 (a, b): --dp 2, then --mp 2, two ranks on the card "
        f"over gloo, beside one process; {card}")
    pred = GroundingPredictor(
        _cls_config(backbone_bf16=False, attn_precise=True),
        roberta_config=roberta, backbone_npoints=npoints, device="cuda",
        seed=args.seed)
    cloud, boxes, cids = scenes[0]
    inputs = pred.make_inputs(cloud, REQUESTS[0][0], boxes, cids)
    ranks = run_ranks(dist_rank, 2, args.seed, args.train_batch,
                      {k: v.cpu() for k, v in inputs.items()})
    log(f"  (a) --dp 2: {args.train_batch // 2} rows a rank, dropout 0; "
        "phase 5's small model's gradients, then two full-width f32 steps")
    dist_report["dp"] = data_parallel(args, [r["dp"] for r in ranks])
    log("  (b) --mp 2: the forward of one request (f32, precise)")
    dist_report["tp"] = tensor_parallel(roberta, pred, inputs,
                                        [r["tp"] for r in ranks])
    del pred, inputs, ranks
    torch.cuda.empty_cache()
    log(f"== phase 12 (c): phase 8's train_torch.py ran under torchrun, one "
        f"process over NCCL: {report['cli']['nccl']}")
    log("== phase 12 (d): one --use_multiview step at "
        f"B = {args.train_batch}")
    dist_report["multiview"] = multiview_step(args, roberta)
    log("== phase 12 (e): --profile_dir on a short training epoch")
    dist_report["profiler"] = profiler_window(args, cfg, roberta, npoints)
    dist_launches = {k: sum(dist_report[part]["launches"][k]
                            for part in dist_report)
                     for k in dist_report["dp"]["launches"]}
    torch.cuda.empty_cache()

    # 13. the text side
    log("== phase 13: the text side: K3 and K4 at the text shapes, the "
        "span predictor (RoBERTa-base trained at B 128), span_cls_torch.py, "
        "the class table, the text pretraining, the PointNet++ MSG modules "
        "and the demo")
    with tempfile.TemporaryDirectory() as tmp:
        text = report["text"] = text_side(args, gen, card, tmp)
    text_launches = text["launches"]

    # 14. the host runtime
    log("== phase 14: the host runtime (butd_detr_tpu_torch/native.py): "
        "the build, the fused augmentation, the PLY reader, the NMS, the "
        "VOC matcher, the detection epoch, the train-split evaluation")
    report["host_runtime"] = host_runtime(
        args, card, os.path.join(cli_tmp, "data"),
        report["cli"]["detection"]["stats"], study_dir,
        report["study"]["history"])

    # 15. the JAX package's last tools: the det setup's script, the two
    # timers
    log("== phase 15: scripts/train_test_det_torch.sh on phase 8's root, "
        "bench_backward_torch.py at B = 24, bench_input_pipeline_torch.py "
        "at 50,000 points")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tools = report["tools"] = {}
    tools["det_setup"] = det_setup_from_the_data_root(
        args, roberta, os.path.join(cli_tmp, "data"), kept.name, card)
    tools["backward"] = backward_by_stage(card)
    tools["input_pipeline"] = input_pipeline(card, kept.name)
    tools["seconds"] = time.perf_counter() - t0
    log(f"  phase 15 took {tools['seconds']:.1f} s")
    tools_launches = tools["det_setup"]["launches"]
    kept.cleanup()

    kernels = []
    replaces = {
        "fps": "butd_detr_tpu/ops/pallas_fps.py:142",
        "ball_query": "butd_detr_tpu/ops/pallas_ball_query.py:178",
        "attention": "butd_detr_tpu/ops/pallas_attention.py:213",
        "attention_bwd": "butd_detr_tpu/ops/pallas_attention.py:219",
        "scatter": "butd_detr_tpu/ops/pallas_scatter.py:108",
        "gather": "butd_detr_tpu/ops/pallas_scatter.py:198",
        "group_gather": "butd_detr_tpu/ops/pallas_window_gather.py:101",
        # no Pallas kernel: the JAX package's solver is XLA's while_loop
        "assignment": "butd_detr_tpu/losses/matcher.py:33",
    }
    backward_only = ("attention_bwd", "scatter")
    for row in (fps_row, bq_row, att_row, bwd_row, sc_row, g_row, gg_row,
                as_row):
        name = row["name"]
        check(train_launches[name] > 0,
              f"{name}: not launched on the training path")
        if name == "assignment":  # the loss's: no request computes one
            check(launches[name] == 0 and eval_launches[name] > 0,
                  f"{name}: launched by a request, or not by the "
                  "evaluation with the loss")
        check(name in backward_only or name == "assignment"
              or (launches[name] > 0 and eval_launches[name] > 0),
              f"{name}: not launched on the serving or evaluation path")
        check(cli_launches[name] > 0,
              f"{name}: not launched by train_torch.py")
        check(probe_launches[name] > 0 and study_launches[name] > 0,
              f"{name}: not launched by the overfit probe or the study")
        check(bf16_launches[name] > 0,
              f"{name}: not launched by the --use_bf16 requests and steps")
        check(dist_report["dp"]["launches"][name] > 0
              and dist_report["profiler"]["launches"][name] > 0
              and dist_report["multiview"]["launches"][name] > 0,
              f"{name}: not launched by the --dp 2 ranks, the profiled "
              "epoch or the multiview step")
        # the text side: K3 and K4 by the span training, the point
        # kernels by the PointNet++ MSG modules, all eight by the demo
        check(text_launches[name] > 0,
              f"{name}: not launched on the text side (phase 13)")
        check(tools_launches[name] > 0,
              f"{name}: not launched by {DET_SCRIPT} (phase 15)")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"butd_detr_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": (launches[name] + train_launches[name]
                         + eval_launches[name] + cli_launches[name]
                         + probe_launches[name] + study_launches[name]
                         + bf16_launches[name] + dist_launches[name]
                         + text_launches[name] + tools_launches[name]),
            "launches_serving": launches[name],
            "launches_training": train_launches[name],
            "launches_evaluation": eval_launches[name],
            "launches_cli": cli_launches[name],
            "launches_probe": probe_launches[name],
            "launches_study": study_launches[name],
            "launches_bf16": bf16_launches[name],
            "launches_distributed": dist_launches[name],
            "launches_text": text_launches[name],
            "launches_det_setup": tools_launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"),
        })
        # K4 at p = 0; K6 with each index type; the batch of a training
        # step (K1, K2, K3) and of an evaluation batch (K3), with SDPA's
        # time beside K3's; K2's kernel by tier and the candidates it
        # tested; K5's run-to-run difference and its bits against the CPU
        for extra in ("ms_p0", "library_ms_p0", "ms_int32", "ms_int64",
                      "training_ms", "library_training_ms", "evaluation_ms",
                      "library_evaluation_ms", "paths", "candidates_tested",
                      "candidates_index_order_scan", "run_to_run",
                      "bit_equal_cpu", "chain_ms", "copy_ms", "copy_plain_ms",
                      "copy_bound_ms", "copy_library_ms", "ms_cli",
                      "plain_ms_cli", "library_ms_cli", "bound_ms_cli",
                      "ms_probe", "plain_ms_probe", "library_ms_probe",
                      "bound_ms_probe", "ms_study", "plain_ms_study",
                      "library_ms_study", "bound_ms_study",
                      "ms_bf16_operands", "ms_f32_operands",
                      "training_ms_bf16_operands",
                      "training_ms_f32_operands", "bf16_rows", "host_us",
                      "library_host_us", "groupings_device_ms", "device_ms",
                      "device_ms_cli", "device_ms_probe", "device_ms_study",
                      "plan"):
            if extra in row:
                kernels[-1][extra] = row[extra]
    # K7 at the multiview width (sa1's 131 channels)
    kernels[[k["name"] for k in kernels].index("group_gather")][
        "multiview"] = dist_report["multiview"]["k7"]
    # K3 and K4 at the text shapes: the span step's, scoring batch's,
    # class table's and pretraining step's calls, each shape's numbers
    # times its calls
    for k in kernels:
        if k["name"] in ("attention", "attention_bwd"):
            shapes = text[k["name"]]
            k["text_shapes"] = shapes
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                for name, sh in shapes.items():
                    k[f"{key}_{name}"] = sh["calls"] * sh[key]
    report["kernels"] = kernels
    report["detail"] = {"fps": fps_row, "ball_query": bq_row,
                        "attention": att_row, "attention_bwd": bwd_row,
                        "scatter": sc_row, "gather": g_row,
                        "group_gather": gg_row, "assignment": as_row}
    return report


def card_name_and_limit():
    """The card's name and power limit as nvidia-smi gives them, or ''."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = smi.stdout.strip().splitlines() if smi.returncode == 0 else []
    return lines[0] if lines else ""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--train-steps", type=int, default=3)
    ap.add_argument("--train-batch", type=int, default=8)
    ap.add_argument("--eval-scenes", type=int, default=20)
    ap.add_argument("--report", default=None,
                    help="also write the full JSON report to this path")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    if min(args.requests, args.train_steps, args.train_batch,
           args.eval_scenes) < 1:
        ap.error("--requests, --train-steps, --train-batch and "
                 "--eval-scenes must be >= 1")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import butd_detr_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e}); run from "
              "the root of a checkout", file=sys.stderr)
        return 2

    try:
        report = run(args)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    report["wall_seconds"] = time.perf_counter() - t0
    log(f"chip_smoke: all phases passed in {report['wall_seconds']:.1f} s")
    card = card_name_and_limit()
    if not card:
        print("chip_smoke: nvidia-smi gave no card line", file=sys.stderr)
        return 1
    report["card"] = card
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": report["kernels"]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
