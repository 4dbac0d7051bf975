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
   forward's no spill); FPS's layout per tier size: the blocks of a
   cloud's cluster and cudaOccupancyMaxActiveClusters;
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
   (each read as it is; the row gather and torch.gather as the median of
   three runs, since a call is bound by the host); the grouped gather's
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
   every cost tied, its optimum scipy's within 1e-5 relative, timed
   beside scipy on the host with both copies (the port's earlier path).
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
   group printed;
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
   query, 51 attention, 39 attention-backward, 13 scatter-add, 15 row
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
   `train_torch.py` with the flags of scripts/train_test_cls.sh (B = 24)
   and `--max_epoch 1 --val_freq 1 --num_workers 4` trains one epoch (40
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
   phase 9 (the text at 128 tokens).
Phase 2 also holds K1, K2, K6 and K7 bit-equal, and K3 and K4 within
their bounds (p = 0 and 0.1, both modes), at the shapes of phases 9 and
10: B = 12 at 5,000 points and B = 24 at 20,000, the small text tower's
4 heads of Dh 32 at L 32 and 128 with key padding, 32 queries.

Prints the whole run's wall time, the `kernels` JSON line, the card's
name and power limit, and last
`{"ok": true, "device": {...}}`. `--report PATH` also writes a fuller JSON
report (per-tier and per-shape times, latencies, the card-vs-CPU errors).
"""

import argparse
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


def log(*a):
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
    """attention_bwd_dq_mma_kernel<48, 1> from its mangled name."""
    import re

    m = re.search(r"\d+(attention_\w+?_kernel)I(\w*?)EEv", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[ib](\d+)E", m.group(2) + "E")
    return f"{m.group(1)}<{', '.join(args)}>"


def attention_resources(lib_name):
    """Per kernel function of csrc/<lib_name>.cu (the attention forward or
    backward): ptxas's registers, shared memory and spills (from the build
    log) and the HMMA (tensor-core mma) instructions in its SASS (cuobjdump
    -sass, where the toolkit has it). Fails if a default-mode (mma) kernel
    has no HMMA, or if one of the forward's spills."""
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
            res["smem_bytes"] = smem_bytes(
                int(name.split("<")[1].split(",")[0]))
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

    def distinct(m, n):
        return torch.stack([torch.randperm(n, device="cuda",
                                           generator=gen)[:m]
                            for _ in range(B)]).to(torch.int32)

    out.append(("kps_features", f32, 1, distinct(cfg.num_target, npoints[1]),
                npoints[1], 288))
    out.append(("matched_boxes", f32, cfg.num_decoder_layers + 1,
                distinct(cfg.max_num_obj, cfg.num_target), cfg.num_target,
                6))
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

    def distinct(m, n, dtype):
        return torch.stack([torch.randperm(n, device="cuda",
                                           generator=gen)[:m]
                            for _ in range(B)]).to(dtype)

    kps = distinct(cfg.num_target, npoints[1], torch.int32)
    rows.append(("kps_xyz", f32, npoints[1], 3, kps, 1, 1))
    rows.append(("kps_features", f32, npoints[1], 288, kps, 1, 1))
    # the matcher's assignment arrives as int64
    rows.append(("matched_boxes", f32, cfg.num_target, 6,
                 distinct(cfg.max_num_obj, cfg.num_target, torch.int64),
                 0, cfg.num_decoder_layers + 1))
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
                 max_abs_err=0, shapes=[])
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
        ms = median_ms(lambda: gather_rows(src, idx), 20)
        # each index type read as it is (no cast kernel before the gather)
        idx32, idx64 = idx.int(), idx.long()
        ms32 = median_ms(lambda: gather_rows(src, idx32), 20)
        ms64 = median_ms(lambda: gather_rows(src, idx64), 20)
        pms = time_ms(lambda: gather_rows_plain(src, idx), 20)
        wide_idx = idx.long()[..., None].expand(-1, -1, C)
        lms = median_ms(lambda: torch.gather(src, 1, wide_idx), 20)
        row_bytes = C * src.element_size()
        nbytes = B * M * 4 + (_distinct_rows(idx, n) + B * M) * row_bytes
        b_ms, by = bound_ms(nbytes, [])
        g_row["shapes"].append(dict(
            name=name, B=B, n=n, M=M, C=C, dtype=str(dtype),
            index_dtype=str(idx.dtype), per_batch=per_batch,
            per_step=per_step, ms=ms, ms_int32=ms32, ms_int64=ms64,
            plain_ms=pms, library_ms=lms, bound_ms=b_ms, bound_by=by))
        for key, val in (("ms", ms), ("ms_int32", ms32), ("ms_int64", ms64),
                         ("plain_ms", pms), ("library_ms", lms),
                         ("bound_ms", b_ms)):
            g_row[key] += per_batch * val
        g_row["step_ms"] += per_step * ms
        log(f"  gather {name:18s} B={B} n={n:5d} M={M:6d} C={C:3d} "
            f"{str(dtype)[6:]}: {ms:.4f} ms (int32 {ms32:.4f}, int64 "
            f"{ms64:.4f}; plain {pms:.4f}, torch.gather {lms:.4f}, bound "
            f"{b_ms:.5f}) x{per_batch} a batch, x{per_step} a step: "
            f"bit-equal")

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
            src = torch.randn(B, n, C, device="cuda", generator=gen).to(dtype)
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
    cases = []
    for name, M, G, Q, counts in ASSIGNMENT_SHAPES:
        pick = torch.randint(0, len(counts), (M,), device="cuda",
                             generator=gen)
        n_valid = torch.tensor(counts, device="cuda")[pick]
        cases.append((name, matcher_costs(gen, M, G, Q, n_valid), n_valid))
    M, G, Q = 56, 132, 256
    n_valid = torch.full((M,), 20, device="cuda")
    nan = matcher_costs(gen, M, G, Q, n_valid).contiguous()
    nan[0, 3] = float("nan")
    nan[1, :, 7] = float("inf")
    nan[2] = float("nan")
    nan[3, 5, 9] = -float("inf")
    cases.append(("nan", nan, n_valid))
    cases.append(("all_tied", torch.full((4, G, Q), 0.5, device="cuda"),
                  torch.tensor([G, 64, 1, 0], device="cuda")))

    row = dict(name="assignment", max_abs_err=0, shapes={})
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
        smem = int(lib.assignment_smem_bytes(G, Q))
        # the tile of min(G, Q) rows of Q + 1 costs fits, or each path
        # step reads its row from device memory
        entry = dict(matrices=M, targets=G, queries=Q,
                     rows=int(n_valid.sum()), smem_bytes=smem,
                     staged=smem >= min(G, Q) * (Q + 1) * 4,
                     optimum_rel_err=worst)
        if name in ("training", "cli", "probe", "study", "full"):
            before = _cuda.LAUNCHES["assignment"]
            entry["ms"] = time_ms(lambda: solve(cost, n_valid), 20)
            check(_cuda.LAUNCHES["assignment"] == before + 21,
                  f"assignment {name}: not one launch a call")
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
            f"solved, bit-equal (card and CPU), optimum within "
            f"{worst:.2g} of scipy's" + (
                f"; {entry['ms']:.3f} ms (plain {entry['plain_ms']:.1f}, "
                f"bound {entry['bound_ms']:.5f}, scipy on the host with the "
                f"copies {entry['library_ms']:.2f}); {entry['smem_bytes']} "
                f"B of shared memory" if "ms" in entry else ""))
    main = row["shapes"]["training"]
    for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
        row[k] = main[k]
    for name in ("cli", "probe", "study"):
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            row[f"{k}_{name}"] = row["shapes"][name][k]
    return row


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
    # the matched boxes of each loss prefix
    want_gather = 12 + cfg.num_decoder_layers + 1
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
    the model's 6 gathers and each loss prefix's matched-box gather, and
    the loss's one assignment (all prefixes' matrices in one call)."""
    att = attention_calls(cfg, roberta)
    frozen = roberta.num_hidden_layers if cfg.freeze_text_encoder else 0
    return dict(TRAIN_LAUNCHES, attention=att,
                attention_bwd=att - frozen,
                scatter=6 + cfg.num_decoder_layers + 1,
                gather=FORWARD_LAUNCHES["gather"]
                + cfg.num_decoder_layers + 1, assignment=1)


def evaluation_batch_launches(cfg, roberta, with_loss=False):
    """Launches of one evaluation batch; with the loss (an evaluation
    without butd_cls), also the loss's matched-box gathers and its
    assignment."""
    loss_gathers = cfg.num_decoder_layers + 1 if with_loss else 0
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


def run_child(cmd, timeout, what):
    """Run `cmd` from the checkout's root in a session of its own; on
    timeout kill the whole session (the child and its loader workers).
    Returns its output; fails when it exits non-zero."""
    import signal

    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
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


def train_and_evaluate_from_a_data_root(args, cfg, roberta, card):
    """Write a ScanNet-format root (`make_rich_scannet`), build its scan
    caches with `prepare_data_torch.py`, then train one epoch and evaluate
    through `train_torch.py` with the flags of scripts/train_test_cls.sh,
    4 loader workers: two processes started as a user starts them. The
    numbers come from the `epoch stats` lines of the run's log."""
    import math
    import tempfile

    from butd_detr_tpu_torch.data import make_rich_scannet

    with tempfile.TemporaryDirectory() as tmp:
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
        cmd = [sys.executable, "train_torch.py", *CLS_FLAGS,
               "--max_epoch", "1", "--val_freq", "1", "--num_workers", "4",
               "--print_freq", "1", "--rng_seed", str(args.seed),
               "--data_root", root, "--log_dir", log_dir]
        t0 = time.perf_counter()
        run_child(cmd, 600, "train_torch.py")
        seconds = time.perf_counter() - t0
        with open(os.path.join(log_dir, "log.txt")) as f:
            text = f.read()
        checkpoints = sorted(n for n in os.listdir(log_dir)
                             if n.startswith("ckpt_epoch_"))
        check(checkpoints == ["ckpt_epoch_1.pth"],
              f"checkpoints written: {checkpoints}")
        ckpt = os.path.join(log_dir, checkpoints[0])
        grounding = ground_from_the_checkpoint(args, cfg, roberta, root,
                                               ckpt)
        detection = detection_epoch_from_the_checkpoint(
            args, cfg, roberta, root, ckpt, os.path.join(tmp, "det_log"))

    stats = [json.loads(line.split("epoch stats ", 1)[1])
             for line in text.splitlines() if "epoch stats " in line]
    check([s["phase"] for s in stats] == ["train", "eval", "eval"],
          f"epochs run: {[s['phase'] for s in stats]}")
    train, evals = stats[0], stats[1:]
    steps = train["batches"]
    check(steps >= 1 and train["scenes"] == steps * 24,
          f"{steps} training steps for {train['scenes']} scenes")
    losses = []
    for line in text.splitlines():
        if "Train: [1][" not in line:
            continue
        fields = line.split("] ", 2)[-1].split()
        values = dict(zip(fields[::2], map(float, fields[1::2])))
        check(all(math.isfinite(v) for v in values.values()),
              f"non-finite training metrics: {line}")
        losses.append(values["loss"])
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

    log(f"  train_torch.py ran {seconds:.1f} s: {steps} steps at B = 24 "
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
                + grounding["launches"][k]
                + sum(e["launches"][k] for e in evals)
                for k in train["launches"]}
    return dict(seconds=seconds, prepare_seconds=prepared, steps=steps,
                losses=losses, train=train, evaluations=evals,
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
                launches=launches)


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
    stats = [json.loads(line.split("epoch stats ", 1)[1])
             for line in text.splitlines() if "epoch stats " in line]
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


def study_with_resume(args, root, card):
    """scripts/accuracy_study_torch.py with the nt32 study's flags, cut to
    24 train and 8 val scenes and 2 epochs, evaluated each epoch: epoch 1
    in one process, epoch 2 in a second that resumes its checkpoint.
    Fails unless both exit 0, the history has rows at epochs 1 and 2 with
    the step count continuing across the resume, every accuracy lies in
    [0, 1], every logged loss is finite, and every step and evaluation
    batch launched the worked-out counts."""
    import tempfile

    from butd_detr_tpu_torch.lang import small_text_roberta_config

    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "study")
        os.makedirs(out_dir)
        os.symlink(root, os.path.join(out_dir, "data"))
        cmd = [sys.executable, os.path.join("scripts",
                                            "accuracy_study_torch.py"),
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
    stats = [json.loads(line.split("epoch stats ", 1)[1])
             for line in text.splitlines() if "epoch stats " in line]
    check([x["phase"] for x in stats] == ["train", "eval", "eval"] * 2,
          f"epochs run: {[x['phase'] for x in stats]}")
    cfg, roberta = study_configs()[1][1], small_text_roberta_config()
    per_step = training_step_launches(cfg, roberta)
    per_batch = evaluation_batch_launches(cfg, roberta)
    for x in stats:
        per = per_step if x["phase"] == "train" else per_batch
        for name, n in per.items():
            check(x["launches"][name] == n * x["batches"],
                  f"study {x['phase']} epoch {x['epoch']}: {name} launched "
                  f"{x['launches'][name]} times in {x['batches']} batches, "
                  f"expected {n} each")
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
    largest error of every end-point group is logged."""
    import numpy as np
    import torch

    from butd_detr_tpu_torch.config import butd_cls_config
    from butd_detr_tpu_torch.ops import _cuda
    from butd_detr_tpu_torch.predict import GroundingPredictor

    cfg32 = butd_cls_config(backbone_bf16=False, attn_precise=True)
    cfg_default = butd_cls_config()
    cloud, boxes, cids = scene
    preds = {}
    for name, cfg, dev in (("cuda", cfg32, "cuda"), ("cpu", cfg32, "cpu"),
                           ("default", cfg_default, "cuda")):
        preds[name] = GroundingPredictor(cfg, roberta_config=roberta,
                                         backbone_npoints=npoints,
                                         device=dev, seed=args.seed)
    weights = preds["cuda"].model.state_dict()
    check(all(torch.equal(v, weights[k]) for k, v in
              preds["default"].model.state_dict().items()),
          "the default-mode model's weights differ from the f32 model's")
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
        pd = preds["default"]
        _cuda.reset_launches()
        default = pd.model(pd.make_inputs(cloud, utterance, boxes, cids))
        default = {k: v.float().cpu() if v.is_floating_point() else v.cpu()
                   for k, v in default.items()}
        expect = dict(FORWARD_LAUNCHES,
                      attention=attention_calls(cfg_default, roberta))
        for name, n in expect.items():
            check(_cuda.LAUNCHES[name] == n,
                  f"default-mode request: {_cuda.LAUNCHES[name]} {name} "
                  f"launches, expected {n}")
        t = time.perf_counter()
        pp = preds["cpu"]
        encoded, detected = pp.model.encode(
            pp.make_inputs(cloud, utterance, boxes, cids))
        logits_p = encoded["seeds_obj_cls_logits"]
        inds_c, n_diff, gap, logit_err = _near_tie_selection(card, logits_p)
        check(n_diff == 0 or gap <= 2 * logit_err,
              f"kps selection: {n_diff} ranks differ by up to {gap} in "
              f"logit, more than twice the logits' error {logit_err}")
        inds_d, d_diff, d_gap, d_logit_err = _near_tie_selection(
            default, logits_p)
        check(d_logit_err <= default_mode_bound(logits_p.numpy()),
              f"default mode: seeds_obj_cls_logits err {d_logit_err} > "
              f"{default_mode_bound(logits_p.numpy())}")
        check(d_diff == 0 or d_gap <= 2 * d_logit_err,
              f"default mode, kps selection: {d_diff} ranks differ by up to "
              f"{d_gap} in logit, more than twice the logits' error "
              f"{d_logit_err}")
        cpu = pp.model.decode({k: v.clone() for k, v in encoded.items()},
                              detected, inds_c.to(torch.int32))
        cpu_d = pp.model.decode(encoded, detected, inds_d.to(torch.int32))
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

    # the default mode against the f32 CPU run, on its own selection
    groups = {}
    for key, want in cpu_d.items():
        want = want.numpy()
        got = default[key].numpy()
        if want.dtype.kind in "iub":
            if key.startswith(("sa", "fp2", "seed_inds")):
                check(np.array_equal(got, want),
                      f"default mode vs CPU: {key} differs")
            continue
        check(np.isfinite(got).all(), f"default mode: {key} not finite")
        err = float(np.abs(got.astype(np.float64) - want).max())
        lim = default_mode_bound(want)
        name = _group(key)
        check(err <= lim, f"default mode vs CPU: {key} err {err} > {lim}")
        if err / lim > groups.get(name, {}).get("ratio", -1.0):
            groups[name] = dict(key=key, err=err, lim=lim, ratio=err / lim,
                                max_abs=float(np.abs(want).max()))
    log(f"  default mode: kps selection {d_diff} of {inds_d.numel()} ranks "
        f"differ (largest CPU-logit gap {d_gap:.3g}; logits' error "
        f"{d_logit_err:.3g}); largest error by group: " + "; ".join(
            f"{name} {g['key']} {g['err']:.3g} (bound {g['lim']:.3g}, "
            f"max|CPU| {g['max_abs']:.3g})" for name, g in groups.items()))
    return dict(kps_ranks_differing=n_diff, kps_gap=gap,
                logit_err=logit_err, equal_ints=ints,
                worst=[dict(key=k, err=e, lim=lm)
                       for _, k, e, lm in worst[:5]],
                default_mode=dict(kps_ranks_differing=d_diff, kps_gap=d_gap,
                                  logit_err=d_logit_err, groups=groups))


# ------------------------------------------------------------- main

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
        "and on the card in the default mode")
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

    # 8. train and evaluate from a data root through the CLI
    card = card_name_and_limit()
    log("== phase 8: prepare_data_torch.py, train_torch.py, predict_torch.py "
        "and the detection evaluation on a "
        f"ScanNet-format root ({CLI_SCENES['points_per_scan']} points a "
        "scan), B=24, 4 loader workers")
    report["cli"] = train_and_evaluate_from_a_data_root(args, cfg, roberta,
                                                        card)
    cli_launches = report["cli"]["launches"]

    # 9, 10. the accuracy study: the overfit probe, a study resumed
    import tempfile

    from butd_detr_tpu_torch.data import make_rich_scannet

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data")
        make_rich_scannet(root, **STUDY_SCENES)
        log("== phase 9: overfit_probe_torch.py, the jax_b12_nt32 "
            "invocation (220 steps at B = 12, 5,000 points, small text "
            "tower from text_init.npz)")
        report["probe"] = overfit_probe(args, root, card)
        log("== phase 10: accuracy_study_torch.py, the nt32 study cut to "
            f"{STUDY_SCENES['n_train']} + {STUDY_SCENES['n_val']} scenes "
            "and 2 epochs, the second resumed in a new process")
        report["study"] = study_with_resume(args, root, card)
    probe_launches = report["probe"]["launches"]
    study_launches = report["study"]["launches"]

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
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"butd_detr_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": (launches[name] + train_launches[name]
                         + eval_launches[name] + cli_launches[name]
                         + probe_launches[name] + study_launches[name]),
            "launches_serving": launches[name],
            "launches_training": train_launches[name],
            "launches_evaluation": eval_launches[name],
            "launches_cli": cli_launches[name],
            "launches_probe": probe_launches[name],
            "launches_study": study_launches[name],
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
                      "library_ms_study", "bound_ms_study"):
            if extra in row:
                kernels[-1][extra] = row[extra]
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
