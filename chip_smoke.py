#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: build, check, serve.

    python3 chip_smoke.py [--seed 0] [--requests 3] [--report PATH]

Run from the root of a checkout, on a machine with one NVIDIA H100 (sm_90a)
and the CUDA toolkit. Phases, in order; any failure exits non-zero before
the last line is printed:

1. build: compile butd_detr_tpu_torch/csrc/*.cu with nvcc (in parallel)
   and print the seconds and ptxas's register/shared-memory report;
2. kernels vs plain versions on the card, at the serving path's shapes:
   FPS and ball query bit-equal at the 4 SA tiers (plus an all-zero cloud
   and centers with no neighbour), attention within its stated bound in
   both modes at every (Lq, Lk, Dh) the forward uses, with key padding and
   a fully masked row; each timed against its plain version (and, for
   attention, against torch's scaled_dot_product_attention as a
   yardstick the port never calls);
3. serving: GroundingPredictor at the full width of the SR3D butd_cls
   model (50k points, RoBERTa-base shape, 3 encoder + 6 decoder layers)
   with seeded random weights answers `--requests` synthetic requests; the
   launch counters must show 4 FPS, 4 ball-query and 51 attention
   launches per request;
4. card vs CPU: one request again in f32 with the precise attention mode,
   on the card and with the plain versions on the CPU (same weights):
   integer end points equal (the kps order up to f32 near-ties, see
   compare_card_cpu), floats within 1e-3 + 5e-3 * std.

Prints the `kernels` JSON line, the card's name and power limit, and last
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


def bound_ms(nbytes, ops_by_rate):
    """Least time: the larger of bytes over HBM rate and the operations
    over their type's peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / rate for n, rate in ops_by_rate)
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by


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
        fps_row["tiers"].append(dict(n=N, npoint=npoint, ms=ms, plain_ms=pms,
                                     bound_ms=b_ms, bound_by=by))
        fps_row["ms"] += ms
        fps_row["plain_ms"] += pms
        fps_row["bound_ms"] += b_ms

        m = new_xyz.shape[1]
        got = ball_query(r, ns, xyz, new_xyz)
        want = ball_query_plain(r, ns, xyz, new_xyz)
        check(torch.equal(got, want), f"ball query kernel != plain at N={N}")
        ms = time_ms(lambda: ball_query(r, ns, xyz, new_xyz), 10)
        pms = time_ms(lambda: ball_query_plain(r, ns, xyz, new_xyz), 2)
        scanned = scanned_candidates(xyz, new_xyz, r, ns)
        # per candidate: 3 sub, 3 mul, 2 add, 1 compare
        b_ms, by = bound_ms(N * 12 + m * 12 + m * ns * 4,
                            [(9 * scanned, F32_OPS_PER_S)])
        bq_row["tiers"].append(dict(n=N, m=m, radius=r, nsample=ns, ms=ms,
                                    plain_ms=pms, bound_ms=b_ms, bound_by=by,
                                    scanned=scanned))
        bq_row["ms"] += ms
        bq_row["plain_ms"] += pms
        bq_row["bound_ms"] += b_ms
        f, q = fps_row["tiers"][-1], bq_row["tiers"][-1]
        log(f"  N={N:6d} -> {npoint:5d}: fps {f['ms']:.3f} ms (plain "
            f"{f['plain_ms']:.1f}, bound {f['bound_ms']:.4f}), ball query "
            f"r={r} ns={ns} {q['ms']:.3f} ms (plain {q['plain_ms']:.2f}, "
            f"bound {q['bound_ms']:.4f}, {q['scanned']} candidates): equal")

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
    return fps_row, bq_row


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


def check_attention(shapes, gen):
    import torch
    import torch.nn.functional as F

    from butd_detr_tpu_torch.ops import attention, attention_plain

    # f32 mode: reassociation only. bf16 mode: P is rounded to bf16 after
    # an f32 sum whose order differs, so one entry may move a bf16 step
    # (2^-8 relative): bounded by 4e-3 at |V| ~ 1.
    tol = {True: (2e-5, 1e-4), False: (4e-3, 4e-3)}
    row = dict(name="attention", ms=0.0, plain_ms=0.0, bound_ms=0.0,
               library_ms=0.0, max_abs_err=0.0, shapes=[])
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
        row["shapes"].append(dict(name=name, H=H, Lq=Lq, Lk=Lk, Dh=Dh,
                                  per_request=per_req, ms=ms, plain_ms=pms,
                                  library_ms=lms, bound_ms=b_ms,
                                  bound_by=by))
        row["ms"] += per_req * ms
        row["plain_ms"] += per_req * pms
        row["library_ms"] += per_req * lms
        row["bound_ms"] += per_req * b_ms
        log(f"  {name:20s} H={H:2d} Lq={Lq:4d} Lk={Lk:4d} Dh={Dh}: "
            f"{ms:.3f} ms (plain {pms:.3f}, sdpa {lms:.3f}, bound "
            f"{b_ms:.4f} by {by}) x{per_req}")
    row["max_abs_err"] = worst[False]
    row["max_abs_err_precise"] = worst[True]
    row["bound_by"] = "operations" if all(
        s["bound_by"] == "operations" for s in row["shapes"]) else "bytes"
    return row


# ------------------------------------------------------------- phase 4

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
    compared on the same queries."""
    import numpy as np
    import torch

    from butd_detr_tpu_torch.config import butd_cls_config
    from butd_detr_tpu_torch.models import top_k_stable
    from butd_detr_tpu_torch.predict import GroundingPredictor

    cfg32 = butd_cls_config(backbone_bf16=False, attn_precise=True)
    cloud, boxes, cids = scene
    preds = {}
    for dev in ("cuda", "cpu"):
        preds[dev] = GroundingPredictor(cfg32, roberta_config=roberta,
                                        backbone_npoints=npoints,
                                        device=dev, seed=args.seed)
    with torch.inference_mode():
        t = time.perf_counter()
        pc = preds["cuda"]
        card = pc.model(pc.make_inputs(cloud, utterance, boxes, cids))
        card = {k: v.cpu() for k, v in card.items()}
        log(f"  card forward {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        pp = preds["cpu"]
        cpu, detected = pp.model.encode(
            pp.make_inputs(cloud, utterance, boxes, cids))
        logits_c = card["seeds_obj_cls_logits"]
        logits_p = cpu["seeds_obj_cls_logits"]
        inds_c = card["query_points_sample_inds"].long()
        inds_p = top_k_stable(logits_p, cfg32.num_target)
        n_diff = int((inds_c != inds_p).sum())
        logit_err = float((logits_c - logits_p).abs().max())
        gap = float((logits_p.gather(1, inds_c)
                     - logits_p.gather(1, inds_p)).abs().max())
        check(n_diff == 0 or gap <= 2 * logit_err,
              f"kps selection: {n_diff} ranks differ by up to {gap} in "
              f"logit, more than twice the logits' error {logit_err}")
        cpu = pp.model.decode(cpu, detected, inds_c.to(torch.int32))
        log(f"  cpu forward {time.perf_counter() - t:.1f} s")
    del preds
    log(f"  kps selection: {n_diff} of {inds_c.numel()} ranks differ "
        f"(largest CPU-logit gap at a differing rank {gap:.3g}; logits' "
        f"card-vs-CPU error {logit_err:.3g})")
    worst, ints = [], []
    for k, want in cpu.items():
        want = want.numpy()
        got = card[k].numpy()
        if want.dtype.kind in "iub":
            if k != "query_points_sample_inds":
                check(np.array_equal(got, want), f"card vs CPU: {k} differs")
                ints.append(k)
            continue
        check(np.isfinite(got).all(), f"card: {k} not finite")
        err = float(np.abs(got.astype(np.float64) - want).max())
        lim = 1e-3 + 5e-3 * float(np.std(want))
        worst.append((err / lim, k, err, lim))
        check(err <= lim, f"card vs CPU: {k} err {err} > {lim}")
    worst.sort(reverse=True)
    log(f"  equal: {', '.join(ints)}; {len(worst)} float end points "
        f"within bound, worst {worst[0][1]} {worst[0][2]:.3g} <= "
        f"{worst[0][3]:.3g}")
    return dict(kps_ranks_differing=n_diff, kps_gap=gap,
                logit_err=logit_err, equal_ints=ints,
                worst=[dict(key=k, err=e, lim=lm)
                       for _, k, e, lm in worst[:5]])


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
        for line in _cuda.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                log(f"  [{name}] {line.strip()}")

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
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    att_row = check_attention(attention_shapes(cfg, roberta, npoints), gen)
    torch.cuda.synchronize()

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
    per_req_att = (roberta.num_hidden_layers + 5 * cfg.num_encoder_layers
                   + 4 * cfg.num_decoder_layers)
    expect = {"fps": 4, "ball_query": 4, "attention": per_req_att}
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

    # 4. card vs CPU, f32 + precise, same weights
    log("== phase 4: one request on the card and on the CPU (f32, precise)")
    report["card_vs_cpu"] = compare_card_cpu(args, roberta, npoints,
                                             scenes[0], REQUESTS[0][0])

    kernels = []
    replaces = {
        "fps": "butd_detr_tpu/ops/pallas_fps.py:142",
        "ball_query": "butd_detr_tpu/ops/pallas_ball_query.py:178",
        "attention": "butd_detr_tpu/ops/pallas_attention.py:213",
    }
    for row in (fps_row, bq_row, att_row):
        name = row["name"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"butd_detr_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"),
        })
    report["kernels"] = kernels
    report["detail"] = {"fps": fps_row, "ball_query": bq_row,
                        "attention": att_row}
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--report", default=None,
                    help="also write the full JSON report to this path")
    args = ap.parse_args(argv)
    if args.requests < 1:
        ap.error("--requests must be >= 1")

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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else ""
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
