"""The benchmark's one generator of grounding batches, driven by a traffic
file (`benchmark/traffic/<name>.json`) and the configuration's widths.

Each scene is a room: points on the floor, on the walls and on the faces of
its objects' boxes, with colours, stored in Hilbert order as the port's
data pipeline stores scans (a cloud of uniform cubes would flatter the ball
query's hashed grid). Every size that sets the work (objects a scene,
tokens a row, targets a row, which rows carry a detection prompt) comes
from one fixed, stratified set per traffic file: a seed shuffles which row
gets which size and draws the geometry, so every seed asks the same work in
another order. Everything is drawn by a `torch.Generator` on the given
device, in bulk; the batches are handed over as host tensors, as the port's
loader hands them.

The keys and dtypes are those of the port's `JointGroundingDataset`
samples, batched: the model's inputs, the loss's targets and what the
grounding evaluators read.
"""

import math
from typing import Dict, List

import torch

MEAN_RGB = (109.8 / 256, 97.2 / 256, 83.8 / 256)
HILBERT_BITS = 10
BOS, PAD, EOS = 0, 1, 2
MIN_TOKEN = 4


def stratified(spec: Dict, n: int) -> torch.Tensor:
    """n values at the mid-quantiles of the distribution `spec`
    ({"dist": "uniform" | "loguniform", "min", "max"}), rounded to integers:
    the same multiset for every seed."""
    u = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    lo, hi = float(spec["min"]), float(spec["max"])
    if spec["dist"] == "uniform":
        v = lo + u * (hi - lo)
    elif spec["dist"] == "loguniform":
        v = torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    else:
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    return v.round().long()


def hilbert_code(q: torch.Tensor, bits: int = HILBERT_BITS) -> torch.Tensor:
    """(R, N, 3) integer cells in [0, 2^bits) -> (R, N) 3*bits-bit Hilbert
    index (Skilling's AxesToTranspose and interleave, as the port's
    `data/scan.py:hilbert_code`)."""
    x = [q[..., 0].clone(), q[..., 1].clone(), q[..., 2].clone()]
    Q = 1 << (bits - 1)
    while Q > 1:
        P = Q - 1
        for i in range(3):
            flag = (x[i] & Q) > 0
            t = (x[0] ^ x[i]) & P
            x0 = torch.where(flag, x[0] ^ P, x[0] ^ t)
            if i != 0:
                x[i] = torch.where(flag, x[i], x[i] ^ t)
            x[0] = x0
        Q >>= 1
    x[1] = x[1] ^ x[0]
    x[2] = x[2] ^ x[1]
    t = torch.zeros_like(x[0])
    Q = 1 << (bits - 1)
    while Q > 1:
        t = torch.where((x[2] & Q) > 0, t ^ (Q - 1), t)
        Q >>= 1
    x = [xi ^ t for xi in x]
    code = torch.zeros_like(x[0])
    for j in range(bits - 1, -1, -1):
        for i in range(3):
            code = (code << 1) | ((x[i] >> j) & 1)
    return code


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def _rows_of(g, n_rows, values, device):
    """`values` (a fixed multiset) in an order drawn from `g`."""
    perm = torch.randperm(n_rows, generator=g, device=device)
    return values.to(device)[perm]


def make_pool(mix: Dict, widths: Dict, batch: int, n_batches: int,
              seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """`n_batches` batches of `batch` rows, as dicts of host tensors.

    mix: the traffic file. widths: the configuration's `data` group
    (num_points, max_num_obj, max_det_boxes, max_text_len, num_obj_class,
    num_class_bins, box_stream)."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    R = batch * n_batches
    N = widths["num_points"]
    G = widths["max_num_obj"]
    D = widths["max_det_boxes"]
    L = widths["max_text_len"]
    C = widths["num_class_bins"]
    f32 = dict(device=device, dtype=torch.float32)
    ar = torch.arange(R, device=device)

    # ---- the work of each row: a fixed multiset, shuffled by the seed
    n_obj = _rows_of(g, R, stratified(mix["objects"], R).clamp(2, G),
                     device)
    n_det_rows = round(mix["detection_prompt_share"] * R)
    is_det = _rows_of(g, R, torch.arange(R) < n_det_rows, device)
    tok_utt = _rows_of(g, R, stratified(mix["utterance_tokens"], R), device)
    tok_det = _rows_of(g, R, stratified(mix["prompt_tokens"], R), device)
    n_tok = torch.where(is_det, tok_det, tok_utt).clamp(8, L)
    anchors = _rows_of(g, R, stratified(mix["utterance_anchors"], R),
                       device)
    prompt_targets = _rows_of(g, R, stratified(mix["prompt_targets"], R),
                              device)
    n_tgt = torch.minimum(torch.where(is_det, prompt_targets, 1 + anchors),
                          n_obj)

    # ---- rooms and objects
    room = mix["room"]
    W = _uniform(g, (R, 1), *room["width_m"], device)
    Dp = _uniform(g, (R, 1), *room["depth_m"], device)
    H = _uniform(g, (R, 1), *room["height_m"], device)
    obj = mix["object_size_m"]
    size = torch.stack([_uniform(g, (R, G), *obj["xy"], device),
                        _uniform(g, (R, G), *obj["xy"], device),
                        _uniform(g, (R, G), *obj["z"], device)], -1)
    size = torch.minimum(size, torch.stack(
        [W.expand(R, G) * 0.5, Dp.expand(R, G) * 0.5, H.expand(R, G) * 0.8],
        -1))
    cx = size[..., 0] / 2 + torch.rand((R, G), generator=g, device=device) \
        * (W - size[..., 0])
    cy = size[..., 1] / 2 + torch.rand((R, G), generator=g, device=device) \
        * (Dp - size[..., 1])
    center = torch.stack([cx, cy, size[..., 2] / 2], -1)
    real = torch.arange(G, device=device)[None] < n_obj[:, None]
    cls = torch.randint(0, widths["num_obj_class"], (R, G), generator=g,
                        device=device)

    # ---- points: floor, walls, object faces (shares from the mix)
    share = mix["point_shares"]
    n_floor = int(N * share["floor"])
    n_wall = int(N * share["walls"])
    n_objp = N - n_floor - n_wall
    floor = torch.stack([torch.rand((R, n_floor), generator=g, device=device)
                         * W, torch.rand((R, n_floor), generator=g,
                                         device=device) * Dp,
                         torch.zeros((R, n_floor), **f32)], -1)
    s = torch.rand((R, n_wall), generator=g, device=device) * 2 * (W + Dp)
    along_x = s < W
    along_y = (s >= W) & (s < W + Dp)
    opp_x = (s >= W + Dp) & (s < 2 * W + Dp)
    wx = torch.where(along_x, s, torch.where(along_y, W, torch.where(
        opp_x, s - W - Dp, torch.zeros_like(s))))
    wy = torch.where(along_x, torch.zeros_like(s), torch.where(
        along_y, s - W, torch.where(opp_x, Dp, s - 2 * W - Dp)))
    wz = torch.rand((R, n_wall), generator=g, device=device) * H
    walls = torch.stack([wx, wy, wz], -1)
    # object points: an object by its surface area, then a face by its own
    fa = torch.stack([size[..., 0] * size[..., 1],
                      size[..., 1] * size[..., 2],
                      size[..., 1] * size[..., 2],
                      size[..., 0] * size[..., 2],
                      size[..., 0] * size[..., 2]], -1)  # top, -x, +x, -y, +y
    area = fa.sum(-1) * real
    which = torch.multinomial(area, n_objp, replacement=True, generator=g)
    fsel = torch.gather(fa, 1, which[..., None].expand(-1, -1, 5))
    u = torch.rand((R, n_objp), generator=g, device=device) \
        * fsel.sum(-1)
    face = (u[..., None] > fsel.cumsum(-1)).sum(-1).clamp(max=4)
    c = torch.gather(center, 1, which[..., None].expand(-1, -1, 3))
    sz = torch.gather(size, 1, which[..., None].expand(-1, -1, 3))
    a, b = (torch.rand((R, n_objp), generator=g, device=device) - 0.5,
            torch.rand((R, n_objp), generator=g, device=device) - 0.5)
    px = torch.where(face == 1, -0.5, torch.where(face == 2, 0.5, a))
    py = torch.where(face >= 3, torch.where(face == 3, -0.5, 0.5),
                     torch.where(face == 0, b, a))
    pz = torch.where(face == 0, 0.5, b)
    objp = c + torch.stack([px, py, pz], -1) * sz
    xyz = torch.cat([floor, walls, objp], 1)
    xyz = xyz + mix["point_noise_m"] * torch.randn(
        xyz.shape, generator=g, device=device)
    owner = torch.cat([torch.full((R, n_floor + n_wall), -1, device=device,
                                  dtype=torch.long), which], 1)

    # colours: one base colour per surface (floor, walls, each object)
    base = torch.rand((R, G + 2, 3), generator=g, device=device)
    surf = torch.cat([torch.zeros((R, n_floor), dtype=torch.long,
                                  device=device),
                      torch.ones((R, n_wall), dtype=torch.long,
                                 device=device), which + 2], 1)
    rgb = torch.gather(base, 1, surf[..., None].expand(-1, -1, 3))
    rgb = (rgb + mix["colour_noise"] * torch.randn(
        rgb.shape, generator=g, device=device)).clamp(0, 1)
    rgb = rgb - torch.tensor(MEAN_RGB, **f32)

    # Hilbert order, per scene
    lo = xyz.amin(1, keepdim=True)
    hi = xyz.amax(1, keepdim=True)
    cells = ((xyz - lo) / (hi - lo + 1e-6) * (1 << HILBERT_BITS)).long() \
        .clamp(0, (1 << HILBERT_BITS) - 1)
    order = torch.sort(hilbert_code(cells), dim=1, stable=True).indices
    xyz = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3))
    rgb = torch.gather(rgb, 1, order[..., None].expand(-1, -1, 3))
    owner = torch.gather(owner, 1, order)

    # ---- targets: objects 0 .. n_tgt - 1 of each scene
    slot = torch.arange(G, device=device)[None]
    is_tgt = slot < n_tgt[:, None]
    point_instance_label = torch.where(
        (owner >= 0) & (owner < n_tgt[:, None]), owner,
        torch.full_like(owner, -1))
    boxes = torch.cat([center, size], -1)
    gt_boxes = torch.where(is_tgt[..., None], boxes, torch.zeros_like(boxes))

    # ---- text: BOS, tokens, EOS, pads; each target a span of 1-3 tokens
    pos = torch.arange(L, device=device)[None]
    words = torch.randint(MIN_TOKEN, mix["vocab_size"], (R, L), generator=g,
                          device=device)
    ids = torch.where(pos < n_tok[:, None] - 1, words,
                      torch.full_like(words, PAD))
    ids[:, 0] = BOS
    ids[ar, n_tok - 1] = EOS
    text_mask = (ids != PAD).long()
    span_len = torch.randint(1, 4, (R, G), generator=g, device=device)
    last_start = (n_tok[:, None] - 2 - span_len).clamp(min=1)
    start = 1 + (torch.rand((R, G), generator=g, device=device)
                 * last_start).long()
    bins = torch.arange(C, device=device)[None, None]
    inside = (bins >= start[..., None]) & \
        (bins < (start + span_len)[..., None])
    positive_map = torch.where(inside & is_tgt[..., None],
                               1.0 / span_len[..., None].float(),
                               torch.zeros((), **f32))

    # ---- the scene's boxes (in an order of their own) and the box stream
    perm = torch.argsort(torch.rand((R, G), generator=g, device=device)
                         + (~real).float(), dim=1)
    all_bboxes = torch.gather(torch.where(real[..., None], boxes,
                                          torch.zeros_like(boxes)), 1,
                              perm[..., None].expand(-1, -1, 6))
    all_mask = torch.gather(real, 1, perm)
    all_cls = torch.gather(torch.where(real, cls, torch.zeros_like(cls)), 1,
                           perm)
    if widths["box_stream"] == "gt":
        det_boxes, det_mask, det_cls = all_bboxes[:, :D], all_mask[:, :D], \
            all_cls[:, :D]
    elif widths["box_stream"] == "detected":
        det = mix["detector"]
        noisy = torch.cat([
            center + det["center_noise"] * size * torch.randn(
                (R, G, 3), generator=g, device=device),
            size * _uniform(g, (R, G, 3), *det["size_scale"], device)], -1)
        fp = torch.cat([
            torch.stack([torch.rand((R, G), generator=g, device=device) * W,
                         torch.rand((R, G), generator=g, device=device) * Dp,
                         torch.rand((R, G), generator=g, device=device)
                         * H * 0.5], -1),
            _uniform(g, (R, G, 3), *obj["xy"], device)], -1)
        wrong = torch.rand((R, G), generator=g, device=device) \
            >= det["class_accuracy"]
        rnd_cls = torch.randint(0, widths["num_obj_class"], (R, G),
                                generator=g, device=device)
        det_all = torch.where(real[..., None], noisy, fp)
        cls_all = torch.where(real & ~wrong, cls, rnd_cls)
        dperm = torch.argsort(torch.rand((R, G), generator=g,
                                         device=device), dim=1)[:, :D]
        det_boxes = torch.gather(det_all, 1, dperm[..., None].expand(-1, -1,
                                                                     6))
        det_cls = torch.gather(cls_all, 1, dperm)
        det_mask = torch.ones((R, D), dtype=torch.bool, device=device)
    else:
        raise ValueError(f"unknown box_stream {widths['box_stream']!r}")

    flags = mix["evaluator_flags"]
    rows = {
        "point_clouds": torch.cat([xyz, rgb], -1).float(),
        "text_ids": ids,
        "text_mask": text_mask,
        "det_boxes": det_boxes.float(),
        "det_class_ids": det_cls.long(),
        "det_bbox_label_mask": det_mask,
        "center_label": gt_boxes[..., :3].float(),
        "size_gts": gt_boxes[..., 3:].float(),
        "sem_cls_label": torch.where(is_tgt, cls, torch.zeros_like(cls)),
        "box_label_mask": is_tgt.float(),
        "positive_map": positive_map,
        "point_instance_label": point_instance_label,
        "all_bboxes": all_bboxes.float(),
        "all_bbox_label_mask": all_mask,
        "is_view_dep": torch.rand(R, generator=g, device=device)
        < flags["view_dependent"],
        "is_hard": torch.rand(R, generator=g, device=device) < flags["hard"],
        "is_unique": torch.rand(R, generator=g, device=device)
        < flags["unique"],
    }
    rows = {k: v.cpu() for k, v in rows.items()}
    return [{k: v[i * batch:(i + 1) * batch].contiguous()
             for k, v in rows.items()} for i in range(n_batches)]
