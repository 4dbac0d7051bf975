"""The yardstick's arithmetic: the traffic generator, the FLOP count and the
roofline bounds against counts worked by hand at small shapes."""

import pytest
import torch

from benchmark.harness import cell as cells
from benchmark.harness import flops, roofline, spec
from benchmark.tests.tiny import held_back_cell, tiny_cell
from benchmark.traffic.generator import hilbert_code, make_pool, stratified


def _pool(seed, cell="cls_train_b24"):
    c = tiny_cell(cell, batch=3)
    return make_pool(c["traffic"], c["config"]["data"], 3, 2, seed, "cpu")


def test_generator_is_deterministic_by_seed():
    a, b = _pool(2 ** 31 + 5), _pool(2 ** 31 + 5)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k
    c = _pool(2 ** 31 + 6)
    assert not torch.equal(a[0]["point_clouds"], c[0]["point_clouds"])


def test_every_seed_asks_the_same_work():
    """The sizes that set the work form one multiset for every seed."""
    def sizes(pool):
        objs = sorted(int(n) for b in pool
                      for n in b["all_bbox_label_mask"].sum(1))
        toks = sorted(int(n) for b in pool for n in b["text_mask"].sum(1))
        tgts = sorted(int(n) for b in pool
                      for n in b["box_label_mask"].sum(1))
        return objs, toks, tgts

    assert sizes(_pool(11)) == sizes(_pool(2 ** 32 + 11))


def test_batches_are_valid_samples():
    c = tiny_cell("det_eval_b24", batch=3)
    for b in make_pool(c["traffic"], c["config"]["data"], 3, 2, 9, "cpu"):
        n = b["point_clouds"].shape[1]
        assert b["point_clouds"].shape == (3, n, 6)
        assert b["point_instance_label"].max() < b["box_label_mask"].sum(
            1).max()
        # each target's box is one of the scene's boxes, bit for bit (the
        # GT evaluator snaps to the scene's boxes)
        gt = torch.cat([b["center_label"], b["size_gts"]], -1)
        for r in range(3):
            for g in range(int(b["box_label_mask"][r].sum())):
                assert (b["all_bboxes"][r] == gt[r, g]).all(-1).any()
        # every target's span lies on real tokens, before EOS
        last = b["text_mask"].sum(1) - 1
        for r in range(3):
            used = b["positive_map"][r].sum(0).nonzero().flatten()
            assert used.min() >= 1 and used.max() < last[r]
        assert b["det_bbox_label_mask"].all()


def test_hilbert_code_visits_the_cube_once():
    cells = torch.stack(torch.meshgrid(*[torch.arange(4)] * 3,
                                       indexing="ij"), -1).reshape(1, -1, 3)
    code = hilbert_code(cells, bits=2)
    assert sorted(code.flatten().tolist()) == list(range(64))
    # neighbours along the curve are neighbours in space
    order = cells[0][code[0].argsort()]
    assert ((order[1:] - order[:-1]).abs().sum(-1) == 1).all()


def test_stratified_sizes():
    v = stratified({"dist": "uniform", "min": 0, "max": 10}, 5)
    assert v.tolist() == [1, 3, 5, 7, 9]


def test_flops_by_hand():
    assert flops._mlp(10, [3, 4, 5]) == 2 * 10 * (12 + 20)
    # one cross attention: q, out on 2 rows, k, v on 3 rows, d 4
    assert flops._attn(2, 3, 4) == 2 * 16 * (2 + 3 + 3 + 2) + 4 * 2 * 3 * 4
    c = spec.load_cell("cls_train_b24")["config"]
    f = flops.forward_flops(c)
    # RoBERTa-base at 128 tokens: 12 layers of 4 768^2 projections, the
    # 768-3072-768 FFN and two 128x128x768 products
    per_layer = 2 * 128 * (4 * 768 ** 2 + 2 * 768 * 3072) \
        + 4 * 128 * 128 * 768
    assert f["text"] == 12 * per_layer
    assert flops.scene_flops(c, True) == f["text"] + 3 * f["rest"]
    assert flops.scene_flops(c, False) == f["text"] + f["rest"]


def test_bounds_by_hand():
    nbytes, ops = roofline._ball_query(2, 100, 10, 4)
    assert nbytes == 2 * (100 * 12 + 10 * 12 + 10 * 4 * 4) and ops == []
    nbytes, ops = roofline._attention_fwd(1, 2, 3, 5, 4)
    assert nbytes == 4 * 2 * 4 * (6 + 10) + 5
    assert ops == [(4 * 30 * 4, roofline.BF16_OPS_PER_S),
                   (5 * 30, roofline.F32_OPS_PER_S)]
    s, by = roofline.least_seconds(3.35e12, [(67e12, roofline.F32_OPS_PER_S)])
    assert abs(s - 1.0) < 1e-12
    nbytes, _ = roofline._gather(2, 10, 3, 4)
    assert nbytes == 2 * (2 * 10 * 3 * 4 + 10 * 4)
    nbytes, _ = roofline._group_mlp_input(1, 50, 4, 8, 3, 4)
    assert nbytes == 4 * 8 * 4 + 4 * 12 + 32 * (12 + 12) + 32 * 6 * 2


def test_every_roofline_file_resolves_at_the_cells_shapes():
    fns = spec.rooflines()
    assert {f["kernel"] for f in fns.values()} == {
        "K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8"}
    for cell_name, modes in (("cls_train_b24", ["train"]),
                             ("det_eval_b24", ["eval", "eval_loss"])):
        cell = spec.load_cell(cell_name)
        names = spec.shape_names(cell["config"], 24, 2.5)
        calls = {}
        for name, fn in fns.items():
            for mode in modes:
                s, n = roofline.function_bound(fn, mode, names)
                assert s >= 0
                calls[fn["kernel"]] = calls.get(fn["kernel"], 0) + n
        # a B = 24 step's or batch's launches as the records count them;
        # the loss gathers its matched boxes at P * B rows in one launch
        # and scatters their gradient back in one
        if cell_name == "cls_train_b24":
            assert calls == {"K1": 4, "K2": 4, "K3": 51, "K4": 39, "K5": 7,
                             "K6": 9, "K7": 4, "K8": 1}
        else:
            assert calls == {"K1": 4, "K2": 4, "K3": 51, "K4": 0, "K5": 0,
                             "K6": 9, "K7": 4, "K8": 1}


# {cell: {function: least seconds a step}} at 5.25 valid targets a row, as
# the roofline files gave them before the loss's gather and scatter were
# written as one launch at P * B rows: the same to the last digit
BOUNDS = {
    "cls_train_b24": {
        "assignment": 2.9608119402985074e-07,
        "attention_bwd": 0.0010962588262090156,
        "attention_fwd": 0.0007062847716059943, "ball_query": 9.984e-06,
        "fps": 0.0003764737719402985, "gather": 3.933569910447761e-05,
        "group_mlp_input": 0.00014204836298507462,
        "scatter": 0.000158975656119403},
    "det_eval_b24": {
        "assignment": 2.9608119402985074e-07,
        "attention_fwd": 0.0007062847716059943, "ball_query": 9.984e-06,
        "fps": 0.0003764737719402985, "gather": 3.933569910447761e-05,
        "group_mlp_input": 0.00014204836298507462},
    "cls_eval_b24": {
        "attention_fwd": 0.0007062847716059943, "ball_query": 9.984e-06,
        "fps": 0.0003764737719402985, "gather": 3.899147462686567e-05,
        "group_mlp_input": 0.00014204836298507462},
}
# a rank of the four-GPU cell (its workload file, not listed yet) steps on
# the one-GPU cell's 24 scenes
BOUNDS["cls_train_ddp4"] = BOUNDS["cls_train_b24"]
HELD_BACK = {"cls_train_ddp4": 4}


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_every_cells_bounds_are_unchanged(name):
    cell = held_back_cell(name, HELD_BACK[name]) if name in HELD_BACK \
        else spec.load_cell(name)
    got = cells.step_bounds(cell["config"], cell["entry"]["batch"], 5.25,
                            cell["entry"]["entry"] == "train")
    assert got == BOUNDS[name]
