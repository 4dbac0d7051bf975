"""The program's stage spans and read-back counter (`utils/spans.py`).

Off, a step records nothing and opens no profiler range; on, the train
step, the eval step and the evaluators open their stage spans in order
with their parents, self time is inclusive time less the children's (on a
fake clock), and no number of the step moves. Each read-back site counts
one `readbacks` with its bytes; the epoch-stats line carries them and the
`--profile_dir` window records the spans. On the card (`cuda`), the train
step, the eval step and the evaluator's device work make no
synchronising call outside the counted read-back sites.
"""

import json

import numpy as np
import pytest
import torch

from butd_detr_tpu_torch.config import Config
from butd_detr_tpu_torch.data import synthetic_batch
from butd_detr_tpu_torch.eval.grounding import GroundingGTEvaluator, _to_host
from butd_detr_tpu_torch.lang.roberta import RobertaConfig
from butd_detr_tpu_torch.models.bdetr import prediction_prefixes
from butd_detr_tpu_torch.train.harness import EpochMeter, TrainTester
from butd_detr_tpu_torch.train.step import Trainer, metrics_to_host
from butd_detr_tpu_torch.utils import spans
from torch_threads import one_torch_thread  # noqa: F401

ROBERTA = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=96,
               max_position_embeddings=40)
NPOINTS = (64, 32, 16, 8)
CFG = dict(use_color=True, butd_cls=True, self_attend=True,
           use_contrastive_align=True, use_soft_token_loss=True,
           num_target=16, num_encoder_layers=2, num_decoder_layers=2,
           max_text_len=12, num_points=256, max_num_obj=8, max_det_boxes=8,
           backbone_bf16=True, attn_precise=False)
BATCH = dict(batch_size=4, num_points=256, max_text_len=12, max_num_obj=8,
             max_det_boxes=8, n_true_objects=3, n_true_tokens=6,
             n_true_det=4, vocab_size=128)
PREFIXES = prediction_prefixes(CFG["num_decoder_layers"])
FORWARD = [("forward", "{root}"), ("backbone", "forward"),
           ("text", "forward"), ("encoder", "forward"),
           ("decoder", "forward")]
# the loss matches every prefix in one call
LOSS = [("loss", "{root}"), ("match", "loss")]


def _trainer(device="cpu", seed=0):
    return Trainer(Config(**CFG), steps_per_epoch=1,
                   roberta_config=RobertaConfig(**ROBERTA),
                   backbone_npoints=NPOINTS, device=device, seed=seed)


def _batch(seed=0):
    return synthetic_batch(**BATCH, seed=seed)


def _evaluator():
    return GroundingGTEvaluator(prefixes=PREFIXES[-1:] + PREFIXES[:-1],
                                with_contrast=True, logger=_Quiet())


def _evaluated(end_points, batch, device="cpu"):
    """The end points with what the evaluator reads of the batch: the
    scene's boxes (here the targets') and the breakdown's flags, as
    tensors on `device`."""
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    B = batch["center_label"].shape[0]
    flags = torch.arange(B, device=device) % 2 == 0
    return dict(batch, **end_points, all_bboxes=torch.cat(
        [batch["center_label"][..., :3], batch["size_gts"]], -1),
        all_bbox_label_mask=batch["box_label_mask"], is_view_dep=flags,
        is_hard=~flags, is_unique=flags)


class _Quiet:
    def info(self, *_):
        pass


@pytest.fixture
def spans_on():
    spans.reset()
    was = spans.enable(True)
    yield
    spans.enable(was)
    spans.reset()


def _opened(records):
    """(name, parent) in the order the spans opened."""
    return [(r.name, r.parent)
            for r in sorted(records, key=lambda r: r.start_ns)]


def _expect(items, root):
    return [(n, p.format(root=root)) for n, p in items]


def test_spans_off_read_no_clock_and_open_no_profiler_range(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a span was opened with the spans off")

    assert not spans.enabled()
    spans.reset()
    monkeypatch.setattr(spans, "clock", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    trainer = _trainer()
    batch = _batch()
    trainer.train_step(batch)
    ep = trainer.eval_step(batch)
    _evaluator().evaluate(_evaluated(ep, batch))
    assert spans.totals() == {} and spans.records() == []


def test_train_step_opens_its_stages_in_order(spans_on):
    trainer = _trainer()
    trainer.train_step_on_device(_batch())
    records = spans.records()
    want = [("train_step", None), ("to_device", "train_step"),
            ("begin_step", "train_step")] + _expect(
        FORWARD + LOSS, "train_step") + [("backward", "train_step"),
                                         ("optimizer", "train_step")]
    assert _opened(records) == want
    # the spans of one step carry the trainer's step before it
    assert {r.step for r in records} == {0}
    trainer.train_step_on_device(_batch(1))
    assert {r.step for r in spans.records()} == {0, 1}


def test_eval_step_and_evaluator_open_their_stages_in_order(spans_on):
    trainer = _trainer()
    batch = _batch()
    ep = trainer.eval_step(batch, with_loss=True)
    want = [("eval_step", None), ("to_device", "eval_step")] + _expect(
        FORWARD + LOSS, "eval_step")
    assert _opened(spans.records()) == want
    spans.reset()
    plain = trainer.eval_step(batch, with_loss=False)
    assert _opened(spans.records()) == [
        ("eval_step", None), ("to_device", "eval_step")] + _expect(
        FORWARD, "eval_step")
    spans.reset()
    _evaluator().evaluate(_evaluated(plain, batch))
    records = spans.records()
    # the hits in one copy, then the breakdown's three flags
    assert _opened(records) == [("evaluate", None), ("hits", "evaluate"),
                                ("readback", "evaluate")] + [
        ("readback", "evaluate")] * 3
    # one root: one step for all its spans
    assert len({r.step for r in records}) == 1
    assert ep["loss"].shape == ()


def test_self_time_is_inclusive_less_the_childrens_on_a_fake_clock(
        spans_on, monkeypatch):
    ticks = iter(range(0, 10 ** 6, 10))
    monkeypatch.setattr(spans, "clock", lambda: next(ticks))
    with spans.span("a", step=7):          # 0 .. 70
        with spans.span("b"):              # 10 .. 20
            pass
        with spans.span("c"):              # 30 .. 60
            with spans.span("b"):          # 40 .. 50
                pass
    t = spans.totals()
    assert t["a"] == {"calls": 1, "ns": 70, "self_ns": 70 - 10 - 30}
    assert t["b"] == {"calls": 2, "ns": 20, "self_ns": 20}
    assert t["c"] == {"calls": 1, "ns": 30, "self_ns": 20}
    assert {r.step for r in spans.records()} == {7}
    assert [(r.name, r.parent) for r in spans.records()] == [
        ("b", "a"), ("b", "c"), ("c", "a"), ("a", None)]

    # a real step: every span's self time is its inclusive time less that
    # of the spans opened directly inside it (no name repeats across
    # levels in a step)
    spans.reset()
    _trainer().train_step_on_device(_batch())
    records = spans.records()
    for name, total in spans.totals().items():
        children = sum(r.ns for r in records if r.parent == name)
        assert total["self_ns"] == total["ns"] - children, name
        assert total["calls"] == sum(r.name == name for r in records)


def _state(trainer):
    out = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    out.update({f"{n}.grad": p.grad.clone()
                for n, p in trainer.model.named_parameters()
                if p.grad is not None})
    out.update({f"buffer.{n}": b.clone()
                for n, b in trainer.model.named_buffers()})
    return out


def test_spans_move_no_number():
    """Losses, gradients, updated weights and buffers bit-equal with the
    spans on and off (two trainers of one seed, two steps each)."""
    runs = []
    for on in (False, True):
        was = spans.enable(on)
        try:
            trainer = _trainer(seed=3)
            metrics = [trainer.train_step(_batch(i)) for i in range(2)]
            ep = trainer.eval_step(_batch(2))
        finally:
            spans.enable(was)
            spans.reset()
        runs.append((metrics, _state(trainer), ep))
    (m0, s0, e0), (m1, s1, e1) = runs
    assert m0 == m1
    assert s0.keys() == s1.keys()
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    for k in e0:
        if isinstance(e0[k], torch.Tensor):
            assert torch.equal(e0[k], e1[k]), k


def test_each_read_back_site_counts_one_with_its_bytes():
    def readbacks():
        return spans.counts()["readbacks"]

    before = readbacks()
    named = {k: torch.tensor(float(i)) for i, k in enumerate("abcde")}
    assert metrics_to_host(named) == {k: float(i)
                                      for i, k in enumerate("abcde")}
    after = readbacks()
    assert after == {"calls": before["calls"] + 1,
                     "bytes": before["bytes"] + 5 * 4}
    out = {"x": torch.ones(4, 3), "y": torch.zeros(7, dtype=torch.bool)}
    host = _to_host(out)
    assert set(host) == {"x", "y"} and host["y"].dtype == np.float32
    assert readbacks() == {"calls": after["calls"] + 1,
                           "bytes": after["bytes"] + (12 + 7) * 4}


def test_epoch_stats_carry_the_read_backs():
    batches = [{"loss": torch.tensor(1.0), "grad_norm": torch.tensor(2.0)}
               for _ in range(3)]
    meter = EpochMeter(batches, torch.device("cpu"))
    for b in meter:
        metrics_to_host(b)
    stats = meter.stats(scenes=3)
    assert stats["readbacks"] == {"calls": 3, "bytes": 3 * 2 * 4}
    assert "launches" in stats


def test_profile_window_records_the_spans(tmp_path):
    """`--profile_dir`: the spans are on while the profiler records, as
    host annotations of its trace, and off after."""
    cfg = Config(log_dir=str(tmp_path / "log"),
                 profile_dir=str(tmp_path / "prof"))
    tester = TrainTester(cfg, device="cpu")
    assert not spans.enabled()
    profiler = tester._start_profiler()
    assert spans.enabled()
    with spans.span("train_step", step=0):
        with spans.span("forward"):
            torch.ones(3).sum()
    path = tester._stop_profiler(profiler)
    assert not spans.enabled()
    spans.reset()
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {"train_step", "forward"} <= names


@pytest.mark.cuda
def test_steps_make_no_sync_outside_the_read_back_sites():
    """Under `set_sync_debug_mode("error")` the train step, the eval step
    with the loss and the evaluator's device work run to their end; the
    read-back sites do synchronise (the mode is live), and each counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from butd_detr_tpu_torch.eval.grounding import (
        _on_device,
        gt_grounding_batch_hits,
    )

    trainer = _trainer(device="cuda")
    batch = {k: torch.as_tensor(v).cuda() for k, v in _batch().items()}
    trainer.train_step(batch)  # builds and warms up outside the mode
    _evaluator().evaluate(_evaluated(trainer.eval_step(batch), batch,
                                     "cuda"))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = trainer.train_step_on_device(batch)
        ep = trainer.eval_step(batch)
        on_device = _on_device(_evaluated(ep, batch, "cuda"), PREFIXES)
        hits = gt_grounding_batch_hits(on_device, tuple(PREFIXES))
        before = spans.counts()["readbacks"]["calls"]
        with pytest.raises(RuntimeError):
            metrics_to_host(metrics)
        assert spans.counts()["readbacks"]["calls"] == before + 1
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(list(metrics_to_host(metrics).values())).all()
    assert _to_host(hits)["mask"].shape == (BATCH["batch_size"],)


def test_spans_open_a_profiler_range_only_while_one_records(
        spans_on, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    def refuse(*_a, **_k):
        raise AssertionError("a profiler range with no profiler running")

    record_function = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with spans.span("forward"):
        pass
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("loss"):
            with spans.span("match"):
                torch.ones(2).sum()
    names = [e.name for e in prof.events()]
    assert "loss" in names and "match" in names and "forward" not in names
    assert spans.totals()["forward"]["calls"] == 1
