"""The port's batched linear sum assignment (`ops/assignment.py`) and its
Hungarian matching (`losses/matcher.py`) against the JAX package's
on-device solver (`butd_detr_tpu/losses/matcher.py`), on the CPU.

Costs are made from a seed with numpy and handed to both. The plain
solver repeats the JAX one step for step, so the assignments are held
equal exactly, ties included (integer costs, duplicated columns, every
entry tied). scipy, the reference's host solver, breaks ties otherwise:
it is held only on the optimum cost, within 1e-5 relative. The kernel
(csrc/assignment.cu) is held bit-equal to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 2).
"""

import ast
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from butd_detr_tpu.losses.matcher import (
    batched_linear_sum_assignment as j_batched_linear_sum_assignment,
)
from butd_detr_tpu.losses.matcher import _lsa_single as j_lsa_single
from butd_detr_tpu.losses.matcher import hungarian_match as j_hungarian_match
from butd_detr_tpu.losses.matcher import (
    matcher_cost_matrix as j_matcher_cost_matrix,
)
from butd_detr_tpu_torch.losses import matcher
from butd_detr_tpu_torch.losses.matcher import (
    hungarian_match,
    matcher_cost_matrix,
    scipy_match_oracle,
)
from butd_detr_tpu_torch.ops.assignment import (
    assignment_plan,
    batched_linear_sum_assignment,
    batched_linear_sum_assignment_plain,
)
from tests.test_torch_train_modules import _seeded_end_points
from torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(q, g) for q in (32, 256) for g in (7, 32, 132)]
KINDS = ("uniform", "integer_ties", "duplicated_columns", "all_tied")


def _costs(kind, M, G, Q, rng):
    if kind == "uniform":
        return rng.rand(M, G, Q).astype(np.float32)
    if kind == "integer_ties":
        return rng.randint(0, 4, (M, G, Q)).astype(np.float32)
    if kind == "duplicated_columns":  # column 2k + 1 repeats column 2k
        cost = rng.rand(M, G, Q).astype(np.float32)
        cost[:, :, 1::2] = cost[:, :, 0::2]
        return cost
    return np.full((M, G, Q), 0.5, np.float32)


@functools.lru_cache(maxsize=None)
def _solved(Q, G, kind):
    """Costs, counts (min(G, Q), 0, 1 and two drawn), the JAX solver's
    and the port's assignments."""
    rng = np.random.RandomState(1000 * Q + 10 * G + KINDS.index(kind))
    cost = _costs(kind, 5, G, Q, rng)
    full = min(G, Q)
    n_valid = np.array([full, 0, 1, *rng.randint(2, full + 1, 2)], np.int32)
    want = np.asarray(j_batched_linear_sum_assignment(
        jnp.asarray(cost), jnp.asarray(n_valid)))
    got = batched_linear_sum_assignment(torch.from_numpy(cost),
                                        torch.from_numpy(n_valid))
    return cost, n_valid, want, got


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("Q,G", SHAPES)
def test_plain_solver_equals_the_jitted_jax_solver(Q, G, kind):
    _, _, want, got = _solved(Q, G, kind)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("Q,G", SHAPES)
def test_plain_solver_finds_scipys_optimum(Q, G, kind):
    """Each matrix's valid rows go to distinct columns at scipy's optimum
    cost (1e-5 relative); the rows past n_valid give column 0."""
    cost, n_valid, _, got = _solved(Q, G, kind)
    got = got.numpy()
    for m, n in enumerate(n_valid):
        assert (got[m, n:] == 0).all()
        if n == 0:
            continue
        cols = got[m, :n]
        assert len(set(cols.tolist())) == n
        rows, best_cols = linear_sum_assignment(cost[m, :n])
        best = cost[m, rows, best_cols].astype(np.float64).sum()
        ours = cost[m, np.arange(n), cols].astype(np.float64).sum()
        assert ours == pytest.approx(best, rel=1e-5)


@pytest.mark.parametrize("past", [0, 1])
@pytest.mark.parametrize("kind", ["uniform", "integer_ties"])
def test_plain_solver_equals_jax_at_the_kernels_staged_rows(kind, past):
    """n_valid = R and R + 1 at the loss's (132, 256): R rows are the most
    the kernel stages in shared memory (`assignment_plan`), and a row past
    them is read from device memory. The card holds the kernel bit-equal
    to the plain version at these counts (chip_smoke.py phase 2), so the
    plain version is held here against the jitted JAX `_lsa_single`."""
    G, Q = 132, 256
    n = assignment_plan(G, Q)["rows_staged"] + past
    rng = np.random.RandomState(20 + 2 * past + (kind == "uniform"))
    cost = _costs(kind, 2, G, Q, rng)
    lsa = jax.jit(j_lsa_single)
    want = np.stack([np.asarray(lsa(jnp.asarray(c), jnp.int32(n)))
                     for c in cost])
    got = batched_linear_sum_assignment_plain(
        torch.from_numpy(cost).transpose(1, 2).contiguous().transpose(1, 2),
        torch.full((2,), n))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, n:] == 0).all()


def test_plain_solver_reads_a_transposed_view_as_its_copy():
    """The matcher hands the solver its (B, Q, G) costs transposed, as a
    view: the same assignment as from the contiguous copy."""
    rng = np.random.RandomState(5)
    cost_bqg = torch.from_numpy(rng.rand(4, 256, 132).astype(np.float32))
    n_valid = torch.tensor([6, 1, 132, 0])
    view = cost_bqg.transpose(1, 2)
    assert not view.is_contiguous()
    assert torch.equal(batched_linear_sum_assignment(view, n_valid),
                       batched_linear_sum_assignment(view.contiguous(),
                                                     n_valid))


def test_non_finite_costs_are_solved_as_the_jax_matcher_maps_them():
    """NaN and +inf cost 1e6, -inf -1e6 (jnp.nan_to_num in the JAX
    `hungarian_match` before it solves): the JAX solver's assignment of
    the mapped costs, and the solver returns."""
    rng = np.random.RandomState(6)
    cost = rng.rand(4, 16, 32).astype(np.float32)
    cost[0, 2, :] = np.nan
    cost[1, :, 5] = np.inf
    cost[2, 3, 7] = -np.inf
    cost[3] = np.nan
    n_valid = np.array([16, 9, 12, 16], np.int32)
    mapped = np.nan_to_num(cost, nan=1e6, posinf=1e6, neginf=-1e6)
    want = np.asarray(j_batched_linear_sum_assignment(
        jnp.asarray(mapped), jnp.asarray(n_valid)))
    got = batched_linear_sum_assignment(torch.from_numpy(cost),
                                        torch.from_numpy(n_valid))
    np.testing.assert_array_equal(got.numpy(), want)


def test_more_valid_rows_than_columns_solves_the_first_q():
    """n_valid > Q (G = 40 targets, Q = 32 queries). The JAX solver's path
    search runs out of free columns, stops on its guard with no sink and
    augments from column -1 (wrapped to Q - 1): what it returns is no
    optimum of any Q of the rows, and its first Q rows cost more than
    their own optimum (here also with repeated columns in two of the
    three). The port solves the first Q rows (the JAX solver's assignment
    at n_valid = Q) and gives column 0 to the rest."""
    rng = np.random.RandomState(7)
    G, Q = 40, 32
    cost = rng.rand(3, G, Q).astype(np.float32)
    over = np.array([33, 40, 36], np.int32)
    at_q = np.full(3, Q, np.int32)
    jax_over = np.asarray(j_batched_linear_sum_assignment(
        jnp.asarray(cost), jnp.asarray(over)))
    jax_at_q = np.asarray(j_batched_linear_sum_assignment(
        jnp.asarray(cost), jnp.asarray(at_q)))
    first_q = lambda a, m: cost[m, np.arange(Q), a[m, :Q]].sum()
    for m in range(3):
        assert len(set(jax_at_q[m, :Q].tolist())) == Q
        assert first_q(jax_over, m) > first_q(jax_at_q, m) + 0.1
    assert [len(set(jax_over[m, :Q].tolist())) for m in range(3)] \
        == [32, 29, 29]
    got = batched_linear_sum_assignment(torch.from_numpy(cost),
                                        torch.from_numpy(over)).numpy()
    np.testing.assert_array_equal(got[:, :Q], jax_at_q[:, :Q])
    assert (got[:, Q:] == 0).all()


def test_solver_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match=r"\(M, G, Q\)"):
        batched_linear_sum_assignment(torch.zeros(2, 3, 4),
                                      torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(M, G, Q\)"):
        batched_linear_sum_assignment(torch.zeros(3, 4),
                                      torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("soft_token", [True, False])
def test_hungarian_match_equals_the_jax_matcher(soft_token):
    """On `_seeded_end_points` (7 padded targets, 24 queries, 1 to 7 of
    them valid): the same cost matrix within 1e-6, and the same
    assignment for every target, padded ones included (column 0)."""
    ep, _ = _seeded_end_points(3)
    boxes = np.concatenate([ep["last_center"], ep["last_pred_size"]], -1)
    gt = np.concatenate([ep["center_label"], ep["size_gts"]], -1)
    labels = None if soft_token else ep["sem_cls_label"]
    args = (ep["last_sem_cls_scores"], boxes, ep["positive_map"], gt,
            ep["box_label_mask"])
    want = np.asarray(j_hungarian_match(
        *map(jnp.asarray, args),
        tgt_labels=None if labels is None else jnp.asarray(labels)))
    targs = [torch.from_numpy(a) for a in args]
    tlabels = None if labels is None else torch.from_numpy(labels)
    got = hungarian_match(*targs, tgt_labels=tlabels)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(
        matcher_cost_matrix(*targs, tgt_labels=tlabels).numpy(),
        np.asarray(j_matcher_cost_matrix(
            *map(jnp.asarray, args), 1.0, 0.0, 2.0,
            None if labels is None else jnp.asarray(labels))),
        rtol=1e-6, atol=1e-6)


def test_hungarian_match_with_a_nan_logit_equals_the_jax_matcher():
    ep, _ = _seeded_end_points(4)
    logits = ep["last_sem_cls_scores"].copy()
    logits[0, 3] = np.nan
    args = (logits, np.concatenate([ep["last_center"],
                                    ep["last_pred_size"]], -1),
            ep["positive_map"],
            np.concatenate([ep["center_label"], ep["size_gts"]], -1),
            ep["box_label_mask"])
    want = np.asarray(j_hungarian_match(*map(jnp.asarray, args)))
    got = hungarian_match(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(got.numpy(), want)


def test_hungarian_match_reaches_scipys_optimum_on_every_prefix():
    """Every matrix of a 7-prefix batch (`compute_hungarian_loss`'s one
    call): the optimum cost of `scipy_match_oracle`, the reference's host
    path, within 1e-5 relative."""
    ep, layers = _seeded_end_points(8)
    prefixes = ["proposal_"] + [f"{i}head_" for i in range(layers - 1)] \
        + ["last_"]
    P, B = len(prefixes), ep["box_label_mask"].shape[0]
    tile = lambda a: torch.from_numpy(np.concatenate([a] * P))
    logits = torch.from_numpy(np.concatenate(
        [ep[p + "sem_cls_scores"] for p in prefixes]))
    boxes = torch.from_numpy(np.concatenate(
        [np.concatenate([ep[p + "center"], ep[p + "pred_size"]], -1)
         for p in prefixes]))
    gt = np.concatenate([ep["center_label"], ep["size_gts"]], -1)
    args = (logits, boxes, tile(ep["positive_map"]), tile(gt),
            tile(ep["box_label_mask"]))
    got = hungarian_match(*args).numpy()
    cost = matcher_cost_matrix(*args).numpy().astype(np.float64)
    oracle = scipy_match_oracle(cost, args[4])
    assert got.shape == oracle.shape == (P * B, 7)
    for b in range(P * B):
        g = int(args[4][b].sum())
        ours = cost[b, got[b, :g], np.arange(g)].sum()
        best = cost[b, oracle[b, :g], np.arange(g)].sum()
        assert ours == pytest.approx(best, rel=1e-5)
        assert (oracle[b, g:] == -1).all()


def test_matcher_module_has_no_host_path():
    """`losses/matcher.py` imports no scipy at module level, and
    `hungarian_match` neither copies to the host nor reads a value
    back."""
    tree = ast.parse(inspect.getsource(matcher))
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] + [
                getattr(node, "module", None) or ""]
            assert not any(n.startswith("scipy") for n in names), names
    body = inspect.getsource(matcher.hungarian_match)
    for call in (".cpu(", ".item(", ".numpy(", ".tolist(", "int(",
                 "float("):
        assert call not in body, call


def test_plain_solver_is_the_wrappers_cpu_path():
    rng = np.random.RandomState(9)
    cost = torch.from_numpy(rng.rand(3, 8, 12).astype(np.float32))
    n_valid = torch.tensor([8, 3, 0], dtype=torch.int64)
    assert torch.equal(batched_linear_sum_assignment(cost, n_valid),
                       batched_linear_sum_assignment_plain(cost, n_valid))
