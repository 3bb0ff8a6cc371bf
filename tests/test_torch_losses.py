"""Port: matching and the PushPull loss against the JAX package (ops/boxes.py,
ops/matcher.py, ops/losses.py), fp32 on the CPU.

The Hungarian solver must give the JAX assignment exactly, ties included,
and so must the host label propagation. Tolerances elsewhere: the cost
matrix, the box functions and the loss terms atol 1e-5 (summation order over
<= 5 classes and 4 coordinates); the loss gradients atol 1e-6 (their
magnitude is below 0.1).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlvit_tpu.ops import boxes as jboxes
from owlvit_tpu.ops import losses as jlosses
from owlvit_tpu.ops import matcher as jmatcher
from owlvit_tpu_torch.ops import boxes, losses, matcher

B, G, P, C = 3, 6, 40, 5


def _boxes(rng, *shape):
    """Valid xyxy boxes in [0, 1] from sigmoid cxcywh, as the box head makes them."""
    c = 1 / (1 + np.exp(-rng.normal(size=(*shape, 4))))
    return np.concatenate([c[..., :2] - c[..., 2:] / 2, c[..., :2] + c[..., 2:] / 2],
                          -1).astype(np.float32)


def _batch(seed):
    rng = np.random.default_rng(seed)
    sims = rng.uniform(-1, 1, size=(B, P, C)).astype(np.float32)
    pred = _boxes(rng, B, P)
    labels = rng.integers(0, C, size=(B, G)).astype(np.int32)
    gt = _boxes(rng, B, G)
    mask = np.zeros((B, G), bool)
    for b, n in enumerate((G, 3, 1)):
        mask[b, :n] = True
    weights = rng.uniform(0.5, 2.0, size=C).astype(np.float32)
    return sims, pred, labels, gt, mask, weights


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def test_box_functions_match_jax():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 2, 7), _boxes(rng, 2, 9)
    ta, tb = _t(a, b)
    iou, union = boxes.pairwise_iou(ta, tb)
    jiou, junion = jboxes.pairwise_iou(jnp.asarray(a), jnp.asarray(b))
    for got, want in ((iou, jiou), (union, junion),
                      (boxes.pairwise_giou(ta, tb), jboxes.pairwise_giou(a, b))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    c = _boxes(rng, 2, 7)
    tc, = _t(c)
    np.testing.assert_allclose(boxes.elementwise_iou(ta, tc).numpy(),
                               np.asarray(jboxes.elementwise_iou(a, c)), atol=1e-6)
    np.testing.assert_allclose(boxes.elementwise_giou(ta, tc).numpy(),
                               np.asarray(jboxes.elementwise_giou(a, c)), atol=1e-6)


def test_cost_matrix_matches_jax():
    sims, pred, labels, gt, mask, _ = _batch(1)
    got = matcher.cost_matrix(*_t(sims, pred, labels, gt, mask)).numpy()
    want = np.asarray(jax.vmap(jmatcher.cost_matrix)(sims, pred, labels, gt, mask))
    assert got.shape == (B, G, P)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _jax_hungarian(cost, mask):
    return np.asarray(jax.vmap(jmatcher.hungarian)(jnp.asarray(cost), jnp.asarray(mask)))


@functools.lru_cache(maxsize=1)
def _smoke():
    """chip_smoke.py as a module: its matcher input families (importing it
    needs no card)."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", ["random", "integer_ties", "masked_rows",
                                  "duplicate_columns", "crowd", "signed_zeros"])
def test_hungarian_equals_jax(case):
    """The numpy solver, and jv_assign on CPU tensors (which runs it),
    against the vmapped JAX solver; "crowd" and "signed_zeros" are the
    smoke's families (chip_smoke.crowd_inputs: every GT row valid and
    competing for the same patches; signed_zero_costs: -0 and +0 must tie)
    at this file's shape."""
    rng = np.random.default_rng(2)
    mask = np.ones((B, G), bool)
    if case == "crowd":
        cost, mask = _smoke().crowd_inputs(rng, B, G, P, C)[:2]
    elif case == "signed_zeros":
        cost, mask = _smoke().signed_zero_costs(rng, B, G, P)
    elif case == "random":
        cost = rng.normal(size=(B, G, P)).astype(np.float32)
    elif case == "integer_ties":  # many equal costs: the tie-breaking must agree
        cost = rng.integers(0, 3, size=(B, G, P)).astype(np.float32)
    elif case == "duplicate_columns":  # every column twice, and masked rows
        cost = np.tile(rng.integers(0, 3, size=(B, G, P // 2)), 2).astype(np.float32)
        mask = rng.random((B, G)) < 0.7
        mask[0] = True
    else:
        cost = rng.normal(size=(B, G, P)).astype(np.float32)
        mask = rng.random((B, G)) < 0.5
        mask[0] = False  # an image with no real row at all
    got = matcher.hungarian(cost, mask)
    want = _jax_hungarian(cost, mask)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[~mask], -1)
    # one image alone, unbatched, gives the same rows
    np.testing.assert_array_equal(matcher.hungarian(cost[1], mask[1]), want[1])
    got_t = matcher.jv_assign(*_t(cost, mask))
    assert got_t.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), want)


def test_assign_drops_a_valid_row_left_unassigned(monkeypatch):
    """A valid row that the solver leaves at -1 (the kernel's safety stop
    on inf or NaN costs) writes the spare column: its label goes nowhere
    and every other row's label lands as before."""
    sims, pred, labels, gt, mask, _ = _batch(3)
    cost = matcher.cost_matrix(*_t(sims, pred, labels, gt, mask))
    solve = matcher.jv_assign
    want_a, want_t = matcher.assign(cost, *_t(labels, mask), C)

    def stopped(c, m):  # row 1 of image 0 (a valid row) left unassigned
        out = solve(c, m).clone()
        out[0, 1] = -1
        return out

    monkeypatch.setattr(matcher, "jv_assign", stopped)
    got_a, got_t = matcher.assign(cost, *_t(labels, mask), C)
    assert mask[0, 1] and got_a[0, 1] == -1
    want_t[0, want_a[0, 1]] = C
    np.testing.assert_array_equal(got_t.numpy(), want_t.numpy())


def test_match_equals_jax():
    sims, pred, labels, gt, mask, _ = _batch(3)
    got_a, got_t = matcher.match(*_t(sims, pred, labels, gt, mask), C)
    want_a, want_t = jax.vmap(lambda *a: jmatcher.match(*a, C))(sims, pred, labels, gt, mask)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


@pytest.mark.parametrize("pad", [-1, 3, 0])
def test_padded_labels_match_jax(pad):
    """Padded GT slots are masked whatever label they carry (-1, C or 0): the
    cost and the match equal the JAX ones. C=3, G=4, labels [0, 2, pad, pad]
    with the last two slots masked."""
    n_cls, g, p = 3, 4, 12
    rng = np.random.default_rng(9)
    sims = rng.uniform(-1, 1, size=(2, p, n_cls)).astype(np.float32)
    pred, gt = _boxes(rng, 2, p), _boxes(rng, 2, g)
    labels = np.array([[0, 2, pad, pad]] * 2, np.int32)
    mask = np.array([[True, True, False, False]] * 2)
    got = matcher.cost_matrix(*_t(sims, pred, labels, gt, mask)).numpy()
    want = np.asarray(jax.vmap(jmatcher.cost_matrix)(sims, pred, labels, gt, mask))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[:, 2:], 0)
    got_a, got_t = matcher.match(*_t(sims, pred, labels, gt, mask), n_cls)
    want_a, want_t = jax.vmap(lambda *a: jmatcher.match(*a, n_cls))(sims, pred, labels, gt,
                                                                     mask)
    np.testing.assert_array_equal(got_a.numpy()[mask], np.asarray(want_a)[mask])
    np.testing.assert_array_equal(got_a.numpy()[~mask], -1)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def _chain_case():
    """Patch 0 (class 2) overlaps 3, 3 overlaps 5 but 0 does not overlap 5:
    the label chains 0 -> 3 -> 5 within one sweep. Patch 7 (class 1)
    overlaps 1, whose turn has passed: 1 takes the label and gives it to
    no one (1 overlaps 2). Patches 8 and 9 sit at IoU 0.85 up to fp32
    rounding, which must fall the same way on both sides."""
    bx = np.array([[0.40, 0.40, 0.60, 0.60]] * 12, np.float32)
    bx[0] = [0.00, 0.00, 0.20, 0.20]
    bx[3] = [0.00, 0.00, 0.20, 0.21]
    bx[5] = [0.00, 0.00, 0.20, 0.24]
    bx[7] = [0.70, 0.70, 0.90, 0.90]
    bx[1] = [0.70, 0.70, 0.90, 0.91]
    bx[2] = [0.70, 0.70, 0.90, 0.94]
    bx[8] = [0.00, 0.50, 1.00, 1.50]
    bx[9] = [0.00, 0.50, 0.85, 1.50]
    bx[10] = [0.30, 0.00, 0.50, 0.10]
    bx[11] = [0.30, 0.00, 0.50, 0.11]
    tc = np.full(12, C, np.int32)
    tc[0], tc[7], tc[8], tc[10] = 2, 1, 4, 3
    return bx, tc


@pytest.mark.parametrize("case", ["random", "chain_and_threshold"])
def test_propagate_labels_equals_jax(case):
    if case == "random":  # near-duplicate boxes, so that labels spread
        rng = np.random.default_rng(4)
        base = _boxes(rng, 12)
        bx = (base[rng.integers(0, 12, 60)]
              + rng.normal(scale=0.01, size=(60, 4))).astype(np.float32)
        tc = np.full(60, C, np.int32)
        fg = rng.choice(60, 8, replace=False)
        tc[fg] = rng.integers(0, C, 8)
    else:
        bx, tc = _chain_case()
    got = losses._propagate_labels(bx, tc, C, 0.85)
    want = np.asarray(jlosses._propagate_labels(jnp.asarray(bx), jnp.asarray(tc), C, 0.85))
    np.testing.assert_array_equal(got, want)
    if case == "random":
        assert (got != tc).any()  # the labels did spread
    else:
        assert got[3] == got[5] == 2 and got[1] == 1 and got[2] == C
        assert got[9] == C and got[11] == 3


def test_push_pull_loss_and_grads_match_jax():
    sims, pred, labels, gt, mask, weights = _batch(5)

    def jax_loss(s, b):
        terms = jlosses.push_pull_loss(s, b, labels, gt, mask, C, jnp.asarray(weights))
        return jlosses.total_loss(terms), terms

    (_, jterms), (jgs, jgb) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(sims), jnp.asarray(pred))
    ts, tb = (torch.from_numpy(x).requires_grad_(True) for x in (sims, pred))
    terms = losses.push_pull_loss(ts, tb, *_t(labels, gt, mask), C,
                                  torch.from_numpy(weights))
    losses.total_loss(terms).backward()
    for k in ("loss_ce", "loss_bg", "loss_bbox", "loss_giou"):
        np.testing.assert_allclose(terms[k].item(), float(jterms[k]), atol=1e-5, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jgs), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jgb), atol=1e-6, rtol=0)
