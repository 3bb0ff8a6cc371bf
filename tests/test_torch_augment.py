"""Port: ops/augment.py against the JAX package's owlvit_tpu/ops/augment.py,
and the trainer's host-sampled flips against the JAX trainer's.

The deterministic cores (`mirror_boxes`, `apply_hflip`, `apply_color`,
`apply_scale_window`) take the same inputs and the same sampled parameters
on both sides, fp32 on the CPU (the conftest pins JAX's matmul precision to
highest). Tolerances: flips and masks exact; pixel values (in [0, 255])
atol 2e-4, the fp32 rounding of sums over 3 channels, H x W pixels or one
axis of linear weights taken in another order; boxes atol 1e-6. The
samplers draw from a torch.Generator where JAX draws from its keys, so they
are held by their ranges and their determinism per seed, not bit for bit.
`_sample_flips` is numpy Philox on both sides: bit-equal.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlvit_tpu.ops import augment as jaug
from owlvit_tpu.train import Trainer as JaxTrainer
from owlvit_tpu.utils import config as jconfig
from owlvit_tpu_torch.ops import augment as aug
from owlvit_tpu_torch.train import Trainer
from owlvit_tpu_torch.utils import config as tconfig

ATOL_PIXELS, ATOL_BOXES = 2e-4, 1e-6


def _images(seed, b=2, s=32):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (b, s, s, 3), dtype=np.uint8).astype(np.float32)


def _boxes():
    # [B=2, G=3, 4] normalized xyxy (slot 2 padded), as tests/test_augment.py
    b = np.zeros((2, 3, 4), np.float32)
    b[0, 0] = [0.10, 0.20, 0.50, 0.60]
    b[0, 1] = [0.60, 0.10, 0.90, 0.40]
    b[1, 0] = [0.25, 0.25, 0.75, 0.75]
    m = np.zeros((2, 3), bool)
    m[0, :2] = True
    m[1, 0] = True
    return b, m


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_apply_hflip_and_mirror_boxes_equal_jax(dtype):
    imgs = _images(0, b=3).astype(dtype)
    boxes = np.random.default_rng(1).uniform(0, 1, (3, 4, 4)).astype(np.float32)
    flip = np.array([True, False, True])
    ji, jb = jaug.apply_hflip(jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(flip))
    ti, tb = aug.apply_hflip(_t(imgs), _t(boxes), _t(flip))
    assert ti.dtype == _t(imgs).dtype
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(
        aug.mirror_boxes(_t(boxes), _t(flip)).numpy(),
        np.asarray(jaug.mirror_boxes(jnp.asarray(boxes), jnp.asarray(flip))))
    # an involution
    back = aug.mirror_boxes(tb, _t(flip))
    np.testing.assert_allclose(back.numpy(), boxes, atol=ATOL_BOXES)


@pytest.mark.parametrize("factors", [
    "random", (1.0, 1.0, 1.0), (1.0, 0.5, 0.0), (1.3, 1.4, 0.6)])
def test_apply_color_equal_jax(factors):
    imgs = _images(2, b=3)
    if factors == "random":
        rng = np.random.default_rng(3)
        factors = tuple(rng.uniform(0.6, 1.4, 3).astype(np.float32) for _ in range(3))
    want = np.asarray(jaug.apply_color(jnp.asarray(imgs), *factors))
    got = aug.apply_color(_t(imgs), *factors).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_PIXELS, rtol=0)
    assert got.min() >= 0.0 and got.max() <= 255.0


# (x0, y0, s) per image, as tests/test_augment.py:61-118 drives them
WINDOWS = {
    "identity": ([0.0, 0.0], [0.0, 0.0], [1.0, 1.0]),
    "zoom_in_top_left": ([0.0, 0.0], [0.0, 0.0], [0.5, 0.5]),
    "crop_right_half_drops_left_box": ([0.5, 0.5], [0.0, 0.0], [0.5, 0.5]),
    "zoom_out": ([-0.2, -0.3], [-0.1, -0.25], [1.3, 1.6]),
    "mixed": ([0.1, -0.2], [0.3, -0.1], [0.7, 1.4]),
}


@pytest.mark.parametrize("window", WINDOWS)
def test_apply_scale_window_equal_jax(window):
    imgs = _images(4)
    boxes, mask = _boxes()
    x0, y0, s = (np.asarray(v, np.float32) for v in WINDOWS[window])
    want = jaug.apply_scale_window(jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(mask),
                                   jnp.asarray(x0), jnp.asarray(y0), jnp.asarray(s))
    got = aug.apply_scale_window(_t(imgs), _t(boxes), _t(mask), x0, y0, s)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=ATOL_PIXELS, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=ATOL_BOXES, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if window == "identity":
        np.testing.assert_allclose(got[0].numpy(), imgs, atol=1e-3)
    if window == "crop_right_half_drops_left_box":
        assert not got[2][0, 0] and got[2][0, 1]  # the left box leaves the crop
    if window == "zoom_out":
        np.testing.assert_array_equal(got[2].numpy(), mask)  # every box stays


def test_zoom_in_moves_a_marker():
    """Crop the top-left quarter (s = 0.5): a marker at input (8, 8) of a
    32 x 32 image lands near output (16, 16); boxes map (b - o) / s."""
    imgs = np.zeros((1, 32, 32, 3), np.float32)
    imgs[0, 8, 8] = 255.0
    boxes = np.asarray([[[0.125, 0.125, 0.375, 0.375]]], np.float32)
    out, ob, om = aug.apply_scale_window(_t(imgs), _t(boxes), torch.ones(1, 1, dtype=torch.bool),
                                         [0.0], [0.0], [0.5])
    y, x = np.unravel_index(out[0, :, :, 0].argmax().item(), (32, 32))
    assert abs(y - 16) <= 1 and abs(x - 16) <= 1
    np.testing.assert_allclose(ob[0, 0].numpy(), [0.25, 0.25, 0.75, 0.75], atol=ATOL_BOXES)
    assert om[0, 0]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_color_jitter_range_and_determinism():
    imgs = _t(_images(5))
    assert aug.color_jitter(_gen(0), imgs, 0.0) is imgs
    a = aug.color_jitter(_gen(0), imgs, 0.5)
    assert a.shape == imgs.shape and a.min() >= 0 and a.max() <= 255
    assert not torch.allclose(a, imgs)
    torch.testing.assert_close(a, aug.color_jitter(_gen(0), imgs, 0.5), rtol=0, atol=0)
    assert not torch.equal(a, aug.color_jitter(_gen(1), imgs, 0.5))
    # the factors it drew, redrawn from the same seed, lie in [1 - s, 1 + s)
    g = _gen(0)
    fb, fc, fs = (aug._uniform(g, 2, 0.5, 1.5, "cpu") for _ in range(3))
    assert all(((f >= 0.5) & (f < 1.5)).all() for f in (fb, fc, fs))
    torch.testing.assert_close(a, aug.apply_color(imgs, fb, fc, fs), rtol=0, atol=0)


def test_scale_jitter_range_and_determinism():
    imgs = _t(_images(6))
    boxes, mask = (_t(x) for x in _boxes())
    same = aug.scale_jitter(_gen(0), imgs, boxes, mask, 1.0, 1.0)
    assert same[0] is imgs and same[1] is boxes and same[2] is mask
    out = aug.scale_jitter(_gen(7), imgs, boxes, mask, 1.3, 1.6)
    np.testing.assert_array_equal(out[2].numpy(), mask.numpy())  # zoom out keeps every box
    kept = out[1][mask]
    assert (kept >= 0).all() and (kept <= 1).all()
    again = aug.scale_jitter(_gen(7), imgs, boxes, mask, 1.3, 1.6)
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    # the sampled windows: s in range, origin inside [min(0, 1 - s), max(0, 1 - s)]
    g = _gen(8)
    s = aug._uniform(g, 64, 0.7, 1.3, "cpu")
    assert ((s >= 0.7) & (s < 1.3)).all()
    u = aug._uniform(g, 64, 0, 1, "cpu")
    x0 = torch.clamp(1 - s, max=0) + (1 - s).abs() * u
    assert ((x0 >= torch.clamp(1 - s, max=0) - 1e-7)
            & (x0 <= torch.clamp(1 - s, min=0) + 1e-7)).all()


def test_augment_batch_all_off_identity():
    imgs = _images(9)
    boxes, mask = (_t(x) for x in _boxes())
    out, ob, om = aug.augment_batch(_gen(0), _t(imgs.astype(np.uint8)), boxes, mask,
                                    hflip_prob=0.0, color_strength=0.0)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), imgs)
    assert torch.equal(ob, boxes) and torch.equal(om, mask)


def test_augment_batch_is_deterministic_per_seed():
    imgs = _t(_images(10, s=64).astype(np.uint8))
    boxes, mask = (_t(x) for x in _boxes())

    def run(seed):
        return aug.augment_batch(_gen(seed), imgs, boxes, mask, hflip_prob=0.5,
                                 color_strength=0.3, scale_min=0.7, scale_max=1.3)

    a, b, c = run(5), run(5), run(6)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.allclose(a[0], c[0])


def test_hflip_draws_both_outcomes():
    imgs = _t(_images(11, b=64, s=8))
    boxes = torch.zeros(64, 1, 4)
    out, _ = aug.hflip(_gen(0), imgs, boxes, prob=0.5)
    flipped = torch.tensor([torch.equal(o, i.flip(1)) and not torch.equal(o, i)
                           for o, i in zip(out, imgs)])
    assert flipped.any() and not flipped.all()
    assert torch.equal(aug.hflip(_gen(0), imgs, boxes, prob=0.0)[0], imgs)
    assert torch.equal(aug.hflip(_gen(0), imgs, boxes, prob=1.0)[0], imgs.flip(2))


@pytest.mark.parametrize("seed,step,n", [(0, 0, 64), (0, 1, 64), (3, 17, 32), (42, 1000, 5)])
def test_sample_flips_equal_jax(seed, step, n):
    """The port keys the Philox stream by (seed, micro-steps done), the JAX
    trainer by (seed, batches done): the same count in a run."""
    jcfg = jconfig.Config(jconfig.DataConfig(), jconfig.TrainingConfig(seed=seed),
                          jconfig.ModelConfig())
    want = JaxTrainer._sample_flips(types.SimpleNamespace(cfg=jcfg, _batches_done=step), n)
    tcfg = tconfig.Config(tconfig.DataConfig(), tconfig.TrainingConfig(seed=seed),
                          tconfig.ModelConfig())
    got = Trainer._sample_flips(types.SimpleNamespace(cfg=tcfg, step=step), n)
    np.testing.assert_array_equal(got, want)
    if n >= 32:
        assert got.any() and not got.all()
    other = Trainer._sample_flips(types.SimpleNamespace(cfg=tcfg, step=step + 1), n)
    assert (other != got).any()
