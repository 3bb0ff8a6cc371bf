"""Port: the COCO mAP copy against the JAX package's `MeanAveragePrecision`,
and the native COCO matcher copy against the original.

Random detections and ground truth from seeded numpy over a few classes
and all three area buckets; both metrics see the same updates. The dicts
must be equal (the same float64 arithmetic on the same inputs; atol 1e-12
only to allow for the fallback path's order, which both take together).
"""

import numpy as np
import pytest

from owlvit_tpu import native as jnative
from owlvit_tpu.ops.map_metric import MeanAveragePrecision as JaxMAP
from owlvit_tpu_torch import native
from owlvit_tpu_torch.ops.map_metric import IOU_THRS, MeanAveragePrecision


def _boxes(rng, n, size):
    xy = rng.uniform(0, size * 0.8, (n, 2))
    wh = rng.uniform(4, size * 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], 1)


def _images(seed, n_images, n_classes, size=300):
    rng = np.random.default_rng(seed)
    for _ in range(n_images):
        g = int(rng.integers(0, 6))
        gt = _boxes(rng, g, size)
        gt_labels = rng.integers(0, n_classes, g)
        d = int(rng.integers(0, 12))
        det = _boxes(rng, d, size)
        if g and d:  # some detections near a ground-truth box
            near = rng.integers(0, g, min(d, g))
            det[:len(near)] = gt[near] + rng.normal(0, 3, (len(near), 4))
        yield det, rng.uniform(0, 1, d), rng.integers(0, n_classes, d), gt, gt_labels


@pytest.mark.parametrize("seed,n_images,n_classes", [(0, 20, 3), (1, 40, 5), (2, 3, 2)])
def test_map_dicts_equal(seed, n_images, n_classes):
    got, want = MeanAveragePrecision(n_classes), JaxMAP(n_classes)
    for args in _images(seed, n_images, n_classes):
        got.update(*args)
        want.update(*args)
    a, b = got.compute(), want.compute()
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), atol=1e-12, rtol=0,
                                   err_msg=k)


def test_map_empty_and_perfect():
    m = MeanAveragePrecision(2)
    gt = np.array([[10.0, 10.0, 60.0, 60.0], [100.0, 100.0, 200.0, 220.0]])
    m.update(gt, np.array([0.9, 0.8]), np.array([0, 1]), gt, np.array([0, 1]))
    out = m.compute()
    assert out["map"] == pytest.approx(1.0) and out["map_per_class"].shape == (2,)
    empty = MeanAveragePrecision(2)
    empty.update(np.zeros((0, 4)), np.zeros(0), np.zeros(0, int), gt, np.array([0, 1]))
    assert empty.compute()["map"] == 0.0


def test_native_coco_match_equal():
    rng = np.random.default_rng(3)
    iou = rng.uniform(0, 1, (9, 7))
    ignore = rng.uniform(size=7) < 0.3
    ignore = ignore[np.argsort(ignore, kind="stable")]
    got, want = native.coco_match(iou, ignore, IOU_THRS), jnative.coco_match(iou, ignore, IOU_THRS)
    if got is None or want is None:
        pytest.skip("the native library does not build here (g++)")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    py = MeanAveragePrecision._py_match(iou, ignore)
    for a, b in zip(got, py):
        np.testing.assert_array_equal(a, b)
