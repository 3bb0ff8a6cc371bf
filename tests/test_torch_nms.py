"""Port: box predicate, NMS and detection packing against the JAX package.

The inputs keep clear of IoU == threshold ties, so the suppression decisions,
classes and valid flags are equal and boxes and scores are fp32-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlvit_tpu.ops import boxes as jboxes
from owlvit_tpu.ops import nms as jnms
from owlvit_tpu_torch.ops import boxes, nms


def _boxes(rng, shape, span=1.0, offset=0.0, degenerate=0):
    """Clustered xyxy boxes (so NMS has work); `degenerate` of them with
    negative width."""
    centers = rng.uniform(0.2, 0.8, size=shape + (2,))
    centers += rng.normal(scale=0.05, size=shape + (2,))
    wh = rng.uniform(0.05, 0.3, size=shape + (2,))
    b = np.concatenate([centers - wh / 2, centers + wh / 2], axis=-1) * span + offset
    if degenerate:
        b[..., :degenerate, [0, 2]] = b[..., :degenerate, [2, 0]]
    return b.astype(np.float32)


def _no_ties(b, t):
    """IoU of every pair at least 1e-4 away from the threshold."""
    iou, _ = jboxes.pairwise_iou(jnp.asarray(b), jnp.asarray(b))
    return bool(np.all(np.abs(np.asarray(iou) - t) > 1e-4))


@pytest.mark.parametrize("threshold", [0.3, 0.6, 0.85])
def test_pairwise_iou_above_matches_jax(threshold):
    rng = np.random.default_rng(0)
    b1 = _boxes(rng, (3, 40), degenerate=3)
    b2 = _boxes(rng, (3, 30))
    ours = boxes.pairwise_iou_above(torch.from_numpy(b1), torch.from_numpy(b2),
                                    threshold).numpy()
    theirs = np.asarray(jboxes.pairwise_iou_above(jnp.asarray(b1),
                                                  jnp.asarray(b2), threshold))
    assert ours.shape == (3, 40, 30) and ours.dtype == np.bool_
    np.testing.assert_array_equal(ours, theirs)
    assert not ours[:, :3].any()  # negative-area boxes never suppress


def test_box_conversion_matches_jax():
    b = np.random.default_rng(1).uniform(0, 1, size=(2, 9, 4)).astype(np.float32)
    np.testing.assert_array_equal(boxes.cxcywh_to_xyxy(torch.from_numpy(b)).numpy(),
                                  np.asarray(jboxes.cxcywh_to_xyxy(jnp.asarray(b))))
    np.testing.assert_array_equal(boxes.area(torch.from_numpy(b)).numpy(),
                                  np.asarray(jboxes.area(jnp.asarray(b))))


def _batch(seed=2, P=64, C=5):
    """Three images with very different coordinate spans (a batch-wide class
    offset of ~1e7 would collapse the small images' boxes in fp32), and sims
    with some rows below the confidence threshold."""
    rng = np.random.default_rng(seed)
    b = np.stack([_boxes(rng, (P,)), _boxes(rng, (P,), span=1e7, offset=-5e6),
                  _boxes(rng, (P,), span=3.0, offset=2.0)])
    sims = rng.uniform(-0.2, 1.0, size=(3, P, C)).astype(np.float32)
    sims[:, : P // 4] = rng.uniform(-0.5, 0.005, size=(3, P // 4, C))
    return b, sims


@pytest.mark.parametrize("top_k", [5, 20, 64])
@pytest.mark.parametrize("iou_threshold", [0.3, 0.6])
def test_postprocess_pack_matches_jax(top_k, iou_threshold):
    b, sims = _batch()
    assert all(_no_ties(b[i], iou_threshold) for i in range(3))
    kw = dict(confidence_threshold=0.01, iou_threshold=iou_threshold, top_k=top_k)
    ours = nms.postprocess(torch.from_numpy(b), torch.from_numpy(sims), **kw)
    theirs = jnms.postprocess(jnp.asarray(b), jnp.asarray(sims), **kw)
    np.testing.assert_array_equal(ours["valid"].numpy(), np.asarray(theirs["valid"]))
    np.testing.assert_array_equal(ours["classes"].numpy(), np.asarray(theirs["classes"]))
    np.testing.assert_array_equal(ours["boxes"].numpy(), np.asarray(theirs["boxes"]))
    np.testing.assert_array_equal(ours["scores"].numpy(), np.asarray(theirs["scores"]))
    packed = nms.pack_detections(ours)
    assert packed.shape == (3, top_k, 7) and packed.dtype == torch.float32
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jnms.pack_detections(theirs)))
    # some suppression and some confidence filtering really happened
    n_valid = ours["valid"].sum(dim=1)
    assert (n_valid > 0).all() and (n_valid < 64).all()


def test_images_are_independent_in_a_batch():
    """Each image of a batch decodes exactly as it does alone: the class
    offset span is taken per image, not over the batch."""
    b, sims = _batch(seed=3)
    kw = dict(confidence_threshold=0.01, iou_threshold=0.6, top_k=32)
    together = nms.pack_detections(
        nms.postprocess(torch.from_numpy(b), torch.from_numpy(sims), **kw))
    for i in range(3):
        alone = nms.pack_detections(nms.postprocess(
            torch.from_numpy(b[i:i + 1]), torch.from_numpy(sims[i:i + 1]), **kw))
        assert torch.equal(together[i], alone[0]), i


def test_nms_order_and_dead_slots():
    """Survivors come out score-descending; slots past the survivors are
    invalid with index -1; equal scores go to the lower index."""
    bx = torch.tensor([[[0, 0, 1, 1], [0, 0, 1, 1], [2, 2, 3, 3], [5, 5, 6, 6]]],
                      dtype=torch.float32)
    sc = torch.tensor([[0.5, 0.9, 0.9, float("-inf")]])
    idx, valid = nms.nms(bx, sc, 0.5, 4)
    assert idx.tolist() == [[1, 2, -1, -1]]
    assert valid.tolist() == [[True, True, False, False]]
    j_idx, j_valid = jnms.nms(jnp.asarray(bx[0].numpy()), jnp.asarray(sc[0].numpy()), 0.5, 4)
    assert np.asarray(j_idx).tolist() == idx[0].tolist()
    assert np.asarray(j_valid).tolist() == valid[0].tolist()
