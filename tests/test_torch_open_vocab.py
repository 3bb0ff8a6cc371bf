"""Port: the open-vocabulary heads and the on-device resize against the JAX
package at `tiny` size, fp32, after the weight bridge from the JAX
`owlvit.init` tree.

The detector forwards run as they are served (every layer frozen, the
fixed-shift softmax, which fp32 resolves to the per-row max): the JAX side
with attention_impl="flash" (the Pallas kernel in interpret mode), the port
with its plain attention on the CPU. Tolerances: logits, embeddings and
boxes atol 2e-5 with rtol 2e-4 (fp32 summation order through two layers and
the heads); the chosen box index of `embed_image_query` exactly equal.

The resize (values in [0, 255]) is held two ways. Against the exact value,
the float64 product of the image with JAX's own fp32 weight matrices
(`compute_weight_mat`): atol 1e-4, a few fp32 ulps at 255 (the port
contracts one axis at a time). Against `jax.image.resize` itself: atol
5e-3, because XLA on the CPU contracts both axes in one einsum whose fp32
sums run over every input pixel, and its own result differs from the exact
one by up to 2.2e-3 ([200, 150] -> 96 without antialias). The normalised
pixels of `preprocess_image`: atol 5e-3 / 255 / min(CLIP_STD).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jax_scale

from owlvit_tpu.models import get_config as jax_get_config
from owlvit_tpu.models import owlvit as jowlvit
from owlvit_tpu.ops import preprocess as jpre
from owlvit_tpu_torch.data.tokenizer import HashTokenizer
from owlvit_tpu_torch.models import get_config, owlvit
from owlvit_tpu_torch.models.convert import from_jax_tree
from owlvit_tpu_torch.ops import preprocess

TOL = dict(atol=2e-5, rtol=2e-4)
SERVED = dict(trainable_last_k=0, static_softmax=True)


@pytest.fixture(scope="module")
def trees():
    params = jowlvit.init(jax.random.PRNGKey(4), jax_get_config("tiny"),
                          num_queries=12)
    tree = jax.tree.map(np.asarray, params)
    model, _ = from_jax_tree(tree, get_config("tiny"))
    return tree, model.eval()


@pytest.fixture(scope="module")
def giou_trees(trees):
    """Both trees with the box head's w/h bias at -1e4: every box collapses
    to a point, no IoU with the whole image is above 0, and
    embed_image_query takes its GIoU fallback."""
    tree, _ = trees
    tree = jax.tree.map(np.array, tree)  # a writable copy
    tree["box_head"]["dense2"]["bias"][2:] = -1e4
    model, _ = from_jax_tree(tree, get_config("tiny"))
    return tree, model.eval()


def _jcfg():
    return jax_get_config("tiny", attention_impl="flash", **SERVED)


def _cfg():
    return get_config("tiny", **SERVED)


def _pixels(seed, n=2, size=96):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("masked", [False, True])
def test_class_predictor(trees, masked):
    tree, model = trees
    cfg = get_config("tiny")
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(2, 9, cfg.vision.hidden_size)).astype(np.float32)
    q = rng.normal(size=(2, 5, cfg.projection_dim)).astype(np.float32)
    mask = np.array([[1, 1, 0, 1, 0], [1, 0, 0, 0, 0]], np.int32) if masked else None
    ref = jowlvit.class_predictor(tree, jax_get_config("tiny"), jnp.asarray(feats),
                                  jnp.asarray(q),
                                  None if mask is None else jnp.asarray(mask))
    with torch.inference_mode():
        got = owlvit.class_predictor(model, cfg, torch.from_numpy(feats),
                                     torch.from_numpy(q),
                                     None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (2, 9, 5)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)
    if masked:  # masked queries carry fp32's lowest value on both sides
        lowest = np.finfo(np.float32).min
        assert (_np(got)[np.broadcast_to(mask[:, None, :] == 0, got.shape)] == lowest).all()


def test_forward_zero_shot(trees):
    tree, model = trees
    cfg = get_config("tiny")
    enc = HashTokenizer(cfg.text.vocab_size, max_len=cfg.text.max_len)(
        ["a red box", "a striped circle", "something else"])
    ids = enc["input_ids"].copy()
    ids[2, 0] = 0  # a query whose first token is 0 is masked
    px = _pixels(2)
    ref_boxes, ref_logits = jowlvit.forward_zero_shot(
        tree, _jcfg(), jnp.asarray(px), jnp.asarray(ids),
        jnp.asarray(enc["attention_mask"]))
    with torch.inference_mode():
        boxes, logits = owlvit.forward_zero_shot(
            model, _cfg(), torch.from_numpy(px), torch.from_numpy(ids),
            torch.from_numpy(enc["attention_mask"]))
    assert boxes.shape == (2, 9, 4) and logits.shape == (2, 9, 3)
    np.testing.assert_allclose(_np(boxes), np.asarray(ref_boxes), **TOL)
    np.testing.assert_allclose(_np(logits), np.asarray(ref_logits), **TOL)
    assert (_np(logits)[..., 2] == np.finfo(np.float32).min).all()


@pytest.mark.parametrize("fallback", [False, True])
def test_embed_image_query(trees, giou_trees, fallback):
    tree, model = giou_trees if fallback else trees
    px = _pixels(3, n=3)
    ref_q, ref_idx, ref_boxes = jowlvit.embed_image_query(tree, _jcfg(), jnp.asarray(px))
    with torch.inference_mode():
        q, idx, boxes = owlvit.embed_image_query(model, _cfg(), torch.from_numpy(px))
    full = np.broadcast_to(np.array([0, 0, 1, 1], np.float32), _np(boxes).shape)
    inter_w = np.minimum(full[..., 2], _np(boxes)[..., 2]) - np.maximum(full[..., 0],
                                                                         _np(boxes)[..., 0])
    overlaps = (np.clip(inter_w, 0, None) > 0).any()
    assert overlaps != fallback  # the fixture does force (or not) the fallback
    np.testing.assert_array_equal(_np(idx), np.asarray(ref_idx))
    np.testing.assert_allclose(_np(q), np.asarray(ref_q), **TOL)
    np.testing.assert_allclose(_np(boxes), np.asarray(ref_boxes), **TOL)


def test_forward_one_shot(trees):
    tree, model = trees
    px, qpx = _pixels(5), _pixels(6)
    ref_boxes, ref_logits = jowlvit.forward_one_shot(tree, _jcfg(), jnp.asarray(px),
                                                     jnp.asarray(qpx))
    with torch.inference_mode():
        boxes, logits = owlvit.forward_one_shot(model, _cfg(), torch.from_numpy(px),
                                                torch.from_numpy(qpx))
    assert logits.shape == (2, 9, 1)
    np.testing.assert_allclose(_np(boxes), np.asarray(ref_boxes), **TOL)
    np.testing.assert_allclose(_np(logits), np.asarray(ref_logits), **TOL)


@pytest.mark.parametrize("shape,size", [((40, 60), 96), ((200, 150), 96),
                                        ((50, 300), 96), ((96, 96), 96),
                                        ((2, 33, 47), 64)])
@pytest.mark.parametrize("antialias", [True, False])
def test_resize_image_matches_jax(shape, size, antialias):
    """Up-, down- and mixed sampling, an identity size, a leading batch."""
    img = np.random.default_rng(7).integers(0, 256, (*shape, 3), dtype=np.uint8)
    ref = jpre.resize_image(jnp.asarray(img), size=size, antialias=antialias)
    got = preprocess.resize_image(torch.from_numpy(img), size=size, antialias=antialias)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    exact = img.astype(np.float64)
    for axis in (-3, -2):  # JAX's weights, applied in float64
        n_in = img.shape[axis]
        if n_in != size:
            w = np.asarray(jax_scale.compute_weight_mat(
                n_in, size, size / n_in, 0.0, jax_scale._fill_keys_cubic_kernel,
                antialias), np.float64)
            exact = np.moveaxis(np.tensordot(np.moveaxis(exact, axis, -1), w, 1), -1, axis)
    np.testing.assert_allclose(_np(got), exact, atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=5e-3, rtol=0)


@pytest.mark.parametrize("shape", [(70, 90), (240, 200)])
def test_preprocess_image_matches_jax(shape):
    img = np.random.default_rng(8).integers(0, 256, (2, *shape, 3), dtype=np.uint8)
    ref = jpre.preprocess_image(jnp.asarray(img), size=96)
    got = preprocess.preprocess_image(torch.from_numpy(img), size=96)
    atol = 5e-3 / 255 / preprocess.CLIP_STD.min()
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=atol, rtol=0)
