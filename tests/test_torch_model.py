"""Port: the model stack against the JAX package at `tiny` size, after the
weight bridge from the JAX `owlvit.init` tree.

The JAX side runs attention_impl="flash" (the Pallas kernel in interpret
mode); the port runs its plain attention on CPU. Tolerances: fp32 atol 2e-5
(summation order). bf16 rounds at different places in the two frameworks:
boxes and sims (in [0, 1] and [-1, 1]) are held to atol 3e-2; hidden states,
whose magnitude reaches several units (a bf16 ulp of 1.6e-2 at 2), to a
max-rel of 2e-2 (max abs difference over max abs value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owlvit_tpu.models import get_config as jax_get_config
from owlvit_tpu.models import layers as jlayers
from owlvit_tpu.models import owlvit as jowlvit
from owlvit_tpu.models import vit as jvit
from owlvit_tpu_torch.models import get_config, layers, owlvit, vit
from owlvit_tpu_torch.models.convert import from_jax_tree, load_tree
from owlvit_tpu_torch.ops.flash_attention import resolve_static_max

ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DTYPES = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])


@pytest.fixture(scope="module")
def jax_tree():
    cfg = jax_get_config("tiny")
    params = jowlvit.init(jax.random.PRNGKey(0), cfg, num_queries=12)
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def port_model(jax_tree):
    model, skipped = from_jax_tree(jax_tree, get_config("tiny"))
    assert skipped == []
    return model.eval()


def _pixels(seed=0, n=2, size=96):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


def _close(port, ref, dtype):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(jnp.asarray(ref, jnp.float32)),
                               atol=ATOL[dtype], rtol=0)


def _close_hidden(port, ref, dtype):
    """Hidden states: fp32 atol; bf16 max-rel (see the module docstring)."""
    if dtype == "float32":
        return _close(port, ref, dtype)
    a = port.detach().float().numpy()
    b = np.asarray(jnp.asarray(ref, jnp.float32))
    assert np.abs(a - b).max() / np.abs(b).max() <= 2e-2


@DTYPES
def test_layer_norm(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 10, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.normal(size=64).astype(np.float32),
         "bias": rng.normal(size=64).astype(np.float32)}
    ref = jlayers.layer_norm(p, jnp.asarray(x, JDT[dtype]))
    ln = load_tree(layers.LayerNorm(64), p)
    out = ln(torch.from_numpy(x).to(TDT[dtype]))
    assert out.dtype == TDT[dtype]
    _close_hidden(out, ref, dtype)


@DTYPES
def test_encoder_block(jax_tree, dtype):
    vc = get_config("tiny").vision
    p0 = jax.tree.map(lambda a: a[0], jax_tree["vision"]["layers"])
    x = np.random.default_rng(2).normal(size=(2, vc.num_patches + 1, vc.hidden_size))
    x = x.astype(np.float32)
    ref = jlayers.encoder_block(
        p0, jnp.asarray(x, JDT[dtype]), vc.num_heads, vc.layer_norm_eps,
        impl="flash", static_softmax=True)
    block = load_tree(layers.EncoderBlock(vc.hidden_size, vc.mlp_dim,
                                          vc.num_heads, vc.layer_norm_eps), p0)
    with torch.no_grad():
        out = block(torch.from_numpy(x).to(TDT[dtype]),
                    static_max=resolve_static_max(TDT[dtype], True))
    _close_hidden(out, ref, dtype)


@DTYPES
def test_vit_forward(jax_tree, port_model, dtype):
    vc = get_config("tiny").vision
    px = _pixels(3)
    ref = jvit.forward(jax_tree["vision"], vc, jnp.asarray(px), dtype=JDT[dtype],
                       attention_impl="flash", trainable_last_k=0,
                       static_softmax=True)
    out = vit.forward(port_model.vision, vc, torch.from_numpy(px),
                      dtype=TDT[dtype], trainable_last_k=0, static_softmax=True)
    assert out.shape == (2, vc.num_patches + 1, vc.hidden_size)
    _close_hidden(out, ref, dtype)


def test_prefix_tail_split_is_exact(port_model):
    """forward_prefix + forward_tail (k=1) is the full forward, bit for bit."""
    vc = get_config("tiny").vision
    px = torch.from_numpy(_pixels(4))
    full = vit.forward(port_model.vision, vc, px)
    split = vit.forward(port_model.vision, vc, px, trainable_last_k=1)
    assert torch.equal(full, split)


@pytest.mark.parametrize("fix_query_norm", [False, True])
@DTYPES
def test_forward_train(jax_tree, port_model, dtype, fix_query_norm):
    over = dict(dtype=dtype, trainable_last_k=0, static_softmax=True,
                fix_query_norm=fix_query_norm)
    px = _pixels(5)
    ref_boxes, ref_sims = jowlvit.forward_train(
        jax_tree, jax_get_config("tiny", attention_impl="flash", **over),
        jnp.asarray(px))
    with torch.inference_mode():
        boxes, sims = owlvit.forward_train(port_model, get_config("tiny", **over),
                                           torch.from_numpy(px))
    assert boxes.dtype == sims.dtype == torch.float32
    assert boxes.shape == (2, 9, 4) and sims.shape == (2, 9, 4)
    _close(boxes, ref_boxes, dtype)
    _close(sims, ref_sims, dtype)


def test_heads_on_shared_features(jax_tree, port_model):
    """box_predictor and the query-bank head alone, on the same fp32
    features (isolates the heads from the backbone)."""
    feats = np.random.default_rng(6).normal(size=(2, 9, 64)).astype(np.float32)
    jcfg, tcfg = jax_get_config("tiny"), get_config("tiny")
    with torch.no_grad():
        _close(owlvit.box_predictor(port_model, tcfg, torch.from_numpy(feats)),
               jowlvit.box_predictor(jax_tree, jcfg, jnp.asarray(feats)), "float32")
        _close(owlvit.class_predictor_querybank(port_model, tcfg,
                                                torch.from_numpy(feats)),
               jowlvit.class_predictor_querybank(jax_tree, jcfg, jnp.asarray(feats)),
               "float32")


def test_init_is_seeded_and_complete():
    cfg = get_config("tiny")
    a = owlvit.init(cfg, torch.Generator().manual_seed(0), num_queries=12)
    b = owlvit.init(cfg, torch.Generator().manual_seed(0), num_queries=12)
    c = owlvit.init(cfg, torch.Generator().manual_seed(1), num_queries=12)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["queries"], sc["queries"])
    assert all(torch.isfinite(t).all() for t in sa.values())
    assert sa["queries"].shape == (12, cfg.projection_dim)
    assert len(a.vision.layers) == cfg.vision.num_layers
