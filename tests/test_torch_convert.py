"""Port: the copies of the JAX package's framework-free pieces (configs,
box-bias prior, npz flatten/unflatten) stay equal to the originals, and an
npz written by the JAX package loads into the port's modules."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from owlvit_tpu.models import configs as jconfigs
from owlvit_tpu.models import convert as jconvert
from owlvit_tpu.models import owlvit as jowlvit
from owlvit_tpu.ops.box_bias import compute_box_bias as jax_box_bias
from owlvit_tpu_torch.models import configs, convert
from owlvit_tpu_torch.ops.box_bias import compute_box_bias


@pytest.mark.parametrize("name", ["b32", "b16", "l14", "tiny", "B/16", "L-14"])
def test_configs_match_jax(name):
    ours, theirs = configs.get_config(name), jconfigs.get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for cls in ("VisionConfig", "TextConfig", "OwlViTConfig"):
        assert ([f.name for f in dataclasses.fields(getattr(configs, cls))]
                == [f.name for f in dataclasses.fields(getattr(jconfigs, cls))])
    for attr in ("grid", "num_patches", "head_dim"):
        assert getattr(ours.vision, attr) == getattr(theirs.vision, attr)
    assert ours.text.head_dim == theirs.text.head_dim
    over = dict(dtype="bfloat16", static_softmax=True, trainable_last_k=0)
    assert (dataclasses.asdict(configs.get_config(name, **over))
            == dataclasses.asdict(jconfigs.get_config(name, **over)))


@pytest.mark.parametrize("grid", [(3, 3), (18, 18), (24, 24), (48, 48), (60, 60), (4, 7)])
def test_box_bias_matches_jax(grid):
    ours, theirs = compute_box_bias(*grid), jax_box_bias(*grid)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)


def test_flatten_unflatten_match_jax():
    rng = np.random.default_rng(0)
    tree = {"a": {"b": rng.normal(size=3), "c": {"d": np.arange(4)}},
            "e": rng.normal(size=(2, 2))}
    flat = convert.flatten(tree)
    jflat = jconvert.flatten(tree)
    assert flat.keys() == jflat.keys() == {"a/b", "a/c/d", "e"}
    for k in flat:
        np.testing.assert_array_equal(flat[k], jflat[k])
    back, jback = convert.unflatten(flat), jconvert.unflatten(jflat)
    assert jax.tree.structure(back) == jax.tree.structure(jback)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jback)):
        np.testing.assert_array_equal(x, y)


def test_jax_npz_loads_into_port(tmp_path):
    cfg = jconfigs.get_config("tiny")
    params = jax.tree.map(np.asarray,
                          jowlvit.init(jax.random.PRNGKey(1), cfg, num_queries=12))
    path = str(tmp_path / "tiny.npz")
    jconvert.save_params(path, params)

    tree = convert.load_params(path)
    model, skipped = convert.from_jax_tree(tree, configs.get_config("tiny"))
    assert skipped == []
    sd = model.state_dict()
    v, L = params["vision"], cfg.vision.num_layers
    # every leaf, the text tower's included, maps to one tensor per stacked layer
    n_leaves = sum(a.shape[0] if "/layers/" in k else 1
                   for k, a in jconvert.flatten(params).items())
    assert len(sd) == n_leaves
    np.testing.assert_array_equal(sd["vision.patch_embedding.weight"].numpy(),
                                  v["patch_embedding"]["kernel"].T)
    for i in range(L):
        np.testing.assert_array_equal(sd[f"vision.layers.{i}.attn.q.weight"].numpy(),
                                      v["layers"]["attn"]["q"]["kernel"][i].T)
        np.testing.assert_array_equal(sd[f"vision.layers.{i}.mlp.fc2.bias"].numpy(),
                                      v["layers"]["mlp"]["fc2"]["bias"][i])
        np.testing.assert_array_equal(sd[f"vision.layers.{i}.ln2.weight"].numpy(),
                                      v["layers"]["ln2"]["scale"][i])
    np.testing.assert_array_equal(sd["vision.position_embedding"].numpy(),
                                  v["position_embedding"])
    np.testing.assert_array_equal(sd["class_head.logit_scale.weight"].numpy(),
                                  params["class_head"]["logit_scale"]["kernel"].T)
    np.testing.assert_array_equal(sd["queries"].numpy(), params["queries"])
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in sd.values())


def test_bridge_refuses_incomplete_tree():
    cfg = jconfigs.get_config("tiny")
    params = jax.tree.map(np.asarray, jowlvit.init(jax.random.PRNGKey(2), cfg))
    del params["box_head"]["dense1"]
    with pytest.raises(RuntimeError, match="Missing key"):
        convert.from_jax_tree(params, configs.get_config("tiny"))
