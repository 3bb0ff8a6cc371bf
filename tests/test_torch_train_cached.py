"""Port: the cached train step against the JAX package's cached routing.

Both trainers start from one parameter tree (the JAX trainer's, carried
across with `from_jax_tree`) and take the same 4 batches of its synthetic
dataset, 2 epochs of 8 images in batches of 4 from `batch_iterator` (which
carry "indices"): `tiny`, fp32, trainable_last_k=1, lr 1e-3 after a 1-step
warmup, training.cache_backbone on. Epoch 1 fills the store and trains on
the exact prefix output; epoch 2 reads the store. The JAX side runs
`Trainer._train_one_batch` (its disk store through `_with_cached_acts`, as
its epoch loop does); the port's `Trainer.train_step`, the stored batches
without their images. Stores: the device pool in the activation dtype, the
device pool in int8, the disk memmap.

Tolerances, as tests/test_torch_train.py: loss terms rtol 1e-4; trainable
parameters after step 4 atol 1e-5, the attention's key bias (zero gradient
up to rounding) within the Adam step bound. int8: both sides quantize their
own prefix output, which differ in the last fp32 bits, so a code can differ
by one step where a value lies on a rounding boundary (one code of 5120 in
this run). Adam turns such a change into up to a few % of one step on a few
parameters, so with int8 the epoch-2 terms are held to rtol 1e-3 and the
parameters to atol 1e-4, a tenth of one step at lr 1e-3.

The port's cached run must also equal its own uncached run: every term and
parameter bit for bit with the activation-dtype device store and the disk
store (the tail trains on the same tensor either way).
"""

import dataclasses
import os
import types

import jax
import numpy as np
import pytest
import torch

from owlvit_tpu.data import batch_iterator
from owlvit_tpu.train import Trainer as JaxTrainer
from owlvit_tpu.train.state import combine_params
from owlvit_tpu.utils import config as jconfig
from owlvit_tpu_torch.models import get_config, owlvit
from owlvit_tpu_torch.models.convert import from_jax_tree
from owlvit_tpu_torch.train import Trainer
from owlvit_tpu_torch.train.trainer import TERM_KEYS
from owlvit_tpu_torch.utils import config as tconfig

BATCH, EPOCHS = 4, 2
KEYS = ("image", "labels", "boxes", "gt_mask", "indices")
STORES = {"device": ("device", None), "int8": ("device", "int8"), "disk": ("disk", None)}


def _jax_config(root, cache=True, store="auto", store_dtype=None):
    return jconfig.Config(
        data=jconfig.DataConfig(synthetic_root=os.path.join(root, "synth"),
                                num_train_images=8, num_test_images=2, max_gt=8,
                                synthetic_classes=3),
        training=jconfig.TrainingConfig(learning_rate=1e-3, warmup_steps=1,
                                        batch_size=BATCH, log_file=None,
                                        cache_backbone=cache,
                                        cache_backbone_store=store,
                                        cache_store_dtype=store_dtype),
        model=jconfig.ModelConfig(name="tiny", trainable_last_k=1))


def _port_config(cfg: jconfig.Config) -> tconfig.Config:
    return tconfig.Config(
        data=tconfig.DataConfig(**dataclasses.asdict(cfg.data)),
        training=tconfig.TrainingConfig(**dataclasses.asdict(cfg.training)),
        model=tconfig.ModelConfig(**dataclasses.asdict(cfg.model)))


def _params(tree):
    model, _ = from_jax_tree(tree, get_config("tiny"))
    return dict(model.named_parameters())


def _port_trainer(cfg, jt, tree0, workdir):
    model, _ = from_jax_tree(tree0, get_config("tiny"))
    return Trainer(_port_config(cfg), model, jt.n_classes,
                   steps_per_epoch=len(jt.train_ds) // BATCH,
                   class_weights=np.asarray(jt._scales), device="cpu",
                   n_images=len(jt.train_ds), workdir=workdir,
                   dataset_id=[key for key, _ in jt.train_ds.items])


def _batches(jt):
    return [{k: b[k] for k in KEYS}
            for epoch in range(EPOCHS)
            for b in batch_iterator(jt.train_ds, BATCH, shuffle=True, seed=epoch,
                                    pad_final=False)]


def _run_port(pt, batches):
    terms = []
    for i, b in enumerate(batches):
        b = dict(b)
        if i >= len(batches) // EPOCHS:  # stored rows: the image is not needed
            b.pop("image")
        terms.append(pt.train_step(b))
    return terms


@pytest.fixture(scope="module", params=list(STORES))
def runs(request, tmp_path_factory):
    store, store_dtype = STORES[request.param]
    root = str(tmp_path_factory.mktemp(request.param))
    cfg = _jax_config(os.path.join(root, "jax"), store=store, store_dtype=store_dtype)
    jt = JaxTrainer(cfg, workdir=os.path.join(root, "jax"))
    assert jt.act_store == store
    tree0 = jax.tree.map(np.asarray, combine_params(jt.state.trainable, jt.state.frozen))
    batches = _batches(jt)
    assert len(batches) == 4 and len({int(i) for b in batches for i in b["indices"]}) == 8

    jax_terms = []
    for b in batches:
        b = dict(b)
        if jt.act_cache is not None:  # the disk store's host-side swap
            b = next(jt._with_cached_acts(iter([b])))
        terms = jt._train_one_batch(b)
        jax_terms.append(np.array([terms[k] for k in TERM_KEYS], np.float32))
    tree = jax.tree.map(np.asarray, combine_params(jt.state.trainable, jt.state.frozen))

    pt = _port_trainer(cfg, jt, tree0, os.path.join(root, "port"))
    port_terms = _run_port(pt, batches)

    plain_cfg = _jax_config(root, cache=False)
    plain = _port_trainer(plain_cfg, jt, tree0, None)
    plain_terms = [plain.train_step({k: b[k] for k in KEYS if k != "indices"})
                   for b in batches]
    return types.SimpleNamespace(store=request.param, jt=jt, pt=pt, plain=plain,
                                 tree0=tree0, tree=tree, jax_terms=jax_terms,
                                 port_terms=port_terms, plain_terms=plain_terms)


def test_loss_terms_agree_with_jax(runs):
    for step, (p, j) in enumerate(zip(runs.port_terms, runs.jax_terms)):
        assert p.shape == (4,) and np.isfinite(p).all()
        rtol = 1e-3 if runs.store == "int8" and step >= 2 else 1e-4
        np.testing.assert_allclose(p, j, rtol=rtol, atol=0, err_msg=f"step {step}")


def test_trainable_params_agree_with_jax(runs):
    want, start = _params(runs.tree), _params(runs.tree0)
    got = dict(runs.pt.model.named_parameters())
    atol = 1e-4 if runs.store == "int8" else 1e-5
    for name in (n for n, p in got.items() if p.requires_grad):
        g, w = got[name].detach().numpy(), want[name].detach().numpy()
        if name.endswith("attn.k.bias"):  # zero gradient up to rounding
            bound = 3 * 1e-3 * 1.01  # lr 0 on the first step
            assert np.abs(g - start[name].detach().numpy()).max() <= bound, name
        else:
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


def test_store_filled_and_frozen_unchanged(runs):
    pt = runs.pt
    if runs.store == "disk":
        assert pt.act_cache.complete and pt.pool is None
    else:
        assert pt.filled.all() and pt.act_cache is None
        pool = pt.pool["q"] if runs.store == "int8" else pt.pool
        assert pool.shape == (8, 10, 64)
        assert pool.dtype == (torch.int8 if runs.store == "int8" else torch.float32)
    start = _params(runs.tree0)
    for name, p in pt.model.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p, start[name]), name


def test_cached_run_matches_uncached(runs):
    """The same 4 steps uncached: bit-equal terms and parameters with the
    activation-dtype stores. int8 reads quantized rows in epoch 2, each
    element moved by up to rowmax/254 (0.4% of the row's peak): its terms
    are held to rtol 1e-2 there and the parameters to atol 1e-3, one Adam
    step; epoch 1 never reads the pool, so its terms are still bit-equal."""
    exact = runs.store != "int8"
    for step, (c, u) in enumerate(zip(runs.port_terms, runs.plain_terms)):
        if exact or step < 2:
            np.testing.assert_array_equal(c, u, err_msg=f"step {step}")
        else:
            np.testing.assert_allclose(c, u, rtol=1e-2, atol=0, err_msg=f"step {step}")
    plain = dict(runs.plain.model.named_parameters())
    for name, p in runs.pt.model.named_parameters():
        if exact:
            assert torch.equal(p, plain[name]), name
        elif not name.endswith("attn.k.bias"):  # noise-driven, as above
            torch.testing.assert_close(p, plain[name], atol=1e-3, rtol=0, msg=name)


def test_gathered_rows_equal_fresh_prefix(runs):
    """The stored rows against a fresh embed_prefix of the same images: bit
    for bit in the activation dtype, within rowmax/254 per element in int8."""
    b = _batches(runs.jt)[0]
    image = torch.from_numpy(np.asarray(b["image"])).reshape(BATCH, 96, 96, 3)
    from owlvit_tpu_torch.ops.preprocess import normalize_image

    fresh = owlvit.embed_prefix(runs.pt.model, runs.pt.model_cfg, normalize_image(image))
    idxs = np.asarray(b["indices"])
    if runs.store == "disk":
        got = runs.pt.act_cache.read_tensor(idxs)
    else:
        got = runs.pt.pool_gather(torch.from_numpy(idxs))
    if runs.store == "int8":
        bound = fresh.abs().amax(-1, keepdim=True) / 254 * (1 + 1e-4)
        assert ((got - fresh).abs() <= bound).all()
    else:
        assert torch.equal(got, fresh)


def _trainer(root, trainable_last_k=1, **training):
    cfg = tconfig.Config(tconfig.DataConfig(),
                         tconfig.TrainingConfig(**{"cache_backbone": True, **training}),
                         tconfig.ModelConfig(name="tiny", trainable_last_k=trainable_last_k))
    model = owlvit.init(get_config("tiny"), torch.Generator().manual_seed(0), num_queries=9)
    return lambda **kw: Trainer(cfg, model, 3, steps_per_epoch=1, device="cpu",
                                **{"n_images": 8, "workdir": str(root), **kw})


@pytest.mark.parametrize("training,kwargs,match", [
    ({"cache_store_dtype": "int4"}, {}, "cache_store_dtype"),
    ({"cache_backbone_store": "disk", "cache_store_dtype": "int8"}, {}, "device pool"),
    ({"cache_backbone_store": "nvme"}, {}, "auto|device|disk"),
    ({"trainable_last_k": None}, {}, "trainable_last_k"),
    ({}, {"n_images": None}, "n_images"),
    ({"cache_backbone_store": "disk"}, {"workdir": None}, "workdir"),
])
def test_cache_options_validated(tmp_path, training, kwargs, match):
    with pytest.raises(ValueError, match=match):
        _trainer(tmp_path, **training)(**kwargs)


def test_auto_store_follows_the_pool_budget(tmp_path):
    """auto: the device pool while the set fits the budget (the JAX
    package's 10 GB), the disk store beyond it; the int8 payload is
    (1 + 4/D) bytes per element."""
    t = _trainer(tmp_path)()
    assert t.act_store == "device"
    vc = get_config("tiny").vision
    per_image = (vc.num_patches + 1) * vc.hidden_size * 4
    assert t.act_pool_bytes(8, None) == 8 * per_image
    assert t.act_pool_bytes(8, "int8") == pytest.approx(8 * per_image / 4 * (1 + 4 / vc.hidden_size))
    big = int(10e9 // per_image) + 1
    assert _trainer(tmp_path)(n_images=big).act_store == "disk"
    assert _trainer(tmp_path)(n_images=big - 1).act_store == "device"
