"""Port: the train step against the JAX package's `Trainer.train_step`.

Both trainers start from one parameter tree (the JAX trainer's, carried
across with `from_jax_tree`) and take the same 4 batches of its synthetic
dataset: `tiny`, fp32, uncached, trainable_last_k=1, lr 1e-3 after a 1-step
warmup (so the first update has lr 0). The JAX side's attention resolves to
its XLA path on the CPU; the port's runs the attention Function with the
plain forward and backward (the Pallas backward is held at the op level in
test_torch_flash_attention_bwd.py).

Tolerances: loss terms rtol 1e-4 (fp32 through two frameworks, four
steps); trainable parameters after step 4 atol 1e-5 (AdamW moves each by at
most ~lr = 1e-3 per step, so this is 1% of one step). The attention's key
bias is the exception: softmax is invariant to it, so its gradient is zero
up to rounding, and Adam scales that rounding noise to steps of about lr in
either direction on each side. It is held to that bound instead.
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
from owlvit_tpu.train.state import partition_params as jax_partition_params
from owlvit_tpu.utils import config as jconfig
from owlvit_tpu_torch.models import get_config
from owlvit_tpu_torch.models.convert import flatten, from_jax_tree
from owlvit_tpu_torch.train import Trainer, lr_schedule, partition_params
from owlvit_tpu_torch.utils import config as tconfig

STEPS, BATCH = 4, 4
KEYS = ("image", "labels", "boxes", "gt_mask")


def _port_config(cfg: jconfig.Config) -> tconfig.Config:
    return tconfig.Config(
        data=tconfig.DataConfig(**dataclasses.asdict(cfg.data)),
        training=tconfig.TrainingConfig(**dataclasses.asdict(cfg.training)),
        model=tconfig.ModelConfig(**dataclasses.asdict(cfg.model)))


def _params(tree):
    model, _ = from_jax_tree(tree, get_config("tiny"))
    return dict(model.named_parameters())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("run"))
    cfg = jconfig.Config(
        data=jconfig.DataConfig(synthetic_root=os.path.join(root, "synth"),
                                num_train_images=8, num_test_images=2, max_gt=8,
                                synthetic_classes=3),
        training=jconfig.TrainingConfig(learning_rate=1e-3, warmup_steps=1,
                                        batch_size=BATCH, log_file=None),
        model=jconfig.ModelConfig(name="tiny", trainable_last_k=1),
    )
    jt = JaxTrainer(cfg, workdir=root)
    tree0 = jax.tree.map(np.asarray, combine_params(jt.state.trainable, jt.state.frozen))
    model, _ = from_jax_tree(tree0, get_config("tiny"))
    pt = Trainer(_port_config(cfg), model, jt.n_classes,
                 steps_per_epoch=len(jt.train_ds) // BATCH,
                 class_weights=np.asarray(jt._scales), device="cpu")
    batches = [{k: b[k] for k in KEYS}
               for epoch in range(STEPS * BATCH // len(jt.train_ds))
               for b in batch_iterator(jt.train_ds, BATCH, shuffle=True, seed=epoch,
                                       pad_final=False)]
    assert len(batches) == STEPS
    jax_terms, port_terms = [], []
    for batch in batches:
        jt.state, packed = jt.train_step(jt.state, batch)
        jax_terms.append(np.asarray(packed))
        port_terms.append(pt.train_step(batch))
    tree = jax.tree.map(np.asarray, combine_params(jt.state.trainable, jt.state.frozen))
    return types.SimpleNamespace(jt=jt, pt=pt, tree0=tree0, tree=tree,
                                 jax_terms=jax_terms, port_terms=port_terms)


def test_loss_terms_agree(runs):
    for step, (p, j) in enumerate(zip(runs.port_terms, runs.jax_terms)):
        assert p.shape == (4,) and np.isfinite(p).all()
        np.testing.assert_allclose(p, j, rtol=1e-4, atol=0, err_msg=f"step {step}")


def test_trainable_params_agree_after_training(runs):
    want = _params(runs.tree)
    got = dict(runs.pt.model.named_parameters())
    moved = 0
    start = _params(runs.tree0)
    for name in (n for n, p in got.items() if p.requires_grad):
        g, w = got[name].detach().numpy(), want[name].detach().numpy()
        if name.endswith("attn.k.bias"):  # zero gradient up to rounding
            bound = (STEPS - 1) * 1e-3 * 1.01  # lr 0 on the first step
            assert np.abs(g - start[name].detach().numpy()).max() <= bound, name
            assert np.abs(w - start[name].detach().numpy()).max() <= bound, name
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)
        moved += not torch.equal(got[name], start[name])
    assert moved == len(runs.pt.params)  # every trainable parameter moved


def test_frozen_params_bit_unchanged(runs):
    start = _params(runs.tree0)
    frozen = [(n, p) for n, p in runs.pt.model.named_parameters() if not p.requires_grad]
    assert frozen
    for name, p in frozen:
        assert torch.equal(p, start[name]), name


def test_trainable_set_equals_jax_partition(runs):
    """The port's trainable parameters are exactly the leaves of the JAX
    trainable subtree, layer by layer."""
    trainable, _ = jax_partition_params(runs.tree0, 1)
    L = get_config("tiny").vision.num_layers
    want = set()
    for key in flatten(trainable):
        parts = key.split("/")
        name = {"kernel": "weight", "scale": "weight"}.get(parts[-1], parts[-1])
        if parts[1:2] == ["layers_tail"]:
            want.add(".".join(["vision", "layers", str(L - 1), *parts[2:-1], name]))
        else:
            want.add(".".join([*parts[:-1], name]))
    got = {n for n, p in runs.pt.model.named_parameters() if p.requires_grad}
    assert got == want
    names = {id(p): n for n, p in runs.pt.model.named_parameters()}
    assert {names[id(p)] for p in runs.pt.params} == want


@pytest.mark.parametrize("schedule,warmup", [("constant", 3), ("constant", 0),
                                             ("cosine", 2), ("cosine", 0)])
def test_lr_schedule_equals_optax(runs, schedule, warmup):
    """The port's schedule against the JAX trainer's optax schedule at every
    update of a short run (rtol 1e-6: optax evaluates in fp32)."""
    t = dataclasses.replace(runs.jt.cfg.training, lr_schedule=schedule,
                            warmup_steps=warmup, n_epochs=3, lr_final=1e-5)
    sched = JaxTrainer._lr_schedule(types.SimpleNamespace(
        cfg=dataclasses.replace(runs.jt.cfg, training=t), train_ds=runs.jt.train_ds))
    ours = lr_schedule(tconfig.TrainingConfig(**dataclasses.asdict(t)),
                       len(runs.jt.train_ds) // t.batch_size)
    for step in range(3 * len(runs.jt.train_ds) // t.batch_size + 3):
        want = sched(step) if callable(sched) else sched
        np.testing.assert_allclose(ours(step), float(want), rtol=1e-6, atol=0,
                                   err_msg=f"step {step}")


@pytest.mark.parametrize("field,value", [
    ("grad_accum", 2), ("ema_decay", 0.99), ("augment", True),
    ("augment_hflip", True), ("mesh_data", 2),
    ("checkpoint_dir", "ckpt")])
def test_unported_options_refused(field, value):
    cfg = tconfig.Config(data=tconfig.DataConfig(),
                         training=tconfig.TrainingConfig(**{field: value}),
                         model=tconfig.ModelConfig(name="tiny"))
    from owlvit_tpu_torch.models import owlvit

    model = owlvit.init(get_config("tiny"), torch.Generator().manual_seed(0), num_queries=9)
    with pytest.raises(NotImplementedError, match=field):
        Trainer(cfg, model, 3, steps_per_epoch=1, device="cpu")


def test_partition_params_full_finetune():
    from owlvit_tpu_torch.models import owlvit

    model = owlvit.init(get_config("tiny"), torch.Generator().manual_seed(0), num_queries=9)
    params = partition_params(model, None)
    names = {n for n, p in model.named_parameters() if p.requires_grad}
    assert len(params) == len(names)
    assert all(f"vision.layers.{i}.attn.q.weight" in names for i in range(2))
    assert "vision.patch_embedding.weight" not in names and "vision.pre_ln.weight" not in names
    with pytest.raises(ValueError, match="out of range"):
        partition_params(model, 3)
