"""Port: checkpoints (torch.save in place of Orbax) with the JAX module's
layout and API: `save`, `latest_step`, `restore`, `prune_steps`, under
step_{step:08d}.

A trainer's state restored into a fresh trainer is bit-equal (every
parameter, the AdamW moments, the step), and the next step from it is
bit-equal to the next step of the trainer that saved it.
"""

import os

import numpy as np
import pytest
import torch

from owlvit_tpu_torch.models import get_config, owlvit
from owlvit_tpu_torch.train import Trainer
from owlvit_tpu_torch.train import checkpoint as ckpt
from owlvit_tpu_torch.utils.config import Config, DataConfig, ModelConfig, TrainingConfig


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 255, (2, 96, 96, 3), dtype=np.uint8),
            "labels": np.array([[0, 2], [1, 0]]),
            "boxes": np.array([[[.1, .1, .5, .5], [.3, .2, .9, .8]]] * 2, np.float32),
            "gt_mask": np.array([[True, True], [True, False]])}


def _trainer(seed=0):
    cfg = Config(DataConfig(), TrainingConfig(batch_size=2, learning_rate=1e-3),
                 ModelConfig(name="tiny", trainable_last_k=1))
    model = owlvit.init(get_config("tiny"), torch.Generator().manual_seed(seed), num_queries=9)
    return Trainer(cfg, model, 3, steps_per_epoch=2, device="cpu")


def test_layout_latest_and_prune(tmp_path):
    d = str(tmp_path / "ckpt")
    assert ckpt.latest_step(d) is None and ckpt.restore(d) is None
    for step in (3, 12, 7):
        path = ckpt.save(d, {"step": step, "w": torch.full((2,), float(step)),
                             "empty": torch.zeros((0, 4))})
        assert path == os.path.join(os.path.abspath(d), f"step_{step:08d}")
    os.makedirs(os.path.join(d, "step_00000099.tmp123"))  # a cut-off save
    assert ckpt.latest_step(d) == 12
    state = ckpt.restore(d)
    assert state["step"] == 12 and torch.equal(state["w"], torch.full((2,), 12.0))
    assert state["empty"].shape == (0, 4)
    ckpt.prune_steps(d, 7)
    assert sorted(x for x in os.listdir(d) if x[5:].isdigit()) == ["step_00000007"]


def test_save_replaces_the_same_step(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, {"step": 1, "w": torch.zeros(3)})
    ckpt.save(d, {"step": 1, "w": torch.ones(3)})
    assert torch.equal(ckpt.restore(d)["w"], torch.ones(3))
    assert os.listdir(d) == ["step_00000001"]


def test_trainer_state_roundtrip_continues_bit_equal(tmp_path):
    a = _trainer()
    for s in range(2):
        a.train_step(_batch(s))
    ckpt.save(str(tmp_path), a.state())

    b = _trainer(seed=1)  # other weights: everything must come from the file
    b.load_state(ckpt.restore(str(tmp_path)))
    assert b.step == 2
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    sa, sb = a.opt.state_dict()["state"], b.opt.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for k in sa:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[k][key], sb[k][key]), (k, key)
    # the optimizer still holds the model's own parameter objects
    assert all(p is q for p, q in zip(b.params, b.opt.param_groups[0]["params"]))
    np.testing.assert_array_equal(b.train_step(_batch(5)), a.train_step(_batch(5)))
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n


def test_restore_refuses_another_geometry(tmp_path):
    a = _trainer()
    ckpt.save(str(tmp_path), a.state())
    cfg = Config(DataConfig(), TrainingConfig(batch_size=2),
                 ModelConfig(name="tiny", trainable_last_k=1))
    other = owlvit.init(get_config("tiny"), torch.Generator().manual_seed(0), num_queries=6)
    b = Trainer(cfg, other, 2, steps_per_epoch=1, device="cpu")
    with pytest.raises(RuntimeError, match="size mismatch"):
        b.load_state(ckpt.restore(str(tmp_path)))
