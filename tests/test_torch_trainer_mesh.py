"""Port: mesh training (training.mesh_data x mesh_model) against the JAX
package's GSPMD mesh and the single-device run (counterpart of
tests/test_trainer_mesh.py, with its `_cfg` and a shared params npz).

Two gloo ranks on the CPU (tests/torch_mesh_ranks.py) run each config
through Trainer.from_config and run(), as `torchrun ... cli train` would;
the parent runs the JAX Trainer and the port on one device from the same
npz and synthetic set. Held: the query bank and every trainable parameter
within rtol 1e-4 / atol 1e-6 (tests/test_trainer_mesh.py:58; fp32, the
gradient summed over two ranks in another order), mAP within 1e-6, equal
step counts.

- dp=2 against the JAX Trainer(mesh_data=2) and the port's single-device
  run; the train set's batches hold uneven box counts per rank, so the
  loss normalisers must be the global batch's.
- dp=1 x tp=2 against the single-device run; its checkpoint (the
  tensor-parallel slices gathered) restored on one device, and resumed
  under tp=2 for another epoch.
- The device store's sharded pool (fp32, int8, and augment_hflip's two
  rows an image): each rank holds its N/2 images' rows, the aligned
  sampler's trajectory against the JAX Trainer(mesh_data=2,
  cache_backbone=True).
- An indivisible set (9 images) falls back to the disk store, on the plain
  sampler: the single-device trajectory.
- grad_accum 2 and augment on the mesh against the single-device run;
  the grad_accum run's checkpoint (its mean and EMA) restored on one device.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from owlvit_tpu.models import get_config as jax_get_config
from owlvit_tpu.models import owlvit as jowlvit
from owlvit_tpu.models.convert import save_params
from owlvit_tpu.train import Trainer as JaxTrainer
from owlvit_tpu.utils.config import Config, DataConfig, ModelConfig, TrainingConfig
from owlvit_tpu_torch.data import DetectionDataset
from owlvit_tpu_torch.train import Trainer
from owlvit_tpu_torch.utils import config as tconfig
from torch_mesh_ranks import run_ranks

RTOL, ATOL, ATOL_MAP = 1e-4, 1e-6, 1e-6

# the mesh runs: name -> (training overrides, n_train)
RUNS = {
    "dp2": (dict(mesh_data=2), 8),
    "tp2": (dict(mesh_model=2, checkpoint_dir="tp2"), 8),
    # tp2's checkpoint (full tensors) resumed under tp=2 for a third epoch
    "tp2_resume": (dict(mesh_model=2, n_epochs=3, checkpoint_dir="tp2",
                        checkpoint_every_epochs=0), 8),
    "cached": (dict(mesh_data=2, cache_backbone=True), 8),
    "int8": (dict(mesh_data=2, cache_backbone=True, cache_store_dtype="int8"), 8),
    "hflip": (dict(mesh_data=2, cache_backbone=True, augment_hflip=True), 8),
    "disk": (dict(mesh_data=2, cache_backbone=True), 9),
    "accum": (dict(mesh_data=2, grad_accum=2, ema_decay=0.9, checkpoint_dir="accum"), 8),
    "augment": (dict(mesh_data=2, augment=True, aug_hflip=0.5, aug_color=0.3,
                     aug_scale_min=0.9, aug_scale_max=1.1), 8),
    # training.stage_pixels: on, uncached (every rank stages the whole set)
    # and with the device store (each rank its own 4 rows)
    "stage": (dict(mesh_data=2, stage_pixels="on"), 8),
    "stage_cached": (dict(mesh_data=2, cache_backbone=True, stage_pixels="on"), 8),
    # refused: the staged train set must divide by mesh_data
    "stage_indivisible": (dict(mesh_data=2, stage_pixels="on"), 9),
}
# the runs whose from_config raises ValueError on every rank
REFUSED = ("stage_indivisible",)


def _cfg(root, npz, n_train=8, **training_kw):
    """tests/test_trainer_mesh.py's _cfg, the parameters from npz."""
    return Config(
        data=DataConfig(
            synthetic_root=os.path.join(root, "synth"),
            num_train_images=n_train,
            num_test_images=4,
            max_gt=8,
            synthetic_classes=3,
        ),
        training=TrainingConfig(
            **{
                "n_epochs": 2, "learning_rate": 1e-4, "batch_size": 4,
                "log_file": None, "top_k": 16, **training_kw,
            }
        ),
        model=ModelConfig(name="tiny", trainable_last_k=1, params_npz=npz),
    )


def _port(cfg: Config) -> tconfig.Config:
    return tconfig.Config(
        data=tconfig.DataConfig(**dataclasses.asdict(cfg.data)),
        training=tconfig.TrainingConfig(**dataclasses.asdict(cfg.training)),
        model=tconfig.ModelConfig(**dataclasses.asdict(cfg.model)))


def _single(cfg: Config, root: str, **training) -> Trainer:
    """The port's run of cfg on one device (no mesh), with overrides."""
    t = dataclasses.replace(cfg.training, mesh_data=1, mesh_model=1, **training)
    trainer = Trainer.from_config(
        _port(dataclasses.replace(cfg, training=t, data=dataclasses.replace(
            cfg.data, synthetic_root=os.path.join(root, "synth")))),
        workdir=root, device="cpu")
    trainer.metrics = trainer.run()
    return trainer


def _jax(cfg: Config, root: str):
    trainer = JaxTrainer(dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, synthetic_root=os.path.join(root, "synth"))), workdir=root)
    metrics = trainer.run()
    return (np.asarray(trainer.state.trainable["queries"], np.float32), float(metrics["map"]),
            int(trainer.state.step))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _trainable(trainer: Trainer) -> list:
    return [p.detach() for p in trainer.params]


def _close_trainable(got: dict, want: list, what: str):
    """Every trainable parameter but the attention's key bias, whose
    gradient is 0 in exact arithmetic (a shift of every score of a query
    leaves its softmax unchanged): AdamW scales its rounding noise, which
    the summation order sets, to a full step."""
    assert len(got["trainable"]) == len(want)
    for name, g, w in zip(got["names"], got["trainable"], want):
        if not name.endswith("attn.k.bias"):
            _close(g, w, f"{what}: {name}")


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("params") / "tiny.npz")
    tree = jowlvit.init(jax.random.PRNGKey(11), jax_get_config("tiny"), num_queries=9)
    save_params(path, jax.tree.map(np.asarray, tree))
    return path


@pytest.fixture(scope="module")
def mesh(tmp_path_factory, npz):
    """Every mesh run, in one spawn of two ranks -> (root, {name: [rank 0's
    result, rank 1's]}, {name: config})."""
    root = str(tmp_path_factory.mktemp("mesh"))
    cfgs, runs = {}, {}
    for name, (training, n_train) in RUNS.items():
        if "checkpoint_dir" in training:  # the named run's directory
            training = {**training, "checkpoint_dir": os.path.join(
                root, training["checkpoint_dir"], "ckpt")}
        cfgs[name] = _cfg(os.path.join(root, name), npz, n_train, **training)
        runs[name] = {"config": dataclasses.asdict(cfgs[name]),
                      "workdir": os.path.join(root, name), "refused": name in REFUSED}
    out = run_ranks("trainer_runs", 2, os.path.join(root, "ranks"), runs=runs)
    return root, {name: [o[name] for o in out] for name in RUNS}, cfgs


def _same_on_ranks(results, step=4):
    a, b = results
    assert torch.equal(a["queries"], b["queries"])
    assert all(torch.equal(x, y) for x, y in zip(a["trainable"], b["trainable"]))
    assert a["map"] == b["map"] and a["step"] == b["step"] == step


def test_dp_matches_jax_mesh_and_single_device(mesh, tmp_path):
    root, out, cfgs = mesh
    cfg = cfgs["dp2"]
    # uneven box counts between the two ranks' halves of a batch
    ds = DetectionDataset(os.path.join(root, "dp2", "synth", "train.json"),
                          os.path.join(root, "dp2", "synth", "images"),
                          image_size=jax_get_config("tiny").vision.image_size, max_gt=8)
    order = np.arange(8)
    np.random.default_rng(cfg.training.seed).shuffle(order)
    counts = [int(s["gt_mask"].sum()) for s in ds.load_batch(order[:4], with_images=False)]
    assert counts[0] + counts[1] != counts[2] + counts[3], counts

    _same_on_ranks(out["dp2"])
    got = out["dp2"][0]
    jq, jmap, jstep = _jax(dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, mesh_data=2)), str(tmp_path / "jax"))
    single = _single(cfg, str(tmp_path / "single"))
    assert jstep == single.step == got["step"] == 4
    _close(got["queries"], jq, "queries vs JAX mesh_data=2")
    _close(got["queries"], single.model.queries.detach(), "queries vs one device")
    _close_trainable(got, _trainable(single), "vs one device")
    assert abs(got["map"] - jmap) <= ATOL_MAP and abs(got["map"] - single.metrics["map"]) <= ATOL_MAP


def test_dp_x_tp_matches_single_device_and_restores(mesh, tmp_path):
    root, out, cfgs = mesh
    _same_on_ranks(out["tp2"])
    got = out["tp2"][0]
    single = _single(cfgs["tp2"], str(tmp_path / "single"), checkpoint_dir=None)
    _close_trainable(got, _trainable(single), "tp=2 vs one device")
    assert abs(got["map"] - single.metrics["map"]) <= ATOL_MAP
    # the checkpoint holds full tensors: it restores on one device
    restored = Trainer.from_config(_port(dataclasses.replace(cfgs["tp2"], training=dataclasses.replace(
        cfgs["tp2"].training, mesh_model=1))), workdir=str(tmp_path / "restore"), device="cpu")
    assert restored.step == 4
    for g, w in zip(_trainable(restored), got["trainable"]):
        assert torch.equal(g, w)
    full = single.model.state_dict()
    for k, v in restored.model.state_dict().items():
        assert v.shape == full[k].shape, k


def test_tp_resumes_a_full_checkpoint(mesh, tmp_path):
    """The tp=2 run's checkpoint, resumed under tp=2 (each rank slices the
    parameters and AdamW's moments) for a third epoch: the single-device
    run of 3 epochs."""
    root, out, cfgs = mesh
    _same_on_ranks(out["tp2_resume"], step=6)
    single = _single(cfgs["tp2_resume"], str(tmp_path / "single"), checkpoint_dir=None)
    assert single.step == 6
    _close_trainable(out["tp2_resume"][0], _trainable(single), "tp=2 resumed vs one device")


@pytest.mark.parametrize("run", ["cached", "int8", "hflip"])
def test_mesh_device_store_sharded_pool(mesh, tmp_path, run):
    """8 images divide by mesh_data=2: each rank's device pool holds its 4
    rows (hflip: 8, rows 2i and 2i+1 of its images), the aligned sampler
    keeps the gathers rank-local, and the run follows the JAX mesh run's
    (same aligned batches; hflip, the flips drawn for the global batch)."""
    root, out, cfgs = mesh
    _same_on_ranks(out[run])
    for r in out[run]:
        assert r["store"] == "device" and r["filled"]
    want = {"cached": (4, 10, 64), "int8": {"q": (4, 10, 64), "s": (4, 10)},
            "hflip": (8, 10, 64)}[run]
    assert out[run][0]["pool_shape"] == want
    jq, jmap, jstep = _jax(cfgs[run], str(tmp_path / "jax"))
    assert jstep == 4
    _close(out[run][0]["queries"], jq, f"{run} queries vs JAX mesh_data=2")
    assert abs(out[run][0]["map"] - jmap) <= ATOL_MAP


def test_mesh_indivisible_set_falls_back_to_disk(mesh, tmp_path):
    root, out, cfgs = mesh
    _same_on_ranks(out["disk"])
    assert [r["store"] for r in out["disk"]] == ["disk", "disk"]
    # the plain sampler: the single-device (device store) trajectory
    single = _single(cfgs["disk"], str(tmp_path / "single"))
    assert single.act_store == "device"
    _close_trainable(out["disk"][0], _trainable(single), "disk store on the mesh vs one device")


def test_grad_accum_on_mesh_matches_single_device_and_restores(mesh, tmp_path):
    root, out, cfgs = mesh
    _same_on_ranks(out["accum"])
    got = out["accum"][0]
    single = _single(cfgs["accum"], str(tmp_path / "single"), checkpoint_dir=None)
    assert single.step == 4 and single.updates == 2
    _close_trainable(got, _trainable(single), "grad_accum 2 vs one device")
    _close_trainable({**got, "trainable": got["ema"]}, single.ema, "EMA vs one device")
    restored = Trainer.from_config(_port(dataclasses.replace(cfgs["accum"], training=dataclasses.replace(
        cfgs["accum"].training, mesh_data=1))), workdir=str(tmp_path / "restore"), device="cpu")
    assert (restored.step, restored.updates, restored.mini_step) == (4, 2, 0)
    for g, w in zip(_trainable(restored), got["trainable"]):
        assert torch.equal(g, w)
    for g, w in zip(restored.ema, got["ema"]):
        assert torch.equal(g, w)


def test_augment_on_mesh_matches_single_device(mesh, tmp_path):
    """The augmentation's parameters are drawn for the global batch and
    each rank keeps its rows: the pixels the single-device run trains on."""
    root, out, cfgs = mesh
    _same_on_ranks(out["augment"])
    single = _single(cfgs["augment"], str(tmp_path / "single"))
    _close(out["augment"][0]["queries"], single.model.queries.detach(), "augment queries")
    _close_trainable(out["augment"][0], _trainable(single), "augment vs one device")


@pytest.mark.parametrize("run,streamed", [("stage", "dp2"), ("stage_cached", "cached")])
def test_staged_mesh_matches_streamed_and_single_device(mesh, tmp_path, run, streamed):
    """stage_pixels: on at dp=2: the streamed mesh run's parameters and mAP
    bit for bit (the same batches gathered on each rank's device, the
    device epoch from the epoch whose steps need no host bookkeeping).
    Uncached every rank stages all 8 images, and the run is held to the
    single-device staged run; with the device store each rank stages its
    own 4, and the run (the shard-aligned batches) is held to the JAX
    package's staged mesh run, within the mesh tolerances."""
    root, out, cfgs = mesh
    _same_on_ranks(out[run])
    got, want = out[run][0], out[streamed][0]
    assert torch.equal(got["queries"], want["queries"]) and got["map"] == want["map"]
    assert all(torch.equal(a, b) for a, b in zip(got["trainable"], want["trainable"]))
    for r in out[run]:
        assert r["staged"] == ((8, {"image", "labels", "boxes", "gt_mask"}) if run == "stage"
                               else (4, {"labels", "boxes", "gt_mask"}))
        assert r["device_epochs"] == ([0, 1] if run == "stage" else [1])
    if run == "stage_cached":
        jq, jmap, jstep = _jax(cfgs[run], str(tmp_path / "jax"))
        assert jstep == 4
        _close(got["queries"], jq, f"{run} queries vs JAX mesh_data=2")
        assert abs(got["map"] - jmap) <= ATOL_MAP
        return
    single = _single(cfgs[run], str(tmp_path / "single"))
    assert single.stage_on
    _close(got["queries"], single.model.queries.detach(), f"{run} queries vs one device")
    _close_trainable(got, _trainable(single), f"{run} vs one device")
    assert abs(got["map"] - single.metrics["map"]) <= ATOL_MAP


def test_staged_mesh_refuses_an_indivisible_set(mesh):
    """The JAX package's refusal: a staged train set of 9 images on
    mesh_data=2, on both ranks."""
    root, out, cfgs = mesh
    for r in out["stage_indivisible"]:
        assert "stage_pixels=on with mesh_data=2" in r["error"]
        assert "(9 images) must divide by mesh_data" in r["error"]


def test_mesh_of_one_step_is_bit_equal():
    """A mesh of one rank (the smoke's NCCL check, here on gloo) takes the
    mesh path, the loss's count all_reduce, the gradient all_reduce and the
    tensor-parallel Functions on groups of one, and is the plain step bit
    for bit: terms and every trainable parameter after two steps."""
    import torch.distributed as dist

    from owlvit_tpu_torch.models import get_config, owlvit
    from owlvit_tpu_torch.parallel import create_mesh

    rng = np.random.default_rng(0)
    S = get_config("tiny").vision.image_size
    batches = [{"image": rng.integers(0, 255, (4, S * S * 3), dtype=np.uint8),
                "labels": rng.integers(0, 3, (4, 2)),
                "boxes": np.array([[[.1, .1, .5, .5], [.4, .3, .9, .8]]] * 4, np.float32),
                "gt_mask": np.array([[True, True], [True, False]] * 2)} for _ in range(2)]
    cfg = tconfig.Config(tconfig.DataConfig(), tconfig.TrainingConfig(batch_size=4),
                         tconfig.ModelConfig(name="tiny", trainable_last_k=2))
    out = []
    for mesh in (None, "one"):
        if mesh:
            mesh = create_mesh(1, 1, device_type="cpu")
        try:
            model = owlvit.init(get_config("tiny"), torch.Generator().manual_seed(0),
                                num_queries=9)
            trainer = Trainer(cfg, model, 3, steps_per_epoch=2, device="cpu", mesh=mesh)
            assert (trainer.mesh is None) == (mesh is None)
            terms = [trainer.train_step(dict(b)) for b in batches]
            out.append((terms, [p.detach().clone() for p in trainer.params]))
        finally:
            if mesh:
                assert model.vision.layers[0].attn.tp_group is not None
                dist.destroy_process_group()
    for a, b in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_cli_train_and_eval_under_torchrun(tmp_path):
    """`torchrun --nproc_per_node=2 -m owlvit_tpu_torch.cli train|eval` on
    a mesh_data: 2 config (gloo, --device cpu): rank 0 alone prints the
    metrics and writes the JSONL and the checkpoint, which the eval of the
    same config restores; without torchrun the config is refused."""
    import json
    import subprocess
    import sys

    from owlvit_tpu_torch import cli

    root = str(tmp_path)
    cfg = os.path.join(root, "c.yaml")
    with open(cfg, "w") as f:
        f.write(f"""data:
  synthetic_root: {root}/synth
  num_train_images: 8
  num_test_images: 4
  max_gt: 8
  synthetic_classes: 3
training:
  n_epochs: 1
  batch_size: 4
  learning_rate: 1.0e-4
  top_k: 16
  mesh_data: 2
  cache_backbone: false
  log_file: metrics.jsonl
  checkpoint_dir: {root}/ckpt
model:
  name: tiny
  trainable_last_k: 1
""")
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        cli.main(["train", "--config", cfg, "--workdir", root, "--device", "cpu"])
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))), os.environ.get("PYTHONPATH", "")]))
    printed = {}
    for cmd in ("train", "eval"):
        run = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node=2", "-m", "owlvit_tpu_torch.cli", cmd, "--config", cfg,
             "--workdir", root, "--device", "cpu"],
            env=env, cwd=root, capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stderr[-3000:]
        assert run.stdout.count('"map":') == 1, run.stdout  # rank 0 only
        printed[cmd] = json.loads(run.stdout[run.stdout.rindex("{\n"):])
    with open(os.path.join(root, "metrics.jsonl")) as f:
        assert len(f.read().strip().splitlines()) == 1
    assert sorted(os.listdir(os.path.join(root, "ckpt"))) == ["step_00000002"]
    assert printed["eval"]["map"] == printed["train"]["map"]
