"""Rank processes for the port's mesh tests (tests/test_torch_parallel.py,
tests/test_torch_trainer_mesh.py, tests/test_torch_prefix_switches.py).

`run_ranks(job, world, tmp, **kw)` spawns `world` processes with
torch.multiprocessing; each joins a gloo process group through a file
rendezvous under tmp (so that parallel test workers never share a port),
runs JOBS[job](rank, **kw) on the CPU with `import jax` made impossible,
and saves its result; the parent gets the list of results in rank order.
A rank that raises fails the spawn, and so the test. This module imports
neither jax nor the JAX package, so the ranks load nothing of either.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch


def run_ranks(job: str, world: int, tmp, **kw) -> list:
    import torch.multiprocessing as mp

    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    mp.start_processes(_entry, args=(world, tmp, job, kw), nprocs=world,
                       start_method="spawn", join=True)
    return [torch.load(os.path.join(tmp, f"{job}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _entry(rank: int, world: int, tmp: str, job: str, kw: dict) -> None:
    sys.modules["jax"] = None  # any `import jax` now raises ImportError
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/{job}_rdzv",
                            rank=rank, world_size=world)
    try:
        out = JOBS[job](rank, **kw)
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("owlvit_tpu", "jaxlib", "flax", "optax"))
        assert not leaked, leaked
        torch.save(out, os.path.join(tmp, f"{job}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------- the jobs


def mesh_layout(rank: int) -> dict:
    """create_mesh over 4 ranks: coordinates and groups of the 2x2 and 4x1
    meshes, and the refusal of a mesh of another size."""
    from owlvit_tpu_torch.parallel import create_mesh
    from owlvit_tpu_torch.parallel.mesh import coords

    out = {}
    for shape in ((2, 2), (4, 1), (1, 4)):
        mesh = create_mesh(*shape, device_type="cpu")
        out[shape] = {
            "coords": (coords(mesh, "data"), coords(mesh, "model")),
            "names": mesh.mesh_dim_names,
            "mesh": mesh.mesh.tolist(),
        }
    try:
        create_mesh(3, 1, device_type="cpu")
        out["mismatch"] = None
    except ValueError as exc:
        out["mismatch"] = str(exc)
    try:
        create_mesh(2, 2, device_type="cpu", backend="nccl")
        out["backend"] = None
    except ValueError as exc:
        out["backend"] = str(exc)
    return out


def _tiny(seed: int = 3, num_queries: int = 9):
    from owlvit_tpu_torch.models import get_config, owlvit

    cfg = get_config("tiny")
    return cfg, owlvit.init(cfg, torch.Generator().manual_seed(seed), num_queries=num_queries)


def tensor_parallel(rank: int, batch: int = 4) -> dict:
    """The tiny detector at tp=2 (mesh 1x2) against the same detector on
    one device, in this process: the eval forward (every layer), the
    frozen prefix, and the trained tail's forward and backward (input and
    weight gradients, the weights' gathered); then local_gather and
    local_scatter over a 2x1 mesh on this rank's rows of a pool."""
    from owlvit_tpu_torch.models import owlvit
    from owlvit_tpu_torch.parallel import create_mesh, local_gather, local_scatter, shard_params
    from owlvit_tpu_torch.parallel.sharding import gather_tensor, spec_for

    cfg, model = _tiny()
    S = cfg.vision.image_size
    pixels = torch.from_numpy(
        np.random.default_rng(5).uniform(-1, 1, (batch, S, S, 3)).astype(np.float32))
    tail_cfg = cfg.replace(trainable_last_k=2)
    eval_cfg = cfg.replace(trainable_last_k=None)

    def run(m):
        with torch.no_grad():
            full = owlvit.forward_train(m, eval_cfg, pixels)
            prefix = owlvit.embed_prefix(m, tail_cfg, pixels)
        acts = prefix.clone().requires_grad_(True)
        m.zero_grad(set_to_none=True)
        boxes, sims = owlvit.forward_train_from_prefix(m, tail_cfg, acts)
        (boxes.square().sum() + sims.square().sum()).backward()
        grads = {n: p.grad for n, p in m.named_parameters() if p.grad is not None}
        return {"full": full, "prefix": prefix, "tail": (boxes.detach(), sims.detach()),
                "dacts": acts.grad, "grads": grads}

    want = run(model)
    mesh = create_mesh(1, 2, device_type="cpu")
    shard_params(model, mesh)
    local_shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    got = run(model)
    got["grads"] = {n: gather_tensor(g, spec_for(n), mesh) for n, g in got["grads"].items()}

    # the row-sharded pool: rank r holds rows [r N/2, (r+1) N/2)
    pool_mesh = create_mesh(2, 1, device_type="cpu")
    n, per = 8, 4
    pool = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
    local = pool[rank * per:(rank + 1) * per].clone()
    idxs = np.array([[2, 0], [5, 7]])[rank]
    gathered = local_gather(local, idxs, pool_mesh)
    local_scatter(local, idxs, -gathered, pool_mesh)
    try:
        local_gather(local, np.array([[5], [0]])[rank], pool_mesh)
        misaligned = None
    except ValueError as exc:
        misaligned = str(exc)
    return {"want": want, "got": got, "local_shapes": local_shapes, "gathered": gathered,
            "scattered": local, "misaligned": misaligned}


def quant_prefix_tp(rank: int, batch: int = 2) -> dict:
    """The int8 frozen prefix (quant_backbone) of a 3-layer detector with 2
    heads of 64 at tp=2 (mesh 1x2) against the same prefix on one device
    in this process, and the unquantized prefix beside them."""
    import dataclasses

    from owlvit_tpu_torch.models import get_config, owlvit
    from owlvit_tpu_torch.parallel import create_mesh, shard_params

    cfg = get_config("tiny", trainable_last_k=1)
    cfg = cfg.replace(vision=dataclasses.replace(cfg.vision, hidden_size=128, num_heads=2,
                                                 num_layers=3, mlp_dim=256))
    model = owlvit.init(cfg, torch.Generator().manual_seed(6), num_queries=6)
    S = cfg.vision.image_size
    pixels = torch.from_numpy(
        np.random.default_rng(8).uniform(-1, 1, (batch, S, S, 3)).astype(np.float32))
    quant = cfg.replace(quant_backbone=True)
    with torch.no_grad():
        one = owlvit.embed_prefix(model, quant, pixels)
        plain = owlvit.embed_prefix(model, cfg, pixels)
        shard_params(model, create_mesh(1, 2, device_type="cpu"))
        tp = owlvit.embed_prefix(model, quant, pixels)
    return {"one": one, "tp": tp, "plain": plain}


def trainer_runs(rank: int, runs: dict) -> dict:
    """Each run of `runs` ({name: {"config": {data, training, model},
    "workdir": ...}}) as the CLI starts it: Trainer.from_config on the mesh
    its config asks for, then run(). Returns per run the trainable
    parameters (full tensors), the query bank, the last metrics, the step,
    the store and the pool's local shape, the staged pools and the device
    epochs; a run marked "refused" returns the ValueError's message."""
    from owlvit_tpu_torch.train import Trainer
    from owlvit_tpu_torch.utils.config import Config, DataConfig, ModelConfig, TrainingConfig

    out = {}
    for name, spec in runs.items():
        c = spec["config"]
        cfg = Config(data=DataConfig(**c["data"]), training=TrainingConfig(**c["training"]),
                     model=ModelConfig(**c["model"]))
        if spec.get("refused"):  # a config every rank must refuse
            try:
                Trainer.from_config(cfg, workdir=spec["workdir"], device="cpu")
            except ValueError as exc:
                out[name] = {"error": str(exc)}
                continue
            raise AssertionError(f"{name}: from_config did not refuse the config")
        trainer = Trainer.from_config(cfg, workdir=spec["workdir"], device="cpu")
        device_epochs = []
        run_epoch = trainer._run_epoch_device

        def spy(epoch, run_epoch=run_epoch, device_epochs=device_epochs):
            device_epochs.append(epoch)
            return run_epoch(epoch)

        trainer._run_epoch_device = spy
        metrics = trainer.run()
        pool = trainer.pool
        names = {id(p): n for n, p in trainer.model.named_parameters()}
        out[name] = {
            "names": [names[id(p)] for p in trainer.params],
            "queries": trainer.model.queries.detach().clone(),
            "trainable": trainer._full([p.detach() for p in trainer.params]),
            "map": float(metrics["map"]), "step": trainer.step,
            "store": trainer.act_store,
            "pool_shape": (None if pool is None else
                           {k: tuple(v.shape) for k, v in pool.items()}
                           if isinstance(pool, dict) else tuple(pool.shape)),
            "filled": None if trainer.act_store != "device" else bool(
                trainer.filled[_own_rows(trainer)].all()),
            "ema": None if trainer.ema is None else trainer._full(trainer.ema),
            # training.stage_pixels: the staged train rows and pools, and the
            # epochs run as the device epoch
            "staged": None if trainer.pix_train is None else (
                trainer.pix_train["labels"].shape[0], set(trainer.pix_train)),
            "device_epochs": device_epochs,
        }
    return out


def _own_rows(trainer) -> np.ndarray:
    per = trainer.pool_rows // trainer.dp
    return np.arange(trainer.data_rank * per, (trainer.data_rank + 1) * per)


JOBS = {"mesh_layout": mesh_layout, "tensor_parallel": tensor_parallel,
        "quant_prefix_tp": quant_prefix_tp, "trainer_runs": trainer_runs}
